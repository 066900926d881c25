// strand_block.cu — closest-hit / any-hit ray queries over the
// octant-threaded strand tree, one warp per strand of 32 rays.
//
// Replaces raytpu/kernels/strand.py:_strand_kernel (entry strand_query,
// reached through make_strand_intersectors with
// RAYTPU_STRAND_PERSISTENT=0), the block-scheduled strand walk, in its
// closest-hit and any-hit forms. raytpu gives each 128-ray strand of
// coherence-sorted rays ONE stackless walker; here a strand is a warp of
// 32 consecutive rays (32 lanes are the card's SIMD width, as 128 are the
// TPU's), and the walker is warp-uniform state:
//
// * the octant is the strand's lane 0's (raytpu: "lane 0 is
//   representative because the engine sorts waves direction-octant-major"),
//   broadcast with __shfl_sync;
// * each step loads the one 32-byte record rows[cur*64 + oct*8] (bmin.xyz,
//   bmax.xyz, hit, miss; links are value-cast floats) from a warp-uniform
//   address, so one broadcast transaction;
// * every lane runs raytpu's slab test against its own LIMIT (closest-hit:
//   its best t; any-hit: tmax, or -inf once the lane is blocked) and
//   __any_sync gives the walker's hit bit: the walker descends wherever any
//   lane's box test hits;
// * at a leaf (hit < 0, triangles in leaf row ~hit) every lane tests the 8
//   slots in order, including lanes whose own box missed (raytpu's
//   behaviour); closest-hit accepts t >= tmin and (t < best or (t == best
//   and slot < best slot)), any-hit keeps a lane's first accepted slot in
//   [tmin, tmax]. Leaves are tested at once: raytpu queues them only for
//   TPU occupancy, which changes no committed result;
// * any-hit: the warp stops once every lane is blocked or dead
//   (__all_sync, raytpu's all_done);
// * tail lanes of a partial strand stay in the loop as dead lanes (ro 0,
//   rd (1,1,1), tmax -inf, raytpu's padding), so every vote has 32 lanes;
// * with `stats`, lane 0 writes the strand's walker steps and leaf visits
//   to stats[2*strand + {0, 1}].
//
// Per ray the result is the brute sweep's wherever chip_smoke.py checks
// it. It is not always the per-ray walk's (strand_walk.cu): a lane tests
// every leaf the walker reaches, including leaves under boxes its own slab
// test misses by rounding, so the block walk finds hits that the per-ray
// walk loses (69 rays of chip_smoke.py's 1080p gallery frame, all sided
// with the brute sweep; ROADMAP fault 3.4). Where both walks test the
// leaf holding a ray's closest hit they agree on it, because ties break to
// the lowest slot whatever the visit order.
//
// Float rules, shared bit for bit with the plain version
// (kernels/strand.py:strand_block_query_torch): the build passes
// --fmad=false, -prec-div=true and -ftz=false, every expression keeps
// raytpu's association, and max/min propagate NaN like torch.
//
// What bounds it on an H100: the dependent chain of node loads per warp
// (one 32-byte record per step, 320 bytes of triangles per leaf), not
// arithmetic; a strand pays for the union of its lanes' visits. Every walk
// is bounded by the node count and checks its node and leaf indices.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr int kNodeFloats = 64;   // 8 octants x 8 floats per node
constexpr int kLeafSize = 8;
constexpr int kLeafFloats = 80;   // 8 triangles x 10 floats
constexpr int kStrand = 32;       // rays per strand = lanes of a warp
constexpr int kWarps = 4;         // strands per block
constexpr int kBlock = kStrand * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// 1/d with exactly-zero components clamped to +/-TINY (sign of the zero)
__device__ __forceinline__ float safe_inv(float d) {
  float s = d;
  if (d == 0.0f) s = (1.0f / d < 0.0f) ? -kTiny : kTiny;
  return 1.0f / s;
}

__global__ void __launch_bounds__(kBlock) strand_block_kernel(
    const float* __restrict__ rows, const float* __restrict__ leaves,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmax, float* __restrict__ t_out,
    int* __restrict__ tri_out, int* __restrict__ stats, int n_rays,
    int n_nodes, int n_leaf_rows, float tmin, int any_hit) {
  const int strand = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (strand * kStrand >= n_rays) return;  // the whole warp: uniform
  const int i = strand * kStrand + lane;
  const bool real = i < n_rays;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  // padding lanes: ro 0, rd (1,1,1), tmax -inf (raytpu's strand padding)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  float dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float tm = neg_inf;
  if (real) {
    ox = __ldg(ro + 3 * i + 0);
    oy = __ldg(ro + 3 * i + 1);
    oz = __ldg(ro + 3 * i + 2);
    dx = __ldg(rd + 3 * i + 0);
    dy = __ldg(rd + 3 * i + 1);
    dz = __ldg(rd + 3 * i + 2);
    tm = __ldg(tmax + i);
  }
  const float ix = safe_inv(dx);
  const float iy = safe_inv(dy);
  const float iz = safe_inv(dz);
  const bool nx = ix < 0.0f;
  const bool ny = iy < 0.0f;
  const bool nz = iz < 0.0f;
  const int my_oct = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
  const int oct = __shfl_sync(kFull, my_oct, 0);
  // closest: best t from min(F32_MAX, tmax); any-hit: tmax
  float best_t = any_hit ? tm : nan_min(kF32Max, tm);
  int best_tri = -1;
  int steps = 0;
  int leaf_visits = 0;

  int c = 0;
  for (int step = 0; c >= 0 && c < n_nodes && step < n_nodes; ++step) {
    if (any_hit && __all_sync(kFull, best_tri >= 0 || tm < 0.0f)) break;
    const float* nd = rows + static_cast<size_t>(c) * kNodeFloats + oct * 8;
    const float bx0 = __ldg(nd + 0), by0 = __ldg(nd + 1), bz0 = __ldg(nd + 2);
    const float bx1 = __ldg(nd + 3), by1 = __ldg(nd + 4), bz1 = __ldg(nd + 5);
    const int hit_link = static_cast<int>(__ldg(nd + 6));
    const int miss_link = static_cast<int>(__ldg(nd + 7));
    const float limit =
        any_hit ? (best_tri >= 0 ? neg_inf : tm) : best_t;
    const float lox = ((nx ? bx1 : bx0) - ox) * ix;
    const float hix = ((nx ? bx0 : bx1) - ox) * ix;
    const float loy = ((ny ? by1 : by0) - oy) * iy;
    const float hiy = ((ny ? by0 : by1) - oy) * iy;
    const float loz = ((nz ? bz1 : bz0) - oz) * iz;
    const float hiz = ((nz ? bz0 : bz1) - oz) * iz;
    const float t_near = nan_max(nan_max(lox, loy), nan_max(loz, tmin));
    const float t_far = nan_min(nan_min(hix, hiy), nan_min(hiz, limit));
    const bool hit_any = __any_sync(kFull, t_near <= t_far);
    ++steps;
    int next = miss_link;
    if (hit_any) {
      if (hit_link >= 0) {
        next = hit_link;
      } else if (~hit_link < n_leaf_rows) {
        ++leaf_visits;
        const int lr = ~hit_link;
        const float* lf = leaves + static_cast<size_t>(lr) * kLeafFloats;
        for (int k = 0; k < kLeafSize; ++k) {
          const float* tp = lf + 10 * k;
          const float p0x = __ldg(tp + 0), p0y = __ldg(tp + 1), p0z = __ldg(tp + 2);
          const float e1x = __ldg(tp + 3), e1y = __ldg(tp + 4), e1z = __ldg(tp + 5);
          const float e2x = __ldg(tp + 6), e2y = __ldg(tp + 7), e2z = __ldg(tp + 8);
          // Moller-Trumbore in raytpu's order: (ax*bx + ay*by) + az*bz
          const float pvx = dy * e2z - dz * e2y;
          const float pvy = dz * e2x - dx * e2z;
          const float pvz = dx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const float inv = 1.0f / det;
          const float tvx = ox - p0x;
          const float tvy = oy - p0y;
          const float tvz = oz - p0z;
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
          const float qx = tvy * e1z - tvz * e1y;
          const float qy = tvz * e1x - tvx * e1z;
          const float qz = tvx * e1y - tvy * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
          const bool geo = (det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
                           (u + v <= 1.0f);
          const int slot = lr * kLeafSize + k;
          if (any_hit) {
            // the first accepted slot blocks the lane; it stays in the
            // strand (no lane leaves before a vote)
            if (best_tri < 0 && geo && t >= tmin && t <= tm) best_tri = slot;
          } else if (geo && t >= tmin &&
                     (t < best_t || (t == best_t && slot < best_tri))) {
            best_t = t;
            best_tri = slot;
          }
        }
      }
    }
    c = next;
  }
  if (stats != nullptr && lane == 0) {
    stats[2 * strand + 0] = steps;
    stats[2 * strand + 1] = leaf_visits;
  }
  if (real) {
    t_out[i] = best_t;
    tri_out[i] = best_tri;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); `stats` may be
// null. Returns the cudaGetLastError() code after the launch, 0 on success.
extern "C" int strand_block_launch(const float* rows, const float* leaves,
                                   const float* ro, const float* rd,
                                   const float* tmax, float* t_out,
                                   int* tri_out, int* stats, int n_rays,
                                   int n_nodes, int n_leaf_rows, float tmin,
                                   int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const int n_strands = (n_rays + kStrand - 1) / kStrand;
  const int grid = (n_strands + kWarps - 1) / kWarps;
  strand_block_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, leaves, ro, rd, tmax, t_out, tri_out, stats, n_rays, n_nodes,
      n_leaf_rows, tmin, any_hit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* strand_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
