// strand_walk.cu — closest-hit / any-hit ray queries over the
// octant-threaded strand tree, one thread per ray.
//
// Replaces raytpu/kernels/strand_persistent.py:_persistent_kernel
// (entry strand_query_persistent, factory
// raytpu/kernels/strand.py:make_strand_intersectors) in its closest-hit
// and any-hit forms. It ports that kernel's contract, not its TPU
// schedule: each thread walks its own ray down the threading of its own
// direction octant, with no strands, walker pools or leaf queues.
//
// Layout (raytpu_torch/accel/strandtree.py): node c's record for octant o
// is the 8 floats at rows + c*64 + o*8: bmin.xyz, bmax.xyz, hit, miss.
// Links are value-cast floats. hit < 0 marks a leaf whose triangles sit
// in leaf row ~hit (8 triangles x p0, e1, e2, pad = 80 floats); after a
// leaf the walk follows miss; -1 terminates.
//
// Float rules, shared bit for bit with the plain version
// (kernels/strand.py:strand_query_torch): the build passes --fmad=false,
// -prec-div=true and -ftz=false, every expression keeps raytpu's
// association, and max/min propagate NaN like torch.maximum/minimum.
// Ties break to the lowest triangle slot, so the visit order does not
// change a closest-hit result.
//
// What bounds it on an H100: dependent global loads. Every step reads one
// 32-byte node record and, at a leaf, 320 bytes of triangles, and threads
// of a warp diverge as their walks part; the tables stay in L2 for scenes
// up to ~50 MB. This first version keeps the walk simple and correct:
// speed is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr int kNodeFloats = 64;   // 8 octants x 8 floats per node
constexpr int kLeafSize = 8;
constexpr int kLeafFloats = 80;   // 8 triangles x 10 floats
constexpr int kBlock = 128;

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

__global__ void __launch_bounds__(kBlock) strand_walk_kernel(
    const float* __restrict__ rows, const float* __restrict__ leaves,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmax, float* __restrict__ t_out,
    int* __restrict__ tri_out, int n_rays, int n_nodes, int n_leaf_rows,
    float tmin, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = __ldg(ro + 3 * i + 0);
  const float oy = __ldg(ro + 3 * i + 1);
  const float oz = __ldg(ro + 3 * i + 2);
  const float dx = __ldg(rd + 3 * i + 0);
  const float dy = __ldg(rd + 3 * i + 1);
  const float dz = __ldg(rd + 3 * i + 2);
  const float ix = safe_inv(dx);
  const float iy = safe_inv(dy);
  const float iz = safe_inv(dz);
  const bool nx = ix < 0.0f;
  const bool ny = iy < 0.0f;
  const bool nz = iz < 0.0f;
  const int oct = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
  const float tm = __ldg(tmax + i);
  // closest: LIMIT = best_t from min(F32_MAX, tmax) (a dead lane with
  // tmax = -inf returns t = -inf, tri = -1); any-hit: LIMIT = tmax
  float best_t = any_hit ? tm : nan_min(kF32Max, tm);
  int best_tri = -1;

  int c = 0;
  for (int step = 0; c >= 0 && c < n_nodes && step < n_nodes; ++step) {
    const float* nd = rows + static_cast<size_t>(c) * kNodeFloats + oct * 8;
    const float bx0 = __ldg(nd + 0), by0 = __ldg(nd + 1), bz0 = __ldg(nd + 2);
    const float bx1 = __ldg(nd + 3), by1 = __ldg(nd + 4), bz1 = __ldg(nd + 5);
    const int hit_link = static_cast<int>(__ldg(nd + 6));
    const int miss_link = static_cast<int>(__ldg(nd + 7));
    const float lox = ((nx ? bx1 : bx0) - ox) * ix;
    const float hix = ((nx ? bx0 : bx1) - ox) * ix;
    const float loy = ((ny ? by1 : by0) - oy) * iy;
    const float hiy = ((ny ? by0 : by1) - oy) * iy;
    const float loz = ((nz ? bz1 : bz0) - oz) * iz;
    const float hiz = ((nz ? bz0 : bz1) - oz) * iz;
    const float limit = any_hit ? tm : best_t;
    const float t_near = nan_max(nan_max(lox, loy), nan_max(loz, tmin));
    const float t_far = nan_min(nan_min(hix, hiy), nan_min(hiz, limit));
    int next = miss_link;
    if (t_near <= t_far) {
      if (hit_link >= 0) {
        next = hit_link;
      } else if (~hit_link < n_leaf_rows) {
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
            if (geo && t >= tmin && t <= tm) {
              best_tri = slot;
              next = -1;  // blocked: stop
              break;
            }
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
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int strand_walk_launch(const float* rows, const float* leaves,
                                  const float* ro, const float* rd,
                                  const float* tmax, float* t_out,
                                  int* tri_out, int n_rays, int n_nodes,
                                  int n_leaf_rows, float tmin, int any_hit,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  strand_walk_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, leaves, ro, rd, tmax, t_out, tri_out, n_rays, n_nodes,
      n_leaf_rows, tmin, any_hit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* strand_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
