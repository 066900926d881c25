// binned_walk.cu — one round of the binned route's treelet walk: each ray
// walks the treelet window it selected, per lane closest-hit or shadow
// (any-hit), one thread per ray with its own stack.
//
// Replaces raytpu/kernels/binned.py:_binned_packet_kernel (launched by
// _binned_launch, driven by make_binned_query). It ports that kernel's
// per-lane contract, not its TPU schedule: no 1024-ray packets, no
// scalar-prefetched BlockSpec windows, no shared packet stack. The round
// loop (kernels/binned.py:make_binned_query) sorts the rays by treelet, so
// rays of one window sit in neighbouring threads and share its rows in L2.
//
// Layout (raytpu_torch/accel/treelets.py): treelet t's node window is the
// Sn rows of 128 floats at nodes + t*Sn*128; child k of a row sits at
// columns 16k..16k+6: bmin.xyz, bmax.xyz, then the window-local link as
// int32 BITS (__float_as_int): a node row, or ~leaf_row for a leaf. Leaf
// row j of the window (leaves + (t*Sl + j)*128) holds 8 triangles of 10
// floats: p0, e1, e2, then the triangle's global slot as int32 bits. Empty
// child slots and padding rows carry inverted boxes; the slab test does
// not order-normalise its intervals, so they miss every ray.
//
// Per lane (raytpu's arithmetic, kept bit for bit with the plain version
// kernels/binned.py:binned_walk_torch): smask == 1 flags a shadow lane,
// any-hit over [shadow_tmin, tmax], which stops at its first blocker;
// other lanes are closest-hit over [tmin, best) starting from
// best = min(F32_MAX, tmax) and their incoming slot tri0, ties to the lowest
// slot. The slab test uses min(tmin, shadow_tmin) for every lane and a
// LIMIT read once per popped node. The build passes --fmad=false,
// -prec-div=true and -ftz=false; max/min propagate NaN like
// torch.maximum/minimum.
//
// What bounds it on an H100: dependent global loads (a 512-byte node row
// per pop, 320 bytes of triangles per leaf row; a window is at most about
// 1 MB and rays of one window run together, so its rows stay in L2), warp
// divergence as walks part, and the per-thread stack in local memory (1 KB
// a thread). This first version keeps the walk simple and correct: no
// shared-memory staging of windows, no warp cooperation.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr int kStackDepth = 256;  // kernels/binned.py:STACK_DEPTH
constexpr int kWidth = 8;         // children per node
constexpr int kRowFloats = 128;   // node and leaf rows
constexpr int kLeafSize = 8;
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

__global__ void __launch_bounds__(kBlock) binned_walk_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
    const int* __restrict__ tid, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ tmax,
    const float* __restrict__ smask, const int* __restrict__ tri0,
    float* __restrict__ t_out, int* __restrict__ tri_out, int n_rays,
    int n_treelets, int sn, int sl, float tmin, float shadow_tmin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const bool shad = __ldg(smask + i) == 1.0f;
  float best_t = nan_min(kF32Max, __ldg(tmax + i));
  int best_tri = shad ? -1 : __ldg(tri0 + i);
  const int t = __ldg(tid + i);
  if (t < 0 || t >= n_treelets) {
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    return;
  }
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
  const float tcut = shad ? shadow_tmin : tmin;
  const float slab_tmin = fminf(tmin, shadow_tmin);
  const float* win = nodes + static_cast<size_t>(t) * sn * kRowFloats;
  const float* lwin = leaves + static_cast<size_t>(t) * sl * kRowFloats;

  int stack[kStackDepth];
  stack[0] = 0;
  int sp = 1;
  for (int pops = 0; sp > 0 && pops < sn; ++pops) {
    const float* nd = win + static_cast<size_t>(stack[--sp]) * kRowFloats;
    const float limit = best_t;  // read once per popped node
    for (int k = 0; k < kWidth; ++k) {
      const float* c = nd + 16 * k;
      const float bx0 = __ldg(c + 0), by0 = __ldg(c + 1), bz0 = __ldg(c + 2);
      const float bx1 = __ldg(c + 3), by1 = __ldg(c + 4), bz1 = __ldg(c + 5);
      const int link = __float_as_int(__ldg(c + 6));
      const float lox = ((nx ? bx1 : bx0) - ox) * ix;
      const float hix = ((nx ? bx0 : bx1) - ox) * ix;
      const float loy = ((ny ? by1 : by0) - oy) * iy;
      const float hiy = ((ny ? by0 : by1) - oy) * iy;
      const float loz = ((nz ? bz1 : bz0) - oz) * iz;
      const float hiz = ((nz ? bz0 : bz1) - oz) * iz;
      const float t_near = nan_max(nan_max(lox, loy), nan_max(loz, slab_tmin));
      const float t_far = nan_min(nan_min(hix, hiy), nan_min(hiz, limit));
      if (!(t_near <= t_far)) continue;
      if (link >= 0) {
        if (link < sn) {
          // clamp as raytpu does: an overflowing push drops a subtree
          stack[min(sp, kStackDepth - 1)] = link;
          sp = min(sp + 1, kStackDepth - 1);
        }
        continue;
      }
      const int lr = ~link;
      if (lr >= sl) continue;
      const float* lf = lwin + static_cast<size_t>(lr) * kRowFloats;
      for (int q = 0; q < kLeafSize; ++q) {
        const float* tp = lf + 10 * q;
        const float p0x = __ldg(tp + 0), p0y = __ldg(tp + 1), p0z = __ldg(tp + 2);
        const float e1x = __ldg(tp + 3), e1y = __ldg(tp + 4), e1z = __ldg(tp + 5);
        const float e2x = __ldg(tp + 6), e2y = __ldg(tp + 7), e2z = __ldg(tp + 8);
        const int slot = __float_as_int(__ldg(tp + 9));
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
        const float th = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool geo = (det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
                         (u + v <= 1.0f);
        if (geo && th >= tcut &&
            (th < best_t || (th == best_t && (shad || slot < best_tri)))) {
          best_t = th;
          best_tri = slot;
          if (shad) {  // the first blocker ends a shadow lane's walk
            t_out[i] = best_t;
            tri_out[i] = best_tri;
            return;
          }
        }
      }
    }
  }
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int binned_walk_launch(const float* nodes, const float* leaves,
                                  const int* tid, const float* ro,
                                  const float* rd, const float* tmax,
                                  const float* smask, const int* tri0,
                                  float* t_out, int* tri_out, int n_rays,
                                  int n_treelets, int sn, int sl, float tmin,
                                  float shadow_tmin, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  binned_walk_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaves, tid, ro, rd, tmax, smask, tri0, t_out, tri_out, n_rays,
      n_treelets, sn, sl, tmin, shadow_tmin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binned_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
