// packet_walk.cu — closest-hit / any-hit ray queries over the 8-wide BVH
// (the packet route), one thread per ray with its own stack.
//
// Replaces raytpu/kernels/intersect_pallas.py:_packet_kernel /
// _one_packet (entry packet_query, factory make_packet_intersectors) in
// its closest-hit and any-hit forms. It ports that kernel's contract, not
// its TPU schedule: no 4096-ray packets, no shared packet stack, no
// representative-ray ordering. Each thread pops its own stack; for each
// child k of the node in storage order it slab-tests the child's box,
// pushes a hit interior child at once and tests a hit leaf's 8 triangles
// at once, so the children are popped last-pushed first. Ties break to the
// lowest triangle slot, so the visit order does not change a closest-hit
// result; any-hit stops at the first blocker.
//
// Layout (raytpu_torch/accel/bvh.py): node n is the 128 floats at
// nodes + n*128; child k sits at columns 16k..16k+6: bmin.xyz, bmax.xyz,
// then the link as int32 BITS (read with __float_as_int, never a value
// cast): a child node index, or ~leaf_row for a leaf whose triangles sit
// in leaf row ~link (8 triangles x p0, e1, e2, pad = 80 floats). Empty
// child slots carry an inverted box (bmin > bmax); the slab test does not
// order-normalise its intervals, so they miss every ray.
//
// Float rules, shared bit for bit with the plain version
// (kernels/packet.py:packet_query_torch): the build passes --fmad=false,
// -prec-div=true and -ftz=false, every expression keeps raytpu's
// association, and max/min propagate NaN like torch.maximum/minimum.
//
// What bounds it on an H100: dependent global loads (a 512-byte node row
// per pop, 320 bytes of triangles per leaf; the tables stay in L2 for
// scenes up to ~50 MB), warp divergence as walks part, and the per-thread
// stack, which lives in local memory (2 KB a thread). This first version
// keeps the walk simple and correct: speed is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr int kStackDepth = 512;  // kernels/packet.py:STACK_DEPTH
constexpr int kWidth = 8;         // children per node
constexpr int kNodeFloats = 128;  // 8 children x 16 floats
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

__global__ void __launch_bounds__(kBlock) packet_walk_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
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
  const float tm = __ldg(tmax + i);
  // closest: LIMIT = best_t from min(F32_MAX, tmax), an open bound (a dead
  // lane with tmax = -inf returns t = -inf, tri = -1); any-hit: LIMIT =
  // tmax, a closed bound
  float best_t = any_hit ? tm : nan_min(kF32Max, tm);
  int best_tri = -1;
  bool blocked = false;

  int stack[kStackDepth];
  stack[0] = 0;
  int sp = 1;
  for (int pops = 0; sp > 0 && pops < n_nodes && !blocked; ++pops) {
    const float* nd = nodes + static_cast<size_t>(stack[--sp]) * kNodeFloats;
    for (int k = 0; k < kWidth && !blocked; ++k) {
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
      const float limit = any_hit ? tm : best_t;
      const float t_near = nan_max(nan_max(lox, loy), nan_max(loz, tmin));
      const float t_far = nan_min(nan_min(hix, hiy), nan_min(hiz, limit));
      if (!(t_near <= t_far)) continue;
      if (link >= 0) {
        if (link < n_nodes) {
          // clamp as raytpu does: an overflowing push drops a subtree
          // (the pack's depth check keeps real trees below the bound)
          stack[min(sp, kStackDepth - 1)] = link;
          sp = min(sp + 1, kStackDepth - 1);
        }
        continue;
      }
      const int lr = ~link;
      if (lr >= n_leaf_rows) continue;
      const float* lf = leaves + static_cast<size_t>(lr) * kLeafFloats;
      for (int q = 0; q < kLeafSize; ++q) {
        const float* tp = lf + 10 * q;
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
        const int slot = lr * kLeafSize + q;
        if (any_hit) {
          if (geo && t >= tmin && t <= tm) {
            best_tri = slot;
            blocked = true;  // the first blocker ends the walk
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
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int packet_walk_launch(const float* nodes, const float* leaves,
                                  const float* ro, const float* rd,
                                  const float* tmax, float* t_out,
                                  int* tri_out, int n_rays, int n_nodes,
                                  int n_leaf_rows, float tmin, int any_hit,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  packet_walk_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaves, ro, rd, tmax, t_out, tri_out, n_rays, n_nodes,
      n_leaf_rows, tmin, any_hit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packet_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
