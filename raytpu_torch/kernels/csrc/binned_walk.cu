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
// Sn rows of 128 floats at nodes + t*Sn*128, walked as a BVH8 with
// window-local links (bvh8_walk.cuh). Leaf row j of the window (leaves +
// (t*Sl + j)*128) holds 8 triangles of 10 floats: p0, e1, e2, then the
// triangle's global slot as int32 bits.
//
// Per lane (kept bit for bit with the plain version
// kernels/binned.py:binned_walk_torch): smask == 1 flags a shadow lane,
// any-hit over [shadow_tmin, tmax], which stops at its first blocker and
// returns t = min(F32_MAX, tmax); other lanes are closest-hit over
// [tmin, best) starting from best = min(F32_MAX, tmax), their incoming
// slot tri0 and its key first[tri0], keeping the smallest (t, first[slot])
// pair. The slab test uses min(tmin, shadow_tmin) for every lane and a
// LIMIT read once per popped node. Float rules and the conservative box
// test: walk_common.cuh.
//
// What bounds it on an H100: per lane the dependent chain of node rows
// (512 bytes) and leaf rows (320 bytes of triangles) of its window, in L2
// while rays of one window run together; the warp's divergence; and the
// frame's many small launches (7a: 38, most of a few thousand rays). The
// design has the packet walk's two kept steps (bvh8_walk.cuh: 16-byte
// loads, while-while traversal with postponed leaves), each of which gained
// on phase 7a's frame (PERF.md); near-first order and a shared-memory short
// stack gained nothing there and were reverted. The stack stays in local
// memory (1 KB a thread); no window is staged in shared memory (one is up
// to 1 MiB).

#include "bvh8_walk.cuh"

namespace {

using namespace walk;

constexpr int kStackDepth = 256;  // kernels/binned.py:STACK_DEPTH
constexpr int kRowFloats = 128;   // node and leaf rows
constexpr int kBlock = 128;

struct Args {
  const float* nodes;
  const float* leaves;
  const int* first;
  const int* tid;
  const float* ro;
  const float* rd;
  const float* tmax;
  const float* smask;
  const int* tri0;
  float* t_out;
  int* tri_out;
  int n_rays, n_treelets, sn, sl;
  float tmin, shadow_tmin;
};

__global__ void __launch_bounds__(kBlock) binned_kernel(Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i - (threadIdx.x & 31) >= a.n_rays) return;  // warp-uniform
  const bool real = i < a.n_rays;
  const bool shad = real && __ldg(a.smask + i) == 1.0f;
  Best b;
  b.t = nan_min(kF32Max, real ? __ldg(a.tmax + i) : -kF32Max);
  b.tri = (real && !shad) ? __ldg(a.tri0 + i) : -1;
  b.key = b.tri >= 0 ? __ldg(a.first + b.tri) : -1;
  const int t = real ? __ldg(a.tid + i) : -1;
  const bool live = t >= 0 && t < a.n_treelets;
  const Ray r = live ? load_ray(a.ro, a.rd, i)
                     : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  const float tcut = shad ? a.shadow_tmin : a.tmin;
  const size_t w = live ? t : 0;
  const float* lwin = a.leaves + w * a.sl * kRowFloats;
  // a shadow lane's best t stays its bound, so LIMIT is best t for both
  bvh8::walk<kStackDepth>(
      a.nodes + w * a.sn * kRowFloats, a.sn, a.sl, r,
      fminf(a.tmin, a.shadow_tmin), &b.t, live, [&](int lr) {
        const float* lf = lwin + static_cast<size_t>(lr) * kRowFloats;
        return shad ? test_row<true, true>(r, lf, 0, a.first, tcut, b.t, &b)
                    : test_row<false, true>(r, lf, 0, a.first, tcut, b.t,
                                            &b);
      });
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int binned_walk_launch(const float* nodes, const float* leaves,
                                  const int* first, const int* tid,
                                  const float* ro, const float* rd,
                                  const float* tmax, const float* smask,
                                  const int* tri0, float* t_out,
                                  int* tri_out, int n_rays, int n_treelets,
                                  int sn, int sl, float tmin,
                                  float shadow_tmin, void* stream) {
  if (n_rays <= 0) return 0;
  const Args a{nodes, leaves, first, tid, ro, rd, tmax, smask, tri0, t_out,
               tri_out, n_rays, n_treelets, sn, sl, tmin, shadow_tmin};
  const int grid = (n_rays + kBlock - 1) / kBlock;
  binned_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binned_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
