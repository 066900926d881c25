// strand_walk.cu — closest-hit / any-hit / mixed-lane ray queries over the
// octant-threaded strand tree, one thread per ray.
//
// Replaces raytpu/kernels/strand_persistent.py:_persistent_kernel
// (entry strand_query_persistent, factories
// raytpu/kernels/strand.py:make_strand_intersectors and
// make_strand_mixed_query) in its closest-hit, any-hit and mixed forms
// (mixed: a per-lane shadow flag, one launch for a bounce's continuation
// rays and the previous bounce's deferred shadow rays). It ports that
// kernel's contract, not its TPU
// schedule: each lane walks its own ray down the threading of its own
// direction octant (strand_common.cuh:walk_kernel), with no strands,
// walker pools or leaf queues.
//
// What bounds it on an H100: the dependent chain of node loads (32 bytes
// a step, 320 a leaf) and the warp's divergence as its lanes' walks part;
// the tables stay in L2 for scenes up to ~50 MB. The design has two steps
// over the first port, each of which gained on the 1080p gallery frame's
// waves (PERF.md): 16-byte loads, and Aila-Laine while-while traversal, so
// leaves are tested at the warp's width. Persistent warps taking 32-ray
// batches from a global counter, and __launch_bounds__(128, 8), measured
// no faster and were reverted.

#include "strand_common.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kAny, bool kMixed = false>
int launch(const strand::Args& a, cudaStream_t stream) {
  const int warps = (a.n_rays + 31) / 32;
  const int grid = (warps + kBlock / 32 - 1) / (kBlock / 32);
  strand::walk_kernel<kBlock, kAny, kMixed><<<grid, kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int strand_walk_launch(const float* rows, const float* leaves,
                                  const int* first, const float* ro,
                                  const float* rd, const float* tmax,
                                  float* t_out, int* tri_out, int n_rays,
                                  int n_nodes, int n_leaf_rows, float tmin,
                                  int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,  leaves, first,   ro,      rd,
                       tmax,  t_out,  tri_out, nullptr, nullptr,
                       n_rays, n_nodes, n_leaf_rows, tmin, tmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true>(a, s) : launch<false>(a, s);
}

// The mixed form: smask [n_rays] flags shadow lanes with 1.0 (any-hit over
// [shadow_tmin, tmax]); the other lanes are closest-hit over [tmin, tmax).
// Same stream and return convention as strand_walk_launch.
extern "C" int strand_walk_mixed_launch(const float* rows,
                                        const float* leaves, const int* first,
                                        const float* ro, const float* rd,
                                        const float* tmax, const float* smask,
                                        float* t_out, int* tri_out,
                                        int n_rays, int n_nodes,
                                        int n_leaf_rows, float tmin,
                                        float shadow_tmin, void* stream) {
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,  leaves, first,   ro,      rd,
                       tmax,  t_out,  tri_out, nullptr, smask,
                       n_rays, n_nodes, n_leaf_rows, tmin, shadow_tmin};
  return launch<false, true>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* strand_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
