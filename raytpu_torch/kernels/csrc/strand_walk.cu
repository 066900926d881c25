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
//
// Options of raytpu's kernel, none of which changes a result, each a
// template case of every form (closest, any-hit, mixed), so the strand
// layout without counters keeps its code: the ribbon layout (rpo > 0:
// raytpu's ribbon_rpo; each lane reads its own octant's renumbered
// records, the same visit sequence; ribbon_k is checked, and each step
// still loads one 32-byte record) and the stats counters (stats non-null:
// strand_common.cuh's Stat).

#include "strand_common.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kAny, bool kMixed, bool kRibbon, bool kStats>
int launch(const strand::Args& a, cudaStream_t stream) {
  const int warps = (a.n_rays + 31) / 32;
  const int grid = (warps + kBlock / 32 - 1) / (kBlock / 32);
  strand::walk_kernel<kBlock, kAny, kMixed, kRibbon, kStats>
      <<<grid, kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instance for the layout (a.rpo) and the counters (a.stats)
template <bool kAny, bool kMixed = false>
int launch(const strand::Args& a, cudaStream_t stream) {
  if (a.rpo > 0) {
    return a.stats ? launch<kAny, kMixed, true, true>(a, stream)
                   : launch<kAny, kMixed, true, false>(a, stream);
  }
  return a.stats ? launch<kAny, kMixed, false, true>(a, stream)
                 : launch<kAny, kMixed, false, false>(a, stream);
}

// rpo > 0 walks ribbon rows (rpo per octant, n_nodes = 16 * rpo) and
// needs 1 <= ribbon_k <= 8; stats is null or int32 [8], zeroed but for
// [3], to which each warp adds its sums.
bool bad_layout(int rpo, int ribbon_k) {
  return rpo < 0 || (rpo > 0 && (ribbon_k < 1 || ribbon_k > 8));
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaGetLastError() code after the launch, 0 on success, or
// cudaErrorInvalidValue for a bad layout (nothing is launched).
extern "C" int strand_walk_launch(const float* rows, const float* leaves,
                                  const int* first, const float* ro,
                                  const float* rd, const float* tmax,
                                  float* t_out, int* tri_out, int* stats,
                                  int n_rays, int n_nodes, int n_leaf_rows,
                                  int rpo, int ribbon_k, float tmin,
                                  int any_hit, void* stream) {
  if (bad_layout(rpo, ribbon_k)) return cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,   leaves,  first,       ro,    rd,
                       tmax,   t_out,   tri_out,     stats, nullptr,
                       n_rays, n_nodes, n_leaf_rows, tmin,  tmin,
                       rpo,    ribbon_k};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true>(a, s) : launch<false>(a, s);
}

// The mixed form: smask [n_rays] flags shadow lanes with 1.0 (any-hit over
// [shadow_tmin, tmax]); the other lanes are closest-hit over [tmin, tmax).
// Same layout, stats, stream and return conventions as strand_walk_launch.
extern "C" int strand_walk_mixed_launch(
    const float* rows, const float* leaves, const int* first,
    const float* ro, const float* rd, const float* tmax, const float* smask,
    float* t_out, int* tri_out, int* stats, int n_rays, int n_nodes,
    int n_leaf_rows, int rpo, int ribbon_k, float tmin, float shadow_tmin,
    void* stream) {
  if (bad_layout(rpo, ribbon_k)) return cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,   leaves,  first,       ro,    rd,
                       tmax,   t_out,   tri_out,     stats, smask,
                       n_rays, n_nodes, n_leaf_rows, tmin,  shadow_tmin,
                       rpo,    ribbon_k};
  return launch<false, true>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* strand_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
