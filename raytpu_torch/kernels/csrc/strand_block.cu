// strand_block.cu — closest-hit / any-hit ray queries over the
// octant-threaded strand tree, one warp per strand of 32 rays.
//
// Replaces raytpu/kernels/strand.py:_strand_kernel (entry strand_query,
// reached through make_strand_intersectors with
// RAYTPU_STRAND_PERSISTENT=0), the block-scheduled strand walk, in its
// closest-hit and any-hit forms. raytpu gives each 128-ray strand of
// coherence-sorted rays ONE stackless walker; here a strand is a warp of
// 32 consecutive rays (32 lanes are the card's SIMD width, as 128 are the
// TPU's), and the walker is warp-uniform state (strand_common.cuh:
// block_kernel):
//
// * the octant is the strand's lane 0's (raytpu: "lane 0 is
//   representative because the engine sorts waves direction-octant-major"),
//   broadcast with __shfl_sync;
// * each step reads the one 32-byte record rows[cur*64 + oct*8] from a
//   warp-uniform address; every lane runs the slab test against its own
//   LIMIT (closest-hit: its best t; any-hit: tmax, or -inf once the lane
//   is blocked) and __any_sync gives the walker's hit bit;
// * at a leaf every lane tests the 8 slots in order, including lanes whose
//   own box missed (raytpu's behaviour); leaves are tested at once: raytpu
//   queues them only for TPU occupancy, which changes no committed result
//   (its queue is the deferral form, strand_block_defer_launch below);
// * any-hit: the warp stops once every lane is blocked or dead
//   (__all_sync, raytpu's all_done);
// * tail lanes of a partial strand stay in the loop as dead lanes (ro 0,
//   rd (1,1,1), tmax -inf, raytpu's padding), so every vote has 32 lanes;
// * with `stats`, lane 0 writes the strand's walker steps and leaf visits
//   to stats[2*strand + {0, 1}].
//
// Per ray the result meets the brute sweep's contract, as the per-ray
// walk's does (kernels/strand.py): a lane tests a superset of the leaves
// its own walk would, so the two walks return the same t bits, the same
// triangle and the same blocked bit.
//
// What bounds it on an H100: the dependent chain of record loads per warp,
// one step at a time, and the union of 32 lanes' visits that a strand
// pays for. The design has two steps over the first port, each of which
// gained on the 1080p gallery frame's waves (PERF.md): 16-byte record
// loads, and a leaf's 320-byte row loaded once per warp, as 20 float4 by
// lanes 0..19, into shared memory, where every lane reads its triangles.
// Loading both successor records while the slab test and the vote run, and
// persistent warps in blocks of 8 taking strands from a global counter,
// measured slower and were reverted.
//
// The deferral form (strand_common.cuh:defer_kernel) is launched for two
// resident blocks of 1024 threads a multiprocessor (32 registers): four
// blocks of raytpu's G = 16 where its 55 registers held two, which gained
// on bounce 1's wave (PERF.md). Three steps lost and were reverted:
// one barrier a step (each warp's flags in shared memory, reduced by every
// warp) in place of the four barrier votes; the row a round would pop
// copied into the stage with cp.async before the vote; and both successor
// records loaded before the vote (a gain of 3% at two blocks, a loss at
// 32 registers, where it spills).

#include "strand_common.cuh"

namespace {

constexpr int kBlock = 128;  // 4 strands per block

template <bool kAny>
int launch(const strand::Args& a, cudaStream_t stream) {
  const int strands = (a.n_rays + 31) / 32;
  const int grid = (strands + kBlock / 32 - 1) / (kBlock / 32);
  strand::block_kernel<kBlock, kAny><<<grid, kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); `stats` may be
// null. Returns the cudaGetLastError() code after the launch, 0 on
// success.
extern "C" int strand_block_launch(const float* rows, const float* leaves,
                                   const int* first, const float* ro,
                                   const float* rd, const float* tmax,
                                   float* t_out, int* tri_out, int* stats,
                                   int n_rays, int n_nodes, int n_leaf_rows,
                                   float tmin, int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,  leaves, first,   ro,      rd,
                       tmax,  t_out,  tri_out, stats,   nullptr,
                       n_rays, n_nodes, n_leaf_rows, tmin, tmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true>(a, s) : launch<false>(a, s);
}

// The deferral form (strand_common.cuh:defer_kernel): `groups` (1..32)
// warps a block walking in lock-step with per-warp leaf queues; with
// skip_done, idle walkers skip their loads. stats is null or int32
// [ceil(n_rays / 32), 3]. Same stream and return conventions;
// cudaErrorInvalidValue for a bad `groups` (nothing is launched).
extern "C" int strand_block_defer_launch(
    const float* rows, const float* leaves, const int* first,
    const float* ro, const float* rd, const float* tmax, float* t_out,
    int* tri_out, int* stats, int n_rays, int n_nodes, int n_leaf_rows,
    float tmin, int any_hit, int groups, int skip_done, void* stream) {
  if (groups < 1 || groups > 32) return cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,  leaves, first,   ro,      rd,
                       tmax,  t_out,  tri_out, stats,   nullptr,
                       n_rays, n_nodes, n_leaf_rows, tmin, tmin};
  const int strands = (n_rays + 31) / 32;
  const int grid = (strands + groups - 1) / groups;
  const size_t smem = static_cast<size_t>(groups) *
                      (strand::kLeafFloats * sizeof(float) +
                       strand::kBlockQcap * sizeof(int));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    strand::defer_kernel<true><<<grid, 32 * groups, smem, s>>>(a, skip_done);
  } else {
    strand::defer_kernel<false><<<grid, 32 * groups, smem, s>>>(a, skip_done);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* strand_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
