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
// walker pools or leaf queues in its default instances.
//
// What bounds it on an H100: the dependent chain of node loads (32 bytes
// a step, 320 a leaf) and the warp's divergence as its lanes' walks part;
// the tables stay in L2 for scenes up to ~50 MB. The design has two steps
// over the first port, each of which gained on the 1080p gallery frame's
// waves (PERF.md): 16-byte loads, and Aila-Laine while-while traversal, so
// leaves are tested at the warp's width. Persistent warps taking 32-ray
// batches from a global counter, and __launch_bounds__(128, 8), measured
// no faster and were reverted; the first and pipelined loads return only
// as opt-in forms of the schedule form.
//
// raytpu's schedule (its walker pool, deferred leaf rounds, pipelined,
// dual and shared-memory fetch, and its ribbon sub-steps over the pool)
// is the schedule form, strand_walk_sched_launch below: a kernel of its
// own (strand_common.cuh:sched_kernel), so the instances above keep the
// while-while walk, which measured fastest on the card (PERF.md).
//
// The schedule form's design for the card has three steps over its first
// port, each of which gained on the 1080p gallery frame's waves
// (PERF.md): a persistent grid of the blocks the card holds resident, not
// raytpu's `walkers` x 128 rays (which left ~4 warps an SM); claims of
// `service_k` batches taken for a block and shared by its warps, so one
// claim's batches run in parallel; and the K-wide window held in shared
// memory, filled with 16-byte loads, not in registers. Four steps lost
// and were reverted: a 64-ray dual batch on a pair of warps, one ray a
// lane, voting through shared memory and a named barrier; the window
// filled with cp.async; launch bounds of 8 blocks an SM (64 registers);
// and a block of 4, 8 or 16 warps picked per launch to keep the most
// warps walking where a launch has fewer claims than resident blocks
// (its launch bounds of 512 threads cost the large waves more than it
// gave the small ones).
//
// Options of raytpu's kernel, none of which changes a result, each a
// template case of every form (closest, any-hit, mixed), so the strand
// and ribbon layouts without counters keep their code: the ribbon layout
// (rpo > 0: raytpu's ribbon_rpo; each lane reads its own octant's
// renumbered records, the same visit sequence; ribbon_k 1 loads one
// 32-byte record a step, ribbon_k = K >= 2 fetches a window of K records
// of the row) and the stats counters (stats non-null: strand_common.cuh's
// Stat). Both were redesigned for the card (PERF.md), each timed in turns
// with the instance without the option. The K-wide fetch loads the
// window's 128-byte lines into L1 (those past the line of the cursor's
// record, which its load brings), one 4-byte load a line, and each step
// loads its record from there: 1.2-1.3x K 1 on the 1080p primary wave
// and on a mixed query. The window held in registers (93-126 registers;
// 1.6-2.3x) or in shared memory (16 / 32 KB a block; 1.4-2.2x) lost, and
// so did prefetch instructions into L1 (1.2x, but 1.35-1.5x on the mixed
// query) or L2, those deduplicated by a warp match, the window's bounds
// packed in one register, and launch bounds of 9 blocks an SM. The
// counters: each block sums its 4 warps' counts in shared memory and adds
// them with one atomic a counter, where each warp's three atomics on the
// same words cost a mixed query +50%; the instances read 1.1-1.2x their
// twins. Slots summed by the last block, counts by warp votes or in
// shared memory, the largest L1 carveout, and partial sums stored for a
// second kernel were no faster.

#include "strand_common.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kAny, bool kMixed, int kRibbon, bool kStats>
int launch(const strand::Args& a, cudaStream_t stream) {
  const int warps = (a.n_rays + 31) / 32;
  const int grid = (warps + kBlock / 32 - 1) / (kBlock / 32);
  strand::walk_kernel<kBlock, kAny, kMixed, kRibbon, kStats>
      <<<grid, kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAny, bool kMixed, int kRibbon>
int launch_stats(const strand::Args& a, cudaStream_t stream) {
  return a.stats ? launch<kAny, kMixed, kRibbon, true>(a, stream)
                 : launch<kAny, kMixed, kRibbon, false>(a, stream);
}

// the instance for the layout (a.rpo; over ribbon rows, a.ribbon_k: 1
// record a step, or a window of 4 or 8 records for K 2..4 or 5..8) and
// the counters (a.stats)
template <bool kAny, bool kMixed = false>
int launch(const strand::Args& a, cudaStream_t stream) {
  if (a.rpo > 0) {
    if (a.ribbon_k >= 2) {
      return a.ribbon_k <= 4 ? launch_stats<kAny, kMixed, 4>(a, stream)
                             : launch_stats<kAny, kMixed, 8>(a, stream);
    }
    return launch_stats<kAny, kMixed, 1>(a, stream);
  }
  return launch_stats<kAny, kMixed, 0>(a, stream);
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

// ---------------------------------------------------------------------
// The schedule form (strand_common.cuh:sched_kernel): raytpu's walker
// pool, leaf rounds and fetch forms, one instance per (mode, fetch form).
// ---------------------------------------------------------------------

namespace {

// The persistent grid: the card's resident capacity for the instance (the
// CUDA occupancy calculator's blocks per SM for its registers and shared
// memory, times the card's SMs), or fewer where the launch has fewer
// claims than that (each block needs one to start). With grid_out, only
// the grid is computed and stored there.
template <bool kAny, bool kMixed, int kFetch, int kWidth>
int launch_sched(const strand::Args& a, const strand::Sched& s,
                 cudaStream_t stream, int* grid_out) {
  auto* kernel = strand::sched_kernel<kBlock, kAny, kMixed, kFetch, kWidth>;
  const size_t smem = strand::sched_smem<kBlock, kFetch, kWidth>(s.n_top);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                smem);
  const long long cap = static_cast<long long>(per_sm) * sms;
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long claims =
      (static_cast<long long>(s.n_batches) + s.service_k - 1) / s.service_k;
  const int grid = static_cast<int>(claims < cap ? claims : cap);
  if (grid_out != nullptr) {
    *grid_out = grid;
    return 0;
  }
  const cudaError_t z = cudaMemsetAsync(s.work, 0, sizeof(*s.work), stream);
  if (z != cudaSuccess) return static_cast<int>(z);
  kernel<<<grid, kBlock, smem, stream>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAny, bool kMixed>
int launch_sched(const strand::Args& a, const strand::Sched& s, int fetch,
                 cudaStream_t stream, int* grid_out) {
  switch (fetch) {
    case strand::kLoad:
      return launch_sched<kAny, kMixed, strand::kLoad, 1>(a, s, stream,
                                                          grid_out);
    case strand::kPipe:
      return launch_sched<kAny, kMixed, strand::kPipe, 1>(a, s, stream,
                                                          grid_out);
    case strand::kDual:
      return launch_sched<kAny, kMixed, strand::kDual, 1>(a, s, stream,
                                                          grid_out);
    default:
      return s.ribbon_k <= 4
                 ? launch_sched<kAny, kMixed, strand::kWide, 4>(a, s, stream,
                                                                grid_out)
                 : launch_sched<kAny, kMixed, strand::kWide, 8>(a, s, stream,
                                                                grid_out);
  }
}

int launch_sched(const strand::Args& a, const strand::Sched& s, int mode,
                 int fetch, cudaStream_t stream, int* grid_out) {
  if (mode == 2) {
    return launch_sched<false, true>(a, s, fetch, stream, grid_out);
  }
  return mode == 1
             ? launch_sched<true, false>(a, s, fetch, stream, grid_out)
             : launch_sched<false, false>(a, s, fetch, stream, grid_out);
}

}  // namespace

// Launch the schedule form on `stream`. mode: 0 closest-hit, 1 any-hit,
// 2 mixed (smask as strand_walk_mixed_launch; else null); fetch: 0 load,
// 1 pipe, 2 dual, 3 ribbon (rpo > 0, 1 <= ribbon_k <= 8; the others need
// rpo == 0); work: a device uint64 the launch zeroes on `stream`; stats:
// null or int32 [8], zeroed, to which each warp adds its sums; service_k
// >= 1; occ, the queued ray slots that fire a round; flush_pop >= 1;
// ctl_every a power of two; unroll >= 1 (1 under fetch 3); n_top, the
// nodes staged in shared memory under fetch 1 and 2 (<= 64 and <=
// n_nodes), else 0. Returns the cudaGetLastError() code after the launch,
// 0 on success, or cudaErrorInvalidValue for bad arguments (nothing
// launched).
extern "C" int strand_walk_sched_launch(
    const float* rows, const float* leaves, const int* first,
    const float* ro, const float* rd, const float* tmax, const float* smask,
    float* t_out, int* tri_out, int* stats, unsigned long long* work,
    int n_rays, int n_nodes, int n_leaf_rows, int rpo, int ribbon_k,
    float tmin, float shadow_tmin, int mode, int fetch, int service_k,
    int occ, int flush_pop, int ctl_every, int unroll, int n_top,
    void* stream) {
  const bool wide = fetch == strand::kWide;
  if (bad_layout(rpo, ribbon_k) || (rpo > 0) != wide || fetch < 0 ||
      fetch > strand::kWide || mode < 0 || mode > 2 ||
      (mode == 2) != (smask != nullptr) || service_k < 1 || occ < 1 ||
      flush_pop < 1 || ctl_every < 1 || (ctl_every & (ctl_every - 1)) != 0 ||
      unroll < 1 || (wide && unroll != 1) || n_top < 0 ||
      n_top > strand::kTopNodes || n_top > n_nodes ||
      (n_top > 0 && fetch != strand::kPipe && fetch != strand::kDual)) {
    return cudaErrorInvalidValue;
  }
  if (n_rays <= 0) return 0;
  const strand::Args a{rows,   leaves,  first,       ro,    rd,
                       tmax,   t_out,   tri_out,     stats, smask,
                       n_rays, n_nodes, n_leaf_rows, tmin,  shadow_tmin,
                       rpo,    ribbon_k};
  const int lanes = fetch == strand::kDual ? 64 : 32;
  const strand::Sched s{work,      stats,         (n_rays + lanes - 1) / lanes,
                        service_k, occ,           flush_pop,
                        ctl_every - 1, unroll,    ribbon_k,
                        n_top};
  return launch_sched(a, s, mode, fetch, static_cast<cudaStream_t>(stream),
                      nullptr);
}

// The grid (blocks of 128 threads) that strand_walk_sched_launch would
// launch for mode, fetch (3: ribbon_k picks the window's width), n_top,
// n_rays and service_k on the current device, stored in *grid: the
// blocks the card holds resident, or the launch's claims where fewer.
// Returns 0, or a CUDA error code.
extern "C" int strand_walk_sched_grid(int mode, int fetch, int ribbon_k,
                                      int n_top, int n_rays, int service_k,
                                      int* grid) {
  if (mode < 0 || mode > 2 || fetch < 0 || fetch > strand::kWide ||
      n_top < 0 || n_top > strand::kTopNodes || n_rays < 1 ||
      service_k < 1) {
    return cudaErrorInvalidValue;
  }
  strand::Args a{};
  strand::Sched s{};
  const int lanes = fetch == strand::kDual ? 64 : 32;
  s.n_batches = (n_rays + lanes - 1) / lanes;
  s.service_k = service_k;
  s.ribbon_k = ribbon_k;
  s.n_top = n_top;
  return launch_sched(a, s, mode, fetch, nullptr, grid);
}

extern "C" const char* strand_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
