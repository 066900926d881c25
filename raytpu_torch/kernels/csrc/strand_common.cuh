// strand_common.cuh — the two walks over the octant-threaded strand tree
// that strand_walk.cu (one thread per ray) and strand_block.cu (one warp
// per 32-ray strand) launch, on the shared arithmetic of walk_common.cuh.
//
// Layout (raytpu_torch/accel/strandtree.py): node c's record for octant o
// is the 8 floats at rows + c*64 + o*8: bmin.xyz, bmax.xyz, hit, miss —
// 32 bytes, 32-byte aligned, so two float4 loads (a walk::Box). Links are
// value-cast floats. hit < 0 marks a leaf whose triangles sit in leaf row
// ~hit (8 triangles x p0, e1, e2, pad = 80 floats, 320 bytes); after a
// leaf the walk follows miss; -1 terminates. The ribbon layout (RibbonTree,
// the per-ray walk only) holds the same records renumbered per octant:
// octant o's node j at rows + (o*rpo*16 + j)*8, rpo rows per octant.

#pragma once

#include "walk_common.cuh"

namespace strand {

using namespace walk;

constexpr int kNodeFloats = 64;   // 8 octants x 8 floats per node
constexpr int kLeafFloats = 80;   // 8 triangles x 10 floats

using Rec = Box;

__device__ __forceinline__ Rec load_rec(const float* __restrict__ rows,
                                        int c, int oct) {
  return load_box(rows + static_cast<size_t>(c) * kNodeFloats + oct * 8);
}

constexpr int kRibbonNodes = 16;  // nodes per ribbon row

// raytpu's stats counters (strand_persistent.py:935-943) that the per-ray
// walk fills: [0] node records loaded, [4] leaf rows tested, [5] leaf rows
// reached, each summed over rays; the wrapper sets [3], the rest stay 0.
// The schedule form (sched_kernel, below) fills every slot but [6], [7]:
// [0] records loaded (fetches over ribbon rows), [1] leaf rounds, [2] pool
// claims, [3] batches installed, [4] leaf rows tested, [5] enqueues.
enum Stat {
  kLoads = 0,
  kRounds = 1,
  kClaims = 2,
  kInstalls = 3,
  kLeafTests = 4,
  kLeafReached = 5
};

__device__ __forceinline__ int hit_link(const Rec& q) {
  return static_cast<int>(q.b.z);
}

__device__ __forceinline__ int miss_link(const Rec& q) {
  return static_cast<int>(q.b.w);
}

// Test leaf row lr's 8 triangles in slot order; true when an any-hit ray
// is blocked (the rest of the row is then skipped).
template <bool kAny>
__device__ __forceinline__ bool test_leaf(const Ray& r,
                                          const float* __restrict__ leaves,
                                          const int* __restrict__ first,
                                          int lr, float tmin, float tm,
                                          Best* b) {
  return test_row<kAny, false>(
      r, leaves + static_cast<size_t>(lr) * kLeafFloats, lr * kLeafSize,
      first, tmin, tm, b);
}

struct Args {
  const float* rows;
  const float* leaves;
  const int* first;
  const float* ro;
  const float* rd;
  const float* tmax;
  float* t_out;
  int* tri_out;
  // block walk: per-strand steps and leaf visits; per-ray walk: the [8]
  // counters of Stat; or null
  int* stats;
  const float* smask;  // mixed walk: 1.0 flags a shadow lane, or null
  int n_rays, n_nodes, n_leaf_rows;
  float tmin, shadow_tmin;
  // per-ray walk: 0 for strand rows, else ribbon rows per octant;
  // ribbon_k (1..8) is raytpu's sub-steps per fetched row: the records a
  // fetch holds (walk_kernel's kRibbon >= 2 and sched_kernel's kWide; 1
  // loads a record a step). The block walk leaves both 0.
  int rpo, ribbon_k;
};

// ---------------------------------------------------------------------
// The per-ray walk (replaces raytpu/kernels/strand_persistent.py:
// _persistent_kernel): one warp per 32 rays, each lane walking its own ray
// down the threading of its own octant, with Aila-Laine "while-while"
// traversal: a lane steps through nodes until it holds a leaf or is done,
// and leaves are tested once no active lane is still stepping, so the
// triangle loop runs at the warp's width. A lane holding a leaf waits (no
// speculative steps), so every lane tests each leaf with the best t it
// would hold in a lone walk: the results are a lone walk's, bit for bit.
//
// kMixed is the mixed-lane form (raytpu's mixed=True): smask == 1 flags a
// shadow lane, any-hit over [shadow_tmin, tmax] with its best t at tmax,
// which stops at its first blocker; every other lane is closest-hit over
// [tmin, best) from min(F32_MAX, tmax). Every lane's slab test uses
// min(tmin, shadow_tmin) and LIMIT = the lane's best t. kAny is unused.
//
// kRibbon > 0 walks the ribbon layout (a.rpo rows per octant): octant
// oct's node c at (oct*rpo*16 + c)*8, where the strand layout (kRibbon 0)
// has node c's record at c*64 + oct*8. kRibbon 1 loads one record a step.
// kRibbon = W >= 2 is raytpu's ribbon sub-steps as a K-wide fetch: a lane
// keeps the window [wb, wb + wn) of up to K = a.ribbon_k <= W consecutive
// records of its row that it fetched last (cut at the end of the cursor's
// 16-node row and at n_nodes), and a cursor outside it fetches the window
// at the cursor: the window's 128-byte lines are loaded into L1
// (load_window_lines) and each sub-step then loads its record as kRibbon 1
// does, from L1. The window lives across leaf tests, so a lane's fetches
// follow its own walk alone. kStats counts: the block's warps' sums of
// records loaded (fetches under the K-wide fetch) and leaf rows tested
// meet in shared memory, and one thread adds them to a.stats's Stat
// counters, one atomic each a block. Both are template cases, so the
// strand layout's instances without stats compile to the walk without
// either option.
// ---------------------------------------------------------------------

// Bring into L1 the 128-byte lines that hold the n (<= kMax) records at
// p, past p's own line (which the load of the record at p brings in): one
// 4-byte non-coherent load a line, whose word goes to *sink (a volatile
// store to shared memory, so that the compilers keep the load). Lanes
// that load one line share one request; prefetch.global.L1 in its place
// measured slower (PERF.md).
template <int kMax>
__device__ __forceinline__ void load_window_lines(const float* p, int n,
                                                  volatile unsigned* sink) {
  const unsigned long long first =
      reinterpret_cast<unsigned long long>(p) >> 7;
  const unsigned long long last =
      (reinterpret_cast<unsigned long long>(p + 8 * n) - 1) >> 7;
#pragma unroll
  for (int m = 1; m <= (kMax * 32 + 127) / 128; ++m) {
    if (first + m <= last) {
      *sink = __ldg(reinterpret_cast<const unsigned*>((first + m) << 7));
    }
  }
}

template <int kBlock, bool kAny, bool kMixed = false, int kRibbon = 0,
          bool kStats = false>
__global__ void __launch_bounds__(kBlock) walk_kernel(Args a) {
  constexpr bool kWindow = kRibbon >= 2;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5)) * 32;
  // warp-uniform; the stats instances keep every warp for the block's sum
  if (!kStats && base >= a.n_rays) return;
  const int i = base + lane;
  const bool real = i < a.n_rays;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float tm = -kF32Max;
  bool shad = false;
  if (real) {
    r = load_ray(a.ro, a.rd, i);
    tm = __ldg(a.tmax + i);
    if (kMixed) shad = __ldg(a.smask + i) == 1.0f;
  }
  // this lane's octant's first record; records are kStride floats apart
  const float* rec0 =
      kRibbon ? a.rows + static_cast<size_t>(r.oct) * a.rpo *
                             kRibbonNodes * 8
              : a.rows + r.oct * 8;
  constexpr int kStride = kRibbon ? 8 : kNodeFloats;
  // closest: LIMIT = best t from min(F32_MAX, tmax) (a dead lane with
  // tmax = -inf returns t = -inf, tri = -1); any-hit: LIMIT = tmax
  Best b;
  b.t = (kMixed ? shad : kAny) ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
  const float slab_tmin = kMixed ? fminf(a.tmin, a.shadow_tmin) : a.tmin;
  int c = real ? 0 : -1;
  int steps = 0;
  int leaf = -1;
  int wb = 0, wn = 0;  // kWindow: the window last fetched
  unsigned fetches = 0, tests = 0;  // kStats: windows fetched, leaf rows
  for (;;) {
    for (;;) {
      const bool stepping =
          leaf < 0 && c >= 0 && c < a.n_nodes && steps < a.n_nodes;
      if (!__any_sync(kFull, stepping)) break;
      if (stepping) {
        const float* p = rec0 + static_cast<size_t>(c) * kStride;
        if constexpr (kWindow) {
          if (c < wb || c >= wb + wn) {
            // the warp's word that the window's line loads go to
            __shared__ unsigned sink[kBlock / 32];
            wb = c;
            wn = min(min(a.ribbon_k, kRibbonNodes - (c & (kRibbonNodes - 1))),
                     a.n_nodes - c);
            load_window_lines<kRibbon>(p, wn, sink + (threadIdx.x >> 5));
            ++fetches;
          }
        }
        const Rec q = load_box(p);
        ++steps;
        const int hl = hit_link(q);
        c = miss_link(q);
        if (box_hit(r, q, slab_tmin, (kAny && !kMixed) ? tm : b.t)) {
          if (hl >= 0) {
            c = hl;
          } else if (~hl < a.n_leaf_rows) {
            leaf = ~hl;
          }
        }
      }
    }
    if (!__any_sync(kFull, leaf >= 0)) break;
    if (leaf >= 0) {
      if (kStats) ++tests;
      bool blocked;
      if (kMixed) {
        blocked = shad ? test_leaf<true>(r, a.leaves, a.first, leaf,
                                         a.shadow_tmin, tm, &b)
                       : test_leaf<false>(r, a.leaves, a.first, leaf,
                                          a.tmin, tm, &b);
      } else {
        blocked = test_leaf<kAny>(r, a.leaves, a.first, leaf, a.tmin, tm,
                                  &b);
      }
      if (blocked) c = -1;  // blocked: stop
      leaf = -1;
    }
  }
  if constexpr (kStats) {
    // the block's sums (integer sums wrap and do not depend on order)
    __shared__ unsigned part[2][kBlock / 32];
    const unsigned loads = __reduce_add_sync(
        kFull, kWindow ? fetches : static_cast<unsigned>(steps));
    tests = __reduce_add_sync(kFull, tests);
    if (lane == 0) {
      part[0][threadIdx.x >> 5] = loads;
      part[1][threadIdx.x >> 5] = tests;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned l = 0, t = 0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) {
        l += part[0][w];
        t += part[1][w];
      }
      atomicAdd(reinterpret_cast<unsigned*>(a.stats) + kLoads, l);
      atomicAdd(reinterpret_cast<unsigned*>(a.stats) + kLeafTests, t);
      atomicAdd(reinterpret_cast<unsigned*>(a.stats) + kLeafReached, t);
    }
  }
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}

// ---------------------------------------------------------------------
// The block walk (replaces raytpu/kernels/strand.py:_strand_kernel): one
// warp per 32-ray strand shares one stackless walker down the threading of
// lane 0's octant, descending wherever any lane's box test hits; at a leaf
// the warp loads the 320-byte row once, as 20 float4 by lanes 0..19, into
// shared memory, and every lane tests the 8 slots from there; any-hit
// strands stop once every lane is blocked or dead; tail lanes are dead
// padding (ro 0, rd (1,1,1), tmax -inf).
// ---------------------------------------------------------------------
template <int kBlock, bool kAny>
__global__ void __launch_bounds__(kBlock) block_kernel(Args a) {
  __shared__ float4 stage[kBlock / 32][kLeafFloats / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  const int n_strands = (a.n_rays + 31) / 32;
  const int strand = blockIdx.x * (kBlock / 32) + warp;
  if (strand >= n_strands) return;  // warp-uniform
  const int i = strand * 32 + lane;
  const bool real = i < a.n_rays;
  // padding lanes: ro 0, rd (1,1,1), tmax -inf (raytpu's strand padding)
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float tm = neg_inf;
  if (real) {
    r = load_ray(a.ro, a.rd, i);
    tm = __ldg(a.tmax + i);
  }
  const int oct = __shfl_sync(kFull, r.oct, 0);
  Best b;
  b.t = kAny ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
  int steps = 0;
  int leaf_visits = 0;
  int c = 0;
  for (int step = 0; c >= 0 && c < a.n_nodes && step < a.n_nodes; ++step) {
    if (kAny && __all_sync(kFull, b.tri >= 0 || tm < 0.0f)) break;
    const Rec q = load_rec(a.rows, c, oct);
    const int hl = hit_link(q);
    const float limit = kAny ? (b.tri >= 0 ? neg_inf : tm) : b.t;
    const bool hit_any = __any_sync(kFull, box_hit(r, q, a.tmin, limit));
    ++steps;
    int next = miss_link(q);
    if (hit_any) {
      if (hl >= 0) {
        next = hl;
      } else if (~hl < a.n_leaf_rows) {
        ++leaf_visits;
        const int lr = ~hl;
        if (lane < 20) {
          stage[warp][lane] = __ldg(
              reinterpret_cast<const float4*>(
                  a.leaves + static_cast<size_t>(lr) * kLeafFloats) +
              lane);
        }
        __syncwarp();
        const float* sf = reinterpret_cast<const float*>(stage[warp]);
        for (int k = 0; k < kLeafSize; ++k) {
          float f[9];
#pragma unroll
          for (int m = 0; m < 9; ++m) f[m] = sf[10 * k + m];
          // the first accepted slot blocks the lane; it stays in the
          // strand (no lane leaves before a vote)
          test_tri<kAny>(r, f, lr * kLeafSize + k, a.first, a.tmin, tm, &b);
        }
        __syncwarp();
      }
    }
    c = next;
  }
  if (a.stats != nullptr && lane == 0) {
    a.stats[2 * strand + 0] = steps;
    a.stats[2 * strand + 1] = leaf_visits;
  }
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}


// ---------------------------------------------------------------------
// The schedule form of the per-ray walk: raytpu's persistent kernel's
// schedule (strand_persistent.py:_persistent_kernel: the walker pool, the
// deferred leaf queue and its rounds, the fetch forms), on the same
// per-lane walk as walk_kernel. It is a kernel of its own, so walk_kernel's
// instances keep their code; its knobs are runtime arguments (Sched).
//
// The order, step for step (kernels/strand.py:_sched_torch replays it):
//
// * Pool. A batch is 32 rays, one warp's lanes (64 under kDual: lanes
//   0..31 and 32..63 of the batch are each thread's first and second ray).
//   The grid is persistent: as many blocks as the card holds resident for
//   the instance, or one a claim where the launch has fewer (the launcher
//   sizes it; raytpu's `walkers` is checked and adds no code). A claim is
//   `service_k` consecutive batches taken with one atomicAdd on s.work (a
//   64-bit counter the launcher zeroes on the launch's stream) for a
//   block: its warps take the claim's batches one at a time from a word in
//   shared memory (take), so one claim's batches are walked in parallel,
//   and the warp that finds the claim spent takes the next one (claim). A
//   claim at or past n_batches ends the block, so no warp reads past the
//   rays. Batches do not share state, so the results and the counters do
//   not depend on which warp took which batch.
// * Iteration `it` of a batch: `unroll` sub-steps, in each of which every
//   lane that can step takes one step (kWide: one fetch of up to
//   ribbon_k records, then up to ribbon_k sub-steps from them). A lane can
//   step while its cursor is a node (0 <= c < n_nodes), it has taken fewer
//   than n_nodes steps, and its queue holds fewer than kQcap leaves (a full
//   queue stalls the lane). A step's box test uses the lane's best t as
//   LIMIT (its tmax on any-hit lanes); a leaf that it hits is pushed on the
//   lane's queue and the lane goes on at the miss link.
// * On iterations with it % ctl_every == 0, the vote: a leaf round fires
//   when some ray slot holds a queued leaf and at least `occ` slots do, or
//   no lane can walk on (stalls aside), or some queue is full. A round
//   pops up to `flush_pop` leaves per slot, one pass at a time while any
//   slot still holds one; each pass tests every popping slot's leaf at the
//   warp's width, with the slot's best t at that moment. An any-hit slot
//   that is blocked stops and drops its queue.
// * The batch ends after the iteration at which no slot can walk on and
//   every queue is empty.
//
// The queue is a stack: a leaf is pushed at q[0] and popped from q[0]
// (raytpu's insert at lane 0 and pop from the head). Deferral only delays
// the moment a best t shrinks: a lane still tests every leaf on its path
// to the closest hit, and ties break on first[slot], so t and the tie key
// are the default walk's. An any-hit lane's blocked bit is too; which
// blocker it returns follows the schedule, and the plain version follows
// the same schedule.
//
// Fetch forms: kLoad loads the cursor's record when it steps. kPipe holds
// the cursor's record in registers and loads both successors (at its hit
// and miss links) before its box test runs, keeping the one the test picks
// (a register double buffer). kDual is kPipe with two rays per thread,
// each sub-step prefetching for both before testing either. Under kPipe
// and kDual, s.n_top > 0 (raytpu's fetch_smem) stages nodes
// 0..n_top-1, all 8 octants, in shared memory per block; a lane reads a
// record there while its cursor is below n_top. kWide walks ribbon rows
// (a.rpo per octant; hit == v + 1 in each octant's pre-order): a fetch
// loads the window of ribbon_k records from the cursor, cut at the end of
// its 16-node row, with 16-byte loads into the lane's slots of the warp's
// window in shared memory (kWidth records a lane), and the sub-steps read
// records there while the cursor stays inside it.
//
// Counters (s.counters, int32 [8], or null): per warp, one atomicAdd each
// after its last batch (a claim counted by the thread that took it), so
// the sums do not depend on order.
// ---------------------------------------------------------------------

constexpr int kQcap = 4;      // leaves a lane can queue (registers)
constexpr int kTopNodes = 64;  // fetch_smem: nodes staged (16 KB a block)
constexpr int kRowNodes = 16;  // nodes per ribbon row

enum Fetch { kLoad = 0, kPipe = 1, kDual = 2, kWide = 3 };

struct Sched {
  unsigned long long* work;  // the pool's claim counter, 0 at launch
  int* counters;             // int32 [8] (Stat), or null
  int n_batches;             // batches of 32 rays (64 under kDual)
  int service_k;             // batches per claim
  int occ;                   // queued slots that fire a round
  int flush_pop;             // pops per slot and round
  int ctl_mask;              // ctl_every - 1 (a power of two)
  int unroll;                // sub-steps per iteration
  int ribbon_k;              // kWide: records per fetch (<= kWidth)
  int n_top;                 // kPipe/kDual: staged nodes, 0 = none
};

// The dynamic shared memory of an instance: the staged top nodes (kPipe,
// kDual with s.n_top > 0), or every warp's window of kWidth records a lane
// (kWide: 32 bytes x kWidth x 32 lanes a warp)
template <int kBlock, int kFetch, int kWidth>
constexpr size_t sched_smem(int n_top) {
  return kFetch == kWide
             ? static_cast<size_t>(kBlock) * kWidth * 2 * sizeof(float4)
             : static_cast<size_t>(n_top) * kNodeFloats * sizeof(float);
}

struct Walker {
  Ray r;
  float tm;
  bool shad;
  Best b;
  int c, steps, qn;
  int q[kQcap];
  Rec cur;  // kPipe, kDual: the record of c
  int loads, tests, enq;
};

template <bool kAny, bool kMixed, int kFetch, int kWidth>
struct SchedWalk {
  const Args& a;
  const Sched& s;
  const float4* top;  // the staged nodes (n_top * 16 float4)
  float4* win;        // kWide: the warp's window, row 2j + h of 32 lanes
                      // holding half h of each lane's record j
  float slab_tmin;

  __device__ __forceinline__ bool walkable(const Walker& w) const {
    return w.c >= 0 && w.c < a.n_nodes && w.steps < a.n_nodes;
  }

  __device__ __forceinline__ bool can_step(const Walker& w) const {
    return walkable(w) && w.qn < kQcap;
  }

  __device__ __forceinline__ const float* rec_ptr(const Walker& w,
                                                  int c) const {
    if (kFetch == kWide) {
      return a.rows + (static_cast<size_t>(w.r.oct) * a.rpo * kRowNodes +
                       c) * 8;
    }
    return a.rows + static_cast<size_t>(c) * kNodeFloats + w.r.oct * 8;
  }

  __device__ __forceinline__ Rec fetch(Walker& w, int c) const {
    ++w.loads;
    if ((kFetch == kPipe || kFetch == kDual) && c < s.n_top) {
      const float4* p = top + c * (kNodeFloats / 4) + w.r.oct * 2;
      Rec x;
      x.a = p[0];
      x.b = p[1];
      return x;
    }
    return load_box(rec_ptr(w, c));
  }

  __device__ __forceinline__ void init(Walker& w, int i) const {
    const bool real = i < a.n_rays;
    w.r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
    w.tm = -kF32Max;
    w.shad = false;
    if (real) {
      w.r = load_ray(a.ro, a.rd, i);
      w.tm = __ldg(a.tmax + i);
      if (kMixed) w.shad = __ldg(a.smask + i) == 1.0f;
    }
    w.b.t = (kMixed ? w.shad : kAny) ? w.tm : nan_min(kF32Max, w.tm);
    w.b.tri = -1;
    w.b.key = -1;
    w.c = real ? 0 : -1;
    w.steps = 0;
    w.qn = 0;
#pragma unroll
    for (int j = 0; j < kQcap; ++j) w.q[j] = -1;
    if ((kFetch == kPipe || kFetch == kDual) && real) w.cur = fetch(w, 0);
  }

  __device__ __forceinline__ void push(Walker& w, int lr) const {
#pragma unroll
    for (int j = kQcap - 1; j > 0; --j) w.q[j] = w.q[j - 1];
    w.q[0] = lr;
    ++w.qn;
    ++w.enq;
  }

  // one step on q, the record of w.c: the box test, then the hit link, a
  // leaf pushed, or the miss link; returns whether the box was hit
  __device__ __forceinline__ bool advance(Walker& w, const Rec& q) const {
    ++w.steps;
    const int hl = hit_link(q);
    w.c = miss_link(q);
    const bool hit =
        box_hit(w.r, q, slab_tmin, (kAny && !kMixed) ? w.tm : w.b.t);
    if (hit) {
      if (hl >= 0) {
        w.c = hl;
      } else if (~hl < a.n_leaf_rows) {
        push(w, ~hl);
      }
    }
    return hit;
  }

  // kPipe/kDual: load both successors of the held record (before the box
  // test that picks one)
  __device__ __forceinline__ void prefetch(Walker& w, bool go, Rec* h,
                                           Rec* m) const {
    *h = w.cur;
    *m = w.cur;
    if (!go) return;
    const int hl = hit_link(w.cur);
    const int ml = miss_link(w.cur);
    if (hl >= 0 && hl < a.n_nodes) *h = fetch(w, hl);
    if (ml >= 0 && ml < a.n_nodes) *m = fetch(w, ml);
  }

  __device__ __forceinline__ void advance_held(Walker& w, bool go,
                                               const Rec& h,
                                               const Rec& m) const {
    if (!go) return;
    const bool descend = advance(w, w.cur) && hit_link(w.cur) >= 0;
    w.cur = descend ? h : m;
  }

  __device__ __forceinline__ void load_step(Walker& w) const {
    if (can_step(w)) advance(w, fetch(w, w.c));
  }

  // kWide: one fetch of the window [c, c + n) into the warp's window in
  // shared memory, then its sub-steps
  __device__ __forceinline__ void wide_iteration(Walker& w) const {
    const int lane = threadIdx.x & 31;
    int n = 0;
    const int base = w.c;
    if (can_step(w)) {
      n = min(min(s.ribbon_k, kRowNodes - (base & (kRowNodes - 1))),
              a.n_nodes - base);
      ++w.loads;
      const float* p = rec_ptr(w, base);
#pragma unroll
      for (int j = 0; j < kWidth; ++j) {
        if (j < n) {
          const Rec x = load_box(p + 8 * j);
          win[(2 * j) * 32 + lane] = x.a;
          win[(2 * j + 1) * 32 + lane] = x.b;
        }
      }
    }
#pragma unroll
    for (int sub = 0; sub < kWidth; ++sub) {
      if (sub >= s.ribbon_k) break;
      const int j = w.c - base;
      const bool go = can_step(w) && j >= 0 && j < n;
      if (!__any_sync(kFull, go)) break;
      if (go) {
        Rec q;
        q.a = win[(2 * j) * 32 + lane];
        q.b = win[(2 * j + 1) * 32 + lane];
        advance(w, q);
      }
    }
  }

  __device__ __forceinline__ void pop_test(Walker& w) const {
    if (w.qn <= 0) return;
    const int lr = w.q[0];
#pragma unroll
    for (int j = 0; j < kQcap - 1; ++j) w.q[j] = w.q[j + 1];
    --w.qn;
    ++w.tests;
    bool blocked;
    if (kMixed) {
      blocked = w.shad ? test_leaf<true>(w.r, a.leaves, a.first, lr,
                                         a.shadow_tmin, w.tm, &w.b)
                       : test_leaf<false>(w.r, a.leaves, a.first, lr,
                                          a.tmin, w.tm, &w.b);
    } else {
      blocked =
          test_leaf<kAny>(w.r, a.leaves, a.first, lr, a.tmin, w.tm, &w.b);
    }
    if (blocked) {  // blocked: stop, drop the queue
      w.c = -1;
      w.qn = 0;
    }
  }

  __device__ __forceinline__ void finish(const Walker& w, int i) const {
    if (i < a.n_rays) {
      a.t_out[i] = w.b.t;
      a.tri_out[i] = w.b.tri;
    }
  }

  // walk batch `bt` to its end; returns the leaf rounds it fired
  __device__ __forceinline__ int batch(int bt, int lane, Walker& w0,
                                       Walker& w1) const {
    constexpr bool kTwo = kFetch == kDual;
    const int i0 = bt * (kTwo ? 64 : 32) + lane;
    init(w0, i0);
    if (kTwo) init(w1, i0 + 32);
    int rounds = 0;
    for (int it = 0;; ++it) {
      if (kFetch == kWide) {
        wide_iteration(w0);
      } else {
        for (int u = 0; u < s.unroll; ++u) {
          const bool g0 = can_step(w0);
          const bool g1 = kTwo && can_step(w1);
          if (!__any_sync(kFull, g0 || g1)) break;
          if (kFetch == kLoad) {
            load_step(w0);
          } else {
            Rec h0, m0, h1, m1;
            prefetch(w0, g0, &h0, &m0);
            if (kTwo) prefetch(w1, g1, &h1, &m1);
            advance_held(w0, g0, h0, m0);
            if (kTwo) advance_held(w1, g1, h1, m1);
          }
        }
      }
      if ((it & s.ctl_mask) == 0) {
        int nq = __popc(__ballot_sync(kFull, w0.qn > 0));
        if (kTwo) nq += __popc(__ballot_sync(kFull, w1.qn > 0));
        const bool live = __any_sync(
            kFull, walkable(w0) || (kTwo && walkable(w1)));
        const bool full = __any_sync(
            kFull, w0.qn >= kQcap || (kTwo && w1.qn >= kQcap));
        if (nq > 0 && (nq >= s.occ || !live || full)) {
          ++rounds;
          for (int p = 0; p < s.flush_pop; ++p) {
            if (!__any_sync(kFull, w0.qn > 0 || (kTwo && w1.qn > 0))) break;
            pop_test(w0);
            if (kTwo) pop_test(w1);
          }
        }
      }
      if (!__any_sync(kFull, walkable(w0) || w0.qn > 0 ||
                                 (kTwo && (walkable(w1) || w1.qn > 0)))) {
        break;
      }
    }
    finish(w0, i0);
    if (kTwo) finish(w1, i0 + 32);
    return rounds;
  }
};

// A claim for the block: service_k batches from s.work into *pool (the
// claim's first batch, capped at n_batches, in the high word; batches
// handed out, 0, in the low word). Returns 1 if the claim holds a batch.
__device__ __forceinline__ int claim(const Sched& s,
                                     unsigned long long* pool) {
  const unsigned long long n = static_cast<unsigned long long>(s.n_batches);
  const unsigned long long g =
      atomicAdd(s.work, static_cast<unsigned long long>(s.service_k));
  atomicExch(pool, (g < n ? g : n) << 32);
  return g < n ? 1 : 0;
}

// The next batch of the block's claim for the calling thread (lane 0 of a
// batch's first warp), taking the next claim when this one is spent (the
// thread that draws index service_k takes it; any later one waits for
// it); -1 when no batch is left. *claims counts the claims taken.
__device__ __forceinline__ int take(const Sched& s, unsigned long long* pool,
                                    int* claims) {
  const unsigned k = static_cast<unsigned>(s.service_k);
  for (;;) {
    const unsigned long long old = atomicAdd(pool, 1ull);
    const long long first = static_cast<long long>(old >> 32);
    const unsigned j = static_cast<unsigned>(old);
    if (first >= s.n_batches) return -1;
    if (j < k) return first + j < s.n_batches ? static_cast<int>(first + j)
                                              : -1;
    if (j == k) {
      *claims += claim(s, pool);
    } else {
      while (static_cast<long long>(
                 *reinterpret_cast<volatile unsigned long long*>(pool) >>
                 32) == first) {
        __nanosleep(64);
      }
    }
  }
}

template <int kBlock, bool kAny, bool kMixed, int kFetch, int kWidth = 1>
__global__ void __launch_bounds__(kBlock) sched_kernel(Args a, Sched s) {
  extern __shared__ float4 top[];  // the staged nodes, or the windows
  __shared__ unsigned long long pool;
  if (kFetch == kPipe || kFetch == kDual) {
    const float4* rows4 = reinterpret_cast<const float4*>(a.rows);
    for (int k = threadIdx.x; k < s.n_top * (kNodeFloats / 4); k += kBlock) {
      top[k] = __ldg(rows4 + k);
    }
  }
  int claims = 0;
  if (threadIdx.x == 0) claims = claim(s, &pool);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const SchedWalk<kAny, kMixed, kFetch, kWidth> walk{
      a, s, top,
      kFetch == kWide ? top + (threadIdx.x >> 5) * kWidth * 64 : nullptr,
      kMixed ? fminf(a.tmin, a.shadow_tmin) : a.tmin};
  Walker w0, w1;
  w0.loads = w0.tests = w0.enq = 0;
  w1.loads = w1.tests = w1.enq = 0;
  int rounds = 0, installs = 0;
  for (;;) {
    int bt = -1;
    if (lane == 0) bt = take(s, &pool, &claims);
    bt = __shfl_sync(kFull, bt, 0);
    if (bt < 0) break;
    ++installs;
    rounds += walk.batch(bt, lane, w0, w1);
  }
  if (s.counters != nullptr) {
    const int loads = __reduce_add_sync(kFull, w0.loads + w1.loads);
    const int tests = __reduce_add_sync(kFull, w0.tests + w1.tests);
    const int enq = __reduce_add_sync(kFull, w0.enq + w1.enq);
    const int taken = __reduce_add_sync(kFull, claims);
    if (lane == 0) {
      atomicAdd(s.counters + kLoads, loads);
      atomicAdd(s.counters + kRounds, rounds);
      atomicAdd(s.counters + kClaims, taken);
      atomicAdd(s.counters + kInstalls, installs);
      atomicAdd(s.counters + kLeafTests, tests);
      atomicAdd(s.counters + kLeafReached, enq);
    }
  }
}

// ---------------------------------------------------------------------
// The block walk's deferral form (raytpu's _strand_kernel with its leaf
// queue, strand.py:258-298, and `groups`, `skip_done`): block_kernel's
// walker, one warp per 32-ray strand, with G = blockDim.x / 32 strands a
// block walking in lock-step, one step an iteration.
//
// * Step: an active walker (0 <= c < n_nodes, fewer than n_nodes steps)
//   loads its record and votes its box test as block_kernel does; at a hit
//   leaf it pushes the row on its queue (a stack of kBlockQcap rows in
//   shared memory) and goes on at the miss link. An any-hit walker whose
//   lanes are all blocked or dead stops and drops its queue first.
// * Vote (the block's): a leaf round fires when every walker is queued or
//   finished and one is queued, or some queue is full. In a round each
//   queued walker pops its top row, stages it in shared memory (20 float4
//   by lanes 0..19) and every lane tests the 8 slots, as block_kernel.
// * skip_done off (raytpu's default): a finished walker still loads the
//   root record each step and a walker with nothing queued still stages
//   row 0 in a round, as raytpu's fixed-shape tiles do; on, both skip.
// * The block ends after the iteration at which no walker is active and
//   every queue is empty. Stats (a.stats, int32 [S, 3], or null): each
//   strand's steps, leaves pushed, and its block's leaf rounds.
//
// Residency: each step waits on one dependent record load, and lock-step
// holds a block until its slowest walker ends, so what the card can hide
// depends on the warps it holds. The launch bounds ask for two blocks of
// 1024 threads a multiprocessor, i.e. at most 32 registers (a few values
// spill): four blocks of G = 16, 64 warps, where 55 registers held two.
// ---------------------------------------------------------------------

constexpr int kBlockQcap = 16;  // rows a walker can queue

template <bool kAny>
__global__ void __launch_bounds__(1024, 2)
    defer_kernel(Args a, int skip_done) {
  extern __shared__ float4 dsm[];
  const int groups = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* stage = dsm + warp * (kLeafFloats / 4);
  int* queue = reinterpret_cast<int*>(dsm + groups * (kLeafFloats / 4)) +
               warp * kBlockQcap;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  const int n_strands = (a.n_rays + 31) / 32;
  const int strand = blockIdx.x * groups + warp;
  const int i = strand * 32 + lane;
  const bool real = i < a.n_rays;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float tm = neg_inf;
  if (real) {
    r = load_ray(a.ro, a.rd, i);
    tm = __ldg(a.tmax + i);
  }
  const int oct = __shfl_sync(kFull, r.oct, 0);
  Best b;
  b.t = kAny ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
  int c = strand < n_strands ? 0 : -1;
  int steps = 0, visits = 0, rounds = 0, qn = 0;
  for (;;) {
    if (kAny && __all_sync(kFull, b.tri >= 0 || tm < 0.0f)) {
      c = -1;
      qn = 0;
    }
    const bool act = c >= 0 && c < a.n_nodes && steps < a.n_nodes;
    if (act || !skip_done) {
      const Rec q = load_rec(a.rows, act ? c : 0, oct);
      if (act) {
        const int hl = hit_link(q);
        const float limit = kAny ? (b.tri >= 0 ? neg_inf : tm) : b.t;
        const bool hit_any =
            __any_sync(kFull, box_hit(r, q, a.tmin, limit));
        ++steps;
        c = miss_link(q);
        if (hit_any) {
          if (hl >= 0) {
            c = hl;
          } else if (~hl < a.n_leaf_rows) {
            ++visits;
            if (lane == 0) queue[qn] = ~hl;
            ++qn;
          }
        }
      }
    }
    const bool walking = c >= 0 && c < a.n_nodes && steps < a.n_nodes;
    const bool all_ready = __syncthreads_and(qn > 0 || !walking);
    const bool any_queued = __syncthreads_or(qn > 0);
    const bool any_full = __syncthreads_or(qn >= kBlockQcap);
    if ((all_ready && any_queued) || any_full) {
      ++rounds;
      const bool pop = qn > 0;
      int lr = 0;
      if (pop) {
        --qn;
        lr = queue[qn];
      }
      if (pop || !skip_done) {
        if (lane < 20) {
          stage[lane] = __ldg(
              reinterpret_cast<const float4*>(
                  a.leaves + static_cast<size_t>(lr) * kLeafFloats) +
              lane);
        }
        __syncwarp();
        if (pop) {
          const float* sf = reinterpret_cast<const float*>(stage);
          for (int k = 0; k < kLeafSize; ++k) {
            float f[9];
#pragma unroll
            for (int m = 0; m < 9; ++m) f[m] = sf[10 * k + m];
            test_tri<kAny>(r, f, lr * kLeafSize + k, a.first, a.tmin, tm,
                           &b);
          }
        }
        __syncwarp();
      }
    }
    if (!__syncthreads_or(walking || qn > 0)) break;
  }
  if (a.stats != nullptr && strand < n_strands && lane == 0) {
    a.stats[3 * strand + 0] = steps;
    a.stats[3 * strand + 1] = visits;
    a.stats[3 * strand + 2] = rounds;
  }
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}

}  // namespace strand
