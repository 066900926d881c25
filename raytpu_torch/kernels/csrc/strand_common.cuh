// strand_common.cuh — the two walks over the octant-threaded strand tree
// that strand_walk.cu (one thread per ray) and strand_block.cu (one warp
// per 32-ray strand) launch, on the shared arithmetic of walk_common.cuh.
//
// Layout (raytpu_torch/accel/strandtree.py): node c's record for octant o
// is the 8 floats at rows + c*64 + o*8: bmin.xyz, bmax.xyz, hit, miss —
// 32 bytes, 32-byte aligned, so two float4 loads (a walk::Box). Links are
// value-cast floats. hit < 0 marks a leaf whose triangles sit in leaf row
// ~hit (8 triangles x p0, e1, e2, pad = 80 floats, 320 bytes); after a
// leaf the walk follows miss; -1 terminates.

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
  int* stats;  // block walk: per-strand steps and leaf visits, or null
  const float* smask;  // mixed walk: 1.0 flags a shadow lane, or null
  int n_rays, n_nodes, n_leaf_rows;
  float tmin, shadow_tmin;
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
// ---------------------------------------------------------------------
template <int kBlock, bool kAny, bool kMixed = false>
__global__ void __launch_bounds__(kBlock) walk_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5)) * 32;
  if (base >= a.n_rays) return;  // warp-uniform
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
  for (;;) {
    for (;;) {
      const bool stepping =
          leaf < 0 && c >= 0 && c < a.n_nodes && steps < a.n_nodes;
      if (!__any_sync(kFull, stepping)) break;
      if (stepping) {
        const Rec q = load_rec(a.rows, c, r.oct);
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

}  // namespace strand
