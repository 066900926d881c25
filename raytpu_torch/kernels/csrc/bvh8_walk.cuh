// bvh8_walk.cuh — one lane's stack walk of an 8-wide BVH, shared by
// packet_walk.cu (the whole tree) and binned_walk.cu (one treelet window).
//
// Layout (raytpu_torch/accel/bvh.py, accel/treelets.py): node n is the 128
// floats at nodes + n*128; child k sits at columns 16k..16k+6: bmin.xyz,
// bmax.xyz, then the link as int32 BITS (read with __float_as_int, never a
// value cast): a child node, or ~leaf_row for a leaf. A child is two
// float4 (walk_common.cuh:Box). Empty child slots carry an inverted box
// (bmin > bmax); the slab test does not order-normalise its intervals, so
// they miss every ray.
//
// The walk, kept bit for bit by the plain versions (kernels/packet.py,
// kernels/binned.py): pop a node; test its 8 children's boxes against one
// LIMIT, read at the pop; push the hit interior children from child 7 down
// to child 0 (so child 0 is popped next); then test the hit leaves from
// child 0 up. Pushes clamp at kDepth - 1 as raytpu's do (the pack's depth
// check keeps real trees below it), and a walk pops at most as many nodes
// as the tree has.
//
// The traversal is Aila-Laine "while-while" with postponed leaves: a lane
// pops nodes until it holds the hit leaves of its last node, or is done,
// and the warp tests leaves once no lane is still stepping, so triangle
// tests run at the warp's width. A lane holding leaves waits (no
// speculative steps), so each lane walks as it would alone.

#pragma once

#include "walk_common.cuh"

namespace bvh8 {

using namespace walk;

constexpr int kNodeFloats = 128;  // 8 children x 16 floats

// One lane's walk from the root of `nodes` (n_nodes rows, n_leaf_rows leaf
// rows). `limit` points at the LIMIT, read once per popped node; leaf(row)
// tests a leaf row and returns true when the lane is blocked, which ends
// its walk. Every lane of the warp must call this (a lane with no walk
// passes live = false).
template <int kDepth, class Leaf>
__device__ __forceinline__ void walk(const float* __restrict__ nodes,
                                     int n_nodes, int n_leaf_rows,
                                     const Ray& r, float slab_tmin,
                                     const float* limit, bool live,
                                     Leaf&& leaf) {
  int stack[kDepth];
  int sp = 0;
  if (live) stack[sp++] = 0;
  int pops = 0;
  bool done = false;
  unsigned pend = 0;  // the hit leaves of pend_nd, a bit per child
  const float* pend_nd = nodes;
  for (;;) {
    for (;;) {
      const bool stepping = pend == 0 && sp > 0 && pops < n_nodes && !done;
      if (!__any_sync(kFull, stepping)) break;
      if (stepping) {
        const float* nd = nodes + static_cast<size_t>(stack[--sp]) *
                                      kNodeFloats;
        ++pops;
        const float lim = *limit;
        int link[8];
        unsigned inner = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const Box x = load_box(nd + 16 * k);
          link[k] = __float_as_int(x.b.z);
          if (!box_hit(r, x, slab_tmin, lim)) continue;
          if (link[k] >= 0) {
            if (link[k] < n_nodes) inner |= 1u << k;
          } else if (~link[k] < n_leaf_rows) {
            pend |= 1u << k;
          }
        }
#pragma unroll
        for (int k = 7; k >= 0; --k) {
          if ((inner >> k) & 1) {
            stack[min(sp, kDepth - 1)] = link[k];
            sp = min(sp + 1, kDepth - 1);
          }
        }
        pend_nd = nd;
      }
    }
    if (!__any_sync(kFull, pend != 0)) break;
    while (__any_sync(kFull, pend != 0)) {
      if (pend != 0) {
        const int k = __ffs(pend) - 1;
        pend &= pend - 1;
        if (leaf(~__float_as_int(__ldg(pend_nd + 16 * k + 6)))) {
          done = true;
          pend = 0;
        }
      }
    }
  }
}

}  // namespace bvh8
