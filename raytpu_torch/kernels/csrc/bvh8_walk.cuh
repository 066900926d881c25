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
//
// kNearFirst (raytpu's `ordered`, the packet walk only) visits a node's
// hit children by the ray's own entry distance: each child gets the key
// (bits(near + 0) & ~7) | k (near >= tmin >= 0 for a hit, and + 0 turns
// -0 into +0, so the bits order as the floats do; a missed child gets
// 0x7ffffff8 | k, after every hit one), the 8 keys are sorted, interior
// children are pushed far-first (so the nearest is popped next) and
// leaves are tested near-first. The plain version sorts the same integer
// keys, so it keeps the kernel's bits. Only the order among two or more
// hit interior children, or two or more hit leaves, is the keys': a lane
// that holds no such pair (97.9% of the pops on the 1080p gallery's
// primary wave, PERF.md) pushes its one interior child, whose link it
// kept from the box tests, and queues its one leaf, without keys or a
// sort. A lane that holds one forms the keys from the entry distances it
// kept, sorts them and reads each pushed child's link again from the node
// row (in L1 since the box loads).

#pragma once

#include "walk_common.cuh"

namespace bvh8 {

using namespace walk;

constexpr int kNodeFloats = 128;  // 8 children x 16 floats

__device__ __forceinline__ void order(unsigned& x, unsigned& y) {
  const unsigned lo = min(x, y);
  y = max(x, y);
  x = lo;
}

// Batcher's odd-even merge sort of 8 keys, ascending
__device__ __forceinline__ void sort8(unsigned* c) {
  order(c[0], c[1]); order(c[2], c[3]); order(c[4], c[5]); order(c[6], c[7]);
  order(c[0], c[2]); order(c[1], c[3]); order(c[4], c[6]); order(c[5], c[7]);
  order(c[1], c[2]); order(c[5], c[6]); order(c[0], c[4]); order(c[3], c[7]);
  order(c[1], c[5]); order(c[2], c[6]); order(c[1], c[4]); order(c[3], c[6]);
  order(c[2], c[4]); order(c[3], c[5]); order(c[3], c[4]);
}

// child k's link, read again from the node row (in L1 since the pop
// loaded its boxes), where k is known only at run time
__device__ __forceinline__ int link_at(const float* nd, unsigned k) {
  return __float_as_int(__ldg(nd + 16 * k + 6));
}

// One lane's walk from the root of `nodes` (n_nodes rows, n_leaf_rows leaf
// rows). `limit` points at the LIMIT, read once per popped node; leaf(row)
// tests a leaf row and returns true when the lane is blocked, which ends
// its walk. Every lane of the warp must call this (a lane with no walk
// passes live = false). Returns the number of nodes the lane popped.
template <int kDepth, bool kNearFirst = false, class Leaf>
__device__ __forceinline__ int walk(const float* __restrict__ nodes,
                                    int n_nodes, int n_leaf_rows,
                                    const Ray& r, float slab_tmin,
                                    const float* limit, bool live,
                                    Leaf&& leaf) {
  int stack[kDepth];
  int sp = 0;
  if (live) stack[sp++] = 0;
  int pops = 0;
  bool done = false;
  // the hit leaves of pend_nd still to test: in storage order a bit per
  // child; near-first, child index + 1 in 4 bits each, the next lowest
  unsigned pend = 0;
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
        if constexpr (kNearFirst) {
          float nr[8];        // each child's entry distance
          unsigned hits = 0;  // the hit children
          unsigned leaves = 0;
          int one = 0;  // the link of the last hit interior child
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const Box x = load_box(nd + 16 * k);
            const int lk = __float_as_int(x.b.z);
            float near;
            const bool hit = slab(r, x, slab_tmin, lim, &near);
            nr[k] = near;
            if (!hit) continue;
            hits |= 1u << k;
            if (lk >= 0) {
              if (lk < n_nodes) {
                inner |= 1u << k;
                one = lk;
              }
            } else if (~lk < n_leaf_rows) {
              leaves |= 1u << k;
            }
          }
          // the order is the keys' only where the lane holds two hit
          // interior children or two hit leaves; else it pushes its one
          // child and queues its one leaf unsorted
          const bool many = ((inner & (inner - 1)) | (leaves & (leaves - 1)))
                            != 0;
          if (many) {
            unsigned key[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              key[k] = ((hits >> k) & 1)
                           ? (__float_as_uint(nr[k] + 0.0f) & ~7u) | k
                           : 0x7ffffff8u | k;
            }
            sort8(key);
#pragma unroll
            for (int j = 7; j >= 0; --j) {
              const unsigned k = key[j] & 7u;
              if ((inner >> k) & 1) {
                stack[min(sp, kDepth - 1)] = link_at(nd, k);
                sp = min(sp + 1, kDepth - 1);
              }
              if ((leaves >> k) & 1) pend = (pend << 4) | (k + 1);
            }
          } else {
            if (inner != 0) {
              stack[min(sp, kDepth - 1)] = one;
              sp = min(sp + 1, kDepth - 1);
            }
            pend = __ffs(leaves);  // the leaf's k + 1, or 0
          }
        } else {
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
        }
        pend_nd = nd;
      }
    }
    if (!__any_sync(kFull, pend != 0)) break;
    while (__any_sync(kFull, pend != 0)) {
      if (pend != 0) {
        int k;
        if constexpr (kNearFirst) {
          k = static_cast<int>(pend & 15u) - 1;
          pend >>= 4;
        } else {
          k = __ffs(pend) - 1;
          pend &= pend - 1;
        }
        if (leaf(~__float_as_int(__ldg(pend_nd + 16 * k + 6)))) {
          done = true;
          pend = 0;
        }
      }
    }
  }
  return pops;
}

}  // namespace bvh8
