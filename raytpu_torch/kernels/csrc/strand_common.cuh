// strand_common.cuh — the arithmetic and the two walks over the
// octant-threaded strand tree that strand_walk.cu (one thread per ray) and
// strand_block.cu (one warp per 32-ray strand) launch.
//
// Layout (raytpu_torch/accel/strandtree.py): node c's record for octant o
// is the 8 floats at rows + c*64 + o*8: bmin.xyz, bmax.xyz, hit, miss —
// 32 bytes, 32-byte aligned, so two float4 loads. Links are value-cast
// floats. hit < 0 marks a leaf whose triangles sit in leaf row ~hit (8
// triangles x p0, e1, e2, pad = 80 floats, 320 bytes: triangles 2j and
// 2j+1 are the 16-byte-aligned floats 20j .. 20j+19); after a leaf the walk
// follows miss; -1 terminates. first[slot] is the lowest slot holding the
// same 9 floats: the closest-hit tie key (kernels/strand.py:first_slots).
//
// Float rules, shared bit for bit with the plain versions
// (kernels/strand.py): the build passes --fmad=false, -prec-div=true and
// -ftz=false, every expression keeps raytpu's association, and max/min
// propagate NaN like torch.maximum/minimum. The box test is conservative:
// near <= far * kFarScale (kFarScale = 1 + 3 * 2^-23, Ize's 1 + 2 gamma_3
// rounded to f32), which only adds box and leaf tests.

#pragma once

#include <cuda_runtime.h>

namespace strand {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr float kFarScale = 1.00000035762786865234375f;  // 1 + 3 * 2^-23
constexpr int kNodeFloats = 64;   // 8 octants x 8 floats per node
constexpr int kLeafSize = 8;
constexpr int kLeafFloats = 80;   // 8 triangles x 10 floats
constexpr unsigned kFull = 0xffffffffu;

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

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  bool nx, ny, nz;
  int oct;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.nx = r.ix < 0.0f; r.ny = r.iy < 0.0f; r.nz = r.iz < 0.0f;
  r.oct = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
  return r;
}

// one node record: a = bmin.xyz, bmax.x; b = bmax.yz, hit, miss
struct Rec {
  float4 a, b;
};

__device__ __forceinline__ Rec load_rec(const float* __restrict__ rows,
                                        int c, int oct) {
  const float4* p = reinterpret_cast<const float4*>(
      rows + static_cast<size_t>(c) * kNodeFloats + oct * 8);
  Rec q;
  q.a = __ldg(p);
  q.b = __ldg(p + 1);
  return q;
}

__device__ __forceinline__ int hit_link(const Rec& q) {
  return static_cast<int>(q.b.z);
}

__device__ __forceinline__ int miss_link(const Rec& q) {
  return static_cast<int>(q.b.w);
}

// raytpu's slab test, made conservative
__device__ __forceinline__ bool box_hit(const Ray& r, const Rec& q,
                                        float tmin, float limit) {
  const float bx0 = q.a.x, by0 = q.a.y, bz0 = q.a.z;
  const float bx1 = q.a.w, by1 = q.b.x, bz1 = q.b.y;
  const float lox = ((r.nx ? bx1 : bx0) - r.ox) * r.ix;
  const float hix = ((r.nx ? bx0 : bx1) - r.ox) * r.ix;
  const float loy = ((r.ny ? by1 : by0) - r.oy) * r.iy;
  const float hiy = ((r.ny ? by0 : by1) - r.oy) * r.iy;
  const float loz = ((r.nz ? bz1 : bz0) - r.oz) * r.iz;
  const float hiz = ((r.nz ? bz0 : bz1) - r.oz) * r.iz;
  const float t_near = nan_max(nan_max(lox, loy), nan_max(loz, tmin));
  const float t_far = nan_min(nan_min(hix, hiy), nan_min(hiz, limit));
  return t_near <= t_far * kFarScale;
}

// Moller-Trumbore in raytpu's order, (ax*bx + ay*by) + az*bz, on the
// triangle's p0, e1, e2 at tp[0..8]: t, and whether (det, u, v) accept
__device__ __forceinline__ float moller_trumbore(const Ray& r,
                                                 const float* tp,
                                                 bool* geo) {
  const float p0x = tp[0], p0y = tp[1], p0z = tp[2];
  const float e1x = tp[3], e1y = tp[4], e1z = tp[5];
  const float e2x = tp[6], e2y = tp[7], e2z = tp[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / det;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *geo = (det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  return t;
}

// A ray's running result. Closest-hit keeps the smallest (t, key) pair,
// the first tested on equal pairs; any-hit keeps the first accepted slot.
struct Best {
  float t;
  int tri, key;
};

// Test one triangle (slot `slot`, floats at tp) in the walks' accept
// order; true when an any-hit ray is blocked by it.
template <bool kAny>
__device__ __forceinline__ bool test_tri(const Ray& r, const float* tp,
                                         int slot,
                                         const int* __restrict__ first,
                                         float tmin, float tm, Best* b) {
  bool geo;
  const float t = moller_trumbore(r, tp, &geo);
  if (kAny) {
    if (b->tri < 0 && geo && t >= tmin && t <= tm) {
      b->tri = slot;
      return true;
    }
    return false;
  }
  if (geo && t >= tmin && t <= b->t) {
    const int key = __ldg(first + slot);
    if (t < b->t || key < b->key) {
      b->t = t;
      b->tri = slot;
      b->key = key;
    }
  }
  return false;
}

// Test leaf row lr's 8 triangles in slot order from global memory, a pair
// (five float4) at a time; true when an any-hit ray is blocked (the rest of
// the row is then skipped).
template <bool kAny>
__device__ __forceinline__ bool test_leaf(const Ray& r,
                                          const float* __restrict__ leaves,
                                          const int* __restrict__ first,
                                          int lr, float tmin, float tm,
                                          Best* b) {
  const float* lf = leaves + static_cast<size_t>(lr) * kLeafFloats;
  for (int j = 0; j < kLeafSize / 2; ++j) {
    float f[20];
    const float4* p = reinterpret_cast<const float4*>(lf + 20 * j);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 x = __ldg(p + q);
      f[4 * q + 0] = x.x; f[4 * q + 1] = x.y;
      f[4 * q + 2] = x.z; f[4 * q + 3] = x.w;
    }
    const int slot = lr * kLeafSize + 2 * j;
    if (test_tri<kAny>(r, f, slot, first, tmin, tm, b)) return true;
    if (test_tri<kAny>(r, f + 10, slot + 1, first, tmin, tm, b)) return true;
  }
  return false;
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
  int n_rays, n_nodes, n_leaf_rows;
  float tmin;
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
// ---------------------------------------------------------------------
template <int kBlock, bool kAny>
__global__ void __launch_bounds__(kBlock) walk_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5)) * 32;
  if (base >= a.n_rays) return;  // warp-uniform
  const int i = base + lane;
  const bool real = i < a.n_rays;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float tm = -kF32Max;
  if (real) {
    r = make_ray(__ldg(a.ro + 3 * i + 0), __ldg(a.ro + 3 * i + 1),
                 __ldg(a.ro + 3 * i + 2), __ldg(a.rd + 3 * i + 0),
                 __ldg(a.rd + 3 * i + 1), __ldg(a.rd + 3 * i + 2));
    tm = __ldg(a.tmax + i);
  }
  // closest: LIMIT = best t from min(F32_MAX, tmax) (a dead lane with
  // tmax = -inf returns t = -inf, tri = -1); any-hit: LIMIT = tmax
  Best b;
  b.t = kAny ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
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
        if (box_hit(r, q, a.tmin, kAny ? tm : b.t)) {
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
      if (test_leaf<kAny>(r, a.leaves, a.first, leaf, a.tmin, tm, &b)) {
        c = -1;  // blocked: stop
      }
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
    r = make_ray(__ldg(a.ro + 3 * i + 0), __ldg(a.ro + 3 * i + 1),
                 __ldg(a.ro + 3 * i + 2), __ldg(a.rd + 3 * i + 0),
                 __ldg(a.rd + 3 * i + 1), __ldg(a.rd + 3 * i + 2));
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
