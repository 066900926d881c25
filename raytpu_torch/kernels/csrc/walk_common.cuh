// walk_common.cuh — the ray and triangle arithmetic that every walk of the
// port shares: strand_walk.cu and strand_block.cu (through
// strand_common.cuh), packet_walk.cu and binned_walk.cu. One copy of the
// float rules, held bit for bit by the walks' plain torch versions
// (kernels/strand.py, kernels/packet.py, kernels/binned.py).
//
// Float rules: the build passes --fmad=false, -prec-div=true and
// -ftz=false, every expression keeps raytpu's association, and max/min
// propagate NaN like torch.maximum/minimum. The box test is conservative:
// near <= far * kFarScale (kFarScale = 1 + 3 * 2^-23, Ize's 1 + 2 gamma_3
// rounded to f32), which only adds box and leaf tests.
//
// Layouts: a box is two float4, bmin.xyz and bmax.x, then bmax.yz and two
// link words; a strand tree record and a BVH8 child (columns 16k..16k+7 of
// a node row) both have it, 16-byte aligned. A leaf row holds 8 triangles
// of 10 floats (p0, e1, e2, then a pad or the triangle's global slot as
// int32 bits); triangles 2j and 2j+1 are the 16-byte-aligned floats
// 20j .. 20j+19, five float4. first[slot] is the lowest slot holding the
// same 9 floats: the closest-hit tie key (kernels/strand.py:first_slots).

#pragma once

#include <cuda_runtime.h>

namespace walk {

constexpr float kF32Max = 3.40282347e38f;
constexpr float kTiny = 1e-36f;
constexpr float kFarScale = 1.00000035762786865234375f;  // 1 + 3 * 2^-23
constexpr int kLeafSize = 8;
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

// ray i of the [R, 3] origin and direction arrays
__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd,
                                        int i) {
  return make_ray(__ldg(ro + 3 * i + 0), __ldg(ro + 3 * i + 1),
                  __ldg(ro + 3 * i + 2), __ldg(rd + 3 * i + 0),
                  __ldg(rd + 3 * i + 1), __ldg(rd + 3 * i + 2));
}

// a box and its two link words: a = bmin.xyz, bmax.x; b = bmax.yz, links
struct Box {
  float4 a, b;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  Box x;
  x.a = __ldg(q);
  x.b = __ldg(q + 1);
  return x;
}

// raytpu's slab test, made conservative; *near gets the entry distance
__device__ __forceinline__ bool slab(const Ray& r, const Box& q, float tmin,
                                     float limit, float* near) {
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
  *near = t_near;
  return t_near <= t_far * kFarScale;
}

__device__ __forceinline__ bool box_hit(const Ray& r, const Box& q,
                                        float tmin, float limit) {
  float near;
  return slab(r, q, tmin, limit, &near);
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
// order; true when an any-hit ray is blocked by it. A closest-hit ray
// accepts t in [tmin, best t], and at best t only a lower key.
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

// Test the 8 triangles of the leaf row at lf in slot order, a pair (five
// float4) at a time; true when an any-hit ray is blocked (the rest of the
// row is then skipped). Triangle k's slot is slot0 + k, or, with
// kSlotInRow, the int32 bits of the row's float 10k + 9.
template <bool kAny, bool kSlotInRow>
__device__ __forceinline__ bool test_row(const Ray& r,
                                         const float* __restrict__ lf,
                                         int slot0,
                                         const int* __restrict__ first,
                                         float tmin, float tm, Best* b) {
  for (int j = 0; j < kLeafSize / 2; ++j) {
    float f[20];
    const float4* p = reinterpret_cast<const float4*>(lf + 20 * j);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 x = __ldg(p + q);
      f[4 * q + 0] = x.x; f[4 * q + 1] = x.y;
      f[4 * q + 2] = x.z; f[4 * q + 3] = x.w;
    }
    const int s0 = kSlotInRow ? __float_as_int(f[9]) : slot0 + 2 * j;
    const int s1 = kSlotInRow ? __float_as_int(f[19]) : slot0 + 2 * j + 1;
    if (test_tri<kAny>(r, f, s0, first, tmin, tm, b)) return true;
    if (test_tri<kAny>(r, f + 10, s1, first, tmin, tm, b)) return true;
  }
  return false;
}

}  // namespace walk
