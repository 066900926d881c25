// step_bench.cu — the per-step cost probe of the strand walks, its walker
// rows spread over the card.
//
// Replaces benchmarks/step_bench.py:_kernel, raytpu's microbenchmark of
// the persistent strand kernel's per-step pieces. Like the TPU kernel it
// runs `iters` iterations of one structural piece (an "arm") on dummy
// (W, 128) f32 state that starts as tree rows 0..W-1, with every
// iteration's result carried into scratch[0][0] so the iterations are
// serialized and nothing folds away. It computes what the TPU kernel
// computes, element for element (raytpu's arithmetic, in its order); the
// plain torch replay is raytpu_torch/tools/step_bench.py:step_bench_torch.
//
// The TPU kernel is one program with no grid that holds the whole (W, 128)
// state as vector registers of one core. Only scratch[0][0] is carried;
// every other row's new state depends on itself, the tree and row 0. So
// the rows are spread over the card: row_kernel runs W / 4 blocks of 4
// warps, each warp owning one row with 4 consecutive elements a lane,
// held in registers. The arms:
//
//   full     4 conditional rolls + slab test + link select + queue roll
//   noroll   slab test + link select (raytpu's code runs it as slab)
//   roll2    2 conditional rolls + slab test + link select
//   slab     slab test + link select
//   rollq    4 conditional rolls + queue roll
//   ctl      the flush/service decision: reductions over all W rows
//            feeding two data-dependent writes (ctl_kernel, one block)
//   fetch    W row copies tree -> scratch at rows (cur[0] + w) & 1023
//   fetchdep W row copies at each row's own index, stored to shared
//            memory and read back (the dependent fetch)
//   fetchmir the same indices written to global memory and brought into a
//            block's shared mirror by one cp.async copy, then read there
//   mt       W row copies + the 8-slot Moller-Trumbore pass on (W, 128)
//   install  7 row copies into row 0 + its safe inverse
//
// A roll by sh elements (a multiple of 8) is a move of sh / 4 lanes, four
// shuffles; the queue's roll by one is each lane's own elements moved up
// plus one shuffle. raytpu rolls and selects (jnp.where), so every roll is
// made and then kept or not. No warp waits on another in full, noroll,
// roll2, slab, rollq, fetch, fetchdep and install: the arms that read row
// 0 (fetch, fetchdep, fetchmir, install) give every warp a slot that
// carries its own copy of row 0's chain, which depends on nothing else
// (in install that slot is the whole arm's work: the warp that owns row 0
// takes it from there). mt's chain is a whole Moller-Trumbore pass, so
// each block runs it once, in one more warp, and hands row 0's cur to the
// block's other warps through shared memory: one block barrier an
// iteration. fetchmir's copy takes the block's indices at once, so its
// warps meet at two block barriers an iteration. ctl reads all W rows
// every iteration: one block, a lane a row (RPL = 1, 2 or 4 rows a lane,
// one warp up to W 128, ceil(W / 128) warps above), warp reductions and,
// with more than one warp, one block barrier an iteration.
//
// Rows that never change (all but row 0 in full, noroll, roll2, slab,
// rollq and ctl) are made opaque to the compiler every iteration
// (`opaque`), and what an iteration computes but does not carry (each
// row's acc and cur, the rolled rows, the queue's moved elements) is
// folded into a sink under a zero the compiler cannot see (`keep`); the
// install copies are stored to a shared row. So no row's work is lifted
// out of the loop or dropped: tools/step_bench.py --sass counts each
// instance's loop. Float rules: --fmad=false, IEEE division, no
// flush-to-zero; f32 -> i32 conversion saturates and sends NaN to 0
// (cvt.rzi), as XLA's does.
//
// What bounds it: it is a serial latency probe by construction (each
// iteration depends on the last through row 0's element 0), not bytes or
// operations. Each block reads the SM cycle counter around its loop
// between two block barriers, and the kernel reports the slowest block's
// count (atomicMax), so cycles per walker-step are the slowest block's
// cycles an iteration over W.

#include <cuda_runtime.h>

namespace {

enum Arm {
  kFull = 0, kNoroll, kRoll2, kSlab, kRollq, kCtl, kFetch, kFetchdep,
  kFetchmir, kMt, kInstall, kArms
};

constexpr int kLanes = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRowWarps = 4;  // a row_kernel block: 4 warps of one row

__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

// torch.maximum / torch.minimum: a if a is NaN, else b if b is NaN, else
// fmaxf / fminf. Written as selects: as ternaries, nvcc branched on them.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("{\n\t.reg .pred pa, pb;\n\t.reg .f32 m;\n\t"
      "setp.nan.f32 pa, %1, %1;\n\tsetp.nan.f32 pb, %2, %2;\n\t"
      "max.f32 m, %1, %2;\n\tselp.f32 m, %2, m, pb;\n\t"
      "selp.f32 %0, %1, m, pa;\n\t}"
      : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("{\n\t.reg .pred pa, pb;\n\t.reg .f32 m;\n\t"
      "setp.nan.f32 pa, %1, %1;\n\tsetp.nan.f32 pb, %2, %2;\n\t"
      "min.f32 m, %1, %2;\n\tselp.f32 m, %2, m, pb;\n\t"
      "selp.f32 %0, %1, m, pa;\n\t}"
      : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the compiler must take x as changed here (no instruction is emitted)
__device__ __forceinline__ void opaque(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }
// x must be computed: it is folded into `sink` under `zero`, a kernel
// argument that is 0 (one LOP3); the kernel stores `sink` only if it is
// not 0, which never happens, but no compiler can know
__device__ __forceinline__ void keep(unsigned& sink, float x, unsigned zero) {
  sink ^= __float_as_uint(x) & zero;
}
__device__ __forceinline__ void keep(unsigned& sink, int x, unsigned zero) {
  sink ^= static_cast<unsigned>(x) & zero;
}

__device__ __forceinline__ float bcast(float x, int src) {
  return __shfl_sync(kFullMask, x, src);
}

__device__ __forceinline__ float pick(const float v[4], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : (j == 2 ? v[2] : v[3]));
}

// element e of a row whose 4-element share this lane holds in v
__device__ __forceinline__ float col(const float v[4], int e) {
  return __shfl_sync(kFullMask, pick(v, e & 3), e >> 2);
}

// this lane's 4 elements of tree row `row`
__device__ __forceinline__ void load_row(float v[4],
                                         const float* __restrict__ tree,
                                         int row, int lane) {
  const float4 x =
      __ldg(reinterpret_cast<const float4*>(tree + row * kLanes) + lane);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <int ARM>
struct Traits {
  static constexpr bool rolls = ARM == kFull || ARM == kRollq || ARM == kRoll2;
  static constexpr bool slab = ARM == kFull || ARM == kNoroll ||
                               ARM == kRoll2 || ARM == kSlab;
  static constexpr bool queue = ARM == kFull || ARM == kRollq;
  static constexpr bool fetch = ARM == kFetch || ARM == kFetchdep ||
                                ARM == kFetchmir;
  // arms whose rows read row 0's new state: a slot for row 0's chain
  static constexpr int n0 = (fetch || ARM == kMt || ARM == kInstall) ? 1 : 0;
  // mt: one more warp a block runs row 0's chain alone and hands its cur
  // to the others through shared memory (one barrier an iteration)
  static constexpr bool producer = ARM == kMt;
};

// Shared memory a block needs, in bytes (tools/step_bench.py:
// launch_geometry's smem); `ctl_warps` is ctl's warps.
inline int smem_need(int arm, int ctl_warps) {
  const int n0 = (arm == kFetch || arm == kFetchdep || arm == kFetchmir ||
                  arm == kMt || arm == kInstall) ? 1 : 0;
  const int slot = 1 + n0;
  if (arm == kFetchdep) return kRowWarps * 2 * slot * 4;
  if (arm == kFetchmir) return ((kRowWarps * slot + 3) & ~3) * 4;
  if (arm == kCtl) return 2 * ctl_warps * 5 * 4;
  if (arm == kInstall) return kRowWarps * kLanes * 4;
  if (arm == kMt) return 2 * 4;
  return 0;
}

// The Moller-Trumbore pass of one row: S0 `s`, the fetched leaf row `l`,
// the row's own `cur`; returns the acc term (max t + max slot) * 1e-12.
__device__ __forceinline__ float mt_pass(const float s[4], const float l[4],
                                         int cur) {
  const float c8 = col(s, 8), c9 = col(s, 9);
  float ro[4], rd[4], best_t[4];
  int best_tri[4];
  for (int j = 0; j < 4; ++j) {
    ro[j] = s[j] * 0.25f;
    rd[j] = s[j] + 1.0f;
    best_t[j] = c8 + 1e3f;
    best_tri[j] = f2i(c9 * 10.0f);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float p0 = col(l, 10 * k);
    const float e1 = col(l, 10 * k + 3);
    const float e2 = col(l, 10 * k + 6);
    for (int j = 0; j < 4; ++j) {
      const float pvx = rd[j] * e2 - rd[j] * p0;
      const float pvy = rd[j] * e1 - rd[j] * e2;
      const float pvz = rd[j] * p0 - rd[j] * e1;
      const float det = e1 * pvx + e2 * pvy + p0 * pvz;
      const float inv = 1.0f / det;
      const float tvx = ro[j] - p0;
      const float tvy = ro[j] - e1;
      const float tvz = ro[j] - e2;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
      const float qx = tvy * e2 - tvz * e1;
      const float qy = tvz * p0 - tvx * e2;
      const float qz = tvx * e1 - tvy * p0;
      const float v = (rd[j] * qx + rd[j] * qy + rd[j] * qz) * inv;
      const float t = (e2 * qx + e1 * qy + p0 * qz) * inv;
      const bool ok = (det != 0.0f) & (u >= 0.0f) & (v >= 0.0f) &
                      (u + v <= 1.0f) & (t >= 0.001f) &
                      ((t < best_t[j]) |
                       ((t == best_t[j]) & (cur + k < best_tri[j])));
      best_t[j] = ok ? t : best_t[j];
      best_tri[j] = ok ? cur + k : best_tri[j];
    }
  }
  const float mt = fmaxf(fmaxf(best_t[0], best_t[1]), fmaxf(best_t[2], best_t[3]));
  const float mi = fmaxf(fmaxf(static_cast<float>(best_tri[0]),
                               static_cast<float>(best_tri[1])),
                         fmaxf(static_cast<float>(best_tri[2]),
                               static_cast<float>(best_tri[3])));
  return (warp_max(mt) + warp_max(mi)) * 1e-12f;
}

// Every arm but ctl, in W / 4 blocks (W is a multiple of 8): warp w of
// block b owns row 4 * b + w. In mt the block has one more warp, warp 4,
// for row 0's chain.
template <int ARM>
__global__ void row_kernel(const float* __restrict__ tree,
                           float* __restrict__ out,
                           float* __restrict__ acc_out,
                           int* __restrict__ idx_g,
                           long long* __restrict__ cycles, int iters,
                           unsigned zero) {
  using T = Traits<ARM>;
  constexpr int N0 = T::n0;
  constexpr int RT = 1 + N0;  // slots: [row 0's chain,] the own row
  constexpr int wpb = kRowWarps;
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool producer = T::producer && warp == wpb;
  const int first = blockIdx.x * wpb + warp;
  // mt's slots a warp runs: the producer slot 0, the others their own rows
  const auto runs = [&](int k) {
    return !T::producer || (producer ? k < N0 : k >= N0);
  };
  int rows[RT];
  float s[RT][4], acc[RT];
  unsigned sink = 0;
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    rows[k] = k < N0 || producer ? 0 : first;
    load_row(s[k], tree, rows[k], lane);
    acc[k] = 0.0f;
  }
  if (T::producer && producer && lane == 0) smem[0] = f2i(s[0][0] * 1e6f) & 1023;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float c0[RT];
    int cur[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      for (int j = 0; j < 4; ++j) opaque(s[k][j]);
      c0[k] = bcast(s[k][0], 0);
      cur[k] = f2i(c0[k] * 1e6f) & 1023;
      keep(sink, cur[k], zero);
    }
    // S: the row after the roll chain (raytpu: jnp.where(bit, roll, S))
    float r[RT][4];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      for (int j = 0; j < 4; ++j) r[k][j] = s[k][j];
      if constexpr (T::rolls) {
        const int amt = (cur[k] & 15) * 8;
        for (int b = 0; b < (ARM == kRoll2 ? 2 : 4); ++b) {
          const int sh = 8 << b;  // roll by 128 - sh: out[i] = x[(i + sh) % 128]
          const int src = (lane + (sh >> 2)) & 31;
          for (int j = 0; j < 4; ++j) {
            const float x = __shfl_sync(kFullMask, r[k][j], src);
            r[k][j] = (amt & sh) ? x : r[k][j];
          }
        }
        for (int j = 1; j < 4; ++j) keep(sink, r[k][j], zero);
      }
      acc[k] = (T::rolls ? bcast(r[k][0], 0) : c0[k]) * 0.0f;
    }
    int pend[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) pend[k] = cur[k] - 1;
    if constexpr (T::slab) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        float sc[8];
        for (int c = 0; c < 8; ++c) sc[c] = col(r[k], c);
        const int hitl = f2i(sc[6]);
        const int missl = f2i(sc[7]);
        bool hit = false;
        for (int j = 0; j < 4; ++j) {
          const float idx = s[k][j] + 1.0f;
          const bool neg = idx < 0.5f;
          const float ro = s[k][j] * 0.25f;
          const float lox = ((neg ? sc[3] : sc[0]) - ro) * idx;
          const float hix = ((neg ? sc[0] : sc[3]) - ro) * idx;
          const float loy = ((neg ? sc[4] : sc[1]) - ro) * idx;
          const float hiy = ((neg ? sc[1] : sc[4]) - ro) * idx;
          const float loz = ((neg ? sc[5] : sc[2]) - ro) * idx;
          const float hiz = ((neg ? sc[2] : sc[5]) - ro) * idx;
          const float near = nan_max(nan_max(lox, loy), nan_max(loz, 0.001f));
          const float far = nan_min(nan_min(hix, hiy), nan_min(hiz, 1e30f));
          hit = hit | (near <= far);
        }
        const bool hit_any = __any_sync(kFullMask, hit);
        const bool is_leaf = hitl < 0;
        pend[k] = (hit_any && is_leaf) ? ~hitl : -1;
        const int nxt = (hit_any && !is_leaf) ? hitl : missl;
        acc[k] = acc[k] + static_cast<float>(nxt) * 1e-9f;
      }
    }
    if constexpr (T::queue) {
      // LIFO insert: q = where(enq, roll(S0, 1), S0), element 0 = pend
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const bool enq = pend[k] >= 0;
        const float up = __shfl_sync(kFullMask, s[k][3], (lane + 31) & 31);
        float q[4] = {up, s[k][0], s[k][1], s[k][2]};
        for (int j = 0; j < 4; ++j) q[j] = enq ? q[j] : s[k][j];
        if (enq && lane == 0) q[0] = static_cast<float>(pend[k]);
        for (int j = 1; j < 4; ++j) keep(sink, q[j], zero);
        acc[k] = acc[k] + bcast(q[0], 0) * 1e-12f;
      }
    }
    if constexpr (T::fetch || ARM == kMt) {
      float l[RT][4];
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        for (int j = 0; j < 4; ++j) l[k][j] = s[k][j];
      }
      if constexpr (ARM == kFetch || ARM == kMt) {
        const int cur00 = T::producer && !producer ? smem[it & 1] : cur[0];
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (runs(k)) load_row(l[k], tree, (cur00 + rows[k]) & 1023, lane);
        }
      }
      if constexpr (ARM == kFetchdep) {
        // the store the dependent read sees (a warp's slots, by parity)
        int* idx_s = smem + (warp * 2 + (it & 1)) * RT;
        if (lane == 0) {
          for (int k = 0; k < RT; ++k) idx_s[k] = cur[k];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < RT; ++k) load_row(l[k], tree, idx_s[k] & 1023, lane);
      }
      if constexpr (ARM == kFetchmir) {
        // the block's indices to global memory, then ONE async copy of
        // them into the shared mirror, waited on once
        const int stride = (wpb * RT + 3) & ~3;
        int* g = idx_g + blockIdx.x * stride;
        if (lane == 0) {
          for (int k = 0; k < RT; ++k) g[warp * RT + k] = cur[k];
        }
        __syncthreads();
        if (static_cast<int>(threadIdx.x) < stride / 4) {
          const unsigned dst = static_cast<unsigned>(
              __cvta_generic_to_shared(smem + 4 * threadIdx.x));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(g + 4 * threadIdx.x));
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_all;\n" ::);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          load_row(l[k], tree, smem[warp * RT + k] & 1023, lane);
        }
      }
      if constexpr (ARM == kMt) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (runs(k)) acc[k] = acc[k] + mt_pass(s[k], l[k], cur[k]);
        }
      }
      if constexpr (T::fetch) {
        const float v00 = bcast(l[0][0], 0);  // row 0's new element 0
#pragma unroll
        for (int k = 0; k < RT; ++k) acc[k] = acc[k] + v00;
      }
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        for (int j = 0; j < 4; ++j) s[k][j] = l[k][j];
      }
    }
    if constexpr (ARM == kInstall) {
      // row 0's home for the copies: a shared row of the warp's own
      const unsigned home = static_cast<unsigned>(
          __cvta_generic_to_shared(smem + warp * kLanes + 4 * lane));
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (k >= N0) {
          // the warp's own row 0 is the chain slot 0 has just run
          if (rows[k] == 0) {
            for (int j = 0; j < 4; ++j) s[k][j] = s[0][j];
          }
          continue;
        }
        float row[4];
#pragma unroll
        for (int src = 0; src < 7; ++src) {
          load_row(row, tree, (cur[0] + src) & 1023, lane);
          asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(home), "f"(row[0]), "f"(row[1]), "f"(row[2]),
                       "f"(row[3]));
        }
        for (int j = 0; j < 4; ++j) {
          const float x = row[j];
          const float inv = 1.0f / x;
          s[k][j] = 1.0f / (x == 0.0f ? (inv < 0.0f ? -1e-36f : 1e-36f) : x);
        }
      }
      const float safe00 = bcast(s[0][0], 0);
#pragma unroll
      for (int k = 0; k < RT; ++k) acc[k] = acc[k] + safe00 * 1e-20f;
    }
    // carry a perturbation back so the iterations serialize
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (rows[k] == 0 && lane == 0) s[k][0] = acc[k] * 1e-20f + s[k][0];
      keep(sink, acc[k], zero);
    }
    if constexpr (T::producer) {
      // the next iteration's cur of row 0, to the block's other warps
      if (producer && lane == 0) smem[(it + 1) & 1] = f2i(s[0][0] * 1e6f) & 1023;
      __syncthreads();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(cycles, clock64() - t0);
  if (sink != 0) acc_out[0] = __uint_as_float(sink);
  if (producer) return;
  reinterpret_cast<float4*>(out + first * kLanes)[lane] =
      make_float4(s[RT - 1][0], s[RT - 1][1], s[RT - 1][2], s[RT - 1][3]);
  if (lane == 0) acc_out[first] = acc[RT - 1];
}

// ctl: one block of wpb warps, lane l of warp w holding rows
// (w * 32 + l) * RPL .. + RPL - 1 (columns 0 and 1: all ctl reads). Each
// iteration's five counts are warp reductions, summed over the warps
// through shared memory (two buffers by parity: one barrier an iteration).
template <int RPL>
__global__ void ctl_kernel(const float* __restrict__ tree,
                           float* __restrict__ out,
                           float* __restrict__ acc_out,
                           long long* __restrict__ cycles, int iters, int W,
                           unsigned zero) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int base = (warp * 32 + lane) * RPL;
  float c0[RPL], c1[RPL], acc[RPL];
  unsigned sink = 0;
  for (int k = 0; k < RPL; ++k) {
    const bool valid = base + k < W;
    c0[k] = valid ? tree[(base + k) * kLanes] : 0.0f;
    c1[k] = valid ? tree[(base + k) * kLanes + 1] : 0.0f;
    acc[k] = 0.0f;
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    int n_q = 0, any_nxt = 0, max_qn = 0, n_need = 0, busy = 0;
    for (int k = 0; k < RPL; ++k) {
      opaque(c0[k]);
      opaque(c1[k]);
      int cur = f2i(c0[k] * 1e6f) & 1023;
      int qn = f2i(c1[k] * 3.0f) & 7;
      opaque(cur);
      opaque(qn);
      if (base + k < W) {
        const int nxt = cur - 512;
        n_q += qn > 0 ? 1 : 0;
        any_nxt |= nxt >= 0 ? 1 : 0;
        max_qn = max(max_qn, qn);
        n_need += (nxt < -2048 && qn == 0) ? 1 : 0;
        busy |= (nxt >= 0 || qn > 0) ? 1 : 0;
      }
    }
    n_q = __reduce_add_sync(kFullMask, n_q);
    any_nxt = __any_sync(kFullMask, any_nxt);
    max_qn = __reduce_max_sync(kFullMask, max_qn);
    n_need = __reduce_add_sync(kFullMask, n_need);
    busy = __any_sync(kFullMask, busy);
    if (wpb > 1) {
      int* part = smem + (it & 1) * wpb * 5;
      if (lane == 0) {
        part[warp * 5 + 0] = n_q;
        part[warp * 5 + 1] = any_nxt;
        part[warp * 5 + 2] = max_qn;
        part[warp * 5 + 3] = n_need;
        part[warp * 5 + 4] = busy;
      }
      __syncthreads();
      n_q = any_nxt = max_qn = n_need = busy = 0;
      for (int w = 0; w < wpb; ++w) {
        n_q += part[w * 5 + 0];
        any_nxt |= part[w * 5 + 1];
        max_qn = max(max_qn, part[w * 5 + 2]);
        n_need += part[w * 5 + 3];
        busy |= part[w * 5 + 4];
      }
    }
    const bool do_leaf = n_q >= 2 * W || (n_q > 0 && !any_nxt) || max_qn >= 128;
    const bool do_service = n_need >= 2 * W || (n_need > 0 && !busy);
    for (int k = 0; k < RPL; ++k) {
      acc[k] = c0[k] * 0.0f + static_cast<float>(n_q) * 1e-12f;
    }
    if (base == 0) {
      if (do_leaf) c0[0] = c0[0] + 1.0f;
      if (do_service) c1[0] = c1[0] + 1.0f;
      // carry a perturbation back so the iterations serialize
      c0[0] = acc[0] * 1e-20f + c0[0];
    }
    for (int k = 0; k < RPL; ++k) keep(sink, acc[k], zero);
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(cycles, clock64() - t0);
  if (sink != 0) acc_out[0] = __uint_as_float(sink);
  for (int i = threadIdx.x; i < W * kLanes / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(out)[i] =
        __ldg(reinterpret_cast<const float4*>(tree) + i);
  }
  __syncthreads();
  for (int k = 0; k < RPL; ++k) {
    if (base + k < W) {
      out[(base + k) * kLanes] = c0[k];
      out[(base + k) * kLanes + 1] = c1[k];
      acc_out[base + k] = acc[k];
    }
  }
}

__global__ void step_bench_empty_kernel() {}

template <int ARM>
int launch_rows(int grid, int threads, int smem, cudaStream_t s,
                const float* tree, float* out, float* acc_out, int* idx_g,
                long long* cycles, int iters) {
  cudaError_t e = cudaFuncSetAttribute(
      row_kernel<ARM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_kernel<ARM><<<grid, threads, smem, s>>>(tree, out, acc_out, idx_g,
                                              cycles, iters, 0u);
  return static_cast<int>(cudaGetLastError());
}

template <int RPL>
int launch_ctl(int smem, int threads, cudaStream_t s, const float* tree,
               float* out, float* acc_out, long long* cycles, int iters,
               int W) {
  cudaError_t e = cudaFuncSetAttribute(
      ctl_kernel<RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ctl_kernel<RPL><<<1, threads, smem, s>>>(tree, out, acc_out, cycles, iters,
                                           W, 0u);
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape against W, as tools/step_bench.py:launch_geometry
// gives it: the row arms W / 4 blocks of 4 warps of one row, ctl one block
// of `warps` warps with `rows` (1, 2 or 4) rows a lane that hold W rows.
bool shape_ok(int arm, int W, int rows, int warps, int grid, int smem) {
  if (W < 8 || W > 1024 || W % 8) return false;
  if (arm == kCtl) {
    return (rows == 1 || rows == 2 || rows == 4) && warps >= 1 &&
           warps <= 32 && grid == 1 && 32 * rows * warps >= W &&
           smem >= smem_need(arm, warps);
  }
  return rows == 1 && warps == kRowWarps && grid * kRowWarps == W &&
         smem >= smem_need(arm, 0);
}

}  // namespace

// Launch arm `arm` (0..10, the Arm order above) on `stream`: `grid` blocks
// of `warps` warps with `rows` rows a warp (ctl: one block, `rows` rows a
// lane) and `smem` bytes of dynamic shared memory; `idx_g` holds fetchmir's
// indices (grid blocks of its slots rounded up to 4). W must be a multiple
// of 8 in [8, 1024]; the shape must be the one
// tools/step_bench.py:launch_geometry gives. Returns the CUDA error code
// after the launch, 0 on success.
extern "C" int step_bench_launch(const float* tree, float* out, float* acc_out,
                                 int* idx_g, long long* cycles, int arm,
                                 int iters, int W, int rows, int warps,
                                 int grid, int smem, void* stream) {
  if (arm < 0 || arm >= kArms || iters < 0 ||
      !shape_ok(arm, W, rows, warps, grid, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * (warps + (arm == kMt ? 1 : 0));
  switch (arm) {
    case kFull: return launch_rows<kFull>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kNoroll: return launch_rows<kNoroll>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kRoll2: return launch_rows<kRoll2>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kSlab: return launch_rows<kSlab>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kRollq: return launch_rows<kRollq>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kFetch: return launch_rows<kFetch>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kFetchdep: return launch_rows<kFetchdep>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kFetchmir: return launch_rows<kFetchmir>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kMt: return launch_rows<kMt>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kInstall: return launch_rows<kInstall>(grid, threads, smem, s, tree, out, acc_out, idx_g, cycles, iters);
    case kCtl:
      switch (rows) {
        case 1: return launch_ctl<1>(smem, threads, s, tree, out, acc_out, cycles, iters, W);
        case 2: return launch_ctl<2>(smem, threads, s, tree, out, acc_out, cycles, iters, W);
        default: return launch_ctl<4>(smem, threads, s, tree, out, acc_out, cycles, iters, W);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch floor: an empty kernel with the same grid, block and shared
// memory.
extern "C" int step_bench_empty_launch(int grid, int threads, int smem,
                                       void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      step_bench_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_bench_empty_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* step_bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
