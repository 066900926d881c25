// step_bench.cu — the per-step cost probe of the strand walks, as one
// thread block.
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
// The TPU kernel is one program with no grid, so this is one block of 16
// warps. Its (W, 128) scratch lives in shared memory (64 KiB at W = 128);
// the (1024, 128) tree stays in global memory. A warp owns whole rows
// (rows warp, warp + 16, ...), each lane 4 consecutive elements, so a
// row-wide any/max is a warp vote or shuffle reduction:
//
//   full     4 conditional rolls + slab test + link select + queue roll
//   noroll   slab test + link select (raytpu's code runs it as slab)
//   roll2    2 conditional rolls + slab test + link select
//   slab     slab test + link select
//   rollq    4 conditional rolls + queue roll
//   ctl      the flush/service decision: block reductions over W rows
//            (shared-memory atomics) feeding two data-dependent writes
//   fetch    W row copies tree -> scratch at rows (cur[0] + w) & 1023
//   fetchdep W row copies at each row's own index, stored to shared
//            memory and read back (the dependent fetch)
//   fetchmir the same indices written to global memory and brought into a
//            shared mirror by one cp.async copy, then read from there
//   mt       W row copies + the 8-slot Moller-Trumbore pass on (W, 128)
//   install  7 row copies into row 0 + its safe inverse
//
// Rolls go through a per-warp shared-memory row (jnp.roll semantics:
// out[i] = x[(i - s) mod 128]). Row copies are float4 loads from global
// memory stored to shared memory. Float rules: --fmad=false, IEEE
// division, no flush-to-zero; f32 -> i32 conversion saturates and sends
// NaN to 0 (cvt.rzi), as XLA's does.
//
// What bounds it: it is a serial latency probe by construction (each
// iteration depends on the last through scratch[0][0], with two or four
// block barriers per iteration), not bytes or operations. Thread 0 reads
// the SM cycle counter around the loop, so cycles per walker-step come
// from the card's own clock.

#include <cuda_runtime.h>

namespace {

enum Arm {
  kFull = 0, kNoroll, kRoll2, kSlab, kRollq, kCtl, kFetch, kFetchdep,
  kFetchmir, kMt, kInstall, kArms
};

constexpr int kLanes = 128;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

struct Ctl {
  int n_q, any_nxt, max_qn, n_need, busy;
};

__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// one 128-float row, global -> shared, a float4 per lane
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int lane) {
  reinterpret_cast<float4*>(dst)[lane] =
      __ldg(reinterpret_cast<const float4*>(src) + lane);
}

__device__ __forceinline__ void load4(const float* row, int lane, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(row)[lane];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void store4(float* row, int lane, const float v[4]) {
  reinterpret_cast<float4*>(row)[lane] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <int ARM>
struct Traits {
  static constexpr bool rolls = ARM == kFull || ARM == kRollq || ARM == kRoll2;
  static constexpr int n_rolls = ARM == kRoll2 ? 2 : 4;
  static constexpr bool slab = ARM == kFull || ARM == kNoroll ||
                               ARM == kRoll2 || ARM == kSlab;
  static constexpr bool queue = ARM == kFull || ARM == kRollq;
  static constexpr bool fetch = ARM == kFetch || ARM == kFetchdep ||
                                ARM == kFetchmir;
  // arms that rewrite scratch rows inside the iteration
  static constexpr bool writes = fetch || ARM == kMt || ARM == kInstall;
  // arms whose acc needs a block-wide value after the row pass
  static constexpr bool fix_acc = fetch || ARM == kCtl || ARM == kInstall;
};

// One row's share of an iteration: the arm's element arithmetic on row r
// (S0 = the row as the iteration found it), and its acc into acc_s[r].
template <int ARM>
__device__ __forceinline__ void row_pass(float* scratch, float* buf,
                                         const float* __restrict__ tree,
                                         int* idx_s, const int* mir_s,
                                         float* acc_s, Ctl* ctl, int r,
                                         int lane, int cur00) {
  using T = Traits<ARM>;
  float* srow = scratch + r * kLanes;
  float s0[4];
  load4(srow, lane, s0);
  const float c0 = srow[0];
  const int cur = f2i(c0 * 1e6f) & 1023;
  // S: the row after the roll chain (columns 0..7 are what the arm reads)
  float sc[8];
  if constexpr (T::rolls) {
    const int amt = (cur & 15) * 8;
    float s[4] = {s0[0], s0[1], s0[2], s0[3]};
    for (int b = 0; b < T::n_rolls; ++b) {
      const int sh = 8 << b;  // roll by 128 - sh: out[i] = x[(i + sh) % 128]
      if (amt & sh) {
        store4(buf, lane, s);
        __syncwarp();
        for (int j = 0; j < 4; ++j) s[j] = buf[(4 * lane + j + sh) & 127];
        __syncwarp();
      }
    }
    store4(buf, lane, s);
    __syncwarp();
    for (int c = 0; c < 8; ++c) sc[c] = buf[c];
    __syncwarp();
  } else {
    for (int c = 0; c < 8; ++c) sc[c] = srow[c];
  }
  const float c8 = srow[8], c9 = srow[9];
  float acc = sc[0] * 0.0f;
  int pend = cur - 1;
  if constexpr (T::slab) {
    const int hitl = f2i(sc[6]);
    const int missl = f2i(sc[7]);
    bool hit = false;
    for (int j = 0; j < 4; ++j) {
      const float idx = s0[j] + 1.0f;
      const bool neg = idx < 0.5f;
      const float ro = s0[j] * 0.25f;
      const float lox = ((neg ? sc[3] : sc[0]) - ro) * idx;
      const float hix = ((neg ? sc[0] : sc[3]) - ro) * idx;
      const float loy = ((neg ? sc[4] : sc[1]) - ro) * idx;
      const float hiy = ((neg ? sc[1] : sc[4]) - ro) * idx;
      const float loz = ((neg ? sc[5] : sc[2]) - ro) * idx;
      const float hiz = ((neg ? sc[2] : sc[5]) - ro) * idx;
      const float near = nan_max(nan_max(lox, loy), nan_max(loz, 0.001f));
      const float far = nan_min(nan_min(hix, hiy), nan_min(hiz, 1e30f));
      hit = hit || (near <= far);
    }
    const bool hit_any = __any_sync(kFullMask, hit);
    const bool is_leaf = hitl < 0;
    pend = (hit_any && is_leaf) ? ~hitl : -1;
    const int nxt = (hit_any && !is_leaf) ? hitl : missl;
    acc = acc + static_cast<float>(nxt) * 1e-9f;
  }
  if constexpr (T::queue) {
    // LIFO insert: roll the row by one lane, pend at lane 0
    const bool enq = pend >= 0;
    float q0 = c0;
    if (enq) {
      for (int j = 0; j < 4; ++j) buf[(4 * lane + j + 1) & 127] = s0[j];
      __syncwarp();
      q0 = static_cast<float>(pend);
    }
    acc = acc + q0 * 1e-12f;
  }
  // the warp has read the row; now an arm may rewrite it
  if constexpr (T::writes) __syncwarp();
  if constexpr (ARM == kFetch) {
    copy_row(srow, tree + ((cur00 + r) & 1023) * kLanes, lane);
  }
  if constexpr (ARM == kFetchdep) {
    if (lane == 0) idx_s[r] = cur;  // the store the dependent read sees
    __syncwarp();
    copy_row(srow, tree + (idx_s[r] & 1023) * kLanes, lane);
  }
  if constexpr (ARM == kFetchmir) {
    copy_row(srow, tree + (mir_s[r] & 1023) * kLanes, lane);
  }
  if constexpr (ARM == kMt) {
    copy_row(srow, tree + ((cur00 + r) & 1023) * kLanes, lane);
    __syncwarp();
    float ro[4], rd[4], best_t[4];
    int best_tri[4];
    for (int j = 0; j < 4; ++j) {
      ro[j] = s0[j] * 0.25f;
      rd[j] = s0[j] + 1.0f;
      best_t[j] = c8 + 1e3f;
      best_tri[j] = f2i(c9 * 10.0f);
    }
    for (int k = 0; k < 8; ++k) {
      const float p0 = srow[10 * k];
      const float e1 = srow[10 * k + 3];
      const float e2 = srow[10 * k + 6];
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
        const bool ok = (det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
                        (u + v <= 1.0f) && (t >= 0.001f) &&
                        ((t < best_t[j]) ||
                         ((t == best_t[j]) && (cur + k < best_tri[j])));
        if (ok) {
          best_t[j] = t;
          best_tri[j] = cur + k;
        }
      }
    }
    float mt = fmaxf(fmaxf(best_t[0], best_t[1]), fmaxf(best_t[2], best_t[3]));
    float mi = fmaxf(fmaxf(static_cast<float>(best_tri[0]),
                           static_cast<float>(best_tri[1])),
                     fmaxf(static_cast<float>(best_tri[2]),
                           static_cast<float>(best_tri[3])));
    acc = acc + (warp_max(mt) + warp_max(mi)) * 1e-12f;
  }
  if constexpr (ARM == kInstall) {
    if (r == 0) {
      for (int src = 0; src < 7; ++src) {
        copy_row(srow, tree + ((cur00 + src) & 1023) * kLanes, lane);
        __syncwarp();
      }
      float row[4];
      load4(srow, lane, row);
      for (int j = 0; j < 4; ++j) {
        const float x = row[j];
        row[j] = 1.0f / (x == 0.0f ? ((1.0f / x < 0.0f) ? -1e-36f : 1e-36f) : x);
      }
      store4(srow, lane, row);
    }
  }
  if constexpr (ARM == kCtl) {
    if (lane == 0) {
      const int qn = f2i(srow[1] * 3.0f) & 7;
      const int nxt = cur - 512;
      atomicAdd(&ctl->n_q, qn > 0 ? 1 : 0);
      if (nxt >= 0) atomicOr(&ctl->any_nxt, 1);
      atomicMax(&ctl->max_qn, qn);
      atomicAdd(&ctl->n_need, (nxt < -2048 && qn == 0) ? 1 : 0);
      if (nxt >= 0 || qn > 0) atomicOr(&ctl->busy, 1);
    }
  }
  if (lane == 0) acc_s[r] = acc;
}

template <int ARM>
__global__ void __launch_bounds__(kThreads) step_bench_kernel(
    const float* __restrict__ tree, float* __restrict__ out,
    float* __restrict__ acc_out, int* __restrict__ idx_g,
    long long* __restrict__ cycles, int iters, int W) {
  using T = Traits<ARM>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* bufs = scratch + W * kLanes;  // one row per warp
  int* idx_s = reinterpret_cast<int*>(bufs + kWarps * kLanes);
  int* mir_s = idx_s + W;  // 16-byte aligned: W is a multiple of 8
  float* acc_s = reinterpret_cast<float*>(mir_s + W);
  Ctl* ctl = reinterpret_cast<Ctl*>(acc_s + W);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* buf = bufs + warp * kLanes;

  for (int i = tid; i < W * kLanes / 4; i += kThreads) {
    reinterpret_cast<float4*>(scratch)[i] =
        __ldg(reinterpret_cast<const float4*>(tree) + i);
  }
  for (int i = tid; i < W; i += kThreads) acc_s[i] = 0.0f;
  if (tid == 0) *ctl = Ctl{0, 0, 0, 0, 0};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int cur00 = f2i(scratch[0] * 1e6f) & 1023;
    // every thread has read S0[0][0] before any row is rewritten
    if constexpr (T::writes) __syncthreads();
    if constexpr (ARM == kFetchmir) {
      // the dependent indices to global memory, then ONE async copy of
      // the column into the shared mirror, waited on once
      for (int r = warp; r < W; r += kWarps) {
        if (lane == 0) idx_g[r] = f2i(scratch[r * kLanes] * 1e6f) & 1023;
      }
      __syncthreads();
      if (tid < W / 4) {
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(mir_s + 4 * tid));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(idx_g + 4 * tid));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
    }
    for (int r = warp; r < W; r += kWarps) {
      row_pass<ARM>(scratch, buf, tree, idx_s, mir_s, acc_s, ctl, r, lane,
                    cur00);
    }
    __syncthreads();
    if constexpr (T::fix_acc) {
      const float v00 = scratch[0];
      for (int r = tid; r < W; r += kThreads) {
        if constexpr (T::fetch) acc_s[r] = acc_s[r] + v00;
        if constexpr (ARM == kInstall) acc_s[r] = acc_s[r] + v00 * 1e-20f;
        if constexpr (ARM == kCtl) {
          acc_s[r] = acc_s[r] + static_cast<float>(ctl->n_q) * 1e-12f;
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      if constexpr (ARM == kCtl) {
        const bool do_leaf = ctl->n_q >= 2 * W ||
                             (ctl->n_q > 0 && !ctl->any_nxt) ||
                             ctl->max_qn >= 128;
        const bool do_service = ctl->n_need >= 2 * W ||
                                (ctl->n_need > 0 && !ctl->busy);
        if (do_leaf) scratch[0] = scratch[0] + 1.0f;
        if (do_service) scratch[1] = scratch[1] + 1.0f;
        *ctl = Ctl{0, 0, 0, 0, 0};
      }
      // carry a perturbation back so the iterations serialize
      scratch[0] = acc_s[0] * 1e-20f + scratch[0];
    }
    __syncthreads();
  }
  const long long t1 = clock64();
  for (int i = tid; i < W * kLanes / 4; i += kThreads) {
    reinterpret_cast<float4*>(out)[i] = reinterpret_cast<float4*>(scratch)[i];
  }
  for (int i = tid; i < W; i += kThreads) acc_out[i] = acc_s[i];
  if (tid == 0) *cycles = t1 - t0;
}

__global__ void step_bench_empty_kernel() {}

template <int ARM>
int launch(const float* tree, float* out, float* acc_out, int* idx_g,
           long long* cycles, int iters, int W, int smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      step_bench_kernel<ARM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_bench_kernel<ARM><<<1, kThreads, smem, stream>>>(
      tree, out, acc_out, idx_g, cycles, iters, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one launch at W walkers, in bytes.
extern "C" int step_bench_smem_bytes(int W) {
  return W * kLanes * 4 + kWarps * kLanes * 4 + 3 * W * 4 +
         static_cast<int>(sizeof(Ctl));
}

// Launch arm `arm` (0..10, the Arm order above) on `stream`. W must be a
// multiple of 8 in [8, 1024] whose shared memory fits a block; the
// wrapper checks. Returns the CUDA error code after the launch, 0 on
// success.
extern "C" int step_bench_launch(const float* tree, float* out, float* acc_out,
                                 int* idx_g, long long* cycles, int arm,
                                 int iters, int W, void* stream) {
  const int smem = step_bench_smem_bytes(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kFull: return launch<kFull>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kNoroll: return launch<kNoroll>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kRoll2: return launch<kRoll2>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kSlab: return launch<kSlab>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kRollq: return launch<kRollq>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kCtl: return launch<kCtl>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kFetch: return launch<kFetch>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kFetchdep: return launch<kFetchdep>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kFetchmir: return launch<kFetchmir>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kMt: return launch<kMt>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    case kInstall: return launch<kInstall>(tree, out, acc_out, idx_g, cycles, iters, W, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch floor: an empty kernel with the same block and shared memory.
extern "C" int step_bench_empty_launch(int W, void* stream) {
  const int smem = step_bench_smem_bytes(W);
  cudaError_t e = cudaFuncSetAttribute(
      step_bench_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_bench_empty_kernel<<<1, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* step_bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
