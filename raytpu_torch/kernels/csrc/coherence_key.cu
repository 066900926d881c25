// coherence_key.cu — the engine's coherence sort key, one thread a lane.
//
// render._ray_sort_key orders a wave's rays before each sorted query:
// dead lanes last, then the direction's octant (major), then the Morton
// cell of the origin, the scene's root box quantised to `bits` bits an
// axis. Its plain version is kernels/coherence.py:coherence_key_torch,
// ~60 elementwise torch launches a key; here it is one. It replaces no
// Pallas kernel: raytpu's _ray_sort_key (raytpu/engine/render.py:207) is
// jnp code that XLA fuses into the bounce's program on the TPU. The fused
// wave mode sorts by the unique 64-bit key `key << 32 | pixel`, which the
// second instance writes straight from the pixel index.
//
// Bit for bit the plain version's, run on the same CUDA tensors:
// ext = bmax - bmin clamped below at 1e-6f (a NaN kept, as ATen's
// clamp_min keeps it), then ((ro - bmin) / ext) * 2^bits rounded after
// each step in that order (kernels/_build.py: no FMA contraction, IEEE
// division; the product by a power of two is exact), converted to int32
// by truncation as ATen's static_cast does on the card (cvt.rzi: a value
// out of range saturates, NaN gives 0) and clamped to [0, 2^bits - 1].
// The octant bit of an axis is `rd < 0`, so -0.0 and NaN give 0 and -inf
// gives 1. A dead lane's key is 1 << (3 bits + 3), above every live key;
// it reads no ray.
//
// What bounds it on an H100: bytes. Every lane reads its alive flag (1 B)
// and writes 4 B, or reads its pixel index (4 B) and writes 8 B in the
// composite form; a live lane also reads its ray (24 B). path360's first
// wave (245,760 lanes, 206,736 live) moves 6.2 MB, ~1.9 us at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace coherence {

constexpr int kBlock = 256;

struct Args {
  const float* ro;
  const float* rd;
  const unsigned char* alive;
  const float* bmin;  // [3] the scene's root box
  const float* bmax;  // [3]
  const int* pxi;     // the composite form's pixel index, else unused
  void* key;          // int32 [n], or int64 [n] in the composite form
  long long ro_s0, ro_s1, rd_s0, rd_s1, alive_s, pxi_s;
  int n, bits;
};

// Part1By2: the low 10 bits of x spread to every third bit
__device__ __forceinline__ unsigned spread(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ int cell(float o, float mn, float mx, float cells,
                                    int top) {
  float ext = __fsub_rn(mx, mn);
  if (!isnan(ext)) ext = fmaxf(ext, 1e-6f);
  const int q = __float2int_rz(__fmul_rn(__fdiv_rn(__fsub_rn(o, mn), ext),
                                         cells));
  return min(max(q, 0), top);
}

template <bool kComposite>
__global__ void __launch_bounds__(kBlock) key_kernel(Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  int key = 1 << (3 * a.bits + 3);
  if (a.alive[i * a.alive_s]) {
    const float* o = a.ro + i * a.ro_s0;
    const float* d = a.rd + i * a.rd_s0;
    const float cells = static_cast<float>(1 << a.bits);
    const int top = (1 << a.bits) - 1;
    const unsigned morton =
        spread(cell(o[0], a.bmin[0], a.bmax[0], cells, top)) |
        (spread(cell(o[a.ro_s1], a.bmin[1], a.bmax[1], cells, top)) << 1) |
        (spread(cell(o[2 * a.ro_s1], a.bmin[2], a.bmax[2], cells, top))
         << 2);
    const unsigned octant = static_cast<unsigned>(d[0] < 0.0f) |
                            (static_cast<unsigned>(d[a.rd_s1] < 0.0f) << 1) |
                            (static_cast<unsigned>(d[2 * a.rd_s1] < 0.0f)
                             << 2);
    key = static_cast<int>((octant << (3 * a.bits)) | morton);
  }
  if (kComposite) {
    // key.long() << 32 | pxi.long(): the pixel index sign-extended
    static_cast<long long*>(a.key)[i] =
        static_cast<long long>(static_cast<unsigned long long>(key) << 32) |
        static_cast<long long>(a.pxi[i * a.pxi_s]);
  } else {
    static_cast<int*>(a.key)[i] = key;
  }
}

}  // namespace coherence

// The key of each of n lanes into `key` (int32), or with `pxi` given the
// composite key << 32 | pxi into `key` (int64). Strides are in elements.
// Returns the launch's cudaError_t.
extern "C" int coherence_key_launch(
    const float* ro, const float* rd, const unsigned char* alive,
    const float* bmin, const float* bmax, const int* pxi, void* key,
    long long ro_s0, long long ro_s1, long long rd_s0, long long rd_s1,
    long long alive_s, long long pxi_s, int n, int bits, void* stream) {
  if (n <= 0) return 0;
  const coherence::Args a{ro,    rd,    alive, bmin,    bmax,  pxi, key,
                          ro_s0, ro_s1, rd_s0, rd_s1, alive_s, pxi_s,
                          n,     bits};
  const int grid = (n + coherence::kBlock - 1) / coherence::kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pxi != nullptr) {
    coherence::key_kernel<true><<<grid, coherence::kBlock, 0, s>>>(a);
  } else {
    coherence::key_kernel<false><<<grid, coherence::kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* coherence_key_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
