// packet_walk.cu — closest-hit / any-hit / mixed-lane ray queries over the
// 8-wide BVH (the packet route), one thread per ray with its own stack.
//
// Replaces raytpu/kernels/intersect_pallas.py:_packet_kernel /
// _one_packet (entry packet_query, factory make_packet_intersectors) in
// its closest-hit, any-hit and mixed forms. In the mixed form
// (packet_query(mixed=True), which no engine path calls) smask == 1 flags
// a shadow lane: any-hit over [shadow_tmin, tmax] that stops at its first
// blocker; the other lanes are closest-hit over [tmin, tmax). Every lane's
// best t starts at min(F32_MAX, tmax) and is its LIMIT, and every lane's
// slab test uses min(tmin, shadow_tmin), as in the treelet walk
// (binned_walk.cu). It ports that kernel's contract, not
// its TPU schedule: no 4096-ray packets and no shared packet stack; each
// thread walks its own ray (bvh8_walk.cuh). Closest-hit keeps the smallest
// (t, first[slot]) pair, so every copy of a triangle that spatial splits
// stored in several leaves carries one tie key and the visit order never
// changes t or the triangle; any-hit stops at the first blocker.
//
// Leaf row j holds 8 triangles x (p0, e1, e2, pad) = 80 floats; triangle k
// of row j is slot 8j + k. Float rules and the conservative box test:
// walk_common.cuh, shared bit for bit with the plain version
// (kernels/packet.py:packet_query_torch).
//
// What bounds it on an H100: the dependent chain of node rows a lane pops
// (512 bytes, 8 box tests each) and its leaf rows (320 bytes, 8 triangle
// tests), out of L2 for scenes up to ~50 MB, and the warp's divergence as
// its lanes' walks part. The design has two steps over the first port,
// each of which gained on phase 6c's 1080p flat wave and phase 6a's waves
// (PERF.md): 16-byte loads of children and triangle pairs, and while-while
// traversal with postponed leaves (bvh8_walk.cuh). A shared-memory short
// stack measured slower and was reverted; the stack stays in local memory
// (2 KB a thread).
//
// Options of raytpu's kernel, none of which changes t or the tie key, each
// a template case, so the three storage-order instances without stats
// keep their code (packet_kernel); the nine with an option are
// packet_option_kernel, which holds each to the blocks an SM it must keep:
// * near-first child order (raytpu's `ordered`, RAYTPU_ORDER_MODE): an
//   instance of each form, kNearFirst, which orders each node's hit
//   children by the ray's own entry distance (raytpu's kernel orders by a
//   packet representative). bvh8_walk.cuh forms the keys and sorts them
//   only for a lane that holds two hit interior children or two hit
//   leaves; 9 blocks an SM (56 registers). It reads 0.94x storage order on
//   the 1080p primary wave and 0.85x on a mixed query (PERF.md; 1.21x and
//   1.05x before); the port's default keeps storage order until a
//   benchmark cell decides;
// * stats (raytpu's with_stats), an instance of each form and order,
//   kStats: with stats non-null, int32 [ceil(R / packet), 128], a
//   block's 4 warps sum their lanes' node pops and leaf-row tests in
//   shared memory and one thread adds them to lanes 0 and 1 of the
//   block's packet row (one atomic each; packet is a multiple of 128, so
//   a block lies in one packet), and the wrapper copies lane 0 to lanes
//   2..127. These are sums of each ray's own walk, not raytpu's one shared
//   walk per packet. The storage-order stats instances run 7 blocks an SM
//   as their twins do (the counters had taken them to 74 registers and 6
//   blocks, +11-12%); they read 0.98-1.05x their twins.

#include "bvh8_walk.cuh"

namespace {

using namespace walk;

constexpr int kStackDepth = 512;  // kernels/packet.py:STACK_DEPTH
constexpr int kLeafFloats = 80;   // 8 triangles x 10 floats
constexpr int kBlock = 128;

struct Args {
  const float* nodes;
  const float* leaves;
  const int* first;
  const float* ro;
  const float* rd;
  const float* tmax;
  const float* smask;  // the mixed form's shadow flags, or null
  float* t_out;
  int* tri_out;
  int* stats;  // int32 [ceil(n_rays / packet), 128], zeroed, or null
  int n_rays, n_nodes, n_leaf_rows, packet;
  float tmin, shadow_tmin;
};

// One thread's ray: the body of packet_kernel and packet_option_kernel
template <bool kAny, bool kMixed, bool kNearFirst, bool kStats>
__device__ __forceinline__ void packet_walk(const Args& a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // warp-uniform; the stats instances keep every warp for the block's sum
  if (!kStats && i - lane >= a.n_rays) return;
  const bool real = i < a.n_rays;
  const Ray r = real ? load_ray(a.ro, a.rd, i)
                     : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  // closest: LIMIT = best t from min(F32_MAX, tmax), an open bound (a dead
  // lane with tmax = -inf returns t = -inf, tri = -1, and walks no node);
  // any-hit: LIMIT = tmax, a closed bound; mixed: LIMIT = best t for both
  // kinds of lane
  const float tm = real ? __ldg(a.tmax + i) : -kF32Max;
  const bool live =
      real && tm != __int_as_float(static_cast<int>(0xff800000u));
  const bool shad = kMixed && real && __ldg(a.smask + i) == 1.0f;
  Best b;
  b.t = (kAny && !kMixed) ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
  const float slab_tmin = kMixed ? fminf(a.tmin, a.shadow_tmin) : a.tmin;
  int tests = 0;
  const int pops = bvh8::walk<kStackDepth, kNearFirst>(
      a.nodes, a.n_nodes, a.n_leaf_rows, r, slab_tmin,
      (kAny && !kMixed) ? &tm : &b.t, live, [&](int lr) {
        if (kStats) ++tests;
        const float* lf = a.leaves + static_cast<size_t>(lr) * kLeafFloats;
        if (kMixed) {
          return shad ? test_row<true, false>(r, lf, lr * kLeafSize, a.first,
                                              a.shadow_tmin, b.t, &b)
                      : test_row<false, false>(r, lf, lr * kLeafSize,
                                               a.first, a.tmin, tm, &b);
        }
        return test_row<kAny, false>(r, lf, lr * kLeafSize, a.first, a.tmin,
                                     tm, &b);
      });
  if constexpr (kStats) {
    // the block's sums (the block lies in one packet; integer sums wrap
    // and do not depend on order)
    __shared__ unsigned part[2][kBlock / 32];
    const unsigned n_pops = __reduce_add_sync(kFull, pops);
    const unsigned n_tests = __reduce_add_sync(kFull, tests);
    if (lane == 0) {
      part[0][threadIdx.x >> 5] = n_pops;
      part[1][threadIdx.x >> 5] = n_tests;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned p = 0, t = 0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) {
        p += part[0][w];
        t += part[1][w];
      }
      unsigned* row = reinterpret_cast<unsigned*>(a.stats) +
                      static_cast<size_t>(blockIdx.x * kBlock / a.packet) *
                          128;
      atomicAdd(row, p);
      atomicAdd(row + 1, t);
    }
  }
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}

// The three storage-order instances without stats (kNearFirst and kStats
// false; the template keeps both, so their names and code stay as they
// were before the options had kernels of their own)
template <bool kAny, bool kMixed, bool kNearFirst, bool kStats>
__global__ void __launch_bounds__(kBlock) packet_kernel(Args a) {
  packet_walk<kAny, kMixed, kNearFirst, kStats>(a);
}

// The option instances (near-first order, stats), each held to the blocks
// an SM it must keep resident: the storage-order stats instances 7, as
// their twins without stats run (72 / 70 registers; the counters took
// them to 74 registers and 6 blocks), the near-first instances 9
template <bool kAny, bool kMixed, bool kNearFirst, bool kStats>
__global__ void __launch_bounds__(kBlock, kNearFirst ? 9 : 7)
    packet_option_kernel(Args a) {
  packet_walk<kAny, kMixed, kNearFirst, kStats>(a);
}

template <bool kAny, bool kMixed, bool kNearFirst, bool kStats>
int launch(const Args& a, cudaStream_t s) {
  const int grid = (a.n_rays + kBlock - 1) / kBlock;
  if constexpr (kNearFirst || kStats) {
    packet_option_kernel<kAny, kMixed, kNearFirst, kStats>
        <<<grid, kBlock, 0, s>>>(a);
  } else {
    packet_kernel<kAny, kMixed, kNearFirst, kStats><<<grid, kBlock, 0, s>>>(
        a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the instance for the order and the counters (a.stats)
template <bool kAny, bool kMixed>
int launch(const Args& a, bool ordered, cudaStream_t s) {
  if (ordered) {
    return a.stats ? launch<kAny, kMixed, true, true>(a, s)
                   : launch<kAny, kMixed, true, false>(a, s);
  }
  return a.stats ? launch<kAny, kMixed, false, true>(a, s)
                 : launch<kAny, kMixed, false, false>(a, s);
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success, or
// cudaErrorInvalidValue for a packet that is not a positive multiple of
// 128 (nothing is launched). ordered != 0 takes the near-first instance;
// stats is null or int32 [ceil(n_rays / packet), 128], zeroed.
extern "C" int packet_walk_launch(const float* nodes, const float* leaves,
                                  const int* first, const float* ro,
                                  const float* rd, const float* tmax,
                                  float* t_out, int* tri_out, int* stats,
                                  int n_rays, int n_nodes, int n_leaf_rows,
                                  int packet, int ordered, float tmin,
                                  int any_hit, void* stream) {
  if (packet <= 0 || packet % 128 != 0) return cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const Args a{nodes,   leaves, first,  ro,      rd,          tmax,
               nullptr, t_out,  tri_out, stats,  n_rays,      n_nodes,
               n_leaf_rows, packet, tmin, tmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true, false>(a, ordered != 0, s)
                 : launch<false, false>(a, ordered != 0, s);
}

// The mixed form: smask [n_rays] flags shadow lanes with 1.0. Same
// ordering, stats, stream and return conventions as packet_walk_launch.
extern "C" int packet_walk_mixed_launch(
    const float* nodes, const float* leaves, const int* first,
    const float* ro, const float* rd, const float* tmax, const float* smask,
    float* t_out, int* tri_out, int* stats, int n_rays, int n_nodes,
    int n_leaf_rows, int packet, int ordered, float tmin, float shadow_tmin,
    void* stream) {
  if (packet <= 0 || packet % 128 != 0) return cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const Args a{nodes,  leaves, first,   ro,     rd,     tmax,
               smask,  t_out,  tri_out, stats,  n_rays, n_nodes,
               n_leaf_rows, packet, tmin, shadow_tmin};
  return launch<false, true>(a, ordered != 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* packet_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
