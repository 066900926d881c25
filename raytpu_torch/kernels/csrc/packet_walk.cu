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
// traversal with postponed leaves (bvh8_walk.cuh). Near-first child order
// (by the ray's entry distance, as raytpu's kernel orders by a packet
// representative) and a shared-memory short stack measured slower and were
// reverted; the stack stays in local memory (2 KB a thread).

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
  int n_rays, n_nodes, n_leaf_rows;
  float tmin, shadow_tmin;
};

template <bool kAny, bool kMixed = false>
__global__ void __launch_bounds__(kBlock) packet_kernel(Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i - (threadIdx.x & 31) >= a.n_rays) return;  // warp-uniform
  const bool real = i < a.n_rays;
  const Ray r = real ? load_ray(a.ro, a.rd, i)
                     : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  // closest: LIMIT = best t from min(F32_MAX, tmax), an open bound (a dead
  // lane with tmax = -inf returns t = -inf, tri = -1); any-hit: LIMIT =
  // tmax, a closed bound; mixed: LIMIT = best t for both kinds of lane
  const float tm = real ? __ldg(a.tmax + i) : -kF32Max;
  const bool shad = kMixed && real && __ldg(a.smask + i) == 1.0f;
  Best b;
  b.t = (kAny && !kMixed) ? tm : nan_min(kF32Max, tm);
  b.tri = -1;
  b.key = -1;
  const float slab_tmin = kMixed ? fminf(a.tmin, a.shadow_tmin) : a.tmin;
  bvh8::walk<kStackDepth>(
      a.nodes, a.n_nodes, a.n_leaf_rows, r, slab_tmin,
      (kAny && !kMixed) ? &tm : &b.t, real, [&](int lr) {
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
  if (real) {
    a.t_out[i] = b.t;
    a.tri_out[i] = b.tri;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success.
extern "C" int packet_walk_launch(const float* nodes, const float* leaves,
                                  const int* first, const float* ro,
                                  const float* rd, const float* tmax,
                                  float* t_out, int* tri_out, int n_rays,
                                  int n_nodes, int n_leaf_rows, float tmin,
                                  int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const Args a{nodes,  leaves,  first,       ro,   rd,  tmax, nullptr,
               t_out,  tri_out, n_rays, n_nodes, n_leaf_rows, tmin, tmin};
  const int grid = (n_rays + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    packet_kernel<true><<<grid, kBlock, 0, s>>>(a);
  } else {
    packet_kernel<false><<<grid, kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The mixed form: smask [n_rays] flags shadow lanes with 1.0. Same stream
// and return convention as packet_walk_launch.
extern "C" int packet_walk_mixed_launch(const float* nodes,
                                        const float* leaves, const int* first,
                                        const float* ro, const float* rd,
                                        const float* tmax, const float* smask,
                                        float* t_out, int* tri_out,
                                        int n_rays, int n_nodes,
                                        int n_leaf_rows, float tmin,
                                        float shadow_tmin, void* stream) {
  if (n_rays <= 0) return 0;
  const Args a{nodes,  leaves,  first,  ro,      rd,          tmax, smask,
               t_out,  tri_out, n_rays, n_nodes, n_leaf_rows, tmin,
               shadow_tmin};
  const int grid = (n_rays + kBlock - 1) / kBlock;
  packet_kernel<false, true>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packet_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
