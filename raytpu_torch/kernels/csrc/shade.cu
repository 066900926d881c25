// shade.cu — the engine's per-bounce shading body, one thread a lane.
//
// render._shade_core shades each lane's closest hit (src/shader.wgsl:
// 339-374 up to the shadow query): the barycentric recompute and the
// interpolated position, normal and uv from the hit's tri_row row, the
// face-forward normal, the hit point with its w = 0 quirk, the base colour
// (with kernels/texture.py's bilinear sample), the material dispatch, the
// four masked RNG draws, the metal, diffuse and glass directions and the
// NEE light pick. Its plain version is kernels/shade.py:shade_core_torch.
// It replaces no Pallas kernel: raytpu's _shade_core
// (raytpu/engine/render.py:473) is jnp code that XLA fuses into the
// bounce's program on the TPU. In torch ops it was ~220 elementwise
// launches a call, each a pass over every lane of the wave; here it is one.
//
// Which tables a lane reads follows the pack's shapes, passed as
// arguments: the material from tri_row columns 42..50 when the pack has
// several materials, else mat_table row 0; the object's 3x3 from columns
// 33..41 when it has several objects, else object_linear row 0; the light
// from the r_light pick when it has several lights, else light_table row
// 0; the texture sample only in a pack with textures.
//
// Float rules (kernels/_build.py: no FMA contraction, IEEE division and
// square root, no flush to zero; sinf, cosf and sqrtf are libdevice's):
// every value is rounded where the plain version rounds it, in its order,
// e.g. (ax*bx + ay*by) + az*bz. The plain version is held bit for bit on
// CUDA tensors, where ATen's kernels fix two points: a tensor divided by a
// Python float is multiplied by the float's f32 reciprocal (in_color / PI,
// BinaryDivTrueKernel.cu), and `1.0 / x` of a tensor is its reciprocal.
// Every other division is a true one.
//
// Lanes: an inactive lane keeps its RNG state, writes bounce_on false and
// a zero emissive term, and reads no row. Every caller reads p,
// scattered, att_mult, ldir, dist and contrib only where bounce_on holds,
// so a lane without a bounce writes zeros there.
//
// What bounds it on an H100: bytes. A lane reads its RNG state and active
// flag (5 B) and writes 93 B; an active lane also reads its ray (24 B),
// its tri (4 B) and 144 to 208 B of its tri_row row in 16-byte loads. The
// cube stand-in's 262,144-lane waves, ~12% of them hits, move ~26 MB a
// call.

#include <cuda_runtime.h>

#include <cstdint>

namespace shade {

constexpr int kBlock = 128;
// render.py's f32 constants (src/shader.wgsl:2-4)
constexpr float kPi = 3.1415926f;
constexpr float kInvPi = 0.3183098f;
constexpr float kEpsilon = 1.1920929e-7f;

struct Args {
  const float* ro;
  const float* rd;
  const int* tri;
  const int* rng_in;
  const unsigned char* active;
  const float* tri_row;        // [T, 64], 16-byte aligned
  const float* object_linear;  // [O, 16]
  const float* mat_table;      // [M, 16]
  const float* light_table;    // [L, 8]
  const float* n_lights_f;     // [] f32(number of lights)
  const float* tex_atlas;      // [N, 4], 16-byte aligned
  const int* tex_size;         // [Tx, 3] (width, height, flat offset)
  int* rng_out;
  float* p;
  float* scattered;
  float* att_mult;
  unsigned char* bounce_on;
  float* emissive;
  float* ldir;
  float* dist;
  float* contrib;
  long long ro_s0, ro_s1, rd_s0, rd_s1, tri_s, rng_s, act_s;
  int n, n_lights, multi_mat, multi_obj, has_textures;
};

// kernels/rng.py: one Murmur3 round and the unit float of its bits
__device__ __forceinline__ uint32_t hash_u32(uint32_t k) {
  k *= 0xcc9e2d51u;
  k = (k << 15) | (k >> 17);
  return k * 0x1b873593u;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float(0x3f800000u | (bits >> 9)) - 1.0f;
}

__device__ __forceinline__ int texel(float v, int hi_excl) {
  return min(max(__float2int_rz(v), 0), hi_excl - 1);
}

// kernels/texture.py:sample_bilinear for one lane
__device__ float4 sample_bilinear(const Args& a, int tex_id, float u,
                                  float v) {
  const int wi = __ldg(a.tex_size + 3 * tex_id);
  const int hi = __ldg(a.tex_size + 3 * tex_id + 1);
  const int off = __ldg(a.tex_size + 3 * tex_id + 2);
  const float x = u * static_cast<float>(wi) - 0.5f;
  const float y = v * static_cast<float>(hi) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int ix0 = texel(x0, wi);
  const int ix1 = texel(x0 + 1.0f, wi);
  const int iy0 = texel(y0, hi);
  const int iy1 = texel(y0 + 1.0f, hi);
  const float4* atlas = reinterpret_cast<const float4*>(a.tex_atlas);
  const float4 t00 = __ldg(atlas + (off + iy0 * wi + ix0));
  const float4 t10 = __ldg(atlas + (off + iy0 * wi + ix1));
  const float4 t01 = __ldg(atlas + (off + iy1 * wi + ix0));
  const float4 t11 = __ldg(atlas + (off + iy1 * wi + ix1));
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top[4] = {t00.x * gx + t10.x * fx, t00.y * gx + t10.y * fx,
                        t00.z * gx + t10.z * fx, t00.w * gx + t10.w * fx};
  const float bot[4] = {t01.x * gx + t11.x * fx, t01.y * gx + t11.y * fx,
                        t01.z * gx + t11.z * fx, t01.w * gx + t11.w * fx};
  return make_float4(top[0] * gy + bot[0] * fy, top[1] * gy + bot[1] * fy,
                     top[2] * gy + bot[2] * fy, top[3] * gy + bot[3] * fy);
}

__global__ void __launch_bounds__(kBlock) shade_kernel(Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s = static_cast<uint32_t>(a.rng_in[i * a.rng_s]);
  bool on = false;
  float emis[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float att[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float con[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float p[3] = {0.0f, 0.0f, 0.0f};
  float scat[3] = {0.0f, 0.0f, 0.0f};
  float ld[3] = {0.0f, 0.0f, 0.0f};
  float dist = 0.0f;
  if (a.active[i * a.act_s]) {
    // the hit's row: columns 0..35 always, 36..43 for the object's 3x3
    // (33..41) or the material (42..50), 44..51 for the material
    const int t = max(a.tri[i * a.tri_s], 0);
    const float4* row4 =
        reinterpret_cast<const float4*>(a.tri_row) + 16LL * t;
    float r[52];
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      if (k < 9 || (k == 9 && a.multi_obj) ||
          (k == 10 && (a.multi_obj || a.multi_mat)) ||
          (k > 10 && a.multi_mat)) {
        const float4 q = __ldg(row4 + k);
        r[4 * k] = q.x;
        r[4 * k + 1] = q.y;
        r[4 * k + 2] = q.z;
        r[4 * k + 3] = q.w;
      } else {
        r[4 * k] = r[4 * k + 1] = r[4 * k + 2] = r[4 * k + 3] = 0.0f;
      }
    }
    const float o[3] = {a.ro[i * a.ro_s0], a.ro[i * a.ro_s0 + a.ro_s1],
                        a.ro[i * a.ro_s0 + 2 * a.ro_s1]};
    const float d[3] = {a.rd[i * a.rd_s0], a.rd[i * a.rd_s0 + a.rd_s1],
                        a.rd[i * a.rd_s0 + 2 * a.rd_s1]};

    // barycentrics (kernels/intersect.py): p0 / e1 / e2 in columns 0..8
    const float pv[3] = {d[1] * r[8] - d[2] * r[7], d[2] * r[6] - d[0] * r[8],
                         d[0] * r[7] - d[1] * r[6]};
    const float det = r[3] * pv[0] + r[4] * pv[1] + r[5] * pv[2];
    const float inv_det = 1.0f / det;
    const float tv[3] = {o[0] - r[0], o[1] - r[1], o[2] - r[2]};
    const float bu = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det;
    const float qv[3] = {tv[1] * r[5] - tv[2] * r[4],
                         tv[2] * r[3] - tv[0] * r[5],
                         tv[0] * r[4] - tv[1] * r[3]};
    const float bv = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det;
    const float w0 = 1.0f - bu - bv;
    float pos[3], nrm[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[k] = r[9 + k] * w0 + r[12 + k] * bu + r[15 + k] * bv;
      nrm[k] = r[18 + k] * w0 + r[21 + k] * bu + r[24 + k] * bv;
    }
    const float uv0 = r[27] * w0 + r[29] * bu + r[31] * bv;
    const float uv1 = r[28] * w0 + r[30] * bu + r[32] * bv;

    float metallic, emission, ior, color[4];
    int tex_id;
    bool has_tex;
    if (a.multi_mat) {
      metallic = r[42];
      emission = r[43];
      ior = r[44];
      tex_id = __float_as_int(r[45]);
      has_tex = __float_as_int(r[46]) == 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) color[c] = r[47 + c];
    } else {
      const float* m = a.mat_table;
      metallic = __ldg(m);
      emission = __ldg(m + 2);
      ior = __ldg(m + 3);
      tex_id = __float_as_int(__ldg(m + 4));
      has_tex = __float_as_int(__ldg(m + 5)) == 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) color[c] = __ldg(m + 8 + c);
    }

    // face-forward normal (src/shader.wgsl:339-343)
    if (!(d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2] < 0.0f)) {
      nrm[0] = -nrm[0];
      nrm[1] = -nrm[1];
      nrm[2] = -nrm[2];
    }

    // base colour (:349-353)
    float in_color[4] = {color[0], color[1], color[2], color[3]};
    if (a.has_textures && has_tex) {
      const float4 tx = sample_bilinear(a, tex_id, uv0, uv1);
      in_color[0] = tx.x;
      in_color[1] = tx.y;
      in_color[2] = tx.z;
      in_color[3] = tx.w;
    }

    // material dispatch (:355-368) and the masked RNG draws
    const bool is_emissive = emission > 0.0f;
    const bool is_metal = !is_emissive && metallic > 0.0f;
    const bool is_mixed = !is_emissive && !(metallic > 0.0f);
    if (is_emissive) {
#pragma unroll
      for (int c = 0; c < 4; ++c) emis[c] = color[c] * emission;
    }
    uint32_t h = hash_u32(s);
    if (is_mixed) s = h;
    const bool is_diffuse = is_mixed && unit_float(h) > 0.5f;
    h = hash_u32(s);
    if (is_diffuse) s = h;
    const float u1 = unit_float(h);
    h = hash_u32(s);
    if (is_diffuse) s = h;
    const float u2 = unit_float(h);
    on = is_metal || is_mixed;
    h = hash_u32(s);
    if (on) s = h;
    const float r_light = unit_float(h);

    if (on) {
      if (is_metal) {
        // perfect mirror, roughness unused (:228-239)
        const float two =
            (d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2]) * 2.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) scat[k] = d[k] - two * nrm[k];
#pragma unroll
        for (int c = 0; c < 4; ++c) att[c] = in_color[c];
      } else if (is_diffuse) {
        // cosine hemisphere in the global-z frame (:212-226)
        const float r_disk = sqrtf(u1);
        const float theta = u2 * (2.0f * kPi);
        const float dx = r_disk * cosf(theta);
        const float dy = r_disk * sinf(theta);
        const float dz = sqrtf(1.0f - dx * dx - dy * dy);
        scat[0] = dx;
        scat[1] = dy;
        scat[2] = d[2] < 0.0f ? -dz : dz;
        const float pdf = fabsf(d[2]) * kInvPi;
        constexpr float kRecipPi = 1.0f / kPi;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          att[c] = in_color[c] * kRecipPi / pdf * 0.5f;
        }
      } else {
        // glass, the reference's refraction formula (:241-257)
        const float len = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        const float ud[3] = {d[0] / len, d[1] / len, d[2] / len};
        float ct = -(ud[0] * nrm[0] + ud[1] * nrm[1] + ud[2] * nrm[2]);
        if (ct == ct) ct = fminf(ct, 1.0f);  // a NaN stays, as clamp's
        float op[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) op[k] = ior * (ud[k] + ct * nrm[k]);
        const float perp =
            sqrtf(fabsf(op[0] * op[0] + op[1] * op[1] + op[2] * op[2]));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          scat[k] = op[k] + -(1.0f - perp * nrm[k]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) att[c] = in_color[c] * 0.5f;
      }

      // hit point, w = 0 drops the translation (:345)
      float lin[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        lin[k] = a.multi_obj ? r[33 + k] : __ldg(a.object_linear + k);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = lin[3 * k] * pos[0] + lin[3 * k + 1] * pos[1] +
               lin[3 * k + 2] * pos[2] + nrm[k] * kEpsilon;
      }

      // NEE: the light, its direction and unattenuated term (:370-374)
      const float n_lights_f = __ldg(a.n_lights_f);
      const float* light = a.light_table;
      if (a.n_lights != 1) {
        const int li = __float2int_rz(r_light * n_lights_f);
        light += 8 * min(max(li, 0), a.n_lights - 1);
      }
      float tl[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) tl[k] = __ldg(light + k) - p[k];
      dist = sqrtf(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) ld[k] = tl[k] / dist;
      const float root = sqrtf(dist);
      const float per_light = 1.0f / n_lights_f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        con[c] = __ldg(light + 4 + c) / root / per_light;
      }
    }
  }
  a.rng_out[i] = static_cast<int>(s);
  a.bounce_on[i] = on;
  reinterpret_cast<float4*>(a.emissive)[i] =
      make_float4(emis[0], emis[1], emis[2], emis[3]);
  reinterpret_cast<float4*>(a.att_mult)[i] =
      make_float4(att[0], att[1], att[2], att[3]);
  reinterpret_cast<float4*>(a.contrib)[i] =
      make_float4(con[0], con[1], con[2], con[3]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.p[3 * i + k] = p[k];
    a.scattered[3 * i + k] = scat[k];
    a.ldir[3 * i + k] = ld[k];
  }
  a.dist[i] = dist;
}

}  // namespace shade

// Launch on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaGetLastError() code after the launch, 0 on success (n <= 0 launches
// nothing). ro and rd are [n, 3] with the given element strides; tri,
// rng_in and active [n] with theirs; every output is contiguous and the
// [n, 4] ones 16-byte aligned.
extern "C" int shade_core_launch(
    const float* ro, const float* rd, const int* tri, const int* rng_in,
    const unsigned char* active, const float* tri_row,
    const float* object_linear, const float* mat_table,
    const float* light_table, const float* n_lights_f,
    const float* tex_atlas, const int* tex_size, int* rng_out, float* p,
    float* scattered, float* att_mult, unsigned char* bounce_on,
    float* emissive, float* ldir, float* dist, float* contrib,
    long long ro_s0, long long ro_s1, long long rd_s0, long long rd_s1,
    long long tri_s, long long rng_s, long long act_s, int n, int n_lights,
    int multi_mat, int multi_obj, int has_textures, void* stream) {
  if (n <= 0) return 0;
  const shade::Args a{ro,        rd,          tri,       rng_in,
                      active,    tri_row,     object_linear,
                      mat_table, light_table, n_lights_f, tex_atlas,
                      tex_size,  rng_out,     p,         scattered,
                      att_mult,  bounce_on,   emissive,  ldir,
                      dist,      contrib,     ro_s0,     ro_s1,
                      rd_s0,     rd_s1,       tri_s,     rng_s,
                      act_s,     n,           n_lights,  multi_mat,
                      multi_obj, has_textures};
  const int grid = (n + shade::kBlock - 1) / shade::kBlock;
  shade::shade_kernel<<<grid, shade::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shade_core_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
