"""Scalar numpy oracle of the reference renderer.

An independent, straight-line reimplementation of src/shader.wgsl's compute
path (`main` -> `pixel_color` -> BRDFs/NEE) plus the host chunk mapping
(src/state.rs:336-379), written per-pixel in numpy float32. It is *slow* and
exists only so tests can compare the vectorised JAX engine against a second,
obviously-faithful implementation of the same semantics — the "fake backend"
test strategy the reference never had (SURVEY.md §4).

Float discipline: every scalar is np.float32; numpy (NEP 50) keeps
float32 results for float32 op python-float. The RNG is exact integer math
mod 2^32. Intersections brute-force all world-space triangles.
"""

from __future__ import annotations

import numpy as np

from ..scene.camera import CameraData
from ..scene.gltf import SceneData
from ..scene.pack import flatten_world_triangles

F32_MAX = np.float32(3.40282347e38)
F32_EPSILON = np.float32(1.1920929e-7)
PI = np.float32(3.1415926)
INV_PI = np.float32(0.3183098)
_MASK = 0xFFFFFFFF


def _dot3(a, b):
    """Explicitly-associated dot matching the JAX engine's rounding."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a, b):
    return np.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


class Rng:
    """src/shader.wgsl:137-149, exact u32 arithmetic."""

    def __init__(self, state: int):
        self.state = state & _MASK

    def next(self) -> np.float32:
        k = self.state
        k = (k * 0xCC9E2D51) & _MASK
        k = ((k << 15) | (k >> 17)) & _MASK
        k = (k * 0x1B873593) & _MASK
        self.state = k
        bits = np.uint32(0x3F800000 | (k >> 9))
        return bits.view(np.float32) - np.float32(1.0)


class OracleRenderer:
    def __init__(self, scene: SceneData, camera: CameraData):
        p0, e1, e2, vi, mat, obj = flatten_world_triangles(scene)
        self.p0 = p0
        self.e1 = e1
        self.e2 = e2
        self.vi = vi
        self.mat = mat
        self.obj = obj
        self.scene = scene
        self.world = camera.world.astype(np.float32)
        self.proj = camera.projection.astype(np.float32)
        if scene.n_lights:
            self.light_pos = scene.light_transform[:, :3, 3].astype(np.float32)
            self.light_color = scene.light_color.astype(np.float32)
        else:
            self.light_pos = np.zeros((1, 3), np.float32)
            self.light_color = np.zeros((1, 4), np.float32)
        self.n_lights = scene.n_lights

    # --- intersection (vectorised over triangles, f32) ---
    def ray_query(self, ro, rd, tmin, tmax):
        """Closest committed intersection; returns (tri, t, u, v) or None."""
        pvec = _cross3(np.broadcast_to(rd, self.e2.shape), self.e2)
        det = _dot3(self.e1, pvec)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = np.float32(1.0) / det
            tvec = ro - self.p0
            u = _dot3(tvec, pvec) * inv_det
            qvec = _cross3(tvec, self.e1)
            v = _dot3(rd, qvec) * inv_det
            t = _dot3(self.e2, qvec) * inv_det
        hit = (
            (det != 0.0)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t >= tmin)
            & (t <= tmax)
        )
        if not hit.any():
            return None
        t = np.where(hit, t, F32_MAX)
        k = int(np.argmin(t))
        return k, np.float32(t[k]), np.float32(u[k]), np.float32(v[k])

    # --- camera (src/shader.wgsl:299-310) ---
    def cast_ray(self, pixel, width, height):
        clip = (
            pixel / np.array([width, height], np.float32) * np.float32(2.0)
            - np.float32(1.0)
        )
        # explicit mat-vec expansion: same f32 association as the engine
        ndc_y = -clip[1]
        cam = np.array(
            [
                self.proj[i, 0] * clip[0]
                + self.proj[i, 1] * ndc_y
                + self.proj[i, 3]
                for i in range(4)
            ],
            np.float32,
        )
        inv_len4 = np.float32(1.0) / np.float32(
            np.sqrt(
                cam[0] * cam[0] + cam[1] * cam[1] + cam[2] * cam[2]
                + cam[3] * cam[3]
            )
        )
        cx, cy, cz = cam[0] * inv_len4, cam[1] * inv_len4, cam[2] * inv_len4
        d3 = np.array(
            [
                self.world[i, 0] * cx + self.world[i, 1] * cy
                + self.world[i, 2] * cz
                for i in range(3)
            ],
            np.float32,
        )
        d3 = d3 / np.float32(np.sqrt(_dot3(d3, d3)))
        return self.world[:3, 3].copy(), d3

    # --- hit decode (src/shader.wgsl:259-293) ---
    def hit_data(self, tri, u, v):
        vi = self.vi[tri]
        s = self.scene
        w0 = np.float32(1.0) - u - v
        # explicit left-associated interpolation (matches the engine)
        n = s.vertex_normal[vi]
        normal = n[0] * w0 + n[1] * u + n[2] * v
        pp = s.vertex_pos[vi]
        pos = pp[0] * w0 + pp[1] * u + pp[2] * v
        tt = s.vertex_uv[vi]
        uv = tt[0] * w0 + tt[1] * u + tt[2] * v
        return int(self.mat[tri]), normal.astype(np.float32), pos.astype(
            np.float32
        ), uv.astype(np.float32)

    def sample_texture(self, tex_id, uv):
        """Bilinear ClampToEdge sample of an RGBA8 texture -> f32 vec4."""
        img = self.scene.textures[tex_id].astype(np.float32) / np.float32(255.0)
        h, w = img.shape[:2]
        x = uv[0] * np.float32(w) - np.float32(0.5)
        y = uv[1] * np.float32(h) - np.float32(0.5)
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        ix0 = int(np.clip(x0, 0, w - 1))
        ix1 = int(np.clip(x0 + 1, 0, w - 1))
        iy0 = int(np.clip(y0, 0, h - 1))
        iy1 = int(np.clip(y0 + 1, 0, h - 1))
        top = img[iy0, ix0] * (np.float32(1.0) - fx) + img[iy0, ix1] * fx
        bot = img[iy1, ix0] * (np.float32(1.0) - fx) + img[iy1, ix1] * fx
        return top * (np.float32(1.0) - fy) + bot * fy

    # --- pixel_color (src/shader.wgsl:321-381) ---
    def pixel_color(self, pixel, width, height, bounces, rng: Rng):
        s = self.scene
        ro, rd = self.cast_ray(pixel, width, height)
        isect = self.ray_query(ro, rd, np.float32(0.001), F32_MAX)
        radiance = np.zeros(4, np.float32)
        attenuation = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
        remaining = bounces
        while isect is not None and remaining > 0:
            remaining -= 1
            tri, t, u, v = isect
            mat_id, normal, pos, uv = self.hit_data(tri, u, v)
            if float(_dot3(rd, normal)) >= 0.0:
                normal = -normal
            linear = s.object_transform[self.obj[tri]][:3, :3].astype(
                np.float32
            )
            p = np.array(
                [
                    linear[i, 0] * pos[0] + linear[i, 1] * pos[1]
                    + linear[i, 2] * pos[2]
                    for i in range(3)
                ],
                np.float32,
            ) + normal * F32_EPSILON

            if s.mat_has_texture[mat_id] == 1:
                in_color = self.sample_texture(int(s.mat_texture[mat_id]), uv)
            else:
                in_color = s.mat_color[mat_id].astype(np.float32)

            emission = np.float32(s.mat_emission[mat_id])
            metallic = np.float32(s.mat_metallic[mat_id])
            if emission > 0.0:
                radiance = radiance + s.mat_color[mat_id].astype(
                    np.float32
                ) * emission
                break
            elif metallic > 0.0:
                scattered = rd - np.float32(2.0) * np.float32(
                    _dot3(rd, normal)
                ) * normal
                out_color = in_color
                pdf = np.float32(1.0)
                attenuation = attenuation * (out_color / pdf)
            else:
                if rng.next() > 0.5:
                    # diffuse_brdf (src/shader.wgsl:212-226)
                    ux, uy = rng.next(), rng.next()
                    r = np.float32(np.sqrt(ux))
                    theta = np.float32(2.0) * PI * uy
                    dx = r * np.float32(np.cos(theta))
                    dy = r * np.float32(np.sin(theta))
                    dz = np.float32(np.sqrt(np.float32(1.0) - dx * dx - dy * dy))
                    scattered = np.array([dx, dy, dz], np.float32)
                    out_color = in_color / PI
                    pdf = np.float32(abs(rd[2])) * INV_PI
                    if rd[2] < 0.0:
                        scattered[2] = -scattered[2]
                else:
                    # glass_brdf (src/shader.wgsl:241-257)
                    uvd = rd / np.float32(np.sqrt(_dot3(rd, rd)))
                    cos_theta = np.float32(min(-_dot3(uvd, normal), 1.0))
                    ior = np.float32(s.mat_ior[mat_id])
                    out_perp = ior * (uvd + cos_theta * normal)
                    plen = np.float32(np.sqrt(abs(_dot3(out_perp, out_perp))))
                    out_parallel = -(np.float32(1.0) - plen * normal)
                    scattered = out_perp + out_parallel
                    out_color = in_color
                    pdf = np.float32(1.0)
                attenuation = attenuation * ((out_color / pdf) * np.float32(0.5))

            # NEE (src/shader.wgsl:370-374)
            li = int(rng.next() * np.float32(self.n_lights))
            li = min(max(li, 0), self.light_pos.shape[0] - 1)
            lpos = self.light_pos[li]
            dvec = lpos - p
            dist = np.float32(np.sqrt(_dot3(dvec, dvec)))
            ldir = dvec / dist
            blocked = (
                self.ray_query(p, ldir, np.float32(0.0), dist) is not None
            )
            if not blocked:
                contrib = (self.light_color[li] / np.float32(np.sqrt(dist))) / (
                    np.float32(1.0) / np.float32(self.n_lights)
                )
                radiance = radiance + contrib

            ro, rd = p, scattered
            isect = self.ray_query(ro, rd, np.float32(0.001), F32_MAX)
        return radiance * attenuation

    # --- main (src/shader.wgsl:395-419 + chunk loop src/state.rs:336-379) ---
    def render(self, width, height, seed, samples, bounces, chunk_size):
        img = np.zeros((height, width, 4), np.float32)
        cols = max(width // chunk_size, 1)
        # the host dispatches w*h/chunk_size chunks (src/state.rs:330-334);
        # the shader guard is pixel.y > height (src/shader.wgsl:406-408), so
        # partial bottom rows DO render — only x truncates to whole chunks
        # (engine twin: raytpu.engine.render._in_chunk_grid)
        total_chunks = (width * height) // chunk_size
        for py in range(height):
            for px in range(width):
                cx, cy = px // chunk_size, py // chunk_size
                chunk = cy * cols + cx
                if cx >= width // chunk_size or chunk >= total_chunks:
                    continue  # never dispatched by the reference
                lx, ly = px % chunk_size, py % chunk_size
                state = (
                    (lx + 1) * (ly + 1) * (chunk + 1) * seed
                ) & _MASK
                rng = Rng(state)
                color = np.zeros(4, np.float32)
                for _ in range(samples):
                    jx, jy = rng.next(), rng.next()
                    pixel = np.array(
                        [np.float32(px) + jx, np.float32(py) + jy], np.float32
                    )
                    color = color + self.pixel_color(
                        pixel, width, height, bounces, rng
                    )
                img[py, px] = color / np.float32(samples)
        return img
