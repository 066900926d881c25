"""The plain reference path tracer, one lane per sampled pixel.

It renders chosen pixels of chosen frames, each lane with its own frame
seed, by the semantics of the path tracer the program ports (the
reference WGSL shader, src/shader.wgsl, as raytpu reproduces it):

* per-pixel RNG: the state ``(lx+1)(ly+1)(chunk+1) seed`` mod 2^32 over
  chunk-local coordinates of ``chunk``-square tiles, advanced by the
  Murmur3 mix ``k *= 0xcc9e2d51; k = rotl(k, 15); k *= 0x1b873593`` and
  read as ``bitcast(0x3f800000 | k >> 9) - 1``; a lane that does not draw
  keeps its state; pixels outside the dispatched chunk grid stay black;
* camera rays: jitter ``+ (rand, rand)``, clip space, the inverse
  projection at z = 0, the 4-vector normalised before truncation, the
  camera's world matrix with w = 0, the origin its translation;
* closest hit (range [0.001, inf)) and shadow any-hit ([0, distance]) by
  Moller-Trumbore over every triangle, by brute force: no acceleration
  structure at all. Ties keep the lowest triangle of the scene's order;
* shading: face-forward interpolated normal, the hit point as the object's
  3x3 linear part times the interpolated object-space position (the
  shader drops the instance translation) plus ``normal * f32 epsilon``;
  emissive, metal (perfect mirror), and a 50/50 mix of the shader's
  global-z cosine-hemisphere diffuse and its glass refraction formula;
  next-event estimation to one light picked by a draw, added
  unattenuated; the attenuation multiplied in once at the path's end;
* flat mode: the base colour of the primary hit.

Each expression keeps the shader's order of operations, e.g.
``(ax*bx + ay*by) + az*bz``, one rounding per operation, so a float32
run reproduces a float32 program pixel for pixel, up to ties between
triangles. ``dtype`` below float32 makes the control that the comparison
must reject (``harness/check.py``).

It imports only numpy and torch: nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bvh
from .world import World

F32_MAX = float(np.float32(3.40282347e38))
PI = float(np.float32(3.1415926))
INV_PI = float(np.float32(0.3183098))
F32_EPSILON = float(np.float32(1.1920929e-7))
M32 = 0xFFFFFFFF
# elements of one [rays, triangles] plane of a sweep
PLANE = 1 << 25


# --- RNG: u32 values held in int64 ---------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for u32 ``a`` in int64, by 16-bit halves of ``c``
    (no product passes 2^49)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _hash(k: torch.Tensor) -> torch.Tensor:
    k = _mul32(k, 0xCC9E2D51)
    k = ((k << 15) | (k >> 17)) & M32
    return _mul32(k, 0x1B873593)


def _unit(k: torch.Tensor, dtype) -> torch.Tensor:
    bits = ((k >> 9) | 0x3F800000).to(torch.int32)
    return (bits.view(torch.float32) - 1.0).to(dtype)


def rand(state, dtype, mask=None):
    """(new state, value in [0, 1)); lanes outside ``mask`` keep their
    state and their value is not to be used."""
    new = _hash(state)
    value = _unit(new, dtype)
    return (new if mask is None else torch.where(mask, new, state)), value


def seed_lanes(px, py, seeds, width: int, chunk: int) -> np.ndarray:
    """Initial RNG state of each lane (u32 in int64): pixel (px, py) of a
    frame with seed ``seeds`` (host integer arrays)."""
    px = np.asarray(px, np.uint64)
    py = np.asarray(py, np.uint64)
    cols = max(width // chunk, 1)
    tile = (py // chunk) * cols + px // chunk
    s = ((px % chunk + 1) * (py % chunk + 1)) & M32
    s = (s * (tile + 1)) & M32
    s = (s * (np.asarray(seeds, np.uint64) & M32)) & M32
    return s.astype(np.int64)


def in_chunk_grid(px, py, width: int, height: int, chunk: int) -> np.ndarray:
    """The pixels the shader's dispatch covers: x in whole chunks, y in
    the frame, chunk index below ``width * height // chunk``."""
    px = np.asarray(px, np.int64)
    py = np.asarray(py, np.int64)
    tile = (py // chunk) * max(width // chunk, 1) + px // chunk
    return ((px // chunk < width // chunk) & (py < height)
            & (tile < width * height // chunk))


# --- vector helpers (explicit association) -------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def camera_rays(w: World, pxf, pyf, width: int, height: int):
    """Pinhole rays through the jittered pixel positions (src/shader.wgsl
    :299-310)."""
    proj, cam = w.cam_proj, w.cam_world
    cx = pxf / float(width) * 2.0 - 1.0
    cy = -(pyf / float(height) * 2.0 - 1.0)
    c = [proj[i, 0] * cx + proj[i, 1] * cy + proj[i, 3] for i in range(4)]
    inv = 1.0 / torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
                           + c[3] * c[3])
    x, y, z = c[0] * inv, c[1] * inv, c[2] * inv
    d = torch.stack([cam[i, 0] * x + cam[i, 1] * y + cam[i, 2] * z
                     for i in range(3)], dim=-1)
    return cam[:3, 3].expand(d.shape), _normalize(d)


# --- brute-force sweep ---------------------------------------------------

def _sweep_chunk(w: World, ro, rd, tmin, tmax, any_hit: bool):
    """Moller-Trumbore of rays [n] against every triangle, as [n, T]
    planes; the closest hit (t, triangle) or the any-hit flags."""
    g = w.geo
    o = [ro[:, i:i + 1] for i in range(3)]
    d = [rd[:, i:i + 1] for i in range(3)]
    e1 = [g["e10"], g["e11"], g["e12"]]
    e2 = [g["e20"], g["e21"], g["e22"]]
    pv = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0]]
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    inv_det = 1.0 / det
    tv = [o[0] - g["p00"], o[1] - g["p01"], o[2] - g["p02"]]
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det
    del pv
    qv = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0]]
    del tv
    v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
    del qv
    hit = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tmin) & (t <= tmax[:, None]))
    if any_hit:
        return hit.any(dim=1)
    t = torch.where(hit, t, float("inf"))
    best, tri = t.min(dim=1)  # the first minimum: the lowest triangle
    return best, tri


def sweep(w: World, ro, rd, tmin: float, tmax, any_hit: bool = False):
    """Closest hit (t [R], triangle [R] int64, valid [R]) or any-hit flags
    [R] of rays ``ro``/``rd`` over [tmin, tmax] (``tmax`` per ray): over
    every triangle, or through the world's BVH where it has one (the same
    answers, ``bvh.py``)."""
    if w.tree is not None:
        return bvh.walk(w.tree, w.geo, ro, rd, tmin, tmax, any_hit)
    step = max(1, PLANE // max(w.n, 1))
    parts = [_sweep_chunk(w, ro[i:i + step], rd[i:i + step], tmin,
                          tmax[i:i + step], any_hit)
             for i in range(0, ro.shape[0], step)]
    if any_hit:
        return torch.cat(parts)
    t = torch.cat([p[0] for p in parts])
    tri = torch.cat([p[1] for p in parts])
    return t, tri, torch.isfinite(t)


# --- shading -------------------------------------------------------------

def _shade(w: World, ro, rd, tri, rng, active):
    """One bounce's shading body for lanes ``active``: returns the
    emissive term, the attenuation multiplier, the scattered ray, whether
    the path bounces, the shadow ray and its contribution, and the RNG."""
    dt = w.dtype
    i = torch.clamp(tri, min=0)
    p0 = torch.stack([w.geo[f"p0{k}"][i] for k in range(3)], dim=-1)
    e1 = torch.stack([w.geo[f"e1{k}"][i] for k in range(3)], dim=-1)
    e2 = torch.stack([w.geo[f"e2{k}"][i] for k in range(3)], dim=-1)
    # barycentrics, the sweep's own expressions
    pv = torch.stack([rd[:, 1] * e2[:, 2] - rd[:, 2] * e2[:, 1],
                      rd[:, 2] * e2[:, 0] - rd[:, 0] * e2[:, 2],
                      rd[:, 0] * e2[:, 1] - rd[:, 1] * e2[:, 0]], dim=-1)
    inv_det = 1.0 / _dot(e1, pv)
    tv = ro - p0
    u = _dot(tv, pv) * inv_det
    qv = torch.stack([tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1],
                      tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2],
                      tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]], dim=-1)
    v = _dot(rd, qv) * inv_det
    b0, b1, b2 = (1.0 - u - v)[:, None], u[:, None], v[:, None]
    pos = w.pos[i, 0] * b0 + w.pos[i, 1] * b1 + w.pos[i, 2] * b2
    normal = w.nrm[i, 0] * b0 + w.nrm[i, 1] * b1 + w.nrm[i, 2] * b2
    metallic, emission, ior = w.metallic[i], w.emission[i], w.ior[i]
    color = w.color[i]

    normal = torch.where((_dot(rd, normal) < 0.0)[:, None], normal, -normal)
    lin = w.lin[i]
    p = torch.stack([lin[:, 3 * r] * pos[:, 0] + lin[:, 3 * r + 1] * pos[:, 1]
                     + lin[:, 3 * r + 2] * pos[:, 2] for r in range(3)],
                    dim=-1) + normal * F32_EPSILON

    emissive = active & (emission > 0.0)
    metal = active & ~emissive & (metallic > 0.0)
    mixed = active & ~emissive & ~(metallic > 0.0)
    emit = torch.where(emissive[:, None], color * emission[:, None], 0.0)

    scat_metal = rd - 2.0 * _dot(rd, normal)[:, None] * normal

    rng, r_mix = rand(rng, dt, mixed)
    diffuse = mixed & (r_mix > 0.5)
    rng, u1 = rand(rng, dt, diffuse)
    rng, u2 = rand(rng, dt, diffuse)
    r_disk = torch.sqrt(u1)
    theta = 2.0 * PI * u2
    dx = r_disk * torch.cos(theta)
    dy = r_disk * torch.sin(theta)
    dz = torch.sqrt(1.0 - dx * dx - dy * dy)
    dz = torch.where(rd[:, 2] < 0.0, -dz, dz)
    scat_diffuse = torch.stack([dx, dy, dz], dim=-1)
    att_diffuse = (color / PI) / (torch.abs(rd[:, 2]) * INV_PI)[:, None]

    unit = _normalize(rd)
    cos_t = torch.clamp(-_dot(unit, normal), max=1.0)
    perp = ior[:, None] * (unit + cos_t[:, None] * normal)
    perp_len = torch.sqrt(torch.abs(_dot(perp, perp)))
    scat_glass = perp + -(1.0 - perp_len[:, None] * normal)

    mult = torch.where(metal[:, None], color,
                       torch.where(diffuse[:, None], att_diffuse * 0.5,
                                   color * 0.5))
    scattered = torch.where(metal[:, None], scat_metal,
                            torch.where(diffuse[:, None], scat_diffuse,
                                        scat_glass))
    on = metal | mixed

    rng, r_light = rand(rng, dt, on)
    li = torch.clamp((r_light * w.n_lights_f).to(torch.int32), 0,
                     w.n_lights - 1).long()
    to_light = w.light_pos[li] - p
    dist = torch.sqrt(_dot(to_light, to_light))
    ldir = to_light / dist[:, None]
    contrib = (w.light_color[li] / torch.sqrt(dist)[:, None]) / (
        1.0 / w.n_lights_f)
    return emit, mult, p, scattered, on, ldir, dist, contrib, rng


def _trace(w: World, ro, rd, rng, alive, bounces: int):
    """Radiance of one path per lane (src/shader.wgsl:321-381), the RNG,
    and the number of bounces the lanes survived, summed."""
    n = ro.shape[0]
    survived = 0
    radiance = torch.zeros((n, 4), dtype=w.dtype, device=w.device)
    att = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=w.dtype,
                       device=w.device).expand(n, 4)
    for _ in range(bounces):
        if not bool(alive.any()):
            break
        _, tri, valid = sweep(w, ro, rd, 0.001,
                              torch.where(alive, F32_MAX, float("-inf")))
        emit, mult, p, scat, on, ldir, dist, contrib, rng = _shade(
            w, ro, rd, tri, rng, alive & valid)
        blocked = sweep(w, p, ldir, 0.0,
                        torch.where(on, dist, float("-inf")), any_hit=True)
        radiance = radiance + (emit + torch.where((on & ~blocked)[:, None],
                                                  contrib, 0.0))
        ro = torch.where(on[:, None], p, ro)
        rd = torch.where(on[:, None], scat, rd)
        att = torch.where(on[:, None], att * mult, att)
        alive = on
        survived += int(on.sum())
    return radiance * att, rng, survived


def render_lanes(w: World, px, py, seeds, *, width: int, height: int,
                 chunk: int, samples: int, bounces: int, mode: str,
                 block: int = 4096) -> np.ndarray:
    """[N, 4] float32: pixel (px[k], py[k]) of the frame rendered with
    seed ``seeds[k]``, by the reference, in blocks of ``block`` lanes."""
    if mode not in ("path", "flat"):
        raise ValueError(f"unknown mode {mode!r}")
    px, py = np.asarray(px, np.int64), np.asarray(py, np.int64)
    state0 = seed_lanes(px, py, seeds, width, chunk)
    grid0 = in_chunk_grid(px, py, width, height, chunk)
    out = []
    for a in range(0, px.shape[0], block):
        sl = slice(a, a + block)
        dev = w.device
        rng = torch.as_tensor(state0[sl], device=dev)
        grid = torch.as_tensor(grid0[sl], device=dev)
        pxf = torch.as_tensor(px[sl], device=dev).to(torch.float32)
        pyf = torch.as_tensor(py[sl], device=dev).to(torch.float32)
        acc = torch.zeros((pxf.shape[0], 4), dtype=w.dtype, device=dev)
        for _ in range(samples):
            rng, jx = rand(rng, torch.float32)
            rng, jy = rand(rng, torch.float32)
            ro, rd = camera_rays(w, (pxf + jx).to(w.dtype),
                                 (pyf + jy).to(w.dtype), width, height)
            if mode == "flat":
                _, tri, valid = sweep(w, ro, rd, 0.001, torch.full(
                    (ro.shape[0],), F32_MAX, device=dev))
                color = torch.where(valid[:, None],
                                    w.color[torch.clamp(tri, min=0)], 0.0)
            else:
                color, rng, _ = _trace(w, ro, rd, rng, grid, bounces)
            acc = acc + color
        img = torch.where(grid[:, None], acc / float(samples), 0.0)
        out.append(img.float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 4), np.float32)


def count_queries(w: World, seeds, *, width: int, height: int, chunk: int,
                  samples: int, bounces: int, mode: str,
                  block: int = 1 << 21) -> int:
    """The ray queries of whole frames rendered with ``seeds``, by the
    shader's cost model: one primary query per pixel of the dispatched
    chunk grid and sample, and two (a shadow ray and the next bounce's
    query) per bounce a path survives. A flat frame queries its primaries
    only. Path frames are traced whole, through the world's BVH; with a
    BVH a flat frame's primaries are walked too, so that the tree counts
    every query's box and triangle tests (``bvh.Tree``)."""
    ys, xs = np.mgrid[0:height, 0:width]
    px, py = xs.ravel(), ys.ravel()
    grid0 = in_chunk_grid(px, py, width, height, chunk)
    total = int(grid0.sum()) * samples * len(seeds)
    if mode == "flat" and w.tree is None:
        return total
    dev = w.device
    for seed in seeds:
        state0 = seed_lanes(px, py, np.full(px.shape, seed), width, chunk)
        for a in range(0, px.shape[0], block):
            sl = slice(a, a + block)
            rng = torch.as_tensor(state0[sl], device=dev)
            grid = torch.as_tensor(grid0[sl], device=dev)
            pxf = torch.as_tensor(px[sl], device=dev).to(torch.float32)
            pyf = torch.as_tensor(py[sl], device=dev).to(torch.float32)
            for _ in range(samples):
                rng, jx = rand(rng, torch.float32)
                rng, jy = rand(rng, torch.float32)
                ro, rd = camera_rays(w, pxf + jx, pyf + jy, width, height)
                if mode == "flat":
                    sweep(w, ro, rd, 0.001,
                          torch.where(grid, F32_MAX, float("-inf")))
                    continue
                _, rng, survived = _trace(w, ro, rd, rng, grid, bounces)
                total += 2 * survived
    return total
