"""Ray-triangle intersection: Möller–Trumbore and the brute-force sweep.

Torch counterpart of ``raytpu.kernels.intersect`` (``Hit``,
``moller_trumbore``, ``barycentrics``, ``intersect_bruteforce``,
``intersect_any_bruteforce``). It is the ``brute`` route and the oracle
the strand kernel is tested against.

Float rules: every expression keeps raytpu's association, e.g.
``(ax*bx + ay*by) + az*bz``, and torch rounds once per elementwise op, so
the results are bit-equal to a numpy sweep with the same operation order.
No ``addcmul``/``lerp``/``matmul`` here: each would change the rounding.

Ranges are closed, [tmin, tmax]. Degenerate padding triangles
(e1 = e2 = 0) give det == 0 and never hit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32_MAX = float(np.float32(3.40282347e38))  # the largest finite f32


class Hit(NamedTuple):
    t: torch.Tensor  # [R] f32 (F32_MAX when no hit)
    tri: torch.Tensor  # [R] i32 triangle slot (-1 when no hit)
    valid: torch.Tensor  # [R] bool


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def moller_trumbore(ro, rd, p0, e1, e2, tmin, tmax):
    """Batched Möller–Trumbore. ro/rd broadcast against p0/e1/e2;
    returns (t, u, v, hit_mask)."""
    pvec = _cross(rd, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / det
    tvec = ro - p0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(rd, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (
        (det != 0.0)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin)
        & (t <= tmax)
    )
    return t, u, v, hit


def barycentrics(ro, rd, geo_rows):
    """(u, v) of each ray's winning triangle, recomputed from the gathered
    per-hit rows (world p0/e1/e2 in columns 0:9). Bit-identical to the
    sweep's internal values."""
    p0 = geo_rows[:, 0:3]
    e1 = geo_rows[:, 3:6]
    e2 = geo_rows[:, 6:9]
    pvec = _cross(rd, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / det
    tvec = ro - p0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(rd, qvec) * inv_det
    return u, v


def _tmax_col(tmax, ro):
    if isinstance(tmax, torch.Tensor) and tmax.dim() == 1:
        return tmax[:, None]
    return torch.as_tensor(tmax, dtype=torch.float32, device=ro.device)


def intersect_bruteforce(ro, rd, tri_p0, tri_e1, tri_e2, tmin, tmax,
                         chunk: int = 512) -> Hit:
    """Closest hit over all triangles. ro/rd: [R,3]; tmax scalar or [R].
    Ties break to the lowest slot (first argmin in a chunk, strict ``<``
    across chunks)."""
    n = tri_p0.shape[0]
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError("triangle array must pad to a chunk multiple")
    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]
    tmax_b = _tmax_col(tmax, ro)
    r = ro.shape[0]
    best_t = torch.full((r,), F32_MAX, dtype=torch.float32, device=ro.device)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=ro.device)
    for base in range(0, n, chunk):
        t, _, _, hit = moller_trumbore(
            ro_b, rd_b, tri_p0[base:base + chunk], tri_e1[base:base + chunk],
            tri_e2[base:base + chunk], tmin, tmax_b,
        )
        t = torch.where(hit, t, F32_MAX)
        ct = t.amin(dim=1)
        k = torch.argmin(t, dim=1)  # first minimum: the lowest slot
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_tri = torch.where(better, (base + k).to(torch.int32), best_tri)
    return Hit(t=best_t, tri=best_tri, valid=best_tri >= 0)


def intersect_any_bruteforce(ro, rd, tri_p0, tri_e1, tri_e2, tmin, tmax,
                             chunk: int = 512) -> torch.Tensor:
    """Any-hit (shadow) query: bool [R]. tmax may be per-ray [R]."""
    n = tri_p0.shape[0]
    chunk = min(chunk, n)
    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]
    tmax_b = _tmax_col(tmax, ro)
    blocked = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for base in range(0, n, chunk):
        _, _, _, hit = moller_trumbore(
            ro_b, rd_b, tri_p0[base:base + chunk], tri_e1[base:base + chunk],
            tri_e2[base:base + chunk], tmin, tmax_b,
        )
        blocked = blocked | hit.any(dim=1)
    return blocked
