"""Ray-triangle intersection: Möller–Trumbore, the brute-force sweep and
the threaded-BVH walk.

Torch counterpart of ``raytpu.kernels.intersect`` (``Hit``,
``moller_trumbore``, ``barycentrics``, ``intersect_bruteforce``,
``intersect_any_bruteforce``, ``intersect_bvh``, ``make_intersectors``).
The sweep is the ``brute`` route and the oracle the walk kernels are
tested against; ``intersect_bvh`` is the ``bvh`` route. raytpu computes
both in XLA, not in a Pallas kernel, so these plain torch ops are the
port itself: no hand-written kernel stands behind them.

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

from ..accel.bvh import LEAF_SIZE

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


def _slab_test(bmin, bmax, ro, inv_d, tmin, tmax):
    """Ray-AABB slab test, raytpu's unrepaired form (``near <= far``).
    Callers pre-clamp zero direction components (``safe_inv_dir``) so
    0 * inf NaNs cannot appear."""
    t0 = (bmin - ro) * inv_d
    t1 = (bmax - ro) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    near = torch.maximum(lo.amax(dim=-1), tmin)
    far = torch.minimum(hi.amin(dim=-1), tmax)
    return near <= far


def safe_inv_dir(rd):
    """1/direction with exactly-zero components clamped to +/-1e-36: keeps
    slab intervals NaN-free with unchanged accept/reject for tmin >= 0."""
    tiny = float(np.float32(1e-36))
    safe = torch.where(rd == 0.0,
                       torch.where(1.0 / rd < 0.0, -tiny, tiny), rd)
    return 1.0 / safe


def intersect_bvh(ro, rd, bvh, tmin, tmax, leaf_size: int = LEAF_SIZE,
                  any_hit: bool = False):
    """Stackless threaded-BVH walk over the fused node rows
    (``bvh.nodes`` [N, 8]: bmin, bmax, then the miss link and the leaf row
    as int32 bits) and leaf rows (``bvh.leaf_tris`` [Nl, 10 * leaf_size]).

    All rays advance in lockstep through their own node pointers; finished
    rays park at ptr = -1, and the loop runs while any pointer is live
    (one host sync per step, raytpu's ``lax.while_loop``). ``tmax`` may be
    per-ray. Returns Hit (closest) or bool blocked (any_hit).

    This route keeps raytpu's contract, not the repaired walks': ties keep
    the first slot visited (``ct < best_t`` across leaves, the first
    minimum within one), the box test is the unrepaired ``near <= far``,
    and the slot is the raw ``leaf_row * leaf_size + k`` with no tie key."""
    r = ro.shape[0]
    dev = ro.device
    tmax_r = torch.as_tensor(tmax, dtype=torch.float32,
                             device=dev).expand(r)
    tmin_t = torch.as_tensor(tmin, dtype=torch.float32, device=dev)
    inv_d = safe_inv_dir(rd)
    nodes = bvh.nodes
    links = nodes[:, 6:8].contiguous().view(torch.int32)  # miss, leaf row
    leaf_tris = bvh.leaf_tris
    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]

    ptr = torch.zeros(r, dtype=torch.int32, device=dev)
    best_t = torch.full((r,), F32_MAX, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    while bool((ptr >= 0).any()):
        active = ptr >= 0
        idx = torch.clamp(ptr, min=0).long()
        node = nodes[idx]  # one fused row gather [R, 8]
        miss = links[idx, 0]
        leaf_row = links[idx, 1]
        is_leaf = leaf_row >= 0
        limit = torch.minimum(best_t, tmax_r)
        hit_box = _slab_test(node[:, 0:3], node[:, 3:6], ro, inv_d, tmin_t,
                             limit)

        test_leaf = active & is_leaf & hit_box
        lrow = leaf_tris[torch.where(test_leaf, leaf_row, 0).long()]
        tris = lrow.reshape(r, leaf_size, 10)
        t, _, _, hit = moller_trumbore(
            ro_b, rd_b, tris[:, :, 0:3], tris[:, :, 3:6], tris[:, :, 6:9],
            tmin, limit[:, None],
        )
        hit = hit & test_leaf[:, None]
        t = torch.where(hit, t, F32_MAX)
        k = torch.argmin(t, dim=1).to(torch.int32)  # the first minimum
        ct = t.amin(dim=1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_tri = torch.where(better, leaf_row * leaf_size + k, best_tri)

        descend = hit_box & ~is_leaf
        nxt = torch.where(descend, idx.to(torch.int32) + 1, miss)
        if any_hit:
            nxt = torch.where(best_t < F32_MAX, -1, nxt)
        ptr = torch.where(active, nxt, -1)
    if any_hit:
        return best_tri >= 0
    return Hit(t=best_t, tri=best_tri, valid=best_tri >= 0)


def make_intersectors(pack, bruteforce_max_tris: int = 2048,
                      chunk: int = 512, which: str = "auto"):
    """(closest_fn, any_fn) with signatures (ro, rd, tmin, tmax): the
    brute sweep for ``which="brute"`` or, under "auto", for scenes of at
    most ``bruteforce_max_tris`` slots; the threaded-BVH walk otherwise.
    The walk needs ``pack.bvh.leaf_tris``, which a stream pack without a
    strand tree drops: it raises raytpu's ValueError then."""
    n = pack.tri_p0.shape[0]
    use_brute = which == "brute" or (which == "auto"
                                     and n <= bruteforce_max_tris)
    if use_brute:
        def closest(ro, rd, tmin, tmax):
            return intersect_bruteforce(ro, rd, pack.tri_p0, pack.tri_e1,
                                        pack.tri_e2, tmin, tmax, chunk=chunk)

        def any_hit(ro, rd, tmin, tmax):
            return intersect_any_bruteforce(ro, rd, pack.tri_p0, pack.tri_e1,
                                            pack.tri_e2, tmin, tmax,
                                            chunk=chunk)
    else:
        if pack.bvh.leaf_tris is None:
            raise ValueError(
                "scene was packed with tables='stream' (beyond-VMEM "
                "binned route only); repack with tables='all' for the "
                "threaded-BVH/brute intersectors"
            )

        def closest(ro, rd, tmin, tmax):
            return intersect_bvh(ro, rd, pack.bvh, tmin, tmax)

        def any_hit(ro, rd, tmin, tmax):
            return intersect_bvh(ro, rd, pack.bvh, tmin, tmax, any_hit=True)

    return closest, any_hit
