"""A plain BVH for the reference, so that it can trace whole frames.

The brute-force sweep (``tracer.sweep``) judges a few thousand sampled
pixels; counting the ray queries of a whole 1080p frame needs every path
traced, which a sweep over every triangle cannot do in a run. This BVH
gives the same answers as the sweep, faster:

* build (numpy): median splits on the longest centroid axis, level by
  level over all nodes at once, leaves of at most ``LEAF`` triangles;
  every box padded outward by ``PAD`` of the scene's extent, so that no
  rounding in the box test can drop a triangle the sweep would hit;
* walk (torch): a stack per ray, one node a step for every ray still
  walking; leaves run the sweep's own Moller-Trumbore expressions, and
  ties in t keep the lowest triangle, as the sweep does. The tree counts
  the box tests (one a node a ray pops) and the triangle tests (each
  triangle of a leaf whose box the ray enters) of every walk: the
  operations that the walk kernels' roofline is bound by.

It is the reference's own structure, built from the reference's
triangles: nothing of the program's BVH or tables is read.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 8
PAD = 1e-4
STACK = 64


def build(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> dict:
    """Host arrays of the tree over triangles (p0, e1, e2) [T, 3]:
    ``bmin``/``bmax`` [N, 3] float32 (padded), ``left``/``right`` [N]
    child nodes (-1 at a leaf), ``first``/``count`` [N] the leaf's
    triangles in ``order`` [T] (original triangle indices); node 0 is
    the root."""
    v = np.stack([p0, p0 + e1, p0 + e2]).astype(np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    cen = (lo + hi) / 2
    n = p0.shape[0]
    order = np.arange(n)
    pad = PAD * float(np.max(hi.max(axis=0) - lo.min(axis=0)))
    start, end = np.array([0]), np.array([n])
    left, right = np.array([-1]), np.array([-1])
    todo = np.array([0])  # the nodes of this level
    while True:
        todo = todo[end[todo] - start[todo] > LEAF]
        if not todo.shape[0]:
            break
        s, e = start[todo], end[todo]
        size = e - s
        offs = np.concatenate([[0], np.cumsum(size)[:-1]])
        seg = np.repeat(np.arange(todo.shape[0]), size)
        at = _ranges(s, e)
        tri = order[at]
        c = cen[tri]
        axis = np.argmax(np.maximum.reduceat(c, offs, axis=0)
                         - np.minimum.reduceat(c, offs, axis=0), axis=1)
        key = c[np.arange(c.shape[0]), axis[seg]]
        order[at] = tri[np.lexsort((tri, key, seg))]
        mid = s + size // 2
        k = start.shape[0]
        kids = k + np.arange(2 * todo.shape[0])
        left[todo], right[todo] = kids[0::2], kids[1::2]
        start = np.concatenate([start, np.stack([s, mid], 1).ravel()])
        end = np.concatenate([end, np.stack([mid, e], 1).ravel()])
        left = np.concatenate([left, np.full(kids.shape[0], -1)])
        right = np.concatenate([right, np.full(kids.shape[0], -1)])
        todo = kids
    tri = order[_ranges(start, end)]
    offs = np.concatenate([[0], np.cumsum(end - start)[:-1]])
    bmin = np.minimum.reduceat(lo[tri], offs, axis=0) - pad
    bmax = np.maximum.reduceat(hi[tri], offs, axis=0) + pad
    return {"bmin": bmin.astype(np.float32), "bmax": bmax.astype(np.float32),
            "left": left, "right": right, "first": start,
            "count": np.where(left < 0, end - start, 0), "order": order}


def _ranges(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The concatenation of ``arange(s[i], e[i])``."""
    size = e - s
    out = np.repeat(s - np.concatenate([[0], np.cumsum(size)[:-1]]), size)
    return out + np.arange(int(size.sum()))


class Tree:
    """The tree's tables on a device; ``leaf_tris`` [N, LEAF] holds each
    leaf's triangle indices, -1 padded."""

    def __init__(self, host: dict, device):
        def dev(x, dt=None):
            return torch.as_tensor(np.ascontiguousarray(x), device=device,
                                   dtype=dt)

        self.bmin = dev(host["bmin"])
        self.bmax = dev(host["bmax"])
        self.left = dev(host["left"], torch.int64)
        self.right = dev(host["right"], torch.int64)
        slots = host["first"][:, None] + np.arange(LEAF)[None, :]
        valid = np.arange(LEAF)[None, :] < host["count"][:, None]
        leaf = np.where(valid, host["order"][np.minimum(
            slots, host["order"].shape[0] - 1)], -1)
        self.leaf_tris = dev(leaf, torch.int64)
        self.box_tests = 0
        self.tri_tests = torch.zeros((), dtype=torch.int64, device=device)


def walk(tree: Tree, geo: dict, ro, rd, tmin: float, tmax, any_hit: bool):
    """The sweep's answer for rays ``ro``/``rd`` over [tmin, tmax]: the
    closest (t, triangle, valid) or any-hit flags, found through the
    tree."""
    r = ro.shape[0]
    dev = ro.device
    inv = 1.0 / torch.where(rd == 0.0, torch.full_like(rd, 1e-30), rd)
    best_t = torch.full((r,), float("inf"), device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    sp = (tmax >= tmin).to(torch.int64)  # the root, for rays with a range
    lanes = torch.nonzero(sp > 0).squeeze(1)
    while lanes.numel():
        tree.box_tests += lanes.numel()
        top = sp[lanes] - 1
        node = stack[lanes, top]
        sp[lanes] = top
        o, iv = ro[lanes], inv[lanes]
        t0 = (tree.bmin[node] - o) * iv
        t1 = (tree.bmax[node] - o) * iv
        near = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=tmin)
        far = torch.minimum(torch.maximum(t0, t1).amin(dim=1),
                            torch.minimum(tmax[lanes], best_t[lanes]))
        hit = near <= far
        inner = hit & (tree.left[node] >= 0)
        at = lanes[inner]
        s = sp[at]
        if s.numel() and int(s.max()) + 2 > STACK:
            raise RuntimeError("the reference BVH is deeper than its stack")
        stack[at, s] = tree.right[node[inner]]
        stack[at, s + 1] = tree.left[node[inner]]
        sp[at] = s + 2
        leaf = hit & (tree.left[node] < 0)
        at = lanes[leaf]
        if at.numel():
            tris = tree.leaf_tris[node[leaf]]  # [n, LEAF]
            tree.tri_tests += (tris >= 0).sum()
            t = _mt(geo, ro[at], rd[at], tris, tmin, tmax[at])
            if any_hit:
                blocked[at] |= torch.isfinite(t).any(dim=1)
                sp[at] = torch.where(blocked[at], 0, sp[at])
            else:
                # the lowest triangle among equal t, as the sweep keeps
                key = torch.where(torch.isfinite(t), tris, 1 << 62)
                ct = t.amin(dim=1)
                ci = torch.where(t == ct[:, None], key, 1 << 62).amin(dim=1)
                bt, bi = best_t[at], best_i[at]
                better = (ct < bt) | ((ct == bt) & torch.isfinite(ct)
                                      & (ci < bi))
                best_t[at] = torch.where(better, ct, bt)
                best_i[at] = torch.where(better, ci, bi)
        lanes = lanes[sp[lanes] > 0]
    if any_hit:
        return blocked
    return best_t, best_i, best_i >= 0


def _mt(geo, ro, rd, tris, tmin, tmax):
    """t [n, LEAF] of the sweep's expressions for each ray against its
    leaf's triangles; inf where there is no hit (or no triangle)."""
    i = torch.clamp(tris, min=0)
    g = {k: v[i] for k, v in geo.items()}
    o = [ro[:, k:k + 1] for k in range(3)]
    d = [rd[:, k:k + 1] for k in range(3)]
    e1 = [g["e10"], g["e11"], g["e12"]]
    e2 = [g["e20"], g["e21"], g["e22"]]
    pv = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0]]
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    inv_det = 1.0 / det
    tv = [o[0] - g["p00"], o[1] - g["p01"], o[2] - g["p02"]]
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det
    qv = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0]]
    v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
    hit = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tmin) & (t <= tmax[:, None]) & (tris >= 0))
    return torch.where(hit, t, float("inf"))
