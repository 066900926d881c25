"""Strand-tree ray queries: the CUDA kernel, its plain torch version, and
the engine's intersector factory.

Replaces ``raytpu/kernels/strand_persistent.py:strand_query_persistent``
with its factory ``raytpu/kernels/strand.py:make_strand_intersectors``
(closest-hit and any-hit forms). The contract, per ray:

* walk the octant-threaded tree (accel/strandtree.py) along the ray's own
  direction octant ``(dx<0) + 2(dy<0) + 4(dz<0)``; hit boxes descend,
  leaves test their 8 triangles and continue at the miss link;
* slab test with the safe inverse direction (zero components -> +/-1e-36),
  ``near = max(max(lox, loy), max(loz, tmin))``,
  ``far = min(min(hix, hiy), min(hiz, LIMIT))``, hit iff ``near <= far``;
* closest-hit: ``LIMIT = best_t``, starting at ``min(F32_MAX, tmax)``;
  accept ``t >= tmin and (t < best_t or (t == best_t and slot < best))``
  — ties break to the lowest slot, so visit order never changes a result;
  a dead lane (tmax = -inf) returns ``t = -inf, tri = -1``;
* any-hit: ``LIMIT = tmax``; accept ``t >= tmin and t <= tmax``, then
  stop. Only ``tri >= 0`` (blocked) is contract; ``t`` returns tmax.

``strand_query_cuda`` launches ``csrc/strand_walk.cu``;
``strand_query_torch`` is the plain version (a vectorised per-ray walk in
torch ops, the same arithmetic in the same order). ``strand_query``
dispatches on the tensors' device alone: CUDA tensors go to the kernel,
CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import F32_MAX, Hit, moller_trumbore

TINY = 1e-36
CLOSEST_TMIN = 0.001  # src/shader.wgsl:312-319
ANY_TMIN = 0.0  # shadow rays start at t = 0 (src/shader.wgsl:174-186)


def _safe_inv(rd: torch.Tensor) -> torch.Tensor:
    safe = torch.where(
        rd == 0.0, torch.where(1.0 / rd < 0.0, -TINY, TINY), rd
    )
    return 1.0 / safe


def strand_query_torch(strand_rows, leaf_tris, ro, rd, tmax, tmin: float,
                       any_hit: bool):
    """Plain torch version of the strand walk. ro/rd [R,3], tmax [R];
    returns (t [R] f32, tri [R] i32). Each loop iteration advances every
    unfinished ray by one node; finished rays leave the working set."""
    dev = ro.device
    r = ro.shape[0]
    recs = strand_rows.reshape(-1, 8)  # node c, octant o at record 8c + o
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = strand_rows.shape[0] * 2
    tmax = tmax.to(torch.float32)
    t_out = torch.empty(r, dtype=torch.float32, device=dev)
    tri_out = torch.empty(r, dtype=torch.int32, device=dev)
    inv = _safe_inv(rd)
    octant = ((rd[:, 0] < 0).long() + 2 * (rd[:, 1] < 0).long()
              + 4 * (rd[:, 2] < 0).long())
    best_t = tmax.clone() if any_hit else torch.minimum(
        torch.full_like(tmax, F32_MAX), tmax
    )
    # the working set: one entry per unfinished ray
    s = dict(
        idx=torch.arange(r, device=dev), o=ro, d=rd, inv=inv, neg=inv < 0.0,
        oct=octant, tm=tmax, bt=best_t,
        btri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        cur=torch.zeros(r, dtype=torch.long, device=dev),
    )
    k8 = torch.arange(8, device=dev, dtype=torch.int32)
    for _ in range(n_nodes):
        if s["idx"].numel() == 0:
            break
        rec = recs[s["cur"] * 8 + s["oct"]]
        lo = (torch.where(s["neg"], rec[:, 3:6], rec[:, 0:3]) - s["o"]) * s["inv"]
        hi = (torch.where(s["neg"], rec[:, 0:3], rec[:, 3:6]) - s["o"]) * s["inv"]
        limit = s["tm"] if any_hit else s["bt"]
        near = torch.maximum(
            torch.maximum(lo[:, 0], lo[:, 1]),
            torch.maximum(lo[:, 2], torch.full_like(lo[:, 2], tmin)),
        )
        far = torch.minimum(
            torch.minimum(hi[:, 0], hi[:, 1]), torch.minimum(hi[:, 2], limit)
        )
        box = near <= far
        hit_link = rec[:, 6].long()
        nxt = torch.where(box & (hit_link >= 0), hit_link, rec[:, 7].long())
        at_leaf = box & (hit_link < 0)
        if bool(at_leaf.any()):
            li = at_leaf.nonzero().squeeze(1)
            lr = (~hit_link[li]).to(torch.int32)
            tri = tris[lr.long()]  # [L, 8, 10]
            lim = (s["tm"] if any_hit else s["bt"])[li][:, None]
            t, _, _, ok = moller_trumbore(
                s["o"][li][:, None, :], s["d"][li][:, None, :],
                tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9], tmin, lim,
            )
            slot = lr[:, None] * 8 + k8  # [L, 8]
            found = ok.any(dim=1)
            if any_hit:
                # the first accepted triangle blocks and ends the walk
                k = ok.to(torch.int32).argmax(dim=1)
                s["btri"][li] = torch.where(
                    found, slot.gather(1, k[:, None])[:, 0], s["btri"][li]
                )
                nxt[li] = torch.where(found, -1, nxt[li])
            else:
                # the kernel's in-order accept rule keeps the smallest
                # (t, slot) pair: the leaf's lowest t, lowest slot on ties
                tc = torch.where(ok, t, torch.inf)
                mt = tc.amin(dim=1)
                ms = slot.gather(1, tc.argmin(dim=1)[:, None])[:, 0]
                bt, bi = s["bt"][li], s["btri"][li]
                acc = found & ((mt < bt) | ((mt == bt) & (ms < bi)))
                s["bt"][li] = torch.where(acc, mt, bt)
                s["btri"][li] = torch.where(acc, ms, bi)
        s["cur"] = nxt
        done = nxt < 0
        if bool(done.any()):
            t_out[s["idx"][done]] = s["bt"][done]
            tri_out[s["idx"][done]] = s["btri"][done]
            keep = ~done
            s = {key: val[keep] for key, val in s.items()}
    # walks cut by the step bound (never for a valid tree) keep their best
    t_out[s["idx"]] = s["bt"]
    tri_out[s["idx"]] = s["btri"]
    return t_out, tri_out


def _check_inputs(tree_name, tree, leaf_tris, ro, rd, tmax):
    """Raise ValueError unless the tree [N, 128], leaf rows [Nl, 80], rays
    [R, 3] and tmax [R] are contiguous float32 tensors on one device."""
    dev = ro.device
    for name, x, width in ((tree_name, tree, 128),
                           ("leaf_tris", leaf_tris, 80), ("ro", ro, 3),
                           ("rd", rd, 3)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: want float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if x.dim() != 2 or x.shape[1] != width or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous [N, {width}] "
                             f"tensor, got {tuple(x.shape)}")
    if (tmax.dtype != torch.float32 or tmax.device != dev
            or tmax.shape != (ro.shape[0],) or not tmax.is_contiguous()):
        raise ValueError(f"tmax: want a contiguous float32 [{ro.shape[0]}] "
                         f"tensor on {dev}")
    if rd.shape[0] != ro.shape[0]:
        raise ValueError("ro and rd differ in length")


_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("strand_walk")
        lib.strand_walk_launch.restype = ctypes.c_int
        lib.strand_walk_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.strand_walk_error_string.restype = ctypes.c_char_p
        lib.strand_walk_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def strand_query_cuda(strand_rows, leaf_tris, ro, rd, tmax, tmin: float,
                      any_hit: bool):
    """Launch ``csrc/strand_walk.cu`` on the current stream (one thread per
    ray, blocks of 128). Same signature and results as
    ``strand_query_torch``; raises on bad inputs or a failed launch.
    ``strand_query_cuda.launches`` counts the launches."""
    if ro.device.type != "cuda":
        raise ValueError(f"strand_query_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    _check_inputs("strand_rows", strand_rows, leaf_tris, ro, rd, tmax)
    lib = _library()
    r = ro.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    tri = torch.empty(r, dtype=torch.int32, device=ro.device)
    if r == 0:
        return t, tri
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.strand_walk_launch(
            strand_rows.data_ptr(), leaf_tris.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), tmax.data_ptr(), t.data_ptr(), tri.data_ptr(),
            r, strand_rows.shape[0] * 2, leaf_tris.shape[0], float(tmin),
            int(any_hit), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "strand_walk launch failed: "
            + lib.strand_walk_error_string(rc).decode()
        )
    strand_query_cuda.launches += 1
    return t, tri


strand_query_cuda.launches = 0


def strand_query(strand_rows, leaf_tris, ro, rd, tmax, tmin: float,
                 any_hit: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if ro.device.type == "cuda":
        return strand_query_cuda(strand_rows, leaf_tris, ro, rd, tmax, tmin,
                                 any_hit)
    return strand_query_torch(strand_rows, leaf_tris, ro, rd, tmax, tmin,
                              any_hit)


def _check_baked_tmin(tmin, baked: float, what: str):
    if float(tmin) != baked:
        raise ValueError(
            f"{what}: tmin is baked at {baked}, the engine passed {tmin}"
        )


def _per_ray(tmax, ro):
    """tmax (a scalar or [R]) as a contiguous float32 [R] on ro's device."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=ro.device)
    return tmax.expand(ro.shape[0]).contiguous()


def make_strand_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature over ``pack.bvh.strand_rows``. tmin is baked: 0.001 for
    closest-hit and 0.0 for any-hit; another value raises. A pack without
    a strand tree (<= 256 slots) raises ValueError."""
    if pack.bvh.strand_rows is None:
        raise ValueError(
            "intersector='strand' needs a strand tree; scenes above "
            "the sort threshold pack one by default"
        )
    tree = pack.bvh.strand_rows.contiguous()
    leaves = pack.bvh.leaf_tris.contiguous()

    def closest(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, CLOSEST_TMIN, "strand closest")
        t, tri = strand_query(tree, leaves, ro.contiguous(), rd.contiguous(),
                              _per_ray(tmax, ro), CLOSEST_TMIN, False)
        return Hit(t=t, tri=tri, valid=tri >= 0)

    def any_fn(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, ANY_TMIN, "strand any-hit")
        _, tri = strand_query(tree, leaves, ro.contiguous(), rd.contiguous(),
                              _per_ray(tmax, ro), ANY_TMIN, True)
        return tri >= 0

    return closest, any_fn
