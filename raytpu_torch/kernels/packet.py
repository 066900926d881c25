"""BVH8 ray queries of the packet route: the CUDA kernel, its plain torch
version, and the engine's intersector factory.

Replaces ``raytpu/kernels/intersect_pallas.py:_packet_kernel`` /
``_one_packet`` (entry ``packet_query``, factory
``make_packet_intersectors``) in its closest-hit and any-hit forms. The
TPU kernel walks one shared stack per 4096-ray packet; this port keeps the
contract and gives every ray its own stack walk of the 8-wide BVH
(``node8_rows``: child k at columns 16k..16k+6, bmin, bmax, then the link
as int32 bits: a child node, or ``~leaf_row`` for a leaf).

Range contract, per ray (raytpu's ``packet_query``):

* closest-hit treats a finite ``tmax`` as an OPEN bound: the walk's bound
  starts at ``min(F32_MAX, tmax)`` and a hit is accepted iff
  ``t >= tmin and (t < best_t or (t == best_t and slot < best_tri))``, so
  a hit at exactly ``tmax`` is a miss. Ties break to the lowest slot, so
  the visit order never changes a result;
* any-hit uses the closed range ``[tmin, tmax]`` and stops at the first
  blocker. Only ``tri >= 0`` (blocked) is contract; ``t`` returns tmax;
* dead lanes (``tmax = -inf``) return ``t = -inf, tri = -1`` for
  closest-hit and are never blocked.

The walk, shared bit for bit by the kernel and the plain version: pop a
node; for each child k in storage order, slab-test its box (safe inverse
direction, zero components -> +/-1e-36; ``near = max(max(lox, loy),
max(loz, tmin))``, ``far = min(min(hix, hiy), min(hiz, LIMIT))``, hit iff
``near <= far``; LIMIT is best_t for closest-hit and tmax for any-hit),
push a hit interior child at once, and test a hit leaf's 8 triangles at
once. The slab does not order-normalise its intervals, so the BVH builder's
empty slots (inverted boxes) miss every ray. Pushes clamp at
``STACK_DEPTH - 1`` as raytpu's do; the pack's depth check keeps a real
tree below that bound, and pops stop after as many nodes as the tree has.

``packet_query_cuda`` launches ``csrc/packet_walk.cu``;
``packet_query_torch`` is the plain version (a vectorised per-ray walk in
torch ops, the same arithmetic in the same order). ``packet_query``
dispatches on the tensors' device alone.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import F32_MAX, Hit, moller_trumbore
from .strand import (
    ANY_TMIN,
    CLOSEST_TMIN,
    _check_baked_tmin,
    _check_inputs,
    _per_ray,
    _safe_inv,
)

# per-ray stack slots: <= 8 pushes per BVH8 level, so a depth-d tree needs
# 8*d + 1; scene/pack.py rejects trees with 8*d + 8 > STACK_DEPTH
STACK_DEPTH = 512
_PLAIN_STACK0 = 64  # the plain version's first stack width; it grows


def packet_query_torch(node8_rows, leaf_tris, ro, rd, tmax, tmin: float,
                       any_hit: bool):
    """Plain torch version of the BVH8 stack walk. ro/rd [R,3], tmax [R];
    returns (t [R] f32, tri [R] i32). Each loop iteration pops one node for
    every unfinished ray; finished rays leave the working set. The stack is
    a [W, width] tensor whose width grows to STACK_DEPTH as pushes need."""
    dev = ro.device
    r = ro.shape[0]
    n_nodes = node8_rows.shape[0]
    n_leaf_rows = leaf_tris.shape[0]
    kids = node8_rows.reshape(n_nodes, 8, 16)
    boxes = kids[:, :, 0:6]
    links = kids[:, :, 6].contiguous().view(torch.int32)  # [N8, 8]
    tris = leaf_tris.reshape(-1, 8, 10)
    tmax = tmax.to(torch.float32)
    t_out = torch.empty(r, dtype=torch.float32, device=dev)
    tri_out = torch.empty(r, dtype=torch.int32, device=dev)
    inv = _safe_inv(rd)
    best_t = tmax.clone() if any_hit else torch.minimum(
        torch.full_like(tmax, F32_MAX), tmax
    )
    stack = torch.zeros((r, _PLAIN_STACK0), dtype=torch.int32, device=dev)
    # the working set: one entry per unfinished ray; the root is on every
    # stack (column 0 holds 0)
    s = dict(
        idx=torch.arange(r, device=dev), o=ro, d=rd, inv=inv, neg=inv < 0.0,
        tm=tmax, bt=best_t,
        btri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        sp=torch.ones(r, dtype=torch.long, device=dev), stack=stack,
    )
    k8 = torch.arange(8, device=dev, dtype=torch.int32)
    for _ in range(n_nodes):
        w = s["idx"].numel()
        if w == 0:
            break
        width = s["stack"].shape[1]
        need = int(s["sp"].max()) + 8
        if need > width and width < STACK_DEPTH:
            grown = min(STACK_DEPTH, max(2 * width, need))
            s["stack"] = torch.cat([s["stack"], s["stack"].new_zeros(
                (w, grown - width))], dim=1)
        lane = torch.arange(w, device=dev)
        s["sp"] = s["sp"] - 1
        node = s["stack"][lane, s["sp"]].long()
        kb = boxes[node]  # [W, 8, 6]
        kl = links[node]  # [W, 8]
        walking = torch.ones(w, dtype=torch.bool, device=dev)
        for k in range(8):
            bmin, bmax, link = kb[:, k, 0:3], kb[:, k, 3:6], kl[:, k]
            lo = (torch.where(s["neg"], bmax, bmin) - s["o"]) * s["inv"]
            hi = (torch.where(s["neg"], bmin, bmax) - s["o"]) * s["inv"]
            limit = s["tm"] if any_hit else s["bt"]
            near = torch.maximum(
                torch.maximum(lo[:, 0], lo[:, 1]),
                torch.maximum(lo[:, 2], torch.full_like(lo[:, 2], tmin)),
            )
            far = torch.minimum(
                torch.minimum(hi[:, 0], hi[:, 1]), torch.minimum(hi[:, 2], limit)
            )
            hit = (near <= far) & walking
            push = hit & (link >= 0) & (link < n_nodes)
            if bool(push.any()):
                slot = torch.clamp(s["sp"], max=STACK_DEPTH - 1)
                s["stack"][lane[push], slot[push]] = link[push]
                s["sp"] = torch.clamp(s["sp"] + push.long(),
                                      max=STACK_DEPTH - 1)
            at_leaf = hit & (link < 0) & (~link < n_leaf_rows)
            if not bool(at_leaf.any()):
                continue
            li = at_leaf.nonzero().squeeze(1)
            lr = ~link[li]
            tri = tris[lr.long()]  # [L, 8, 10]
            lim = (s["tm"] if any_hit else s["bt"])[li][:, None]
            t, _, _, ok = moller_trumbore(
                s["o"][li][:, None, :], s["d"][li][:, None, :],
                tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9], tmin, lim,
            )
            slots = lr[:, None] * 8 + k8  # [L, 8]
            found = ok.any(dim=1)
            if any_hit:
                # the first accepted triangle blocks and ends the walk
                first = ok.to(torch.int32).argmax(dim=1)
                s["btri"][li] = torch.where(
                    found, slots.gather(1, first[:, None])[:, 0],
                    s["btri"][li],
                )
                walking[li] = ~found
            else:
                # the kernel's in-order accept rule keeps the smallest
                # (t, slot) pair: the leaf's lowest t, lowest slot on ties
                tc = torch.where(ok, t, torch.inf)
                mt = tc.amin(dim=1)
                ms = slots.gather(1, tc.argmin(dim=1)[:, None])[:, 0]
                bt, bi = s["bt"][li], s["btri"][li]
                acc = found & ((mt < bt) | ((mt == bt) & (ms < bi)))
                s["bt"][li] = torch.where(acc, mt, bt)
                s["btri"][li] = torch.where(acc, ms, bi)
        done = (s["sp"] == 0) | ~walking
        if bool(done.any()):
            t_out[s["idx"][done]] = s["bt"][done]
            tri_out[s["idx"][done]] = s["btri"][done]
            keep = ~done
            s = {key: val[keep] for key, val in s.items()}
    # walks cut by the pop bound (never for a tree) keep their best
    t_out[s["idx"]] = s["bt"]
    tri_out[s["idx"]] = s["btri"]
    return t_out, tri_out


_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("packet_walk")
        lib.packet_walk_launch.restype = ctypes.c_int
        lib.packet_walk_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.packet_walk_error_string.restype = ctypes.c_char_p
        lib.packet_walk_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def packet_query_cuda(node8_rows, leaf_tris, ro, rd, tmax, tmin: float,
                      any_hit: bool):
    """Launch ``csrc/packet_walk.cu`` on the current stream (one thread per
    ray, blocks of 128). Same signature and results as
    ``packet_query_torch``; raises on bad inputs or a failed launch.
    ``packet_query_cuda.launches`` counts the launches."""
    if ro.device.type != "cuda":
        raise ValueError(f"packet_query_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    _check_inputs("node8_rows", node8_rows, leaf_tris, ro, rd, tmax)
    if node8_rows.shape[0] == 0:
        raise ValueError("node8_rows: want at least the root node")
    lib = _library()
    r = ro.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    tri = torch.empty(r, dtype=torch.int32, device=ro.device)
    if r == 0:
        return t, tri
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.packet_walk_launch(
            node8_rows.data_ptr(), leaf_tris.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), tmax.data_ptr(), t.data_ptr(), tri.data_ptr(),
            r, node8_rows.shape[0], leaf_tris.shape[0], float(tmin),
            int(any_hit), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "packet_walk launch failed: "
            + lib.packet_walk_error_string(rc).decode()
        )
    packet_query_cuda.launches += 1
    return t, tri


packet_query_cuda.launches = 0


def packet_query(node8_rows, leaf_tris, ro, rd, tmax, tmin: float,
                 any_hit: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if ro.device.type == "cuda":
        return packet_query_cuda(node8_rows, leaf_tris, ro, rd, tmax, tmin,
                                 any_hit)
    return packet_query_torch(node8_rows, leaf_tris, ro, rd, tmax, tmin,
                              any_hit)


def make_packet_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature over ``pack.bvh.node8_rows``. tmin is baked: 0.001 for
    closest-hit and 0.0 for any-hit; another value raises."""
    node8 = pack.bvh.node8_rows.contiguous()
    leaves = pack.bvh.leaf_tris.contiguous()

    def closest(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, CLOSEST_TMIN, "packet closest")
        t, tri = packet_query(node8, leaves, ro.contiguous(), rd.contiguous(),
                              _per_ray(tmax, ro), CLOSEST_TMIN, False)
        return Hit(t=t, tri=tri, valid=tri >= 0)

    def any_fn(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, ANY_TMIN, "packet any-hit")
        _, tri = packet_query(node8, leaves, ro.contiguous(), rd.contiguous(),
                              _per_ray(tmax, ro), ANY_TMIN, True)
        return tri >= 0

    return closest, any_fn
