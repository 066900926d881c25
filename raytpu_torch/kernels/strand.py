"""Strand-tree ray queries: the CUDA kernels, their plain torch versions,
and the engine's intersector factory.

Replaces ``raytpu/kernels/strand_persistent.py:strand_query_persistent``
with its factories ``raytpu/kernels/strand.py:make_strand_intersectors``
(closest-hit and any-hit forms) and ``make_strand_mixed_query`` (the
mixed form, below). The contract, per ray:

* walk the octant-threaded tree (accel/strandtree.py) along the ray's own
  direction octant ``(dx<0) + 2(dy<0) + 4(dz<0)``; hit boxes descend,
  leaves test their 8 triangles and continue at the miss link;
* slab test with the safe inverse direction (zero components -> +/-1e-36),
  ``near = max(max(lox, loy), max(loz, tmin))``,
  ``far = min(min(hix, hiy), min(hiz, LIMIT))``, hit iff
  ``near <= far * FAR_SCALE`` (the conservative test, below);
* closest-hit: ``LIMIT = best_t``, starting at ``min(F32_MAX, tmax)``;
  accept ``t >= tmin and (t < best_t or (t == best_t and key < best
  key))``, where a slot's key is ``first[slot]``, the lowest slot holding
  the same 9 floats (``first_slots``): ties break to the lowest slot of
  any copy, so visit order never changes a result; a dead lane (tmax =
  -inf) returns ``t = -inf, tri = -1``;
* any-hit: ``LIMIT = tmax``; accept ``t >= tmin and t <= tmax``, then
  stop. Only ``tri >= 0`` (blocked) is contract; ``t`` returns tmax.

The contract the walks are held to is the brute sweep
(kernels/intersect.py): the same original triangle, and the same t. Two
repairs make a per-ray walk meet it (ROADMAP fault 3.4, found on the
1080p gallery frame):

* a slab test that misses by rounding loses the triangle inside a box:
  a hit that Moller-Trumbore accepts on a shared grid edge lies an ulp or
  two outside its flat floor box. ``FAR_SCALE = 1 + 2 gamma_3`` widens
  every box test, LIMIT included, by more than the slab arithmetic's own
  rounding (Ize, "Robust BVH Ray Traversal", JCGT 2(2), 2013);
* spatial splits store one triangle in several leaves. Where two
  triangles tie in t (a box standing on the floor: its bottom face and
  the floor are coplanar), the sweep keeps the lowest slot of all copies,
  while a walk sees only the copies in the leaves it visits. Comparing
  ``first[slot]`` instead of the slot gives every copy the key the sweep
  gives the triangle.

Neither repair can change a result that was already right. A wider box
only adds box and leaf tests, and every triangle is still tested
exactly, so the walk's best (t, key) is a minimum over a superset of the
triangles it tested before: the sweep's winner, if it was tested before,
is still the minimum. The key orders copies of one triangle (identical
data, so identical t) as one, and leaves every other comparison as it
was whenever no copy was involved.

Every walk of the port (the strand walks here, the packet walk in
kernels/packet.py, the treelet walk in kernels/binned.py) takes the tie
keys as its third argument, ``first`` (int32 [Nl * 8]): ``pack_scene``
computes them once per pack (``ScenePack.bvh.first_slots``), and a tree
built by hand gets them from ``first_slots(leaf_tris)``.

``strand_query_cuda`` launches ``csrc/strand_walk.cu``;
``strand_query_torch`` is the plain version (a vectorised per-ray walk in
torch ops, the same arithmetic in the same order). ``strand_query``
dispatches on the tensors' device alone: CUDA tensors go to the kernel,
CPU tensors to the plain version.

The mixed form (raytpu's ``mixed=True``, ``strand_mixed_query_cuda`` /
``_torch`` / ``strand_mixed_query``) walks a bounce's continuation rays
and the previous bounce's deferred shadow rays in one launch: ``smask ==
1`` flags a shadow lane, any-hit over [shadow_tmin, tmax] with LIMIT =
tmax; every other lane is closest-hit over [tmin, tmax) as above; every
lane's slab test uses ``min(tmin, shadow_tmin)``. A closest lane's
result equals the closest-hit form's and a shadow lane's blocked bit the
any-hit form's: a lower slab tmin only adds box tests.

Every per-ray form takes two options of raytpu's persistent kernel,
neither of which changes a result:

* ``rpo`` (raytpu's ``ribbon_rpo``): 0 walks the strand layout
  (``BvhPack.strand_rows``); ``rpo > 0`` walks the ribbon layout
  (``BvhPack.ribbon_rows``, ``accel/strandtree.py:RibbonTree``) with that
  many 16-node rows per octant: octant o's node j is record ``o * rpo *
  16 + j`` of the rows cut into 8-float records. The ribbon is the same
  threading with renumbered nodes, so every lane visits the same boxes
  and leaves in the same order and ``t`` and ``tri`` are bit-equal to the
  strand layout's. ``ribbon_k`` (1..8, raytpu's sub-steps per fetched
  row) is checked and passed to the kernel, which loads one 32-byte record
  per step whatever its value: it changes no result and, so far, no code
  path on the card. The factories read ``RAYTPU_RIBBON`` = K once, as
  raytpu's do.
* ``stats=True`` also returns int32 [8] counters in raytpu's order
  (``strand_query_persistent(stats=True)``: iterations, flushes, services,
  installs, leaf pops, enqueues, 0, 0), with the per-ray walk's meanings:
  [0] node records loaded, summed over rays; [1] 0 (no leaf queue: a lane
  tests a leaf when it reaches it); [2] 0 (no walker pool to refill: the
  launch grid schedules the warps); [3] ``ceil(R / 128)``, raytpu's count
  of 128-ray strands, each installed once; [4] leaf rows tested and [5]
  leaf rows reached, each summed over rays (equal here). A dead lane (tmax
  = -inf) loads the root record and stops. Each counter is an int32 sum
  that wraps past 2^31 - 1 (a 1080p wave loads about 10^8 records); the
  kernel adds one warp's sum with one atomic, and integer sums do not
  depend on order, so the plain version reproduces them bit for bit.

The block-scheduled walk replaces ``raytpu/kernels/strand.py:
_strand_kernel`` (entry ``strand_query``), which raytpu runs with
``RAYTPU_STRAND_PERSISTENT=0``: a whole strand of consecutive
(coherence-sorted) rays shares one stackless walker, walking the octant
of the strand's lane 0 and descending wherever any lane's box test hits;
at a leaf every lane tests the 8 slots. On the card a strand is a warp of
32 rays (``csrc/strand_block.cu``, ``strand_block_query_cuda``);
``strand_block_query_torch`` is its plain version; with ``with_stats``
both also return each strand's walker steps and leaf visits. Both walks
meet the brute sweep's contract; the block walk tests a superset of each
ray's own leaves, so per ray the two return the same t bits and the same
triangle (possibly another copy of it) and the same blocked bit.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .intersect import F32_MAX, Hit, moller_trumbore

TINY = 1e-36
# the conservative box test: t_far, LIMIT included, is scaled by
# 1 + 2 gamma_3 before the compare, gamma_3 = 3u / (1 - 3u), u = 2^-24;
# rounded to f32 this is 1 + 3 * 2^-23, exact in f32, so the scale is one
# correctly rounded multiply (csrc/strand_common.cuh kFarScale)
FAR_SCALE = 1.0 + 3.0 * 2.0 ** -23
CLOSEST_TMIN = 0.001  # src/shader.wgsl:312-319
ANY_TMIN = 0.0  # shadow rays start at t = 0 (src/shader.wgsl:174-186)
STRAND = 32  # rays per strand of the block walk: one warp
# raytpu's STRAND_VMEM_BUDGET (kernels/strand.py:440): larger tables force
# the persistent walk (_hbm_tables), and the port routes the same way
STRAND_TABLE_BUDGET = 100 * 1024 * 1024
I32_MAX = 2**31 - 1
RIBBON_NODES = 16  # nodes per ribbon row (accel/strandtree.py)
STRAND_RAYS = 128  # rays of one of raytpu's strands (stats[3], installs)


def wrap_i32(x):
    """An integer sum (an int or an int64 tensor) as int32 arithmetic
    leaves it (two's complement)."""
    return (x + 2**31) % 2**32 - 2**31


def _check_layout(rows, rpo: int, ribbon_k: int) -> None:
    """Raise ValueError unless ``rpo`` is 0 (strand rows) or ``rows`` holds
    8 * rpo ribbon rows, with ``1 <= ribbon_k <= 8`` (raytpu's bound)."""
    if rpo < 0:
        raise ValueError(f"rpo={rpo}: want 0 (strand layout) or > 0")
    if rpo and not 1 <= ribbon_k <= 8:
        raise ValueError(f"ribbon_k={ribbon_k}: want 1..8")
    if rpo and rows.shape[0] != 8 * rpo:
        raise ValueError(f"ribbon rows: want 8 * rpo = {8 * rpo} rows, got "
                         f"{rows.shape[0]}")


def _n_nodes(rows, rpo: int) -> int:
    """The walk's node bound: 16 per ribbon row of an octant, else 2 per
    strand row."""
    return rpo * RIBBON_NODES if rpo else rows.shape[0] * 2


def _strand_stats(counts: dict, n_rays: int, device) -> torch.Tensor:
    """The per-ray walk's int32 [8] counters from a plain walk's counts."""
    leaves = counts.get("tris", 0) // 8
    return torch.tensor(
        [wrap_i32(v) for v in (counts.get("boxes", 0), 0, 0,
                               -(-n_rays // STRAND_RAYS), leaves, leaves,
                               0, 0)], dtype=torch.int32, device=device)


def _safe_inv(rd: torch.Tensor) -> torch.Tensor:
    safe = torch.where(
        rd == 0.0, torch.where(1.0 / rd < 0.0, -TINY, TINY), rd
    )
    return 1.0 / safe


def first_slots(rows: torch.Tensor) -> torch.Tensor:
    """int32 [n] on rows' device: for each slot, the lowest slot whose
    triangle has the same 9 floats, bit for bit (p0, e1, e2). ``rows`` is
    one row per slot of at least 9 floats (``ScenePack.tri_row`` [T, 64],
    whose columns 0:9 are the leaf rows' p0/e1/e2), or leaf rows [Nl, 80]
    of 8 slots x 10 floats each; nothing past the 9 floats is read. A
    triangle that spatial splits stored in several leaves, or distinct
    triangles with identical data, get one tie key, as the sweep sees
    them."""
    if rows.shape[-1] == 80:
        rows = rows.reshape(-1, 10)
    rows = rows[:, :9].contiguous().view(torch.int32)
    n = rows.shape[0]
    first = torch.zeros(0, dtype=torch.int32, device=rows.device)
    if n:
        _, group = torch.unique(rows, dim=0, return_inverse=True)
        low = torch.full((n,), n, dtype=torch.int64, device=rows.device)
        low.scatter_reduce_(0, group, torch.arange(n, device=rows.device),
                            "amin")
        first = low[group].to(torch.int32).contiguous()
    return first


def _leaf_closest(ok, t, slot, key):
    """Per row of a leaf's 8 tests ([..., 8]): the kernels' in-order
    accept rule over the leaf alone, as (found, t, slot, key) of its
    smallest (t, key) pair, the lowest k among equal pairs."""
    tc = torch.where(ok, t, torch.inf)
    mt = tc.amin(dim=-1, keepdim=True)
    cand = ok & (tc == mt)
    kc = torch.where(cand, key, I32_MAX)
    mk = kc.amin(dim=-1, keepdim=True)
    k = (cand & (kc == mk)).to(torch.int32).argmax(dim=-1, keepdim=True)
    return (ok.any(dim=-1), mt[..., 0], slot.gather(-1, k)[..., 0],
            mk[..., 0])


def strand_query_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                       tmin: float, any_hit: bool,
                       counts: dict | None = None, *, rpo: int = 0,
                       ribbon_k: int = 4, stats: bool = False):
    """Plain torch version of the strand walk. ``first`` is
    ``first_slots(leaf_tris)``, ro/rd [R,3], tmax [R]; returns (t [R] f32,
    tri [R] i32), and with ``stats`` the int32 [8] counters (module
    docstring). ``rpo > 0`` walks ribbon rows (``strand_rows`` is then
    ``BvhPack.ribbon_rows``; ``ribbon_k`` is checked only). Each loop
    iteration advances every unfinished ray by one node; finished rays
    leave the working set (a dead lane, tmax = -inf, after the root).
    A ``counts`` dict gains the walk's box tests ("boxes"), triangle tests
    ("tris") and the table bytes it reads, each distinct 32-byte node
    record and 320-byte leaf row once ("bytes")."""
    shad = torch.full((ro.shape[0],), any_hit, dtype=torch.bool,
                      device=ro.device)
    return _walk_torch(strand_rows, leaf_tris, first, ro, rd, tmax, shad,
                       tmin, tmin, counts, rpo, ribbon_k, stats)


def strand_mixed_query_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                             smask, tmin: float, shadow_tmin: float,
                             counts: dict | None = None, *, rpo: int = 0,
                             ribbon_k: int = 4, stats: bool = False):
    """Plain torch version of the strand walk's mixed form (raytpu's
    ``strand_query_persistent(..., mixed=True)``): ``smask`` [R] == 1.0
    flags a shadow lane, any-hit over [shadow_tmin, tmax] (its t returns
    tmax); every other lane is closest-hit over [tmin, tmax) with the tie
    keys ``first``. Every lane's slab test uses min(tmin, shadow_tmin).
    Returns (t [R] f32, tri [R] i32); ``counts``, ``rpo``, ``ribbon_k``
    and ``stats`` as in ``strand_query_torch``."""
    return _walk_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                       smask == 1.0, tmin, shadow_tmin, counts, rpo,
                       ribbon_k, stats)


def _walk_torch(rows, leaf_tris, first, ro, rd, tmax, shad, tmin: float,
                shadow_tmin: float, counts: dict | None, rpo: int = 0,
                ribbon_k: int = 4, stats: bool = False):
    """The per-ray walk of every form, per lane: ``shad`` [R] bool lanes
    are any-hit from ``shadow_tmin`` (LIMIT = tmax), the others
    closest-hit from ``tmin`` (LIMIT = best t from min(F32_MAX, tmax));
    the slab test uses min(tmin, shadow_tmin). The closest-hit and any-hit
    forms pass shadow_tmin = tmin. The kernel's arithmetic in its order
    (csrc/strand_common.cuh:walk_kernel), over strand rows (``rpo`` 0) or
    ribbon rows."""
    _check_layout(rows, rpo, ribbon_k)
    # this walk's own counts, added to the caller's dict at the end
    into, counts = counts, ({} if stats or counts is not None else None)
    dev = ro.device
    r = ro.shape[0]
    # strand layout: node c, octant o at record 8c + o; ribbon layout:
    # octant o's node j at record o * rpo * 16 + j
    recs = rows.reshape(-1, 8)
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = _n_nodes(rows, rpo)
    tmax = tmax.to(torch.float32)
    slab_tmin = min(tmin, shadow_tmin)
    inv = _safe_inv(rd)
    octant = ((rd[:, 0] < 0).long() + 2 * (rd[:, 1] < 0).long()
              + 4 * (rd[:, 2] < 0).long())
    # an any-hit lane's best t is its LIMIT, tmax, and never changes
    best_t = torch.where(shad, tmax,
                         torch.minimum(torch.full_like(tmax, F32_MAX), tmax))
    tcut = torch.where(shad, shadow_tmin, tmin).to(torch.float32)
    any_lanes = bool(shad.any())
    closest_lanes = not bool(shad.all())
    t_out = torch.empty(r, dtype=torch.float32, device=dev)
    tri_out = torch.empty(r, dtype=torch.int32, device=dev)
    # the working set: one entry per unfinished ray
    s = dict(
        idx=torch.arange(r, device=dev), o=ro, d=rd, inv=inv, neg=inv < 0.0,
        oct=octant * (rpo * RIBBON_NODES) if rpo else octant, shad=shad,
        tcut=tcut, bt=best_t,
        btri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        bkey=torch.full((r,), -1, dtype=torch.int32, device=dev),
        cur=torch.zeros(r, dtype=torch.long, device=dev),
    )
    k8 = torch.arange(8, device=dev, dtype=torch.int32)
    if counts is not None:
        seen_rec = torch.zeros(recs.shape[0], dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    for _ in range(n_nodes):
        if s["idx"].numel() == 0:
            break
        ri = s["oct"] + s["cur"] if rpo else s["cur"] * 8 + s["oct"]
        if counts is not None:
            counts["boxes"] = counts.get("boxes", 0) + s["idx"].numel()
            seen_rec[ri] = True
        rec = recs[ri]
        lo = (torch.where(s["neg"], rec[:, 3:6], rec[:, 0:3]) - s["o"]) * s["inv"]
        hi = (torch.where(s["neg"], rec[:, 0:3], rec[:, 3:6]) - s["o"]) * s["inv"]
        near = torch.maximum(
            torch.maximum(lo[:, 0], lo[:, 1]),
            torch.maximum(lo[:, 2], torch.full_like(lo[:, 2], slab_tmin)),
        )
        far = torch.minimum(
            torch.minimum(hi[:, 0], hi[:, 1]),
            torch.minimum(hi[:, 2], s["bt"]),
        )
        box = near <= far * FAR_SCALE
        hit_link = rec[:, 6].long()
        nxt = torch.where(box & (hit_link >= 0), hit_link, rec[:, 7].long())
        at_leaf = box & (hit_link < 0)
        if bool(at_leaf.any()):
            li = at_leaf.nonzero().squeeze(1)
            lr = (~hit_link[li]).to(torch.int32)
            if counts is not None:
                counts["tris"] = counts.get("tris", 0) + 8 * li.numel()
                seen_leaf[lr.long()] = True
            tri = tris[lr.long()]  # [L, 8, 10]
            bt, bi, bk = s["bt"][li], s["btri"][li], s["bkey"][li]
            t, _, _, ok = moller_trumbore(
                s["o"][li][:, None, :], s["d"][li][:, None, :],
                tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9],
                s["tcut"][li][:, None], bt[:, None],
            )
            slot = lr[:, None] * 8 + k8  # [L, 8]
            sh = s["shad"][li]
            ti, tk = bi, bk
            if closest_lanes:
                found, mt, ms, mk = _leaf_closest(ok, t, slot,
                                                  first[slot.long()])
                acc = ~sh & found & ((mt < bt) | ((mt == bt) & (mk < bk)))
                s["bt"][li] = torch.where(acc, mt, bt)
                ti = torch.where(acc, ms, bi)
                tk = torch.where(acc, mk, bk)
            if any_lanes:
                # the first accepted triangle blocks and ends the walk
                blocked = sh & ok.any(dim=1)
                k = ok.to(torch.int32).argmax(dim=1)
                ti = torch.where(blocked, slot.gather(1, k[:, None])[:, 0],
                                 ti)
                nxt[li] = torch.where(blocked, -1, nxt[li])
            s["btri"][li] = ti
            s["bkey"][li] = tk
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
    if counts is not None:
        counts["bytes"] = (32 * int(seen_rec.sum())
                           + 320 * int(seen_leaf.sum()))
    if into is not None:
        for key, val in counts.items():
            into[key] = into.get(key, 0) + val
    if stats:
        return t_out, tri_out, _strand_stats(counts, r, dev)
    return t_out, tri_out


def _check_inputs(tree_name, tree, leaf_tris, ro, rd, tmax, first=None):
    """Raise ValueError unless the tree [N, 128], leaf rows [Nl, 80], rays
    [R, 3] and tmax [R] are contiguous float32 tensors on one device (and
    the tie keys, where given, a contiguous int32 [Nl * 8] tensor there)."""
    dev = ro.device
    if first is not None and (
            first.dtype != torch.int32 or first.device != dev
            or first.shape != (leaf_tris.shape[0] * 8,)
            or not first.is_contiguous()):
        raise ValueError(f"first: want a contiguous int32 "
                         f"[{leaf_tris.shape[0] * 8}] tensor on {dev}")
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


_LIBS: dict = {}


def _library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with its launch signatures declared:
    strand_block's (rows, leaves, first, ro, rd, tmax, t, tri, stats,
    n_rays, n_nodes, n_leaf_rows, tmin, any_hit, stream); strand_walk's
    (rows, leaves, first, ro, rd, tmax, t, tri, stats, n_rays, n_nodes,
    n_leaf_rows, rpo, ribbon_k, tmin, any_hit, stream) and its mixed
    launch (rows, leaves, first, ro, rd, tmax, smask, t, tri, stats,
    n_rays, n_nodes, n_leaf_rows, rpo, ribbon_k, tmin, shadow_tmin,
    stream)."""
    from ._build import LOCK, load_library

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with LOCK:
        if name not in _LIBS:
            lib = load_library(name)
            launch = getattr(lib, name + "_launch")
            launch.restype = ctypes.c_int
            if name == "strand_block":
                launch.argtypes = [ptr] * 9 + [i32] * 3 + [f32, i32, ptr]
            else:
                launch.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, ptr]
                lib.strand_walk_mixed_launch.restype = ctypes.c_int
                lib.strand_walk_mixed_launch.argtypes = (
                    [ptr] * 10 + [i32] * 5 + [f32, f32, ptr])
            err = getattr(lib, name + "_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return _LIBS[name]


def _raise_failed(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, name + "_error_string")(rc)
                           .decode())


def _block_launch(strand_rows, leaf_tris, first, ro, rd, tmax, tmin,
                  any_hit, stats=None):
    """Check the inputs, allocate the outputs and launch
    ``csrc/strand_block.cu`` on the current stream: (t, tri)."""
    if ro.device.type != "cuda":
        raise ValueError(f"strand_block needs CUDA tensors, got {ro.device}")
    _check_inputs("strand_rows", strand_rows, leaf_tris, ro, rd, tmax, first)
    lib = _library("strand_block")
    r = ro.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    tri = torch.empty(r, dtype=torch.int32, device=ro.device)
    if r == 0:
        return t, tri
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.strand_block_launch(
            strand_rows.data_ptr(), leaf_tris.data_ptr(), first.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), tmax.data_ptr(), t.data_ptr(),
            tri.data_ptr(), None if stats is None else stats.data_ptr(), r,
            strand_rows.shape[0] * 2, leaf_tris.shape[0], float(tmin),
            int(any_hit), stream)
    _raise_failed(lib, "strand_block", rc)
    return t, tri


def _walk_launch(rows, leaf_tris, first, ro, rd, tmax, smask, tmin,
                 second: float, rpo: int, ribbon_k: int, stats: bool):
    """Check the inputs, allocate the outputs and launch
    ``csrc/strand_walk.cu`` on the current stream: with ``smask`` None the
    closest-hit (``second`` = 0) or any-hit (1) instance, else the mixed one
    (``second`` = shadow_tmin). Returns (t, tri, stats or None, whether a
    kernel was launched: not for no rays)."""
    if ro.device.type != "cuda":
        raise ValueError(f"strand_walk needs CUDA tensors, got {ro.device}")
    _check_inputs("strand_rows", rows, leaf_tris, ro, rd, tmax, first)
    _check_layout(rows, rpo, ribbon_k)
    if smask is not None and (
            smask.dtype != torch.float32 or smask.device != ro.device
            or smask.shape != tmax.shape or not smask.is_contiguous()):
        raise ValueError(f"smask: want a contiguous float32 [{ro.shape[0]}] "
                         f"tensor on {ro.device}")
    lib = _library("strand_walk")
    r = ro.shape[0]
    dev = ro.device
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    st = None
    if stats:
        st = torch.zeros(8, dtype=torch.int32, device=dev)
        st[3] = wrap_i32(-(-r // STRAND_RAYS))
    if r == 0:
        return t, tri, st, False
    n_nodes = _n_nodes(rows, rpo)
    head = [rows.data_ptr(), leaf_tris.data_ptr(), first.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), tmax.data_ptr()]
    tail = [t.data_ptr(), tri.data_ptr(), None if st is None else
            st.data_ptr(), r, n_nodes, leaf_tris.shape[0], int(rpo),
            int(ribbon_k), float(tmin)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if smask is None:
            rc = lib.strand_walk_launch(*head, *tail, int(second), stream)
        else:
            rc = lib.strand_walk_mixed_launch(*head, smask.data_ptr(), *tail,
                                              float(second), stream)
    _raise_failed(lib, "strand_walk", rc)
    return t, tri, st, True


def _count(fn, rpo: int) -> None:
    """One launch of ``fn``'s kernel: ``ribbon_launches`` on ribbon rows,
    ``launches`` on strand rows."""
    if rpo:
        fn.ribbon_launches += 1
    else:
        fn.launches += 1


def strand_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                      tmin: float, any_hit: bool, *, rpo: int = 0,
                      ribbon_k: int = 4, stats: bool = False):
    """Launch ``csrc/strand_walk.cu`` on the current stream (one thread per
    ray, while-while traversal). Same signature and results as
    ``strand_query_torch``; raises on bad inputs or a failed launch.
    ``strand_query_cuda.launches`` counts the launches over strand rows,
    ``.ribbon_launches`` those over ribbon rows."""
    t, tri, st, launched = _walk_launch(strand_rows, leaf_tris, first, ro,
                                        rd, tmax, None, tmin, int(any_hit),
                                        rpo, ribbon_k, stats)
    if launched:
        _count(strand_query_cuda, rpo)
    return (t, tri, st) if stats else (t, tri)


strand_query_cuda.launches = 0
strand_query_cuda.ribbon_launches = 0


def strand_query(strand_rows, leaf_tris, first, ro, rd, tmax, tmin: float,
                 any_hit: bool, *, rpo: int = 0, ribbon_k: int = 4,
                 stats: bool = False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = strand_query_cuda if ro.device.type == "cuda" else strand_query_torch
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, tmin, any_hit,
              rpo=rpo, ribbon_k=ribbon_k, stats=stats)


def strand_mixed_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                            smask, tmin: float, shadow_tmin: float, *,
                            rpo: int = 0, ribbon_k: int = 4,
                            stats: bool = False):
    """Launch the mixed form of ``csrc/strand_walk.cu`` on the current
    stream. Same signature and results as ``strand_mixed_query_torch``;
    raises on bad inputs or a failed launch.
    ``strand_mixed_query_cuda.launches`` counts the launches over strand
    rows, ``.ribbon_launches`` those over ribbon rows."""
    t, tri, st, launched = _walk_launch(strand_rows, leaf_tris, first, ro,
                                        rd, tmax, smask, tmin, shadow_tmin,
                                        rpo, ribbon_k, stats)
    if launched:
        _count(strand_mixed_query_cuda, rpo)
    return (t, tri, st) if stats else (t, tri)


strand_mixed_query_cuda.launches = 0
strand_mixed_query_cuda.ribbon_launches = 0


def strand_mixed_query(strand_rows, leaf_tris, first, ro, rd, tmax, smask,
                       tmin: float, shadow_tmin: float, *, rpo: int = 0,
                       ribbon_k: int = 4, stats: bool = False):
    """The mixed kernel for CUDA tensors, its plain version for CPU
    tensors."""
    fn = (strand_mixed_query_cuda if ro.device.type == "cuda"
          else strand_mixed_query_torch)
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, smask, tmin,
              shadow_tmin, rpo=rpo, ribbon_k=ribbon_k, stats=stats)


def strand_block_query_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                             tmin: float, any_hit: bool,
                             with_stats: bool = False):
    """Plain torch version of the block walk. ``first`` is
    ``first_slots(leaf_tris)``, ro/rd [R,3], tmax [R]; returns (t [R]
    f32, tri [R] i32) and, with ``with_stats``, int32 [ceil(R/32), 2] of
    each strand's walker steps and leaf visits. The
    rays are cut into strands [S, 32], the last one padded with dead lanes
    (ro 0, rd (1,1,1), tmax -inf); each loop iteration advances every
    unfinished strand's walker by one node."""
    dev = ro.device
    r = ro.shape[0]
    n_str = -(-r // STRAND)
    pad = n_str * STRAND - r
    recs = strand_rows.reshape(-1, 8)  # node c, octant o at record 8c + o
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = strand_rows.shape[0] * 2
    n_leaf_rows = leaf_tris.shape[0]
    tmax = tmax.to(torch.float32)
    if pad:
        ro = torch.cat([ro, ro.new_zeros((pad, 3))])
        rd = torch.cat([rd, rd.new_ones((pad, 3))])
        tmax = torch.cat([tmax, tmax.new_full((pad,), float("-inf"))])
    o = ro.reshape(n_str, STRAND, 3)
    d = rd.reshape(n_str, STRAND, 3)
    tm = tmax.reshape(n_str, STRAND)
    inv = _safe_inv(d)
    lane0 = d[:, 0]
    best_t = tm.clone() if any_hit else torch.minimum(
        torch.full_like(tm, F32_MAX), tm
    )
    t_out = torch.empty_like(tm)
    tri_out = torch.empty((n_str, STRAND), dtype=torch.int32, device=dev)
    st_out = torch.empty((n_str, 2), dtype=torch.int32, device=dev)
    # the working set: one entry per unfinished strand
    s = dict(
        idx=torch.arange(n_str, device=dev), o=o, d=d, inv=inv,
        neg=inv < 0.0, tm=tm, bt=best_t,
        oct=((lane0[:, 0] < 0).long() + 2 * (lane0[:, 1] < 0).long()
             + 4 * (lane0[:, 2] < 0).long()),
        btri=torch.full((n_str, STRAND), -1, dtype=torch.int32, device=dev),
        bkey=torch.full((n_str, STRAND), -1, dtype=torch.int32, device=dev),
        cur=torch.zeros(n_str, dtype=torch.long, device=dev),
        st=torch.zeros((n_str, 2), dtype=torch.int32, device=dev),
    )
    k8 = torch.arange(8, device=dev, dtype=torch.int32)

    def retire(done):
        nonlocal s
        i = s["idx"][done]
        t_out[i] = s["bt"][done]
        tri_out[i] = s["btri"][done]
        st_out[i] = s["st"][done]
        s = {key: val[~done] for key, val in s.items()}

    for _ in range(n_nodes):
        if any_hit:
            # every lane blocked or dead: the walker stops
            retire(((s["btri"] >= 0) | (s["tm"] < 0.0)).all(dim=1))
        if s["idx"].numel() == 0:
            break
        rec = recs[s["cur"] * 8 + s["oct"]][:, None, :]  # [W, 1, 8]
        neg = s["neg"]
        lo = (torch.where(neg, rec[..., 3:6], rec[..., 0:3]) - s["o"]) * s["inv"]
        hi = (torch.where(neg, rec[..., 0:3], rec[..., 3:6]) - s["o"]) * s["inv"]
        if any_hit:
            limit = torch.where(s["btri"] >= 0, float("-inf"), s["tm"])
        else:
            limit = s["bt"]
        near = torch.maximum(
            torch.maximum(lo[..., 0], lo[..., 1]),
            torch.maximum(lo[..., 2], torch.full_like(lo[..., 2], tmin)),
        )
        far = torch.minimum(
            torch.minimum(hi[..., 0], hi[..., 1]),
            torch.minimum(hi[..., 2], limit),
        )
        hit_any = (near <= far * FAR_SCALE).any(dim=1)
        s["st"][:, 0] += 1
        hit_link = rec[:, 0, 6].long()
        nxt = torch.where(hit_any & (hit_link >= 0), hit_link,
                          rec[:, 0, 7].long())
        at_leaf = hit_any & (hit_link < 0) & (~hit_link < n_leaf_rows)
        if bool(at_leaf.any()):
            li = at_leaf.nonzero().squeeze(1)
            s["st"][li, 1] += 1
            lr = (~hit_link[li]).to(torch.int32)
            tri = tris[lr.long()][:, None]  # [L, 1, 8, 10]
            lim = s["tm"][li][..., None] if any_hit else float("inf")
            t, _, _, ok = moller_trumbore(
                s["o"][li][:, :, None, :], s["d"][li][:, :, None, :],
                tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], tmin, lim,
            )  # [L, 32, 8]
            slot = (lr[:, None] * 8 + k8)[:, None, :].expand_as(t)
            bt, bi = s["bt"][li], s["btri"][li]
            if any_hit:
                # a lane keeps its first accepted slot
                found = ok.any(dim=2)
                k = ok.to(torch.int32).argmax(dim=2, keepdim=True)
                first_ok = slot.gather(2, k)[..., 0]
                s["btri"][li] = torch.where(found & (bi < 0), first_ok, bi)
            else:
                found, mt, ms, mk = _leaf_closest(ok, t, slot,
                                                  first[slot.long()])
                bk = s["bkey"][li]
                acc = found & ((mt < bt) | ((mt == bt) & (mk < bk)))
                s["bt"][li] = torch.where(acc, mt, bt)
                s["btri"][li] = torch.where(acc, ms, bi)
                s["bkey"][li] = torch.where(acc, mk, bk)
        s["cur"] = nxt
        retire((nxt < 0) | (nxt >= n_nodes))
    # walks cut by the step bound (never for a valid tree) keep their best
    retire(torch.ones_like(s["idx"], dtype=torch.bool))
    t, tri = t_out.reshape(-1)[:r], tri_out.reshape(-1)[:r]
    return (t, tri, st_out) if with_stats else (t, tri)


def strand_block_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                            tmin: float, any_hit: bool,
                            with_stats: bool = False):
    """Launch ``csrc/strand_block.cu`` on the current stream (one warp per
    32-ray strand, 4 strands per block). Same signature and results as
    ``strand_block_query_torch``; raises on bad inputs or a failed launch.
    ``strand_block_query_cuda.launches`` counts the launches."""
    r = ro.shape[0]
    stats = torch.zeros((-(-r // STRAND), 2), dtype=torch.int32,
                        device=ro.device) if with_stats else None
    t, tri = _block_launch(strand_rows, leaf_tris, first, ro, rd, tmax, tmin,
                           any_hit, stats)
    if r:
        strand_block_query_cuda.launches += 1
    return (t, tri, stats) if with_stats else (t, tri)


strand_block_query_cuda.launches = 0


def strand_block_query(strand_rows, leaf_tris, first, ro, rd, tmax,
                       tmin: float, any_hit: bool, with_stats: bool = False):
    """The block kernel for CUDA tensors, its plain version for CPU
    tensors."""
    fn = (strand_block_query_cuda if ro.device.type == "cuda"
          else strand_block_query_torch)
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, tmin, any_hit,
              with_stats)


def _check_baked_tmin(tmin, baked: float, what: str):
    if float(tmin) != baked:
        raise ValueError(
            f"{what}: tmin is baked at {baked}, the engine passed {tmin}"
        )


def _per_ray(tmax, ro):
    """tmax (a scalar or [R]) as a contiguous float32 [R] on ro's device."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=ro.device)
    return tmax.expand(ro.shape[0]).contiguous()


def _ribbon_env() -> int:
    """RAYTPU_RIBBON = K (sub-steps per fetched ribbon row, raytpu's
    ``ribbon_k``): 0 or less keeps the strand layout; above 8 raises, as
    raytpu's kernel asserts ``1 <= ribbon_k <= 8``."""
    k = int(os.environ.get("RAYTPU_RIBBON", "0"))
    if k > 8:
        raise ValueError(f"RAYTPU_RIBBON={k}: want 0..8")
    return k


def _layout(pack, tree, leaves, per_ray: bool) -> tuple:
    """(rows, layout keywords) of a strand factory, as raytpu's factories
    choose: the ribbon rows with ``rpo`` and ``ribbon_k`` when
    RAYTPU_RIBBON = K > 0, the per-ray walk is chosen, the tables are
    within the 100 MiB budget and the pack has ribbon rows; else the
    strand rows and no keywords."""
    k = _ribbon_env()
    ribbon = getattr(pack.bvh, "ribbon_rows", None)
    if (k > 0 and per_ray and ribbon is not None
            and (tree.numel() + leaves.numel()) * 4 <= STRAND_TABLE_BUDGET):
        ribbon = ribbon.contiguous()
        return ribbon, dict(rpo=ribbon.shape[0] // 8, ribbon_k=k)
    return tree, {}


def make_strand_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature over ``pack.bvh.strand_rows`` and ``leaf_tris``, ties broken
    on ``pack.bvh.first_slots``. tmin is baked: 0.001 for
    closest-hit and 0.0 for any-hit; another value raises. A pack without
    a strand tree (<= 256 slots) raises ValueError.

    The walk is chosen here, once, as raytpu's factory chooses its kernel:
    the per-ray walk (raytpu's persistent kernel, its default), or the
    block walk when ``RAYTPU_STRAND_PERSISTENT=0`` and the strand rows and
    leaf rows fit raytpu's 100 MiB table budget (above it raytpu forces
    the persistent kernel, and so does the port). ``RAYTPU_RIBBON`` = K > 0
    puts the per-ray walk on ``pack.bvh.ribbon_rows`` where the pack has
    them (K > 8 raises; the block walk keeps the strand rows, as raytpu's
    block kernel has no ribbon). raytpu's block-kernel
    scheduling knobs (``groups``, ``RAYTPU_STRAND_SKIP_DONE``,
    ``RAYTPU_STRAND_MULTIROLL``, the leaf-queue deferral) are TPU
    scheduling and have no counterpart. On a CUDA pack the chosen walk's
    library is built or loaded here, on the caller's thread."""
    if pack.bvh.strand_rows is None:
        raise ValueError(
            "intersector='strand' needs a strand tree; scenes above "
            "the sort threshold pack one by default"
        )
    tree = pack.bvh.strand_rows.contiguous()
    leaves = pack.bvh.leaf_tris.contiguous()
    first = pack.bvh.first_slots.contiguous()
    persistent = os.environ.get("RAYTPU_STRAND_PERSISTENT", "1") != "0"
    if (tree.numel() + leaves.numel()) * 4 > STRAND_TABLE_BUDGET:
        persistent = True
    tree, layout = _layout(pack, tree, leaves, persistent)
    query = strand_query if persistent else strand_block_query
    if tree.device.type == "cuda":  # build or load here, not at a launch
        _library("strand_walk" if persistent else "strand_block")

    def closest(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, CLOSEST_TMIN, "strand closest")
        t, tri = query(tree, leaves, first, ro.contiguous(), rd.contiguous(),
                       _per_ray(tmax, ro), CLOSEST_TMIN, False, **layout)
        return Hit(t=t, tri=tri, valid=tri >= 0)

    def any_fn(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, ANY_TMIN, "strand any-hit")
        _, tri = query(tree, leaves, first, ro.contiguous(), rd.contiguous(),
                       _per_ray(tmax, ro), ANY_TMIN, True, **layout)
        return tri >= 0

    return closest, any_fn


def make_strand_mixed_query(pack):
    """The deferred-NEE mixed query over ``pack.bvh.strand_rows``,
    ``leaf_tris`` and ``first_slots``, with raytpu's contract (the port's
    ``make_binned_query``'s too): (ro [R,3], rd [R,3], tmax [R], smask
    [R], *, tmin, shadow_tmin) -> (t [R], tri [R]). One walk serves a
    bounce's continuation rays (closest lanes) and the previous bounce's
    deferred shadow rays (``smask == 1``: only ``tri >= 0``, blocked, is
    contract). It always takes the per-ray walk, as raytpu's factory
    always takes its persistent kernel: ``RAYTPU_STRAND_PERSISTENT=0`` does
    not move it to the block walk. ``RAYTPU_RIBBON`` = K > 0 is read here,
    once, as in ``make_strand_intersectors``: the walk takes
    ``pack.bvh.ribbon_rows`` where the pack has them and the tables fit
    100 MiB (the same bits). raytpu's schedule knobs
    (``RAYTPU_STRAND_WALKERS``, ``_SERVICE_K``, ``_FLUSH``, ``_PIPE``,
    ``_UNROLL``, ``_CTL``, ``_POP``, ``_DUAL``) change no result there and
    are not read here. A pack without a strand tree raises ValueError. On
    a CUDA pack the kernel's library is built or loaded here, on the
    caller's thread."""
    if pack.bvh.strand_rows is None:
        raise ValueError(
            "bounce_backend='mixed' needs a strand tree; pack "
            "the scene with the default packed tables"
        )
    leaves = pack.bvh.leaf_tris.contiguous()
    first = pack.bvh.first_slots.contiguous()
    tree, layout = _layout(pack, pack.bvh.strand_rows.contiguous(), leaves,
                           True)
    if tree.device.type == "cuda":  # build or load here, not at a launch
        _library("strand_walk")

    def query(ro, rd, tmax, smask, *, tmin: float, shadow_tmin: float):
        return strand_mixed_query(
            tree, leaves, first, ro.contiguous(), rd.contiguous(),
            _per_ray(tmax, ro), smask.to(torch.float32).contiguous(), tmin,
            shadow_tmin, **layout)

    return query
