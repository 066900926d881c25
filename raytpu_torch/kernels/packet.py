"""BVH8 ray queries of the packet route: the CUDA kernel, its plain torch
version, and the engine's intersector factory.

Replaces ``raytpu/kernels/intersect_pallas.py:_packet_kernel`` /
``_one_packet`` (entry ``packet_query``, factory
``make_packet_intersectors``) in its closest-hit, any-hit and mixed forms
(``smask``, below). The TPU kernel walks one shared stack per 4096-ray
packet; this port keeps the
contract and gives every ray its own stack walk of the 8-wide BVH
(``node8_rows``: child k at columns 16k..16k+6, bmin, bmax, then the link
as int32 bits: a child node, or ``~leaf_row`` for a leaf).

Range contract, per ray (raytpu's ``packet_query``), held to the brute
sweep (kernels/intersect.py) as the strand walks are (kernels/strand.py):

* closest-hit treats a finite ``tmax`` as an OPEN bound: the walk's bound
  starts at ``min(F32_MAX, tmax)`` and a hit is accepted iff ``t >= tmin
  and (t < best_t or (t == best_t and first[slot] < best key))``, so a hit
  at exactly ``tmax`` is a miss. ``first`` is the tie keys
  (``first_slots``: the lowest slot holding the same triangle bits), so
  ties break to the lowest slot of any copy and the visit order never
  changes t or the triangle; which copy's slot is returned is the first
  one the walk tests;
* any-hit uses the closed range ``[tmin, tmax]`` and stops at the first
  blocker. Only ``tri >= 0`` (blocked) is contract; ``t`` returns tmax;
* dead lanes (``tmax = -inf``) return ``t = -inf, tri = -1`` for
  closest-hit and are never blocked.

The walk, shared bit for bit by the kernel and the plain version
(csrc/bvh8_walk.cuh): pop a node; slab-test its 8 children against the
LIMIT of the pop (best_t for closest-hit, tmax for any-hit), with the safe
inverse direction (zero components -> +/-1e-36), ``near = max(max(lox,
loy), max(loz, tmin))``, ``far = min(min(hix, hiy), min(hiz, LIMIT))``,
hit iff ``near <= far * FAR_SCALE`` (the conservative test of
kernels/strand.py); push the hit interior children from child 7 down, so
child 0 is popped next; then test the hit leaves' 8 triangles from child 0
up. The slab does not order-normalise its intervals, so the BVH builder's
empty slots (inverted boxes) miss every ray. Pushes clamp at ``STACK_DEPTH
- 1`` as raytpu's do; the pack's depth check keeps a real tree below that
bound, and pops stop after as many nodes as the tree has.

The two repairs of ROADMAP fault 3.5 (the conservative box test and the
tie keys) are those of fault 3.4 in the strand walks; neither can change a
result that was already right (kernels/strand.py says why).

``packet_query_cuda`` launches ``csrc/packet_walk.cu``;
``packet_query_torch`` is the plain version (a vectorised per-ray walk in
torch ops, the same arithmetic in the same order). ``packet_query``
dispatches on the tensors' device alone.

Each of the three takes ``smask`` and ``shadow_tmin`` for the mixed form,
raytpu's ``packet_query(..., smask, mixed=True, shadow_tmin)``: lanes
with ``smask == 1`` are shadow lanes, any-hit over the closed range
[shadow_tmin, tmax]; the others closest-hit over [tmin, tmax); every
lane's bound starts at ``min(F32_MAX, tmax)`` and the slab test uses
``min(tmin, shadow_tmin)``, the treelet walk's per-lane contract
(kernels/binned.py). No engine path calls it, as in raytpu; with ``smask``
None a call runs the closest-hit or any-hit form.

Two more of raytpu's options, neither of which changes ``t`` or the tie
key:

* ``ordered`` (raytpu's near-first child order): each popped node's hit
  children are visited by the ray's own entry distance, with the integer
  key ``(bits(near + 0) & ~7) | k`` (a missed child ``0x7ffffff8 | k``):
  interior children pushed far-first, so the nearest is popped next, and
  leaves tested near-first (csrc/bvh8_walk.cuh; the plain version sorts
  the same keys with ``torch.sort``). Which copy of a spatially split
  triangle is returned follows the visit order. With ``ordered=None`` the
  call reads ``RAYTPU_ORDER_MODE`` as raytpu does: ``all`` orders every
  query, ``none`` none, any other value the any-hit queries only. **Unset,
  the port keeps storage order**, where raytpu's default is ``all``:
  near-first measured slower on the card (PERF.md), and order changes no
  result of the contract.
* ``with_stats`` (raytpu's): also returns int32 [ceil(R / packet), 128],
  per packet of ``packet`` rays (``RAYTPU_PACKET``, default 4096, read at
  import as raytpu reads it; a multiple of 128) lane 1 the leaf-row tests
  and every other lane the node pops, each summed over the packet's rays,
  each ray counting its own walk. raytpu counts one shared walk per packet
  (a pop per node of the union); the port has no shared walk, so its
  counts are the per-ray sums. A dead lane (tmax = -inf) walks no node, so
  an all-dead packet counts 0. The sums are int32 and wrap past 2^31 - 1;
  the kernel adds a warp's sum with one atomic, and integer sums do not
  depend on order, so the plain version reproduces them bit for bit.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .intersect import F32_MAX, Hit, moller_trumbore
from .strand import (
    ANY_TMIN,
    CLOSEST_TMIN,
    FAR_SCALE,
    _check_baked_tmin,
    _check_inputs,
    _leaf_closest,
    _per_ray,
    _safe_inv,
    wrap_i32,
)

# per-ray stack slots: <= 8 pushes per BVH8 level, so a depth-d tree needs
# 8*d + 1; scene/pack.py rejects trees with 8*d + 8 > STACK_DEPTH
STACK_DEPTH = 512
_PLAIN_STACK0 = 64  # the plain version's first stack width; it grows
# rays per stats row: raytpu's packet size (intersect_pallas.py:60)
PACKET = int(os.environ.get("RAYTPU_PACKET", 4096))
_MISSED_KEY = 0x7FFFFFF8  # a missed child's near-first key, less its k


def resolve_order(ordered, any_hit: bool) -> bool:
    """raytpu's ``ordered`` resolution (intersect_pallas.py:451-461), read
    at call time: an explicit value wins; else RAYTPU_ORDER_MODE ``all`` is
    True, ``none`` False and any other value ``any_hit``. Unset, the port
    keeps storage order (False), where raytpu defaults to ``all``."""
    if ordered is not None:
        return bool(ordered)
    mode = os.environ.get("RAYTPU_ORDER_MODE")
    if mode is None:
        return False
    return {"all": True, "none": False}.get(mode, any_hit)


def _check_packet(packet: int) -> None:
    if packet <= 0 or packet % 128:
        raise ValueError(f"packet={packet}: want a positive multiple of 128")


def _packet_stats(pops, tests, packet: int) -> torch.Tensor:
    """int32 [ceil(R / packet), 128] from per-ray int64 node pops and
    leaf-row tests: lane 1 the packet's tests, every other lane its pops."""
    r = pops.shape[0]
    n_pk = -(-r // packet)
    pk = torch.arange(r, device=pops.device) // packet
    sums = torch.zeros((n_pk, 2), dtype=torch.int64, device=pops.device)
    sums[:, 0].index_add_(0, pk, pops)
    sums[:, 1].index_add_(0, pk, tests)
    sums = wrap_i32(sums)  # as the kernel's int32 atomics leave them
    lane = torch.arange(128, device=pops.device)
    return torch.where(lane == 1, sums[:, 1:2], sums[:, 0:1]).to(torch.int32)


def packet_query_torch(node8_rows, leaf_tris, first, ro, rd, tmax,
                       tmin: float, any_hit: bool,
                       counts: dict | None = None, smask=None,
                       shadow_tmin: float = 0.0, *, ordered=None,
                       with_stats: bool = False, packet: int = PACKET):
    """Plain torch version of the BVH8 stack walk. ``first`` is the tie
    keys (``first_slots``), ro/rd [R,3], tmax [R]; returns (t [R] f32,
    tri [R] i32), and with ``with_stats`` the per-packet stats (module
    docstring). ``ordered`` picks near-first order (None: resolved by
    ``resolve_order``). Each loop iteration pops one node for every
    unfinished ray; finished rays leave the working set, and dead lanes
    (tmax = -inf) never enter it. The stack is a [W, width] tensor whose
    width grows to STACK_DEPTH as pushes need.
    A ``counts`` dict gains the walk's box tests ("boxes"), triangle tests
    ("tris") and the table bytes it reads, each distinct 512-byte node row
    and 320-byte leaf row once ("bytes").

    With ``smask`` [R] (raytpu's ``packet_query(mixed=True)``), the mixed
    form: ``smask == 1`` flags a shadow lane, any-hit over [shadow_tmin,
    tmax] that stops at its first blocker; the other lanes are closest-hit
    over [tmin, tmax). Every lane's best t starts at min(F32_MAX, tmax)
    and is its LIMIT (a shadow lane's t returns it), and the slab test uses
    min(tmin, shadow_tmin), as in the treelet walk. ``any_hit`` must be
    False. Without ``smask`` shadow_tmin is not read."""
    _check_packet(packet)
    ordered = resolve_order(ordered, any_hit)
    dev = ro.device
    r = ro.shape[0]
    # the any-hit lanes: every lane or none, or smask's shadow lanes
    if smask is None:
        shad = torch.full((r,), any_hit, dtype=torch.bool, device=dev)
        shadow_tmin = tmin
    elif any_hit:
        raise ValueError("the mixed form (smask given) needs any_hit=False")
    else:
        shad = smask == 1.0
    slab_tmin = min(tmin, shadow_tmin)
    tcut = torch.where(shad, shadow_tmin, tmin).to(torch.float32)
    any_lanes = bool(shad.any())
    closest_lanes = not bool(shad.all())
    n_nodes = node8_rows.shape[0]
    n_leaf_rows = leaf_tris.shape[0]
    kids = node8_rows.reshape(n_nodes, 8, 16)
    boxes = kids[:, :, 0:6]
    links = kids[:, :, 6].contiguous().view(torch.int32)  # [N8, 8]
    tris = leaf_tris.reshape(-1, 8, 10)
    tmax = tmax.to(torch.float32)
    inv = _safe_inv(rd)
    # the any-hit form's LIMIT is tmax itself; every other lane's is its
    # best t, from min(F32_MAX, tmax)
    best_t = tmax.clone() if any_hit else torch.minimum(
        torch.full_like(tmax, F32_MAX), tmax
    )
    # a dead lane (tmax = -inf) walks no node: its result is its start
    t_out = best_t.clone()
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    live = tmax != float("-inf")
    ray_pops = torch.zeros(r, dtype=torch.int64, device=dev)
    ray_tests = torch.zeros(r, dtype=torch.int64, device=dev)
    stack = torch.zeros((r, _PLAIN_STACK0), dtype=torch.int32, device=dev)
    # the working set: one entry per unfinished ray; the root is on every
    # stack (column 0 holds 0)
    s = dict(
        idx=torch.arange(r, device=dev), o=ro, d=rd, inv=inv, neg=inv < 0.0,
        shad=shad, tcut=tcut, bt=best_t,
        btri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        bkey=torch.full((r,), -1, dtype=torch.int32, device=dev),
        sp=torch.ones(r, dtype=torch.long, device=dev), stack=stack,
    )
    s = {key: val[live] for key, val in s.items()}
    k8 = torch.arange(8, device=dev, dtype=torch.int32)
    k8l = k8.long()
    if counts is not None:
        counts.setdefault("boxes", 0)
        seen_node = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(n_leaf_rows, dtype=torch.bool, device=dev)
    for _ in range(n_nodes):
        w = s["idx"].numel()
        if w == 0:
            break
        ray_pops[s["idx"]] += 1
        width = s["stack"].shape[1]
        need = int(s["sp"].max()) + 8
        if need > width and width < STACK_DEPTH:
            grown = min(STACK_DEPTH, max(2 * width, need))
            s["stack"] = torch.cat([s["stack"], s["stack"].new_zeros(
                (w, grown - width))], dim=1)
        if counts is not None:
            counts["boxes"] = counts.get("boxes", 0) + 8 * w
        lane = torch.arange(w, device=dev)
        s["sp"] = s["sp"] - 1
        node = s["stack"][lane, s["sp"]].long()
        if counts is not None:
            seen_node[node] = True
        kb = boxes[node]  # [W, 8, 6]
        kl = links[node]  # [W, 8]
        # every child's box against the LIMIT of the pop
        neg = s["neg"][:, None, :]
        lo = (torch.where(neg, kb[..., 3:6], kb[..., 0:3])
              - s["o"][:, None, :]) * s["inv"][:, None, :]
        hi = (torch.where(neg, kb[..., 0:3], kb[..., 3:6])
              - s["o"][:, None, :]) * s["inv"][:, None, :]
        limit = s["bt"][:, None]
        near = torch.maximum(
            torch.maximum(lo[..., 0], lo[..., 1]),
            torch.maximum(lo[..., 2], torch.full_like(lo[..., 2], slab_tmin)),
        )
        far = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                            torch.minimum(hi[..., 2], limit))
        hit = near <= far * FAR_SCALE
        inner = hit & (kl >= 0) & (kl < n_nodes)
        at_leaf = hit & (kl < 0) & (~kl < n_leaf_rows)
        if ordered:
            # the visit order: children by their near-first keys; column j
            # of the reordered tensors is the j-th child to visit
            bits = (near + 0.0).view(torch.int32).long() & 0xFFFFFFFF
            key = torch.where(hit, (bits & ~7) | k8l, _MISSED_KEY | k8l)
            visit = torch.sort(key, dim=1).values & 7
            inner, at_leaf, kl = (x.gather(1, visit)
                                  for x in (inner, at_leaf, kl))
        # interior children from the last to visit down, so the first is
        # popped next
        for j in range(7, -1, -1):
            push = inner[:, j]
            if bool(push.any()):
                slot = torch.clamp(s["sp"], max=STACK_DEPTH - 1)
                s["stack"][lane[push], slot[push]] = kl[push, j]
                s["sp"] = torch.clamp(s["sp"] + push.long(),
                                      max=STACK_DEPTH - 1)
        # then the hit leaves, the first to visit first
        walking = torch.ones(w, dtype=torch.bool, device=dev)
        for j in range(8):
            at = at_leaf[:, j] & walking
            if not bool(at.any()):
                continue
            li = at.nonzero().squeeze(1)
            lr = ~kl[li, j]
            ray_tests[s["idx"][li]] += 1
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
            slots = lr[:, None] * 8 + k8  # [L, 8]
            sh = s["shad"][li]
            ti, tk = bi, bk
            if closest_lanes:
                found, mt, ms, mk = _leaf_closest(ok, t, slots,
                                                  first[slots.long()])
                acc = ~sh & found & ((mt < bt) | ((mt == bt) & (mk < bk)))
                s["bt"][li] = torch.where(acc, mt, bt)
                ti = torch.where(acc, ms, bi)
                tk = torch.where(acc, mk, bk)
            if any_lanes:
                # the first accepted triangle blocks and ends the walk
                blocked = sh & ok.any(dim=1)
                k = ok.to(torch.int32).argmax(dim=1)
                ti = torch.where(blocked, slots.gather(1, k[:, None])[:, 0],
                                 ti)
                walking[li] = ~blocked
            s["btri"][li] = ti
            s["bkey"][li] = tk
        done = (s["sp"] == 0) | ~walking
        if bool(done.any()):
            t_out[s["idx"][done]] = s["bt"][done]
            tri_out[s["idx"][done]] = s["btri"][done]
            keep = ~done
            s = {key: val[keep] for key, val in s.items()}
    # walks cut by the pop bound (never for a tree) keep their best
    t_out[s["idx"]] = s["bt"]
    tri_out[s["idx"]] = s["btri"]
    if counts is not None:
        counts["bytes"] = (counts.get("bytes", 0) + 512 * int(seen_node.sum())
                           + 320 * int(seen_leaf.sum()))
    if with_stats:
        return t_out, tri_out, _packet_stats(ray_pops, ray_tests, packet)
    return t_out, tri_out


_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    from ._build import LOCK, load_library

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with LOCK:
        if _LIB is None:
            lib = load_library("packet_walk")
            lib.packet_walk_launch.restype = ctypes.c_int
            lib.packet_walk_launch.argtypes = (
                [ptr] * 9 + [i32] * 5 + [f32, i32, ptr])
            lib.packet_walk_mixed_launch.restype = ctypes.c_int
            lib.packet_walk_mixed_launch.argtypes = (
                [ptr] * 10 + [i32] * 5 + [f32, f32, ptr])
            lib.packet_walk_error_string.restype = ctypes.c_char_p
            lib.packet_walk_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def packet_query_cuda(node8_rows, leaf_tris, first, ro, rd, tmax,
                      tmin: float, any_hit: bool, smask=None,
                      shadow_tmin: float = 0.0, *, ordered=None,
                      with_stats: bool = False, packet: int = PACKET):
    """Launch ``csrc/packet_walk.cu`` on the current stream (one thread per
    ray, blocks of 128); with ``smask``, its mixed form; with ``ordered``
    (resolved by ``resolve_order``), its near-first instance. Same
    signature and results as ``packet_query_torch``; raises on bad inputs
    or a failed launch. ``packet_query_cuda.launches`` counts the
    storage-order closest-hit and any-hit launches, ``.mixed_launches``
    the storage-order mixed ones, ``.ordered_launches`` and
    ``.mixed_ordered_launches`` the near-first ones."""
    if ro.device.type != "cuda":
        raise ValueError(f"packet_query_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    _check_inputs("node8_rows", node8_rows, leaf_tris, ro, rd, tmax, first)
    _check_packet(packet)
    if node8_rows.shape[0] == 0:
        raise ValueError("node8_rows: want at least the root node")
    if smask is not None:
        if any_hit:
            raise ValueError("the mixed form (smask given) needs "
                             "any_hit=False")
        if (smask.dtype != torch.float32 or smask.device != ro.device
                or smask.shape != tmax.shape or not smask.is_contiguous()):
            raise ValueError(f"smask: want a contiguous float32 "
                             f"[{ro.shape[0]}] tensor on {ro.device}")
    ordered = resolve_order(ordered, any_hit)
    lib = _library()
    r = ro.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    tri = torch.empty(r, dtype=torch.int32, device=ro.device)
    st = (torch.zeros((-(-r // packet), 128), dtype=torch.int32,
                      device=ro.device) if with_stats else None)
    if r == 0:
        return (t, tri, st) if with_stats else (t, tri)
    head = (node8_rows.data_ptr(), leaf_tris.data_ptr(), first.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), tmax.data_ptr())
    tail = (t.data_ptr(), tri.data_ptr(), None if st is None else
            st.data_ptr(), r, node8_rows.shape[0], leaf_tris.shape[0],
            int(packet), int(ordered), float(tmin))
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        if smask is None:
            rc = lib.packet_walk_launch(*head, *tail, int(any_hit), stream)
        else:
            rc = lib.packet_walk_mixed_launch(*head, smask.data_ptr(), *tail,
                                              float(shadow_tmin), stream)
    if rc != 0:
        raise RuntimeError(
            "packet_walk launch failed: "
            + lib.packet_walk_error_string(rc).decode()
        )
    if smask is None:
        counter = "ordered_launches" if ordered else "launches"
    else:
        counter = "mixed_ordered_launches" if ordered else "mixed_launches"
    setattr(packet_query_cuda, counter,
            getattr(packet_query_cuda, counter) + 1)
    if with_stats:
        # lane 0 holds each packet's pops: raytpu's layout repeats them in
        # every lane but 1
        st[:, 2:] = st[:, :1]
        return t, tri, st
    return t, tri


packet_query_cuda.launches = 0
packet_query_cuda.mixed_launches = 0
packet_query_cuda.ordered_launches = 0
packet_query_cuda.mixed_ordered_launches = 0


def packet_query(node8_rows, leaf_tris, first, ro, rd, tmax, tmin: float,
                 any_hit: bool, smask=None, shadow_tmin: float = 0.0, *,
                 ordered=None, with_stats: bool = False,
                 packet: int = PACKET):
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    ``smask`` selects the mixed form (raytpu's ``packet_query(...,
    smask, mixed=True, shadow_tmin)``), which no engine path calls;
    ``ordered``, ``with_stats`` and ``packet`` as in
    ``packet_query_torch``."""
    if ro.device.type == "cuda":
        return packet_query_cuda(node8_rows, leaf_tris, first, ro, rd, tmax,
                                 tmin, any_hit, smask, shadow_tmin,
                                 ordered=ordered, with_stats=with_stats,
                                 packet=packet)
    return packet_query_torch(node8_rows, leaf_tris, first, ro, rd, tmax,
                              tmin, any_hit, smask=smask,
                              shadow_tmin=shadow_tmin, ordered=ordered,
                              with_stats=with_stats, packet=packet)


# raytpu's packet-kernel VMEM budget (intersect_pallas.py:549-557): the
# BVH8 rows and leaf rows, each padded to 128 lanes, at most 100 MiB
PACKET_TABLE_BUDGET = 100 * 1024 * 1024


def packet_tables_fit(pack) -> bool:
    """raytpu's ``vmem_budget_ok``: the pack has BVH8 rows, and they and
    the leaf rows at 128-lane padding (512 bytes a row) fit
    ``PACKET_TABLE_BUDGET``. ``auto`` routes by it, as raytpu's TPU branch
    does; on the card nothing else depends on it."""
    if pack.bvh.node8_rows is None:  # stream pack (tables dropped)
        return False
    rows = pack.bvh.node8_rows.shape[0] + pack.bvh.leaf_tris.shape[0]
    return rows * 128 * 4 <= PACKET_TABLE_BUDGET


def make_packet_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature over ``pack.bvh.node8_rows``, ties broken on
    ``pack.bvh.first_slots``. tmin is baked: 0.001 for closest-hit and 0.0
    for any-hit; another value raises. On a CUDA pack the kernel's library
    is built or loaded here, on the caller's thread."""
    node8 = pack.bvh.node8_rows.contiguous()
    leaves = pack.bvh.leaf_tris.contiguous()
    first = pack.bvh.first_slots.contiguous()
    if node8.device.type == "cuda":  # build or load here, not at a launch
        _library()

    def closest(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, CLOSEST_TMIN, "packet closest")
        t, tri = packet_query(node8, leaves, first, ro.contiguous(),
                              rd.contiguous(), _per_ray(tmax, ro),
                              CLOSEST_TMIN, False)
        return Hit(t=t, tri=tri, valid=tri >= 0)

    def any_fn(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, ANY_TMIN, "packet any-hit")
        _, tri = packet_query(node8, leaves, first, ro.contiguous(),
                              rd.contiguous(), _per_ray(tmax, ro), ANY_TMIN,
                              True)
        return tri >= 0

    return closest, any_fn
