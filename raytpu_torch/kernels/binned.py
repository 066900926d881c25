"""Binned (treelet) ray queries: the CUDA treelet walk, its plain torch
version, the round loop around it, and the engine's intersector factory.

Replaces ``raytpu/kernels/binned.py:_binned_packet_kernel`` (launched by
``_binned_launch``, driven by ``make_binned_query``, factory
``make_binned_intersectors``). The route serves scenes packed with
treelets (accel/treelets.py): the BVH8 cut into windows of at most a
budget of rows, ``tl_nodes`` [T, Sn, 128] and ``tl_leaves`` [T, Sl, 128]
with window-local links and each triangle's global slot as int32 bits in
leaf column 10k+9.

Per-lane modes, as raytpu's mixed queries have them: a lane with
``smask == 1`` is a shadow lane, any-hit over the closed range
[shadow_tmin, tmax]; every other lane is closest-hit over [tmin, tmax)
(an open bound: the walk's bound starts at ``min(F32_MAX, tmax)`` and a
hit at exactly tmax loses). Dead lanes carry tmax = -inf. Closest-hit ties
break on the tie keys ``first`` (``first_slots`` of the global slots: the
lowest slot holding the same triangle bits), so neither the treelet order
nor the visit order changes t or the triangle; which copy's slot is
returned is the first one tested.

The query (``make_binned_query``), per round:

1. select: every ray takes its nearest treelet, in (entry distance,
   treelet id) order after the one it visited last, whose box it enters
   before its bound (its best t; a blocked shadow ray has none left); the
   box test and the bound are widened by FAR_SCALE, as the walk's box
   test is;
2. bin: the rays with a treelet are sorted by it (a stable argsort: rays
   of one treelet sit in neighbouring threads). raytpu scatters them into
   1024-ray packets that feed a TPU BlockSpec; that schedule has no
   counterpart here, and per-ray results do not depend on it;
3. walk: one ``binned_walk`` launch, one thread per ray over its treelet;
4. fold: closest lanes carry the improved (t, slot) forward, shadow lanes
   their blocked bit. The loop ends when no ray has a treelet left: one
   host sync per round, for the count of rays still walking.

The walk, shared bit for bit by the kernel and the plain version (the
packet walk's, csrc/bvh8_walk.cuh, with raytpu's per-lane arithmetic): the
safe inverse direction (zero components -> +/-1e-36); per popped node a
LIMIT of the lane's best t (its bound for a shadow lane); every child's
slab test ``near = max(max(lox, loy), max(loz, min(tmin, shadow_tmin)))``,
``far = min(min(hix, hiy), min(hiz, LIMIT))``, hit iff ``near <= far *
FAR_SCALE``, with bounds picked by the sign of the inverse direction and
never order-normalised (empty slots carry inverted boxes and miss); the
hit interior children pushed from child 7 down (clamped at STACK_DEPTH - 1
as raytpu does), then the hit leaves' 8 triangles tested from child 0 up.
A closest lane starts from its incoming ``tri0`` (key ``first[tri0]``)
and accepts ``t >= tmin`` and ``t < best_t``, or ``t == best_t`` and a
lower key; it walks until its stack is empty. A shadow lane accepts ``t``
in [shadow_tmin, tmax] and stops at its first blocker; its t stays its
bound (only its blocked bit is contract).

``binned_walk_cuda`` launches ``csrc/binned_walk.cu``;
``binned_walk_torch`` is the plain version. ``binned_walk`` dispatches on
the tensors' device alone.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import span, spanned
from .intersect import F32_MAX, Hit, moller_trumbore
from .strand import (
    ANY_TMIN,
    CLOSEST_TMIN,
    FAR_SCALE,
    _check_baked_tmin,
    _leaf_closest,
    _per_ray,
    _safe_inv,
)

STACK_DEPTH = 256  # per-ray stack slots, raytpu's treelet walk bound
# rays per select chunk are bounded in [chunk, T] ELEMENTS (raytpu's
# SELECT_CHUNK): many-treelet scenes shrink the chunk
SELECT_ELEMS = 1 << 25
_PLAIN_STACK0 = 32  # the plain version's first stack width; it grows

# queries run and rounds walked since the last reset, on either device
# (a plain counter, like the kernels' launch counts)
QUERY_STATS = dict(queries=0, rounds=0, max_rounds=0)


def binned_walk_torch(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask,
                      tri0, tmin: float, shadow_tmin: float,
                      counts: dict | None = None):
    """Plain torch version of the treelet walk. tl_nodes [T, Sn, 128],
    tl_leaves [T, Sl, 128], first [S] i32 (the tie keys of the global
    slots, ``first_slots``), tid [R] i32 (each ray's treelet), ro/rd [R, 3],
    tmax [R], smask [R] (1.0 = shadow lane), tri0 [R] i32 (a closest
    lane's incoming best slot); returns (t [R] f32, tri [R] i32). A ray
    whose tid is out of range returns its starting state. Each loop
    iteration pops one node for every unfinished ray; finished rays leave
    the working set. The stack is a [W, width] tensor whose width grows to
    STACK_DEPTH as pushes need. A ``counts`` dict gains the walk's box
    tests ("boxes"), triangle tests ("tris") and the table bytes it reads,
    each distinct 512-byte node row and the 320 bytes of triangles of each
    distinct leaf row once ("bytes")."""
    dev = ro.device
    n_tl, sn = tl_nodes.shape[0], tl_nodes.shape[1]
    sl = tl_leaves.shape[1]
    kids = tl_nodes.reshape(n_tl * sn, 8, 16)
    boxes = kids[:, :, 0:6]
    links = kids[:, :, 6].contiguous().view(torch.int32)  # [T*Sn, 8]
    tris = tl_leaves.reshape(n_tl * sl, 128)[:, :80].reshape(-1, 8, 10)
    slots = tris[:, :, 9].contiguous().view(torch.int32)  # [T*Sl, 8]
    shadow = smask == 1.0
    tcut = torch.where(shadow, shadow_tmin, tmin).to(torch.float32)
    slab_tmin = min(tmin, shadow_tmin)
    inv = _safe_inv(rd)
    t_out = torch.minimum(torch.full_like(tmax, F32_MAX), tmax)
    tri_out = torch.where(shadow, -1, tri0).to(torch.int32)
    key_in = torch.where(tri_out >= 0, first[tri_out.clamp(min=0).long()], -1)
    tid = tid.long()
    lanes = ((tid >= 0) & (tid < n_tl)).nonzero().squeeze(1)
    w = lanes.numel()
    # the working set: one entry per unfinished ray; the root (local node
    # 0) is on every stack
    s = dict(
        idx=lanes, base=tid[lanes], o=ro[lanes], d=rd[lanes], inv=inv[lanes],
        neg=inv[lanes] < 0.0, shad=shadow[lanes], tcut=tcut[lanes],
        bt=t_out[lanes], btri=tri_out[lanes], bkey=key_in[lanes],
        sp=torch.ones(w, dtype=torch.long, device=dev),
        stack=torch.zeros((w, _PLAIN_STACK0), dtype=torch.int32, device=dev),
    )
    if counts is not None:
        seen_node = torch.zeros(kids.shape[0], dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    for _ in range(sn):
        w = s["idx"].numel()
        if w == 0:
            break
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
        node = s["base"] * sn + s["stack"][lane, s["sp"]].long()
        if counts is not None:
            seen_node[node] = True
        kb = boxes[node]  # [W, 8, 6]
        kl = links[node]  # [W, 8]
        # every child's box against the LIMIT of the pop, as the TPU kernel
        # reads it once per popped node
        neg = s["neg"][:, None, :]
        lo = (torch.where(neg, kb[..., 3:6], kb[..., 0:3])
              - s["o"][:, None, :]) * s["inv"][:, None, :]
        hi = (torch.where(neg, kb[..., 0:3], kb[..., 3:6])
              - s["o"][:, None, :]) * s["inv"][:, None, :]
        near = torch.maximum(
            torch.maximum(lo[..., 0], lo[..., 1]),
            torch.maximum(lo[..., 2], torch.full_like(lo[..., 2], slab_tmin)),
        )
        far = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                            torch.minimum(hi[..., 2], s["bt"][:, None]))
        hit = near <= far * FAR_SCALE
        inner = hit & (kl >= 0) & (kl < sn)
        at_leaf = hit & (kl < 0) & (~kl < sl)
        # interior children from child 7 down, so child 0 is popped next
        for j in range(7, -1, -1):
            push = inner[:, j]
            if bool(push.any()):
                slot = torch.clamp(s["sp"], max=STACK_DEPTH - 1)
                s["stack"][lane[push], slot[push]] = kl[push, j]
                s["sp"] = torch.clamp(s["sp"] + push.long(),
                                      max=STACK_DEPTH - 1)
        # then the hit leaves from child 0 up
        walking = torch.ones(w, dtype=torch.bool, device=dev)
        for j in range(8):
            at = at_leaf[:, j] & walking
            if not bool(at.any()):
                continue
            li = at.nonzero().squeeze(1)
            row = s["base"][li] * sl + (~kl[li, j]).long()
            if counts is not None:
                counts["tris"] = counts.get("tris", 0) + 8 * li.numel()
                seen_leaf[row] = True
            tri = tris[row]  # [L, 8, 10]
            t, _, _, ok = moller_trumbore(
                s["o"][li][:, None, :], s["d"][li][:, None, :],
                tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9],
                s["tcut"][li][:, None], torch.inf,
            )
            gslot = slots[row]  # [L, 8]
            bt, bi, bk = s["bt"][li], s["btri"][li], s["bkey"][li]
            shd = s["shad"][li]
            # a shadow lane's first accepted triangle (t <= tmax) blocks
            # it and ends its walk; its t stays its bound
            sok = ok & (t <= bt[:, None])
            k = sok.to(torch.int32).argmax(dim=1)
            blocked = shd & sok.any(dim=1)
            # a closest lane keeps the smallest (t, first[slot]) pair
            found, mt, ms, mk = _leaf_closest(ok, t, gslot,
                                              first[gslot.long()])
            acc = ~shd & found & ((mt < bt) | ((mt == bt) & (mk < bk)))
            s["bt"][li] = torch.where(acc, mt, bt)
            s["btri"][li] = torch.where(
                blocked, gslot.gather(1, k[:, None])[:, 0],
                torch.where(acc, ms, bi))
            s["bkey"][li] = torch.where(acc, mk, bk)
            walking[li] = ~blocked
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
    return t_out, tri_out


def _check_walk_inputs(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask,
                       tri0):
    """Raise ValueError unless every input is a contiguous tensor of the
    walk's dtype and shape on one device."""
    dev = ro.device
    r = ro.shape[0]
    for name, x, dtype, shape in (
        ("tl_nodes", tl_nodes, torch.float32, (None, None, 128)),
        ("tl_leaves", tl_leaves, torch.float32, (tl_nodes.shape[0], None,
                                                 128)),
        ("first", first, torch.int32, (None,)),
        ("tid", tid, torch.int32, (r,)),
        ("ro", ro, torch.float32, (r, 3)),
        ("rd", rd, torch.float32, (r, 3)),
        ("tmax", tmax, torch.float32, (r,)),
        ("smask", smask, torch.float32, (r,)),
        ("tri0", tri0, torch.int32, (r,)),
    ):
        if (x.dtype != dtype or x.device != dev or not x.is_contiguous()
                or x.dim() != len(shape)
                or any(want is not None and got != want
                       for got, want in zip(x.shape, shape))):
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape "
                f"{tuple('*' if d is None else d for d in shape)} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if tl_nodes.shape[1] == 0 or tl_leaves.shape[1] == 0:
        raise ValueError("treelet windows must hold at least one row each")


_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    from ._build import LOCK, load_library

    with LOCK:
        if _LIB is None:
            lib = load_library("binned_walk")
            lib.binned_walk_launch.restype = ctypes.c_int
            lib.binned_walk_launch.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_void_p]
            )
            lib.binned_walk_error_string.restype = ctypes.c_char_p
            lib.binned_walk_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


@spanned("raytpu::kernels.binned")
def binned_walk_cuda(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask,
                     tri0, tmin: float, shadow_tmin: float):
    """Launch ``csrc/binned_walk.cu`` on the current stream (one thread per
    ray, blocks of 128). Same signature and results as
    ``binned_walk_torch``; raises on bad inputs or a failed launch.
    ``binned_walk_cuda.launches`` counts the launches."""
    if ro.device.type != "cuda":
        raise ValueError(f"binned_walk_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    _check_walk_inputs(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask,
                       tri0)
    lib = _library()
    r = ro.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    tri = torch.empty(r, dtype=torch.int32, device=ro.device)
    if r == 0:
        return t, tri
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.binned_walk_launch(
            tl_nodes.data_ptr(), tl_leaves.data_ptr(), first.data_ptr(),
            tid.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), tmax.data_ptr(), smask.data_ptr(),
            tri0.data_ptr(), t.data_ptr(), tri.data_ptr(), r,
            tl_nodes.shape[0], tl_nodes.shape[1], tl_leaves.shape[1],
            float(tmin), float(shadow_tmin), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "binned_walk launch failed: "
            + lib.binned_walk_error_string(rc).decode()
        )
    binned_walk_cuda.launches += 1
    return t, tri


binned_walk_cuda.launches = 0


def binned_walk(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask, tri0,
                tmin: float, shadow_tmin: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = binned_walk_cuda if ro.device.type == "cuda" else binned_walk_torch
    return fn(tl_nodes, tl_leaves, first, tid, ro, rd, tmax, smask, tri0,
              tmin, shadow_tmin)


def make_binned_query(pack, max_rounds: int | None = None):
    """Mixed-mode query over the pack's treelet tables with the engine's
    mixed signature: (ro [R,3], rd [R,3], tmax [R], smask [R], tmin=,
    shadow_tmin=) -> (t [R], tri [R]). Shadow lanes return t =
    min(F32_MAX, tmax) and tri >= 0 iff blocked.

    ``max_rounds`` truncates the round loop (diagnostics only: results are
    exact only when the loop runs to its end). raytpu's ``packet`` (rays
    per TPU packet) has no counterpart: rays are sorted by treelet and
    walked one thread each. On a CUDA pack the kernel's library is built or
    loaded here, on the caller's thread."""
    tnodes = pack.tl_nodes.contiguous()
    tleaves = pack.tl_leaves.contiguous()
    first = pack.bvh.first_slots.contiguous()
    tb_min = pack.tl_bmin
    tb_max = pack.tl_bmax
    n_tl = tnodes.shape[0]
    chunk = max(4096, min(262144, (SELECT_ELEMS // max(n_tl, 1)) // 128 * 128))
    if tnodes.device.type == "cuda":  # build or load here, not at a launch
        _library()

    def query(ro, rd, tmax, smask, *, tmin: float, shadow_tmin: float):
        dev = ro.device
        r = ro.shape[0]
        ro = ro.contiguous()
        rd = rd.contiguous()
        tmax = tmax.to(torch.float32).contiguous()
        smask = smask.to(torch.float32).contiguous()
        inv = _safe_inv(rd)
        shadow = smask == 1.0
        tcut = torch.where(shadow, shadow_tmin, tmin).to(torch.float32)
        tids = torch.arange(n_tl, device=dev)
        best_t = torch.minimum(torch.full_like(tmax, F32_MAX), tmax)
        best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
        last_t = torch.full((r,), -torch.inf, device=dev)
        last_tid = torch.full((r,), -1, dtype=torch.long, device=dev)

        def select(rays):
            """Each of ``rays``' next treelet in (entry, id) order that can
            still matter: (treelet [n] i64, entry t [n], valid [n]).
            Chunked so the temporaries are [chunk, T], never [n, T, 3]."""
            sel, sel_t = [], []
            for c in torch.split(rays, chunk):
                near = tcut[c][:, None].expand(-1, n_tl)
                far = tmax[c][:, None].expand(-1, n_tl)
                for a in range(3):
                    o = ro[c, a][:, None]
                    iv = inv[c, a][:, None]
                    lo = (tb_min[None, :, a] - o) * iv
                    hi = (tb_max[None, :, a] - o) * iv
                    near = torch.maximum(near, torch.minimum(lo, hi))
                    far = torch.minimum(far, torch.maximum(lo, hi))
                bound = torch.where(
                    shadow[c],
                    torch.where(best_tri[c] >= 0, -torch.inf, tmax[c]),
                    best_t[c])
                lt = last_t[c][:, None]
                later = tids[None, :] > last_tid[c][:, None]
                after = (near > lt) | ((near == lt) & later)
                # the walk's conservative box test, on the treelet's box
                # and on the ray's bound
                ok = ((near <= far * FAR_SCALE) & after
                      & (near <= bound[:, None] * FAR_SCALE))
                key = torch.where(ok, near, torch.inf)
                s = torch.argmin(key, dim=1)
                sel.append(s)
                sel_t.append(key.gather(1, s[:, None])[:, 0])
            sel = torch.cat(sel)
            sel_t = torch.cat(sel_t)
            return sel, sel_t, sel_t < torch.inf

        rays = torch.arange(r, device=dev)
        sel, sel_t, valid = select(rays)
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            # rays without a treelet never get one back: drop them (the
            # host waits for the count of those that stay)
            with span("raytpu::kernels.sync.binned_rays"):
                keep = valid.nonzero()[:, 0]
            rays, sel, sel_t = rays[keep], sel[keep], sel_t[keep]
            if rays.numel() == 0:
                break
            order = torch.sort(sel, stable=True)[1]
            g = rays[order]
            t_o, tri_o = binned_walk(
                tnodes, tleaves, first, sel[order].to(torch.int32), ro[g],
                rd[g],
                torch.where(shadow[g], tmax[g], best_t[g]), smask[g],
                best_tri[g], tmin, shadow_tmin)
            # shadow lanes keep t = tmax; closest lanes carry the
            # improved bound forward
            best_t[g] = torch.where(shadow[g], best_t[g], t_o)
            best_tri[g] = tri_o
            last_t[rays] = sel_t
            last_tid[rays] = sel
            rounds += 1
            sel, sel_t, valid = select(rays)
        QUERY_STATS["queries"] += 1
        QUERY_STATS["rounds"] += rounds
        QUERY_STATS["max_rounds"] = max(QUERY_STATS["max_rounds"], rounds)
        return best_t, best_tri

    return query


def make_binned_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature, both over the binned query. tmin is baked: 0.001 for
    closest-hit and 0.0 for any-hit; another value raises."""
    query = make_binned_query(pack)

    def closest(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, CLOSEST_TMIN, "binned closest")
        t, tri = query(ro, rd, _per_ray(tmax, ro),
                       torch.zeros(ro.shape[0], device=ro.device),
                       tmin=CLOSEST_TMIN, shadow_tmin=ANY_TMIN)
        return Hit(t=t, tri=tri, valid=tri >= 0)

    def any_fn(ro, rd, tmin, tmax):
        _check_baked_tmin(tmin, ANY_TMIN, "binned any-hit")
        _, tri = query(ro, rd, _per_ray(tmax, ro),
                       torch.ones(ro.shape[0], device=ro.device),
                       tmin=CLOSEST_TMIN, shadow_tmin=ANY_TMIN)
        return tri >= 0

    return closest, any_fn
