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
  strand layout's. ``ribbon_k`` = K (1..8, raytpu's sub-steps per
  fetched row): K = 1 loads one 32-byte record a step; K >= 2 is the
  K-wide fetch, a template case of the same walk: a lane fetches a window
  of up to K consecutive records of its 16-node row (cut at the row's end
  and at the node count) and steps inside it while its cursor stays
  there, fetching anew at a cursor outside (the schedule form, below,
  fetches the same windows under its pool). On the card a fetch loads
  the window's 128-byte lines into L1, one 4-byte load a line (the line
  of the cursor's own record comes with its load), and each step loads
  its record from there, so the window costs no registers; a window held
  in registers or in shared memory measured slower (PERF.md). The factories
  read ``RAYTPU_RIBBON`` = K once, as raytpu's do.
* ``stats=True`` also returns int32 [8] counters in raytpu's order
  (``strand_query_persistent(stats=True)``: iterations, flushes, services,
  installs, leaf pops, enqueues, 0, 0), with the per-ray walk's meanings:
  [0] node records loaded (windows fetched under the K-wide fetch),
  summed over rays; [1] 0 (no leaf queue: a lane
  tests a leaf when it reaches it); [2] 0 (no walker pool to refill: the
  launch grid schedules the warps); [3] ``ceil(R / 128)``, raytpu's count
  of 128-ray strands, each installed once; [4] leaf rows tested and [5]
  leaf rows reached, each summed over rays (equal here). A dead lane (tmax
  = -inf) loads the root record and stops. Each counter is an int32 sum
  that wraps past 2^31 - 1 (a 1080p wave loads about 10^8 records); the
  kernel sums each block's 4 warps in shared memory and adds the block's
  sums with one atomic a counter, and integer sums do not depend on
  order, so the plain version reproduces them bit for bit.

The schedule form (``csrc/strand_common.cuh:sched_kernel``, which sets out
its order step for step) is raytpu's persistent schedule on the per-ray
walk. Every per-ray form takes raytpu's keywords (``walkers``,
``service_k``, ``flush_occ``, ``pipe``, ``unroll``, ``ctl_every``,
``flush_pop``, ``dual``, ``fetch_smem``, ``smem_cur``, ``smem_pend``,
``tree_any``); with none given it is the while-while walk above, with any
given the rest take raytpu's kernel defaults (``SCHEDULE_DEFAULTS``) and
raytpu's assertions raise ValueError (``_schedule``). On the card:

* ``walkers`` is checked as raytpu checks it (>= 1, even under ``dual``)
  and adds no code: the grid is persistent and fills the blocks the card
  holds resident for the instance, whatever the pool's size (one block a
  claim where the launch has fewer claims);
* ``service_k``: a claim is ``service_k`` consecutive batches of 32 rays
  (64 under ``dual``) taken with one atomic for a block, whose warps take
  its batches one at a time, so one claim's batches run in parallel;
  claims (counter [2]) are ``ceil(batches / service_k)`` whichever block
  takes them;
* ``flush_occ``, ``flush_pop``, ``ctl_every``, ``unroll``: a lane queues
  the leaves it reaches (at most ``QCAP``, then it stalls) and walks on;
  every ``ctl_every`` iterations of ``unroll`` steps the warp votes, and a
  leaf round fires at ``max(int(flush_occ * 32), 1)`` queued lanes (of 64
  under ``dual``), when no lane walks on, or at a full queue, popping up
  to ``flush_pop`` leaves a lane;
* ``pipe``: both successors of the held record load before its box test;
  ``dual``: two rays a thread; ``fetch_smem``: the top ``TOP_NODES``
  nodes, all octants, staged in shared memory a block; over ribbon rows
  (``rpo > 0``) a fetch loads ``ribbon_k`` records of the row at once into
  the lane's window in shared memory and the in-row steps read them
  there;
* ``tree_any`` (tables past raytpu's VMEM budget) selects the pipelined
  form, as raytpu's assertions require: every table is in global memory
  on the card, so it adds nothing else. ``smem_cur`` and ``smem_pend``
  mirror values into the TPU's scalar memory; a thread keeps its cursor
  and popped leaf in registers, so they are normalised and checked
  only.

Its ``stats`` counters: [0] records loaded (fetches over ribbon rows),
[1] leaf rounds, [2] pool claims, [3] batches installed, [4] leaf rows
tested, [5] leaves enqueued, [6], [7] 0. Deferral only delays when a best
t shrinks, so t and the tie key are the while-while walk's, and an any-hit
lane's blocked bit; the plain version (``_sched_torch``) replays the
warp's lock-step, so it also returns the kernel's ``tri`` on any-hit lanes
and every counter. ``make_strand_intersectors`` and
``make_strand_mixed_query`` pass the keywords as raytpu's factories do,
from raytpu's variables (``_route``).

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
``defer=True`` runs its deferral form (``csrc/strand_common.cuh:
defer_kernel``; ``_defer_torch``): raytpu's per-walker leaf queue at
``groups`` strands a block (raytpu's walkers = 8 x groups), rounds when
every walker is queued or done or a queue is full, and ``skip_done``
(idle walkers skip their loads); its stats add each block's leaf rounds.
raytpu's ``multiroll`` batches the octant roll of a TPU tile; each lane
reads its own record on the card, so the keyword is accepted and adds no
code.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..obs import span, spanned
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
    """The per-ray walk's int32 [8] counters from a plain walk's counts:
    [0] its records loaded, or its windows under the K-wide fetch."""
    leaves = counts.get("tris", 0) // 8
    return torch.tensor(
        [wrap_i32(v) for v in (counts.get("fetches",
                                          counts.get("boxes", 0)), 0, 0,
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
                       ribbon_k: int = 4, stats: bool = False, **schedule):
    """Plain torch version of the strand walk. ``first`` is
    ``first_slots(leaf_tris)``, ro/rd [R,3], tmax [R]; returns (t [R] f32,
    tri [R] i32), and with ``stats`` the int32 [8] counters (module
    docstring). ``rpo > 0`` walks ribbon rows (``strand_rows`` is then
    ``BvhPack.ribbon_rows``; ``ribbon_k`` >= 2 only changes what stats[0]
    counts: the K-wide fetch's windows). Each loop
    iteration advances every unfinished ray by one node; finished rays
    leave the working set (a dead lane, tmax = -inf, after the root).
    A ``counts`` dict gains the walk's box tests ("boxes"), triangle tests
    ("tris") and the table bytes it reads, each distinct 32-byte node
    record and 320-byte leaf row once ("bytes"). raytpu's schedule
    keywords (``walkers``, ``service_k``, ``flush_occ``, ``pipe``,
    ``unroll``, ``ctl_every``, ``flush_pop``, ``dual``, ``fetch_smem``,
    ``smem_cur``, ``smem_pend``, ``tree_any``; module docstring) replay
    the schedule form instead."""
    shad = torch.full((ro.shape[0],), any_hit, dtype=torch.bool,
                      device=ro.device)
    return _walk_torch(strand_rows, leaf_tris, first, ro, rd, tmax, shad,
                       tmin, tmin, counts, rpo, ribbon_k, stats,
                       _schedule(rpo, _n_nodes(strand_rows, rpo), **schedule))


def strand_mixed_query_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                             smask, tmin: float, shadow_tmin: float,
                             counts: dict | None = None, *, rpo: int = 0,
                             ribbon_k: int = 4, stats: bool = False,
                             **schedule):
    """Plain torch version of the strand walk's mixed form (raytpu's
    ``strand_query_persistent(..., mixed=True)``): ``smask`` [R] == 1.0
    flags a shadow lane, any-hit over [shadow_tmin, tmax] (its t returns
    tmax); every other lane is closest-hit over [tmin, tmax) with the tie
    keys ``first``. Every lane's slab test uses min(tmin, shadow_tmin).
    Returns (t [R] f32, tri [R] i32); ``counts``, ``rpo``, ``ribbon_k``,
    ``stats`` and the schedule keywords as in ``strand_query_torch``."""
    return _walk_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                       smask == 1.0, tmin, shadow_tmin, counts, rpo,
                       ribbon_k, stats,
                       _schedule(rpo, _n_nodes(strand_rows, rpo), **schedule))


def _walk_torch(rows, leaf_tris, first, ro, rd, tmax, shad, tmin: float,
                shadow_tmin: float, counts: dict | None, rpo: int = 0,
                ribbon_k: int = 4, stats: bool = False, sched=None):
    """The per-ray walk of every form, per lane: ``shad`` [R] bool lanes
    are any-hit from ``shadow_tmin`` (LIMIT = tmax), the others
    closest-hit from ``tmin`` (LIMIT = best t from min(F32_MAX, tmax));
    the slab test uses min(tmin, shadow_tmin). The closest-hit and any-hit
    forms pass shadow_tmin = tmin. The kernel's arithmetic in its order
    (csrc/strand_common.cuh:walk_kernel), over strand rows (``rpo`` 0) or
    ribbon rows; with ``sched`` (``_schedule``'s record) the schedule
    form's lock-step replay (``_sched_torch``). On ribbon rows with
    ``ribbon_k`` >= 2 the counts gain "fetches", the K-wide fetch's
    windows: a lane keeps the window [wb, wb + wn) it fetched last and
    fetches anew when its cursor lies outside (walk_kernel's rule), so its
    fetches follow its own walk alone."""
    _check_layout(rows, rpo, ribbon_k)
    if sched is not None:
        return _sched_torch(rows, leaf_tris, first, ro, rd, tmax, shad,
                            tmin, shadow_tmin, counts, rpo, ribbon_k, stats,
                            sched)
    # this walk's own counts, added to the caller's dict at the end
    into, counts = counts, ({} if stats or counts is not None else None)
    dev = ro.device
    r = ro.shape[0]
    # strand layout: node c, octant o at record 8c + o; ribbon layout:
    # octant o's node j at record o * rpo * 16 + j
    recs = rows.reshape(-1, 8)
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = _n_nodes(rows, rpo)
    s = _lane_state(ro, rd, tmax, shad, tmin, shadow_tmin, rpo)
    slab_tmin = min(tmin, shadow_tmin)
    any_lanes = bool(shad.any())
    closest_lanes = not bool(shad.all())
    t_out = torch.empty(r, dtype=torch.float32, device=dev)
    tri_out = torch.empty(r, dtype=torch.int32, device=dev)
    s["cur"] = torch.zeros(r, dtype=torch.long, device=dev)
    window = rpo > 0 and ribbon_k >= 2 and counts is not None
    if counts is not None:
        seen_rec = torch.zeros(recs.shape[0], dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    if window:  # the window each lane holds: none yet
        s["wb"] = torch.zeros(r, dtype=torch.long, device=dev)
        s["wn"] = torch.zeros(r, dtype=torch.long, device=dev)
        counts["fetches"] = 0
    for _ in range(n_nodes):
        if s["idx"].numel() == 0:
            break
        ri = _rec_index(s, s["cur"], rpo)
        if counts is not None:
            counts["boxes"] = counts.get("boxes", 0) + s["idx"].numel()
            seen_rec[ri] = True
        if window:
            j = s["cur"] - s["wb"]
            new = (j < 0) | (j >= s["wn"])
            c = s["cur"][new]
            s["wb"][new] = c
            s["wn"][new] = torch.minimum(
                torch.minimum(torch.full_like(c, ribbon_k),
                              RIBBON_NODES - c % RIBBON_NODES), n_nodes - c)
            counts["fetches"] += int(new.sum())
        rec = recs[ri]
        box = _box_test(s, rec, slab_tmin, s["bt"])
        hit_link = rec[:, 6].long()
        nxt = torch.where(box & (hit_link >= 0), hit_link, rec[:, 7].long())
        at_leaf = box & (hit_link < 0)
        if bool(at_leaf.any()):
            li = at_leaf.nonzero().squeeze(1)
            lr = (~hit_link[li]).to(torch.int32)
            if counts is not None:
                counts["tris"] = counts.get("tris", 0) + 8 * li.numel()
                seen_leaf[lr.long()] = True
            blocked = _leaf_test(s, li, lr, tris, first, closest_lanes,
                                 any_lanes)
            nxt[li] = torch.where(blocked, -1, nxt[li])
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


def _lane_state(ro, rd, tmax, shad, tmin: float, shadow_tmin: float,
                rpo: int) -> dict:
    """The per-ray walks' per-lane state: the rays, the octant (as a record
    offset: the octant, or its first ribbon record), the any-hit flag and
    tmin, and the best (t, tri, key) as each walk starts it."""
    dev = ro.device
    r = ro.shape[0]
    tmax = tmax.to(torch.float32)
    inv = _safe_inv(rd)
    octant = ((rd[:, 0] < 0).long() + 2 * (rd[:, 1] < 0).long()
              + 4 * (rd[:, 2] < 0).long())
    # an any-hit lane's best t is its LIMIT, tmax, and never changes
    best_t = torch.where(shad, tmax,
                         torch.minimum(torch.full_like(tmax, F32_MAX), tmax))
    return dict(
        idx=torch.arange(r, device=dev), o=ro, d=rd, inv=inv, neg=inv < 0.0,
        oct=octant * (rpo * RIBBON_NODES) if rpo else octant, shad=shad,
        tcut=torch.where(shad, shadow_tmin, tmin).to(torch.float32),
        bt=best_t,
        btri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        bkey=torch.full((r,), -1, dtype=torch.int32, device=dev),
    )


def _rec_index(s: dict, cur, rpo: int):
    """Record index of node ``cur`` in each lane's octant."""
    return s["oct"] + cur if rpo else cur * 8 + s["oct"]


def _box_test(s: dict, rec, slab_tmin: float, limit):
    """The kernels' conservative slab test of each lane against its record
    ``rec`` [n, 8] with LIMIT ``limit`` [n]."""
    lo = (torch.where(s["neg"], rec[:, 3:6], rec[:, 0:3]) - s["o"]) * s["inv"]
    hi = (torch.where(s["neg"], rec[:, 0:3], rec[:, 3:6]) - s["o"]) * s["inv"]
    near = torch.maximum(
        torch.maximum(lo[:, 0], lo[:, 1]),
        torch.maximum(lo[:, 2], torch.full_like(lo[:, 2], slab_tmin)),
    )
    far = torch.minimum(
        torch.minimum(hi[:, 0], hi[:, 1]),
        torch.minimum(hi[:, 2], limit),
    )
    return near <= far * FAR_SCALE


def _leaf_test(s: dict, li, lr, tris, first, closest_lanes: bool,
               any_lanes: bool):
    """Lanes ``li`` test leaf rows ``lr`` (8 slots in order) against their
    best: s's bt/btri/bkey are updated in place; returns which of them an
    any-hit lane's first accepted slot blocked."""
    k8 = torch.arange(8, device=lr.device, dtype=torch.int32)
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
    blocked = torch.zeros_like(sh)
    if closest_lanes:
        found, mt, ms, mk = _leaf_closest(ok, t, slot, first[slot.long()])
        acc = ~sh & found & ((mt < bt) | ((mt == bt) & (mk < bk)))
        s["bt"][li] = torch.where(acc, mt, bt)
        ti = torch.where(acc, ms, bi)
        tk = torch.where(acc, mk, bk)
    if any_lanes:
        # the first accepted triangle blocks and ends the walk
        blocked = sh & ok.any(dim=1)
        k = ok.to(torch.int32).argmax(dim=1)
        ti = torch.where(blocked, slot.gather(1, k[:, None])[:, 0], ti)
    s["btri"][li] = ti
    s["bkey"][li] = tk
    return blocked


# the schedule form (csrc/strand_common.cuh:sched_kernel): leaves a lane
# can queue, nodes staged in shared memory under fetch_smem, and the fetch
# forms' codes (strand_common.cuh:Fetch)
QCAP = 4
TOP_NODES = 64
LOAD, PIPE, DUAL, WIDE = 0, 1, 2, 3
FETCH_NAMES = {LOAD: "load", PIPE: "pipe", DUAL: "dual", WIDE: "wide"}
# raytpu's schedule keywords (strand_query_persistent's) and its kernel's
# defaults for them
SCHEDULE_DEFAULTS = dict(walkers=128, service_k=16, flush_occ=0.75,
                         pipe=False, unroll=1, ctl_every=1, flush_pop=1,
                         dual=False, fetch_smem=False, smem_cur=False,
                         smem_pend=False, tree_any=False)
BLOCK_QCAP = 16  # rows a walker of the block walk's deferral form queues


def _schedule(rpo: int, n_nodes: int, **given) -> dict | None:
    """The schedule form's record from raytpu's keywords, or None (the
    while-while walk) when none is given. Unset keywords take raytpu's
    kernel defaults (``SCHEDULE_DEFAULTS``); raytpu's assertions
    (``strand_persistent.py:118-164``) raise ValueError. ``walkers``,
    ``smem_cur`` and ``smem_pend`` are normalised and checked as raytpu
    does, and add no code: the card's grid fills its resident capacity
    whatever the pool's size, and a thread keeps its cursor and its popped
    leaf in registers (the TPU's scalar unit holds them), so none of them
    is in the record."""
    unknown = set(given) - set(SCHEDULE_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown schedule keywords {sorted(unknown)}")
    if all(v is None for v in given.values()):
        return None
    k = {name: (default if given.get(name) is None else given[name])
         for name, default in SCHEDULE_DEFAULTS.items()}
    ribbon = rpo > 0
    pipe = bool(k["pipe"])
    smem_cur = bool(k["smem_cur"]) and not pipe  # raytpu's normalisation
    unroll, ctl = int(k["unroll"]), int(k["ctl_every"])
    pop = int(k["flush_pop"])
    walkers, service_k = int(k["walkers"]), int(k["service_k"])
    checks = (
        (1 <= unroll <= 64, f"unroll={unroll}: want 1..64"),
        (unroll == 1 or (pipe and not ribbon),
         "unroll > 1 requires pipe=True and the strand (non-ribbon) layout"),
        (ctl >= 1 and ctl & (ctl - 1) == 0,
         f"ctl_every={ctl}: want a power of two"),
        (pop >= 1, f"flush_pop={pop}: want >= 1"),
        (pop == 1 or not k["smem_pend"],
         "smem_pend defers exactly one pend set; multi-pop needs the "
         "in-line leaf phase"),
        (not k["tree_any"] or (pipe and not ribbon and not smem_cur),
         "tree_any requires the pipelined strand (non-ribbon) layout"),
        (not k["dual"] or (pipe and not ribbon and walkers % 2 == 0),
         "dual requires the pipelined strand layout and an even pool"),
        (not k["fetch_smem"] or (pipe and not ribbon and not smem_cur),
         "fetch_smem requires the pipelined strand layout"),
        (walkers >= 1 and service_k >= 1,
         f"walkers={walkers}, service_k={service_k}: want >= 1"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    fetch = WIDE if ribbon else DUAL if k["dual"] else PIPE if pipe else LOAD
    lanes = 64 if fetch == DUAL else 32
    return dict(fetch=fetch, service_k=service_k,
                occ=max(int(float(k["flush_occ"]) * lanes), 1),
                flush_pop=pop, ctl_every=ctl, unroll=unroll,
                n_top=min(TOP_NODES, n_nodes) if k["fetch_smem"] else 0)


def _sched_torch(rows, leaf_tris, first, ro, rd, tmax, shad, tmin: float,
                 shadow_tmin: float, counts: dict | None, rpo: int,
                 ribbon_k: int, stats: bool, sched: dict):
    """Plain version of the schedule form: its lock-step, replayed for
    every batch of 32 rays (64 under dual) at once, step for step as
    csrc/strand_common.cuh:sched_kernel sets it out (which lanes step, when
    a queue stalls a lane, when the vote runs and fires, the stack's pop
    order), with walk_kernel's arithmetic. Batches share no state, so the
    pool's order of claims changes nothing: claims are ceil(batches /
    service_k) and installs the batches. Returns as ``_walk_torch``; the
    counters are the form's (module docstring)."""
    into, counts = counts, ({} if stats or counts is not None else None)
    dev = ro.device
    r = ro.shape[0]
    fetch = sched["fetch"]
    lanes = 64 if fetch == DUAL else 32
    n_b = -(-r // lanes)
    pad = n_b * lanes - r
    recs = rows.reshape(-1, 8)
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = _n_nodes(rows, rpo)
    n_leaf_rows = leaf_tris.shape[0]
    if pad:  # lanes past the rays: never step (the kernel's non-real lanes)
        ro = torch.cat([ro, ro.new_zeros((pad, 3))])
        rd = torch.cat([rd, rd.new_ones((pad, 3))])
        tmax = torch.cat([tmax.to(torch.float32),
                          tmax.new_full((pad,), -F32_MAX,
                                        dtype=torch.float32)])
        shad = torch.cat([shad, shad.new_zeros(pad)])
    s = _lane_state(ro, rd, tmax, shad, tmin, shadow_tmin, rpo)
    slab_tmin = min(tmin, shadow_tmin)
    any_lanes = bool(shad.any())
    closest_lanes = not bool(shad.all())
    real = torch.arange(n_b * lanes, device=dev) < r
    s.update(c=torch.where(real, 0, -1),
             steps=torch.zeros(n_b * lanes, dtype=torch.long, device=dev),
             qn=torch.zeros(n_b * lanes, dtype=torch.long, device=dev),
             q=torch.full((n_b * lanes, QCAP), -1, dtype=torch.long,
                          device=dev))
    t_out = torch.empty(n_b * lanes, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n_b * lanes, dtype=torch.int32, device=dev)
    n = dict(loads=0, rounds=0, tests=0, enq=0, boxes=0)
    seen_rec = torch.zeros(recs.shape[0], dtype=torch.bool, device=dev)
    seen_leaf = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)

    def walkable():
        return (s["c"] >= 0) & (s["c"] < n_nodes) & (s["steps"] < n_nodes)

    def step(go):
        """Lanes ``go`` take one step: box test, then descend, push the
        leaf, or take the miss link."""
        li = go.nonzero().squeeze(1)
        sub = {key: val[li] for key, val in s.items()}
        ri = _rec_index(sub, sub["c"], rpo)
        rec = recs[ri]
        if fetch in (PIPE, DUAL):  # both successors load before the test
            for link in (rec[:, 6].long(), rec[:, 7].long()):
                ok = (link >= 0) & (link < n_nodes)
                n["loads"] += int(ok.sum())
                seen_rec[_rec_index(sub, link, rpo)[ok]] = True
        n["boxes"] += li.numel()
        box = _box_test(sub, rec, slab_tmin, sub["bt"])
        hl = rec[:, 6].long()
        nxt = torch.where(box & (hl >= 0), hl, rec[:, 7].long())
        leaf = box & (hl < 0) & (~hl < n_leaf_rows)
        s["steps"][li] += 1
        s["c"][li] = nxt
        if bool(leaf.any()):
            lj = li[leaf]
            q = s["q"][lj]
            s["q"][lj] = torch.cat([(~hl[leaf])[:, None], q[:, :-1]], 1)
            s["qn"][lj] += 1
            n["enq"] += lj.numel()

    def pop_test(pop):
        """Lanes ``pop`` pop their queue's head and test that leaf."""
        li = pop.nonzero().squeeze(1)
        lr = s["q"][li, 0].to(torch.int32)
        s["q"][li] = torch.cat([s["q"][li, 1:], s["q"][li, -1:]], 1)
        s["qn"][li] -= 1
        n["tests"] += li.numel()
        seen_leaf[lr.long()] = True
        blocked = _leaf_test(s, li, lr, tris, first, closest_lanes,
                             any_lanes)
        if bool(blocked.any()):  # blocked: stop, drop the queue
            s["c"][li[blocked]] = -1
            s["qn"][li[blocked]] = 0

    if fetch in (PIPE, DUAL):  # each real lane loads its root record
        n["loads"] += int(real.sum())
        seen_rec[_rec_index(s, s["c"].clamp(min=0), rpo)[real]] = True
    it = 0
    while s["idx"].numel():
        if fetch == WIDE:
            go = walkable() & (s["qn"] < QCAP)
            base = s["c"].clone()
            width = torch.zeros_like(base)
            if bool(go.any()):
                c = base[go]
                width[go] = torch.minimum(
                    torch.minimum(torch.full_like(c, ribbon_k),
                                  RIBBON_NODES - c % RIBBON_NODES),
                    n_nodes - c)
                n["loads"] += int(go.sum())
                for j in range(ribbon_k):
                    inside = width[go] > j
                    seen_rec[_rec_index({"oct": s["oct"][go]}, c + j,
                                        rpo)[inside]] = True
            for _ in range(ribbon_k):
                j = s["c"] - base
                go = (walkable() & (s["qn"] < QCAP) & (j >= 0)
                      & (j < width))
                if not bool(go.any()):
                    break
                step(go)
        else:
            for _ in range(sched["unroll"]):
                go = walkable() & (s["qn"] < QCAP)
                if not bool(go.any()):
                    break
                if fetch == LOAD:
                    n["loads"] += int(go.sum())
                    seen_rec[_rec_index(s, s["c"], rpo)[go]] = True
                step(go)
        if it % sched["ctl_every"] == 0:
            queued = (s["qn"] > 0).view(-1, lanes)
            n_q = queued.sum(1)
            live = walkable().view(-1, lanes).any(1)
            full = (s["qn"] >= QCAP).view(-1, lanes).any(1)
            fire = (n_q > 0) & ((n_q >= sched["occ"]) | ~live | full)
            n["rounds"] += int(fire.sum())
            fire = fire.repeat_interleave(lanes)
            for _ in range(sched["flush_pop"]):
                pop = fire & (s["qn"] > 0)
                if not bool(pop.any()):
                    break
                pop_test(pop)
        done = ~(walkable() | (s["qn"] > 0)).view(-1, lanes).any(1)
        if bool(done.any()):
            d = done.repeat_interleave(lanes)
            t_out[s["idx"][d]] = s["bt"][d]
            tri_out[s["idx"][d]] = s["btri"][d]
            s = {key: val[~d] for key, val in s.items()}
        it += 1
    if counts is not None:
        counts["boxes"] = counts.get("boxes", 0) + n["boxes"]
        counts["tris"] = counts.get("tris", 0) + 8 * n["tests"]
        counts["bytes"] = (32 * int(seen_rec.sum())
                           + 320 * int(seen_leaf.sum()))
    if into is not None:
        for key, val in counts.items():
            into[key] = into.get(key, 0) + val
    t_out, tri_out = t_out[:r], tri_out[:r]
    if stats:
        st = torch.tensor(
            [wrap_i32(v) for v in (
                n["loads"], n["rounds"], -(-n_b // sched["service_k"]), n_b,
                n["tests"], n["enq"], 0, 0)],
            dtype=torch.int32, device=dev)
        return t_out, tri_out, st
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
    n_rays, n_nodes, n_leaf_rows, tmin, any_hit, stream) and its deferral
    form's (the same, then groups, skip_done, before the stream);
    strand_walk's (rows, leaves, first, ro, rd, tmax, t, tri, stats,
    n_rays, n_nodes, n_leaf_rows, rpo, ribbon_k, tmin, any_hit, stream),
    its mixed launch (rows, leaves, first, ro, rd, tmax, smask, t, tri,
    stats, n_rays, n_nodes, n_leaf_rows, rpo, ribbon_k, tmin, shadow_tmin,
    stream) and its schedule form's (rows, leaves, first, ro, rd, tmax,
    smask, t, tri, stats, work, n_rays, n_nodes, n_leaf_rows, rpo,
    ribbon_k, tmin, shadow_tmin, mode, fetch, service_k, occ, flush_pop,
    ctl_every, unroll, n_top, stream), with its grid query (mode, fetch,
    ribbon_k, n_top, n_rays, service_k, int* grid)."""
    from ._build import LOCK, load_library

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with LOCK:
        if name not in _LIBS:
            lib = load_library(name)
            launch = getattr(lib, name + "_launch")
            launch.restype = ctypes.c_int
            if name == "strand_block":
                launch.argtypes = [ptr] * 9 + [i32] * 3 + [f32, i32, ptr]
                lib.strand_block_defer_launch.restype = ctypes.c_int
                lib.strand_block_defer_launch.argtypes = (
                    [ptr] * 9 + [i32] * 3 + [f32] + [i32] * 3 + [ptr])
            else:
                launch.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, ptr]
                lib.strand_walk_mixed_launch.restype = ctypes.c_int
                lib.strand_walk_mixed_launch.argtypes = (
                    [ptr] * 10 + [i32] * 5 + [f32, f32, ptr])
                lib.strand_walk_sched_launch.restype = ctypes.c_int
                lib.strand_walk_sched_launch.argtypes = (
                    [ptr] * 11 + [i32] * 5 + [f32, f32] + [i32] * 8 + [ptr])
                lib.strand_walk_sched_grid.restype = ctypes.c_int
                lib.strand_walk_sched_grid.argtypes = (
                    [i32] * 6 + [ctypes.POINTER(i32)])
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
                  any_hit, stats=None, defer=None):
    """Check the inputs, allocate the outputs and launch
    ``csrc/strand_block.cu`` on the current stream, or its deferral form
    with ``defer`` = (groups, skip_done): (t, tri)."""
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
        args = (strand_rows.data_ptr(), leaf_tris.data_ptr(),
                first.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                tmax.data_ptr(), t.data_ptr(), tri.data_ptr(),
                None if stats is None else stats.data_ptr(), r,
                strand_rows.shape[0] * 2, leaf_tris.shape[0], float(tmin),
                int(any_hit))
        if defer is None:
            rc = lib.strand_block_launch(*args, stream)
        else:
            rc = lib.strand_block_defer_launch(*args, int(defer[0]),
                                               int(defer[1]), stream)
    _raise_failed(lib, "strand_block", rc)
    return t, tri


def _walk_launch(rows, leaf_tris, first, ro, rd, tmax, smask, tmin,
                 second: float, rpo: int, ribbon_k: int, stats: bool,
                 sched: dict | None = None):
    """Check the inputs, allocate the outputs and launch
    ``csrc/strand_walk.cu`` on the current stream: with ``smask`` None the
    closest-hit (``second`` = 0) or any-hit (1) instance, else the mixed one
    (``second`` = shadow_tmin); with ``sched`` (``_schedule``'s record) the
    schedule form's. Returns (t, tri, stats or None, whether a kernel was
    launched: not for no rays)."""
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
        if sched is None:
            st[3] = wrap_i32(-(-r // STRAND_RAYS))
    if r == 0:
        return t, tri, st, False
    n_nodes = _n_nodes(rows, rpo)
    if sched is not None:
        work = torch.empty(1, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            rc = lib.strand_walk_sched_launch(
                rows.data_ptr(), leaf_tris.data_ptr(), first.data_ptr(),
                ro.data_ptr(), rd.data_ptr(), tmax.data_ptr(),
                None if smask is None else smask.data_ptr(), t.data_ptr(),
                tri.data_ptr(), None if st is None else st.data_ptr(),
                work.data_ptr(), r, n_nodes, leaf_tris.shape[0], int(rpo),
                int(ribbon_k), float(tmin),
                float(tmin if smask is None else second),
                2 if smask is not None else int(second), sched["fetch"],
                sched["service_k"], sched["occ"],
                sched["flush_pop"], sched["ctl_every"], sched["unroll"],
                sched["n_top"], torch.cuda.current_stream().cuda_stream)
        _raise_failed(lib, "strand_walk", rc)
        return t, tri, st, True
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


def sched_grid(sched: dict, mode: int, n_rays: int,
               ribbon_k: int = 4) -> int:
    """The grid, in blocks of 4 warps, that the schedule form ``sched``
    (``_schedule``'s record) launches for ``n_rays`` rays on the current
    CUDA device in mode 0 (closest-hit), 1 (any-hit) or 2 (mixed): the
    blocks the card holds resident (the CUDA occupancy calculator's blocks
    per SM for the instance's registers and shared memory, times the SMs),
    or the launch's claims of ``service_k`` batches where fewer. raytpu's
    ``walkers`` does not enter it."""
    lib = _library("strand_walk")
    grid = ctypes.c_int(0)
    rc = lib.strand_walk_sched_grid(mode, sched["fetch"], ribbon_k,
                                    sched["n_top"], n_rays,
                                    sched["service_k"], ctypes.byref(grid))
    _raise_failed(lib, "strand_walk", rc)
    return grid.value


def _count(fn, rpo: int, ribbon_k: int, sched: dict | None = None) -> None:
    """One launch of ``fn``'s kernel: ``ribbon_launches`` on ribbon rows
    one record a step, ``ribbon_wide_launches`` with the K-wide fetch
    (``ribbon_k`` >= 2), ``launches`` on strand rows; a schedule form's
    ``<form>_launches`` (``sched_form``)."""
    if sched is not None:
        name = sched_form(sched) + "_launches"
        setattr(fn, name, getattr(fn, name) + 1)
    elif rpo and ribbon_k >= 2:
        fn.ribbon_wide_launches += 1
    elif rpo:
        fn.ribbon_launches += 1
    else:
        fn.launches += 1


SCHED_FORMS = ("load", "pipe", "dual", "smem", "wide")


def sched_form(sched: dict) -> str:
    """The schedule form a ``_schedule`` record launches: its fetch form
    (``load``, ``pipe``, ``dual``, ``wide``), or ``smem`` for the pipelined
    and dual fetches with nodes staged in shared memory."""
    return "smem" if sched["n_top"] else FETCH_NAMES[sched["fetch"]]


def _zero_counts(fn, names) -> None:
    for name in names:
        setattr(fn, name, 0)


@spanned("raytpu::kernels.strand")
def strand_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                      tmin: float, any_hit: bool, *, rpo: int = 0,
                      ribbon_k: int = 4, stats: bool = False, **schedule):
    """Launch ``csrc/strand_walk.cu`` on the current stream (one thread per
    ray, while-while traversal; with a schedule keyword, the schedule
    form). Same signature and results as ``strand_query_torch``; raises on
    bad inputs or a failed launch. ``strand_query_cuda.launches`` counts
    the launches over strand rows, ``.ribbon_launches`` those over ribbon
    rows one record a step, ``.ribbon_wide_launches`` the K-wide fetch's
    (``ribbon_k`` >= 2), ``.<form>_launches`` the schedule form's
    (``SCHED_FORMS``)."""
    sched = _schedule(rpo, _n_nodes(strand_rows, rpo), **schedule)
    t, tri, st, launched = _walk_launch(strand_rows, leaf_tris, first, ro,
                                        rd, tmax, None, tmin, int(any_hit),
                                        rpo, ribbon_k, stats, sched)
    if launched:
        _count(strand_query_cuda, rpo, ribbon_k, sched)
    return (t, tri, st) if stats else (t, tri)


_zero_counts(strand_query_cuda,
             ["launches", "ribbon_launches", "ribbon_wide_launches"]
             + [f + "_launches" for f in SCHED_FORMS])


def strand_query(strand_rows, leaf_tris, first, ro, rd, tmax, tmin: float,
                 any_hit: bool, *, rpo: int = 0, ribbon_k: int = 4,
                 stats: bool = False, **schedule):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = strand_query_cuda if ro.device.type == "cuda" else strand_query_torch
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, tmin, any_hit,
              rpo=rpo, ribbon_k=ribbon_k, stats=stats, **schedule)


@spanned("raytpu::kernels.strand")
def strand_mixed_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                            smask, tmin: float, shadow_tmin: float, *,
                            rpo: int = 0, ribbon_k: int = 4,
                            stats: bool = False, **schedule):
    """Launch the mixed form of ``csrc/strand_walk.cu`` on the current
    stream. Same signature and results as ``strand_mixed_query_torch``;
    raises on bad inputs or a failed launch.
    ``strand_mixed_query_cuda.launches`` counts the launches over strand
    rows, ``.ribbon_launches`` and ``.ribbon_wide_launches`` those over
    ribbon rows (one record a step; the K-wide fetch), ``.<form>_launches``
    the schedule form's."""
    sched = _schedule(rpo, _n_nodes(strand_rows, rpo), **schedule)
    t, tri, st, launched = _walk_launch(strand_rows, leaf_tris, first, ro,
                                        rd, tmax, smask, tmin, shadow_tmin,
                                        rpo, ribbon_k, stats, sched)
    if launched:
        _count(strand_mixed_query_cuda, rpo, ribbon_k, sched)
    return (t, tri, st) if stats else (t, tri)


_zero_counts(strand_mixed_query_cuda,
             ["launches", "ribbon_launches", "ribbon_wide_launches"]
             + [f + "_launches" for f in SCHED_FORMS])


def strand_mixed_query(strand_rows, leaf_tris, first, ro, rd, tmax, smask,
                       tmin: float, shadow_tmin: float, *, rpo: int = 0,
                       ribbon_k: int = 4, stats: bool = False, **schedule):
    """The mixed kernel for CUDA tensors, its plain version for CPU
    tensors."""
    fn = (strand_mixed_query_cuda if ro.device.type == "cuda"
          else strand_mixed_query_torch)
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, smask, tmin,
              shadow_tmin, rpo=rpo, ribbon_k=ribbon_k, stats=stats,
              **schedule)


def _strand_box(s: dict, w, rec, tmin: float, any_hit: bool):
    """The block walk's vote: whether any lane of strands ``w`` hits its
    strand's record ``rec`` [n, 1, 8], each lane with its own LIMIT
    (closest: its best t; any-hit: tmax, -inf once blocked)."""
    neg, o, inv = s["neg"][w], s["o"][w], s["inv"][w]
    lo = (torch.where(neg, rec[..., 3:6], rec[..., 0:3]) - o) * inv
    hi = (torch.where(neg, rec[..., 0:3], rec[..., 3:6]) - o) * inv
    if any_hit:
        limit = torch.where(s["btri"][w] >= 0, float("-inf"), s["tm"][w])
    else:
        limit = s["bt"][w]
    near = torch.maximum(
        torch.maximum(lo[..., 0], lo[..., 1]),
        torch.maximum(lo[..., 2], torch.full_like(lo[..., 2], tmin)),
    )
    far = torch.minimum(
        torch.minimum(hi[..., 0], hi[..., 1]),
        torch.minimum(hi[..., 2], limit),
    )
    return (near <= far * FAR_SCALE).any(dim=1)


def _strand_leaf(s: dict, li, lr, tris, first, tmin: float, any_hit: bool):
    """Every lane of strands ``li`` tests leaf rows ``lr``'s 8 slots in
    order (s's best updated in place): an any-hit lane keeps its first
    accepted slot, a closest lane the smallest (t, key)."""
    k8 = torch.arange(8, device=lr.device, dtype=torch.int32)
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
        found, mt, ms, mk = _leaf_closest(ok, t, slot, first[slot.long()])
        bk = s["bkey"][li]
        acc = found & ((mt < bt) | ((mt == bt) & (mk < bk)))
        s["bt"][li] = torch.where(acc, mt, bt)
        s["btri"][li] = torch.where(acc, ms, bi)
        s["bkey"][li] = torch.where(acc, mk, bk)


def _check_block_options(defer: bool, groups: int, skip_done: bool) -> None:
    """Raise ValueError unless ``groups`` is 1..32 and the deferral options
    come with ``defer`` (without it the walk is 4 strands a block)."""
    if not 1 <= groups <= 32:
        raise ValueError(f"groups={groups}: want 1..32 warps a block")
    if not defer and (skip_done or groups != 4):
        raise ValueError("groups and skip_done are options of the deferral "
                         "form: pass defer=True")


def strand_block_query_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                             tmin: float, any_hit: bool,
                             with_stats: bool = False, *,
                             defer: bool = False, groups: int = 4,
                             skip_done: bool = False,
                             multiroll: bool = False):
    """Plain torch version of the block walk. ``first`` is
    ``first_slots(leaf_tris)``, ro/rd [R,3], tmax [R]; returns (t [R]
    f32, tri [R] i32) and, with ``with_stats``, int32 [ceil(R/32), 2] of
    each strand's walker steps and leaf visits. The
    rays are cut into strands [S, 32], the last one padded with dead lanes
    (ro 0, rd (1,1,1), tmax -inf); each loop iteration advances every
    unfinished strand's walker by one node. ``defer=True`` replays the
    deferral form (``_defer_torch``; its stats are [S, 3]) at ``groups``
    strands a block; ``skip_done`` and ``multiroll`` change no output
    (module docstring)."""
    _check_block_options(defer, groups, skip_done)
    if defer:
        out = _defer_torch(strand_rows, leaf_tris, first, ro, rd, tmax,
                           tmin, any_hit, groups, skip_done)
        return out if with_stats else out[:2]
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
        hit_any = _strand_box(s, slice(None), rec, tmin, any_hit)
        s["st"][:, 0] += 1
        hit_link = rec[:, 0, 6].long()
        nxt = torch.where(hit_any & (hit_link >= 0), hit_link,
                          rec[:, 0, 7].long())
        at_leaf = hit_any & (hit_link < 0) & (~hit_link < n_leaf_rows)
        if bool(at_leaf.any()):
            li = at_leaf.nonzero().squeeze(1)
            s["st"][li, 1] += 1
            lr = (~hit_link[li]).to(torch.int32)
            _strand_leaf(s, li, lr, tris, first, tmin, any_hit)
        s["cur"] = nxt
        retire((nxt < 0) | (nxt >= n_nodes))
    # walks cut by the step bound (never for a valid tree) keep their best
    retire(torch.ones_like(s["idx"], dtype=torch.bool))
    t, tri = t_out.reshape(-1)[:r], tri_out.reshape(-1)[:r]
    return (t, tri, st_out) if with_stats else (t, tri)


def _defer_torch(strand_rows, leaf_tris, first, ro, rd, tmax, tmin: float,
                 any_hit: bool, groups: int, skip_done: bool):
    """Plain version of the block walk's deferral form
    (csrc/strand_common.cuh:defer_kernel): blocks of ``groups`` strands
    in lock-step, each walker pushing its hit leaves on a stack of
    ``BLOCK_QCAP`` rows, the block's vote firing a leaf round when every
    walker is queued or finished and one is queued, or a stack is full;
    a round pops each queued walker's top row and every lane of the strand
    tests its 8 slots. ``skip_done`` only spares loads, so it changes no
    output here. Returns (t [R], tri [R], stats int32 [S, 3]: each
    strand's steps, leaves pushed, and its block's leaf rounds)."""
    dev = ro.device
    r = ro.shape[0]
    n_str = -(-r // STRAND)
    n_blk = -(-n_str // groups)
    n_all = n_blk * groups
    pad = n_all * STRAND - r
    recs = strand_rows.reshape(-1, 8)
    tris = leaf_tris.reshape(-1, 8, 10)
    n_nodes = strand_rows.shape[0] * 2
    n_leaf_rows = leaf_tris.shape[0]
    tmax = tmax.to(torch.float32)
    if pad:
        ro = torch.cat([ro, ro.new_zeros((pad, 3))])
        rd = torch.cat([rd, rd.new_ones((pad, 3))])
        tmax = torch.cat([tmax, tmax.new_full((pad,), float("-inf"))])
    o = ro.reshape(n_all, STRAND, 3)
    d = rd.reshape(n_all, STRAND, 3)
    tm = tmax.reshape(n_all, STRAND)
    inv = _safe_inv(d)
    lane0 = d[:, 0]
    t_out = torch.empty_like(tm)
    tri_out = torch.empty((n_all, STRAND), dtype=torch.int32, device=dev)
    st_out = torch.empty((n_all, 3), dtype=torch.int32, device=dev)
    s = dict(
        idx=torch.arange(n_all, device=dev), o=o, d=d, inv=inv,
        neg=inv < 0.0, tm=tm,
        bt=tm.clone() if any_hit else torch.minimum(
            torch.full_like(tm, F32_MAX), tm),
        oct=((lane0[:, 0] < 0).long() + 2 * (lane0[:, 1] < 0).long()
             + 4 * (lane0[:, 2] < 0).long()),
        btri=torch.full((n_all, STRAND), -1, dtype=torch.int32, device=dev),
        bkey=torch.full((n_all, STRAND), -1, dtype=torch.int32, device=dev),
        c=torch.where(torch.arange(n_all, device=dev) < n_str, 0, -1),
        q=torch.zeros((n_all, BLOCK_QCAP), dtype=torch.long, device=dev),
        qn=torch.zeros(n_all, dtype=torch.long, device=dev),
        st=torch.zeros((n_all, 3), dtype=torch.int32, device=dev),
    )
    while s["idx"].numel():
        if any_hit:  # every lane blocked or dead: stop, drop the queue
            done = ((s["btri"] >= 0) | (s["tm"] < 0.0)).all(dim=1)
            s["c"] = torch.where(done, -1, s["c"])
            s["qn"] = torch.where(done, 0, s["qn"])
        act = ((s["c"] >= 0) & (s["c"] < n_nodes)
               & (s["st"][:, 0] < n_nodes))
        if bool(act.any()):
            w = act.nonzero().squeeze(1)
            rec = recs[s["c"][w] * 8 + s["oct"][w]][:, None, :]
            hit_any = _strand_box(s, w, rec, tmin, any_hit)
            hl = rec[:, 0, 6].long()
            s["st"][w, 0] += 1
            s["c"][w] = torch.where(hit_any & (hl >= 0), hl,
                                    rec[:, 0, 7].long())
            leaf = hit_any & (hl < 0) & (~hl < n_leaf_rows)
            if bool(leaf.any()):
                lw = w[leaf]
                s["st"][lw, 1] += 1
                s["q"][lw, s["qn"][lw]] = ~hl[leaf]
                s["qn"][lw] += 1
        walking = ((s["c"] >= 0) & (s["c"] < n_nodes)
                   & (s["st"][:, 0] < n_nodes))
        queued = s["qn"] > 0
        fire = (((queued | ~walking).view(-1, groups).all(1)
                 & queued.view(-1, groups).any(1))
                | (s["qn"] >= BLOCK_QCAP).view(-1, groups).any(1))
        fire = fire.repeat_interleave(groups)
        s["st"][:, 2] += fire.to(torch.int32)
        pop = fire & queued
        if bool(pop.any()):
            li = pop.nonzero().squeeze(1)
            s["qn"][li] -= 1
            lr = s["q"][li, s["qn"][li]].to(torch.int32)
            _strand_leaf(s, li, lr, tris, first, tmin, any_hit)
        alive = (walking | (s["qn"] > 0)).view(-1, groups).any(1)
        done = (~alive).repeat_interleave(groups)
        if bool(done.any()):
            i = s["idx"][done]
            t_out[i] = s["bt"][done]
            tri_out[i] = s["btri"][done]
            st_out[i] = s["st"][done]
            s = {key: val[~done] for key, val in s.items()}
    t, tri = t_out.reshape(-1)[:r], tri_out.reshape(-1)[:r]
    return t, tri, st_out[:n_str]


@spanned("raytpu::kernels.strand")
def strand_block_query_cuda(strand_rows, leaf_tris, first, ro, rd, tmax,
                            tmin: float, any_hit: bool,
                            with_stats: bool = False, *,
                            defer: bool = False, groups: int = 4,
                            skip_done: bool = False,
                            multiroll: bool = False):
    """Launch ``csrc/strand_block.cu`` on the current stream (one warp per
    32-ray strand, 4 strands per block; ``defer=True``: the deferral form,
    ``groups`` strands a block). Same signature and results as
    ``strand_block_query_torch``; raises on bad inputs or a failed launch.
    ``strand_block_query_cuda.launches`` counts the launches,
    ``.defer_launches`` the deferral form's."""
    _check_block_options(defer, groups, skip_done)
    r = ro.shape[0]
    stats = torch.zeros((-(-r // STRAND), 3 if defer else 2),
                        dtype=torch.int32,
                        device=ro.device) if with_stats else None
    t, tri = _block_launch(strand_rows, leaf_tris, first, ro, rd, tmax, tmin,
                           any_hit, stats, (groups, skip_done) if defer
                           else None)
    if r:
        if defer:
            strand_block_query_cuda.defer_launches += 1
        else:
            strand_block_query_cuda.launches += 1
    return (t, tri, stats) if with_stats else (t, tri)


_zero_counts(strand_block_query_cuda, ["launches", "defer_launches"])


def strand_block_query(strand_rows, leaf_tris, first, ro, rd, tmax,
                       tmin: float, any_hit: bool, with_stats: bool = False,
                       **options):
    """The block kernel for CUDA tensors, its plain version for CPU
    tensors; ``options`` are the deferral form's (``defer``, ``groups``,
    ``skip_done``, ``multiroll``)."""
    fn = (strand_block_query_cuda if ro.device.type == "cuda"
          else strand_block_query_torch)
    return fn(strand_rows, leaf_tris, first, ro, rd, tmax, tmin, any_hit,
              with_stats, **options)


def _check_baked_tmin(tmin, baked: float, what: str):
    if float(tmin) != baked:
        raise ValueError(
            f"{what}: tmin is baked at {baked}, the engine passed {tmin}"
        )


def _per_ray(tmax, ro):
    """tmax (a scalar or [R]) as a contiguous float32 [R] on ro's device;
    a scalar is copied there from the host, which waits for the device."""
    if torch.is_tensor(tmax):
        tmax = tmax.to(device=ro.device, dtype=torch.float32)
    else:
        with span("raytpu::kernels.sync.tmax"):
            tmax = torch.as_tensor(tmax, dtype=torch.float32,
                                   device=ro.device)
    return tmax.expand(ro.shape[0]).contiguous()


def _ribbon_env() -> int:
    """RAYTPU_RIBBON = K (sub-steps per fetched ribbon row, raytpu's
    ``ribbon_k``): 0 or less keeps the strand layout; above 8 raises, as
    raytpu's kernel asserts ``1 <= ribbon_k <= 8``."""
    k = int(os.environ.get("RAYTPU_RIBBON", "0"))
    if k > 8:
        raise ValueError(f"RAYTPU_RIBBON={k}: want 0..8")
    return k


# raytpu's schedule variables (kernels/strand.py:507-546, :616-635), by
# the keyword each sets
SCHEDULE_ENV = dict(
    walkers="RAYTPU_STRAND_WALKERS", service_k="RAYTPU_STRAND_SERVICE_K",
    flush_occ="RAYTPU_STRAND_FLUSH", pipe="RAYTPU_STRAND_PIPE",
    unroll="RAYTPU_STRAND_UNROLL", ctl_every="RAYTPU_STRAND_CTL",
    flush_pop="RAYTPU_STRAND_POP", dual="RAYTPU_STRAND_DUAL")


def _tree_any(tree, leaves) -> bool:
    """raytpu's beyond-budget route (``_hbm_tables``): tables over 100 MiB,
    or RAYTPU_STRAND_HBM forcing it (any value but "0") or off ("0")."""
    env = os.environ.get("RAYTPU_STRAND_HBM")
    if env is None:
        return (tree.numel() + leaves.numel()) * 4 > STRAND_TABLE_BUDGET
    return env != "0"


def _route(pack, tree, leaves, per_ray: bool) -> tuple:
    """(rows, keywords, per_ray) of a strand factory, as raytpu's factories
    choose them, each variable read once. ``tree_any`` forces the per-ray
    walk and the strand rows. RAYTPU_RIBBON = K > 0 puts the per-ray walk
    on ``pack.bvh.ribbon_rows`` (``rpo``, ``ribbon_k``: K >= 2 is the
    K-wide fetch of the while-while walk) where the pack has them. The
    schedule keywords, with raytpu's factory defaults (walkers 128,
    service_k 16, flush 0.5, pipe at >= 4096 triangles or with
    ``tree_any``, unroll 4 with pipe, else 1, and 1 on ribbon rows, ctl 1,
    pop 1, dual with pipe and off on ribbon rows), are passed when the
    per-ray walk is chosen and a schedule variable or RAYTPU_STRAND_HBM
    (not "0") is set; otherwise the walk keeps the while-while instances,
    also over the budget: the card holds every table in global memory
    whatever their size, so the size alone changes no code on it (the
    pipelined form measured slower than the while-while walk on every
    wave, PERF.md)."""
    env = os.environ
    tree_any = _tree_any(tree, leaves)
    per_ray = per_ray or tree_any
    k = _ribbon_env()
    ribbon = getattr(pack.bvh, "ribbon_rows", None)
    keywords = {}
    rows = tree
    if k > 0 and per_ray and not tree_any and ribbon is not None:
        rows = ribbon.contiguous()
        keywords = dict(rpo=rows.shape[0] // 8, ribbon_k=k)
    if per_ray and (env.get("RAYTPU_STRAND_HBM", "0") != "0"
                    or any(v in env for v in SCHEDULE_ENV.values())):
        pipe = tree_any or env.get(
            "RAYTPU_STRAND_PIPE",
            "1" if pack.n_triangles >= 4096 else "0") != "0"
        unroll = int(env.get("RAYTPU_STRAND_UNROLL", "4")) if pipe else 1
        sched = dict(
            walkers=int(env.get("RAYTPU_STRAND_WALKERS", "128")),
            service_k=int(env.get("RAYTPU_STRAND_SERVICE_K", "16")),
            flush_occ=float(env.get("RAYTPU_STRAND_FLUSH", "0.5")),
            pipe=pipe, unroll=1 if keywords else unroll,
            ctl_every=int(env.get("RAYTPU_STRAND_CTL", "1")),
            flush_pop=int(env.get("RAYTPU_STRAND_POP", "1")),
            dual=(env.get("RAYTPU_STRAND_DUAL", "0") != "0" and pipe
                  and not keywords),
            tree_any=tree_any)
        _schedule(keywords.get("rpo", 0),
                  _n_nodes(rows, keywords.get("rpo", 0)), **sched)
        keywords.update(sched)
    return rows, keywords, per_ray


def make_strand_intersectors(pack):
    """(closest_fn, any_fn) with the engine's (ro, rd, tmin, tmax)
    signature over ``pack.bvh.strand_rows`` and ``leaf_tris``, ties broken
    on ``pack.bvh.first_slots``. tmin is baked: 0.001 for
    closest-hit and 0.0 for any-hit; another value raises. A pack without
    a strand tree (<= 256 slots) raises ValueError.

    The walk is chosen here, once, as raytpu's factory chooses its kernel,
    and every variable is read here, once: the per-ray walk (raytpu's
    persistent kernel, its default), or the block walk when
    ``RAYTPU_STRAND_PERSISTENT=0`` and raytpu's ``tree_any`` does not hold
    (tables over 100 MiB, or ``RAYTPU_STRAND_HBM`` set to anything but 0,
    force the per-ray walk, as raytpu's). The per-ray walk takes
    ``_route``'s layout and schedule: ``RAYTPU_RIBBON``, and raytpu's
    schedule variables (``RAYTPU_STRAND_WALKERS``, ``_SERVICE_K``,
    ``_FLUSH``, ``_PIPE``, ``_UNROLL``, ``_CTL``, ``_POP``, ``_DUAL``) and
    ``RAYTPU_STRAND_HBM`` with raytpu's defaults, any of which selects the
    schedule form (tables over the budget alone keep the while-while
    walk). The block walk
    reads ``RAYTPU_STRAND_GROUPS`` = G (default 16, raytpu's) and
    ``RAYTPU_STRAND_SKIP_DONE`` (set and non-empty, as raytpu's ``bool``):
    either turns on the deferral form at G strands a block, with
    ``skip_done`` from the latter; ``RAYTPU_STRAND_MULTIROLL`` (not "0") is
    read and passed, and adds no code (module docstring). On a CUDA pack
    the chosen walk's library is built or loaded here, on the caller's
    thread."""
    if pack.bvh.strand_rows is None:
        raise ValueError(
            "intersector='strand' needs a strand tree; scenes above "
            "the sort threshold pack one by default"
        )
    tree = pack.bvh.strand_rows.contiguous()
    leaves = pack.bvh.leaf_tris.contiguous()
    first = pack.bvh.first_slots.contiguous()
    env = os.environ
    groups = env.get("RAYTPU_STRAND_GROUPS")
    skip_done = bool(env.get("RAYTPU_STRAND_SKIP_DONE"))
    multiroll = env.get("RAYTPU_STRAND_MULTIROLL", "0") != "0"
    persistent = env.get("RAYTPU_STRAND_PERSISTENT", "1") != "0"
    tree, layout, persistent = _route(pack, tree, leaves, persistent)
    query = strand_query if persistent else strand_block_query
    if not persistent:
        layout = {}
        if groups is not None or skip_done:
            layout = dict(defer=True, groups=int(groups or "16"),
                          skip_done=skip_done)
            _check_block_options(**layout)
        if multiroll:
            layout["multiroll"] = True
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
    not move it to the block walk. ``RAYTPU_RIBBON``, ``RAYTPU_STRAND_HBM``
    and raytpu's schedule variables are read here, once, as in
    ``make_strand_intersectors`` (``_route``). A pack without a strand tree
    raises ValueError. On a CUDA pack the kernel's library is built or
    loaded here, on the caller's thread."""
    if pack.bvh.strand_rows is None:
        raise ValueError(
            "bounce_backend='mixed' needs a strand tree; pack "
            "the scene with the default packed tables"
        )
    leaves = pack.bvh.leaf_tris.contiguous()
    first = pack.bvh.first_slots.contiguous()
    tree, layout, _ = _route(pack, pack.bvh.strand_rows.contiguous(), leaves,
                             True)
    if tree.device.type == "cuda":  # build or load here, not at a launch
        _library("strand_walk")

    def query(ro, rd, tmax, smask, *, tmin: float, shadow_tmin: float):
        return strand_mixed_query(
            tree, leaves, first, ro.contiguous(), rd.contiguous(),
            _per_ray(tmax, ro), smask.to(torch.float32).contiguous(), tmin,
            shadow_tmin, **layout)

    return query
