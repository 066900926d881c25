"""Offline strand-walk simulator: exact step / leaf-visit counts. The
port's counterpart of raytpu's ``benchmarks/strand_sim.py``.

Replays raytpu's strand kernel's traversal in numpy on the captured engine
waves (raytpu's ``benchmarks/waves/``, read as data), so coherence-key and
tree-shape experiments can be ranked by VISIT COUNTS without device time:
the kernel is latency/step-bound, so steps and leaf phases predict
wall-clock. Counts are hardware-independent.

``decode_tree``, ``walk_strand``, ``ribbon_renumber``,
``collapsed_threading`` and ``main``'s sweeps are raytpu's, line for line.
Only their sources are the port's: the pack is
``tools/scenes.py:cached_atrium(..., as_numpy=True)`` (its strand rows
have raytpu's ``[ceil(N/2), 128]`` layout, ``accel/strandtree.py``), the
waves ``tools/waves.py:load_wave`` and the coherence key the port's
``engine/render.py:_ray_sort_key`` (``tools/waves.py:engine_sort``).

Differences from the kernel, by design:
* best_t tightens IMMEDIATELY at each leaf visit (the kernel defers MT
  to batched flushes) — the sim's step counts are a slightly tight
  lower bound, consistently across configs;
* per-block leaf-PHASE counts are modeled from the same ready/flush
  policy but not bit-exact.

raytpu's defaults stay (strands of 128 rays, groups of 16); the port's
block walk (``strand_block.cu``) walks 32-ray strands, which is
``--strand 32``. At width 32 each line is followed by the block walk's own
per-strand counters on the same rays (``strand_block_query(...,
with_stats=True)`` on ``--device``: the kernel on the card, its plain
version on the CPU) and the sim's ratio to them.

Usage:
    python -m raytpu_torch.tools.strand_sim [--tris 250000]
        [--waves b2c b3c b2s] [--morton-bits 6 9] [--strand 128]
        [--groups 1 4 16]
    python -m raytpu_torch.tools.strand_sim --device cpu --tris 5000 \\
        --max-rays 2048 --strand 32 128
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import scenes
from .waves import engine_sort, load_wave

NODE_LANES = 8
F32_MAX = np.float32(3.40282347e38)


def decode_tree(rows: np.ndarray, n_nodes: int):
    """[ceil(N/2),128] rows -> per-octant (bmin, bmax, hit, miss)."""
    rows = np.asarray(rows)
    node = np.arange(n_nodes)
    r, base = node // 2, (node % 2) * 64
    out = []
    for o in range(8):
        lo = base + o * NODE_LANES
        bmin = np.stack([rows[r, lo + a] for a in range(3)], -1)
        bmax = np.stack([rows[r, lo + 3 + a] for a in range(3)], -1)
        hit = rows[r, lo + 6].astype(np.int64)
        miss = rows[r, lo + 7].astype(np.int64)
        out.append((bmin, bmax, hit, miss))
    return out


def walk_strand(tree_o, leaf, ro, rd, tmax, tmin, any_hit, rowstats=None):
    """One strand (S rays) through one octant threading; returns
    (steps, leaf_visits). With ``rowstats`` (a dict), also counts
    transitions whose next node shares the current fetch row
    (next//2 == cur//2) or a 2-row window (next//4 == cur//4) — sizes
    the speculative multi-step idea (process the co-resident node in
    the same iteration, no extra fetch)."""
    bmin, bmax, hit, miss = tree_o
    if rowstats is not None:
        # node-visit sequence, -1-separated per strand (for the fixed-K
        # sub-step iteration model in main)
        rowstats.setdefault("_seq", []).extend([-1, 0])
    inv = 1.0 / np.where(rd == 0.0, np.float32(1e-36), rd)
    neg = inv < 0.0
    best_t = np.minimum(np.full(ro.shape[0], F32_MAX, np.float32), tmax)
    blocked = np.zeros(ro.shape[0], bool)
    cur, steps, leafs = 0, 0, 0
    while cur >= 0:
        steps += 1
        lo = np.where(neg, bmax[cur], bmin[cur])
        hi = np.where(neg, bmin[cur], bmax[cur])
        t0 = (lo - ro) * inv
        t1 = (hi - ro) * inv
        if any_hit:
            limit = np.where(blocked, -np.inf, tmax)
        else:
            limit = best_t
        near = np.maximum(t0.max(1), tmin)
        far = np.minimum(t1.min(1), limit)
        h = bool((near <= far).any())
        if h and hit[cur] < 0:  # leaf
            leafs += 1
            lr = ~hit[cur]
            row = leaf[lr]
            for k in range(8):
                p0 = row[10 * k : 10 * k + 3]
                e1 = row[10 * k + 3 : 10 * k + 6]
                e2 = row[10 * k + 6 : 10 * k + 9]
                pv = np.cross(rd, e2)
                det = (e1 * pv).sum(1)
                with np.errstate(divide="ignore", invalid="ignore"):
                    invd = 1.0 / det
                    tv = ro - p0
                    u = (tv * pv).sum(1) * invd
                    qv = np.cross(tv, e1)
                    v = (rd * qv).sum(1) * invd
                    t = (e2 * qv).sum(1) * invd
                ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
                if any_hit:
                    okh = ok & (t >= tmin) & (t <= tmax) & ~blocked
                    blocked |= okh
                else:
                    okh = ok & (t >= tmin) & (t < best_t)
                    best_t = np.where(okh, t, best_t)
            nxt = miss[cur]
        elif h:
            nxt = hit[cur]
        else:
            nxt = miss[cur]
        if rowstats is not None and nxt >= 0:
            rowstats["trans"] = rowstats.get("trans", 0) + 1
            for rsz in (2, 4, 8, 16):
                if nxt // rsz == cur // rsz:
                    k = f"row{rsz}"
                    rowstats[k] = rowstats.get(k, 0) + 1
            rowstats.setdefault("_seq", []).append(nxt)
        cur = nxt
        if any_hit and bool((blocked | (tmax < 0)).all()):
            break
    return steps, leafs


def ribbon_renumber(tree_o, n: int):
    """Renumber one octant's threading in near-first DFS pre-order.

    The always-hit walk (interior -> hit, leaf -> miss) visits every
    node exactly once (validate_strand_tree), and an interior node's hit
    link is its near-first child — visited immediately after — so in the
    renumbered space hit[v] == v + 1 for every interior node. A walker's
    hit-CHAIN is then a run of consecutive node indices: with R nodes
    packed per fetch row, the chain advances inside one fetched row
    without touching the scalar unit. Returns (bmin, bmax, hit, miss)
    in the new numbering plus the permutation."""
    bmin, bmax, hit, miss = tree_o
    order = np.empty(n, np.int64)
    pos = np.empty(n, np.int64)
    v, i = 0, 0
    while v != -1:
        order[i] = v
        pos[v] = i
        v = int(hit[v]) if hit[v] >= 0 else int(miss[v])
        i += 1
    assert i == n

    # leaf hit links are ~leaf_row payloads (< 0) — kept verbatim
    nhit = np.where(hit >= 0, pos[np.maximum(hit, 0)], hit)[order]
    nmiss = np.where(miss >= 0, pos[np.maximum(miss, 0)], miss)[order]
    interior = nhit >= 0
    assert (nhit[interior] == np.flatnonzero(interior) + 1).all()
    return (bmin[order], bmax[order], nhit, nmiss), order


def collapsed_threading(pack, levels: int):
    """Per-octant (bmin, bmax, hit, miss) for a 2^levels-ary collapse of
    the canonical binary BVH: children of a kept node are its depth-
    ``levels`` descendants (or shallower leaves). Same skip-link walk
    contract as the strand tree, so walk_strand() consumes it as-is —
    fewer nodes => fewer fetches per walk, at (possibly) more own-box
    tests. The sim ranks that trade before any builder work."""
    nodes = np.asarray(pack.bvh.nodes)
    bmin, bmax = nodes[:, 0:3], nodes[:, 3:6]
    miss0 = nodes[:, 6].view(np.int32).astype(np.int64)
    leaf_row = nodes[:, 7].view(np.int32).astype(np.int64)
    n = nodes.shape[0]
    interior = leaf_row < 0
    left = np.where(interior, np.arange(n, dtype=np.int64) + 1, -1)
    right = np.where(
        interior, miss0[np.minimum(np.maximum(left, 0), n - 1)], -1
    )
    right = np.where(right < 0, left, right)  # root-miss=-1 guard

    def kids(v, depth):
        if depth == 0 or not interior[v]:
            return [v]
        return kids(left[v], depth - 1) + kids(right[v], depth - 1)

    # collect kept nodes (BFS from root over `levels`-deep jumps)
    children = {}
    order = [0]
    qi = 0
    while qi < len(order):
        v = order[qi]
        qi += 1
        if not interior[v]:
            continue
        cs = kids(left[v], levels - 1) + kids(right[v], levels - 1)
        children[v] = cs
        order.extend(cs)

    center = (bmin + bmax) * 0.5
    out = []
    sys.setrecursionlimit(100000)
    for o in range(8):
        s = np.array([1 if (o >> a) & 1 == 0 else -1 for a in range(3)],
                     np.float32)
        hit = np.full(n, -1, np.int64)
        miss = np.full(n, -1, np.int64)

        def thread(v, after):
            if not interior[v]:
                hit[v] = ~leaf_row[v]
                miss[v] = after
                return
            cs = sorted(children[v], key=lambda c: float(center[c] @ s))
            hit[v] = cs[0]
            miss[v] = after
            for i, c in enumerate(cs):
                thread(c, cs[i + 1] if i + 1 < len(cs) else after)

        thread(0, -1)
        out.append((bmin, bmax, hit, miss))
    return out


def block_counters(dpack, ro, rd, tmax, tmin: float, any_hit: bool,
                   n_str: int):
    """strand_block's own per-strand (steps, leaf visits) on the first
    ``n_str`` 32-ray strands of the sorted rays, on the pack's device."""
    from ..kernels.strand import strand_block_query

    n = n_str * 32
    dev = dpack.device
    args = [torch.as_tensor(a[:n], device=dev) for a in (ro, rd, tmax)]
    _, _, st = strand_block_query(
        dpack.bvh.strand_rows, dpack.bvh.leaf_tris, dpack.bvh.first_slots,
        *args, tmin, any_hit, with_stats=True)
    st = st.cpu().numpy().astype(np.int64)
    return st[:, 0], st[:, 1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="strand_sim", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--waves", nargs="*", default=["b2c"])
    ap.add_argument("--morton-bits", type=int, nargs="*", default=[6])
    ap.add_argument("--strand", type=int, nargs="*", default=[128])
    ap.add_argument("--groups", type=int, nargs="*", default=[16])
    ap.add_argument("--max-rays", type=int, default=0,
                    help="sim only the first N rays (0 = all)")
    ap.add_argument("--collapse", type=int, default=0,
                    help="walk a 2^N-ary collapsed threading instead of "
                         "the built strand tree (1 = binary sanity)")
    ap.add_argument("--seg", type=int, default=0,
                    help="sort in independent segments of this many rays "
                         "(models RAYTPU_SORT_MODE=seg coherence loss; "
                         "0 = one full-wave sort)")
    ap.add_argument("--nosort", action="store_true",
                    help="skip the coherence sort entirely: strands = 128 "
                         "consecutive rays of the engine's pixel-block "
                         "order (sizes what the sort buys in walk steps)")
    ap.add_argument("--rowstats", action="store_true",
                    help="count fetch-row-local transitions (sizes the "
                         "speculative multi-step: next//2==cur//2 needs "
                         "no extra fetch)")
    ap.add_argument("--ribbon", action="store_true",
                    help="renumber each octant's threading in near-first "
                         "DFS pre-order (hit == cur+1 for interiors) and "
                         "report row-local transition fractions — sizes "
                         "the ribbon layout where a hit-chain runs inside "
                         "one fetched row")
    ap.add_argument("--order-from", default=None,
                    help="sort this wave by ANOTHER wave's key (e.g. walk "
                         "b2s in b2c's sorted order — models the "
                         "resort-lite scheme where the shadow wave rides "
                         "the closest wave's sort for free)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sorts and the block walk's counters run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    from ..engine.render import _ray_sort_key
    from .waves import full_cache

    _, pack = scenes.cached_atrium(args.tris, as_numpy=True)
    dpack = pack.to(args.device)
    if args.collapse:
        tree = collapsed_threading(pack, args.collapse)
    else:
        tree = decode_tree(
            np.asarray(pack.bvh.strand_rows),
            int(np.asarray(pack.bvh.nodes).shape[0]),
        )
    if args.ribbon:
        n = tree[0][0].shape[0]
        tree = [ribbon_renumber(t, n)[0] for t in tree]
        args.rowstats = True
    leaf = np.asarray(pack.bvh.leaf_tris)
    full = full_cache(args.tris)

    def host(arrays):
        return tuple(a.cpu().numpy() for a in arrays)

    for name in args.waves:
        w = load_wave(name, full=full)
        any_hit = w["kind"] == "shadow"
        for bits in args.morton_bits:
            os.environ["RAYTPU_MORTON_BITS"] = str(bits)
            if args.nosort:
                ro = np.asarray(w["ro"], np.float32)
                rd = np.asarray(w["rd"], np.float32)
                tmax = np.asarray(w["tmax"], np.float32)
            elif args.order_from:
                # waves are pixel-aligned bands of the same tile: apply
                # the permutation induced by sorting the OTHER wave's key
                ow = load_wave(args.order_from, full=full)
                n = min(len(w["ro"]), len(ow["ro"]))
                okey = _ray_sort_key(
                    dpack, *(torch.as_tensor(ow[k][:n], device=dpack.device)
                             for k in ("ro", "rd")),
                    torch.as_tensor(ow["tmax"][:n], device=dpack.device)
                    >= 0,
                ).cpu().numpy()
                perm = np.argsort(okey, kind="stable")
                ro = np.asarray(w["ro"][:n], np.float32)[perm]
                rd = np.asarray(w["rd"][:n], np.float32)[perm]
                tmax = np.asarray(w["tmax"][:n], np.float32)[perm]
            elif args.seg:
                parts = []
                n = len(w["ro"])
                for s0 in range(0, n, args.seg):
                    sl = slice(s0, min(s0 + args.seg, n))
                    parts.append(host(engine_sort(
                        dpack, w["ro"][sl], w["rd"][sl], w["tmax"][sl]
                    )))
                ro = np.concatenate([p[0] for p in parts])
                rd = np.concatenate([p[1] for p in parts])
                tmax = np.concatenate([p[2] for p in parts])
            else:
                ro, rd, tmax = host(engine_sort(
                    dpack, w["ro"], w["rd"], w["tmax"]
                ))
            for S in args.strand:
                n_str = len(ro) // S
                if args.max_rays:
                    n_str = min(n_str, max(args.max_rays // S, 1))
                steps = np.zeros(n_str, np.int64)
                leafs = np.zeros(n_str, np.int64)
                rstats = {} if args.rowstats else None
                for i in range(n_str):
                    sl = slice(i * S, (i + 1) * S)
                    if (tmax[sl] < 0).all():
                        continue  # fully dead strand: 1 root step
                    o = (
                        (rd[sl][0, 0] < 0)
                        + 2 * (rd[sl][0, 1] < 0)
                        + 4 * (rd[sl][0, 2] < 0)
                    )
                    steps[i], leafs[i] = walk_strand(
                        tree[o], leaf, ro[sl], rd[sl], tmax[sl],
                        np.float32(w["tmin"]), any_hit, rstats,
                    )
                per_ray = steps.sum() / max(n_str * S, 1)
                if rstats:
                    tr = max(rstats.get("trans", 1), 1)
                    frac = " ".join(
                        f"row{z}={rstats.get(f'row{z}', 0) / tr:.3f}"
                        for z in (2, 4, 8, 16)
                    )
                    print(f"{name} rowstats: trans={tr} {frac}",
                          flush=True)
                    seq = rstats.get("_seq")
                    if seq:
                        # fixed-K model: one scalar fetch per iteration,
                        # up to K node tests while the walk stays inside
                        # the fetched 16-node row
                        total = sum(x >= 0 for x in seq)
                        for K in (2, 3, 4, 6, 8):
                            iters = 0
                            row, done = -2, 0
                            for x in seq:
                                if x < 0:
                                    row = -2
                                    continue
                                if x // 16 == row and done < K:
                                    done += 1
                                else:
                                    iters += 1
                                    row, done = x // 16, 1
                            print(
                                f"{name} ribbon16 K={K}: "
                                f"iters/step={iters / max(total, 1):.3f}"
                                f" (fetch reduction "
                                f"{max(total, 1) / max(iters, 1):.2f}x)",
                                flush=True,
                            )
                line = (f"{name} bits={bits} S={S}: strands={n_str} "
                        f"steps/ray={per_ray:.2f} "
                        f"steps mean={steps.mean():.0f} "
                        f"p50={np.percentile(steps, 50):.0f} "
                        f"p99={np.percentile(steps, 99):.0f} "
                        f"max={steps.max()} leafs mean={leafs.mean():.0f}")
                for g in args.groups:
                    W = 8 * g  # walkers per block
                    nb = n_str // W
                    if nb < 1:
                        continue
                    blocks = steps[: nb * W].reshape(nb, W)
                    # walker-iterations paid / walker-steps used
                    tail = (blocks.max(1) * W).sum() / max(
                        blocks.sum(), 1
                    )
                    line += f" tail@g{g}={tail:.2f}x"
                print(line, flush=True)
                if S == 32 and not args.collapse and not args.ribbon:
                    live = steps > 0
                    k_steps, k_leafs = block_counters(
                        dpack, ro, rd, tmax, np.float32(w["tmin"]), any_hit,
                        n_str)
                    print(f"{name} bits={bits} S=32 strand_block counters "
                          f"({args.device}): steps mean="
                          f"{k_steps.mean():.0f} leafs mean="
                          f"{k_leafs.mean():.0f}; sim / kernel over the "
                          f"{int(live.sum())} strands with a live ray: "
                          f"steps {steps[live].sum() / max(k_steps[live].sum(), 1):.3f}"
                          f" leafs {leafs[live].sum() / max(k_leafs[live].sum(), 1):.3f}",
                          flush=True)


    return 0


if __name__ == "__main__":
    raise SystemExit(main())
