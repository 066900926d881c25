"""Octant-threaded BVH layout walked by the strand kernel.

A numpy-only copy of ``raytpu.accel.strandtree`` (``StrandTree``,
``build_strand_tree``, ``validate_strand_tree``, ``strand_tree_from_packed``
and the ribbon layout: ``RibbonTree``, ``build_ribbon_tree``,
``validate_ribbon_tree``). The code is unchanged, so both packages emit
identical rows.

Stackless traversal needs the child visit order *baked into the links*,
and near-first ordering keeps closest-hit walks short, so every interior
node stores EIGHT (hit, miss) link pairs, one per ray-direction octant,
each threading a DFS that visits the nearer child (by box-center dot
octant direction) first. A ray walks the threading of its own octant.

Device layout (``StrandTree.rows``): two nodes per 128-lane row; node n
occupies lanes [(n % 2) * 64, ...+64): for octant o, 8 floats at
lane offset o * 8:

    bmin.xyz, bmax.xyz, hit_link, miss_link

Links are VALUE-cast floats (exact for |v| < 2^24): ``hit_link`` = next
node index when the box is hit (interior) or ``~leaf_row`` (leaf — test
triangles, then go to miss), ``miss_link`` = next node when the box
misses (or after a leaf), -1 terminates. The leaf rows are
ScenePack.bvh.leaf_tris.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import BvhArrays

OCTANTS = 8
NODE_LANES = 8  # floats per (node, octant) record


@dataclass
class StrandTree:
    rows: np.ndarray  # [ceil(N/2), 128] f32
    n_nodes: int


RIBBON_NODES_PER_ROW = 16  # 16 nodes x 8 floats = one 128-lane row


@dataclass
class RibbonTree:
    """Per-octant ribbon layout (round 4): each octant's threading is
    renumbered in its OWN near-first DFS pre-order, so an interior node's
    hit link is always ``v + 1`` — a walker's hit-CHAIN is a run of
    consecutive node indices. Rows pack 16 nodes of ONE octant (vs the
    StrandTree's 2 nodes x 8 octants), so while the chain stays inside a
    fetched row the kernel advances WITHOUT a new serialized scalar
    fetch. Captured-wave sim (benchmarks/strand_sim.py --ribbon): 74% of
    ALL transitions stay in a 16-node row -> 2.69x fewer fetches at 4
    sub-steps per fetch. Memory identical to StrandTree (64N floats).

    Row ``o * rows_per_oct + j // 16`` lanes ``(j % 16) * 8 .. +8`` hold
    octant o's renumbered node j: bmin.xyz, bmax.xyz, hit, miss (value-
    cast floats, same link conventions as StrandTree; every octant's
    root is its node 0)."""

    rows: np.ndarray  # [8 * rows_per_oct, 128] f32
    n_nodes: int
    rows_per_oct: int



def _children(bvh: BvhArrays):
    """Reconstruct (left, right) child indices from the canonical threaded
    layout: DFS pre-order means left = n + 1, and the emitter threads a
    left child's miss link to its right sibling (accel/bvh.py
    _emit_threaded)."""
    n = bvh.n_nodes
    interior = bvh.leaf_count == 0
    left = np.where(interior, np.arange(n, dtype=np.int64) + 1, -1)
    right = np.where(interior, bvh.miss[np.minimum(left, n - 1)], -1)
    return interior, left, right


def strand_tree_from_packed(nodes_fused: np.ndarray) -> StrandTree:
    """Build from a ScenePack's fused threaded node rows ([N, 8] f32:
    bmin, bmax, bitcast miss, bitcast leaf_row) — the device-side mirror
    of BvhArrays, enough to reconstruct the topology."""
    nodes_fused = np.asarray(nodes_fused)
    miss = nodes_fused[:, 6].view(np.int32)
    leaf_row = nodes_fused[:, 7].view(np.int32)
    bvh = BvhArrays(
        bmin=nodes_fused[:, 0:3],
        bmax=nodes_fused[:, 3:6],
        miss=miss.astype(np.int32),
        leaf_first=np.where(leaf_row >= 0, leaf_row * 8, -1).astype(np.int32),
        leaf_count=(leaf_row >= 0).astype(np.int32),
        tri_order=np.zeros(0, np.int32),  # unused by the strand build
        leaf_size=8,
    )
    return build_strand_tree(bvh)


def _octant_links(bvh: BvhArrays):
    """Per-octant near-first DFS threading over the FIXED canonical node
    numbering (only the links differ per octant). Returns (hit, miss),
    each [8, N] int64 with the StrandTree link conventions."""
    n = bvh.n_nodes
    interior, left, right = _children(bvh)
    center = (bvh.bmin + bvh.bmax) * 0.5
    leaf_row = np.where(
        bvh.leaf_count > 0, bvh.leaf_first // bvh.leaf_size, -1
    )
    signs = np.array(
        [[1 if (o >> a) & 1 == 0 else -1 for a in range(3)]
         for o in range(OCTANTS)],
        np.float32,
    )  # octant bit a set <=> direction negative along axis a (engine key)
    hit = np.full((OCTANTS, n), -1, np.int64)
    miss = np.full((OCTANTS, n), -1, np.int64)
    interior_list = interior.tolist()
    for o in range(OCTANTS):
        s = signs[o]
        # near child first: smaller box-center projection along the octant
        # direction (s has the direction's per-axis signs)
        dl = center[np.maximum(left, 0)] @ s
        dr = center[np.maximum(right, 0)] @ s
        first = np.where(dl <= dr, left, right)
        second = np.where(dl <= dr, right, left)
        # the near-first DFS threading is a 2-term recurrence —
        # miss[first[v]] = second[v], miss[second[v]] = miss[v] — and the
        # canonical numbering is a DFS pre-order (children index > parent),
        # so one ascending pass resolves it without a stack. Plain lists:
        # per-element numpy indexing is ~10x slower at 100k+ nodes.
        hl = hit[o].tolist()
        ml = miss[o].tolist()
        fl = first.tolist()
        sl = second.tolist()
        lr = leaf_row.tolist()
        for v in range(n):
            if interior_list[v]:
                f = fl[v]
                sec = sl[v]
                hl[v] = f
                ml[f] = sec
                ml[sec] = ml[v]
            else:
                hl[v] = ~lr[v]
        hit[o] = hl
        miss[o] = ml
    return hit, miss


def build_strand_tree(bvh: BvhArrays) -> StrandTree:
    n = bvh.n_nodes
    hit, miss = _octant_links(bvh)
    rows = np.zeros((-(-n // 2), 128), np.float32)
    node = np.arange(n)
    base = (node % 2) * 64
    for o in range(OCTANTS):
        lo = base + o * NODE_LANES
        r = node // 2
        for a in range(3):
            rows[r, lo + a] = bvh.bmin[:, a]
            rows[r, lo + 3 + a] = bvh.bmax[:, a]
        rows[r, lo + 6] = hit[o].astype(np.float32)
        rows[r, lo + 7] = miss[o].astype(np.float32)
    return StrandTree(rows=rows, n_nodes=n)


def build_ribbon_tree(bvh: BvhArrays) -> RibbonTree:
    """Ribbon layout: per-octant renumbering in near-first DFS pre-order
    (hit == v + 1 for interiors) packed 16 nodes of one octant per row —
    see the RibbonTree docstring. The node-visit SEQUENCE of any walk is
    identical to the StrandTree's (same threading, renumbered), so the
    traversal results are bit-identical."""
    n = bvh.n_nodes
    hit, miss = _octant_links(bvh)
    rpo = -(-n // RIBBON_NODES_PER_ROW)
    rows = np.zeros((OCTANTS * rpo, 128), np.float32)
    # padded tail slots: inverted boxes (never hit) + terminating links;
    # unreachable (no link points there) but inert even if fetched
    pad_cols = np.tile(
        np.array([np.inf, np.inf, np.inf, -np.inf, -np.inf, -np.inf,
                  -1.0, -1.0], np.float32),
        RIBBON_NODES_PER_ROW,
    )
    rows[:] = pad_cols
    interior = bvh.leaf_count == 0
    for o in range(OCTANTS):
        h, m = hit[o], miss[o]
        # the always-hit walk (interior -> hit, leaf -> miss) visits every
        # node exactly once in near-first DFS pre-order
        # (validate_strand_tree); its sequence IS the new numbering
        order = np.empty(n, np.int64)
        pos = np.empty(n, np.int64)
        il = interior.tolist()
        hl, ml = h.tolist(), m.tolist()
        v = 0
        for i in range(n):
            order[i] = v
            pos[v] = i
            v = hl[v] if il[v] else ml[v]
            if v == -1:
                assert i == n - 1, "threading dropped nodes"
        # renumber links: leaf hit payloads (~leaf_row < 0) verbatim;
        # -1 miss terminators verbatim
        nhit = np.where(h >= 0, pos[np.maximum(h, 0)], h)[order]
        nmiss = np.where(m >= 0, pos[np.maximum(m, 0)], m)[order]
        assert (
            nhit[interior[order]] == np.flatnonzero(interior[order]) + 1
        ).all(), "pre-order renumbering must make hit == v + 1"
        j = np.arange(n)
        r = o * rpo + j // RIBBON_NODES_PER_ROW
        lo = (j % RIBBON_NODES_PER_ROW) * NODE_LANES
        for a in range(3):
            rows[r, lo + a] = bvh.bmin[order, a]
            rows[r, lo + 3 + a] = bvh.bmax[order, a]
        rows[r, lo + 6] = nhit.astype(np.float32)
        rows[r, lo + 7] = nmiss.astype(np.float32)
    return RibbonTree(rows=rows, n_nodes=n, rows_per_oct=rpo)


def validate_strand_tree(tree: StrandTree, bvh: BvhArrays) -> None:
    """Per octant: the always-hit walk (interior -> hit link, leaf -> miss
    link) must visit every node exactly once before terminating at -1,
    boxes must match the canonical tree, and leaf links must carry the
    canonical leaf rows."""
    n = tree.n_nodes
    leaf_row = np.where(
        bvh.leaf_count > 0, bvh.leaf_first // bvh.leaf_size, -1
    )
    interior = bvh.leaf_count == 0
    for o in range(OCTANTS):
        hit_l = np.zeros(n, np.int64)
        miss_l = np.zeros(n, np.int64)
        for v in range(n):
            r, lo = v // 2, (v % 2) * 64 + o * NODE_LANES
            hit_l[v] = int(tree.rows[r, lo + 6])
            miss_l[v] = int(tree.rows[r, lo + 7])
            np.testing.assert_array_equal(
                tree.rows[r, lo : lo + 3], bvh.bmin[v]
            )
            np.testing.assert_array_equal(
                tree.rows[r, lo + 3 : lo + 6], bvh.bmax[v]
            )
            if not interior[v]:
                assert ~hit_l[v] == leaf_row[v], (o, v)
        visited = np.zeros(n, bool)
        v, steps = 0, 0
        while v != -1:
            assert not visited[v], f"octant {o}: node {v} revisited"
            visited[v] = True
            v = int(hit_l[v] if interior[v] else miss_l[v])
            steps += 1
            assert steps <= n
        assert visited.all(), f"octant {o}: threading drops nodes"


def validate_ribbon_tree(
    tree: RibbonTree, strand: StrandTree, bvh: BvhArrays
) -> None:
    """Per octant: walking the ribbon from its root must visit the SAME
    box/leaf sequence as walking the StrandTree from node 0 under every
    branch outcome summary — verified by replaying the always-hit walk
    (which covers every node) and checking box + leaf-payload equality
    step by step, plus hit == v + 1 for interiors."""
    n = tree.n_nodes
    rpo = tree.rows_per_oct
    K = RIBBON_NODES_PER_ROW
    interior = bvh.leaf_count == 0
    for o in range(OCTANTS):
        def rib(j):
            r, lo = o * rpo + j // K, (j % K) * NODE_LANES
            return tree.rows[r, lo : lo + NODE_LANES]

        def strd(v):
            r, lo = v // 2, (v % 2) * 64 + o * NODE_LANES
            return strand.rows[r, lo : lo + NODE_LANES]

        v, j, steps = 0, 0, 0
        while v != -1:
            sv, rj = strd(v), rib(j)
            np.testing.assert_array_equal(rj[:6], sv[:6])
            is_int = interior[v]
            if is_int:
                assert int(rj[6]) == j + 1, (o, j)
            else:
                assert int(rj[6]) == int(sv[6]), (o, j)  # ~leaf_row
            # same NEXT box under a miss: either both terminate or the
            # miss targets carry identical records
            mv, mj = int(sv[7]), int(rj[7])
            assert (mv == -1) == (mj == -1), (o, j)
            if mv != -1:
                np.testing.assert_array_equal(rib(mj)[:6], strd(mv)[:6])
            v = int(sv[6]) if is_int else int(sv[7])
            j = int(rj[6]) if is_int else int(rj[7])
            steps += 1
            assert steps <= n
        assert j == -1, o
