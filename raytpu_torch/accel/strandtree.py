"""Octant-threaded BVH layout walked by the strand kernel.

A numpy-only copy of ``raytpu.accel.strandtree`` (its ``StrandTree``,
``build_strand_tree`` and ``validate_strand_tree``; the ribbon layout is
not carried over). The code is unchanged, so both packages emit identical
rows.

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
