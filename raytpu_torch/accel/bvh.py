"""Software bounding-volume hierarchy: a numpy-only copy of raytpu.accel.bvh
(the port's host side cannot import raytpu, whose package imports JAX).
The code below is unchanged, so both packages build identical trees; the
text that follows describes the original package's consumers.

The reference leans on wgpu hardware acceleration structures (BLAS-per-object
+ TLAS, src/state.rs:1145-1246; traversal via WGSL ``ray_query``,
src/shader.wgsl:312-319). TPUs have no ray units, so this module owns that
subsystem in software. Two device layouts are emitted from one binned-SAH
binary build:

* **Threaded (skip-link) binary layout** — DFS order, one fused 8-float row
  per node — traversed by the pure-XLA ``lax.while_loop`` path (one row
  gather per step). Works on any backend; used on CPU and as fallback.
* **8-wide (BVH8) layout** — the binary tree collapsed so each node packs
  its 8 children's boxes + links into exactly one 128-lane f32 row, and each
  leaf packs 8 triangles into one row. This feeds the Pallas packet
  traversal kernel, where Mosaic requires dynamic indexing on the sublane
  dimension only and pads the lane dimension to 128 — a 128-wide row is the
  natural unit. Wide branching also cuts traversal depth ~3x.

Both share one triangle order (leaf-contiguous, padded to ``LEAF_SIZE`` with
degenerate triangles), so the scene packer reorders geometry once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
LEAF_SIZE = 8  # triangles per (padded) leaf; fixed across builder and kernels
BVH8_WIDTH = 8  # children per wide node


@dataclass
class BvhArrays:
    """Threaded flat binary BVH (XLA path).

    Node ``i``'s first child (when interior) is ``i + 1`` (DFS order);
    ``miss[i]`` is the node to visit when the ray misses ``i``'s box or has
    finished ``i``'s leaf (-1 terminates traversal). Leaves reference
    ``LEAF_SIZE``-aligned entries of ``tri_order`` starting at
    ``leaf_first[i]``; padding entries are -1."""

    bmin: np.ndarray  # [N,3] f32
    bmax: np.ndarray  # [N,3] f32
    miss: np.ndarray  # [N] i32
    leaf_first: np.ndarray  # [N] i32 (-1 for interior nodes)
    leaf_count: np.ndarray  # [N] i32 (0 for interior nodes)
    tri_order: np.ndarray  # [n_leaves * LEAF_SIZE] i32, -1 = padding
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return int(self.miss.shape[0])


@dataclass
class Bvh8Arrays:
    """8-wide BVH for the Pallas packet kernel.

    ``node_rows``: [N, 128] f32. Child k of a node occupies columns
    [16k, 16k+16): bmin(3), bmax(3), then column 16k+6 bitcasts an int32
    link — ``child_node_index`` for interior children, ``~leaf_row`` (i.e.
    -leaf_row - 1) for leaf children; empty slots carry an inverted box that
    can never be hit and link 0. Leaf row j covers triangle slots
    [8j, 8j+8) of the shared leaf-ordered triangle arrays."""

    node_rows: np.ndarray  # [N, 128] f32
    n_leaf_rows: int


def _sah_split(
    centroids: np.ndarray,
    tri_bmin: np.ndarray,
    tri_bmax: np.ndarray,
    ids: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Binned SAH split of ``ids``: returns (left_ids, right_ids), or None
    when the centroids are degenerate on every axis."""
    n = ids.shape[0]
    c = centroids[ids]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    extent = cmax - cmin
    for axis in np.argsort(-extent):
        if extent[axis] <= 0.0:
            continue
        scale = N_BINS * (1.0 - 1e-6) / extent[axis]
        bins = np.minimum(
            ((c[:, axis] - cmin[axis]) * scale).astype(np.int32), N_BINS - 1
        )
        counts = np.bincount(bins, minlength=N_BINS)
        binned_min = np.full((N_BINS, 3), np.inf, np.float32)
        binned_max = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(binned_min, bins, tri_bmin[ids])
        np.maximum.at(binned_max, bins, tri_bmax[ids])
        # sweep: SAH cost of splitting after bin k
        lmin = np.minimum.accumulate(binned_min, axis=0)
        lmax = np.maximum.accumulate(binned_max, axis=0)
        rmin = np.minimum.accumulate(binned_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binned_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = n - lcount

        def area(lo, hi):
            d = np.maximum(hi - lo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = area(lmin, lmax)[:-1] * lcount[:-1] + area(rmin[1:], rmax[1:]) * (
            rcount[:-1]
        )
        cost = np.where((lcount[:-1] == 0) | (rcount[:-1] == 0), np.inf, cost)
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            continue
        go_left = bins <= best
        return ids[go_left], ids[~go_left]
    return None


class _BinaryTree:
    """Intermediate binary SAH tree shared by both emitted layouts.
    record := [leaf_ids | None, left_rec, right_rec, bmin, bmax]"""

    def __init__(self, tri_p0, tri_e1, tri_e2, leaf_size):
        v0 = tri_p0
        v1 = tri_p0 + tri_e1
        v2 = tri_p0 + tri_e2
        self.tri_bmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
        self.tri_bmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
        self.centroids = ((self.tri_bmin + self.tri_bmax) * 0.5).astype(
            np.float32
        )
        self.leaf_size = leaf_size
        self.records: list[list] = []
        self.root = self._build(np.arange(tri_p0.shape[0], dtype=np.int64))
        # leaf rows assigned in DFS order -> shared triangle order
        self.tri_order: list[int] = []
        self.leaf_row_of_rec: dict[int, int] = {}
        self._assign_leaves()

    # beyond this depth splits switch to medians, bounding tree depth (and
    # therefore the packet kernel's traversal stack) even for adversarial
    # SAH cases
    MAX_SAH_DEPTH = 32

    def _build(self, ids_root: np.ndarray) -> int:
        work = [(ids_root, None, None, 0)]  # (ids, parent, child_slot, depth)
        root_rec = None
        while work:
            ids, parent, slot, depth = work.pop()
            b_lo = self.tri_bmin[ids].min(axis=0)
            b_hi = self.tri_bmax[ids].max(axis=0)
            split = None
            if ids.shape[0] > self.leaf_size:
                if depth < self.MAX_SAH_DEPTH:
                    split = _sah_split(
                        self.centroids, self.tri_bmin, self.tri_bmax, ids
                    )
                if split is None:
                    # degenerate centroids or depth bound: median split
                    half = ids.shape[0] // 2
                    split = (ids[:half], ids[half:])
            rec = len(self.records)
            if split is None:
                self.records.append([ids, -1, -1, b_lo, b_hi])
            else:
                self.records.append([None, -1, -1, b_lo, b_hi])
                work.append((split[1], rec, 2, depth + 1))
                work.append((split[0], rec, 1, depth + 1))
            if parent is None:
                root_rec = rec
            else:
                self.records[parent][slot] = rec
        return root_rec

    def _assign_leaves(self):
        stack = [self.root]
        while stack:
            rec = stack.pop()
            ids, left, right, _, _ = self.records[rec]
            if ids is None:
                stack.append(right)
                stack.append(left)
            else:
                self.leaf_row_of_rec[rec] = len(self.tri_order) // (
                    self.leaf_size
                )
                self.tri_order.extend(int(i) for i in ids)
                self.tri_order.extend(
                    [-1] * ((-ids.shape[0]) % self.leaf_size)
                )


def _emit_threaded(tree: _BinaryTree) -> BvhArrays:
    records = tree.records
    n_nodes = len(records)
    bmin_arr = np.empty((n_nodes, 3), np.float32)
    bmax_arr = np.empty((n_nodes, 3), np.float32)
    miss_arr = np.empty(n_nodes, np.int32)
    leaf_first_arr = np.full(n_nodes, -1, np.int32)
    leaf_count_arr = np.zeros(n_nodes, np.int32)

    # DFS pre-order with miss links: a left child's miss is its right
    # sibling; record ids resolve to flat indices afterwards.
    flat_of_rec: dict[int, int] = {}
    walk: list[tuple[int, int]] = [(tree.root, -1)]
    emitted: list[tuple[int, int]] = []
    while walk:
        rec, miss_rec = walk.pop()
        flat_of_rec[rec] = len(emitted)
        emitted.append((rec, miss_rec))
        ids, left, right, _, _ = records[rec]
        if ids is None:
            walk.append((right, miss_rec))
            walk.append((left, right))

    for idx, (rec, miss_rec) in enumerate(emitted):
        ids, left, right, b_lo, b_hi = records[rec]
        bmin_arr[idx] = b_lo
        bmax_arr[idx] = b_hi
        miss_arr[idx] = -1 if miss_rec == -1 else flat_of_rec[miss_rec]
        if ids is not None:
            leaf_first_arr[idx] = tree.leaf_row_of_rec[rec] * tree.leaf_size
            leaf_count_arr[idx] = ids.shape[0]

    return BvhArrays(
        bmin=bmin_arr,
        bmax=bmax_arr,
        miss=miss_arr,
        leaf_first=leaf_first_arr,
        leaf_count=leaf_count_arr,
        tri_order=np.asarray(tree.tri_order, np.int32),
        leaf_size=tree.leaf_size,
    )


def _emit_bvh8(tree: _BinaryTree) -> Bvh8Arrays:
    """Collapse the binary tree into 8-wide nodes. Each wide node's children
    are obtained by repeatedly expanding the largest-area interior cluster
    root until 8 slots are filled (or only leaves remain)."""
    records = tree.records

    def area(rec):
        _, _, _, lo, hi = records[rec]
        d = np.maximum(hi - lo, 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def children_of(rec):
        """Cluster roots for the wide node rooted at binary record rec."""
        ids, left, right, _, _ = records[rec]
        if ids is not None:
            return [rec]  # degenerate: root is a single leaf
        slots = [left, right]
        while len(slots) < BVH8_WIDTH:
            # expand the interior slot with the largest surface area
            best, best_a = -1, -1.0
            for i, s in enumerate(slots):
                if records[s][0] is None:
                    a = area(s)
                    if a > best_a:
                        best, best_a = i, a
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([records[s][1], records[s][2]])
        return slots

    # wide nodes are created for the root and for every interior cluster root
    node_index: dict[int, int] = {}
    order: list[int] = []

    def alloc(rec):
        node_index[rec] = len(order)
        order.append(rec)

    alloc(tree.root)
    qi = 0
    node_children: list[list[int]] = []
    while qi < len(order):
        rec = order[qi]
        qi += 1
        slots = children_of(rec)
        node_children.append(slots)
        for s in slots:
            if records[s][0] is None:
                alloc(s)

    n_nodes = len(order)
    rows = np.zeros((n_nodes, 128), np.float32)
    # empty slots: inverted box (min > max) never hit
    for k in range(BVH8_WIDTH):
        rows[:, 16 * k + 0 : 16 * k + 3] = 1.0
        rows[:, 16 * k + 3 : 16 * k + 6] = -1.0

    links = np.zeros((n_nodes, BVH8_WIDTH), np.int32)
    for ni, rec in enumerate(order):
        for k, s in enumerate(node_children[ni]):
            ids, _, _, b_lo, b_hi = records[s]
            rows[ni, 16 * k + 0 : 16 * k + 3] = b_lo
            rows[ni, 16 * k + 3 : 16 * k + 6] = b_hi
            if ids is None:
                links[ni, k] = node_index[s]
            else:
                links[ni, k] = ~tree.leaf_row_of_rec[s]
    for k in range(BVH8_WIDTH):
        rows[:, 16 * k + 6] = links[:, k].view(np.float32)

    return Bvh8Arrays(
        node_rows=rows,
        n_leaf_rows=len(tree.tri_order) // tree.leaf_size,
    )


def build_bvh(
    tri_p0: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    leaf_size: int = LEAF_SIZE,
) -> tuple[BvhArrays, Bvh8Arrays]:
    """Build both device layouts over triangles (p0, p0+e1, p0+e2)."""
    if tri_p0.shape[0] == 0:
        threaded = BvhArrays(
            bmin=np.zeros((1, 3), np.float32),
            bmax=np.full((1, 3), -1.0, np.float32),  # inverted: never hit
            miss=np.full(1, -1, np.int32),
            leaf_first=np.zeros(1, np.int32),
            leaf_count=np.zeros(1, np.int32),
            tri_order=np.full(leaf_size, -1, np.int32),
            leaf_size=leaf_size,
        )
        rows = np.zeros((1, 128), np.float32)
        for k in range(BVH8_WIDTH):
            rows[:, 16 * k + 0 : 16 * k + 3] = 1.0
            rows[:, 16 * k + 3 : 16 * k + 6] = -1.0
            rows[:, 16 * k + 6] = np.int32(~0).view(np.float32)
        return threaded, Bvh8Arrays(node_rows=rows, n_leaf_rows=1)

    # production path: the native C++ builder (raytpu/native); the Python
    # build below is the readable fallback/reference (~100x slower)
    from ..native import native_build_bvh

    native = native_build_bvh(tri_p0, tri_e1, tri_e2, leaf_size)
    if native is not None:
        nodes, wide, order = native
        miss = nodes[:, 6].view(np.int32).copy()
        leaf_row = nodes[:, 7].view(np.int32)
        leaf_first = np.where(
            leaf_row >= 0, leaf_row * leaf_size, -1
        ).astype(np.int32)
        per_leaf = (order.reshape(-1, leaf_size) >= 0).sum(axis=1)
        leaf_count = np.where(
            leaf_row >= 0, per_leaf[np.maximum(leaf_row, 0)], 0
        ).astype(np.int32)
        threaded = BvhArrays(
            bmin=nodes[:, 0:3].copy(),
            bmax=nodes[:, 3:6].copy(),
            miss=miss,
            leaf_first=leaf_first,
            leaf_count=leaf_count,
            tri_order=order,
            leaf_size=leaf_size,
        )
        return threaded, Bvh8Arrays(
            node_rows=wide, n_leaf_rows=order.shape[0] // leaf_size
        )

    tree = _BinaryTree(tri_p0, tri_e1, tri_e2, leaf_size)
    return _emit_threaded(tree), _emit_bvh8(tree)


def validate_bvh(bvh: BvhArrays, n_tris: int) -> None:
    """Structural sanity checks (used by tests)."""
    seen = bvh.tri_order[bvh.tri_order >= 0]
    # every triangle appears at least once; SBVH spatial splits (native
    # builder) may reference a triangle from several leaves — duplicates
    # carry bit-identical data, so the lowest-slot tie break keeps every
    # traversal path agreeing (bvh_builder.cpp)
    assert seen.shape[0] >= n_tris
    assert np.unique(seen).shape[0] == n_tris
    leaves = bvh.leaf_count > 0
    assert (bvh.leaf_first[leaves] >= 0).all()
    ends = bvh.leaf_first[leaves] + bvh.leaf_count[leaves]
    assert (ends <= bvh.tri_order.shape[0]).all()
    # miss links must point strictly forward (DFS pre-order) or terminate
    idx = np.arange(bvh.n_nodes)
    assert ((bvh.miss > idx) | (bvh.miss == -1)).all()


def bvh8_depth(node_rows: np.ndarray) -> int:
    """Depth of the wide tree in node levels (root-only tree = 1), walking
    interior child links breadth-first. Bounds the packet kernel's stack:
    a traversal holds at most BVH8_WIDTH pending children per level, so
    8*depth + 1 SMEM slots suffice (checked against STACK_DEPTH at pack
    time, scene/pack.py)."""
    links = np.stack(
        [node_rows[:, 16 * k + 6].view(np.int32) for k in range(BVH8_WIDTH)],
        axis=1,
    )
    filled = np.stack(
        [
            (node_rows[:, 16 * k + 0] <= node_rows[:, 16 * k + 3])
            for k in range(BVH8_WIDTH)
        ],
        axis=1,
    )
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        child = links[frontier]
        interior = filled[frontier] & (child >= 0)
        frontier = np.unique(child[interior]).astype(np.int64)
    return depth


def validate_bvh8(bvh8: Bvh8Arrays, n_tris: int, leaf_size: int = LEAF_SIZE):
    """Every leaf row must be referenced at most once and cover all tris."""
    rows = bvh8.node_rows
    links = np.stack(
        [rows[:, 16 * k + 6].view(np.int32) for k in range(BVH8_WIDTH)],
        axis=1,
    )
    bmin0 = rows[:, 0:3]
    bmax0 = rows[:, 3:6]
    # filled slots have non-inverted boxes
    filled = np.stack(
        [
            (rows[:, 16 * k + 0] <= rows[:, 16 * k + 3])
            for k in range(BVH8_WIDTH)
        ],
        axis=1,
    )
    leaf_refs = links[filled & (links < 0)]
    leaf_rows = ~leaf_refs
    assert np.unique(leaf_rows).shape[0] == leaf_rows.shape[0]
    assert leaf_rows.max(initial=-1) < bvh8.n_leaf_rows
    covered = leaf_rows.shape[0] * leaf_size
    assert covered >= n_tris
