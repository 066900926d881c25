"""Treelet decomposition of the 8-wide BVH: a numpy-only copy of
``raytpu.accel.treelets`` (the port's host side cannot import raytpu,
whose package imports JAX). The code below is unchanged, so both packages
cut identical treelets; the text that follows describes the original
package's consumers (on the card every window is read from global memory
by ``raytpu_torch/kernels/csrc/binned_walk.cu``).

Treelet decomposition of the 8-wide BVH for binned wavefront traversal.

The resident packet kernel (kernels/intersect_pallas.py) walks the WHOLE
tree once per 4096-ray packet, so each packet pays for the union of all
its lanes' node visits — measured ~300x redundancy on incoherent bounce
waves (docs/PROFILE_r2.md). This module cuts the tree at a frontier of
subtrees ("treelets") of bounded VMEM footprint so the binned traversal
path (kernels/binned.py) can instead:

1. box-test every ray against the T treelet bounds (dense, vectorised);
2. bin the (ray, treelet) hit pairs by treelet;
3. walk each bin against ONLY its treelet's nodes — the per-packet union
   is bounded by the treelet window, and the windows stream HBM->VMEM per
   grid step, so scenes larger than VMEM work the same way (the TPU
   replacement for the reference scaling to whatever the GPU holds,
   src/state.rs:1145-1246).

The frontier partitions the tree: every node row and every leaf row lands
in exactly one treelet, so a min-combine over a ray's pair results is an
exact closest hit.

Treelet windows are uniform ([T, Sn, 128] nodes, [T, Sl, 128] leaves,
padded with never-hit sentinels) because Pallas BlockSpec index_maps pick
whole blocks; column 9 of each packed triangle carries its *global*
triangle slot (bitcast int32) so hits report scene-level ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import BVH8_WIDTH, LEAF_SIZE, Bvh8Arrays

# default per-treelet budget, in 512-byte VMEM rows (nodes + leaves).
# Smaller treelets cull better but raise per-ray candidate counts (and so
# the binned round count); an 8-wide split lands subtree costs in roughly
# (budget/8, budget]. 2048 rows = 1 MiB per window, ~tens of treelets for
# a 250k-triangle scene, candidate counts p99 <= ~8.
DEFAULT_BUDGET_ROWS = 2048


@dataclass
class TreeletArrays:
    """Device tables for the binned traversal path.

    ``tnodes[t]`` is treelet t's node window in the packet-kernel row
    format (child k at columns [16k, 16k+16): bmin, bmax, link), except
    links are *local*: interior -> node row within the window, leaf ->
    ``~local_leaf_row``. Root is row 0. Padding rows carry inverted boxes.

    ``tleaves[t]`` packs 8 triangles per row like ScenePack.leaf_tris but
    widened to 128 columns, and column ``10k + 9`` of triangle k bitcasts
    the global triangle slot (int32)."""

    tnodes: np.ndarray  # [T, Sn, 128] f32
    tleaves: np.ndarray  # [T, Sl, 128] f32
    tbox_min: np.ndarray  # [T, 3] f32
    tbox_max: np.ndarray  # [T, 3] f32
    n_leaf_rows: np.ndarray  # [T] i32 — real (unpadded) leaf rows

    @property
    def n_treelets(self) -> int:
        return int(self.tnodes.shape[0])


def _decode(node_rows: np.ndarray):
    """(links [N,8] i32, filled [N,8] bool, boxes [N,8,6] f32)."""
    links = np.stack(
        [node_rows[:, 16 * k + 6].view(np.int32) for k in range(BVH8_WIDTH)],
        axis=1,
    )
    filled = np.stack(
        [
            node_rows[:, 16 * k + 0] <= node_rows[:, 16 * k + 3]
            for k in range(BVH8_WIDTH)
        ],
        axis=1,
    )
    boxes = np.stack(
        [node_rows[:, 16 * k : 16 * k + 6] for k in range(BVH8_WIDTH)],
        axis=1,
    )
    return links, filled, boxes


def _subtree_costs(links, filled):
    """Per interior node: (node rows, leaf rows) in its subtree, inclusive.
    Iterative post-order; no assumption on child index ordering."""
    n = links.shape[0]
    nrows = np.zeros(n, np.int64)
    lrows = np.zeros(n, np.int64)
    state = np.zeros(n, np.int8)  # 0 unvisited, 1 children pushed
    stack = [0]
    while stack:
        v = stack[-1]
        kids = [
            links[v, k]
            for k in range(BVH8_WIDTH)
            if filled[v, k] and links[v, k] >= 0
        ]
        leaves = sum(
            1
            for k in range(BVH8_WIDTH)
            if filled[v, k] and links[v, k] < 0
        )
        if state[v] == 0:
            state[v] = 1
            stack.extend(kids)
        else:
            stack.pop()
            nrows[v] = 1 + sum(nrows[c] for c in kids)
            lrows[v] = leaves + sum(lrows[c] for c in kids)
    return nrows, lrows


def build_treelets(
    bvh8: Bvh8Arrays,
    leaf_tris: np.ndarray,
    budget_rows: int = DEFAULT_BUDGET_ROWS,
    leaf_size: int = LEAF_SIZE,
) -> TreeletArrays:
    """Cut the wide tree at a frontier of subtrees whose node+leaf row
    count fits ``budget_rows``, then emit uniform per-treelet windows."""
    node_rows = np.asarray(bvh8.node_rows)
    leaf_tris = np.asarray(leaf_tris)
    links, filled, boxes = _decode(node_rows)
    nrows, lrows = _subtree_costs(links, filled)

    # scene box: union of the root's filled child boxes
    root_kids = filled[0]
    scene_lo = boxes[0][root_kids, 0:3].min(axis=0)
    scene_hi = boxes[0][root_kids, 3:6].max(axis=0)

    # frontier split: (link, box_lo, box_hi); leaf links always stay
    frontier = [(np.int32(0), scene_lo, scene_hi)]
    out = []
    while frontier:
        link, lo, hi = frontier.pop()
        if link >= 0 and nrows[link] + lrows[link] > budget_rows:
            v = int(link)
            for k in range(BVH8_WIDTH):
                if filled[v, k]:
                    frontier.append(
                        (links[v, k], boxes[v, k, 0:3], boxes[v, k, 3:6])
                    )
        else:
            out.append((int(link), lo, hi))

    # pack frontier pieces into window GROUPS (<= BVH8_WIDTH pieces each,
    # combined rows within budget): the 8-wide cut produces piece sizes in
    # (budget/8, budget], so single-piece windows padded to the global max
    # ran ~50% empty (docs/PROFILE_r3.md). Packing preserves emission
    # (DFS) order for spatial locality; a multi-piece window gets a
    # synthetic BVH8 root whose children are the pieces' roots — the
    # kernel's walk (stack starts at local node 0) is unchanged.
    def piece_rows(link):
        if link < 0:
            return 0, 1
        return int(nrows[link]), int(lrows[link])

    # per-dimension caps: Sn and Sl pad to their own maxima across ALL
    # windows, so a node-heavy window and a leaf-heavy window would pad
    # each other; capping both dimensions near the global node:leaf ratio
    # keeps every window's shape close to (Sn, Sl)
    total_n = sum(piece_rows(p[0])[0] for p in out) + len(out)
    total_l = sum(piece_rows(p[0])[1] for p in out)
    frac_n = total_n / max(total_n + total_l, 1)
    n_cap = max(int(budget_rows * frac_n * 1.25), 64)
    l_cap = max(int(budget_rows * (1.0 - frac_n) * 1.25), 64)

    groups = []
    cur, cur_n, cur_l = [], 1, 0
    for piece in out:
        pn, plf = piece_rows(piece[0])
        if cur and (
            len(cur) >= BVH8_WIDTH
            or cur_n + pn > n_cap
            or cur_l + plf > l_cap
        ):
            groups.append(cur)
            cur, cur_n, cur_l = [], 1, 0
        cur.append(piece)
        cur_n += pn
        cur_l += plf
    if cur:
        groups.append(cur)

    def bfs_subtree(link, local_nodes, local_leaves, node_local):
        """Append subtree ``link``'s nodes/leaves, assigning window-local
        ids (node slot = index in local_nodes; None = synthetic root)."""
        start = len(local_nodes)
        node_local[int(link)] = start
        local_nodes.append(int(link))
        qi = start
        while qi < len(local_nodes):
            v = int(local_nodes[qi])
            qi += 1
            for k in range(BVH8_WIDTH):
                if not filled[v, k]:
                    continue
                c = int(links[v, k])
                if c >= 0:
                    node_local[c] = len(local_nodes)
                    local_nodes.append(c)
                else:
                    local_leaves.append(~c)
        return start

    per_nodes, per_leaves, per_box = [], [], []
    for group in groups:
        if len(group) == 1 and group[0][0] >= 0:
            link, lo, hi = group[0]
            local_nodes, local_leaves, node_local = [], [], {}
            bfs_subtree(link, local_nodes, local_leaves, node_local)
            per_nodes.append(("subtree", local_nodes, node_local))
            per_leaves.append(local_leaves)
            per_box.append((lo, hi))
        else:
            # synthetic root at slot 0; child k = piece k's root
            local_nodes = [None]
            local_leaves = []
            node_local = {}
            kids = []  # (lo, hi, node slot or ~local leaf row)
            for link, lo, hi in group:
                if link < 0:
                    kids.append((lo, hi, ~len(local_leaves)))
                    local_leaves.append(~link)
                else:
                    slot = bfs_subtree(
                        link, local_nodes, local_leaves, node_local
                    )
                    kids.append((lo, hi, slot))
            per_nodes.append(("forest", local_nodes, node_local, kids))
            per_leaves.append(local_leaves)
            per_box.append((
                np.minimum.reduce([g[1] for g in group]),
                np.maximum.reduce([g[2] for g in group]),
            ))

    T = len(groups)
    Sn = max(len(spec[1]) for spec in per_nodes)
    Sl = max(len(ls) for ls in per_leaves)
    tnodes = np.zeros((T, Sn, 128), np.float32)
    # padding rows / empty slots: inverted boxes (never hit)
    for k in range(BVH8_WIDTH):
        tnodes[:, :, 16 * k + 0 : 16 * k + 3] = 1.0
        tnodes[:, :, 16 * k + 3 : 16 * k + 6] = -1.0
    tleaves = np.zeros((T, Sl, 128), np.float32)
    tbox_min = np.zeros((T, 3), np.float32)
    tbox_max = np.zeros((T, 3), np.float32)
    n_leaf_rows = np.zeros(T, np.int32)

    lanes = leaf_tris.shape[1]
    for t, ((lo, hi), spec, lls) in enumerate(
        zip(per_box, per_nodes, per_leaves)
    ):
        tbox_min[t] = lo
        tbox_max[t] = hi
        n_leaf_rows[t] = len(lls)
        # leaf windows + global tri ids in column 10k+9
        rows = leaf_tris[np.asarray(lls, np.int64)]
        tleaves[t, : len(lls), :lanes] = rows
        for k in range(leaf_size):
            tleaves[t, : len(lls), 10 * k + 9] = (
                (np.asarray(lls, np.int64) * leaf_size + k)
                .astype(np.int32)
                .view(np.float32)
            )
        local_nodes = spec[1]
        node_local = spec[2]
        leaf_local = {g: i for i, g in enumerate(lls)}
        if spec[0] == "forest":
            # synthetic root row: child k = piece k (box + local link)
            kids = spec[3]
            for k, (klo, khi, tgt) in enumerate(kids):
                tnodes[t, 0, 16 * k + 0 : 16 * k + 3] = klo
                tnodes[t, 0, 16 * k + 3 : 16 * k + 6] = khi
                tnodes[t, 0, 16 * k + 6] = np.int32(tgt).view(np.float32)
        for li, v in enumerate(local_nodes):
            if v is None:
                continue  # slot 0 = the synthetic root, emitted above
            src = node_rows[v].copy()
            for k in range(BVH8_WIDTH):
                if not filled[v, k]:
                    continue
                c = int(links[v, k])
                loc = node_local[c] if c >= 0 else ~leaf_local[~c]
                src[16 * k + 6] = np.int32(loc).view(np.float32)
            tnodes[t, li] = src

    return TreeletArrays(
        tnodes=tnodes,
        tleaves=tleaves,
        tbox_min=tbox_min,
        tbox_max=tbox_max,
        n_leaf_rows=n_leaf_rows,
    )


def validate_treelets(
    tl: TreeletArrays, bvh8: Bvh8Arrays, leaf_size: int = LEAF_SIZE
) -> None:
    """Structural checks (used by tests): the frontier partitions the
    tree's leaf rows; local links stay in range; global ids are valid."""
    seen = []
    for t in range(tl.n_treelets):
        nl = int(tl.n_leaf_rows[t])
        for r in range(nl):
            # column 10k+9 of slot k must carry the row's base global slot
            # + k (slot 0's id is the base; the row covers 8 consecutive
            # global triangle slots)
            base = int(tl.tleaves[t, r, 9:10].view(np.int32)[0])
            assert base % leaf_size == 0
            for k in range(leaf_size):
                gid = (
                    tl.tleaves[t, r, 10 * k + 9 : 10 * k + 10]
                    .view(np.int32)[0]
                )
                assert gid == base + k
            seen.append(base // leaf_size)
        links, filled, _ = _decode(tl.tnodes[t])
        interior = filled & (links >= 0)
        leafs = filled & (links < 0)
        assert links[interior].max(initial=0) < tl.tnodes.shape[1]
        assert (~links[leafs]).max(initial=0) < max(nl, 1)
    seen_arr = np.sort(np.asarray(seen))
    assert seen_arr.shape[0] == bvh8.n_leaf_rows
    assert (seen_arr == np.arange(bvh8.n_leaf_rows)).all()
