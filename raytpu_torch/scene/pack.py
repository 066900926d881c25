"""Lower host SceneData to the device ScenePack (torch tensors).

The same tables as ``raytpu.scene.pack.pack_scene``, built the same way in
numpy and then placed on the requested device:

* **World-space triangle flattening.** Each instance's triangles are baked
  into world space once, so no per-ray transforms run in the hot loop.
* **One row per lookup.** Everything shading needs for a hit is packed
  into one ``tri_row`` (see raytpu_torch.types).
* **BVH leaf ordering.** Triangles are stored in BVH leaf order with
  ``leaf_size`` alignment and degenerate padding, so a leaf visit reads
  one contiguous row of ``leaf_tris``.
* **Traversal layouts.** The 8-wide BVH (``node8_rows``) serves the
  packet route (flat mode and every wave of a scene of <= 256 slots). Its
  depth is checked against the packet walk's stack bound here, as raytpu
  does. The octant-threaded strand tree is built only above 256 slots
  (raytpu's bounce-sort threshold), where it serves every path-mode wave,
  and only within the table budget below; so is its ribbon layout
  (``RAYTPU_RIBBON``), where raytpu builds it.
  Every pack carries the walks' tie keys (``first_slots``, computed once
  here on ``device`` from the slots' p0/e1/e2).
  The binned route's treelet windows (accel/treelets.py) are built above
  4096 slots, or as ``treelets=`` says. Per-ray results do not depend on
  the route: ties break to the lowest slot.
* **Table budget.** ``TABLE_BUDGET`` (raytpu's 100 MiB VMEM budget)
  decides three tables, by raytpu's TPU rule (raytpu/scene/pack.py:
  279-306): a pack **streams** (drops ``node8_rows``, and ``leaf_tris``
  too when there is no strand tree) under ``tables="stream"``, or under
  ``"auto"`` when it has treelets and its BVH8 and leaf rows, 512 bytes a
  row, exceed the budget; the **strand tree** is built above 256 slots
  only when the strand and leaf rows fit the budget or the pack streams;
  the **ribbon rows** only when they fit and the pack does not stream. A
  streamed scene renders through the strand or the binned route.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..accel.bvh import LEAF_SIZE, build_bvh, bvh8_depth
from ..accel.strandtree import build_ribbon_tree, build_strand_tree
from ..accel.treelets import build_treelets
from ..kernels.packet import STACK_DEPTH
from ..kernels.strand import first_slots
from ..types import BvhPack, CameraPack, ScenePack
from .camera import CameraData
from .gltf import SceneData

# slots above which treelets="auto" builds the binned route's treelets
TREELET_MIN_SLOTS = 4096
# raytpu's VMEM budget for a pack's tables (raytpu/scene/pack.py:279-306),
# each row counted at 128 floats: it decides the stream drop, the strand
# tree and the ribbon rows (``pack_scene``)
TABLE_BUDGET = 100 * 1024 * 1024
ROW_BYTES = 128 * 4


def _sort_min_tris() -> int:
    """Triangle-slot threshold above which bounce waves are coherence-
    sorted and the strand tree is built (engine/render.py's
    ``sort_bounced``): RAYTPU_SORT_MIN_TRIS, default 256, raytpu's knob.
    pack_scene and the engine both read it, so they always agree."""
    return int(os.environ.get("RAYTPU_SORT_MIN_TRIS", "256"))


def flatten_world_triangles(scene: SceneData):
    """Instantiate every (object, primitive, triangle) into world space.

    Returns SoA numpy arrays (p0, e1, e2, vi[3], material, object)."""
    p0s, e1s, e2s, vis, mats, objs = [], [], [], [], [], []
    for o in range(scene.n_objects):
        m = int(scene.object_mesh[o])
        transform = scene.object_transform[o].astype(np.float64)
        start = int(scene.mesh_primitive_start[m])
        count = int(scene.mesh_primitive_count[m])
        for p in range(start, start + count):
            vstart = int(scene.prim_vertex_start[p])
            istart = int(scene.prim_index_start[p])
            icount = int(scene.prim_index_count[p])
            idx = scene.indices[istart : istart + icount].astype(np.int64)
            # indices are primitive-relative; add vertex_start back on
            # (src/shader.wgsl:276-278)
            vidx = (idx + vstart).reshape(-1, 3)
            pos = scene.vertex_pos[vidx.reshape(-1)].reshape(-1, 3, 3)
            # full affine transform (the TLAS instance transform applies
            # translation too; only the *shading* hit point drops it)
            world = pos.astype(np.float64) @ transform[:3, :3].T + transform[:3, 3]
            world = world.astype(np.float32)
            v0 = world[:, 0]
            p0s.append(v0)
            e1s.append(world[:, 1] - v0)
            e2s.append(world[:, 2] - v0)
            vis.append(vidx.astype(np.int32))
            n_tris = vidx.shape[0]
            mats.append(
                np.full(n_tris, int(scene.prim_material[p]), np.int32)
            )
            objs.append(np.full(n_tris, o, np.int32))

    if not p0s:
        z3 = np.zeros((0, 3), np.float32)
        return z3, z3, z3, np.zeros((0, 3), np.int32), np.zeros(0, np.int32), (
            np.zeros(0, np.int32)
        )
    return (
        np.concatenate(p0s),
        np.concatenate(e1s),
        np.concatenate(e2s),
        np.concatenate(vis),
        np.concatenate(mats),
        np.concatenate(objs),
    )


def _pad_textures(textures) -> tuple[np.ndarray, np.ndarray]:
    """Flatten decoded RGBA8 textures into one normalized-f32 texel buffer
    [sum(w*h), 4] plus per-texture (width, height, offset) descriptors.
    Empty scenes get the reference's 1x1 dummy (src/state.rs:613-620)."""
    if not textures:
        textures = [np.zeros((1, 1, 4), np.uint8)]
    desc = np.zeros((len(textures), 3), np.int32)
    chunks = []
    offset = 0
    for i, t in enumerate(textures):
        h, w = t.shape[0], t.shape[1]
        desc[i] = (w, h, offset)
        chunks.append((t.astype(np.float32) / 255.0).reshape(h * w, 4))
        offset += h * w
    return np.concatenate(chunks, axis=0), desc


def _bitcast_i32_to_f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int32).view(np.float32)


def pack_scene(scene: SceneData, device="cuda", leaf_size: int = LEAF_SIZE,
               treelets: str = "auto", tables: str = "auto",
               as_numpy: bool = False) -> ScenePack:
    """Build the ScenePack on ``device`` (the card unless the caller asks
    for the CPU).

    ``treelets``: "auto" builds the binned route's treelet windows for
    scenes above 4096 slots; "always" and "never" force it.
    ``tables`` follows raytpu's TPU branch on every device: "auto" streams
    a pack that has treelets and whose BVH8 and leaf rows exceed
    ``TABLE_BUDGET``; "stream" always streams; "all" never streams, so its
    BVH8 and leaf rows stay whatever their size. A stream pack drops the
    BVH8 rows, and the leaf rows too when it has no strand tree. The
    strand tree (above 256 slots) is built only when the strand and leaf
    rows fit the budget or the pack streams, so an "all" pack over the
    budget has none and ``auto`` routes it to packet, binned, brute or
    bvh as raytpu's TPU branch does.

    ``as_numpy`` returns the same pack with every table a host numpy array
    (``n_lights_f`` an ``np.float32``; ``device`` is not used): exactly
    the arrays of raytpu's ``pack_scene(as_numpy=True)``, plus the port's
    tie keys. Such a pack pickles, and ``ScenePack.to(device)`` turns it
    into tensors there; every render entry point moves it once, to the
    device its caller asks for (the card by default).

    This is also where raytpu's numpy-level scene data crosses into the
    port. Raises ValueError for a BVH8 too deep for the packet walk's
    stack, as raytpu does, or for an unknown ``treelets``/``tables``
    value."""
    if treelets not in ("auto", "always", "never"):
        raise ValueError(f"treelets={treelets!r}: want 'auto', 'always' or "
                         "'never'")
    if tables not in ("auto", "stream", "all"):
        raise ValueError(f"tables={tables!r}: want 'auto', 'stream' or "
                         "'all'")
    p0, e1, e2, vi, mat, obj = flatten_world_triangles(scene)

    bvh, bvh8 = build_bvh(p0, e1, e2, leaf_size=leaf_size)

    # the packet walk's per-ray stack must provably hold the deepest
    # traversal (<= 8 pushes per level); reject pathological trees here
    depth = bvh8_depth(bvh8.node_rows)
    if 8 * depth + 8 > STACK_DEPTH:
        raise ValueError(
            f"BVH8 depth {depth} exceeds the packet kernel stack bound "
            f"(needs {8 * depth + 8} slots, STACK_DEPTH={STACK_DEPTH})"
        )

    # reorder triangles into BVH leaf order; -1 entries become degenerate
    # padding triangles (e1 = e2 = 0 can never be hit). Pad the slot count
    # so the brute-force sweep's fixed chunk (512) always divides it.
    order = bvh.tri_order
    pad_to = 8 if order.shape[0] <= 512 else 512
    n_slots = max(int(order.shape[0]), pad_to)
    n_slots = -(-n_slots // pad_to) * pad_to
    assert n_slots % leaf_size == 0

    def scatter(arr, fill=0.0):
        out = np.full((n_slots,) + arr.shape[1:], fill, arr.dtype)
        valid = order >= 0
        out[: order.shape[0]][valid] = arr[order[valid]]
        return out

    tri_p0 = scatter(p0)
    tri_e1 = scatter(e1)
    tri_e2 = scatter(e2)
    tri_vi = scatter(vi)
    tri_material = scatter(mat)
    tri_object = scatter(obj)

    # --- fused shade row: one gather per hit (see raytpu_torch.types) ---
    # col layout: 0:9 world p0/e1/e2; 9:18 object-space corner positions;
    # 18:27 corner normals; 27:33 corner uvs; 33:42 object 3x3 linear;
    # 42 metallic, 43 emission, 44 ior, 45 texture id (bitcast),
    # 46 has_texture (bitcast); 47:51 material colour rgba
    t_cnt = n_slots
    tri_row = np.zeros((t_cnt, 64), np.float32)
    tri_row[:, 0:3] = tri_p0
    tri_row[:, 3:6] = tri_e1
    tri_row[:, 6:9] = tri_e2
    vp = scene.vertex_pos if scene.vertex_pos.size else np.zeros((1, 3), np.float32)
    vn = (
        scene.vertex_normal if scene.vertex_normal.size
        else np.zeros((1, 3), np.float32)
    )
    vt = scene.vertex_uv if scene.vertex_uv.size else np.zeros((1, 2), np.float32)
    for k in range(3):
        ids = tri_vi[:, k]
        tri_row[:, 9 + 3 * k : 12 + 3 * k] = vp[ids]
        tri_row[:, 18 + 3 * k : 21 + 3 * k] = vn[ids]
        tri_row[:, 27 + 2 * k : 29 + 2 * k] = vt[ids]
    if scene.n_objects:
        lin9 = scene.object_transform[:, :3, :3].reshape(-1, 9)
        tri_row[:, 33:42] = lin9[np.clip(tri_object, 0, scene.n_objects - 1)]
    else:
        tri_row[:, [33, 37, 41]] = 1.0
    if scene.mat_metallic.shape[0]:
        mid = np.clip(tri_material, 0, scene.mat_metallic.shape[0] - 1)
        tri_row[:, 42] = scene.mat_metallic[mid]
        tri_row[:, 43] = scene.mat_emission[mid]
        tri_row[:, 44] = scene.mat_ior[mid]
        tri_row[:, 45] = _bitcast_i32_to_f32(scene.mat_texture[mid])
        tri_row[:, 46] = _bitcast_i32_to_f32(scene.mat_has_texture[mid])
        tri_row[:, 47:51] = scene.mat_color[mid]

    # BVH fused node rows + leaf rows
    n_nodes = bvh.n_nodes
    nodes = np.zeros((n_nodes, 8), np.float32)
    nodes[:, 0:3] = bvh.bmin
    nodes[:, 3:6] = bvh.bmax
    nodes[:, 6] = _bitcast_i32_to_f32(bvh.miss)
    leaf_row = np.where(bvh.leaf_first >= 0, bvh.leaf_first // leaf_size, -1)
    nodes[:, 7] = _bitcast_i32_to_f32(leaf_row.astype(np.int32))

    n_leaf_rows = t_cnt // leaf_size
    leaf_tris = np.zeros((n_leaf_rows, 10 * leaf_size), np.float32)
    per_tri = np.concatenate(
        [tri_p0, tri_e1, tri_e2, np.zeros((t_cnt, 1), np.float32)], axis=1
    )  # [T,10]
    leaf_tris[:] = per_tri.reshape(n_leaf_rows, leaf_size * 10)

    # --- objects / materials / lights ---
    if scene.n_objects == 0:
        obj_linear = np.zeros((1, 16), np.float32)
        obj_linear[0, [0, 4, 8]] = 1.0
    else:
        obj_linear = np.zeros((scene.n_objects, 16), np.float32)
        obj_linear[:, :9] = scene.object_transform[:, :3, :3].reshape(-1, 9)

    n_mats = max(scene.mat_metallic.shape[0], 1)
    mat_table = np.zeros((n_mats, 16), np.float32)
    if scene.mat_metallic.shape[0]:
        mat_table[:, 0] = scene.mat_metallic
        mat_table[:, 1] = scene.mat_roughness
        mat_table[:, 2] = scene.mat_emission
        mat_table[:, 3] = scene.mat_ior
        mat_table[:, 4] = _bitcast_i32_to_f32(scene.mat_texture)
        mat_table[:, 5] = _bitcast_i32_to_f32(scene.mat_has_texture)
        mat_table[:, 8:12] = scene.mat_color

    n_lights = scene.n_lights
    light_table = np.zeros((max(n_lights, 1), 8), np.float32)
    if n_lights > 0:
        # position = translation column of the node transform
        # (light.transform * (0,0,0,1), src/shader.wgsl:175)
        light_table[:, 0:3] = scene.light_transform[:, :3, 3]
        light_table[:, 4:8] = scene.light_color

    atlas, sizes = _pad_textures(scene.textures)

    tl = None
    if treelets == "always" or (treelets == "auto"
                                and n_slots > TREELET_MIN_SLOTS):
        tl = build_treelets(bvh8, leaf_tris)
    leaf_bytes = leaf_tris.shape[0] * ROW_BYTES
    stream = tables == "stream" or (
        tables == "auto" and tl is not None
        and bvh8.node_rows.shape[0] * ROW_BYTES + leaf_bytes > TABLE_BUDGET)
    strand_fits = -(-bvh.n_nodes // 2) * ROW_BYTES + leaf_bytes <= TABLE_BUDGET
    strand_rows = ribbon_rows = None
    if n_slots > _sort_min_tris() and (strand_fits or stream):
        strand_rows = build_strand_tree(bvh).rows
        # the same node budget in another numbering; stream packs walk the
        # strand layout only
        if strand_fits and not stream:
            ribbon_rows = build_ribbon_tree(bvh).rows

    def conv(x):
        if x is None:
            return None
        x = np.ascontiguousarray(x)
        return x if as_numpy else torch.from_numpy(x).to(device)

    tri_row_t = conv(tri_row)
    first = first_slots(torch.as_tensor(tri_row_t))
    return ScenePack(
        tri_row=tri_row_t,
        object_linear=conv(obj_linear),
        mat_table=conv(mat_table),
        light_table=conv(light_table),
        n_lights_f=(np.float32(n_lights) if as_numpy
                    else torch.tensor(np.float32(n_lights), device=device)),
        scene_bmin=conv(bvh.bmin[0]),
        scene_bmax=conv(bvh.bmax[0]),
        tex_atlas=conv(atlas),
        tex_size=conv(np.asarray(sizes, np.int32)),
        bvh=BvhPack(
            nodes=conv(nodes),
            node8_rows=None if stream else conv(bvh8.node_rows),
            leaf_tris=(None if stream and strand_rows is None
                       else conv(leaf_tris)),
            first_slots=first.numpy() if as_numpy else first,
            strand_rows=conv(strand_rows),
            ribbon_rows=conv(ribbon_rows),
        ),
        has_textures=len(scene.textures) > 0,
        tl_nodes=None if tl is None else conv(tl.tnodes),
        tl_leaves=None if tl is None else conv(tl.tleaves),
        tl_bmin=None if tl is None else conv(tl.tbox_min),
        tl_bmax=None if tl is None else conv(tl.tbox_max),
    )


def pack_camera(camera: CameraData, device="cuda") -> CameraPack:
    return CameraPack(
        world=torch.as_tensor(np.asarray(camera.world, np.float32),
                              device=device),
        projection=torch.as_tensor(
            np.asarray(camera.projection, np.float32), device=device
        ),
    )
