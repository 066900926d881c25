"""Procedural benchmark scenes: the port's copy of raytpu's
``benchmarks/scenes.py``, and a cached pack of its atrium.

raytpu benches a Sponza-class *atrium* (BASELINE.json configs 5 and 6)
that it builds procedurally, since no such asset ships with the
reference: a colonnaded courtyard with arched walls, a floor, pillars,
fabric-like awnings, a metal blob, a glass panel and three emissive lamp
quads, tessellated to a target triangle count, with PBR materials and
three point lights. ``_mesh_grid``, ``_cylinder`` and ``build_atrium``
are raytpu's, line for line (its Python index loops included, so the
scene is byte-equal; ``tests/test_torch_scenes.py`` pins it); only the
imports take the port's ``scene/camera.py`` and ``scene/gltf.py``, as
raytpu's module imports raytpu, and with it JAX.

``cached_atrium(tris, device)`` is the port's ``bench.py:_cached_atrium``:
the scene's host pack (``pack_scene(as_numpy=True)``) pickled under the
checkout's ``.bench_cache/`` and moved to ``device``."""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..scene.camera import CameraData, perspective_matrix
from ..scene.gltf import SceneData
from ..scene.pack import pack_scene


def _mesh_grid(nx, nz, scale_x, scale_z, height_fn):
    """Tessellated height-field patch: returns (pos, normal, idx)."""
    xs = np.linspace(-0.5, 0.5, nx) * scale_x
    zs = np.linspace(-0.5, 0.5, nz) * scale_z
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = height_fn(xx, zz)
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    # numeric normals
    dy_dx = np.gradient(yy, axis=0) / max(scale_x / (nx - 1), 1e-6)
    dy_dz = np.gradient(yy, axis=1) / max(scale_z / (nz - 1), 1e-6)
    n = np.stack([-dy_dx, np.ones_like(yy), -dy_dz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = n.reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a = i * nz + j
            b = (i + 1) * nz + j
            idx += [a, b, a + 1, b, b + 1, a + 1]
    return pos, nrm, np.asarray(idx, np.uint32)


def _cylinder(n_seg, n_h, radius, height):
    """Open cylinder (pillar)."""
    thetas = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    hs = np.linspace(0, height, n_h)
    pos, nrm = [], []
    for h in hs:
        for t in thetas:
            pos.append([radius * np.cos(t), h, radius * np.sin(t)])
            nrm.append([np.cos(t), 0.0, np.sin(t)])
    idx = []
    for i in range(n_h - 1):
        for j in range(n_seg):
            a = i * n_seg + j
            b = i * n_seg + (j + 1) % n_seg
            c = (i + 1) * n_seg + j
            d = (i + 1) * n_seg + (j + 1) % n_seg
            idx += [a, c, b, b, c, d]
    return (
        np.asarray(pos, np.float32),
        np.asarray(nrm, np.float32),
        np.asarray(idx, np.uint32),
    )


def build_atrium(target_tris: int = 250_000) -> SceneData:
    """Sponza-class courtyard. target_tris controls tessellation."""
    rng = np.random.default_rng(42)
    positions, normals, uvs, indices = [], [], [], []
    prim_rows, mesh_rows = [], []
    obj_transforms, obj_meshes = [], []
    mats = []

    vert_ctr = 0
    idx_ctr = 0
    prim_ctr = 0

    def add_mesh(parts, transform=np.eye(4, dtype=np.float32)):
        nonlocal vert_ctr, idx_ctr, prim_ctr
        mesh_rows.append((prim_ctr, len(parts)))
        for pos, nrm, idx, mat in parts:
            uv = (pos[:, [0, 2]] * 0.25).astype(np.float32)
            positions.append(pos)
            normals.append(nrm)
            uvs.append(uv)
            indices.append(idx.astype(np.uint32))
            prim_rows.append(
                (vert_ctr, pos.shape[0], idx_ctr, idx.shape[0], mat)
            )
            vert_ctr += pos.shape[0]
            idx_ctr += idx.shape[0]
            prim_ctr += 1
        obj_transforms.append(transform.astype(np.float32))
        obj_meshes.append(len(mesh_rows) - 1)

    def mat(color, metallic=0.0, roughness=0.6, emission=None, ior=None):
        mats.append((metallic, roughness, emission or 0.0, ior or 0.0,
                     list(color) + [1.0]))
        return len(mats) - 1

    stone = mat((0.55, 0.5, 0.45))
    floor_m = mat((0.4, 0.38, 0.35))
    fabric_r = mat((0.7, 0.15, 0.1))
    fabric_g = mat((0.15, 0.5, 0.2))
    metal_m = mat((0.8, 0.75, 0.6), metallic=1.0, roughness=0.2)
    glass_m = mat((0.9, 0.9, 1.0), ior=1.5)
    lamp_m = mat((1.0, 0.9, 0.7), emission=8.0)

    # budget: floor ~30%, walls ~30%, pillars ~25%, awnings ~10%, props ~5%
    gf = max(int(np.sqrt(target_tris * 0.30 / 2)), 8)
    floor = _mesh_grid(
        gf, gf, 30.0, 14.0,
        lambda x, z: 0.02 * np.sin(x * 2.1) * np.cos(z * 1.7),
    )
    add_mesh([(floor[0], floor[1], floor[2], floor_m)])

    gw = max(int(np.sqrt(target_tris * 0.15 / 2)), 8)
    for side, z in ((0, -7.0), (1, 7.0)):
        wall = _mesh_grid(
            gw, gw, 30.0, 10.0,
            lambda x, z_: 0.15 * np.sin(x * 3.0) * np.sin(z_ * 2.0),
        )
        t = np.eye(4, dtype=np.float32)
        # rotate the patch upright (height-field y becomes wall depth)
        rot = np.array(
            [[1, 0, 0], [0, 0, -1 if side else 1], [0, 1 if side else -1, 0]],
            np.float32,
        )
        t[:3, :3] = rot
        t[:3, 3] = [0.0, 5.0, z]
        add_mesh([(wall[0], wall[1], wall[2], stone)], t)

    n_pillars = 14
    seg = max(int(np.sqrt(target_tris * 0.25 / (n_pillars * 2))), 6)
    pillar = _cylinder(seg * 2, seg, 0.45, 7.0)
    for i in range(n_pillars):
        x = -12.0 + (i % 7) * 4.0
        z = -4.5 if i < 7 else 4.5
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [x, 0.0, z]
        add_mesh([(pillar[0], pillar[1], pillar[2], stone)], t)

    ga = max(int(np.sqrt(target_tris * 0.10 / (4 * 2))), 6)
    awning = _mesh_grid(
        ga, ga, 6.0, 4.0,
        lambda x, z: -0.35 * np.cos(x * 0.8) * np.cos(z * 0.9),
    )
    for i, m in enumerate([fabric_r, fabric_g, fabric_r, fabric_g]):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [-9.0 + i * 6.0, 6.5, 0.0]
        add_mesh([(awning[0], awning[1], awning[2], m)], t)

    # props: a metal sphere-ish blob, a glass panel, lamp quads
    gp = max(int(np.sqrt(target_tris * 0.04 / 2)), 6)
    blob = _mesh_grid(
        gp, gp, 3.0, 3.0,
        lambda x, z: 1.2 * np.exp(-(x * x + z * z) * 1.2),
    )
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [3.0, 0.05, 1.5]
    add_mesh([(blob[0], blob[1], blob[2], metal_m)], t)

    panel = _mesh_grid(8, 8, 3.0, 3.0, lambda x, z: x * 0.0)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    t[:3, 3] = [-5.0, 2.0, 2.0]
    add_mesh([(panel[0], panel[1], panel[2], glass_m)], t)

    lamp = _mesh_grid(4, 4, 1.0, 1.0, lambda x, z: x * 0.0)
    for x in (-10.0, 0.0, 10.0):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [x, 8.5, 0.0]
        add_mesh([(lamp[0], lamp[1], lamp[2], lamp_m)], t)

    # lights: three points in the open courtyard volume (below the
    # awnings at y=6.5, so direct light actually reaches the floor)
    light_transforms, light_colors, light_powers = [], [], []
    for x, c in [(-10.0, (1.0, 0.95, 0.9)), (0.0, (1.0, 1.0, 1.0)),
                 (10.0, (0.9, 0.95, 1.0))]:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [x, 4.5, 2.5]
        light_transforms.append(t)
        light_colors.append(list(c) + [0.0])
        light_powers.append(800.0)

    prim_arr = np.asarray(prim_rows, np.int64)
    mesh_arr = np.asarray(mesh_rows, np.int64)
    mat_arr = np.asarray([m[:4] for m in mats], np.float32)

    # camera: inside the courtyard looking down the long axis
    proj = perspective_matrix(16.0 / 9.0, 0.9, 0.1, 200.0)
    world = np.eye(4, dtype=np.float32)
    # look from (-13, 2.2, 0) toward +x
    world[:3, :3] = np.array(
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32
    )
    world[:3, 3] = [-13.0, 2.2, 0.0]
    camera = CameraData(
        world=world,
        projection=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
    )

    return SceneData(
        vertex_pos=np.concatenate(positions).astype(np.float32),
        vertex_normal=np.concatenate(normals).astype(np.float32),
        vertex_uv=np.concatenate(uvs).astype(np.float32),
        indices=np.concatenate(indices).astype(np.uint32),
        prim_vertex_start=prim_arr[:, 0],
        prim_vertex_count=prim_arr[:, 1],
        prim_index_start=prim_arr[:, 2],
        prim_index_count=prim_arr[:, 3],
        prim_material=prim_arr[:, 4],
        mesh_primitive_start=mesh_arr[:, 0],
        mesh_primitive_count=mesh_arr[:, 1],
        object_transform=np.stack(obj_transforms),
        object_mesh=np.asarray(obj_meshes, np.int64),
        mat_metallic=mat_arr[:, 0],
        mat_roughness=mat_arr[:, 1],
        mat_emission=mat_arr[:, 2],
        mat_ior=mat_arr[:, 3],
        mat_texture=np.zeros(len(mats), np.int64),
        mat_has_texture=np.zeros(len(mats), np.int64),
        mat_color=np.asarray([m[4] for m in mats], np.float32),
        light_transform=np.stack(light_transforms).astype(np.float32),
        light_color=np.asarray(light_colors, np.float32),
        light_power=np.asarray(light_powers, np.float32),
        textures=[],
        camera=camera,
    )


CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache")
# bump when the ScenePack layout or the scene changes
SCHEMA = 1


def cached_atrium(tris: int, device="cuda", tables: str = "auto",
                  cache: str | None = None):
    """(scene, pack) for ``build_atrium(tris)``: the host pack
    (``pack_scene(scene, as_numpy=True, tables=tables)``) is read from its
    pickle under ``cache`` or built and pickled there, then moved to
    ``device``; ``cache`` defaults to ``CACHE``, the checkout's
    ``.bench_cache/``. The pickles are the port's own
    (``atrium_torch_<tris>_<tables>_v<SCHEMA>.pkl``); raytpu's hold its
    types, and reading them would import raytpu."""
    scene = build_atrium(tris)
    cache = CACHE if cache is None else cache
    key = os.path.join(cache, f"atrium_torch_{tris}_{tables}_v{SCHEMA}.pkl")
    if os.path.exists(key):
        with open(key, "rb") as f:
            host = pickle.load(f)
    else:
        host = pack_scene(scene, as_numpy=True, tables=tables)
        os.makedirs(cache, exist_ok=True)
        tmp = f"{key}.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(host, f)
        os.replace(tmp, key)
    return scene, host.to(device)
