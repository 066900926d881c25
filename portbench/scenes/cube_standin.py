"""The cube stand-in: the upstream's one shipped scene and camera, frozen here.

The upstream ships ``cube.glb`` (one mesh of 24 vertices and 36 indices,
one PBR material, one point light) and a ``camera.json`` look-at camera.
The repository holds neither file, so this is the stand-in that
``raytpu_torch/tools/scenes.py:write_cube`` and ``write_cube_camera``
write from repository code, with the values raytpu's tests pin: a box of
half-size 1 with per-face normals (``tests/tools/glb_writer.py:box``),
colour 0.8, metallic 0, roughness 0.5, and a light at (4.0762, 5.9039,
-1.0055) of colour (1, 1, 1, 0) and power 54351.41; camera origin
(0, 0, -20), looking at the origin, fov 0.3.

The arrays are what the port's ``load_scene`` and
``load_camera_json(..., width, height)`` give for that GLB and that
camera file, under the port's ``SceneData`` field names, with the camera
as ``camera_world`` and ``camera_projection``: a copy that imports
nothing of the program (the benchmark's tests pin it bit for bit to the
program's loader). The camera's aspect is the frame's, as the camera
file's path computes it.
"""

from __future__ import annotations

import numpy as np

from portbench.scenes.atrium import perspective_matrix

LIGHT = (4.0762, 5.9039, -1.0055)
POWER = 54351.41
ORIGIN, AT, FOV = (0.0, 0.0, -20.0), (0.0, 0.0, 0.0), 0.3


def box(size: float = 1.0):
    """(pos, normal, uv, indices): an axis-aligned cube with per-face
    normals, 24 vertices and 36 indices, in ``glb_writer.box``'s order."""
    faces = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            c = n * size
            faces.append((np.array([c - u * size - v * size,
                                    c + u * size - v * size,
                                    c + u * size + v * size,
                                    c - u * size + v * size], np.float32),
                          n))
    pos = np.concatenate([f[0] for f in faces])
    nrm = np.concatenate([np.tile(f[1], (4, 1)) for f in faces])
    uv = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                 (6, 1))
    idx = np.concatenate([np.array([0, 1, 2, 0, 2, 3], np.uint32) + 4 * i
                          for i in range(6)])
    return pos.astype(np.float32), nrm.astype(np.float32), uv, idx


def look_at(eye, center, up) -> np.ndarray:
    """``nalgebra_glm::look_at``: a right-handed view matrix."""
    eye, center, up = (np.asarray(a, np.float64) for a in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s.dot(eye), -u.dot(eye), f.dot(eye)
    return m.astype(np.float32)


def build(width: int, height: int) -> dict:
    """The stand-in's arrays, its camera made for a ``width`` x ``height``
    frame: the camera file's view matrix used as the camera's world
    transform, and the inverse of a perspective with near 100 and far
    0.001 (the upstream's reversed pair)."""
    pos, nrm, uv, idx = box()
    light = np.eye(4, dtype=np.float32)
    light[:3, 3] = LIGHT
    proj = perspective_matrix(width / height, FOV, 100.0, 0.001)
    one = np.ones(1, np.int64)
    zero = np.zeros(1, np.int64)
    return dict(
        vertex_pos=pos, vertex_normal=nrm, vertex_uv=uv, indices=idx,
        prim_vertex_start=zero, prim_vertex_count=one * pos.shape[0],
        prim_index_start=zero.copy(), prim_index_count=one * idx.shape[0],
        prim_material=zero.copy(),
        mesh_primitive_start=zero.copy(), mesh_primitive_count=one.copy(),
        object_transform=np.eye(4, dtype=np.float32)[None],
        object_mesh=zero.copy(),
        mat_metallic=np.zeros(1, np.float32),
        mat_roughness=np.full(1, 0.5, np.float32),
        mat_emission=np.zeros(1, np.float32),
        mat_ior=np.zeros(1, np.float32),
        mat_texture=zero.copy(), mat_has_texture=zero.copy(),
        mat_color=np.array([[0.8, 0.8, 0.8, 1.0]], np.float32),
        light_transform=light[None],
        light_color=np.array([[1.0, 1.0, 1.0, 0.0]], np.float32),
        light_power=np.full(1, POWER, np.float32),
        camera_world=look_at(ORIGIN, AT, (0.0, 1.0, 0.0)),
        camera_projection=np.linalg.inv(
            proj.astype(np.float64)).astype(np.float32),
    )
