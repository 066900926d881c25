"""The reference's scene tables, worked out again from the scene arrays.

Every (object, primitive, triangle) is instantiated in the scene's own
order (object, then primitive, then index triple): world-space corners
from the object's full affine transform (computed in float64, rounded
once to float32), edges ``e1 = v1 - v0`` and ``e2 = v2 - v0`` in float32,
the object-space corner positions and normals that shading interpolates,
the object's 3x3 linear part, and the material's parameters. Lights are
the translation column of their node transform and their colour.

Nothing here comes from the program: no BVH, no slot order, no packed
row. The reference sweeps these triangles by brute force
(``tracer.py``), so the program's acceleration structures and tables are
judged, not reused.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bvh


def triangles(scene: dict) -> dict:
    """Host numpy tables, one row per scene triangle: ``p0``, ``e1``,
    ``e2`` [T, 3] world space; ``pos`` and ``nrm`` [T, 3, 3] object-space
    corners; ``lin`` [T, 9] the object's row-major 3x3; ``metallic``,
    ``emission``, ``ior`` [T]; ``color`` [T, 4]."""
    out = {k: [] for k in ("p0", "e1", "e2", "pos", "nrm", "lin", "mat")}
    for o in range(scene["object_mesh"].shape[0]):
        m = int(scene["object_mesh"][o])
        xf = scene["object_transform"][o].astype(np.float64)
        first = int(scene["mesh_primitive_start"][m])
        for p in range(first, first + int(scene["mesh_primitive_count"][m])):
            i0 = int(scene["prim_index_start"][p])
            idx = scene["indices"][i0:i0 + int(scene["prim_index_count"][p])]
            vidx = (idx.astype(np.int64)
                    + int(scene["prim_vertex_start"][p])).reshape(-1, 3)
            pos = scene["vertex_pos"][vidx]  # [n, 3 corners, 3]
            world = (pos.astype(np.float64) @ xf[:3, :3].T
                     + xf[:3, 3]).astype(np.float32)
            out["p0"].append(world[:, 0])
            out["e1"].append(world[:, 1] - world[:, 0])
            out["e2"].append(world[:, 2] - world[:, 0])
            out["pos"].append(pos)
            out["nrm"].append(scene["vertex_normal"][vidx])
            n = vidx.shape[0]
            out["lin"].append(np.broadcast_to(
                scene["object_transform"][o][:3, :3].reshape(9), (n, 9)))
            out["mat"].append(np.full(n, int(scene["prim_material"][p])))
    t = {k: np.concatenate(v) for k, v in out.items()}
    mat = t.pop("mat")
    t["metallic"] = scene["mat_metallic"][mat]
    t["emission"] = scene["mat_emission"][mat]
    t["ior"] = scene["mat_ior"][mat]
    t["color"] = scene["mat_color"][mat]
    t["lin"] = np.ascontiguousarray(t["lin"], np.float32)
    return t


class World:
    """The reference's tables on ``device`` in ``dtype``: float32 for the
    reference, a lower precision for its control. Geometry is kept as
    separate [T] columns so that a sweep broadcasts [rays, T] planes;
    with ``tree`` the world also holds a BVH (``bvh.py``), through which
    every sweep then runs."""

    def __init__(self, scene: dict, device, dtype=torch.float32,
                 tree: bool = False):
        if np.any(scene["mat_has_texture"]):
            raise ValueError("the reference shades untextured scenes only")
        tri = triangles(scene)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=device).to(dtype)

        self.device, self.dtype = torch.device(device), dtype
        self.n = int(tri["p0"].shape[0])
        # geometry columns: p0x, p0y, ..., e2z, each [T]
        self.geo = {f"{k}{i}": dev(tri[k][:, i])
                    for k in ("p0", "e1", "e2") for i in range(3)}
        self.pos = dev(tri["pos"])
        self.nrm = dev(tri["nrm"])
        self.lin = dev(tri["lin"])
        self.metallic = dev(tri["metallic"])
        self.emission = dev(tri["emission"])
        self.ior = dev(tri["ior"])
        self.color = dev(tri["color"])
        self.light_pos = dev(scene["light_transform"][:, :3, 3])
        self.light_color = dev(scene["light_color"])
        self.n_lights = int(scene["light_color"].shape[0])
        self.n_lights_f = dev(np.float32(self.n_lights))
        self.cam_world = dev(scene["camera_world"])
        self.cam_proj = dev(scene["camera_projection"])
        self.tree = None
        if tree:
            self.tree = bvh.Tree(bvh.build(tri["p0"], tri["e1"], tri["e2"]),
                                 device)
