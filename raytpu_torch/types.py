"""Core value types: render configuration and the device scene pack.

Torch counterparts of ``raytpu.types``. ``ScenePack``, ``BvhPack`` and
``CameraPack`` are dataclasses of tensors on one device; ``.to(device)``
returns a copy on another. They carry only the tables the path-mode
slice reads:

* ``tri_row``     [T, 64]  everything shading needs for one hit in one
                           row: world p0/e1/e2, object-space corner
                           pos/normal/uv, material parameters and colour,
                           the object's 3x3 linear transform
* ``mat_table``   [M, 16]  metallic/roughness/emission/ior/texture ids + rgba
* ``light_table`` [L, 8]   position + colour
* ``bvh.nodes``   [N, 8]   bmin, bmax, miss link, leaf row (bitcast int32)
* ``bvh.node8_rows`` [N8, 128]  the 8-wide BVH of the packet route: child k
                           at columns 16k..16k+6 (bmin, bmax, then the link
                           as int32 bits: child node, or ~leaf_row); None
                           in a ``tables="stream"`` pack
* ``bvh.leaf_tris`` [Nl, 80]  8 triangles x (p0, e1, e2, pad) world space;
                           None in a stream pack without a strand tree
* ``bvh.strand_rows`` [ceil(N/2), 128]  the octant-threaded strand tree,
                           or None (scenes of <= 256 slots have none)
* ``bvh.ribbon_rows`` [8 * ceil(N/16), 128]  the same threading in the
                           ribbon layout (16 nodes of one octant per row,
                           accel/strandtree.py:RibbonTree), where raytpu
                           builds it: with a strand tree, in a pack that
                           is not a stream pack and fits 100 MiB; else None
* ``bvh.first_slots`` [T] i32  each slot's lowest slot holding the same
                           triangle bits: the tie key of every walk
                           (kernels/strand.py:first_slots), in every pack
* ``tl_nodes`` [T, Sn, 128], ``tl_leaves`` [T, Sl, 128], ``tl_bmin`` /
  ``tl_bmax`` [T, 3]     the binned route's treelet windows
                           (accel/treelets.py), or None when the scene was
                           packed without treelets
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; the reference CLI flag surface
    (src/main.rs:30-52) plus raytpu's extensions, with raytpu's defaults."""

    width: int
    height: int
    seed: int
    samples: int
    bounces: int
    chunk_size: int
    mode: str = "path"  # "path" | "flat" — flat = primary-ray base colour
    tile_rows: Optional[int] = None  # rows per render tile; None = auto
    bruteforce_max_tris: int = 2048  # tiling budget switch (_auto_tile_rows)
    # "auto" | "brute" | "bvh" | "packet" | "strand" | "binned"
    intersector: str = "auto"
    # "sorted": coherence-sorted bounce queries with immediate NEE;
    # "binned": deferred NEE, each bounce's shadow rays ride the next
    # bounce's mixed binned query. raytpu's "mixed" is a retired arm and
    # is refused.
    bounce_backend: str = "sorted"


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field moved (None
    fields stay None)."""
    return replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in fields(obj)
        if isinstance(getattr(obj, f.name), (torch.Tensor, BvhPack))
    })


@dataclass(frozen=True)
class BvhPack:
    nodes: torch.Tensor  # [N, 8] f32 (threaded layout; cols 6/7 bitcast i32)
    # [N8, 128] f32 (BVH8; link cols bitcast i32); None in a stream pack
    node8_rows: Optional[torch.Tensor]
    # [Nl, 80] f32; slot of row j, lane k = 8j + k; None in a stream pack
    # without a strand tree
    leaf_tris: Optional[torch.Tensor]
    # [T] i32 tie keys (kernels/strand.py:first_slots), in every pack
    first_slots: torch.Tensor
    # [ceil(N/2), 128] f32 (accel/strandtree.py); None up to 256 slots
    strand_rows: Optional[torch.Tensor] = None
    # [8 * ceil(N/16), 128] f32 (accel/strandtree.py:RibbonTree): octant
    # o's renumbered node j at row o * (rows // 8) + j // 16; None where
    # there is no strand tree, in a stream pack, or past 100 MiB
    ribbon_rows: Optional[torch.Tensor] = None

    def to(self, device) -> "BvhPack":
        return _to(self, device)


@dataclass(frozen=True)
class ScenePack:
    """Device scene. Triangles are stored in BVH leaf order, padded with
    degenerate triangles (e1 = e2 = 0 never intersect)."""

    tri_row: torch.Tensor  # [T, 64] f32
    object_linear: torch.Tensor  # [O, 16] f32 (3x3 row-major + pad)
    mat_table: torch.Tensor  # [M, 16] f32
    light_table: torch.Tensor  # [L, 8] f32 (padded to >= 1 black light)
    n_lights_f: torch.Tensor  # [] f32 — f32(number of lights), 0 allowed
    tex_atlas: torch.Tensor  # [N_texels, 4] f32
    tex_size: torch.Tensor  # [Tx, 3] i32 (width, height, flat offset)
    scene_bmin: torch.Tensor  # [3] f32 (BVH root box)
    scene_bmax: torch.Tensor  # [3] f32
    bvh: BvhPack
    # False when the scene has no textures: shading skips sampling
    has_textures: bool = False
    # treelet windows of the binned route (accel/treelets.py,
    # kernels/binned.py); None when packed without treelets
    tl_nodes: Optional[torch.Tensor] = None  # [T, Sn, 128] f32
    # [T, Sl, 128] f32; column 10k+9 holds triangle k's slot as int32 bits
    tl_leaves: Optional[torch.Tensor] = None
    tl_bmin: Optional[torch.Tensor] = None  # [T, 3] f32
    tl_bmax: Optional[torch.Tensor] = None  # [T, 3] f32

    def to(self, device) -> "ScenePack":
        return _to(self, device)

    @property
    def device(self) -> torch.device:
        return self.tri_row.device

    @property
    def tri_p0(self):
        return self.tri_row[:, 0:3]

    @property
    def tri_e1(self):
        return self.tri_row[:, 3:6]

    @property
    def tri_e2(self):
        return self.tri_row[:, 6:9]

    @property
    def n_triangles(self) -> int:
        return int(self.tri_row.shape[0])

    @property
    def n_materials(self) -> int:
        return int(self.mat_table.shape[0])

    @property
    def n_objects(self) -> int:
        return int(self.object_linear.shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.light_table.shape[0])


@dataclass(frozen=True)
class CameraPack:
    """Device camera: the two matrices of the reference's Uniforms
    (src/state.rs:22-24)."""

    world: torch.Tensor  # [4,4] f32 ("view" in the shader)
    projection: torch.Tensor  # [4,4] f32 (inverse perspective)

    def to(self, device) -> "CameraPack":
        return _to(self, device)
