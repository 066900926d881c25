"""raytpu_torch's host side against raytpu: the copied numpy modules (glTF
loader, camera, BVH, strand tree) give identical arrays, every table of
the port's pack is bit-equal to ``raytpu.scene.pack.pack_scene(
as_numpy=True)``, the zlib PNG writer decodes to raytpu's pixels, and the
port imports neither JAX nor raytpu."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import raytpu
from raytpu.accel.bvh import build_bvh as rt_build_bvh
from raytpu.accel import strandtree as rt_strandtree
from raytpu.accel.strandtree import build_strand_tree as rt_build_strand_tree
from raytpu.io import metrics as rt_metrics
from raytpu.io.metrics import ssim as rt_ssim
from raytpu.io.png import write_png as rt_write_png
from raytpu.scene.pack import flatten_world_triangles as rt_flatten
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.accel import strandtree as pt_strandtree
from raytpu_torch.accel.strandtree import build_strand_tree, validate_strand_tree
from raytpu_torch.io import metrics as pt_metrics
from raytpu_torch.io.metrics import psnr, ssim
from raytpu_torch.io.png import write_png
from raytpu_torch.scene import camera as pt_camera
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import flatten_world_triangles, pack_scene

from .test_production_parity import _grid_mesh
from .tools.glb_writer import GlbBuilder, box, quad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the gallery camera with its eye in front of the scene (the look-at
# quirk makes eye [0, 2.5, 9] face away from it)
EYE, AT, FOV = [0, 2.5, -9], [0, -0.5, 0], 0.7


def _checker():
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 3] = 255
    for y in range(8):
        for x in range(8):
            c = 220 if (x + y) % 2 == 0 else 60
            tex[y, x, :3] = (c, c - 10 if c > 10 else 0, c)
    return tex


def write_scene(path, cells: int, textured: bool = True):
    """The gallery layout of tests/test_production_parity.py: a floor grid
    of 2*cells^2 triangles (checker-textured or plain), metal/glass/
    diffuse boxes, an emissive quad and two lights. cells=36 is the
    4096-slot gallery; cells=4 stays under 256 slots."""
    b = GlbBuilder()
    if textured:
        floor_m = b.add_material(color=(1, 1, 1, 1),
                                 texture=b.add_texture_rgba(_checker()))
    else:
        floor_m = b.add_material(color=(0.8, 0.8, 0.8, 1))
    metal = b.add_material(color=(0.9, 0.8, 0.5, 1), metallic=1.0)
    glass = b.add_material(color=(0.85, 0.9, 1.0, 1), ior=1.5)
    diffuse = b.add_material(color=(0.7, 0.3, 0.3, 1))
    glow = b.add_material(color=(1.0, 0.7, 0.3, 1), emission=5.0)
    pos, nrm, uv, idx = _grid_mesh(cells, cells, 16.0)
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, floor_m, np.uint32)]),
               translation=[0, -2, 0])
    bp, bn, bu, bi = box()
    for mat, at in ((metal, [-2.5, -1, 0]), (glass, [0, -1, 1.5]),
                    (diffuse, [2.5, -1, 0])):
        b.add_node(mesh=b.add_mesh([(bp, bn, bu, bi, mat, np.uint32)]),
                   translation=at)
    qp, qn, qu, qi = quad(size=2.0)
    b.add_node(mesh=b.add_mesh([(qp, qn, qu, qi, glow, np.uint16)]),
               translation=[0, 2.5, -2])
    b.add_node(light=b.add_light(intensity=40.0), translation=[4, 5, 6])
    b.add_node(light=b.add_light(color=(0.4, 0.6, 1.0), intensity=25.0),
               translation=[-5, 4, 3])
    b.add_node(camera=b.add_camera(aspect=1.5, yfov=0.6),
               translation=[0, 1, -8])
    b.write(path)


@functools.lru_cache(maxsize=None)
def scene_path(name: str) -> str:
    """A GLB written once per process: "gallery" (4096 slots, textured),
    "small" (<= 256 slots, textured) or "small_plain" (untextured)."""
    cells, textured = {"gallery": (36, True), "small": (4, True),
                       "small_plain": (4, False)}[name]
    path = os.path.join(tempfile.mkdtemp(prefix="raytpu_torch_"),
                        name + ".glb")
    write_scene(path, cells, textured)
    return path


def _soup(ntri, seed=0):
    rng = np.random.default_rng(seed)
    p0 = (rng.random((ntri, 3), np.float32) - 0.5) * 10
    e1 = rng.normal(size=(ntri, 3)).astype(np.float32)
    e2 = rng.normal(size=(ntri, 3)).astype(np.float32)
    return p0, e1, e2


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", ["gallery", "small"])
def test_gltf_copy_matches_raytpu(name):
    want = raytpu.load_scene(scene_path(name))
    got = load_scene(scene_path(name))
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "textures":
            assert len(a) == len(b) == 1
            np.testing.assert_array_equal(a[0], b[0])
        elif f.name == "camera":
            np.testing.assert_array_equal(a.world, b.world)
            np.testing.assert_array_equal(a.projection, b.projection)
        else:
            _assert_same(a, b, f.name)


def test_camera_copy_matches_raytpu(tmp_path):
    path = tmp_path / "camera.json"
    path.write_text(json.dumps({"origin": EYE, "at": AT, "fov": FOV}))
    for w, h in ((48, 32), (1920, 1080)):
        want = raytpu.load_camera_json(str(path), w, h)
        got = pt_camera.load_camera_json(str(path), w, h)
        _assert_same(want.world, got.world, "world")
        _assert_same(want.projection, got.projection, "projection")
    _assert_same(raytpu.perspective_matrix(1.3, 0.5, 0.1, 50.0),
                 pt_camera.perspective_matrix(1.3, 0.5, 0.1, 50.0), "persp")
    _assert_same(raytpu.look_at([1, 2, 3], [0, 0, 1], [0, 1, 0]),
                 pt_camera.look_at([1, 2, 3], [0, 0, 1], [0, 1, 0]), "look_at")


def _geometry(which):
    if which == "soup":
        return _soup(700, seed=4)
    return rt_flatten(raytpu.load_scene(scene_path("gallery")))[:3]


@pytest.mark.parametrize("which", ["soup", "gallery"])
def test_bvh_and_strand_tree_copies_match_raytpu(which):
    p0, e1, e2 = _geometry(which)
    want, want8 = rt_build_bvh(p0, e1, e2)
    got, got8 = build_bvh(p0, e1, e2)
    for f in dataclasses.fields(want):
        _assert_same(getattr(want, f.name), getattr(got, f.name), f.name)
    _assert_same(want8.node_rows, got8.node_rows, "node_rows")
    tree = build_strand_tree(got)
    validate_strand_tree(tree, got)
    _assert_same(rt_build_strand_tree(want).rows, tree.rows, "strand rows")


@pytest.mark.parametrize("which", ["soup", "gallery"])
def test_ribbon_copies_match_raytpu(which):
    """The ribbon layout's host copies (build_ribbon_tree,
    validate_ribbon_tree, strand_tree_from_packed) give raytpu's rows: the
    ribbon from the same BVH, and the strand tree rebuilt from a pack's
    fused node rows; each package's validator accepts the other's tree."""
    p0, e1, e2 = _geometry(which)
    want, _ = rt_build_bvh(p0, e1, e2)
    got, _ = build_bvh(p0, e1, e2)
    rt_rib = rt_strandtree.build_ribbon_tree(want)
    rib = pt_strandtree.build_ribbon_tree(got)
    assert pt_strandtree.RIBBON_NODES_PER_ROW == 16
    assert (rib.n_nodes, rib.rows_per_oct) == (rt_rib.n_nodes,
                                               rt_rib.rows_per_oct)
    assert rib.rows.shape == (8 * -(-got.n_nodes // 16), 128)
    _assert_same(rt_rib.rows, rib.rows, "ribbon rows")
    tree = build_strand_tree(got)
    pt_strandtree.validate_ribbon_tree(rib, tree, got)
    rt_strandtree.validate_ribbon_tree(rib, rt_build_strand_tree(want), want)
    # a pack's fused rows [N, 8]: bmin, bmax, bitcast miss and leaf row
    fused = np.zeros((got.n_nodes, 8), np.float32)
    fused[:, 0:3], fused[:, 3:6] = got.bmin, got.bmax
    fused[:, 6] = got.miss.astype(np.int32).view(np.float32)
    fused[:, 7] = np.where(got.leaf_first >= 0, got.leaf_first // 8,
                           -1).astype(np.int32).view(np.float32)
    _assert_same(rt_strandtree.strand_tree_from_packed(fused).rows,
                 pt_strandtree.strand_tree_from_packed(fused).rows,
                 "strand rows from the packed nodes")
    _assert_same(tree.rows, pt_strandtree.strand_tree_from_packed(fused).rows,
                 "strand rows from the BVH")


_BVH_TABLES = ("nodes", "node8_rows", "leaf_tris", "strand_rows")


def _torch_tables(pack):
    """Every table of a raytpu_torch pack as numpy (None stays None), by
    raytpu's names."""
    out = {k: getattr(pack, k).numpy() for k in (
        "tri_row", "object_linear", "mat_table", "light_table", "n_lights_f",
        "scene_bmin", "scene_bmax", "tex_atlas", "tex_size")}
    out.update({k: None if getattr(pack.bvh, k) is None
                else getattr(pack.bvh, k).numpy() for k in _BVH_TABLES})
    return out


def _raytpu_tables(pack):
    out = {k: np.asarray(getattr(pack, k)) for k in (
        "tri_row", "object_linear", "mat_table", "light_table", "n_lights_f",
        "scene_bmin", "scene_bmax", "tex_atlas", "tex_size")}
    out.update({k: getattr(pack.bvh, k) for k in _BVH_TABLES})
    return out


@pytest.mark.parametrize("name", ["gallery", "small", "small_plain"])
def test_pack_tables_bit_equal_raytpu(name):
    """Every table bit-equal to raytpu's numpy pack, the BVH8 rows
    included; like raytpu, the port builds the strand tree only above 256
    slots and leaves it None below."""
    scene = raytpu.load_scene(scene_path(name))
    want = _raytpu_tables(rt_pack_scene(scene, as_numpy=True))
    pack = pack_scene(load_scene(scene_path(name)), "cpu")
    got = _torch_tables(pack)
    if pack.n_triangles <= 256:
        assert want["strand_rows"] is None and got["strand_rows"] is None
    else:
        assert want["strand_rows"] is not None
    for k, a in want.items():
        b = got[k]
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        # bit patterns: bitcast int columns and padding compare exactly
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).view(np.uint8),
            np.ascontiguousarray(b).view(np.uint8), err_msg=k)
    assert pack.has_textures == (name != "small_plain")
    moved = pack.to("cpu")
    assert moved.has_textures == pack.has_textures
    # link columns hold int32 bits (~0 reads as a NaN): compare bits
    assert torch.equal(moved.bvh.node8_rows.view(torch.int32),
                       pack.bvh.node8_rows.view(torch.int32))
    if pack.bvh.strand_rows is None:
        assert moved.bvh.strand_rows is None
    else:
        assert torch.equal(moved.bvh.strand_rows, pack.bvh.strand_rows)
    assert torch.equal(moved.n_lights_f, pack.n_lights_f)


@pytest.mark.parametrize("name,tables", [("gallery", "auto"),
                                         ("gallery", "stream"),
                                         ("small", "auto"),
                                         ("small", "stream")])
def test_pack_carries_the_strand_tie_keys(name, tables):
    """Every pack carries its slots' tie keys, computed once
    (kernels/strand.py:first_slots) from the slots' p0/e1/e2 in
    ``tri_row``: each slot's key is the lowest slot holding the same 9
    floats, so a key is its own key; where the pack keeps leaf rows the
    keys equal theirs; .to() moves them. That includes a <= 256-slot pack
    (the packet route's) and a stream pack without leaf rows (the binned
    route's)."""
    from raytpu_torch.kernels.strand import first_slots

    pack = pack_scene(load_scene(scene_path(name)), "cpu", tables=tables)
    first = pack.bvh.first_slots
    per = pack.tri_row[:, :9].contiguous().view(torch.int32)
    assert first.dtype == torch.int32 and first.shape == (per.shape[0],)
    assert torch.equal(first, first_slots(pack.tri_row))
    if pack.bvh.leaf_tris is None:
        assert tables == "stream" and pack.n_triangles <= 256
    else:
        assert torch.equal(first, first_slots(pack.bvh.leaf_tris))
    slots = torch.arange(per.shape[0], dtype=torch.int32)
    assert bool((first <= slots).all())
    assert torch.equal(first[first.long()], first)
    assert torch.equal(per[first.long()], per)
    assert int((first < slots).sum()) > 0  # split triangles, zero padding
    assert torch.equal(pack.to("cpu").bvh.first_slots, first)


def test_flatten_matches_raytpu():
    scene = raytpu.load_scene(scene_path("gallery"))
    for a, b in zip(rt_flatten(scene), flatten_world_triangles(scene)):
        _assert_same(a, b, "flatten")


def test_png_writer_decodes_to_raytpu_pixels(tmp_path):
    rng = np.random.default_rng(5)
    frame = rng.uniform(-0.2, 1.3, size=(17, 23, 4)).astype(np.float32)
    frame[0, 0, 0] = np.nan
    frame[1, 1, 1] = np.inf
    frame[2, 2, 2] = -np.inf
    write_png(str(tmp_path / "port.png"), frame)
    rt_write_png(str(tmp_path / "raytpu.png"), frame)
    got = Image.open(tmp_path / "port.png")
    want = Image.open(tmp_path / "raytpu.png")
    assert got.mode == want.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ssim_copy_matches_raytpu():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, size=(40, 30, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, size=a.shape), 0, 255)
    assert ssim(a, b) == rt_ssim(a, b) < 1.0
    assert ssim(a, a) == 1.0


def test_psnr_copy_matches_raytpu():
    """raytpu's psnr, copied verbatim: the same source and the same values
    (inf on equal images)."""
    import inspect

    assert inspect.getsource(pt_metrics.psnr) == inspect.getsource(
        rt_metrics.psnr)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=(40, 30, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, size=a.shape), 0, 255)
    assert psnr(a, b) == rt_metrics.psnr(a, b) < float("inf")
    assert psnr(a, b, data_range=1.0) == rt_metrics.psnr(a, b, 1.0)
    assert psnr(a, a) == rt_metrics.psnr(a, a) == float("inf")


def test_package_imports_neither_jax_nor_raytpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytpu_torch, raytpu_torch.cli\n"
        "for m in pkgutil.walk_packages(raytpu_torch.__path__, "
        "'raytpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'raytpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('raytpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15  # every module was imported


def test_native_builder_copy_is_raytpus_file():
    """raytpu_torch/native compiles its own copy of raytpu's SAH/SBVH
    builder, byte for byte the same source (so both build the same trees),
    and reads nothing of the raytpu package."""
    from raytpu_torch import native

    copy = os.path.join(REPO, "raytpu_torch", "native", "csrc",
                        "bvh_builder.cpp")
    with open(copy, "rb") as f, open(os.path.join(
            REPO, "raytpu", "native", "bvh_builder.cpp"), "rb") as g:
        assert f.read() == g.read()
    assert os.path.samefile(native._SRC, copy)
    assert "raytpu" + os.sep + "native" not in native._SRC.replace(
        "raytpu_torch" + os.sep, "")
