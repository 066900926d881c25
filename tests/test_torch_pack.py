"""raytpu_torch's pack options against raytpu: ``pack_scene``'s
``tables="all"`` and ``as_numpy``, raytpu's TPU pack rule (the stream drop,
the strand tree and the ribbon rows under one table budget), and the
native builder's variables (``RAYTPU_NO_NATIVE``, ``RAYTPU_NATIVE_CACHE``,
``native_available``).

A numpy pack is held byte for byte to raytpu's ``pack_scene(as_numpy=True)``
on raytpu's TPU branch, pickled, and rendered through every entry point on
the CPU. The budget rule is held to a hand table of raytpu's cases at a
test-sized budget, and each case's ``auto`` route to raytpu's TPU branch
under the same budget."""

import dataclasses
import functools
import glob
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

import raytpu
import raytpu.native as rt_native
from raytpu.engine import render as rt_render
from raytpu.kernels import binned as rt_binned
from raytpu.kernels import intersect_pallas as rt_pallas
from raytpu.kernels import strand as rt_strand
from raytpu.scene import pack as rt_pack_mod
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu.types import RenderConfig as RtRenderConfig
from raytpu_torch import native, render as top_render
from raytpu_torch.engine import render
from raytpu_torch.engine.progressive import render_with_checkpoint
from raytpu_torch.engine.render import (
    count_rays,
    placed,
    render_frame,
    render_tile,
)
from raytpu_torch.kernels import packet
from raytpu_torch.kernels._build import BUILD_DIR
from raytpu_torch.parallel.shard import render_frame_sharded
from raytpu_torch.scene import pack as pack_mod
from raytpu_torch.scene.camera import camera_from_lookat
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig, ScenePack

from .test_torch_host import scene_path
from .test_torch_schedule import _Recorder

# raytpu's ScenePack tables, by name (raytpu has no tie keys; the port has
# no scene_diag)
TABLES = ("tri_row", "object_linear", "mat_table", "light_table",
          "n_lights_f", "scene_bmin", "scene_bmax", "tex_atlas", "tex_size",
          "tl_nodes", "tl_leaves", "tl_bmin", "tl_bmax")
BVH_TABLES = ("nodes", "node8_rows", "leaf_tris", "strand_rows",
              "ribbon_rows")
SMALL_CFG = dict(width=16, height=12, seed=5, samples=1, bounces=2,
                 chunk_size=8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the other plain-walk test files run
    (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tpu_branch(monkeypatch):
    """raytpu's pack_scene told it runs on a TPU: the branch whose rule the
    port follows on every device."""
    monkeypatch.setattr(rt_pack_mod, "_default_backend_is_tpu", lambda: True)


@functools.lru_cache(maxsize=None)
def _scene(name: str):
    """(the port's SceneData, raytpu's) of "atrium" (raytpu's
    build_atrium(5000): 6,656 slots, treelets under "auto") or a test
    scene of tests/test_torch_host.py."""
    if name == "atrium":
        from benchmarks.scenes import build_atrium

        scene = build_atrium(5000)
        return scene, scene
    return load_scene(scene_path(name)), raytpu.load_scene(scene_path(name))


def _tables(pack) -> dict:
    out = {k: getattr(pack, k) for k in TABLES}
    out.update({k: getattr(pack.bvh, k) for k in BVH_TABLES})
    return out


def _assert_bytes_equal(got: dict, want: dict):
    for k, a in want.items():
        b = got[k]
        assert (a is None) == (b is None), k
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert type(got[k]) in (np.ndarray, np.float32), k
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).view(np.uint8),
            np.ascontiguousarray(b).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("treelets", ["auto", "always", "never"])
@pytest.mark.parametrize("tables", ["auto", "stream", "all"])
@pytest.mark.parametrize("name", ["atrium", "small"])
def test_numpy_pack_bytes_equal_raytpu(tpu_branch, name, tables, treelets):
    """Every table of an ``as_numpy`` pack is raytpu's numpy array, byte
    for byte and None where raytpu's is, on raytpu's TPU branch; the tie
    keys are the tensor pack's."""
    ours, theirs = _scene(name)
    got = pack_scene(ours, "cpu", treelets=treelets, tables=tables,
                     as_numpy=True)
    want = rt_pack_scene(theirs, treelets=treelets, tables=tables,
                         as_numpy=True)
    assert got.on_host
    assert isinstance(got.n_lights_f, np.float32)
    _assert_bytes_equal(_tables(got), _tables(want))
    assert got.has_textures == want.has_textures
    tensors = pack_scene(ours, "cpu", treelets=treelets, tables=tables)
    assert got.bvh.first_slots.dtype == np.int32
    np.testing.assert_array_equal(got.bvh.first_slots,
                                  tensors.bvh.first_slots.numpy())


def test_numpy_pack_pickles_and_moves(tpu_branch):
    """A numpy pack survives pickle, and ``.to(device)`` makes each table
    the tensor pack's, bit for bit (None stays None)."""
    ours, _ = _scene("atrium")
    host = pickle.loads(pickle.dumps(pack_scene(ours, as_numpy=True,
                                                tables="stream")))
    moved = host.to("cpu")
    direct = pack_scene(ours, "cpu", tables="stream")
    assert not moved.on_host and moved.device == torch.device("cpu")
    for k in TABLES:
        a, b = getattr(moved, k), getattr(direct, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8) if a.dim() else a,
                b.view(torch.uint8) if b.dim() else b), k
    for k in (*BVH_TABLES, "first_slots"):
        a, b = getattr(moved.bvh, k), getattr(direct.bvh, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    assert moved.n_lights_f.dim() == 0
    assert moved.n_lights_f.dtype == torch.float32


def _camera(w: int, h: int, device):
    return pack_camera(camera_from_lookat([0, 2.5, -9], [0, -0.5, 0], 0.7,
                                          w, h), device)


@functools.lru_cache(maxsize=None)
def _direct_frame(name: str, intersector: str = "auto"):
    cfg = RenderConfig(**SMALL_CFG, intersector=intersector)
    return render_frame(pack_scene(_scene(name)[0], "cpu"),
                        _camera(cfg.width, cfg.height, "cpu"), cfg)


def _via(entry: str, pack, cfg, tmp_path):
    """The frame of a numpy ``pack`` through one render entry point, on the
    CPU (each entry point moves the pack once)."""
    w, h = cfg.width, cfg.height
    cam = _camera(w, h, "cpu")
    if entry == "render_frame":
        return render_frame(pack, cam, cfg, device="cpu")
    if entry == "render_tile":
        return render_tile(pack, cam, 0, cfg, h, device="cpu").numpy()
    if entry == "render_frame_sharded":
        return render_frame_sharded(pack, cam, cfg, devices=["cpu"] * 2)
    if entry == "render":
        host_cam = camera_from_lookat([0, 2.5, -9], [0, -0.5, 0], 0.7, w, h)
        return top_render(pack, host_cam, cfg, device="cpu")
    if entry == "render_with_checkpoint":
        return render_with_checkpoint(pack, cam, cfg,
                                      str(tmp_path / "ck.npz"),
                                      device="cpu")
    raise AssertionError(entry)


@pytest.mark.parametrize("entry", ["render_frame", "render_tile",
                                   "render_frame_sharded", "render",
                                   "render_with_checkpoint"])
def test_numpy_pack_renders_the_direct_frame(entry, tmp_path):
    """After pickle, each render entry point takes the numpy pack to the
    device it is asked for, and the frame equals the one from
    ``pack_scene(scene, "cpu")`` pixel for pixel."""
    host = pickle.loads(pickle.dumps(pack_scene(_scene("small")[0],
                                                as_numpy=True)))
    cfg = RenderConfig(**SMALL_CFG)
    frame = _via(entry, host, cfg, tmp_path)
    np.testing.assert_array_equal(frame, _direct_frame("small"))
    assert host.on_host  # the caller's pack is left as it was


def test_numpy_pack_goes_to_the_card_by_default(monkeypatch):
    """With no device named, a numpy pack and its camera are moved to
    "cuda" (never the CPU), once; a pack of tensors stays put."""
    seen = []

    def to(self, device):
        seen.append((type(self).__name__, device))
        return self

    host = pack_scene(_scene("small")[0], as_numpy=True)
    cam = _camera(8, 8, "cpu")
    tensors = pack_scene(_scene("small")[0], "cpu")
    same_pack, same_cam = placed(tensors, cam)
    assert same_pack is tensors and same_cam is cam
    monkeypatch.setattr(ScenePack, "to", to)
    monkeypatch.setattr(type(cam), "to", to)
    placed(host, cam)
    assert seen == [("ScenePack", "cuda"), ("CameraPack", "cuda")]
    seen.clear()
    placed(tensors, cam, "cpu")
    assert seen == [("ScenePack", "cpu"), ("CameraPack", "cpu")]


def test_count_rays_takes_a_numpy_pack():
    host = pack_scene(_scene("small")[0], as_numpy=True)
    cfg = RenderConfig(**SMALL_CFG)
    cam = _camera(cfg.width, cfg.height, "cpu")
    assert count_rays(host, cam, cfg, device="cpu") == count_rays(
        pack_scene(_scene("small")[0], "cpu"), cam, cfg)


def test_bvh_route_advice_stream_raises_all_renders():
    """The ``bvh`` route's error tells the user to repack with
    tables='all': a stream pack without a strand tree (<= 256 slots)
    raises it, and the same scene packed with tables='all' renders the
    default pack's ``bvh`` frame."""
    scene = _scene("small")[0]
    cfg = RenderConfig(**SMALL_CFG, intersector="bvh")
    cam = _camera(cfg.width, cfg.height, "cpu")
    stream = pack_scene(scene, "cpu", tables="stream")
    assert stream.bvh.leaf_tris is None
    with pytest.raises(ValueError, match="repack with tables='all'"):
        render_frame(stream, cam, cfg)
    frame = render_frame(pack_scene(scene, "cpu", tables="all"), cam, cfg)
    np.testing.assert_array_equal(frame, _direct_frame("small", "bvh"))
    assert frame[..., :3].max() > 0


def test_pack_rejects_unknown_tables():
    with pytest.raises(ValueError, match="'auto', 'stream' or 'all'"):
        pack_scene(_scene("small")[0], "cpu", tables="resident")


def _bytes(pack) -> dict:
    """The budget's operands of a full numpy pack: BVH8 + leaf rows and
    strand + leaf rows, in bytes at 128 floats a row."""
    leaf = pack.bvh.leaf_tris.shape[0]
    return dict(n8=(pack.bvh.node8_rows.shape[0] + leaf) * 512,
                strand=(pack.bvh.strand_rows.shape[0] + leaf) * 512)


# raytpu's cases (raytpu/scene/pack.py:279-306, on a TPU) at a budget set
# below, above or between the atrium's table sizes: (treelets, tables,
# budget, streams, strand tree, ribbon rows, the route auto takes)
RULE = [
    # treelet-backed over the budget: streams, keeps its strand tree
    ("auto", "auto", "below", True, True, False, "strand"),
    # not treelet-backed over the budget: no stream, no strand tree
    ("never", "auto", "below", False, False, False, "bvh"),
    # within the budget: every table
    ("auto", "auto", "above", False, True, True, "packet+strand"),
    ("never", "auto", "above", False, True, True, "packet+strand"),
    # the BVH8 rows fit, the strand tables do not: no strand tree
    ("auto", "auto", "between", False, False, False, "packet"),
    # "all" never streams: over the budget, no strand tree, treelets
    ("auto", "all", "below", False, False, False, "binned"),
    ("never", "all", "below", False, False, False, "bvh"),
    # "stream" always streams, and then keeps its strand tree
    ("auto", "stream", "above", True, True, False, "strand"),
    ("never", "stream", "below", True, True, False, "strand"),
]
ROUTES = {"strand": ["make_strand_intersectors"],
          "packet+strand": ["make_packet_intersectors",
                            "make_strand_intersectors"],
          "packet": ["make_packet_intersectors"],
          "binned": ["make_binned_intersectors", "make_binned_query"],
          "bvh": ["make_intersectors"]}


def _routes(monkeypatch, port_pack, rt_pack):
    """The factories each package's router calls under ``auto`` (all
    swapped for stand-ins; raytpu's router told it runs on a TPU), the
    port's ``make_intersectors`` with its ``which``."""
    names = ["make_packet_intersectors", "make_strand_intersectors",
             "make_strand_mixed_query", "make_binned_intersectors",
             "make_binned_query", "make_intersectors"]
    pr = _Recorder(monkeypatch, render, names,
                   lambda *a, **k: ("closest", "any"))
    rr = [_Recorder(monkeypatch, mod, fns,
                    lambda *a, **k: ("closest", "any"))
          for mod, fns in ((rt_pallas, ["make_packet_intersectors"]),
                           (rt_strand, ["make_strand_intersectors",
                                        "make_strand_mixed_query"]),
                           (rt_binned, ["make_binned_intersectors",
                                        "make_binned_query"]))]
    tpu = type("D", (), dict(platform="tpu"))
    monkeypatch.setattr(jax, "devices", lambda *a: [tpu()])
    size = dict(width=8, height=8, seed=1, samples=1, bounces=1,
                chunk_size=8)
    render._route(port_pack, RenderConfig(**size))
    rt_render._choose_intersectors(rt_pack, RtRenderConfig(**size))
    port = sorted(c[0] for c in pr.calls)
    which = [c[1].get("which") for c in pr.calls
             if c[0] == "make_intersectors"]
    return port, which, sorted(c[0] for r in rr for c in r.calls)


@pytest.mark.parametrize("treelets,tables,budget,streams,strand,ribbon,"
                         "route", RULE)
def test_pack_rule_follows_raytpus_tpu_branch(
        monkeypatch, treelets, tables, budget, streams, strand, ribbon,
        route):
    """The one table budget (``TABLE_BUDGET``, patched to a test size with
    the packet route's ``PACKET_TABLE_BUDGET``) decides the stream drop,
    the strand tree and the ribbon rows as raytpu's TPU rule does, and
    ``auto`` then takes the route raytpu's TPU branch takes on a pack with
    the same tables."""
    ours, theirs = _scene("atrium")
    sizes = _bytes(pack_scene(ours, as_numpy=True))
    assert sizes["n8"] < sizes["strand"]
    limit = dict(below=sizes["n8"] - 1, between=sizes["n8"],
                 above=sizes["strand"])[budget]
    monkeypatch.setattr(pack_mod, "TABLE_BUDGET", limit)
    monkeypatch.setattr(packet, "PACKET_TABLE_BUDGET", limit)
    real = rt_pallas.vmem_budget_ok
    monkeypatch.setattr(rt_pallas, "vmem_budget_ok",
                        lambda p: real(p, budget_bytes=limit))
    pack = pack_scene(ours, "cpu", treelets=treelets, tables=tables)
    bvh = pack.bvh
    assert (bvh.node8_rows is None) == streams
    assert (bvh.strand_rows is not None) == strand
    assert (bvh.ribbon_rows is not None) == ribbon
    assert bvh.leaf_tris is not None  # atrium: kept by the strand tree
    assert (pack.tl_nodes is not None) == (treelets == "auto")
    # raytpu's pack with the same tables present (its budget is a literal)
    full = rt_pack_scene(theirs, treelets=treelets, as_numpy=True)
    rt_pack = dataclasses.replace(full, bvh=dataclasses.replace(
        full.bvh, **{k: None for k in BVH_TABLES
                     if getattr(bvh, k) is None}))
    port, which, ref = _routes(monkeypatch, pack, rt_pack)
    assert port == ROUTES[route]
    assert port == (ref or ["make_intersectors"])
    if route == "bvh":  # 6,656 slots, above bruteforce_max_tris
        assert which == ["bvh"]
    if route == "strand":
        assert packet.packet_tables_fit(pack) is False


@pytest.mark.parametrize("tables", ["auto", "stream", "all"])
def test_real_budget_pack_equals_raytpus_tpu_pack(tpu_branch, tables):
    """At the real budget the port's tensor pack of the atrium is raytpu's
    TPU-branch pack, table for table."""
    ours, theirs = _scene("atrium")
    got = pack_scene(ours, "cpu", tables=tables)
    want = rt_pack_scene(theirs, tables=tables, as_numpy=True)
    _assert_bytes_equal({k: None if v is None else v.numpy()
                         for k, v in _tables(got).items()}, _tables(want))
    assert pack_mod.TABLE_BUDGET == 100 * 1024 * 1024


@pytest.fixture
def fresh_native(monkeypatch):
    """Both packages' native loaders as if never called (restored after
    the test)."""
    for mod in (native, rt_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", False)


@pytest.mark.parametrize("name", ["small", "gallery"])
def test_no_native_builds_raytpus_python_tree(monkeypatch, fresh_native,
                                              name):
    """Under RAYTPU_NO_NATIVE neither package loads its library, and the
    port's numpy pack is raytpu's, byte for byte, both from the pure-Python
    builder."""
    monkeypatch.setenv("RAYTPU_NO_NATIVE", "1")
    ours, theirs = _scene(name)
    got = pack_scene(ours, as_numpy=True)
    want = rt_pack_scene(theirs, as_numpy=True)
    assert native.native_available() is rt_native.native_available() is False
    _assert_bytes_equal(_tables(got), _tables(want))


def test_native_cache_names_the_library_directory(monkeypatch, tmp_path,
                                                  fresh_native):
    """RAYTPU_NATIVE_CACHE names the directory the ``.so`` is built into;
    unset, the port's build directory."""
    monkeypatch.delenv("RAYTPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("RAYTPU_NATIVE_CACHE", raising=False)
    assert native._cache_dir() == BUILD_DIR
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native builder cannot be compiled")
    cache = tmp_path / "native"
    monkeypatch.setenv("RAYTPU_NATIVE_CACHE", str(cache))
    assert native.native_available() is True
    assert native.native_available() is True  # loaded once
    built = glob.glob(str(cache / "bvh_builder_*.so"))
    assert len(built) == 1
    assert os.path.samefile(native._LIB._name, built[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small", "gallery"])
def test_numpy_pack_renders_on_cuda(name):
    """A pickled numpy pack moved with ``.to("cuda")`` (and one left for
    ``render_frame`` to move) renders the PNG of ``pack_scene(scene,
    "cuda")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py phase 9g runs this)")
    from raytpu_torch.io.png import quantize_rgba32f

    scene = _scene(name)[0]
    host = pickle.loads(pickle.dumps(pack_scene(scene, as_numpy=True)))
    cfg = RenderConfig(**SMALL_CFG)
    cam = _camera(cfg.width, cfg.height, "cuda")
    want = quantize_rgba32f(render_frame(pack_scene(scene, "cuda"), cam,
                                         cfg))
    for frame in (render_frame(host.to("cuda"), cam, cfg),
                  render_frame(host, cam, cfg)):
        np.testing.assert_array_equal(quantize_rgba32f(frame), want)
