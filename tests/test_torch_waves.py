"""The port's captured-wave tools (``raytpu_torch/tools/waves.py`` and
``strand_ab.py``) against raytpu's ``benchmarks/waves.py``:
``load_wave`` on each committed fixture, ``engine_sort`` bit for bit on the
first 16,384 rays of each over ``build_atrium(5000)`` packed by both
packages, the port's ``capture`` against raytpu's ``_trace_paths`` with
its recorder (its brute-force pair, on the CPU) at 64x36, 4 bounces, chunk
8, and ``stats``, ``ab`` and ``strand_ab`` (``--check``) run as functions
and through their command lines on the first rays of a fixture, through
the plain versions.

Importing benchmarks/waves.py points JAX's persistent compilation cache
at RAYTPU_CACHE: the import runs with it in a temporary directory and
JAX's settings are restored after it."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.tools import scenes
from raytpu_torch.tools import strand_ab
from raytpu_torch.tools import waves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's waves against raytpu's brute-force waves: the triangle and
# every scatter decision agree; JAX and torch round the shading's sin, cos
# and sqrt apart in the last ulps (ROADMAP: float rules)
WAVE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain walks run thousands of small torch ops: one intra-op
    thread keeps them from contending with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _rt_waves():
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("RAYTPU_CACHE")
    import tempfile

    os.environ["RAYTPU_CACHE"] = tempfile.mkdtemp(prefix="raytpu_cache")
    try:
        spec = importlib.util.spec_from_file_location(
            "raytpu_waves", os.path.join(REPO, "benchmarks", "waves.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if env is None:
            os.environ.pop("RAYTPU_CACHE")
        else:
            os.environ["RAYTPU_CACHE"] = env
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@functools.lru_cache(maxsize=None)
def _scene():
    return scenes.build_atrium(5000)


@functools.lru_cache(maxsize=None)
def _pack():
    return pack_scene(_scene(), "cpu")


@pytest.mark.parametrize("name", waves.COMMIT_WAVES)
def test_load_wave_equals_raytpus(name):
    got = waves.load_wave(name, prefer_full=False)
    want = _rt_waves().load_wave(name, prefer_full=False)
    assert got.keys() == want.keys()
    for k in ("ro", "rd", "tmax"):
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["tmin"] == want["tmin"] and got["kind"] == want["kind"]
    assert got["kind"] == ("shadow" if name.endswith("s") else "closest")


@pytest.mark.parametrize("name", waves.COMMIT_WAVES)
def test_engine_sort_bit_equal_raytpus(name):
    from raytpu.scene.pack import pack_scene as rt_pack_scene

    w = waves.load_wave(name, prefer_full=False)
    cut = slice(None, 16384)
    ro, rd, tmax = w["ro"][cut], w["rd"][cut], w["tmax"][cut]
    idx = np.arange(ro.shape[0], dtype=np.int32)
    got = waves.engine_sort(_pack(), ro, rd, tmax, extra=(idx,))
    want = _rt_waves().engine_sort(rt_pack_scene(_scene(), as_numpy=True),
                                   ro, rd, tmax, extra=(idx,))
    for a, b, k in zip(got, want, ("ro", "rd", "tmax", "order")):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, k
        assert a.numpy().tobytes() == b.tobytes(), k
    # dead lanes last, in engine order
    order, live = got[3].numpy(), got[2].numpy() >= 0
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()
    assert (np.diff(order[n_live:]) > 0).all()


def _rt_capture(width: int, height: int, bounces: int):
    """raytpu's capture (``benchmarks/waves.py:capture``) on the CPU:
    raytpu's ``_trace_paths`` with its recorder over raytpu's brute-force
    pair (its packet kernel is the TPU's), in 32x32-block order, unsorted,
    tile 0 = the whole frame."""
    import jax.numpy as jnp

    from raytpu.engine.render import (
        _in_chunk_grid,
        _pixel_layout,
        _trace_paths,
        cast_rays,
    )
    from raytpu.kernels import rng as rngk
    from raytpu.kernels.intersect import make_intersectors
    from raytpu.scene.pack import pack_camera as rt_pack_camera
    from raytpu.scene.pack import pack_scene as rt_pack_scene

    pack = rt_pack_scene(_scene())
    cam = rt_pack_camera(_scene().camera)
    rec = _rt_waves()._Recorder(*make_intersectors(pack, which="brute"))
    px, py, _ = _pixel_layout(width, height, True)
    in_grid = _in_chunk_grid(px, py, width, height, 8)
    rng = rngk.seed_pixels(px, py, width, 8, 1)
    rng, jx = rngk.rand(rng)
    rng, jy = rngk.rand(rng)
    ro, rd = cast_rays(px.astype(jnp.float32) + jx,
                       py.astype(jnp.float32) + jy, cam.world,
                       cam.projection, width, height)
    _trace_paths(pack, rec.closest, rec.any_hit, ro, rd, rng, bounces,
                 mask=in_grid, sort_bounced=False, eager=True)
    counts = {"closest": 0, "shadow": 0}
    out = {}
    for kind, wro, wrd, wtmin, wtmax in rec.calls:
        name = f"b{counts[kind]}{'c' if kind == 'closest' else 's'}"
        counts[kind] += 1
        out[name] = dict(ro=wro, rd=wrd, tmax=wtmax, tmin=wtmin, kind=kind)
    return out


@functools.lru_cache(maxsize=None)
def _capture():
    return waves.capture(_pack(), pack_camera(_scene().camera, "cpu"), 64,
                         36, 4, 1)


def test_capture_matches_raytpus_trace():
    got, want = _capture(), _rt_capture(64, 36, 4)
    assert list(got) == list(want)
    assert list(got)[:2] == ["b0c", "b0s"] and len(got) == 8
    for name, w in want.items():
        g = got[name]
        assert g["kind"] == w["kind"] and g["tmin"] == np.float32(w["tmin"])
        live = w["tmax"] >= 0
        np.testing.assert_array_equal(g["tmax"] >= 0, live, err_msg=name)
        assert live.any(), name
        if name == "b0c":
            # the camera's origin and the bounds bit for bit; the
            # directions as test_torch_render.py's cast_rays test holds
            # them (XLA on the CPU contracts multiply-adds)
            for k in ("ro", "tmax"):
                assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k
            np.testing.assert_allclose(g["rd"], w["rd"], rtol=1e-5,
                                       atol=1e-6)
            continue
        for k in ("ro", "rd"):
            np.testing.assert_allclose(g[k][live], w[k][live], rtol=0,
                                       atol=WAVE_ATOL, err_msg=f"{name} {k}")
        # shadow bounds are the light distances; closest bounds F32_MAX
        np.testing.assert_allclose(g["tmax"][live], w["tmax"][live],
                                   rtol=WAVE_ATOL, atol=0, err_msg=name)


def test_save_capture_round_trip(tmp_path):
    got = _capture()
    full = str(tmp_path / "full.npz")
    waves.save_capture(got, full=full, bands_dir=str(tmp_path))
    for name, w in got.items():
        back = waves.load_wave(name, full=full)
        for k in ("ro", "rd", "tmax"):
            assert back[k].tobytes() == w[k].tobytes(), k
        assert back["tmin"] == w["tmin"] and back["kind"] == w["kind"]
    for name in waves.COMMIT_WAVES:
        b = waves.load_wave(name, prefer_full=False, waves_dir=str(tmp_path))
        w = got[name]
        dead = w["tmax"] < 0
        assert (b["tmax"][dead] == -np.inf).all()
        assert (b["ro"][dead] == 0).all() and (b["rd"][dead] == 1).all()
        np.testing.assert_array_equal(
            b["ro"][~dead], w["ro"][~dead].astype(np.float16))
        assert b["kind"] == w["kind"]


@functools.lru_cache(maxsize=None)
def _first_rays(names: tuple, rays: int = 4096):
    return waves.sorted_waves(_pack(), names, rays, prefer_full=False)


def test_stats_runs_on_the_plain_walk():
    rows = waves.stats(_pack(), _first_rays(("b2c",)), inner=1, repeats=1,
                       plain=True)
    assert len(rows) == 2 * len(waves.PACKETS)
    for order in ("storage", "near-first"):
        sel = [x for x in rows if x["kernel"].endswith(order)]
        assert [x["packet"] for x in sel] == list(waves.PACKETS)
        # a packet's counters are its rays' sums: every size sums alike
        assert len({(x["pops_total"], x["leafs_total"]) for x in sel}) == 1
        assert all(x["plain"] == "bit-equal" and x["ms"] > 0 for x in sel)
    assert rows[0]["pops"] == rows[0]["pops_total"]  # one 4096-ray packet
    # each size's plain stats rows are the smallest packet's, summed
    from raytpu_torch.kernels.packet import packet_query_torch

    w, pack = _first_rays(("b2c",))["b2c"], _pack()
    args = (pack.bvh.node8_rows, pack.bvh.leaf_tris, pack.bvh.first_slots,
            w["ro"], w["rd"], w["tmax"], w["tmin"], False)
    small = packet_query_torch(*args, packet=128, with_stats=True)[2]
    for packet in (256, 384, 4096, 8192):
        want = packet_query_torch(*args, packet=packet, with_stats=True)[2]
        assert torch.equal(waves.regroup(small, packet // 128), want)


def test_ab_agrees_on_the_plain_walks():
    rows = waves.ab(_pack(), _first_rays(("b2c", "b2s")), groups=[4],
                    persistent=[(128, 16)], inner=1, repeats=1, plain=True)
    assert [x["kernel"] for x in rows[:5]] == [
        "packet_walk", "strand_walk", "strand_block",
        "strand_block deferral G 4",
        "strand_walk schedule W 128 K 16 FO 0.75"]
    assert len(rows) == 10
    assert all(x["agree"] is True for x in rows if x["kernel"] !=
               "packet_walk")


def test_strand_ab_check_passes_on_the_plain_walks():
    rows = strand_ab.measure(_pack(), _first_rays(("b2c", "b2s")),
                             block=True, check=True, stats=True, inner=1,
                             repeats=1, plain=True)
    assert [x["kernel"] for x in rows] == [
        "strand_walk (default instance)", "strand_block"] * 2
    assert all(x["plain"] == "bit-equal" for x in rows)
    assert [x["agree"] for x in rows] == ["", True, "", True]


def test_strand_ab_check_catches_a_wrong_hit():
    w = _first_rays(("b2c",))["b2c"]
    from raytpu_torch.kernels.strand import strand_query

    pack = _pack()
    args = (pack.bvh.strand_rows, pack.bvh.leaf_tris, pack.bvh.first_slots,
            w["ro"], w["rd"], w["tmax"], w["tmin"], False)
    t, tri = strand_query(*args)
    assert strand_ab.check_pair(pack.bvh.first_slots, False, (t, tri),
                                (t, tri)) == ""
    hit = int((tri >= 0).nonzero()[0])
    t2 = t.clone()
    t2[hit] = torch.nextafter(t[hit], torch.tensor(np.inf))
    assert strand_ab.check_pair(pack.bvh.first_slots, False, (t, tri),
                                (t2, tri)) == "t bits"
    tri2 = tri.clone()
    tri2[hit] = -1
    assert strand_ab.check_pair(pack.bvh.first_slots, False, (t, tri),
                                (t, tri2)) == "hit mask"
    assert strand_ab.check_pair(pack.bvh.first_slots, True, (t, tri),
                                (t, tri2)) == "blocked bit"


@pytest.mark.parametrize("argv", [
    ["waves", "stats", "--waves", "b2s", "--packets", "4096", "1024"],
    ["waves", "ab", "--waves", "b2s", "--groups", "4"],
    ["strand_ab", "--waves", "b2s", "--block", "--check", "--stats",
     "--pipe", "--service-k", "4"],
])
def test_command_line_on_the_cpu(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    main = waves.main if argv[0] == "waves" else strand_ab.main
    assert main(argv[1:] + ["--device", "cpu", "--tris", "5000", "--rays",
                            "1024", "--inner", "1", "--repeats", "1",
                            "--plain"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith("| wave | kernel and form |")
    assert len(table) > 2 and all(line.startswith("| b2s |")
                                  for line in table[2:])
    assert any(p.name.startswith("atrium_torch_5000_")
               for p in tmp_path.iterdir())
