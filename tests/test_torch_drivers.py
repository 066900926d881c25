"""The port's measurement drivers (``raytpu_torch/tools/``: headline_ab,
frame_profile, sort_bench, gather_bench, profile_atrium, strand_sim,
multichip_report, bgemm_sim) against raytpu's ``benchmarks/`` scripts, on
the CPU at small sizes:

* profile_atrium's ray sets and its four sort keys bit for bit against
  raytpu's ``main`` run on the same first hits (a 5,000-triangle atrium,
  4,096 rays);
* strand_sim's ``decode_tree``, ``walk_strand`` (with and without
  ``rowstats``), ``ribbon_renumber`` and ``collapsed_threading`` against
  raytpu's on the same pack and the first 2,048 rays of the committed
  b2c and b2s waves;
* bgemm_sim's candidates, block unions and table against raytpu's
  ``main``;
* multichip_report's ray counts per shard against raytpu's
  ``shard_ray_counts`` arithmetic, and its 8-way render on ``["cpu"] * 8``
  against ``render_frame`` bit for bit;
* frame_profile's grouping on a synthetic trace with one event of each
  kind;
* every tool's command line with ``--device cpu`` (sort_bench and
  gather_bench with ``--check``), and no tool importing JAX, raytpu,
  bench or benchmarks.

raytpu's scripts point JAX's persistent compilation cache at RAYTPU_CACHE
when imported: they are imported with it in a temporary directory and
JAX's settings restored after."""

import ast
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu_torch.engine.render import cast_rays as pt_cast_rays
from raytpu_torch.engine.render import render_frame
from raytpu_torch.kernels.packet import packet_query_torch
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.tools import (
    bgemm_sim,
    frame_profile,
    gather_bench,
    headline_ab,
    multichip_report,
    profile_atrium,
    scenes,
    sort_bench,
    strand_sim,
    waves,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bgemm_sim", "frame_profile", "gather_bench", "headline_ab",
         "multichip_report", "profile_atrium", "sort_bench", "strand_sim")


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain walks run thousands of small torch ops: one intra-op
    thread keeps them from contending with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_cache_in_tmp():
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("RAYTPU_CACHE")
    os.environ["RAYTPU_CACHE"] = tempfile.mkdtemp(prefix="raytpu_cache")
    try:
        yield
    finally:
        if env is None:
            os.environ.pop("RAYTPU_CACHE")
        else:
            os.environ["RAYTPU_CACHE"] = env
        for k, v in saved.items():
            jax.config.update(k, v)


@functools.lru_cache(maxsize=None)
def raytpu_module(name: str):
    """A module of raytpu's scripts (``bench``, ``benchmarks.<name>``),
    imported after ``bench.py`` and ``benchmarks/waves.py`` (which the
    scripts' ``main`` import), all with JAX's cache in a temporary
    directory."""
    with _jax_cache_in_tmp():
        importlib.import_module("bench")
        importlib.import_module("benchmarks.waves")
        return importlib.import_module(name)


def _rt(name: str):
    return raytpu_module(f"benchmarks.{name}")


@functools.lru_cache(maxsize=None)
def _host_pack():
    """The port's host pack of the 5,000-triangle atrium (``tables="all"``,
    so the BVH8 rows are there)."""
    return pack_scene(scenes.build_atrium(5000), as_numpy=True,
                      tables="all")


@functools.lru_cache(maxsize=None)
def _rt_pack():
    from benchmarks.scenes import build_atrium as rt_build_atrium
    from raytpu.scene.pack import pack_scene as rt_pack_scene

    scene = rt_build_atrium(5000)
    return scene, rt_pack_scene(scene, tables="all")


def _run_main(module, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()
    return capsys.readouterr().out


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


# ---------------------------------------------------------------- profile


def test_profile_atrium_sets_and_sorts_equal_raytpus(monkeypatch, capsys):
    """raytpu's ``main`` on the 5,000-triangle atrium at 4,096 rays, its
    first hits taken from the port's plain packet walk and its camera rays
    from the port's ``cast_rays`` (so both build from the same inputs), its
    ``time_query`` recording each set: the port's primary, bounce (each
    sort key) and shadow sets equal them bit for bit."""
    rt = _rt("profile_atrium")
    bench = sys.modules["bench"]  # imported by _rt, its cache kept aside

    host = _host_pack()
    pack = host.to("cpu")
    tables = (pack.bvh.node8_rows, pack.bvh.leaf_tris, pack.bvh.first_slots)
    rt_scene, rt_pack = _rt_pack()
    monkeypatch.setattr(bench, "_cached_atrium",
                        lambda tris: (rt_scene, rt_pack))

    def first_hits(node8, leaves, rox, roy, roz, rdx, rdy, rdz, tmax,
                   tmin=0.001, any_hit=False, **kw):
        ro, rd = (torch.as_tensor(np.stack([np.asarray(c) for c in cols],
                                           -1)) for cols in
                  ((rox, roy, roz), (rdx, rdy, rdz)))
        t, tri = packet_query_torch(*tables, ro, rd,
                                    torch.as_tensor(np.asarray(tmax)), tmin,
                                    any_hit)
        return jnp.asarray(t.numpy()), jnp.asarray(tri.numpy())

    def camera_rays(px, py, world, proj, w, h):
        return tuple(jnp.asarray(a.numpy()) for a in pt_cast_rays(
            *(torch.as_tensor(np.asarray(x)) for x in (px, py, world, proj)),
            w, h))

    sets = []

    def record(pack_, ro, rd, tmax, *, packet, any_hit=False, label=""):
        sets.append((label, packet, any_hit,
                     *(np.asarray(x) for x in (ro, rd, tmax))))
        return "", 0.0, 0.0

    monkeypatch.setattr(rt, "packet_query", first_hits)
    monkeypatch.setattr(rt, "cast_rays", camera_rays)
    monkeypatch.setattr(rt, "time_query", record)
    _run_main(rt, ["--tris", "5000", "--rays", "4096", "--packets", "4096",
                   "1024"], monkeypatch, capsys)

    cam = pack_camera(scenes.build_atrium(5000).camera, "cpu")
    ro, rd, tmax = profile_atrium.primary_set(cam, 4096, device="cpu")
    t, tri = packet_query_torch(*tables, ro, rd, tmax, 0.001, False)
    hitp, brd, alive = profile_atrium.bounce_set(ro, rd, t, tri)
    assert 0.3 < float(alive.float().mean()) <= 1.0
    want = [("primary", 4096, False, ro, rd, tmax)]
    for mode in profile_atrium.SORT_MODES:
        sro, srd = profile_atrium.sort_rays(pack, hitp, brd, mode)
        want += [(f"bounce/{mode}", p, False, sro, srd, tmax)
                 for p in (4096, 1024)]
    want.append(("shadow(any)", 4096, True,
                 *profile_atrium.shadow_set(pack, hitp)))
    assert [s[:3] for s in sets] == [w[:3] for w in want]
    for got, exp in zip(sets, want):
        for k, a, b in zip(("ro", "rd", "tmax"), got[3:], exp[3:]):
            _same(a, b.numpy(), f"{got[0]} {k}")


# ------------------------------------------------------------------- sim


@functools.lru_cache(maxsize=None)
def _sorted_wave(name: str, rays: int = 2048):
    w = waves.load_wave(name, prefer_full=False)
    return tuple(a.numpy() for a in waves.engine_sort(
        _host_pack().to("cpu"), w["ro"][:rays], w["rd"][:rays],
        w["tmax"][:rays])) + (np.float32(w["tmin"]), w["kind"] == "shadow")


def test_strand_sim_decode_and_renumber_equal_raytpus():
    rt = _rt("strand_sim")
    host = _host_pack()
    n = host.bvh.nodes.shape[0]
    got = strand_sim.decode_tree(host.bvh.strand_rows, n)
    want = rt.decode_tree(host.bvh.strand_rows, n)
    for o, (g, w) in enumerate(zip(got, want)):
        for k, a, b in zip(("bmin", "bmax", "hit", "miss"), g, w):
            _same(a, b, f"octant {o} {k}")
        (rg, og), (rw, ow) = (strand_sim.ribbon_renumber(g, n),
                              rt.ribbon_renumber(w, n))
        _same(og, ow, f"octant {o} order")
        for k, a, b in zip(("bmin", "bmax", "hit", "miss"), rg, rw):
            _same(a, b, f"octant {o} ribbon {k}")


def test_strand_sim_collapsed_threading_equals_raytpus():
    rt = _rt("strand_sim")
    host = _host_pack()
    for levels in (1, 2):
        for o, (g, w) in enumerate(zip(
                strand_sim.collapsed_threading(host, levels),
                rt.collapsed_threading(host, levels))):
            for k, a, b in zip(("bmin", "bmax", "hit", "miss"), g, w):
                _same(a, b, f"levels {levels} octant {o} {k}")


@pytest.mark.parametrize("rowstats", [False, True])
@pytest.mark.parametrize("name", ["b2c", "b2s"])
def test_strand_sim_walk_strand_equals_raytpus(name, rowstats):
    """Each 32-ray strand of the first 2,048 engine-sorted rays, raytpu's
    octant choice, through both copies of ``walk_strand``: the same steps,
    leaf visits and row statistics."""
    rt = _rt("strand_sim")
    host = _host_pack()
    n = host.bvh.nodes.shape[0]
    tree = strand_sim.decode_tree(host.bvh.strand_rows, n)
    leaf = np.asarray(host.bvh.leaf_tris)
    ro, rd, tmax, tmin, any_hit = _sorted_wave(name)
    stats = ({}, {}) if rowstats else (None, None)
    walked = 0
    for i in range(ro.shape[0] // 32):
        sl = slice(i * 32, (i + 1) * 32)
        if (tmax[sl] < 0).all():
            continue
        o = ((rd[sl][0, 0] < 0) + 2 * (rd[sl][0, 1] < 0)
             + 4 * (rd[sl][0, 2] < 0))
        got = strand_sim.walk_strand(tree[o], leaf, ro[sl], rd[sl], tmax[sl],
                                     tmin, any_hit, stats[0])
        want = rt.walk_strand(tree[o], leaf, ro[sl], rd[sl], tmax[sl], tmin,
                              any_hit, stats[1])
        assert got == want, i
        walked += 1
    assert walked > 16
    assert stats[0] == stats[1]


# ----------------------------------------------------------------- bgemm


def test_bgemm_sim_unions_and_tests_equal_raytpus(monkeypatch, capsys):
    """raytpu's ``main`` at 5,000 triangles, budgets 64 and 128, on b2c and
    b2s, with its ``block_unions`` recording each call: the port's
    candidates and unions equal its arguments and results, and the port's
    table its hardware-independent columns."""
    rt = _rt("bgemm_sim")
    calls = []
    real = rt.block_unions

    def record(cand, block):
        out = real(cand, block)
        calls.append((cand, block, out))
        return out

    monkeypatch.setattr(rt, "block_unions", record)
    out = _run_main(rt, ["--tris", "5000", "--budgets", "64", "128",
                         "--waves", "b2c", "b2s", "--blocks", "128", "256"],
                    monkeypatch, capsys)
    host = _host_pack()
    pack = host.to("cpu")
    sorted_ = {}
    for name in ("b2c", "b2s"):
        w = waves.load_wave(name, prefer_full=False)
        sorted_[name] = (*waves.engine_sort(pack, w["ro"], w["rd"],
                                            w["tmax"]), float(w["tmin"]))
    rows = [bgemm_sim.sizing(host.bvh.node8_rows, host.bvh.leaf_tris, b,
                             sorted_, (128, 256)) for b in (64, 128)]
    from raytpu_torch.accel.bvh import Bvh8Arrays
    from raytpu_torch.accel.treelets import build_treelets

    i = 0
    for budget in (64, 128):
        tl = build_treelets(Bvh8Arrays(host.bvh.node8_rows,
                                       host.bvh.leaf_tris.shape[0]),
                            host.bvh.leaf_tris, budget_rows=budget)
        for name, (ro, rd, tmax, tmin) in sorted_.items():
            cand = bgemm_sim.candidates(
                ro, rd, tmax, tmin, torch.as_tensor(tl.tbox_min),
                torch.as_tensor(tl.tbox_max))
            for b in (128, 256):
                rcand, rb, rout = calls[i]
                i += 1
                assert rb == b
                _same(cand.numpy(), rcand, f"{budget} {name} candidates")
                got = bgemm_sim.block_unions(cand, b).numpy()
                np.testing.assert_array_equal(got, rout)
    assert i == len(calls) == 8
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bgemm_sim.print_rows(rows, (128, 256))
    mine = buf.getvalue().splitlines()
    theirs = [ln for ln in out.splitlines() if "|" in ln]
    assert len(mine) == len(theirs) == 5
    for a, b in zip(mine[1:], theirs[1:]):
        head_a, cols_a = a.split("|")
        head_b, cols_b = b.split("|")
        assert head_a == head_b
        # raytpu's columns: U, tests, est (a TPU's rate) per block
        ta, tb = cols_a.split(), cols_b.split()
        assert ta[:3] == tb[:3]
        assert ta[3:5] == tb[3:5] and ta[5:7] == tb[6:8]


# ------------------------------------------------------------- multichip


def test_multichip_counts_equal_raytpus_arithmetic(tmp_path, monkeypatch):
    """Ray queries per shard (contiguous and 4 round-robin tiles a shard)
    on the cube stand-in at 64x64, 4 spp, 2 bounces: the port's
    ``shard_ray_counts`` against raytpu's arithmetic over its
    ``_count_tile``."""
    import raytpu
    from raytpu.engine.render import _count_tile as rt_count_tile
    from raytpu.scene.pack import pack_camera as rt_pack_camera
    from raytpu.scene.pack import pack_scene as rt_pack_scene

    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    pack, cam, config = multichip_report.setup("cpu")
    glb = str(tmp_path / "cube_standin.glb")
    rpack = rt_pack_scene(raytpu.load_scene(glb))
    rcam = rt_pack_camera(raytpu.load_camera_json(
        str(tmp_path / "cube_camera.json"), 64, 64))
    h = w = 64

    def rt_counts(tiles_per_shard):  # benchmarks/multichip_report.py:97-115
        rps = -(-h // (8 * tiles_per_shard))
        sub = raytpu.RenderConfig(
            width=w, height=h, seed=1, samples=config.samples,
            bounces=config.bounces, chunk_size=16, tile_rows=rps)
        per_shard = [0] * 8
        for s in range(8):
            for i in range(tiles_per_shard):
                y0 = (i * 8 + s) * rps
                if y0 >= h:
                    continue
                per_shard[s] += int(np.asarray(rt_count_tile(
                    rpack, rcam, jnp.int32(y0), sub, rps,
                    min(rps, h - y0),
                ), np.int64).sum())
        return per_shard

    for tps in (1, 4):
        got = multichip_report.shard_ray_counts(pack, cam, config, tps)
        assert got == rt_counts(tps), tps
        assert len(set(got)) > 1


def test_multichip_report_on_eight_cpu_shards(tmp_path, monkeypatch, capsys):
    """The report's command line on ``["cpu"] * 8``: its asserts pass and
    the 8-way render equals ``render_frame`` bit for bit, in both
    interleavings."""
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    assert multichip_report.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sharded == single-device: bit_equal=True" in out
    assert "round-robin (tiles_per_shard=4) == single-device: bit_equal=True" \
        in out
    assert "built 0, loaded 0" in out
    assert scenes.CUBE_NOTE in out.splitlines()[2]
    pack, cam, config = multichip_report.setup("cpu")
    from raytpu_torch.parallel.shard import render_frame_sharded

    single = render_frame(pack, cam, config)
    out8 = render_frame_sharded(pack, cam, config, devices=["cpu"] * 8)
    assert out8.tobytes() == single.tobytes()


# --------------------------------------------------------- frame profile


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, pid=1, tid=tid, ts=ts, dur=dur,
                args=args)


def test_frame_profile_groups_a_synthetic_trace():
    """One device event of each kind, launched under the ops the engine
    uses: each lands in its group, the groups sum to the total, the ops
    are the outermost launching ones, and a trace without device events
    raises."""
    kinds = [  # (launching ops, outermost first; kernel; group)
        ([], "void strand::walk_kernel<128, false>(walk::Args)",
         "strand kernel"),
        ([], "void (anonymous namespace)::packet_kernel<false, false, "
             "false, false>(walk::Args)", "packet kernel"),
        ([], "void (anonymous namespace)::binned_kernel<false>(walk::Args)",
         "binned kernel"),
        (["aten::sort", "aten::copy_"],
         "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()",
         "sort"),
        (["aten::index"], "void at::native::index_elementwise_kernel<>()",
         "gather"),
        (["aten::index_put_", "aten::_index_put_impl_"],
         "void at::native::index_put_kernel<>()", "scatter"),
        (["aten::to", "aten::_to_copy", "aten::copy_"],
         "void at::native::elementwise_kernel<copy>()", "memcpy"),
        (["aten::mul"], "void at::native::vectorized_elementwise_kernel<>()",
         "elementwise"),
        (["aten::sum"], "void at::native::reduce_kernel<>()", "other"),
    ]
    events, t = [], 0.0
    for corr, (ops, kernel, _) in enumerate(kinds):
        for depth, op in enumerate(ops):
            events.append(_x("cpu_op", op, t + depth, 10 - 2 * depth))
        events.append(_x("cuda_runtime", "cudaLaunchKernel", t + 5, 1,
                         correlation=corr))
        events.append(_x("kernel", kernel, t + 100, 1.0 + corr, tid=7,
                         correlation=corr))
        t += 20
    events.append(_x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                     t + 100, 4.0, tid=8))
    events.append(dict(ph="M", name="process_name", pid=1, args={}))
    rep = frame_profile.parse_events(events)
    groups = rep["groups"]
    for corr, (_, _, group) in enumerate(kinds):
        want = 1 + (group == "memcpy")
        assert groups[group][1] == want, group
    assert groups["memcpy"][0] == pytest.approx((1.0 + 6) / 1e3 + 4e-3)
    assert sum(ms for ms, _ in groups.values()) == pytest.approx(
        rep["total_ms"])
    assert rep["total_ms"] == pytest.approx(
        (sum(1.0 + c for c in range(len(kinds))) + 4.0) / 1e3)
    assert rep["n_events"] == len(kinds) + 1
    assert rep["ops"]["aten::to", "memcpy"] == [7e-3, 1]
    assert rep["ops"]["strand::walk_kernel", "strand kernel"][1] == 1
    assert ("Memcpy DtoH", "memcpy") in rep["ops"]
    line = frame_profile.summary_line(dict(rep, wall_ms=1.0))
    assert "strand kernel 0.00 (1)" in line and "device busy" in line
    with pytest.raises(frame_profile.NoDeviceEvents):
        frame_profile.parse_events([e for e in events
                                    if e.get("cat") not in ("kernel",
                                                            "gpu_memcpy")])


def test_frame_profile_fails_loudly_without_device_events(tmp_path,
                                                          monkeypatch):
    """On the CPU a frame's trace has no device events: the command line
    exits non-zero, naming that, and prints no table."""
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    pack, cam, cfg = frame_profile.frame_setup("multi", 0, 0, 0, 0, 0, "cpu")
    small = dataclasses.replace(cfg, width=16, height=16, samples=1,
                                bounces=1)
    with pytest.raises(frame_profile.NoDeviceEvents):
        frame_profile.capture(pack, cam, small, str(tmp_path / "trace"))
    assert (tmp_path / "trace" / frame_profile.TRACE_NAME).exists()
    with pytest.raises(SystemExit, match="no device events"):
        frame_profile.main(["--parse-only", "--outdir",
                            str(tmp_path / "trace")])


# ---------------------------------------------------------- command lines


@pytest.mark.parametrize("tool", ["sort_bench", "gather_bench"])
def test_sort_and_gather_bench_check_on_the_cpu(tool, capsys):
    mod = {"sort_bench": sort_bench, "gather_bench": gather_bench}[tool]
    extra = ["--table", "1000"] if tool == "gather_bench" else []
    assert mod.main(["--device", "cpu", "--rows", "4096", "--inner", "2",
                     "--repeats", "1", "--check"] + extra) == 0
    out = capsys.readouterr().out.splitlines()
    if tool == "sort_bench":
        checks = [ln for ln in out if ln.startswith("check ")]
        assert len(checks) == 4 and all(
            ln.endswith("equal to a stable argsort plus gathers")
            for ln in checks)
        assert out[4] == "| sort | operands | ms |"
        assert "x3.5 bounce-equivalents" in out[-1]
    else:
        assert out[0] == "| cols | ms | Mrows/s | GB/s |"
        assert len(out) == 2 + 6 + 1
        assert out[-1].endswith("equals numpy's on the same indices")


def test_sort_bench_check_catches_a_wrong_permutation():
    x = sort_bench.inputs(4096, "cpu")
    rows = sort_bench.rows(x)
    row = rows[1]
    good = row.body
    assert sort_bench.check(row, x) == ""
    row.body = lambda k: (lambda p, o: (p.flip(0), o))(*good(k))
    assert sort_bench.check(row, x) == "permutation"
    row.body = lambda k: (lambda p, o: (p, [o[0] + 1] + o[1:]))(*good(k))
    assert sort_bench.check(row, x) == "ro"


def test_headline_ab_pbr_on_the_cpu(tmp_path, monkeypatch, capsys):
    """raytpu's pbr config at 32x32 through ``render_frame`` on the CPU:
    raytpu's report lines, and the PNG of the timed frame."""
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    png = tmp_path / "pbr.png"
    assert headline_ab.main(["--scene", "pbr", "--device", "cpu", "--width",
                             "32", "--height", "32", "--repeats", "1",
                             "--count-rays", "--output", str(png)]) == 0
    captured = capsys.readouterr()
    out = captured.out.splitlines()
    assert out[0].startswith("scene: pbr+nee (BASELINE config 4), 88 slots, "
                             "32x32 4 spp 4 bounces chunk 32")
    assert out[1].startswith("steady frame ") and " Mrays/s" in out[1]
    assert captured.err.startswith("warmup ")
    assert png.stat().st_size > 0


def test_profile_atrium_command_line_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    assert profile_atrium.main(["--device", "cpu", "--tris", "5000",
                                "--rays", "2048", "--packets", "1024", "512",
                                "--inner", "1", "--repeats", "1", "--plain",
                                "64"]) == 0
    out = capsys.readouterr().out
    table = [ln for ln in out.splitlines() if ln.startswith("| ")]
    assert table[0].startswith("| rays | packet | Mrays/s |")
    labels = [ln.split("|")[1].strip() for ln in table[1:]]
    assert labels == ["primary"] + [f"bounce/{m}" for m in
                                    profile_atrium.SORT_MODES
                                    for _ in (1024, 512)] + ["shadow(any)"]


def test_strand_sim_command_line_on_the_cpu(tmp_path, monkeypatch, capsys):
    """raytpu's line at strands of 32 and 128, and at 32 the block walk's
    own counters on the same rays: the sim's immediate best-t is the plain
    block walk's, so the ratios are 1."""
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    assert strand_sim.main(["--device", "cpu", "--tris", "5000",
                            "--max-rays", "1024", "--strand", "32", "128",
                            "--waves", "b2c"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("b2c bits=6 S=32: strands=32 steps/ray=")
    assert "strand_block counters (cpu)" in out[1]
    assert out[1].endswith("steps 1.000 leafs 1.000")
    assert out[2].startswith("b2c bits=6 S=128: strands=8 ")


def test_bgemm_sim_command_line_prints_no_rate_on_the_cpu(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    assert bgemm_sim.main(["--device", "cpu", "--tris", "5000", "--budgets",
                           "128", "--waves", "b1c"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and "est-Mray/s" not in out[0]
    assert out[1].split()[:5] == ["128", "8", "904", "89.0", "|"]


# ----------------------------------------------------------- no JAX side


def test_tools_import_no_jax_raytpu_bench_or_benchmarks():
    """Every module of ``raytpu_torch/tools/`` imports, and the GLB writer
    loads, in a process where jax, raytpu, bench and benchmarks cannot be
    imported; and no module of ``raytpu_torch/`` nor ``chip_smoke.py``
    names one of them in an import statement."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'raytpu', 'bench', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        f"for tool in {TOOLS!r} + ('scenes', 'waves', 'strand_ab', "
        "'timing'):\n"
        "    importlib.import_module('raytpu_torch.tools.' + tool)\n"
        "from raytpu_torch.tools import scenes\n"
        "scenes._writer()\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if sys.modules[n] is not None\n"
        "             and n.split('.')[0] in ('jax', 'jaxlib', 'raytpu',\n"
        "                                     'bench', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    banned = {"jax", "jaxlib", "raytpu", "bench", "benchmarks"}
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(
            REPO, "raytpu_torch")) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & banned, (
                path, node.lineno)
