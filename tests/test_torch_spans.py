"""The program's spans (``raytpu_torch/obs.py``) in a torch.profiler
trace: a small atrium frame (path and flat, two tiles, two samples), a
4-spp frame of the cube stand-in (one tile) and ``pack_scene`` under the
profiler name every layer's work with ``raytpu::<layer>.<what>`` spans
that nest on one thread; with no profiler running no span is made and
the frame is bit-equal. On the card (``cuda`` marker), the ``.sync``
spans of a frame are its host syncs, every walk kernel is launched
inside a ``raytpu::kernels.*`` span, and each frame is read back into
page-locked memory that later frames reuse.

Nothing here imports JAX or raytpu: on a machine with the card,
``python -m pytest --noconftest tests/test_torch_spans.py -m cuda``."""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
import warnings

import numpy as np
import pytest
import torch

from raytpu_torch import obs
from raytpu_torch.engine.render import render_frame, render_frame_tiles
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.scene.camera import load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.tools.scenes import (build_atrium, write_cube,
                                       write_cube_camera)
from raytpu_torch.types import RenderConfig

TRIS = 5000
LAYERS = ("entry", "scene", "engine", "kernels")
FRAME = dict(width=64, height=36, seed=7, samples=2, bounces=4,
             chunk_size=8, tile_rows=18)  # two tiles
SYNC_WARNING = re.compile("synchroniz", re.IGNORECASE)


@functools.lru_cache(maxsize=None)
def _scene():
    return build_atrium(TRIS)


@functools.lru_cache(maxsize=None)
def _packed(device: str):
    scene = _scene()
    return pack_scene(scene, device), pack_camera(scene.camera, device)


def _config(mode: str, **extra) -> RenderConfig:
    return RenderConfig(**{**FRAME, **extra}, mode=mode)


def _activities(device: str):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])


def _traced(fn, device: str = "cpu"):
    """(fn's result, the Chrome trace's events) of one call of ``fn``
    under torch.profiler."""
    from torch.profiler import profile

    with profile(activities=_activities(device)) as prof:
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)["traceEvents"]


def _spans(events) -> list:
    """(start, end, name, thread) of the trace's program spans."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"], (e.get("pid"), e.get("tid"))) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(obs.PREFIX)]


def _layer(name: str) -> str:
    return re.fullmatch(r"raytpu::([a-z]+)\.[a-z_.]+", name).group(1)


def _count(spans, name) -> int:
    return sum(1 for s in spans if s[2] == name)


def _parents(spans) -> dict:
    """{span: the innermost span that holds it, or None}; asserts that
    the spans nest on each thread (a child starts and ends inside its
    parent, to the trace's rounding)."""
    out = {}
    for thread in {s[3] for s in spans}:
        stack = []
        for s in sorted((s for s in spans if s[3] == thread),
                        key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            if stack:
                assert s[1] <= stack[-1][1] + 0.01, (s, stack[-1])
            out[s] = stack[-1] if stack else None
            stack.append(s)
    return out


@functools.lru_cache(maxsize=None)
def _frames(mode: str):
    """(the plain frame, the profiled frame, its program spans) on the
    CPU."""
    pack, cam = _packed("cpu")
    plain = render_frame(pack, cam, _config(mode))
    traced, events = _traced(lambda: render_frame(pack, cam, _config(mode)))
    return plain, traced, _spans(events)


@pytest.mark.parametrize("mode", ["path", "flat"])
def test_profiled_frame_is_the_plain_frame(mode):
    plain, traced, _ = _frames(mode)
    assert np.array_equal(plain, traced)


@pytest.mark.parametrize("mode", ["path", "flat"])
def test_one_frame_span_and_every_span_in_a_layer(mode):
    _, _, spans = _frames(mode)
    assert _count(spans, "raytpu::entry.frame") == 1
    assert _count(spans, "raytpu::entry.tile") == 2
    assert _count(spans, "raytpu::entry.sample") == 2 * FRAME["samples"]
    assert _count(spans, "raytpu::entry.readback") == 2
    assert _count(spans, "raytpu::entry.sync.readback") == 1
    assert _count(spans, "raytpu::entry.stitch") == 0
    assert {_layer(s[2]) for s in spans} <= set(LAYERS)


@pytest.mark.parametrize("mode", ["path", "flat"])
def test_spans_nest_inside_the_frame_on_one_thread(mode):
    _, _, spans = _frames(mode)
    parents = _parents(spans)
    assert len({s[3] for s in spans}) == 1
    roots = [s for s, p in parents.items() if p is None]
    assert [s[2] for s in roots] == ["raytpu::entry.frame"]
    for s, p in parents.items():
        if s[2] in ("raytpu::entry.tile", "raytpu::entry.alloc",
                    "raytpu::entry.readback", "raytpu::entry.sync.readback"):
            assert p[2] == "raytpu::entry.frame", s
        if s[2] == "raytpu::entry.sample":
            assert p[2] == "raytpu::entry.tile", s
        if s[2] in ("raytpu::engine.paths", "raytpu::engine.flat"):
            assert p[2] == "raytpu::entry.sample", s
        if s[2] == "raytpu::engine.bounce":
            assert p[2] == "raytpu::engine.paths", s


def test_paths_once_a_tile_sample_and_bounces_within_their_number():
    _, _, spans = _frames("path")
    tile_samples = 2 * FRAME["samples"]
    assert _count(spans, "raytpu::engine.paths") == tile_samples
    assert 0 < _count(spans, "raytpu::engine.bounce") <= (
        tile_samples * FRAME["bounces"])
    parents = _parents(spans)
    for paths in (s for s in spans if s[2] == "raytpu::engine.paths"):
        inside = [s for s, p in parents.items()
                  if s[2] == "raytpu::engine.bounce" and p == paths]
        assert 0 < len(inside) <= FRAME["bounces"]
    for name in ("raytpu::engine.shade", "raytpu::engine.nee",
                 "raytpu::engine.sort", "raytpu::engine.sync.alive"):
        assert _count(spans, name) > 0, name


def test_flat_frame_has_no_bounce_engine():
    _, _, spans = _frames("flat")
    assert _count(spans, "raytpu::engine.flat") == 2 * FRAME["samples"]
    assert not [s for s in spans if s[2] in (
        "raytpu::engine.paths", "raytpu::engine.bounce",
        "raytpu::engine.sort")]


def test_fused_wave_mode_spans(monkeypatch):
    """The fused wave mode's bounces, sorts and live-lane reads are spans
    too (a 1080p tile's mode; forced here on a small one)."""
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", "1")
    pack, cam = _packed("cpu")
    cfg = _config("path", samples=1, tile_rows=None)
    _, events = _traced(lambda: render_frame(pack, cam, cfg))
    spans = _spans(events)
    assert _count(spans, "raytpu::engine.paths") == 1
    assert 1 < _count(spans, "raytpu::engine.bounce") <= cfg.bounces
    assert _count(spans, "raytpu::engine.sync.alive") == _count(
        spans, "raytpu::engine.bounce")
    _parents(spans)


def test_pack_scene_spans_its_phases():
    scene = _scene()
    _, events = _traced(lambda: (pack_scene(scene, "cpu"),
                                 pack_camera(scene.camera, "cpu")))
    spans = _spans(events)
    parents = _parents(spans)
    assert _count(spans, "raytpu::scene.pack") == 1
    assert _count(spans, "raytpu::scene.camera") == 1
    phases = {s[2] for s, p in parents.items()
              if p is not None and p[2] == "raytpu::scene.pack"}
    assert phases == {"raytpu::scene.flatten", "raytpu::scene.bvh",
                      "raytpu::scene.treelets", "raytpu::scene.strand",
                      "raytpu::scene.ribbon", "raytpu::scene.upload"}
    assert {_layer(s[2]) for s in spans} == {"scene"}


def test_no_profiler_makes_no_span(monkeypatch):
    """With no profiler running the helper never reaches
    ``record_function``: the pack and the frame run with it raising, and
    the frame is bit-equal to the profiled one."""
    def refuse(name):
        raise AssertionError(f"span {name} made with no profiler running")

    monkeypatch.setattr(obs, "record_function", refuse)
    scene = _scene()
    pack, cam = pack_scene(scene, "cpu"), pack_camera(scene.camera, "cpu")
    for mode in ("path", "flat"):
        _, traced, _ = _frames(mode)
        assert np.array_equal(render_frame(pack, cam, _config(mode)),
                              traced)
    assert obs.span("raytpu::entry.frame") is obs.span("raytpu::x.y")


def _annotation(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _device(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": ts,
            "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": corr}}


CANNED = [
    _annotation("raytpu::entry.frame", 0, 1000),
    _annotation("raytpu::entry.alloc", 0, 100),
    _annotation("raytpu::entry.tile", 100, 700),
    _annotation("raytpu::engine.paths", 150, 600),
    _annotation("raytpu::engine.sync.alive", 200, 40),
    _annotation("raytpu::kernels.strand", 300, 30),
    _annotation("raytpu::entry.readback", 850, 100),
    _annotation("raytpu::engine.shade", 0, 1000, tid=2),  # another thread
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 310, "dur": 10,
     "pid": 1, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 320, "dur": 5, "pid": 1, "tid": 1, "args": {"correlation": 1}},
    _device(220, 60, 0),
    _device(330, 300, 1),
    _device(990, 20, 2),
]


def test_frame_profile_reads_idle_by_innermost_span():
    """``tools/frame_profile.py``'s idle by program span on a canned
    trace: exact, split at the spans' edges, the frame's thread alone,
    and the benchmark's reader (``portbench/harness/spans.py``) reads the
    same over the same range."""
    from portbench.harness import spans as bench_spans
    from raytpu_torch.tools import frame_profile

    rep = frame_profile.parse_events(CANNED)
    # idle: 0-220, 280-330, 630-990 (the trace spans 0-1010)
    want = {"raytpu::entry.alloc": 100, "raytpu::entry.tile": 50 + 50,
            "raytpu::engine.paths": 50 + 20 + 120,
            "raytpu::engine.sync.alive": 20, "raytpu::kernels.strand": 30,
            "raytpu::entry.readback": 100, "raytpu::entry.frame": 50 + 40,
            frame_profile.OUTSIDE: 0}
    got = {k: round(v * 1e3, 6) for k, v in rep["idle"].items()}
    assert {k: v for k, v in got.items() if v} == {
        k: v for k, v in want.items() if v}
    bench = bench_spans.reduce(CANNED, 0.0, 1010.0)["idle_s"]
    assert {k: round(v * 1e6, 6) for k, v in bench.items() if v} == {
        k: v for k, v in want.items() if v}
    line = frame_profile.summary_line(dict(rep, wall_ms=1.0))
    assert "device idle ms by program span: engine.paths 0.19" in line
    assert frame_profile.idle_by_span([], [], 0.0, 1.0) == {}


CUBE = dict(width=128, height=128, seed=7, samples=4, bounces=4,
            chunk_size=64, mode="path")  # one tile
# a cube frame's host syncs: an attenuation copy a sample, a live-lane read
# a bounce of each sample (some lane survives to every bounce), the readback
CUBE_SYNCS = CUBE["samples"] * (1 + CUBE["bounces"]) + 1


@functools.lru_cache(maxsize=None)
def _cube(device: str):
    """(pack, camera) of the cube stand-in, written as a GLB and a
    camera.json and loaded as a user's files are."""
    with tempfile.TemporaryDirectory() as tmp:
        write_cube(os.path.join(tmp, "cube.glb"))
        write_cube_camera(os.path.join(tmp, "camera.json"))
        scene = load_scene(os.path.join(tmp, "cube.glb"))
        cam = load_camera_json(os.path.join(tmp, "camera.json"),
                               CUBE["width"], CUBE["height"])
    return pack_scene(scene, device), pack_camera(cam, device)


def test_cube_frame_spans_each_sample_and_its_syncs():
    """A 4-spp frame of one tile: an ``entry.sample`` span a sample, each
    holding that sample's ``engine.paths``, and 21 ``.sync`` spans."""
    pack, cam = _cube("cpu")
    _, events = _traced(lambda: render_frame(pack, cam,
                                             RenderConfig(**CUBE)))
    spans = _spans(events)
    parents = _parents(spans)
    assert _count(spans, "raytpu::entry.tile") == 1
    samples = [s for s in spans if s[2] == "raytpu::entry.sample"]
    assert len(samples) == CUBE["samples"]
    for sample in samples:
        assert parents[sample][2] == "raytpu::entry.tile"
        assert [s[2] for s, p in parents.items() if p == sample] == [
            "raytpu::engine.paths"]
    syncs = [s[2] for s in spans if ".sync" in s[2]]
    assert len(syncs) == CUBE_SYNCS
    assert syncs.count("raytpu::engine.sync.alive") == (
        CUBE["samples"] * CUBE["bounces"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see the module "
                    "docstring)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["path", "flat"])
@pytest.mark.parametrize("width,height", [(64, 36), (1920, 1080)])
def test_sync_spans_are_the_frames_host_syncs(mode, width, height):
    """The ``.sync`` spans of one frame on the card are as many as the
    synchronising calls that ``set_sync_debug_mode("warn")`` reports for
    the same frame (at 1080p one tile in fused wave mode)."""
    dev = _card()
    pack, cam = _packed(dev)
    cfg = _config(mode, width=width, height=height, samples=1,
                  tile_rows=None)
    render_frame(pack, cam, cfg)  # builds and warms everything
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            render_frame(pack, cam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if SYNC_WARNING.search(str(w.message))]
    _, events = _traced(lambda: render_frame(pack, cam, cfg), dev)
    spans = _spans(events)
    marked = [s[2] for s in spans if ".sync" in s[2]]
    print(f"{mode} {width}x{height}: {len(syncs)} syncs, spans "
          f"{sorted(set(marked))}")
    assert len(syncs) > 0
    assert len(marked) == len(syncs)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["path", "flat"])
def test_walk_launches_fall_inside_kernel_spans(mode):
    """Every walk kernel's device event has its runtime launch inside a
    ``raytpu::kernels.*`` span: the spans and the device events share
    the trace's clock."""
    dev = _card()
    pack, cam = _packed(dev)
    cfg = _config(mode)
    render_frame(pack, cam, cfg)
    _, events = _traced(lambda: render_frame(pack, cam, cfg), dev)
    kernel_spans = [s for s in _spans(events)
                    if s[2].startswith("raytpu::kernels.")
                    and ".sync" not in s[2]]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and "correlation" in e.get("args", {})
                and str(e.get("cat", "")).lower() in ("cuda_runtime",
                                                      "cuda_driver")}
    walks = [e for e in events if e.get("ph") == "X"
             and str(e.get("cat", "")).lower() == "kernel"
             and re.search(r"walk_kernel|block_kernel|packet(_option)?_"
                           r"kernel|binned_kernel", e.get("name", ""))]
    assert walks
    for w in walks:
        call = launches[w["args"]["correlation"]]
        ts = float(call["ts"])
        thread = (call.get("pid"), call.get("tid"))
        assert any(a <= ts <= b and t == thread
                   for a, b, _, t in kernel_spans), w["name"]


@pytest.mark.cuda
def test_cube_sync_spans_are_the_frames_host_syncs():
    """The cube frame's ``.sync`` spans on the card: as many as
    ``set_sync_debug_mode("warn")`` counts, and the CPU's 21."""
    dev = _card()
    pack, cam = _cube(dev)
    cfg = RenderConfig(**CUBE)
    render_frame(pack, cam, cfg)  # builds and warms everything
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            render_frame(pack, cam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if SYNC_WARNING.search(str(w.message))]
    _, events = _traced(lambda: render_frame(pack, cam, cfg), dev)
    marked = [s[2] for s in _spans(events) if ".sync" in s[2]]
    print(f"cube: {len(syncs)} syncs, {len(marked)} .sync spans")
    assert len(marked) == len(syncs) == CUBE_SYNCS


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["path", "flat"])
@pytest.mark.parametrize("width,height,tile_rows", [
    (64, 36, 18), (1920, 1080, None)])
def test_frame_reads_back_into_reused_pinned_memory(mode, width, height,
                                                    tile_rows):
    """On the card a frame (two tiles at 64x36, one at 1080p) is bit-equal
    to ``render_frame_tiles``' tiles stitched into zeros and lives in
    page-locked memory; after three warm-up frames, ten more, each
    rendered while the one before is held (as the benchmark holds it),
    take every block from the pinned host cache and allocate none."""
    dev = _card()
    pack, cam = _packed(dev)
    cfg = _config(mode, width=width, height=height, samples=1,
                  tile_rows=tile_rows)
    want = np.zeros((height, width, 4), np.float32)
    for y0, rows, tile in render_frame_tiles(pack, cam, cfg):
        want[y0 : y0 + rows] = tile
    frame = render_frame(pack, cam, cfg)
    assert torch.from_numpy(frame).is_pinned()
    np.testing.assert_array_equal(frame.view(np.uint32),
                                  want.view(np.uint32))
    for _ in range(3):
        frame = render_frame(pack, cam, cfg)
    before = torch.cuda.host_memory_stats()
    for _ in range(10):
        frame = render_frame(pack, cam, cfg)
    after = torch.cuda.host_memory_stats()
    print(f"{mode} {width}x{height}: pinned blocks "
          f"{after['allocations.current']}, "
          f"{after['allocated_bytes.current']} B")
    assert after["num_host_alloc"] == before["num_host_alloc"]
    np.testing.assert_array_equal(frame.view(np.uint32),
                                  want.view(np.uint32))
