"""The cube cell: its frozen scene is bit-equal to what the program's
loaders give for the stand-in's files (which this test, and never the
harness, writes and loads through ``raytpu_torch``), its files are found
by name, a tiny copy of it runs on the CPU, and its two new readers read
what they should from a report."""

import dataclasses
import importlib.util

import numpy as np
import pytest

from portbench.harness import cell, spec
from portbench.scenes import cube_standin

from .conftest import add_cell, last_line

CELL = "cube_standin.path512"


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("width,height", [(512, 512), (64, 36)])
def test_frozen_cube_equals_the_programs_loaders(tmp_path, width, height):
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.tools.scenes import write_cube, write_cube_camera

    write_cube(str(tmp_path / "cube.glb"))
    write_cube_camera(str(tmp_path / "camera.json"))
    want = load_scene(str(tmp_path / "cube.glb"))
    cam = load_camera_json(str(tmp_path / "camera.json"), width, height)
    got = cube_standin.build(width, height)
    names = set()
    for f in dataclasses.fields(want):
        if f.name == "camera":
            assert want.camera is None  # the camera comes from camera.json
        elif f.name == "textures":
            assert want.textures == []
        else:
            _same(got[f.name], getattr(want, f.name), f.name)
            names.add(f.name)
    _same(got["camera_world"], cam.world, "camera_world")
    _same(got["camera_projection"], cam.projection, "camera_projection")
    assert set(got) == names | {"camera_world", "camera_projection"}
    assert got["indices"].shape == (36,) and got["vertex_pos"].shape == (
        24, 3)


def test_spec_finds_the_cells_files():
    s = spec.Spec()
    w = s.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "cube_standin", "path512", 1)
    cfg = s.config("cube_standin")
    assert cfg["scene"] == "cube_standin" and cfg["reduced"] == []
    assert cfg["scene_args"] == {"width": 512, "height": 512}
    t = s.traffic("path512")
    assert (t["mode"], t["width"], t["height"], t["samples"], t["bounces"],
            t["chunk"], t["check_pixels"]) == ("path", 512, 512, 4, 4, 64,
                                               1024)
    lim = s.limits(CELL)["diverged_pct"]
    assert 5 * lim["limit"] <= lim["upper"]
    assert 5 * lim["limit"] <= min(lim["faults"].values())
    assert lim["lower"] <= lim["limit"]
    for k, v in s.scene(cfg).items():
        _same(v, cube_standin.build(512, 512)[k], k)
    assert [m["name"] for m in s.end_to_end(CELL)] == ["busy_ms", "setup_s"]
    assert {"entry.frame_ms", "scene.pack_s", "engine.glue_ms.busy",
            "kernels.walk_ms.busy", "engine.launches",
            "kernels.walk_roofline.busy"} == {
                m["name"] for m in s.per_layer(CELL)}


def _report(groups):
    return {"groups": {g: [0.0, 0] for g in (
        "strand kernel", "packet kernel", "binned kernel", "sort", "gather",
        "scatter", "memcpy", "elementwise", "other")} | groups}


def test_launches_reads_device_events_a_traced_frame():
    read = spec.Spec().reader("engine.launches")
    rep = _report({"packet kernel": [0.003, 90], "memcpy": [0.001, 12],
                   "elementwise": [0.02, 1200]})
    assert read({"trace": rep, "frames_traced": 3}) == pytest.approx(
        (90 + 12 + 1200) / 3)
    assert read({"trace": None, "frames_traced": 3}) is None


def test_roofline_busy_reads_as_the_walk_roofline():
    s = spec.Spec()
    rep = _report({"packet kernel": [0.004, 90], "elementwise": [0.5, 10]})
    ctx = {"trace": rep, "card": {"name": "NVIDIA H100 80GB HBM3"},
           "counts": lambda: (1_000_000, 3_000_000, 2_000_000)}
    got = s.reader("kernels.walk_roofline.busy")(ctx)
    assert got == s.reader("kernels.walk_roofline")(ctx)
    assert 0 < got < 100
    assert s.reader("kernels.walk_roofline.busy")(dict(ctx, trace=None)) \
        is None
    # the reader is the accepted file's own code, not a copy of it
    path = s.dir + "/metrics/kernels.walk_roofline.busy.py"
    mod_spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    assert mod.read.__code__.co_filename.endswith("kernels.walk_roofline.py")


def test_tiny_cube_cell_runs_on_the_cpu(tiny_root, capsys):
    add_cell(tiny_root, "cube64.path64",
             {"scene": "cube_standin", "scene_args": {"width": 64,
                                                      "height": 64},
              "pack": {"tables": "auto"}},
             {"mode": "path", "width": 64, "height": 64, "samples": 2,
              "bounces": 4, "chunk": 16, "warmup_frames": 1,
              "trace_frames": 1, "check_frames": 2, "check_pixels": 256},
             CELL)
    for trace in (0, 1):
        assert cell.run(["--workload", "cube64.path64", "--seed",
                         str(2 ** 31 + 9), "--seconds", "0.2", "--trace",
                         str(trace)], root=tiny_root, dev="cpu") == 0
        line = last_line(capsys)
        assert line["correct"] is True
        assert line["checks"]["diverged_pct"]["value"] == 0.0
        if trace:  # no device trace on the CPU: the trace readers are silent
            assert set(line["metrics"]) == {"entry.frame_ms",
                                            "scene.pack_s"}


@pytest.mark.cuda
def test_tiny_cube_cell_traced_on_the_card(card, tiny_root, capsys):
    add_cell(tiny_root, "cube128.path128",
             {"scene": "cube_standin", "scene_args": {"width": 128,
                                                      "height": 128},
              "pack": {"tables": "auto"}},
             {"mode": "path", "width": 128, "height": 128, "samples": 4,
              "bounces": 4, "chunk": 64, "warmup_frames": 2,
              "trace_frames": 2, "check_frames": 4, "check_pixels": 512},
             CELL)
    assert cell.run(["--workload", "cube128.path128", "--seed",
                     str(2 ** 31 + 11), "--seconds", "2", "--trace", "1"],
                    root=tiny_root) == 0
    line = last_line(capsys)
    assert line["correct"] is True
    m = line["metrics"]
    assert {"entry.frame_ms", "scene.pack_s", "engine.glue_ms.busy",
            "kernels.walk_ms.busy", "engine.launches",
            "kernels.walk_roofline.busy"} == set(m)
    assert 0 < m["kernels.walk_roofline.busy"]["value"] < 100
    # 4 samples of 1 primary and 4 bounces of a shadow and a closest walk
    assert m["engine.launches"]["value"] > 36
    assert line["breakdown"]["device_ops"]
