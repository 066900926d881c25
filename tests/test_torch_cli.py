"""raytpu_torch's CLI flags beyond the plain render (``--gui``,
``--checkpoint``, ``--devices``, ``--profile``) on the CPU, the GUI module
without a display, and the package's top-level API.

Each flag must exit 0 and write the same PNG as the plain run: the GUI's
headless fallback, a checkpointed render and row shards all return the
``render_frame`` result, and a profiled render is the same render."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import raytpu
from raytpu.gui import _frame_to_ppm as rt_frame_to_ppm
import raytpu_torch
from raytpu_torch import cli, gui
from raytpu_torch.engine import render
from raytpu_torch.scene.camera import load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .test_torch_host import AT, EYE, FOV, scene_path

headless = pytest.mark.skipif(
    bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")),
    reason="a display server would open a real window; the headless "
    "fallback contract only holds without one",
)


def _camera_json(tmp_path):
    path = tmp_path / "camera.json"
    path.write_text(json.dumps({"origin": EYE, "at": AT, "fov": FOV}))
    return path


def _args(tmp_path, out):
    return ["--width", "32", "--height", "24", "--seed", "3", "--scene",
            scene_path("gallery"), "--chunk-size", "8", "--samples", "1",
            "--bounces", "2", "--camera", str(_camera_json(tmp_path)),
            "--output", str(tmp_path / out), "--device", "cpu"]


@pytest.mark.parametrize("flag", [
    pytest.param(["--gui"], marks=headless, id="gui"),
    pytest.param(["--checkpoint", "ck.npz"], id="checkpoint"),
    pytest.param(["--devices", "2"], id="devices"),
    pytest.param(["--profile", "prof"], id="profile"),
])
def test_cli_flag_writes_the_plain_png(tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    assert cli.main(_args(tmp_path, "plain.png")) == 0
    assert cli.main(_args(tmp_path, "flag.png") + flag) == 0
    plain = (tmp_path / "plain.png").read_bytes()
    assert (tmp_path / "flag.png").read_bytes() == plain
    if flag[0] == "--checkpoint":
        with np.load(tmp_path / "ck.npz") as ck:
            assert int(ck["next_y0"]) == 24
            assert ck["frame"].shape == (24, 32, 4)
    if flag[0] == "--profile":
        traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names)


def test_profile_trace_is_written_when_the_render_raises(tmp_path,
                                                         monkeypatch):
    def boom(*args, **kwargs):
        torch.ones(3) * 2
        raise RuntimeError("render failed")

    monkeypatch.setattr(render, "render_frame", boom)
    with pytest.raises(RuntimeError, match="render failed"):
        cli.main(_args(tmp_path, "x.png") + ["--profile",
                                             str(tmp_path / "prof")])
    assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert not (tmp_path / "x.png").exists()


def test_ppm_encoding_roundtrip():
    rgba = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    ppm = gui._frame_to_ppm(rgba)
    assert ppm == rt_frame_to_ppm(rgba)
    assert ppm.startswith(b"P6 3 2 255 ")
    body = ppm[len(b"P6 3 2 255 "):]
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(2, 3, 3), rgba[:, :, :3])


@headless
def test_headless_gui_renders_exact_frame(tmp_path, capsys):
    pack = pack_scene(load_scene(scene_path("small")), "cpu")
    cam = pack_camera(raytpu_torch.camera_from_lookat(EYE, AT, FOV, 32, 32),
                      "cpu")
    config = RenderConfig(width=32, height=32, seed=1, samples=1, bounces=2,
                          chunk_size=16, tile_rows=8)
    assert gui._try_tk(32, 32) is None
    via_gui = gui.run_gui(pack, cam, config)
    np.testing.assert_array_equal(via_gui, render.render_frame(pack, cam,
                                                               config))
    assert "(32/32 rows)" in capsys.readouterr().err


def test_top_level_api_renders_host_scenes(tmp_path):
    assert raytpu_torch.__all__ == raytpu.__all__
    for name in raytpu_torch.__all__:
        assert getattr(raytpu_torch, name) is not None, name
    scene = raytpu_torch.load_scene(scene_path("small"))
    cam = load_camera_json(str(_camera_json(tmp_path)), 32, 24)
    cfg = raytpu_torch.RenderConfig(width=32, height=24, seed=2, samples=1,
                                    bounces=2, chunk_size=8)
    got = raytpu_torch.render(scene, cam, cfg, device="cpu")
    pack = pack_scene(scene, "cpu")
    camp = pack_camera(cam, "cpu")
    want = render.render_frame(pack, camp, cfg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(raytpu_torch.render(pack, camp, cfg), want)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            raytpu_torch.render(scene, cam, cfg)
