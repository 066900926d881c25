"""On the card (``cuda`` marker; skipped without one): the reference
against the program's frame at a small size, the bfloat16 control
rejected there, and a whole tiny run, plain and traced."""

import numpy as np
import pytest
import torch

from portbench.harness import cell, check, port
from portbench.reference import tracer
from portbench.reference.world import World
from portbench.scenes import atrium

from .conftest import last_line

W, H = 160, 90


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["path", "flat"])
def test_reference_and_control_on_the_card(card, mode):
    arrays = atrium.build_atrium(20000)
    pack, cam, _ = port.pack(arrays, card, {"tables": "auto"})
    t = {"mode": mode, "width": W, "height": H, "samples": 1,
         "bounces": 4 if mode == "path" else 1, "chunk": 8}
    img = port.render(pack, cam, port.config(t, 2_900_000_001))
    del pack, cam
    ys, xs = np.mgrid[0:H, 0:W]
    xs, ys = xs.ravel(), ys.ravel()
    kw = dict(width=W, height=H, chunk=8, samples=1, bounces=t["bounces"],
              mode=mode)
    seeds = np.full(xs.shape, 2_900_000_001)
    ref = tracer.render_lanes(World(arrays, card), xs, ys, seeds, **kw)
    low = tracer.render_lanes(World(arrays, card, torch.bfloat16), xs, ys,
                              seeds, **kw)
    got = img[ys, xs]
    assert check.diverged_pct(got, ref) < 1.0
    assert check.diverged_pct(low, ref) > 10.0


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_on_the_card(card, tiny_root, capsys, trace):
    assert cell.run(["--workload", "atrium5k.path64", "--seed",
                     str(2 ** 31 + 5), "--seconds", "1", "--trace",
                     str(trace)], root=tiny_root) == 0
    line = last_line(capsys)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["device"]["window_s"] >= line["device"]["busy_s"]
        assert {"engine.glue_ms", "kernels.walk_ms", "device.idle_pct",
                "scene.pack_s", "kernels.walk_roofline",
                "entry.frame_ms_p95"} <= set(line["metrics"])
        assert 0 < line["metrics"]["kernels.walk_roofline"]["value"] < 100
        assert line["breakdown"]["device_ops"]
    else:
        assert set(line["metrics"]) == {"frame_ms", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_busy_run_on_the_card(card, tiny_root, capsys, trace):
    # a cell like the streamed one: busy_ms over every frame of the window,
    # no more than the frames' wall time and no less than the traced busy
    # share of it
    assert cell.run(["--workload", "atrium5k.path32", "--seed",
                     str(2 ** 31 + 7), "--seconds", "3", "--trace",
                     str(trace)], root=tiny_root) == 0
    line = last_line(capsys)
    assert line["correct"] is True
    if trace:
        assert set(line["metrics"]) == {
            "entry.frame_ms", "engine.glue_ms.busy", "kernels.walk_ms.busy",
            "scene.pack_s"}
    else:
        assert set(line["metrics"]) == {"busy_ms", "setup_s"}
        assert 0 < line["metrics"]["busy_ms"]["value"] < 1e3 * 3 / (
            line["attempted"] - 1)
