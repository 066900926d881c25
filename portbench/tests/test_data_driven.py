"""A cell and a per-layer metric are added from files alone: new files
under configs/, traffic/, limits/ and metrics/ plus new BENCHMARK.json
entries, with no existing file of the harness edited."""

import hashlib
import json
import os

from portbench.harness import cell

from .conftest import add_cell, last_line


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_throwaway_cell_and_metric_from_files_alone(tiny_root, capsys):
    before = _digests(tiny_root)
    add_cell(tiny_root, "atrium2k.path48",
             {"scene": "atrium", "scene_args": {"target_tris": 2000},
              "pack": {"tables": "auto"}},
             {"mode": "path", "width": 48, "height": 32, "samples": 1,
              "bounces": 3, "chunk": 16, "warmup_frames": 1,
              "trace_frames": 1, "check_frames": 2, "check_pixels": 64},
             "atrium300k.path1080")
    with open(os.path.join(tiny_root, "portbench", "metrics",
                           "engine.frames_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['frames_traced']\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "engine.frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "engine", "moves": "frame_ms",
        "workloads": ["atrium2k.path48"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert len(after) == len(before) + 4

    assert cell.run(["--workload", "atrium2k.path48", "--seed", "8",
                     "--seconds", "0.3", "--trace", "1"], root=tiny_root,
                    dev="cpu") == 0
    line = last_line(capsys)
    assert line["correct"] is True
    assert line["metrics"]["engine.frames_traced"] == {"value": 1,
                                                      "unit": "frames"}
    # the other cells do not list the new metric and do not read it
    assert cell.run(["--workload", "atrium5k.path64", "--seed", "8",
                     "--seconds", "0.3", "--trace", "1"], root=tiny_root,
                    dev="cpu") == 0
    assert "engine.frames_traced" not in last_line(capsys)["metrics"]
