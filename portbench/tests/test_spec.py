"""BENCHMARK.json against the files it names and the benchmark's rules:
each cell's configuration, traffic and limits exist, each per-layer
metric has its reader, and names, sizes and bounds keep their limits."""

import json
import os
import re

import pytest

from portbench.harness import spec

S = spec.Spec()
B = S.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    cfg = S.config(w["config"])
    t = S.traffic(w["traffic"])
    assert {"mode", "width", "height", "samples", "bounces", "chunk",
            "check_frames", "check_pixels"} <= set(t)
    limits = S.limits(w["name"])
    assert set(limits) == {"diverged_pct"}
    assert 0 < limits["diverged_pct"]["limit"] < 100
    assert os.path.exists(os.path.join(S.dir, "scenes",
                                       cfg["scene"] + ".py"))


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/configs/")
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []
    assert any(w["config"] == c["name"] for w in B["workloads"])


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        # each cell that reads it reports the metric that it moves
        assert set(m.get("workloads", cells)) <= set(
            e2e[m["moves"]].get("workloads", cells))
        assert callable(S.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_enough(w):
    names = {m["name"] for m in S.end_to_end(w["name"])}
    assert "setup_s" in names and len(names) >= 2
    assert S.per_layer(w["name"])
    # the busy clock's profiler would slow the frames that frame_ms times
    assert not {"frame_ms", "busy_ms"} <= names
