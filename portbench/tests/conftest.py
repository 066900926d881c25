"""Fixtures of the benchmark's own tests: a throwaway checkout root with
tiny cells added from files alone, and the card for the ``cuda`` tests
(decided inside a fixture, never at import)."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench.harness import spec

# name: (mode, width, height, bounces, the full-size cell it is like)
TINY = {
    "atrium5k.path64": ("path", 64, 36, 4, "atrium300k.path1080"),
    "atrium5k.flat64": ("flat", 64, 36, 1, "atrium300k.flat1080"),
    "atrium5k.path32": ("path", 32, 18, 4, "atrium3.5m.path360"),
}


@pytest.fixture(autouse=True)
def _environ():
    """A run clears RAYTPU_* and sets cache variables: keep them here."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def add_cell(root, name, config, traffic, limits_from):
    """Add cell ``name`` to the checkout at ``root`` by files and entries
    alone: ``configs/<cfg>.json``, ``traffic/<t>.json``,
    ``limits/<name>.json`` (a copy of ``limits_from``'s), the two
    BENCHMARK.json entries, and the cell's name in the ``workloads`` of
    every metric that lists ``limits_from``: the new cell reports what
    that cell reports."""
    cfg_name, t_name = name.split(".")
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", cfg_name + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", t_name + ".json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(pb, "limits", limits_from + ".json"),
                os.path.join(pb, "limits", name + ".json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    if cfg_name not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": cfg_name, "source": "https://example.org/throwaway",
            "file": f"portbench/configs/{cfg_name}.json", "reduced": [],
            "why": "a test's throwaway configuration"})
    bench["workloads"].append({"name": name, "config": cfg_name,
                               "traffic": t_name, "chips": 1,
                               "why": "a test's throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if limits_from in m.get("workloads", []):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the atrium at 5,000 triangles and three
    small cells (path and flat at 64x36 like the 1080p cells, path at 32x18
    like the streamed one), each held to the limit of its full-size
    counterpart and reporting its metrics."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (mode, w, h, bounces, like) in TINY.items():
        add_cell(str(root), name,
                 {"scene": "atrium", "scene_args": {"target_tris": 5000},
                  "pack": {"tables": "auto"}},
                 {"mode": mode, "width": w, "height": h, "samples": 1,
                  "bounces": bounces, "chunk": 8, "warmup_frames": 1,
                  "trace_frames": 2, "check_frames": 4, "check_pixels": 48},
                 like)
    return str(root)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see "
                    "portbench/README.md)")
    return "cuda"


def last_line(capsys) -> dict:
    """The result line of a run: the last line of standard output."""
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
