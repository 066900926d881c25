"""The result line's shape, the numbers compared printed last, and the
runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

from portbench.harness import cell, device, spec

from .conftest import last_line


def test_result_line_trace0(tiny_root, capsys):
    rc = cell.run(["--workload", "atrium5k.flat64", "--seed",
                   str(2 ** 31 + 99), "--seconds", "0.5", "--trace", "0"],
                  root=tiny_root, dev="cpu")
    assert rc == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frame_ms", "setup_s"}
    units = {m: v["unit"] for m, v in line["metrics"].items()}
    assert units == {"frame_ms": "ms", "setup_s": "s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    c = line["checks"]["diverged_pct"]
    assert set(c) == {"value", "limit"}
    assert out.err.strip().splitlines()[-1] == (
        f"check diverged_pct = {c['value']} (limit {c['limit']})")


def test_result_line_trace1_has_per_layer_metrics_only(tiny_root, capsys):
    rc = cell.run(["--workload", "atrium5k.path64", "--seed", "17",
                   "--seconds", "0.5", "--trace", "1"], root=tiny_root,
                  dev="cpu")
    assert rc == 0
    line = last_line(capsys)
    # the CPU has no device trace: only the host clock's metrics are read
    assert set(line["metrics"]) == {"scene.pack_s", "entry.frame_ms_p95"}
    assert line["metrics"]["scene.pack_s"]["unit"] == "s"
    assert line["metrics"]["entry.frame_ms_p95"]["unit"] == "ms"
    assert line["metrics"]["entry.frame_ms_p95"]["value"] > 0


def test_busy_cell_reports_no_device_number_from_the_cpu(tiny_root, capsys):
    # busy_ms comes from the card's trace alone: a CPU run leaves it out
    # and reports no host-clock frame time in its place
    assert cell.run(["--workload", "atrium5k.path32", "--seed",
                     str(2 ** 32 + 3), "--seconds", "0.3", "--trace", "0"],
                    root=tiny_root, dev="cpu") == 0
    line = last_line(capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s"}
    assert cell.run(["--workload", "atrium5k.path32", "--seed", "4",
                     "--seconds", "0.3", "--trace", "1"], root=tiny_root,
                    dev="cpu") == 0
    line = last_line(capsys)
    assert set(line["metrics"]) == {"scene.pack_s", "entry.frame_ms"}
    assert line["metrics"]["entry.frame_ms"]["value"] > 0


def test_no_card_no_result(tiny_root, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cell.run(["--workload", "atrium5k.path64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], root=tiny_root)
    assert rc != 0
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "CUDA" in out.err


def test_benchmark_files_alone_print_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ fails."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "atrium300k.path1080", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_banned_module_stops_the_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    rc = cell.run(["--workload", "atrium5k.flat64", "--seed", "5",
                   "--seconds", "0.2", "--trace", "0"], root=tiny_root,
                  dev="cpu")
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax.numpy" in out.err


def test_heap_only_malloc_takes():
    # glibc takes both settings: no allocation mapped on its own, and the
    # heap trimmed only past 1 GiB free at its top
    assert device.heap_only_malloc() is True
