"""Op-level breakdown of one warm atrium frame on the card: the port's
counterpart of raytpu's ``benchmarks/frame_profile.py``.

``capture`` renders the frame three times through ``render_frame``: a
warm-up frame, a timed frame, and a frame under ``torch.profiler`` (CPU
and CUDA activity), whose Chrome trace it saves as
``<outdir>/frame.pt.trace.json``. ``parse`` reads such a trace and puts
each device event (kernel, memcpy, memset) into exactly one group, by the
kernel's name and the ``aten::`` ops that launched it (the CPU ops open on
the launching thread when the runtime call was made, outermost first):

* ``strand kernel``: ``strand::walk_kernel``, ``sched_kernel``,
  ``block_kernel``, ``defer_kernel`` (strand_walk.cu, strand_block.cu);
* ``packet kernel``: ``packet_kernel``, ``packet_option_kernel``;
* ``binned kernel``: ``binned_kernel``;
* ``sort``: launched under ``aten::sort`` or ``aten::argsort``, or a
  radix-sort kernel;
* ``gather``: under ``aten::index``, ``index_select``, ``gather``,
  ``take``;
* ``scatter``: under ``aten::index_put_`` (and its ``_index_put_impl_``),
  ``scatter_``, ``scatter``, ``scatter_add_``;
* ``memcpy``: memcpy and memset events (HtoD, DtoH, DtoD) and kernels
  launched under ``aten::copy_``;
* ``elementwise``: the rest of the kernels whose name says elementwise;
* ``other``: everything else (reductions, scans, the probe's kernels).

The report: the device total (the events' durations summed; the groups
sum to it), the frame's wall ms, device-busy ms (the union of the device
intervals) and busy share, a table of groups (ms, %, events) and the top
``--top`` device ops (the outermost launching ``aten::`` op, or the
kernel's name where no op launched it). raytpu subtracts nothing here and
neither does the port. A trace without device events is an error (a CPU
run has none): ``parse`` raises and the command exits non-zero; it never
prints a table of zeros.

    python -m raytpu_torch.tools.frame_profile [--tris 250000]
        [--width 1920] [--height 1080] [--top 40] [--scene atrium|multi]
    python -m raytpu_torch.tools.frame_profile --parse-only [--outdir DIR]

``chip_smoke.py:profile_frame`` calls ``profile`` and ``summary_line``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import torch

from . import scenes

GROUPS = ("strand kernel", "packet kernel", "binned kernel", "sort",
          "gather", "scatter", "memcpy", "elementwise", "other")
# the port's kernels, by name (demangled, or mangled where the trace keeps
# the mangled name)
KERNEL_GROUPS = (
    (re.compile(r"strand::(walk|sched|block|defer)_kernel"
                r"|6strand\d+(walk|sched|block|defer)_kernel"),
     "strand kernel"),
    (re.compile(r"packet(_option)?_kernel"), "packet kernel"),
    (re.compile(r"binned_kernel"), "binned kernel"),
)
OP_GROUPS = {
    "aten::sort": "sort", "aten::argsort": "sort",
    "aten::index": "gather", "aten::index_select": "gather",
    "aten::gather": "gather", "aten::take": "gather",
    "aten::index_put_": "scatter", "aten::_index_put_impl_": "scatter",
    "aten::index_put": "scatter", "aten::scatter_": "scatter",
    "aten::scatter": "scatter", "aten::scatter_add_": "scatter",
    "aten::copy_": "memcpy",
}
SORT_KERNEL = re.compile(r"radix|RadixSort|SegmentedSort|sortKeyValue|"
                         r"bitonicSort", re.IGNORECASE)
# Chrome-trace categories, lower-cased (torch 2.x names, then older ones)
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset", "memcpy": "memcpy",
               "memset": "memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime"}
OP_CATS = {"cpu_op", "operator"}
TRACE_NAME = "frame.pt.trace.json"


class NoDeviceEvents(RuntimeError):
    """The trace holds no device event."""


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _launching_ops(events: list) -> dict:
    """{correlation id: [names of the CPU ops open on the launching thread
    at the runtime call, outermost first]}."""
    ops, calls = {}, {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        if cat in OP_CATS:
            ops.setdefault(key, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("name", "")))
        elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
            calls.setdefault(key, []).append(
                (float(e["ts"]), e["args"]["correlation"]))
    out = {}
    for key, launches in calls.items():
        # ops nest on one thread: swept in order of start (outer first on
        # ties), a stack holds the ops open at each launch
        spans = sorted(ops.get(key, []), key=lambda s: (s[0], -s[1]))
        stack, i = [], 0
        for ts, corr in sorted(launches):
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = [name for _, _, name in stack]
    return out


def classify(name: str, kind: str, stack: list) -> str:
    """The group of one device event: ``name`` the kernel's (or memcpy's)
    name, ``kind`` kernel / memcpy / memset, ``stack`` the launching CPU
    ops, outermost first."""
    for pattern, group in KERNEL_GROUPS:
        if pattern.search(name):
            return group
    if kind in ("memcpy", "memset"):
        return "memcpy"
    for op in stack:
        if op in OP_GROUPS:
            return OP_GROUPS[op]
    if SORT_KERNEL.search(name):
        return "sort"
    if "elementwise" in name.lower():
        return "elementwise"
    return "other"


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return (base.split(" ")[-1] if "::" in base else base) or name[:60]


def parse_events(events: list) -> dict:
    """The report of a Chrome trace's events: dict(total_ms, busy_ms,
    span_ms, n_events, groups {group: [ms, events]} in GROUPS' order,
    ops {(op, group): [ms, events]})."""
    stacks = _launching_ops(events)
    groups = {g: [0.0, 0] for g in GROUPS}
    ops, spans = {}, []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        kind = DEVICE_CATS.get(str(e.get("cat", "")).lower())
        if kind is None:
            continue
        name = e.get("name", "")
        stack = [op for op in stacks.get(
            e.get("args", {}).get("correlation"), []) if op.startswith(
                "aten::")]
        group = classify(name, kind, stack)
        ms = dur / 1e3
        groups[group][0] += ms
        groups[group][1] += 1
        op = stack[0] if stack else _short(name)
        row = ops.setdefault((op, group), [0.0, 0])
        row[0] += ms
        row[1] += 1
        spans.append((ts, ts + dur))
    if not spans:
        raise NoDeviceEvents("the trace holds no device events (no kernel, "
                             "memcpy or memset): nothing ran on a card")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(total_ms=sum(v[0] for v in groups.values()),
                busy_ms=busy / 1e3, span_ms=(hi - lo) / 1e3,
                n_events=len(spans), groups=groups, ops=ops)


def parse(path: str) -> dict:
    """``parse_events`` of a saved trace: ``path`` a trace file, or a
    directory holding ``frame.pt.trace.json`` (or the newest
    ``*.pt.trace.json``)."""
    if os.path.isdir(path):
        names = [f for f in os.listdir(path) if f.endswith(".pt.trace.json")]
        if not names:
            raise FileNotFoundError(f"no *.pt.trace.json under {path}")
        name = TRACE_NAME if TRACE_NAME in names else max(
            names, key=lambda f: os.path.getmtime(os.path.join(path, f)))
        path = os.path.join(path, name)
    with open(path) as f:
        return parse_events(json.load(f)["traceEvents"])


def profile(render, outdir: str | None = None) -> dict:
    """One call of ``render`` under torch.profiler (CPU and, on a card,
    CUDA activity), ending in a synchronise: its Chrome trace saved as
    ``<outdir>/frame.pt.trace.json`` (a temporary directory when
    ``outdir`` is None) and parsed; the report has ``wall_ms`` too.
    Raises NoDeviceEvents when nothing ran on a card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        render()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        out = tmp if outdir is None else outdir
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, TRACE_NAME)
        prof.export_chrome_trace(path)
        rep = parse(path)
    rep.update(wall_ms=wall, trace=None if outdir is None else path)
    return rep


def summary_line(rep: dict, top: int = 6) -> str:
    """One line: wall ms, device busy ms and share, device events, every
    non-empty group's ms and events, and the ``top`` ops' ms."""
    wall = rep.get("wall_ms", rep["span_ms"])
    groups = ", ".join(f"{g} {ms:.2f} ({n})"
                       for g, (ms, n) in rep["groups"].items() if n)
    ops = sorted(rep["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    top_ops = ", ".join(f"{op.removeprefix('aten::')} ({g}) {v[0]:.2f}"
                        for (op, g), v in ops)
    return (f"wall {wall:.1f} ms, device busy {rep['busy_ms']:.2f} ms "
            f"({rep['busy_ms'] / wall:.1%}), {rep['n_events']} device "
            f"events, device total {rep['total_ms']:.2f} ms; groups (ms, "
            f"events): {groups}; most device ms: {top_ops}")


def print_report(rep: dict, top: int) -> None:
    """raytpu's report: the device total, the table of groups and the top
    ``top`` ops; then the wall, busy and span figures."""
    total = rep["total_ms"]
    print(f"device total: {total:.2f} ms")
    print("\n| group | ms | % | events |")
    print("|---|---|---|---|")
    for g, (ms, n) in sorted(rep["groups"].items(), key=lambda kv: -kv[1][0]):
        if n:
            print(f"| {g} | {ms:8.3f} | {100 * ms / total:4.1f} | {n} |")
    print(f"\ntop {top} ops:")
    print("| op | group | events | ms |")
    print("|---|---|---|---|")
    for (name, g), (ms, n) in sorted(rep["ops"].items(),
                                     key=lambda kv: -kv[1][0])[:top]:
        print(f"| {name[:90]} | {g} | {n} | {ms:8.3f} |")
    wall = rep.get("wall_ms")
    print(f"\nwall {'not measured' if wall is None else f'{wall:.1f} ms'}, "
          f"trace span {rep['span_ms']:.1f} ms, device busy "
          f"{rep['busy_ms']:.2f} ms ({rep['busy_ms'] / (wall or rep['span_ms']):.1%}"
          f" of the {'wall' if wall else 'span'}), {rep['n_events']} device "
          "events", flush=True)


def frame_setup(scene_name: str, tris: int, width: int, height: int,
                bounces: int, samples: int, device: str):
    """(pack, camera, config) of raytpu's two profiled scenes: the atrium
    (``cached_atrium``, chunk 8) or BENCH config 3 exactly
    (``build_multi_mesh_glb``: 256x256, 2 spp, 3 bounces, chunk 32)."""
    from ..scene.gltf import load_scene
    from ..scene.pack import pack_camera, pack_scene
    from ..types import RenderConfig

    if scene_name == "atrium":
        scene, pack = scenes.cached_atrium(tris, device)
        cfg = RenderConfig(width=width, height=height, seed=1,
                           samples=samples, bounces=bounces, chunk_size=8)
    elif scene_name == "multi":
        scene = load_scene(scenes.cached_glb("multi_mesh.glb"))
        pack = pack_scene(scene, device)
        cfg = RenderConfig(width=256, height=256, seed=1, samples=2,
                           bounces=3, chunk_size=32, bruteforce_max_tris=64)
    else:
        raise SystemExit(f"unknown scene {scene_name}")
    return pack, pack_camera(scene.camera, device), cfg


def capture(pack, cam, cfg, outdir: str) -> dict:
    """A warm-up frame, a timed frame, then ``profile`` of a third frame
    with its trace under ``outdir``; returns the report."""
    from ..engine.render import render_frame

    def frame():
        render_frame(pack, cam, cfg)
        if pack.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    frame()
    _log(f"[profile] warmup {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    frame()
    _log(f"[profile] steady frame {(time.perf_counter() - t0) * 1e3:.1f} ms "
         "(host clock, ending in a synchronise)")
    return profile(frame, outdir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="frame_profile", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--outdir", default=os.path.join(scenes.CACHE,
                                                     "frame_trace"))
    ap.add_argument("--scene", default="atrium", choices=["atrium", "multi"])
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        if args.parse_only:
            rep = parse(args.outdir)
        else:
            if args.device == "cuda" and not torch.cuda.is_available():
                raise SystemExit("no CUDA device: a profile of the CPU has "
                                 "no device events")
            rep = capture(*frame_setup(args.scene, args.tris, args.width,
                                       args.height, args.bounces,
                                       args.samples, args.device),
                          args.outdir)
    except NoDeviceEvents as e:
        raise SystemExit(f"frame_profile: {e}") from None
    print_report(rep, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
