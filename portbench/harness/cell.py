"""One run of one cell: set-up, the window, the check, the result line.

    set-up   import, CUDA init, the configuration's scene, ``pack_scene``
             to tables resident on the card, warm-up frames of the cell's
             own request (the first run of a checkout builds the
             program's CUDA libraries here). The process allocates from
             glibc's heap alone and keeps what it frees
             (``device.heap_only_malloc``), and renders its frames on one
             intra-op thread;
    window   frames back to back, one client, each with its own seed,
             each done when its image is on the host; every frame records
             its sampled pixels. With ``--trace 1`` the first
             ``trace_frames`` frames run under torch.profiler. A cell with
             an end-to-end metric read from the device trace (``busy_ms``)
             has every frame of its ``--trace 0`` window profiled for
             device activity alone (``trace.BusyClock``); such a cell
             reports no host-clock time a frame, which the profiler
             would slow;
    check    once the window has closed, the device's peak memory read and
             the program's state freed: the plain reference renders the
             sampled pixels of frames drawn from the seed, and
             ``check.judge`` holds them to the cell's limits; in a traced
             run, where a metric asks for them, the reference then counts
             the traced frames' ray queries and their box and triangle
             tests (whole frames, through its own BVH).

The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..reference.tracer import count_queries
from ..reference.world import World
from . import check, device, peaks, sample, spec, trace, window


FRAME_THREADS = 1


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _traced_window(prof_path: str, mark: str) -> tuple:
    """(events, lo_us, hi_us) of a saved trace: its events and the span
    of the ``mark`` annotation around the traced frames."""
    with open(prof_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("name") == mark and e.get("ph") == "X"
             and str(e.get("cat", "")).lower() == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {mark!r} annotation")
    return events, min(a for a, _ in spans), max(b for _, b in spans)


def _counter(arrays, dev, seeds, traffic, card_name):
    """A function that counts, once and when first called, the ray queries
    and the box and triangle tests of the frames of ``seeds``: (queries,
    box tests, triangle tests), by the reference through its own BVH."""
    memo = []

    def counts():
        if not memo:
            t = time.perf_counter()
            world = World(arrays, dev, tree=True)
            queries = count_queries(
                world, seeds, **{k: traffic[k] for k in (
                    "width", "height", "chunk", "samples", "bounces",
                    "mode")})
            box, tri = world.tree.box_tests, int(world.tree.tri_tests)
            del world
            _log(f"[portbench] the traced frames: {queries} ray queries, "
                 f"{box} box and {tri} triangle tests, counted by the "
                 f"reference in {time.perf_counter() - t:.2f} s; least walk "
                 f"time by bytes "
                 f"{peaks.bytes_bound_s(peaks.query_bytes(queries), card_name)}"
                 f" s, by operations "
                 f"{peaks.ops_bound_s(peaks.walk_ops(box, tri), card_name)} s")
            memo.append((queries, box, tri))
        return memo[0]

    return counts


def set_up(s: spec.Spec, cfg: dict, traffic: dict, dev: str, seed: int):
    """(scene arrays, pack, camera, pack seconds): the configuration's
    scene, packed on ``dev`` with its pack settings, and the warm-up frames
    of the traffic's own request, on ``FRAME_THREADS`` intra-op threads
    from there on."""
    import torch

    from . import port

    t = time.perf_counter()
    arrays = s.scene(cfg)
    _log(f"[portbench] scene {time.perf_counter() - t:.2f} s")
    pack, cam, pack_s = port.pack(arrays, dev, cfg.get("pack", {}))
    _log(f"[portbench] pack {pack_s:.2f} s")
    # frames on one intra-op thread: no pool of threads spinning beside
    # the one that drives the card (the pack keeps the default)
    torch.set_num_threads(FRAME_THREADS)
    for k in range(traffic.get("warmup_frames", 2)):
        t = time.perf_counter()
        port.render(pack, cam, port.config(traffic,
                                           sample.warmup_seed(seed, k)))
        _log(f"[portbench] warm-up frame {k}: "
             f"{time.perf_counter() - t:.3f} s")
    return arrays, pack, cam, pack_s


def run(argv=None, root: str = spec.ROOT, dev: str | None = None) -> int:
    """Run a cell; ``dev`` None means the card, which must be there (a
    test passes "cpu" to drive the rest of a run without one)."""
    t_start = device.process_start()
    args = parse(argv)
    dropped = device.clean_env(root)
    if dropped:
        _log(f"[portbench] cleared {', '.join(dropped)}")
    _log(f"[portbench] heap-only malloc: {device.heap_only_malloc()}")
    import torch

    s = spec.Spec(root)
    cell = s.workload(args.workload)
    if dev is None:
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < cell["chips"]):
            _log(f"[portbench] {args.workload} needs {cell['chips']} CUDA "
                 f"device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = "cuda"
    cuda = dev == "cuda"
    from . import port

    cfg = s.config(cell["config"])
    traffic = s.traffic(cell["traffic"])
    limits = s.limits(args.workload)

    # --- set-up ---------------------------------------------------------
    arrays, pack, cam, pack_s = set_up(s, cfg, traffic, dev, args.seed)
    setup_s = time.time() - t_start
    e2e = s.end_to_end(args.workload)
    clock = None
    if cuda and not args.trace and any(m["source"] == "device_trace"
                                       for m in e2e):
        clock = trace.BusyClock()
        clock.start()  # the profiler's first start loads its library
        clock.stop()
        clock = trace.BusyClock()

    # --- window ---------------------------------------------------------
    w, h = traffic["width"], traffic["height"]
    n_px = traffic["check_pixels"]
    n_trace = traffic.get("trace_frames", 3) if args.trace else 0
    mark = "portbench.traced_frames"
    prof = rec = None
    if n_trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if clock:
        clock.start()
    if cuda:
        torch.cuda.synchronize()
    frame_s, recorded = [], []
    t0 = time.perf_counter()
    while True:
        i = len(frame_s)
        xs, ys = sample.pixels(args.seed, i, w, h, n_px)
        if i == 0 and n_trace:
            rec = record_function(mark)
            rec.__enter__()
        a = time.perf_counter()
        img = port.render(pack, cam,
                          port.config(traffic, sample.frame_seed(args.seed, i)))
        b = time.perf_counter()
        frame_s.append(b - a)
        recorded.append(img[ys, xs].copy())
        if n_trace and i + 1 == n_trace:
            rec.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        if b - t0 >= args.seconds and len(frame_s) >= n_trace:
            break
        if clock:
            clock.frame_done()
    window_s = time.perf_counter() - t0
    if clock:
        clock.stop()
        _log(f"[portbench] device busy {clock.busy_s:.6f} s over "
             f"{len(frame_s)} frames: {clock.events} device events in "
             f"{clock.pieces} pieces")
    n = len(frame_s)
    q = np.percentile(frame_s, [0, 25, 50, 75, 100]) * 1e3
    _log(f"[portbench] window {window_s:.3f} s, {n} frames; frame ms "
         f"min/q1/median/q3/max {' / '.join(f'{x:.2f}' for x in q)}; "
         f"first 10 {np.mean(frame_s[:10]) * 1e3:.2f}, last 10 "
         f"{np.mean(frame_s[-10:]) * 1e3:.2f}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # --- the program's state freed, then the check -----------------------
    del pack, cam, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    frames = sample.checked_frames(args.seed, n, traffic["check_frames"])
    ref = check.reference(arrays, dev, args.seed, frames, traffic)
    got = np.concatenate([recorded[int(i)] for i in frames])
    numbers = {"diverged_pct": check.diverged_pct(got, ref)}
    correct, checks = check.judge(numbers, limits)
    _log(f"[portbench] reference {time.perf_counter() - t:.2f} s over "
         f"{got.shape[0]} pixels of {frames.shape[0]} frames")

    # --- metrics ----------------------------------------------------------
    card = device.card() if cuda else {"name": "cpu", "power_limit_w": None}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": card["name"],
                "count": cell["chips"] if cuda else 0,
                "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": n, "failed": 0,
           "metrics": {}, "device": dev_info}
    if not args.trace:
        values = {"frame_ms": window.frame_ms(window_s, n),
                  "setup_s": setup_s,
                  "busy_ms": clock.busy_s * 1e3 / n if clock else None}
        for m in e2e:
            if values[m["name"]] is not None:
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    else:
        report = None
        if cuda:
            fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                events, lo, hi = _traced_window(path, mark)
            finally:
                os.remove(path)
            report = trace.reduce(events, lo, hi)
            report["window_s"] = (hi - lo) / 1e6
            dev_info.update(busy_s=report["busy_s"],
                            window_s=report["window_s"])
            out["breakdown"] = {"device_ops": trace.top(report["ops"]),
                                "idle_gaps": trace.top(report["gaps"])}
        counts = _counter(arrays, dev, [sample.frame_seed(args.seed, i)
                                        for i in range(n_trace)],
                          traffic, card["name"])
        ctx = dict(workload=args.workload, config=cfg, traffic=traffic,
                   frames_traced=n_trace, frame_s=frame_s, trace=report,
                   pack_s=pack_s, card=card, counts=counts)
        for m in s.per_layer(args.workload):
            value = s.reader(m["name"])(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
    out["card"] = card
    out["checks"] = checks

    found = device.banned_modules()
    if found:
        _log(f"[portbench] loaded in this process: {', '.join(found)}")
        return 3
    for name, c in checks.items():
        _log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0
