"""Readings that set a cell's limits: sound runs, the control, the faults.

    python3 portbench/calibrate.py --workload <name> --seeds S1 S2 ...
        [--control-seeds C1 C2 C3] [--device cuda|cpu]

from the root of a checkout, on the card at the cell's own size. The
benchmark's runs never run this. In one process it packs the cell's
scene once and warms up as a run does (``cell.set_up``), and for each
seed renders the frames a run's check would judge (``check_frames`` of
them, with the run's frame seeds and pixel places), recording each frame's sampled pixels; then, the
program's state freed, the reference renders those pixels and each
compared number is read:

* ``program``: the program's pixels, one reading a seed (the lower
  reading is the largest of a dozen seeds or more);
* ``control``: the reference computed in bfloat16, the precision below
  the configuration's float32, put in the program's place (the upper
  reading is the smallest over the control seeds);
* the faults a cell can have, planted in the program's recorded output:
  ``stale`` (each frame returns the frame before it: a state left
  unchanged), ``half`` (the bottom half of each frame left out, black),
  ``altered`` (every pixel's colour off by one part in ten thousand, as
  a lower-precision shading step would leave it).

Prints one JSON line a seed and a summary line (the largest program
reading, the smallest control reading), and writes them to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from portbench.harness import cell, check, device, sample, spec  # noqa: E402


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, root: str = spec.ROOT) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device.clean_env(root)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        _log("calibrate: no CUDA device")
        return 2
    from portbench.harness import port

    s = spec.Spec(root)
    wl = s.workload(args.workload)
    cfg, t = s.config(wl["config"]), s.traffic(wl["traffic"])
    w, h, n_px, n_fr = t["width"], t["height"], t["check_pixels"], t[
        "check_frames"]
    arrays, pack, cam, _ = cell.set_up(s, cfg, t, args.device, 0)

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    rec = {}
    for sd in seeds:
        got, stale, prev = [], [], None
        t0 = time.perf_counter()
        for i in range(n_fr):
            xs, ys = sample.pixels(sd, i, w, h, n_px)
            img = port.render(pack, cam, port.config(
                t, sample.frame_seed(sd, i)))
            got.append(img[ys, xs].copy())
            stale.append((prev if prev is not None else np.zeros_like(img))[
                ys, xs].copy())
            prev = img
        rec[sd] = (np.concatenate(got), np.concatenate(stale),
                   time.perf_counter() - t0)
    del pack, cam, img, prev
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()

    frames = np.arange(n_fr)
    lines = []
    for sd in seeds:
        t0 = time.perf_counter()
        ref = check.reference(arrays, args.device, sd, frames, t)
        ref_s = time.perf_counter() - t0
        got, stale, frames_s = rec[sd]
        _, py, _ = sample.lanes(sd, frames, w, h, n_px)
        half = np.where((py >= h // 2)[:, None], 0.0, got).astype(np.float32)
        altered = got * np.float32(1.0001)
        row = {"seed": sd, "frames_s": frames_s, "reference_s": ref_s,
               "pixels": int(got.shape[0]),
               "program": check.diverged_pct(got, ref),
               "stale": check.diverged_pct(stale, ref),
               "half": check.diverged_pct(half, ref),
               "altered": check.diverged_pct(altered, ref)}
        if sd in args.control_seeds:
            t0 = time.perf_counter()
            row["control"] = check.diverged_pct(check.reference(
                arrays, args.device, sd, frames, t, torch.bfloat16), ref)
            row["control_s"] = time.perf_counter() - t0
        lines.append(row)
        print(json.dumps(row), flush=True)
    summary = {
        "workload": args.workload,
        "card": device.card() if args.device == "cuda" else "cpu",
        "program_max": max(r["program"] for r in lines
                           if r["seed"] in args.seeds),
        "program_seeds": len(args.seeds),
        "control_min": min((r["control"] for r in lines if "control" in r),
                           default=None),
        "faults_min": {k: min(r[k] for r in lines)
                       for k in ("stale", "half", "altered")},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in lines + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
