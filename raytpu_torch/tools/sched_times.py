"""Time the strand walks' schedule and deferral forms, or walk_kernel's
option forms, on the 1080p gallery's waves, in one checkout of the repo
or in several, in turns.

    python -m raytpu_torch.tools.sched_times              # this checkout
    python raytpu_torch/tools/sched_times.py --roots A B --order ABBA
    python raytpu_torch/tools/sched_times.py --forms options --roots A B

A root is the top of a checkout (the directory that holds ``chip_smoke.py``,
``raytpu_torch/`` and ``tests/tools/``). The waves are captured once, by
the first root named (or this checkout), into ``--waves`` (a directory; a
temporary one by default): chip_smoke.py's gallery (360 x 360 floor
cells, 259,238 triangles) packed on the card, the 1920x1080 frame's
primary wave (2,088,960 rays), bounce 1's wave (the largest closest-hit
wave after the primary one of the frame on the block route,
``RAYTPU_STRAND_PERSISTENT=0``) and the largest mixed query of the frame
with ``bounce_backend="mixed"`` (4,177,920 lanes), with the tables; the
small wave is the primary wave's first 245,760 rays (as many as phase
7a's 640x360 primary wave). Each root then runs in a process of its own,
since two checkouts' packages cannot share one: it builds its strand
kernels, loads the waves and times, with CUDA events after a warm-up,
``--reps`` launches of each call in turns (a b ... b a): on the primary,
small and bounce 1's waves, the per-ray walk's default instance and each
schedule form (``FORMS``: raytpu's keywords); on the mixed query, the
mixed default and forms; on bounce 1's, the block walk and its deferral
form (G 16, skip_done). Every form is first held to its default instance
on t bits and the tie key (closest lanes) and the blocked bit; a
difference exits 1. Each process prints one JSON line with the card's
name and power limit; with ``--roots`` the command then prints each
root's mean per call. Only each checkout's public calls are used
(``strand_query_cuda``, ``strand_mixed_query_cuda``,
``strand_block_query_cuda``), so any two checkouts of the port compare.
The small wave's launches are short enough that CUDA events around them
measure the host as much as the card.

``--forms options`` times walk_kernel's option forms instead (``OPTIONS``:
the stats counters on the strand rows, and the ribbon rows one record a
step and with the K-wide fetch at K 4 and 8, each with and without
stats) beside the default instance, in turns, on the primary wave and the
mixed query only (each form held to the default instance as above; the
counters are left to chip_smoke.py's phases 3g and 11a), and each process
reports every walk_kernel instance's registers, spills and static shared
memory from ptxas's report (``kernels/_build.py:kernel_resources``, where
the checkout has it). Needs a GPU; refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# raytpu's factory defaults (kernels/strand.py:507-546 at >= 4096
# triangles) and one set per fetch form, as chip_smoke.py's phase 12
RAYTPU_SCHED = dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                    unroll=4)
FORMS = {
    "load": dict(walkers=128, service_k=16, flush_occ=0.5),
    "pipe": RAYTPU_SCHED,
    "pipe service_k 1": dict(RAYTPU_SCHED, service_k=1),
    "dual": dict(RAYTPU_SCHED, dual=True),
    "smem": dict(RAYTPU_SCHED, fetch_smem=True),
    "wide K 4": dict(walkers=128, service_k=16, flush_occ=0.5, ribbon_k=4),
    "wide K 8": dict(walkers=128, service_k=16, flush_occ=0.5, ribbon_k=8),
}
# walk_kernel's option forms (--forms options)
OPTIONS = {
    "strand stats": dict(stats=True),
    **{f"ribbon K {k}{' stats' if st else ''}": dict(ribbon_k=k, stats=st)
       for k in (1, 4, 8) for st in (False, True)},
}
DEFER = dict(defer=True, groups=16, skip_done=True)
WAVES = "waves.pt"
# the small wave: the primary wave's first rays, as many as chip_smoke.py's
# phase 7a frame's primary wave (640x360 x 1 spp)
SMALL_RAYS = 245760


def _capture(root: str, out: str) -> None:
    """The tables and the waves, from ``root``'s package, saved to
    ``out``/WAVES."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as c
    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    w, h = c.MAIN_ARGS["width"], c.MAIN_ARGS["height"]
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "gallery.glb")
        c.write_gallery(glb, cells=360)
        pack = pack_scene(load_scene(glb), "cuda")
    g = c.GALLERY_CAM
    cam = pack_camera(camera_from_lookat(g["origin"], g["at"], g["fov"], w, h),
                      "cuda")
    ro, rd = c.primary_wave(cam, w, h, c.MAIN_ARGS["chunk_size"], 1)
    with c.env(RAYTPU_STRAND_PERSISTENT="0"), \
            c.recorded_queries("strand_block_query") as calls:
        render_frame(pack, cam, RenderConfig(**c.MAIN_ARGS))
    big = max((i for i in range(1, len(calls)) if not calls[i][7]),
              key=lambda i: calls[i][3].shape[0])
    _, _, _, bro, brd, btmax, btmin, _ = calls[big][:8]
    with c.recorded_mixed("make_strand_mixed_query") as mixed:
        render_frame(pack, cam, RenderConfig(**c.MAIN_ARGS,
                                             intersector="packet",
                                             bounce_backend="mixed"))
    mro, mrd, mtmax, msmask, mtmin, mshadow = max(
        mixed, key=lambda q: q[0].shape[0])[:6]
    bvh = pack.bvh
    torch.save(dict(
        rows=bvh.strand_rows, ribbon=bvh.ribbon_rows, leaf=bvh.leaf_tris,
        first=bvh.first_slots,
        primary=(ro, rd, torch.full((ro.shape[0],), c.F32_MAX,
                                    device="cuda"), 0.001),
        bounce=(bro, brd, btmax, float(btmin)),
        mixed=(mro, mrd, mtmax, msmask, float(mtmin), float(mshadow))),
        os.path.join(out, WAVES))


def _time_root(root: str, waves: str, reps: int, forms: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import time

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sched_times needs a CUDA device")
    import chip_smoke as c
    from raytpu_torch.kernels import _build
    from raytpu_torch.kernels.strand import (
        strand_block_query_cuda,
        strand_mixed_query_cuda,
        strand_query_cuda,
    )

    t0 = time.perf_counter()
    for name in ("strand_walk", "strand_block"):
        _build.load_library(name)
    build_s = time.perf_counter() - t0
    d = torch.load(os.path.join(waves, WAVES))
    rows, ribbon, leaf, first = d["rows"], d["ribbon"], d["leaf"], d["first"]
    rpo = ribbon.shape[0] // 8

    def tree(kw):
        if "ribbon_k" in kw:
            return ribbon, dict(kw, rpo=rpo)
        return rows, kw

    ro, rd, tmax, tmin = d["primary"]
    n = SMALL_RAYS
    d["small"] = (ro[:n].contiguous(), rd[:n].contiguous(),
                  tmax[:n].contiguous(), tmin)
    table = OPTIONS if forms == "options" else FORMS
    labels = ("primary",) if forms == "options" else ("primary", "small",
                                                      "bounce")
    sets = {}
    for label in labels:
        ro, rd, tmax, tmin = d[label]
        wave = (leaf, first, ro, rd, tmax, tmin, False)
        calls = {"default": lambda wave=wave: strand_query_cuda(rows, *wave)}
        for name, kw in table.items():
            t, k = tree(kw)
            calls[name] = (lambda t=t, k=k, wave=wave:
                           strand_query_cuda(t, *wave, **k))
        if label == "bounce":
            calls["block"] = lambda wave=wave: strand_block_query_cuda(
                rows, *wave)
            calls["defer G 16 skip_done"] = (
                lambda wave=wave: strand_block_query_cuda(rows, *wave,
                                                          **DEFER))
        sets[label] = (calls, None)
    ro, rd, tmax, smask, tmin, shadow = d["mixed"]
    wave = (leaf, first, ro, rd, tmax, smask, tmin, shadow)
    calls = {"default": lambda: strand_mixed_query_cuda(rows, *wave)}
    for name, kw in table.items():
        t, k = tree(kw)
        calls[name] = (lambda t=t, k=k: strand_mixed_query_cuda(t, *wave,
                                                                **k))
    sets["mixed"] = (calls, smask)
    out = {}
    for label, (calls, sm) in sets.items():
        base = calls["default"]()
        for name, fn in calls.items():
            bad = c.agree("mixed" if sm is not None else "closest", fn(),
                          base, first, sm)
            if bad:
                raise SystemExit(f"sched_times {root} {label} {name}: {bad} "
                                 "lanes differ from the default instance")
        out[label] = c.in_turns(calls, reps=reps)
    # walk_kernel's instances by name, in checkouts that report them
    res = getattr(_build, "kernel_resources", None)
    name = getattr(c, "instance_name", lambda k: k)
    regs = {name(k): v for k, v in res("strand_walk").items()
            if "walk_kernel" in k} if res and forms == "options" else {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return dict(root=root, card=smi, build_s=round(build_s, 2), reps=reps,
                rays={k: int(d[k][0].shape[0]) for k in sets}, ms=out,
                resources=regs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="time this checkout in this process")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="checkouts to time, each in its own process")
    ap.add_argument("--order", default=None,
                    help="the roots' turns as letters (A = the first root); "
                         "default each once")
    ap.add_argument("--waves", default=None,
                    help="directory of the captured waves (captured there "
                         "when missing)")
    ap.add_argument("--capture", action="store_true",
                    help="only capture the waves (with --root's package)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", choices=("schedule", "options"),
                    default="schedule",
                    help="the schedule and deferral forms (default) or "
                         "walk_kernel's option forms")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if args.capture:
        _capture(args.root or here, args.waves)
        return 0
    if args.waves is not None:
        return _run(args, args.waves, here)
    with tempfile.TemporaryDirectory(prefix="sched_times_") as waves:
        return _run(args, waves, here)


def _run(args, waves: str, here: str) -> int:
    """Capture the waves into ``waves`` if missing, then time the roots."""
    roots = args.roots or [args.root or here]
    if not os.path.exists(os.path.join(waves, WAVES)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--capture", "--root", roots[0], "--waves",
                               waves])
        if proc.returncode != 0:
            return proc.returncode
    if args.roots is None:
        print(json.dumps(_time_root(roots[0], waves, args.reps,
                                    args.forms)), flush=True)
        return 0
    order = args.order or "".join(chr(65 + i) for i in range(len(roots)))
    rows = []
    for letter in order:
        root = roots[ord(letter) - 65]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--waves", waves, "--reps", str(args.reps), "--forms",
             args.forms],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for root in roots:
        mine = [r for r in rows if r["root"] == root]
        for label, calls in mine[0]["ms"].items():
            mean = {k: sum(r["ms"][label][k] for r in mine) / len(mine)
                    for k in calls}
            print(f"{root} {label} ({mine[0]['rays'][label]} rays): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in mean.items())
                  + f" ms ({len(mine)} processes; {mine[0]['card']})")
        if mine[0].get("resources"):
            print(f"{root} walk_kernel registers / spill stores / smem: "
                  + ", ".join(f"{k} {v['registers']}/{v['spill_stores']}/"
                              f"{v['smem']}" for k, v in
                              sorted(mine[0]["resources"].items())))
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
