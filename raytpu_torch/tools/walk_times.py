"""Time the strand walk and the packet walk on the 1080p gallery's primary
wave, in one checkout of the repo or in several, in turns.

    python -m raytpu_torch.tools.walk_times              # this checkout
    python raytpu_torch/tools/walk_times.py --roots A B --order ABBA

A root is the top of a checkout (the directory that holds ``chip_smoke.py``
and ``raytpu_torch/``). Each root runs in a process of its own, since two
checkouts' packages cannot share one: it builds its strand and packet
kernels, packs chip_smoke.py's gallery (360 x 360 floor cells, 259,238
triangles), casts the 1920x1080 frame's primary wave (2,088,960 rays) and
times, with CUDA events after a warm-up, ``--reps`` launches of each of
strand_walk (closest-hit, strand rows) and packet_walk (closest-hit,
storage order), in turns (strand, packet, packet, strand), printing one
JSON line with the card's name and power limit. With ``--roots`` the
command runs the roots' processes in the order ``--order`` gives (letters
naming the roots in turn: A the first), then prints each root's mean.
Only each checkout's own calls are used (``strand_query_cuda(rows, leaf,
first, ro, rd, tmax, tmin, any_hit)`` and ``packet_query_cuda`` alike), so
any two checkouts of the port compare. Needs a GPU; refuses to run
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def _time_root(root: str, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import time

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("walk_times needs a CUDA device")
    import chip_smoke as c
    from raytpu_torch.kernels import _build
    from raytpu_torch.kernels.packet import packet_query_cuda
    from raytpu_torch.kernels.strand import strand_query_cuda
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene

    t0 = time.perf_counter()
    for name in ("strand_walk", "packet_walk"):
        _build.load_library(name)
    build_s = time.perf_counter() - t0
    w, h = c.MAIN_ARGS["width"], c.MAIN_ARGS["height"]
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "gallery.glb")
        c.write_gallery(glb, cells=360)
        pack = pack_scene(load_scene(glb), "cuda")
    g = c.GALLERY_CAM
    cam = pack_camera(camera_from_lookat(g["origin"], g["at"], g["fov"], w, h),
                      "cuda")
    ro, rd = c.primary_wave(cam, w, h, c.MAIN_ARGS["chunk_size"], 1)
    tmax = torch.full((ro.shape[0],), c.F32_MAX, device="cuda")
    bvh = pack.bvh
    calls = {
        "strand_walk": lambda: strand_query_cuda(
            bvh.strand_rows, bvh.leaf_tris, bvh.first_slots, ro, rd, tmax,
            0.001, False),
        "packet_walk": lambda: packet_query_cuda(
            bvh.node8_rows, bvh.leaf_tris, bvh.first_slots, ro, rd, tmax,
            0.001, False),
    }
    times = {k: [] for k in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(c.cuda_ms(calls[name], reps=reps))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return dict(root=root, card=smi, rays=int(ro.shape[0]),
                build_s=round(build_s, 2), reps=reps,
                **{k: sum(v) / len(v) for k, v in times.items()},
                runs={k: v for k, v in times.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="time this checkout in this process")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="checkouts to time, each in its own process")
    ap.add_argument("--order", default=None,
                    help="the roots' turns as letters (A = the first root); "
                         "default each once")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.roots is None:
        root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        print(json.dumps(_time_root(root, args.reps)), flush=True)
        return 0
    order = args.order or "".join(chr(65 + i) for i in range(len(args.roots)))
    rows = []
    for letter in order:
        root = args.roots[ord(letter) - 65]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--reps", str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for root in args.roots:
        mine = [r for r in rows if r["root"] == root]
        print(f"{root}: " + ", ".join(
            f"{k} {sum(r[k] for r in mine) / len(mine):.4f} ms"
            for k in ("strand_walk", "packet_walk"))
            + f" ({len(mine)} processes; {mine[0]['card']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
