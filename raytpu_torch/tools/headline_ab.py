"""Time the headline atrium frame end to end (no trace): the port's
counterpart of raytpu's ``benchmarks/headline_ab.py``, the A/B tool for
engine-glue changes. Prints steady-state ms and Mrays/s. Knobs ride
environment variables (e.g. ``RAYTPU_LARGE_WAVE``), so run one process per
arm; the tool has no A/B loop of its own.

The four configs are raytpu's (``--scene``):

* ``atrium`` (default): ``tools/scenes.py:cached_atrium(--tris)`` at
  ``--width`` x ``--height`` (1920x1080), 1 spp, ``--bounces`` (4), chunk
  8, ``--tile-rows``; ``--intersector`` and ``RAYTPU_BOUNCE_BACKEND``
  override the config's;
* ``multi``: BASELINE config 3 (``build_multi_mesh_glb``), 256x256, 2
  spp, 3 bounces, chunk 32, ``bruteforce_max_tris=64``;
  ``RAYTPU_BOUNCE_BACKEND`` applies;
* ``pbr``: BASELINE config 4 (``build_pbr_nee_glb``), 256x256, 4 spp, 4
  bounces, chunk 32; ``--intersector`` applies;
* ``cube``: BASELINE config 2, 512x512, 4 spp, 4 bounces, chunk 64, on
  ``write_cube``'s stand-in and the camera.json's values
  (``CUBE_CAMERA``): the reference's cube.glb is not in the repository,
  and the first report line says so.

``--width`` and ``--height`` given explicitly also resize the multi, pbr
and cube configs (raytpu's fix them), so that a small run of them is
possible on the CPU.

raytpu jits one function over the frame's tiles; the port renders through
its ``render_frame`` (tiled by ``_auto_tile_rows``). One timing is
``--inner`` frames back to back, ending in one ``torch.cuda.synchronize()``,
on the host clock; the steady frame is the best of ``--repeats`` timings
over ``--inner``, after a warm-up frame. Mrays/s uses ``--rays`` when
given, or ``count_rays`` of the frame with ``--count-rays``.
``--output PNG`` writes the last frame's PNG.

    python -m raytpu_torch.tools.headline_ab [--scene atrium] [--repeats 3]
    python -m raytpu_torch.tools.headline_ab --scene pbr --device cpu \\
        --width 32 --height 32 --repeats 1
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from . import scenes


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup(args, device: str):
    """(first report line, pack, camera, RenderConfig) of ``args.scene``."""
    from ..scene.camera import load_camera_json
    from ..scene.gltf import load_scene
    from ..scene.pack import pack_camera, pack_scene
    from ..types import RenderConfig

    def size(w: int, h: int) -> dict:
        return dict(width=args.width or w, height=args.height or h)

    bb = os.environ.get("RAYTPU_BOUNCE_BACKEND")
    if args.scene == "multi":
        scene = load_scene(scenes.cached_glb("multi_mesh.glb"))
        pack = pack_scene(scene, device)
        extra = {"bounce_backend": bb} if bb else {}
        cfg = RenderConfig(**size(256, 256), seed=1, samples=2, bounces=3,
                           chunk_size=32, bruteforce_max_tris=64, **extra)
        note = "multi-mesh (BASELINE config 3)"
    elif args.scene == "pbr":
        scene = load_scene(scenes.cached_glb("pbr_nee.glb"))
        pack = pack_scene(scene, device)
        extra = ({"intersector": args.intersector} if args.intersector
                 else {})
        cfg = RenderConfig(**size(256, 256), seed=1, samples=4, bounces=4,
                           chunk_size=32, **extra)
        note = "pbr+nee (BASELINE config 4)"
    elif args.scene == "cube":
        path = scenes.cached_glb("cube_standin.glb")
        scene = load_scene(path)
        pack = pack_scene(scene, device)
        cfg = RenderConfig(**size(512, 512), seed=1, samples=4, bounces=4,
                           chunk_size=64)
        cam = load_camera_json(os.path.join(os.path.dirname(path),
                                            "cube_camera.json"),
                               cfg.width, cfg.height)
        note = f"cube (BASELINE config 2) on {scenes.CUBE_NOTE}"
    else:
        scene, pack = scenes.cached_atrium(args.tris, device)
        extra = {}
        if args.intersector:
            extra["intersector"] = args.intersector
        if bb:
            extra["bounce_backend"] = bb
        cfg = RenderConfig(**size(1920, 1080), seed=1, samples=1,
                           bounces=args.bounces, chunk_size=8,
                           tile_rows=args.tile_rows, **extra)
        note = f"atrium {args.tris} (BASELINE config 5)"
    cam = pack_camera(cam if args.scene == "cube" else scene.camera, device)
    line = (f"scene: {note}, {pack.n_triangles} slots, {cfg.width}x"
            f"{cfg.height} {cfg.samples} spp {cfg.bounces} bounces chunk "
            f"{cfg.chunk_size}, device {device}")
    return line, pack, cam, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="headline_ab", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--width", type=int, default=None,
                    help="default 1920 (atrium) or the config's")
    ap.add_argument("--height", type=int, default=None,
                    help="default 1080 (atrium) or the config's")
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rays", type=float, default=0.0,
                    help="known ray count (Mrays/s uses it if given)")
    ap.add_argument("--count-rays", action="store_true",
                    help="count the frame's rays with count_rays for Mrays/s")
    ap.add_argument("--scene", default="atrium",
                    choices=["atrium", "multi", "pbr", "cube"])
    ap.add_argument("--tile-rows", type=int, default=None)
    ap.add_argument("--intersector", default=None,
                    help="override config.intersector")
    ap.add_argument("--inner", type=int, default=1,
                    help="frames back to back per timing (small frames)")
    ap.add_argument("--output", default=None,
                    help="write the last frame's PNG here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions")
    from ..engine.render import count_rays, render_frame
    from ..io.png import write_png

    line, pack, cam, cfg = setup(args, args.device)
    print(line, flush=True)
    cuda = args.device == "cuda"

    def frames():
        for _ in range(args.inner):
            out = render_frame(pack, cam, cfg)
        if cuda:
            torch.cuda.synchronize()
        return out

    t0 = time.time()
    frame = frames()
    _log(f"warmup {time.time() - t0:.1f}s")
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        frame = frames()
        best = min(best, time.perf_counter() - t0)
    ms = best * 1000 / args.inner
    rays = float(count_rays(pack, cam, cfg)) if args.count_rays else args.rays
    line = f"steady frame {ms:.1f} ms"
    if rays:
        line += f"  ->  {rays / (ms / 1000.0) / 1e6:.2f} Mrays/s"
        if args.count_rays:
            line += f" (count_rays {int(rays)})"
    print(line, flush=True)
    if args.output:
        write_png(args.output, frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
