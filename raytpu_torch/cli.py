"""Command-line driver with raytpu's flag surface (the reference's flags,
src/main.rs:30-52, plus raytpu's extensions):

    python -m raytpu_torch.cli --width W --height H --seed S \
        --scene FILE.glb --chunk-size C --samples N --bounces B \
        [--output out.png] [--camera camera.json] [--mode path|flat] \
        [--device cuda|cpu]

Camera resolution order matches src/state.rs:398-411: the JSON override
wins; otherwise the scene's glTF camera; a scene with neither is an error.
The device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no
GPU the run stops with status 1 and does not fall back. ``--gui``,
``--checkpoint``, ``--devices`` > 1 and ``--profile`` are raytpu features
this package does not run yet: they exit with status 2 before any
work."""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu-torch", description=__doc__)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--scene", type=str, required=True)
    p.add_argument("--chunk-size", dest="chunk_size", type=int, required=True)
    p.add_argument("--samples", type=int, required=True)
    p.add_argument("--bounces", type=int, required=True)
    p.add_argument("--gui", action="store_true")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--camera", type=str, default=None)
    p.add_argument(
        "--mode", choices=["path", "flat"], default="path",
        help="path tracing (reference behaviour) or flat primary-hit colour",
    )
    p.add_argument("--checkpoint", type=str, default=None,
                   help="progressive checkpoint file (not yet ported)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the frame across devices (not yet ported)")
    p.add_argument("--profile", type=str, default=None,
                   help="profiler trace directory (not yet ported)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="render device (default: cuda; cpu only when asked)")
    return p


def _not_ported(args) -> str | None:
    if args.gui:
        return "--gui"
    if args.checkpoint is not None:
        return "--checkpoint"
    if args.devices > 1:
        return "--devices > 1"
    if args.profile is not None:
        return "--profile"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    missing = _not_ported(args)
    if missing is not None:
        print(f"ray tracer error: {missing} is not yet ported to raytpu_torch",
              file=sys.stderr)
        return 2

    import torch

    from .engine.render import render_frame
    from .io.png import write_png
    from .scene.camera import load_camera_json
    from .scene.gltf import GltfError, load_scene
    from .scene.pack import pack_camera, pack_scene
    from .types import RenderConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ray tracer error: no CUDA device is available; pass "
              "--device cpu to render on the CPU", file=sys.stderr)
        return 1
    try:
        scene = load_scene(args.scene)
    except (OSError, GltfError) as e:
        print(f"ray tracer error: failed to load scene file {args.scene}",
              file=sys.stderr)
        print(f" caused by: {e}", file=sys.stderr)
        return 1

    if args.camera is not None:
        camera = load_camera_json(args.camera, args.width, args.height)
    elif scene.camera is not None:
        camera = scene.camera
    else:
        print("ray tracer error: failed to load camera from scene",
              file=sys.stderr)
        return 1

    config = RenderConfig(
        width=args.width,
        height=args.height,
        seed=args.seed,
        samples=args.samples,
        bounces=args.bounces,
        chunk_size=args.chunk_size,
        mode=args.mode,
    )
    frame = render_frame(pack_scene(scene, args.device),
                         pack_camera(camera, args.device), config)
    if args.output is not None:
        write_png(args.output, frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
