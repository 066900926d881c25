"""Command-line driver with raytpu's flag surface (the reference's flags,
src/main.rs:30-52, plus raytpu's extensions):

    python -m raytpu_torch.cli --width W --height H --seed S \
        --scene FILE.glb --chunk-size C --samples N --bounces B \
        [--gui] [--output out.png] [--camera camera.json] \
        [--mode path|flat] [--checkpoint FILE.npz] [--devices N] \
        [--profile DIR] [--device cuda|cpu]

Camera resolution order matches src/state.rs:398-411: the JSON override
wins; otherwise the scene's glTF camera; a scene with neither is an error.
The device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no
GPU the run stops with status 1 and does not fall back. As raytpu's
``main`` does, the render is ``--gui``'s live preview, else row shards
over ``--devices`` N > 1 (N cards, or N CPU shards with ``--device
cpu``), else a checkpointed render with ``--checkpoint``, else one
``render_frame``; ``--profile`` wraps whichever runs in a torch.profiler
trace."""

from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager, nullcontext


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
                   help="progressive checkpoint file for resume")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the frame's rows across this many devices")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the render to this "
                        "directory (TensorBoard or Perfetto open it)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="render device (default: cuda; cpu only when asked)")
    return p


@contextmanager
def _profiled(trace_dir: str, device: str):
    """A torch.profiler trace of the block, CPU activity plus CUDA activity
    on the card, written into ``trace_dir`` as ``*.pt.trace.json`` when the
    block ends, by an exception too."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

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
    pack = pack_scene(scene, args.device)
    cam = pack_camera(camera, args.device)

    profile_ctx = (nullcontext() if args.profile is None
                   else _profiled(args.profile, args.device))
    with profile_ctx:  # exceptions must still close the trace
        if args.gui:
            from .gui import run_gui

            frame = run_gui(pack, cam, config)
        elif args.devices > 1:
            from .parallel.shard import make_devices, render_frame_sharded

            devices = (["cpu"] * args.devices if args.device == "cpu"
                       else make_devices(args.devices))
            frame = render_frame_sharded(pack, cam, config, devices=devices)
        elif args.checkpoint is not None:
            from .engine.progressive import render_with_checkpoint

            frame = render_with_checkpoint(pack, cam, config, args.checkpoint)
        else:
            frame = render_frame(pack, cam, config)

    if args.output is not None:
        write_png(args.output, frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
