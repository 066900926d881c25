"""Multi-device sharding report: the port's counterpart of raytpu's
``benchmarks/multichip_report.py``.

raytpu reports on an 8-device virtual CPU mesh; the port shards over a
list of torch devices (``parallel/shard.py:render_frame_sharded``), eight
shards on ``["cpu"] * 8`` with ``--device cpu``, and on the card over
``make_devices(8)`` where the host has eight cards, else ``["cuda:0"] *
8`` (the shards take turns on one card). It reports what raytpu's does:

* shard balance: rows per shard, and ray queries per shard (the engine's
  exact counter, ``engine/render.py:_count_tile``) with contiguous blocks
  and round-robin at 4 tiles a shard, and their min/max balance;
* the collectives: the port has none. Each shard renders its rows to host
  memory; the host stitches the shards (raytpu's all-gather of
  framebuffer shards) and takes the spp shards' mean (raytpu's
  all-reduce);
* the 8-way row-sharded render against the single-device one, bit-equal
  and allclose(2e-6), for both interleavings (allclose asserted, as raytpu
  asserts it), and the 4 x 2 rows x spp render's statistical agreement;
* raytpu's compile-count flatness becomes the kernel libraries built and
  loaded across the spp sizes (``kernels/_build.py``'s cache): at most one
  of each.

The scene is raytpu's, cube.glb with its camera.json override, at 64x64, 4
spp, 2 bounces, chunk 16; the port renders ``tools/scenes.py``'s cube
stand-in (the first report line says so).

    python -m raytpu_torch.tools.multichip_report
    python -m raytpu_torch.tools.multichip_report --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import scenes

W = H = 64
SHARDS = 8


def devices_for(device: str, n: int) -> tuple:
    """(n devices, a note): ``["cpu"] * n``; on the card ``make_devices(n)``
    when the host has n cards, else ``["cuda:0"] * n``."""
    from ..parallel.shard import make_devices

    if device == "cpu":
        return ["cpu"] * n, f"{n} x cpu"
    if torch.cuda.device_count() >= n:
        return make_devices(n), f"{n} x {torch.cuda.get_device_name(0)}"
    return ["cuda:0"] * n, (f"{n} shards on cuda:0 "
                            f"({torch.cuda.get_device_name(0)}; the host "
                            f"has {torch.cuda.device_count()} card(s))")


def setup(device: str):
    """(pack, camera, config) of the report's frame on ``device``."""
    from ..scene.camera import load_camera_json
    from ..scene.gltf import load_scene
    from ..scene.pack import pack_camera, pack_scene
    from ..types import RenderConfig

    path = scenes.cached_glb("cube_standin.glb")
    pack = pack_scene(load_scene(path), device)
    cam = pack_camera(load_camera_json(
        os.path.join(os.path.dirname(path), "cube_camera.json"), W, H),
        device)
    config = RenderConfig(width=W, height=H, seed=1, samples=4, bounces=2,
                          chunk_size=16)
    return pack, cam, config


def shard_ray_counts(pack, cam, config, tiles_per_shard: int,
                     shards: int = SHARDS) -> list:
    """Ray queries per shard with ``tiles_per_shard`` round-robin tiles a
    shard (raytpu's ``shard_ray_counts``)."""
    from ..engine.render import _count_tile
    from ..types import RenderConfig

    w, h = config.width, config.height
    rps = -(-h // (shards * tiles_per_shard))
    sub = RenderConfig(
        width=w, height=h, seed=1, samples=config.samples,
        bounces=config.bounces, chunk_size=16, tile_rows=rps)
    per_shard = [0] * shards
    for s in range(shards):
        for i in range(tiles_per_shard):
            y0 = (i * shards + s) * rps
            if y0 >= h:
                continue
            per_shard[s] += int(_count_tile(pack, cam, y0, sub, rps,
                                            min(rps, h - y0)))
    return per_shard


def _libraries() -> dict:
    from ..kernels import _build

    with _build.LOCK:
        return {"built": dict(_build.BUILDS), "loaded": dict(_build.LOADS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip_report", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    from ..engine.render import count_rays, render_frame
    from ..parallel.shard import render_frame_sharded

    pack, cam, config = setup(args.device)
    h = config.height
    before = _libraries()
    single = render_frame(pack, cam, config)
    devs, note = devices_for(args.device, SHARDS)

    print(f"# Multi-device sharding report ({SHARDS} shards)\n")
    print(f"- scene: {scenes.CUBE_NOTE}, {W}x{H}, "
          f"samples={config.samples}, bounces={config.bounces}")
    print(f"- devices: {note}\n")

    # ---- rows x 1: pure data parallel, parity mode ---------------------
    rows_per_shard = -(-h // SHARDS)
    out = render_frame_sharded(pack, cam, config, devices=devs)
    bit_equal = bool(np.array_equal(out, single))
    close = bool(np.allclose(out, single, rtol=2e-6, atol=1e-7))

    print(f"## rows x 1 ({SHARDS} row shards, parity data-parallel mode)\n")
    print(f"- rows per shard: {rows_per_shard} "
          f"(balance: {'exact' if h % SHARDS == 0 else 'padded'})")
    # per-shard ray workload (the actual load-balance metric: rays, not
    # rows, from the engine's exact counter)
    per_shard = shard_ray_counts(pack, cam, config, 1)
    total = sum(per_shard)
    print(f"- ray queries per shard (contiguous blocks): {per_shard}")
    print(f"- load balance (min/max): {min(per_shard) / max(per_shard):.3f}")
    per_shard4 = shard_ray_counts(pack, cam, config, 4)
    print(f"- ray queries per shard (tiles_per_shard=4, round-robin): "
          f"{per_shard4}")
    print(f"- load balance (min/max): "
          f"{min(per_shard4) / max(per_shard4):.3f}")
    print("- collectives: none on a device; the host stitches the "
          "shards' rows (raytpu's framebuffer all-gather)")
    print(f"- sharded == single-device: bit_equal={bit_equal}, "
          f"allclose(2e-6)={close}")
    if not close:
        raise RuntimeError("the row-sharded frame is off the single-device "
                           "one")

    # interleaved mode must also reproduce the single-device image
    out_rr = render_frame_sharded(pack, cam, config, devices=devs,
                                  tiles_per_shard=4)
    rr_bit = bool(np.array_equal(out_rr, single))
    rr_close = bool(np.allclose(out_rr, single, rtol=2e-6, atol=1e-7))
    print(f"- round-robin (tiles_per_shard=4) == single-device: "
          f"bit_equal={rr_bit}, allclose(2e-6)={rr_close}\n")
    if not rr_close:
        raise RuntimeError("the round-robin frame is off the single-device "
                           "one")

    # ---- 4 x 2: rows x spp with the host's mean -------------------------
    out2 = render_frame_sharded(pack, cam, config, devices=devs,
                                n_sample_shards=2)
    print("## rows x spp (4 x 2, decorrelated sample sharding)\n")
    print("- collectives: none on a device; the host stitches the rows and "
          "takes the 2 spp shards' mean (raytpu's all-reduce pmean)")
    mean_err = float(np.abs(out2 - single).mean())
    print(f"- statistical agreement vs single device: mean |diff| = "
          f"{mean_err:.4f} (decorrelated seeds; not a parity mode)")
    after = _libraries()
    libs = {k: {n: v - before[k].get(n, 0) for n, v in after[k].items()
                if v - before[k].get(n, 0)} for k in after}
    print(f"- kernel libraries built / loaded across the spp sizes (1 and 2 "
          f"shards; one cache, kernels/_build.py): built {libs['built'] or 0}"
          f", loaded {libs['loaded'] or 0}"
          + (" (the plain versions run on the CPU)"
             if args.device == "cpu" else "") + "\n")
    if any(n > 1 for d in libs.values() for n in d.values()):
        raise RuntimeError(f"a kernel library was built or loaded more than "
                           f"once across the spp sizes: {libs}")
    if not np.isfinite(out2).all():
        raise RuntimeError("the rows x spp frame is not finite")

    print("## scaling model\n")
    print("- rendering is embarrassingly parallel over pixels: scene "
          "tables are replicated, there is NO cross-shard traffic during "
          "tracing; the only exchanges are the output stitch and the "
          "spp mean, both O(framebuffer), on the host.")
    single_rays = count_rays(pack, cam, config)
    print(f"- total ray queries this frame: {total} (single-device "
          f"count_rays {single_rays}: no duplicated work).")
    if total != single_rays or sum(per_shard4) != single_rays:
        raise RuntimeError("the shards' ray queries do not sum to the "
                           "single-device count")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
