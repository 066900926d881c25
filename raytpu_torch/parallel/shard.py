"""Multi-device rendering: row shards, and optional sample shards.

Torch counterpart of ``raytpu.parallel.shard``. The reference is
single-GPU; its only parallelism is pixels. So the frame's rows are
sharded across devices with the scene and camera replicated on each
(``pack.to(device)``, as raytpu's ``in_specs=(P(), P())`` replicates
them). Row sharding keeps the reference-exact RNG (each pixel's stream
is self-contained), so a sharded frame matches the single-device one up
to the last-ulp noise of per-shape float paths.

An optional second axis ("spp") splits the per-pixel sample loop across
devices and averages the result (raytpu's ``pmean``). Because the
reference's RNG is serial across samples (src/shader.wgsl:412-414), this
mode decorrelates the streams: spp shard ``s`` seeds with
``seed * (2*s + 1) mod 2^32``. Statistically equivalent, not bit-equal —
a fast mode, not a parity mode.

One process, one controller, as raytpu's ``shard_map`` is: each distinct
device gets one host thread, so that a host sync on one card does not
stall another, and the shards of one device (a repeated device, or the
CPU) run one after another on its thread. The kernels' libraries build
under one module lock (``kernels/_build.py``): the first thread to need
one builds it and the others wait. Process-wide diagnostics
(``WAVE_STATS``, ``QUERY_STATS``, the kernels' launch counters) are
shared by every shard, not kept per shard.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import replace

import numpy as np
import torch

from ..engine.render import render_tile
from ..types import CameraPack, RenderConfig, ScenePack


def make_devices(n_row_shards: int, n_sample_shards: int = 1) -> list:
    """The first ``n_row_shards * n_sample_shards`` CUDA devices,
    rows-major (row shard r, sample shard s is entry
    ``r * n_sample_shards + s``), as raytpu's ``make_mesh`` reshapes
    ``jax.devices()``. Raises ValueError when fewer exist."""
    need = n_row_shards * n_sample_shards
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    return [torch.device("cuda", i) for i in range(need)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def render_frame_sharded(pack: ScenePack, camera: CameraPack,
                         config: RenderConfig, n_devices: int | None = None,
                         n_sample_shards: int = 1, devices=None,
                         tiles_per_shard: int = 1) -> np.ndarray:
    """Render the frame with rows sharded across devices; [H, W, 4] f32.

    ``devices`` (rows-major, ``len(devices) / n_sample_shards`` row
    shards) takes the place of raytpu's ``mesh``; without it the first
    ``n_devices`` CUDA devices (all by default) are used through
    ``make_devices``. Each device gets ``pack.to(device)`` once (an
    ``as_numpy`` pack is made tensors there). tiles_per_shard > 1 splits
    each shard's rows into that many round-robin tiles for load balance
    (shard s takes tiles s, s + n, s + 2n, ...: ray cost concentrates
    where geometry is); 1 = one contiguous block per shard."""
    if devices is None:
        if n_devices is None:
            n_devices = max(torch.cuda.device_count(), 1)
        devices = make_devices(n_devices // n_sample_shards, n_sample_shards)
    devices = [_device(d) for d in devices]
    n_spp = n_sample_shards
    if not devices or len(devices) % n_spp:
        raise ValueError(f"{len(devices)} devices do not split into "
                         f"{n_spp} sample shards")
    n_rows = len(devices) // n_spp
    if n_spp > 1 and config.samples % n_spp:
        raise ValueError("samples must divide by the spp mesh axis")
    rows_per_shard = -(-config.height // (n_rows * tiles_per_shard))
    cfg = (replace(config, samples=config.samples // n_spp) if n_spp > 1
           else config)

    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = (pack.to(d), camera.to(d))
    shards = {}  # device -> [(row shard, sample shard)] in order
    for r in range(n_rows):
        for s in range(n_spp):
            shards.setdefault(devices[r * n_spp + s], []).append((r, s))

    def run(d):
        """Every shard on device ``d``: {(r, s): [tile per round-robin
        index, each [rows_per_shard, W, 4] numpy f32]}."""
        p, c = replicas[d]
        out = {}
        with torch.cuda.device(d) if d.type == "cuda" else nullcontext():
            for r, s in shards[d]:
                seed = (None if n_spp == 1
                        else (config.seed * (2 * s + 1)) % 2**32)
                out[r, s] = [render_tile(
                    p, c, (i * n_rows + r) * rows_per_shard, cfg,
                    rows_per_shard, seed=seed).cpu().numpy()
                    for i in range(tiles_per_shard)]
        return out

    results = {}
    with ThreadPoolExecutor(len(shards)) as pool:
        for part in pool.map(run, shards):
            results.update(part)

    w = config.width
    out = np.zeros((tiles_per_shard, n_rows, rows_per_shard, w, 4),
                   np.float32)
    for r in range(n_rows):
        for i in range(tiles_per_shard):
            acc = results[r, 0][i]
            for s in range(1, n_spp):
                acc = acc + results[r, s][i]
            out[i, r] = acc / np.float32(n_spp) if n_spp > 1 else acc
    # tile t = i * n_rows + r sits at rows [t * rows_per_shard, ...)
    return out.reshape(-1, w, 4)[: config.height]
