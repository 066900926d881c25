"""Progressive rendering with checkpoint/resume.

Torch counterpart of ``raytpu.engine.progressive``. The reference is
naturally checkpointable — all inter-chunk state is the SAMPLES texture
plus the ``current_chunk`` counter (src/state.rs:330-379) — but never
persists it. A checkpoint is raytpu's ``.npz``: the partial framebuffer
(``frame``), the next tile row (``next_y0``) and a fingerprint of its
inputs (``key``). Tiles are deterministic (seeded per pixel,
kernels/rng.py), so resuming produces the identical image."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..types import CameraPack, RenderConfig, ScenePack
from .render import placed, render_frame_tiles


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), np.float32)


def _ckpt_key(pack: ScenePack, camera: CameraPack,
              config: RenderConfig) -> str:
    """Fingerprint of everything a tile depends on. A checkpoint written
    under any other (config, camera, scene) must NOT be resumed — stitching
    rows rendered with different samples/bounces/camera would silently
    produce a frankenframe. Scene identity uses cheap facts (the slot
    table's shape, the scene box, the material and light tables) rather
    than hashing the full geometry; tensors are hashed from the host."""
    h = hashlib.sha256()
    h.update(repr(config).encode())
    h.update(_host(camera.world).tobytes())
    h.update(_host(camera.projection).tobytes())
    h.update(str(tuple(pack.tri_row.shape)).encode())
    h.update(_host(pack.scene_bmin).tobytes())
    h.update(_host(pack.scene_bmax).tobytes())
    h.update(_host(pack.mat_table).tobytes())
    h.update(_host(pack.light_table).tobytes())
    return h.hexdigest()


def render_with_checkpoint(pack: ScenePack, camera: CameraPack,
                           config: RenderConfig, path: str,
                           save_every: int = 1, device=None) -> np.ndarray:
    """Render, persisting progress to ``path`` after every ``save_every``
    tiles; resumes from an existing checkpoint of the same shape and key
    (one with no key, another key or another shape restarts at row 0).
    The device is ``engine.render.placed``'s."""
    pack, camera = placed(pack, camera, device)
    frame = np.zeros((config.height, config.width, 4), np.float32)
    key = _ckpt_key(pack, camera, config)
    next_y0 = 0
    if os.path.exists(path):
        with np.load(path) as ckpt:
            saved = ckpt["frame"]
            saved_key = str(ckpt["key"]) if "key" in ckpt else ""
            if saved.shape == frame.shape and saved_key == key:
                frame = saved
                next_y0 = int(ckpt["next_y0"])

    def save(done_y0: int) -> None:
        np.savez(path, frame=frame, next_y0=np.int64(done_y0), key=key)

    pending = 0
    # tiles rendered in a previous run are skipped, not rendered again
    for y0, rows, tile in render_frame_tiles(pack, camera, config,
                                             first_row=next_y0):
        frame[y0 : y0 + rows] = tile
        pending += 1
        if pending >= save_every:
            save(y0 + rows)
            pending = 0
    save(config.height)
    return frame
