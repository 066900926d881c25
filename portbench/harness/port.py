"""The one boundary between the benchmark and the program.

The program is ``raytpu_torch``. The benchmark hands it the scene arrays
it built itself (as the port's ``SceneData``), packs them with the user's
pack settings, and renders frames through the main entry point,
``render_frame``, which returns each image on the host as numpy. Nothing
else of the program is read: no counter, no tool, no cached pack.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from raytpu_torch.engine.render import render_frame
from raytpu_torch.scene.camera import CameraData
from raytpu_torch.scene.gltf import SceneData
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig


def scene_data(arrays: dict) -> SceneData:
    """The port's ``SceneData`` of a scene builder's arrays."""
    names = {f.name for f in dataclasses.fields(SceneData)}
    return SceneData(
        **{k: v for k, v in arrays.items() if k in names},
        textures=[],
        camera=CameraData(world=arrays["camera_world"],
                          projection=arrays["camera_projection"]))


def pack(arrays: dict, device, pack_args: dict):
    """(pack, camera, seconds): ``pack_scene`` and ``pack_camera`` on
    ``device`` with the configuration's pack settings, timed by the host
    clock until the tables are resident (a synchronise on a card)."""
    scene = scene_data(arrays)
    t0 = time.perf_counter()
    p = pack_scene(scene, device, **pack_args)
    cam = pack_camera(scene.camera, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return p, cam, time.perf_counter() - t0


def config(traffic: dict, seed: int) -> RenderConfig:
    """The render request of a traffic mix with one frame's seed."""
    return RenderConfig(width=traffic["width"], height=traffic["height"],
                        seed=seed, samples=traffic["samples"],
                        bounces=traffic["bounces"],
                        chunk_size=traffic["chunk"], mode=traffic["mode"])


def render(p, cam, cfg: RenderConfig) -> np.ndarray:
    """One frame, [H, W, 4] float32 on the host."""
    return render_frame(p, cam, cfg)
