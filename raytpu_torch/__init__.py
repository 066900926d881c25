"""raytpu_torch — raytpu's path tracer in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100.

A port of the JAX package ``raytpu`` (which stays the reference): glTF/GLB
scenes and an optional JSON look-at camera in, path-traced PNG out, with
the same RNG stream, the same reference quirks and the same triangle on
every hit. It imports torch and numpy, never JAX or raytpu, and exports
raytpu's top-level API.

Typical use:

    import raytpu_torch
    scene = raytpu_torch.load_scene("cube.glb")
    cam = raytpu_torch.load_camera_json("camera.json", 512, 512)
    cfg = raytpu_torch.RenderConfig(width=512, height=512, seed=1,
                                    samples=16, bounces=4, chunk_size=64)
    frame = raytpu_torch.render(scene, cam, cfg)  # [H,W,4] f32, on the card
    raytpu_torch.write_png("out.png", frame)
"""

from .engine.render import render_frame, render_frame_tiles, render_tile
from .io.png import quantize_rgba32f, write_png
from .scene.camera import (
    CameraData,
    camera_from_lookat,
    load_camera_json,
    look_at,
    perspective_matrix,
)
from .scene.gltf import GltfError, SceneData, load_scene
from .scene.pack import pack_camera, pack_scene
from .types import BvhPack, CameraPack, RenderConfig, ScenePack

__version__ = "0.1.0"


def render(scene, camera, config: RenderConfig, device="cuda"):
    """Convenience wrapper: accepts host SceneData/CameraData, packed onto
    ``device`` (the card unless the caller asks for the CPU), or packed
    objects (an ``as_numpy`` pack is moved to ``device``), and returns the
    [H,W,4] float32 frame."""
    pack = scene if isinstance(scene, ScenePack) else pack_scene(scene,
                                                                 device)
    if isinstance(camera, CameraData):
        camera = pack_camera(camera, device)
    return render_frame(pack, camera, config,
                        device=device if pack.on_host else None)


__all__ = [
    "BvhPack",
    "CameraData",
    "CameraPack",
    "GltfError",
    "RenderConfig",
    "SceneData",
    "ScenePack",
    "camera_from_lookat",
    "load_camera_json",
    "load_scene",
    "look_at",
    "pack_camera",
    "pack_scene",
    "perspective_matrix",
    "quantize_rgba32f",
    "render",
    "render_frame",
    "render_frame_tiles",
    "render_tile",
    "write_png",
]
