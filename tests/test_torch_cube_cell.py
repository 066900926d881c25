"""The benchmark's cube cell on the CPU: the upstream's cube stand-in,
written as a GLB and a camera.json by ``raytpu_torch/tools/scenes.py``,
loaded through ``load_scene`` and ``load_camera_json`` and rendered
through ``render_frame`` (the packet route: 24 slots, no coherence
sorts), agrees on every pixel with the benchmark's plain reference
(``portbench/reference/tracer.py``) under the check's tolerance.

Nothing here imports JAX or raytpu."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench.harness import check
from portbench.reference import tracer
from portbench.reference.world import World
from raytpu_torch.engine.render import render_frame
from raytpu_torch.scene.camera import load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.tools.scenes import write_cube, write_cube_camera
from raytpu_torch.types import RenderConfig

W = H = 64


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """(scene arrays under the reference's names, pack, camera pack) of
    the stand-in at W x H on the CPU."""
    d = tmp_path_factory.mktemp("cube")
    write_cube(str(d / "cube.glb"))
    write_cube_camera(str(d / "camera.json"))
    scene = load_scene(str(d / "cube.glb"))
    cam = load_camera_json(str(d / "camera.json"), W, H)
    arrays = {f.name: getattr(scene, f.name)
              for f in dataclasses.fields(scene)
              if f.name not in ("camera", "textures")}
    arrays.update(camera_world=cam.world, camera_projection=cam.projection)
    return arrays, pack_scene(scene, "cpu"), pack_camera(cam, "cpu")


@pytest.mark.parametrize("mode,samples,bounces,chunk", [
    ("path", 2, 4, 16), ("flat", 1, 1, 16)])
def test_cube_frame_equals_the_reference(cube, mode, samples, bounces,
                                         chunk):
    arrays, pack, cam = cube
    seed = 7
    img = render_frame(pack, cam, RenderConfig(
        width=W, height=H, seed=seed, samples=samples, bounces=bounces,
        chunk_size=chunk, mode=mode))
    ys, xs = np.mgrid[0:H, 0:W]
    xs, ys = xs.ravel(), ys.ravel()
    ref = tracer.render_lanes(
        World(arrays, "cpu"), xs, ys, np.full(xs.shape, seed), width=W,
        height=H, chunk=chunk, samples=samples, bounces=bounces, mode=mode)
    lit = (np.abs(ref).sum(axis=1) > 0).mean()
    assert 0.05 < lit < 0.5  # the cube, and mostly misses around it
    assert check.diverged_pct(img[ys, xs], ref) == 0.0
