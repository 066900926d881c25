"""The path-mode slice as a whole: raytpu_torch.engine.render against
raytpu's engine on the CPU, and the CLI.

Frame tolerance: XLA:CPU contracts multiply-adds into FMAs and its
sin/cos/sqrt differ from torch's in the last ulp, so most f32 pixels of
two otherwise identical renders differ in their low bits. The frames are
therefore compared as the PNG the user gets (the reference's u8
quantisation) with the cross-engine bar of tests/imgdiff.py: at most 2%
of pixels differ and SSIM >= 0.99."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.kernels.intersect import Hit as RtHit
from raytpu.scene.pack import pack_camera as rt_pack_camera
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch import cli
from raytpu_torch.engine import render
from raytpu_torch.io.png import write_png
from raytpu_torch.kernels.intersect import intersect_bruteforce
from raytpu_torch.kernels.strand import strand_query_cuda
from raytpu_torch.scene.camera import camera_from_lookat, load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_host import AT, EYE, FOV, scene_path

CFG = dict(width=48, height=32, seed=11, samples=2, bounces=4,
           chunk_size=16)


@functools.lru_cache(maxsize=None)
def _packs(name: str, w: int = 48, h: int = 32):
    """((port pack, port camera), (raytpu pack, raytpu camera))."""
    cam = camera_from_lookat(EYE, AT, FOV, w, h)
    port = (pack_scene(load_scene(scene_path(name))), pack_camera(cam))
    ref = (rt_pack_scene(raytpu.load_scene(scene_path(name))),
           rt_pack_camera(raytpu.camera_from_lookat(EYE, AT, FOV, w, h)))
    return port, ref


def _assert_png_equiv(a, b):
    assert_images_equiv(quantize_rgba32f(a) / 255.0,
                        quantize_rgba32f(b) / 255.0)


def _lit(frame) -> float:
    return float((quantize_rgba32f(frame).max(-1) > 0).mean())


def test_cast_rays_matches_raytpu():
    (_, cam), (_, rcam) = _packs("gallery")
    r = np.random.default_rng(0)
    px = (r.random(4000) * 48).astype(np.float32)
    py = (r.random(4000) * 32).astype(np.float32)
    o, d = render.cast_rays(torch.from_numpy(px), torch.from_numpy(py),
                            cam.world, cam.projection, 48, 32)
    ro, rd = rt_render.cast_rays(jnp.asarray(px), jnp.asarray(py),
                                 rcam.world, rcam.projection, 48, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-6)
    assert o.shape == d.shape == (4000, 3)


def test_shade_core_matches_raytpu():
    """Fixed hits (one brute sweep) and RNG states into both shaders: the
    masked RNG replay is bit-equal, the shaded values agree to rtol 1e-5."""
    (pack, cam), (rpack, _) = _packs("gallery")
    r = np.random.default_rng(1)
    px = torch.from_numpy((r.random(3000) * 48).astype(np.float32))
    py = torch.from_numpy((r.random(3000) * 32).astype(np.float32))
    ro, rd = render.cast_rays(px, py, cam.world, cam.projection, 48, 32)
    ro = ro.contiguous()
    hit = intersect_bruteforce(ro, rd, pack.tri_p0, pack.tri_e1,
                               pack.tri_e2, 0.001, 3.4e38)
    state = r.integers(-2**31, 2**31, size=3000, dtype=np.int64)
    state = state.astype(np.int32)
    active = hit.valid & torch.from_numpy(r.random(3000) < 0.9)
    got = render._shade_core(pack, ro, rd, hit, torch.from_numpy(state),
                             active)
    want = rt_render._shade_core(
        rpack, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
        RtHit(t=jnp.asarray(hit.t.numpy()), tri=jnp.asarray(hit.tri.numpy()),
              valid=jnp.asarray(hit.valid.numpy())),
        jnp.asarray(state.view(np.uint32)), jnp.asarray(active.numpy()))
    assert 0.5 < float(hit.valid.float().mean())
    np.testing.assert_array_equal(
        got["rng"].numpy(), np.asarray(want["rng"]).view(np.int32))
    np.testing.assert_array_equal(got["bounce_on"].numpy(),
                                  np.asarray(want["bounce_on"]))
    on = got["bounce_on"].numpy()
    for k in ("p", "scattered", "att_mult", "emissive_delta", "ldir", "dist",
              "contrib"):
        np.testing.assert_allclose(got[k].numpy()[on], np.asarray(want[k])[on],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@functools.lru_cache(maxsize=None)
def _frames(name: str, **extra):
    (pack, cam), (rpack, rcam) = _packs(name)
    port = render.render_frame(pack, cam, RenderConfig(**CFG, **extra))
    ref = rt_render.render_frame(rpack, rcam, raytpu.RenderConfig(**CFG,
                                                                  **extra))
    return port, ref


def test_gallery_frame_matches_raytpu():
    """The main path (4096 slots: strand walk, sorted bounce and shadow
    queries) against raytpu's default CPU route."""
    port, ref = _frames("gallery")
    assert port.shape == (32, 48, 4) and np.isfinite(port).all()
    assert _lit(port) > 0.5 and _lit(ref) > 0.5
    _assert_png_equiv(port, ref)


def test_textured_small_scene_matches_raytpu():
    (pack, _), _ = _packs("small")
    assert pack.n_triangles <= 256 and pack.has_textures
    port, ref = _frames("small")
    assert _lit(port) > 0.5
    _assert_png_equiv(port, ref)


def test_flat_mode_matches_raytpu():
    port, ref = _frames("gallery", mode="flat")
    assert _lit(port) > 0.5
    _assert_png_equiv(port, ref)


def test_brute_route_matches_strand_route():
    (pack, cam), _ = _packs("small")
    strand = render.render_frame(pack, cam, RenderConfig(**CFG))
    brute = render.render_frame(pack, cam,
                                RenderConfig(**CFG, intersector="brute"))
    _assert_png_equiv(strand, brute)


def test_tiles_stitch_to_the_frame():
    (pack, cam), _ = _packs("small")
    whole = render.render_frame(pack, cam, RenderConfig(**CFG))
    tiled = render.render_frame(pack, cam, RenderConfig(**CFG, tile_rows=12))
    _assert_png_equiv(whole, tiled)
    rows = [r for _, r, _ in render.render_frame_tiles(
        pack, cam, RenderConfig(**CFG, tile_rows=12))]
    assert rows == [12, 12, 8]


@pytest.mark.parametrize("which", ["bvh", "packet", "binned"])
def test_unported_routes_raise(which):
    (pack, cam), _ = _packs("small")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render.render_tile(pack, cam, 0, RenderConfig(**CFG, intersector=which),
                           8)


def _cli_args(tmp_path, out="out.png", camera=True):
    args = ["--width", "40", "--height", "24", "--seed", "3", "--scene",
            scene_path("small_plain"), "--chunk-size", "8", "--samples", "1",
            "--bounces", "2", "--output", str(tmp_path / out),
            "--device", "cpu"]
    if camera:
        cam = tmp_path / "camera.json"
        cam.write_text(json.dumps({"origin": EYE, "at": AT, "fov": FOV}))
        args += ["--camera", str(cam)]
    return args


def test_cli_writes_the_rendered_png(tmp_path):
    before = strand_query_cuda.launches
    assert cli.main(_cli_args(tmp_path)) == 0
    cfg = RenderConfig(width=40, height=24, seed=3, samples=1, bounces=2,
                       chunk_size=8)
    frame = render.render_frame(
        pack_scene(load_scene(scene_path("small_plain"))),
        pack_camera(load_camera_json(str(tmp_path / "camera.json"), 40, 24)),
        cfg)
    write_png(str(tmp_path / "want.png"), frame)
    assert (tmp_path / "out.png").read_bytes() == (
        tmp_path / "want.png").read_bytes()
    assert _lit(frame) > 0.3
    assert strand_query_cuda.launches == before  # CPU: the plain version
    # without --camera the scene's glTF camera is used
    assert cli.main(_cli_args(tmp_path, "gltf.png", camera=False)) == 0
    assert (tmp_path / "gltf.png").stat().st_size > 0


@pytest.mark.parametrize("flag", [["--gui"], ["--checkpoint", "ck.npz"],
                                  ["--devices", "2"], ["--profile", "prof"]])
def test_cli_unported_flags_exit_2(tmp_path, capsys, flag):
    assert cli.main(_cli_args(tmp_path) + flag) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "out.png").exists()
