"""The port's engine as a whole: raytpu_torch.engine.render against
raytpu's engine on the CPU (the packet route for flat mode and scenes of
<= 256 slots, the strand route for path waves above), its routing,
``count_rays``, and the CLI.

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
from raytpu_torch.kernels.packet import packet_query_cuda
from raytpu_torch.kernels.strand import strand_query_cuda
from raytpu_torch.scene.camera import camera_from_lookat, load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_host import AT, EYE, FOV, scene_path
from .tools.glb_writer import GlbBuilder, box, quad

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
    (pack, cam), _ = _packs("gallery")
    assert pack.bvh.strand_rows is not None
    strand = render.render_frame(pack, cam,
                                 RenderConfig(**CFG, intersector="strand"))
    brute = render.render_frame(pack, cam,
                                RenderConfig(**CFG, intersector="brute"))
    _assert_png_equiv(strand, brute)


def test_packet_route_matches_brute_route():
    (pack, cam), _ = _packs("small")
    assert pack.bvh.strand_rows is None
    packet = render.render_frame(pack, cam,
                                 RenderConfig(**CFG, intersector="packet"))
    brute = render.render_frame(pack, cam,
                                RenderConfig(**CFG, intersector="brute"))
    assert _lit(packet) > 0.5
    _assert_png_equiv(packet, brute)
    with pytest.raises(ValueError, match="strand tree"):
        render.render_tile(pack, cam, 0,
                           RenderConfig(**CFG, intersector="strand"), 8)


def test_tiles_stitch_to_the_frame():
    (pack, cam), _ = _packs("small")
    whole = render.render_frame(pack, cam, RenderConfig(**CFG))
    tiled = render.render_frame(pack, cam, RenderConfig(**CFG, tile_rows=12))
    _assert_png_equiv(whole, tiled)
    rows = [r for _, r, _ in render.render_frame_tiles(
        pack, cam, RenderConfig(**CFG, tile_rows=12))]
    assert rows == [12, 12, 8]


@pytest.mark.parametrize("which", ["bvh", "binned"])
def test_unported_routes_raise(which):
    (pack, cam), _ = _packs("small")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render.render_tile(pack, cam, 0, RenderConfig(**CFG, intersector=which),
                           8)


def write_pbr_nee(path):
    """bench.py's pbr+nee layout (BASELINE config 4): a diffuse backdrop,
    metal/glass/diffuse boxes, an emissive panel and one light, viewed
    through its glTF camera: all four material branches and NEE, 40
    triangles."""
    b = GlbBuilder()
    diffuse = b.add_material(color=(0.7, 0.7, 0.7, 1), ior=1.1)
    metal = b.add_material(color=(0.9, 0.8, 0.6, 1), metallic=1.0)
    glass = b.add_material(color=(0.9, 0.9, 1.0, 1), ior=1.5)
    glow = b.add_material(color=(1.0, 0.5, 0.2, 1), emission=6.0)
    pos, nrm, uv, idx = quad(size=10.0)
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, diffuse, np.uint16)]),
               translation=[0, 0, -4])
    bp, bn, bu, bi = box()
    for m, x in ((metal, -3.0), (glass, 0.0), (diffuse, 3.0)):
        b.add_node(mesh=b.add_mesh([(bp, bn, bu, bi, m, np.uint32)]),
                   translation=[x, 0, -1.5])
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, glow, np.uint16)]),
               matrix=[0.2, 0, 0, 0, 0, 0.2, 0, 0, 0, 0, 0.2, 0, 0, 4, 0, 1])
    b.add_node(light=b.add_light(intensity=50.0), translation=[0, 5, 8])
    b.add_node(camera=b.add_camera(1.0, 0.8), translation=[0, 0, 12])
    b.write(path)


def test_pbr_nee_frame_matches_raytpu(tmp_path):
    """The packet route through all four material branches and NEE,
    against raytpu's default CPU route, at 32x32, 2 spp, 4 bounces."""
    path = str(tmp_path / "pbr_nee.glb")
    write_pbr_nee(path)
    scene = load_scene(path)
    pack = pack_scene(scene)
    assert pack.n_triangles <= 256 and pack.bvh.strand_rows is None
    cfg = dict(width=32, height=32, seed=1, samples=2, bounces=4,
               chunk_size=32)
    port = render.render_frame(pack, pack_camera(scene.camera),
                               RenderConfig(**cfg))
    rscene = raytpu.load_scene(path)
    ref = rt_render.render_frame(rt_pack_scene(rscene),
                                 rt_pack_camera(rscene.camera),
                                 raytpu.RenderConfig(**cfg))
    assert np.isfinite(port).all() and _lit(port) > 0.3
    _assert_png_equiv(port, ref)


def _spy(monkeypatch, calls):
    """Wrap both intersector factories so every query records its route."""
    def wrap(name, factory):
        def make(pack):
            fns = factory(pack)

            def tag(fn, kind):
                def query(*args):
                    calls.add(f"{name} {kind}")
                    return fn(*args)
                return query
            return tag(fns[0], "closest"), tag(fns[1], "any")
        return make

    monkeypatch.setattr(render, "make_packet_intersectors",
                        wrap("packet", render.make_packet_intersectors))
    monkeypatch.setattr(render, "make_strand_intersectors",
                        wrap("strand", render.make_strand_intersectors))


@pytest.mark.parametrize("name,mode,want", [
    ("small", "path", {"packet closest", "packet any"}),
    ("small", "flat", {"packet closest"}),
    ("gallery", "flat", {"packet closest"}),
    ("gallery", "path", {"strand closest", "strand any"}),
])
def test_auto_routes_like_raytpu_tpu_branch(monkeypatch, name, mode, want):
    """"auto": packet for flat mode and every wave of a <= 256-slot scene,
    strand for every path wave of a scene with a strand tree."""
    calls = set()
    _spy(monkeypatch, calls)
    (pack, cam), _ = _packs(name)
    cfg = RenderConfig(width=16, height=8, seed=2, samples=1, bounces=2,
                       chunk_size=8, mode=mode)
    frame = render.render_tile(pack, cam, 0, cfg, 8)
    assert frame.shape == (8, 16, 4)
    assert calls == want


@pytest.mark.parametrize("name,tile_rows", [
    ("small", None), ("small", 12), ("gallery", None), ("gallery", 12)])
def test_count_rays_equals_raytpu(name, tile_rows):
    """Exact: the same query count as raytpu's count_rays at 48x32 (tiles
    of 12 rows leave padding rows in the last tile)."""
    (pack, cam), (rpack, rcam) = _packs(name)
    cfg = dict(CFG, tile_rows=tile_rows)
    got = render.count_rays(pack, cam, RenderConfig(**cfg))
    want = rt_render.count_rays(rpack, rcam, raytpu.RenderConfig(**cfg))
    assert isinstance(got, int)
    assert got == want
    # at least every in-grid primary query, at most 1 + 2*bounces per lane
    lanes = 48 * 32 * CFG["samples"]
    assert lanes < got <= lanes * (1 + 2 * CFG["bounces"])


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
    before = strand_query_cuda.launches, packet_query_cuda.launches
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
    # CPU: the plain versions
    assert (strand_query_cuda.launches, packet_query_cuda.launches) == before
    # without --camera the scene's glTF camera is used
    assert cli.main(_cli_args(tmp_path, "gltf.png", camera=False)) == 0
    assert (tmp_path / "gltf.png").stat().st_size > 0


@pytest.mark.parametrize("flag", [["--gui"], ["--checkpoint", "ck.npz"],
                                  ["--devices", "2"], ["--profile", "prof"]])
def test_cli_unported_flags_exit_2(tmp_path, capsys, flag):
    assert cli.main(_cli_args(tmp_path) + flag) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "out.png").exists()
