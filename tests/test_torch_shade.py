"""The shading kernel (``raytpu_torch/kernels/shade.py``): on the CPU,
``render._shade_core`` runs the plain version and the kernel's wrapper
refuses what the kernel does not take; on the card (``cuda`` marker)
``csrc/shade.cu`` is bit-equal to the plain version run on the same CUDA
tensors, on every output where ``bounce_on`` holds and on ``rng``,
``bounce_on`` and ``emissive_delta`` everywhere, with zeros elsewhere, and
whole frames rendered through it are bit-equal to frames rendered through
the plain version. The plain version is held to raytpu by
``tests/test_torch_render.py:test_shade_core_matches_raytpu``.

Nothing here imports JAX or raytpu: on a machine with the card,
``python -m pytest --noconftest tests/test_torch_shade.py -m cuda``."""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from raytpu_torch.engine import render
from raytpu_torch.kernels.intersect import F32_MAX, Hit
from raytpu_torch.kernels.packet import make_packet_intersectors
from raytpu_torch.kernels.shade import (_check_inputs, shade_core_cuda,
                                        shade_core_torch)
from raytpu_torch.scene.camera import load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.tools.scenes import (build_atrium, write_cube,
                                       write_cube_camera)
from raytpu_torch.types import RenderConfig

ATRIUM_TRIS = 3000
ROW_OUTPUTS = ("p", "scattered", "att_mult", "ldir", "dist", "contrib")


@functools.lru_cache(maxsize=None)
def _cube_files():
    d = tempfile.mkdtemp(prefix="raytpu_torch_shade_")
    glb, cam = os.path.join(d, "cube.glb"), os.path.join(d, "camera.json")
    write_cube(glb)
    write_cube_camera(cam)
    return glb, cam


def _textured(scene):
    """The atrium with two of its materials (stone and floor) textured by
    two checkers of different sizes (RGBA8, no image file)."""
    def checker(h, w, seed):
        g = np.random.default_rng(seed)
        return g.integers(0, 256, (h, w, 4), dtype=np.uint8)

    tex = np.zeros_like(scene.mat_texture)
    has = np.zeros_like(scene.mat_has_texture)
    tex[:2] = [0, 1]
    has[:2] = 1
    return dataclasses.replace(scene, mat_texture=tex, mat_has_texture=has,
                               textures=[checker(8, 8, 1), checker(5, 3, 2)])


@functools.lru_cache(maxsize=None)
def _packed(name: str, device: str):
    """(pack, camera, width, height) of the cube stand-in (1 material, 1
    object, 1 light), a small atrium (7 materials with glass, metal and
    emissive, 26 objects, 3 lights) or that atrium textured."""
    if name == "cube":
        glb, cam = _cube_files()
        return (pack_scene(load_scene(glb), device),
                pack_camera(load_camera_json(cam, 128, 128), device), 128,
                128)
    scene = build_atrium(ATRIUM_TRIS)
    if name == "textured":
        scene = _textured(scene)
    return (pack_scene(scene, device), pack_camera(scene.camera, device), 64,
            36)


def _lanes(name: str, device: str, n: int, seed: int):
    """A wave of ``n`` lanes: half camera rays, half rays from points of
    the scene's box towards other points of it; their closest hits (the
    packet walk); random RNG states; 90% of the hits active."""
    pack, cam, w, h = _packed(name, device)
    g = np.random.default_rng(seed)
    half = n // 2
    px = torch.from_numpy((g.random(half) * w).astype(np.float32))
    py = torch.from_numpy((g.random(half) * h).astype(np.float32))
    o_cam, d_cam = render.cast_rays(px.to(device), py.to(device), cam.world,
                                    cam.projection, w, h)
    lo = pack.scene_bmin.cpu().numpy()
    hi = pack.scene_bmax.cpu().numpy()
    pts = lo + (hi - lo) * g.random((2, n - half, 3))
    d = (pts[1] - pts[0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = torch.cat([o_cam, torch.from_numpy(pts[0].astype(np.float32)
                                            ).to(device)])
    rd = torch.cat([d_cam, torch.from_numpy(d).to(device)])
    closest, _ = make_packet_intersectors(pack)
    hit = closest(ro, rd, 0.001, torch.full((n,), F32_MAX, device=device))
    rng = torch.from_numpy(g.integers(-2**31, 2**31, n).astype(np.int32))
    keep = torch.from_numpy(g.random(n) < 0.9).to(device)
    return pack, ro, rd, hit, rng.to(device), hit.valid & keep


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_kernel_matches(got: dict, want: dict) -> None:
    """The kernel's dict against the plain version's: rng, bounce_on and
    emissive_delta bit-equal on every lane, the other six bit-equal where
    bounce_on holds and zero where it does not."""
    assert list(got) == list(want)
    on = want["bounce_on"]
    assert torch.equal(got["bounce_on"], on)
    assert torch.equal(got["rng"], want["rng"])
    for k in ("emissive_delta",) + ROW_OUTPUTS:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        lanes = slice(None) if k == "emissive_delta" else on
        differ = _bits(g[lanes]) != _bits(w[lanes])
        if differ.dim() > 1:
            differ = differ.any(1)
        assert not differ.any(), (
            f"{k}: {int(differ.sum())} lanes differ, e.g. "
            f"{g[lanes][differ][:3].tolist()} against "
            f"{w[lanes][differ][:3].tolist()}")
        if k != "emissive_delta":
            assert not _bits(g[~on]).any(), f"{k}: a lane off is not zero"


# --- on the CPU ---


def test_shade_core_on_cpu_runs_the_plain_version(monkeypatch):
    pack, ro, rd, hit, rng, active = _lanes("cube", "cpu", 2000, 3)
    want = shade_core_torch(pack, ro, rd, hit, rng, active)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper on CPU tensors")

    monkeypatch.setattr(render, "shade_core_cuda", refuse)
    got = render._shade_core(pack, ro, rd, hit, rng, active)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bool(want["bounce_on"].any())


def test_cuda_wrapper_refuses_cpu_tensors():
    pack, ro, rd, hit, rng, active = _lanes("cube", "cpu", 256, 4)
    before = shade_core_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        shade_core_cuda(pack, ro, rd, hit, rng, active)
    assert shade_core_cuda.launches == before


def _bad(case: str, pack, ro, rd, hit, rng, active):
    """The inputs with one fault planted."""
    if case == "ro float64":
        ro = ro.double()
    elif case == "rd [R, 4]":
        rd = torch.cat([rd, rd[:, :1]], 1)
    elif case == "rd shorter":
        rd = rd[1:]
    elif case == "tri int64":
        hit = hit._replace(tri=hit.tri.long())
    elif case == "rng float32":
        rng = rng.view(torch.float32)
    elif case == "active uint8":
        active = active.to(torch.uint8)
    elif case == "active [R, 1]":
        active = active[:, None]
    elif case == "tri_row not contiguous":
        pack = dataclasses.replace(pack, tri_row=pack.tri_row.t().contiguous()
                                   .t())
    elif case == "tri_row [T, 63]":
        pack = dataclasses.replace(pack, tri_row=pack.tri_row[:, :63])
    elif case == "tri_row not 16-byte aligned":
        flat = torch.empty(pack.tri_row.numel() + 1)
        moved = flat[1:].view_as(pack.tri_row)
        moved.copy_(pack.tri_row)
        pack = dataclasses.replace(pack, tri_row=moved)
    elif case == "light_table float64":
        pack = dataclasses.replace(pack,
                                   light_table=pack.light_table.double())
    elif case == "tex_size int64":
        pack = dataclasses.replace(pack, tex_size=pack.tex_size.long())
    elif case == "n_lights_f [1]":
        pack = dataclasses.replace(pack, n_lights_f=pack.n_lights_f[None])
    return pack, ro, rd, hit, rng, active


@pytest.mark.parametrize("case", [
    "ro float64", "rd [R, 4]", "rd shorter", "tri int64", "rng float32",
    "active uint8", "active [R, 1]", "tri_row not contiguous",
    "tri_row [T, 63]", "tri_row not 16-byte aligned", "light_table float64",
    "tex_size int64", "n_lights_f [1]"])
def test_kernel_inputs_are_checked(case):
    """The wrapper's checks (after the device check, which refuses CPU
    tensors first) raise ValueError on a wrong dtype, shape, layout or
    alignment; the well-formed inputs pass them."""
    lanes = _lanes("cube", "cpu", 256, 5)
    _check_inputs(*lanes)
    with pytest.raises(ValueError):
        _check_inputs(*_bad(case, *lanes))


def test_kernel_inputs_take_strided_rays_and_lanes():
    """Rays of any strides (the primary wave's origin is one expanded
    point) and strided lane vectors pass the checks: the kernel reads
    them through their strides."""
    pack, ro, rd, hit, rng, active = _lanes("cube", "cpu", 256, 6)
    _check_inputs(pack, ro[:1].expand(256, 3), rd.t().contiguous().t(),
                  hit._replace(tri=torch.stack([hit.tri] * 2, 1)[:, 0]),
                  torch.stack([rng] * 2, 1)[:, 1], active)


def test_pack_tables_are_checked_once_per_pack(monkeypatch):
    """The lanes are checked on every call, the pack's tables on the first
    call with that pack only (a frozen pack's tables stay as packed); a
    new pack, here one with a wrong table, is checked again."""
    from raytpu_torch.kernels import shade

    pack, ro, rd, hit, rng, active = _lanes("cube", "cpu", 256, 7)
    _check_inputs(pack, ro, rd, hit, rng, active)
    checked = []
    real = shade._check

    def counted(name, *args, **kwargs):
        checked.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(shade, "_check", counted)
    _check_inputs(pack, ro, rd, hit, rng, active)
    assert checked == ["ro", "rd", "hit.tri", "rng", "active"]
    with pytest.raises(ValueError, match="active"):
        _check_inputs(pack, ro, rd, hit, rng, active.to(torch.uint8))
    bad = dataclasses.replace(pack, light_table=pack.light_table.double())
    with pytest.raises(ValueError, match="light_table"):
        _check_inputs(bad, ro, rd, hit, rng, active)


# --- on the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cube", "atrium", "textured"])
def test_kernel_bit_equal_plain_on_cuda(name):
    """65,613 lanes (not a multiple of the block): every output of the
    kernel against the plain version on the same CUDA tensors, one launch
    a call."""
    _card()
    lanes = _lanes(name, "cuda", 65613, 7)
    before = shade_core_cuda.launches
    got = shade_core_cuda(*lanes)
    assert shade_core_cuda.launches == before + 1
    want = shade_core_torch(*lanes)
    torch.cuda.synchronize()
    _assert_kernel_matches(got, want)
    on = want["bounce_on"]
    assert 0 < int(on.sum()) < on.shape[0]
    if name != "cube":  # every material kind is shaded
        assert bool((want["emissive_delta"] > 0).any())


@pytest.mark.cuda
def test_kernel_edge_cases_on_cuda():
    """No lanes (nothing launched), every lane inactive (RNG kept, every
    output zero), strided inputs (an expanded origin, rows and lanes at a
    stride of 2) and a tier slice ``x[:p]`` of a wider wave, each against
    the plain version."""
    _card()
    pack, ro, rd, hit, rng, active = _lanes("atrium", "cuda", 8192, 8)
    before = shade_core_cuda.launches
    none = shade_core_cuda(pack, ro[:0], rd[:0], Hit(*(x[:0] for x in hit)),
                           rng[:0], active[:0])
    assert shade_core_cuda.launches == before
    assert {k: tuple(v.shape) for k, v in none.items()} == dict(
        rng=(0,), p=(0, 3), scattered=(0, 3), att_mult=(0, 4), bounce_on=(0,),
        emissive_delta=(0, 4), ldir=(0, 3), dist=(0,), contrib=(0, 4))

    off = torch.zeros_like(active)
    got = shade_core_cuda(pack, ro, rd, hit, rng, off)
    _assert_kernel_matches(got, shade_core_torch(pack, ro, rd, hit, rng, off))
    assert torch.equal(got["rng"], rng) and not bool(got["bounce_on"].any())
    assert not _bits(got["emissive_delta"]).any()

    wide = {k: torch.stack([x, x], 1) for k, x in dict(
        tri=hit.tri, rng=rng, active=active).items()}
    strided = (pack, ro[:1].expand(ro.shape[0], 3),
               torch.cat([rd, rd], 1)[:, 3:],
               hit._replace(tri=wide["tri"][:, 1]), wide["rng"][:, 0],
               wide["active"][:, 1])
    assert not strided[2].is_contiguous()
    _assert_kernel_matches(shade_core_cuda(*strided),
                           shade_core_torch(*strided))

    p = 8192 - 1024 - 256
    tier = (pack, ro[:p], rd[:p], Hit(*(x[:p] for x in hit)), rng[:p],
            active[:p])
    _assert_kernel_matches(shade_core_cuda(*tier), shade_core_torch(*tier))
    torch.cuda.synchronize()


FRAMES = {
    "cube": ("cube", dict(width=128, height=128, samples=4, bounces=4,
                          chunk_size=64), {}),
    "atrium": ("atrium", dict(width=64, height=36, samples=2, bounces=4,
                              chunk_size=8), {}),
    "atrium fused": ("atrium", dict(width=64, height=36, samples=1,
                                    bounces=4, chunk_size=8),
                     {"RAYTPU_LARGE_WAVE": "1"}),
    "atrium deferred NEE": ("atrium", dict(width=64, height=36, samples=1,
                                           bounces=4, chunk_size=8,
                                           bounce_backend="mixed"), {}),
    "textured": ("textured", dict(width=64, height=36, samples=1,
                                  bounces=3, chunk_size=8), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_bit_equal_plain_on_cuda(frame, monkeypatch):
    """A frame rendered on the card through the kernel is bit-equal to
    the same frame with ``_shade_core`` sent to the plain version: the
    zeros the kernel writes where bounce_on is false reach no pixel (the
    query, fused and deferred-NEE schedules)."""
    _card()
    name, cfg, environ = FRAMES[frame]
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    pack, cam, _, _ = _packed(name, "cuda")
    config = RenderConfig(seed=5, **cfg)
    before = shade_core_cuda.launches
    got = render.render_frame(pack, cam, config)
    assert shade_core_cuda.launches > before
    monkeypatch.setattr(render, "shade_core_cuda", shade_core_torch)
    want = render.render_frame(pack, cam, config)
    assert (want > 0).any()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
