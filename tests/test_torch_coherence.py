"""The coherence sort key (``raytpu_torch/kernels/coherence.py``): on the
CPU, ``render._ray_sort_key`` runs the plain version, which interleaves
the origin's cell bits as a Morton code under the direction's octant,
never loads the kernel's library, and is built once a sorted query with
RAYTPU_MORTON_BITS read once; on the card (``cuda`` marker)
``csrc/coherence_key.cu`` is bit-equal to the plain version run on the
same CUDA tensors, for every bit width and for the fused loop's int64
composite, over origins inside, on and far outside the scene's box,
non-finite directions, dead lanes, a flat box and strided rows, and whole
frames rendered through it are bit-equal to frames rendered through the
plain version.

Nothing here imports JAX or raytpu: on a machine with the card,
``python -m pytest --noconftest tests/test_torch_coherence.py -m cuda``."""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from raytpu_torch.engine import render
from raytpu_torch.kernels import _build, coherence
from raytpu_torch.kernels.coherence import (coherence_key_cuda,
                                            coherence_key_torch, dead_key)
from raytpu_torch.scene.camera import load_camera_json
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.tools.scenes import (build_atrium, write_cube,
                                       write_cube_camera)
from raytpu_torch.types import RenderConfig

ATRIUM_TRIS = 3000
BOXES = {
    "box": ([-12.5, -0.25, -30.0], [14.0, 20.0, 31.5]),
    "flat axis": ([-3.0, 2.0, -1.0], [5.0, 2.0, 7.0]),  # ext[1] -> 1e-6
}
# a 64x36 atrium frame, one tile and one sample: 4 bounces, every one with
# live lanes
FRAME = dict(width=64, height=36, seed=5, samples=1, bounces=4, chunk_size=8)


def _lanes(n: int, seed: int, box: str, device, finite: bool = False):
    """(ro, rd, alive, bmin, bmax, pxi) of ``n`` lanes: origins inside the
    box and around it, on its faces and on cell edges, far outside (the
    int conversion saturates) and non-finite; directions with -0.0, +0.0,
    +-inf and NaN components; ~20% of lanes dead; a shuffled pixel index.
    ``finite`` keeps origins within ten extents of the box."""
    g = np.random.default_rng(seed)
    lo, hi = (np.asarray(v, np.float32) for v in BOXES[box])
    ext = np.maximum(hi - lo, np.float32(1e-6))
    ro = (lo + (hi - lo) * g.uniform(-0.25, 1.25, (n, 3))).astype(np.float32)
    kind = g.integers(0, 6 if not finite else 4, (n, 3))
    faces = np.where(g.random((n, 3)) < 0.5, lo, hi)
    edges = lo + ext * (g.integers(0, 65, (n, 3)) / np.float32(64.0))
    wide = lo + ext * g.uniform(-10.0, 10.0, (n, 3))
    far = g.choice(np.array([1e30, -1e30, 3e9, -3e9, 2.2e9, 1e20],
                            np.float32), (n, 3))
    odd = g.choice(np.array([np.inf, -np.inf, np.nan], np.float32), (n, 3))
    for k, v in enumerate((faces, edges, wide, far, odd)):
        ro = np.where(kind == k + 1, v, ro).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    special = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], np.float32)
    pick = g.random((n, 3)) < 0.15
    rd = np.where(pick, g.choice(special, (n, 3)), rd).astype(np.float32)
    alive = g.random(n) < 0.8
    pxi = g.permutation(n).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (t(ro), t(rd), t(alive), t(lo), t(hi), t(pxi))


def _interleaved(ro, rd, alive, lo, hi, bits: int) -> np.ndarray:
    """The key lane by lane, bit by bit (no Part1By2): the cell of each
    axis in float32 steps, its bit i at 3i + axis, the octant above."""
    ext = np.maximum(hi - lo, np.float32(1e-6))
    cells = np.float32(1 << bits)
    q = np.clip((((ro - lo) / ext) * cells).astype(np.int64), 0,
                (1 << bits) - 1)
    out = np.zeros(ro.shape[0], np.int64)
    for i in range(bits):
        for axis in range(3):
            out |= ((q[:, axis] >> i) & 1) << (3 * i + axis)
    for axis in range(3):
        out |= (rd[:, axis] < 0).astype(np.int64) << (3 * bits + axis)
    return np.where(alive, out, 1 << (3 * bits + 3))


@functools.lru_cache(maxsize=None)
def _atrium(device: str):
    scene = build_atrium(ATRIUM_TRIS)
    return pack_scene(scene, device), pack_camera(scene.camera, device)


@functools.lru_cache(maxsize=None)
def _cube(device: str):
    d = tempfile.mkdtemp(prefix="raytpu_torch_coherence_")
    glb, cam = os.path.join(d, "cube.glb"), os.path.join(d, "camera.json")
    write_cube(glb)
    write_cube_camera(cam)
    return (pack_scene(load_scene(glb), device),
            pack_camera(load_camera_json(cam, 64, 36), device))


def _counting(monkeypatch, name: str):
    """Wrap ``render.<name>`` to count its calls; returns the list of
    each call's ``pxi is not None``."""
    calls, fn = [], getattr(render, name)

    def counted(*a):
        calls.append(a[6] is not None)
        return fn(*a)

    monkeypatch.setattr(render, name, counted)
    return calls


# --- on the CPU ---


@pytest.mark.parametrize("bits", range(1, 10))
def test_plain_key_is_octant_over_morton(bits):
    """The plain version against a bit-by-bit interleave of the cells."""
    ro, rd, alive, lo, hi, pxi = _lanes(20000, bits, "box", "cpu",
                                        finite=True)
    got = coherence_key_torch(ro, rd, alive, lo, hi, bits)
    assert got.dtype == torch.int32
    want = _interleaved(*(x.numpy() for x in (ro, rd, alive, lo, hi)), bits)
    assert np.array_equal(got.numpy(), want)
    assert int(got.max()) == dead_key(bits)
    assert int(got[alive].max()) < dead_key(bits)


def test_plain_composite_key_is_key_then_pixel():
    ro, rd, alive, lo, hi, pxi = _lanes(20000, 3, "flat axis", "cpu")
    key = coherence_key_torch(ro, rd, alive, lo, hi, 6)
    both = coherence_key_torch(ro, rd, alive, lo, hi, 6, pxi)
    assert both.dtype == torch.int64
    assert torch.equal(both >> 32, key.long())
    assert torch.equal(both & 0xFFFFFFFF, pxi.long())
    assert torch.unique(both).numel() == both.numel()


def test_sort_key_reads_the_variable(monkeypatch):
    """RAYTPU_MORTON_BITS keeps its meaning: 6 unset, at most 9."""
    pack, _ = _atrium("cpu")
    ro, rd, alive, *_ = _lanes(512, 1, "box", "cpu")
    for value, bits in ((None, 6), ("3", 3), ("12", 9)):
        if value is None:
            monkeypatch.delenv("RAYTPU_MORTON_BITS", raising=False)
        else:
            monkeypatch.setenv("RAYTPU_MORTON_BITS", value)
        key = render._ray_sort_key(pack, ro, rd, alive)
        assert torch.equal(key, coherence_key_torch(
            ro, rd, alive, pack.scene_bmin, pack.scene_bmax, bits))
        assert int(key.max()) == dead_key(bits)


def test_sorted_query_reads_the_bits_once(monkeypatch):
    pack, _ = _atrium("cpu")
    ro, rd, alive, *_ = _lanes(512, 2, "box", "cpu")
    reads = []
    monkeypatch.setattr(render, "_morton_bits", lambda: reads.append(1) or 4)
    keys = _counting(monkeypatch, "coherence_key_torch")
    seen = []

    def query(o, d, tmin, tmax):
        seen.append(tmax)
        n = o.shape[0]
        tri = torch.where(tmax > 0, 0, -1).to(torch.int32)
        return render.Hit(t=torch.zeros(n), tri=tri, valid=tri >= 0)

    hit = render._sorted_query(query, pack, ro, rd, 0.001, None, alive, True)
    assert reads == [1] and keys == [False]
    # dead lanes sort last with a bound of -inf, at bits 4's dead key
    n_live = int(alive.sum())
    assert bool((seen[0][:n_live] > 0).all())
    assert bool((seen[0][n_live:] == float("-inf")).all())
    assert torch.equal(hit.valid, alive)


@pytest.mark.parametrize("large_wave,composites", [(str(1 << 30), 0),
                                                   ("1", 3)])
def test_cpu_frame_never_loads_the_library(monkeypatch, large_wave,
                                           composites):
    """A 4-bounce atrium frame on the CPU in query and fused mode: 7 keys
    (the first shadow wave, then a closest and a shadow query a bounce, or
    the fused loop's composite and its shadow query), each from the plain
    version with the bits read once, and no library loaded."""
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", large_wave)

    def refuse(*a, **k):
        raise AssertionError("the key kernel on the CPU")

    monkeypatch.setattr(coherence, "_library", refuse)
    monkeypatch.setattr(render, "coherence_key_cuda", refuse)
    reads, bits = [], render._morton_bits
    monkeypatch.setattr(render, "_morton_bits",
                        lambda: reads.append(1) or bits())
    keys = _counting(monkeypatch, "coherence_key_torch")
    loads = dict(_build.LOADS)
    pack, cam = _atrium("cpu")
    frame = render.render_frame(pack, cam, RenderConfig(**FRAME))
    assert render.WAVE_STATS["mode"] == ("fused" if composites else "query")
    assert len(render.WAVE_STATS["widths"]) == 4
    assert len(keys) == 7 and sum(keys) == composites
    assert len(reads) == 7
    assert _build.LOADS == loads
    assert (frame > 0).any()


def test_cuda_wrapper_refuses_cpu_tensors():
    ro, rd, alive, lo, hi, pxi = _lanes(256, 4, "box", "cpu")
    before = coherence_key_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        coherence_key_cuda(ro, rd, alive, lo, hi, 6)
    assert coherence_key_cuda.launches == before


# --- on the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    differ = got != want
    assert not differ.any(), (
        f"{int(differ.sum())} lanes differ, e.g. {got[differ][:3].tolist()} "
        f"against {want[differ][:3].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("composite", [False, True],
                         ids=["key", "composite"])
@pytest.mark.parametrize("bits", range(1, 10))
def test_kernel_bit_equal_plain_on_cuda(bits, composite):
    """100,003 lanes (not a multiple of the block) in a box and in a box
    with a flat axis, contiguous, as a prefix of a wider wave (the fused
    loop's ``state["ro"][:wsz]``) and at strides of 2 rows and lanes:
    every key of the kernel against the plain version, one launch a
    call."""
    _card()
    n = 100003
    for box in BOXES:
        ro, rd, alive, lo, hi, pxi = _lanes(n + 4096, 10 * bits + 1, box,
                                            "cuda")
        wave = [x[:n] for x in (ro, rd, alive)] + [lo, hi, pxi[:n]]
        wide = [torch.cat([x, x], -1)[..., 3:] if x.dim() == 2
                else torch.stack([x, x], 1)[:, 1] for x in (ro, rd, alive)]
        strided = wide + [lo, hi, torch.stack([pxi, pxi], 1)[:, 0]]
        assert not strided[0].is_contiguous()
        assert not strided[2].is_contiguous()
        for lanes in (wave, strided):
            args = lanes[:5] + [bits, lanes[5] if composite else None]
            before = coherence_key_cuda.launches
            got = coherence_key_cuda(*args)
            assert coherence_key_cuda.launches == before + 1
            want = coherence_key_torch(*args)
            torch.cuda.synchronize()
            _assert_same(got, want)
            key = (got >> 32) if composite else got
            # every kind of lane is there: dead, and live in several cells
            assert int((key == dead_key(bits)).sum()) > 0
            assert torch.unique(key).numel() > 8


@pytest.mark.cuda
def test_kernel_zero_lanes_launch_nothing_on_cuda():
    _card()
    ro, rd, alive, lo, hi, pxi = _lanes(1024, 5, "box", "cuda")
    before = coherence_key_cuda.launches
    for p in (None, pxi[:0]):
        got = coherence_key_cuda(ro[:0], rd[:0], alive[:0], lo, hi, 6, p)
        assert got.shape == (0,)
        assert got.dtype == (torch.int32 if p is None else torch.int64)
    assert coherence_key_cuda.launches == before
    with pytest.raises(ValueError, match="alive"):
        coherence_key_cuda(ro, rd, alive.to(torch.uint8), lo, hi, 6)
    with pytest.raises(ValueError, match="bits"):
        coherence_key_cuda(ro, rd, alive, lo, hi, 10)
    assert coherence_key_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("large_wave", [str(1 << 30), "1"],
                         ids=["query", "fused"])
def test_frame_bit_equal_plain_on_cuda(large_wave, monkeypatch):
    """An atrium frame rendered on the card through the kernel is
    bit-equal to the same frame with the key sent to the plain version,
    in query and in fused mode."""
    _card()
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", large_wave)
    pack, cam = _atrium("cuda")
    config = RenderConfig(**FRAME)
    before = coherence_key_cuda.launches
    got = render.render_frame(pack, cam, config)
    assert coherence_key_cuda.launches == before + 7
    monkeypatch.setattr(render, "coherence_key_cuda", coherence_key_torch)
    want = render.render_frame(pack, cam, config)
    assert coherence_key_cuda.launches == before + 7
    assert (want > 0).any()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case,launches", [("sorted", 7), ("flat", 0),
                                           ("packet route", 0)])
def test_key_launches_a_frame_on_cuda(case, launches, monkeypatch):
    """A 4-bounce query-mode frame of the sorted strand route launches
    the key kernel 7 times; flat mode and the packet route's path mode
    (the cube: 24 slots, no sorts) launch it never."""
    _card()
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", str(1 << 30))
    pack, cam = _cube("cuda") if case == "packet route" else _atrium("cuda")
    config = RenderConfig(**FRAME, mode="flat" if case == "flat" else "path")
    before = coherence_key_cuda.launches
    render.render_frame(pack, cam, config)
    torch.cuda.synchronize()
    assert coherence_key_cuda.launches - before == launches
    if case == "sorted":
        assert len(render.WAVE_STATS["widths"]) == 4
