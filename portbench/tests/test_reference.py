"""The plain reference against the program's CPU render of a tiny atrium
frame: pixel for pixel in float32, and the bfloat16 control rejected."""

import numpy as np
import pytest
import torch

from portbench.harness import check, port, spec
from portbench.reference import tracer
from portbench.reference.world import World
from portbench.scenes import atrium

W, H = 64, 36


@pytest.fixture(scope="module")
def scene():
    arrays = atrium.build_atrium(5000)
    pack, cam, _ = port.pack(arrays, "cpu", {"tables": "auto"})
    return arrays, pack, cam


def _frame(scene, mode, seed, bounces):
    arrays, pack, cam = scene
    t = {"mode": mode, "width": W, "height": H, "samples": 1,
         "bounces": bounces, "chunk": 8}
    img = port.render(pack, cam, port.config(t, seed))
    ys, xs = np.mgrid[0:H, 0:W]
    return img[ys.ravel(), xs.ravel()], xs.ravel(), ys.ravel(), t


@pytest.mark.parametrize("mode,seed,bounces", [
    ("path", 1, 4), ("path", 3_000_000_017, 4), ("path", 77, 2),
    ("flat", 1, 1), ("flat", 3_000_000_017, 1),
])
def test_reference_equals_the_programs_cpu_frame(scene, mode, seed,
                                                 bounces):
    got, xs, ys, t = _frame(scene, mode, seed, bounces)
    ref = tracer.render_lanes(
        World(scene[0], "cpu"), xs, ys, np.full(xs.shape, seed), width=W,
        height=H, chunk=8, samples=1, bounces=bounces, mode=mode)
    assert (np.abs(ref).sum(axis=1) > 0).mean() > 0.5  # a lit frame
    assert check.diverged_pct(got, ref) == 0.0
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode", ["path", "flat"])
def test_bfloat16_control_is_rejected(scene, mode):
    got, xs, ys, t = _frame(scene, mode, 5, 4 if mode == "path" else 1)
    kw = dict(width=W, height=H, chunk=8, samples=1, bounces=t["bounces"],
              mode=mode)
    seeds = np.full(xs.shape, 5)
    ref = tracer.render_lanes(World(scene[0], "cpu"), xs, ys, seeds, **kw)
    low = tracer.render_lanes(World(scene[0], "cpu", torch.bfloat16), xs,
                              ys, seeds, **kw)
    limit = spec.Spec().limits(f"atrium300k.{mode}1080")["diverged_pct"][
        "limit"]
    assert check.diverged_pct(low, ref) > 3 * limit


def test_rng_and_grid_rules():
    def murmur(k):  # the shader's mix in Python integers
        k = (k * 0xCC9E2D51) & 0xFFFF_FFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFF_FFFF
        return (k * 0x1B873593) & 0xFFFF_FFFF

    keys = [0, 1, 12345, 0xFFFF_FFFF, 0x8000_0001]
    new, v = tracer.rand(torch.tensor(keys), torch.float32)
    assert new.tolist() == [murmur(k) for k in keys]
    want = [np.frombuffer(np.uint32(0x3F80_0000 | murmur(k) >> 9).tobytes(),
                          np.float32)[0] - np.float32(1) for k in keys]
    assert v.tolist() == [float(x) for x in want]
    kept, _ = tracer.rand(torch.tensor([7, 8]), torch.float32,
                          torch.tensor([True, False]))
    assert kept.tolist() == [murmur(7), 8]
    # (lx+1)(ly+1)(chunk+1) seed mod 2^32
    s = tracer.seed_lanes([9], [2], [0xFFFF_FFFF + 8], width=16, chunk=8)
    assert int(s[0]) == (2 * 3 * 2 * 7) & 0xFFFF_FFFF
    assert tracer.in_chunk_grid([15, 16], [0, 0], 20, 4, 8).tolist() == [
        True, False]


@pytest.mark.parametrize("got,ref,want", [
    ([[1.0, 2.0, 0.0, 0.0]], [[1.0, 2.0, 0.0, 0.0]], 0.0),
    ([[1.0 + 5e-6, 2.0, 0.0, 0.0]], [[1.0, 2.0, 0.0, 0.0]], 0.0),
    ([[1.0 + 5e-5, 2.0, 0.0, 0.0]], [[1.0, 2.0, 0.0, 0.0]], 100.0),
    ([[np.nan, 0, 0, 0], [1, 0, 0, 0]], [[np.nan, 0, 0, 0], [np.nan, 0, 0, 0]],
     50.0),
])
def test_diverged_pct(got, ref, want):
    assert check.diverged_pct(np.asarray(got, np.float32),
                              np.asarray(ref, np.float32)) == want


def test_bvh_walk_gives_the_sweeps_answers(scene):
    brute = World(scene[0], "cpu")
    tree = World(scene[0], "cpu", tree=True)
    g = torch.Generator().manual_seed(0)
    n = 6000
    ro = torch.rand(n, 3, generator=g) * torch.tensor([28.0, 8.0, 13.0]) \
        - torch.tensor([14.0, 0.0, 6.5])
    rd = torch.randn(n, 3, generator=g)
    rd[::7, 1] = 0.0  # directions along a box face
    tmax = torch.full((n,), tracer.F32_MAX)
    tmax[::5] = float("-inf")  # dead lanes
    a, b = (tracer.sweep(w, ro, rd, 0.001, tmax) for w in (brute, tree))
    assert a[2].sum() > n // 3
    assert torch.equal(a[2], b[2]) and torch.equal(a[0], b[0])
    assert torch.equal(a[1][a[2]], b[1][a[2]])
    dist = torch.rand(n, generator=g) * 10
    assert torch.equal(tracer.sweep(brute, ro, rd, 0.0, dist, any_hit=True),
                       tracer.sweep(tree, ro, rd, 0.0, dist, any_hit=True))


@pytest.mark.parametrize("mode,seed,w,h", [
    ("path", 1, 64, 36), ("path", 3_000_000_017, 96, 40),
    ("flat", 5, 64, 36)])
def test_query_count_equals_the_programs_count(scene, mode, seed, w, h):
    from raytpu_torch.engine.render import count_rays

    arrays, pack, cam = scene
    t = {"mode": mode, "width": w, "height": h, "samples": 1,
         "bounces": 4 if mode == "path" else 1, "chunk": 8}
    world = World(arrays, "cpu", tree=True)
    got = tracer.count_queries(world, [seed], **t)
    if mode == "flat":  # primaries only; the program counts paths always
        assert got == w * h
    else:
        assert got == count_rays(pack, cam, port.config(t, seed))
    # every query pops the root at the least; a hit tests a triangle
    assert world.tree.box_tests >= got
    assert 0 < int(world.tree.tri_tests) < world.tree.box_tests * 8
