"""The threaded-BVH route (``intersector="bvh"``): raytpu_torch's
``intersect_bvh`` and ``make_intersectors`` against raytpu's, and its
frames against raytpu's ``bvh`` frames, on the CPU.

raytpu computes this walk in XLA, so both sides walk the same tables
with the same contract (first slot visited on ties, the unrepaired box
test, raw slots): ``tri`` and the any-hit bit must be equal on every ray.
``t`` is held to rtol 1e-4, the port's CPU bar against XLA, which
contracts multiply-adds into FMAs. Frames are compared as PNG pixels
with tests/imgdiff.py's bar, as in tests/test_torch_render.py."""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.kernels import intersect as rt_intersect
from raytpu.scene.pack import pack_camera as rt_pack_camera
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from raytpu_torch.engine import render
from raytpu_torch.kernels import intersect
from raytpu_torch.scene.camera import camera_from_lookat
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_host import AT, EYE, FOV, _soup, scene_path

F32_MAX = np.float32(3.40282347e38)


def _soup_tables(ntri):
    """The pack's node and leaf rows for a random soup, built as
    ``pack_scene`` builds them, and the slot -> triangle map."""
    p0, e1, e2 = _soup(ntri, seed=3)
    bvh, _ = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    nodes = np.zeros((bvh.n_nodes, 8), np.float32)
    nodes[:, 0:3] = bvh.bmin
    nodes[:, 3:6] = bvh.bmax
    nodes[:, 6] = bvh.miss.astype(np.int32).view(np.float32)
    leaf_row = np.where(bvh.leaf_first >= 0, bvh.leaf_first // LEAF_SIZE, -1)
    nodes[:, 7] = leaf_row.astype(np.int32).view(np.float32)
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    return nodes, per.reshape(-1, 10 * LEAF_SIZE), order


@functools.lru_cache(maxsize=None)
def _tables(which):
    """(nodes, leaf rows) as numpy, the box the rays start in."""
    if which == "soup":
        nodes, leaves, order = _soup_tables(3000)
        # spatial splits store some triangles in several slots
        assert (np.bincount(order[order >= 0]) > 1).any()
        return nodes, leaves, 8.0
    pack = pack_scene(load_scene(scene_path("gallery")), "cpu")
    assert pack.n_triangles > 2048
    return pack.bvh.nodes.numpy(), pack.bvh.leaf_tris.numpy(), 12.0


def _rays(n, span, seed):
    r = np.random.default_rng(seed)
    ro = (r.random((n, 3), np.float32) - 0.5) * np.float32(span)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::11, 0] = 0.0
    rd[5::13, 1] = -0.0
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[::7] = -np.inf  # dead lanes
    tmax[3::9] = 2.5  # finite closest-hit bounds
    return ro, rd, tmax


@pytest.mark.parametrize("which", ["gallery", "soup"])
def test_intersect_bvh_matches_raytpu(which):
    nodes, leaves, span = _tables(which)
    ro, rd, tmax = _rays(1500, span, seed=len(which))
    port = SimpleNamespace(nodes=torch.from_numpy(nodes),
                           leaf_tris=torch.from_numpy(leaves))
    ref = SimpleNamespace(nodes=jnp.asarray(nodes),
                          leaf_tris=jnp.asarray(leaves))
    t_ro, t_rd, t_tmax = map(torch.from_numpy, (ro, rd, tmax))
    got = intersect.intersect_bvh(t_ro, t_rd, port, 0.001, t_tmax)
    want = rt_intersect.intersect_bvh(jnp.asarray(ro), jnp.asarray(rd), ref,
                                      0.001, jnp.asarray(tmax))
    tri = got.tri.numpy()
    assert got.tri.dtype == torch.int32 and 0.2 < (tri >= 0).mean() < 0.9
    np.testing.assert_array_equal(tri, np.asarray(want.tri))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-4)
    shadow = np.full(1500, 3.0, np.float32)
    shadow[::5] = -np.inf
    blocked = intersect.intersect_bvh(t_ro, t_rd, port, 0.0,
                                      torch.from_numpy(shadow), any_hit=True)
    want_b = rt_intersect.intersect_bvh(jnp.asarray(ro), jnp.asarray(rd), ref,
                                        0.0, jnp.asarray(shadow), any_hit=True)
    assert blocked.dtype == torch.bool and 0.1 < blocked.float().mean() < 0.9
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(want_b))
    # a scalar tmax and no rays
    scalar = intersect.intersect_bvh(t_ro, t_rd, port, 0.001, float(F32_MAX))
    live = tmax == F32_MAX
    np.testing.assert_array_equal(scalar.tri.numpy()[live], tri[live])
    empty = intersect.intersect_bvh(t_ro[:0], t_rd[:0], port, 0.001, t_tmax[:0])
    assert empty.tri.shape == (0,)


def test_safe_inv_dir_and_slab_match_raytpu():
    rd = np.array([[0.0, -0.0, 1.0], [2.0, -4.0, 0.5]], np.float32)
    np.testing.assert_array_equal(
        intersect.safe_inv_dir(torch.from_numpy(rd)).numpy(),
        np.asarray(rt_intersect.safe_inv_dir(jnp.asarray(rd))))
    r = np.random.default_rng(4)
    bmin = r.normal(size=(500, 3)).astype(np.float32)
    bmax = bmin + r.random((500, 3), np.float32)
    ro = r.normal(size=(500, 3)).astype(np.float32) * 2
    # aimed near each box's centre, so about half the rays pass through
    rd = (bmin + bmax) / 2 - ro + r.normal(size=(500, 3)) * 0.4
    inv = (1.0 / rd).astype(np.float32)
    tmax = (r.random(500) * 3).astype(np.float32)
    got = intersect._slab_test(*map(torch.from_numpy, (bmin, bmax, ro, inv)),
                               torch.tensor(0.001), torch.from_numpy(tmax))
    want = rt_intersect._slab_test(*map(jnp.asarray, (bmin, bmax, ro, inv)),
                                   0.001, jnp.asarray(tmax))
    assert 0.1 < got.float().mean() < 0.9
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _packs(name):
    cam = camera_from_lookat(EYE, AT, FOV, 48, 32)
    return ((pack_scene(load_scene(scene_path(name)), "cpu"),
             pack_camera(cam, "cpu")),
            (rt_pack_scene(raytpu.load_scene(scene_path(name))),
             rt_pack_camera(raytpu.camera_from_lookat(EYE, AT, FOV, 48, 32))))


@pytest.mark.parametrize("name,mode", [("gallery", "path"),
                                       ("small", "path"),
                                       ("gallery", "flat")])
def test_bvh_frame_matches_raytpu_bvh_frame(name, mode):
    """The route through the engine: row-order waves, no coherence sorts
    (``packet_mode`` False), raytpu's ``intersector="bvh"`` frame."""
    (pack, cam), (rpack, rcam) = _packs(name)
    cfg = dict(width=48, height=32, seed=7, samples=1, bounces=3,
               chunk_size=16, mode=mode, intersector="bvh")
    port = render.render_frame(pack, cam, RenderConfig(**cfg))
    ref = rt_render.render_frame(rpack, rcam, raytpu.RenderConfig(**cfg))
    assert port.shape == (32, 48, 4) and np.isfinite(port).all()
    assert (quantize_rgba32f(port).max(-1) > 0).mean() > 0.5
    assert_images_equiv(quantize_rgba32f(port) / 255.0,
                        quantize_rgba32f(ref) / 255.0)
    route = render._route(pack, RenderConfig(**cfg))
    assert route[2:] == (False, False, None, None)


def test_bvh_route_refuses_a_pack_without_leaf_rows():
    """raytpu's error, word for word, for a stream pack that dropped the
    leaf rows (no strand tree at <= 256 slots); "brute" still runs."""
    pack = pack_scene(load_scene(scene_path("small")), "cpu",
                      tables="stream")
    assert pack.bvh.leaf_tris is None
    with pytest.raises(ValueError) as got:
        intersect.make_intersectors(pack, which="bvh")
    bare = SimpleNamespace(tri_p0=np.zeros((4096, 3), np.float32),
                           bvh=SimpleNamespace(leaf_tris=None))
    with pytest.raises(ValueError) as want:
        rt_intersect.make_intersectors(bare, which="auto")
    assert str(got.value) == str(want.value)
    cam = pack_camera(camera_from_lookat(EYE, AT, FOV, 16, 8), "cpu")
    cfg = dict(width=16, height=8, seed=1, samples=1, bounces=1,
               chunk_size=8)
    with pytest.raises(ValueError, match="tables='stream'"):
        render.render_tile(pack, cam, 0,
                           RenderConfig(**cfg, intersector="bvh"), 8)
    frame = render.render_tile(pack, cam, 0,
                               RenderConfig(**cfg, intersector="brute"), 8)
    assert frame.shape == (8, 16, 4)


@pytest.mark.parametrize("which,limit,want", [
    ("auto", 2048, "intersect_bvh"), ("auto", 4096, "intersect_bruteforce"),
    ("brute", 0, "intersect_bruteforce"), ("bvh", 1 << 20, "intersect_bvh")])
def test_make_intersectors_chooses_as_raytpu(monkeypatch, which, limit,
                                             want):
    """raytpu's rule: "brute", or "auto" at <= bruteforce_max_tris slots,
    is the sweep; anything else the walk (the gallery has 4096 slots)."""
    (pack, _), _ = _packs("gallery")
    calls = []
    for name in ("intersect_bvh", "intersect_bruteforce",
                 "intersect_any_bruteforce"):
        fn = getattr(intersect, name)
        monkeypatch.setattr(
            intersect, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    closest, any_hit = intersect.make_intersectors(
        pack, bruteforce_max_tris=limit, which=which)
    ro = torch.tensor([[0.0, 2.5, -9.0]])
    rd = torch.tensor([[0.0, -0.3, 0.95]])
    hit = closest(ro, rd, 0.001, float(F32_MAX))
    any_hit(ro, rd, 0.0, torch.tensor([1.0]))
    assert calls[0] == want
    assert bool(hit.valid[0])
