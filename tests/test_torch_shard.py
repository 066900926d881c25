"""raytpu_torch.parallel.shard on CPU devices: row shards against
``render_frame`` within raytpu's own bar (tests/test_parallel.py: rtol
2e-6, atol 1e-7), uneven rows, spp shards (decorrelated seeds: the mean
within 0.05 of the single frame) and one spp shard's tile against
raytpu's ``render_tile`` at the same wrapped seed, one host thread per
distinct device (``"cpu"`` and ``"cpu:0"`` are two devices to the pool)
with a shard's error raised to the caller, and ``make_devices``' refusal
when too few CUDA devices exist."""

import functools
import threading
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.scene.pack import pack_camera as rt_pack_camera
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.engine import render
from raytpu_torch.parallel import shard
from raytpu_torch.scene.camera import camera_from_lookat
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_host import AT, EYE, FOV, scene_path


@functools.lru_cache(maxsize=None)
def _packed(name, w, h):
    return (pack_scene(load_scene(scene_path(name)), "cpu"),
            pack_camera(camera_from_lookat(EYE, AT, FOV, w, h), "cpu"))


def _close(sharded, single, label):
    print(f"{label}: bit-equal {np.array_equal(sharded, single)}")
    assert sharded.shape == single.shape and sharded.dtype == np.float32
    np.testing.assert_allclose(sharded, single, rtol=2e-6, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _single():
    pack, cam = _packed("gallery", 32, 16)
    cfg = RenderConfig(width=32, height=16, seed=1, samples=1, bounces=2,
                       chunk_size=16)
    return pack, cam, cfg, render.render_frame(pack, cam, cfg)


@pytest.mark.parametrize("n,tiles", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_row_shards_match_single_device(n, tiles):
    """The gallery (strand route) over n CPU shards, each rendering
    ``tiles`` round-robin tiles."""
    pack, cam, cfg, single = _single()
    assert (single[..., :3].max(-1) > 0).mean() > 0.5
    _close(shard.render_frame_sharded(pack, cam, cfg, devices=["cpu"] * n,
                                      tiles_per_shard=tiles),
           single, f"rows x{n}, {tiles} tile(s) each")


def test_distinct_devices_run_on_their_own_threads(monkeypatch):
    """Two distinct device names, two row shards each: each device's
    shards run in turn on one worker thread of its own, and the frame
    matches the single one."""
    pack, cam, cfg, single = _single()
    threads = {}
    real = shard.render_tile

    def spy(p, c, y0, cf, h, seed):
        # one replica of the scene per device
        threads.setdefault(id(p), []).append(threading.get_ident())
        return real(p, c, y0, cf, h, seed=seed)

    monkeypatch.setattr(shard, "render_tile", spy)
    _close(shard.render_frame_sharded(
        pack, cam, cfg, devices=["cpu", "cpu:0", "cpu", "cpu:0"]),
        single, "rows x4 over 2 device names")
    assert len(threads) == 2
    ids = [set(ts) for ts in threads.values()]
    assert [len(ts) for ts in threads.values()] == [2, 2]
    assert all(len(i) == 1 for i in ids) and ids[0] != ids[1]
    assert threading.get_ident() not in ids[0] | ids[1]


def test_a_shards_error_reaches_the_caller(monkeypatch):
    pack, cam, cfg, _ = _single()
    real = shard.render_tile

    def fail_second(p, c, y0, cf, h, seed):
        if y0 > 0:
            raise RuntimeError(f"shard at row {y0} failed")
        return real(p, c, y0, cf, h, seed=seed)

    monkeypatch.setattr(shard, "render_tile", fail_second)
    with pytest.raises(RuntimeError, match="shard at row 8 failed"):
        shard.render_frame_sharded(pack, cam, cfg, devices=["cpu", "cpu:0"])


def test_uneven_rows_pad_correctly(monkeypatch):
    """H 20 over 8 shards: 3 rows each, 24 rendered, cut to 20; shard s
    renders rows 3s..3s+2."""
    pack, cam = _packed("gallery", 32, 20)
    cfg = RenderConfig(width=32, height=20, seed=1, samples=1, bounces=2,
                       chunk_size=4)
    y0s = []
    real = shard.render_tile
    monkeypatch.setattr(shard, "render_tile", lambda p, c, y0, cf, h, seed:
                        y0s.append((y0, h, seed)) or real(p, c, y0, cf, h,
                                                          seed=seed))
    sharded = shard.render_frame_sharded(pack, cam, cfg, devices=["cpu"] * 8)
    assert y0s == [(3 * s, 3, None) for s in range(8)]
    _close(sharded, render.render_frame(pack, cam, cfg), "uneven")


def test_spp_shards_statistically_close(monkeypatch):
    """2 row shards x 4 spp shards: each renders samples / 4 under seed
    ``seed * (2s + 1)``; the average is within 0.05 of the single frame."""
    pack, cam = _packed("small", 32, 32)
    cfg = RenderConfig(width=32, height=32, seed=1, samples=8, bounces=2,
                       chunk_size=16)
    calls = []
    real = shard.render_tile
    monkeypatch.setattr(shard, "render_tile", lambda p, c, y0, cf, h, seed:
                        calls.append((y0, cf.samples, seed))
                        or real(p, c, y0, cf, h, seed=seed))
    fast = shard.render_frame_sharded(pack, cam, cfg, n_sample_shards=4,
                                      devices=["cpu"] * 8)
    assert sorted(calls) == sorted((16 * r, 2, 2 * s + 1) for r in range(2)
                                   for s in range(4))
    single = render.render_frame(pack, cam, cfg)
    assert fast.shape == single.shape
    assert not np.array_equal(fast, single)
    assert abs(float(fast.mean()) - float(single.mean())) < 0.05
    with pytest.raises(ValueError, match="samples must divide"):
        shard.render_frame_sharded(pack, cam, replace(cfg, samples=6),
                                   n_sample_shards=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="do not split"):
        shard.render_frame_sharded(pack, cam, cfg, n_sample_shards=4,
                                   devices=["cpu"] * 6)


def test_spp_shard_tile_matches_raytpu_at_a_wrapped_seed(monkeypatch):
    """Spp shard 1's tile at seed 3e9 (x3 passes 2^32) against raytpu's
    ``render_tile`` with ``seed=jnp.uint32(seed) * 3``, both on the brute
    sweep (an XLA route on raytpu's side)."""
    pack, cam = _packed("small", 32, 32)
    seed = 3_000_000_000
    cfg = RenderConfig(width=32, height=32, seed=seed, samples=2, bounces=3,
                       chunk_size=16, intersector="brute")
    tiles = {}
    real = shard.render_tile

    def spy(p, c, y0, cf, h, seed):
        tiles[y0, seed] = out = real(p, c, y0, cf, h, seed=seed)
        return out

    monkeypatch.setattr(shard, "render_tile", spy)
    shard.render_frame_sharded(pack, cam, cfg, n_sample_shards=2,
                               devices=["cpu"] * 4)
    wrapped = seed * 3 % 2**32
    assert seed * 3 > 2**32 and (16, wrapped) in tiles
    rpack = rt_pack_scene(raytpu.load_scene(scene_path("small")))
    rcam = rt_pack_camera(raytpu.camera_from_lookat(EYE, AT, FOV, 32, 32))
    rcfg = raytpu.RenderConfig(width=32, height=32, seed=seed, samples=1,
                               bounces=3, chunk_size=16, intersector="brute")
    want = rt_render.render_tile(rpack, rcam, jnp.int32(16), rcfg, 16,
                                 seed=jnp.uint32(seed) * jnp.uint32(3))
    got = tiles[16, wrapped].numpy()
    assert (quantize_rgba32f(got).max(-1) > 0).mean() > 0.5
    assert_images_equiv(quantize_rgba32f(got) / 255.0,
                        quantize_rgba32f(np.asarray(want)) / 255.0)


def test_make_devices_needs_enough_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"^need 2 devices, have 1$"):
        shard.make_devices(2)
    with pytest.raises(ValueError, match=r"^need 4 devices, have 1$"):
        shard.make_devices(2, 2)
    pack, cam = _packed("small", 32, 32)
    cfg = RenderConfig(width=32, height=32, seed=1, samples=2, bounces=1,
                       chunk_size=16)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        shard.render_frame_sharded(pack, cam, cfg, n_devices=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        shard.render_frame_sharded(pack, cam, cfg)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert shard.make_devices(2, 2) == [torch.device("cuda", i)
                                        for i in range(4)]
