"""raytpu_torch.kernels.rng (int32-bit state) against raytpu.kernels.rng
(uint32 state): the same bits over many seeds and draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import rng as rt_rng
from raytpu_torch.kernels import rng


def _bits(a) -> np.ndarray:
    """uint32 (raytpu) or int32 (port) state as comparable int32 bits."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _states(n=50_000, seed=0):
    r = np.random.default_rng(seed)
    s = r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    s[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xCC9E2D51]
    return s


def test_hash_matches_raytpu():
    s = _states()
    want = rt_rng.hash_u32(jnp.asarray(s))
    got = rng.hash_u32(torch.from_numpy(s.view(np.int32)))
    np.testing.assert_array_equal(_bits(want), got.numpy())


def test_rand_stream_matches_raytpu():
    """40 chained draws: states and floats bit-equal at every step."""
    s = _states(8192, seed=1)
    js = jnp.asarray(s)
    ts = torch.from_numpy(s.view(np.int32).copy())
    for _ in range(40):
        js, jv = rt_rng.rand(js)
        ts, tv = rng.rand(ts)
        np.testing.assert_array_equal(_bits(js), ts.numpy())
        np.testing.assert_array_equal(
            np.asarray(jv).view(np.int32), tv.numpy().view(np.int32)
        )
        assert float(tv.min()) >= 0.0 and float(tv.max()) < 1.0


def test_rand_masked_matches_raytpu():
    s = _states(8192, seed=2)
    masks = np.random.default_rng(3).random((25, s.shape[0])) < 0.4
    js = jnp.asarray(s)
    ts = torch.from_numpy(s.view(np.int32).copy())
    for m in masks:
        js, jv = rt_rng.rand_masked(js, jnp.asarray(m))
        ts, tv = rng.rand_masked(ts, torch.from_numpy(m))
        np.testing.assert_array_equal(_bits(js), ts.numpy())
        np.testing.assert_array_equal(
            np.asarray(jv).view(np.int32), tv.numpy().view(np.int32)
        )


@pytest.mark.parametrize("seed", [1, 11, 12345, 2**31 - 1, 2**31 + 5,
                                  2**32 - 1])
@pytest.mark.parametrize("width,height,chunk", [(48, 32, 16), (100, 37, 64),
                                                (1920, 8, 64)])
def test_seed_pixels_matches_raytpu(seed, width, height, chunk):
    py, px = np.meshgrid(np.arange(height + 3), np.arange(width + 5),
                         indexing="ij")
    px = px.reshape(-1).astype(np.int32)
    py = py.reshape(-1).astype(np.int32)
    want = rt_rng.seed_pixels(jnp.asarray(px), jnp.asarray(py), width,
                              chunk, seed)
    got = rng.seed_pixels(torch.from_numpy(px), torch.from_numpy(py), width,
                          chunk, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_bits(want), got.numpy())
