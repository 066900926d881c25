"""raytpu_torch.kernels.intersect (Möller–Trumbore, brute-force sweeps,
barycentrics) against raytpu's and against a numpy sweep.

Tolerances: XLA:CPU contracts multiply-adds into FMAs, so raytpu's ``t``
differs from an unfused evaluation by up to several hundred ulp on CPU;
the port is held to raytpu with the winning slot and the blocked bit
exact and ``t`` within rtol 1e-4. Against a numpy sweep with the same
operation order (numpy rounds once per op, as torch does) ``t`` and the
slot are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import intersect as rt
from raytpu_torch.kernels import intersect as pt

F32_MAX = np.float32(3.40282347e38)


def _scene(ntri, seed):
    """Random soup padded to a multiple of 512 slots with degenerate
    triangles, plus exact duplicates at higher slots (lowest-slot ties)."""
    r = np.random.default_rng(seed)
    p0 = (r.random((ntri, 3), np.float32) - 0.5) * 10
    e1 = r.normal(size=(ntri, 3)).astype(np.float32)
    e2 = r.normal(size=(ntri, 3)).astype(np.float32)
    n = -(-(ntri + 64) // 512) * 512
    out = [np.zeros((n, 3), np.float32) for _ in range(3)]
    for o, a in zip(out, (p0, e1, e2)):
        o[:ntri] = a
        o[ntri:ntri + 64] = a[:64]  # duplicates of the first 64
    return out


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = (r.random((n, 3), np.float32) - 0.5) * 8.0
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::9, 1] = 0.0
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    return ro, rd, tmax


def _np_sweep(ro, rd, p0, e1, e2, tmin, tmax):
    """Closest hit in numpy, raytpu's operation order, lowest slot on ties."""
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    ro, rd = ro[:, None], rd[:, None]
    with np.errstate(all="ignore"):
        pvec = cross(rd, e2)
        det = dot(e1, pvec)
        inv = np.float32(1.0) / det
        tvec = ro - p0
        u = dot(tvec, pvec) * inv
        qvec = cross(tvec, e1)
        v = dot(rd, qvec) * inv
        t = dot(e2, qvec) * inv
        hit = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
               & (t >= np.float32(tmin)) & (t <= tmax[:, None]))
    t = np.where(hit, t, F32_MAX)
    tri = np.argmin(t, axis=1).astype(np.int32)
    best = t.min(axis=1)
    return best, np.where(best < F32_MAX, tri, -1)


@pytest.fixture(scope="module")
def case():
    p0, e1, e2 = _scene(900, seed=3)
    ro, rd, tmax = _rays(3000, seed=4)
    return p0, e1, e2, ro, rd, tmax


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_brute_closest_matches_raytpu(case):
    p0, e1, e2, ro, rd, tmax = case
    want = rt.intersect_bruteforce(*map(jnp.asarray, (ro, rd, p0, e1, e2)),
                                   0.001, jnp.asarray(tmax))
    got = pt.intersect_bruteforce(*_t(ro, rd, p0, e1, e2), 0.001,
                                  *_t(tmax))
    np.testing.assert_array_equal(np.asarray(want.tri), got.tri.numpy())
    hit = got.valid.numpy()
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-4)


def test_brute_any_matches_raytpu(case):
    p0, e1, e2, ro, rd, _ = case
    tmax = np.full(ro.shape[0], 2.5, np.float32)
    tmax[::5] = -np.inf
    want = rt.intersect_any_bruteforce(
        *map(jnp.asarray, (ro, rd, p0, e1, e2)), 0.0, jnp.asarray(tmax))
    got = pt.intersect_any_bruteforce(*_t(ro, rd, p0, e1, e2), 0.0,
                                      *_t(tmax))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert 0.05 < got.numpy().mean() < 0.95


def test_brute_bit_equal_to_numpy_sweep(case):
    p0, e1, e2, ro, rd, tmax = case
    got = pt.intersect_bruteforce(*_t(ro, rd, p0, e1, e2), 0.001,
                                  *_t(tmax))
    t, tri = _np_sweep(ro, rd, p0, e1, e2, 0.001, tmax)
    np.testing.assert_array_equal(got.tri.numpy(), tri)
    hit = tri >= 0
    np.testing.assert_array_equal(got.t.numpy()[hit].view(np.int32),
                                  t[hit].view(np.int32))
    # every duplicate hit resolves to the lower of its two slots
    assert not np.isin(tri, np.arange(900, 964)).any()


def test_barycentrics_match_raytpu_and_sweep(case):
    p0, e1, e2, ro, rd, tmax = case
    got = pt.intersect_bruteforce(*_t(ro, rd, p0, e1, e2), 0.001, *_t(tmax))
    hit = got.valid.numpy()
    tri = got.tri.numpy()[hit]
    rows = np.concatenate([p0, e1, e2], axis=1)[tri]
    u, v = pt.barycentrics(*_t(ro[hit], rd[hit], rows))
    ju, jv = rt.barycentrics(*map(jnp.asarray, (ro[hit], rd[hit], rows)))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-6)
    # recomputed (u, v) are the sweep's own: inside the triangle
    assert (u.numpy() >= 0).all() and (v.numpy() >= 0).all()
    assert ((u + v).numpy() <= 1.0).all()
