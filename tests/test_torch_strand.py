"""The strand walk's plain torch version (raytpu_torch.kernels.strand)
against the port's brute-force sweep (t bit-equal) and raytpu's
(``intersect_bruteforce`` / ``intersect_any_bruteforce``, the plain
reference raytpu holds its own strand kernels to), on random soups with
dead lanes, exactly-zero direction components and finite-tmax shadow rays.

A triangle that spatial splits store in several slots carries identical
data in each; the sweep sees every slot and the walk only those of the
leaves it visits, so parity is on the original triangle (``tri_order``)
and on hit/miss, as in tests/test_strand.py. The CUDA kernel is held to
the plain version by the ``cuda``-marked test and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels.intersect import (
    intersect_any_bruteforce as rt_any,
    intersect_bruteforce as rt_closest,
)
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.accel.strandtree import build_strand_tree, validate_strand_tree
from raytpu_torch.kernels import strand
from raytpu_torch.kernels.intersect import (
    intersect_any_bruteforce,
    intersect_bruteforce,
)
from raytpu_torch.kernels.strand import (
    make_strand_intersectors,
    strand_query,
    strand_query_cuda,
    strand_query_torch,
)

F32_MAX = np.float32(3.40282347e38)
N_RAYS = 1500


def _soup(ntri, seed=0):
    r = np.random.default_rng(seed)
    p0 = (r.random((ntri, 3), np.float32) - 0.5) * 10
    e1 = r.normal(size=(ntri, 3)).astype(np.float32)
    e2 = r.normal(size=(ntri, 3)).astype(np.float32)
    return p0, e1, e2


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = (r.random((n, 3), np.float32) - 0.5) * 8.0
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::11, 0] = 0.0
    rd[5::13, 1] = -0.0
    rd[7::17, 2] = 0.0
    return ro, rd


def _build(ntri):
    """(strand rows, leaf rows, slot-ordered p0/e1/e2, slot -> triangle)."""
    p0, e1, e2 = _soup(ntri)
    bvh, _ = build_bvh(p0, e1, e2)
    tree = build_strand_tree(bvh)
    validate_strand_tree(tree, bvh)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    return (tree.rows, per.reshape(-1, 80), per[:, 0:3].copy(),
            per[:, 3:6].copy(), per[:, 6:9].copy(), order)


@pytest.fixture(scope="module", params=[5, 300, 3000])
def case(request):
    ntri = request.param
    rows, leaf, sp0, se1, se2, order = _build(ntri)
    ro, rd = _rays(N_RAYS, seed=ntri)
    tmax = np.full(N_RAYS, F32_MAX, np.float32)
    tmax[::7] = -np.inf  # dead lanes
    shadow = np.full(N_RAYS, 6.0, np.float32)  # finite-tmax shadow rays
    shadow[::5] = -np.inf
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        rows=rows, leaf=leaf, p0=sp0, e1=se1, e2=se2, ro=ro, rd=rd,
        tmax=tmax, shadow=shadow).items()}
    closest = strand_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                 t["tmax"], 0.001, False)
    blocked = strand_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                 t["shadow"], 0.0, True)[1] >= 0
    return dict(t=t, np=dict(ro=ro, rd=rd, tmax=tmax, shadow=shadow,
                             p0=sp0, e1=se1, e2=se2),
                order=order, closest=closest, blocked=blocked.numpy())


def _triangle(tri, order):
    return np.where(tri >= 0, order[np.maximum(tri, 0)], -1)


def test_plain_walk_closest_bit_equal_port_brute(case):
    t = case["t"]
    want = intersect_bruteforce(t["ro"], t["rd"], t["p0"], t["e1"], t["e2"],
                                0.001, t["tmax"], chunk=8)
    got_t, got_tri = (a.numpy() for a in case["closest"])
    live = case["np"]["tmax"] >= 0
    # dead lanes: the kernel contract's t = -inf, tri = -1
    assert (got_tri[~live] == -1).all()
    assert (got_t[~live] == -np.inf).all()
    np.testing.assert_array_equal(got_t[live].view(np.int32),
                                  want.t.numpy()[live].view(np.int32))
    np.testing.assert_array_equal(
        _triangle(got_tri, case["order"])[live],
        _triangle(want.tri.numpy(), case["order"])[live])


def test_plain_walk_closest_matches_raytpu_brute(case):
    n = case["np"]
    want = rt_closest(*map(jnp.asarray, (n["ro"], n["rd"], n["p0"], n["e1"],
                                         n["e2"])),
                      jnp.float32(0.001), jnp.asarray(n["tmax"]), chunk=8)
    got_t, got_tri = (a.numpy() for a in case["closest"])
    live = n["tmax"] >= 0
    want_tri = np.asarray(want.tri)
    np.testing.assert_array_equal(_triangle(got_tri, case["order"])[live],
                                  _triangle(want_tri, case["order"])[live])
    hit = live & (got_tri >= 0)
    np.testing.assert_allclose(got_t[hit], np.asarray(want.t)[hit],
                               rtol=1e-4)


def test_plain_walk_any_hit_matches_both_brutes(case):
    t, n = case["t"], case["np"]
    port = intersect_any_bruteforce(t["ro"], t["rd"], t["p0"], t["e1"],
                                    t["e2"], 0.0, t["shadow"], chunk=8)
    ref = rt_any(*map(jnp.asarray, (n["ro"], n["rd"], n["p0"], n["e1"],
                                    n["e2"])),
                 jnp.float32(0.0), jnp.asarray(n["shadow"]), chunk=8)
    np.testing.assert_array_equal(case["blocked"], port.numpy())
    np.testing.assert_array_equal(case["blocked"], np.asarray(ref))
    assert not case["blocked"][::5].any()  # dead shadow lanes


def _tie_scene():
    """40 small triangles plus 11 exact copies of triangle 0 (12 copies over
    two leaves), and 500 rays aimed at that triangle's centroid."""
    bvh, _, per, order, ro, rd = _tie_geometry()
    return build_strand_tree(bvh).rows, per, order, ro, rd


def _tie_geometry():
    """The tie scene's (bvh, bvh8, slot-ordered rows [S, 10], slot ->
    triangle, ro, rd)."""
    r = np.random.default_rng(7)
    p0 = (r.random((40, 3), np.float32) - 0.5) * 10
    e1 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    e2 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    p0, e1, e2 = (np.concatenate([a, np.repeat(a[:1], 11, 0)])
                  for a in (p0, e1, e2))
    bvh, bvh8 = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    c = p0[0] + (e1[0] + e2[0]) / 3
    ro = (r.random((500, 3), np.float32) - 0.5) * 12
    rd = c - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return bvh, bvh8.node_rows, per, order, ro, rd


def test_plain_walk_ties_break_to_lowest_slot():
    """Distinct triangles with identical data in two leaves: every ray
    must commit the lowest slot, as the sweep does, whichever leaf the
    walk reaches first."""
    rows, per, order, ro, rd = _tie_scene()
    assert (order >= 0).sum() == np.unique(order[order >= 0]).size
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        rows=rows, leaf=per.reshape(-1, 80), ro=ro, rd=rd,
        tmax=np.full(500, F32_MAX, np.float32)).items()}
    _, tri = strand_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                t["tmax"], 0.001, False)
    want = intersect_bruteforce(t["ro"], t["rd"],
                                torch.from_numpy(per[:, 0:3].copy()),
                                torch.from_numpy(per[:, 3:6].copy()),
                                torch.from_numpy(per[:, 6:9].copy()),
                                0.001, t["tmax"], chunk=8)
    copies = np.flatnonzero(np.isin(order, [0, *range(40, 51)]))
    assert len(np.unique(copies // 8)) == 2
    on_copies = np.isin(tri.numpy(), copies)
    assert on_copies.mean() > 0.9
    np.testing.assert_array_equal(tri.numpy(), want.tri.numpy())
    assert set(tri.numpy()[on_copies]) == {copies.min()}


def test_dispatch_by_device_and_cuda_wrapper_refuses_cpu(case):
    t = case["t"]
    before = strand_query_cuda.launches
    a = strand_query(t["rows"], t["leaf"], t["ro"], t["rd"], t["tmax"],
                     0.001, False)
    for x, y in zip(a, case["closest"]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        strand_query_cuda(t["rows"], t["leaf"], t["ro"], t["rd"], t["tmax"],
                          0.001, False)
    assert strand_query_cuda.launches == before


class _Pack:
    def __init__(self, t):
        self.bvh = type("B", (), dict(strand_rows=t["rows"],
                                      leaf_tris=t["leaf"]))


def test_intersectors_bake_tmin(case):
    t = case["t"]
    closest, any_fn = make_strand_intersectors(_Pack(t))
    hit = closest(t["ro"], t["rd"], 0.001, t["tmax"])
    assert torch.equal(hit.tri, case["closest"][1])
    assert torch.equal(hit.valid, case["closest"][1] >= 0)
    assert np.array_equal(any_fn(t["ro"], t["rd"], 0.0, t["shadow"]).numpy(),
                          case["blocked"])
    # a scalar tmax broadcasts to every ray
    full = closest(t["ro"], t["rd"], 0.001, float(F32_MAX))
    live = case["np"]["tmax"] >= 0
    assert torch.equal(full.tri[live], hit.tri[live])
    with pytest.raises(ValueError):
        closest(t["ro"], t["rd"], 0.0, t["tmax"])
    with pytest.raises(ValueError):
        any_fn(t["ro"], t["rd"], 0.001, t["shadow"])


@pytest.mark.cuda
def test_kernel_bit_equal_plain_on_cuda():
    """strand_walk.cu against the plain version on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, leaf, *_ = _build(3000)
    ro, rd = _rays(65536, seed=9)
    tmax = np.full(65536, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    dev = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda()
           for k, a in dict(rows=rows, leaf=leaf, ro=ro, rd=rd,
                            tmax=tmax).items()}
    args = (dev["rows"], dev["leaf"], dev["ro"], dev["rd"], dev["tmax"])
    before = strand_query_cuda.launches
    tk, trk = strand.strand_query_cuda(*args, 0.001, False)
    tp, trp = strand_query_torch(*args, 0.001, False)
    torch.cuda.synchronize()
    assert strand_query_cuda.launches == before + 1
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(trk, trp)
    dev["tmax"].fill_(4.0)
    _, ak = strand_query_cuda(*args, 0.0, True)
    _, ap = strand_query_torch(*args, 0.0, True)
    assert torch.equal(ak >= 0, ap >= 0)
    rows, per, _, ro, rd = _tie_scene()
    cu = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        rows, per.reshape(-1, 80), ro, rd, np.full(500, F32_MAX, np.float32))]
    assert torch.equal(strand_query_cuda(*cu, 0.001, False)[1],
                       strand_query_torch(*cu, 0.001, False)[1])
