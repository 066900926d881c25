"""The packet route's BVH8 walk (raytpu_torch.kernels.packet): its plain
torch version against the port's brute-force sweep (t bit-equal) and
raytpu's (``intersect_bruteforce`` / ``intersect_any_bruteforce``), on
random soups with dead lanes, exactly-zero direction components,
finite-tmax closest-hit and shadow rays; the open closest-hit bound; the
lowest-slot tie break; the pack's stack-depth check against raytpu's; and
the intersector factory.

As in tests/test_torch_strand.py, parity is on the original triangle
(``tri_order``): spatial splits may store one triangle in several slots
with identical data. The CUDA kernel is held to the plain version by the
``cuda``-marked test and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
import raytpu.scene.pack as rt_pack_mod
from raytpu.accel.bvh import Bvh8Arrays as RtBvh8Arrays
from raytpu.kernels.intersect import (
    intersect_any_bruteforce as rt_any,
    intersect_bruteforce as rt_closest,
)
from raytpu_torch.accel.bvh import Bvh8Arrays, build_bvh
from raytpu_torch.kernels.intersect import (
    intersect_any_bruteforce,
    intersect_bruteforce,
)
from raytpu_torch.kernels.packet import (
    STACK_DEPTH,
    make_packet_intersectors,
    packet_query,
    packet_query_cuda,
    packet_query_torch,
)
from raytpu_torch.scene import pack as pt_pack_mod
from raytpu_torch.scene.gltf import load_scene

from .conftest import isolated
from .test_torch_host import scene_path
from .test_torch_strand import _rays, _soup, _tie_geometry, _triangle

F32_MAX = np.float32(3.40282347e38)
N_RAYS = 1500


def _build(ntri):
    """(node8 rows, leaf rows, slot-ordered p0/e1/e2, slot -> triangle)."""
    p0, e1, e2 = _soup(ntri)
    bvh, bvh8 = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    return (bvh8.node_rows, per.reshape(-1, 80), per[:, 0:3].copy(),
            per[:, 3:6].copy(), per[:, 6:9].copy(), order)


def _tensors(**arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in arrays.items()}


@pytest.fixture(scope="module", params=[5, 300, 3000])
def case(request):
    ntri = request.param
    rows, leaf, sp0, se1, se2, order = _build(ntri)
    ro, rd = _rays(N_RAYS, seed=ntri)
    tmax = np.full(N_RAYS, F32_MAX, np.float32)
    tmax[3::10] = 5.0  # finite closest-hit bound (open)
    tmax[::7] = -np.inf  # dead lanes
    shadow = np.full(N_RAYS, 6.0, np.float32)  # finite-tmax shadow rays
    shadow[::5] = -np.inf
    t = _tensors(rows=rows, leaf=leaf, p0=sp0, e1=se1, e2=se2, ro=ro, rd=rd,
                 tmax=tmax, shadow=shadow)
    closest = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                 t["tmax"], 0.001, False)
    blocked = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                 t["shadow"], 0.0, True)[1] >= 0
    return dict(t=t, np=dict(ro=ro, rd=rd, tmax=tmax, shadow=shadow,
                             p0=sp0, e1=se1, e2=se2),
                order=order, closest=closest, blocked=blocked.numpy())


def test_plain_walk_closest_bit_equal_port_brute(case):
    t, n = case["t"], case["np"]
    want = intersect_bruteforce(t["ro"], t["rd"], t["p0"], t["e1"], t["e2"],
                                0.001, t["tmax"], chunk=8)
    got_t, got_tri = (a.numpy() for a in case["closest"])
    live = n["tmax"] >= 0
    # dead lanes: the contract's t = -inf, tri = -1
    assert (got_tri[~live] == -1).all()
    assert (got_t[~live] == -np.inf).all()
    np.testing.assert_array_equal(
        _triangle(got_tri, case["order"])[live],
        _triangle(want.tri.numpy(), case["order"])[live])
    hit = live & (got_tri >= 0)
    assert hit.any()
    np.testing.assert_array_equal(got_t[hit].view(np.int32),
                                  want.t.numpy()[hit].view(np.int32))
    # a miss returns the walk's bound: min(F32_MAX, tmax)
    miss = live & (got_tri < 0)
    np.testing.assert_array_equal(got_t[miss], n["tmax"][miss])
    assert (miss & (n["tmax"] < F32_MAX)).any()


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
    assert case["blocked"].any()


def test_closest_hit_bound_is_open_any_hit_closed():
    """One triangle hit at t ~ 2: a closest-hit lane whose tmax is exactly
    that hit's t misses (and returns t = tmax), one with the next float up
    hits; an any-hit lane with the same tmax is blocked."""
    rows, leaf, *_ = _build(5)
    p0 = leaf.reshape(-1, 10)[0, 0:3]
    e1 = leaf.reshape(-1, 10)[0, 3:6]
    e2 = leaf.reshape(-1, 10)[0, 6:9]
    target = p0 + (e1 + e2) / 3
    d = np.array([0.0, 0.0, 1.0], np.float32)
    ro = np.stack([target - 2.0 * d] * 3).astype(np.float32)
    rd = np.stack([d] * 3)
    t = _tensors(rows=rows, leaf=leaf, ro=ro, rd=rd)
    free = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                              torch.full((3,), float(F32_MAX)), 0.001, False)
    t_hit = free[0][0]
    assert int(free[1][0]) >= 0
    bounds = torch.stack([t_hit, torch.nextafter(t_hit, torch.tensor(np.inf)),
                          t_hit])
    got_t, got_tri = packet_query_torch(t["rows"], t["leaf"], t["ro"],
                                        t["rd"], bounds, 0.001, False)
    assert int(got_tri[0]) == -1 and got_t[0] == t_hit
    assert int(got_tri[1]) == int(free[1][0]) and got_t[1] == t_hit
    _, blocked = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                    bounds, 0.0, True)
    assert int(blocked[2]) >= 0


def test_plain_walk_ties_break_to_lowest_slot():
    """Distinct triangles with identical data in two leaves: every ray
    must commit the lowest slot, as the sweep does, whichever leaf the
    walk reaches first."""
    _, rows, per, order, ro, rd = _tie_geometry()
    t = _tensors(rows=rows, leaf=per.reshape(-1, 80), ro=ro, rd=rd,
                 tmax=np.full(500, F32_MAX, np.float32))
    _, tri = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
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


def _chain(levels: int) -> np.ndarray:
    """BVH8 rows of a chain: node i's child 0 is node i + 1, the last
    node's child 0 is leaf row 0, every other slot is empty."""
    rows = np.zeros((levels, 128), np.float32)
    for k in range(8):
        rows[:, 16 * k + 0:16 * k + 3] = 1.0
        rows[:, 16 * k + 3:16 * k + 6] = -1.0
        rows[:, 16 * k + 6] = np.int32(~0).view(np.float32)
    rows[:, 0:3] = -1.0
    rows[:, 3:6] = 1.0
    links = np.append(np.arange(1, levels), ~0).astype(np.int32)
    rows[:, 6] = links.view(np.float32)
    return rows


@pytest.mark.parametrize("levels", [63, 64])
def test_pack_depth_check_matches_raytpu(monkeypatch, levels):
    """8*depth + 8 > STACK_DEPTH raises in both packs, with the same
    message; 63 levels (512 slots) pass and the chain is what gets packed."""
    chain = _chain(levels)

    def fake(real, cls):
        def build(*args, **kwargs):
            bvh, _ = real(*args, **kwargs)
            return bvh, cls(node_rows=chain.copy(), n_leaf_rows=1)
        return build

    monkeypatch.setattr(rt_pack_mod, "build_bvh",
                        fake(rt_pack_mod.build_bvh, RtBvh8Arrays))
    monkeypatch.setattr(pt_pack_mod, "build_bvh",
                        fake(pt_pack_mod.build_bvh, Bvh8Arrays))
    path = scene_path("small_plain")
    if 8 * levels + 8 > STACK_DEPTH:
        with pytest.raises(ValueError) as rt_err:
            rt_pack_mod.pack_scene(raytpu.load_scene(path), as_numpy=True)
        with pytest.raises(ValueError) as pt_err:
            pt_pack_mod.pack_scene(load_scene(path))
        assert str(pt_err.value) == str(rt_err.value)
        assert "BVH8 depth 64" in str(pt_err.value)
    else:
        want = rt_pack_mod.pack_scene(raytpu.load_scene(path), as_numpy=True)
        got = pt_pack_mod.pack_scene(load_scene(path))
        np.testing.assert_array_equal(want.bvh.node8_rows, chain)
        np.testing.assert_array_equal(got.bvh.node8_rows.numpy(), chain)


def test_dispatch_by_device_and_cuda_wrapper_refuses_cpu(case):
    t = case["t"]
    before = packet_query_cuda.launches
    a = packet_query(t["rows"], t["leaf"], t["ro"], t["rd"], t["tmax"],
                     0.001, False)
    for x, y in zip(a, case["closest"]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        packet_query_cuda(t["rows"], t["leaf"], t["ro"], t["rd"], t["tmax"],
                          0.001, False)
    assert packet_query_cuda.launches == before


class _Pack:
    def __init__(self, t):
        self.bvh = type("B", (), dict(node8_rows=t["rows"],
                                      leaf_tris=t["leaf"]))


def test_intersectors_bake_tmin(case):
    t = case["t"]
    closest, any_fn = make_packet_intersectors(_Pack(t))
    hit = closest(t["ro"], t["rd"], 0.001, t["tmax"])
    assert torch.equal(hit.tri, case["closest"][1])
    assert torch.equal(hit.t, case["closest"][0])
    assert torch.equal(hit.valid, case["closest"][1] >= 0)
    assert np.array_equal(any_fn(t["ro"], t["rd"], 0.0, t["shadow"]).numpy(),
                          case["blocked"])
    # a scalar tmax broadcasts to every ray
    full = closest(t["ro"], t["rd"], 0.001, float(F32_MAX))
    unbounded = case["np"]["tmax"] == F32_MAX
    assert torch.equal(full.tri[unbounded], hit.tri[unbounded])
    with pytest.raises(ValueError):
        closest(t["ro"], t["rd"], 0.0, t["tmax"])
    with pytest.raises(ValueError):
        any_fn(t["ro"], t["rd"], 0.001, t["shadow"])


@pytest.mark.cuda
def test_kernel_bit_equal_plain_on_cuda():
    """packet_walk.cu against the plain version on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, leaf, *_ = _build(3000)
    ro, rd = _rays(65536, seed=9)
    tmax = np.full(65536, F32_MAX, np.float32)
    tmax[3::10] = 5.0
    tmax[::7] = -np.inf
    dev = {k: v.cuda() for k, v in _tensors(rows=rows, leaf=leaf, ro=ro,
                                             rd=rd, tmax=tmax).items()}
    args = (dev["rows"], dev["leaf"], dev["ro"], dev["rd"], dev["tmax"])
    before = packet_query_cuda.launches
    tk, trk = packet_query_cuda(*args, 0.001, False)
    tp, trp = packet_query_torch(*args, 0.001, False)
    torch.cuda.synchronize()
    assert packet_query_cuda.launches == before + 1
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(trk, trp)
    dev["tmax"].fill_(4.0)
    _, ak = packet_query_cuda(*args, 0.0, True)
    _, ap = packet_query_torch(*args, 0.0, True)
    assert torch.equal(ak >= 0, ap >= 0)
    _, rows, per, _, ro, rd = _tie_geometry()
    cu = [v.cuda() for v in _tensors(
        rows=rows, leaf=per.reshape(-1, 80), ro=ro, rd=rd,
        tmax=np.full(500, F32_MAX, np.float32)).values()]
    assert torch.equal(packet_query_cuda(*cu, 0.001, False)[1],
                       packet_query_torch(*cu, 0.001, False)[1])


@pytest.mark.slow
@isolated
def test_plain_walk_matches_raytpu_packet_kernel_interpreted():
    """raytpu's Pallas packet kernel (interpret mode) on 300 triangles x
    4096 rays: the same triangle and blocked bit (per-packet leaf tests
    cannot lose a hit the per-ray walk finds, and the sweep agrees with
    both), t within rtol 1e-4."""
    from raytpu.kernels.intersect_pallas import packet_query as rt_packet

    rows, leaf, *_, order = _build(300)
    ro, rd = _rays(4096, seed=300)
    tmax = np.full(4096, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    shadow = np.full(4096, 6.0, np.float32)
    t = _tensors(rows=rows, leaf=leaf, ro=ro, rd=rd, tmax=tmax, shadow=shadow)
    got_t, got_tri = packet_query_torch(t["rows"], t["leaf"], t["ro"],
                                        t["rd"], t["tmax"], 0.001, False)
    cols = [jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)]
    want_t, want_tri = rt_packet(jnp.asarray(rows), jnp.asarray(leaf), *cols,
                                 jnp.asarray(tmax), tmin=0.001,
                                 any_hit=False, interpret=True)
    np.testing.assert_array_equal(_triangle(got_tri.numpy(), order),
                                  _triangle(np.asarray(want_tri), order))
    hit = got_tri.numpy() >= 0
    np.testing.assert_allclose(got_t.numpy()[hit], np.asarray(want_t)[hit],
                               rtol=1e-4)
    _, got_b = packet_query_torch(t["rows"], t["leaf"], t["ro"], t["rd"],
                                  t["shadow"], 0.0, True)
    _, want_b = rt_packet(jnp.asarray(rows), jnp.asarray(leaf), *cols,
                          jnp.asarray(shadow), tmin=0.0, any_hit=True,
                          interpret=True)
    np.testing.assert_array_equal(got_b.numpy() >= 0,
                                  np.asarray(want_b) >= 0)
