"""The block-scheduled strand walk's plain torch version
(raytpu_torch.kernels.strand.strand_block_query_torch) against raytpu's
block kernel (``raytpu.kernels.strand.strand_query`` in interpret mode)
and against the port's per-ray walk, plus the factory's kernel choice.

Parity with raytpu: the same original triangle (spatial splits store one
triangle in several slots with identical data), ``t`` to rtol 1e-4
(XLA:CPU contracts the Moller-Trumbore chain into FMAs), the any-hit
blocked bit exactly. Against the port's per-ray walk, which rounds the
same way: closest ``t`` bit-equal. The CUDA kernel is held to the plain
version by the ``cuda``-marked test and by chip_smoke.py (phase 3d)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu_torch.kernels import strand
from raytpu_torch.kernels.strand import (
    STRAND,
    make_strand_intersectors,
    strand_block_query,
    strand_block_query_cuda,
    strand_block_query_torch,
    strand_query_torch,
)

from .conftest import isolated
from .test_torch_strand import _Pack, _build, _rays, _tie_scene

F32_MAX = np.float32(3.40282347e38)


def _sorted_rays(n, seed):
    """Random rays (exactly-zero components included) octant-sorted, as
    the engine's coherence sort groups them."""
    ro, rd = _rays(n, seed)
    octant = (rd[:, 0] < 0) + 2 * (rd[:, 1] < 0) + 4 * (rd[:, 2] < 0)
    idx = np.argsort(octant, kind="stable")
    return ro[idx], rd[idx]


def _tensors(**arrays):
    """The arrays as tensors, with the leaf rows' tie keys as "first"."""
    t = {k: torch.from_numpy(np.ascontiguousarray(a))
         for k, a in arrays.items()}
    t["first"] = strand.first_slots(t["leaf"])
    return t


def _triangle(tri, order):
    return np.where(tri >= 0, order[np.maximum(tri, 0)], -1)


@isolated
def test_plain_block_walk_matches_raytpu_block_kernel():
    """raytpu's _strand_kernel (one block of 8 strands, groups=1) and the
    port's warp-strand walk on a 300-triangle soup and 1,000 octant-sorted
    rays with dead lanes: the same triangles, t to rtol 1e-4, the same
    blocked bits."""
    from raytpu.kernels.strand import strand_query as rt_strand_query

    rows, leaf, _, _, _, order = _build(300)
    ro, rd = _sorted_rays(1000, seed=3)
    tmax = np.full(1000, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    tmax[3::10] = 5.0
    shadow = np.full(1000, 6.0, np.float32)
    shadow[::7] = -np.inf

    def raytpu(tm, tmin, any_hit):
        t, tri = rt_strand_query(
            jnp.asarray(rows), jnp.asarray(leaf),
            *(jnp.asarray(ro[:, a]) for a in range(3)),
            *(jnp.asarray(rd[:, a]) for a in range(3)),
            jnp.asarray(tm), tmin=tmin, any_hit=any_hit, interpret=True,
            groups=1,
        )
        return np.asarray(t), np.asarray(tri)

    t = _tensors(rows=rows, leaf=leaf, ro=ro, rd=rd, tmax=tmax,
                 shadow=shadow)
    got_t, got_tri = (a.numpy() for a in strand_block_query_torch(
        t["rows"], t["leaf"], t["first"], t["ro"], t["rd"], t["tmax"], 0.001,
        False))
    want_t, want_tri = raytpu(tmax, 0.001, False)
    live = tmax >= 0
    assert (got_tri[~live] == -1).all() and (want_tri[~live] == -1).all()
    np.testing.assert_array_equal(_triangle(got_tri, order),
                                  _triangle(want_tri, order))
    hit = live & (got_tri >= 0)
    assert hit.sum() > 200
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4)
    blocked = strand_block_query_torch(t["rows"], t["leaf"], t["first"],
                                       t["ro"], t["rd"], t["shadow"], 0.0,
                                       True)[1]
    _, want_blocked = raytpu(shadow, 0.0, True)
    np.testing.assert_array_equal(blocked.numpy() >= 0, want_blocked >= 0)
    assert (blocked.numpy() >= 0).sum() > 200


@pytest.fixture(scope="module", params=[5, 300, 3000])
def case(request):
    """A soup, 1,500 octant-sorted rays (not a multiple of 32) with dead
    lanes and finite closest-hit bounds, and 6.0-long shadow rays."""
    ntri = request.param
    rows, leaf, _, _, _, order = _build(ntri)
    n = 1500
    ro, rd = _sorted_rays(n, seed=ntri)
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    tmax[3::10] = 5.0
    shadow = np.full(n, 6.0, np.float32)
    shadow[::5] = -np.inf
    return dict(t=_tensors(rows=rows, leaf=leaf, ro=ro, rd=rd, tmax=tmax,
                           shadow=shadow), order=order, tmax=tmax)


def test_plain_block_walk_equals_per_ray_walk(case):
    """Plain against plain: closest t bit-equal, the same original
    triangle (slots too wherever a triangle has one slot), the same
    blocked bits; dead lanes return t = -inf, tri = -1."""
    t = case["t"]
    args = (t["rows"], t["leaf"], t["first"], t["ro"], t["rd"])
    bt, btri = strand_block_query_torch(*args, t["tmax"], 0.001, False)
    pt, ptri = strand_query_torch(*args, t["tmax"], 0.001, False)
    np.testing.assert_array_equal(bt.numpy().view(np.int32),
                                  pt.numpy().view(np.int32))
    np.testing.assert_array_equal(_triangle(btri.numpy(), case["order"]),
                                  _triangle(ptri.numpy(), case["order"]))
    dead = case["tmax"] < 0
    assert (btri.numpy()[dead] == -1).all()
    assert (bt.numpy()[dead] == -np.inf).all()
    _, bblk = strand_block_query_torch(*args, t["shadow"], 0.0, True)
    _, pblk = strand_query_torch(*args, t["shadow"], 0.0, True)
    np.testing.assert_array_equal(bblk.numpy() >= 0, pblk.numpy() >= 0)


def test_block_walk_counters(case):
    """One row of (steps, leaf visits) per 32-ray strand: every strand
    steps at least once, visits no more leaves than it steps, and the
    counters do not change the results."""
    t = case["t"]
    args = (t["rows"], t["leaf"], t["first"], t["ro"], t["rd"], t["tmax"],
            0.001, False)
    bt, btri, st = strand_block_query_torch(*args, with_stats=True)
    n_str = -(-t["ro"].shape[0] // STRAND)
    assert st.shape == (n_str, 2) and st.dtype == torch.int32
    assert bool((st[:, 0] >= 1).all())
    assert bool((st[:, 1] <= st[:, 0]).all())
    plain = strand_block_query_torch(*args)
    assert torch.equal(plain[0], bt) and torch.equal(plain[1], btri)
    # all lanes dead: the closest-hit walker tests the root once and
    # leaves; the any-hit walker stops before its first step
    dead = torch.full_like(t["tmax"], float("-inf"))
    walk = (t["rows"], t["leaf"], t["first"], t["ro"], t["rd"], dead)
    assert bool((strand_block_query_torch(*walk, 0.001, False, True)[2]
                 == torch.tensor([1, 0], dtype=torch.int32)).all())
    assert bool((strand_block_query_torch(*walk, 0.0, True, True)[2]
                 == 0).all())


def test_per_ray_walk_counts_its_reads(case):
    """The per-ray walk's counts, the inputs of chip_smoke.py's bounds:
    one ray reads each node record and leaf row it visits once, so its
    bytes are 32 per box test plus 320 per leaf (8 triangle tests); a wave
    reads each distinct row once, at least its largest ray's bytes and at
    most the tables. Counting changes no result."""
    t = case["t"]
    tables = (t["rows"].numel() + t["leaf"].numel()) * 4
    wave = {}
    got = strand_query_torch(t["rows"], t["leaf"], t["first"], t["ro"],
                             t["rd"], t["tmax"], 0.001, False, counts=wave)
    plain = strand_query_torch(t["rows"], t["leaf"], t["first"], t["ro"],
                               t["rd"], t["tmax"], 0.001, False)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    largest = 0
    for i in range(0, t["ro"].shape[0], 75):
        one = {}
        strand_query_torch(t["rows"], t["leaf"], t["first"],
                           t["ro"][i:i + 1], t["rd"][i:i + 1],
                           t["tmax"][i:i + 1], 0.001, False, counts=one)
        assert one["bytes"] == 32 * one["boxes"] + 40 * one.get("tris", 0)
        largest = max(largest, one["bytes"])
    assert wave["boxes"] >= t["ro"].shape[0]
    assert wave.get("tris", 0) % 8 == 0
    assert 0 < largest <= wave["bytes"] <= tables


def test_block_walk_ties_break_to_lowest_slot():
    rows, per, order, ro, rd = _tie_scene()
    t = _tensors(rows=rows, leaf=per.reshape(-1, 80), ro=ro, rd=rd,
                 tmax=np.full(500, F32_MAX, np.float32))
    _, btri = strand_block_query_torch(t["rows"], t["leaf"], t["first"],
                                       t["ro"], t["rd"], t["tmax"], 0.001,
                                       False)
    _, ptri = strand_query_torch(t["rows"], t["leaf"], t["first"], t["ro"],
                                 t["rd"], t["tmax"], 0.001, False)
    np.testing.assert_array_equal(btri.numpy(), ptri.numpy())
    copies = np.flatnonzero(np.isin(order, [0, *range(40, 51)]))
    on_copies = np.isin(btri.numpy(), copies)
    assert on_copies.mean() > 0.9
    assert set(btri.numpy()[on_copies]) == {copies.min()}


def test_block_dispatch_and_cuda_wrapper_refuses_cpu(case):
    t = case["t"]
    args = (t["rows"], t["leaf"], t["first"], t["ro"], t["rd"], t["tmax"],
            0.001, False)
    before = strand_block_query_cuda.launches
    for x, y in zip(strand_block_query(*args),
                    strand_block_query_torch(*args)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        strand_block_query_cuda(*args)
    assert strand_block_query_cuda.launches == before


def _spy(monkeypatch):
    calls = []

    def fake(name, real):
        def query(*args):
            calls.append(name)
            return real(*args)
        return query

    monkeypatch.setattr(strand, "strand_query",
                        fake("persistent", strand.strand_query))
    monkeypatch.setattr(strand, "strand_block_query",
                        fake("block", strand.strand_block_query))
    return calls


@pytest.mark.parametrize("env,budget,want", [
    (None, None, "persistent"),
    ("1", None, "persistent"),
    ("0", None, "block"),
    ("0", 64, "persistent"),  # tables over the budget
])
def test_factory_picks_the_walk_like_raytpu(monkeypatch, case, env, budget,
                                            want):
    """RAYTPU_STRAND_PERSISTENT (read when the factory runs, default "1")
    picks the walk; tables over the 100 MiB budget keep the persistent
    one, as raytpu's _hbm_tables forces it."""
    if env is None:
        monkeypatch.delenv("RAYTPU_STRAND_PERSISTENT", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_STRAND_PERSISTENT", env)
    if budget is not None:
        monkeypatch.setattr(strand, "STRAND_TABLE_BUDGET", budget)
    calls = _spy(monkeypatch)
    t = case["t"]
    closest, any_fn = make_strand_intersectors(_Pack(t))
    monkeypatch.setenv("RAYTPU_STRAND_PERSISTENT",
                       "1" if want == "block" else "0")  # bound already
    hit = closest(t["ro"], t["rd"], 0.001, t["tmax"])
    blocked = any_fn(t["ro"], t["rd"], 0.0, t["shadow"])
    assert calls == [want, want]
    want_t, want_tri = strand_query_torch(t["rows"], t["leaf"], t["first"],
                                          t["ro"], t["rd"], t["tmax"], 0.001,
                                          False)
    assert torch.equal(hit.t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(hit.valid, want_tri >= 0)
    assert blocked.shape == t["shadow"].shape
    with pytest.raises(ValueError):
        closest(t["ro"], t["rd"], 0.0, t["tmax"])
    with pytest.raises(ValueError):
        any_fn(t["ro"], t["rd"], 0.001, t["shadow"])


@pytest.mark.cuda
def test_block_kernel_bit_equal_plain_on_cuda():
    """strand_block.cu against the plain version on the same CUDA
    tensors: t, tri and the per-strand counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, leaf, *_ = _build(3000)
    ro, rd = _sorted_rays(65535, seed=9)
    tmax = np.full(65535, F32_MAX, np.float32)
    tmax[::7] = -np.inf
    dev = {k: v.cuda() for k, v in _tensors(rows=rows, leaf=leaf, ro=ro,
                                            rd=rd, tmax=tmax).items()}
    args = (dev["rows"], dev["leaf"], dev["first"], dev["ro"], dev["rd"],
            dev["tmax"])
    before = strand_block_query_cuda.launches
    tk, trk, sk = strand_block_query_cuda(*args, 0.001, False, True)
    tp, trp, sp = strand_block_query_torch(*args, 0.001, False, True)
    torch.cuda.synchronize()
    assert strand_block_query_cuda.launches == before + 1
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(trk, trp) and torch.equal(sk, sp)
    dev["tmax"].fill_(4.0)
    _, ak = strand_block_query_cuda(*args, 0.0, True)
    _, ap = strand_block_query_torch(*args, 0.0, True)
    assert torch.equal(ak, ap)
