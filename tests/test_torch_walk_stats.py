"""The walks' stats outputs and the packet walk's near-first order in the
port.

* Stats: ``packet_query*(with_stats=True, packet=)`` returns raytpu's
  int32 [ceil(R/packet), 128] (lane 1 leaf-row tests, every other lane
  node pops) and ``strand_query*``/``strand_mixed_query*(stats=True)``
  raytpu's int32 [8]; the shapes and dtypes are held to raytpu's outputs
  through ``jax.eval_shape``, which traces raytpu's kernels without running
  a Pallas program. The port's counts are the per-ray walks' own (sums over
  rays), so they are held to the plain walks' ``counts`` totals.
* Order: ``packet_query*(ordered=True)`` visits each node's hit children
  near-first and returns the storage order's t bits and tie key (which copy
  of a spatially split triangle comes back may differ);
  ``RAYTPU_ORDER_MODE`` resolves ``ordered=None`` as raytpu does when it is
  set, and the port keeps storage order when it is unset.

The CUDA kernels are held to these plain versions by the ``cuda``-marked
test and by chip_smoke.py (phases 3g, 3h, 11b)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels.intersect_pallas import packet_query as rt_packet_query
from raytpu.kernels.strand_persistent import strand_query_persistent
from raytpu_torch.kernels import packet, strand
from raytpu_torch.kernels.packet import (
    make_packet_intersectors,
    packet_query,
    packet_query_cuda,
    packet_query_torch,
    resolve_order,
)
from raytpu_torch.kernels.strand import (
    strand_mixed_query_torch,
    strand_query,
    strand_query_torch,
)

from .test_torch_mixed import _lanes
from .test_torch_packet import _build as _build_bvh8
from .test_torch_strand import _build, _rays

F32_MAX = np.float32(3.40282347e38)
N_RAYS = 512


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain walks run thousands of small torch ops: one intra-op
    thread keeps them from contending with the other test workers' threads
    (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(ntri: int, n: int = N_RAYS):
    """BVH8 rows, strand rows, leaf rows and tie keys of the strand tests'
    soup, with its rays: closest bounds (some finite, dead lanes) and
    shadow bounds."""
    rows8, leaf, *_ = _build_bvh8(ntri)
    rows = _build(ntri)[0]
    ro, rd = _rays(n, seed=ntri)
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[3::10] = 5.0
    tmax[::7] = -np.inf
    shadow = np.full(n, 6.0, np.float32)
    shadow[::5] = -np.inf
    lf = _t(leaf)
    return dict(rows8=_t(rows8), rows=_t(rows), leaf=lf,
                first=strand.first_slots(lf), ro=_t(ro), rd=_t(rd),
                tmax=_t(tmax), shadow=_t(shadow))


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_stats_shapes_and_dtypes_are_raytpus():
    """raytpu's packet_query(with_stats=True) and
    strand_query_persistent(stats=True), traced by jax.eval_shape at the
    port's shapes, against the port's outputs: the same shape and dtype for
    every output, at packet sizes that do and do not divide R."""
    c = _case(300, 1000)
    rays = [_spec(1000)] * 7
    for pk in (256, 384):
        want = jax.eval_shape(
            lambda n, lf, *r, pk=pk: rt_packet_query(
                n, lf, *r, with_stats=True, packet=pk),
            _spec(*c["rows8"].shape), _spec(*c["leaf"].shape), *rays)
        got = packet_query_torch(c["rows8"], c["leaf"], c["first"], c["ro"],
                                 c["rd"], c["tmax"], 0.001, False,
                                 with_stats=True, packet=pk)
        assert [(tuple(g.shape), str(g.dtype)[6:]) for g in got] == [
            (w.shape, str(w.dtype)) for w in want]
        assert got[2].shape == (-(-1000 // pk), 128)
    want = jax.eval_shape(
        lambda n, lf, *r: strand_query_persistent(
            n, lf, *r, stats=True, walkers=8, service_k=2),
        _spec(*c["rows"].shape), _spec(*c["leaf"].shape), *rays)
    for got in (strand_query_torch(c["rows"], c["leaf"], c["first"],
                                   c["ro"], c["rd"], c["tmax"], 0.001, False,
                                   stats=True),
                strand_mixed_query_torch(c["rows"], c["leaf"], c["first"],
                                         c["ro"], c["rd"], c["tmax"],
                                         torch.zeros(1000), 0.001, 0.0,
                                         stats=True)):
        assert [(tuple(g.shape), str(g.dtype)[6:]) for g in got] == [
            (w.shape, str(w.dtype)) for w in want]


@pytest.mark.parametrize("ntri", [5, 300, 3000])
@pytest.mark.parametrize("ordered", [False, True])
def test_packet_stats_sum_the_plain_walks_counts(ntri, ordered):
    """Per packet, lane 1 holds its rays' leaf-row tests and every other
    lane their node pops: summed over packets they equal the plain walk's
    counts (8 box tests a pop, 8 triangle tests a leaf row), closest-hit,
    any-hit and mixed; the closest-hit results are those of the walk
    without stats. A packet of dead lanes (tmax = -inf) counts 0."""
    c = _case(ntri)
    tmax = c["tmax"].clone()
    tmax[256:384] = float("-inf")  # packet 2 of 128 rays: all dead
    ro, rd, mtmax, smask, _ = _lanes(N_RAYS, ntri)
    calls = [(c["ro"], c["rd"], tmax, 0.001, False, {}),
             (c["ro"], c["rd"], c["shadow"], 0.0, True, {}),
             (_t(ro), _t(rd), _t(mtmax), 0.001, False,
              dict(smask=_t(smask), shadow_tmin=0.0))]
    lane = torch.arange(128)
    for i, (ro_, rd_, bound, tmin, any_hit, kw) in enumerate(calls):
        args = (c["rows8"], c["leaf"], c["first"], ro_, rd_, bound, tmin,
                any_hit)
        counts = {}
        t, tri, st = packet_query_torch(*args, counts, **kw, ordered=ordered,
                                        with_stats=True, packet=128)
        assert st.dtype == torch.int32 and st.shape == (4, 128)
        assert torch.equal(st[:, lane != 1], st[:, :1].expand(4, 127))
        assert int(st[:, 0].sum()) * 8 == counts["boxes"]
        assert int(st[:, 1].sum()) * 8 == counts.get("tris", 0)
        assert int(st[:, 0].min()) >= 0 and int(st[:, 0].sum()) > 0
        if i == 0:
            t0, tri0 = packet_query_torch(*args, ordered=ordered)
            assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
            assert torch.equal(tri, tri0)
            assert int(st[2].abs().sum()) == 0  # the all-dead packet
            assert int(st[1, 0]) > 0


@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_strand_stats_count_the_plain_walks_work(ntri):
    """strand_query*(stats=True): [0] the records loaded (the plain walk's
    box tests), [3] ceil(R/128) installs, [4] and [5] the leaf rows tested
    and reached (its triangle tests / 8), the rest 0; closest-hit, any-hit
    and mixed, strand and ribbon rows (one record a step) alike (the same
    visits)."""
    from .test_torch_ribbon import _ribbon

    c = _case(ntri)
    _, rib, rpo, *_ = _ribbon(ntri)
    ro, rd, mtmax, smask, _ = _lanes(N_RAYS, ntri)
    head = (c["leaf"], c["first"])
    closest = (c["ro"], c["rd"], c["tmax"], 0.001, False)
    out = []
    for fn, args in (
            (strand_query_torch, closest),
            (strand_query_torch, (c["ro"], c["rd"], c["shadow"], 0.0, True)),
            (strand_mixed_query_torch, (_t(ro), _t(rd), _t(mtmax), _t(smask),
                                        0.001, 0.0))):
        counts = {"boxes": 10}  # the walk adds its counts to a caller's
        out.append(fn(c["rows"], *head, *args, counts, stats=True))
        leaves = counts.get("tris", 0) // 8
        assert out[-1][2].dtype == torch.int32
        assert out[-1][2].tolist() == [counts["boxes"] - 10, 0, 0,
                                       -(-N_RAYS // 128), leaves, leaves, 0,
                                       0]
        assert counts["boxes"] - 10 >= N_RAYS
    # the closest-hit results are those of the walk without stats, and the
    # ribbon rows count what the strand rows count (the same visits)
    t, tri, st = out[0]
    t0, tri0 = strand_query_torch(c["rows"], *head, *closest)
    assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
    assert torch.equal(tri, tri0)
    _, _, st_ribbon = strand_query_torch(_t(rib), *head, *closest, rpo=rpo,
                                         ribbon_k=1, stats=True)
    assert torch.equal(st_ribbon, st)
    assert strand.wrap_i32(2**31) == -2**31 and strand.wrap_i32(5) == 5


@pytest.mark.parametrize("layout", ["strand", "ribbon K 1", "ribbon K 4"])
@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_strand_stats_do_not_depend_on_ray_order(ntri, layout):
    """strand_query*(stats=True) on a permuted wave: the same int32 [8]
    (and each lane's t and tri, permuted), closest-hit, any-hit and mixed.
    The kernel sums a block's warps' counts before one atomic a block, in
    an order the launch does not fix; this pins that the sums, and so the
    counters, do not depend on which lanes share a warp or a block."""
    from .test_torch_ribbon import _ribbon

    c = _case(ntri)
    _, rib, rpo, *_ = _ribbon(ntri)
    rows, kw = (c["rows"], {}) if layout == "strand" else (
        _t(rib), dict(rpo=rpo, ribbon_k=int(layout[-1])))
    perm = torch.from_numpy(np.random.default_rng(ntri).permutation(N_RAYS))
    ro, rd, mtmax, smask, _ = (_t(a) for a in _lanes(N_RAYS, ntri))
    head = (c["leaf"], c["first"])
    for fn, lanes, tail in (
            (strand_query_torch, (c["ro"], c["rd"], c["tmax"]),
             (0.001, False)),
            (strand_query_torch, (c["ro"], c["rd"], c["shadow"]),
             (0.0, True)),
            (strand_mixed_query_torch, (ro, rd, mtmax, smask), (0.001, 0.0))):
        want = fn(rows, *head, *lanes, *tail, stats=True, **kw)
        got = fn(rows, *head, *(a[perm] for a in lanes), *tail, stats=True,
                 **kw)
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0].view(torch.int32),
                           want[0][perm].view(torch.int32))
        assert torch.equal(got[1], want[1][perm])
        assert int(want[2][0]) >= N_RAYS


@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_near_first_order_keeps_t_and_tie_key(ntri):
    """Near-first order against storage order: closest-hit t bits equal and
    the same tie key first[tri] (the returned copy of a split triangle may
    differ), any-hit's blocked bit, and the mixed form's lanes; near-first
    pops no more nodes here than storage order does in all."""
    c = _case(ntri)
    first = c["first"]

    def key(tri):
        return torch.where(tri >= 0, first[tri.clamp(min=0).long()], -1)

    args = (c["rows8"], c["leaf"], first, c["ro"], c["rd"])
    pops = {}
    for ordered in (False, True):
        counts = {}
        pops[ordered] = (
            packet_query_torch(*args, c["tmax"], 0.001, False, counts,
                               ordered=ordered),
            packet_query_torch(*args, c["shadow"], 0.0, True,
                               ordered=ordered), counts["boxes"])
    (sc, sa, s_boxes), (oc, oa, o_boxes) = pops[False], pops[True]
    assert torch.equal(oc[0].view(torch.int32), sc[0].view(torch.int32))
    assert torch.equal(key(oc[1]), key(sc[1]))
    assert torch.equal(oa[1] >= 0, sa[1] >= 0)
    assert o_boxes <= s_boxes
    ro, rd, mtmax, smask, h = _lanes(N_RAYS, ntri)
    margs = (c["rows8"], c["leaf"], first, _t(ro), _t(rd), _t(mtmax), 0.001,
             False)
    ms = packet_query_torch(*margs, smask=_t(smask), ordered=False)
    mo = packet_query_torch(*margs, smask=_t(smask), ordered=True)
    assert torch.equal(mo[0][:h].view(torch.int32),
                       ms[0][:h].view(torch.int32))
    assert torch.equal(key(mo[1][:h]), key(ms[1][:h]))
    assert torch.equal(mo[1][h:] >= 0, ms[1][h:] >= 0)
    assert int((sc[1] >= 0).sum()) > 0


@pytest.mark.parametrize("mode", [None, "all", "anyhit", "none", "bogus", ""])
def test_order_mode_table(monkeypatch, mode):
    """RAYTPU_ORDER_MODE as raytpu resolves it (intersect_pallas.py:451-461)
    when set: all -> near-first, none -> storage order, any other value ->
    near-first for any-hit queries only; unset -> storage order (raytpu's
    default is all). An explicit ``ordered`` wins. The plain walk,
    ``packet_query`` and the intersector factory read it at call time."""
    if mode is None:
        monkeypatch.delenv("RAYTPU_ORDER_MODE", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_ORDER_MODE", mode)
    want = {None: (False, False), "all": (True, True),
            "none": (False, False)}.get(mode, (False, True))
    assert (resolve_order(None, False), resolve_order(None, True)) == want
    for explicit in (False, True):
        assert resolve_order(explicit, False) is explicit
        assert resolve_order(explicit, True) is explicit
    c = _case(300, 512)
    ro, rd = c["ro"], c["rd"]

    class _Pack:
        class bvh:  # noqa: N801 - a stand-in for BvhPack
            node8_rows, leaf_tris, first_slots = (c["rows8"], c["leaf"],
                                                  c["first"])

    closest, any_fn = make_packet_intersectors(_Pack)
    seen = []
    real = packet.packet_query_torch

    def spy(*args, **kwargs):
        seen.append(resolve_order(kwargs.get("ordered"), args[7]))
        return real(*args, **kwargs)

    monkeypatch.setattr(packet, "packet_query_torch", spy)
    hit = closest(ro, rd, 0.001, F32_MAX)
    blocked = any_fn(ro, rd, 0.0, c["shadow"])
    assert seen == list(want)
    args = (c["rows8"], c["leaf"], c["first"], ro, rd)
    want_c = real(*args, torch.full((512,), F32_MAX), 0.001, False,
                  ordered=want[0])
    assert torch.equal(hit.tri, want_c[1])
    assert torch.equal(blocked, real(*args, c["shadow"], 0.0, True,
                                     ordered=want[1])[1] >= 0)
    # packet_query dispatches the CPU tensors to the plain walk, ordered
    # passed through
    t, tri = packet_query(*args, c["tmax"], 0.001, False, ordered=True)
    want_o = real(*args, c["tmax"], 0.001, False, ordered=True)
    assert torch.equal(tri, want_o[1])


def test_stats_and_order_arguments_are_checked():
    """A packet that is not a positive multiple of 128 raises (raytpu
    asserts it); the CUDA wrappers refuse CPU tensors and count nothing."""
    c = _case(5, 64)
    args = (c["rows8"], c["leaf"], c["first"], c["ro"], c["rd"], c["tmax"],
            0.001, False)
    for bad in (0, 100, 200):
        with pytest.raises(ValueError, match="packet"):
            packet_query_torch(*args, with_stats=True, packet=bad)
    before = (packet_query_cuda.ordered_launches, packet_query_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        packet_query_cuda(*args, ordered=True, with_stats=True)
    assert (packet_query_cuda.ordered_launches,
            packet_query_cuda.launches) == before
    assert packet.PACKET == 4096 or packet.PACKET % 128 == 0


@pytest.mark.cuda
def test_stats_and_near_first_kernels_bit_equal_plain_on_cuda():
    """packet_walk.cu's near-first instances and both walks' stats against
    the plain versions on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    c = {k: v.cuda() for k, v in _case(3000, 65536).items()}
    for ordered in (False, True):
        for bound, tmin, any_hit in ((c["tmax"], 0.001, False),
                                     (c["shadow"], 0.0, True)):
            args = (c["rows8"], c["leaf"], c["first"], c["ro"], c["rd"],
                    bound, tmin, any_hit)
            got = packet_query_cuda(*args, ordered=ordered, with_stats=True)
            want = packet_query_torch(*args, ordered=ordered,
                                      with_stats=True)
            torch.cuda.synchronize()
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
    args = (c["rows"], c["leaf"], c["first"], c["ro"], c["rd"], c["tmax"],
            0.001, False)
    got = strand_query(*args, stats=True)
    want = strand_query_torch(*args, stats=True)
    assert torch.equal(got[2], want[2])
