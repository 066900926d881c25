"""The ribbon strand layout in the port (``RAYTPU_RIBBON``): the pack's
``ribbon_rows`` against raytpu's pack, the plain ribbon walk against the
plain strand walk (bit-equal: the ribbon is the same threading with
renumbered nodes, so every lane visits the same boxes and leaves in the
same order), the factories' choice of layout, and a frame with the ribbon
against the default frame. The slow test holds the plain ribbon walk to
raytpu's persistent kernel over ribbon rows in interpret mode. The CUDA
kernel's ribbon form is held to the plain version by the ``cuda``-marked
test and by chip_smoke.py (phases 3g, 11a)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.io.png import quantize_rgba32f
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.accel.strandtree import build_ribbon_tree
from raytpu_torch.engine import render
from raytpu_torch.kernels import strand
from raytpu_torch.kernels.strand import (
    make_strand_intersectors,
    make_strand_mixed_query,
    strand_mixed_query_torch,
    strand_query_cuda,
    strand_query_torch,
)
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_scene
from raytpu_torch.types import RenderConfig

from .conftest import isolated
from .test_torch_host import scene_path
from .test_torch_mixed import _lanes
from .test_torch_render import _packs
from .test_torch_strand import _build, _rays, _soup

F32_MAX = np.float32(3.40282347e38)
N_RAYS = 768


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


@functools.lru_cache(maxsize=None)
def _ribbon(ntri: int):
    """(strand rows, ribbon rows, rows per octant, leaf rows, slot ->
    triangle) of the strand tests' soup."""
    rows, leaf, *_, order = _build(ntri)
    bvh, _ = build_bvh(*_soup(ntri))
    rib = build_ribbon_tree(bvh)
    return rows, rib.rows, rib.rows_per_oct, leaf, order


@functools.lru_cache(maxsize=None)
def _port_pack(name: str, tables: str = "auto"):
    return pack_scene(load_scene(scene_path(name)), "cpu", tables=tables)


@pytest.mark.parametrize("name,tables", [("gallery", "auto"),
                                         ("gallery", "stream"),
                                         ("small", "auto")])
def test_pack_ribbon_rows_equal_raytpus(name, tables):
    """The port's pack has ribbon rows exactly where raytpu's has them,
    bit-equal: above 256 slots outside a stream pack; None at <= 256 slots
    and in a stream pack. ``.to()`` moves them."""
    want = rt_pack_scene(raytpu.load_scene(scene_path(name)), tables=tables,
                         as_numpy=True).bvh.ribbon_rows
    pack = _port_pack(name, tables)
    got = pack.bvh.ribbon_rows
    if name == "gallery" and tables == "auto":
        assert pack.n_triangles > 256
        assert want is not None and got is not None
        assert got.dtype == torch.float32
        n = pack.bvh.nodes.shape[0]
        assert tuple(got.shape) == (8 * -(-n // 16), 128)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        assert torch.equal(pack.to("cpu").bvh.ribbon_rows, got)
    else:
        assert want is None and got is None


@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_plain_ribbon_walk_bit_equal_strand_walk(ntri):
    """Closest-hit, any-hit and mixed: the plain walk over ribbon rows
    returns the strand layout's t and tri bits, with the same counts."""
    rows, rib, rpo, leaf, _ = _ribbon(ntri)
    ro, rd = _rays(N_RAYS, seed=ntri)
    tmax = np.full(N_RAYS, F32_MAX, np.float32)
    tmax[3::10] = 5.0
    tmax[::7] = -np.inf
    shadow = np.full(N_RAYS, 6.0, np.float32)
    shadow[::5] = -np.inf
    lf = _t(leaf)
    first = strand.first_slots(lf)
    for bound, tmin, any_hit in ((tmax, 0.001, False), (shadow, 0.0, True)):
        args = (lf, first, _t(ro), _t(rd), _t(bound), tmin, any_hit)
        c_strand, c_rib = {}, {}
        want = strand_query_torch(_t(rows), *args, counts=c_strand)
        got = strand_query_torch(_t(rib), *args, counts=c_rib, rpo=rpo,
                                 ribbon_k=4)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        assert c_rib["boxes"] == c_strand["boxes"]
        assert c_rib.get("tris", 0) == c_strand.get("tris", 0)
    ro, rd, mtmax, smask, _ = _lanes(N_RAYS, ntri)
    args = (lf, first, _t(ro), _t(rd), _t(mtmax), _t(smask), 0.001, 0.0)
    want = strand_mixed_query_torch(_t(rows), *args)
    got = strand_mixed_query_torch(_t(rib), *args, rpo=rpo, ribbon_k=8)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert int((want[1] >= 0).sum()) > 0


def test_ribbon_layout_arguments_are_checked():
    """``rpo`` must match the rows (8 per octant's rpo) and ``ribbon_k``
    lie in 1..8, raytpu's bound; the CUDA wrapper refuses CPU tensors and
    counts nothing."""
    rows, rib, rpo, leaf, _ = _ribbon(300)
    ro, rd = _rays(64, seed=1)
    lf = _t(leaf)
    args = (lf, strand.first_slots(lf), _t(ro), _t(rd),
            _t(np.full(64, F32_MAX, np.float32)), 0.001, False)
    for bad in (dict(rpo=rpo + 1), dict(rpo=rpo, ribbon_k=0),
                dict(rpo=rpo, ribbon_k=9), dict(rpo=-1)):
        with pytest.raises(ValueError):
            strand_query_torch(_t(rib), *args, **bad)
    before = (strand_query_cuda.launches, strand_query_cuda.ribbon_launches)
    with pytest.raises(ValueError, match="CUDA"):
        strand_query_cuda(_t(rib), *args, rpo=rpo)
    assert (strand_query_cuda.launches,
            strand_query_cuda.ribbon_launches) == before


class _Spy:
    """Records the rows and layout keywords each strand walk is given."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("strand_query", "strand_block_query",
                     "strand_mixed_query"):
            real = getattr(strand, name)
            monkeypatch.setattr(strand, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def spy(rows, *args, **kwargs):
            self.calls.append((name, rows, kwargs))
            return real(rows, *args, **kwargs)
        return spy


@pytest.mark.parametrize("ribbon", [None, "0", "4", "8"])
@pytest.mark.parametrize("persistent", ["1", "0"])
def test_factories_choose_the_layout_like_raytpu(monkeypatch, ribbon,
                                                 persistent):
    """RAYTPU_RIBBON = K > 0 puts the per-ray walk on the pack's ribbon
    rows with rpo = rows / 8 and ribbon_k = K; the block walk
    (RAYTPU_STRAND_PERSISTENT=0) keeps the strand rows, and the mixed query
    (always the per-ray walk) follows K alone. Every choice returns the
    same hits."""
    pack = _port_pack("gallery")
    if ribbon is None:
        monkeypatch.delenv("RAYTPU_RIBBON", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_RIBBON", ribbon)
    monkeypatch.setenv("RAYTPU_STRAND_PERSISTENT", persistent)
    spy = _Spy(monkeypatch)
    closest, any_fn = make_strand_intersectors(pack)
    mixed = make_strand_mixed_query(pack)
    ro, rd = _rays(256, seed=3)
    ro = _t(ro * 0.5 + np.float32([0, 1, -6]))
    rd = _t(rd)
    hit = closest(ro, rd, 0.001, F32_MAX)
    blocked = any_fn(ro, rd, 0.0, torch.full((256,), 4.0))
    t, tri = mixed(ro, rd, torch.full((256,), F32_MAX),
                   torch.zeros(256), tmin=0.001, shadow_tmin=0.0)
    k = int(ribbon or 0)
    rib = pack.bvh.ribbon_rows
    want_rpo = rib.shape[0] // 8
    names = [c[0] for c in spy.calls]
    assert names == (["strand_query"] * 2 if persistent == "1"
                     else ["strand_block_query"] * 2) + ["strand_mixed_query"]
    for name, rows, kwargs in spy.calls:
        on_ribbon = k > 0 and name != "strand_block_query"
        assert rows is (rib if on_ribbon else pack.bvh.strand_rows)
        assert kwargs == (dict(rpo=want_rpo, ribbon_k=k) if on_ribbon
                          else {})
    default = strand_query_torch(pack.bvh.strand_rows, pack.bvh.leaf_tris,
                                 pack.bvh.first_slots, ro, rd,
                                 torch.full((256,), F32_MAX), 0.001, False)
    first = pack.bvh.first_slots

    def key(x):  # the block walk may return another copy of a triangle
        return torch.where(x >= 0, first[x.clamp(min=0).long()], -1)

    assert torch.equal(key(hit.tri), key(default[1]))
    assert torch.equal(hit.t.view(torch.int32), default[0].view(torch.int32))
    assert torch.equal(tri, default[1])
    assert torch.equal(t.view(torch.int32), default[0].view(torch.int32))
    assert int(hit.valid.sum()) > 50 and bool(blocked.any())


def test_factories_refuse_k_above_8_and_fall_back_without_ribbon_rows(
        monkeypatch):
    """K = 9 raises at either factory (raytpu asserts 1 <= ribbon_k <= 8);
    a stream pack has no ribbon rows, so K = 4 keeps the strand rows."""
    spy = _Spy(monkeypatch)
    monkeypatch.setenv("RAYTPU_RIBBON", "9")
    for factory in (make_strand_intersectors, make_strand_mixed_query):
        with pytest.raises(ValueError, match="RAYTPU_RIBBON"):
            factory(_port_pack("gallery"))
    monkeypatch.setenv("RAYTPU_RIBBON", "4")
    stream = _port_pack("gallery", "stream")
    closest, _ = make_strand_intersectors(stream)
    ro, rd = _rays(32, seed=5)
    closest(_t(ro), _t(rd), 0.001, F32_MAX)
    assert len(spy.calls) == 1
    assert spy.calls[0][1] is stream.bvh.strand_rows
    assert spy.calls[0][2] == {}


def _png(frame):
    return quantize_rgba32f(frame)


@pytest.mark.parametrize("backend", ["sorted", "mixed"])
def test_ribbon_frame_equals_default_frame(monkeypatch, backend):
    """A 48x32 gallery frame (4,096 slots) with RAYTPU_RIBBON=4 gives the
    default frame's PNG, and its f32 pixels bit for bit: on the immediate
    schedule (every wave on the per-ray strand walk) and with deferred NEE
    through the strand walk's mixed query."""
    (pack, cam), _ = _packs("gallery")
    cfg = RenderConfig(width=48, height=32, seed=5, samples=1, bounces=3,
                       chunk_size=16, intersector="strand",
                       bounce_backend=backend)
    monkeypatch.delenv("RAYTPU_RIBBON", raising=False)
    default = render.render_frame(pack, cam, cfg)
    monkeypatch.setenv("RAYTPU_RIBBON", "4")
    spy = _Spy(monkeypatch)
    ribbon = render.render_frame(pack, cam, cfg)
    assert spy.calls and all(c[2].get("rpo", 0) > 0 for c in spy.calls)
    np.testing.assert_array_equal(_png(ribbon), _png(default))
    np.testing.assert_array_equal(ribbon.view(np.uint32),
                                  default.view(np.uint32))
    assert float((_png(default).max(-1) > 0).mean()) > 0.3


@pytest.mark.cuda
def test_ribbon_kernel_bit_equal_plain_on_cuda():
    """strand_walk.cu over ribbon rows against the plain walk and against
    its own strand-layout launch, closest, any-hit and mixed, with the
    stats counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, rib, rpo, leaf, _ = _ribbon(3000)
    ro, rd, tmax, smask, _ = _lanes(65536, 9)
    dev = [_t(a).cuda() for a in (rows, rib, leaf, ro, rd, tmax, smask)]
    rows, rib, leaf, ro, rd, tmax, smask = dev
    first = strand.first_slots(leaf)
    for any_hit, tmin in ((False, 0.001), (True, 0.0)):
        args = (leaf, first, ro, rd, tmax, tmin, any_hit)
        before = strand_query_cuda.ribbon_launches
        got = strand_query_cuda(rib, *args, rpo=rpo, stats=True)
        assert strand_query_cuda.ribbon_launches == before + 1
        want = strand_query_torch(rib, *args, rpo=rpo, stats=True)
        strand_layout = strand_query_cuda(rows, *args)
        torch.cuda.synchronize()
        for a, b in ((got[0], want[0]), (got[0], strand_layout[0])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[1], strand_layout[1])
        assert torch.equal(got[2], want[2])
    args = (leaf, first, ro, rd, tmax, smask, 0.001, 0.0)
    got = strand.strand_mixed_query_cuda(rib, *args, rpo=rpo)
    want = strand_mixed_query_torch(rows, *args)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.slow
@isolated
def test_plain_ribbon_walk_matches_raytpu_persistent_ribbon():
    """raytpu's strand_query_persistent over ribbon rows (ribbon_k 4, 8
    walkers, service_k 2, interpret mode) against the port's plain ribbon
    walk, closest-hit and any-hit, as tests/test_strand.py holds raytpu's
    ribbon to its strand kernel: the same original triangle on closest
    lanes and t to rtol 1e-4 (XLA:CPU's FMA contraction), the blocked bit
    on shadow lanes. The port's plain walk (tie keys, conservative box
    test) equals raytpu's brute sweep on these rays, and so does raytpu's
    ribbon kernel."""
    from raytpu.kernels.strand_persistent import strand_query_persistent

    _, rib, rpo, leaf, order = _ribbon(300)
    ro, rd = _rays(1024, seed=7)
    oct_ = (rd[:, 0] < 0) + 2 * (rd[:, 1] < 0) + 4 * (rd[:, 2] < 0)
    idx = np.argsort(oct_, kind="stable")
    ro, rd = ro[idx], rd[idx]
    tmax = np.full(1024, F32_MAX, np.float32)
    tmax[::9] = -np.inf
    shadow = np.full(1024, 4.0, np.float32)
    shadow[::9] = -np.inf
    lf = _t(leaf)
    first = strand.first_slots(lf)
    live = tmax >= 0
    for bound, tmin, any_hit in ((tmax, 0.001, False), (shadow, 0.0, True)):
        got_t, got_tri = (a.numpy() for a in strand_query_torch(
            _t(rib), lf, first, _t(ro), _t(rd), _t(bound), tmin, any_hit,
            rpo=rpo, ribbon_k=4))
        want_t, want_tri = (np.asarray(a) for a in strand_query_persistent(
            jnp.asarray(rib), jnp.asarray(leaf),
            *(jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)),
            jnp.asarray(bound), tmin=tmin, any_hit=any_hit, interpret=True,
            walkers=8, service_k=2, ribbon_rpo=rpo, ribbon_k=4))
        if any_hit:
            np.testing.assert_array_equal(got_tri[live] >= 0,
                                          want_tri[live] >= 0)
            assert (got_tri[live] >= 0).sum() > 50
            continue
        tri_g = np.where(got_tri >= 0, order[np.maximum(got_tri, 0)], -1)
        tri_w = np.where(want_tri >= 0, order[np.maximum(want_tri, 0)], -1)
        np.testing.assert_array_equal(tri_g[live], tri_w[live])
        hit = live & (got_tri >= 0)
        np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4)
        assert hit.sum() > 100
