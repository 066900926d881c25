"""raytpu's remaining engine arms in the port: the mixed-lane forms of the
strand walk and the packet walk, ``bounce_backend="mixed"`` and the sort
knobs.

The mixed forms (``strand_mixed_query_torch``, ``packet_query_torch(...,
smask=...)``) are held to raytpu's kernels in interpret mode: closest
lanes on the same original triangle (spatial splits store one triangle in
several slots with identical data) and ``t`` to rtol 1e-4 (XLA:CPU's FMA
contraction, the bar of tests/test_torch_strand.py); shadow lanes on the
blocked bit, the only part of their contract. Against the port's own
closest-hit and any-hit walks they are bit-equal.

Every new engine arm only reorders per-lane work, so its frame must equal
the port's default frame: 0 PNG pixels differ and the f32 frames agree to
atol 1e-6, as tests/test_torch_fused.py holds fused mode. Against raytpu's
``bvh`` frame the bar is tests/imgdiff.py's (<= 2% of PNG pixels differ,
SSIM >= 0.99)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.scene import pack as rt_pack
from raytpu_torch.engine import render
from raytpu_torch.kernels import strand
from raytpu_torch.kernels.packet import packet_query_cuda, packet_query_torch
from raytpu_torch.kernels.strand import (
    strand_mixed_query_cuda,
    strand_mixed_query_torch,
    strand_query_torch,
)
from raytpu_torch.scene import pack as port_pack
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_scene
from raytpu_torch.types import RenderConfig

from .conftest import isolated
from .imgdiff import assert_images_equiv
from .test_torch_binned import _mixed_rays
from .test_torch_host import scene_path
from .test_torch_packet import _build as _build_bvh8
from .test_torch_render import _packs
from .test_torch_strand import _build, _rays

F32_MAX = np.float32(3.40282347e38)
CFG = dict(width=64, height=32, seed=11, samples=1, bounces=3, chunk_size=16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _triangle(tri, order):
    return np.where(tri >= 0, order[np.maximum(tri, 0)], -1)


def _lanes(n, seed):
    """Mixed lanes on the strand tests' rays: the first half closest-hit
    (some with a finite open bound), the second half shadow rays with a
    finite bound; dead lanes of both kinds. (ro, rd, tmax, smask, h)."""
    ro, rd = _rays(n, seed)
    rng = np.random.default_rng(seed)
    h = n // 2
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[3:h:10] = 5.0
    tmax[h:] = rng.uniform(1, 12, n - h)
    tmax[::9] = -np.inf
    smask = np.zeros(n, np.float32)
    smask[h:] = 1.0
    return ro, rd, tmax, smask, h


def _split(tmax, h):
    """The closest half's and the shadow half's bounds, each with the other
    half dead."""
    closest, shadow = tmax.copy(), tmax.copy()
    closest[h:] = -np.inf
    shadow[:h] = -np.inf
    return closest, shadow


@isolated
def test_plain_strand_mixed_matches_raytpu_persistent_kernel():
    """raytpu's strand_query_persistent(mixed=True) in interpret mode (8
    walkers, service_k 2, so strands refill mid-wave) against the plain
    mixed walk: a 300-triangle soup and 512 lanes."""
    from raytpu.kernels.strand_persistent import strand_query_persistent

    rows, leaf, _, _, _, order = _build(300)
    ro, rd, tmax, smask, h = _lanes(512, 4)
    t = _t(leaf)
    got_t, got_tri = (a.numpy() for a in strand_mixed_query_torch(
        _t(rows), t, strand.first_slots(t), _t(ro), _t(rd), _t(tmax),
        _t(smask), 0.001, 0.0))
    want_t, want_tri = (np.asarray(a) for a in strand_query_persistent(
        jnp.asarray(rows), jnp.asarray(leaf),
        *(jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)),
        jnp.asarray(tmax), tmin=0.001, interpret=True, walkers=8,
        service_k=2, smask=jnp.asarray(smask), mixed=True,
        shadow_tmin=0.0))
    live = tmax >= 0
    c, s = live & (smask == 0), live & (smask == 1)
    np.testing.assert_array_equal(_triangle(got_tri[c], order),
                                  _triangle(want_tri[c], order))
    hit = c & (got_tri >= 0)
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4)
    np.testing.assert_array_equal(got_tri[s] >= 0, want_tri[s] >= 0)
    assert (got_tri[~live] == -1).all()
    assert hit.sum() > 50 and (got_tri[s] >= 0).sum() > 50


@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_plain_mixed_walks_equal_separate_walks(ntri):
    """Each plain mixed form against the port's own closest-hit walk on
    the closest half (t bits, tri) and any-hit walk on the shadow half
    (the blocked bit), on one launch's worth of lanes."""
    rows, leaf, *_ = _build(ntri)
    rows8 = _build_bvh8(ntri)[0]
    ro, rd, tmax, smask, h = _lanes(1500, ntri)
    closest, shadow = _split(tmax, h)
    lf = _t(leaf)
    first = strand.first_slots(lf)
    for name, tree, mixed, plain in (
            ("strand", _t(rows),
             lambda *a: strand_mixed_query_torch(*a, _t(smask), 0.001, 0.0),
             strand_query_torch),
            ("packet", _t(rows8),
             lambda *a: packet_query_torch(*a, 0.001, False,
                                           smask=_t(smask),
                                           shadow_tmin=0.0),
             packet_query_torch)):
        args = (tree, lf, first, _t(ro), _t(rd))
        t, tri = mixed(*args, _t(tmax))
        tc, tric = plain(*args, _t(closest), 0.001, False)
        _, tria = plain(*args, _t(shadow), 0.0, True)
        assert torch.equal(tri[:h], tric[:h]), name
        assert torch.equal(t[:h].view(torch.int32),
                           tc[:h].view(torch.int32)), name
        assert torch.equal(tri[h:] >= 0, tria[h:] >= 0), name
        dead = _t(tmax) < 0
        assert bool((tri[dead] == -1).all()), name
        if ntri > 5:
            assert int((tri[:h] >= 0).sum()) > 100, name
            assert int((tri[h:] >= 0).sum()) > 100, name


def test_plain_packet_mixed_matches_raytpu_mixed_packet_kernel():
    """raytpu's packet_query(mixed=True) in interpret mode against the
    plain walk's mixed form on the binned tests' mixed lanes (300
    triangles, 256 lanes), and raytpu's capped two-round property
    (tests/test_intersect.py): a round capped at tmax = 6 and a second
    round over [6, tmax) from tmin = shadow_tmin = 6 give the one-round
    answer lane for lane."""
    from raytpu.kernels.intersect_pallas import packet_query

    rows8, leaf, *_, order = _build_bvh8(300)
    ro, rd, tmax, smask, _, h = _mixed_rays(256, 8, 1)
    lf = _t(leaf)
    args = (_t(rows8), lf, strand.first_slots(lf), _t(ro), _t(rd))

    def port(bound, tmin, shadow_tmin):
        return (a.numpy() for a in packet_query_torch(
            *args, _t(bound), tmin, False, smask=_t(smask),
            shadow_tmin=shadow_tmin))

    t, tri = port(tmax, 0.001, 0.0)
    want_t, want_tri = (np.asarray(a) for a in packet_query(
        jnp.asarray(rows8), jnp.asarray(leaf),
        *(jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)),
        jnp.asarray(tmax), jnp.asarray(smask), tmin=0.001, mixed=True,
        shadow_tmin=0.0, interpret=True, packet=256))
    live = tmax >= 0
    c, s = live & (smask == 0), live & (smask == 1)
    np.testing.assert_array_equal(_triangle(tri[c], order),
                                  _triangle(want_tri[c], order))
    hit = c & (tri >= 0)
    np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-4)
    np.testing.assert_array_equal(tri[s] >= 0, want_tri[s] >= 0)
    assert hit.any() and (tri[s] >= 0).any()

    cap = np.float32(6.0)
    t1, tri1 = port(np.minimum(tmax, cap), 0.001, 0.0)
    unresolved = (tri1 < 0) & (tmax > cap)
    t2, tri2 = port(np.where(unresolved, tmax, -np.inf).astype(np.float32),
                    float(cap), float(cap))
    t12 = np.where(tri1 >= 0, t1, t2)
    tri12 = np.where(tri1 >= 0, tri1, tri2)
    # each round returns the first copy of a triangle it tests: the closest
    # lanes are compared on the tie key
    first = args[2].numpy()

    def key(x):
        return np.where(x >= 0, first[np.maximum(x, 0)], -1)

    np.testing.assert_array_equal(key(tri12[:h]), key(tri[:h]))
    # a closest lane's t is its hit's, or its bound when it misses (here
    # some closest bounds are finite and below the cap)
    hit = tri[:h] >= 0
    np.testing.assert_array_equal(t12[:h][hit].view(np.int32),
                                  t[:h][hit].view(np.int32))
    np.testing.assert_array_equal(tri12[h:] >= 0, tri[h:] >= 0)
    assert unresolved[:h].any() and unresolved[h:].any()


def test_mixed_inputs_refused():
    """The mixed form needs any_hit False, and the CUDA wrappers refuse CPU
    tensors."""
    rows8, leaf, *_ = _build_bvh8(5)
    ro, rd, tmax, smask, _ = _lanes(64, 1)
    lf = _t(leaf)
    args = (_t(rows8), lf, strand.first_slots(lf), _t(ro), _t(rd), _t(tmax))
    with pytest.raises(ValueError, match="any_hit"):
        packet_query_torch(*args, 0.0, True, smask=_t(smask))
    with pytest.raises(ValueError, match="CUDA"):
        packet_query_cuda(*args, 0.001, False, _t(smask), 0.0)
    rows = _build(5)[0]
    with pytest.raises(ValueError, match="CUDA"):
        strand_mixed_query_cuda(_t(rows), *args[1:], _t(smask), 0.001, 0.0)


def _png_diff(a, b) -> int:
    return int(np.any(quantize_rgba32f(a) != quantize_rgba32f(b),
                      axis=-1).sum())


def _frame(monkeypatch, env=None, pack=None, **cfg):
    """The 64x32 gallery (4,096 slots) with the given knobs set: (frame,
    the last path's WAVE_STATS)."""
    for name in ("RAYTPU_LARGE_WAVE", "RAYTPU_MORTON_BITS",
                 "RAYTPU_B0_STRAND", "RAYTPU_B0S_NOSORT",
                 "RAYTPU_COMPACT_DIV"):
        monkeypatch.delenv(name, raising=False)
    for name, value in (env or {}).items():
        monkeypatch.setenv(name, value)
    (gallery, cam), _ = _packs("gallery", 64, 32)
    frame = render.render_frame(pack or gallery, cam,
                                RenderConfig(**CFG, **cfg))
    return frame, dict(render.WAVE_STATS)


@functools.lru_cache(maxsize=None)
def _treelet_pack():
    """The gallery with treelets, for bounce_backend='binned'."""
    return pack_scene(load_scene(scene_path("gallery")), "cpu",
                      treelets="always")


@functools.lru_cache(maxsize=None)
def _raytpu_bvh_frame():
    _, (rpack, rcam) = _packs("gallery", 64, 32)
    return rt_render.render_frame(
        rpack, rcam, raytpu.RenderConfig(**CFG, intersector="bvh"))


def _spy(monkeypatch, calls):
    """Wrap the intersector factories so each query records its route."""
    def tag(fn, name):
        def query(*args, **kwargs):
            calls.add(name)
            return fn(*args, **kwargs)
        return query

    def pair(name, factory):
        def make(pack):
            c, a = factory(pack)
            return tag(c, f"{name} closest"), tag(a, f"{name} any")
        return make

    for attr, name in (("make_packet_intersectors", "packet"),
                       ("make_strand_intersectors", "strand")):
        monkeypatch.setattr(render, attr, pair(name, getattr(render, attr)))
    for attr, name in (("make_binned_query", "binned mixed"),
                       ("make_strand_mixed_query", "strand mixed")):
        real = getattr(render, attr)
        monkeypatch.setattr(render, attr,
                            lambda pack, real=real, name=name:
                            tag(real(pack), name))


@pytest.mark.parametrize("intersector", ["packet", "strand"])
def test_mixed_backend_frame_equals_binned_and_sorted(monkeypatch,
                                                      intersector):
    """bounce_backend='mixed': strand primary and last shadow waves, the
    bounces' deferred NEE through the strand walk's mixed query. Its frame
    equals the binned deferred-NEE frame and the sorted frame."""
    calls = set()
    _spy(monkeypatch, calls)
    mixed, _ = _frame(monkeypatch, pack=_treelet_pack(),
                      intersector=intersector, bounce_backend="mixed")
    assert calls == {"strand closest", "strand mixed", "strand any"}
    calls.clear()
    binned, _ = _frame(monkeypatch, pack=_treelet_pack(),
                       intersector="packet", bounce_backend="binned")
    assert calls == {"strand closest", "binned mixed", "strand any"}
    sorted_, _ = _frame(monkeypatch)
    for other in (binned, sorted_):
        assert _png_diff(mixed, other) == 0
        np.testing.assert_allclose(mixed, other, rtol=0, atol=1e-6)
    assert float((quantize_rgba32f(mixed).max(-1) > 0).mean()) > 0.5


@pytest.mark.parametrize("intersector", ["packet", "strand"])
def test_mixed_backend_frame_matches_raytpu(monkeypatch, intersector):
    mixed, _ = _frame(monkeypatch, intersector=intersector,
                      bounce_backend="mixed")
    assert_images_equiv(quantize_rgba32f(mixed) / 255.0,
                        quantize_rgba32f(_raytpu_bvh_frame()) / 255.0)


@pytest.mark.parametrize("env", [
    {"RAYTPU_MORTON_BITS": "4"},
    {"RAYTPU_B0_STRAND": "0"},
    {"RAYTPU_B0S_NOSORT": "1"},
], ids=["morton4", "b0_packet", "b0s_nosort"])
def test_sort_knobs_leave_the_frame(monkeypatch, env):
    """Each knob changes which code runs, never the frame.
    RAYTPU_B0_STRAND=0 takes the primary and first shadow waves to the
    packet walk."""
    calls = set()
    _spy(monkeypatch, calls)
    frame, _ = _frame(monkeypatch, env)
    default, _ = _frame(monkeypatch)
    assert _png_diff(frame, default) == 0
    np.testing.assert_allclose(frame, default, rtol=0, atol=1e-6)
    assert ("packet closest" in calls) == ("RAYTPU_B0_STRAND" in env)


@pytest.mark.parametrize("value", [None, "100", "5000"])
def test_sort_min_tris_is_raytpus_and_pack_and_route_agree(monkeypatch,
                                                           value):
    """RAYTPU_SORT_MIN_TRIS as raytpu reads it; pack_scene builds the
    strand tree and the route sorts bounce waves on the same side of it
    (the gallery has 4,096 slots)."""
    if value is None:
        monkeypatch.delenv("RAYTPU_SORT_MIN_TRIS", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_SORT_MIN_TRIS", value)
    assert port_pack._sort_min_tris() == rt_pack._sort_min_tris()
    pack = pack_scene(load_scene(scene_path("gallery")), "cpu")
    above = pack.n_triangles > port_pack._sort_min_tris()
    assert (pack.bvh.strand_rows is not None) == above
    assert render._route(pack, RenderConfig(**CFG)).sort_bounced == above


@pytest.mark.cuda
def test_strand_mixed_kernel_bit_equal_plain_on_cuda():
    """strand_walk.cu's mixed form against its plain version and against
    the separate closest and any-hit launches, on the same CUDA
    tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, leaf, *_ = _build(3000)
    ro, rd, tmax, smask, h = _lanes(65536, 9)
    closest, shadow = _split(tmax, h)
    dev = [_t(a).cuda() for a in (rows, leaf)]
    args = (*dev, strand.first_slots(dev[1]), _t(ro).cuda(), _t(rd).cuda())
    before = strand_mixed_query_cuda.launches
    tk, trk = strand_mixed_query_cuda(*args, _t(tmax).cuda(),
                                      _t(smask).cuda(), 0.001, 0.0)
    tp, trp = strand_mixed_query_torch(*args, _t(tmax).cuda(),
                                       _t(smask).cuda(), 0.001, 0.0)
    torch.cuda.synchronize()
    assert strand_mixed_query_cuda.launches == before + 1
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(trk, trp)
    tc, trc = strand.strand_query_cuda(*args, _t(closest).cuda(), 0.001,
                                       False)
    _, tra = strand.strand_query_cuda(*args, _t(shadow).cuda(), 0.0, True)
    assert torch.equal(trk[:h], trc[:h])
    assert torch.equal(tk[:h].view(torch.int32), tc[:h].view(torch.int32))
    assert torch.equal(trk[h:] >= 0, tra[h:] >= 0)


@pytest.mark.cuda
def test_packet_mixed_kernel_bit_equal_plain_on_cuda():
    """packet_walk.cu's mixed form against its plain version and against
    the separate closest and any-hit launches, on the same CUDA
    tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows8, leaf, *_ = _build_bvh8(3000)
    ro, rd, tmax, smask, h = _lanes(65536, 9)
    closest, shadow = _split(tmax, h)
    dev = [_t(a).cuda() for a in (rows8, leaf)]
    args = (*dev, strand.first_slots(dev[1]), _t(ro).cuda(), _t(rd).cuda())
    sm = _t(smask).cuda()
    before = packet_query_cuda.mixed_launches
    tk, trk = packet_query_cuda(*args, _t(tmax).cuda(), 0.001, False, sm,
                                0.0)
    tp, trp = packet_query_torch(*args, _t(tmax).cuda(), 0.001, False,
                                 smask=sm, shadow_tmin=0.0)
    torch.cuda.synchronize()
    assert packet_query_cuda.mixed_launches == before + 1
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(trk, trp)
    tc, trc = packet_query_cuda(*args, _t(closest).cuda(), 0.001, False)
    _, tra = packet_query_cuda(*args, _t(shadow).cuda(), 0.0, True)
    assert torch.equal(trk[:h], trc[:h])
    assert torch.equal(tk[:h].view(torch.int32), tc[:h].view(torch.int32))
    assert torch.equal(trk[h:] >= 0, tra[h:] >= 0)
