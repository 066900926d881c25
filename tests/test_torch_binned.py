"""The binned treelet route (raytpu_torch.kernels.binned and the deferred-NEE
engine mode) against raytpu on the CPU: the treelet copy, the stream and
treelet tables of the pack, the treelet walk's plain version against
raytpu's Pallas kernel (interpret mode) and the port's brute sweep, the
round loop against raytpu's, frames and ``count_rays`` on a stream pack of
the atrium, and the routing.

Tolerances: ``tri`` and the blocked bit are exact. ``t`` is held bit-equal
to the port's own brute sweep and to rtol 1e-4 against raytpu, whose
interpret-mode kernels run under XLA:CPU's FMA contraction (the bar of
tests/test_torch_strand.py).
Frames are compared as PNG pixels with tests/imgdiff.py's cross-engine bar
(<= 2% of pixels differ, SSIM >= 0.99). Triangles that spatial splits
store in several slots carry identical data, so a slot is compared through
the original triangle it holds."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.accel.bvh import build_bvh as rt_build_bvh
from raytpu.accel.treelets import build_treelets as rt_build_treelets
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.kernels.binned import _binned_launch
from raytpu.kernels.intersect import (
    intersect_any_bruteforce as rt_any,
    intersect_bruteforce as rt_closest,
)
from raytpu.kernels.binned import make_binned_query as rt_make_binned_query
from raytpu.scene.pack import flatten_world_triangles as rt_flatten
from raytpu.scene.pack import pack_camera as rt_pack_camera
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.accel.treelets import build_treelets, validate_treelets
from raytpu_torch.engine import render
from raytpu_torch.kernels import binned
from raytpu_torch.kernels.binned import (
    binned_walk,
    binned_walk_cuda,
    binned_walk_torch,
    make_binned_intersectors,
    make_binned_query,
)
from raytpu_torch.kernels.intersect import (
    intersect_any_bruteforce,
    intersect_bruteforce,
)
from raytpu_torch.kernels.strand import first_slots
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_intersect import _random_soup
from .test_torch_host import scene_path
from .test_torch_packet import _node_row, lost_case
from .test_torch_strand import _f32, _tri_rows

F32_MAX = np.float32(3.40282347e38)
FRAME = dict(width=32, height=24, seed=3, samples=1, chunk_size=8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _soup(n_tris: int, seed: int, budget: int):
    """A raytpu test soup (tests/test_binned.py's _soup_treelets) built by
    both packages: (port treelets, raytpu treelets, bvh8, slot-ordered
    p0/e1/e2, slot -> triangle, leaf rows [Nl, 80])."""
    rng = np.random.default_rng(seed)
    a, b, c = _random_soup(n_tris, rng)
    p0, e1, e2 = a, b - a, c - a
    bvh, bvh8 = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    leaf = per.reshape(-1, 80)
    _, rt_bvh8 = rt_build_bvh(p0, e1, e2)
    return dict(tl=build_treelets(bvh8, leaf, budget_rows=budget),
                rt_tl=rt_build_treelets(rt_bvh8, leaf, budget_rows=budget),
                bvh8=bvh8, p0=per[:, 0:3].copy(), e1=per[:, 3:6].copy(),
                e2=per[:, 6:9].copy(), order=order, leaf=leaf,
                first=first_slots(_t(leaf)))


def _triangle(tri, order):
    return np.where(tri >= 0, order[np.maximum(tri, 0)], -1)


def _mixed_rays(n, seed, n_slots):
    """Half closest, half shadow lanes with dead lanes of both, finite
    incoming bounds and incoming slots on some closest lanes, and exactly
    zero direction components."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    rd[::11, 0] = 0.0
    rd[5::13, 1] = -0.0
    h = n // 2
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[3:h:10] = rng.uniform(2, 12, len(range(3, h, 10)))
    tmax[h:] = rng.uniform(1, 20, n - h)
    tmax[::9] = -np.inf
    smask = np.zeros(n, np.float32)
    smask[h:] = 1.0
    tri0 = np.full(n, -1, np.int32)
    tri0[3:h:10] = rng.integers(0, n_slots, len(range(3, h, 10)))
    return ro, rd, tmax, smask, tri0, h


@pytest.mark.parametrize("which", ["soup", "atrium"])
def test_treelet_copy_matches_raytpu(which):
    """Bit-equal windows, boxes and leaf counts, budget 32 on a 3000
    triangle soup (seed 7, a real frontier) and the default budget on
    build_atrium(5000)'s BVH8; validate_treelets passes."""
    if which == "soup":
        s = _soup(3000, 7, 32)
        got, want, bvh8 = s["tl"], s["rt_tl"], s["bvh8"]
        assert got.n_treelets > 4
    else:
        p0, e1, e2 = rt_flatten(_atrium())[:3]
        _, rt_bvh8 = rt_build_bvh(p0, e1, e2)
        _, bvh8 = build_bvh(p0, e1, e2)
        leaf = np.asarray(_packs()["rt_full"].bvh.leaf_tris)
        got = build_treelets(bvh8, leaf)
        want = rt_build_treelets(rt_bvh8, leaf)
    validate_treelets(got, bvh8)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f.name)


@functools.lru_cache(maxsize=None)
def _atrium():
    """raytpu's build_atrium(5000) SceneData (6,656 slots): both packages
    pack the same arrays."""
    from benchmarks.scenes import build_atrium

    return build_atrium(5000)


@functools.lru_cache(maxsize=None)
def _packs():
    scene = _atrium()
    return dict(
        full=pack_scene(scene, "cpu"),
        stream=pack_scene(scene, "cpu", tables="stream"),
        rt_full=rt_pack_scene(scene, as_numpy=True),
        rt_stream=rt_pack_scene(scene, tables="stream", as_numpy=True),
        cam=pack_camera(scene.camera, "cpu"),
        rt_cam=rt_pack_camera(scene.camera),
    )


_TABLES = ("tri_row", "scene_bmin", "scene_bmax", "tl_nodes", "tl_leaves",
           "tl_bmin", "tl_bmax")
_BVH_TABLES = ("nodes", "node8_rows", "leaf_tris", "strand_rows")


@pytest.mark.parametrize("scene,treelets,tables", [
    ("atrium", "auto", "auto"), ("atrium", "auto", "stream"),
    ("small", "always", "auto"), ("small", "always", "stream"),
    ("small", "auto", "auto")])
def test_pack_tables_bit_equal_raytpu(scene, treelets, tables):
    """The treelet and BVH tables bit-equal to raytpu's numpy pack, and
    None exactly where raytpu's are: treelets above 4096 slots or when
    forced, no BVH8 rows in a stream pack, no leaf rows in a stream pack
    without a strand tree (<= 256 slots)."""
    if scene == "atrium":
        key = "stream" if tables == "stream" else "full"
        got, want = _packs()[key], _packs()["rt_" + key]
    else:
        got = pack_scene(load_scene(scene_path("small")), "cpu", treelets=treelets,
                         tables=tables)
        want = rt_pack_scene(raytpu.load_scene(scene_path("small")),
                             treelets=treelets, tables=tables, as_numpy=True)
    pairs = [(k, getattr(want, k), getattr(got, k)) for k in _TABLES]
    pairs += [(k, getattr(want.bvh, k), getattr(got.bvh, k))
              for k in _BVH_TABLES]
    for k, a, b in pairs:
        assert (a is None) == (b is None), k
        if a is None:
            continue
        a = np.ascontiguousarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=k)
    assert (got.tl_nodes is not None) == (treelets == "always"
                                          or got.n_triangles > 4096)
    assert (got.bvh.node8_rows is None) == (tables == "stream")
    assert (got.bvh.leaf_tris is None) == (tables == "stream"
                                           and got.n_triangles <= 256)
    moved = got.to("cpu")
    assert (moved.tl_nodes is None) == (got.tl_nodes is None)


def test_pack_rejects_unknown_options():
    path = scene_path("small")
    with pytest.raises(ValueError, match="treelets"):
        pack_scene(load_scene(path), "cpu", treelets="sometimes")
    with pytest.raises(ValueError, match="tables"):
        pack_scene(load_scene(path), "cpu", tables="resident")


def _packet_tids(n_treelets, n_rays, packet):
    """One launch's treelet ids: each packet of ``packet`` lanes on one
    treelet (raytpu's grid), cycling through the windows; (per packet,
    per lane)."""
    tid_pp = (np.arange(n_rays // packet) * 5 % n_treelets).astype(np.int32)
    return tid_pp, np.repeat(tid_pp, packet)


def test_plain_walk_matches_raytpu_launch():
    """One launch on a 2000-triangle soup cut at budget 48 (seed 11):
    1024 lanes in packets of 128, half closest (some with a finite
    incoming bound and slot), half shadow, dead lanes of both, against
    raytpu's _binned_launch in interpret mode lane for lane."""
    s = _soup(2000, 11, 48)
    tl = s["tl"]
    assert tl.n_treelets > 4
    rays = _mixed_rays(1024, 21, s["order"].shape[0])
    ro, rd, tmax, smask, tri0, h = rays
    tid_pp, tid = _packet_tids(tl.n_treelets, 1024, 128)
    t, tri = binned_walk_torch(
        _t(tl.tnodes), _t(tl.tleaves), s["first"], _t(tid), _t(ro), _t(rd),
        _t(tmax),
        _t(smask), _t(tri0), 0.001, 0.0)
    t, tri = t.numpy(), tri.numpy()
    want_t, want_tri = _binned_launch(
        jnp.asarray(tl.tnodes), jnp.asarray(tl.tleaves), jnp.asarray(tid_pp),
        *(jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)),
        jnp.asarray(tmax), jnp.asarray(smask), jnp.asarray(tri0),
        tmin=0.001, shadow_tmin=0.0, packet=128, interpret=True)
    want_t, want_tri = np.asarray(want_t), np.asarray(want_tri)
    live = tmax >= 0
    c = live & (smask == 0)
    np.testing.assert_array_equal(_triangle(tri[c], s["order"]),
                                  _triangle(want_tri[c], s["order"]))
    np.testing.assert_allclose(t[c], want_t[c], rtol=1e-4)
    # the incoming slot stays where no window triangle beats its bound
    kept = c & (tri0 >= 0) & (tri == tri0)
    assert kept.any() and (tri[c] >= 0).sum() > 50
    sh = live & (smask == 1)
    np.testing.assert_array_equal(tri[sh] >= 0, want_tri[sh] >= 0)
    assert 0 < (tri[sh] >= 0).sum() < sh.sum()
    # dead lanes: t = -inf; tri0 passes through a dead closest lane
    assert (t[~live] == -np.inf).all()
    np.testing.assert_array_equal(tri[~live], np.where(smask == 1, -1,
                                                       tri0)[~live])


def test_plain_walk_whole_tree_matches_raytpu_mixed_packet_kernel():
    """One treelet holding the whole tree against raytpu's packet kernel
    in its mixed form (packet_query(mixed=True), interpret mode), which
    the port does not carry: the binned walk keeps its smask contract
    lane for lane (300 triangles, 256 lanes)."""
    from raytpu.kernels.intersect_pallas import packet_query

    s = _soup(300, 5, 10_000)
    tl = s["tl"]
    assert tl.n_treelets == 1
    ro, rd, tmax, smask, _, h = _mixed_rays(256, 8, 1)
    tri0 = np.full(256, -1, np.int32)
    t, tri = binned_walk_torch(
        _t(tl.tnodes), _t(tl.tleaves), s["first"],
        torch.zeros(256, dtype=torch.int32),
        _t(ro), _t(rd), _t(tmax), _t(smask), _t(tri0), 0.001, 0.0)
    t, tri = t.numpy(), tri.numpy()
    want_t, want_tri = packet_query(
        jnp.asarray(s["bvh8"].node_rows), jnp.asarray(s["leaf"]),
        *(jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)),
        jnp.asarray(tmax), jnp.asarray(smask), tmin=0.001, mixed=True,
        shadow_tmin=0.0, interpret=True, packet=256)
    want_t, want_tri = np.asarray(want_t), np.asarray(want_tri)
    live = tmax >= 0
    c = live & (smask == 0)
    np.testing.assert_array_equal(_triangle(tri[c], s["order"]),
                                  _triangle(want_tri[c], s["order"]))
    np.testing.assert_allclose(t[c], want_t[c], rtol=1e-4)
    sh = live & (smask == 1)
    np.testing.assert_array_equal(tri[sh] >= 0, want_tri[sh] >= 0)
    assert (tri[c] >= 0).any() and (tri[sh] >= 0).any()


def _soup_pack(s, lib):
    conv = jnp.asarray if lib == "jax" else _t
    tl = s["tl"] if lib == "torch" else s["rt_tl"]
    return type("P", (), dict(
        tl_nodes=conv(tl.tnodes), tl_leaves=conv(tl.tleaves),
        tl_bmin=conv(tl.tbox_min), tl_bmax=conv(tl.tbox_max),
        bvh=type("B", (), dict(first_slots=s["first"]))))


def _query_rays(s):
    """tests/test_binned.py's 512 mixed rays (seed 11 after the soup)."""
    rng = np.random.default_rng(11)
    _random_soup(2000, rng)
    n, h = 512, 256
    ro = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sdist = rng.uniform(1, 20, h).astype(np.float32)
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[h:] = sdist
    tmax[5] = -np.inf
    tmax[h + 9] = -np.inf
    smask = np.zeros(n, np.float32)
    smask[h:] = 1.0
    return ro, rd, tmax, smask, h


def test_query_matches_raytpu_and_port_brute():
    """The round loop on tests/test_binned.py's case (2000 triangles,
    budget 48, 512 mixed rays): closest lanes bit-equal in t to the port's
    brute sweep and on the same triangle as it and as raytpu's binned
    query (interpret mode, 128-ray packets); shadow lanes blocked exactly
    where both sweeps say."""
    s = _soup(2000, 11, 48)
    ro, rd, tmax, smask, h = _query_rays(s)
    binned.QUERY_STATS.update(queries=0, rounds=0, max_rounds=0)
    t, tri = make_binned_query(_soup_pack(s, "torch"))(
        _t(ro), _t(rd), _t(tmax), _t(smask), tmin=0.001, shadow_tmin=0.0)
    t, tri = t.numpy(), tri.numpy()
    assert binned.QUERY_STATS["queries"] == 1
    assert binned.QUERY_STATS["rounds"] > 1
    want_t, want_tri = rt_make_binned_query(
        _soup_pack(s, "jax"), interpret=True, packet=128)(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmax),
        jnp.asarray(smask), tmin=0.001, shadow_tmin=0.0)
    want_t, want_tri = np.asarray(want_t), np.asarray(want_tri)
    tri_p = [_t(s[k]) for k in ("p0", "e1", "e2")]
    brute = intersect_bruteforce(_t(ro[:h]), _t(rd[:h]), *tri_p, 0.001,
                                 _t(tmax[:h]), chunk=8)
    live = tmax[:h] >= 0
    order = s["order"]
    np.testing.assert_array_equal(_triangle(tri[:h], order)[live],
                                  _triangle(brute.tri.numpy(), order)[live])
    np.testing.assert_array_equal(_triangle(tri[:h], order)[live],
                                  _triangle(want_tri[:h], order)[live])
    hit = live & (tri[:h] >= 0)
    assert hit.mean() > 0.1
    np.testing.assert_array_equal(t[:h][hit].view(np.int32),
                                  brute.t.numpy()[hit].view(np.int32))
    np.testing.assert_allclose(t[:h][hit], want_t[:h][hit], rtol=1e-4)
    assert (tri[:h][~live] == -1).all()
    blocked = intersect_any_bruteforce(_t(ro[h:]), _t(rd[h:]), *tri_p, 0.0,
                                       _t(tmax[h:]), chunk=8).numpy()
    live_s = tmax[h:] >= 0
    np.testing.assert_array_equal((tri[h:] >= 0)[live_s], blocked[live_s])
    np.testing.assert_array_equal((tri[h:] >= 0)[live_s],
                                  (want_tri[h:] >= 0)[live_s])
    assert (tri[h:][~live_s] == -1).all()
    # cutting the loop short loses hits: the answer is exact only at the end
    _, cut = make_binned_query(_soup_pack(s, "torch"), max_rounds=1)(
        _t(ro), _t(rd), _t(tmax), _t(smask), tmin=0.001, shadow_tmin=0.0)
    assert (cut.numpy() != tri).any()


def test_intersectors_bake_tmin():
    s = _soup(2000, 11, 48)
    ro, rd, tmax, smask, h = _query_rays(s)
    closest, any_fn = make_binned_intersectors(_soup_pack(s, "torch"))
    hit = closest(_t(ro[:h]), _t(rd[:h]), 0.001, float(F32_MAX))
    tri_p = [_t(s[k]) for k in ("p0", "e1", "e2")]
    brute = intersect_bruteforce(_t(ro[:h]), _t(rd[:h]), *tri_p, 0.001,
                                 float(F32_MAX), chunk=8)
    assert torch.equal(hit.valid, brute.valid)
    assert torch.equal(hit.t[hit.valid], brute.t[brute.valid])
    blocked = any_fn(_t(ro[h:]), _t(rd[h:]), 0.0, _t(tmax[h:]))
    assert torch.equal(blocked, intersect_any_bruteforce(
        _t(ro[h:]), _t(rd[h:]), *tri_p, 0.0, _t(tmax[h:]), chunk=8))
    with pytest.raises(ValueError):
        closest(_t(ro), _t(rd), 0.0, float(F32_MAX))
    with pytest.raises(ValueError):
        any_fn(_t(ro), _t(rd), 0.001, float(F32_MAX))


def test_dispatch_by_device_and_cuda_wrapper_refuses_cpu():
    s = _soup(300, 5, 10_000)
    ro, rd, tmax, smask, tri0, _ = _mixed_rays(256, 3, 1)
    args = (_t(s["tl"].tnodes), _t(s["tl"].tleaves), s["first"],
            torch.zeros(256, dtype=torch.int32), _t(ro), _t(rd), _t(tmax),
            _t(smask), _t(tri0), 0.001, 0.0)
    before = binned_walk_cuda.launches
    for x, y in zip(binned_walk(*args), binned_walk_torch(*args)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        binned_walk_cuda(*args)
    assert binned_walk_cuda.launches == before


@pytest.mark.parametrize("bad", ["dtype", "stride"])
def test_kernel_inputs_refuse_bad_tie_keys(bad):
    """binned_walk_cuda's input check (run before every launch) takes the
    tie keys only as a contiguous int32 tensor on the rays' device."""
    s = _soup(300, 5, 10_000)
    ro, rd, tmax, smask, tri0, _ = _mixed_rays(64, 3, 1)
    first = {"dtype": s["first"].long(),
             "stride": s["first"].repeat_interleave(2)[::2]}[bad]
    args = [_t(s["tl"].tnodes), _t(s["tl"].tleaves), s["first"],
            torch.zeros(64, dtype=torch.int32), _t(ro), _t(rd), _t(tmax),
            _t(smask), _t(tri0)]
    binned._check_walk_inputs(*args)
    args[2] = first
    with pytest.raises(ValueError, match="first"):
        binned._check_walk_inputs(*args)


def test_plain_walk_counts_its_reads():
    """The plain walk's counts, the inputs of chip_smoke.py's bounds, on
    treelets at budget 48: one ray pops each node of its treelet once (8
    box tests, one 512-byte row) and reads each leaf it visits once (8
    triangle tests, 320 bytes of triangles); a launch reads each distinct
    row once, at least its largest ray's bytes and at most the tables.
    Counting changes no result."""
    s = _soup(3000, 7, 48)
    tl = s["tl"]
    ro, rd, tmax, smask, tri0, _ = _mixed_rays(600, 4, s["leaf"].shape[0] * 8)
    tid = np.random.default_rng(4).integers(0, tl.n_treelets, 600)
    args = [_t(a) for a in (tl.tnodes, tl.tleaves, tid.astype(np.int32), ro,
                            rd, tmax, smask, tri0)]
    args.insert(2, s["first"])
    tables = (tl.tnodes.size * 4 + tl.tleaves.size // 128 * 320)
    wave = {}
    got = binned_walk_torch(*args, 0.001, 0.0, counts=wave)
    plain = binned_walk_torch(*args, 0.001, 0.0)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    largest = 0
    for i in range(0, 600, 30):
        one = {}
        binned_walk_torch(*args[:3], *(a[i:i + 1] for a in args[3:]),
                          0.001, 0.0, counts=one)
        assert one["bytes"] == 64 * one["boxes"] + 40 * one.get("tris", 0)
        largest = max(largest, one["bytes"])
    assert wave.get("tris", 0) % 8 == 0
    assert 0 < largest <= wave["bytes"] <= tables


def _small_budget(pack, lib):
    """The pack with its treelets rebuilt at budget 64 (several rounds)."""
    scene = _atrium()
    p0, e1, e2 = rt_flatten(scene)[:3]
    leaf = np.asarray(_packs()["rt_full"].bvh.leaf_tris)
    if lib == "jax":
        tl = rt_build_treelets(rt_build_bvh(p0, e1, e2)[1], leaf,
                               budget_rows=64)
        conv = jnp.asarray
    else:
        tl = build_treelets(build_bvh(p0, e1, e2)[1], leaf, budget_rows=64)
        conv = _t
    return dataclasses.replace(
        pack, tl_nodes=conv(tl.tnodes), tl_leaves=conv(tl.tleaves),
        tl_bmin=conv(tl.tbox_min), tl_bmax=conv(tl.tbox_max))


def _png(frame):
    return quantize_rgba32f(frame) / 255.0


@pytest.mark.parametrize("case", ["binned", "binned_budget64",
                                  "packet_bounce_binned"])
def test_frame_matches_raytpu(case):
    """build_atrium(5000) at 32x24, seed 3, chunk 8: the binned route on
    the stream packs (2 bounces) against raytpu's frame with the same
    configuration, the same with both packs' treelets rebuilt at budget 64
    (several rounds per query), and the packet route with
    bounce_backend='binned' on the full pack (3 bounces: strand primary
    and last shadow waves, binned mixed bounces). raytpu runs that last
    configuration's strand kernel in interpret mode for minutes on the
    CPU, so its reference is raytpu's threaded-BVH frame of the same
    scene, seed and depth, which raytpu holds equal to its deferred-NEE
    frame up to triangle ties (render.py:635-642)."""
    p = _packs()
    if case == "packet_bounce_binned":
        pack, rpack = p["full"], p["rt_full"]
        extra = dict(bounces=3, intersector="packet", bounce_backend="binned")
        rt_extra = dict(bounces=3, intersector="bvh")
    else:
        pack, rpack = p["stream"], p["rt_stream"]
        extra = rt_extra = dict(bounces=2, intersector="binned")
        if case == "binned_budget64":
            pack = _small_budget(pack, "torch")
            rpack = _small_budget(rpack, "jax")
            assert pack.tl_nodes.shape[0] > 8
    binned.QUERY_STATS.update(queries=0, rounds=0, max_rounds=0)
    got = render.render_frame(pack, p["cam"], RenderConfig(**FRAME, **extra))
    want = rt_render.render_frame(rpack, p["rt_cam"],
                                  raytpu.RenderConfig(**FRAME, **rt_extra))
    assert got.shape == (24, 32, 4) and np.isfinite(got).all()
    assert float((quantize_rgba32f(got).max(-1) > 0).mean()) > 0.5
    assert binned.QUERY_STATS["queries"] >= 2
    if case == "binned_budget64":
        assert binned.QUERY_STATS["max_rounds"] > 2
    assert_images_equiv(_png(got), _png(want))


def test_count_rays_equals_raytpu_on_the_binned_route():
    p = _packs()
    cfg = dict(FRAME, bounces=3, intersector="binned")
    got = render.count_rays(p["stream"], p["cam"], RenderConfig(**cfg))
    want = rt_render.count_rays(p["rt_stream"], p["rt_cam"],
                                raytpu.RenderConfig(**cfg))
    assert isinstance(got, int) and got == want
    assert 32 * 24 < got <= 32 * 24 * 7


def _spy(monkeypatch, calls):
    """Wrap every intersector factory so each query records its route."""
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
                       ("make_strand_intersectors", "strand"),
                       ("make_binned_intersectors", "binned")):
        monkeypatch.setattr(render, attr,
                            pair(name, getattr(render, attr)))
    real = render.make_binned_query
    monkeypatch.setattr(render, "make_binned_query",
                        lambda pack: tag(real(pack), "binned mixed"))


@pytest.mark.parametrize("pack_kind,cfg,want", [
    ("stream", {}, {"strand closest", "strand any"}),
    ("stream_small", {}, {"binned closest", "binned any"}),
    ("stream", dict(intersector="binned"),
     {"binned closest", "binned mixed", "binned any"}),
    ("full", dict(intersector="packet", bounce_backend="binned"),
     {"strand closest", "binned mixed", "strand any"}),
    ("full", dict(bounce_backend="binned"),
     {"strand closest", "binned mixed", "strand any"}),
])
def test_routes_like_raytpu_tpu_branch(monkeypatch, pack_kind, cfg, want):
    """"auto" on a stream pack takes the strand route when it has a strand
    tree and the binned route when it has none (a <= 256-slot scene); the
    binned route defers NEE into mixed queries above 256 slots (primary
    closest, mixed bounces, a last any-hit wave); bounce_backend='binned'
    keeps the strand pair for the primary and last shadow waves."""
    calls = set()
    _spy(monkeypatch, calls)
    if pack_kind == "stream_small":
        pack = pack_scene(load_scene(scene_path("small")), "cpu",
                          treelets="always", tables="stream")
        assert pack.bvh.strand_rows is None and pack.bvh.leaf_tris is None
    else:
        pack = _packs()[pack_kind]
    config = RenderConfig(width=16, height=8, seed=2, samples=1, bounces=3,
                          chunk_size=8, **cfg)
    frame = render.render_tile(pack, _packs()["cam"], 0, config, 8)
    assert frame.shape == (8, 16, 4)
    assert calls == want


def test_route_errors():
    p = _packs()
    small = pack_scene(load_scene(scene_path("small")), "cpu")
    assert small.tl_nodes is None
    cfg = dict(width=16, height=8, seed=2, samples=1, bounces=2, chunk_size=8)
    with pytest.raises(ValueError, match="treelet tables"):
        render.render_tile(small, p["cam"], 0,
                           RenderConfig(**cfg, intersector="binned"), 8)
    with pytest.raises(ValueError, match="treelet tables"):
        render.render_tile(small, p["cam"], 0,
                           RenderConfig(**cfg, bounce_backend="binned"), 8)
    with pytest.raises(ValueError, match="tables='stream'"):
        render.render_tile(p["stream"], p["cam"], 0,
                           RenderConfig(**cfg, intersector="packet"), 8)
    with pytest.raises(ValueError, match="needs a strand tree"):
        render.render_tile(small, p["cam"], 0,
                           RenderConfig(**cfg, intersector="packet",
                                        bounce_backend="mixed"), 8)
    route = render._route(p["full"],
                          RenderConfig(**cfg, bounce_backend="mixed"))
    assert callable(route.mixed_fn)


@pytest.mark.cuda
def test_kernel_bit_equal_plain_on_cuda():
    """binned_walk.cu against the plain version on the same CUDA tensors,
    one launch over several windows (budget 48) and over one (budget
    2048), and the whole query against the port's brute sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    for budget in (48, 2048):
        s = _soup(3000, 0, budget)
        rays = _mixed_rays(65536, 9, s["order"].shape[0])
        _, tid = _packet_tids(s["tl"].n_treelets, 65536, 128)
        ro, rd, tmax, smask, tri0, _ = rays
        args = [x.cuda() for x in (
            _t(s["tl"].tnodes), _t(s["tl"].tleaves), s["first"], _t(tid),
            _t(ro), _t(rd), _t(tmax), _t(smask), _t(tri0))]
        before = binned_walk_cuda.launches
        tk, trk = binned_walk_cuda(*args, 0.001, 0.0)
        tp, trp = binned_walk_torch(*args, 0.001, 0.0)
        torch.cuda.synchronize()
        assert binned_walk_cuda.launches == before + 1
        assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
        assert torch.equal(trk, trp)
    s = _soup(2000, 11, 48)
    ro, rd, tmax, smask, h = _query_rays(s)
    pack = _soup_pack(s, "torch")
    pack = type("P", (), {k: getattr(pack, k).cuda() for k in (
        "tl_nodes", "tl_leaves", "tl_bmin", "tl_bmax")} | dict(
        bvh=type("B", (), dict(first_slots=s["first"].cuda()))))
    t, tri = make_binned_query(pack)(
        _t(ro).cuda(), _t(rd).cuda(), _t(tmax).cuda(), _t(smask).cuda(),
        tmin=0.001, shadow_tmin=0.0)
    cpu_t, cpu_tri = make_binned_query(_soup_pack(s, "torch"))(
        _t(ro), _t(rd), _t(tmax), _t(smask), tmin=0.001, shadow_tmin=0.0)
    assert torch.equal(tri.cpu(), cpu_tri)
    assert torch.equal(t.cpu().view(torch.int32), cpu_t.view(torch.int32))


# ROADMAP fault 3.5: a primary ray of phase 7a's stream scene that the
# treelet walk lost before its repair, as f32 bit patterns: its winner W
# lies on a floor edge it shares with O (the same t); W's leaf box missed
# the ray by rounding, so the walk kept O, a higher slot (class ``slab``)
BINNED_SLAB_RO = _f32(0x80000000, 0x3ef2dce9, 0xc115426f)
BINNED_SLAB_RD = _f32(0x3ec5c0af, 0xbf06e2c5, 0x3f41d152)
BINNED_SLAB_BOX = _f32(0x3fe147ae, 0xc0000000, 0xc0bb4e82, 0x3ff0a3d7,
                       0xc0000000, 0xc0b8bf26)
BINNED_SLAB_W = _f32(0x3fe9d037, 0xc0000000, 0xc0b92c60, 0xbc5a7400, 0,
                     0x3c5a7400, 0, 0, 0x3c5a7400)
BINNED_SLAB_O = _f32(0x3fe81b4f, 0xc0000000, 0xc0b8bf26, 0, 0, 0x3c5a7400,
                     0x3c5a7400, 0, 0)


def _lost_window(kind):
    """(tl_nodes [1, 1, 128], tl_leaves [1, Sl, 128], slot rows [S, 10],
    treelet box min and max [1, 3], ro [1, 3], rd [1, 3]) of one treelet
    window showing a lost ray: ``tie`` is the packet walk's tie case; for
    ``slab`` the root holds W's leaf under the box at fault and O's leaf
    under a box around everything."""
    if kind == "tie":
        rows, leaf, ro, rd = lost_case("tie")
    else:
        big = np.array([-60, -60, -60, 60, 60, 60], np.float32)
        rows = _node_row((BINNED_SLAB_BOX, ~0), (big, ~1))
        leaf = _tri_rows(BINNED_SLAB_W, *[None] * 7, BINNED_SLAB_O)
        ro, rd = BINNED_SLAB_RO[None], BINNED_SLAB_RD[None]
    tleaves = np.zeros((1, leaf.shape[0], 128), np.float32)
    tleaves[0, :, :80] = leaf
    slots = np.arange(leaf.shape[0] * 8, dtype=np.int32).reshape(-1, 8)
    tleaves[0, :, 9:80:10] = slots.view(np.float32)
    kids = rows.reshape(8, 16)
    real = (kids[:, 0:3] <= kids[:, 3:6]).all(1)
    return (rows[None], tleaves, leaf.reshape(-1, 10),
            kids[real, 0:3].min(0)[None], kids[real, 3:6].max(0)[None], ro,
            rd)


@pytest.mark.parametrize("kind", ["tie", "slab"])
def test_lost_hit_found_by_the_repaired_walk(monkeypatch, kind):
    """The repaired treelet walk, alone and in the round loop, returns
    raytpu's brute-sweep triangle (its tie key) and the port's brute-sweep
    t bits where a rule of the unrepaired walk lost it: the raw-slot tie
    rule (identity keys) for ``tie``, raytpu's slab test (FAR_SCALE 1) for
    ``slab``; a shadow lane is blocked where raytpu's brute any-hit is."""
    tnodes, tleaves, per, bmin, bmax, ro, rd = _lost_window(kind)
    p0, e1, e2 = (per[:, a:a + 3].copy() for a in (0, 3, 6))
    tmax = np.full(1, F32_MAX, np.float32)
    want = rt_closest(*map(jnp.asarray, (ro, rd, p0, e1, e2)),
                      jnp.float32(0.001), jnp.asarray(tmax), chunk=8)
    want_tri = int(np.asarray(want.tri)[0])
    port = intersect_bruteforce(_t(ro), _t(rd), _t(p0), _t(e1), _t(e2),
                                0.001, _t(tmax), chunk=8)
    assert want_tri >= 0 and int(port.tri[0]) == want_tri
    first = first_slots(_t(per))

    def walk(keys, smask=0.0, bound=tmax):
        return binned_walk_torch(
            _t(tnodes), _t(tleaves), keys, torch.zeros(1, dtype=torch.int32),
            _t(ro), _t(rd), _t(bound), torch.full((1,), smask),
            torch.full((1,), -1, dtype=torch.int32), 0.001, 0.0)

    # the test bites: the unrepaired rule loses the hit
    if kind == "tie":
        _, old = walk(torch.arange(per.shape[0], dtype=torch.int32))
    else:
        monkeypatch.setattr(binned, "FAR_SCALE", 1.0)
        _, old = walk(first)
        monkeypatch.undo()
    assert int(old[0]) < 0 or not np.array_equal(per[int(old[0]), :9],
                                                 per[want_tri, :9])
    pack = type("P", (), dict(
        tl_nodes=_t(tnodes), tl_leaves=_t(tleaves), tl_bmin=_t(bmin),
        tl_bmax=_t(bmax), bvh=type("B", (), dict(first_slots=first))))
    query = make_binned_query(pack)(_t(ro), _t(rd), _t(tmax),
                                    torch.zeros(1), tmin=0.001,
                                    shadow_tmin=0.0)
    for got_t, got_tri in (walk(first), query):
        assert int(first[got_tri[0]]) == want_tri
        assert got_t.view(torch.int32)[0] == port.t.view(torch.int32)[0]
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want.t),
                                   rtol=1e-4)
    shadow = np.full(1, 100.0, np.float32)
    blocked = walk(first, 1.0, shadow)[1] >= 0
    ref = rt_any(*map(jnp.asarray, (ro, rd, p0, e1, e2)), jnp.float32(0.0),
                 jnp.asarray(shadow), chunk=8)
    assert bool(blocked[0]) == bool(np.asarray(ref)[0])
