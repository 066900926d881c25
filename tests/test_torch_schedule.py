"""raytpu's schedule flags in the port: the schedule form of the per-ray
strand walk (walker pool, leaf rounds, pipelined, dual and shared-memory
fetch, K-wide ribbon fetch; ``strand_query(..., walkers=...)``) and the
block walk's deferral form (``strand_block_query(..., defer=True)``,
``groups``, ``skip_done``).

The plain versions replay each kernel's lock-step (csrc/strand_common.cuh:
sched_kernel, defer_kernel). They are held to the default walks on t bits
and the tie key (closest lanes) and the blocked bit, their counters to
values worked out by hand on a two-leaf scene, and, in a child process,
to raytpu's kernels in interpret mode. The factories are held to raytpu's
(which kernel and keywords each variable reaches, read at factory time),
and ``auto`` to raytpu's budget rule. The CUDA forms are held to the plain
versions by the ``cuda``-marked tests (also over pool sizes, claim
sizes and the deferral form's G and skip_done) and by chip_smoke.py
(phases 3i, 12)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu
from raytpu.engine import render as rt_render
from raytpu.kernels import binned as rt_binned
from raytpu.kernels import intersect_pallas as rt_pallas
from raytpu.kernels import strand as rt_strand
from raytpu.kernels import strand_persistent as rt_persistent
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu.types import RenderConfig as RtRenderConfig
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.accel.strandtree import build_ribbon_tree, build_strand_tree
from raytpu_torch.engine import render
from raytpu_torch.kernels import packet, strand
from raytpu_torch.kernels.strand import (
    make_strand_intersectors,
    make_strand_mixed_query,
    strand_block_query_torch,
    strand_mixed_query_torch,
    strand_query_torch,
)
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_scene
from raytpu_torch.types import RenderConfig

from .conftest import isolated
from .test_torch_host import scene_path
from .test_torch_strand import _build, _rays, _soup, _tie_geometry

F32_MAX = np.float32(3.40282347e38)
N_RAYS = 500

# the sets held to the default walk: raytpu's factory defaults, the small
# pool of tests/test_strand.py:150-159, and one per fetch form
SETS = {
    "raytpu defaults": dict(walkers=128, service_k=16, flush_occ=0.5,
                            pipe=True, unroll=4),
    "small pool": dict(walkers=8, service_k=2, pipe=True, unroll=4,
                       ctl_every=4, flush_pop=2),
    "no pipe": dict(walkers=64, flush_occ=0.25),
    "dual": dict(walkers=128, pipe=True, unroll=2, dual=True,
                 fetch_smem=True),
    "fetch_smem": dict(pipe=True, fetch_smem=True, smem_cur=True),
    "ribbon K=3": dict(walkers=16, ribbon_k=3),
    "ribbon K=8": dict(walkers=16, ribbon_k=8, smem_pend=True),
}
DEFER = {"G=2": dict(defer=True, groups=2),
         "G=16 skip_done": dict(defer=True, groups=16, skip_done=True)}


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


def _sorted(ro, rd):
    octant = (rd[:, 0] < 0) + 2 * (rd[:, 1] < 0) + 4 * (rd[:, 2] < 0)
    idx = np.argsort(octant, kind="stable")
    return ro[idx], rd[idx]


@functools.lru_cache(maxsize=None)
def _scene(name: str):
    """(strand rows, ribbon rows, rpo, leaf rows, first, ro, rd) of a soup
    ("5", "300", "3000" triangles) or of the tie scene ("tie"), its rays
    octant-sorted, as tensors."""
    if name == "tie":
        bvh, _, per, _, ro, rd = _tie_geometry()
        rows, leaf = build_strand_tree(bvh).rows, per.reshape(-1, 80)
    else:
        rows, leaf, *_ = _build(int(name))
        bvh, _ = build_bvh(*_soup(int(name)))
        ro, rd = _rays(N_RAYS, seed=int(name))
    rib = build_ribbon_tree(bvh)
    assert np.array_equal(build_strand_tree(bvh).rows, rows)
    ro, rd = _sorted(ro, rd)
    leaf = _t(leaf)
    return (_t(rows), _t(rib.rows), rib.rows_per_oct, leaf,
            strand.first_slots(leaf), _t(ro), _t(rd))


def _bounds(n: int):
    """Closest bounds (every tenth 5.0, every seventh lane dead), shadow
    bounds (6.0, every fifth dead), mixed bounds and flags (every other
    lane a shadow lane)."""
    closest = torch.full((n,), float(F32_MAX))
    closest[3::10] = 5.0
    closest[::7] = float("-inf")
    shadow = torch.full((n,), 6.0)
    shadow[::5] = float("-inf")
    smask = torch.zeros(n)
    smask[1::2] = 1.0
    mixed = torch.where(smask == 1.0, shadow, closest)
    return closest, shadow, mixed, smask


def _key(first, tri):
    return torch.where(tri >= 0, first[tri.clamp(min=0).long()], -1)


def _same_contract(got, want, first, shadow_lanes):
    """t bits and the tie key on closest lanes, the blocked bit on shadow
    lanes."""
    c = ~shadow_lanes
    assert torch.equal(got[0][c].view(torch.int32),
                       want[0][c].view(torch.int32))
    assert torch.equal(_key(first, got[1])[c], _key(first, want[1])[c])
    assert torch.equal(got[1][~c] >= 0, want[1][~c] >= 0)


def _walk(kw, rows, rib, rpo):
    """(rows, keywords) of a set: the ribbon sets walk the ribbon rows."""
    if "ribbon_k" in kw:
        return rib, dict(kw, rpo=rpo)
    return rows, kw


@pytest.mark.parametrize("mode", ["closest", "any-hit", "mixed"])
@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("scene", ["5", "300", "3000", "tie"])
def test_schedule_forms_equal_default_walk(scene, name, mode):
    """Every schedule set's plain walk against the default plain walk:
    closest lanes' t bits and tie keys, shadow lanes' blocked bits; its
    counters count the same triangle tests as leaf rows reached."""
    rows, rib, rpo, leaf, first, ro, rd = _scene(scene)
    n = ro.shape[0]
    closest, shadow, mixed, smask = _bounds(n)
    tree, kw = _walk(SETS[name], rows, rib, rpo)
    if mode == "mixed":
        args = (leaf, first, ro, rd, mixed, smask, 0.001, 0.0)
        want = strand_mixed_query_torch(rows, *args)
        got = strand_mixed_query_torch(tree, *args, stats=True, **kw)
        shadow_lanes = smask == 1.0
    else:
        any_hit = mode == "any-hit"
        args = (leaf, first, ro, rd, shadow if any_hit else closest,
                0.0 if any_hit else 0.001, any_hit)
        want = strand_query_torch(rows, *args)
        got = strand_query_torch(tree, *args, stats=True, **kw)
        shadow_lanes = torch.full((n,), any_hit)
    _same_contract(got, want, first, shadow_lanes)
    st = got[2].tolist()
    assert st[4] <= st[5] and st[6:] == [0, 0] and st[0] > 0
    if mode != "any-hit":  # a closest lane tests every leaf it queues
        assert st[4] == st[5] or bool(shadow_lanes.any())
    assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("mode", ["closest", "any-hit"])
@pytest.mark.parametrize("name", list(DEFER))
@pytest.mark.parametrize("scene", ["5", "300", "tie"])
def test_deferral_form_equals_block_walk(scene, name, mode):
    """The block walk's deferral form against its default form: closest t
    bits and tie keys, the blocked bit; each strand's leaves pushed are at
    least its default leaf visits, and a block's rounds are shared by its
    strands."""
    rows, _, _, leaf, first, ro, rd = _scene(scene)
    n = ro.shape[0]
    closest, shadow, _, _ = _bounds(n)
    any_hit = mode == "any-hit"
    args = (rows, leaf, first, ro, rd, shadow if any_hit else closest,
            0.0 if any_hit else 0.001, any_hit)
    want = strand_block_query_torch(*args, True)
    got = strand_block_query_torch(*args, True, **DEFER[name])
    _same_contract(got, want, first, torch.full((n,), any_hit))
    assert got[2].shape == (want[2].shape[0], 3)
    if not any_hit:
        assert bool((got[2][:, 1] >= want[2][:, 1]).all())
    g = DEFER[name]["groups"]
    per_block = got[2][:, 2].reshape(-1, g) if got[2].shape[0] % g == 0 \
        else None
    if per_block is not None:
        assert bool((per_block == per_block[:, :1]).all())


@functools.lru_cache(maxsize=None)
def _two_leaves():
    """A scene worked by hand: a root over two leaves of 8 triangles each,
    leaf A (node 1, row 0) in planes x = 0.5..0.57, leaf B (node 2, row 1)
    in x = 2.5..2.57, both over y, z in [-1, 2]; 64 rays from x = -1 along
    +x, 48 through both leaves and 16 (rays 48..63, y = 50) missing the
    root. A closest hit in A is t = 1.5, in B t = 3.5."""
    k = np.arange(8, dtype=np.float32)

    def plane(x):
        p0 = np.stack([x, np.full(8, -1, np.float32),
                       np.full(8, -1, np.float32)], 1)
        return (p0, np.tile(np.float32([0, 3, 0]), (8, 1)),
                np.tile(np.float32([0, 0, 3]), (8, 1)))

    p0, e1, e2 = (np.concatenate([a, b]).astype(np.float32)
                  for a, b in zip(plane(0.5 + 0.01 * k),
                                  plane(2.5 + 0.01 * k)))
    bvh, _ = build_bvh(p0, e1, e2)
    rows = build_strand_tree(bvh).rows
    # the tree the counts below were worked out on
    assert bvh.n_nodes == 3
    assert rows[0, 6:8].tolist() == [1, -1]
    assert rows[0, 70:72].tolist() == [-1, 2]
    assert rows[1, 6:8].tolist() == [-2, -1]
    rib = build_ribbon_tree(bvh)
    order = bvh.tri_order
    leaf = np.zeros((order.shape[0], 10), np.float32)
    leaf[:, 0:3], leaf[:, 3:6], leaf[:, 6:9] = (p0[order], e1[order],
                                                e2[order])
    r = np.random.default_rng(1)
    ro = np.zeros((64, 3), np.float32)
    ro[:, 0] = -1.0
    ro[:, 1:] = r.uniform(-0.5, 0.5, (64, 2))
    ro[48:, 1] = 50.0
    rd = np.tile(np.float32([1, 0, 0]), (64, 1))
    leaf = _t(leaf.reshape(-1, 80))
    return (_t(rows), _t(rib.rows), rib.rows_per_oct, leaf,
            strand.first_slots(leaf), _t(ro), _t(rd))


# The counters [loads (fetches on ribbon rows), leaf rounds, claims,
# installs, leaf tests, enqueues, 0, 0] of each set on the two-leaf scene,
# closest-hit, worked by hand. Batch 0 is 32 through-rays, batch 1 16
# through and 16 missing (one batch of 48 and 16 under dual).
# * load, unroll 1, occ 16: iteration 1 queues A and its round tests it
#   (t 1.5), so at iteration 2 B's box (entry 3.5) misses: a through-ray
#   loads root, A, B (3), a missing one the root; one round a batch.
# * pipe, unroll 4: one iteration walks root, A, B before any vote, so
#   both leaves queue; round 1 pops B (the stack's top), round 2, with no
#   lane walking on, pops A. Loads: the root at install, then each step's
#   successors: A at the root, B at A, none at B (3; 2 for a missing ray).
# * fetch_smem: pipe's schedule; a staged record counts as a load.
# * small pool, ctl 4, pop 2, occ 24: the one vote pops B then A.
# * dual, occ 32: one batch of 64, two rounds.
# * ribbon K=4: one fetch of the window [0, 4) a ray, then root, A, B.
HAND = {
    "load": (dict(walkers=128, service_k=16, flush_occ=0.5),
             [160, 2, 1, 2, 48, 48, 0, 0]),
    "pipe": (dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                  unroll=4), [176, 4, 1, 2, 96, 96, 0, 0]),
    "fetch_smem": (dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                        unroll=4, fetch_smem=True),
                   [176, 4, 1, 2, 96, 96, 0, 0]),
    "small pool": (dict(walkers=8, service_k=2, pipe=True, unroll=4,
                        ctl_every=4, flush_pop=2),
                   [176, 2, 1, 2, 96, 96, 0, 0]),
    "dual": (dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                  unroll=4, dual=True), [176, 2, 1, 1, 96, 96, 0, 0]),
    "ribbon K=4": (dict(walkers=128, service_k=1, flush_occ=0.5,
                        ribbon_k=4), [64, 4, 2, 2, 96, 96, 0, 0]),
}


# The while-while walk's counters on ribbon rows, closest-hit, worked by
# hand on the two-leaf scene: [0] loads a step at K = 1 (a through-ray
# loads root, A, B; a missing one the root), else the K-wide fetch's
# windows: at K = 2 the window [0, 2) holds root and A, B fetches [2, 4);
# at K >= 4 one window holds all three. [3] ceil(64 / 128) = 1; the 48
# through-rays test leaf A only (B's box misses at t 1.5).
WINDOW = {1: 160, 2: 112, 4: 64, 8: 64}


@pytest.mark.parametrize("k", list(WINDOW))
def test_window_fetches_on_two_leaves(k):
    """The K-wide fetch of the while-while walk (``ribbon_k`` = K >= 2 on
    ribbon rows, no schedule keyword) counts its windows in stats[0], as
    worked by hand (WINDOW); its hits and its other counters are the one
    record a step walk's."""
    rows, rib, rpo, leaf, first, ro, rd = _two_leaves()
    tmax = torch.full((64,), float(F32_MAX))
    t, tri, st = strand_query_torch(rib, leaf, first, ro, rd, tmax, 0.001,
                                    False, rpo=rpo, ribbon_k=k, stats=True)
    assert st.tolist() == [WINDOW[k], 0, 0, 1, 48, 48, 0, 0]
    t0, tri0 = strand_query_torch(rows, leaf, first, ro, rd, tmax, 0.001,
                                  False)
    assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
    assert torch.equal(tri, tri0)


@pytest.mark.parametrize("mode", ["closest", "any-hit", "mixed"])
@pytest.mark.parametrize("scene", ["300", "3000"])
def test_window_fetch_counts_fewer_loads(scene, mode):
    """On soups, each K-wide fetch (K 2..8) returns the one record a step
    walk's t and tri bits and counters, but stats[0]: its windows, at
    most that walk's loads and falling as K grows."""
    _, rib, rpo, leaf, first, ro, rd = _scene(scene)
    closest, shadow, mixed, smask = _bounds(ro.shape[0])
    if mode == "mixed":
        fn, args = strand_mixed_query_torch, (leaf, first, ro, rd, mixed,
                                              smask, 0.001, 0.0)
    else:
        any_hit = mode == "any-hit"
        fn, args = strand_query_torch, (leaf, first, ro, rd,
                                        shadow if any_hit else closest,
                                        0.0 if any_hit else 0.001, any_hit)
    one = fn(rib, *args, rpo=rpo, ribbon_k=1, stats=True)
    fetches = [int(one[2][0])]
    for k in range(2, 9):
        got = fn(rib, *args, rpo=rpo, ribbon_k=k, stats=True)
        assert torch.equal(got[0].view(torch.int32), one[0].view(torch.int32))
        assert torch.equal(got[1], one[1])
        assert got[2][1:].tolist() == one[2][1:].tolist()
        fetches.append(int(got[2][0]))
    assert fetches == sorted(fetches, reverse=True)
    assert fetches[-1] < fetches[0]


@pytest.mark.parametrize("env,scheduled", [(None, False), ("1", True),
                                           ("0", False)])
def test_tables_over_budget_keep_the_default_walk(monkeypatch, env,
                                                  scheduled):
    """Tables over the budget force the per-ray walk on the strand rows,
    as raytpu's tree_any does, also with RAYTPU_STRAND_PERSISTENT=0 and
    RAYTPU_RIBBON set; they reach the pipelined schedule form only when
    RAYTPU_STRAND_HBM is set (not "0"): the size alone keeps the
    while-while walk, which holds every table in global memory as the
    pipelined form does."""
    pack, _ = _packs("gallery")
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAYTPU_STRAND_PERSISTENT", "0")
    monkeypatch.setenv("RAYTPU_RIBBON", "4")
    if env is not None:
        monkeypatch.setenv("RAYTPU_STRAND_HBM", env)
    monkeypatch.setattr(strand, "STRAND_TABLE_BUDGET", 1024)
    port = _Recorder(monkeypatch, strand,
                     ["strand_query", "strand_block_query",
                      "strand_mixed_query"], lambda *a, **k: (
                          torch.zeros(a[3].shape[0]),
                          torch.full((a[3].shape[0],), -1,
                                     dtype=torch.int32)))
    closest, _ = make_strand_intersectors(pack)
    mixed = make_strand_mixed_query(pack)
    ro, rd = _rays(64, seed=2)
    closest(_t(ro), _t(rd), 0.001, float(F32_MAX))
    mixed(_t(ro), _t(rd), torch.full((64,), float(F32_MAX)), torch.zeros(64),
          tmin=0.001, shadow_tmin=0.0)
    want = {}
    if env == "0":  # tree_any off: the block walk, ribbon rows for mixed
        assert [c[0] for c in port.calls] == ["strand_block_query",
                                              "strand_mixed_query"]
        assert port.calls[1][1] == dict(rpo=pack.bvh.ribbon_rows.shape[0]
                                        // 8, ribbon_k=4)
        return
    if scheduled:
        want = dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                    unroll=4, ctl_every=1, flush_pop=1, dual=False,
                    tree_any=True)
    assert port.calls == [("strand_query", want),
                          ("strand_mixed_query", want)]


@pytest.mark.parametrize("name", list(HAND))
def test_counters_on_two_leaves(name):
    """Each form's counters on the two-leaf scene, as worked by hand
    (HAND), and its hits: t 1.5 in leaf A on the 48 through-rays."""
    rows, rib, rpo, leaf, first, ro, rd = _two_leaves()
    kw, want = HAND[name]
    tree, kw = _walk(kw, rows, rib, rpo)
    t, tri, st = strand_query_torch(tree, leaf, first, ro, rd,
                                    torch.full((64,), float(F32_MAX)),
                                    0.001, False, stats=True, **kw)
    assert st.tolist() == want
    assert torch.equal(t[:48], torch.full((48,), 1.5))
    assert bool((tri[:48] >= 0).all() and (tri[:48] < 8).all())
    assert bool((tri[48:] == -1).all())


@pytest.mark.parametrize("groups", [1, 2, 16])
def test_deferral_counters_on_two_leaves(groups):
    """The deferral form's per-strand stats on the two-leaf scene, worked
    by hand: each walker steps root, A, B (3 steps), queues A (1 push);
    the round that tests A comes when both are queued, so B's box misses
    and one round serves the block (both strands in one block at G >= 2;
    at G = 1 each its own). Any-hit: a strand whose lanes are all blocked
    after that round stops before B (2 steps); strand 1 has live missing
    lanes, so it steps B."""
    rows, _, _, leaf, first, ro, rd = _two_leaves()
    kw = dict(defer=True, groups=groups, skip_done=groups == 16)
    args = (rows, leaf, first, ro, rd)
    t, tri, st = strand_block_query_torch(
        *args, torch.full((64,), float(F32_MAX)), 0.001, False, True, **kw)
    assert st.tolist() == [[3, 1, 1], [3, 1, 1]]
    assert torch.equal(t[:48], torch.full((48,), 1.5))
    _, blocked, st = strand_block_query_torch(
        *args, torch.full((64,), 10.0), 0.0, True, True, **kw)
    assert st.tolist() == [[2, 1, 1], [3, 1, 1]]
    assert torch.equal(blocked >= 0, torch.arange(64) < 48)


@pytest.mark.parametrize("mode", ["closest", "mixed"])
@pytest.mark.parametrize("form", list(strand.SCHED_FORMS))
def test_plain_form_does_not_depend_on_walkers(form, mode):
    """``walkers`` is checked and adds no code: the schedule record has no
    pool size, and each form's plain walk returns the same t, tri and
    counters at 1 (2 under dual, raytpu's even pool), 128 and 4096
    walkers, on a ray count whose batches fill no block of 4 warps."""
    rows, rib, rpo, leaf, first, ro, rd = _scene("300")
    n = SWEEP_RAYS
    ro, rd = ro[:n].contiguous(), rd[:n].contiguous()
    closest, _, mixed, smask = _bounds(n)
    runs = []
    for walkers in (2 if form == "dual" else 1, 128, 4096):
        tree, kw = _walk(dict(FORM_SETS[form], walkers=walkers), rows, rib,
                         rpo)
        sched = strand._schedule(kw.get("rpo", 0),
                                 strand._n_nodes(tree, kw.get("rpo", 0)),
                                 **{k: v for k, v in kw.items()
                                    if k not in ("rpo", "ribbon_k")})
        assert "walkers" not in sched
        runs.append((sched, strand_mixed_query_torch(
            tree, leaf, first, ro, rd, mixed, smask, 0.001, 0.0, stats=True,
            **kw) if mode == "mixed" else strand_query_torch(
            tree, leaf, first, ro, rd, closest, 0.001, False, stats=True,
            **kw)))
    (s0, (t0, tri0, st0)), *rest = runs
    for s, (t, tri, st) in rest:
        assert s == s0
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
        assert torch.equal(tri, tri0) and torch.equal(st, st0)
    assert st0[3] == -(-n // (64 if form == "dual" else 32))


@isolated
def test_plain_forms_match_raytpu_kernels():
    """raytpu's persistent kernel at a non-default schedule (walkers 8,
    service_k 2, pipe, unroll 4, ctl_every 4, flush_pop 2; mixed, so one
    launch holds closest and shadow lanes) and its block kernel at groups
    2, closest-hit and any-hit, in interpret mode, against the port's plain
    schedule and deferral forms on a 300-triangle soup: the same original
    triangle on closest lanes and t to rtol 1e-4 (XLA:CPU contracts the
    Moller-Trumbore chain into FMAs), the blocked bit on shadow lanes."""
    rows, leaf, *_, order = _build(300)
    n = 512
    ro, rd = _sorted(*_rays(n, seed=11))
    tmax = np.full(n, F32_MAX, np.float32)
    tmax[::9] = -np.inf
    shadow = np.full(n, 4.0, np.float32)
    shadow[::9] = -np.inf
    smask = np.zeros(n, np.float32)
    smask[1::2] = 1.0
    live = tmax >= 0
    lf = _t(leaf)
    first = strand.first_slots(lf)
    sched = dict(walkers=8, service_k=2, pipe=True, unroll=4, ctl_every=4,
                 flush_pop=2)
    rays = [jnp.asarray(a[:, i]) for a in (ro, rd) for i in range(3)]
    port_args = (_t(rows), lf, first, _t(ro), _t(rd))
    rt_args = (jnp.asarray(rows), jnp.asarray(leaf), *rays)

    def check(got, want, shadow_lanes):
        (got_t, got_tri), (want_t, want_tri) = (
            [np.asarray(a) for a in x] for x in (got, want))
        s = live & shadow_lanes
        np.testing.assert_array_equal(got_tri[s] >= 0, want_tri[s] >= 0)
        c = live & ~shadow_lanes
        tri_g = np.where(got_tri >= 0, order[np.maximum(got_tri, 0)], -1)
        tri_w = np.where(want_tri >= 0, order[np.maximum(want_tri, 0)], -1)
        np.testing.assert_array_equal(tri_g[c], tri_w[c])
        hit = c & (got_tri >= 0)
        np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4)
        return int(hit.sum()), int((s & (got_tri >= 0)).sum())

    bound = np.where(smask == 1.0, shadow, tmax)
    hits = check(
        strand_mixed_query_torch(*port_args, _t(bound), _t(smask), 0.001,
                                 0.0, **sched),
        rt_persistent.strand_query_persistent(
            *rt_args, jnp.asarray(bound), tmin=0.001, interpret=True,
            smask=jnp.asarray(smask), mixed=True, shadow_tmin=0.0, **sched),
        smask == 1.0)
    assert hits[0] > 50 and hits[1] > 20
    for bnd, tmin, any_hit in ((tmax, 0.001, False), (shadow, 0.0, True)):
        hits = check(
            strand_block_query_torch(*port_args, _t(bnd), tmin, any_hit,
                                     defer=True, groups=2),
            rt_strand.strand_query(*rt_args, jnp.asarray(bnd), tmin=tmin,
                                   any_hit=any_hit, interpret=True,
                                   groups=2),
            np.full(n, any_hit))
        assert max(hits) > 30


# raytpu's assertions (strand_persistent.py:118-164) and the port's bounds
BAD = [
    (dict(unroll=0), "unroll"),
    (dict(unroll=65, pipe=True), "unroll"),
    (dict(unroll=2), "requires pipe"),
    (dict(unroll=2, pipe=True, ribbon_k=4), "requires pipe"),
    (dict(ctl_every=3), "power of two"),
    (dict(ctl_every=0), "power of two"),
    (dict(flush_pop=0), "flush_pop"),
    (dict(flush_pop=2, smem_pend=True), "smem_pend"),
    (dict(tree_any=True), "tree_any"),
    (dict(tree_any=True, pipe=True, ribbon_k=4), "tree_any"),
    (dict(dual=True), "dual"),
    (dict(dual=True, pipe=True, walkers=7), "dual"),
    (dict(dual=True, pipe=True, ribbon_k=4), "dual"),
    (dict(fetch_smem=True), "fetch_smem"),
    (dict(fetch_smem=True, pipe=True, ribbon_k=4), "fetch_smem"),
    (dict(walkers=0), "walkers"),
    (dict(service_k=0), "service_k"),
]


@pytest.mark.parametrize("kw,match", BAD)
def test_raytpu_assertions_raise(kw, match):
    """raytpu's assertion cases raise ValueError (smem_cur is normalised
    away under pipe first, as raytpu does), and so do the block walk's
    bad groups and its options without defer."""
    rows, rib, rpo, leaf, first, ro, rd = _scene("5")
    tree, kw = _walk(kw, rows, rib, rpo)
    with pytest.raises(ValueError, match=match):
        strand_query_torch(tree, leaf, first, ro, rd,
                           torch.full((ro.shape[0],), 1.0), 0.001, False,
                           **kw)


@pytest.mark.parametrize("kw", [dict(defer=True, groups=0),
                                dict(defer=True, groups=33),
                                dict(skip_done=True), dict(groups=16)])
def test_block_options_raise(kw):
    rows, _, _, leaf, first, ro, rd = _scene("5")
    with pytest.raises(ValueError, match="groups"):
        strand_block_query_torch(rows, leaf, first, ro, rd,
                                 torch.full((ro.shape[0],), 1.0), 0.001,
                                 False, **kw)


def test_smem_cur_is_normalised_under_pipe():
    """raytpu drops smem_cur under pipe before its checks, so fetch_smem
    with both is valid and walks as fetch_smem alone."""
    rows, _, _, leaf, first, ro, rd = _scene("300")
    args = (rows, leaf, first, ro, rd, torch.full((ro.shape[0],), 9.0),
            0.001, False)
    a = strand_query_torch(*args, stats=True, pipe=True, fetch_smem=True,
                           smem_cur=True)
    b = strand_query_torch(*args, stats=True, pipe=True, fetch_smem=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert strand._schedule(0, 64, pipe=True, fetch_smem=True,
                            smem_cur=True)["n_top"] == 64


@functools.lru_cache(maxsize=None)
def _packs(name: str, tables: str = "auto"):
    """(the port's pack, raytpu's pack) of a test scene, on the CPU."""
    return (pack_scene(load_scene(scene_path(name)), "cpu", tables=tables),
            rt_pack_scene(raytpu.load_scene(scene_path(name)),
                          tables=tables))


class _Recorder:
    """Swaps each named factory or kernel of a module for one that records
    its name and keywords and returns a stand-in."""

    def __init__(self, monkeypatch, module, names, result):
        self.calls = []
        for name in names:
            monkeypatch.setattr(module, name, self._wrap(name, result))

    def _wrap(self, name, result):
        def record(*args, **kwargs):
            self.calls.append((name, kwargs))
            return result(*args, **kwargs)
        return record


def _rt_query(*args, **kwargs):
    r = args[2].shape[0]
    return jnp.zeros(r, jnp.float32), jnp.full(r, -1, jnp.int32)


# variable sets, and whether the per-ray walk takes the schedule form:
# when a schedule variable or RAYTPU_STRAND_HBM (not "0") is set
ENVS = [
    ({}, False),
    ({"RAYTPU_STRAND_HBM": "1"}, True),
    ({"RAYTPU_STRAND_HBM": "0"}, False),
    ({"RAYTPU_STRAND_HBM": "0", "RAYTPU_STRAND_WALKERS": "64"}, True),
    ({"RAYTPU_STRAND_HBM": "1", "RAYTPU_RIBBON": "4"}, True),
    ({"RAYTPU_STRAND_HBM": "1", "RAYTPU_STRAND_PERSISTENT": "0"}, True),
    ({"RAYTPU_STRAND_WALKERS": "8", "RAYTPU_STRAND_SERVICE_K": "2",
      "RAYTPU_STRAND_PIPE": "1", "RAYTPU_STRAND_UNROLL": "4",
      "RAYTPU_STRAND_CTL": "4", "RAYTPU_STRAND_POP": "2"}, True),
    ({"RAYTPU_STRAND_FLUSH": "0.25"}, True),
    ({"RAYTPU_STRAND_PIPE": "1", "RAYTPU_STRAND_DUAL": "1"}, True),
    ({"RAYTPU_STRAND_PIPE": "0", "RAYTPU_STRAND_UNROLL": "8"}, True),
    ({"RAYTPU_RIBBON": "4"}, False),
    ({"RAYTPU_RIBBON": "1"}, False),
    ({"RAYTPU_RIBBON": "8", "RAYTPU_STRAND_PIPE": "1",
      "RAYTPU_STRAND_DUAL": "1"}, True),
    ({"RAYTPU_STRAND_PERSISTENT": "0", "RAYTPU_STRAND_GROUPS": "2"},
     False),
    ({"RAYTPU_STRAND_PERSISTENT": "0", "RAYTPU_STRAND_SKIP_DONE": "1",
      "RAYTPU_STRAND_MULTIROLL": "1"}, False),
]
VARS = sorted({k for e, _ in ENVS for k in e}
              | set(strand.SCHEDULE_ENV.values()))


@pytest.mark.parametrize("envs,scheduled", ENVS, ids=lambda e: ",".join(
    f"{k[7:]}={v}" for k, v in e.items()) if isinstance(e, dict) else
    str(e))
def test_factories_reach_raytpus_choices(monkeypatch, envs, scheduled):
    """Each variable set reaches the walk, the rows and the keywords that
    raytpu's factories pass its kernels (their kernels swapped for
    recorders, as the port's walks are): the per-ray walk with raytpu's
    schedule keywords (rpo for ribbon_rpo), or the block walk with its
    groups and skip_done. Unset, the port keeps the while-while walk (no
    keywords) where raytpu passes its TPU defaults. Every variable is read
    when the factory runs: changing it before the call changes nothing."""
    pack, rt_pack = _packs("gallery")
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    rt = _Recorder(monkeypatch, rt_persistent, ["strand_query_persistent"],
                   _rt_query)
    rt_b = _Recorder(monkeypatch, rt_strand, ["strand_query"], _rt_query)
    port = _Recorder(monkeypatch, strand,
                     ["strand_query", "strand_block_query",
                      "strand_mixed_query"], lambda *a, **k: (
                          torch.zeros(a[3].shape[0]),
                          torch.full((a[3].shape[0],), -1,
                                     dtype=torch.int32)))
    rows_seen = []
    real_route = strand._route

    def route(*args):
        out = real_route(*args)
        rows_seen.append(out[0])
        return out

    monkeypatch.setattr(strand, "_route", route)
    closest, _ = make_strand_intersectors(pack)
    mixed = make_strand_mixed_query(pack)
    rt_closest, _ = rt_strand.make_strand_intersectors(rt_pack)
    rt_mixed = rt_strand.make_strand_mixed_query(rt_pack)
    for k in VARS:  # read at factory time only
        monkeypatch.setenv(k, "9")
    ro, rd = _rays(64, seed=2)
    closest(_t(ro), _t(rd), 0.001, float(F32_MAX))
    mixed(_t(ro), _t(rd), torch.full((64,), float(F32_MAX)), torch.zeros(64),
          tmin=0.001, shadow_tmin=0.0)
    rt_closest(jnp.asarray(ro), jnp.asarray(rd), 0.001, F32_MAX)
    rt_mixed(jnp.asarray(ro), jnp.asarray(rd), jnp.full(64, F32_MAX),
             jnp.zeros(64), tmin=0.001, shadow_tmin=0.0)
    (pname, pkw), (mname, mkw) = port.calls
    assert mname == "strand_mixed_query"
    rt_kw = [kw for _, kw in rt.calls]
    if envs.get("RAYTPU_STRAND_PERSISTENT") == "0" and len(rt_kw) == 1:
        # raytpu's block kernel, with its groups and skip_done
        assert pname == "strand_block_query"
        ((_, bkw),) = rt_b.calls
        deferral = ("RAYTPU_STRAND_GROUPS" in envs
                    or "RAYTPU_STRAND_SKIP_DONE" in envs)
        # raytpu reads skip_done in strand_query: bool(the variable)
        want = (dict(defer=True, groups=bkw["groups"],
                     skip_done=bool(envs.get("RAYTPU_STRAND_SKIP_DONE")))
                if deferral else {})
        if envs.get("RAYTPU_STRAND_MULTIROLL", "0") != "0":
            want["multiroll"] = True
        assert pkw == want
        assert rows_seen[0] is pack.bvh.strand_rows
        rt_kw = rt_kw * 2
    else:
        assert pname == "strand_query"
        assert not rt_b.calls
    for kw, ref in zip((pkw, mkw), rt_kw):
        if pname == "strand_block_query" and kw is pkw:
            continue
        want = {}
        if ref["ribbon_rpo"]:
            want = dict(rpo=ref["ribbon_rpo"], ribbon_k=ref["ribbon_k"])
        if scheduled:
            want.update({k: ref[k] for k in (
                "walkers", "service_k", "flush_occ", "pipe", "unroll",
                "ctl_every", "flush_pop", "dual", "tree_any")})
        assert kw == want
    if rt_kw[0]["ribbon_rpo"]:
        assert rows_seen[-1] is not pack.bvh.strand_rows


def _tag(name):
    return lambda *a, **k: name


def _routes(monkeypatch, port_pack, rt_pack, intersector):
    """The factories each package's router calls for ``intersector`` (all
    swapped for tags; raytpu's router told it runs on a TPU)."""
    pr = _Recorder(monkeypatch, render, [
        "make_packet_intersectors", "make_strand_intersectors",
        "make_strand_mixed_query", "make_binned_intersectors",
        "make_binned_query", "make_intersectors"],
        lambda *a, **k: ("closest", "any"))
    rr = []
    for mod, names in ((rt_pallas, ["make_packet_intersectors"]),
                       (rt_strand, ["make_strand_intersectors",
                                    "make_strand_mixed_query"]),
                       (rt_binned, ["make_binned_intersectors",
                                    "make_binned_query"])):
        rr.append(_Recorder(monkeypatch, mod, names,
                            lambda *a, **k: ("closest", "any")))
    tpu = type("D", (), dict(platform="tpu"))
    monkeypatch.setattr(jax, "devices", lambda *a: [tpu()])
    size = dict(width=8, height=8, seed=1, samples=1, bounces=1,
                chunk_size=8, intersector=intersector)
    render._route(port_pack, RenderConfig(**size))
    rt_render._choose_intersectors(rt_pack, RtRenderConfig(**size))
    return (sorted(c[0] for c in pr.calls),
            sorted(c[0] for r in rr for c in r.calls))


@pytest.mark.parametrize("budget", [100 * 1024 * 1024, 64 * 1024, 0])
@pytest.mark.parametrize("name,tables", [("gallery", "auto"),
                                         ("gallery", "stream"),
                                         ("small", "auto")])
def test_auto_routes_by_raytpus_budget(monkeypatch, name, tables, budget):
    """``auto`` picks what raytpu's TPU branch picks under the same budget
    (raytpu's ``vmem_budget_ok`` given it, the port's
    PACKET_TABLE_BUDGET set to it): the packet route when the BVH8 and
    leaf rows at 128-lane padding fit, else the strand route on a pack
    with a strand tree, else binned, else the sweep."""
    port_pack, rt_pack = _packs(name, tables)
    monkeypatch.setattr(packet, "PACKET_TABLE_BUDGET", budget)
    real = rt_pallas.vmem_budget_ok
    monkeypatch.setattr(rt_pallas, "vmem_budget_ok", lambda p: real(
        p, budget_bytes=budget))
    assert packet.packet_tables_fit(port_pack) == real(rt_pack, budget)
    port, ref = _routes(monkeypatch, port_pack, rt_pack, "auto")
    if not ref:  # raytpu's sweep: the port's make_intersectors
        assert port == ["make_intersectors"]
    else:
        assert port == ref


FORMS = [("strand", f) for f in strand.SCHED_FORMS] + [
    ("mixed", f) for f in strand.SCHED_FORMS] + [("block", "defer")]
FORM_SETS = dict(load=dict(walkers=128, flush_occ=0.5),
                 pipe=dict(walkers=128, flush_occ=0.5, pipe=True, unroll=4),
                 dual=dict(pipe=True, unroll=4, dual=True),
                 smem=dict(pipe=True, unroll=4, fetch_smem=True),
                 wide=dict(ribbon_k=4))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("kind", ["strand", "mixed"])
def test_window_fetch_bit_equal_plain_on_cuda(kind, k):
    """strand_walk.cu's K-wide fetch (walk_kernel over ribbon rows with
    ribbon_k = K >= 2) against its plain version (t, tri, every counter)
    and the strand layout (t bits, tri), counting one
    ``ribbon_wide_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, rib, rpo, leaf, first, ro, rd = (
        x.cuda() if isinstance(x, torch.Tensor) else x
        for x in _scene("3000"))
    closest, _, mixed, smask = (x.cuda() for x in _bounds(ro.shape[0]))
    if kind == "strand":
        fn, plain = strand.strand_query_cuda, strand_query_torch
        args = (leaf, first, ro, rd, closest, 0.001, False)
    else:
        fn, plain = strand.strand_mixed_query_cuda, strand_mixed_query_torch
        args = (leaf, first, ro, rd, mixed, smask, 0.001, 0.0)
    before = fn.ribbon_wide_launches
    got = fn(rib, *args, rpo=rpo, ribbon_k=k, stats=True)
    assert fn.ribbon_wide_launches == before + 1
    want = plain(rib, *args, rpo=rpo, ribbon_k=k, stats=True)
    default = fn(rows, *args)
    torch.cuda.synchronize()
    for a in (want, default):
        assert torch.equal(got[0].view(torch.int32), a[0].view(torch.int32))
        assert torch.equal(got[1], a[1])
    assert torch.equal(got[2], want[2])


# the launch shapes the cuda cases also sweep: raytpu's pool sizes (which
# add no code) with claim sizes, and the K-wide form at K 8, on 430 rays:
# 14 batches of 32 rays and 7 of 64, so the last block's warps are not all
# busy, and the last batch is partial
POOLS = [(1, 1), (128, 16), (4096, 64), (1, 64), (4096, 1)]
SWEEP_RAYS = 430
CASES = ([(kind, form, {}, N_RAYS) for kind, form in FORMS]
         + [(kind, form, dict(walkers=w * 2 if form == "dual" and w == 1
                              else w, service_k=k), SWEEP_RAYS)
            for kind in ("strand", "mixed") for form in strand.SCHED_FORMS
            for w, k in POOLS]
         + [(kind, "wide", dict(ribbon_k=8, service_k=k), SWEEP_RAYS)
            for kind in ("strand", "mixed") for k in (1, 16, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,form,sweep,n", CASES, ids=lambda v: str(v))
def test_schedule_form_bit_equal_plain_on_cuda(kind, form, sweep, n):
    """Each form of strand_walk.cu's schedule and strand_block.cu's
    deferral against its plain version (t, tri, every counter) and the
    default instance (t bits and the tie key, the blocked bit), counting
    one launch of its form; the schedule forms also at each launch shape
    of the sweep (``sweep``'s keywords over the form's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, rib, rpo, leaf, first, ro, rd = (
        x.cuda() if isinstance(x, torch.Tensor) else x
        for x in _scene("3000"))
    ro, rd = ro[:n].contiguous(), rd[:n].contiguous()
    closest, shadow, mixed, smask = (x.cuda() for x in _bounds(n))
    if kind == "block":
        args = (rows, leaf, first, ro, rd, closest, 0.001, False)
        before = strand.strand_block_query_cuda.defer_launches
        got = strand.strand_block_query_cuda(*args, True, **DEFER["G=2"])
        assert strand.strand_block_query_cuda.defer_launches == before + 1
        want = strand_block_query_torch(*args, True, **DEFER["G=2"])
        default = strand.strand_block_query_cuda(*args)
        shadow_lanes = torch.zeros(n, dtype=torch.bool, device="cuda")
    else:
        tree, kw = _walk(dict(FORM_SETS[form], **sweep), rows, rib, rpo)
        fn = (strand.strand_query_cuda if kind == "strand"
              else strand.strand_mixed_query_cuda)
        if kind == "strand":
            args = (leaf, first, ro, rd, closest, 0.001, False)
            shadow_lanes = torch.zeros(n, dtype=torch.bool, device="cuda")
            plain = strand_query_torch
        else:
            args = (leaf, first, ro, rd, mixed, smask, 0.001, 0.0)
            shadow_lanes = smask == 1.0
            plain = strand_mixed_query_torch
        before = getattr(fn, form + "_launches")
        got = fn(tree, *args, stats=True, **kw)
        assert getattr(fn, form + "_launches") == before + 1
        want = plain(tree, *args, stats=True, **kw)
        default = fn(rows, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _same_contract(got, default, first, shadow_lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any-hit"])
@pytest.mark.parametrize("skip_done", [False, True])
@pytest.mark.parametrize("groups", [1, 4, 16, 32])
def test_deferral_form_bit_equal_plain_on_cuda(groups, skip_done, mode):
    """strand_block.cu's deferral form at G strands a block, with and
    without skip_done, against its plain version: t bits, tri and every
    strand's steps, leaves pushed and block rounds; and the default block
    walk on the contract (t bits and tie key, the blocked bit). 430 rays:
    14 strands, which fill no block of 4, 16 or 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    rows, _, _, leaf, first, ro, rd = (
        x.cuda() if isinstance(x, torch.Tensor) else x
        for x in _scene("3000"))
    n = SWEEP_RAYS
    ro, rd = ro[:n].contiguous(), rd[:n].contiguous()
    closest, shadow, _, _ = (x.cuda() for x in _bounds(n))
    any_hit = mode == "any-hit"
    args = (rows, leaf, first, ro, rd, shadow if any_hit else closest,
            0.0 if any_hit else 0.001, any_hit)
    kw = dict(defer=True, groups=groups, skip_done=skip_done)
    got = strand.strand_block_query_cuda(*args, True, **kw)
    want = strand_block_query_torch(*args, True, **kw)
    default = strand.strand_block_query_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _same_contract(got, default, first, torch.full((n,), any_hit,
                                                   device="cuda"))
