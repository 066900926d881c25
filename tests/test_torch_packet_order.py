"""The packet walk's exact near-first order and its stats over block and
packet boundaries, on the plain version (``kernels/packet.py:
packet_query_torch``), which the CUDA kernel (``csrc/packet_walk.cu`` on
``csrc/bvh8_walk.cuh``) keeps bit for bit in t, tri and every stats lane.

* Order: a hand-built two-level BVH8 whose root holds leaves whose entry
  distances tie in ``bits & ~7`` (the child index k breaks the tie, not
  the float), an interior child entered at -0.0 (its key is +0's), a
  missed child among hit ones and leaves at several distances. Any-hit
  returns the first leaf in key order (storage order: the first by k);
  closest-hit pops and leaf-row tests equal the counts worked by hand for
  both orders, and both return the same t and triangle.
* Counts: packets of 128 and 384 rays over 434 rays (three blocks of 128
  and a part block) with an all-dead packet: every stats row is the sum of
  its rays' own walks, each walked alone.
* The plain walk's count of hit children per pop (its "hits" count, which
  the packet timing reports) agrees with its pops, leaf-row tests and
  pushes, and changes none of its results.

The ``cuda``-marked test holds the kernel's 12 instances to the same
numbers on the card; chip_smoke.py's phase 3h does so at more sizes."""

import numpy as np
import pytest
import torch

from raytpu_torch.kernels.packet import packet_query_cuda, packet_query_torch
from raytpu_torch.kernels.strand import first_slots

from .test_torch_mixed import _lanes
from .test_torch_walk_stats import _case

F32_MAX = np.float32(3.40282347e38)
# the entry distances of the root's two tied leaves: 5 and the next float,
# equal in bits & ~7
TIE_FAR = np.nextafter(np.float32(5.0), np.float32(6.0))


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


def _node(children: dict) -> np.ndarray:
    """A BVH8 node row: children {k: (zlo, zhi, link)} over x, y in
    [-1, 1] (zlo None: x in [5, 6], a box the rays miss), the other slots
    empty (an inverted box)."""
    row = np.zeros((8, 16), np.float32)
    row[:, 0:3], row[:, 3:6] = 1e30, -1e30
    for k, (zlo, zhi, link) in children.items():
        lo_x, hi_x = (-1.0, 1.0) if zlo is not None else (5.0, 6.0)
        row[k, 0:6] = (lo_x, -1.0, zlo if zlo is not None else 0.0,
                       hi_x, 1.0, zhi)
        row[k, 6] = np.array(link, np.int32).view(np.float32)
    return row.reshape(-1)


def _order_tree(with_near_leaf: bool):
    """(node rows, leaf rows) of the hand-built tree, for rays from the
    origin along +z. Leaf row j holds one triangle, in slot 0, across the
    z axis at depth TRI[j]. The root: k0 node 1 (z 3..4), k1 row 0 (entered
    at TIE_FAR), k2 row 1 (entered at 5.0: nearer, but after k1 in key
    order), k3 row 5 (entered at 4.0; empty without ``with_near_leaf``),
    k4 node 2 (entered at -0.0), k5 node 3 missed; node 1: k0 node 3 (z
    3.5..4), k1 row 2; node 2: k0 row 3; node 3: k0 row 4."""
    root = {0: (3.0, 4.0, 1), 1: (TIE_FAR, 6.0, ~0), 2: (5.0, 6.0, ~1),
            4: (-0.0, 1.0, 2), 5: (None, 1.0, 3)}
    if with_near_leaf:
        root[3] = (4.0, 4.6, ~5)
    nodes = np.stack([_node(root),
                      _node({0: (3.5, 4.0, 3), 1: (3.25, 3.3, ~2)}),
                      _node({0: (0.5, 0.75, ~3)}),
                      _node({0: (3.75, 3.8, ~4)})])
    leaves = np.zeros((6, 8, 10), np.float32)
    for j, z in enumerate(TRI):
        leaves[j, 0, 0:9] = (-1.0, -1.0, z, 4.0, 0.0, 0.0, 0.0, 4.0, 0.0)
    return _t(nodes), _t(leaves.reshape(6, 80))


TRI = (5.5, 5.25, 3.25, 0.5, 3.75, 4.5)  # each leaf row's triangle depth
# hand-worked walks of one ray, ordered -> (pops, leaf-row tests) for the
# closest hit and the any-hit result's slot, with and without row 5's leaf
# at the root. Storage order pops node 1 first (LIMIT 4.5 or 5.25 from the
# root's leaves), pushes node 3 and finds row 2's 3.25 there, pops node 3
# in vain and finds row 3's 0.5 in node 2 last. Near-first pops node 2
# first (key +0 beats node 1's 3.0), finds 0.5, and then node 1's children
# all miss; at the root it tests row 5 (4.0) before the tied rows 0 and 1,
# after which their triangles (5.5, 5.25) are too far.
HAND = {True: {False: ((4, 5), 0), True: ((3, 4), 40)},
        False: {False: ((4, 4), 0), True: ((3, 3), 0)}}


def _order_ray(n: int = 1):
    ro = torch.zeros((n, 3))
    rd = torch.zeros((n, 3))
    rd[:, 2] = 1.0
    return ro, rd


@pytest.mark.parametrize("with_near_leaf", [True, False])
@pytest.mark.parametrize("ordered", [False, True])
def test_near_first_order_is_the_hand_worked_one(with_near_leaf, ordered):
    """On the hand-built tree (tmin -0.0, so the interior child at z = -0.0
    is entered at -0.0): closest-hit returns row 3's triangle (slot 24, t
    0.5) in both orders with the hand-worked pops and leaf-row tests;
    any-hit returns the first leaf in key order (near-first: row 5 at 4.0,
    or without it row 0, whose entry distance ties row 1's nearer one in
    bits & ~7 and whose k is lower), or in storage order the first by k.
    The mixed form's closest and shadow lanes do the same, and their
    counts add."""
    nodes, leaves = _order_tree(with_near_leaf)
    first = first_slots(leaves)
    ro, rd = _order_ray()
    (pops, tests), any_slot = HAND[with_near_leaf][ordered]
    t, tri, st = packet_query_torch(nodes, leaves, first, ro, rd,
                                    torch.tensor([F32_MAX]), -0.0, False,
                                    ordered=ordered, with_stats=True,
                                    packet=128)
    assert float(t[0]) == 0.5 and int(tri[0]) == 24
    assert (int(st[0, 0]), int(st[0, 1])) == (pops, tests)
    _, tri_a, st_a = packet_query_torch(nodes, leaves, first, ro, rd,
                                        torch.tensor([F32_MAX]), -0.0, True,
                                        ordered=ordered, with_stats=True,
                                        packet=128)
    assert int(tri_a[0]) == any_slot
    assert (int(st_a[0, 0]), int(st_a[0, 1])) == (1, 1)
    ro2, rd2 = _order_ray(2)
    t_m, tri_m, st_m = packet_query_torch(
        nodes, leaves, first, ro2, rd2, torch.full((2,), F32_MAX), -0.0,
        False, smask=torch.tensor([0.0, 1.0]), shadow_tmin=-0.0,
        ordered=ordered, with_stats=True, packet=128)
    assert float(t_m[0]) == 0.5 and tri_m.tolist() == [24, any_slot]
    assert (int(st_m[0, 0]), int(st_m[0, 1])) == (pops + 1, tests + 1)


def test_near_first_key_of_minus_zero_is_plus_zeros():
    """Without the + 0, the child entered at -0.0 would key as
    0x80000000 | k, after every other child, and near-first would pop node
    1 before node 2: the hand-worked pops pin the + 0. Its entry distance
    is -0.0 in this tree (as the slab computes it)."""
    nodes, _ = _order_tree(True)
    box = nodes[0].reshape(8, 16)[4]
    lo_z = (box[2] - 0.0) * 1.0
    near = torch.maximum(torch.maximum(torch.tensor(-1e36),
                                       torch.tensor(-1e36)),
                         torch.maximum(lo_z, torch.tensor(-0.0)))
    assert float(near) == 0.0 and torch.signbit(near)
    assert not torch.signbit(near + 0.0)
    assert HAND[True][True][0][0] < HAND[True][False][0][0]


N_BOUNDARY = 434  # three blocks of 128 rays and a part block


def _boundary_lanes(form: str, c: dict):
    """(ro, rd, tmax, tmin, any_hit, keywords) of N_BOUNDARY rays of the
    300-triangle soup, rays 128..255 (a packet of 128) all dead."""
    if form == "mixed":
        ro, rd, tmax, smask, _ = (_t(a) for a in _lanes(N_BOUNDARY, 300))
        kw = dict(smask=smask, shadow_tmin=0.0)
    else:
        ro, rd = c["ro"], c["rd"]
        tmax = (c["shadow"] if form == "any" else c["tmax"]).clone()
        kw = {}
    tmax = tmax.clone()
    tmax[128:256] = float("-inf")
    return (ro, rd, tmax, 0.0 if form == "any" else 0.001, form == "any",
            kw)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("form", ["closest", "any", "mixed"])
def test_packet_stats_are_per_ray_sums_across_blocks(form, ordered):
    """Each ray walked alone (placed first in a packet of its own, the
    packet's other lanes dead) gives its own pops and leaf-row tests; the
    stats of the 434 rays together, at packets of 128 and 384 (a partial
    last block and a partial last packet), are those per-ray counts summed
    per packet: lane 1 the tests, every other lane the pops; the all-dead
    packet counts 0, and t and tri are the walk's without stats."""
    c = _case(300, N_BOUNDARY)
    ro, rd, tmax, tmin, any_hit, kw = _boundary_lanes(form, c)
    head = (c["rows8"], c["leaf"], c["first"])
    # ray j alone at lane 128 j: row j of the stats is its own walk
    idx = torch.arange(N_BOUNDARY) * 128
    alone = {}
    for name, x in (("ro", ro), ("rd", rd)):
        alone[name] = torch.zeros((N_BOUNDARY * 128, 3))
        alone[name][idx] = x
    alone["tmax"] = torch.full((N_BOUNDARY * 128,), float("-inf"))
    alone["tmax"][idx] = tmax
    akw = dict(kw)
    if "smask" in kw:
        akw["smask"] = torch.zeros(N_BOUNDARY * 128)
        akw["smask"][idx] = kw["smask"]
    _, _, own = packet_query_torch(*head, alone["ro"], alone["rd"],
                                   alone["tmax"], tmin, any_hit, **akw,
                                   ordered=ordered, with_stats=True,
                                   packet=128)
    pops, tests = own[:, 0].long(), own[:, 1].long()
    assert int(pops[128:256].sum()) == 0 and int(pops.sum()) > N_BOUNDARY
    t0, tri0 = packet_query_torch(*head, ro, rd, tmax, tmin, any_hit, **kw,
                                  ordered=ordered)
    lane = torch.arange(128)
    for packet in (128, 384):
        t, tri, st = packet_query_torch(*head, ro, rd, tmax, tmin, any_hit,
                                        **kw, ordered=ordered,
                                        with_stats=True, packet=packet)
        rows = -(-N_BOUNDARY // packet)
        pk = torch.arange(N_BOUNDARY) // packet
        want_p = torch.zeros(rows, dtype=torch.long).index_add_(0, pk, pops)
        want_t = torch.zeros(rows, dtype=torch.long).index_add_(0, pk, tests)
        assert st.shape == (rows, 128) and st.dtype == torch.int32
        assert st[:, 1].long().tolist() == want_t.tolist()
        assert torch.equal(st[:, lane != 1].long(),
                           want_p[:, None].expand(rows, 127))
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
        assert torch.equal(tri, tri0)
        if packet == 128:
            assert int(st[1].abs().sum()) == 0  # the all-dead packet


@pytest.mark.parametrize("ntri", [5, 300, 3000])
def test_plain_walk_counts_hit_children(ntri):
    """The plain walk's "hits" count (the histogram the packet timing
    reports): its pops are the walk's node pops, its hit leaves the
    leaf-row tests (a closest-hit walk tests every hit leaf), its hit
    interior children every push (each pushed node is popped once, the
    roots are not pushed), and asking for it leaves t, tri and stats as
    they are."""
    c = _case(ntri)
    args = (c["rows8"], c["leaf"], c["first"], c["ro"], c["rd"], c["tmax"],
            0.001, False)
    work = {"hits": {}}
    t, tri, st = packet_query_torch(*args, work, ordered=False,
                                    with_stats=True, packet=128)
    t0, tri0, st0 = packet_query_torch(*args, ordered=False,
                                       with_stats=True, packet=128)
    pops, (groups, sortless) = work["hits"]["pops"], work["hits"]["groups"]
    n = torch.arange(9)
    live = int((c["tmax"] != float("-inf")).sum())
    assert pops.shape == (9, 9) and int(pops.sum()) == int(st[:, 0].sum())
    assert int((pops.sum(0) * n).sum()) == int(st[:, 1].sum())
    assert int((pops.sum(1) * n).sum()) == int(pops.sum()) - live
    assert 0 < sortless <= groups
    assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
    assert torch.equal(tri, tri0) and torch.equal(st, st0)


@pytest.mark.cuda
def test_order_and_boundary_counts_on_cuda():
    """packet_walk.cu's 12 instances on the hand-built tree (the
    hand-worked results and counts) and over the boundary lanes (bit for
    bit against the plain version: t and tri, and every stats lane where
    the instance has stats)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    for with_near_leaf in (True, False):
        nodes, leaves = (x.cuda() for x in _order_tree(with_near_leaf))
        first = first_slots(leaves)
        ro, rd = (x.cuda() for x in _order_ray())
        tmax = torch.full((1,), float(F32_MAX), device="cuda")
        for ordered in (False, True):
            (pops, tests), any_slot = HAND[with_near_leaf][ordered]
            for st in (False, True):
                out = packet_query_cuda(nodes, leaves, first, ro, rd, tmax,
                                        -0.0, False, ordered=ordered,
                                        with_stats=st, packet=128)
                assert float(out[0][0]) == 0.5 and int(out[1][0]) == 24
                if st:
                    assert out[2][0, :2].tolist() == [pops, tests]
                out = packet_query_cuda(nodes, leaves, first, ro, rd, tmax,
                                        -0.0, True, ordered=ordered,
                                        with_stats=st, packet=128)
                assert int(out[1][0]) == any_slot
    c = {k: v.cuda() for k, v in _case(300, N_BOUNDARY).items()}
    for form in ("closest", "any", "mixed"):
        ro, rd, tmax, tmin, any_hit, kw = _boundary_lanes(form, c)
        kw = {k: v.cuda() if torch.is_tensor(v) else v
              for k, v in kw.items()}
        args = (c["rows8"], c["leaf"], c["first"], ro.cuda(), rd.cuda(),
                tmax.cuda(), tmin, any_hit)
        for packet in (128, 384):
            for ordered in (False, True):
                want = packet_query_torch(*args, **kw, ordered=ordered,
                                          with_stats=True, packet=packet)
                for st in (False, True):
                    got = packet_query_cuda(*args, **kw, ordered=ordered,
                                            with_stats=st, packet=packet)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32))
                    assert torch.equal(got[1], want[1])
                    if st:
                        assert torch.equal(got[2], want[2])
