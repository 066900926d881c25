"""Captured engine waves of the atrium, for the walks' A/Bs: the port's
counterpart of raytpu's ``benchmarks/waves.py``.

Synthetic ray sets can reverse kernel verdicts that the engine's real
deep-bounce waves give (an enclosed scene, half the lanes dead, hits
nearby), so raytpu times its walks on real waves of its headline frame,
and so does this tool:

* ``capture``: one tile of the atrium frame (1920x1080, seed 1, 4
  bounces, chunk 8; tile 0, rows 0..545, the tile of raytpu's fixtures)
  traced by the engine's own ``_trace_paths`` in query mode, unsorted,
  recording every query's inputs (origins, directions, per-lane tmax with
  -inf on dead lanes, tmin). With ``RAYTPU_B0_STRAND`` on (the default)
  every wave of a scene above 256 slots goes through the strand pair, so
  the recorder wraps the pair the engine calls. Waves are named as raytpu
  names them: ``b{k}c`` / ``b{k}s``, the k-th closest-hit / shadow query.
* ``save_capture``: the full capture into ``.bench_cache/`` and raytpu's
  f16 bands of the four key waves into a directory of the caller's
  (``.bench_cache/waves_torch/`` by default). It never writes
  ``benchmarks/waves/``, raytpu's committed fixtures.
* ``load_wave``: a wave from the full capture when there is one, else
  from raytpu's committed f16 bands (``benchmarks/waves/``, read as
  data); numpy only.
* ``engine_sort``: the engine's coherence sort (``_ray_sort_key``, dead
  lanes last, a stable sort, so ties keep engine order).
* ``stats``: the packet walk over each wave in storage and in near-first
  order: ms per launch, Mrays/s, and the stats rows' pops and leaf tests
  per packet at raytpu's packet sizes (the port walks a ray per thread, so
  a packet's counters are its rays' sums, not a shared stack's union, and
  the packet size groups the stats rows and changes nothing else: each
  order's launch is timed once).
* ``ab``: the strand walks against the packet walk on each wave (the
  per-ray walk, the block walk, its deferral form at ``--groups`` G, and
  the schedule form at ``--persistent W,K[,FO]``), with raytpu's
  agreement rule: the blocked bit on any-hit waves, the triangle's data on
  closest-hit waves (spatial splits store one triangle in several slots).

Times are ms per launch from ``--inner`` launches queued together behind
a sleep kernel (``tools/timing.py:queued_ms``): CUDA events around one
launch of a ~262k-ray wave measure the host. ``--plain`` holds
every launch to its plain version, bit for bit (t, tri and counters).

    python -m raytpu_torch.tools.waves capture [--tris 250000]
    python -m raytpu_torch.tools.waves stats [--waves b1c b2c b3c b2s]
    python -m raytpu_torch.tools.waves ab [--groups 16] [--persistent 128,16]
    python -m raytpu_torch.tools.waves stats --device cpu --tris 5000 --rays 4096

The pack is ``tools/scenes.py:cached_atrium``'s; ``stats`` and ``ab`` need
its BVH8 rows, so a pack whose default tables drop them is packed
``tables="all"`` (the tool says so). On the CPU every walk runs as its
plain version.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import scenes
from .timing import queued_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# raytpu's committed f16 bands, read as data files
WAVES_DIR = os.path.join(REPO, "benchmarks", "waves")
BANDS_DIR = os.path.join(REPO, ".bench_cache", "waves_torch")
COMMIT_WAVES = ("b1c", "b2c", "b3c", "b2s")
COMMIT_RAYS = 262144  # contiguous band kept per wave (f16)
# tile 0 of raytpu's fixtures: rows 0..545 (2^20 // 1920, its tile height
# when it captured them)
FIXTURE_TILE_ROWS = 546
PACKETS = (4096, 2048, 1024, 512, 256, 128)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def full_cache(tris: int = 250_000) -> str:
    """The full capture of the atrium at ``tris`` triangles, under
    ``scenes.CACHE`` (read at call time)."""
    return os.path.join(scenes.CACHE, f"waves_atrium{tris}_torch_full.npz")


class Recorder:
    """Wraps a (closest, any_hit) pair; records every call's inputs as
    numpy (kind, ro, rd, tmin, tmax broadcast to [R]) before passing
    through."""

    def __init__(self, closest, any_hit):
        self._closest = closest
        self._any = any_hit
        self.calls = []

    def _record(self, kind, ro, rd, tmin, tmax):
        tm = torch.as_tensor(tmax, dtype=torch.float32,
                             device=ro.device).expand(ro.shape[0])
        self.calls.append((kind, ro.cpu().numpy().copy(),
                           rd.cpu().numpy().copy(), float(tmin),
                           tm.cpu().numpy().copy()))

    def closest(self, ro, rd, tmin, tmax):
        self._record("closest", ro, rd, tmin, tmax)
        return self._closest(ro, rd, tmin, tmax)

    def any_hit(self, ro, rd, tmin, tmax):
        self._record("shadow", ro, rd, tmin, tmax)
        return self._any(ro, rd, tmin, tmax)


def capture(pack, camera, width: int = 1920, height: int = 1080,
            bounces: int = 4, seed: int = 1,
            tile_rows: int = FIXTURE_TILE_ROWS, chunk_size: int = 8):
    """Tile 0's waves (rows [0, tile_rows), at most the frame) from the
    engine's trace on the pack's device, in query mode and unsorted:
    {name: dict(ro, rd, tmax, tmin, kind, bounce)}, numpy."""
    from ..engine.render import Route, _camera_rays, _tile, _trace_paths
    from ..types import RenderConfig

    cfg = RenderConfig(width=width, height=height, seed=seed, samples=1,
                       bounces=bounces, chunk_size=chunk_size)
    tile = _tile(pack, 0, cfg, min(tile_rows, height), seed)
    route = tile.route
    if not route.packet_mode:
        raise ValueError("wave capture expects the packet or strand route")
    rec = Recorder(*(route.bounce_pair or (route.closest, route.any_hit)))
    ro, rd, rng = _camera_rays(tile, camera, cfg, tile.rng)
    _log(f"[waves] tracing tile 0 ({ro.shape[0]} rays, {bounces} "
         "bounces)...")
    # unsorted (sort_bounced False): the recorder sees each wave in engine
    # order; the A/Bs apply the sort under test themselves
    pair = (rec.closest, rec.any_hit)
    _trace_paths(pack, Route(*pair, packet_mode=True, sort_bounced=False,
                             mixed_fn=None, bounce_pair=pair),
                 ro, rd, rng, bounces, mask=tile.in_grid)
    waves = {}
    counts = {"closest": 0, "shadow": 0}
    for kind, wro, wrd, wtmin, wtmax in rec.calls:
        b = counts[kind]
        counts[kind] += 1
        name = f"b{b}{'c' if kind == 'closest' else 's'}"
        waves[name] = dict(ro=wro, rd=wrd, tmax=wtmax,
                           tmin=np.float32(wtmin), kind=kind,
                           bounce=np.int32(b))
        _log(f"[waves] {name}: {wro.shape[0]} rays, "
             f"{float((wtmax >= 0).mean()) * 100:.0f}% live")
    return waves


def band(w: dict):
    """raytpu's f16 band of a wave (its ``save_capture``): the middle
    COMMIT_RAYS rays, dead lanes' payloads zeroed (tmax -inf, ro 0, rd 1)
    and the open bound F32_MAX mapped to +inf. Returns (dict of f16 ro,
    rd, tmax, band start)."""
    r = w["ro"].shape[0]
    lo = max((r - COMMIT_RAYS) // 2, 0)
    sl = slice(lo, lo + min(COMMIT_RAYS, r))
    tmax = w["tmax"][sl].astype(np.float32).copy()
    dead = tmax < 0
    tmax[dead] = -np.inf
    tmax[tmax >= 1e38] = np.inf
    ro = w["ro"][sl].astype(np.float32).copy()
    rd = w["rd"][sl].astype(np.float32).copy()
    ro[dead] = 0.0
    rd[dead] = 1.0
    return dict(ro=ro.astype(np.float16), rd=rd.astype(np.float16),
                tmax=tmax.astype(np.float16)), lo


def save_capture(waves, full: str, bands_dir: str = BANDS_DIR,
                 prefix: str = "atrium250k") -> None:
    """The full capture into ``full`` (``full_cache(tris)``) and the f16 band of each of
    COMMIT_WAVES into ``bands_dir`` (``<prefix>_<name>.npz``, raytpu's
    fixture layout)."""
    os.makedirs(os.path.dirname(full), exist_ok=True)
    flat = {f"{name}_{k}": v for name, w in waves.items()
            for k, v in w.items() if k != "kind"}
    flat["names"] = np.array(sorted(waves))
    np.savez_compressed(full, **flat)
    _log(f"[waves] full capture -> {full} "
         f"({os.path.getsize(full) / 1e6:.1f} MB)")
    os.makedirs(bands_dir, exist_ok=True)
    for name in COMMIT_WAVES:
        w = waves[name]
        b, lo = band(w)
        path = os.path.join(bands_dir, f"{prefix}_{name}.npz")
        np.savez_compressed(path, **b, tmin=w["tmin"], bounce=w["bounce"],
                            kind=np.array(w["kind"]),
                            full_rays=np.int64(w["ro"].shape[0]),
                            band_start=np.int64(lo))
        _log(f"[waves] band {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


def band_agreement(waves, waves_dir: str = WAVES_DIR) -> list:
    """A capture's f16 bands against raytpu's committed ones, per wave of
    COMMIT_WAVES: dict(name, rays, same_rays (the full waves' lane counts
    agree), live_agree (the share of lanes whose live mask agrees), ro,
    rd (the largest |difference| of the f16 values over lanes live in
    both))."""
    out = []
    for name in COMMIT_WAVES:
        ours, _ = band(waves[name])
        z = np.load(os.path.join(waves_dir, f"atrium250k_{name}.npz"),
                    allow_pickle=False)
        live_a = ours["tmax"].astype(np.float32) >= 0
        live_b = z["tmax"].astype(np.float32) >= 0
        both = live_a & live_b
        d = {k: float(np.abs(ours[k].astype(np.float32)[both]
                             - z[k].astype(np.float32)[both]).max(
                                 initial=0.0)) for k in ("ro", "rd")}
        out.append(dict(name=name, rays=int(live_a.shape[0]),
                        same_rays=int(z["full_rays"])
                        == waves[name]["ro"].shape[0],
                        live_agree=float((live_a == live_b).mean()), **d))
    return out


def load_wave(name: str, prefer_full: bool = True, full: str | None = None,
              waves_dir: str = WAVES_DIR):
    """-> dict(ro, rd, tmax [f32 numpy], tmin float, kind str). Prefers
    the full capture ``full`` (default ``full_cache()``, the 250k atrium's);
    falls back to the committed f16 band."""
    full = full_cache() if full is None else full
    if prefer_full and os.path.exists(full):
        z = np.load(full, allow_pickle=False)
        if f"{name}_ro" in z:
            return dict(
                ro=z[f"{name}_ro"], rd=z[f"{name}_rd"],
                tmax=z[f"{name}_tmax"], tmin=float(z[f"{name}_tmin"]),
                kind="shadow" if name.endswith("s") else "closest",
            )
    z = np.load(os.path.join(waves_dir, f"atrium250k_{name}.npz"),
                allow_pickle=False)
    return dict(
        ro=z["ro"].astype(np.float32), rd=z["rd"].astype(np.float32),
        tmax=z["tmax"].astype(np.float32), tmin=float(z["tmin"]),
        kind=str(z["kind"]),
    )


def engine_sort(pack, ro, rd, tmax, extra=()):
    """The engine's coherence sort (``_ray_sort_key``: dead lanes last,
    then direction octant, then the origin's Morton cell; a stable sort,
    so equal keys keep engine order) on the pack's device; returns sorted
    (ro, rd, tmax, *extra) tensors."""
    from ..engine.render import _ray_sort_key

    dev = pack.device
    ro, rd, tmax = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (ro, rd, tmax))
    perm = torch.sort(_ray_sort_key(pack, ro, rd, tmax >= 0), stable=True)[1]
    return (ro[perm].contiguous(), rd[perm].contiguous(),
            tmax[perm].contiguous()) + tuple(
                torch.as_tensor(e, device=dev)[perm] for e in extra)


def sorted_waves(pack, names, rays: int | None = None,
                 prefer_full: bool = True, full: str | None = None) -> dict:
    """{name: dict(ro, rd, tmax, tmin, kind)}: each wave loaded
    (``load_wave``), cut to its first ``rays`` rays when given, and
    engine-sorted on the pack's device."""
    out = {}
    for name in names:
        w = load_wave(name, prefer_full, full)
        cut = slice(None, rays)
        ro, rd, tmax = engine_sort(pack, w["ro"][cut], w["rd"][cut],
                                   w["tmax"][cut])
        out[name] = dict(ro=ro, rd=rd, tmax=tmax, tmin=w["tmin"],
                         kind=w["kind"])
    return out


def same_bits(a, b) -> bool:
    """Two results (tensors or tuples of them) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return all(same_bits(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def agree(pack, any_hit: bool, tri_a, tri_b) -> bool:
    """raytpu's agreement rule for two walks' results on one wave: the
    blocked bit on any-hit waves; on closest-hit waves the hit mask and the
    committed slots' triangle data (spatial splits store one triangle in
    several slots with the same rows)."""
    if not bool(((tri_a >= 0) == (tri_b >= 0)).all()):
        return False
    if any_hit:
        return True
    rows = pack.bvh.leaf_tris.reshape(-1, 10)[:, :9]
    hit = tri_a >= 0
    return bool((rows[tri_a[hit].long()] == rows[tri_b[hit].long()]).all())


def _plain_check(label: str, got, want) -> str:
    if not same_bits(got, want):
        raise RuntimeError(f"{label}: the launch differs from its plain "
                           "version")
    return "bit-equal"


def regroup(st, k: int):
    """Stats rows of packet p summed ``k`` rows at a time: the rows of
    packet k * p (a packet's counters are its rays' sums, wrapped as int32
    sums)."""
    from ..kernels.strand import wrap_i32

    n = -(-st.shape[0] // k)
    pad = st.new_zeros((n * k - st.shape[0], st.shape[1]))
    sums = torch.cat([st, pad]).long().reshape(n, k, -1).sum(1)
    return wrap_i32(sums).to(torch.int32)


def stats(pack, waves: dict, packets=PACKETS, inner: int = 32,
          repeats: int = 5, plain: bool = False) -> list:
    """The packet walk over each sorted wave (``sorted_waves``) in storage
    order, then near-first: one row per (wave, order, packet) with ms per
    launch, Mrays/s (all lanes and live lanes) and the stats rows' pops and
    leaf tests per packet and in all. The packet size enters only the stats
    rows, so each order's launch is timed once and its ms stands in every
    size's row. With ``plain`` each order's plain version runs once, at the
    smallest packet: the timed launch's (t, tri) and each size's stats
    launch (t, tri and the counters, which are the smallest packet's rows
    summed, ``regroup``) are held to it bit for bit."""
    from ..kernels.packet import packet_query, packet_query_torch

    node8, leaf, first = (pack.bvh.node8_rows, pack.bvh.leaf_tris,
                          pack.bvh.first_slots)
    cuda = pack.device.type == "cuda"
    small = min(packets)
    if any(p % small for p in packets):
        raise ValueError(f"packets {packets}: want multiples of the "
                         "smallest")
    rows = []
    for name, w in waves.items():
        any_hit = w["kind"] == "shadow"
        args = (node8, leaf, first, w["ro"], w["rd"], w["tmax"], w["tmin"],
                any_hit)
        r = w["ro"].shape[0]
        live = float((w["tmax"] >= 0).float().mean())
        for ordered in (False, True):
            ms = queued_ms(lambda: packet_query(*args, ordered=ordered),
                           inner, repeats, cuda)
            want = note = None
            if plain:
                label = f"{name} packet_walk"
                want = packet_query_torch(*args, ordered=ordered,
                                          packet=small, with_stats=True)
                note = _plain_check(label, packet_query(
                    *args, ordered=ordered), want[:2])
            for packet in packets:
                out = packet_query(*args, ordered=ordered, packet=packet,
                                   with_stats=True)
                if plain:
                    _plain_check(f"{label} {packet}", out, (
                        *want[:2], regroup(want[2], packet // small)))
                s = out[2]
                pops, leafs = s[:, 0].double(), s[:, 1].double()
                rows.append(dict(
                    wave=name, kernel="packet_walk "
                    + ("near-first" if ordered else "storage"),
                    packet=packet, ms=ms, mrays=r / ms / 1e3,
                    live_mrays=r * live / ms / 1e3,
                    pops=float(pops.mean()), leafs=float(leafs.mean()),
                    pops_total=int(pops.sum()), leafs_total=int(leafs.sum()),
                    unit="packet", agree="", plain=note or ""))
    return rows


def ab(pack, waves: dict, groups=(), persistent=(), inner: int = 32,
       repeats: int = 5, plain: bool = False) -> list:
    """The strand walks against the packet walk on each sorted wave: rows
    for packet_walk (storage order, its pops and leaf tests per 4,096-ray
    packet), strand_walk (the per-ray walk: records loaded and leaf rows
    tested per ray), strand_block (steps and leaf visits per 32-ray strand)
    and its deferral form at each G of ``groups``, each with ms per launch,
    Mrays/s and raytpu's agreement with packet_walk; then strand_walk's
    schedule form at each (W, K[, FO]) of ``persistent`` (walkers,
    service_k, flush_occ, default 0.75), agreement held to strand_block as
    raytpu holds its persistent arms to its block kernel. With ``plain``
    each of packet_walk, strand_walk, strand_block and the deferral form is
    replayed once by its plain version, with counters: the timed launch's
    (t, tri) and the counters' launch are held to it bit for bit."""
    from ..kernels.packet import packet_query, packet_query_torch
    from ..kernels.strand import (
        strand_block_query,
        strand_block_query_torch,
        strand_query,
        strand_query_torch,
    )

    node8, leaf, first = (pack.bvh.node8_rows, pack.bvh.leaf_tris,
                          pack.bvh.first_slots)
    tree = pack.bvh.strand_rows
    cuda = pack.device.type == "cuda"
    rows = []
    for name, w in waves.items():
        any_hit = w["kind"] == "shadow"
        rays = (w["ro"], w["rd"], w["tmax"], w["tmin"], any_hit)
        r = w["ro"].shape[0]

        def arm(kernel, fn, plain_fn, stats_kw, work, against):
            """Times ``fn`` (the rays' walk with no counters), runs it with
            ``stats_kw`` (counters: ``work`` maps them to (pops, leafs,
            unit)) and adds its row; returns its tri."""
            ms = queued_ms(lambda: fn(*rays), inner, repeats, cuda)
            got = fn(*rays, **stats_kw)
            note = ""
            if plain:
                label = f"{name} {kernel}"
                want = plain_fn(*rays, **stats_kw)
                _plain_check(label, fn(*rays), want[:2])
                note = _plain_check(label, got, want)
            rows.append(dict(wave=name, kernel=kernel, packet=None, ms=ms,
                             mrays=r / ms / 1e3, live_mrays=None,
                             **dict(zip(("pops", "leafs", "unit"),
                                        work(got[2]))),
                             agree="" if against is None else agree(
                                 pack, any_hit, got[1], against),
                             plain=note))
            return got[1]

        tri_p = arm("packet_walk",
                    lambda *a, **k: packet_query(node8, leaf, first, *a, **k),
                    lambda *a, **k: packet_query_torch(node8, leaf, first, *a,
                                                       **k),
                    dict(with_stats=True),
                    lambda s: (float(s[:, 0].double().mean()),
                               float(s[:, 1].double().mean()), "packet"),
                    None)
        arm("strand_walk",
            lambda *a, **k: strand_query(tree, leaf, first, *a, **k),
            lambda *a, **k: strand_query_torch(tree, leaf, first, *a, **k),
            dict(stats=True),
            lambda s: (int(s[0]) / r, int(s[4]) / r, "ray"), tri_p)
        tri_b = None
        for label, kw in [("strand_block", {})] + [
                (f"strand_block deferral G {g}",
                 dict(defer=True, groups=int(g))) for g in groups]:
            tri_k = arm(label,
                        lambda *a, kw=kw, **k: strand_block_query(
                            tree, leaf, first, *a, **kw, **k),
                        lambda *a, kw=kw, **k: strand_block_query_torch(
                            tree, leaf, first, *a, **kw, **k),
                        dict(with_stats=True),
                        lambda s: (float(s[:, 0].double().mean()),
                                   float(s[:, 1].double().mean()), "strand"),
                        tri_p)
            tri_b = tri_k if tri_b is None else tri_b
        for w_arm in persistent:
            kw = dict(walkers=int(w_arm[0]), service_k=int(w_arm[1]),
                      flush_occ=float(w_arm[2]) if len(w_arm) > 2 else 0.75)
            ms_s = queued_ms(lambda kw=kw: strand_query(
                tree, leaf, first, *rays, **kw), inner, repeats, cuda)
            _, tri_s = strand_query(tree, leaf, first, *rays, **kw)
            rows.append(dict(
                wave=name, kernel=f"strand_walk schedule W {kw['walkers']} "
                f"K {kw['service_k']} FO {kw['flush_occ']}", packet=None,
                ms=ms_s, mrays=r / ms_s / 1e3, live_mrays=None, pops=None,
                leafs=None, unit="", agree=agree(pack, any_hit, tri_s, tri_b),
                plain=""))
    return rows


def print_table(rows: list) -> None:
    """One markdown table of ``stats``/``ab``/``strand_ab`` rows."""
    print("| wave | kernel and form | packet | ms | Mrays/s | live Mrays/s "
          "| agree | pops / unit | leaf tests / unit | unit | plain |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for x in rows:
        def f(v, fmt):
            return "" if v is None or v == "" else format(v, fmt)
        print(f"| {x['wave']} | {x['kernel']} | {x.get('packet') or ''} | "
              f"{x['ms']:.4f} | {x['mrays']:.1f} | "
              f"{f(x.get('live_mrays'), '.1f')} | {x.get('agree', '')} | "
              f"{f(x.get('pops'), '.1f')} | {f(x.get('leafs'), '.1f')} | "
              f"{x.get('unit', '')} | {x.get('plain', '')} |", flush=True)


def atrium_pack(tris: int, device: str, need_bvh8: bool = True):
    """(scene, pack) of ``cached_atrium``; packed ``tables="all"`` when
    the default tables drop the BVH8 rows and ``need_bvh8``."""
    scene, pack = scenes.cached_atrium(tris, device)
    if need_bvh8 and pack.bvh.node8_rows is None:
        _log(f"[waves] the atrium({tris}) pack streams (no BVH8 rows): "
             "packing it tables='all'")
        scene, pack = scenes.cached_atrium(tris, device, tables="all")
    return scene, pack


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions")
    return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="waves", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("--bands", default=BANDS_DIR,
                     help="directory for the f16 bands")
    st = sub.add_parser("stats")
    st.add_argument("--waves", nargs="*", default=list(COMMIT_WAVES))
    st.add_argument("--packets", type=int, nargs="*", default=list(PACKETS))
    abp = sub.add_parser("ab")
    abp.add_argument("--groups", type=int, nargs="*", default=[],
                     help="the block walk's deferral form at G strands a "
                          "block, besides its default instance")
    abp.add_argument("--persistent", type=lambda s: tuple(
        float(x) for x in s.split(",")), nargs="*", default=[],
        metavar="W,K[,FO]",
        help="schedule-form arms (walkers,service_k[,flush_occ])")
    abp.add_argument("--waves", nargs="*", default=None,
                     help="default: b0c b1c b2c b3c b0s b2s with a full "
                          "capture, else the four committed waves")
    for p in (cap, st, abp):
        p.add_argument("--tris", type=int, default=250_000)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for p in (st, abp):
        p.add_argument("--rays", type=int, default=None,
                       help="the first N rays of each wave")
        p.add_argument("--inner", type=int, default=32,
                       help="launches queued and timed together")
        p.add_argument("--repeats", type=int, default=5)
        p.add_argument("--plain", action="store_true",
                       help="hold every launch to its plain version")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if args.cmd == "capture":
        from ..scene.pack import pack_camera

        scene, pack = atrium_pack(args.tris, dev, need_bvh8=False)
        waves = capture(pack, pack_camera(scene.camera, dev))
        save_capture(waves, full_cache(args.tris), bands_dir=args.bands)
        if args.tris == 250_000:
            for a in band_agreement(waves):
                print(f"{a['name']}: {a['rays']} lanes, full wave's lanes as "
                      f"raytpu's: {a['same_rays']}, live mask agrees on "
                      f"{a['live_agree']:.6f}, largest |d| ro {a['ro']:.6g} "
                      f"rd {a['rd']:.6g} (f16)")
        return 0
    _, pack = atrium_pack(args.tris, dev)
    full = full_cache(args.tris)
    if args.cmd == "stats":
        rows = stats(pack, sorted_waves(pack, args.waves, args.rays,
                                        full=full),
                     args.packets, args.inner, args.repeats, args.plain)
    else:
        names = args.waves or (
            ["b0c", "b1c", "b2c", "b3c", "b0s", "b2s"]
            if os.path.exists(full) else list(COMMIT_WAVES))
        rows = ab(pack, sorted_waves(pack, names, args.rays, full=full),
                  args.groups, args.persistent, args.inner, args.repeats,
                  args.plain)
    print_table(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
