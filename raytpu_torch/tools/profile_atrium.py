"""Traversal profile of the headline atrium config on the card: the port's
counterpart of raytpu's ``benchmarks/profile_atrium.py``.

``packet_query`` over three ray sets of the atrium's 1080p frame:

* PRIMARY rays: the top ``--rays`` (2^20) of the frame in 32x32-block
  order (``engine/render.py:_pixel_layout``, ``cast_rays`` at the pixel
  centres);
* BOUNCE-like rays from their first hits: raytpu's cosine-z scatter (a
  cosine hemisphere around global z, sign-flipped by the incoming
  direction's z) from ``np.random.default_rng(1)``, line for line, so the
  two packages build bit-equal sets from the same hits; sorted by each of
  raytpu's four keys (``sort_rays``: none, octant18, origin_major, dir6)
  and, as raytpu's tool does, walked with an all-alive bound;
* SHADOW-like any-hit rays from the first hits to the first light.

Per set and packet size: Mrays/s, ms, pops per packet (mean, p90), leaf
tests per packet and ns per pop. The port's packet walk walks a ray per
thread, so a packet's counters are its rays' sums and the packet size only
groups the stats rows: each (set, key) launch is timed once and its ms
stands in every packet size's row, and the counters are read once at the
smallest size and regrouped (``tools/waves.py:regroup``). A time is
``--inner`` launches queued behind a sleep kernel (``tools/timing.py``),
the median of ``--repeats``, less the same chain's empty launches (the
port's counterpart of raytpu's RPC floor, printed). The packet walk runs
in the port's default child order (``RAYTPU_ORDER_MODE`` unset: storage
order; raytpu's default is near-first).

``--plain N`` holds each timed set's launch to the plain packet walk on N
sampled rays, bit for bit (t and tri).

    python -m raytpu_torch.tools.profile_atrium [--tris 250000]
        [--rays 1048576] [--packets 4096 2048 1024]
    python -m raytpu_torch.tools.profile_atrium --device cpu --tris 5000 \\
        --rays 4096 --packets 1024 --inner 1 --repeats 1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import scenes
from .timing import SHORT_SLEEP_CYCLES, queued_ms
from .waves import regroup

SORT_MODES = ("none", "octant18", "origin_major", "dir6")
F32_BIG = 3.4e38  # raytpu's open bound of this tool


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def primary_set(cam, rays: int, w: int = 1920, h: int = 1080,
                device="cuda"):
    """(ro, rd, tmax): the top ``rays`` of the w x h frame in 32x32-block
    order, through the pixel centres, with the open bound."""
    from ..engine.render import _pixel_layout, cast_rays

    px, py, _ = _pixel_layout(w, min(rays // w, h), True, device)
    ro, rd = cast_rays(px.to(torch.float32) + 0.5,
                       py.to(torch.float32) + 0.5, cam.world,
                       cam.projection, w, h)
    n = min(rays, ro.shape[0])
    # the origins are one camera position expanded: the walks want rows
    ro, rd = ro[:n].contiguous(), rd[:n].contiguous()
    return ro, rd, torch.full((n,), F32_BIG, device=ro.device)


def bounce_set(ro, rd, t, tri):
    """(hit points, bounce directions, alive) from the first hits (t, tri)
    of (ro, rd): raytpu's cosine-z scatter, line for line."""
    n = ro.shape[0]
    hitp = ro + rd * torch.where(tri >= 0, t, 1.0)[:, None]
    rng = np.random.default_rng(1)
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random(n).astype(np.float32)
    rdisk = np.sqrt(u1)
    th = 2 * np.pi * u2
    dx, dy = rdisk * np.cos(th), rdisk * np.sin(th)
    dz = np.sqrt(np.maximum(1 - dx * dx - dy * dy, 0.0))
    dz = np.where(rd[:, 2].cpu().numpy() < 0, -dz, dz)
    brd = torch.as_tensor(np.stack([dx, dy, dz], -1), device=ro.device)
    return hitp, brd, tri >= 0


def shadow_set(pack, hitp):
    """(origins, directions, distances): the hit points towards the first
    light."""
    lpos = pack.light_table[0, 0:3]
    to_l = lpos[None, :] - hitp
    sq = to_l * to_l
    # summed x, y, then z, as XLA sums raytpu's three terms (torch.sum's
    # vectorised order rounds apart on some rays); the square root taken
    # in f64 and rounded to f32 is the correctly rounded f32 root on every
    # device (torch's f32 root on the CPU is off by an ulp on some rays)
    dist = torch.sqrt(((sq[:, 0] + sq[:, 1]) + sq[:, 2]).double()).float()
    return hitp, to_l / dist[:, None], dist


def _morton6(q):
    from ..kernels.coherence import _morton

    return _morton((q[:, 0], q[:, 1], q[:, 2]), 6)


def sort_rays(pack, ro, rd, mode: str):
    """raytpu's coherence sorts (its ``sort_rays``): sorted (ro, rd) by
    ``none`` (as given), ``octant18`` (octant, then the origin's 6-bit
    Morton cell: the engine's key), ``origin_major`` (the cell, then the
    octant) or ``dirN`` (the direction's N-bit-per-axis Morton cell, then
    the origin's); a stable lexicographic sort."""
    if mode == "none":
        return ro, rd
    ext = torch.clamp(pack.scene_bmax - pack.scene_bmin, min=1e-6)
    q = torch.clamp(((ro - pack.scene_bmin) / ext * 64.0).to(torch.int32),
                    0, 63)
    omorton = _morton6(q)
    octant = ((rd[:, 0] < 0).to(torch.int32)
              | ((rd[:, 1] < 0).to(torch.int32) << 1)
              | ((rd[:, 2] < 0).to(torch.int32) << 2))
    if mode == "octant18":  # the engine's key
        key = ((octant << 18) | omorton).long()
    elif mode.startswith("dir"):  # fine direction-major, origin minor
        n = 1 << int(mode[3:])
        dq = torch.clamp(((rd * 0.5 + 0.5) * n).to(torch.int32), 0, n - 1)
        key = (_morton6(dq).long() << 32) | omorton.long()
    elif mode == "origin_major":
        key = ((omorton << 3) | octant).long()
    else:
        raise ValueError(mode)
    perm = torch.sort(key, stable=True)[1]
    return ro[perm].contiguous(), rd[perm].contiguous()


def _floor_ms(device, inner: int, repeats: int, cuda: bool) -> float:
    """ms of one empty launch, queued ``inner`` at a time."""
    x = torch.zeros(1, device=device)
    return queued_ms(lambda: x.add_(0.0), inner, repeats, cuda,
                     SHORT_SLEEP_CYCLES)


def measure(pack, ro, rd, tmax, *, packets, any_hit: bool = False,
            label: str = "", inner: int = 8, repeats: int = 5,
            floor: float = 0.0, plain: int = 0) -> list:
    """raytpu's ``time_query`` rows of one ray set, one per packet size:
    the launch timed once (less ``floor``), the stats read once at the
    smallest packet and regrouped. With ``plain`` > 0 the launch is held
    to the plain walk on that many sampled rays (RuntimeError if not
    bit-equal)."""
    from ..kernels.packet import packet_query, packet_query_torch

    tables = (pack.bvh.node8_rows, pack.bvh.leaf_tris, pack.bvh.first_slots)
    cuda = ro.device.type == "cuda"
    r = ro.shape[0]
    args = (*tables, ro, rd, tmax, 0.001, any_hit)
    ms = queued_ms(lambda: packet_query(*args), inner, repeats, cuda,
                   SHORT_SLEEP_CYCLES)
    dt = max(ms - floor, 1e-6) / 1e3
    small = min(packets)
    t, tri, st = packet_query(*args, packet=small, with_stats=True)
    note = ""
    if plain:
        idx = torch.as_tensor(np.sort(np.random.default_rng(7).choice(
            r, min(plain, r), replace=False)), device=ro.device)
        pt, ptri = packet_query_torch(*tables, ro[idx], rd[idx], tmax[idx],
                                      0.001, any_hit)
        # the timed launch's results, and the stats launch's
        for ot, otri in (packet_query(*args), (t, tri)):
            if not (torch.equal(pt.view(torch.int32),
                                ot[idx].view(torch.int32))
                    and torch.equal(ptri, otri[idx])):
                raise RuntimeError(f"{label}: packet_walk differs from its "
                                   "plain version")
        note = f"; plain walk bit-equal on {idx.numel()} sampled rays"
    rows = []
    for packet in packets:
        s = regroup(st, packet // small).cpu().numpy()
        pops, leafs = s[:, 0].astype(np.float64), s[:, 1].astype(np.float64)
        mrays = r / dt / 1e6
        rows.append(
            f"| {label} | {packet} | {mrays:8.1f} | {dt * 1000:7.2f} | "
            f"{pops.mean():7.0f} | {np.percentile(pops, 90):7.0f} | "
            f"{leafs.mean():6.0f} | {dt / max(pops.sum(), 1) * 1e9:6.3f} |")
        _log(f"[profile] {label} packet={packet}: {mrays:.1f} Mrays/s, "
             f"pops mean {pops.mean():.0f} p90 {np.percentile(pops, 90):.0f}"
             f", leafs mean {leafs.mean():.0f}{note}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_atrium", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--packets", type=int, nargs="*",
                    default=[4096, 2048, 1024])
    ap.add_argument("--inner", type=int, default=8,
                    help="launches queued and timed together")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--plain", type=int, default=0, metavar="N",
                    help="hold each set's launch to the plain walk on N "
                         "sampled rays")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    from ..kernels.packet import packet_query
    from ..scene.pack import pack_camera
    from .waves import atrium_pack

    dev = args.device
    cuda = dev == "cuda"
    small = min(args.packets)
    if any(p % small for p in args.packets):
        raise SystemExit(f"packets {args.packets}: want multiples of the "
                         "smallest")
    scene, pack = atrium_pack(args.tris, dev)
    cam = pack_camera(scene.camera, dev)
    _log(f"[profile] atrium {args.tris} tris, BVH nodes "
         f"{tuple(pack.bvh.node8_rows.shape)}, leaves "
         f"{tuple(pack.bvh.leaf_tris.shape)}")
    floor = _floor_ms(dev, args.inner, args.repeats, cuda)
    _log(f"[profile] empty launch {floor * 1e3:.1f} us (queued "
         f"{args.inner} at a time), subtracted from each launch")
    kw = dict(packets=args.packets, inner=args.inner, repeats=args.repeats,
              floor=floor, plain=args.plain)

    ro, rd, tmax = primary_set(cam, args.rays, device=dev)
    n = ro.shape[0]
    rows = ["| rays | packet | Mrays/s | ms | pops/pkt | p90 | leafs | "
            "ns/pop |", "|---|---|---|---|---|---|---|---|"]
    rows += measure(pack, ro, rd, tmax, label="primary",
                    **dict(kw, packets=[4096]))

    tables = (pack.bvh.node8_rows, pack.bvh.leaf_tris, pack.bvh.first_slots)
    t, tri = packet_query(*tables, ro, rd, tmax, 0.001, False)
    hitp, brd, alive = bounce_set(ro, rd, t, tri)
    _log(f"[profile] bounce set: {float(alive.float().mean()) * 100:.0f}% "
         "lanes alive")
    for mode in SORT_MODES:
        sro, srd = sort_rays(pack, hitp, brd, mode)
        # dead lanes would keep -inf bounds on unsorted rays; after the
        # sort the pairing is lost, so the all-alive bound (raytpu's)
        rows += measure(pack, sro, srd, tmax, label=f"bounce/{mode}", **kw)

    sro, sdir, dist = shadow_set(pack, hitp)
    rows += measure(pack, sro, sdir, dist, any_hit=True,
                    label="shadow(any)", **dict(kw, packets=[4096]))

    print("# Atrium traversal profile\n")
    print(f"- scene: {args.tris} tris, rays per set: {n}")
    print("- device: " + (f"{torch.cuda.get_device_name(0)}" if cuda
                          else "cpu (the plain packet walk)") + "\n")
    print("\n".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
