"""Offline sizing of a block-binned GEMM intersector on the captured
waves: the port's counterpart of raytpu's ``benchmarks/bgemm_sim.py``.

The design under test (raytpu's, never built): coherence-sorted blocks of
128 rays compute a per-block UNION of candidate treelets (slab test
against the treelet bounds), then test every block ray densely against
every triangle of every union treelet. This ranks treelet budgets by the
quantities that do not depend on hardware, raytpu's, line for line:

  candidates per ray, the block unions' sizes (``block_unions``), the
  padded triangles a treelet (Kpad) and tests a ray
  = mean block-union size x Kpad x block / live rays

over the port's treelets (``accel/treelets.py:build_treelets`` at each
``--budgets`` rows) of the atrium pack's BVH8 rows and the four
captured waves (``tools/waves.py``: raytpu's committed bands, engine-
sorted). The slab tests and unions run as torch ops on ``--device`` in
raytpu's f32 order, so the card does the [rays, treelets] work; the
numbers equal numpy's.

raytpu's cost model turns tests a ray into Mrays/s with a TPU's VPU
lane-ops a cycle and clock, beside its strand kernel's measured rate. On
the card they become the card's own: cycles a ray ~ (tests x EP_OPS + T x
SEL_OPS) / (f32 lanes a cycle = SM count x 128, from
``torch.cuda.get_device_properties``), at the SM clock from
``nvidia-smi`` (``clocks.max.sm``), beside strand_walk's measured rate on
the same wave (``strand_query``, 32 launches queued, ``tools/timing.py``).
Under ``--device cpu`` the tool prints only the hardware-independent
columns: no rate taken on or for any device.

    python -m raytpu_torch.tools.bgemm_sim [--tris 250000]
        [--budgets 64 128 256 512] [--waves b1c b2c b2s b3c]
        [--blocks 128 256]
    python -m raytpu_torch.tools.bgemm_sim --device cpu --tris 5000
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from . import scenes
from .timing import queued_ms
from .waves import engine_sort, full_cache, load_wave

# cost-model operation counts (lane-ops): Woop epilogue per (ray, tri) —
# t = -oz/dz (div ~ 4), u/v maddss (4), range+validity compares (6),
# tkey select + min/argmin passes (2x) — and the dense [R,T] selection
EP_OPS = 16.0
SEL_OPS = 22.0
CHUNK = 65536  # rays a slab-test chunk


def block_unions(cand, block: int):
    """cand [R, T] bool -> per-block union sizes [ceil(R/block)]."""
    r = cand.shape[0]
    pad = (-r) % block
    if pad:
        cand = torch.cat([cand, cand.new_zeros((pad, cand.shape[1]))])
    return cand.reshape(-1, block, cand.shape[1]).any(dim=1).sum(dim=1)


def candidates(ro, rd, tmax, tmin: float, bmin, bmax):
    """[R, T] bool: each ray's slab test against each treelet's box, in
    chunks of CHUNK rays (raytpu's f32 arithmetic, op for op)."""
    inv = 1.0 / torch.where(rd == 0.0, 1e-36, rd)
    tmin_t = torch.tensor(tmin, dtype=torch.float32, device=ro.device)
    rows = []
    for s0 in range(0, ro.shape[0], CHUNK):
        sl = slice(s0, s0 + CHUNK)
        o, iv, tm = ro[sl], inv[sl], tmax[sl]
        lo = torch.where(iv[:, None, :] < 0, bmax[None], bmin[None])
        hi = torch.where(iv[:, None, :] < 0, bmin[None], bmax[None])
        t0 = ((lo - o[:, None, :]) * iv[:, None, :]).amax(-1)
        t1 = ((hi - o[:, None, :]) * iv[:, None, :]).amin(-1)
        near = torch.maximum(t0, tmin_t)
        far = torch.minimum(t1, tm[:, None])
        rows.append(near <= far)
    return torch.cat(rows)


def sizing(node_rows, leaf_tris, budget: int, waves: dict,
           blocks) -> dict:
    """One budget's row: dict(budget, T, k_pad, util, waves: {name:
    dict(cand_mean, cand_p99, unions {block: (mean union size,
    tests a ray)})})."""
    from ..accel.bvh import Bvh8Arrays
    from ..accel.treelets import build_treelets

    bvh8 = Bvh8Arrays(node_rows=node_rows, n_leaf_rows=leaf_tris.shape[0])
    tl = build_treelets(bvh8, leaf_tris, budget_rows=budget)
    T = tl.n_treelets
    k_pad = tl.tleaves.shape[1] * 8
    # real tris: count non-degenerate slots (slot col of padding = 0
    # with zero geometry; use n_leaf_rows for a row-level proxy)
    util = float(np.sum(tl.n_leaf_rows) * 8) / float(T * k_pad) * 100.0
    out = dict(budget=budget, T=T, k_pad=k_pad, util=util, waves={})
    for name, (ro, rd, tmax, tmin) in waves.items():
        dev = ro.device
        bmin = torch.as_tensor(np.asarray(tl.tbox_min), device=dev)  # [T,3]
        bmax = torch.as_tensor(np.asarray(tl.tbox_max), device=dev)
        live = tmax > 0
        cand = candidates(ro, rd, tmax, tmin, bmin, bmax)  # [R, T]
        per_ray = cand.sum(dim=1).cpu().numpy()
        live_np = live.cpu().numpy()
        cmean = per_ray[live_np].mean() if live_np.any() else 0.0
        cp99 = np.percentile(per_ray[live_np], 99) if live_np.any() else 0
        unions = {}
        for b in blocks:
            u = block_unions(cand, b).cpu().numpy()
            nz = u[u > 0]
            tests = float(nz.sum()) * k_pad * b / max(int(live_np.sum()), 1)
            unions[b] = (nz.mean() if nz.size else 0.0, tests)
        out["waves"][name] = dict(cand_mean=cmean, cand_p99=cp99,
                                  unions=unions)
    return out


def card_model() -> dict:
    """The card's side of the cost model: f32 lanes a cycle (SM count x
    128), the SM clock (``nvidia-smi``'s clocks.max.sm) and the card's
    name and power limit."""
    props = torch.cuda.get_device_properties(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz, name, watts = (x.strip() for x in
                        smi.stdout.strip().splitlines()[0].split(","))
    return dict(lanes=props.multi_processor_count * 128,
                sms=props.multi_processor_count, clock=float(mhz) * 1e6,
                name=name, watts=watts)


def strand_rates(pack, waves: dict, inner: int = 32,
                 repeats: int = 3) -> dict:
    """{wave: strand_walk's Mrays/s on it}: the default instance's launch
    timed queued (``tools/timing.py:queued_ms``)."""
    from ..kernels.strand import strand_query

    tables = (pack.bvh.strand_rows, pack.bvh.leaf_tris,
              pack.bvh.first_slots)
    out = {}
    for name, (ro, rd, tmax, tmin) in waves.items():
        ms = queued_ms(lambda: strand_query(
            *tables, ro, rd, tmax, tmin, name.endswith("s")), inner, repeats)
        out[name] = ro.shape[0] / ms / 1e3
    return out


def print_rows(rows: list, blocks, model: dict | None = None,
               rates: dict | None = None) -> None:
    """raytpu's table; the est-Mray/s and strand columns only with a card's
    ``model`` and ``rates``."""
    est = model is not None
    print(f"{'budget':>6} {'T':>5} {'Kpad':>5} {'util%':>5} | wave "
          f"{'cand/ray':>9} {'p99':>4} "
          + " ".join(f"U{b:<4} tests/ray" + ("  est-Mray/s" if est else "")
                     for b in blocks)
          + ("  strand-Mray/s" if est else ""))
    for row in rows:
        for name, w in row["waves"].items():
            cols = []
            for b in blocks:
                u, tests = w["unions"][b]
                col = f"{u:5.1f} {tests:9.0f}"
                if est:
                    cyc = (tests * EP_OPS + row["T"] * SEL_OPS) / model[
                        "lanes"]
                    col += f" {model['clock'] / cyc / 1e6 if cyc else 0:10.1f}"
                cols.append(col)
            print(f"{row['budget']:>6} {row['T']:>5} {row['k_pad']:>5} "
                  f"{row['util']:>5.1f} | {name:<4} {w['cand_mean']:>9.2f} "
                  f"{w['cand_p99']:>4.0f} " + "  ".join(cols)
                  + (f" {rates[name]:14.1f}" if est else ""), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bgemm_sim", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--budgets", type=int, nargs="+",
                    default=[64, 128, 256, 512])
    ap.add_argument("--waves", nargs="+",
                    default=["b1c", "b2c", "b2s", "b3c"])
    ap.add_argument("--blocks", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    # raytpu packs tables="all" for the BVH8 rows; the default tables keep
    # them below the pack budget (the 250k atrium), and that pickle is
    # shared with the other tools
    _, host = scenes.cached_atrium(args.tris, as_numpy=True)
    if host.bvh.node8_rows is None:
        _, host = scenes.cached_atrium(args.tris, tables="all",
                                       as_numpy=True)
    pack = host.to(args.device)
    full = full_cache(args.tris)
    waves = {}
    for name in args.waves:
        w = load_wave(name, full=full)
        waves[name] = (*engine_sort(pack, w["ro"], w["rd"], w["tmax"]),
                       float(w["tmin"]))
    rows = [sizing(host.bvh.node8_rows, host.bvh.leaf_tris, b, waves,
                   args.blocks) for b in args.budgets]
    model = rates = None
    if args.device == "cuda":
        model = card_model()
        rates = strand_rates(pack, waves)
        print(f"cost model on {model['name']} ({model['watts']} W limit): "
              f"(tests x {EP_OPS:.0f} + T x {SEL_OPS:.0f}) lane-ops / "
              f"{model['lanes']} f32 lanes a cycle ({model['sms']} SMs x "
              f"128) at {model['clock'] / 1e6:.0f} MHz (nvidia-smi "
              "clocks.max.sm); strand_walk's measured rate on each wave "
              "(32 launches queued): " + ", ".join(
                  f"{k} {v:.1f} Mrays/s" for k, v in rates.items()),
              flush=True)
    print_rows(rows, args.blocks, model, rates)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
