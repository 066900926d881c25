"""Is the card's random row gather bound by bytes or by row rate? The
port's counterpart of raytpu's ``benchmarks/gather_bench.py``.

The shading path gathers ``pack.tri_row[tri]`` once per bounce
(``engine/render.py:_shade_inputs``): [R, 64] f32 rows from a [T, 64]
table. Whether slimming the row (fewer columns) can win depends on the
gather's scaling law. The gather here is the port's own, ``table[idx]``,
at ``--rows`` (2,088,960, the 1080p frame's lanes) from a ``--table`` of
398,336 rows (the atrium's slots; at 64 columns 102 MB, over the card's
50 MB L2, as in the real frame), for each of ``--cols``. Indices come
from ``np.random.default_rng(1)`` as raytpu's (sorted with ``--sorted``),
then each table from the same generator.

A timing is a chain of ``--inner`` gathers, each index set perturbed by a
runtime zero taken from the previous gather's output (its values are in
[0, 1), which no compiler is told), queued behind a sleep kernel
(``tools/timing.py``); ms is the median of ``--repeats`` chains less the
same chain with the gather taken out (the port's counterpart of raytpu's
RPC floor, printed), over ``--inner``. GB/s counts the gathered rows'
bytes once. ``--check`` holds one gather of each table to numpy's gather
of the same indices.

    python -m raytpu_torch.tools.gather_bench [--rows 2088960]
        [--table 398336] [--cols 8 16 32 56 64 128]
    python -m raytpu_torch.tools.gather_bench --device cpu --rows 4096 --check
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .timing import SHORT_SLEEP_CYCLES, queued_ms


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def chain_ms(table, idx, inner: int, repeats: int, cuda: bool) -> tuple:
    """(ms per gather less the empty chain's, the empty chain's ms)."""
    def chain():
        i = idx
        for _ in range(inner):
            out = table[i]
            # runtime-zero dependency (out >= 0, unprovable)
            i = idx + torch.clamp(out[0, 0].to(torch.int32), max=0)

    def empty():
        i = idx
        for _ in range(inner):
            i = idx + torch.clamp(i[0], max=0)

    total = queued_ms(chain, 1, repeats, cuda, SHORT_SLEEP_CYCLES)
    floor = queued_ms(empty, 1, repeats, cuda, SHORT_SLEEP_CYCLES)
    return max(total - floor, 0.0) / inner, floor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gather_bench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows", type=int, default=2_088_960)
    ap.add_argument("--table", type=int, default=398_336)
    ap.add_argument("--cols", type=int, nargs="*",
                    default=[8, 16, 32, 56, 64, 128])
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sorted", action="store_true",
                    help="use a sorted (clustered) index set instead of "
                         "uniform random")
    ap.add_argument("--check", action="store_true",
                    help="hold one gather of each table to numpy's")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cuda = args.device == "cuda"

    rng = np.random.default_rng(1)
    idx_np = rng.integers(0, args.table, args.rows).astype(np.int32)
    if args.sorted:
        idx_np = np.sort(idx_np)
    idx = torch.as_tensor(idx_np, device=args.device)
    _log(f"[gather] rows {args.rows}, table {args.table}, "
         f"sorted={args.sorted}, device {args.device}"
         + (f" ({torch.cuda.get_device_name(0)})" if cuda else ""))
    print("| cols | ms | Mrows/s | GB/s |")
    print("|---|---|---|---|")
    bad = []
    for c in args.cols:
        table_np = rng.random((args.table, c), dtype=np.float32)
        table = torch.as_tensor(table_np, device=args.device)
        if args.check and not np.array_equal(table[idx].cpu().numpy(),
                                             table_np[idx_np]):
            bad.append(c)
        dt, floor = chain_ms(table, idx, args.inner, args.repeats, cuda)
        _log(f"[gather] {c} cols: empty-chain floor {floor:.3f} ms for "
             f"{args.inner}")
        gb = args.rows * c * 4 / (dt / 1e3) / 1e9 if dt else float("inf")
        mrows = args.rows / (dt / 1e3) / 1e6 if dt else float("inf")
        print(f"| {c} | {dt:7.3f} | {mrows:7.1f} | {gb:6.1f} |", flush=True)
    if args.check:
        print("check: every table's gather "
              + (f"differs from numpy's at cols {bad}" if bad
                 else "equals numpy's on the same indices"), flush=True)
    if bad:
        raise SystemExit(f"gather_bench: the gather differs from numpy's at "
                         f"cols {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
