"""Steady-state cost of the engine's coherence sorts at headline width:
the port's counterpart of raytpu's ``benchmarks/sort_bench.py``.

raytpu times ``lax.sort`` with 7, 6, 0, 8 and 9 payload operands, the
shapes its engine issues per bounce. The port's engine issues no
multi-operand sort: it sorts a key, then moves each payload column with a
gather. So this tool times the sort shapes ``engine/render.py`` issues,
each with the payload it moves, at ``--rows`` (2,088,960, the 1080p
frame's lanes):

* ``_sorted_query``'s: a stable key sort, then the rays gathered (a
  closest-hit query's bound comes from the sorted key, a shadow query's
  is gathered);
* ``_mixed_bounce_query``'s sort over a bounce's rays and its deferred
  shadow rays (2 x ``--rows`` lanes);
* the fused wave mode's state sort (``_fused_bounces``, on waves of 2^20
  lanes), on the unique int64 key ``key << 32 | pixel``: the state
  permuted in place.

Each row names the engine line it stands for and counts its operands as
raytpu's table does: the key, each payload column, and the permutation.
A timing is a chain of ``--inner`` sorts, each key perturbed by a runtime
zero taken from the previous result's permutation (so no repeat can be
skipped), queued behind a sleep kernel (``tools/timing.py``); the row's ms
is the median of ``--repeats`` chains less the same chain with the sort
taken out (the port's counterpart of raytpu's RPC floor, printed beside
it), over ``--inner``. raytpu's per-bounce line follows, built from the
fused state sort and the shadow sort x 3.5 bounce-equivalents.

``--check`` holds each row's permutation and payload, on the unperturbed
key, to a stable ``torch.argsort`` plus gathers of the same inputs.

    python -m raytpu_torch.tools.sort_bench [--rows 2088960] [--inner 8]
    python -m raytpu_torch.tools.sort_bench --device cpu --rows 4096 --check
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .timing import SHORT_SLEEP_CYCLES, queued_ms

F32_MAX = float(np.finfo(np.float32).max)
# the engine's dead-lane key at RAYTPU_MORTON_BITS 6 (kernels/coherence.py:
# dead_key)
DEAD = 1 << 21


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def inputs(rows: int, device) -> dict:
    """The sorts' inputs, from ``np.random.default_rng(1)``: raytpu's key
    (int32 in [0, 2^21)), the rays (ro, rd [R, 3], a shadow bound [R]),
    the path state (rng [R] i32, radiance and attenuation [R, 4], alive,
    pixel index) and a second key and ray set for the mixed query."""
    rng = np.random.default_rng(1)
    r = rows
    host = dict(
        key=rng.integers(0, 1 << 21, r, dtype=np.int32),
        ro=rng.random((r, 3), dtype=np.float32),
        rd=rng.random((r, 3), dtype=np.float32) - 0.5,
        tm=rng.random(r, dtype=np.float32) * 10,
        rng=rng.integers(-2**31, 2**31 - 1, r, dtype=np.int32),
        rad=rng.random((r, 4), dtype=np.float32),
        att=rng.random((r, 4), dtype=np.float32),
        alive=rng.random(r) < 0.6,
        pxi=np.arange(r, dtype=np.int32),
        key2=rng.integers(0, 1 << 21, r, dtype=np.int32),
        s_ro=rng.random((r, 3), dtype=np.float32),
        s_rd=rng.random((r, 3), dtype=np.float32) - 0.5,
        s_tm=rng.random(r, dtype=np.float32) * 10,
    )
    x = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    # the mixed query's lanes: a bounce's rays, then its shadow rays
    x["m_key"] = torch.cat([x["key"], x["key2"]])
    x["m_ro"] = torch.cat([x["ro"], x["s_ro"]])
    x["m_rd"] = torch.cat([x["rd"], x["s_rd"]])
    x["m_tm"] = torch.cat([torch.where(x["alive"], F32_MAX, -np.inf),
                           x["s_tm"]])
    x["smask"] = torch.cat([torch.zeros(r, device=device),
                            torch.ones(r, device=device)])
    x["key64"] = (x["key"].long() << 32) | x["pxi"].long()
    return x


@dataclass
class Row:
    """One sort shape: ``body(key)`` sorts ``key`` and moves the payload
    as the engine line does, returning (the permutation, the moved
    columns); ``payload`` names the inputs it moves, in that order;
    ``key`` the input key it sorts."""

    name: str
    key: str
    payload: tuple
    body: Callable
    # what the body returns after the moved columns: "bound" (a closest-hit
    # query's bound, from the sorted key)
    extra: str = ""
    reset: Callable | None = None  # restores what the body moves in place

    def operands(self, x: dict) -> int:
        return 2 + sum(x[k].shape[1] if x[k].dim() == 2 else 1
                       for k in self.payload)


def rows(x: dict) -> list:
    """The engine's sort shapes over the inputs ``x``."""
    r = x["key"].shape[0]

    def payload_closest(k):  # _sorted_query, returns_hit
        key_s, perm = torch.sort(k, stable=True)
        tm_s = torch.where(key_s == DEAD, -np.inf, F32_MAX)
        return perm, [x["ro"][perm], x["rd"][perm], tm_s]

    def payload_shadow(k):  # _sorted_query, any-hit
        _, perm = torch.sort(k, stable=True)
        return perm, [x["ro"][perm], x["rd"][perm], x["tm"][perm]]

    def mixed(k):  # _mixed_bounce_query
        perm = torch.sort(k, stable=True)[1]
        return perm, [x["m_ro"][perm], x["m_rd"][perm], x["m_tm"][perm],
                      x["smask"][perm]]

    state = ("ro", "rd", "rng", "rad", "att", "alive", "pxi")

    # the fused mode's state (radiance and attenuation as 3 columns),
    # permuted in place as the engine does
    x.update({f"f_{c}": (x[c][:, :3] if c in ("rad", "att") else x[c])
              .contiguous() for c in state})
    fused_state = {c: x[f"f_{c}"].clone() for c in state}

    def fused(k):  # _fused_bounces
        perm = torch.sort(k)[1]
        for v in fused_state.values():
            v[:r] = v[:r][perm]
        return perm, list(fused_state.values())

    def fused_reset():
        for c, v in fused_state.items():
            v.copy_(x[f"f_{c}"])

    fused_payload = tuple(f"f_{c}" for c in state)
    return [
        Row("sorted query, closest-hit", "key", ("ro", "rd"),
            payload_closest, extra="bound"),
        Row("sorted query, shadow", "key", ("ro", "rd", "tm"),
            payload_shadow),
        Row("mixed query, 2 x rows lanes", "m_key",
            ("m_ro", "m_rd", "m_tm", "smask"), mixed),
        Row("fused state, int64 key", "key64", fused_payload, fused,
            reset=fused_reset),
    ]


def check(row: Row, x: dict) -> str:
    """'' when the row's permutation and every moved column equal a stable
    argsort of the same key plus gathers of the same inputs, else what
    differs."""
    k = x[row.key]
    if row.reset is not None:
        row.reset()
    perm, outs = row.body(k)
    want = torch.argsort(k, stable=True)
    if not torch.equal(perm, want):
        return "permutation"
    for name, got in zip(row.payload, outs):
        if not torch.equal(got, x[name][want]):
            return name
    if row.extra == "bound" and not torch.equal(
            outs[-1], torch.where(k[want] == DEAD, -np.inf, F32_MAX)):
        return "bound"
    return ""


def time_row(row: Row, x: dict, inner: int, repeats: int,
             cuda: bool) -> tuple:
    """(ms per sort less the empty chain's, the empty chain's ms) of a
    chain of ``inner`` sorts, the median of ``repeats``."""
    base = x[row.key]

    def chain():
        k = base
        for i in range(inner):
            perm, _ = row.body(k)
            # runtime zero: the permutation's entries are >= 0, which no
            # compiler is told
            k = (base + (i + 1)) + perm[0].clamp(max=0).to(base.dtype)

    def empty():
        k = base
        for i in range(inner):
            k = (base + (i + 1)) + k[0].clamp(max=0)

    total = queued_ms(chain, 1, repeats, cuda, SHORT_SLEEP_CYCLES)
    floor = queued_ms(empty, 1, repeats, cuda, SHORT_SLEEP_CYCLES)
    return max(total - floor, 0.0) / inner, floor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sort_bench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows", type=int, default=2_088_960)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="hold every row to a stable argsort plus gathers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cuda = args.device == "cuda"
    x = inputs(args.rows, args.device)
    table = rows(x)
    _log(f"[sort] rows {args.rows}, device {args.device}"
         + (f" ({torch.cuda.get_device_name(0)})" if cuda else ""))
    bad = []
    if args.check:
        for row in table:
            what = check(row, x)
            print(f"check {row.name}: "
                  + ("equal to a stable argsort plus gathers" if not what
                     else f"{what} differs"), flush=True)
            if what:
                bad.append(row.name)
    print("| sort | operands | ms |")
    print("|---|---|---|")
    ms = {}
    for row in table:
        dt, floor = time_row(row, x, args.inner, args.repeats, cuda)
        ms[row.name] = dt
        _log(f"[sort] {row.name}: empty-chain floor {floor:.3f} ms for "
             f"{args.inner}")
        print(f"| {row.name} | {row.operands(x)} ops | {dt:7.3f} ms |",
              flush=True)
    per_bounce = (ms["fused state, int64 key"]
                  + ms["sorted query, shadow"])
    print(f"[sort] per-bounce total (fused state sort + shadow sort) "
          f"{per_bounce:.3f} ms, x3.5 bounce-equivalents ~= "
          f"{per_bounce * 3.5:.2f} ms/frame", flush=True)
    if bad:
        raise SystemExit(f"sort_bench: {', '.join(bad)} differ from a "
                         "stable argsort plus gathers")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
