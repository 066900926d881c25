"""The comparison that decides ``correct``.

The program's pixels, recorded as its window produced them, against the
plain reference's (``reference/tracer.py``) for the same frames, seeds and
places. A pixel agrees when each of its four channels lies within
``ATOL + RTOL * |reference|`` of the reference (NaN agreeing with NaN
only). The reference reproduces a float32 program's every rounding, so a
sound run agrees on all but the rare pixels where two triangles tie and
the path goes another way; ``diverged_pct``, the share of checked pixels
that do not agree, is held to the cell's limit
(``limits/<workload>.json``, set between the readings of sound runs and
of the lower-precision control, see PERF.md).
"""

from __future__ import annotations

import numpy as np

from . import sample

RTOL = 1e-5
ATOL = 1e-6


def diverged_pct(got: np.ndarray, ref: np.ndarray) -> float:
    """% of pixels ([N, 4] each) on which the program leaves the
    reference."""
    if got.shape != ref.shape or got.shape[0] == 0:
        raise ValueError(f"cannot compare {got.shape} with {ref.shape}")
    both_nan = np.isnan(got) & np.isnan(ref)
    with np.errstate(invalid="ignore"):
        close = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    agree = (close | both_nan | (got == ref)).all(axis=1)
    return float(100.0 * (1.0 - agree.mean()))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    out, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and (
            value <= limit)
    return ok, out


def reference(arrays: dict, dev, seed: int, frames, traffic: dict,
              dtype=None) -> np.ndarray:
    """The reference's pixels [N, 4] for the sampled pixels of ``frames``
    of a run with ``seed`` (``sample.lanes``' order), in float32 or in
    ``dtype`` (the control)."""
    import torch

    from ..reference.tracer import render_lanes
    from ..reference.world import World

    px, py, seeds = sample.lanes(seed, frames, traffic["width"],
                                 traffic["height"], traffic["check_pixels"])
    world = World(arrays, dev, dtype or torch.float32)
    return render_lanes(world, px, py, seeds, width=traffic["width"],
                        height=traffic["height"], chunk=traffic["chunk"],
                        samples=traffic["samples"],
                        bounces=traffic["bounces"], mode=traffic["mode"])
