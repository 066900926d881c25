"""The window's arithmetic: the end-to-end numbers of a closed loop.

One client renders frames back to back. The window opens when the first
timed frame starts and closes when the frame that first reaches
``--seconds`` has its image on the host, so every frame in it is whole.
"""

from __future__ import annotations

import math


def frame_ms(window_s: float, frames: int) -> float:
    """The window's time over the frames completed in it: what a user pays
    a frame, stalls included (not a median of frames)."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return window_s * 1e3 / frames


def p95_ms(frame_s: list) -> float:
    """The 95th percentile of every frame time of the window, by nearest
    rank: the frame below which 95% of the window's frames lie."""
    if not frame_s:
        raise ValueError("no frame completed in the window")
    ranked = sorted(frame_s)
    return ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)] * 1e3
