"""Seeds and samples drawn from a run's ``--seed``.

Every frame of a run gets its own render seed, so no frame can be served
from an earlier one; every frame records a fixed number of pixels, at
places drawn from the seed and the frame's index before it is rendered;
and once the window has closed, the frames whose pixels are checked are
drawn from the seed among those completed. The same seed gives the same
seeds and places, whatever the frame times.
"""

from __future__ import annotations

import numpy as np

_WARMUP = 1 << 40  # frame indices of the warm-up stream start here


def _stream(seed: int, *key) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *key]))


def frame_seed(seed: int, index: int) -> int:
    """The render seed of the window's frame ``index``: an odd u32 (an
    even one's factors of two would shorten the pixels' RNG cycles, and 0
    would stop them)."""
    return int(_stream(seed, index).integers(0, 1 << 32)) | 1


def warmup_seed(seed: int, index: int) -> int:
    """The render seed of warm-up frame ``index``: not a window frame's."""
    return frame_seed(seed, _WARMUP + index)


def pixels(seed: int, index: int, width: int, height: int, count: int):
    """(xs, ys) of the ``count`` distinct pixels frame ``index`` records."""
    flat = _stream(seed, index, 1).choice(width * height, size=count,
                                          replace=False)
    return flat % width, flat // width


def checked_frames(seed: int, completed: int, count: int) -> np.ndarray:
    """The indices, ascending, of the frames the check judges: all of the
    window's when it completed ``count`` or fewer."""
    if completed <= count:
        return np.arange(completed)
    return np.sort(_stream(seed, 2).choice(completed, size=count,
                                           replace=False))


def lanes(seed: int, frames, width: int, height: int, count: int):
    """(px, py, seeds) of every pixel that ``frames`` record: the lanes
    the reference renders for them."""
    per = [pixels(seed, int(i), width, height, count) for i in frames]
    px = np.concatenate([x for x, _ in per]) if per else np.zeros(0, int)
    py = np.concatenate([y for _, y in per]) if per else np.zeros(0, int)
    seeds = np.repeat(np.asarray([frame_seed(seed, int(i)) for i in frames],
                                 np.uint64), count)
    return px, py, seeds
