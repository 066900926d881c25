"""Device times of short launches, queued behind a sleep kernel.

CUDA events around one launch of a sub-millisecond kernel measure the
host's time to queue it, not the card's. Queued behind ``torch.cuda._sleep``
the launches run back to back once the sleep ends, so CUDA events between
them time the launches alone. Used by ``tools/waves.py``,
``tools/strand_ab.py`` and ``chip_smoke.py:device_times``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz


def queued_events(calls: list) -> list:
    """Device ms of each call in ``calls``, in order, all queued behind a
    sleep kernel with a CUDA event after each; raises RuntimeError if the
    host took longer to queue them than the card slept."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(calls) + 2)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for call, e in zip(calls, ev[2:]):
        call()
        e.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"queueing {len(calls)} launches took "
                           f"{host_ms:.1f} ms, longer than the card slept: "
                           "the launch times would include the host")
    return [a.elapsed_time(b) for a, b in zip(ev[1:], ev[2:])]


def queued_ms(fn, inner: int = 32, repeats: int = 5,
              cuda: bool = True) -> float:
    """ms per call of ``fn`` (after one warm-up call): the median over
    ``repeats`` of ``inner`` calls timed by ``queued_events``. Without
    ``cuda`` (the plain versions on the CPU), host ms around the calls."""
    fn()
    times = []
    for _ in range(repeats):
        if cuda:
            times.append(sum(queued_events([fn] * inner)) / inner)
            continue
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(times))
