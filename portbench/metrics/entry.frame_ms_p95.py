"""entry.frame_ms_p95: the 95th percentile of every frame time of a traced
run's window, by nearest rank (harness/window.py), the first frames under
the profiler among them. Layer: entry (``render_frame``). Moves frame_ms.

The tail that a progressive preview feels, in the cells that report
frame_ms. It is no end-to-end metric:
from run to run on a shared host it spreads as widely as the bound it
would need (PERF.md)."""

from portbench.harness.window import p95_ms


def read(ctx):
    return p95_ms(ctx["frame_s"]) if ctx["frame_s"] else None
