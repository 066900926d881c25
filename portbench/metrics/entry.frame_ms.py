"""entry.frame_ms: the mean frame time of a traced run's window, each
frame from its call to ``render_frame`` to its image on the host, the
first frames under the profiler among them. Layer: entry
(``render_frame``). Moves busy_ms.

frame_ms under another name, in the cells whose frames the host paces
so unsteadily from run to run that no bound the benchmark may set would
hold it (PERF.md); there busy_ms is the end-to-end metric."""

from portbench.harness.window import frame_ms


def read(ctx):
    return frame_ms(sum(ctx["frame_s"]), len(ctx["frame_s"])) if (
        ctx["frame_s"]) else None
