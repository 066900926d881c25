"""engine.glue_ms: device ms a traced frame outside the walk kernels:
the engine's elementwise shading, gathers, scatters, sorts, copies and
the rest (harness/trace.py's groups). Layer: engine. Moves frame_ms
(engine.glue_ms.busy reads the same where a cell reports busy_ms)."""

from portbench.harness.trace import glue_ms


def read(ctx):
    rep = ctx["trace"]
    return None if rep is None else glue_ms(rep, ctx["frames_traced"])
