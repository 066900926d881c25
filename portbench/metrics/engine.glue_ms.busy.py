"""engine.glue_ms.busy: engine.glue_ms, in the cells that report busy_ms:
device ms a traced frame outside the walk kernels. Layer: engine. Moves
busy_ms."""

from portbench.harness.trace import glue_ms


def read(ctx):
    rep = ctx["trace"]
    return None if rep is None else glue_ms(rep, ctx["frames_traced"])
