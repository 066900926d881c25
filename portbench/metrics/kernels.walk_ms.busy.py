"""kernels.walk_ms.busy: kernels.walk_ms, in the cells that report
busy_ms: device ms a traced frame in the walk kernels. Layer: kernels.
Moves busy_ms. Nothing to read in a frame that launches no walk
kernel."""

from portbench.harness.trace import walk_ms


def read(ctx):
    rep = ctx["trace"]
    return None if rep is None else walk_ms(rep, ctx["frames_traced"])
