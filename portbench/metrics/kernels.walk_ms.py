"""kernels.walk_ms: device ms a traced frame in the hand-written walk
kernels (strand, packet and binned groups). Layer: kernels. Moves
frame_ms (kernels.walk_ms.busy reads the same where a cell reports
busy_ms). Nothing to read in a frame that launches no walk kernel."""

from portbench.harness.trace import walk_ms


def read(ctx):
    rep = ctx["trace"]
    return None if rep is None else walk_ms(rep, ctx["frames_traced"])
