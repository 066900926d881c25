"""engine.launches: the device events (kernels, copies, sets) a traced
frame, every group of harness/trace.py summed: what a frame of many
small waves pays per launch, and what a fused or graph-captured wave
moves first. Layer: engine. Moves busy_ms. None without a device
trace."""


def read(ctx):
    rep = ctx["trace"]
    if rep is None:
        return None
    return sum(n for _, n in rep["groups"].values()) / ctx["frames_traced"]
