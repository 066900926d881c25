"""engine.host_syncs: the program's spans with ``.sync`` in their name
a traced frame, of every layer: each one a point where the host waits
for the card (harness/spans.py). Layer: engine. Moves frame_ms. None
where the trace holds no ``raytpu::entry.frame`` span."""

from portbench.harness.spans import of_run


def read(ctx):
    rep = of_run(ctx)
    if not rep or not rep["frames"]:
        return None
    syncs = sum(n for name, n in rep["count"].items() if ".sync" in name)
    return syncs / rep["frames"]
