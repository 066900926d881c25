"""engine.idle_ms: device idle ms a traced frame under the program's
``raytpu::engine.*`` spans (innermost open span; harness/spans.py): the
wave loop's Python, the sort and shading dispatch and the waits after
its host syncs. Layer: engine. Moves frame_ms. None where the trace
holds no ``raytpu::entry.frame`` span."""

from portbench.harness.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "engine")
