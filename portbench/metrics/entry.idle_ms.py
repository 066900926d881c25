"""entry.idle_ms: device idle ms a traced frame under the program's
``raytpu::entry.*`` spans (innermost open span; harness/spans.py): the
frame's host buffers, the readback copy, the stitch and ``render_tile``'s
set-up. Layer: entry. Moves frame_ms. None where the trace holds no
``raytpu::entry.frame`` span."""

from portbench.harness.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "entry")
