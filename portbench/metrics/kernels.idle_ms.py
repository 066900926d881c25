"""kernels.idle_ms: device idle ms a traced frame under the program's
``raytpu::kernels.*`` spans (innermost open span; harness/spans.py): the
walk wrappers' host side, from entry to the launch's return. Layer:
kernels. Moves frame_ms. None where the trace holds no
``raytpu::entry.frame`` span."""

from portbench.harness.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "kernels")
