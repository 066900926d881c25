"""kernels.walk_roofline: % of the walk kernels' device time that the
traced frames' ray queries need at the least. Layer: kernels. Moves
frame_ms.

The least time is the larger of two bounds (harness/peaks.py):

* bytes: 40 bytes a query (ray in, answer out) at the card's HBM
  bandwidth; the scene's tables are not counted;
* operations: the box and triangle tests of the same queries walked
  through the reference's own BVH (binary, median splits, leaves of at
  most 8 triangles: reference/bvh.py), 21 and 53 float32 operations a
  test, at the card's float32 peak outside the tensor cores.

The run's standard error names the bound that binds. The counts are the
benchmark's own, never the program's counters: the reference traces the
traced frames whole with their seeds (one primary query per pixel and
sample of the dispatched grid, two per bounce a path survives; a flat
frame its primaries only: reference/tracer.py:count_queries)."""

from portbench.harness.peaks import (bytes_bound_s, ops_bound_s, query_bytes,
                                     walk_ops)
from portbench.harness.trace import WALK_GROUPS


def bounds(ctx):
    """(bytes bound s, operations bound s) of the traced frames, each None
    where it cannot be read."""
    card = ctx["card"]["name"]
    queries, box, tri = ctx["counts"]()
    b = o = None
    if queries:
        b = bytes_bound_s(query_bytes(queries), card)
    if box:
        o = ops_bound_s(walk_ops(box, tri), card)
    return b, o


def read(ctx):
    rep = ctx["trace"]
    if rep is None:
        return None
    walk_s = sum(rep["groups"][g][0] for g in WALK_GROUPS)
    b, o = bounds(ctx)
    if b is None or o is None or walk_s <= 0:
        return None
    return 100.0 * max(b, o) / walk_s
