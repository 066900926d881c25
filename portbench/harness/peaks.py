"""Published peaks of the cards the benchmark runs on, and what a ray
query needs at the least: the bytes it moves and the operations of its
box and triangle tests.

NVIDIA's data sheet for the H100 SXM part: 3.35 TB/s of HBM3 bandwidth
and 67 TFLOP/s of float32 outside the tensor cores, at its 700 W power
limit. A card set below that limit runs slower under load; its limit is
printed beside every share read against these peaks.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_ops_per_s": 67e12},
}

# one ray query: origin, direction, tmin, tmax in (8 floats); the hit
# distance and the triangle out (2 words)
QUERY_BYTES_IN = 32
QUERY_BYTES_OUT = 8
# operations per box test (6 sub, 6 mul, 4 max, 4 min, 1 compare) and per
# Moller-Trumbore triangle test (cross 9, det 5, div 1, tvec 3, u 6,
# cross 9, v 6, t 6, 8 compares and the u + v add)
BOX_OPS = 21
TRI_OPS = 53


def query_bytes(queries: int) -> int:
    """The bytes that ``queries`` ray queries must move at the least: each
    ray read once and each answer written once (the scene's tables are
    not counted: how much of them a walk must read depends on the rays)."""
    return queries * (QUERY_BYTES_IN + QUERY_BYTES_OUT)


def walk_ops(box_tests: int, tri_tests: int) -> int:
    """The float32 operations of a walk's box and triangle tests."""
    return box_tests * BOX_OPS + tri_tests * TRI_OPS


def bytes_bound_s(nbytes: int, card: str):
    """The least seconds ``nbytes`` take at the card's HBM bandwidth, or
    None for a card the table lacks."""
    peak = PEAKS.get(card)
    return None if peak is None else nbytes / peak["hbm_bytes_per_s"]


def ops_bound_s(ops: int, card: str):
    """The least seconds ``ops`` float32 operations take at the card's
    peak outside the tensor cores, or None for a card the table lacks."""
    peak = PEAKS.get(card)
    return None if peak is None else ops / peak["f32_ops_per_s"]
