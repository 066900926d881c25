"""The bytes and operations bounds of ray queries and the roofline reader
built on them."""

import pytest

from portbench.harness import peaks, spec

H100 = "NVIDIA H100 80GB HBM3"


def test_query_bytes():
    # origin, direction, tmin, tmax in; t and triangle out
    assert peaks.query_bytes(1) == 40
    assert peaks.query_bytes(2_073_600) == 82_944_000


def test_bytes_bound_on_the_h100():
    assert peaks.bytes_bound_s(3_350_000_000_000, H100) == pytest.approx(1.0)
    # the 1080p flat frame's primaries: 0.025 ms
    assert peaks.bytes_bound_s(peaks.query_bytes(2_073_600), H100) * 1e3 \
        == pytest.approx(0.02476, rel=1e-3)
    assert peaks.bytes_bound_s(1000, "some other card") is None


def test_ops_bound_on_the_h100():
    assert peaks.walk_ops(1, 0) == 21 and peaks.walk_ops(0, 1) == 53
    assert peaks.ops_bound_s(67_000_000_000_000, H100) == pytest.approx(1.0)
    assert peaks.ops_bound_s(1000, "some other card") is None


def _ctx(walk_s, queries, card=H100, frames=3, box=0, tri=0):
    groups = {g: [0.0, 0] for g in ("strand kernel", "packet kernel",
                                    "binned kernel", "other")}
    groups["packet kernel"] = [walk_s, frames]
    return {"trace": {"groups": groups}, "frames_traced": frames,
            "card": {"name": card},
            "counts": lambda: (queries, box, tri)}


@pytest.mark.parametrize("box,tri,binds", [
    (10, 2, "bytes"), (60, 20, "operations")])
def test_roofline_reader(box, tri, binds):
    read = spec.Spec().reader("kernels.walk_roofline")
    # 3 flat frames of 2,073,600 queries each at 0.5 ms a frame's walk,
    # with ``box`` and ``tri`` tests a query
    q = 3 * 2_073_600
    got = read(_ctx(1.5e-3, q, box=box * q, tri=tri * q))
    by_bytes = q * 40 / 3.35e12
    by_ops = q * (21 * box + 53 * tri) / 67e12
    assert (by_bytes > by_ops) == (binds == "bytes")
    assert got == pytest.approx(100 * max(by_bytes, by_ops) / 1.5e-3)
    assert 0 < got < 100
    assert read(_ctx(1.5e-3, None, box=box * q, tri=tri * q)) is None
    assert read(_ctx(1.5e-3, q)) is None  # no tests counted
    assert read(_ctx(1.5e-3, 100, card="another card", box=9)) is None
    assert read(_ctx(0.0, 100, box=9)) is None
