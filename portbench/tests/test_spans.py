"""The program spans' reading of a canned Chrome trace: every idle
microsecond under the innermost ``raytpu::`` span open on the frame's
thread, split exactly at the spans' edges; the spans leave the frozen
grouping's report as it was; the four readers; and, on the card, a tiny
traced run that reports them."""

import pytest

from portbench.harness import spans, spec, trace

from . import test_trace
from .conftest import last_line

READERS = ("entry.idle_ms", "engine.idle_ms", "kernels.idle_ms",
           "engine.host_syncs")


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _dev(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "some_kernel", "ts": ts,
            "dur": dur, "pid": 0, "tid": 7}


SPANS = [
    _span("raytpu::entry.frame", 100, 900),
    _span("raytpu::entry.alloc", 100, 50),
    _span("raytpu::entry.tile", 150, 650),
    _span("raytpu::engine.paths", 200, 500),
    _span("raytpu::engine.bounce", 250, 350),
    _span("raytpu::engine.sync.alive", 250, 50),
    _span("raytpu::kernels.strand", 320, 20),
    _span("raytpu::entry.sync.readback", 800, 100),
    _span("raytpu::entry.stitch", 900, 80),
    # another thread's span and a span of no program: not read
    _span("raytpu::engine.shade", 100, 950, tid=2),
    _span("portbench.traced_frames", 90, 1000),
]
EVENTS = SPANS + [
    _dev(50, 70),  # starts before the range: not busy there
    _dev(330, 170),
    _dev(850, 30, cat="gpu_memcpy"),
    _dev(990, 20),
    _dev(1060, 5),  # starts after the range
    {"ph": "X", "cat": "gpu_user_annotation", "name": "raytpu::entry.frame",
     "ts": 330, "dur": 680, "pid": 0, "tid": 7},  # no device work
]
LO, HI = 100.0, 1050.0
# idle: 100-330, 500-850, 880-990, 1010-1050 (730 us)
WANT_US = {
    "raytpu::entry.alloc": 50, "raytpu::entry.tile": 50 + 100,
    "raytpu::engine.paths": 50 + 100, "raytpu::engine.sync.alive": 50,
    "raytpu::engine.bounce": 20 + 100, "raytpu::kernels.strand": 10,
    "raytpu::entry.sync.readback": 50 + 20, "raytpu::entry.stitch": 80,
    "raytpu::entry.frame": 10, spans.OUTSIDE: 40,
}


def test_idle_split_by_span_and_layer_is_exact():
    rep = spans.reduce(EVENTS, LO, HI)
    got = {k: round(v * 1e6, 6) for k, v in rep["idle_s"].items()}
    assert got == WANT_US
    layers = {k: round(v * 1e6, 6) for k, v in
              rep["idle_s_by_layer"].items()}
    assert layers == {"entry": 360, "engine": 320, "kernels": 10,
                      spans.OUTSIDE: 40}
    # the whole idle time of the range, as the frozen grouping reads it
    whole = trace.reduce(EVENTS, LO, HI)
    assert sum(rep["idle_s"].values()) == pytest.approx(
        sum(whole["gaps"].values()))
    assert rep["frames"] == 1
    assert rep["count"] == {s["name"]: 1 for s in SPANS[:9]}


def test_frames_and_counts_of_two_frames():
    second = [dict(s, ts=s["ts"] + 1100) for s in SPANS[:9]]
    rep = spans.reduce(EVENTS + second, LO, 2200.0)
    assert rep["frames"] == 2
    assert rep["count"]["raytpu::engine.sync.alive"] == 2
    # no span is open from the first frame's end to the second's start
    # (but for the device's 1060-1065) nor after the second
    assert rep["idle_s"][spans.OUTSIDE] == pytest.approx(
        (50 + 135 + 100) * 1e-6)
    assert rep["idle_s"]["raytpu::entry.stitch"] == pytest.approx(160e-6)


def test_a_child_is_cut_to_its_parent():
    events = [_span("raytpu::entry.frame", 0, 100),
              _span("raytpu::entry.tile", 50, 50.5),  # past its parent
              _dev(200, 10)]
    rep = spans.reduce(events, 0.0, 200.0)
    assert rep["idle_s"]["raytpu::entry.tile"] == pytest.approx(50e-6)
    assert rep["idle_s"][spans.OUTSIDE] == pytest.approx(100e-6)


def test_spans_leave_the_frozen_grouping_as_it_was():
    plain = trace.reduce(test_trace.EVENTS, 100.0, 1000.0)
    marked = trace.reduce(test_trace.EVENTS + SPANS + [
        _span("raytpu::engine.sort", 555, 150),
        _span("raytpu::kernels.strand", 265, 20)], 100.0, 1000.0)
    assert marked == plain


def _ctx(events=None):
    if events is None:
        return {"trace": None}
    return {"trace": {"spans": spans.reduce(events, LO, HI)}}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_frame_span(name):
    read = spec.Spec().reader(name)
    assert read(_ctx()) is None
    no_frame = [e for e in EVENTS if e.get("name") != "raytpu::entry.frame"]
    assert read(_ctx(no_frame)) is None
    assert read(_ctx(test_trace.EVENTS)) is None


@pytest.mark.parametrize("name,want", [
    ("entry.idle_ms", 0.36), ("engine.idle_ms", 0.32),
    ("kernels.idle_ms", 0.01), ("engine.host_syncs", 2)])
def test_readers_read_a_frame(name, want):
    assert spec.Spec().reader(name)(_ctx(EVENTS)) == pytest.approx(want)


def test_the_window_is_found_where_the_harness_holds_it(capsys):
    """Without ``spans`` in the report, ``of_run`` reduces the traced
    window that ``cell.run`` holds while it calls the readers, once."""
    read = spec.Spec().reader("entry.idle_ms")
    code = ("def run(ctx):\n"
            "    events, lo, hi = EVENTS, LO, HI\n"
            "    return read(ctx), read(ctx)\n")
    names = {"__name__": "portbench.harness.cell", "EVENTS": EVENTS,
             "LO": LO, "HI": HI, "read": read}
    exec(compile(code, "cell.py", "exec"), names)
    ctx = {"trace": {}}
    assert names["run"](ctx) == (pytest.approx(0.36), pytest.approx(0.36))
    assert ctx["trace"]["spans"]["frames"] == 1
    err = capsys.readouterr().err
    assert err.count("device idle s by program span") == 1
    assert "raytpu::entry.tile 0.000150" in err
    # anywhere else, nothing is read
    assert read({"trace": {}}) is None


@pytest.mark.cuda
def test_tiny_traced_run_reports_the_span_metrics(card, tiny_root, capsys):
    from portbench.harness import cell

    assert cell.run(["--workload", "atrium5k.path64", "--seed",
                     str(2 ** 31 + 11), "--seconds", "1", "--trace", "1"],
                    root=tiny_root) == 0
    line = last_line(capsys)
    assert line["correct"] is True
    for name in READERS:
        assert line["metrics"][name]["value"] >= 0, name
    assert line["metrics"]["engine.host_syncs"]["value"] >= 1
