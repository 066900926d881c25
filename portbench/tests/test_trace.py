"""The frozen grouping on a canned Chrome trace: every device event in one
group, the groups summing to the total, busy time as the union of the
intervals, and idle gaps named by the host op running through them."""

import pytest

from portbench.harness import trace


def _op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def _dev(name, ts, dur, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _op("aten::index", 100, 90), _launch(150, 1),
    _dev("void at::native::index_elementwise_kernel<128, 4>(int)", 300,
         50, 1),
    _op("aten::mul", 210, 40), _launch(220, 2),
    _dev("void at::native::vectorized_elementwise_kernel<4>(int)", 360,
         20, 2),
    _launch(270, 3),
    _dev("void strand::walk_kernel<128, false>(strand::Args)", 400, 100, 3),
    _dev("Memcpy DtoH (Device -> Pageable)", 520, 30, cat="gpu_memcpy"),
    _op("aten::sort", 560, 140), _launch(610, 5),
    _dev("void cub::DeviceRadixSortOnesweepKernel<int>(int)", 650, 10, 5),
    _dev("void at::native::reduce_kernel<512, 1>(int)", 705, 5),
    _dev("void packet_kernel<false>(Args)", 1200, 50),  # outside the range
]


def test_groups_sum_to_total_and_busy_is_the_union():
    rep = trace.reduce(EVENTS, 100.0, 1000.0)
    got = {g: round(s * 1e6, 6) for g, (s, n) in rep["groups"].items() if n}
    assert got == {"gather": 50, "elementwise": 20, "strand kernel": 100,
                   "memcpy": 30, "sort": 10, "other": 5}
    assert rep["total_s"] == pytest.approx(
        sum(s for s, _ in rep["groups"].values()))
    assert rep["total_s"] == pytest.approx(215e-6)
    assert rep["busy_s"] == pytest.approx(215e-6)
    assert rep["n_events"] == 6
    assert "aten::index (gather)" in rep["ops"]
    assert "strand::walk_kernel (strand kernel)" in rep["ops"]


def test_overlapping_events_count_once_in_busy():
    events = [_dev("a_kernel", 0, 100), _dev("b_kernel", 50, 100)]
    rep = trace.reduce(events, 0.0, 400.0)
    assert rep["total_s"] == pytest.approx(200e-6)
    assert rep["busy_s"] == pytest.approx(150e-6)


def test_idle_gaps_are_named_by_the_host_op_and_fill_the_rest():
    rep = trace.reduce(EVENTS, 100.0, 1000.0)
    assert sum(rep["gaps"].values()) == pytest.approx(
        (1000 - 100) * 1e-6 - rep["busy_s"])
    # the gaps 550..650 and 660..705 have aten::sort open at their middles
    assert rep["gaps"]["aten::sort"] == pytest.approx(145e-6)
    assert rep["gaps"][trace.HOST_IDLE] > 0
    assert trace.top(rep["gaps"], 2)[0][1] == max(rep["gaps"].values())


@pytest.mark.parametrize("name,kind,stack,group", [
    ("void strand::walk_kernel<128>(x)", "kernel", [], "strand kernel"),
    ("_ZN6strand11walk_kernelILi128EEEvNS_4ArgsE", "kernel", [],
     "strand kernel"),
    ("void strand::block_kernel<1>(x)", "kernel", [], "strand kernel"),
    ("packet_option_kernel<true>", "kernel", [], "packet kernel"),
    ("binned_kernel", "kernel", [], "binned kernel"),
    ("Memset (Device)", "memset", [], "memcpy"),
    ("elementwise_kernel", "kernel", ["aten::copy_"], "memcpy"),
    ("elementwise_kernel", "kernel", ["aten::index_put_"], "scatter"),
    ("some_kernel", "kernel", [], "other"),
])
def test_classify(name, kind, stack, group):
    assert trace.classify(name, kind, stack) == group


def test_no_device_event_raises():
    with pytest.raises(ValueError):
        trace.reduce([_op("aten::mul", 0, 10)], 0.0, 100.0)


class _Raw:
    """A profiler's raw event, as ``_KinetoEvent`` answers."""

    def __init__(self, cuda, kind, start, dur):
        from torch.autograd import DeviceType

        self._d = DeviceType.CUDA if cuda else DeviceType.CPU
        self._k, self._a, self._n = kind, start, dur

    def device_type(self):
        return self._d

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._n


def test_busy_from_raw_events_is_the_union_of_device_intervals():
    raw = [_Raw(False, "cpu_op", 0, 10_000),
           _Raw(False, "cuda_runtime", 100, 5),
           _Raw(True, "kernel", 1_000, 500),
           _Raw(True, "kernel", 1_200, 500),  # overlaps the one before
           _Raw(True, "gpu_memcpy", 3_000, 1_000),
           _Raw(True, "gpu_memset", 5_000, 10),
           _Raw(True, "gpu_user_annotation", 0, 9_000)]
    spans = trace.device_spans_ns(raw)
    assert spans == [(1_000, 1_500), (1_200, 1_700), (3_000, 4_000),
                     (5_000, 5_010)]
    assert trace.busy_s_of(spans) == pytest.approx(1_710e-9)
    assert trace.busy_s_of([]) == 0.0
