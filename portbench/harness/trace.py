"""Device time by layer from a torch.profiler Chrome trace.

The grouping is a frozen copy of ``raytpu_torch/tools/frame_profile.py``
(``classify``, ``_launching_ops``, the groups and their patterns), so that
a later change to the program's tool cannot move the yardstick. Each
device event (kernel, memcpy, memset) falls in exactly one group, by the
kernel's name and the ``aten::`` ops open on the launching thread when the
runtime call was made (found through the call's correlation id):

* walk kernels: ``strand kernel`` (``strand::walk_kernel``,
  ``sched_kernel``, ``block_kernel``, ``defer_kernel``), ``packet
  kernel`` (``packet_kernel``, ``packet_option_kernel``), ``binned
  kernel`` (``binned_kernel``);
* engine glue: ``sort``, ``gather``, ``scatter``, ``memcpy``,
  ``elementwise`` and ``other``.

``reduce`` adds what the benchmark needs beside the groups: the union of
the device intervals (busy time), and the idle gaps between them, each
named by the outermost host op running at its middle.

``BusyClock`` reads the card's busy time over every frame of a window
from the profiler's raw device records alone (no CPU ops, no Chrome
trace), a piece of the window at a time.
"""

from __future__ import annotations

import bisect
import re
import time

GROUPS = ("strand kernel", "packet kernel", "binned kernel", "sort",
          "gather", "scatter", "memcpy", "elementwise", "other")
WALK_GROUPS = ("strand kernel", "packet kernel", "binned kernel")
KERNEL_GROUPS = (
    (re.compile(r"strand::(walk|sched|block|defer)_kernel"
                r"|6strand\d+(walk|sched|block|defer)_kernel"),
     "strand kernel"),
    (re.compile(r"packet(_option)?_kernel"), "packet kernel"),
    (re.compile(r"binned_kernel"), "binned kernel"),
)
OP_GROUPS = {
    "aten::sort": "sort", "aten::argsort": "sort",
    "aten::index": "gather", "aten::index_select": "gather",
    "aten::gather": "gather", "aten::take": "gather",
    "aten::index_put_": "scatter", "aten::_index_put_impl_": "scatter",
    "aten::index_put": "scatter", "aten::scatter_": "scatter",
    "aten::scatter": "scatter", "aten::scatter_add_": "scatter",
    "aten::copy_": "memcpy",
}
SORT_KERNEL = re.compile(r"radix|RadixSort|SegmentedSort|sortKeyValue|"
                         r"bitonicSort", re.IGNORECASE)
# Chrome-trace categories, lower-cased (torch 2.x names, then older ones)
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset", "memcpy": "memcpy",
               "memset": "memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime"}
OP_CATS = {"cpu_op", "operator"}
HOST_IDLE = "host python (no aten op)"


def _launching_ops(events: list) -> dict:
    """{correlation id: [names of the CPU ops open on the launching thread
    at the runtime call, outermost first]}."""
    ops, calls = {}, {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        if cat in OP_CATS:
            ops.setdefault(key, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("name", "")))
        elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
            calls.setdefault(key, []).append(
                (float(e["ts"]), e["args"]["correlation"]))
    out = {}
    for key, launches in calls.items():
        spans = sorted(ops.get(key, []), key=lambda s: (s[0], -s[1]))
        stack, i = [], 0
        for ts, corr in sorted(launches):
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = [name for _, _, name in stack]
    return out


def classify(name: str, kind: str, stack: list) -> str:
    """The group of one device event: ``name`` the kernel's (or memcpy's)
    name, ``kind`` kernel / memcpy / memset, ``stack`` the launching CPU
    ops, outermost first."""
    for pattern, group in KERNEL_GROUPS:
        if pattern.search(name):
            return group
    if kind in ("memcpy", "memset"):
        return "memcpy"
    for op in stack:
        if op in OP_GROUPS:
            return OP_GROUPS[op]
    if SORT_KERNEL.search(name):
        return "sort"
    if "elementwise" in name.lower():
        return "elementwise"
    return "other"


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces that have no
    name, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return (base.split(" ")[-1] if "::" in base else base) or name[:60]


def _union(spans: list) -> list:
    """Sorted disjoint intervals covering ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost(host: dict) -> list:
    """Per host thread, its outermost ops as sorted disjoint
    (starts, ends, names) lists."""
    out = []
    for spans in host.values():
        starts, ends, names = [], [], []
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            if not ends or a >= ends[-1]:
                starts.append(a)
                ends.append(b)
                names.append(name)
        out.append((starts, ends, names))
    return out


def _host_op_at(threads: list, ts: float) -> str:
    """The longest outermost ``aten::`` op open at ``ts`` on any host
    thread."""
    best, best_len = HOST_IDLE, -1.0
    for starts, ends, names in threads:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ends[i] >= ts and ends[i] - starts[i] > best_len:
            best, best_len = names[i], ends[i] - starts[i]
    return best


def reduce(events: list, lo_us: float, hi_us: float) -> dict:
    """The report of the device events that start in [lo_us, hi_us) on the
    trace's clock: ``groups`` {group: [seconds, events]}, ``total_s`` (the
    groups' sum), ``busy_s`` (the union of the intervals, clipped to the
    range), ``ops`` {"op (group)": seconds} and ``gaps`` {host op:
    seconds idle}. Raises ValueError when no device event lies there."""
    stacks = _launching_ops(events)
    groups = {g: [0.0, 0] for g in GROUPS}
    ops, spans, host = {}, [], {}
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        cat = str(e.get("cat", "")).lower()
        if cat in OP_CATS and e.get("name", "").startswith("aten::"):
            host.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + dur, e["name"]))
        kind = DEVICE_CATS.get(cat)
        if kind is None or not lo_us <= ts < hi_us:
            continue
        name = e.get("name", "")
        stack = [op for op in stacks.get(
            e.get("args", {}).get("correlation"), []) if op.startswith(
                "aten::")]
        group = classify(name, kind, stack)
        groups[group][0] += dur / 1e6
        groups[group][1] += 1
        label = f"{stack[0] if stack else _short(name)} ({group})"
        ops[label] = ops.get(label, 0.0) + dur / 1e6
        spans.append((ts, min(ts + dur, hi_us)))
    if not spans:
        raise ValueError("the traced frames hold no device event")
    busy = _union(spans)
    threads, gaps, edge = _outermost(host), {}, lo_us
    for a, b in busy + [[hi_us, hi_us]]:
        if a > edge:
            name = _host_op_at(threads, (a + edge) / 2)
            gaps[name] = gaps.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return dict(groups=groups, total_s=sum(v[0] for v in groups.values()),
                busy_s=sum(b - a for a, b in busy) / 1e6, ops=ops,
                gaps=gaps, n_events=len(spans))


def glue_ms(rep: dict, frames: int) -> float:
    """Device ms a frame outside the walk kernels."""
    return sum(s for g, (s, _) in rep["groups"].items()
               if g not in WALK_GROUPS) * 1e3 / frames


def walk_ms(rep: dict, frames: int) -> float | None:
    """Device ms a frame in the walk kernels; None where none ran."""
    if not sum(rep["groups"][g][1] for g in WALK_GROUPS):
        return None
    return sum(rep["groups"][g][0] for g in WALK_GROUPS) * 1e3 / frames


def device_spans_ns(events) -> list:
    """(start, end) ns of the device events (kernels, copies, sets) among a
    profiler's raw events (``_KinetoEvent``s or alike)."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        kind = getattr(e, "activity_type", None)
        if kind is not None and kind().lower() not in DEVICE_CATS:
            continue
        a = e.start_ns()
        out.append((a, a + e.duration_ns()))
    return out


def busy_s_of(spans_ns: list) -> float:
    """Seconds covered by the union of (start, end) ns spans."""
    return sum(b - a for a, b in _union(spans_ns)) / 1e9


class BusyClock:
    """The card's busy seconds over a run of whole frames.

    Each piece of about ``piece_s`` seconds is profiled (device activity
    only) from one frame boundary to another; at a boundary the piece is
    synchronised, stopped, reduced to the union of its device intervals
    and the next one started, so no profiler buffer fills and every
    device event of every frame is counted once."""

    def __init__(self, piece_s: float = 2.0):
        self.piece_s = piece_s
        self.busy_s = 0.0
        self.events = 0
        self.pieces = 0
        self._prof = None
        self._t = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        spans = device_spans_ns(self._prof.profiler.kineto_results.events())
        self._prof = None
        self.busy_s += busy_s_of(spans)
        self.events += len(spans)
        self.pieces += 1

    def frame_done(self):
        """At a frame boundary: a new piece once this one is long enough."""
        if time.perf_counter() - self._t >= self.piece_s:
            self.stop()
            self.start()


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest [name, value] pairs of ``d``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
