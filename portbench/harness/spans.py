"""The device's idle time by program span, from the traced window's Chrome
events.

The program marks its host work with ``torch.profiler.record_function``
ranges named ``raytpu::<layer>.<what>`` (``user_annotation`` events); a
span that waits for the device has ``.sync`` in its name. ``reduce``
takes the host thread that holds ``raytpu::entry.frame``, builds the
device's busy intervals as ``trace.reduce`` does (device events that
start in the range, clipped to its end, their union), and puts every
idle microsecond of the range down to the innermost program span open on
that thread at that instant, split exactly at the spans' edges; idle
time under no program span is ``outside``.

``of_run`` gives the per-layer readers the report of the run's traced
window, reduced once: ``ctx["trace"]["spans"]`` where the harness put it
there, else the window that ``harness/cell.py``'s ``run`` holds while
it calls the readers (its ``events``, ``lo`` and ``hi``).
"""

from __future__ import annotations

import sys

from . import trace

PREFIX = "raytpu::"
FRAME = PREFIX + "entry.frame"
OUTSIDE = "outside"


def layer_of(name: str) -> str:
    """``entry`` of ``raytpu::entry.tile``; ``outside`` stays ``outside``."""
    return name[len(PREFIX):].split(".", 1)[0] if name.startswith(
        PREFIX) else name


def _is_span(e: dict) -> bool:
    return (e.get("ph") == "X"
            and str(e.get("cat", "")).lower() == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX))


def _busy(events: list, lo_us: float, hi_us: float) -> list:
    """The union of the device intervals that start in [lo_us, hi_us),
    each clipped to hi_us (``trace.reduce``'s busy time)."""
    spans = []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        if str(e.get("cat", "")).lower() not in trace.DEVICE_CATS:
            continue
        ts = float(e["ts"])
        if lo_us <= ts < hi_us:
            spans.append((ts, min(ts + float(e.get("dur", 0)), hi_us)))
    return trace._union(spans)


def _idle(busy: list, lo_us: float, hi_us: float) -> list:
    """The complement of ``busy`` in [lo_us, hi_us), sorted."""
    out, edge = [], lo_us
    for a, b in busy + [[hi_us, hi_us]]:
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    return out


def _pieces(spans: list) -> list:
    """(start, end, name) pieces of one thread's time, each under the
    innermost span open through it; a child is cut to its parent."""
    out, stack, cur = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            out.append((cur, end, top))
            cur = end
        if stack:
            out.append((cur, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append((b, name))
        cur = a
    while stack:
        end, top = stack.pop()
        out.append((cur, end, top))
        cur = end
    return [p for p in out if p[1] > p[0]]


def reduce(events: list, lo_us: float, hi_us: float) -> dict:
    """The program spans' report of [lo_us, hi_us) on the trace's clock:
    ``idle_s`` {span name or ``outside``: idle seconds}, ``idle_s_by_layer``
    {layer or ``outside``: idle seconds}, ``count`` {span name: spans that
    start in the range on the frame's thread} and ``frames`` (the
    ``raytpu::entry.frame`` spans among them). Without a frame span in the
    range: ``frames`` 0 and nothing else read."""
    spans = [e for e in events if _is_span(e)]
    frames = [e for e in spans if e["name"] == FRAME
              and lo_us <= float(e["ts"]) < hi_us]
    if not frames:
        return dict(idle_s={}, idle_s_by_layer={}, count={}, frames=0)
    thread = (frames[0].get("pid"), frames[0].get("tid"))
    mine = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in spans
            if (e.get("pid"), e.get("tid")) == thread]
    count = {}
    for a, _, name in mine:
        if lo_us <= a < hi_us:
            count[name] = count.get(name, 0) + 1
    idle = _idle(_busy(events, lo_us, hi_us), lo_us, hi_us)
    pieces = _pieces(mine)
    idle_s, i, j = {}, 0, 0
    while i < len(idle) and j < len(pieces):
        a = max(idle[i][0], pieces[j][0])
        b = min(idle[i][1], pieces[j][1])
        if b > a:
            name = pieces[j][2]
            idle_s[name] = idle_s.get(name, 0.0) + (b - a) / 1e6
        if idle[i][1] <= pieces[j][1]:
            i += 1
        else:
            j += 1
    inside = sum(idle_s.values())
    idle_s[OUTSIDE] = max(sum(b - a for a, b in idle) / 1e6 - inside, 0.0)
    by_layer = {}
    for name, s in idle_s.items():
        layer = layer_of(name)
        by_layer[layer] = by_layer.get(layer, 0.0) + s
    return dict(idle_s=idle_s, idle_s_by_layer=by_layer, count=count,
                frames=len(frames))


def _held_window():
    """(events, lo_us, hi_us) of the traced window that ``cell.run`` holds
    on the stack while its readers run, or None."""
    f = sys._getframe(1)
    while f is not None:
        names = f.f_locals
        if (f.f_code.co_name == "run"
                and f.f_globals.get("__name__", "").endswith("harness.cell")
                and isinstance(names.get("events"), list)
                and "lo" in names and "hi" in names):
            return names["events"], names["lo"], names["hi"]
        f = f.f_back
    return None


def of_run(ctx: dict) -> dict | None:
    """The program spans' report of the run's traced window, reduced once
    and kept as ``ctx["trace"]["spans"]``; None without a device trace
    (the ten largest idle spans go to standard error when reduced)."""
    rep = ctx.get("trace")
    if rep is None:
        return None
    if "spans" not in rep:
        window = _held_window()
        if window is None:
            return None
        rep["spans"] = reduce(*window)
        top = trace.top(rep["spans"]["idle_s"])
        print("[portbench] device idle s by program span (innermost): "
              + ", ".join(f"{name} {s:.6f}" for name, s in top),
              file=sys.stderr, flush=True)
    return rep["spans"]


def idle_ms(ctx: dict, layer: str) -> float | None:
    """Device idle ms a traced frame under ``layer``'s spans; None without
    a ``raytpu::entry.frame`` span in the window."""
    rep = of_run(ctx)
    if not rep or not rep["frames"]:
        return None
    return rep["idle_s_by_layer"].get(layer, 0.0) * 1e3 / rep["frames"]
