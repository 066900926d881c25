"""The program's spans in the torch.profiler trace.

``span(name)`` marks a stretch of the host's work as a
``torch.profiler.record_function`` range, so it lands in the same Kineto
timeline as the kernels and copies it launches, on the device trace's
clock. It costs one check of the profiler's flag when no profiler is
recording, and then returns a shared context that does nothing: tracing
is on exactly while the caller runs torch.profiler (``cli.py --profile``,
``tools/frame_profile.py``, a benchmark's traced window). There is no
switch, no second recorder and no value attached to a span: a counter is
the count of spans of one name. ``spanned(name)`` puts a whole function
inside one.

Names are ``raytpu::<layer>.<what>``, ``<layer>`` one of ``entry``,
``scene``, ``engine`` and ``kernels``; a span in which the host waits for
the device has ``.sync`` in its name (``raytpu::engine.sync.alive``).
README.md lists them.
"""

from __future__ import annotations

import functools

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

PREFIX = "raytpu::"


class _Off:
    """The span of a run that no profiler records: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else the
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
