"""The port's tracing: spans around the stages of its entry points and one
registry of counters.

Spans are off by default, and then ``span(name)`` tests one bool and
returns one shared context that does nothing. Turned on
(``enable()``, or ``with tracing():``), each span keeps, per path
(``trace``, ``trace/sort``, ...), the number of entries, the total seconds
and the self seconds (the total less the time its child spans cover). The
parent of a span is the span open around it on the same thread. Only
totals are kept, no timeline. While ``torch.profiler`` records, an open
span also opens ``torch.profiler.record_function("bvh.<path>")``, so that
the stage sits on the profiler's timeline beside the device's kernels.

Counters are always on: ``count(name, n)`` adds ``n`` to ``name``. The
kernel wrappers count their launches (``launch.<kernel>[.<build>]``; the
``launch.*`` keys without a build suffix sum to every launch), the device
table cache its uploads (``table_upload``, ``table_upload_bytes``), the
native build each library's seconds (``lib_build_s.<name>``),
and the general path's lock step its steps and host reads
(``traverse.steps``, ``traverse.host_reads``).

    from bvh_tpu_torch import obs
    with obs.tracing():
        tracer(origins, directions)
    obs.snapshot()  # {"spans": {path: {"n", "total_s", "self_s"}},
                    #  "counts": {name: value}}
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_on = False
_clock = time.perf_counter
_lock = threading.Lock()
_spans: dict[str, list] = {}  # path -> [entries, total seconds, child seconds]
_counts: dict[str, float] = {}
_local = threading.local()


class _Off:
    """The span of tracing off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "path", "child", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.path = (self.name if not stack
                     else f"{stack[-1].path}/{self.name}")
        self.child = 0.0
        stack.append(self)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(f"bvh.{self.path}")
            self.rf.__enter__()
        self.t0 = _clock()
        return None

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            rec = _spans.get(self.path)
            if rec is None:
                rec = _spans[self.path] = [0, 0.0, 0.0]
            rec[0] += 1
            rec[1] += dt
            rec[2] += self.child
        return False


def _stack() -> list:
    """This thread's open spans, the innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str):
    """A context around one stage named ``name`` (no ``/``), nested under
    the span open around it on this thread."""
    return _Span(name) if _on else _OFF


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def launch(kernel: str, **builds) -> None:
    """Counts one launch of ``kernel``'s timed build in ``launch.<kernel>``
    and, for each of ``builds`` that holds (``frame=True``), in
    ``launch.<kernel>.<build>`` too. A kernel's counting build is a kernel
    of its own: ``launch.<kernel>_count``."""
    count(f"launch.{kernel}")
    for build, held in builds.items():
        if held:
            count(f"launch.{kernel}.{build}")


def counted(name: str):
    """The counter ``name``'s value: 0 where nothing was counted."""
    return _counts.get(name, 0)


def enable() -> None:
    """Turns spans on."""
    global _on
    _on = True


def disable() -> None:
    """Turns spans off; what they kept stays until ``reset()``."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans are on."""
    return _on


@contextlib.contextmanager
def tracing():
    """Spans on inside the block, and off again after it."""
    enable()
    try:
        yield
    finally:
        disable()


def snapshot() -> dict:
    """The spans' totals by path and the counters, as plain dicts."""
    with _lock:
        spans = {p: {"n": n, "total_s": tot, "self_s": tot - child}
                 for p, (n, tot, child) in _spans.items()}
        return {"spans": spans, "counts": dict(_counts)}


def reset() -> None:
    """Clears the spans' totals and every counter."""
    with _lock:
        _spans.clear()
        _counts.clear()
