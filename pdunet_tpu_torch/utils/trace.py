"""Spans of the port's phases, on the host's clock and the device's.

    with trace.span("recon"):
        ...

``span(name)`` marks one phase of the program. With no recording active and
no ``torch.profiler`` running it returns one shared object that does
nothing: two flag checks, no allocation, no CUDA event. Under a running
profiler it also opens ``torch.profiler.record_function(name)``, so the
phase lies on the profile's timeline beside the device's kernels, and an
idle gap there can be put down to the innermost phase over it. Inside

    with trace.recording(device) as rec:
        ...
    spans = rec.spans()

every span is kept in memory: its name, its id, its parent's and its
root's (the spans of one request or train step share their root's), host
``perf_counter_ns`` at enter and exit, whether a profiler was running at
its start (``profiled``), and on a CUDA device a timing-enabled event at
each end. ``recording`` synchronises and records an anchor: an event on
the idle device and the host's ns at that moment (the shortest of eight
round trips). ``spans()`` takes a second anchor and resolves the events
once, after the window, onto the host's clock (the first anchor's ns +
its ``elapsed_time`` to the event, scaled so that the two anchors agree:
a drift between the clocks over a long recording cancels), so each span
has host and device [start, end] on one clock with no profiler. On the
CPU a span's device times are its host times. While the current stream
is being captured into a CUDA graph a span records no event (its device
times are then None).

Spans nest by time on one stack per recording, not per thread: the
autograd engine runs a CUDA backward on a thread of its own while the
caller waits in ``backward()``, so the unroll's spans that remat
recomputes there nest under the step's ``train.backward``.

A root span (one with no parent) keeps the change over it of every
counter registered with :func:`counter` (``Span.counts``, the nonzero
ones). The kernel layer registers its own: ``ops/radon/cuda_kernels.py``
each ``.launches``, ``.launches_tc`` and ``.launches_split`` of its
wrappers and table builders (calls on the CPU do not count),
``ops/radon/_build.py`` its ``kernels_built`` and ``kernels_loaded``, and
``models/primal_dual.py`` ``convnet.channels_last`` and
``convnet.padded_convs``: LPD ConvNet calls on the card, and those of their
convolutions whose channels were zero-padded.

The program's spans (:data:`NAMES`), where they are opened:

  synthesis, recon   training/tasks.py, every task's ``batch_from_images``
                     and ``recon_fn``
  pd.dual, pd.primal models/primal_dual.py, each unroll step's two nets with
                     their concatenated input and residual add
  train.step         training/loop.py ``make_train_step``, with its phases
  train.synthesis, train.forward, train.backward, train.optimizer
  setup.plans        training/tasks.py ``build_task``: each operator's
                     construction (plans, tables built there, radial DCF)
  setup.opnorm       ``build_task``'s power iteration for σ
  setup.kernels      ops/radon/_build.py ``load_library``, on a real load
                     (an nvcc build and the library's ``CDLL``)
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["NAMES", "Span", "Recorder", "span", "traced", "recording", "active", "counter"]

NAMES = ("synthesis", "recon", "pd.dual", "pd.primal", "train.step",
         "train.synthesis", "train.forward", "train.backward", "train.optimizer",
         "setup.plans", "setup.opnorm", "setup.kernels")

#: the recording that spans go to, or None
_active: Optional["Recorder"] = None
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One resolved span; times in ns on the host's ``perf_counter_ns`` clock."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    host_start: int
    host_end: int
    device_start: Optional[int]
    device_end: Optional[int]
    profiled: bool
    #: the kernel counters' nonzero changes over a root span ({} below one)
    counts: dict


class _Off:
    """What ``span`` returns when nothing records and no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    """A span that opens a profiler range, is recorded, or both."""

    __slots__ = ("name", "rec", "range", "id", "parent", "root", "t0", "t1", "e0", "e1",
                 "profiled", "counts")

    def __init__(self, name: str, rec: Optional["Recorder"]):
        self.name, self.rec = name, rec

    def __enter__(self):
        self.profiled = _profiling()
        self.range = None
        if self.profiled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.rec is not None:
            self.rec._open(self)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._close(self)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def mark(self, end: bool = True, cuda: bool = False):
        """This span's end (or start) as ``make_train_step``'s ``marks=``
        holds it: the CUDA event, else host seconds. ``cuda``: the phase ran
        on a card, where host seconds would time the host's dispatch, not
        the phase: with no event (a recording on another device, or a
        stream being captured) this raises."""
        ev = self.e1 if end else self.e0
        if ev is not None:
            return ev
        if cuda:
            raise RuntimeError(f"span {self.name!r} recorded no CUDA event for marks=: the "
                               "recording is not on the step's device, or the stream is "
                               "being captured")
        return (self.t1 if end else self.t0) * 1e-9


def span(name: str):
    """A context for the phase ``name`` (one of :data:`NAMES`)."""
    rec = _active
    if rec is None and not _profiling():
        return _OFF
    return _Live(name, rec)


def traced(name: str, fn):
    """``fn`` with each call inside ``span(name)``."""

    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return call


def active() -> Optional["Recorder"]:
    """The active recording, or None."""
    return _active


#: counter name → read() -> int, registered by the modules that count
_COUNTERS: dict = {}


def counter(name: str, read):
    """Register the counter ``name``, which starts from 0: each root span
    keeps the change of ``read()`` over it."""
    _COUNTERS[name] = read


def _counters() -> dict:
    return {k: read() for k, read in _COUNTERS.items()}


class Recorder:
    """The spans of one recording (see the module docstring)."""

    def __init__(self, device=None, anchor: bool = True):
        self.device = torch.device("cpu" if device is None else device)
        self.cuda = self.device.type == "cuda"
        self._spans, self._stack = [], []
        self.anchor = self._anchor() if anchor and self.cuda else None

    def _anchor(self, tries: int = 8) -> tuple:
        """(event, host ns) of one moment on both clocks: an event recorded
        on the idle device and stamped midway between its record and its
        completion, of the try whose round trip was shortest (the first
        after an idle spell can take tens of µs to reach the device)."""
        best = None
        for _ in range(tries):
            torch.cuda.synchronize(self.device)
            t = time.perf_counter_ns()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
            u = time.perf_counter_ns()
            if best is None or u - t < best[2]:
                best = (ev, (t + u) // 2, u - t)
        return best[:2]

    def _event(self):
        if not self.cuda or torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _open(self, s: _Live):
        s.id = len(self._spans)
        s.parent = self._stack[-1].id if self._stack else None
        s.root = self._stack[-1].root if self._stack else s.id
        s.counts = _counters() if s.parent is None else None
        self._spans.append(s)
        self._stack.append(s)
        s.t0 = time.perf_counter_ns()
        s.e0 = self._event()

    def _close(self, s: _Live):
        s.e1 = self._event()
        s.t1 = time.perf_counter_ns()
        if s.counts is not None:
            now = _counters()
            # a counter registered inside the span counted from 0 there
            s.counts = {k: v - s.counts.get(k, 0) for k, v in now.items()
                        if v != s.counts.get(k, 0)}
        # an exception may leave through several spans at once: each removes itself
        if self._stack and self._stack[-1] is s:
            self._stack.pop()
        else:
            self._stack.remove(s)

    def _to_host(self):
        """event → host ns, through the first anchor and one taken now; the
        clocks' rates are matched only over a second or more."""
        if self.anchor is None:
            return lambda ev: None
        (a, a_ns), (b, b_ns) = self.anchor, self._anchor()
        ms = a.elapsed_time(b)
        scale = (b_ns - a_ns) / (ms * 1e6) if ms >= 1e3 else 1.0
        return lambda ev: None if ev is None else a_ns + round(a.elapsed_time(ev) * 1e6 * scale)

    def spans(self) -> list:
        """Every closed span as a :class:`Span`, in order of start (an
        anchored recording synchronises the device)."""
        to_host = self._to_host() if self.cuda else None
        out = []
        for s in self._spans:
            if not hasattr(s, "t1"):
                continue
            d0, d1 = (to_host(s.e0), to_host(s.e1)) if self.cuda else (s.t0, s.t1)
            out.append(Span(s.name, s.id, s.parent, s.root, s.t0, s.t1, d0, d1, s.profiled,
                            s.counts or {}))
        return out


@contextlib.contextmanager
def recording(device=None, anchor: bool = True):
    """Record every span opened inside (one recording at a time). On a CUDA
    ``device`` spans record events; ``anchor=False`` skips the
    synchronisation and the anchor, for a caller that only times between
    the events itself (their device times then resolve to None)."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace recording is already active")
    rec = Recorder(device, anchor)
    _active = rec
    try:
        yield rec
    finally:
        _active = None
