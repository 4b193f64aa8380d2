"""Reading a ``torch.profiler`` trace of the traced slice.

The slice runs inside ``record_function(SLICE)`` with the device
synchronised at both ends, so that span bounds the window. Device events
(kernels, copies, fills; not the device-side images of host spans) give
the busy time as the union of their intervals; each idle gap is named by
the innermost host event running at its midpoint.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

__all__ = ["SLICE", "Trace", "read_profile", "idle_percent"]

SLICE = "portbench.slice"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device: list          # [(name, start_ns, dur_ns)] device events inside the window
    host: list            # [(name, start_ns, dur_ns)] host events inside the window

    def device_seconds(self, match) -> tuple:
        """(seconds, launches) of the device events whose name ``match``es."""
        hits = [d for n, _, d in self.device if match(n)]
        return sum(hits) * 1e-9, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), d * 1e-9] for n, d in ops],
                "idle_gaps": [[_short(n), s] for n, s in self._gaps()[:top]]}

    def _gaps(self) -> list:
        """Idle seconds inside the window by the host event at each gap's
        midpoint, largest first."""
        lo, hi = self._bounds()
        merged = _union([(s, s + d) for _, s, d in self.device], lo, hi)
        gaps, t = [], lo
        for s, e in merged:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        hosts = sorted((h for h in self.host if h[0] != SLICE), key=lambda h: h[1])
        by_name, active, i = {}, [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) // 2
            while i < len(hosts) and hosts[i][1] <= mid:
                n, hs, hd = hosts[i]
                heapq.heappush(active, (hs + hd, hd, n))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = min(active, key=lambda a: a[1])[2] if active else "(no host event)"
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def _bounds(self):
        for n, s, d in self.host:
            if n == SLICE:
                return s, s + d
        raise ValueError("the trace has no slice span")


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def _union(intervals, lo, hi) -> list:
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def read_profile(prof) -> Trace:
    """The slice's :class:`Trace` from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), _ns(ev, "start"), _ns(ev, "duration"))
        (host if ev.device_type() == DeviceType.CPU else device).append(rec)
    # a host span (record_function) also appears on the device's timeline,
    # under its own name, over the kernels it launched: not an operation
    spans = {n for n, _, _ in host}
    device = [d for d in device if d[0] not in spans]
    trace = Trace(0.0, 0.0, device, host)
    lo, hi = trace._bounds()
    device = [(n, s, d) for n, s, d in device if s < hi and s + d > lo]
    host = [(n, s, d) for n, s, d in host if s < hi and s + d > lo]
    busy = sum(e - s for s, e in _union([(s, s + d) for _, s, d in device], lo, hi))
    return Trace((hi - lo) * 1e-9, busy * 1e-9, device, host)


def idle_percent(run):
    """Share of the traced slice in which no operation ran on the device, in
    %: 1 − (union of device event intervals ÷ the slice's length). None
    where the run traced nothing, or nothing ran on the device."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
