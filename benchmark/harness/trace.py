"""The benchmark's own host spans and the device trace of a traced run.

With ``--trace 1`` a run starts ``torch.profiler`` with CUDA activity
alone (kernels, copies and fills on the device's timeline; no per-op
host recording, whose cost would slow the eager engines' dispatch
several times over) for ``trace_seconds`` of the traffic file, at
boundaries of the traffic's work (a batch, a call, an arrival): the
closed loops trace the start of their window, the open loop a segment
of its traffic after the window.  The window and the spans
are the benchmark's own, on the host's wall clock in nanoseconds, the
clock the profiler puts device timestamps on: ``bench`` spans around
its calls into the port (spans inside the port are a later change).
The reduction reads the profiler's raw events, not ``key_averages()``,
whose per-event tables are slow at ~10^5 launches.
"""

from __future__ import annotations

import contextlib
import time

# names of device activities that are copies or fills, not kernels
COPY_PREFIXES = ('Memcpy', 'Memset', 'memcpy', 'memset')


class Tracer:
    """Host spans, and the profiler while a traced window is open."""

    def __init__(self, enabled: bool, device_type: str):
        self.enabled = enabled
        self.device_type = device_type
        self.active = False
        self.prof = None
        self.events = None
        self._spans = []
        self._t0 = None

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.time_ns()))

    def span(self, name: str):
        """A host span while the traced window is open, else nothing."""
        return self._span(name) if self.active else contextlib.nullcontext()

    def start(self) -> None:
        if not self.enabled:
            return
        if self.device_type == 'cuda':
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.active = True
        self._t0 = time.time_ns()

    def stop(self, sync) -> None:
        """Close the traced window after ``sync()`` (the device drained)."""
        if not self.active:
            return
        sync()
        window = (self._t0, time.time_ns())
        self.active = False
        device = []
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            device = device_events(self.prof)
            self.prof = None
        self.events = dict(
            device=[d for d in device if d[2] > window[0] and d[1] < window[1]],
            outside=sum(1 for d in device
                        if d[2] <= window[0] or d[1] >= window[1]),
            spans=self._spans, window=window)


def device_events(prof) -> list:
    """Every device activity of the profile as ``(name, start_ns,
    end_ns)``."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def busy_intervals(device: list, window: tuple) -> list:
    """The union of the device activities' intervals inside ``window``."""
    iv = sorted((max(s, window[0]), min(e, window[1])) for _n, s, e in device)
    out = []
    for s, e in iv:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(events: dict) -> float:
    return sum(e - s for s, e in busy_intervals(
        events['device'], events['window'])) / 1e9


def window_s(events: dict) -> float:
    w = events['window']
    return (w[1] - w[0]) / 1e9


def idle_gaps(events: dict, top: int = 10) -> list:
    """The longest gaps between device activities in the window, each
    named by the shortest bench span open at its middle."""
    w = events['window']
    busy = busy_intervals(events['device'], w)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted(events['spans'], key=lambda s: s[2] - s[1])
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        label = next((n for n, a, b in spans if a <= mid <= b), 'none')
        named.append([label, (e - s) / 1e9])
    return named


def top_device_ops(events: dict, top: int = 10) -> list:
    """Device time by activity name, the largest first."""
    tot = {}
    for name, s, e in events['device']:
        tot[name] = tot.get(name, 0) + (e - s)
    items = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in items]


def matching(device: list, patterns) -> list:
    """The device activities whose names hold any of ``patterns``."""
    return [d for d in device if any(p in d[0] for p in patterns)]


def device_seconds(device: list) -> float:
    return sum(e - s for _n, s, e in device) / 1e9

