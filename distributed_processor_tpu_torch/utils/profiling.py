"""Profiling helpers: the software replacement for RTL waveform dumps.

The reference profiles by Verilator tracing (`--trace` in every cocotb
Makefile); here the analogs are (a) the interpreter's ``trace=True``
instruction trace (:mod:`.vcd` writes it as a VCD file) and (b) the
PyTorch profiler wrapped below.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time
import types

import torch

from ..obs.trace import HOST_SPANS, write_chrome_trace


# ---------------------------------------------------------------------------
# named counters: one process-wide registry for host-event probes
# ---------------------------------------------------------------------------
# The counters live in the typed metrics registry (obs/metrics.py), under
# the JAX package's names, so tests and bench rows snapshot every probe
# uniformly and export the lot as Prometheus text.  Counters are ints
# incremented on the host (compile-cache hits and misses, dispatches).
# This package's registry is its own: it shares nothing with the JAX
# package's, so each package's tests read their own counters.
#
# The registry is thread-safe: a bare dict read-modify-write would drop
# increments made from several threads (the compile cache's singleflight
# waiters, for one) and let count asserts misfire on torn snapshots.
#
# These functions are the stable facade; gauges and histograms are
# reached through `registry()`.

from ..obs.metrics import default_registry as _default_registry


def registry():
    """The process-wide typed metrics registry backing these counters."""
    return _default_registry()


def counter_inc(name: str, amount: int = 1) -> int:
    """Increment (and return) the named counter."""
    return _default_registry().inc(name, amount)


def counter_get(name: str) -> int:
    """Current value of the named counter (0 if never incremented)."""
    return _default_registry().get(name)


def counters() -> dict:
    """Consistent snapshot of every named counter."""
    return _default_registry().counters()


def registry_snapshot() -> dict:
    """Deep snapshot of the whole registry (counters + gauges +
    histograms) — pair with :func:`registry_restore` to isolate
    counter-asserting tests from execution order."""
    return _default_registry().snapshot()


def registry_restore(snap: dict) -> None:
    """Restore a :func:`registry_snapshot`."""
    return _default_registry().restore(snap)


def prometheus_text() -> str:
    """Prometheus text-format exposition of every registered metric."""
    return _default_registry().prometheus_text()


@contextlib.contextmanager
def device_profile(logdir: str):
    """Capture a device profile of the enclosed work with
    ``torch.profiler`` (host and, where CUDA is available, the card's
    kernels) and write it to ``logdir`` as a Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``, as TensorBoard's handler names
    it; view with Perfetto or TensorBoard).  The port's host spans of the
    profile (``obs.trace.host_span``, recorded while it collects) go
    beside it, in ``<host>_<pid>.<ns>.host_spans.json`` on the trace's
    time base, so the two files' events share one timeline.

    Yields a namespace whose ``base_ns`` (the trace's
    ``baseTimeNanoseconds``) and ``trace`` (its path) are set once the
    profile is written; ``ExecutionService.dump_trace(path,
    base_ns=...)`` puts a service's request spans on the same timeline::

        with device_profile(logdir) as prof:
            ...                                   # traffic
        svc.dump_trace('requests.json', base_ns=prof.base_ns)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()

    def ready(prof):
        os.makedirs(logdir, exist_ok=True)
        stem = os.path.join(logdir, f'{socket.gethostname()}_{os.getpid()}'
                                    f'.{time.time_ns()}')
        prof.export_chrome_trace(stem + '.pt.trace.json')
        with open(stem + '.pt.trace.json') as f:
            base = re.search(r'"baseTimeNanoseconds":\s*(\d+)', f.read())
        out.base_ns = int(base.group(1)) if base else 0
        out.trace = stem + '.pt.trace.json'
        write_chrome_trace(stem + '.host_spans.json', [], pid='port host',
                           base_ns=out.base_ns,
                           host_spans=HOST_SPANS.spans(t0, time.time_ns()))

    out = types.SimpleNamespace(base_ns=None, trace=None)
    with torch.profiler.profile(activities=acts, on_trace_ready=ready):
        yield out
        _synchronize()


def _synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for without
    CUDA: CPU tensors are computed when their call returns)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock stage timing with device synchronisation.

    Example::

        t = StageTimer()
        out = t.stage('simulate', lambda: simulate_batch(mp, bits))
        print(t.report())
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    def stage(self, name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        _synchronize()
        self.times[name] = self.times.get(name, 0.0) \
            + (time.perf_counter() - t0)
        return out

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f'{name:20s} {dt * 1000:10.1f} ms  {dt / total:6.1%}'
                 for name, dt in sorted(self.times.items(),
                                        key=lambda kv: -kv[1])]
        return '\n'.join(lines)
