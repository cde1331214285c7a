"""Profiling helpers: the software replacement for RTL waveform dumps.

The reference profiles by Verilator tracing (`--trace` in every cocotb
Makefile); here the analogs are (a) the interpreter's ``trace=True``
instruction trace (:mod:`.vcd` writes it as a VCD file) and (b) the
PyTorch profiler wrapped below.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .results import host_array


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
    kernels) and write it to ``logdir`` as a Chrome trace (view with
    Perfetto or TensorBoard)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)):
        yield
        _synchronize()


def _synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for without
    CUDA: CPU tensors are computed when their call returns)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _to_host(tree):
    """Every tensor leaf of a dict / list / tuple tree as a host numpy
    array."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return host_array(tree)
    return tree


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


class DispatchTimer:
    """Per-step wall-clock split into the three host-visible phases of
    an asynchronously dispatched device step: DISPATCH (the call
    returning its tensors — kernel enqueue, plus whatever the host waits
    on inside the call), DEVICE (``torch.cuda.synchronize`` after it),
    TRANSFER (the host copy of every output tensor).  A dispatch-bound
    loop shows the first segment dominating while the device sits idle —
    the diagnosis that motivates folding batches into one dispatch
    (``parallel.sweep.run_spanned``).

    Example::

        t = DispatchTimer()
        for seed in seeds:
            stats = t.step(lambda: run_batch(seed))
        print(t.breakdown())
    """

    def __init__(self):
        self.dispatch_s = 0.0
        self.device_s = 0.0
        self.transfer_s = 0.0
        self.steps = 0

    def step(self, fn):
        """Run ``fn() -> tree of tensors``; returns the host numpy tree,
        charging each phase to its counter."""
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        _synchronize()
        t2 = time.perf_counter()
        host = _to_host(out)
        t3 = time.perf_counter()
        self.dispatch_s += t1 - t0
        self.device_s += t2 - t1
        self.transfer_s += t3 - t2
        self.steps += 1
        return host

    def breakdown(self) -> dict:
        """Totals + per-step means in ms, JSON-able for bench rows."""
        n = max(self.steps, 1)
        out = {'steps': self.steps}
        for name in ('dispatch', 'device', 'transfer'):
            s = getattr(self, name + '_s')
            out[name + '_s'] = round(s, 6)
            out[name + '_ms_per_step'] = round(1e3 * s / n, 4)
        return out
