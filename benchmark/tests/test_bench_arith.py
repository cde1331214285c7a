"""The open loop's clock: latency from each request's due time, the
generator's lateness, failures counted at the time the run gave up, the
95th percentile over all requests; rates over all work and all time."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from benchmark.drivers import service_open_loop as sol
from benchmark.harness.cell import Context, read_metric
from benchmark.harness.common import Cell, p95


def test_p95_nearest_rank_over_all_values():
    assert p95(range(1, 101)) == 95
    assert p95([5.0]) == 5.0
    assert p95([1.0] * 94 + [float('inf')] * 6) == float('inf')
    assert p95([1.0] * 95 + [float('inf')] * 5) == 1.0


class _Handle:
    def __init__(self, delay: float, fail: bool):
        self._t = time.perf_counter() + delay
        self.fail = fail

    def result(self, timeout=None):
        wait = self._t - time.perf_counter()
        if timeout is not None and wait > timeout:
            time.sleep(timeout)
            raise TimeoutError('not back')
        time.sleep(max(0.0, wait))
        if self.fail:
            raise RuntimeError('shed')
        return {}

    def trace(self):
        return None


class _Service:
    """Answers request k after ``delays[k]`` seconds; every third fails,
    and the eighth never answers."""

    def __init__(self, delays):
        self.delays, self.k = delays, 0
        self.lock = threading.Lock()

    def submit(self, mp, bits):
        with self.lock:
            k, self.k = self.k, self.k + 1
        if k == 7:
            return _Handle(1e9, False)
        return _Handle(self.delays[k], k % 3 == 2)

    def stats(self):
        return {'dispatches': self.k, 'programs_dispatched': self.k}


def test_latency_counts_from_the_due_time():
    cell = Cell('rb8_reset.tenants')
    ctx = Context(cell, 9, 0.5, False, 'cpu', dict(grace_s=0.3))
    due = np.array([0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.35, 0.40])
    delays = [0.02 * (k + 1) for k in range(len(due))]
    st = dict(svc=_Service(delays), due=due, which=np.zeros(8, int),
              bits=[None], mps=[None], sample=set())
    win = sol.window(ctx, st)
    lat = np.asarray(st['lat'])
    # answered requests: due -> result, at least their service delay and
    # at most that plus the generator's lateness
    for k in (0, 1, 3, 4, 6):
        assert delays[k] <= lat[k] < delays[k] + 0.05
    # failed (2, 5) and unanswered (7) requests count at the give-up time
    give_up = due[-1] + 0.3
    for k in (2, 5, 7):
        assert lat[k] == pytest.approx(give_up - due[k], abs=0.05)
    assert st['unanswered'] == 3 and win['failed'] == 3
    assert win['latencies_ms'] == pytest.approx(list(1e3 * lat))
    # the goodput counts only the answered requests within the limit
    slo_s = float(ctx.traffic['slo_ms']) / 1e3
    ok = sum(1 for k in (0, 1, 3, 4, 6) if lat[k] <= slo_s)
    assert ok == 5
    assert win['metrics']['goodput_rps'] == pytest.approx(ok / 0.5)
    assert read_metric('request_p95_ms.tenants',
                       dict(window=win)) == pytest.approx(1e3 * p95(lat))


def test_rate_is_all_work_over_all_time(monkeypatch):
    """The campaign's rate divides every shot of the window by the whole
    window, the batches' host work included."""
    from benchmark.drivers import physics_batches as pb
    ctx = Context(Cell('rb8_reset.campaign'), 1, 0.2, False, 'cpu',
                  dict(keep_batches=1))
    calls = []

    def batch(i):
        calls.append(i)
        time.sleep(0.03)
        return None, {'n_pulses': np.zeros((10, 8))}, \
            {'fault_shots': np.zeros(8), 'err_shots': 0}
    st = dict(batch=batch, B=10)
    t0 = time.perf_counter()
    win = pb.window(ctx, st)
    wall = time.perf_counter() - t0
    assert win['attempted'] == 10 * len(calls)
    rate = win['metrics']['shots_per_s']
    assert 10 * len(calls) / wall <= rate <= 10 * len(calls) / (0.03 * len(calls))
