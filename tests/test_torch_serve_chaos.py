"""The port's self-healing service under the in-process chaos harness.

Mirrors the in-process cases of tests/test_serve_chaos.py, over two
executors that share the CPU where the JAX tests take two devices: a
100-request soak under scripted and seeded crashes, hangs and slowdowns
(every handle terminates, every completion equals its solo run, which
equals the JAX package's), the breaker's quarantine and canary
re-admission, the retry budget surfacing the original error, overload
shedding and deadline rejection, dispatcher death and respawn, the hang
watchdog with its stale straggler discarded, the attempt-token and
cancel races, and a forced shutdown that never deadlocks ``result``.
"""

import threading
import time

import numpy as np
import pytest

from distributed_processor_tpu_torch.serve import (CancelledError,
                                                   ChaosError, ChaosMonkey,
                                                   ChaosPlan,
                                                   CircuitBreaker,
                                                   ExecutionService,
                                                   OverloadError,
                                                   RetryPolicy,
                                                   ShutdownError, soak)
from distributed_processor_tpu_torch.serve.request import RequestHandle
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, simulate_batch)
from distributed_processor_tpu_torch.utils import profiling

from test_torch_serve import T, assert_same, clean_mp, jax_solo

_KW = dict(max_steps=2 * 8 + 64, max_pulses=8 + 2, max_meas=2,
           max_resets=2)
_CFG = InterpreterConfig(**_KW)
POOL = ['cpu', 'cpu']


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = profiling.registry_snapshot()
    yield
    profiling.registry_restore(snap)


def _mp(salt=0):
    return clean_mp(salt)[1]


def _solo(mp, bits):
    out = simulate_batch(mp, bits, cfg=_CFG, device='cpu')
    return {k: v.numpy() for k, v in out.items()}


def _bits(rng, shots=3):
    return rng.integers(0, 2, size=(shots, 1, 2)).astype(np.int32)


def _wait_all_live(svc, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if svc.stats()['health']['live'] == len(svc._executors):
            return
        time.sleep(0.02)
    raise AssertionError(f'executors not all re-admitted: '
                         f'{svc.stats()["health"]}')


def _svc(**kw):
    base = dict(max_batch_programs=4, max_wait_ms=2.0, max_queue=1024,
                retry_policy=RetryPolicy(max_attempts=6, backoff_s=0.005),
                breaker_threshold=2, breaker_cooldown_ms=60.0,
                supervise_interval_ms=10.0, devices=['cpu'])
    base.update(kw)
    return ExecutionService(_CFG, **base)


def test_chaos_soak_pool_terminates_bit_identical():
    pairs = [clean_mp(s) for s in range(4)]
    mps = [mp for _, mp in pairs]
    # the solo references the soak checks against equal the JAX
    # package's on the soak's own bits
    rng = np.random.default_rng(7)
    for mj, mp in pairs:
        b = rng.integers(0, 2, (3, 1, 2)).astype(np.int32)
        assert_same(_solo(mp, b), jax_solo(mj, b, _KW))
    # the watchdog's margin is wider than tests/test_serve_chaos.py's:
    # the CPU engine's dispatch runs eagerly, and a loaded test host must
    # not read one as a hang
    plan = ChaosPlan(seed=7, script=('crash',) * 4, p_crash=0.10,
                     p_hang=0.02, p_slow=0.10, hang_s=1.5, slow_s=0.005)
    with _svc(devices=POOL, hang_timeout_s=0.8) as svc:
        for n_programs in (1, 2, 4):
            svc.warmup(mps[0], shots=3, n_programs=n_programs)
        with ChaosMonkey(svc, plan) as monkey:
            report = soak(svc, mps, _CFG, n_requests=100, shots=3, seed=7,
                          result_timeout_s=T, device='cpu')
        assert monkey.script_exhausted()
        assert report.submitted == 100 and report.hung == 0
        assert report.bit_mismatches == 0
        assert report.terminated() == report.submitted
        assert report.completed == 100, dict(report.errors)
        stats = svc.stats()
        assert stats['breaker_trips'] >= 1 and stats['readmissions'] >= 1
        assert stats['retries'] >= report.retries >= 1
        _wait_all_live(svc)
        post = [(mp, _bits(rng)) for mp in mps for _ in range(2)]
        handles = [svc.submit(mp, b, cfg=_CFG) for mp, b in post]
        for (mp, b), h in zip(post, handles):
            assert_same(h.result(timeout=T), _solo(mp, b), 'post-chaos')
        assert svc.stats()['health']['quarantined'] == 0


def test_breaker_trip_quarantine_canary_readmit_single_executor():
    mj, mp = clean_mp()
    bits = _bits(np.random.default_rng(0))
    with _svc() as svc:
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('crash', 'crash'))):
            h = svc.submit(mp, bits, cfg=_CFG)
            got = h.result(timeout=T)
        assert_same(got, jax_solo(mj, bits, _KW), 'healed request')
        assert h.retries == 2
        stats = svc.stats()
        assert stats['breaker_trips'] >= 1 and stats['readmissions'] >= 1
        assert stats['canary']['ok'] >= 1 and stats['health']['live'] == 1


def test_circuit_breaker_unit():
    br = CircuitBreaker(threshold=2, cooldown_s=1.0, cooldown_mult=2.0,
                        max_cooldown_s=3.0)
    assert not br.record_failure()
    assert br.record_failure()
    br.trip(now=100.0)
    assert br.trips == 1
    assert not br.ready_to_probe(100.5) and br.ready_to_probe(101.0)
    br.trip(now=101.0)
    assert not br.ready_to_probe(102.5) and br.ready_to_probe(103.0)
    br.readmit()
    assert br.readmissions == 1 and br.consecutive == 0
    br.record_failure()
    br.record_success()
    assert br.consecutive == 0
    br.trip(now=200.0)
    assert br.ready_to_probe(201.0)


def test_retry_policy_schedule():
    p = RetryPolicy(max_attempts=4, backoff_s=0.02, backoff_mult=2.0,
                    max_backoff_s=0.05)
    assert [p.delay_s(i) for i in range(4)] == [0.02, 0.04, 0.05, 0.05]
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        ChaosPlan(script=('explode',))
    with pytest.raises(ValueError):
        ChaosPlan(p_crash=0.9, p_hang=0.2)


def test_retry_budget_exhaustion_surfaces_original_error():
    mp, bits = _mp(), _bits(np.random.default_rng(1))
    with _svc(retry_policy=RetryPolicy(max_attempts=2, backoff_s=0.005),
              breaker_threshold=100) as svc:
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('crash',) * 8)):
            h = svc.submit(mp, bits, cfg=_CFG)
            with pytest.raises(ChaosError, match='injected crash'):
                h.result(timeout=T)
        assert h.retries == 1
        stats = svc.stats()
        assert stats['retry_exhausted'] == 1 and stats['failed'] >= 1


def test_overload_shed_and_deadline_reject():
    mp = _mp()
    rng = np.random.default_rng(2)
    with _svc(max_batch_programs=1, max_wait_ms=0.0,
              max_est_wait_ms=0.001, supervision=False) as svc:
        for _ in range(2):
            svc.submit(mp, _bits(rng), cfg=_CFG).result(timeout=T)
        assert svc.stats()['est_wait_ms'] is not None
        started, release = threading.Event(), threading.Event()
        orig = svc._run_batch

        def pinned(ex, key, batch, cfg):
            started.set()
            release.wait(30.0)
            return orig(ex, key, batch, cfg)

        svc._run_batch = pinned
        try:
            busy = svc.submit(mp, _bits(rng), cfg=_CFG)
            assert started.wait(30.0)
            low = svc.submit(mp, _bits(rng), cfg=_CFG, priority=0)
            high = svc.submit(mp, _bits(rng), cfg=_CFG, priority=1)
            with pytest.raises(OverloadError, match='shed'):
                low.result(timeout=5.0)
            with pytest.raises(OverloadError, match='deadline'):
                svc.submit(mp, _bits(rng), cfg=_CFG, deadline_ms=0.01)
            with pytest.raises(OverloadError, match='overloaded'):
                svc.submit(mp, _bits(rng), cfg=_CFG, priority=0)
        finally:
            release.set()
        assert busy.result(timeout=T) and high.result(timeout=T)
        stats = svc.stats()
        assert stats['shed'] == 1 and stats['overload_rejected'] == 2


def test_dispatcher_death_respawn_and_recovery():
    mj, mp = clean_mp()
    bits = _bits(np.random.default_rng(3))
    with _svc() as svc:
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('die',))):
            h = svc.submit(mp, bits, cfg=_CFG)
            got = h.result(timeout=T)
        assert_same(got, jax_solo(mj, bits, _KW), 'post-death request')
        assert h.retries >= 1
        stats = svc.stats()
        assert stats['executor_deaths'] == 1
        assert stats['devices'][0]['respawns'] == 1
        assert stats['readmissions'] >= 1 and stats['health']['live'] == 1


def test_hang_watchdog_retries_elsewhere_stale_attempt_discarded():
    mp, bits = _mp(), _bits(np.random.default_rng(4))
    want = _solo(mp, bits)
    with _svc(devices=POOL, hang_timeout_s=0.8) as svc:
        svc.warmup(mp, shots=3, n_programs=1)
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('hang',),
                                        hang_s=3.0)):
            t0 = time.monotonic()
            h = svc.submit(mp, bits, cfg=_CFG)
            got = h.result(timeout=T)
            dt = time.monotonic() - t0
            assert_same(got, want, 'watchdog retry')
            assert dt < 2.9, f'completion took {dt:.2f} s'
            assert h.retries >= 1
            time.sleep(3.1 - dt if dt < 3.1 else 0)
            assert_same(h.result(timeout=1.0), want, 'post-straggler')
        stats = svc.stats()
        assert stats['hangs'] >= 1 and stats['breaker_trips'] >= 1


def test_attempt_token_blocks_stale_completion():
    h = RequestHandle()
    t1 = h._claim()
    assert t1 and not h.done()
    assert h._requeue(t1) and h.retries == 1
    assert not h._fulfill({'x': 1}, token=t1)
    assert not h._fail(RuntimeError('stale'), token=t1)
    assert not h.done()
    t2 = h._claim()
    assert t2 and t2 != t1
    assert h._fulfill({'x': 2}, token=t2)
    assert h.result(timeout=0) == {'x': 2}


def test_cancel_racing_retry_never_double_runs():
    h = RequestHandle()
    tok = h._claim()
    assert not h.cancel()
    assert h._requeue(tok)
    assert h.cancel()
    assert not h._requeue(tok)
    assert h._claim() == 0
    assert not h._fulfill({'x': 3})
    assert h.cancelled()
    with pytest.raises(CancelledError):
        h.result(timeout=0)


def test_cancel_during_retry_backoff_in_service():
    mp, bits = _mp(), _bits(np.random.default_rng(5))
    with _svc(retry_policy=RetryPolicy(max_attempts=6, backoff_s=0.5),
              breaker_threshold=100) as svc:
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('crash',) * 4)):
            h = svc.submit(mp, bits, cfg=_CFG)
            deadline = time.monotonic() + 30.0
            while h.retries == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert h.retries >= 1
            assert h.cancel()
            with pytest.raises(CancelledError):
                h.result(timeout=5.0)
        deadline = time.monotonic() + 10.0
        while svc.stats()['parked'] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.stats()['parked'] == 0
        assert h.cancelled()


def test_forced_shutdown_never_deadlocks_result():
    mp = _mp()
    rng = np.random.default_rng(6)
    started, release = threading.Event(), threading.Event()
    svc = _svc(supervision=False)
    orig = svc._run_batch

    def wedged(ex, key, batch, cfg):
        started.set()
        release.wait(30.0)
        return orig(ex, key, batch, cfg)

    svc._run_batch = wedged
    try:
        h_flight = svc.submit(mp, _bits(rng), cfg=_CFG)
        assert started.wait(30.0)
        h_queued = svc.submit(mp, _bits(rng), cfg=_CFG)
        svc.shutdown(drain=False, timeout=0.3)
        for h in (h_flight, h_queued):
            with pytest.raises(ShutdownError):
                h.result(timeout=5.0)
        assert isinstance(h_flight.exception(timeout=0), CancelledError)
    finally:
        release.set()
        svc.shutdown(drain=False, timeout=T)
    with pytest.raises(ShutdownError):
        h_flight.result(timeout=0)
