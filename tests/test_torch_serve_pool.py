"""The port's executor pool against the JAX package's.

Mirrors tests/test_serve_multidevice.py over two executors that share the
CPU device (``devices=['cpu', 'cpu']``): bucket-affinity routing sends
each shape bucket to a sticky home executor, work stealing migrates a
ripened batch to an idle executor, stolen requests re-run their deadline
and cancel checks at the re-queue boundary, warm-up covers every
executor, and shutdown under load joins every ``dproc-serve-dispatch-*``
thread.  Every result equals the JAX package's solo ``simulate_batch``,
whichever executor ran it.
"""

import threading
import time

import numpy as np
import pytest

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds

from distributed_processor_tpu_torch import isa
from distributed_processor_tpu_torch.serve import (CancelledError,
                                                   Coalescer, DeadlineError,
                                                   ExecutionService,
                                                   bucket_key)
from distributed_processor_tpu_torch.serve.request import Request
from distributed_processor_tpu_torch.serve.service import _normalize_cfg
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, clear_aot_cache)
from distributed_processor_tpu_torch.utils import profiling

from test_torch_interpreter import _to_port
from test_torch_serve import T, assert_same, jax_solo

POOL = ['cpu', 'cpu']
_KW = dict(max_steps=2 * 16 + 64, max_pulses=16 + 2, max_meas=2,
           max_resets=2)
_CFG = InterpreterConfig(**_KW)


@pytest.fixture(autouse=True)
def _isolation():
    snap = profiling.registry_snapshot()
    clear_aot_cache()
    yield
    clear_aot_cache()
    profiling.registry_restore(snap)


def _mp(n_pulses, base):
    core = [jisa.pulse_cmd(amp_word=base + 7 * i, cfg_word=0, env_word=3,
                           cmd_time=10 + 20 * i) for i in range(n_pulses)] \
        + [jisa.done_cmd()]
    mp = j_from_cmds([core])
    return mp, _to_port(mp)


def _small():
    """Branch-free single-core program in the 8-instruction bucket."""
    return _mp(3, 1000)


def _big():
    """The same family in the 16-instruction bucket: another key."""
    return _mp(10, 2000)


def _bits(rng, shots):
    return rng.integers(0, 2, size=(shots, 1, 2)).astype(np.int32)


def _solo(mp_j, bits):
    return jax_solo(mp_j, bits, _KW)


def _no_leaked_dispatchers():
    return [t.name for t in threading.enumerate()
            if t.name.startswith('dproc-serve-dispatch') and t.is_alive()]


def test_pool_routing_spreads_buckets_bit_identity():
    (small_j, small), (big_j, big) = _small(), _big()
    rng = np.random.default_rng(3)
    reqs = [(small_j, small, _bits(rng, 4)) for _ in range(4)] \
        + [(big_j, big, _bits(rng, 4)) for _ in range(4)]
    with ExecutionService(_CFG, max_batch_programs=4, max_wait_ms=25.0,
                          devices=POOL, work_stealing=False) as svc:
        handles = [svc.submit(mp, b) for _, mp, b in reqs]
        results = [h.result(timeout=T) for h in handles]
        st = svc.stats()
    for (mj, _, b), got in zip(reqs, results):
        assert_same(got, _solo(mj, b), f'{mj.n_instr}instr')
    assert st['n_devices'] == 2 and st['steals'] == 0
    assert [d['device'] for d in st['devices']] == ['cpu', 'cpu']
    assert [d['home_buckets'] for d in st['devices']] == [1, 1]
    assert all(d['dispatches'] >= 1 for d in st['devices'])
    assert sum(d['dispatches'] for d in st['devices']) == st['dispatches']
    assert sum(d['programs_dispatched'] for d in st['devices']) \
        == st['programs_dispatched'] == len(reqs)
    assert not _no_leaked_dispatchers()


def test_work_steal_migrates_ripe_batch_to_idle_executor():
    mp_j, mp = _small()
    rng = np.random.default_rng(4)
    bits = [_bits(rng, 4) for _ in range(4)]
    svc = ExecutionService(_CFG, max_batch_programs=2, max_wait_ms=5.0,
                           devices=POOL)
    try:
        svc.warmup(mp, shots=4, n_programs=2)
        orig, slowed = svc._run_batch, []

        def slow_first(ex, key, batch, cfg):
            if not slowed:
                slowed.append(ex.idx)
                time.sleep(0.5)     # hold the home busy past ripening
            return orig(ex, key, batch, cfg)

        svc._run_batch = slow_first
        handles = [svc.submit(mp, b) for b in bits]
        results = [h.result(timeout=T) for h in handles]
        st = svc.stats()
    finally:
        svc.shutdown(timeout=T)
    for b, got in zip(bits, results):
        assert_same(got, _solo(mp_j, b), 'stolen-ok')
    assert st['steals'] >= 1
    assert sum(d['steals'] for d in st['devices']) == st['steals']
    assert sum(d['stolen_from'] for d in st['devices']) >= 1
    assert all(d['dispatches'] >= 1 for d in st['devices'])
    assert not _no_leaked_dispatchers()


def test_absorb_reruns_deadline_and_cancel_checks():
    _, mp = _small()
    ncfg, _ = _normalize_cfg(_CFG, isa.shape_bucket(mp.n_instr))
    key = bucket_key(mp, ncfg)

    def mk(seq, deadline=None):
        return Request(mp=mp, meas_bits=np.zeros((2, 1, 2), np.int32),
                       init_regs=None, cfg=ncfg, strict=False, n_shots=2,
                       priority=0, deadline=deadline, seq=seq)

    now = time.monotonic()
    home, thief = Coalescer(4, 60.0), Coalescer(4, 60.0)
    live, doomed, dead = mk(0), mk(1, deadline=now + 0.01), mk(2)
    for r in (live, doomed, dead):
        home.push(key, r)
    assert dead.handle.cancel()
    later = now + 1.0
    moved = home.migrate_bucket(key, 4)
    assert len(moved) == 3 and len(home) == 0
    expired = thief.absorb(key, moved, now=later)
    assert [r.seq for r in expired] == [1]
    with pytest.raises(DeadlineError):
        doomed.handle.result(timeout=0)
    assert thief.dropped_cancelled == 1
    assert len(thief) == 1 and live.migrations == 1
    k, batch, exp = thief.pop_batch(now=later)
    assert k == key and [r.seq for r in batch] == [0] and not exp


def test_warmup_and_compile_stats():
    """Warm-up covers every executor, each classified cold; the shape is
    warmed once per device, so the second executor on the shared CPU
    finds it warm (``compile_ms`` 0).  A live batch of the warmed shape
    is then a warm hit on its home."""
    mp_j, mp = _small()
    rng = np.random.default_rng(5)
    cold0 = profiling.counter_get('serve.compile.cold')
    warm0 = profiling.counter_get('serve.compile.warm')
    with ExecutionService(_CFG, max_batch_programs=2, max_wait_ms=5.0,
                          devices=POOL) as svc:
        report = svc.warmup(mp, shots=4, n_programs=2)
        assert [r['cold'] for r in report] == [True, True]
        assert report[0]['compile_ms'] > 0
        assert report[1]['compile_ms'] == 0.0
        st = svc.stats()
        assert st['compile']['cold'] == 2 and st['compile']['warm'] == 0
        per = st['compile']['per_bucket']['c1i8']
        assert per['cold'] == 2 and per['warm'] == 0
        assert per['cold_ms_mean'] is None
        assert st['warmups'] == 2 and st['warmup']['aot_compiled'] == 1
        assert st['dispatches'] == 0
        bits = [_bits(rng, 4) for _ in range(2)]
        handles = [svc.submit(mp, b) for b in bits]
        for h, b in zip(handles, bits):
            assert_same(h.result(timeout=T), _solo(mp_j, b))
        st = svc.stats()
    per = st['compile']['per_bucket']['c1i8']
    assert st['compile']['cold'] == 2 and st['compile']['warm'] == 1
    assert per['warm_ms_mean'] is not None and per['warm_ms_mean'] > 0
    assert per['cold_ms_mean'] is None and per['compile_ms_est'] is None
    assert st['devices'][0]['warm_hits'] == 1
    assert profiling.counter_get('serve.compile.cold') - cold0 == 2
    assert profiling.counter_get('serve.compile.warm') - warm0 == 1
    assert not _no_leaked_dispatchers()


def test_shutdown_under_load_joins_every_dispatcher():
    mp_j, mp = _small()
    rng = np.random.default_rng(6)
    bits = [_bits(rng, 2) for _ in range(8)]
    svc = ExecutionService(_CFG, max_batch_programs=2, max_wait_ms=2.0,
                           devices=POOL * 2)
    handles = [svc.submit(mp, b) for b in bits]
    svc.shutdown(drain=True, timeout=T)
    for h, b in zip(handles, bits):
        assert_same(h.result(timeout=0), _solo(mp_j, b), 'drained')
    assert not _no_leaked_dispatchers()
    svc = ExecutionService(_CFG, max_batch_programs=64,
                           max_wait_ms=60_000.0, devices=POOL * 2)
    h = svc.submit(mp, bits[0])
    svc.shutdown(drain=False, timeout=T)
    with pytest.raises(CancelledError):
        h.result(timeout=0)
    assert not _no_leaked_dispatchers()


def test_bucket_affinity_is_sticky():
    _, mp = _small()
    rng = np.random.default_rng(7)
    with ExecutionService(_CFG, max_batch_programs=2, max_wait_ms=5.0,
                          devices=POOL, work_stealing=False) as svc:
        for _round in range(3):
            hs = [svc.submit(mp, _bits(rng, 2)) for _ in range(2)]
            for h in hs:
                h.result(timeout=T)
        st = svc.stats()
    assert st['devices'][0]['dispatches'] == st['dispatches'] == 3
    assert st['devices'][1]['dispatches'] == 0
    assert st['devices'][1]['queue_depth'] == 0
    assert not _no_leaked_dispatchers()
