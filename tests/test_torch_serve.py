"""The port's execution service (``serve/``) against the JAX package.

Mirrors tests/test_serve.py.  The load-bearing property is bit-identity:
a request's demuxed stats equal the solo ``simulate_batch`` run of the
same program under the same normalized cfg, per stat including the fault
word — here held against the JAX package's ``simulate_batch`` on the same
seeded bits.  Around it: strict faults stay on the offending handle,
cancellation and deadlines act at batch boundaries, admission control is
synchronous, shutdown drains or cancels, many submitter threads share one
service, and ``stats()`` carries the JAX service's keys with its
timing-free counts.  The services run on the CPU (``devices=['cpu']``);
``ExecutionService()`` names the card and raises without one.  Every
service is a context manager or shut down with a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu.models import (active_reset,
                                              make_default_qchip,
                                              rb_ensemble)
from distributed_processor_tpu.pipeline import compile_to_machine
from distributed_processor_tpu.serve import \
    ExecutionService as JService
from distributed_processor_tpu.sim.interpreter import (
    FaultError as JFaultError, InterpreterConfig as JCfg,
    is_infrastructure_error as j_is_infra, simulate_batch as j_simulate)

from distributed_processor_tpu_torch import isa
from distributed_processor_tpu_torch.decoder import stack_machine_programs
from distributed_processor_tpu_torch.integrity import IntegrityError
from distributed_processor_tpu_torch.serve import (
    CancelledError, ChaosError, Coalescer, DeadlineError, ExecutionService,
    ExecutorLostError, OverloadError, QueueFullError, QuotaExceededError,
    ServiceClosedError, ShutdownError, bucket_key)
from distributed_processor_tpu_torch.serve.request import Request
from distributed_processor_tpu_torch.sim.interpreter import (
    FaultError, InterpreterConfig, is_infrastructure_error)
from distributed_processor_tpu_torch.utils import profiling as t_profiling

from test_torch_interpreter import _to_port

CPU = ['cpu']
T = 120          # every result / join / shutdown waits at most this long


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    """The port's registry, restored around every test as
    tests/conftest.py restores the JAX package's."""
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def ensemble(n_qubits, depth, n_seqs, seed):
    """Active reset + random RB sequences compiled by the JAX package:
    ``(jax programs, port programs)``."""
    qubits = [f'Q{i}' for i in range(n_qubits)]
    qchip = make_default_qchip(n_qubits)
    mps = [compile_to_machine(active_reset(qubits) + prog, qchip,
                              n_qubits=n_qubits)
           for prog in rb_ensemble(qubits, depth, n_seqs, seed=seed)]
    return mps, [_to_port(mp) for mp in mps]


def cfg_kw(mps, **kw):
    """The bucket's budget for a list of programs, as keywords both
    packages' ``InterpreterConfig`` take."""
    bucket = max(isa.shape_bucket(mp.n_instr) for mp in mps)
    base = dict(max_steps=2 * bucket + 64, max_pulses=bucket + 2,
                max_meas=2, max_resets=2)
    base.update(kw)
    return base


def jax_solo(mp_j, bits, kw, init_regs=None):
    """The JAX package's solo run, as host arrays."""
    out = j_simulate(mp_j, bits, init_regs=init_regs, cfg=JCfg(**kw))
    return {k: np.asarray(v) for k, v in out.items()}


def assert_same(got, want, label=''):
    """Every key equal in value and dtype."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (label, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f'{label}:{k}')


def loop_mp(iters=1000):
    """A counted loop that exhausts any small step budget (traps):
    ``(jax program, port program)``."""
    core = [jisa.alu_cmd('reg_alu', 'i', iters, 'id0', write_reg_addr=0),
            jisa.pulse_cmd(amp_word=1000, cfg_word=0, env_word=3,
                           cmd_time=10),
            jisa.alu_cmd('reg_alu', 'i', -1, 'add', 0, write_reg_addr=0),
            jisa.alu_cmd('jump_cond', 'i', 0, 'le', 0, jump_cmd_ptr=1),
            jisa.done_cmd()]
    mp = j_from_cmds([core])
    return mp, _to_port(mp)


def clean_mp(salt=0):
    """A branch-free single-core program in loop_mp's shape bucket."""
    core = [jisa.pulse_cmd(amp_word=1000 + 7 * salt + 13 * i, cfg_word=0,
                           env_word=3, cmd_time=10 + 20 * i)
            for i in range(3)] + [jisa.done_cmd()]
    mp = j_from_cmds([core])
    return mp, _to_port(mp)


def timing_free(st: dict) -> dict:
    """The counts of a ``stats()`` snapshot that do not depend on timing."""
    keys = ('submitted', 'completed', 'failed', 'expired', 'rejected',
            'dispatches', 'programs_dispatched', 'batch_occupancy',
            'engine_dispatches', 'n_devices', 'work_stealing', 'steals',
            'warmups', 'retries', 'retry_exhausted', 'shed',
            'overload_rejected', 'queue_depth', 'parked')
    out = {k: st[k] for k in keys}
    out['compile'] = {k: st['compile'][k] for k in ('cold', 'warm')}
    out['per_bucket'] = {b: (v['cold'], v['warm'])
                         for b, v in st['compile']['per_bucket'].items()}
    out['tenants'] = {t: {k: v for k, v in row.items()
                          if k not in ('device_ms', 'compile_ms')}
                      for t, row in st['tenants'].items()}
    out['streaming'] = {k: v for k, v in st['streaming'].items()
                        if k != 'rounds_in_flight'}
    out['calibration'] = dict(st['calibration'])
    return out


def assert_stats_match(st_t: dict, st_j: dict):
    """The same keys as the JAX service's ``stats()``, and the same
    timing-free counts (the device rows differ only in their label)."""
    assert set(st_t) == set(st_j), set(st_t) ^ set(st_j)
    assert set(st_t['devices'][0]) == set(st_j['devices'][0])
    assert timing_free(st_t) == timing_free(st_j)


# ---------------------------------------------------------------------------
# the fault taxonomy and the card default
# ---------------------------------------------------------------------------

def test_is_infrastructure_error_matches_jax():
    """The retry classifier of both packages agrees on every exception
    class the service meets, the port's torch-side ones included."""
    from distributed_processor_tpu_torch.decoder import \
        ProgramValidationError
    assert not j_is_infra(JFaultError(np.zeros(8)))
    excs = [FaultError(np.zeros(8)), ValueError('v'), TypeError('t'),
            KeyError('k'),
            IndexError('i'), AssertionError('a'),
            NotImplementedError('n'),
            ProgramValidationError([('E', 0, 1, 'bad')]),
            QuotaExceededError('q'), RuntimeError('r'), OSError('o'),
            MemoryError(), ChaosError('c'), IntegrityError('s'),
            ExecutorLostError('l'), OverloadError('o'), DeadlineError('d'),
            CancelledError('x'), ShutdownError('s')]
    for exc in excs[1:]:
        assert is_infrastructure_error(exc) == j_is_infra(exc), exc
    assert not is_infrastructure_error(FaultError(np.zeros(8)))
    assert is_infrastructure_error(RuntimeError('CUDA error'))


def test_service_defaults_to_cuda():
    """``ExecutionService()`` runs on the card: without CUDA it raises
    and starts no thread."""
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match='CUDA'):
        ExecutionService()
    with pytest.raises(RuntimeError, match='CUDA'):
        ExecutionService(devices=['cuda'])
    leaked = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith('dproc-serve') for n in leaked)


# ---------------------------------------------------------------------------
# the service: bit-identity through coalesced dispatch
# ---------------------------------------------------------------------------

def test_service_bit_identity_mixed_buckets_and_shots():
    """Unequal shot counts and two shape buckets coalesce into per-bucket
    batches; every demuxed result equals JAX's solo run."""
    small_j, small = ensemble(2, 2, 3, seed=8)
    big_j, big = ensemble(2, 12, 2, seed=9)
    kw_s, kw_b = cfg_kw(small), cfg_kw(big)
    assert isa.shape_bucket(small[0].n_instr) \
        != isa.shape_bucket(big[0].n_instr)
    rng = np.random.default_rng(3)
    reqs = [(mj, mp, kw_s, rng.integers(0, 2, (4 + 3 * i, mp.n_cores, 2))
             .astype(np.int32))
            for i, (mj, mp) in enumerate(zip(small_j, small))]
    reqs += [(mj, mp, kw_b, rng.integers(0, 2, (6, mp.n_cores, 2))
              .astype(np.int32)) for mj, mp in zip(big_j, big)]
    with ExecutionService(max_batch_programs=8, max_wait_ms=25.0,
                          devices=CPU) as svc:
        handles = [svc.submit(mp, bits, cfg=InterpreterConfig(**kw))
                   for _, mp, kw, bits in reqs]
        results = [h.result(timeout=T) for h in handles]
        stats = svc.stats()
    assert stats['completed'] == len(reqs)
    assert stats['dispatches'] >= 2
    assert stats['queue_depth'] == 0
    assert sum(n * c for n, c in stats['batch_occupancy'].items()) \
        == len(reqs)
    for (mj, _, kw, bits), got in zip(reqs, results):
        assert_same(got, jax_solo(mj, bits, kw), 'serve')


def test_service_init_regs_and_shots_only():
    mps_j, mps = ensemble(2, 2, 2, seed=10)
    kw = cfg_kw(mps)
    regs = np.arange(mps[0].n_cores * isa.N_REGS, dtype=np.int32) \
        .reshape(mps[0].n_cores, isa.N_REGS) % 7
    with ExecutionService(InterpreterConfig(**kw), max_batch_programs=2,
                          max_wait_ms=25.0, devices=CPU) as svc:
        h0 = svc.submit(mps[0], shots=4, init_regs=regs)
        h1 = svc.submit(mps[1], shots=4)
        r0, r1 = h0.result(timeout=T), h1.result(timeout=T)
    zeros = np.zeros((4, mps[0].n_cores, kw['max_meas']), np.int32)
    assert_same(r0, jax_solo(mps_j[0], zeros, kw, init_regs=regs), 'regs')
    assert_same(r1, jax_solo(mps_j[1], zeros, kw), 'zero-bits')


def test_strict_fault_isolation_and_stats_match_jax():
    """One coalesced batch: a strict faulting request raises on ITS
    handle only (the JAX package's FaultError counts), the count-mode
    faulting mate reports in-band, the clean mates are fulfilled equal to
    JAX's solo run; the same submissions to a JAX service give the same
    ``stats()`` keys and timing-free counts."""
    (fs_j, fs), (fc_j, fc) = loop_mp(), loop_mp()
    (ca_j, ca), (cb_j, cb) = clean_mp(), clean_mp(1)
    kw = dict(max_steps=6, max_pulses=8, max_meas=2)
    bits = np.zeros((4, 1, 2), np.int32)
    outs, stats = {}, {}
    for pkg, Svc, Cfg, progs in (
            ('port', ExecutionService, InterpreterConfig, (fs, fc, ca, cb)),
            ('jax', JService, JCfg, (fs_j, fc_j, ca_j, cb_j))):
        extra = dict(devices=CPU) if pkg == 'port' else {}
        with Svc(Cfg(**kw), max_batch_programs=4, max_wait_ms=50.0,
                 **extra) as svc:
            hs = svc.submit(progs[0], bits, fault_mode='strict')
            others = [svc.submit(p, bits) for p in progs[1:]]
            with pytest.raises((FaultError, JFaultError)) as ei:
                hs.result(timeout=T)
            outs[pkg] = ([h.result(timeout=T) for h in others],
                         np.asarray(ei.value.counts))
            stats[pkg] = svc.stats()
    (out_c, out_1, out_2), counts = outs['port']
    assert isinstance(ei.value, JFaultError)          # the last was JAX's
    np.testing.assert_array_equal(counts, outs['jax'][1])
    assert counts[0] == 4                             # budget_exhausted x4
    assert stats['port']['dispatches'] == 1
    assert stats['port']['batch_occupancy'] == {4: 1}
    assert stats['port']['completed'] == 3 and stats['port']['failed'] == 1
    assert np.asarray(out_c['fault']).all()
    for got, want in zip(outs['port'][0], outs['jax'][0]):
        assert_same(got, {k: np.asarray(v) for k, v in want.items()})
    assert_same(out_1, jax_solo(ca_j, bits, kw), 'clean-mate')
    assert not np.asarray(out_2['fault']).any()
    assert_stats_match(stats['port'], stats['jax'])


def test_cancel_timeout_deadline():
    mps_j, mps = ensemble(2, 2, 3, seed=11)
    kw = cfg_kw(mps)
    bits = np.zeros((2, mps[0].n_cores, kw['max_meas']), np.int32)
    with ExecutionService(InterpreterConfig(**kw), max_batch_programs=64,
                          max_wait_ms=60_000.0, devices=CPU) as svc:
        h_cancel = svc.submit(mps[0], bits)
        h_wait = svc.submit(mps[1], bits)
        h_dead = svc.submit(mps[2], bits, deadline_ms=80.0)
        assert h_cancel.cancel()
        assert h_cancel.cancelled() and h_cancel.done()
        with pytest.raises(CancelledError):
            h_cancel.result(timeout=T)
        assert not h_cancel.cancel()
        with pytest.raises(TimeoutError):
            h_wait.result(timeout=0.05)
        with pytest.raises(DeadlineError):
            h_dead.result(timeout=30)
        assert h_wait.cancel()
        svc.shutdown(drain=False, timeout=T)
    final = svc.stats()
    assert final['expired'] == 1
    assert final['cancelled'] >= 1
    assert final['completed'] == 0


def test_queue_full_admission_then_drain():
    mps_j, mps = ensemble(2, 2, 3, seed=12)
    kw = cfg_kw(mps)
    bits = np.zeros((2, mps[0].n_cores, kw['max_meas']), np.int32)
    svc = ExecutionService(InterpreterConfig(**kw), max_batch_programs=64,
                           max_wait_ms=60_000.0, max_queue=2, devices=CPU)
    try:
        h0 = svc.submit(mps[0], bits)
        h1 = svc.submit(mps[1], bits)
        with pytest.raises(QueueFullError):
            svc.submit(mps[2], bits)
        svc.shutdown(drain=True, timeout=T)
        assert_same(h0.result(timeout=T), jax_solo(mps_j[0], bits, kw))
        assert_same(h1.result(timeout=T), jax_solo(mps_j[1], bits, kw))
        stats = svc.stats()
        assert stats['rejected'] == 1 and stats['completed'] == 2
        with pytest.raises(ServiceClosedError):
            svc.submit(mps[0], bits)
    finally:
        svc.shutdown(timeout=T)


def test_shutdown_drain_under_load():
    mps_j, mps = ensemble(2, 2, 6, seed=13)
    kw = cfg_kw(mps)
    bits = np.zeros((3, mps[0].n_cores, kw['max_meas']), np.int32)
    svc = ExecutionService(InterpreterConfig(**kw), max_batch_programs=3,
                           max_wait_ms=5.0, devices=CPU)
    handles = [svc.submit(mp, bits) for mp in mps]
    svc.shutdown(drain=True, timeout=T)
    for mj, h in zip(mps_j, handles):
        assert h.done()
        assert_same(h.result(timeout=T), jax_solo(mj, bits, kw), 'drain')
    assert svc.stats()['completed'] == len(mps)
    assert not any(t.name.startswith('dproc-serve') and t.is_alive()
                   for t in threading.enumerate())


def test_submit_rejects_unservable_cfgs():
    """Every refusal raises the JAX service's type, message and all."""
    mps_j, mps = ensemble(2, 2, 1, seed=14)
    bads = (dict(engine='straightline'), dict(engine='block'),
            dict(straightline=True), dict(opcode_histogram=True),
            dict(fault_mode='loud'), dict(cores_axis='cores'))
    with ExecutionService(max_wait_ms=1.0, devices=CPU) as svc, \
            JService(max_wait_ms=1.0) as jsvc:
        for bad in bads:
            with pytest.raises(ValueError) as e_t:
                svc.submit(mps[0], shots=2, cfg=InterpreterConfig(
                    max_steps=64, max_meas=2, **bad))
            with pytest.raises(ValueError) as e_j:
                jsvc.submit(mps_j[0], shots=2, cfg=JCfg(
                    max_steps=64, max_meas=2, **bad))
            assert str(e_t.value) == str(e_j.value)
        cases = [((), {}), ((), {'shots': 0}),
                 ((np.zeros((2, 5, 2), np.int32),), {}),
                 ((np.zeros((2, 2, 2), np.int32),), {'shots': 3}),
                 ((), {'shots': 2, 'init_regs': np.zeros((3, 3))})]
        for args, kwargs in cases:
            with pytest.raises(ValueError) as e_t:
                svc.submit(mps[0], *args, **kwargs)
            with pytest.raises(ValueError) as e_j:
                jsvc.submit(mps_j[0], *args, **kwargs)
            assert str(e_t.value) == str(e_j.value)
    for kw in (dict(max_batch_programs=0), dict(max_queue=0),
               dict(singleton_engine='fused'),
               dict(singleton_engine='nope'), dict(hang_timeout_s=0),
               dict(trace_sample=2.0), dict(audit_mode='loud'),
               dict(devices=True), dict(devices=[])):
        with pytest.raises(ValueError) as e_t:
            ExecutionService(**{'devices': CPU, **kw})
        with pytest.raises(ValueError) as e_j:
            JService(**kw)
        assert str(e_t.value).replace('torch devices', 'jax devices') \
            == str(e_j.value)


def test_coalescer_priority_and_ripening():
    """Batcher unit semantics, no threads, the same as the JAX
    coalescer's on the same requests."""
    _, mp = clean_mp()
    cfg = InterpreterConfig(max_steps=64, max_meas=2)
    key = bucket_key(mp, cfg)
    bits = np.zeros((2, 1, 2), np.int32)

    def req(seq, priority=0, deadline=None):
        return Request(mp=mp, meas_bits=bits, init_regs=None, cfg=cfg,
                       strict=False, n_shots=2, priority=priority,
                       deadline=deadline, seq=seq)

    co = Coalescer(max_batch_programs=2, max_wait_s=60.0)
    for r in (req(0), req(1, priority=5), req(2)):
        co.push(key, r)
    assert len(co) == 3
    k, batch, expired = co.pop_batch()
    assert k == key and not expired
    assert [r.seq for r in batch] == [1, 0]
    k2, _, _ = co.pop_batch()
    assert k2 is None and len(co) == 1
    assert 0 < co.next_event() <= 60.0
    k3, batch3, _ = co.pop_batch(now=time.monotonic() + 61.0)
    assert k3 == key and [r.seq for r in batch3] == [2]
    dead = req(3, deadline=time.monotonic() - 1.0)
    co.push(key, dead)
    k4, _, expired4 = co.pop_batch()
    assert k4 is None and expired4 == [dead]
    with pytest.raises(DeadlineError):
        dead.handle.result(timeout=T)


def test_bucket_key_matches_jax():
    """The coalescing key of both packages agrees on cores, instruction
    bucket, geometry, cfg fields and traits, and round-trips JSON."""
    from distributed_processor_tpu.serve import bucket_key as j_key
    from distributed_processor_tpu_torch.serve import BucketSpec
    mps_j, mps = ensemble(2, 2, 2, seed=16)
    kw = cfg_kw(mps)
    for mj, mp in zip(mps_j, mps):
        kt = bucket_key(mp, InterpreterConfig(**kw))
        kj = j_key(mj, JCfg(**kw))
        doc_t, doc_j = kt.bind(n_programs=4, n_shots=8).to_json(), \
            kj.bind(n_programs=4, n_shots=8).to_json()
        assert doc_t == doc_j
        assert BucketSpec.from_json(doc_t).identity() \
            == kt.bind(n_programs=4, n_shots=8).identity()
        assert kt.label() == kj.label()


def test_concurrent_submitter_stress():
    """6 submitter threads x 4 requests each against one service, with a
    short switch interval: every result equal to JAX's solo run, and
    the counters consistent."""
    import sys
    mps_j, mps = ensemble(2, 2, 3, seed=15)
    kw = cfg_kw(mps)
    rng = np.random.default_rng(4)
    n_threads, per_thread = 6, 4
    jobs = [[(int(rng.integers(len(mps))),
              rng.integers(0, 2, (int(rng.integers(2, 6)),
                                  mps[0].n_cores, 2)).astype(np.int32))
             for _ in range(per_thread)] for _ in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ExecutionService(InterpreterConfig(**kw), max_batch_programs=8,
                              max_wait_ms=5.0, max_queue=512,
                              devices=CPU) as svc:
            def worker(tid):
                try:
                    hs = [svc.submit(mps[i], bits) for i, bits in jobs[tid]]
                    for j, h in enumerate(hs):
                        results[tid][j] = h.result(timeout=T)
                except Exception as e:      # pragma: no cover - surfaced
                    errors.append((tid, e))
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
            assert not any(t.is_alive() for t in threads)
            stats = svc.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    n = n_threads * per_thread
    assert stats['submitted'] == stats['completed'] == n
    assert stats['latency_samples'] == n
    assert stats['tenants']['default']['shots'] == sum(
        b.shape[0] for job in jobs for _, b in job)
    for tid in range(n_threads):
        for (i, bits), got in zip(jobs[tid], results[tid]):
            assert_same(got, jax_solo(mps_j[i], bits, kw), f't{tid}')


def test_single_device_stats_surface():
    """One executor: the stats surface of the JAX service (one device
    row, zero steals, the cold/warm classification), labelled with the
    executor's torch device."""
    mps_j, mps = ensemble(2, 2, 1, seed=21)
    kw = cfg_kw(mps)
    bits = np.zeros((2, mps[0].n_cores, 2), np.int32)
    stats = {}
    for pkg, Svc, Cfg, mp in (('port', ExecutionService, InterpreterConfig,
                               mps[0]),
                              ('jax', JService, JCfg, mps_j[0])):
        extra = dict(devices=CPU) if pkg == 'port' else {}
        with Svc(Cfg(**kw), max_batch_programs=4, max_wait_ms=2.0,
                 **extra) as svc:
            svc.submit(mp, bits).result(timeout=T)
            svc.submit(mp, bits).result(timeout=T)
            stats[pkg] = svc.stats()
    st = stats['port']
    assert st['n_devices'] == 1 and st['work_stealing'] is False
    dev = st['devices'][0]
    assert dev['device'] == 'cpu' and dev['home_buckets'] == 1
    assert dev['dispatches'] == st['dispatches'] == 2
    assert st['compile']['cold'] == 1 and st['compile']['warm'] == 1
    assert_stats_match(st, stats['jax'])


def test_singleton_engines_match_jax():
    """``singleton_engine=``: a one-program batch rides the engine
    ladder (the straight-line engine, K1 span's plain version under
    'pallas' on the CPU, the block engine) and equals JAX's run of that
    engine; the engine counts land in ``stats()``."""
    mps_j, mps = ensemble(2, 2, 1, seed=17)
    kw = cfg_kw(mps)
    bits = np.random.default_rng(5).integers(
        0, 2, (6, mps[0].n_cores, 2)).astype(np.int32)
    for eng in ('straightline', 'pallas', 'block', 'auto'):
        with ExecutionService(InterpreterConfig(**kw), devices=CPU,
                              singleton_engine=eng, max_batch_programs=1,
                              max_wait_ms=1.0) as svc:
            got = svc.submit(mps[0], bits).result(timeout=T)
            st = svc.stats()
        want = j_simulate(mps_j[0], bits, cfg=JCfg(
            engine=eng, pallas_interpret=True, **kw))
        want = {k: np.asarray(v) for k, v in want.items()}
        for k in want:
            if k != 'steps':      # the engines count steps their own way
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ran = 'straightline' if eng == 'auto' else eng
        assert st['engine_dispatches'] == {ran: 1}, st['engine_dispatches']


def test_audit_catches_corruption_strict():
    """``audit_sample=1`` re-executes every batch on another engine: a
    flipped bit fails the batch typed (IntegrityError, infrastructure
    class: retried) under ``audit_mode='strict'``, and the retry
    delivers JAX's bits."""
    from distributed_processor_tpu_torch.serve import ChaosMonkey, ChaosPlan
    from distributed_processor_tpu_torch.serve import RetryPolicy
    mps_j, mps = ensemble(2, 2, 1, seed=18)
    kw = cfg_kw(mps)
    bits = np.zeros((3, mps[0].n_cores, 2), np.int32)
    with ExecutionService(InterpreterConfig(**kw), devices=CPU,
                          audit_sample=1.0, audit_mode='strict',
                          max_batch_programs=1, max_wait_ms=1.0,
                          retry_policy=RetryPolicy(max_attempts=3,
                                                   backoff_s=0.001)) as svc:
        with ChaosMonkey(svc, ChaosPlan(script=('corrupt',))) as monkey:
            got = svc.submit(mps[0], bits).result(timeout=T)
        assert monkey.injected['corrupt'] == 1
        st = svc.stats()
    assert st['integrity']['audits'] == 2
    assert st['integrity']['mismatches'] == 1
    assert st['retries'] == 1
    assert_same(got, jax_solo(mps_j[0], bits, kw))


def test_stacked_batch_equals_solo():
    """The multi path the service dispatches: stacked programs demuxed
    per request equal JAX's solo runs (the padding rows inert)."""
    from distributed_processor_tpu_torch.sim.interpreter import (
        demux_multi_batch, simulate_multi_batch)
    mps_j, mps = ensemble(2, 2, 3, seed=19)
    kw = cfg_kw(mps)
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (4, 5, mps[0].n_cores, 2)).astype(np.int32)
    mmp = stack_machine_programs(mps + mps[-1:])
    out = simulate_multi_batch(mmp, bits, cfg=InterpreterConfig(**kw),
                               device='cpu')
    host = {k: v.numpy() for k, v in out.items()}
    for i, mj in enumerate(mps_j):
        assert_same(demux_multi_batch(host, i), jax_solo(mj, bits[i], kw))


def test_kernel_build_once_and_exact_launch_counts(monkeypatch, tmp_path):
    """Concurrent first use of a kernel builds its source once (a stubbed
    ``nvcc``), and launch counts taken from many threads under a short
    switch interval lose no increment."""
    import sys
    from distributed_processor_tpu_torch.ops import _cuda
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    builds = []

    def slow_build(name, verbose=False):
        builds.append(name)
        time.sleep(0.05)
        return str(tmp_path / f'{name}.so')

    monkeypatch.setattr(_cuda, 'build', slow_build)
    monkeypatch.setattr(_cuda.ctypes, 'CDLL', lambda path: ('lib', path))
    monkeypatch.setattr(_cuda, '_LIBS', {})
    gate = threading.Barrier(8)
    libs = []

    def first_use():
        gate.wait(T)
        libs.append(_cuda.load('exec_span'))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)
    assert builds == ['exec_span'] and len(set(libs)) == 1 and len(libs) == 8

    old_count, old_si = exec_span.launches, sys.getswitchinterval()
    exec_span.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        def launches():
            for _ in range(2000):
                _cuda.count_launch(exec_span)
        threads = [threading.Thread(target=launches) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        assert not any(t.is_alive() for t in threads)
        assert exec_span.launches == 8 * 2000
    finally:
        sys.setswitchinterval(old_si)
        exec_span.launches = old_count
