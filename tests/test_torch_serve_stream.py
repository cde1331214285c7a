"""The port's streaming sessions against the JAX package's.

Mirrors the service cases of tests/test_qec_stream.py: the stream cfg
normalizer (its refusals, word for word JAX's), a session of chunks of
differing round counts (each chunk's result equal on every key to the
JAX package's ``simulate_rounds`` with the decode, the close summary's
full-history decode), a detached chunk and the malformed submissions,
per-round deadlines counted for every round of an expired chunk, the
session TTL sweep, and a chunk that survives two injected crashes with
no lost or duplicated rounds.  CPU only.
"""

import dataclasses
import time

import numpy as np
import pytest

from distributed_processor_tpu.models import qec as jqec
from distributed_processor_tpu.ops import decode as jdec
from distributed_processor_tpu.serve.service import \
    _normalize_stream_cfg as j_normalize_stream_cfg
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_rounds as j_rounds)

from distributed_processor_tpu_torch.models import qec as tqec
from distributed_processor_tpu_torch.ops.decode import (DecodeSpec,
                                                        decode_history)
from distributed_processor_tpu_torch.serve import (ChaosMonkey, ChaosPlan,
                                                   DeadlineError,
                                                   ExecutionService,
                                                   RetryPolicy, StreamKey)
from distributed_processor_tpu_torch.serve.service import \
    _normalize_stream_cfg
from distributed_processor_tpu_torch.sim.interpreter import \
    InterpreterConfig
from distributed_processor_tpu_torch.utils import profiling

from test_torch_interpreter import _to_port
from test_torch_serve import T, assert_same

CPU = ['cpu']


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = profiling.registry_snapshot()
    yield
    profiling.registry_restore(snap)


def _rep(n_data=3):
    """The repetition round in both packages: ``(jax program, port
    program, cfg keywords, port decode spec, jax decode spec)``."""
    mp_j = jqec.qec_round_machine_program(n_data)
    kw = dataclasses.asdict(jqec.qec_config(n_data, record_pulses=False))
    dec = tqec.repetition_decode_spec(n_data)
    return (mp_j, _to_port(mp_j), kw, dec,
            jdec.DecodeSpec(dec.scheme, dec.cores, dec.slot))


def _planes(rng, rounds, shots, mp, kw):
    return rng.integers(0, 2, (rounds, shots, mp.n_cores, kw['max_meas']),
                        dtype=np.int32)


def _jax_rounds(mp_j, mb, kw, jdec_spec):
    out = j_rounds(mp_j, mb, cfg=JCfg(**kw), decode=jdec_spec)
    return {k: np.asarray(v) for k, v in out.items()}


def test_normalize_stream_cfg_policy():
    base = dict(max_steps=80, max_pulses=10, max_meas=2)
    for bad in (dict(engine='fused'), dict(opcode_histogram=True),
                dict(cores_axis='cores'), dict(fault_mode='bogus')):
        with pytest.raises(ValueError) as e_t:
            _normalize_stream_cfg(InterpreterConfig(**base, **bad), 8)
        with pytest.raises(ValueError) as e_j:
            j_normalize_stream_cfg(JCfg(**base, **bad), 8)
        assert str(e_t.value) == str(e_j.value)
    norm, strict = _normalize_stream_cfg(InterpreterConfig(
        **base, engine='block', record_pulses=True, rounds=8,
        fault_mode='strict'), 8)
    assert norm.engine == 'block' and not norm.record_pulses
    assert norm.rounds == 1 and norm.fault_mode == 'count' and strict
    assert dataclasses.asdict(norm) == dataclasses.asdict(
        j_normalize_stream_cfg(JCfg(**base, engine='block',
                                    record_pulses=True, rounds=8,
                                    fault_mode='strict'), 8)[0])
    key = StreamKey(sid=3, n_cores=2, n_instr_bucket=8, cfg=norm)
    assert key.label() == 'stream3c2i8'


def test_stream_session_end_to_end():
    mp_j, mp, kw, dec, jd = _rep(3)
    rng = np.random.default_rng(21)
    chunks = [_planes(rng, r, 4, mp, kw) for r in (2, 3, 4)]
    with ExecutionService(max_wait_ms=2.0, devices=CPU) as svc:
        sess = svc.open_stream(mp, cfg=InterpreterConfig(**kw), decode=dec)
        for mb in chunks:
            sess.submit_rounds(mb)
        results = list(sess.results(timeout=T))
        assert len(results) == len(chunks)
        for i, (mb, got) in enumerate(zip(chunks, results)):
            assert_same(got, _jax_rounds(mp_j, mb, kw, jd), f'chunk {i}')
        summary = sess.close(timeout=T)
        assert (summary['chunks'], summary['rounds'],
                summary['failed_chunks']) == (3, 9, 0)
        hist = np.concatenate(
            [np.asarray(r['syndrome_hist']) for r in results], axis=1)
        np.testing.assert_array_equal(summary['syndrome_hist'], hist)
        np.testing.assert_array_equal(
            summary['decoded'], np.asarray(jdec.decode_history(
                hist, jd.scheme)))
        np.testing.assert_array_equal(
            summary['decoded'], decode_history(hist, dec.scheme).numpy())
        st = svc.stats()['streaming']
        assert st['open_sessions'] == 0 and st['sessions_opened'] == 1
        assert st['rounds_submitted'] == st['rounds_served'] == 9
        assert st['round_deadline_misses'] == 0
        with pytest.raises(RuntimeError, match='closed'):
            sess.submit_rounds(chunks[0])
        with pytest.raises(RuntimeError, match='closed'):
            sess.close()
        with pytest.raises(ValueError, match='not open'):
            svc.submit_rounds(mp, chunks[0], cfg=InterpreterConfig(**kw),
                              stream=sess.sid)
        assert svc.close_stream(sess.sid) is False


def test_submit_rounds_detached_and_rejections():
    mp_j, mp, kw, dec, jd = _rep(3)
    cfg = InterpreterConfig(**kw)
    mb = _planes(np.random.default_rng(22), 3, 4, mp, kw)
    with ExecutionService(max_wait_ms=2.0, devices=CPU) as svc:
        got = svc.submit_rounds(mp, mb, cfg=cfg,
                                decode=dec).result(timeout=T)
        assert_same(got, _jax_rounds(mp_j, mb, kw, jd), 'detached chunk')
        st = svc.stats()
        assert st['streaming']['open_sessions'] == 0
        assert st['engine_dispatches'] == {'generic': 1}
        with pytest.raises(ValueError, match='rounds, n_shots'):
            svc.submit_rounds(mp, mb[0], cfg=cfg)
        with pytest.raises(ValueError, match='not both'):
            svc.submit_rounds(mp, mb, cfg=cfg, deadline_ms=50.0,
                              round_deadline_ms=10.0)
        with pytest.raises(ValueError, match='out of range'):
            svc.submit_rounds(mp, mb, cfg=cfg,
                              decode=DecodeSpec('majority', (99,)))
        with pytest.raises(ValueError, match='not open'):
            svc.submit_rounds(mp, mb, cfg=cfg, stream=424242)


def test_stream_chunk_on_the_span_rung():
    """A chunk on ``engine='pallas'`` (K1 span on the card, its plain
    version here): every key but ``steps`` equal to JAX's run of the
    Pallas engine in interpret mode, with the decode."""
    mp_j, mp, kw, dec, jd = _rep(3)
    mb = _planes(np.random.default_rng(26), 4, 3, mp, kw)
    with ExecutionService(max_wait_ms=2.0, devices=CPU) as svc:
        got = svc.submit_rounds(
            mp, mb, cfg=InterpreterConfig(**dict(kw, engine='pallas')),
            decode=dec).result(timeout=T)
        assert svc.stats()['engine_dispatches'] == {'pallas': 1}
    want = _jax_rounds(mp_j, mb, dict(kw, engine='pallas',
                                      pallas_interpret=True), jd)
    assert_same({k: v for k, v in got.items() if k != 'steps'},
                {k: v for k, v in want.items() if k != 'steps'}, 'span')


def test_stream_round_deadline_miss_counts_every_round():
    mp_j, mp, kw, dec, jd = _rep(3)
    mb = _planes(np.random.default_rng(23), 4, 3, mp, kw)
    with ExecutionService(max_batch_programs=64, max_wait_ms=60_000.0,
                          devices=CPU) as svc:
        sess = svc.open_stream(mp, cfg=InterpreterConfig(**kw), decode=dec,
                               round_deadline_ms=15.0)
        h = sess.submit_rounds(mb)
        with pytest.raises(DeadlineError):
            h.result(timeout=60.0)
        summary = sess.close(timeout=60.0)
        assert summary['failed_chunks'] == 1
        assert isinstance(summary['errors'][0], DeadlineError)
        st = svc.stats()['streaming']
        assert st['round_deadline_misses'] == mb.shape[0]
        assert st['rounds_served'] == 0


def test_stream_session_ttl_expiry():
    mp_j, mp, kw, dec, jd = _rep(3)
    rng = np.random.default_rng(24)
    with ExecutionService(max_wait_ms=2.0, supervise_interval_ms=10.0,
                          session_ttl_s=0.05, devices=CPU) as svc:
        sess = svc.open_stream(mp, cfg=InterpreterConfig(**kw), decode=dec)
        deadline = time.monotonic() + 30.0
        while svc.stats()['streaming']['sessions_expired'] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        st = svc.stats()['streaming']
        assert st['sessions_expired'] == 1 and st['open_sessions'] == 0
        events = svc.flight_recorder.events(kind='session_expired')
        assert events and events[-1]['sid'] == sess.sid
        with pytest.raises(ValueError, match='not open'):
            sess.submit_rounds(_planes(rng, 2, 3, mp, kw))


def test_stream_chunk_survives_chaos_crashes():
    mp_j, mp, kw, dec, jd = _rep(3)
    rng = np.random.default_rng(25)
    chunks = [_planes(rng, r, 3, mp, kw) for r in (3, 2)]
    with ExecutionService(max_wait_ms=2.0, max_queue=1024,
                          retry_policy=RetryPolicy(max_attempts=6,
                                                   backoff_s=0.005),
                          breaker_threshold=2, breaker_cooldown_ms=60.0,
                          supervise_interval_ms=10.0, devices=CPU) as svc:
        sess = svc.open_stream(mp, cfg=InterpreterConfig(**kw), decode=dec)
        with ChaosMonkey(svc, ChaosPlan(seed=0, script=('crash', 'crash'))) \
                as monkey:
            h = sess.submit_rounds(chunks[0])
            got = h.result(timeout=T)
        assert monkey.script_exhausted()
        assert h.retries == 2
        assert_same(got, _jax_rounds(mp_j, chunks[0], kw, jd), 'healed')
        sess.submit_rounds(chunks[1])
        summary = sess.close(timeout=T)
        assert summary['failed_chunks'] == 0 and summary['rounds'] == 5
        assert summary['decoded'].shape == (3, 3)
        assert svc.stats()['streaming']['rounds_served'] == 5
