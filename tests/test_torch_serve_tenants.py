"""The port's tenant isolation fabric against the JAX package's.

Mirrors the in-process cases of tests/test_tenants.py: deficit
round-robin fair queueing (each claim order equal to the JAX coalescer's
on the same requests), the shed selector and its exemptions, typed
non-retryable quotas (max queued, the shots token bucket, the compile
token bucket), billing-grade metering (exact against ground truth, and
exactly once under chaos retries), stream chunks billed to their
session's tenant, and a greedy tenant that can neither starve nor shed a
victim.  Services run on the CPU.
"""

import numpy as np
import pytest

from distributed_processor_tpu.serve import Coalescer as JCoalescer
from distributed_processor_tpu.serve.batcher import \
    shed_exempt as j_shed_exempt
from distributed_processor_tpu.serve import ExecutionService as JService
from distributed_processor_tpu.serve.request import (
    QuotaExceededError as JQuotaExceededError, Request as JRequest,
    RequestHandle as JHandle)
from distributed_processor_tpu.sim.interpreter import InterpreterConfig \
    as JCfg

from distributed_processor_tpu_torch.serve import (ChaosMonkey, ChaosPlan,
                                                   Coalescer,
                                                   ExecutionService,
                                                   OverloadError,
                                                   RetryPolicy, tenant_soak)
from distributed_processor_tpu_torch.serve.batcher import shed_exempt
from distributed_processor_tpu_torch.serve.request import (
    QuotaExceededError, Request, RequestHandle)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, is_infrastructure_error)
from distributed_processor_tpu_torch.utils import profiling

from test_torch_serve import (T, assert_same, assert_stats_match,
                              clean_mp, jax_solo)

CPU = ['cpu']
_KW = dict(max_steps=2 * 8 + 64, max_pulses=8 + 2, max_meas=2,
           max_resets=2)
_CFG = InterpreterConfig(**_KW)


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = profiling.registry_snapshot()
    yield
    profiling.registry_restore(snap)


def _mp(salt=0):
    return clean_mp(salt)[1]


def _bits(rng, shots=3):
    return rng.integers(0, 2, size=(shots, 1, 2)).astype(np.int32)


def _req(pkg, seq, tenant='default', priority=0, rounds=None, sid=None):
    R, H = (Request, RequestHandle) if pkg == 'port' \
        else (JRequest, JHandle)
    return R(mp=None, meas_bits=None, init_regs=None, cfg=None,
             strict=False, n_shots=3, priority=priority, deadline=None,
             seq=seq, handle=H(), rounds=rounds, sid=sid, tenant=tenant)


def _both(make_queue, fill, n_pops):
    """Run the same pushes and pops through the port's coalescer and the
    JAX package's; returns the port's batches after asserting that both
    claimed the same requests in the same order."""
    orders = {}
    for pkg, cls in (('port', Coalescer), ('jax', JCoalescer)):
        q = make_queue(cls)
        fill(q, lambda *a, **k: _req(pkg, *a, **k))
        batches = []
        for _ in range(n_pops):
            if not len(q):
                break
            _, batch, _ = q.pop_batch(flush=True)
            batches.append([(r.seq, r.tenant) for r in batch])
        orders[pkg] = batches
    assert orders['port'] == orders['jax']
    return orders['port']


def test_drr_interleaves_tenants_against_fifo():
    key = ('b',)

    def fill(q, req):
        for seq in range(12):
            q.push(key, req(seq, tenant='greedy'))
        q.push(key, req(100, tenant='victim'))
        q.push(key, req(101, tenant='victim'))

    batches = _both(lambda cls: cls(
        max_batch_programs=4, max_wait_s=0.0,
        tenant_weights={'greedy': 1.0, 'victim': 1.0}), fill, 1)
    tenants = [t for _, t in batches[0]]
    assert 'victim' in tenants
    greedy = [s for s, t in batches[0] if t == 'greedy']
    assert greedy == sorted(greedy)


def test_drr_weights_shape_throughput():
    key = ('b',)

    def fill(q, req):
        for seq in range(40):
            q.push(key, req(seq, tenant='heavy'))
            q.push(key, req(1000 + seq, tenant='light'))

    batches = _both(lambda cls: cls(
        max_batch_programs=4, max_wait_s=0.0,
        tenant_weights={'heavy': 3.0, 'light': 1.0}), fill, 10)
    served = [t for b in batches for _, t in b]
    assert len(served) == 40
    assert served.count('heavy') == pytest.approx(30, abs=3)


def test_drr_single_tenant_reduces_to_legacy_order():
    key = ('b',)

    def fill(q, req):
        for s in range(7):
            q.push(key, req(s, priority=s % 2))

    legacy = _both(lambda cls: cls(max_batch_programs=3, max_wait_s=0.0),
                   fill, 10)
    fair = _both(lambda cls: cls(max_batch_programs=3, max_wait_s=0.0,
                                 tenant_weights={}), fill, 10)
    assert legacy == fair


def test_drr_priority_order_preserved_within_tenant():
    key = ('b',)

    def fill(q, req):
        q.push(key, req(0, tenant='a', priority=0))
        q.push(key, req(1, tenant='a', priority=5))

    batches = _both(lambda cls: cls(max_batch_programs=2, max_wait_s=0.0,
                                    tenant_weights={'a': 1.0}), fill, 1)
    assert [s for s, _ in batches[0]] == [1, 0]


def test_shed_prefers_most_over_quota_tenants_newest():
    picks = {}
    for pkg, cls in (('port', Coalescer), ('jax', JCoalescer)):
        q = cls(max_batch_programs=8, max_wait_s=10.0)
        for seq, t in ((0, 'calm'), (1, 'greedy'), (2, 'greedy')):
            q.push(('b',), _req(pkg, seq, tenant=t))
        _, victim = q.shed_candidate(
            below_priority=1, tenant_pressure={'greedy': 3.0, 'calm': 0.1})
        picks[pkg] = (victim.tenant, victim.seq)
    assert picks['port'] == picks['jax'] == ('greedy', 2)


def test_shed_exempts_stream_chunks_and_internal_work():
    for kw in (dict(rounds=4), dict(sid=7), dict(), dict(seq=-1)):
        seq = kw.pop('seq', 5)
        assert shed_exempt(_req('port', seq, **kw)) \
            == j_shed_exempt(_req('jax', seq, **kw))
    q = Coalescer(max_batch_programs=8, max_wait_s=10.0)
    q.push(('b',), _req('port', 10, tenant='victim', rounds=4, sid=1))
    q.push(('b',), _req('port', -3, tenant='victim'))
    assert q.shed_candidate(below_priority=1,
                            tenant_pressure={'victim': 99.0}) is None
    q.push(('b',), _req('port', 11, tenant='victim'))
    got = q.shed_candidate(below_priority=1,
                           tenant_pressure={'victim': 99.0})
    assert got is not None and got[1].seq == 11


def test_quota_exceeded_is_typed_and_non_retryable():
    """The over-quota submission raises the typed refusal; the same
    submissions to a JAX service give the same timing-free counts."""
    assert not is_infrastructure_error(QuotaExceededError('x'))
    assert not issubclass(QuotaExceededError, OverloadError)
    mp_j, mp = clean_mp()
    stats = {}
    for pkg, Svc, Cfg, prog, Quota in (
            ('port', ExecutionService, InterpreterConfig, mp,
             QuotaExceededError),
            ('jax', JService, JCfg, mp_j, JQuotaExceededError)):
        rng = np.random.default_rng(0)
        extra = dict(devices=CPU) if pkg == 'port' else {}
        with Svc(Cfg(**_KW), max_batch_programs=8, max_wait_ms=1000.0,
                 tenants={'capped': {'max_queued': 1}}, **extra) as svc:
            h1 = svc.submit(prog, _bits(rng), tenant='capped')
            with pytest.raises(Quota):
                svc.submit(prog, _bits(rng), tenant='capped')
            h2 = svc.submit(prog, _bits(rng), tenant='other')
            st = svc.stats()
            assert st['tenants']['capped']['quota_rejected'] == 1
            assert st['tenants']['other']['quota_rejected'] == 0
            if pkg == 'port':
                assert profiling.counter_get(
                    'tenant.capped.quota_rejected') == 1
            h1.result(timeout=T)
            h2.result(timeout=T)
            stats[pkg] = svc.stats()
    assert_stats_match(stats['port'], stats['jax'])


def test_shots_rate_limit_token_bucket():
    rng = np.random.default_rng(1)
    with ExecutionService(_CFG, max_batch_programs=4, max_wait_ms=2.0,
                          tenants={'meter': {'shots_per_s': 1.0,
                                             'shots_burst': 6.0}},
                          devices=CPU) as svc:
        svc.warmup(_mp(), shots=6, n_programs=1)
        svc.submit(_mp(), _bits(rng, 6), tenant='meter').result(timeout=T)
        with pytest.raises(QuotaExceededError):
            svc.submit(_mp(), _bits(rng, 6), tenant='meter')
        svc.submit(_mp(), _bits(rng, 6), tenant='other').result(timeout=T)


def test_compile_submission_rate_limit():
    from distributed_processor_tpu_torch.models import make_default_qchip
    qchip = make_default_qchip(2)
    prog = [{'name': 'X90', 'qubit': ['Q0']}]
    with ExecutionService(_CFG, tenants={'src': {'compiles_per_s': 0.001,
                                                 'compiles_burst': 1.0}},
                          devices=CPU) as svc:
        svc.submit_source(prog, qchip, shots=3, n_qubits=2,
                          tenant='src').result(timeout=T)
        with pytest.raises(QuotaExceededError):
            svc.submit_source(prog, qchip, shots=3, n_qubits=2,
                              tenant='src')
        st = svc.stats()
        assert st['tenants']['src']['quota_rejected'] == 1
        assert st['tenants']['src']['compile_ms'] > 0.0


def test_usage_metering_matches_ground_truth():
    rng = np.random.default_rng(2)
    with ExecutionService(_CFG, max_batch_programs=4, max_wait_ms=2.0,
                          devices=CPU) as svc:
        plan = [('acme', 3), ('acme', 5), ('bob', 2)]
        handles = [svc.submit(_mp(), _bits(rng, n), tenant=t)
                   for t, n in plan]
        for h in handles:
            h.result(timeout=T)
        st = svc.stats()['tenants']
    assert st['acme']['submitted'] == st['acme']['completed'] == 2
    assert st['acme']['shots'] == 8 and st['acme']['queued'] == 0
    assert st['acme']['device_ms'] > 0.0
    assert st['bob']['shots'] == 2
    assert profiling.counter_get('tenant.acme.shots') == 8
    assert profiling.counter_get('tenant.bob.shots') == 2


def test_metering_exactly_once_under_chaos_retries():
    """Scripted crashes force retries: the shots meter equals the ground
    truth exactly, and every delivered result equals JAX's solo run."""
    rng = np.random.default_rng(3)
    mp_j, mp = clean_mp()
    bits = [_bits(rng) for _ in range(12)]
    with ExecutionService(_CFG, max_batch_programs=4, max_wait_ms=2.0,
                          retry_policy=RetryPolicy(max_attempts=6,
                                                   backoff_s=0.005),
                          supervise_interval_ms=10.0, devices=CPU) as svc:
        svc.warmup(mp, shots=3, n_programs=1)
        with ChaosMonkey(svc, ChaosPlan(seed=7, script=('crash',) * 2)) \
                as monkey:
            handles = [svc.submit(mp, b, tenant='acme') for b in bits]
            results = [h.result(timeout=T) for h in handles]
        assert monkey.script_exhausted()
        assert any(h.retries >= 1 for h in handles)
        st = svc.stats()['tenants']['acme']
    assert st['submitted'] == st['completed'] == 12
    assert st['failed'] == 0 and st['queued'] == 0
    assert st['shots'] == 12 * 3
    for b, got in zip(bits, results):
        assert_same(got, jax_solo(mp_j, b, _KW))


def test_stream_chunks_inherit_session_tenant():
    from distributed_processor_tpu_torch.models.qec import (
        qec_config, qec_multiround_machine_program)
    rng = np.random.default_rng(4)
    mp = qec_multiround_machine_program(n_data=3, rounds=1)
    cfg = qec_config(3, record_pulses=False)
    with ExecutionService(devices=CPU) as svc:
        with svc.open_stream(mp, cfg=cfg, tenant='qec-lab') as sess:
            assert sess.tenant == 'qec-lab'
            sess.submit_rounds(rng.integers(
                0, 2, (4, 3, mp.n_cores, cfg.max_meas)).astype(np.int32))
            list(sess.results(timeout=T))
        st = svc.stats()['tenants']
    assert st['qec-lab']['completed'] == 1
    assert st['qec-lab']['shots'] == 4 * 3


def test_greedy_tenant_cannot_starve_or_shed_victim():
    rng = np.random.default_rng(6)
    with ExecutionService(
            _CFG, max_batch_programs=4, max_wait_ms=2.0, max_queue=64,
            tenants={'greedy': {'weight': 1.0, 'max_queued': 16,
                                'shots_per_s': 0.001, 'shots_burst': 36.0},
                     'victim': {'weight': 4.0}}, devices=CPU) as svc:
        svc.warmup(_mp(), shots=3, n_programs=4)
        greedy_handles, greedy_rejects = [], 0
        for _ in range(40):
            try:
                greedy_handles.append(
                    svc.submit(_mp(), _bits(rng), tenant='greedy'))
            except QuotaExceededError:
                greedy_rejects += 1
        victims = [svc.submit(_mp(), _bits(rng), tenant='victim')
                   for _ in range(4)]
        for h in victims:
            h.result(timeout=T)
        for h in greedy_handles:
            try:
                h.result(timeout=T)
            except OverloadError:
                pass
        st = svc.stats()['tenants']
    assert greedy_rejects >= 28 and len(greedy_handles) <= 12
    assert st['victim']['completed'] == 4
    assert st['victim']['shed'] == 0 and st['victim']['quota_rejected'] == 0
    assert st['greedy']['quota_rejected'] == greedy_rejects
    assert st['victim']['shots'] == 4 * 3


def test_tenant_soak_meters_match_ground_truth_under_chaos():
    """``tenant_soak``: a greedy tenant floods while two others trickle,
    under scripted crashes; every completion equals its solo run and the
    billing meters equal the caller-side ledger exactly."""
    mps = [_mp(s) for s in range(3)]
    with ExecutionService(_CFG, max_batch_programs=4, max_wait_ms=2.0,
                          retry_policy=RetryPolicy(max_attempts=6,
                                                   backoff_s=0.005),
                          tenants={'greedy': {'max_queued': 6}},
                          supervise_interval_ms=10.0, devices=CPU) as svc:
        with ChaosMonkey(svc, ChaosPlan(seed=3, script=('crash',) * 2)):
            rep = tenant_soak(svc, mps, _CFG, tenants=['greedy', 'a', 'b'],
                              greedy='greedy', n_requests=36, seed=4,
                              result_timeout_s=T, device='cpu')
    assert rep.hung == 0 and rep.bit_mismatches == 0
    assert rep.meter_mismatches == []
    # typed admission refusals are counted among the terminations
    assert rep.terminated() == rep.submitted + rep.rejected
    assert rep.per_tenant['greedy']['quota_rejected'] == rep.rejected > 0
    assert rep.per_tenant['a']['completed'] \
        == rep.per_tenant['a']['submitted'] > 0
