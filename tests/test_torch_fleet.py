"""The port's fleet tier (``serve/{transport,router,fleet}.py``) against
the JAX package.

Mirrors tests/test_fleet.py.  The router-only cases need no replica
process; the rest share one module-scoped ``Fleet`` of two replica
processes on the CPU (``service={'devices': ['cpu']}``, one intra-op
thread each).  The load-bearing property is bit-identity across the
wire: a result served by a replica process equals the JAX package's
``simulate_batch`` on the same bits, on every key, also across a
SIGKILL and a SIGSTOP of the loaded replica; a strict ``FaultError``
crosses the wire with the JAX package's counts and is never retried.
Every fixture shuts its fleet down in a finalizer, and every result and
ready wait has a timeout.
"""

import pickle
import socket
import time

import numpy as np
import pytest

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu.serve.benchmark import _workload as j_workload
from distributed_processor_tpu.sim.interpreter import (
    FaultError as JFaultError, InterpreterConfig as JCfg,
    simulate_batch as j_simulate)

from distributed_processor_tpu_torch.decoder import ProgramValidationError
from distributed_processor_tpu_torch.serve import (CancelledError,
                                                   DeadlineError,
                                                   ExecutorLostError,
                                                   FleetRouter,
                                                   OverloadError,
                                                   ReplicaLostError,
                                                   RetryPolicy,
                                                   ServiceClosedError,
                                                   ShutdownError,
                                                   is_terminal_error)
from distributed_processor_tpu_torch.serve.benchmark import _workload
from distributed_processor_tpu_torch.serve.fleet import Fleet
from distributed_processor_tpu_torch.serve.transport import \
    _picklable_error
from distributed_processor_tpu_torch.sim.interpreter import (
    FaultError, InterpreterConfig)

from test_torch_interpreter import _to_port

pytestmark = [pytest.mark.serve, pytest.mark.fleet]

T = 120          # every result / ready wait is bounded


@pytest.fixture(autouse=True)
def _serve_thread_leak_probe():
    """The module-scoped fleet keeps router and wire threads alive
    across tests by design: the leak boundary is the module's end."""
    yield


@pytest.fixture(autouse=True, scope='module')
def _fleet_thread_boundary():
    """After the module's fleet shuts down, every dproc-serve* thread is
    joined (prints the junit-gated marker otherwise)."""
    import threading
    yield
    deadline = time.monotonic() + 10.0
    leaked = []
    while time.monotonic() < deadline:
        leaked = sorted(t.name for t in threading.enumerate()
                        if t.name.startswith('dproc-serve')
                        and t.is_alive())
        if not leaked:
            return
        time.sleep(0.05)
    print(f'SERVICE THREAD LEAK: {leaked}')


def _assert_same(got, want, label=''):
    """Every key equal in value and dtype."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (label, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f'{label}: {k}')


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------

def test_serve_exports_are_jax():
    import distributed_processor_tpu.serve as jserve
    import distributed_processor_tpu_torch.serve as tserve
    assert tserve.__all__ == jserve.__all__
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None, name


def test_terminal_error_taxonomy():
    """Program-class errors and the request's own outcomes are terminal
    at the router; infrastructure errors are retried elsewhere."""
    for exc in (FaultError([3, 0, 0, 0, 0, 0]),
                ProgramValidationError([('jump_oob', 0, 3,
                                         'target 9 outside [0, 5)')]),
                ValueError('bad shots'),
                DeadlineError('deadline passed'),
                CancelledError('cancelled'),
                ShutdownError('shutting down')):
        assert is_terminal_error(exc), exc
    for exc in (RuntimeError('executor crashed'),
                ExecutorLostError('dispatcher died'),
                ReplicaLostError('connection lost'),
                OverloadError('queue projected past deadline')):
        assert not is_terminal_error(exc), exc


def test_typed_errors_pickle_roundtrip():
    fe = pickle.loads(pickle.dumps(FaultError([2, 0, 1, 0, 0, 0])))
    assert isinstance(fe, FaultError)
    np.testing.assert_array_equal(fe.counts, [2, 0, 1, 0, 0, 0])
    assert _picklable_error(fe) is fe
    assert is_terminal_error(fe)


# ---------------------------------------------------------------------------
# the router alone
# ---------------------------------------------------------------------------

def _tiny_mp():
    core = [jisa.pulse_cmd(amp_word=1000, cfg_word=0, env_word=3,
                           cmd_time=10), jisa.done_cmd()]
    return _to_port(j_from_cmds([core]))


def test_router_validates_liveness_window():
    with pytest.raises(ValueError, match='liveness window'):
        FleetRouter(gossip_interval_ms=50.0, liveness_window_ms=50.0)


def test_gossip_staleness_marks_silent_replica_down():
    """A connection that stays open but never answers gossip (the
    SIGSTOP failure mode) is marked down within the liveness window."""
    lis = socket.socket()
    lis.bind(('127.0.0.1', 0))
    lis.listen(4)
    try:
        with FleetRouter(gossip_interval_ms=20.0,
                         liveness_window_ms=100.0) as router:
            router.add_replica('mute', lis.getsockname())
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                s = router.stats()
                if s['gossip_stale'] >= 1 \
                        and not s['replicas']['mute']['alive']:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError(
                    f'silent replica never marked stale: {s}')
            kinds = [e['kind'] for e in router.flight_recorder.events()]
            assert 'gossip_stale' in kinds and 'replica_down' in kinds
    finally:
        lis.close()


def test_heartbeat_not_queued_behind_result_frame(monkeypatch):
    """A replica whose result-frame write holds its connection's write
    lock for ~1 s stays live under the router's default 250 ms window:
    gossip travels on a connection of its own, so no heartbeat goes
    stale and the request completes on its first attempt (with one
    connection the heartbeat waits behind the frame, the replica is
    declared stale and the request fails over)."""
    from distributed_processor_tpu_torch.serve import ExecutionService
    from distributed_processor_tpu_torch.serve.transport import \
        ReplicaServer
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    send_on_resolve = ReplicaServer._send_on_resolve

    class HeldLock:
        """The connection's write lock, held ~1 s before the frame is
        written: a slow write of a large result frame."""

        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            self._lock.acquire()
            time.sleep(1.0)

        def __exit__(self, *exc):
            self._lock.release()

    def slow_send(self, conn, wlock, *args, **kw):
        return send_on_resolve(self, conn, HeldLock(wlock), *args, **kw)

    monkeypatch.setattr(ReplicaServer, '_send_on_resolve', slow_send)
    mp, bits = _tiny_mp(), np.zeros((2, 1, 2), np.int32)
    cfg = InterpreterConfig(max_steps=32, max_meas=2)
    svc = ExecutionService(devices=['cpu'], max_wait_ms=1.0)
    server = ReplicaServer(svc)
    try:
        with FleetRouter(name='held') as router:
            router.add_replica('r0', server.address)
            out = router.submit(mp, bits, cfg=cfg).result(timeout=T)
            s = router.stats()
            kinds = [e['kind'] for e in router.flight_recorder.events()]
    finally:
        server.close()
        svc.shutdown()
    assert 'gossip_stale' not in kinds, kinds
    assert (s['gossip_stale'], s['failovers'], s['retries'],
            s['completed']) == (0, 0, 0, 1), s
    want = simulate_batch(mp, bits, cfg=cfg, device='cpu')
    _assert_same(out, {k: v.numpy() for k, v in want.items()})


def test_router_shutdown_fails_parked_with_typed_error():
    """With no routable replica a request parks; shutdown fails it with
    ShutdownError, and later submissions are refused."""
    router = FleetRouter(retry_policy=RetryPolicy(max_attempts=2,
                                                  backoff_s=0.005))
    h = router.submit(_tiny_mp(), np.zeros((2, 1, 2), np.int32),
                      cfg=InterpreterConfig(max_steps=32, max_meas=2))
    assert not h.done()
    assert router.stats()['parked'] >= 0
    router.shutdown()
    assert isinstance(h.exception(timeout=5), ShutdownError)
    with pytest.raises(ServiceClosedError):
        router.submit(_tiny_mp(), np.zeros((2, 1, 2), np.int32))
    router.shutdown()                  # idempotent


def test_router_stats_keys_equal_jax():
    from distributed_processor_tpu.serve import FleetRouter as JRouter
    with FleetRouter(name='k') as r, JRouter(name='k') as jr:
        assert set(r.stats()) == set(jr.stats())
        assert r.prometheus_text(timeout_s=1.0) \
            == jr.prometheus_text(timeout_s=1.0)


# ---------------------------------------------------------------------------
# a live fleet: two replica processes on the CPU
# ---------------------------------------------------------------------------

N_REQS = 4


@pytest.fixture(scope='module')
def workload():
    """``(port programs, bits, port cfg, JAX programs, JAX cfg)``: the
    same RB workload compiled by each package, on the same bits."""
    mps, bits, cfg = _workload(N_REQS, 2, 2, 4, seed=3)
    jmps, jbits, jcfg = j_workload(N_REQS, 2, 2, 4, seed=3)
    for a, b in zip(bits, jbits):
        np.testing.assert_array_equal(a, b)
    return mps, bits, cfg, jmps, jcfg


@pytest.fixture(scope='module')
def fleet(workload):
    mps, bits, cfg, _jmps, _jcfg = workload
    f = Fleet(2, service={'devices': ['cpu'], 'max_batch_programs': 4,
                          'max_wait_ms': 5.0, 'max_queue': 256},
              env={'OMP_NUM_THREADS': '1'}, ready_timeout_s=T,
              # a liveness window well past a loaded host's scheduling
              # hiccups: a replica marked stale while it holds the strict
              # request would retry it, which is not what is tested
              router_kwargs={'retry_policy':
                             RetryPolicy(max_attempts=10, backoff_s=0.05,
                                         max_backoff_s=1.0),
                             'liveness_window_ms': 1000.0})
    try:
        # warm every replica on the serving bucket (bucket affinity
        # would home all fleet.submit traffic on one)
        for rid in f.replica_ids():
            f.router.call_replica(
                rid, 'submit', dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
                timeout_s=T)
        yield f
    finally:
        f.shutdown()
        for slot in f._replicas:
            assert slot.proc is None or slot.proc.poll() is not None


@pytest.fixture(scope='module')
def refs(workload):
    """The JAX package's solo runs on the same bits."""
    _mps, bits, _cfg, jmps, jcfg = workload
    return [{k: np.asarray(v) for k, v in
             j_simulate(jmps[i], bits[i], cfg=jcfg).items()}
            for i in range(N_REQS)]


def _wait_routable(fleet, n, timeout_s=T):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = fleet.router.stats()
        if s['n_routable'] >= n:
            return s
        time.sleep(0.05)
    raise AssertionError(f'{n} replicas never routable: '
                         f'{fleet.router.stats()}')


def _quiet(fleet, timeout_s=T):
    """The router's stats once no request is in flight, parked or
    awaiting a retry: every submission resolved."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = fleet.router.stats()
        if (s['parked'] == 0
                and all(r['inflight'] == 0 for r in s['replicas'].values())
                and s['completed'] + s['failed'] == s['submitted']):
            return s
        time.sleep(0.02)
    raise AssertionError(f'fleet never went quiet: {fleet.router.stats()}')


def test_fleet_round_trip_equals_jax(fleet, workload, refs):
    mps, bits, cfg, _jmps, _jcfg = workload
    handles = [fleet.submit(mps[i], bits[i], cfg=cfg)
               for i in range(N_REQS)]
    for i, h in enumerate(handles):
        _assert_same(h.result(timeout=T), refs[i], f'req {i}')
    s = fleet.stats()
    assert s['n_routable'] == 2 and s['completed'] >= N_REQS
    rep = fleet.replica_stats(0)
    assert 'compile' in rep and 'warmup' in rep
    assert rep['engine_dispatches'].get('generic', 0) >= 1
    from distributed_processor_tpu.serve import Fleet as JFleet  # noqa
    assert {'processes', 'autoscale', 'shared_dir'} <= set(s)


def test_strict_fault_error_crosses_wire_untouched(fleet):
    """A strict FaultError crosses the wire with the JAX package's
    counts and is never retried.  The before/after snapshots are taken
    only once the fleet is quiet, so no other request's retry or
    failure falls between them."""
    core = [jisa.alu_cmd('reg_alu', 'i', 1000, 'id0', write_reg_addr=0),
            jisa.pulse_cmd(amp_word=1000, cfg_word=0, env_word=3,
                           cmd_time=10),
            jisa.alu_cmd('reg_alu', 'i', -1, 'add', 0, write_reg_addr=0),
            jisa.alu_cmd('jump_cond', 'i', 0, 'le', 0, jump_cmd_ptr=1),
            jisa.done_cmd()]
    jmp = j_from_cmds([core])
    mb = np.zeros((4, 1, 2), np.int32)
    kw = dict(max_steps=6, max_meas=2, fault_mode='strict')
    with pytest.raises(JFaultError) as solo:
        j_simulate(jmp, mb, cfg=JCfg(**kw))

    _wait_routable(fleet, 2)
    before = _quiet(fleet)
    exc = fleet.submit(_to_port(jmp), mb,
                       cfg=InterpreterConfig(**kw)).exception(timeout=T)
    after = _quiet(fleet)
    assert isinstance(exc, FaultError), exc
    np.testing.assert_array_equal(exc.counts, solo.value.counts)
    assert after['retries'] == before['retries']
    assert after['failed'] == before['failed'] + 1


def test_kill_failover_bit_identity_and_warm_respawn(fleet, workload,
                                                     refs):
    """SIGKILL the loaded replica with requests in flight: every request
    completes equal to JAX's run on the survivor, the monitor respawns
    the victim from the shared catalog, and its first request after the
    replay counts no cold dispatch."""
    mps, bits, cfg, _jmps, _jcfg = workload
    _wait_routable(fleet, 2)
    before = fleet.router.stats()
    victim_rid = fleet.router.primary_replica()
    victim_idx = fleet.replica_ids().index(victim_rid)
    respawns0 = fleet.stats()['processes'][victim_rid]['respawns']

    handles = [fleet.submit(mps[i % N_REQS], bits[i % N_REQS], cfg=cfg)
               for i in range(2 * N_REQS)]
    fleet.kill(victim_idx)
    for i, h in enumerate(handles):
        _assert_same(h.result(timeout=T), refs[i % N_REQS],
                     f'req {i} after kill')
    after = fleet.router.stats()
    assert after['replica_down'] >= before['replica_down'] + 1

    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        st = fleet.stats()
        if st['processes'][victim_rid]['respawns'] > respawns0 \
                and st['replicas'].get(victim_rid, {}).get('routable'):
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f'victim never respawned and re-admitted: '
                             f'{fleet.stats()}')
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        rep = fleet.replica_stats(victim_rid)
        if rep['warmup']['in_progress'] == 0:
            break
        time.sleep(0.1)
    else:
        raise AssertionError('respawned replica warm-up never settled')
    assert rep['warmup']['replayed'] >= 1
    cold0 = rep['compile']['cold']
    got = fleet.router.call_replica(
        victim_rid, 'submit', dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
        timeout_s=T)
    _assert_same(got, refs[0], 'respawned replica')
    assert fleet.replica_stats(victim_rid)['compile']['cold'] == cold0


def test_wedge_gossip_failover_then_readmit(fleet, workload, refs):
    """SIGSTOP the loaded replica: only gossip staleness can catch it;
    its work fails over equal to JAX's runs, and SIGCONT re-admits it
    on the next heartbeat."""
    mps, bits, cfg, _jmps, _jcfg = workload
    _wait_routable(fleet, 2)
    before = fleet.router.stats()
    victim_rid = fleet.router.primary_replica()
    victim_idx = fleet.replica_ids().index(victim_rid)
    handles = [fleet.submit(mps[i], bits[i], cfg=cfg)
               for i in range(N_REQS)]
    fleet.wedge(victim_idx)
    try:
        for i, h in enumerate(handles):
            _assert_same(h.result(timeout=T), refs[i], f'req {i} wedged')
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            mid = fleet.router.stats()
            if mid['gossip_stale'] >= before['gossip_stale'] + 1:
                break
            time.sleep(0.02)
        assert mid['gossip_stale'] >= before['gossip_stale'] + 1, mid
        assert not mid['replicas'][victim_rid]['alive']
    finally:
        fleet.unwedge(victim_idx)
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        s = fleet.router.stats()
        if s['replicas'][victim_rid]['routable']:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f'unwedged replica never re-admitted: '
                             f'{fleet.router.stats()}')
    assert s['replica_up'] >= before['replica_up'] + 1


def test_stream_over_the_fleet(fleet):
    """A streaming session rides the ordinary frames: every chunk's
    result equals the direct ``simulate_rounds`` call."""
    from distributed_processor_tpu_torch.models import (
        repetition_config, repetition_decode_spec,
        repetition_round_machine_program)
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_rounds
    import dataclasses
    mp = repetition_round_machine_program(3)
    # the service serves rounds without pulse records
    cfg = dataclasses.replace(repetition_config(3), record_pulses=False)
    spec = repetition_decode_spec(3)
    rng = np.random.default_rng(9)
    chunks = [rng.integers(0, 2, (2, 4, mp.n_cores, cfg.max_meas),
                           dtype=np.int32) for _ in range(2)]
    _wait_routable(fleet, 2)
    with fleet.open_stream(mp, cfg=cfg, decode=spec) as sess:
        for mb in chunks:
            sess.submit_rounds(mb)
        frames = list(sess.results(timeout=T))
    for mb, got in zip(chunks, frames):
        want = simulate_rounds(mp, mb, cfg=cfg, decode=spec, device='cpu')
        _assert_same(got, {k: v.numpy() for k, v in want.items()},
                     'stream chunk')
    assert fleet.stats()['streaming']['open_sessions'] == 0


@pytest.mark.slow
def test_fleet_soak_scripted_chaos(fleet, workload):
    """Scripted kill + wedge/unwedge under a paced stream: no hangs, no
    mismatch against the solo runs, goodput positive in the kill
    window."""
    from distributed_processor_tpu_torch.serve.chaos import fleet_soak
    mps, _bits, cfg, _jmps, _jcfg = workload
    _wait_routable(fleet, 2)
    n = 30
    report = fleet_soak(
        fleet, mps, cfg, n_requests=n, shots=4, seed=5, rate_hz=30.0,
        actions=[(n // 3, 'kill', -1), (n // 2, 'wedge', -1),
                 ((3 * n) // 4, 'unwedge', -1)],
        result_timeout_s=300.0, device='cpu')
    assert report.hung == 0
    assert report.bit_mismatches == 0
    assert report.terminated() == report.submitted
    kill_t = next(t for t, m, _ in report.actions if m == 'kill')
    assert report.ok_in_window(kill_t, kill_t + 2.0) > 0


def test_shutdown_leaves_no_process(workload):
    """A fleet shut down partway (its spawn failed for one replica)
    leaves no child process and no thread behind."""
    import threading
    with pytest.raises(RuntimeError, match='fleet spawn failed'):
        Fleet(2, service={'devices': ['cpu'], 'no_such_knob': 1},
              env={'OMP_NUM_THREADS': '1'}, ready_timeout_s=T)
    f = Fleet(1, service={'devices': ['cpu']}, name='lone',
              env={'OMP_NUM_THREADS': '1'}, ready_timeout_s=T)
    pid = f.pid(0)
    f.shutdown()
    f.shutdown()                        # idempotent
    assert f._replicas[0].proc.poll() is not None
    with pytest.raises(ProcessLookupError):
        import os
        os.kill(pid, 0)
    left = [t.name for t in threading.enumerate()
            if t.name.endswith('-lone') and t.is_alive()]
    assert not left


def test_shutdown_during_respawn_leaves_no_process():
    """A shutdown that lands while the monitor is booting a respawn
    abandons the boot and kills the booting replica: no process of the
    fleet outlives it, however long a replica takes to become ready."""
    import subprocess
    f = Fleet(1, service={'devices': ['cpu']}, name='respawning',
              env={'OMP_NUM_THREADS': '1'}, respawn_backoff_s=0.0,
              ready_timeout_s=T)
    shared = f.shared_dir
    f.kill(0)
    deadline = time.monotonic() + T
    while f.stats()['processes']['r0']['respawns'] == 0 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    f.shutdown()
    assert time.monotonic() - t0 < 10.0
    time.sleep(0.2)
    ps = subprocess.run(['ps', '-eo', 'pid,args'], capture_output=True,
                        text=True, timeout=30).stdout
    assert not [ln for ln in ps.splitlines()
                if 'replica_main' in ln and shared in ln]
