"""The port's fleet observability against the JAX package's frozen names.

Mirrors tests/test_fleet_obs.py on a module-scoped ``Fleet`` of two
replica processes on the CPU: the router's ``fleet_*`` metric names and
the span names of a stitched fleet trace equal the frozen manifests of
tests/test_fleet_obs.py; the replica-side spans the router's sampling
decision brought back over the wire are clock-aligned inside the wire
window (a monotone waterfall that tools/traceview.py reads); the merged
Prometheus text's per-replica ``serve_*`` series equal the replicas'
own registries pulled directly, and the rollup is their sum; the gossip
op, the federated flight timeline and the SLO watch behave as JAX's.
"""

import json
import time

import pytest

from distributed_processor_tpu.serve import FleetRouter as JRouter

from distributed_processor_tpu_torch.obs import STAGE_ORDER
from distributed_processor_tpu_torch.serve import FleetRouter, RetryPolicy
from distributed_processor_tpu_torch.serve.benchmark import _workload
from distributed_processor_tpu_torch.serve.fleet import Fleet

from test_fleet_obs import (_FLEET_COUNTERS, _FLEET_GAUGES,
                            _FLEET_SPAN_NAMES, _ROUTER_CORE_SPANS,
                            _prom_series, traceview)

pytestmark = [pytest.mark.serve, pytest.mark.fleet]

T = 120          # every result / ready wait is bounded
N_REQS = 6


@pytest.fixture(autouse=True)
def _serve_thread_leak_probe():
    """The module-scoped fleet keeps its threads alive across tests by
    design: the leak boundary is the module's end."""
    yield


@pytest.fixture(autouse=True, scope='module')
def _fleet_thread_boundary():
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


def test_stage_order_is_jax():
    from distributed_processor_tpu.obs import STAGE_ORDER as J_STAGES
    assert tuple(STAGE_ORDER) == tuple(J_STAGES) \
        == tuple(traceview.STAGE_ORDER)


def test_fleet_metric_manifest_is_frozen():
    """An empty router exposes every frozen fleet_* series from boot,
    and its text equals the JAX router's."""
    with FleetRouter(name='manifest') as router:
        text = router.prometheus_text(timeout_s=1.0)
    for pn in sorted(_FLEET_COUNTERS):
        assert f'# TYPE {pn} counter' in text, pn
        assert _prom_series(text, pn), pn
    for pn in sorted(_FLEET_GAUGES - {'fleet_heartbeat_age_ms'}):
        assert f'# TYPE {pn} gauge' in text, pn
        assert _prom_series(text, pn), pn
    assert '# TYPE fleet_heartbeat_age_ms gauge' in text
    names = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith('# TYPE fleet_')}
    assert names == (_FLEET_COUNTERS | _FLEET_GAUGES
                     | {'fleet_latency_ms'})
    with JRouter(name='manifest') as jrouter:
        assert text == jrouter.prometheus_text(timeout_s=1.0)


@pytest.fixture(scope='module')
def workload():
    return _workload(N_REQS, 2, 2, 4, seed=7)


@pytest.fixture(scope='module')
def fleet(workload):
    mps, bits, cfg = workload
    # trace_sample goes to the ROUTER only: every replica-side span
    # below exists because the router's decision rode the wire
    f = Fleet(2, service={'devices': ['cpu'], 'max_batch_programs': 4,
                          'max_wait_ms': 5.0, 'max_queue': 256},
              env={'OMP_NUM_THREADS': '1'}, ready_timeout_s=T,
              router_kwargs={
                  'retry_policy': RetryPolicy(max_attempts=10,
                                              backoff_s=0.05,
                                              max_backoff_s=1.0),
                  'trace_sample': 1.0,
                  'trace_keep': 64,
                  'slo_budgets': {'total': {'p99_ms': 1e-4}},
                  'slo_min_samples': 4,
                  # past a loaded host's scheduling hiccups
                  'liveness_window_ms': 1000.0,
              })
    try:
        for rid in f.replica_ids():
            f.router.call_replica(
                rid, 'submit', dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
                timeout_s=T)
        yield f
    finally:
        f.shutdown()


def _run_workload(fleet, workload):
    mps, bits, cfg = workload
    handles = [fleet.submit(mps[i], bits[i], cfg=cfg)
               for i in range(N_REQS)]
    for h in handles:
        h.result(timeout=T)


def _stitched_contexts(fleet):
    return [c for c in fleet.router.trace_contexts()
            if any(s['name'] == 'wire.await' for s in c.spans)]


def test_wire_trace_stitching_monotone(fleet, workload, tmp_path):
    """A sampled request's context holds the router-side spans and the
    replica-side spans (tagged with the serving replica), every name
    in the frozen set, every replica span inside the wire window; the
    export drives tools/traceview.py."""
    _run_workload(fleet, workload)
    ctxs = _stitched_contexts(fleet)
    assert ctxs, 'no stitched contexts at trace_sample=1.0'
    rids = set(fleet.replica_ids())
    saw_replica_side = False
    for ctx in ctxs:
        names = [s['name'] for s in ctx.spans]
        assert set(names) <= _FLEET_SPAN_NAMES, \
            set(names) - _FLEET_SPAN_NAMES
        assert _ROUTER_CORE_SPANS <= set(names)
        wire = [s for s in ctx.spans if s['name'] == 'wire.await']
        ws = min(s['t0'] for s in wire)
        we = max(s['t1'] for s in wire)
        for s in ctx.spans:
            rid = s['args'].get('replica')
            if rid is None:
                continue
            saw_replica_side = True
            assert rid in rids
            assert ws - 1e-9 <= s['t0'] <= we + 1e-9
            if s['t1'] is not None:
                assert s['t0'] <= s['t1'] <= we + 1e-9
        # router-side order: submit, route, wire.send, wire.await
        first = {n: min(s['t0'] for s in ctx.spans if s['name'] == n)
                 for n in ('submit', 'route', 'wire.send', 'wire.await')}
        assert first['submit'] <= first['route'] <= first['wire.send'] \
            <= first['wire.await']
    assert saw_replica_side, 'no replica-side spans came back'
    out = tmp_path / 'fleet_trace.json'
    n = fleet.dump_trace(str(out))
    assert n > 0
    summary = traceview.summarize(str(out))
    assert summary['events'] == n
    stages = {s['stage']: s for s in summary['stages']}
    assert 'wire.await' in stages
    assert 'wire_p50_ms' in stages['wire.await']


def test_router_stage_histograms_feed_stats(fleet, workload):
    _run_workload(fleet, workload)
    s = fleet.stats()
    assert s['completed'] >= N_REQS
    text = fleet.prometheus_text()
    assert '# TYPE fleet_stage_wire_await_ms histogram' in text
    assert _prom_series(text, 'fleet_stage_wire_await_ms_count')


def test_prometheus_per_replica_sums_match_direct(fleet, workload):
    """The labeled serve_* series equal each replica's registry pulled
    directly over the wire, and the unlabeled rollup is their sum."""
    _run_workload(fleet, workload)
    text = fleet.prometheus_text()
    direct = {rid: fleet.router.call_replica(rid, 'fleet-metrics',
                                             timeout_s=30.0)['metrics']
              for rid in fleet.replica_ids()}
    series = _prom_series(text, 'serve_submitted')
    assert set(series) == set(direct) | {None}
    for rid, snap in direct.items():
        want = snap['counters'].get('serve.submitted', 0)
        # the direct pull ran after the exposition; counters only grow
        assert series[rid] <= want
        assert want - series[rid] <= N_REQS
    assert series[None] == sum(v for rid, v in series.items()
                               if rid is not None)
    assert series[None] > 0
    # the engine counters of the replicas are there too: the port's
    # per-rung dispatch counts reach the fleet's one pane
    engines = _prom_series(text, 'serve_engine_generic')
    assert engines.get(None, 0) >= 1


def test_gossip_op_carries_flight_digest_and_clock(fleet):
    for rid in fleet.replica_ids():
        resp = fleet.router.call_replica(rid, 'gossip', timeout_s=30.0)
        assert {'stats', 'mono', 'flight'} <= set(resp)
        assert isinstance(resp['mono'], float)
        fl = resp['flight']
        assert {'recorded', 'dropped', 'counts', 'tail'} <= set(fl)
        assert fl['dropped'] >= 0
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        offs = fleet.router.clock_offsets()
        if set(offs) == set(fleet.replica_ids()):
            break
        time.sleep(0.05)
    assert set(offs) == set(fleet.replica_ids()), offs
    for rid, o in offs.items():
        assert o['samples'] > 0
        assert o['uncertainty_s'] < float('inf')
        assert abs(o['offset_s']) <= max(1.0, 10 * o['uncertainty_s'])


def test_merged_flight_is_time_aligned(fleet, workload):
    _run_workload(fleet, workload)
    mf = fleet.merged_flight(pull=True)
    assert {'router', 'replicas', 'clock_offsets', 'events'} <= set(mf)
    assert set(mf['replicas']) == set(fleet.replica_ids())
    for ring in mf['replicas'].values():
        assert ring['source'] in ('pull', 'gossip')
        assert ring['recorded'] >= 0 and ring['dropped'] >= 0
    assert 'router' in {e['origin'] for e in mf['events']}
    for e in mf['events']:
        assert 'origin' in e and 't_router' in e and 'kind' in e
    aligned = [e['t_router'] for e in mf['events']
               if e['t_router'] is not None]
    assert aligned == sorted(aligned)
    json.dumps(mf)


def test_slo_watch_breaches_on_impossible_budget(fleet, workload):
    _run_workload(fleet, workload)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        s = fleet.stats()
        if s.get('slo_breaches', 0) >= 1:
            break
        time.sleep(0.05)
    assert s.get('slo_breaches', 0) >= 1, s
    slo = s['slo']
    assert 'total' in slo and slo['total']['breached']
    assert slo['total']['samples'] >= 4
    kinds = [e['kind'] for e in fleet.router.flight_recorder.events()]
    assert 'slo_breach' in kinds
    series = _prom_series(fleet.prometheus_text(), 'fleet_slo_breaches')
    assert series[None] >= 1
