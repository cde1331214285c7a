"""The port's ``obs/`` and ``utils/profiling`` against the JAX package's.

The same observations go into both packages' objects and must come out
the same: histogram counts, sums and percentiles, registry snapshots and
restores, the Prometheus text (single-registry and merged), tenant usage
rows, the flight recorder's ring and dump, the tracer's sampling and its
Chrome trace, the clock-offset estimate; the profiling facade and its
timers on the port's own registry.  Only the parts that need no serving
tier (which the port has not yet).  Wall-clock fields (the recorder's
``t`` and ``mono``) are compared for presence, not value.
"""

import json
import threading
import types

import numpy as np
import pytest
import torch

import distributed_processor_tpu.obs as j_obs
from distributed_processor_tpu.utils import profiling as j_profiling

import distributed_processor_tpu_torch.obs as t_obs
from distributed_processor_tpu_torch.utils import profiling as t_profiling

torch.set_num_threads(1)

JAX = types.SimpleNamespace(obs=j_obs, profiling=j_profiling)
PORT = types.SimpleNamespace(obs=t_obs, profiling=t_profiling)


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def _both(fn, *args):
    """``fn`` on each package; the two results must be equal."""
    want, got = fn(JAX, *args), fn(PORT, *args)
    assert got == want
    return got


def _registry_ops(pkg):
    reg = pkg.obs.MetricsRegistry()
    log = [reg.inc('a.b'), reg.inc('a.b', 4), reg.get('a.b'),
           reg.get('missing')]
    reg.set_gauge('depth', 7)
    log += [reg.gauge('depth'), reg.gauge('nope', default=-1.0)]
    h = reg.histogram('lat_ms')
    for v in (1.0, 2.0, 3.0, 100.0):
        h.observe(v)
    log += [h.count, h.sum, reg.histogram('lat_ms') is h, reg.counters(),
            reg.gauges(), reg.snapshot()]
    return log


def test_registry_counters_gauges_histograms():
    log = _both(_registry_ops)
    assert log[:4] == [1, 5, 5, 0] and log[6:9] == [4, 106.0, True]


def _histogram_ops(pkg, window, values):
    h = pkg.obs.Histogram('x', window=window)
    for v in values:
        h.observe(float(v))
    return [h.count, h.sum, h.values()] + [h.percentile(p)
                                           for p in (0, 1, 50, 90, 99, 100)]


@pytest.mark.parametrize('window,n', [(512, 300), (16, 100), (4096, 1)])
def test_histogram_matches_jax(window, n):
    vals = np.random.default_rng(3).exponential(10.0, size=n)
    got = _both(_histogram_ops, window, vals)
    assert got[0] == n and len(got[2]) == min(window, n)
    assert got[5] == pytest.approx(float(np.percentile(got[2], 50)))
    assert _both(lambda pkg: pkg.obs.Histogram('empty').percentile(50)) \
        is None


def _snapshot_restore(pkg):
    reg = pkg.obs.MetricsRegistry()
    reg.inc('c', 3)
    reg.set_gauge('g', 1.5)
    reg.observe('h', 12.0)
    snap = reg.snapshot()
    reg.inc('c', 10)
    reg.inc('new', 1)
    reg.set_gauge('g', 9.0)
    reg.observe('h', 99.0)
    mid = reg.snapshot()
    reg.restore(snap)
    return [mid, reg.snapshot(), reg.get('c'), reg.get('new'),
            reg.gauge('g'), reg.histogram('h').values()]


def test_registry_snapshot_restore_roundtrip():
    log = _both(_snapshot_restore)
    assert log[2:] == [3, 0, 1.5, [12.0]]


def _prometheus(pkg):
    reg = pkg.obs.MetricsRegistry()
    reg.inc('serve.submitted', 2)
    reg.inc('compilecache.hits', 5)
    reg.set_gauge('serve.svc0.queue_depth', 3)
    reg.observe('serve.latency_ms', 1.7)
    reg.observe('compilecache.compile_ms', 40.0, buckets=(1.0, 10.0, 100.0))
    other = pkg.obs.MetricsRegistry()
    other.inc('serve.submitted', 7)
    other.observe('serve.latency_ms', 250.0)
    snaps = {'r0': reg.snapshot(), 'r"1\n': other.snapshot()}
    return [reg.prometheus_text(),
            pkg.obs.prometheus_snapshot_lines(reg.snapshot(),
                                              labels={'replica': 'a\\b'}),
            pkg.obs.merged_prometheus_text(snaps),
            pkg.obs.escape_label_value('x"y\\z\n'),
            list(pkg.obs.DEFAULT_BUCKETS)]


def test_prometheus_text_matches_jax():
    text = _both(_prometheus)[0]
    assert '# TYPE serve_submitted counter' in text
    assert 'serve_latency_ms_bucket{le="+Inf"} 1' in text


def _tenants(pkg):
    snap = {'counters': {'tenant.acme.shots': 10, 'tenant.a.b.completed': 2,
                         'tenant.acme.bogus': 1, 'serve.x': 3}}
    rows = pkg.obs.tenant_usage(snap)
    return [rows, pkg.obs.merge_tenant_usage({'p0': rows, 'p1': rows}),
            list(pkg.obs.TENANT_METERS)]


def test_tenant_usage_matches_jax():
    rows = _both(_tenants)[0]
    assert rows['acme']['shots'] == 10 and rows['a.b']['completed'] == 2


def _threads(pkg):
    reg = pkg.obs.MetricsRegistry()

    def worker():
        for _ in range(500):
            reg.inc('n')
            reg.observe('h', 1.0)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return [reg.get('n'), reg.histogram('h').count]


def test_registry_thread_safety():
    assert _both(_threads) == [4000, 4000]


def _recorder(pkg, tmp_path):
    rec = pkg.obs.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record('retry', seq=i, attempt=i % 3)
    rec.record('breaker_trip', executor='cpu:0')
    p = tmp_path / f'{id(pkg)}.json'
    n = rec.dump(str(p))
    doc = json.loads(p.read_text())
    for ev in doc['events'] + rec.events():
        # wall-clock fields: present, compared by presence only
        assert isinstance(ev.pop('t'), float)
        assert isinstance(ev.pop('mono'), float)
    return [rec.recorded, rec.dropped, rec.counts(),
            rec.events(kind='breaker_trip'), n, doc]


def test_flight_recorder_matches_jax(tmp_path):
    log = _both(_recorder, tmp_path)
    assert log[:3] == [11, 7, {'retry': 3, 'breaker_trip': 1}]
    assert [e['seq'] for e in log[5]['events']] == [7, 8, 9, 10]


def _tracer(pkg, tmp_path):
    out = []
    for sample in (0.0, 0.25, 1.0):
        t = pkg.obs.Tracer(sample, keep=100)
        got = [t.maybe_start() for _ in range(100)]
        out.append([sample, t.enabled,
                    [c is None for c in got], [t.sampled(i)
                                               for i in range(12)]])
    t = pkg.obs.Tracer(1.0)
    ctx = t.maybe_start()
    t0 = 100.0
    ctx.instant('submit', t=t0, seq=0)
    ctx.span('queued', t0, t0 + 0.5, bucket='b')
    ctx.span('execute', t0 + 0.5, t0 + 0.7, device='cpu:0')
    ctx.instant('done', t=t0 + 0.7, outcome='ok')
    t.start(41).span('replica', t0 + 0.1, t0 + 0.2)
    p = tmp_path / f'{id(pkg)}.json'
    n = pkg.obs.write_chrome_trace(str(p), t.contexts(), pid='svc')
    out += [pkg.obs.chrome_trace_events(t.contexts(), pid='svc'), n,
            json.loads(p.read_text()), list(pkg.obs.STAGE_ORDER)]
    return out


def test_tracer_and_chrome_trace_match_jax(tmp_path):
    log = _both(_tracer, tmp_path)
    assert sum(not none for none in log[1][2]) == 25
    assert log[4] == 5 and log[5]['displayTimeUnit'] == 'ms'


def _clock(pkg):
    est = pkg.obs.ClockOffsetEstimator(window=3)
    out = [est.n, est.offset, est.uncertainty_s]
    for t_send, t_remote, t_recv in ((0.0, 10.4, 1.0), (2.0, 12.1, 2.2),
                                     (3.0, 13.9, 4.0), (5.0, 15.3, 5.5)):
        est.add_sample(t_send, t_remote, t_recv)
        out.append([est.n, est.offset, est.uncertainty_s,
                    est.to_local(20.0), est.to_remote(20.0)])
    return out


def test_clock_offset_matches_jax():
    log = _both(_clock)
    assert log[:3] == [0, 0.0, float('inf')]


def test_profiling_facade_on_the_ports_registry():
    """The facade reads and writes the port's default registry, under the
    JAX package's counter names, and never the JAX package's."""
    j_before = j_profiling.counters()
    assert t_profiling.registry() is t_obs.default_registry()
    assert t_profiling.registry() is not j_profiling.registry()
    t_profiling.counter_inc('obs.test.facade', 2)
    assert t_profiling.counter_get('obs.test.facade') == 2
    assert t_profiling.counters()['obs.test.facade'] == 2
    assert 'obs_test_facade 2' in t_profiling.prometheus_text()
    snap = t_profiling.registry_snapshot()
    t_profiling.counter_inc('obs.test.facade', 100)
    t_profiling.registry_restore(snap)
    assert t_profiling.counter_get('obs.test.facade') == 2
    assert j_profiling.counters() == j_before


def test_compile_cache_counters_on_registry():
    """tests/test_obs.py's compile-cache counter case, on the port."""
    from distributed_processor_tpu_torch.compilecache import CompileCache
    from distributed_processor_tpu_torch.models import make_default_qchip
    before = t_profiling.counters()
    n0 = t_profiling.registry().histogram('compilecache.compile_ms').count
    cache = CompileCache(capacity=8)
    prog = [{'name': 'X90', 'qubit': ['Q0']}]
    for _ in range(2):
        cache.get_or_compile(prog, make_default_qchip(2), n_qubits=2)
    after = t_profiling.counters()
    for name in ('compilecache.misses', 'compilecache.hits'):
        assert after[name] == before.get(name, 0) + 1
    assert t_profiling.registry().histogram(
        'compilecache.compile_ms').count == n0 + 1
    rec = t_obs.FlightRecorder()
    cache.recorder = rec
    st = cache.stats()
    cache.invalidate_epoch('nonexistent-fp')
    ev = rec.events(kind='cache_invalidate')
    assert len(ev) == 1 and ev[0]['entries'] == 0
    assert cache.stats()['invalidations'] == st['invalidations'] + 1


def test_timers_return_host_arrays(tmp_path):
    """``StageTimer`` on CPU tensors returns the stage's own output and
    charges its time; ``device_profile`` writes its trace."""
    st = t_profiling.StageTimer()
    x = st.stage('add', lambda: torch.arange(4) + 1)
    assert torch.equal(x, torch.arange(1, 5))
    assert st.times['add'] >= 0.0 and 'add' in st.report()
    with t_profiling.device_profile(str(tmp_path)):
        torch.ones(8).sum()
    assert any(p.name.endswith('.json') for p in tmp_path.iterdir())
