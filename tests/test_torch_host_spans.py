"""The port's host spans (``obs/trace.py`` ``host_span``) on the CPU.

The ring records only while a ``torch.profiler`` profile collects in the
process, from every thread, on ``time.time_ns()`` (the clock the
profiler stamps its events with); the switch is torch's process-wide
``torch.autograd.profiler._is_profiler_enabled``, pinned here because it
is private to torch.  ``run_physics_batch``, ``simulate_rounds`` and a
batch of the ``ExecutionService`` each give the taxonomy of the
``obs/trace.py`` module docstring.  The request spans' Chrome export
and ``device_profile`` put everything on the profiler's clock.

One test needs the card (marker ``cuda``; it skips elsewhere)::

    python -m pytest --noconftest tests/test_torch_host_spans.py -m cuda -q

This file imports nothing of JAX.
"""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    active_reset, make_default_qchip, rb_ensemble)
from distributed_processor_tpu_torch.models.qec import (
    qec_config, qec_round_machine_program, repetition_decode_spec)
from distributed_processor_tpu_torch.obs import (
    HOST_SPANS, HostSpanRing, Tracer, chrome_trace_events, host_idle_ns,
    host_span, host_work_intervals, self_time_ns, wall_offset_s)
from distributed_processor_tpu_torch.parallel import physics_batch_stats
from distributed_processor_tpu_torch.serve import ExecutionService
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, simulate_rounds)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, run_physics_batch)
from distributed_processor_tpu_torch.utils import profiling

T = 120          # every result / join / shutdown waits at most this long


@pytest.fixture(autouse=True)
def _empty_ring():
    HOST_SPANS.clear()
    yield
    HOST_SPANS.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s['name'], []).append(s)
    return out


def _children(spans, parent) -> list:
    return [s['name'] for s in sorted(spans, key=lambda s: s['t0'])
            if s['parent'] == parent['id']]


def test_profiler_flag_is_process_wide():
    """The switch: torch's module flag reads True on a second thread
    while a profile collects, and False before and after; the C flag
    is per thread, which is why the ring does not read it."""
    import torch.autograd.profiler as ap
    seen = {}

    def other():
        seen['module'] = ap._is_profiler_enabled
        seen['thread_local'] = torch._C._autograd._profiler_enabled()

    assert ap._is_profiler_enabled is False
    with _cpu_profile():
        t = threading.Thread(target=other)
        t.start()
        t.join(T)
        assert not t.is_alive()
        assert ap._is_profiler_enabled is True
    assert ap._is_profiler_enabled is False
    assert seen == {'module': True, 'thread_local': False}


def test_ring_off_without_a_profile():
    """No profile: every site gets one shared no-op span, the ring stays
    empty, and a site allocates nothing."""
    a, b = host_span('x', 'k', 1), host_span('y')
    assert a is b
    with a as sp:
        sp.arg('engine', 'generic')
    assert HOST_SPANS.recorded == 0 and HOST_SPANS.spans() == []

    def sites(n):
        for i in range(n):
            with host_span('physics.epoch', 'ep', i):
                with host_span('physics.wait'):
                    pass

    sites(10)                      # warm the code paths
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        sites(20000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - base < 1024, (base, peak)
    assert HOST_SPANS.recorded == 0


def test_ring_records_threads_parents_and_self_time():
    """Under a CPU-only profile the ring records spans of the main
    thread and of a second thread; each span's parent is the span that
    encloses it on its own thread, and self time is the duration less
    the children's."""
    def worker():
        with host_span('t2.outer'):
            with host_span('t2.inner', 'n', 2):
                time.sleep(0.002)

    with _cpu_profile():
        with host_span('main.outer', 'shots', 4) as sp:
            sp.arg('engine', 'straightline')
            t = threading.Thread(target=worker)
            t.start()
            with host_span('main.inner'):
                time.sleep(0.003)
            with host_span('main.inner'):
                time.sleep(0.001)
            t.join(T)
            assert not t.is_alive()
    spans = HOST_SPANS.spans()
    got = _by_name(spans)
    assert sorted(got) == ['main.inner', 'main.outer', 't2.inner',
                           't2.outer']
    outer, = got['main.outer']
    assert outer['args'] == {'shots': 4, 'engine': 'straightline'}
    assert outer['parent'] is None
    assert all(s['parent'] == outer['id'] for s in got['main.inner'])
    t2o, = got['t2.outer']
    t2i, = got['t2.inner']
    assert t2o['parent'] is None and t2i['parent'] == t2o['id']
    assert t2i['args'] == {'n': 2}
    assert t2o['thread'] != outer['thread'] == threading.get_ident()
    for s in spans:
        assert isinstance(s['t0'], int) and s['t0'] <= s['t1']
    own = self_time_ns(spans)
    inner = sum(s['t1'] - s['t0'] for s in got['main.inner'])
    assert own[outer['id']] == outer['t1'] - outer['t0'] - inner
    assert own[t2i['id']] == t2i['t1'] - t2i['t0']
    assert HOST_SPANS.recorded == 5 and HOST_SPANS.dropped == 0
    # the reader keeps the spans inside its bounds
    assert HOST_SPANS.spans(outer['t0'], outer['t1']) == [
        s for s in spans if s['t0'] >= outer['t0'] and s['t1'] <= outer['t1']]
    assert HOST_SPANS.spans(outer['t1'] + 1) == []


def test_host_work_and_the_devices_idle_time_under_it():
    """Host work is where some thread's innermost span is not a
    ``*.wait``, two threads counted once where they overlap; the idle
    time under it is what the device's busy intervals leave."""
    def span(i, name, t0, t1, parent=None, thread=1):
        return dict(name=name, t0=t0, t1=t1, args={}, id=i, parent=parent,
                    thread=thread)
    spans = [span(1, 'serve.enqueue', 0, 100),
             span(2, 'step.wait', 20, 30, parent=1),
             span(3, 'h2d.wait', 60, 70, parent=1),
             span(4, 'physics.exec', 90, 150, thread=2),
             span(5, 'rounds.wait', 200, 300, thread=2)]
    assert host_work_intervals(spans) == [[0, 20], [30, 60], [70, 150]]
    assert host_idle_ns(spans, []) == 130
    assert host_idle_ns(spans, [(10, 40), (100, 400)]) == \
        10 + (60 - 40) + (100 - 70)
    assert host_idle_ns(spans, [(0, 150)]) == 0
    assert host_idle_ns([], [(0, 10)]) == 0


def test_ring_bound_counts_what_it_drops():
    ring = HostSpanRing(capacity=3)
    for i in range(5):
        ring.append({'name': 'x', 't0': i, 't1': i + 1})
    assert ring.recorded == 5 and ring.dropped == 2
    assert [s['t0'] for s in ring.spans()] == [2, 3, 4]
    assert [s['t0'] for s in ring.spans(3, 4)] == [3]
    ring.clear()
    assert ring.recorded == 0 and ring.dropped == 0


def test_span_on_the_profilers_clock():
    """A span lies inside a ``time.time_ns()`` bracket, and in order with
    the profiler's own ``record_function`` ranges: one inside it, one
    after it."""
    with _cpu_profile() as prof:
        a = time.time_ns()
        with host_span('outer'):
            with record_function('inside'):
                torch.ones(64).sum()
        with record_function('after'):
            torch.ones(64).sum()
        z = time.time_ns()
    span, = HOST_SPANS.spans()
    assert a <= span['t0'] <= span['t1'] <= z
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ('inside', 'after')}
    assert span['t0'] <= ranges['inside'][0] <= ranges['inside'][1] \
        <= span['t1']
    assert ranges['after'][0] >= span['t1']


@pytest.fixture(scope='module')
def rb3():
    qubits = ['Q0', 'Q1', 'Q2']
    mp = compile_to_machine(active_reset(qubits)
                            + rb_ensemble(qubits, 3, 1, seed=7)[0],
                            make_default_qchip(3), n_qubits=3)
    cfg = dict(max_steps=2 * mp.n_instr + 64,
               max_pulses=int(mp.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2, record_pulses=False)
    return mp, cfg


@pytest.mark.parametrize('fault_mode', ['count', 'strict'])
def test_physics_batch_taxonomy(rb3, fault_mode):
    """``run_physics_batch`` and ``physics_batch_stats``: one
    ``physics.batch`` (shots, engine, exec, device) over
    ``physics.prepare``, one
    ``physics.epoch`` per check of the loop, each over a
    ``physics.wait`` and, but for the last, ``physics.exec`` and
    ``physics.resolve``, and ``physics.finalize`` (over the strict
    check's ``physics.wait``); ``sweep.stats`` beside it.  The blocking
    copies of constants to the device are ``h2d.wait`` spans under the
    span they interrupt: the straight-line engine's under
    ``physics.exec``, the tables' under ``physics.prepare``."""
    mp, cfg = rb3
    model = ReadoutPhysics(sigma=0.05, p1_init=0.15, resolve_chunk=256,
                           resolve_mode='fused')
    with _cpu_profile():
        out = run_physics_batch(
            mp, model, 5, 16,
            cfg=InterpreterConfig(**cfg, straightline=True,
                                  fault_mode=fault_mode),
            device='cpu')
        physics_batch_stats(out)
    spans = HOST_SPANS.spans()
    got = _by_name(spans)
    batch, = got['physics.batch']
    assert batch['parent'] is None
    assert batch['args'] == {'shots': 16, 'engine': 'straightline',
                             'exec': 'plain', 'device': 'parity'}
    epochs = int(out['epochs'])
    kids = _children(spans, batch)
    assert kids == (['physics.prepare'] + ['physics.epoch'] * (epochs + 1)
                    + ['physics.finalize'])
    eps = sorted(got['physics.epoch'], key=lambda s: s['t0'])
    assert [e['args']['ep'] for e in eps] == list(range(epochs + 1))
    for e in eps[:-1]:
        assert _children(spans, e) == ['physics.wait', 'physics.exec',
                                       'physics.resolve']
    assert _children(spans, eps[-1]) == ['physics.wait']
    fin, = got['physics.finalize']
    assert [k for k in _children(spans, fin) if k != 'h2d.wait'] == \
        (['physics.wait'] if fault_mode == 'strict' else [])
    stats, = got['sweep.stats']
    assert stats['parent'] is None and stats['t0'] >= batch['t1']
    assert _children(spans, stats) == ['h2d.wait']
    assert len(got['physics.wait']) == epochs + 1 + (fault_mode == 'strict')
    for name in ('physics.prepare', 'physics.exec'):
        for s in got[name]:
            assert set(_children(spans, s)) == {'h2d.wait'}
    assert all(s['parent'] is not None for s in got['h2d.wait'])
    assert not got.keys() - {'physics.batch', 'physics.prepare',
                             'physics.epoch', 'physics.wait',
                             'physics.exec', 'physics.resolve',
                             'physics.finalize', 'sweep.stats',
                             'h2d.wait'}


@pytest.mark.parametrize('fault_mode', ['count', 'strict'])
def test_rounds_call_taxonomy(fault_mode):
    """``simulate_rounds``: one ``rounds.call`` over ``rounds.prepare``,
    ``rounds.exec``, ``rounds.decode`` and, under the strict fault mode,
    the check's ``rounds.wait``; every other span is a ``*.wait`` under
    one of them."""
    n = 3
    mp = qec_round_machine_program(n)
    cfg = qec_config(n, record_pulses=False, fault_mode=fault_mode)
    bits = np.random.default_rng(4).integers(0, 2, (4, 6, n, cfg.max_meas),
                                             dtype=np.int32)
    with _cpu_profile():
        out = simulate_rounds(mp, bits, cfg=cfg, device='cpu',
                              decode=repetition_decode_spec(n))
    assert 'decoded' in out
    spans = HOST_SPANS.spans()
    call, = _by_name(spans)['rounds.call']
    want = ['rounds.prepare', 'rounds.exec', 'rounds.decode']
    if fault_mode == 'strict':
        want.append('rounds.wait')
    assert _children(spans, call) == want
    assert _children(spans, _by_name(spans)['rounds.decode'][0]) == \
        ['h2d.wait']
    ids = {s['id'] for s in spans if s['parent'] == call['id']}
    rest = [s for s in spans if s is not call and s['id'] not in ids]
    assert all(s['name'].endswith('.wait') for s in rest)
    assert all(s['parent'] is not None for s in rest)


def test_service_batch_spans_on_the_dispatcher_thread(rb3):
    """A coalesced batch of the ``ExecutionService``: ``serve.pack``,
    ``serve.enqueue``, ``serve.copy`` and ``serve.demux`` in that order,
    recorded from the dispatcher thread, not the submitter's.  Under
    ``serve.enqueue`` the generic engine's step loop waits on its settle
    test once a step (``step.wait``)."""
    mp, cfg = rb3
    bits = np.random.default_rng(1).integers(0, 2, (8, mp.n_cores, 2),
                                             dtype=np.int32)
    with ExecutionService(InterpreterConfig(**cfg), devices=['cpu'],
                          max_batch_programs=4, max_wait_ms=50.0) as svc:
        svc.warmup([svc.bucket_spec(mp, shots=8, n_programs=p,
                                    cfg=InterpreterConfig(**cfg))
                    for p in (1, 2, 4)])
        assert HOST_SPANS.spans() == []
        with _cpu_profile():
            handles = [svc.submit(mp, bits) for _ in range(3)]
            for h in handles:
                h.result(timeout=T)
    spans = [s for s in HOST_SPANS.spans() if s['name'].startswith('serve.')]
    assert spans, HOST_SPANS.spans()
    names = [s['name'] for s in sorted(spans, key=lambda s: s['t0'])]
    assert names[:4] == ['serve.pack', 'serve.enqueue', 'serve.copy',
                         'serve.demux']
    assert len(names) % 4 == 0 and \
        names == ['serve.pack', 'serve.enqueue', 'serve.copy',
                  'serve.demux'] * (len(names) // 4)
    assert {s['thread'] for s in spans} != {threading.get_ident()}
    assert all(s['parent'] is None for s in spans)
    every = HOST_SPANS.spans()
    for enq in (s for s in spans if s['name'] == 'serve.enqueue'):
        kids = _children(every, enq)
        assert kids.count('step.wait') >= 2
        assert set(kids) == {'step.wait', 'h2d.wait'}


def test_service_trace_on_the_profiles_timeline(rb3, tmp_path):
    """``device_profile`` yields the trace's time base; the service's
    ``dump_trace`` with it puts each request's ``execute`` span on the
    profiler's clock around the dispatcher's ``serve.*`` host spans, and
    adds them to the file."""
    mp, cfg = rb3
    bits = np.random.default_rng(2).integers(0, 2, (8, mp.n_cores, 2),
                                             dtype=np.int32)
    with ExecutionService(InterpreterConfig(**cfg), devices=['cpu'],
                          max_batch_programs=1, max_wait_ms=1.0,
                          trace_sample=1.0) as svc:
        with profiling.device_profile(str(tmp_path / 'prof')) as prof:
            svc.submit(mp, bits).result(timeout=T)
        assert prof.base_ns is not None and prof.trace.endswith(
            '.pt.trace.json')
        path = tmp_path / 'requests.json'
        n = svc.dump_trace(str(path), base_ns=prof.base_ns)
    doc = json.loads(path.read_text())
    assert doc['baseTimeNanoseconds'] == prof.base_ns
    assert n == len(doc['traceEvents'])
    ev = doc['traceEvents']
    execute, = [e for e in ev if e['name'] == 'execute']
    host = [e for e in ev if e['cat'] == 'host'
            and e['name'].startswith('serve.')]
    assert [e['name'] for e in host] == ['serve.pack', 'serve.enqueue',
                                         'serve.copy', 'serve.demux']
    slack = 1e3                                  # µs: the clocks' offset
    for e in host[:3]:
        assert execute['ts'] - slack <= e['ts']
        assert e['ts'] + e['dur'] <= execute['ts'] + execute['dur'] + slack


def test_wall_offset_from_paired_reads():
    off = wall_offset_s()
    t_mono = time.monotonic()
    t_wall = time.time()
    assert abs(t_wall - t_mono - off) < 5e-3


def test_chrome_export_on_the_profilers_clock():
    """With ``base_ns`` the request spans move from ``time.monotonic()``
    to the profiler's clock, and the host spans join them, one row per
    thread; without it the export is rebased as before."""
    tracer = Tracer(1.0)
    ctx = tracer.maybe_start()
    t0 = time.monotonic()
    ctx.span('execute', t0, t0 + 0.25, device='cpu:0')
    ctx.instant('done', t=t0 + 0.25)
    host = [{'name': 'serve.enqueue', 't0': 5_000_000_000,
             't1': 5_000_002_500, 'args': {}, 'id': 1, 'parent': None,
             'thread': 77}]
    rebased = chrome_trace_events(tracer.contexts(), pid='svc')
    assert [e['ts'] for e in rebased] == [0.0, 250000.0]
    base = 1_000_000_000
    ev = chrome_trace_events(tracer.contexts(), pid='svc', base_ns=base,
                             host_spans=host)
    assert [e['name'] for e in ev] == ['execute', 'done', 'serve.enqueue']
    want = (t0 + wall_offset_s()) * 1e6 - base / 1e3
    assert abs(ev[0]['ts'] - want) < 5e3       # within 5 ms
    assert ev[0]['dur'] == 250000.0
    assert ev[2] == {'name': 'serve.enqueue', 'cat': 'host', 'ph': 'X',
                     'pid': 'svc', 'tid': 'thread-77', 'ts': 4000000.0,
                     'dur': 2.5}


def test_device_profile_writes_host_spans_beside_its_trace(tmp_path):
    with profiling.device_profile(str(tmp_path)):
        with host_span('outer', 'k', 3):
            torch.ones(8).sum()
    traces = sorted(tmp_path.glob('*.pt.trace.json'))
    beside = sorted(tmp_path.glob('*.host_spans.json'))
    assert len(traces) == 1 and len(beside) == 1
    assert beside[0].name.split('.')[:2] == traces[0].name.split('.')[:2]
    prof = json.loads(traces[0].read_text())
    doc = json.loads(beside[0].read_text())
    assert doc['baseTimeNanoseconds'] == prof.get('baseTimeNanoseconds', 0)
    ev, = doc['traceEvents']
    span, = HOST_SPANS.spans()
    assert ev['name'] == 'outer' and ev['args'] == {'k': 3}
    assert ev['ts'] == round((span['t0'] - doc['baseTimeNanoseconds'])
                             / 1e3, 3)
    # the profiler's own events sit on the same base
    tss = [e['ts'] for e in prof['traceEvents']
           if e.get('ph') == 'X' and e.get('name') == 'aten::ones']
    assert tss and ev['ts'] <= min(tss) <= ev['ts'] + ev['dur']


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the card)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_spans_under_the_benchmarks_cuda_only_profile(card, rb3):
    """Under a CUDA-only profile (the benchmark's ``--trace 1``) the
    dispatcher thread's ``serve.*`` spans record, and a span around a
    kernel launch and ``synchronize()`` contains that kernel's device
    interval."""
    mp, cfg = rb3
    bits = np.random.default_rng(2).integers(0, 2, (64, mp.n_cores, 2),
                                             dtype=np.int32)
    x = torch.ones(1 << 20, device=card)
    with ExecutionService(InterpreterConfig(**cfg), max_batch_programs=2,
                          max_wait_ms=20.0) as svc:
        svc.warmup([svc.bucket_spec(mp, shots=64, n_programs=p,
                                    cfg=InterpreterConfig(**cfg))
                    for p in (1, 2)])
        (x * 2).sum()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            handles = [svc.submit(mp, bits) for _ in range(2)]
            for h in handles:
                h.result(timeout=T)
            with host_span('probe.wait'):
                y = torch.cumsum(x, 0)
                torch.cuda.synchronize()
    assert float(y[-1]) == float(1 << 20)
    got = _by_name(HOST_SPANS.spans())
    assert {'serve.pack', 'serve.enqueue', 'serve.copy',
            'serve.demux'} <= set(got)
    assert all(s['thread'] != threading.get_ident()
               for s in got['serve.enqueue'])
    probe, = got['probe.wait']
    # what the device ran from the launch on: the scan, inside the span
    launched = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and e.start_ns() >= probe['t0']]
    assert launched, 'no device activity after the launch'
    assert all(t1 <= probe['t1'] for _t0, t1 in launched), \
        (probe['t0'], probe['t1'], launched)
