"""Open-loop tenants on the port's in-process ``ExecutionService``.

Requests arrive at ``rate_hz`` for the window: ``round(rate_hz x
seconds)`` arrivals whose gaps are the exponential distribution's
quantiles at that rate, in an order drawn from the seed, so every seed
offers the same gaps (Poisson-like arrivals, the same load).  Request
``k`` runs one of a pool of ``n_programs`` distinct programs of the
configuration's family (drawn from the seed, compiled in set-up; the
order cycles through the pool in permutations drawn from the seed) at
``shots`` shots with its own measured bits (``bit_pool`` arrays drawn
from the seed, each slot 1 with probability ``p1[slot]``).  The service
coalesces with ``max_batch_programs`` and ``max_wait_ms``.

Every request is timed from its due time to its result on the host; a
request that fails, is shed or never returns within ``grace_s`` of the
last arrival counts at the time the run gave up on it.  The submitter's
lateness (submit time less due time) is printed.  The end-to-end metric
is the goodput: the requests answered within ``slo_ms`` of their due
time, per second of the window.  The tail, ``request_p95_ms``, is read
per layer, over the whole window of a traced run: the profiler, whose
start and stop each hold the host for seconds, runs only in a segment
after the window (``traced_segment``), on the schedule's first
``trace_seconds`` of arrivals again.

The comparison: every request must return, and ``check_requests``
requests drawn from the seed are held shot by shot, every compared
output, against the oracle run once per pattern of the bits their
reads consume.
"""

from __future__ import annotations

import importlib
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..harness.common import derive_seed, p95
from ..reference import lanes
from .physics_batches import interpreter_config

# threads that wait on results: more than the requests that are ever
# outstanding below the rate the service sustains
WAITERS = 256

KEYS = ('n_pulses', 'n_meas', 'n_resets', 'time', 'qclk', 'offset', 'pc',
        'done', 'err', 'fault', 'regs', 'rst_time', 'meas_avail')


def schedule(seed: int, rate_hz: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of the window's arrivals:
    the exponential quantiles at ``rate_hz`` as gaps, permuted by
    ``seed``."""
    n = max(1, int(round(rate_hz * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_hz
    rng = np.random.default_rng(derive_seed(seed, 0x67617073))
    return np.cumsum(rng.permutation(gaps))


def assignment(seed: int, n_req: int, n_programs: int) -> np.ndarray:
    """Request -> program: the pool in a fresh permutation per cycle."""
    rng = np.random.default_rng(derive_seed(seed, 0x70726f67))
    cycles = math.ceil(n_req / n_programs)
    return np.concatenate([rng.permutation(n_programs)
                           for _ in range(cycles)])[:n_req]


def bit_pool(seed: int, n: int, shots: int, C: int, p1) -> list:
    out = []
    for j in range(n):
        rng = np.random.default_rng(derive_seed(seed, 0x62697473, j))
        u = rng.random((shots, C, len(p1)))
        out.append((u < np.asarray(p1)[None, None, :]).astype(np.int32))
    return out


def setup(ctx) -> dict:
    from distributed_processor_tpu_torch.serve import ExecutionService
    conf, tr = ctx.cell.config, ctx.traffic
    prog = importlib.import_module(
        f'benchmark.programs.{conf["program"]["kind"]}')
    n_prog = int(tr['n_programs'])
    pool_seed = derive_seed(ctx.seed, 0x706f6f6c)
    sources = prog.sources(conf['program'], n_programs=n_prog,
                           seed=pool_seed)
    qchip = prog.qchip_source(conf['program'])
    mps = [prog.port_program(conf['program'], s, qchip) for s in sources]
    cfg = interpreter_config(conf, max(mps, key=lambda m: m.n_instr))
    B, C = int(tr['shots']), mps[0].n_cores
    due = schedule(ctx.seed, float(tr['rate_hz']), ctx.seconds)
    which = assignment(ctx.seed, len(due), n_prog)
    bits = bit_pool(ctx.seed, int(tr['bit_pool']), B, C, tr['p1'])
    rng = np.random.default_rng(derive_seed(ctx.seed, 0x636865636b))
    sample = set(rng.choice(len(due), min(int(tr['check_requests']),
                                             len(due)), replace=False).tolist())
    devices = None if ctx.device == 'cuda' else [ctx.device]
    svc = ExecutionService(
        cfg, max_batch_programs=int(tr['max_batch_programs']),
        max_wait_ms=float(tr['max_wait_ms']), devices=devices,
        trace_sample=1.0 if ctx.tracer.enabled else 0.0,
        trace_keep=len(due) + 64)
    # warm the pow2 occupancy ladder the coalescer dispatches into
    P = int(tr['max_batch_programs'])
    ladder = [1 << j for j in range(P.bit_length()) if 1 << j <= P]
    svc.warmup([svc.bucket_spec(mps[0], shots=B, n_programs=p, cfg=cfg)
                for p in ladder])
    ctx.sync()
    st = dict(prog=prog, sources=sources, qchip=qchip, mps=mps, cfg=cfg,
              B=B, C=C, due=due, which=which, bits=bits, sample=sample,
              svc=svc)
    return st


def _await(st, k: int, h, give_up: float, done_t: dict,
           results: dict) -> None:
    """Wait for request ``k`` (blocking, no polling) and time its result
    on the host; a request that fails, is shed or is not back by
    ``give_up`` is marked unanswered."""
    try:
        res = h.result(timeout=max(0.0, give_up - time.perf_counter()))
    except Exception as exc:        # failed, shed, or not back in time
        done_t[k] = None
        results.setdefault('_errors', []).append(
            f'{k}: {type(exc).__name__}: {exc}')
        return
    done_t[k] = time.perf_counter()
    if k in st['sample']:
        results[k] = res


def window(ctx, st) -> dict:
    svc, due, tr = st['svc'], st['due'], ctx.traffic
    done_t, results = {}, {}
    waiters = ThreadPoolExecutor(max_workers=WAITERS,
                                 thread_name_prefix='bench-wait')
    lateness = np.zeros(len(due))
    s0 = svc.stats()
    t0 = time.perf_counter()
    give_up = t0 + due[-1] + float(tr['grace_s'])
    for k, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        t_sub = time.perf_counter()
        try:
            h = svc.submit(st['mps'][st['which'][k]],
                           st['bits'][k % len(st['bits'])])
        except Exception as exc:                 # refused at admission
            done_t[k] = None
            results.setdefault('_errors', []).append(
                f'{k}: {type(exc).__name__}: {exc}')
            h = None
        lateness[k] = t_sub - (t0 + d)
        if h is not None:
            waiters.submit(_await, st, k, h, give_up, done_t, results)
    waiters.shutdown(wait=True)
    end = time.perf_counter()
    s1 = svc.stats()
    lat = []
    for k, d in enumerate(due):
        t = done_t.get(k)
        lat.append((t if t is not None else give_up) - (t0 + d))
    unanswered = sum(1 for k in range(len(due)) if done_t.get(k) is None)
    st.update(results=results, unanswered=unanswered, s0=s0, s1=s1,
              spans=[], lat=lat)
    if ctx.tracer.enabled:
        traced_segment(ctx, st)
    ctx.log(f'generator lateness over {len(due)} arrivals: median '
            f'{1e3 * float(np.median(lateness)):.3f} ms, p95 '
            f'{1e3 * p95(lateness):.3f} ms, max '
            f'{1e3 * float(lateness.max()):.3f} ms')
    for e in results.get('_errors', [])[:5]:
        ctx.log(f'request failed: {e}')
    lat_ms = 1e3 * np.asarray(lat)
    q = max(1, len(lat_ms) // 4)
    trend = float(np.median(lat_ms[-q:]) / np.median(lat_ms[:q]))
    slo_ms = float(tr['slo_ms'])
    # a failed, shed or unanswered request never meets the limit
    n_slo = sum(1 for k in range(len(due))
                if done_t.get(k) is not None and lat_ms[k] <= slo_ms)
    return dict(attempted=len(due), failed=unanswered,
                metrics={'goodput_rps': n_slo / ctx.seconds},
                latencies_ms=lat_ms.tolist(),
                note=f'{len(due)} requests at {tr["rate_hz"]} Hz over '
                     f'{end - t0:.4f} s; {n_slo} answered within '
                     f'{slo_ms:g} ms of their due time; due-to-result '
                     f'latency p50 {float(np.median(lat_ms)):.3f} ms, p95 '
                     f'{p95(lat_ms):.3f} ms, max '
                     f'{float(lat_ms.max()):.3f} ms; backlog trend (median '
                     f'of the last quarter over the first) {trend:.3f}; '
                     f'{s1["dispatches"] - s0["dispatches"]} batches, '
                     f'{s1["programs_dispatched"] - s0["programs_dispatched"]}'
                     f' programs')


def traced_segment(ctx, st) -> None:
    """After the window: the schedule's first ``trace_seconds`` of
    arrivals again, from an empty queue as the window started, under the
    profiler.  The profiler starts before the segment's first arrival
    and stops once its last result is back, so neither stalls an arrival
    of the window or of the segment."""
    svc, tr = st['svc'], ctx.traffic
    due = st['due'][st['due'] < float(tr['trace_seconds'])]
    ctx.tracer.start()
    st['s_trace0'], st['t_trace0'] = svc.stats(), time.monotonic()
    handles, errors = [], []
    t0 = time.perf_counter()
    for k, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            with ctx.span('arrival_wait'):
                time.sleep(wait)
        with ctx.span('submit'):
            try:
                handles.append(svc.submit(st['mps'][st['which'][k]],
                                          st['bits'][k % len(st['bits'])]))
            except Exception as exc:             # refused at admission
                errors.append(f'{type(exc).__name__}: {exc}')
    for h in handles:
        try:
            with ctx.span('result'):
                h.result(timeout=float(tr['grace_s']))
        except Exception as exc:        # failed, shed, or not back in time
            errors.append(f'{type(exc).__name__}: {exc}')
            continue
        st['spans'].extend(s for s in h.trace() or ()
                           if s['name'] == 'execute')
    for e in errors[:5]:
        ctx.log(f'traced segment: request failed: {e}')
    st['s_trace'], st['t_trace'] = svc.stats(), time.monotonic()
    ctx.tracer.stop(ctx.sync)


def _tables(ctx, st, feedback: bool = True) -> dict:
    """The reference tables of the sampled requests' programs."""
    conf = ctx.cell.config
    tables = {}
    for k in st['sample']:
        j = int(st['which'][k])
        if j not in tables:
            rmp = st['prog'].reference_program(
                conf['program'], st['sources'][j], st['qchip'])
            tables[j] = lanes.InjectedTable(
                rmp, {}, conf['interpreter']['max_meas'],
                conf['interpreter']['max_resets'], feedback=feedback)
    return tables


def judge(ctx, st, results: dict, unanswered: int) -> list:
    """The numbers compared: requests that never returned, and shots of
    the sampled requests that differ from the reference on any compared
    output."""
    import torch
    tables = _tables(ctx, st)
    bad_shots, per_key = 0, {}
    for k in st['sample']:
        res = results.get(k)
        if res is None:
            continue
        table = tables[int(st['which'][k])]
        bits = torch.as_tensor(st['bits'][k % len(st['bits'])])
        uniq, inv = torch.unique(table.codes(bits), return_inverse=True)
        tab = table.table(uniq.numpy())
        got = {key: torch.as_tensor(np.asarray(res[key])) for key in KEYS}
        c = lanes.compare(got, tab, inv, KEYS)
        bad_shots += c.pop('any')
        for key, v in c.items():
            per_key[key] = per_key.get(key, 0) + v
    ctx.log(f'compared every shot of {len(st["sample"])} requests drawn '
            f'from the seed; mismatches by output: {per_key}')
    return [('requests_unanswered', unanswered, 0),
            ('sampled_shots_differing', bad_shots, 0)]


def check(ctx, st) -> list:
    s0, s1 = st.get('s_trace0', st['s0']), st.get('s_trace', st['s1'])
    t_start = st.get('t_trace0', float('-inf'))
    t_end = st.get('t_trace', float('inf'))
    st['work'] = dict(
        batches=s1['dispatches'] - s0['dispatches'],
        programs=s1['programs_dispatched'] - s0['programs_dispatched'],
        execute_spans=sorted({(s['t0'], s['t1']) for s in st['spans']
                              if s.get('t1') is not None
                              and s['t0'] >= t_start
                              and s['t1'] <= t_end}))
    return judge(ctx, st, st['results'], st['unanswered'])


def control(ctx, st, n_requests: int) -> list:
    """The control at the cell's size: the reference with its
    feed-forward broken (every fproc read serves 0) put in the service's
    place for the sampled requests, judged as a window's requests are."""
    import torch
    broken = _tables(ctx, st, feedback=False)
    results = {}
    for k in sorted(st['sample'])[:n_requests]:
        table = broken[int(st['which'][k])]
        bits = torch.as_tensor(st['bits'][k % len(st['bits'])])
        uniq, inv = torch.unique(table.codes(bits), return_inverse=True)
        tab = table.table(uniq.numpy())
        results[k] = {key: tab[key][inv.numpy()] for key in KEYS}
    return judge(ctx, st, results, 0)


def release(st) -> None:
    """Shut the service down (its threads and device state) before the
    comparison runs."""
    svc = st.pop('svc', None)
    if svc is not None:
        svc.shutdown()
