"""Continuous-batching benchmark: the service's reason to exist, timed.

One workload, two executions: ``n_reqs`` independent single-program
requests (distinct random RB sequences — the realistic many-users
shape) run (a) sequentially, one ``simulate_batch`` dispatch per
program, and (b) through :class:`~.service.ExecutionService`, which
coalesces them into shape-bucketed multi-program dispatches.  Both
sides use the same normalized generic-engine cfg and both rounds are
timed WARM (a cold round runs first to pay each shape's first
run), so the ratio isolates the dispatch economics: N host
round-trips vs ~1.  Results are asserted bit-identical before any
number is reported.

Two further modes probe the multi-device pool:

* :func:`multi_device_scaling` — the pod-scale headline: the same
  closed-loop workload at dp=1/2/... per-device executors, warm,
  bit-identity asserted per request before any timing, per-device
  traffic recorded from ``stats()``.
* :func:`open_loop_latency` — p50/p99 request latency under a seeded
  Poisson-ish MIXED-bucket arrival process (open loop: arrivals do not
  wait for completions, so queueing delay is measured honestly instead
  of being hidden by submit backpressure).

Further rows time the chaos-injected service, tenant isolation, the
fleet of replica processes through a SIGKILL, fleet observability, the
compile front door and the calibration loop.  Every function takes
``device=`` (default the card): the torch device its services, replicas
and solo references run on (``'cpu'`` on a host without a card, where a
count of executors repeats the one CPU device).  ``warm_retraces`` of
:func:`continuous_batching_comparison` counts the timed round's
dispatches that the service's own cold/warm classifier marks cold after
its warm-up (eager torch has nothing to retrace; 0 on a warmed
service).

Shared by the ``serve-bench`` CLI subcommand.  ``python -m
distributed_processor_tpu_torch.serve.benchmark scaling|openloop ...``
runs one mode standalone and prints its JSON row.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from .. import isa
from ..models import active_reset, make_default_qchip, rb_ensemble
from ..pipeline import compile_to_machine
from ..sim.interpreter import InterpreterConfig, simulate_batch
from .bucketspec import BucketSpec
from .catalog import BucketCatalog
from .service import ExecutionService, _normalize_cfg, _to_host


def _on_card(device) -> bool:
    return device is None or torch.device(device).type == 'cuda'


def _service_devices(device, n: int = None):
    """``devices=`` for a benchmark's service: ``n`` executors (None:
    one) on ``device`` — the first ``n`` cards for the card (None keeps
    the service's default, one executor on the card), the one device
    repeated otherwise."""
    if _on_card(device):
        return n
    return [device] * (n or 1)


def _fleet_service(device) -> dict:
    """The replicas' ``devices`` entry of a fleet's ``service=`` dict:
    none on the card (one executor each), the device otherwise."""
    return {} if _on_card(device) else {'devices': [str(device)]}


def _fleet_env(device) -> dict:
    """Replica environment: one intra-op thread each on the CPU, so the
    replicas and the router share the host's cores."""
    return {} if _on_card(device) else {'OMP_NUM_THREADS': '1'}


def continuous_batching_comparison(n_reqs: int = 32, n_qubits: int = 2,
                                   depth: int = 2, shots: int = 32,
                                   seed: int = 0,
                                   max_wait_ms: float = 100.0,
                                   trace_sample: float = 0.0,
                                   trace_out: str = None,
                                   service_kwargs: dict = None,
                                   device=None) -> dict:
    """Warm throughput of ``n_reqs`` service submissions vs the same
    requests dispatched sequentially; returns a JSON-able row.

    ``trace_sample`` > 0 turns on per-request tracing in the measured
    service (the observability-overhead bench varies it); ``trace_out``
    exports the warm round's Chrome-trace JSON (docs/OBSERVABILITY.md);
    ``service_kwargs`` forwards extra :class:`ExecutionService` knobs
    (the integrity-overhead bench varies ``audit_sample`` /
    ``audit_mode`` through it)."""
    qubits = [f'Q{i}' for i in range(n_qubits)]
    qchip = make_default_qchip(n_qubits)
    mps = [compile_to_machine(active_reset(qubits) + prog, qchip,
                              n_qubits=n_qubits)
           for prog in rb_ensemble(qubits, depth, n_reqs, seed=seed)]
    C = mps[0].n_cores
    bucket = max(isa.shape_bucket(mp.n_instr) for mp in mps)
    cfg = InterpreterConfig(max_steps=2 * bucket + 64,
                            max_pulses=bucket + 2, max_meas=2,
                            max_resets=2, record_pulses=False)
    rng = np.random.default_rng(11)
    bits = [rng.integers(0, 2, size=(shots, C, 2)).astype(np.int32)
            for _ in mps]

    def run_sequential():
        outs = []
        t0 = time.perf_counter()
        for mp, b in zip(mps, bits):
            # the host copy per call mirrors what the service hands back
            outs.append(_to_host(simulate_batch(mp, b, cfg=cfg,
                                                device=device)))
        return outs, time.perf_counter() - t0

    def run_service(dump_to=None, warm=False):
        svc = ExecutionService(cfg, max_batch_programs=n_reqs,
                               max_wait_ms=max_wait_ms,
                               max_queue=4 * n_reqs,
                               trace_sample=trace_sample,
                               trace_keep=2 * n_reqs,
                               devices=_service_devices(device),
                               **(service_kwargs or {}))
        try:
            if warm:
                # every pow2 occupancy the round can dispatch, so the
                # classifier's cold count after this point is the
                # timed round's own
                _warm_pow2(svc, mps[0], shots, max_programs=n_reqs)
            cold0 = svc.stats()['compile']['cold']
            t0 = time.perf_counter()
            handles = [svc.submit(mp, b) for mp, b in zip(mps, bits)]
            res = [h.result(timeout=600) for h in handles]
            dt = time.perf_counter() - t0
            stats = svc.stats()
            n_events = svc.dump_trace(dump_to) if dump_to else 0
        finally:
            svc.shutdown()
        return res, dt, stats, n_events, stats['compile']['cold'] - cold0

    # cold round pays every shape's first run on both sides
    run_sequential()
    run_service()
    # warm round is the measurement
    seq_outs, t_seq = run_sequential()
    svc_res, t_svc, stats, n_events, warm_retraces = run_service(
        dump_to=trace_out, warm=True)

    mismatch = []
    for i, (a, b) in enumerate(zip(svc_res, seq_outs)):
        for k in b:
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                mismatch.append(f'{i}:{k}')
    if mismatch:
        raise AssertionError(
            f'service results diverged from sequential dispatch: '
            f'{mismatch[:8]}')

    return {
        'n_reqs': n_reqs, 'n_qubits': n_qubits, 'depth': depth,
        'shots_per_req': shots, 'bucket_n_instr': bucket,
        'sequential_warm_s': round(t_seq, 4),
        'service_warm_s': round(t_svc, 4),
        'throughput_ratio': round(t_seq / t_svc, 2),
        'dispatches': stats['dispatches'],
        'mean_batch_occupancy': round(stats['coalesce_efficiency'], 2),
        'latency_p50_ms': round(stats['latency_p50_ms'], 3),
        'latency_p99_ms': round(stats['latency_p99_ms'], 3),
        'warm_retraces': warm_retraces,
        'bit_identical': True,
        'trace_sample': trace_sample,
        'trace_events': n_events,
        'audits': stats['integrity']['audits'],
        'audit_mismatches': stats['integrity']['mismatches'],
        'note': 'both sides warm, same generic-engine cfg; ratio is '
                'N per-program dispatches vs coalesced multi-program '
                'dispatch(es); results asserted bit-identical first; '
                'warm_retraces = timed dispatches classified cold after '
                'the warm-up',
    }


def _workload(n_reqs, n_qubits, depth, shots, seed):
    """(mps, bits, cfg): the RB many-users workload every serve bench
    mode shares — one shape bucket, distinct program contents."""
    qubits = [f'Q{i}' for i in range(n_qubits)]
    qchip = make_default_qchip(n_qubits)
    mps = [compile_to_machine(active_reset(qubits) + prog, qchip,
                              n_qubits=n_qubits)
           for prog in rb_ensemble(qubits, depth, n_reqs, seed=seed)]
    bucket = max(isa.shape_bucket(mp.n_instr) for mp in mps)
    cfg = InterpreterConfig(max_steps=2 * bucket + 64,
                            max_pulses=bucket + 2, max_meas=2,
                            max_resets=2, record_pulses=False)
    rng = np.random.default_rng(seed + 11)
    bits = [rng.integers(0, 2, size=(shots, mps[0].n_cores, 2))
            .astype(np.int32) for _ in mps]
    return mps, bits, cfg


def _solo_refs(mps, bits, cfg, device=None):
    """Per-request references for the bit-identity gate, under the same
    normalized cfg the service will use, as host arrays."""
    ncfg, _ = _normalize_cfg(cfg, isa.shape_bucket(mps[0].n_instr))
    return [_to_host(simulate_batch(mp, b, cfg=ncfg, device=device))
            for mp, b in zip(mps, bits)]


def _assert_bit_identical(results, refs, label):
    mismatch = []
    for i, (got, want) in enumerate(zip(results, refs)):
        for k in want:
            if not np.array_equal(np.asarray(got[k]),
                                  np.asarray(want[k])):
                mismatch.append(f'{i}:{k}')
    if mismatch:
        raise AssertionError(
            f'{label}: service results diverged from solo dispatch: '
            f'{mismatch[:8]}')


def _warm_pow2(svc, mp, shots, cfg=None, max_programs=None):
    """AOT-warm every pow2 occupancy of ``mp``'s bucket on every device
    with one ``warmup()`` call.  With ``pad_programs`` (the default)
    live batches only ever dispatch at pow2 occupancies up to the batch
    cap, so a warmed ladder means the timed round is cold-free.  The
    ladder tops out at the cap rounded UP to a pow2 (a 6-deep batch
    pads to 8)."""
    cap = int(max_programs if max_programs is not None
              else svc.max_batch_programs)
    specs, p = [], 1
    while True:
        specs.append(svc.bucket_spec(mp, shots=shots,
                                     n_programs=min(p, cap), cfg=cfg))
        if p >= cap:
            break
        p *= 2
    return svc.warmup(specs)


def multi_device_scaling(dp_list=(1, 2), n_reqs: int = 32,
                         n_qubits: int = 2, depth: int = 2,
                         shots: int = 64, seed: int = 0,
                         max_batch_programs: int = None,
                         max_wait_ms: float = 50.0,
                         device=None) -> dict:
    """Pod-scale headline: warm closed-loop shots/s of the SAME
    workload served by 1, 2, ... per-device executors.

    Per dp the service is warmed on every device first (so the timed
    round measures steady-state serving, not cold shapes), every
    request's
    result is asserted bit-identical to its solo dispatch BEFORE the
    timed round, and ``stats()`` must show dispatch traffic on every
    device (the bucket is shared, so devices past the home only get
    work via stealing).  On the card, dp counts cards
    (``torch.cuda.device_count()``); on the CPU each executor repeats
    the one CPU device, and ``host_cpu_count`` is recorded because they
    share the host's cores.
    """
    dp_list = sorted(set(int(d) for d in dp_list))
    if dp_list[0] < 1:
        raise ValueError(f'dp counts must be >= 1; got {dp_list}')
    if _on_card(device):
        avail = torch.cuda.device_count()
        if dp_list[-1] > avail:
            raise ValueError(
                f'dp={dp_list[-1]} needs that many visible devices; '
                f'this process sees {avail} CUDA device(s)')
    mps, bits, cfg = _workload(n_reqs, n_qubits, depth, shots, seed)
    # enough ripe batches per round that every executor gets work:
    # n_reqs/mb >= 2*dp for the largest dp
    mb = max_batch_programs or max(1, n_reqs // (2 * dp_list[-1]))
    refs = _solo_refs(mps, bits, cfg, device)
    rows, base_sps = {}, None
    for dp in dp_list:
        svc = ExecutionService(cfg, max_batch_programs=mb,
                               max_wait_ms=max_wait_ms,
                               max_queue=4 * n_reqs,
                               devices=_service_devices(device, dp))
        try:
            _warm_pow2(svc, mps[0], shots, max_programs=mb)
            # untimed round: residual cold shapes + the bit-identity gate
            handles = [svc.submit(mp, b) for mp, b in zip(mps, bits)]
            res = [h.result(timeout=600) for h in handles]
            _assert_bit_identical(res, refs, f'dp{dp} pre-timing')
            t0 = time.perf_counter()
            handles = [svc.submit(mp, b) for mp, b in zip(mps, bits)]
            res = [h.result(timeout=600) for h in handles]
            dt = time.perf_counter() - t0
            _assert_bit_identical(res, refs, f'dp{dp} timed')
            stats = svc.stats()
        finally:
            svc.shutdown()
        active = sum(1 for d in stats['devices'] if d['dispatches'] > 0)
        if active < dp:
            raise AssertionError(
                f'dp{dp}: only {active}/{dp} devices saw dispatch '
                f'traffic — routing/stealing failed to spread the load')
        sps = n_reqs * shots / dt
        base_sps = base_sps if base_sps is not None else sps
        rows[f'dp{dp}'] = {
            'warm_s': round(dt, 4),
            'shots_per_sec': round(sps, 1),
            'speedup_vs_dp1': round(sps / base_sps, 2),
            'devices_active': active,
            'steals': stats['steals'],
            'compile_cold': stats['compile']['cold'],
            'compile_warm': stats['compile']['warm'],
            'per_device_dispatches': [d['dispatches']
                                      for d in stats['devices']],
        }
    return {
        'n_reqs': n_reqs, 'n_qubits': n_qubits, 'depth': depth,
        'shots_per_req': shots, 'max_batch_programs': mb,
        'host_cpu_count': os.cpu_count(),
        'bit_identical': True,
        **rows,
        'note': 'warm closed-loop rounds, every device warmed first; '
                'bit-identity vs solo dispatch asserted per request '
                'before timing; CPU executors share the host, which '
                'bounds their speedup by host_cpu_count',
    }


def open_loop_latency(n_reqs: int = 48, rate_hz: float = 40.0,
                      n_qubits: int = 2, depths=(2, 12),
                      shots: int = 16, seed: int = 0, devices=None,
                      max_batch_programs: int = 4,
                      max_wait_ms: float = 5.0, slo: bool = False,
                      warmup_catalog: str = None,
                      trace_sample: float = 0.0,
                      trace_out: str = None, device=None) -> dict:
    """Open-loop serving latency: p50/p99 under a seeded Poisson-ish
    mixed-bucket arrival process.

    Closed-loop throughput hides queueing: submitters wait for results,
    so the queue never builds.  Here arrivals follow pre-drawn
    exponential inter-arrival gaps (open loop — a request is submitted
    at its scheduled time no matter how backed up the service is; the
    service shards over ``devices`` executors on ``device``) and
    each request draws one of ``depths``'s shape buckets at random, so
    the coalescer sees the realistic interleaved-tenant mix.  Every
    executable shape is warmed on every device first; the reported
    p50/p99 are the service's own submit-to-done percentiles over
    exactly these requests.  Bit-identity is asserted per request
    before any number is reported.

    ``slo=True`` is the latency-SLO cold-start headline: the SAME
    arrival trace runs twice — first against a cold service with an
    empty ``warmup_catalog`` (the catalog learns each dispatched
    bucket, and every bucket's first timed request runs cold: the
    allocator grows to its working set), then against a fresh service that replays the (pow2-
    completed) catalog at startup.  Before the warmed timed round one
    probe request per bucket is asserted bit-identical to the solo
    reference AND asserted to have classified warm; the
    warmed round must then show ``cold_hits == 0`` and a lower p99
    than the unwarmed round — i.e. the catalog provably moved the cold
    start out of the serving tail.  ``warmup_catalog`` names the
    catalog file (a temp file when None in slo mode; in normal mode it
    is simply handed to the service for replay + recording).
    """
    rng = np.random.default_rng(seed)
    per_bucket = {d: _workload(max(1, n_reqs // len(depths)), n_qubits,
                               d, shots, seed + 17 * i)
                  for i, d in enumerate(depths)}
    choice = rng.integers(0, len(depths), size=n_reqs)
    gaps = rng.exponential(1.0 / rate_hz, size=n_reqs)
    reqs = []                       # (mp, bits, cfg, depth)
    for i in range(n_reqs):
        d = depths[choice[i]]
        mps, bits, cfg = per_bucket[d]
        j = i % len(mps)
        reqs.append((mps[j], bits[j], cfg, d))
    refs = {d: _solo_refs(*per_bucket[d], device) for d in depths}

    def _new_service(catalog=None):
        return ExecutionService(max_batch_programs=max_batch_programs,
                                max_wait_ms=max_wait_ms,
                                max_queue=4 * n_reqs,
                                devices=_service_devices(device, devices),
                                warmup_catalog=catalog,
                                trace_sample=trace_sample,
                                trace_keep=2 * n_reqs)

    def _await_replay(svc, timeout_s=600.0):
        deadline = time.monotonic() + timeout_s
        while svc.stats()['warmup']['in_progress'] > 0:
            if time.monotonic() > deadline:
                raise AssertionError('catalog replay never finished')
            time.sleep(0.01)

    def _run_arrivals(svc):
        """The timed open-loop round; (results, wall, pre, stats)."""
        pre = svc.stats()
        t0 = time.perf_counter()
        handles = []
        for (mp, bits, cfg, _d), gap in zip(reqs, gaps):
            time.sleep(float(gap))
            handles.append(svc.submit(mp, bits, cfg=cfg))
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        return results, wall, pre, svc.stats()

    def _check_bits(results, label):
        for (mp, bits, cfg, d), got, i in zip(reqs, results,
                                              range(n_reqs)):
            want = refs[d][i % len(refs[d])]
            for k in want:
                if not np.array_equal(np.asarray(got[k]),
                                      np.asarray(want[k])):
                    raise AssertionError(
                        f'{label}: open-loop request {i} (depth {d}) '
                        f'diverged from solo dispatch on {k!r}')

    slo_row = None
    if slo:
        cat_path, tmp_dir = warmup_catalog, None
        if cat_path is None:
            tmp_dir = tempfile.mkdtemp(prefix='dproc-catalog-')
            cat_path = os.path.join(tmp_dir, 'buckets.json')
        try:
            # phase A — cold: the catalog file does not exist yet, so
            # nothing replays; each bucket's first dispatch runs cold
            # INSIDE the timed window and the service records every
            # dispatched spec into the catalog.
            svc = _new_service(cat_path)
            try:
                res_a, wall_a, pre_a, st_a = _run_arrivals(svc)
            finally:
                svc.shutdown()
            _check_bits(res_a, 'unwarmed phase')
            cold_unwarmed = (st_a['compile']['cold']
                             - pre_a['compile']['cold'])
            # complete the learned catalog with the full pow2
            # occupancy ladder: phase A's organic batch occupancies
            # depend on arrival timing, and the faster warmed phase
            # can coalesce differently — the ladder covers every shape
            # pad_programs can produce, deterministically.
            cat = BucketCatalog(cat_path)
            for d in depths:
                mps_d, _, cfg_d = per_bucket[d]
                ncfg, _ = _normalize_cfg(
                    cfg_d, isa.shape_bucket(mps_d[0].n_instr))
                tmpl = BucketSpec.from_program(mps_d[0], ncfg)
                p = 1
                while p <= max_batch_programs:
                    cat.record(tmpl.bind(n_programs=p, n_shots=shots))
                    p *= 2
            catalog_specs = len(cat)
            # phase B — warm: a fresh service replays the catalog on
            # its background warmup thread; wait it out, then gate on
            # the probes before timing anything.
            svc = _new_service(cat_path)
            try:
                _await_replay(svc)
                s0 = svc.stats()
                probes = []
                for d in depths:
                    mps_d, bits_d, cfg_d = per_bucket[d]
                    probes.append((d, svc.submit(mps_d[0], bits_d[0],
                                                 cfg=cfg_d)))
                for d, h in probes:
                    got = h.result(timeout=600)
                    want = refs[d][0]
                    for k in want:
                        if not np.array_equal(np.asarray(got[k]),
                                              np.asarray(want[k])):
                            raise AssertionError(
                                f'warmed probe (depth {d}) '
                                f'diverged from solo dispatch on '
                                f'{k!r}')
                s1 = svc.stats()
                probe_cold = (s1['compile']['cold']
                              - s0['compile']['cold'])
                if probe_cold:
                    raise AssertionError(
                        f'{probe_cold} probe request(s) classified '
                        f'COLD after catalog replay — the warm-up '
                        f'missed their shapes')
                results, wall, pre, stats = _run_arrivals(svc)
                if trace_out:
                    svc.dump_trace(trace_out)
            finally:
                svc.shutdown()
            _check_bits(results, 'warmed phase')
        finally:
            if tmp_dir is not None:
                import shutil
                shutil.rmtree(tmp_dir, ignore_errors=True)
        cold_hits = (stats['compile']['cold']
                     - pre['compile']['cold'])
        if cold_hits:
            raise AssertionError(
                f'{cold_hits} cold dispatch(es) inside the warmed timed '
                f'round — catalog replay did not cover the traffic')
        p99_unwarmed = st_a['latency_p99_ms']
        p99_warmed = stats['latency_p99_ms']
        if cold_unwarmed > 0 and not (p99_warmed < p99_unwarmed):
            raise AssertionError(
                f'warmed p99 {p99_warmed:.3f}ms is not below unwarmed '
                f'p99 {p99_unwarmed:.3f}ms despite {cold_unwarmed} '
                f'cold dispatch(es) in the unwarmed round')
        slo_row = {
            'catalog_specs': catalog_specs,
            'catalog_path': warmup_catalog,   # None when a temp file
            'unwarmed': {
                'latency_p50_ms': round(st_a['latency_p50_ms'], 3),
                'latency_p99_ms': round(p99_unwarmed, 3),
                'cold_hits': cold_unwarmed,
                'wall_s': round(wall_a, 4),
            },
            'warmed': {
                'latency_p50_ms': round(stats['latency_p50_ms'], 3),
                'latency_p99_ms': round(p99_warmed, 3),
                'cold_hits': cold_hits,
                'wall_s': round(wall, 4),
                'aot_compiled': stats['warmup']['aot_compiled'],
                'replayed': stats['warmup']['replayed'],
            },
            'p99_improvement': (
                round(p99_unwarmed / p99_warmed, 2)
                if p99_warmed > 0 else None),
            'probe_bit_identical': True,
        }
    else:
        svc = _new_service(warmup_catalog)
        try:
            if warmup_catalog:
                _await_replay(svc)
            # warm every pow2 occupancy x bucket x device the open
            # loop can produce (pad_programs keeps live batches on
            # these shapes)
            for d in depths:
                mps, _, cfg = per_bucket[d]
                _warm_pow2(svc, mps[0], shots, cfg=cfg,
                           max_programs=max_batch_programs)
            results, wall, pre, stats = _run_arrivals(svc)
            if trace_out:
                svc.dump_trace(trace_out)
        finally:
            svc.shutdown()
        _check_bits(results, 'open loop')
    occ = stats['batch_occupancy']
    row = {
        'n_reqs': n_reqs, 'offered_rate_hz': rate_hz,
        'achieved_rate_hz': round(n_reqs / wall, 2),
        'depths': list(depths), 'shots_per_req': shots,
        'n_devices': stats['n_devices'],
        'latency_p50_ms': round(stats['latency_p50_ms'], 3),
        'latency_p99_ms': round(stats['latency_p99_ms'], 3),
        'mean_batch_occupancy': round(stats['coalesce_efficiency'], 2),
        'batch_occupancy': {int(k): v for k, v in occ.items()},
        'dispatches': stats['dispatches'],
        'steals': stats['steals'],
        'cold_compiles_timed': (stats['compile']['cold']
                                - pre['compile']['cold']),
        'bit_identical': True,
        'note': 'seeded exponential inter-arrival gaps, mixed shape '
                'buckets, all executable shapes warmed on all devices '
                'first; p50/p99 are service submit-to-done percentiles',
    }
    if slo_row is not None:
        row['slo'] = slo_row
        row['note'] = (
            'slo mode: same seeded arrival trace run cold (catalog '
            'learning, cold shapes in-window) then warm (catalog '
            'replay); '
            'per-bucket probes asserted bit-identical and warm-'
            'classified before timing; headline fields are the warmed '
            'round')
    return row


def availability_under_chaos(n_reqs: int = 80, rate_hz: float = 60.0,
                             n_qubits: int = 2, depth: int = 2,
                             shots: int = 8, seed: int = 0,
                             devices=None,
                             max_batch_programs: int = 4,
                             max_wait_ms: float = 5.0,
                             p_crash: float = 0.08,
                             p_hang: float = 0.02,
                             p_slow: float = 0.10,
                             hang_s: float = 1.0,
                             hang_timeout_s: float = 0.4,
                             device=None) -> dict:
    """Availability headline: goodput and p99 latency of an open-loop
    arrival stream while the chaos monkey injects executor crashes,
    hangs and slowdowns under ``_run_batch``.

    The supervision stack (bounded retries, breaker quarantine, hang
    watchdog, canary re-admission) is what keeps goodput near 1.0
    here — with it, an injected fault costs a retry, not a lost or
    hung request.  Every completed request is asserted bit-identical
    to its solo dispatch and every handle must terminate (zero hung)
    BEFORE any number is reported; availability that corrupts bits
    would not be availability."""
    from .chaos import ChaosMonkey, ChaosPlan, soak
    from .supervise import RetryPolicy
    mps, _bits, cfg = _workload(min(n_reqs, 16), n_qubits, depth,
                                shots, seed)
    rng = np.random.default_rng(seed + 23)
    gaps = rng.exponential(1.0 / rate_hz, size=n_reqs)
    svc = ExecutionService(
        cfg, max_batch_programs=max_batch_programs,
        max_wait_ms=max_wait_ms, max_queue=4 * n_reqs,
        devices=_service_devices(device, devices),
        retry_policy=RetryPolicy(max_attempts=5, backoff_s=0.01),
        hang_timeout_s=hang_timeout_s, breaker_threshold=3,
        breaker_cooldown_ms=100.0, supervise_interval_ms=10.0)
    plan = ChaosPlan(seed=seed, p_crash=p_crash, p_hang=p_hang,
                     p_slow=p_slow, hang_s=hang_s, slow_s=0.01)
    try:
        _warm_pow2(svc, mps[0], shots,
                   max_programs=max_batch_programs)

        def pace(i):
            time.sleep(float(gaps[i]))

        t0 = time.perf_counter()
        with ChaosMonkey(svc, plan) as monkey:
            report = soak(svc, mps, cfg, n_requests=n_reqs,
                          shots=shots, seed=seed,
                          result_timeout_s=600.0, submit_hook=pace,
                          device=device)
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.shutdown()
    if report.hung:
        raise AssertionError(
            f'{report.hung} request(s) never terminated under chaos — '
            f'the supervision layer failed its core guarantee')
    if report.bit_mismatches:
        raise AssertionError(
            f'{report.bit_mismatches} completed request(s) diverged '
            f'from solo dispatch under chaos')
    offered = report.submitted + report.rejected
    return {
        'n_reqs': n_reqs, 'offered_rate_hz': rate_hz,
        'depth': depth, 'shots_per_req': shots,
        'n_devices': stats['n_devices'],
        'injected': dict(sorted(monkey.injected.items())),
        'goodput_fraction': round(
            report.completed / max(offered, 1), 4),
        'completed': report.completed,
        'failed_typed': dict(sorted(report.errors.items())),
        'rejected': report.rejected,
        'hung': report.hung,
        'retries': stats['retries'],
        'retry_exhausted': stats['retry_exhausted'],
        'breaker_trips': stats['breaker_trips'],
        'readmissions': stats['readmissions'],
        'hangs_detected': stats['hangs'],
        'executor_deaths': stats['executor_deaths'],
        # the service's own submit-to-done percentiles (recorded at
        # fulfill time); soak's harvest-order timings would overstate
        'latency_p50_ms': round(stats['latency_p50_ms'], 3),
        'latency_p99_ms': round(stats['latency_p99_ms'], 3),
        'wall_s': round(wall, 4),
        'bit_identical': True,
        'note': 'open-loop seeded arrivals with crash/hang/slowdown '
                'injection under _run_batch; every completion '
                'bit-checked vs solo dispatch and every handle must '
                'terminate before numbers are reported; goodput = '
                'completed / offered',
    }


def tenant_isolation(n_victim: int = 8, greedy_factor: int = 8,
                     n_qubits: int = 2, depth: int = 2,
                     shots: int = 8, seed: int = 0,
                     max_batch_programs: int = 4,
                     max_wait_ms: float = 5.0,
                     victim_weight: float = 8.0,
                     max_p99_ratio: float = 1.5,
                     p99_slack_ms: float = 250.0,
                     device=None) -> dict:
    """Tenant isolation headline: what weighted fair queueing buys the
    victim of a greedy neighbor (docs/SERVING.md "Tenants").

    One adversarial arrival shape, two fresh services: a greedy tenant
    dumps its whole backlog (``greedy_factor * n_victim`` requests)
    into the queue, then a victim tenant submits ``n_victim`` requests
    behind it.  Fair-OFF (``tenant_fair=False`` — the pre-tenant
    arrival-order scheduler) makes the victim wait out the entire
    greedy backlog; fair-ON runs deficit round-robin with the victim
    weighted ``victim_weight``x, interleaving it into the very next
    batches.  Both rounds are AOT-warmed first and every victim
    completion is asserted bit-identical to its solo dispatch.  The
    fair-ON round must additionally hold the isolation contract before
    any number is reported: ZERO victim sheds, zero victim quota
    rejections, EXACTLY ``n_victim * shots`` metered victim shots
    (billing ground truth), and a victim p99 within ``max_p99_ratio``
    of the fair-OFF p99 plus ``p99_slack_ms`` (on fast hosts the
    greedy backlog drains quickly and both tails are small — the bound
    guards regression, the reported tails are the evidence).
    """
    n_greedy = greedy_factor * n_victim
    mps, bits, cfg = _workload(n_victim, n_qubits, depth, shots, seed)
    refs = _solo_refs(mps, bits, cfg, device)
    tenants = {'greedy': {'weight': 1.0},
               'victim': {'weight': float(victim_weight)}}
    rounds = {}
    for label, fair in (('fair_off', False), ('fair_on', True)):
        svc = ExecutionService(
            cfg, max_batch_programs=max_batch_programs,
            max_wait_ms=max_wait_ms,
            max_queue=4 * (n_greedy + n_victim),
            tenants=tenants, tenant_fair=fair,
            devices=_service_devices(device))
        try:
            _warm_pow2(svc, mps[0], shots,
                       max_programs=max_batch_programs)
            t0 = time.perf_counter()
            greedy_handles = [
                svc.submit(mps[i % len(mps)], bits[i % len(bits)],
                           tenant='greedy')
                for i in range(n_greedy)]
            victim = []                 # (handle, ref idx, t_submit)
            for i in range(n_victim):
                victim.append((svc.submit(mps[i], bits[i],
                                          tenant='victim'),
                               i, time.perf_counter()))
            lat_ms = []
            for h, i, ts in victim:
                got = h.result(timeout=600)
                lat_ms.append((time.perf_counter() - ts) * 1e3)
                want = refs[i]
                for k in want:
                    if not np.array_equal(np.asarray(got[k]),
                                          np.asarray(want[k])):
                        raise AssertionError(
                            f'{label}: victim request {i} diverged '
                            f'from solo dispatch on {k!r}')
            for h in greedy_handles:
                h.result(timeout=600)
            wall = time.perf_counter() - t0
            ts = svc.stats()['tenants']
        finally:
            svc.shutdown()
        rounds[label] = {
            'victim_p50_ms': round(float(np.percentile(lat_ms, 50)), 3),
            'victim_p99_ms': round(float(np.percentile(lat_ms, 99)), 3),
            'wall_s': round(wall, 4),
            'victim': {k: ts['victim'][k] for k in
                       ('completed', 'shed', 'quota_rejected',
                        'shots')},
            'greedy_completed': ts['greedy']['completed'],
        }
    on, off = rounds['fair_on'], rounds['fair_off']
    v = on['victim']
    if v['shed'] or v['quota_rejected']:
        raise AssertionError(
            f"fair-on round shed {v['shed']} / quota-rejected "
            f"{v['quota_rejected']} victim request(s) — the greedy "
            f'tenant exported its pain')
    if v['shots'] != n_victim * shots:
        raise AssertionError(
            f"victim metered {v['shots']} shots, ground truth is "
            f'{n_victim * shots} — billing is not exactly-once')
    if on['victim_p99_ms'] > (max_p99_ratio * off['victim_p99_ms']
                              + p99_slack_ms):
        raise AssertionError(
            f"fair-on victim p99 {on['victim_p99_ms']}ms exceeds "
            f"{max_p99_ratio}x the fair-off p99 "
            f"{off['victim_p99_ms']}ms (+{p99_slack_ms}ms slack) — "
            f'fair queueing made the victim WORSE')
    return {
        'n_victim': n_victim, 'n_greedy': n_greedy,
        'shots_per_req': shots, 'victim_weight': victim_weight,
        **rounds,
        'victim_p99_ratio_on_vs_off': (
            round(on['victim_p99_ms'] / off['victim_p99_ms'], 3)
            if off['victim_p99_ms'] > 0 else None),
        'bit_identical': True,
        'note': 'greedy backlog submitted first, victim behind it; '
                'fair-off = arrival order, fair-on = DRR with the '
                'victim weighted; victim completions bit-checked vs '
                'solo dispatch; fair-on asserted zero victim sheds, '
                'exact victim billing, bounded p99 before reporting',
    }


def fleet_failover(n_replicas: int = 2, n_reqs: int = 60,
                   rate_hz: float = 30.0, n_qubits: int = 2,
                   depth: int = 2, shots: int = 8, seed: int = 0,
                   kill_at_frac: float = 0.33,
                   kill_window_s: float = 2.0, device=None) -> dict:
    """Fleet availability headline: goodput through a timed replica
    SIGKILL (docs/FLEET.md).

    An open-loop stream runs against ``n_replicas`` replica processes
    behind the FleetRouter; a third of the way in, the replica
    carrying the load is SIGKILLed.  The router recovers its in-flight
    requests onto survivors and the fleet monitor respawns the dead
    replica from the shared warm tiers.  The row asserts the contract
    before reporting a single number: zero hung handles, every
    completion bit-identical to solo dispatch, every failure typed,
    and goodput STRICTLY POSITIVE inside ``kill_window_s`` after the
    kill — a fleet that pauses while a replica is down has not
    federated anything.  The replicas run on ``device`` (one executor
    each; every replica on the one card when the host has one)."""
    from .chaos import fleet_soak
    from .fleet import Fleet
    mps, bits, cfg = _workload(min(n_reqs, 12), n_qubits, depth,
                               shots, seed)
    kill_i = max(1, int(n_reqs * kill_at_frac))
    t_start = time.perf_counter()
    with Fleet(
            n_replicas,
            service={'max_batch_programs': 4, 'max_wait_ms': 5.0,
                     'max_queue': 4 * n_reqs,
                     'max_est_wait_ms': 5000.0,
                     **_fleet_service(device)},
            env=_fleet_env(device),
    ) as fleet:
        # warm EVERY replica on the workload bucket directly (bucket
        # affinity would otherwise leave the failover target cold and
        # the kill window would measure its first dispatch, not the
        # router)
        for rid in fleet.replica_ids():
            fleet.router.call_replica(
                rid, 'submit',
                dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
                timeout_s=600.0)
        t0 = time.perf_counter()
        report = fleet_soak(
            fleet, mps, cfg, n_requests=n_reqs, shots=shots,
            seed=seed, rate_hz=rate_hz,
            actions=[(kill_i, 'kill', -1)],
            result_timeout_s=600.0, device=device)
        wall = time.perf_counter() - t0
        stats = fleet.stats()
    boot_s = t0 - t_start
    if report.hung:
        raise AssertionError(
            f'{report.hung} request(s) never terminated across the '
            f'replica kill — the fleet failed its core guarantee')
    if report.bit_mismatches:
        raise AssertionError(
            f'{report.bit_mismatches} completed request(s) diverged '
            f'from solo dispatch across the replica kill')
    kill_t = next(t for t, m, _ in report.actions if m == 'kill')
    ok_in_kill = report.ok_in_window(kill_t, kill_t + kill_window_s)
    if ok_in_kill == 0:
        raise AssertionError(
            f'goodput hit zero inside the {kill_window_s}s kill '
            f'window — survivors did not absorb the failover')
    offered = report.submitted + report.rejected
    return {
        'n_replicas': n_replicas, 'n_reqs': n_reqs,
        'offered_rate_hz': rate_hz, 'depth': depth,
        'shots_per_req': shots,
        'goodput_fraction': round(
            report.completed / max(offered, 1), 4),
        'completed': report.completed,
        'failed_typed': dict(sorted(report.errors.items())),
        'rejected': report.rejected,
        'hung': report.hung,
        'kill_t_s': round(kill_t, 3),
        'ok_in_kill_window': ok_in_kill,
        'kill_window_goodput_rps': round(
            ok_in_kill / kill_window_s, 2),
        'retries': stats['retries'],
        'retry_exhausted': stats['retry_exhausted'],
        'failovers': stats['failovers'],
        'replica_down': stats['replica_down'],
        'replica_up': stats['replica_up'],
        'respawns': sum(p['respawns']
                        for p in stats['processes'].values()),
        'latency_p50_ms': round(stats['latency_p50_ms'], 3),
        'latency_p99_ms': round(stats['latency_p99_ms'], 3),
        'fleet_boot_s': round(boot_s, 3),
        'wall_s': round(wall, 4),
        'bit_identical': True,
        'note': 'open-loop stream over replica processes; the loaded '
                'replica is SIGKILLed mid-stream and respawned from '
                'the shared warm tiers; every completion bit-checked '
                'vs solo dispatch, every handle must terminate, and '
                'goodput must stay positive through the kill window',
    }


def fleet_observability_overhead(n_replicas: int = 2,
                                 n_reqs: int = 24,
                                 n_qubits: int = 2, depth: int = 2,
                                 shots: int = 8, seed: int = 0,
                                 sampled: float = 0.25,
                                 device=None) -> dict:
    """What FLEET observability costs: the same closed-loop workload
    through one fleet at trace_sample off / ``sampled`` / full
    (docs/OBSERVABILITY.md "Fleet observability").

    One fleet serves all three rounds (``set_trace_sample`` retunes the
    router's sampler live; the sampling decision rides the wire, so the
    replicas' piggyback cost follows the router's rate with no replica
    restart).  Every replica is warmed on the workload bucket before
    the off round, so round-to-round deltas isolate the tracing tax:
    wire-frame trace ids, replica-side span capture, piggybacked span
    return, and router-side stitching + clock alignment.  The full
    round must actually retain stitched traces — a zero-span "full"
    round would report an overhead it never paid."""
    from .fleet import Fleet
    mps, bits, cfg = _workload(n_reqs, n_qubits, depth, shots, seed)
    refs = _solo_refs(mps, bits, cfg, device)
    rounds = (('off', 0.0), ('sampled', float(sampled)),
              ('full', 1.0))
    out = {'n_replicas': n_replicas, 'n_reqs': n_reqs,
           'shots_per_req': shots}
    with Fleet(
            n_replicas,
            service={'max_batch_programs': 4, 'max_wait_ms': 5.0,
                     'max_queue': 4 * n_reqs,
                     'max_est_wait_ms': 5000.0,
                     **_fleet_service(device)},
            env=_fleet_env(device),
    ) as fleet:
        for rid in fleet.replica_ids():
            fleet.router.call_replica(
                rid, 'submit',
                dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
                timeout_s=600.0)
        # untimed round: residual cold shapes at occupancy > 1 + the
        # bit-identity gate, so the off round is a true warm baseline
        handles = [fleet.submit(mp, b, cfg=cfg)
                   for mp, b in zip(mps, bits)]
        res = [h.result(timeout=600) for h in handles]
        _assert_bit_identical(res, refs, 'fleet-obs pre-timing')
        base_s = None
        for label, sample in rounds:
            fleet.set_trace_sample(sample)
            spans0 = sum(len(c.spans)
                         for c in fleet.router.trace_contexts())
            t0 = time.perf_counter()
            handles = [fleet.submit(mp, b, cfg=cfg)
                       for mp, b in zip(mps, bits)]
            res = [h.result(timeout=600) for h in handles]
            dt = time.perf_counter() - t0
            _assert_bit_identical(res, refs, f'fleet-obs {label}')
            spans = sum(len(c.spans)
                        for c in fleet.router.trace_contexts()) \
                - spans0
            entry = {'trace_sample': sample,
                     'wall_s': round(dt, 4),
                     'reqs_per_sec': round(n_reqs / dt, 2),
                     'stitched_spans': spans}
            if base_s is None:
                base_s = dt
            elif base_s > 0:
                entry['overhead_vs_off'] = round(dt / base_s - 1.0, 4)
            out[label] = entry
        if out['full']['stitched_spans'] <= 0:
            raise AssertionError(
                'full round retained no stitched spans — the fleet '
                'trace path is not actually on, the reported overhead '
                'is fiction')
        if out['off']['stitched_spans'] != 0:
            raise AssertionError(
                f"off round stitched {out['off']['stitched_spans']} "
                f'spans — sampling off must cost (and record) nothing')
    out['bit_identical'] = True
    out['note'] = ('one fleet, three closed-loop rounds with the '
                   'router sampler retuned live; replicas warmed '
                   'before the off round; every completion bit-checked '
                   'vs solo dispatch')
    return out


def compile_front_door(n_tenants: int = 4, n_programs: int = 4,
                       n_qubits: int = 2, depth: int = 4,
                       shots: int = 8, seed: int = 0,
                       stampede_threads: int = 8,
                       max_wait_ms: float = 5.0, device=None) -> dict:
    """The multi-tenant compile front door, timed: ``n_tenants`` tenants
    each submit the SAME ``n_programs`` textbook programs (the cloud
    workload: a million users, one RB curriculum).

    Three executions of the N x M duplicate-program traffic: (a)
    uncached compile-per-request — every tenant pays a full
    ``compile_to_machine``; (b) the content-addressed cache, cold — M
    compiles, everything else hits; (c) the cache fully warm.  The row
    asserts the contract before reporting numbers: exactly M cold
    compiles, a 100% warm hit rate, an ``stampede_threads``-way
    concurrent stampede on a fresh program compiling EXACTLY once
    (singleflight), cached programs byte-identical to direct compiles,
    ``submit_source`` results bit-identical to compile+submit, and a
    >= 10x warm speedup.
    """
    import threading
    from ..compilecache import CompileCache, machine_program_bytes
    qubits = [f'Q{i}' for i in range(n_qubits)]
    qchip = make_default_qchip(n_qubits)
    sources = [active_reset(qubits) + p
               for p in rb_ensemble(qubits, depth, n_programs,
                                    seed=seed)]
    traffic = sources * n_tenants       # every tenant, every program

    t0 = time.perf_counter()
    direct = {}
    for i, prog in enumerate(traffic):
        mp = compile_to_machine(prog, qchip, n_qubits=n_qubits)
        if i < n_programs:
            direct[i] = mp
    t_uncached = time.perf_counter() - t0

    cache = CompileCache()
    t0 = time.perf_counter()
    for prog in traffic:
        cache.get_or_compile(prog, qchip, n_qubits=n_qubits)
    t_cold = time.perf_counter() - t0
    st = cache.stats()
    cold_compiles, cold_hits = st['misses'], st['hits']
    t0 = time.perf_counter()
    cached = [cache.get_or_compile(prog, qchip, n_qubits=n_qubits)[0]
              for prog in traffic]
    t_warm = time.perf_counter() - t0
    warm_hits = cache.stats()['hits'] - cold_hits

    if cold_compiles != n_programs:
        raise AssertionError(
            f'{cold_compiles} cold compiles for {n_programs} distinct '
            f'programs — content addressing failed to dedup')
    if warm_hits != len(traffic):
        raise AssertionError(
            f'warm pass hit {warm_hits}/{len(traffic)} — cache lost '
            f'entries it should have kept')
    for i in range(n_programs):
        if (machine_program_bytes(cached[i])
                != machine_program_bytes(direct[i])):
            raise AssertionError(
                f'cached program {i} is not byte-identical to its '
                f'direct compile')
    warm_speedup = t_uncached / t_warm
    if warm_speedup < 10.0:
        raise AssertionError(
            f'warm speedup {warm_speedup:.1f}x < 10x — the front door '
            f'is not paying for itself on duplicate traffic')

    # singleflight: a concurrent stampede on a program the cache has
    # never seen must compile exactly once (waiters that arrive after
    # the flight lands count as plain hits — equally deduplicated)
    fresh = active_reset(qubits) + rb_ensemble(
        qubits, depth, 1, seed=seed + 999)[0]
    misses_before = cache.stats()['misses']
    barrier = threading.Barrier(stampede_threads)

    def _stampede():
        barrier.wait()
        cache.get_or_compile(fresh, qchip, n_qubits=n_qubits)

    threads = [threading.Thread(target=_stampede)
               for _ in range(stampede_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stampede_compiles = cache.stats()['misses'] - misses_before
    if stampede_compiles != 1:
        raise AssertionError(
            f'{stampede_threads}-way stampede compiled '
            f'{stampede_compiles} times — singleflight failed')

    # submit_source end-to-end: bit-identical to compile+submit
    svc = ExecutionService(max_wait_ms=max_wait_ms,
                           compile_cache=cache,
                           devices=_service_devices(device))
    try:
        refs = [svc.submit(direct[i], shots=shots).result(timeout=600)
                for i in range(n_programs)]
        handles = [svc.submit_source(p, qchip, shots=shots,
                                     n_qubits=n_qubits)
                   for p in sources]
        res = [h.result(timeout=600) for h in handles]
        _assert_bit_identical(res, refs, 'submit_source')
        svc_stats = svc.stats()
    finally:
        svc.shutdown()

    cc = svc_stats['compile_cache']
    return {
        'n_tenants': n_tenants, 'n_programs': n_programs,
        'n_qubits': n_qubits, 'depth': depth,
        'traffic_requests': len(traffic),
        'uncached_s': round(t_uncached, 4),
        'cached_cold_s': round(t_cold, 4),
        'cached_warm_s': round(t_warm, 4),
        'cold_compiles': cold_compiles,
        'warm_hit_rate': 1.0,
        'traffic_speedup': round(t_uncached / t_cold, 2),
        'warm_speedup': round(warm_speedup, 1),
        'stampede_threads': stampede_threads,
        'stampede_compiles': stampede_compiles,
        'singleflight_waits': cc['singleflight_waits'],
        'compile_ms_p50': cc['compile_ms_p50'],
        'compile_ms_p99': cc['compile_ms_p99'],
        'bit_identical': True,
        'note': 'N tenants x M duplicate programs; asserted before '
                'reporting: M cold compiles, 100% warm hits, stampede '
                'compiles exactly once, cached bytes == direct bytes, '
                'submit_source bit-identical to compile+submit, '
                'warm speedup >= 10x',
    }


def calibration_loop(knob: str = 'amplitude', n_qubits: int = 2,
                     shots: int = 8, true_x90: float = 0.52,
                     lr: float = None, max_steps: int = None,
                     device=None) -> dict:
    """Closed-loop gradient calibration through the serve tier, timed
    (docs/CALIBRATION.md).

    Three runs of one knob's gradient-descent loop (calib/loops.py) on
    a live qchip whose device truth drifted (``true_x90`` vs the
    nominal 0.48 for the amplitude knob):

    1. **writeback run** — the headline: candidates through
       ``submit_source`` under a ``CalibrationSession``, convergence
       ASSERTED before any number reports (tuned value within 5e-3 of
       the truth, stale compile-cache epoch flushed by the
       post-writeback probe, exactly one lineage ``writeback_flush``);
    2. **cold rerun** — the same loop, no writeback, compiling its
       candidate ladder fresh under the post-writeback epoch;
    3. **warm rerun** — identical to (2): every candidate must re-hit
       the compile cache (the warm hit fraction is asserted == 1.0,
       the trajectory asserted identical to the cold rerun's).

    The row reports steps-to-converge, per-run wall time, the warm hit
    fraction and warm speedup, and the service's calibration session
    accounting.
    """
    from ..calib import calibrate
    from ..sim.grad import LossSpec
    spec = (LossSpec(knob='amplitude', x90_amp=true_x90)
            if knob == 'amplitude' else None)
    qchip = make_default_qchip(n_qubits)
    svc = ExecutionService(devices=_service_devices(device))
    try:
        t0 = time.perf_counter()
        res = calibrate(svc, qchip, knob=knob, qubit='Q0', spec=spec,
                        lr=lr, max_steps=max_steps, shots=shots,
                        n_qubits=n_qubits, device=device)
        t_loop = time.perf_counter() - t0
        if not res.converged:
            raise AssertionError(
                f'{knob} loop failed to converge in {res.steps} steps: '
                f'{res.detail.get("reason")}')
        if knob == 'amplitude' and \
                abs(res.params['amp'] - true_x90) > 5e-3:
            raise AssertionError(
                f'converged amp {res.params["amp"]:.5f} not within '
                f'5e-3 of the device truth {true_x90}')
        if res.fp_before == res.fp_after:
            raise AssertionError('writeback did not move the '
                                 'calibration epoch')
        if not 1 <= res.flushed <= res.steps:
            raise AssertionError(
                f'post-writeback probe flushed {res.flushed} entries '
                f'for a {res.steps}-step loop')
        cache = svc.compile_cache
        if cache.stats()['writeback_flushes'] != 1:
            raise AssertionError(
                f'{cache.stats()["writeback_flushes"]} lineage '
                f'writeback flushes for one writeback')

        # cold/warm rerun pair under the post-writeback epoch: the
        # trajectory depends only on (start, lr, spec), so the reruns
        # retrace the same candidate ladder — first compiles it,
        # second must re-hit every rung
        t0 = time.perf_counter()
        cold = calibrate(svc, qchip, knob=knob, qubit='Q0', spec=spec,
                         lr=lr, max_steps=max_steps, shots=shots,
                         n_qubits=n_qubits, write_back=False,
                         device=device)
        t_cold = time.perf_counter() - t0
        hits0 = cache.stats()['hits']
        t0 = time.perf_counter()
        warm = calibrate(svc, qchip, knob=knob, qubit='Q0', spec=spec,
                         lr=lr, max_steps=max_steps, shots=shots,
                         n_qubits=n_qubits, write_back=False,
                         device=device)
        t_warm = time.perf_counter() - t0
        warm_hit_fraction = \
            (cache.stats()['hits'] - hits0) / max(warm.steps, 1)
        if warm.losses != cold.losses:
            raise AssertionError('warm rerun trajectory diverged from '
                                 'the cold rerun')
        if warm_hit_fraction < 1.0:
            raise AssertionError(
                f'warm rerun hit only {warm_hit_fraction:.2f} of its '
                f'candidate compiles — the calibration ladder fell '
                f'out of the cache')
        calib_stats = svc.stats()['calibration']
    finally:
        svc.shutdown()
    return {
        'knob': knob, 'n_qubits': n_qubits, 'shots': shots,
        'steps_to_converge': res.steps,
        'converged_params': {k: round(v, 6)
                             for k, v in res.params.items()},
        'loss_first': res.losses[0], 'loss_final': res.losses[-1],
        'epoch_entries_flushed': res.flushed,
        'writeback_flushes': 1,
        'loop_s': round(t_loop, 4),
        'cold_rerun_s': round(t_cold, 4),
        'warm_rerun_s': round(t_warm, 4),
        'warm_hit_fraction': warm_hit_fraction,
        'warm_speedup': round(t_cold / t_warm, 2) if t_warm else None,
        'sessions': calib_stats,
        'note': 'asserted before reporting: convergence to the drifted '
                'device truth, epoch moved by writeback, exactly the '
                'stale epoch flushed (one lineage flush), warm rerun '
                '100% cache hits with an identical trajectory',
    }


def _main(argv=None):
    """Standalone entry: ``python -m distributed_processor_tpu_torch.
    serve.benchmark [--device cpu] scaling|openloop|frontdoor|tenants|
    chaos ...`` prints one JSON row (``--device``: the torch device,
    default the card)."""
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog='python -m distributed_processor_tpu_torch.serve.benchmark')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the card)')
    sub = ap.add_subparsers(dest='mode', required=True)
    s = sub.add_parser('scaling', help='closed-loop dp scaling row')
    s.add_argument('--dp', default='1,2')
    s.add_argument('--reqs', type=int, default=32)
    s.add_argument('--shots', type=int, default=64)
    s.add_argument('--depth', type=int, default=2)
    s.add_argument('--qubits', type=int, default=2)
    s.add_argument('--seed', type=int, default=0)
    o = sub.add_parser('openloop', help='open-loop latency row')
    o.add_argument('--reqs', type=int, default=48)
    o.add_argument('--rate', type=float, default=40.0)
    o.add_argument('--shots', type=int, default=16)
    o.add_argument('--depths', default='2,12')
    o.add_argument('--devices', type=int, default=None)
    o.add_argument('--qubits', type=int, default=2)
    o.add_argument('--seed', type=int, default=0)
    o.add_argument('--slo', action='store_true',
                   help='cold-vs-warm catalog SLO comparison')
    o.add_argument('--warmup-catalog', default=None,
                   help='bucket catalog path to replay/record')
    f = sub.add_parser('frontdoor', help='compile front-door row')
    f.add_argument('--tenants', type=int, default=4)
    f.add_argument('--programs', type=int, default=4)
    f.add_argument('--depth', type=int, default=4)
    f.add_argument('--shots', type=int, default=8)
    f.add_argument('--qubits', type=int, default=2)
    f.add_argument('--seed', type=int, default=0)
    f.add_argument('--stampede', type=int, default=8)
    t = sub.add_parser('tenants', help='tenant-isolation row')
    t.add_argument('--victims', type=int, default=8)
    t.add_argument('--greedy-factor', type=int, default=8)
    t.add_argument('--shots', type=int, default=8)
    t.add_argument('--depth', type=int, default=2)
    t.add_argument('--qubits', type=int, default=2)
    t.add_argument('--seed', type=int, default=0)
    t.add_argument('--victim-weight', type=float, default=8.0)
    c = sub.add_parser('chaos', help='availability-under-chaos row')
    c.add_argument('--reqs', type=int, default=80)
    c.add_argument('--rate', type=float, default=60.0)
    c.add_argument('--shots', type=int, default=8)
    c.add_argument('--depth', type=int, default=2)
    c.add_argument('--devices', type=int, default=None)
    c.add_argument('--qubits', type=int, default=2)
    c.add_argument('--seed', type=int, default=0)
    c.add_argument('--p-crash', type=float, default=0.08)
    c.add_argument('--p-hang', type=float, default=0.02)
    c.add_argument('--p-slow', type=float, default=0.10)
    args = ap.parse_args(argv)
    if args.mode == 'scaling':
        row = multi_device_scaling(
            dp_list=[int(x) for x in args.dp.split(',') if x],
            n_reqs=args.reqs, n_qubits=args.qubits, depth=args.depth,
            shots=args.shots, seed=args.seed, device=args.device)
    elif args.mode == 'openloop':
        row = open_loop_latency(
            n_reqs=args.reqs, rate_hz=args.rate, n_qubits=args.qubits,
            depths=[int(x) for x in args.depths.split(',') if x],
            shots=args.shots, seed=args.seed, devices=args.devices,
            slo=args.slo, warmup_catalog=args.warmup_catalog,
            device=args.device)
    elif args.mode == 'tenants':
        row = tenant_isolation(
            n_victim=args.victims, greedy_factor=args.greedy_factor,
            n_qubits=args.qubits, depth=args.depth, shots=args.shots,
            seed=args.seed, victim_weight=args.victim_weight,
            device=args.device)
    elif args.mode == 'frontdoor':
        row = compile_front_door(
            n_tenants=args.tenants, n_programs=args.programs,
            n_qubits=args.qubits, depth=args.depth, shots=args.shots,
            seed=args.seed, stampede_threads=args.stampede,
            device=args.device)
    else:
        row = availability_under_chaos(
            n_reqs=args.reqs, rate_hz=args.rate, n_qubits=args.qubits,
            depth=args.depth, shots=args.shots, seed=args.seed,
            devices=args.devices, p_crash=args.p_crash,
            p_hang=args.p_hang, p_slow=args.p_slow, device=args.device)
    print(json.dumps(row))


if __name__ == '__main__':
    _main()
