"""A closed loop of GHZ parity-scan batches on the statevec device.

The window runs batches of ``shots`` back to back through the port's
``sim.physics.run_physics_batch`` (the configuration's engine ladder,
which picks the generic engine behind the discrete-event gate for a
statevec device with couplings; the step budget scaled by
``sim.physics.statevec_step_budget``, as ``Simulator.run`` scales it),
reduces each with ``parallel.sweep.physics_batch_stats(out,
outcome_slot=...)``, whose ``outcome_counts`` is the joint histogram of
every core's last read, and fetches the sums.  The program family's
programs take turns, from an offset drawn from the seed, and the window
ends at ``--seconds`` or, where that comes later, once every program
has run (a traced run's profile, and the host's reading of its events,
take seconds of the window).  Batch ``i``
draws its thermal initial states (``p1_init``) on the device from
``derive_seed(seed, i, 1)`` and runs with the noise seed
``derive_seed(seed, i)``.

Traffic keys: ``shots``, ``keep_batches`` (how many batches of the
window, drawn from the seed, keep every output for the per-shot
comparison), ``trace_seconds``.

The comparison:

* every batch's ``outcome_counts`` against ``B p`` of its program's
  exact distribution (:mod:`..reference.density`).  A bin's count is
  binomial, ``sd = sqrt(B p (1 - p))``: each bin must lie within
  ``5.5 sd + 3`` (5.5 sd is a two-sided Gaussian tail of 4e-8 a bin,
  so a run's ~6000 bins false-alarm well under one run in a hundred,
  and the 3 covers the heavier Poisson tail of bins with ``B p`` near
  0).  The bins together take a chi-square test: the bins with
  ``B p >= 5`` (where the chi-square law holds) and one bin pooling
  the rest, below the critical value of a 1e-6 false-alarm rate (a
  systematic error of a few parts in a thousand over the distribution
  exceeds it at 131072 shots, which single bins cannot see);
* each program's batches pooled, the same chi-square as a z score,
  ``(chi2 - dof) / sqrt(2 dof)``, below 5 (a false alarm of about 5e-6
  a program at the 180-256 degrees of freedom here, by the
  Wilson-Hilferty law; a bias too small for one batch to show grows
  with the pooled shots);
* the state's norm: in every batch the median over its shots of
  ``| |psi|^2 - 1 |`` below ``1e-5``.  At 131072 shots the histogram
  cannot tell a complex32 state from the configuration's complex64 (the
  reference held at float16 moves the distribution by a noncentrality
  of at most 4 against the chi-square's 180-256 degrees of freedom), but
  the norm can: held at float16 the reference loses 1.6e-3 to 2.7e-3 of
  its trace, where a complex64 shot's norm is off by about 1e-7.  The
  median, not the mean: a few shots a batch drift far more (up to 1e-2
  in 16384 CPU shots), enough to move a batch's mean by 4e-5;
* every shot of the kept batches, on every integer output, against the
  scalar oracle run with that shot's measured bits
  (:class:`..reference.lanes.InjectedTable`).

The per-layer work (``st['work']``) counts the traced batches, K2's
launches and windows in them, and the event gate's device counters.
"""

from __future__ import annotations

import functools
import importlib
import math
import time

import numpy as np

from ..harness.common import Reservoir, derive_seed, torch_seed
from ..reference import density, lanes
from ..roofline import resolve as resolve_work

# integer outputs compared shot by shot: the measured bits are the
# oracle's input, so they are not among them
KEYS = ('n_pulses', 'n_meas', 'n_resets', 'time', 'qclk', 'offset', 'pc',
        'done', 'err', 'fault', 'regs', 'rst_time', 'meas_avail',
        'meas_gtime', 'meas_bits_valid')
BIN_SD, BIN_SLACK, CHI2_ALARM = 5.5, 3.0, 1e-6
POOLED_Z, NORM_DRIFT = 5.0, 1e-5
OFFSET_WORD = 0x726f756e


def _init_states(seed: int, i: int, B: int, C: int, p1: float, device):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, i, 1))
    return (torch.rand((B, C), generator=gen, device=device)
            < p1).to(torch.int32)


def port_model(config: dict, couplings: tuple):
    """The configuration's readout and statevec device as the port's
    ``ReadoutPhysics``."""
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
    dev = {k: v for k, v in config['device'].items()
           if k not in ('kind', 'couplings')}
    r = dict(config['readout'])
    for k in ('g0', 'g1'):
        r[k] = complex(*r[k])
    return ReadoutPhysics(device=DeviceModel(
        'statevec', couplings=tuple(couplings), **dev), **r)


def interpreter_config(config: dict, mp, model):
    """The configuration's interpreter fields with the step and pulse
    budgets sized from the program, the steps scaled for the event gate."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    from distributed_processor_tpu_torch.sim.physics import \
        statevec_step_budget
    b = config['budget']
    cfg = InterpreterConfig(
        **config['interpreter'],
        max_steps=b['steps_per_instr'] * mp.n_instr + b['steps_plus'],
        max_pulses=int(mp.max_pulses_per_core(1)) + b['pulses_plus'])
    return statevec_step_budget(cfg, model, mp.n_cores)


def setup(ctx) -> dict:
    import torch
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import (
        prepare_physics_tables, run_physics_batch)
    cf, tr = ctx.cell.config, ctx.traffic
    prog = importlib.import_module(f'benchmark.programs.'
                                   f'{cf["program"]["kind"]}')
    srcs = prog.sources(cf['program'])
    qchip = prog.qchip_source(cf['program'])
    mps = [prog.port_program(cf['program'], s, qchip) for s in srcs]
    cps = prog.port_couplings(mps[0], qchip)
    model = port_model(cf, cps)
    cfgs = [interpreter_config(cf, mp, model) for mp in mps]
    dev = ctx.device
    tables = [prepare_physics_tables(mp, model, dev) for mp in mps]
    P = len(mps)
    st = dict(prog=prog, sources=srcs, qchip=qchip, mps=mps, couplings=cps,
              port_couplings=[prog.port_couplings(mp, qchip) for mp in mps],
              model=model, B=int(tr['shots']), C=mps[0].n_cores,
              p1=float(cf['readout']['p1_init']), slot=int(cf['outcome_slot']),
              offset=derive_seed(ctx.seed, OFFSET_WORD) % P)

    def batch(i: int):
        k = (st['offset'] + i) % P
        with ctx.span('batch'):
            init = _init_states(ctx.seed, i, st['B'], st['C'], st['p1'], dev)
            out = run_physics_batch(mps[k], model, derive_seed(ctx.seed, i),
                                    st['B'], init_states=init, cfg=cfgs[k],
                                    tables=tables[k], device=dev)
        with ctx.span('reduce'):
            stats = dict(physics_batch_stats(out, outcome_slot=st['slot']),
                         incomplete=out['incomplete'],
                         norm_drift=(torch.view_as_real(out['psi'])
                                     .square().sum((-2, -1),
                                                   dtype=torch.float64)
                                     - 1.0).abs().median())
            for key in ('gate_stall_steps', 'live_core_steps'):
                if key in out:
                    stats[key] = out[key]
        with ctx.span('fetch'):
            host = {key: v.cpu().numpy() for key, v in stats.items()}
        kept = {key: out[key] for key in KEYS + ('meas_bits',)}
        return k, init, kept, host

    st['batch'] = batch
    # every program runs at the one [B, 2^C] shape: one batch warms it
    st['batch'](-1)
    ctx.sync()
    return st


def window(ctx, st) -> dict:
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    keep = Reservoir(int(ctx.traffic['keep_batches']),
                     derive_seed(ctx.seed, 0x6b656570))
    sums, progs = [], []
    trace_s = float(ctx.traffic['trace_seconds'])
    k2 = resolve_windows_fused.launches

    def close_trace(n: int) -> None:
        ctx.tracer.stop(ctx.sync)
        st['traced_batches'] = n
        st['resolve_launches'] = resolve_windows_fused.launches - k2

    ctx.tracer.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        k, init, out, host = st['batch'](i)
        sums.append(host)
        progs.append(k)
        keep.offer((i, k, init, out))
        i += 1
        now = time.perf_counter() - t0
        if ctx.tracer.active and now >= trace_s:
            close_trace(i)
        if now >= ctx.seconds and len(set(progs)) == len(st['mps']):
            break
    wall = time.perf_counter() - t0
    if ctx.tracer.active:
        close_trace(i)
    st.update(sums=sums, progs=progs, kept=keep.items, n_batches=i,
              wall=wall)
    shots = i * st['B']
    failed = int(sum(int(np.asarray(h['fault_shots']).sum())
                     + int(h['err_shots']) for h in sums))
    return dict(attempted=shots, failed=failed,
                metrics={'shots_per_s': shots / wall},
                note=f'{i} batches of {st["B"]} shots in {wall:.4f} s, '
                     f'{len(set(progs))} programs')


@functools.lru_cache(maxsize=None)
def chi2_critical(dof: int, alarm: float = CHI2_ALARM) -> float:
    """The chi-square value with ``dof`` degrees of freedom that a true
    distribution exceeds with probability ``alarm``: bisection on the
    regularized upper incomplete gamma, ``Q(dof/2, x/2)``."""
    import torch
    lo, hi = 0.0, dof + 40.0 * math.sqrt(2.0 * dof) + 100.0
    a = torch.tensor(dof / 2.0, dtype=torch.float64)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        q = float(torch.special.gammaincc(a, torch.tensor(
            mid / 2.0, dtype=torch.float64)))
        lo, hi = (mid, hi) if q > alarm else (lo, mid)
    return hi


def judge_histogram(counts, p) -> tuple:
    """``(worst bin's share of its bound, chi-square's share of its
    critical value, shots binned)`` of one batch's histogram against the
    distribution ``p``."""
    n = np.asarray(counts, np.float64)
    N = n.sum()
    e = N * p
    bound = BIN_SD * np.sqrt(N * p * (1.0 - p)) + BIN_SLACK
    worst_bin = float(np.max(np.abs(n - e) / bound))
    big = e >= 5.0
    obs, exp = list(n[big]), list(e[big])
    if (~big).any():
        obs.append(n[~big].sum())
        exp.append(e[~big].sum())
    obs, exp = np.asarray(obs), np.asarray(exp)
    keep = exp > 0
    chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    dof = max(int(keep.sum()) - 1, 1)
    return worst_bin, chi2 / chi2_critical(dof), int(N)


def chi2_z(counts, p) -> float:
    """``(chi2 - dof) / sqrt(2 dof)`` over the bins with ``B p >= 5``
    and one pooling the rest."""
    n = np.asarray(counts, np.float64)
    e = n.sum() * p
    big = e >= 5.0
    obs = np.append(n[big], n[~big].sum())
    exp = np.append(e[big], e[~big].sum())
    keep = exp > 0
    dof = max(int(keep.sum()) - 1, 1)
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    return float((chi2 - dof) / math.sqrt(2 * dof))


def reference_setup(ctx, st) -> None:
    """The reference's compiled programs, coupling maps and channels."""
    cf = ctx.cell.config
    prog = st['prog']
    st['rmps'] = [prog.reference_program(cf['program'], s, st['qchip'])
                  for s in st['sources']]
    st['ref_couplings'] = prog.reference_couplings(
        st['rmps'][0], st['qchip'], int(cf['readout']['drive_elem']))
    st['channels'] = density.channels_from_config(
        cf, st['ref_couplings'], st['C'])


def judge(ctx, st, dists: dict, sums: list, progs: list,
          kept: list) -> list:
    """The numbers compared: the worst bin and chi-square of every
    batch's histogram against its program's distribution, the worst
    program's pooled chi-square z, the worst batch's ``norm_drift`` (the
    median over its shots of ``| |psi|^2 - 1 |``), the shots not binned,
    the programs the window did not reach,
    the coupling maps that differ between the two sides, and the kept
    batches' shots that differ from the oracle on any integer output."""
    cf = ctx.cell.config
    worst_bin = worst_chi2 = drift = 0.0
    unbinned = 0
    for h, k in zip(sums, progs):
        wb, wc, n = judge_histogram(h['outcome_counts'], dists[k])
        worst_bin, worst_chi2 = max(worst_bin, wb), max(worst_chi2, wc)
        unbinned += st['B'] - n
        drift = max(drift, float(h['norm_drift']))
    pooled = {}
    for h, k in zip(sums, progs):
        pooled[k] = pooled.get(k, 0) + np.asarray(h['outcome_counts'])
    zs = {k: chi2_z(n, dists[k]) for k, n in pooled.items()}
    ctx.log('pooled chi-square z by program: ' + ', '.join(
        f'{k}: {zs[k]:.2f} ({int(n.sum())} shots)'
        for k, n in sorted(pooled.items())))
    bad_shots, per_key, tables = 0, {}, {}
    for _i, k, init, out in kept:
        if k not in tables:
            tables[k] = lanes.InjectedTable(
                st['rmps'][k], {}, cf['interpreter']['max_meas'],
                cf['interpreter']['max_resets'])
        tab = tables[k]
        codes = tab.codes(out['meas_bits'])
        used = np.unique(codes.cpu().numpy())
        recs = tab.table(used)
        idx = torch_searchsorted(used, codes)
        c = lanes.compare(out, recs, idx, KEYS)
        bad_shots += c.pop('any')
        for key, v in c.items():
            per_key[key] = per_key.get(key, 0) + v
    maps = sum(cps != tuple(st['ref_couplings'])
               for cps in st['port_couplings'])
    ctx.log(f'compared {len(sums)} batches\' histograms over '
            f'{len(set(progs))} programs and every shot of {len(kept)} '
            f'kept batches; mismatches by output: {per_key}')
    return [('outcome_bin_worst_share_of_bound', worst_bin, 1.0),
            ('outcome_chi2_worst_share_of_critical', worst_chi2, 1.0),
            ('outcome_chi2_pooled_z_worst', max(zs.values(), default=0.0),
             POOLED_Z),
            ('norm_drift_median_worst', drift, NORM_DRIFT),
            ('shots_not_binned', unbinned, 0),
            ('programs_not_compared', len(st['mps']) - len(set(progs)), 0),
            ('coupling_maps_differing', int(maps), 0),
            ('kept_shots_differing', bad_shots, 0)]


def torch_searchsorted(used: np.ndarray, codes):
    """Each code's row in the sorted ``used`` codes, on the codes'
    device."""
    import torch
    return torch.searchsorted(torch.as_tensor(used, device=codes.device),
                              codes)


def _distributions(ctx, st, programs, feedback: bool = True) -> dict:
    return {k: density.outcome_distribution(
        st['rmps'][k], st['channels'], st['slot'], feedback=feedback)
        for k in sorted(set(programs))}


def check(ctx, st) -> list:
    reference_setup(ctx, st)
    dists = _distributions(ctx, st, st['progs'])
    n = st.get('traced_batches', st['n_batches'])
    traced = st['sums'][:n]
    # the resolve hop's work in the traced batches: every shot fires the
    # same windows whatever its outcomes (the reads are unconditional)
    cf = ctx.cell.config['interpreter']
    windows = samples = 0
    for k in st['progs'][:n]:
        rec = lanes.InjectedTable(st['rmps'][k], {}, cf['max_meas'],
                                  cf['max_resets']).table([0])
        windows += st['B'] * int(rec['n_meas'].sum())
        samples += st['B'] * int(rec['window_samples'].sum())
    gate = [sum(int(h[key]) for h in traced if key in h)
            for key in ('gate_stall_steps', 'live_core_steps')]
    st['work'] = dict(batches=n, windows=windows, samples=samples,
                      resolve_launches=st.get('resolve_launches'),
                      resolve_least_s=resolve_work.least_seconds(
                          windows, samples),
                      gate_stall_steps=gate[0] if gate[1] else None,
                      live_core_steps=gate[1] or None)
    return judge(ctx, st, dists, st['sums'], st['progs'], st['kept'])


def _drawn(ctx, st, dists: dict, progs: list) -> list:
    """Each batch's sums drawn from its program's distribution in
    ``dists``, which may hold less than 1: a reference has one state a
    program, so each shot's norm is off by what its trace is."""
    rng = np.random.default_rng(derive_seed(ctx.seed, 0x636f6e74))
    B = st['B']
    return [dict(outcome_counts=rng.multinomial(
        B, dists[k] / dists[k].sum()), norm_drift=abs(dists[k].sum() - 1))
        for k in progs]


def control(ctx, st, n_batches: int) -> list:
    """The control at the cell's size: the reference computed at the
    precision below the configuration's (the density matrix held at
    float16 after every channel: a complex32 state) put in the port's
    place for ``n_batches`` batches, each batch's histogram drawn from
    its distribution and its norm that matrix's trace, judged against the
    float64 reference as a window's batches are.  The precision leaves
    every integer output alone, so the kept shots are the oracle's own
    with feed-forward (they match).  The control with the feed-forward
    removed (:func:`control_feedforward`) runs after it, and its
    numbers are logged."""
    import torch
    reference_setup(ctx, st)
    P = len(st['mps'])
    progs = [(st['offset'] + i) % P for i in range(n_batches)]
    half = density.held_in(st['channels'], torch.float16)
    held = {k: density.outcome_distribution(st['rmps'][k], half, st['slot'])
            for k in sorted(set(progs))}
    kept = _oracle_kept(ctx, st, progs, feedback=True)
    checks = judge(ctx, st, _distributions(ctx, st, progs),
                   _drawn(ctx, st, held, progs), progs, kept)
    ff = control_feedforward(ctx, st, n_batches)
    ctx.log('control without feed-forward: ' + ', '.join(
        f'{n} = {v} (limit {lim})' for n, v, lim in ff)
        + f' -> {"fails" if any(v > lim for _n, v, lim in ff) else "PASSES"}')
    return checks


def _oracle_kept(ctx, st, progs: list, feedback: bool) -> list:
    """The kept batches of a control: each shot the oracle's run on the
    shot's thermal reset bits, every later read 0, with or without the
    feed-forward."""
    import torch
    cf = ctx.cell.config
    B, C = st['B'], st['C']
    kept = []
    for i in range(min(len(progs), int(ctx.traffic['keep_batches']))):
        k = progs[i]
        init = _init_states(ctx.seed, i, B, C, st['p1'], ctx.device)
        tab = lanes.InjectedTable(st['rmps'][k], {},
                                  cf['interpreter']['max_meas'],
                                  cf['interpreter']['max_resets'],
                                  feedback=feedback)
        bits = torch.zeros((B, C, cf['interpreter']['max_meas']),
                           dtype=torch.int32, device=ctx.device)
        bits[:, :, 0] = init             # the reset reads the thermal state
        codes = tab.codes(bits)
        used = np.unique(codes.cpu().numpy())
        recs = tab.table(used)
        idx = torch_searchsorted(used, codes)
        out = {key: torch.as_tensor(v, device=ctx.device)[idx]
               for key, v in recs.items()}
        out['meas_bits'] = bits
        kept.append((i, k, init, out))
    return kept


def control_feedforward(ctx, st, n_batches: int) -> list:
    """The reference with the reset's feed-forward removed (every fproc
    read serves 0) put in the port's place for ``n_batches`` batches:
    each batch's histogram drawn from that reference's distribution,
    each kept shot the oracle's run with no feed-forward on the shot's
    thermal reset bits, judged as a window's batches are."""
    reference_setup(ctx, st)
    P = len(st['mps'])
    progs = [(st['offset'] + i) % P for i in range(n_batches)]
    broken = _distributions(ctx, st, progs, feedback=False)
    sums = _drawn(ctx, st, broken, progs)
    kept = _oracle_kept(ctx, st, progs, feedback=False)
    return judge(ctx, st, _distributions(ctx, st, progs), sums, progs, kept)


def release(st) -> None:
    """Free the port's state before the comparison runs."""
    st.pop('batch', None)
