"""A closed loop of physics-closed batches: the RB campaign.

The window runs batches of ``shots`` back to back through the port's
``sim.physics.run_physics_batch`` (the configuration's engine ladder),
reduces each with ``parallel.sweep.physics_batch_stats`` and fetches the
sums, as ``parallel.driver.run_physics_sweep`` does at span 1.  Batch
``i`` draws its thermal initial states (``p1_init`` of the
configuration) on the device from ``derive_seed(seed, i, 1)`` and hands
them to the port with the noise seed ``derive_seed(seed, i)``.

Traffic keys: ``shots``, ``keep_batches`` (how many batches of the
window, drawn from the seed, keep every output for the comparison),
``trace_seconds``.

The comparison: the reference compiles the same source and runs the
oracle once per initial-state pattern the window used (ideal readout:
at sigma = 0.05 a window's noise is hundreds of standard deviations
below the gap between the two responses); every batch's fetched sums
must equal the pattern-weighted reference sums, and every shot of the
kept batches every compared output.
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from ..harness.common import Reservoir, derive_seed, torch_seed
from ..reference import lanes, sweep
from ..roofline import resolve as resolve_work

KEYS = ('n_pulses', 'n_meas', 'n_resets', 'time', 'qclk', 'offset', 'pc',
        'done', 'err', 'fault', 'regs', 'rst_time', 'meas_avail',
        'meas_gtime', 'meas_state', 'meas_bits', 'meas_bits_valid', 'qturns')


def _init_states(seed: int, i: int, B: int, C: int, p1: float, device):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, i, 1))
    return (torch.rand((B, C), generator=gen, device=device)
            < p1).to(torch.int32)


def interpreter_config(config: dict, mp):
    """The configuration's interpreter fields, with the step and pulse
    budgets sized from the program as ``bench.py`` sizes them."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    kw = dict(config['interpreter'])
    b = config.get('budget')
    if b:
        kw.update(max_steps=b['steps_per_instr'] * mp.n_instr
                  + b['steps_plus'],
                  max_pulses=int(mp.max_pulses_per_core(1))
                  + b['pulses_plus'])
    return InterpreterConfig(**kw)


def readout_model(config: dict):
    from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
    r = {k: v for k, v in config['readout'].items() if k != 'p1_init'}
    for k in ('g0', 'g1'):
        if k in r:
            r[k] = complex(*r[k])
    return ReadoutPhysics(p1_init=config['readout']['p1_init'], **r)


def setup(ctx) -> dict:
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import (
        prepare_physics_tables, run_physics_batch)
    cfg_file, tr = ctx.cell.config, ctx.traffic
    prog = importlib.import_module(
        f'benchmark.programs.{cfg_file["program"]["kind"]}')
    source = prog.sources(cfg_file['program'])[0]
    qchip = prog.qchip_source(cfg_file['program'])
    mp = prog.port_program(cfg_file['program'], source, qchip)
    model = readout_model(cfg_file)
    cfg = interpreter_config(cfg_file, mp)
    dev = ctx.device
    tables = prepare_physics_tables(mp, model, dev)
    st = dict(prog=prog, source=source, qchip=qchip, mp=mp, model=model,
              cfg=cfg, tables=tables, B=int(tr['shots']), C=mp.n_cores,
              p1=float(cfg_file['readout']['p1_init']))

    def batch(i: int):
        with ctx.span('batch'):
            init = _init_states(ctx.seed, i, st['B'], st['C'], st['p1'], dev)
            out = run_physics_batch(mp, model, derive_seed(ctx.seed, i),
                                    st['B'], init_states=init, cfg=cfg,
                                    tables=tables, device=dev)
        with ctx.span('reduce'):
            stats = dict(physics_batch_stats(out),
                         incomplete=out['incomplete'])
        with ctx.span('fetch'):
            host = {k: v.cpu().numpy() for k, v in stats.items()}
        return init, out, host

    st['batch'] = batch
    # warm every shape the window uses, holding as many batches' outputs
    # as the window keeps so the allocator's pool is already that large
    held = [st['batch'](-1 - j) for j in range(int(tr['keep_batches']) + 1)]
    del held
    ctx.sync()
    return st


def window(ctx, st) -> dict:
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    keep = Reservoir(int(ctx.traffic['keep_batches']),
                     derive_seed(ctx.seed, 0x6b656570))
    sums = []
    trace_s = float(ctx.traffic['trace_seconds'])
    k2 = resolve_windows_fused.launches
    ctx.tracer.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        init, out, host = st['batch'](i)
        sums.append(host)
        keep.offer((i, init, out))
        i += 1
        now = time.perf_counter() - t0
        if ctx.tracer.active and now >= trace_s:
            ctx.tracer.stop(ctx.sync)
            st['traced_batches'] = i
            st['resolve_launches'] = resolve_windows_fused.launches - k2
        if now >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    if ctx.tracer.active:
        ctx.tracer.stop(ctx.sync)
        st['traced_batches'] = i
        st['resolve_launches'] = resolve_windows_fused.launches - k2
    st.update(sums=sums, kept=keep.items, n_batches=i, wall=wall)
    shots = i * st['B']
    failed = int(sum(int(np.asarray(h['fault_shots']).sum())
                     + int(h['err_shots']) for h in sums))
    return dict(attempted=shots, failed=failed,
                metrics={'shots_per_s': shots / wall},
                note=f'{i} batches of {st["B"]} shots in {wall:.4f} s')


def reference_outcomes(ctx, st, feedback: bool = True) -> tuple:
    """The reference's per-pattern outcomes over every pattern the window
    used, and each batch's shots per pattern."""
    import torch
    rmp = st['prog'].reference_program(ctx.cell.config['program'],
                                       st['source'], st['qchip'])
    C, B = st['C'], st['B']
    counts = []
    for i in range(st['n_batches']):
        init = _init_states(ctx.seed, i, B, C, st['p1'], ctx.device)
        counts.append(torch.bincount(lanes.state_codes(init),
                                     minlength=1 << C).cpu().numpy())
    counts = np.stack(counts)                                  # [N, 2^C]
    used = np.nonzero(counts.sum(0))[0]
    cf = ctx.cell.config
    table = lanes.physics_table(rmp, lanes.code_patterns(used, C),
                                cf['interpreter']['max_meas'],
                                cf['interpreter']['max_resets'],
                                cf['readout']['x90_amp'], feedback=feedback)
    full = {k: np.zeros((1 << C,) + v.shape[1:], v.dtype)
            for k, v in table.items()}
    for k, v in table.items():
        full[k][used] = v
    return full, counts


def judge(ctx, st, table: dict, counts: np.ndarray, sums: list,
          kept: list) -> list:
    """The numbers compared: batches whose sums differ from the
    reference's, and shots of the kept batches that differ on any
    compared output."""
    n_codes = len(np.asarray(sums[0]['fault_shots']))
    bad_batches = sum(not sweep.stats_equal(
        h, sweep.expected_stats(table, counts[i], n_codes))
        for i, h in enumerate(sums))
    bad_shots, per_key = 0, {}
    for _i, init, out in kept:
        c = lanes.compare(out, table, lanes.state_codes(init), KEYS)
        bad_shots += c.pop('any')
        for k, v in c.items():
            per_key[k] = per_key.get(k, 0) + v
    ctx.log(f'compared {len(sums)} batches\' sums and every shot of '
            f'{len(kept)} kept batches ({sum(o["n_pulses"].shape[0] for _i, _s, o in kept)}'
            f' shots); mismatches by output: {per_key}')
    return [('batch_sums_differing', bad_batches, 0),
            ('kept_shots_differing', bad_shots, 0)]


def check(ctx, st) -> list:
    table, counts = reference_outcomes(ctx, st)
    # the resolve hop's work in the traced batches: every fired window
    n = st.get('traced_batches', st['n_batches'])
    per_pattern = table['n_meas'].sum(1), table['window_samples'].sum(1)
    traced = counts[:n].sum(0)
    windows = int(traced @ per_pattern[0])
    samples = int(traced @ per_pattern[1])
    st['work'] = dict(batches=n, windows=windows, samples=samples,
                      resolve_launches=st.get('resolve_launches'),
                      resolve_least_s=resolve_work.least_seconds(
                          windows, samples))
    return judge(ctx, st, table, counts, st['sums'], st['kept'])


def control(ctx, st, n_batches: int) -> list:
    """The control at the cell's size: the reference with its
    feed-forward broken (every fproc read serves 0) put in the port's
    place for ``n_batches`` batches, judged as a window's batches are."""
    import torch
    st['n_batches'] = n_batches
    broken, counts = reference_outcomes(ctx, st, feedback=False)
    C, B = st['C'], st['B']
    sums, kept = [], []
    for i in range(n_batches):
        init = _init_states(ctx.seed, i, B, C, st['p1'], ctx.device)
        idx = lanes.state_codes(init)
        out = {k: torch.as_tensor(v, device=ctx.device)[idx]
               for k, v in broken.items()}
        sums.append(sweep.expected_stats(broken, counts[i], 1))
        if i < int(ctx.traffic['keep_batches']):
            kept.append((i, init, out))
    table, _ = reference_outcomes(ctx, st)
    return judge(ctx, st, table, counts, sums, kept)


def release(st) -> None:
    """Free the port's state before the comparison runs."""
    for k in ('tables', 'batch'):
        st.pop(k, None)
