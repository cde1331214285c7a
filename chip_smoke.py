"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. environment: the card's name and power limit, and the build of every
   CUDA kernel of the port from ``distributed_processor_tpu_torch/csrc``;
2. each kernel against its plain torch version on the card, at the
   shapes the main path gives it (sigma = 0, identical streamed noise,
   and the kernel's own Philox noise held to CLT bounds), and each
   kernel's time beside the plain version's and its bound;
3. the main path at full width: the headline program (8-qubit active
   reset + depth-12 RB) compiled by the port and run physics-closed by
   ``run_physics_batch`` at 262144 shots, with the kernels' launch
   counts read around that run;
4. the same program on CUDA and on the CPU in the port, at sigma = 0 with
   explicit initial states: bits and statistics identical;
5. a 1M-shot sweep (``run_physics_sweep``, 4 x 262144 shots).

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX.  Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def check(cond, msg: str):
    if not cond:
        fail(msg)


# peak rates of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float32 operations per resolved sample (csrc/resolve.cu): the chain
# (carrier rotation, envelope product, amplitude, channel, matched
# filter) is 36; Box-Muller noise adds log, sqrt, sin, cos and ~10 more
CHAIN_OPS, NOISE_OPS = 36, 14

HEADLINE = dict(n_qubits=8, depth=12, batch=262144, sweep_batches=4,
                sigma=0.05, p1_init=0.15, resolve_chunk=256)
# the torch device the phases run on (a CPU rehearsal sets 'cpu')
DEV = 'cuda'


def sync():
    import torch
    if DEV == 'cuda':
        torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / reps


def headline_program():
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.models import (
        make_default_qchip, active_reset, rb_program)
    n = HEADLINE['n_qubits']
    qubits = [f'Q{i}' for i in range(n)]
    program = active_reset(qubits) + rb_program(qubits, HEADLINE['depth'],
                                                seed=1234)
    return compile_to_machine(program, make_default_qchip(n), n_qubits=n)


def headline_config(mp, **kw):
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    return InterpreterConfig(
        max_steps=2 * mp.n_instr + 64,
        max_pulses=int(mp.max_pulses_per_core(1)) + 4,
        max_meas=2, max_resets=2, record_pulses=False, straightline=None,
        **kw)


def headline_model(**kw):
    from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
    args = dict(sigma=HEADLINE['sigma'], p1_init=HEADLINE['p1_init'],
                resolve_chunk=HEADLINE['resolve_chunk'],
                resolve_mode='fused')
    args.update(kw)
    return ReadoutPhysics(**args)


def resolve_inputs(tables, B: int, seed: int, full_windows: bool = False):
    """Per-window scalars and channel responses for one resolve epoch of
    the headline program's tables, made from ``seed`` on the card."""
    import torch
    C, F, W = tables['bas'].shape[0], tables['bas'].shape[2], \
        tables['bas'].shape[3]
    dev = tables['env'].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    angle = 2 * math.pi * u(B, C, 1)
    nsamp = torch.full((B, C, 1), W, dtype=torch.int32, device=dev)
    if not full_windows:
        # a quarter of the windows end early, to hold the window mask
        short = u(B, C, 1) < 0.25
        nsamp = torch.where(short, (u(B, C, 1) * W).to(torch.int32), nsamp)
    rows = tables['rows'].tolist() or [0]
    pick = (u(B, C, 1) * len(rows)).to(torch.int64).clamp(max=len(rows) - 1)
    sc = dict(amp=0.3 + 0.7 * u(B, C, 1), cosA=torch.cos(angle),
              sinA=torch.sin(angle),
              f_idx=(u(B, C, 1) * F).to(torch.int32).clamp(max=F - 1),
              addr=torch.as_tensor(rows, dtype=torch.int32,
                                   device=dev)[pick],
              n_samp=nsamp)
    state = u(B, C) < 0.5
    gs_i = torch.where(state, -0.6, 1.0).to(torch.float32).contiguous()
    gs_q = torch.where(state, 0.8, 0.0).to(torch.float32).contiguous()
    return sc, gs_i, gs_q


def phase_environment() -> dict:
    import torch
    from distributed_processor_tpu_torch.ops import _cuda
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} count {torch.cuda.device_count()}')
    t0 = time.perf_counter()
    sources = _cuda.sources()
    for src in sources:
        _cuda.build(src, verbose=True)
    print(f'kernel build: {time.perf_counter() - t0:.3f} s '
          f'({", ".join(s + ".cu" for s in sources)})')
    return dict(smi=smi, name=name)


def phase_kernels(mp) -> dict:
    """The resolve kernel against its plain version on the card."""
    import torch
    from distributed_processor_tpu_torch.ops.resolve import (
        resolve_windows_fused, resolve_windows_reference)
    from distributed_processor_tpu_torch.sim.physics import \
        prepare_physics_tables
    model = headline_model()
    tables = prepare_physics_tables(mp, model, DEV)
    full_tables = prepare_physics_tables(
        mp, headline_model(resolve_mode='persample'), DEV)
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    ck = 256
    # the main path's batch: every comparison launches the kernel on the
    # lanes [B, C] and grid the main path gives it
    B = HEADLINE['batch']
    sigma = float(HEADLINE['sigma'])
    max_err, max_ratio = 0.0, 0.0

    def agree(got, want, what):
        nonlocal max_err, max_ratio
        scale = float(want[2].abs().max())
        for name, g, w in zip(('acc_i', 'acc_q', 'energy'), got, want):
            err = (g - w).abs()
            tol = 1e-5 * w.abs() + 1e-5 * scale
            max_err = max(max_err, float(err.max()))
            max_ratio = max(max_ratio, float((err / tol).max()))
            bad = err > tol
            check(not bool(bad.any()),
                  f'{what}: {name} differs from the plain version at '
                  f'{int(bad.sum())} windows (max |err| '
                  f'{float(err.max()):.3e}, scale {scale:.3e})')

    for label, tabs, ring in (('rows, sigma=0', tables, False),
                              ('full table, sigma=0', full_tables, False),
                              ('rows, ring, sigma=0', tables, True)):
        sc, gs_i, gs_q = resolve_inputs(tabs, B, seed=1)
        args = (sc, tabs, gs_i, gs_q, 0.0, 1.0 / 40.0, 7, W, Lp)
        got = resolve_windows_fused(*args, ring=ring)
        want = resolve_windows_reference(*args, ring=ring, ck=ck)
        sync()
        agree(got, want, label)
        print(f'kernel vs plain ({label}, B={B} C={C} W={W}): agree, '
              f'max |err| {max_err:.3e}, max |err|/tol {max_ratio:.3f}')

    # identical streamed noise into both ([2, C, B, W] float32, 17 GB at
    # the main path's batch)
    sc, gs_i, gs_q = resolve_inputs(tables, B, seed=2)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    noise = torch.randn((2, C, B, W), generator=gen, device=DEV).mul_(sigma)
    args = (sc, tables, gs_i, gs_q, sigma, 0.0, 7, W, Lp)
    got = resolve_windows_fused(*args, noise=noise)
    want = resolve_windows_reference(*args, noise=noise, ck=ck)
    sync()
    agree(got, want, 'streamed noise')
    print(f'kernel vs plain (streamed noise, B={B}): agree, max |err| '
          f'{max_err:.3e}, max |err|/tol {max_ratio:.3f}')
    del noise, got, want
    if DEV == 'cuda':
        torch.cuda.empty_cache()

    # the kernel's own Philox noise against the plain version's torch
    # noise: the deviation from the sigma = 0 sums, normalised by
    # sigma * sqrt(energy), is N(0, 1) per window for both
    clean = resolve_windows_reference(*args[:4], 0.0, *args[5:], ck=ck)
    norm = sigma * clean[2].clamp(min=1e-12).sqrt()
    live = clean[2] > 0
    stats = {}
    for label, out in (
            ('kernel', resolve_windows_fused(*args, epoch=1)),
            ('plain', resolve_windows_reference(*args, epoch=1, ck=ck))):
        d = torch.stack([(out[0] - clean[0]) / norm,
                         (out[1] - clean[1]) / norm])         # [2, B, C]
        mean = torch.stack([d[:, :, c][:, live[:, c]].mean()
                            for c in range(C)])
        var = torch.stack([d[:, :, c][:, live[:, c]].var()
                           for c in range(C)])
        stats[label] = (mean, var)
    n = 2 * int(live.sum(0).min())
    tol_mean, tol_var = 5 * math.sqrt(2 / n), 5 * math.sqrt(4 / n)
    dm = (stats['kernel'][0] - stats['plain'][0]).abs().max()
    dv = (stats['kernel'][1] - stats['plain'][1]).abs().max()
    check(float(dm) < tol_mean and float(dv) < tol_var,
          f'Philox noise statistics off: mean diff {float(dm):.4f} '
          f'(tol {tol_mean:.4f}), var diff {float(dv):.4f} '
          f'(tol {tol_var:.4f}); kernel var {stats["kernel"][1].tolist()}')
    kvar = [round(v, 4) for v in stats['kernel'][1].tolist()]
    print(f'kernel Philox noise vs plain torch noise: per-core mean diff '
          f'{float(dm):.4f} < {tol_mean:.4f}, var diff {float(dv):.4f} < '
          f'{tol_var:.4f}; kernel var {kvar}')

    # time per epoch at bench shape: all windows full length, as the
    # headline program's are
    sc, gs_i, gs_q = resolve_inputs(tables, B, seed=4, full_windows=True)
    args = (sc, tables, gs_i, gs_q, sigma, 0.0, 7, W, Lp)
    ms = cuda_time_ms(lambda: resolve_windows_fused(*args), reps=10)
    plain_ms = cuda_time_ms(
        lambda: resolve_windows_reference(*args, ck=ck), reps=2)
    samples = float(sc['n_samp'].clamp(max=W).sum())
    ops = samples * (CHAIN_OPS + NOISE_OPS)
    nbytes = B * C * (8 * 4 + 3 * 4) + sum(
        t.numel() * t.element_size() for t in
        (tables['env'], tables['bas'], tables['rows'], tables['interps']))
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f'resolve epoch at B={B} C={C} W={W}: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms)')
    return dict(name='resolve_windows', route='cuda',
                source='distributed_processor_tpu_torch/csrc/resolve.cu',
                replaces='distributed_processor_tpu/ops/resolve_pallas.py:196',
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def phase_main_path(mp, env) -> int:
    """The headline physics-closed batch on the card; returns launches."""
    import torch
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B = HEADLINE['batch']
    model, cfg = headline_model(), headline_config(mp)
    resolve_windows_fused.launches = 0
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2026, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    launches = resolve_windows_fused.launches
    epochs = int(out['epochs'])
    check(not bool(out['incomplete']), 'main path left shots incomplete')
    check(sum(stats['fault_shots']) == 0,
          f'main path faulted shots: {stats["fault_shots"]}')
    check(launches == epochs and epochs > 0,
          f'resolve kernel launched {launches} times in {epochs} epochs')
    C = mp.n_cores
    check(tuple(out['meas_bits'].shape) == (B, C, 2)
          and bool(out['meas_bits_valid'].all()),
          'main path left measurement slots unresolved')
    check(stats['err_shots'] == 0, f'{stats["err_shots"]} errored shots')
    meas1 = out['meas_bits'].float().mean(0)                 # [C, 2]
    print(f'main path: {B} shots, epochs {epochs}, resolve launches '
          f'{launches}, {dt:.3f} s ({B / dt:.1f} shots/s, first call)')
    print('main path stats: ' + json.dumps(stats))
    print('main path P(1) per core and slot: '
          + json.dumps([[round(x, 5) for x in r] for r in meas1.tolist()]))
    # steady state: a second batch with another seed
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2027, B, cfg=cfg, device=DEV)
    int(out['epochs'])
    sync()
    dt = time.perf_counter() - t0
    print(f'main path steady batch: {dt:.3f} s, {B / dt:.1f} shots/s '
          f'on {env["smi"]}')
    profile_batch(lambda: int(run_physics_batch(
        mp, model, 2028, B, cfg=cfg, device=DEV)['epochs']))
    return launches


def profile_batch(fn):
    """Where one batch's time goes: ``torch.profiler`` device time by
    kernel over the batch's wall time (the profiler's own overhead
    lengthens the wall time; the un-profiled batch time is above)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev_us, resolve_us, n_kernels, top = 0.0, 0.0, 0, []
    for evt in prof.key_averages():
        if getattr(evt, 'device_type', None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, 'self_device_time_total', 0.0))
        dev_us += us
        n_kernels += evt.count
        top.append((us, evt.count, evt.key[:60]))
        if 'resolve_kernel' in evt.key:
            resolve_us += us
    if dev_us == 0.0:
        print('main path breakdown: device time not measured (the '
              'profiler saw no CUDA kernels)')
        return
    top.sort(reverse=True)
    print(f'main path breakdown (torch.profiler, one batch): wall '
          f'{wall:.4f} s, device busy {dev_us / 1e6:.4f} s '
          f'({100 * dev_us / 1e6 / wall:.1f}%), {n_kernels} kernel '
          f'launches; resolve kernel {resolve_us / 1e6:.4f} s '
          f'({100 * resolve_us / dev_us:.1f}% of device time)')
    for us, count, name in top[:8]:
        print(f'  {us / 1e3:10.3f} ms  {count:6d}x  {name}')


def phase_cuda_vs_cpu(mp):
    import numpy as np
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B = 256
    init = np.random.default_rng(5).integers(0, 2, (B, mp.n_cores))
    model, cfg = headline_model(sigma=0.0), headline_config(mp)
    outs = {d: run_physics_batch(mp, model, 11, B, init_states=init,
                                 cfg=cfg, device=d)
            for d in (DEV, 'cpu')}
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err', 'fault',
                'qturns', 'epochs', 'steps'):
        a, b = (outs[d][key].cpu().numpy() for d in (DEV, 'cpu'))
        check(np.array_equal(a, b), f'CUDA and CPU differ in {key}')
    sa, sb = (physics_batch_stats(outs[d]) for d in (DEV, 'cpu'))
    for key in sa:
        check(np.array_equal(sa[key].cpu().numpy(), sb[key].cpu().numpy()),
              f'CUDA and CPU differ in stats {key}')
    print(f'CUDA vs CPU at sigma=0, B={B}: bits and stats identical')


def phase_sweep(mp, env):
    import torch
    from distributed_processor_tpu_torch.parallel import run_physics_sweep
    n, B = HEADLINE['sweep_batches'], HEADLINE['batch']
    sync()
    t0 = time.perf_counter()
    res = run_physics_sweep(mp, headline_model(), n * B, B, seed=2026,
                            cfg=headline_config(mp), device=DEV)
    dt = time.perf_counter() - t0
    check(res['incomplete_batches'] == 0 and res['shots'] == n * B,
          f'sweep incomplete: {res}')
    check(not any(res['fault_shots'].values()), f'sweep faults: {res}')
    print(f'sweep: {n * B} shots in {dt:.3f} s = {n * B / dt:.1f} shots/s '
          f'on {env["smi"]}; meas1_rate '
          + json.dumps([round(float(x), 5) for x in res['meas1_rate']])
          + f', survival00 {res["survival00_rate"]:.5f}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    # the port must be importable from here (a bare copy of this script
    # fails at this import)
    import distributed_processor_tpu_torch  # noqa: F401
    env = phase_environment()
    mp = headline_program()
    kernel = phase_kernels(mp)
    torch.cuda.empty_cache()
    kernel['launches'] = phase_main_path(mp, env)
    phase_cuda_vs_cpu(mp)
    phase_sweep(mp, env)
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'library_ms')
    print(json.dumps({'kernels': [{k: kernel[k] for k in order}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
