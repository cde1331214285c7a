"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. environment: the card's name and power limit, and the build of every
   CUDA kernel of the port from ``distributed_processor_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. each kernel against its plain torch version on the card, at the
   shapes its path gives it, with its time beside the plain version's and
   its bound: the resolver K2 (sigma = 0, identical streamed noise, and
   the kernel's own Philox noise held to CLT bounds); the span kernel K1
   (``engine='pallas'``) against the straight-line engine on seeded
   injected bits; the span kernel K3 (``engine='fused'``) against its
   plain version and against the generic engine at sigma = 0;
3. the paths at full width, each driven with every launch count set to 0
   just before it and read just after: the main path (the headline
   program, 8-qubit active reset + depth-12 RB, compiled by the port and
   run physics-closed by ``run_physics_batch`` at 262144 shots; its
   config resolves to the straight-line engine, and the generic engine's
   batch is timed beside it), the K1 path (``simulate_batch`` with
   ``engine='pallas'``, then ``'auto'``) and the K3 path
   (``run_physics_batch`` with ``engine='fused'``, sigma = 0);
4. the headline on CUDA and on the CPU in the port, at sigma = 0 with
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
from concurrent.futures import ThreadPoolExecutor


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
# 32-bit operations per retired instruction of the span kernels
# (csrc/exec_span.cu: decode and dispatch, ALU, pulse latch and trigger,
# next pc/time), counted against the float32 peak — the card's integer
# rate is no higher; per K3 measurement, the discriminator's 21 float32
# operations besides one add per energy sample
SPAN_OPS_PER_INSTR, DISCRIMINATE_OPS = 40, 21

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
    """The bench's config (``straightline=None``), with overrides."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    args = dict(max_steps=2 * mp.n_instr + 64,
                max_pulses=int(mp.max_pulses_per_core(1)) + 4,
                max_meas=2, max_resets=2, record_pulses=False,
                straightline=None)
    args.update(kw)
    return InterpreterConfig(**args)


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
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        for src in pool.map(lambda name: _cuda.build(name, verbose=True),
                            sources):
            print(f'built {src}')
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


def _reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from distributed_processor_tpu_torch.ops.exec_span import (
        exec_span, exec_span_fused)
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    for fn in (resolve_windows_fused, exec_span, exec_span_fused):
        fn.launches = 0


def _launches() -> dict:
    from distributed_processor_tpu_torch.ops.exec_span import (
        exec_span, exec_span_fused)
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    return {'resolve_windows': resolve_windows_fused.launches,
            'exec_span': exec_span.launches,
            'exec_span_fused': exec_span_fused.launches}


def _max_abs_diff(a: dict, b: dict, what: str) -> float:
    """Every key of two output dicts identical; returns max |a - b| (0)."""
    import torch
    check(set(a) == set(b), f'{what}: keys differ: {sorted(set(a) ^ set(b))}')
    worst = 0.0
    for key in sorted(a):
        x, y = a[key], b[key]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f'{what}: {key} is {x.dtype} {tuple(x.shape)} vs '
              f'{y.dtype} {tuple(y.shape)}')
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs()
            fail(f'{what}: {key} differs at {int((diff > 0).sum())} '
                 f'elements (max |diff| {float(diff.max())})')
        if x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def _carry_bytes(st: dict) -> int:
    return sum(t.numel() * t.element_size() for t in st.values())


def _span_inputs(mp, cfg, B: int, seed: int, physics: bool = False):
    """The span kernels' inputs at batch ``B`` on the card: the initial
    carry, the packed program, element geometry and seeded injected bits
    (or, for ``physics``, seeded initial qubit states)."""
    import torch
    from distributed_processor_tpu_torch.sim.interpreter import (
        _init_state, _program_constants, _soa_np)
    _soa, spc, interp, _sync = _program_constants(mp, DEV)
    st = _init_state(B, mp.n_cores, cfg, None, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2, (B, mp.n_cores, cfg.max_meas), generator=gen,
                         device=DEV, dtype=torch.int32)
    if physics:
        st['qturns'] = 2 * bits[..., 0]
    return st, _soa_np(mp), spc, interp, bits


def phase_k1(mp) -> dict:
    """K1 (engine='pallas') against the straight-line engine on the card,
    on seeded injected bits at the main path's batch; its time beside
    the plain version's and its bound."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, simulate_batch)
    B = HEADLINE['batch']
    worst = 0.0
    for record in (False, True):
        cfg = headline_config(mp, record_pulses=record,
                              opcode_histogram=True)
        _st, _soa, _spc, _interp, bits = _span_inputs(mp, cfg, B, seed=21)
        outs = {eng: simulate_batch(mp, bits, cfg=headline_config(
            mp, engine=eng, record_pulses=record, opcode_histogram=True),
            device=DEV) for eng in ('pallas', 'straightline')}
        sync()
        worst = max(worst, _max_abs_diff(outs['pallas'],
                                         outs['straightline'],
                                         f'K1 vs plain (records {record})'))
        retired = int(outs['pallas']['op_hist'].sum())
        print(f'K1 vs plain (B={B}, records {record}): every key identical, '
              f'{retired} instructions retired')
        del outs
    # time at the main path's config (no records, no histogram) on the
    # same bits, which retire the instructions counted above
    cfg = headline_config(mp)
    st, soa_np, spc, interp, bits = _span_inputs(mp, cfg, B, seed=21)
    valid = torch.ones(bits.shape, dtype=torch.bool, device=DEV)
    ms = cuda_time_ms(lambda: exec_span(st, soa_np, spc, interp, bits, cfg),
                      reps=20)
    plain_ms = cuda_time_ms(lambda: _exec_straightline(
        st, soa_np, spc, interp, bits, valid, cfg), reps=3)
    out = exec_span(st, soa_np, spc, interp, bits, cfg)
    nbytes = _carry_bytes(st) + _carry_bytes(out) + sum(
        t.numel() * t.element_size() for t in (bits, spc, interp)) \
        + soa_np.nbytes
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = retired * SPAN_OPS_PER_INSTR / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K1 at B={B} C={mp.n_cores} N={mp.n_instr}: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes '
          f'{nbytes / 1e9:.3f} GB = {t_bytes:.4f} ms, operations '
          f'{t_ops:.4f} ms)')
    return dict(name='exec_span', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='distributed_processor_tpu/ops/exec_pallas.py:349',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def phase_k3(mp) -> dict:
    """K3 (engine='fused') against its plain version (the fused
    straight-line pass) and against the generic engine, at sigma = 0 and
    the main path's batch; its time beside the plain version's and its
    bound."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import \
        exec_span_fused
    from distributed_processor_tpu_torch.sim.interpreter import \
        _exec_straightline
    from distributed_processor_tpu_torch.sim.physics import (
        _physics_tables, fused_readout, physics_config,
        prepare_physics_tables, run_physics_batch)
    B, C = HEADLINE['batch'], mp.n_cores
    model = headline_model(sigma=0.0)
    fused = fused_readout(mp, model, prepare_physics_tables(mp, model, DEV))
    interp_m = _physics_tables(mp, model.meas_elem)[3]
    bits0 = torch.zeros((B, C, 2), dtype=torch.int32, device=DEV)
    valid0 = torch.zeros(bits0.shape, dtype=torch.bool, device=DEV)

    def inputs(**kw):
        cfg = physics_config(headline_config(mp, **kw), model)
        st, soa_np, spc, interp, init = _span_inputs(mp, cfg, B, seed=31,
                                                     physics=True)
        return cfg, st, soa_np, spc, interp, init

    def kernel():
        return exec_span_fused(st, soa_np, spc, interp, bits0, valid0, cfg,
                               fused)

    def plain():
        out = _exec_straightline(dict(st, meas_bits=bits0,
                                      meas_valid=valid0),
                                 soa_np, spc, interp, None, None, cfg,
                                 fused=fused)
        return out, out.pop('meas_bits'), out.pop('meas_valid')

    # compare with the opcode histogram on, to count retired instructions
    cfg, st, soa_np, spc, interp, init = inputs(opcode_histogram=True)
    got, want = kernel(), plain()
    sync()
    retired = int(got[0]['op_hist'].sum())
    worst = _max_abs_diff(dict(got[0], meas_bits=got[1], meas_valid=got[2]),
                          dict(want[0], meas_bits=want[1],
                               meas_valid=want[2]), 'K3 vs plain')
    check(bool(got[2].all()), 'K3 left measurement slots unresolved')
    print(f'K3 vs plain (B={B}, sigma=0): every key identical')
    del want
    # the whole fused batch against the generic engine's two epochs
    init_states = init[..., 0]
    runs = {eng: run_physics_batch(
        mp, model, 7, B, init_states=init_states,
        cfg=headline_config(mp, engine=eng), device=DEV)
        for eng in ('fused', 'generic')}
    for key in runs['generic']:
        if key not in ('epochs', 'steps'):
            check(torch.equal(runs['fused'][key], runs['generic'][key]),
                  f'K3 vs generic: {key} differs')
    check(int(runs['fused']['epochs']) == 1
          and int(runs['generic']['epochs']) == 2,
          f"K3 epochs {int(runs['fused']['epochs'])}, generic "
          f"{int(runs['generic']['epochs'])}")
    print(f'K3 vs generic engine (B={B}, sigma=0): bits and integer '
          f'outputs identical, epochs 1 vs 2')
    del runs, got
    # time at the path's config (no histogram) on the same inputs
    cfg, st, soa_np, spc, interp, init = inputs()
    ms = cuda_time_ms(kernel, reps=20)
    plain_ms = cuda_time_ms(plain, reps=1)
    out, bits, valid = kernel()
    # operations this run's data needs: the integer work per retired
    # instruction, one add per energy sample of every window and the
    # discriminator per measurement
    env_len = (out['meas_env'] >> 12) & 0xfff
    fired = torch.arange(cfg.max_meas, device=DEV)[None, None, :] \
        < out['n_meas'][..., None]
    interp_c = torch.as_tensor(interp_m, device=DEV)[None, :, None]
    count = torch.where(env_len == 0xfff, 0,
                        (env_len * 4 * interp_c).clamp(max=fused['w']))
    samples = int((count * fired).sum())
    n_meas = int(fired.sum())
    ops = retired * SPAN_OPS_PER_INSTR + samples + n_meas * DISCRIMINATE_OPS
    nbytes = _carry_bytes(st) + _carry_bytes(out) + 2 * sum(
        t.numel() * t.element_size() for t in (bits, valid)) + sum(
        t.numel() * t.element_size() for t in
        (spc, interp, fused['e2'], fused['g0'], fused['g1'])) + soa_np.nbytes
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K3 at B={B} C={C}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {bound_ms:.4f} ms (bytes {nbytes / 1e9:.3f} GB = '
          f'{t_bytes:.4f} ms, operations {ops:.3e} = {t_ops:.4f} ms; '
          f'{n_meas} windows, {samples} energy samples)')
    return dict(name='exec_span_fused', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='distributed_processor_tpu/sim/interpreter.py:3206',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def phase_main_path(mp, env) -> int:
    """The headline physics-closed batch on the card: the bench's config
    resolves to the straight-line engine, with K2 resolving each epoch;
    the generic engine's batch is timed beside it.  Returns K2's
    launches in the main path's run."""
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import \
        resolve_engine
    from distributed_processor_tpu_torch.sim.physics import (
        physics_config, run_physics_batch)
    B = HEADLINE['batch']
    model, cfg = headline_model(), headline_config(mp)
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'straightline',
          f'the headline config resolves to {eng!r}, not the straight-line '
          f'engine of the JAX package')
    print(f'main path: engine=None, straightline=None resolves to {eng!r}')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2026, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['resolve_windows']
    epochs = int(out['epochs'])
    check(not bool(out['incomplete']), 'main path left shots incomplete')
    check(sum(stats['fault_shots']) == 0,
          f'main path faulted shots: {stats["fault_shots"]}')
    check(launches == epochs and epochs > 0,
          f'resolve kernel launched {launches} times in {epochs} epochs')
    check(counts['exec_span'] == 0 and counts['exec_span_fused'] == 0,
          f'main path launched span kernels: {counts}')
    check(int(out['steps']) == epochs * mp.n_instr,
          f"straight-line steps {int(out['steps'])}, want {epochs} x "
          f'{mp.n_instr}')
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
    # steady state: a batch with another seed on each engine, after an
    # untimed one on that engine
    for label, run_cfg in (('engine=None', cfg),
                           ("engine='generic'",
                            headline_config(mp, engine='generic'))):
        int(run_physics_batch(mp, model, 2031, B, cfg=run_cfg,
                              device=DEV)['epochs'])
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        out = run_physics_batch(mp, model, 2027, B, cfg=run_cfg, device=DEV)
        epochs = int(out['epochs'])
        sync()
        dt = time.perf_counter() - t0
        print(f'main path steady batch, {label}: {dt:.3f} s, '
              f'{B / dt:.1f} shots/s, epochs {epochs}, steps '
              f"{int(out['steps'])}, kernel launches {_launches()} "
              f'on {env["smi"]}')
        profile_batch(lambda: int(run_physics_batch(
            mp, model, 2028, B, cfg=run_cfg, device=DEV)['epochs']), label)
    return launches


def phase_k1_path(mp, env) -> int:
    """The K1 path: ``simulate_batch`` with ``engine='pallas'`` on seeded
    injected bits at 262144 shots, then ``engine='auto'``, which takes
    the kernel on the card.  Returns K1's launches in the pallas run."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        FAULT_CODES, fault_shot_counts, simulate_batch)
    B, C = HEADLINE['batch'], mp.n_cores
    gen = torch.Generator(device=DEV)
    gen.manual_seed(41)
    bits = torch.randint(0, 2, (B, C, 2), generator=gen, device=DEV,
                         dtype=torch.int32)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = simulate_batch(mp, bits, cfg=headline_config(mp, engine='pallas'),
                         device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['exec_span']
    check(launches == 1 and counts['resolve_windows'] == 0
          and counts['exec_span_fused'] == 0,
          f'K1 path launches: {counts}')
    faults = fault_shot_counts(out['fault']).tolist()
    check(bool(out['done'].all()) and not any(faults),
          f'K1 path left lanes undone or faulted: '
          f'{dict(zip([n for n, _ in FAULT_CODES], faults))}')
    check(int(out['steps']) == mp.n_instr and tuple(out['regs'].shape)
          == (B, C, 16), 'K1 path output has the wrong shape or steps')
    print(f"K1 path: simulate_batch(engine='pallas') {B} shots in "
          f'{dt:.4f} s (first call), K1 launches {launches}')
    sync()
    t0 = time.perf_counter()
    simulate_batch(mp, bits, cfg=headline_config(mp, engine='pallas'),
                   device=DEV)
    sync()
    print(f"K1 path steady batch: {time.perf_counter() - t0:.4f} s on "
          f'{env["smi"]}')
    before = exec_span.launches
    auto = simulate_batch(mp, bits, cfg=headline_config(mp, engine='auto'),
                          device=DEV)
    check(exec_span.launches == before + 1,
          f"engine='auto' on the card launched K1 "
          f'{exec_span.launches - before} times')
    _max_abs_diff(auto, out, "engine='auto' vs engine='pallas'")
    print("K1 path: engine='auto' on the card took K1 (one launch), "
          'outputs identical')
    return launches


def phase_k3_path(mp, env) -> int:
    """The K3 path: ``run_physics_batch`` with ``engine='fused'`` at
    sigma = 0 and 262144 shots.  Returns K3's launches in that run."""
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B, C = HEADLINE['batch'], mp.n_cores
    model = headline_model(sigma=0.0)
    cfg = headline_config(mp, engine='fused')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2029, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['exec_span_fused']
    check(launches == 1 and counts['resolve_windows'] == 0
          and counts['exec_span'] == 0, f'K3 path launches: {counts}')
    check(int(out['epochs']) == 1, f"K3 path took {int(out['epochs'])} "
          f'epochs')
    check(not bool(out['incomplete']) and sum(stats['fault_shots']) == 0
          and stats['err_shots'] == 0, f'K3 path faults or errors: {stats}')
    check(tuple(out['meas_bits'].shape) == (B, C, 2)
          and bool(out['meas_bits_valid'].all()),
          'K3 path left measurement slots unresolved')
    print(f"K3 path: run_physics_batch(engine='fused', sigma=0) {B} shots "
          f'in {dt:.4f} s (first call), epochs 1, K3 launches {launches}; '
          f'stats {json.dumps(stats)}')
    sync()
    t0 = time.perf_counter()
    int(run_physics_batch(mp, model, 2030, B, cfg=cfg, device=DEV)['epochs'])
    sync()
    print(f'K3 path steady batch: {time.perf_counter() - t0:.4f} s on '
          f'{env["smi"]}')
    return launches


def profile_batch(fn, label: str):
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
    dev_us, n_kernels, top = 0.0, 0, []
    ours = {'resolve_kernel': 0.0, 'exec_span_kernel': 0.0}
    for evt in prof.key_averages():
        if getattr(evt, 'device_type', None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, 'self_device_time_total', 0.0))
        dev_us += us
        n_kernels += evt.count
        top.append((us, evt.count, evt.key[:60]))
        for name in ours:
            if name in evt.key:
                ours[name] += us
    if dev_us == 0.0:
        print(f'{label} breakdown: device time not measured (the '
              f'profiler saw no CUDA kernels)')
        return
    top.sort(reverse=True)
    print(f'{label} breakdown (torch.profiler, one batch): wall '
          f'{wall:.4f} s, device busy {dev_us / 1e6:.4f} s '
          f'({100 * dev_us / 1e6 / wall:.1f}%), {n_kernels} kernel '
          f'launches; ' + ', '.join(
              f'{name} {us / 1e6:.4f} s ({100 * us / dev_us:.1f}% of device '
              f'time)' for name, us in ours.items()))
    for us, count, name in top[:8]:
        print(f'  {us / 1e3:10.3f} ms  {count:6d}x  {name}')


def phase_cuda_vs_cpu(mp):
    """Each path on the card against the same path on the CPU (the plain
    versions there), at sigma = 0 with explicit initial states."""
    import numpy as np
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B = 256
    init = np.random.default_rng(5).integers(0, 2, (B, mp.n_cores))
    model = headline_model(sigma=0.0)
    for engine in (None, 'fused'):
        cfg = headline_config(mp, engine=engine)
        outs = {d: run_physics_batch(mp, model, 11, B, init_states=init,
                                     cfg=cfg, device=d)
                for d in (DEV, 'cpu')}
        for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err',
                    'fault', 'qturns', 'epochs', 'steps'):
            a, b = (outs[d][key].cpu().numpy() for d in (DEV, 'cpu'))
            check(np.array_equal(a, b),
                  f'CUDA and CPU differ in {key} (engine={engine!r})')
        sa, sb = (physics_batch_stats(outs[d]) for d in (DEV, 'cpu'))
        for key in sa:
            check(np.array_equal(sa[key].cpu().numpy(),
                                 sb[key].cpu().numpy()),
                  f'CUDA and CPU differ in stats {key} (engine={engine!r})')
        print(f'CUDA vs CPU at sigma=0, B={B}, engine={engine!r}: bits and '
              f'stats identical')
    bits = np.random.default_rng(6).integers(0, 2, (B, mp.n_cores, 2))
    cfg = headline_config(mp, engine='pallas', record_pulses=True)
    outs = {d: simulate_batch(mp, bits, cfg=cfg, device=d)
            for d in (DEV, 'cpu')}
    _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()}, outs['cpu'],
                  "CUDA vs CPU, engine='pallas'")
    print(f"CUDA vs CPU, simulate_batch(engine='pallas'), B={B}: every key "
          f'identical')


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
    resolve = phase_kernels(mp)
    torch.cuda.empty_cache()
    k1 = phase_k1(mp)
    k3 = phase_k3(mp)
    torch.cuda.empty_cache()
    resolve['launches'] = phase_main_path(mp, env)
    k1['launches'] = phase_k1_path(mp, env)
    k3['launches'] = phase_k3_path(mp, env)
    phase_cuda_vs_cpu(mp)
    phase_sweep(mp, env)
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'library_ms')
    print(json.dumps({'kernels': [{k: kernel[k] for k in order}
                                  for kernel in (resolve, k1, k3)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
