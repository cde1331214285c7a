"""Host-side sweep drivers: stream batches, accumulate statistics.

Counterpart of :func:`run_physics_sweep` and :func:`run_multi_sweep` in
the JAX package's ``parallel/driver.py``, on one device.  Each batch is
one :func:`..sim.physics.run_physics_batch` (or
:func:`..sim.interpreter.simulate_multi_batch`) call with a seed derived
from the sweep seed and the batch index, reduced on the device by
:func:`.sweep.physics_batch_stats` (:func:`.sweep.multi_batch_stats`);
the host sums a few integers per batch.  Checkpointing, spans and meshes
are ported later (ROADMAP.md).
"""

from __future__ import annotations

import warnings
from dataclasses import replace

import numpy as np
import torch

from .. import isa
from ..decoder import MultiMachineProgram, stack_machine_programs
from ..sim.interpreter import (InterpreterConfig, FaultError, FAULT_CODES,
                               _fault_policy, ensemble_config, not_ported,
                               resolve_engine, simulate_multi_batch,
                               torch_device)
from ..sim.physics import (run_physics_batch, prepare_physics_tables,
                           derive_seed)
from .sweep import multi_batch_stats, physics_batch_stats


def _n_batches(total_shots: int, batch: int) -> int:
    """The number of ``batch``-sized runs in ``total_shots``."""
    if total_shots <= 0 or batch <= 0:
        raise ValueError(f'need positive total_shots/batch, got '
                         f'{total_shots}/{batch}')
    if total_shots % batch:
        raise ValueError(f'total_shots {total_shots} not divisible by '
                         f'batch {batch}')
    return total_shots // batch


def run_physics_sweep(mp, model, total_shots: int, batch: int,
                      seed: int = 0, cfg: InterpreterConfig = None,
                      init_regs=None, checkpoint: str = None,
                      span: int = 1, mesh=None, device=None,
                      **cfg_kw) -> dict:
    """Physics-closed sweep: ``total_shots`` in ``batch``-sized runs.

    Batch ``i`` runs with ``derive_seed(seed, i)``, so the result is a
    function of ``seed`` alone.  ``device``: the torch device (default
    CUDA).  Returns ``{'shots', 'engine', 'mean_pulses' [C],
    'meas1_rate' [C], 'survival00_rate', 'clean_shots', 'err_shots',
    'fault_shots', 'incomplete_batches'}`` as in the JAX package;
    ``cfg.fault_mode='strict'`` raises :class:`FaultError` after the
    sweep if any shot trapped."""
    if checkpoint is not None:
        raise not_ported('run_physics_sweep(checkpoint=...)', 9)
    if span != 1:
        raise not_ported('run_physics_sweep(span=...)', 9)
    if mesh is not None:
        raise not_ported('run_physics_sweep(mesh=...)', 9)
    device = torch_device(device)
    cfg = replace(cfg, **cfg_kw) if cfg else InterpreterConfig(**cfg_kw)
    cfg = replace(cfg, record_pulses=False)       # statistics only
    cfg, strict = _fault_policy(cfg)
    n_batches = _n_batches(total_shots, batch)
    tables = prepare_physics_tables(mp, model, device)
    acc, incomplete = None, 0
    for i in range(n_batches):
        out = run_physics_batch(mp, model, derive_seed(seed, i), batch,
                                init_regs=init_regs, cfg=cfg, tables=tables,
                                device=device)
        stats = {k: v.cpu().numpy().astype(np.int64)
                 for k, v in physics_batch_stats(out).items()}
        incomplete += int(out['incomplete'])
        acc = stats if acc is None else {k: acc[k] + v
                                         for k, v in stats.items()}
    if incomplete:
        warnings.warn(
            f'{incomplete}/{n_batches} batches contain shots '
            f'that did not finish (step budget); mean_pulses/meas1_rate '
            f'include their partial counts', stacklevel=2)
    clean = int(acc['clean_shots'])
    faults = {name: int(n)
              for (name, _), n in zip(FAULT_CODES, acc['fault_shots'])}
    if strict and any(faults.values()):
        raise FaultError(acc['fault_shots'])
    return {
        'shots': total_shots,
        'engine': resolve_engine(mp, cfg, device),
        'mean_pulses': acc['pulse_sum'] / total_shots,
        'meas1_rate': acc['meas1_sum'] / total_shots,
        'survival00_rate': float(acc['allzero_sum'] / clean)
        if clean else float('nan'),
        'clean_shots': clean,
        'err_shots': int(acc['err_shots']),
        'fault_shots': faults,
        'incomplete_batches': incomplete,
    }


def run_multi_sweep(mps, total_shots: int, batch: int, p1=0.5,
                    seed: int = 0, cfg: InterpreterConfig = None,
                    init_regs=None, checkpoint: str = None, span: int = 1,
                    mesh=None, device=None, **cfg_kw) -> dict:
    """Injected-bits sweep over a program ensemble: ``total_shots`` per
    program in ``batch``-sized steps, each batch one
    :func:`..sim.interpreter.simulate_multi_batch` call (generic engine).

    Bits are Bernoulli(``p1``) per (program, shot, core, slot), ``p1`` a
    scalar or per-core array, drawn on the device from a generator
    seeded from ``derive_seed(seed, i)`` for batch ``i``.  Returns
    per-program arrays as the JAX package does: ``mean_pulses [n_progs,
    n_cores]``, ``err_rate`` and ``err_shots [n_progs]``, ``mean_qclk
    [n_progs, n_cores]``, ``fault_shots`` (code name -> ``[n_progs]``),
    plus ``shots`` (per program), ``n_progs``, ``engine`` and
    ``incomplete_batches`` ((program, batch) pairs with an unfinished
    shot)."""
    if checkpoint is not None:
        raise not_ported('run_multi_sweep(checkpoint=...)', 9)
    if span != 1:
        raise not_ported('run_multi_sweep(span=...)', 9)
    if mesh is not None:
        raise not_ported('run_multi_sweep(mesh=...)', 9)
    device = torch_device(device)
    mmp = mps if isinstance(mps, MultiMachineProgram) \
        else stack_machine_programs(mps)
    cfg = replace(ensemble_config(mmp, cfg, **cfg_kw), record_pulses=False,
                  straightline=False, engine=None)
    cfg, strict = _fault_policy(cfg)
    n_batches = _n_batches(total_shots, batch)
    P, C, M = mmp.n_progs, mmp.n_cores, cfg.max_meas
    p1 = torch.as_tensor(np.broadcast_to(np.asarray(p1, np.float32),
                                         (C,)).copy(), device=device)
    if init_regs is not None:
        init_regs = np.asarray(init_regs, np.int32)
        if init_regs.ndim == 2:
            init_regs = np.broadcast_to(init_regs[None],
                                        (P,) + init_regs.shape)
        if init_regs.shape[0] != P:
            raise ValueError(
                f'init_regs leading axis {init_regs.shape[0]} != '
                f'n_progs {P}')
    regs = torch.zeros((P, C, isa.N_REGS), dtype=torch.int32, device=device) \
        if init_regs is None else torch.as_tensor(init_regs, device=device)
    acc = None
    for i in range(n_batches):
        gen = torch.Generator(device=device)
        # manual_seed takes the derived 64-bit seed's top 63 bits, as
        # run_physics_batch seeds its generators
        gen.manual_seed(derive_seed(seed, i) >> 1)
        bits = (torch.rand((P, batch, C, M), generator=gen, device=device)
                < p1[None, None, :, None]).to(torch.int32)
        out = simulate_multi_batch(mmp, bits, init_regs=regs, cfg=cfg,
                                   device=device)
        stats = {k: v.cpu().numpy().astype(np.int64)
                 for k, v in multi_batch_stats(out).items()}
        acc = stats if acc is None else {k: acc[k] + v
                                         for k, v in stats.items()}
    incomplete = int(acc['incomplete'].sum())
    if incomplete:
        warnings.warn(
            f'{incomplete} (program, batch) pairs contain shots that '
            f'did not finish (step budget); means include their partial '
            f'counts — raise max_steps or treat them as lower bounds',
            stacklevel=2)
    fault_pp = acc['fault_shots']                  # [n_progs, n_codes]
    if strict and fault_pp.any():
        raise FaultError(fault_pp.sum(axis=0))
    return {
        'shots': total_shots,
        'n_progs': P,
        'engine': 'generic',
        'mean_pulses': acc['pulse_sum'] / total_shots,
        'err_rate': acc['err_shots'] / total_shots,
        'err_shots': acc['err_shots'].copy(),
        'mean_qclk': acc['qclk_sum'] / total_shots,
        'fault_shots': {name: fault_pp[:, i].copy()
                        for i, (name, _) in enumerate(FAULT_CODES)},
        'incomplete_batches': incomplete,
    }
