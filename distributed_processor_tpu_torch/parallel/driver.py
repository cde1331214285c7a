"""Host-side sweep driver: stream batches, accumulate statistics.

Counterpart of :func:`run_physics_sweep` in the JAX package's
``parallel/driver.py``, on one device.  Each batch is one
:func:`..sim.physics.run_physics_batch` call with a seed derived from the
sweep seed and the batch index, reduced on the device by
:func:`.sweep.physics_batch_stats`; the host sums a few integers per
batch.  Checkpointing, spans and meshes are ported later (ROADMAP.md).
"""

from __future__ import annotations

import warnings
from dataclasses import replace

import numpy as np

from ..sim.interpreter import (InterpreterConfig, FaultError, FAULT_CODES,
                               _fault_policy, not_ported, resolve_engine,
                               torch_device)
from ..sim.physics import (run_physics_batch, prepare_physics_tables,
                           derive_seed)
from .sweep import physics_batch_stats


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
    if total_shots <= 0 or batch <= 0:
        raise ValueError(f'need positive total_shots/batch, got '
                         f'{total_shots}/{batch}')
    if total_shots % batch:
        raise ValueError(f'total_shots {total_shots} not divisible by '
                         f'batch {batch}')
    tables = prepare_physics_tables(mp, model, device)
    acc, incomplete = None, 0
    for i in range(total_shots // batch):
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
            f'{incomplete}/{total_shots // batch} batches contain shots '
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
