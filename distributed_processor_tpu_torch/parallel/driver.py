"""Host-side sweep drivers: stream batches, accumulate, checkpoint.

Counterpart of the JAX package's ``parallel/driver.py``.  Each batch is
one :func:`..sim.physics.run_physics_batch` (or
:func:`..sim.interpreter.simulate_multi_batch`) call with a seed derived
from the sweep seed and the batch index, reduced on the device by
:func:`.sweep.physics_batch_stats` (:func:`.sweep.multi_batch_stats`);
the host folds a few integers per batch into a
:class:`..utils.results.SweepAccumulator`, which checkpoints the sums so
an interrupted sweep resumes to the identical result.  ``span`` folds
batches on the device before the host fetches them
(:func:`.sweep.run_spanned`); ``mesh`` shards each batch's shots over
the ranks of a ``'dp'`` axis (:mod:`.mesh`).
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from dataclasses import replace

import numpy as np
import torch

from .. import isa
from ..decoder import MultiMachineProgram, stack_machine_programs
from ..sim.interpreter import (InterpreterConfig, FaultError, FAULT_CODES,
                               _fault_policy, cores_ineligible,
                               ensemble_config, resolve_engine,
                               simulate_multi_batch, torch_device)
from ..sim.physics import (run_physics_batch, prepare_physics_tables,
                           derive_seed)
from ..utils.results import SweepAccumulator
from .mesh import axis, psum
from .sweep import (multi_batch_stats, physics_batch_stats, run_spanned,
                    sharded_cores_stat_sums)

# the JAX package's fingerprint version: a checkpoint of either package
# is then validated field by field by the other, and their differing
# random-stream fields reject it
FINGERPRINT_VERSION = 5
# the port's random stream, named in every fingerprint: Philox generators
# seeded through sim.physics.derive_seed (the JAX package's 'key' field
# names a threefry key instead)
STREAM = 'philox:derive_seed'


def _jsonable(v):
    """Dataclass, complex, tuple, array and tensor values as stable
    JSON-able structures, field by field, so the fingerprint survives
    cosmetic repr changes and mismatches are reported per field."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, complex):
        return [v.real, v.imag]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return _jsonable(v.tolist())       # complex dtypes recurse
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


def _regs_crc(init_regs) -> int:
    if init_regs is None:
        return 0
    if isinstance(init_regs, torch.Tensor):
        init_regs = init_regs.cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(np.asarray(init_regs)).tobytes())


def _sweep_fingerprint(mp, model, batch: int, seed: int, cfg, init_regs,
                       n_dp: int = 0) -> dict:
    """Identity of a physics sweep for checkpoint validation: resuming
    with another program, model, config, registers, batch size, seed or
    dp extent fails loudly instead of mixing accumulations.  The JAX
    package's fields, with ``seed`` and ``stream`` in place of its
    threefry ``key``."""
    crc = 0
    for f in dataclasses.fields(mp.soa):          # every operand plane
        crc = zlib.crc32(
            np.ascontiguousarray(getattr(mp.soa, f.name)).tobytes(), crc)
    for t in mp.tables:                           # env/freq content
        for env in t.envs:
            crc = zlib.crc32(np.ascontiguousarray(env).tobytes(), crc)
        for fr in t.freqs:
            crc = zlib.crc32(
                np.ascontiguousarray(fr['freq']).tobytes(), crc)
    return {
        'fingerprint_version': FINGERPRINT_VERSION,
        'batch': int(batch),
        'seed': int(seed),
        'stream': STREAM,
        'program_crc': int(crc),
        'model': _jsonable(model),
        'cfg': _jsonable(cfg),
        'init_regs_crc': int(_regs_crc(init_regs)),
        # the dp extent changes each shard's seed and size, hence the
        # noise streams: a mesh checkpoint is not a single-device one
        'n_dp': int(n_dp),
    }


def _ensemble_fingerprint(mmp, batch: int, seed: int, cfg, init_regs, p1,
                          n_dp: int = 0) -> dict:
    """Sweep identity of the ensemble path: the CRC covers every operand
    plane of the STACKED ``[n_progs, n_cores, n_instr]`` program, so a
    swapped, reordered or re-padded ensemble is rejected."""
    crc = 0
    for f in dataclasses.fields(mmp.soa):
        crc = zlib.crc32(
            np.ascontiguousarray(getattr(mmp.soa, f.name)).tobytes(), crc)
    return {
        'fingerprint_version': FINGERPRINT_VERSION,
        'multi': True,
        'n_progs': int(mmp.n_progs),
        'batch': int(batch),
        'seed': int(seed),
        'stream': STREAM,
        'program_crc': int(crc),
        'p1': np.asarray(p1, np.float64).tolist(),
        'cfg': _jsonable(cfg),
        'init_regs_crc': int(_regs_crc(init_regs)),
        'n_dp': int(n_dp),
    }


def _n_batches(total_shots: int, batch: int, span: int = 1) -> int:
    """The number of ``batch``-sized runs in ``total_shots``."""
    if total_shots <= 0 or batch <= 0:
        raise ValueError(f'need positive total_shots/batch, got '
                         f'{total_shots}/{batch}')
    if total_shots % batch:
        raise ValueError(f'total_shots {total_shots} not divisible by '
                         f'batch {batch}')
    if span < 1:
        raise ValueError(f'span must be >= 1, got {span}')
    return total_shots // batch


def _dp_of(mesh, batch: int) -> tuple:
    """``(n_dp, row, group, shots)``: the dp axis of a sweep's mesh
    (``0, 0, None`` without one) and the shots of each rank's share of a
    batch."""
    if mesh is None:
        return 0, 0, None, batch
    n_dp, row, group = axis(mesh, 'dp')
    if batch % n_dp:
        raise ValueError(f'batch {batch} not divisible by mesh dp={n_dp}')
    return n_dp, row, group, batch // n_dp


def _accumulate(step, meta: dict, n_batches: int, batch: int,
                checkpoint: str, checkpoint_every: int, span: int,
                strict_resume: bool) -> SweepAccumulator:
    """Run ``step`` over the batches the checkpoint (if any) lacks, in
    spans, and return the accumulator, saved when checkpointed."""
    if checkpoint and checkpoint_every <= 0:
        checkpoint_every = 1          # a requested checkpoint that never
                                      # writes mid-run resumes nothing
    acc = SweepAccumulator.resume(checkpoint, checkpoint_every, meta=meta,
                                  strict=strict_resume) \
        if checkpoint else SweepAccumulator(meta=meta)
    if acc.n_batches > n_batches:
        raise ValueError(
            f'checkpoint already holds {acc.n_batches} batches '
            f'({acc.n_batches * batch} shots) > requested '
            f'{n_batches * batch}')
    run_spanned(step, acc, n_batches, span)
    if checkpoint:
        acc.save()
    return acc


def run_physics_sweep(mp, model, total_shots: int, batch: int,
                      seed: int = 0, cfg: InterpreterConfig = None,
                      init_regs=None, checkpoint: str = None,
                      checkpoint_every: int = 0, span: int = 1,
                      mesh=None, strict_resume: bool = False, device=None,
                      **cfg_kw) -> dict:
    """Physics-closed sweep: ``total_shots`` in ``batch``-sized runs.

    Batch ``i`` runs with ``derive_seed(seed, i)``, so the result is a
    function of ``seed`` alone.  ``device``: the torch device (default
    CUDA).

    ``checkpoint``: a results file (:mod:`..utils.results`); the sweep
    resumes from it, skipping the batches it holds (the seed stream is
    a function of the batch index, so a resumed sweep equals the
    uninterrupted one), and a checkpoint of another sweep — another
    program, model, config, registers, batch, seed or dp extent, or the
    JAX package's (another random stream) — is rejected field by field.
    ``checkpoint_every`` counts batches (default 1 when checkpointing);
    ``strict_resume`` rejects unfingerprinted or version-skewed files.

    ``span``: batches whose sums are folded on the device before the
    host fetches them, one span behind (:func:`.sweep.run_spanned`);
    spans start on the absolute batch grid and checkpoints snap to span
    edges.  Any span gives the identical result, so ``span`` is not part
    of the checkpoint's identity.

    ``mesh``: a :mod:`.mesh` mesh whose ``'dp'`` axis shards each batch
    (``batch`` divisible by it): dp row ``r`` runs its ``batch / dp``
    shots with ``derive_seed(seed, i, r)`` on its own device and the
    sums are all-reduced over ``'dp'``, so every rank returns the whole
    result.  A cores mesh with more than one shard raises: physics
    sweeps shard shots only.

    Returns ``{'shots', 'engine', 'mean_pulses' [C], 'meas1_rate' [C],
    'survival00_rate', 'clean_shots', 'err_shots', 'fault_shots',
    'incomplete_batches'}`` as in the JAX package;
    ``cfg.fault_mode='strict'`` raises :class:`FaultError` after the
    sweep (and its checkpoint) if any shot trapped."""
    device = torch_device(device)
    cfg = replace(cfg, **cfg_kw) if cfg else InterpreterConfig(**cfg_kw)
    cfg = replace(cfg, record_pulses=False)       # statistics only
    # strict faults are a host-side reporting policy, not sweep identity
    cfg, strict = _fault_policy(cfg)
    n_batches = _n_batches(total_shots, batch, span)
    tables = prepare_physics_tables(mp, model, device)
    if mesh is not None and 'cores' in mesh.mesh_dim_names \
            and axis(mesh, 'cores')[0] > 1:
        reason = cores_ineligible(mp, replace(cfg, physics=True))
        raise ValueError(
            f'run_physics_sweep shards shots over dp only; a '
            f"cores={axis(mesh, 'cores')[0]} mesh axis is ineligible "
            f'here: {reason} — injected-bits programs shard cores '
            f'via run_cores_sweep / sweep.sharded_cores_stats')
    n_dp, row, group, shots = _dp_of(mesh, batch)

    def step(i: int) -> dict:
        batch_seed = derive_seed(seed, i) if mesh is None \
            else derive_seed(seed, i, row)
        out = run_physics_batch(mp, model, batch_seed, shots,
                                init_regs=init_regs, cfg=cfg, tables=tables,
                                device=device)
        stats = dict(physics_batch_stats(out), incomplete=out['incomplete'])
        stats = {k: v.to(torch.int64) for k, v in stats.items()}
        if group is not None:
            stats = psum(stats, group)
            # a batch is incomplete if any shard was: count it once
            stats['incomplete'].clamp_(max=1)
        return stats

    meta = _sweep_fingerprint(mp, model, batch, seed, cfg, init_regs, n_dp)
    acc = _accumulate(step, meta, n_batches, batch, checkpoint,
                      checkpoint_every, span, strict_resume)
    shots_done = acc.n_batches * batch
    incomplete = int(acc.state['incomplete'])
    if incomplete:
        warnings.warn(
            f'{incomplete}/{acc.n_batches} batches contain shots '
            f'that did not finish (step budget); mean_pulses/meas1_rate '
            f'include their partial counts', stacklevel=2)
    clean = int(acc.state['clean_shots'])
    faults = {name: int(n) for (name, _), n
              in zip(FAULT_CODES, acc.state['fault_shots'])}
    if strict and any(faults.values()):
        raise FaultError(acc.state['fault_shots'])
    return {
        'shots': shots_done,
        'engine': resolve_engine(mp, cfg, device),
        'mean_pulses': acc.state['pulse_sum'] / shots_done,
        'meas1_rate': acc.state['meas1_sum'] / shots_done,
        'survival00_rate': float(acc.state['allzero_sum'] / clean)
        if clean else float('nan'),
        'clean_shots': clean,
        'err_shots': int(acc.state['err_shots']),
        'fault_shots': faults,
        'incomplete_batches': incomplete,
    }


def _bernoulli_bits(seed: int, shape: tuple, p1, device) -> torch.Tensor:
    """Bits Bernoulli(``p1 [C]``) of ``shape [..., C, M]`` from a
    generator seeded with ``seed``'s top 63 bits, as
    :func:`..sim.physics.run_physics_batch` seeds its generators."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed >> 1)
    return (torch.rand(shape, generator=gen, device=device)
            < p1[:, None]).to(torch.int32)


def run_cores_sweep(mp, total_shots: int, batch: int, p1=0.5, seed: int = 0,
                    cfg: InterpreterConfig = None, init_regs=None, mesh=None,
                    device=None, **cfg_kw) -> dict:
    """Injected-bits sweep of ONE many-core program with its core axis
    sharded over the mesh ``'cores'`` axis: batch ``i``'s bits are
    Bernoulli(``p1``) per (shot, core, slot) from ``derive_seed(seed,
    i)`` (the same on every rank), each batch runs through
    :func:`.sweep.sharded_cores_stat_sums`, and the host folds its sums.

    ``mesh`` must be a ``('dp', 'cores')`` mesh
    (:func:`.mesh.make_cores_mesh`).  Returns ``shots``, ``engine``
    (``'generic'``, the engine of the collective fabric), ``mean_pulses
    [n_cores]``, ``err_rate``, ``err_shots``, ``mean_qclk [n_cores]``
    and ``fault_shots``; ``cfg.fault_mode='strict'`` raises
    :class:`FaultError` after the sweep if any shot trapped."""
    device = torch_device(device)
    cfg = replace(cfg, **cfg_kw) if cfg else InterpreterConfig(**cfg_kw)
    cfg, strict = _fault_policy(cfg)
    if mesh is None:
        raise ValueError("run_cores_sweep needs a ('dp', 'cores') mesh "
                         '(parallel.mesh.make_cores_mesh)')
    n_batches = _n_batches(total_shots, batch)
    C = mp.n_cores
    p1 = torch.as_tensor(np.broadcast_to(np.asarray(p1, np.float32),
                                         (C,)).copy(), device=device)
    sums = None
    for i in range(n_batches):
        bits = _bernoulli_bits(derive_seed(seed, i), (batch, C, cfg.max_meas),
                               p1, device)
        stats = sharded_cores_stat_sums(mp, bits, mesh, init_regs=init_regs,
                                        cfg=cfg, device=device)
        host = {k: v.cpu().numpy() for k, v in stats.items()}
        sums = host if sums is None else {k: sums[k] + host[k] for k in sums}
    faults = {name: int(n) for (name, _), n
              in zip(FAULT_CODES, sums['fault_shots'])}
    if strict and any(faults.values()):
        raise FaultError(sums['fault_shots'])
    return {
        'shots': total_shots,
        'engine': 'generic',     # the engine hosting the collective fabric
        'mean_pulses': sums['pulse_sum'] / total_shots,
        'err_rate': float(sums['err_shots'] / total_shots),
        'err_shots': int(sums['err_shots']),
        'mean_qclk': sums['qclk_sum'] / total_shots,
        'fault_shots': faults,
    }


def run_multi_sweep(mps, total_shots: int, batch: int, p1=0.5,
                    seed: int = 0, cfg: InterpreterConfig = None,
                    init_regs=None, checkpoint: str = None,
                    checkpoint_every: int = 0, span: int = 1, mesh=None,
                    strict_resume: bool = False, device=None,
                    **cfg_kw) -> dict:
    """Injected-bits sweep over a program ensemble: ``total_shots`` per
    program in ``batch``-sized steps, each batch one
    :func:`..sim.interpreter.simulate_multi_batch` call (generic engine).

    Bits are Bernoulli(``p1``) per (program, shot, core, slot), ``p1`` a
    scalar or per-core array, drawn on the device from a generator
    seeded from ``derive_seed(seed, i)`` for batch ``i`` (with ``mesh``:
    ``derive_seed(seed, i, r)`` for dp row ``r``'s shots).
    ``checkpoint``, ``checkpoint_every``, ``strict_resume``, ``span`` and
    ``mesh`` as in :func:`run_physics_sweep`; the fingerprint covers the
    whole stacked ensemble.  Returns per-program arrays as the JAX
    package does: ``mean_pulses [n_progs, n_cores]``, ``err_rate`` and
    ``err_shots [n_progs]``, ``mean_qclk [n_progs, n_cores]``,
    ``fault_shots`` (code name -> ``[n_progs]``), plus ``shots`` (per
    program), ``n_progs``, ``engine`` and ``incomplete_batches``
    ((program, batch) pairs with an unfinished shot)."""
    device = torch_device(device)
    mmp = mps if isinstance(mps, MultiMachineProgram) \
        else stack_machine_programs(mps)
    cfg = replace(ensemble_config(mmp, cfg, **cfg_kw), record_pulses=False,
                  straightline=False, engine=None)
    cfg, strict = _fault_policy(cfg)
    n_batches = _n_batches(total_shots, batch, span)
    P, C, M = mmp.n_progs, mmp.n_cores, cfg.max_meas
    p1_np = np.broadcast_to(np.asarray(p1, np.float32), (C,)).copy()
    p1 = torch.as_tensor(p1_np, device=device)
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
    n_dp, row, group, shots = _dp_of(mesh, batch)

    def step(i: int) -> dict:
        batch_seed = derive_seed(seed, i) if mesh is None \
            else derive_seed(seed, i, row)
        bits = _bernoulli_bits(batch_seed, (P, shots, C, M), p1, device)
        out = simulate_multi_batch(mmp, bits, init_regs=regs, cfg=cfg,
                                   device=device)
        stats = {k: v.to(torch.int64)
                 for k, v in multi_batch_stats(out).items()}
        if group is not None:
            stats = psum(stats, group)
            # a program's batch is incomplete if any shard was
            stats['incomplete'].clamp_(max=1)
        return stats

    meta = _ensemble_fingerprint(mmp, batch, seed, cfg, init_regs, p1_np,
                                 n_dp)
    acc = _accumulate(step, meta, n_batches, batch, checkpoint,
                      checkpoint_every, span, strict_resume)
    shots_done = acc.n_batches * batch
    incomplete = int(acc.state['incomplete'].sum())
    if incomplete:
        warnings.warn(
            f'{incomplete} (program, batch) pairs contain shots that '
            f'did not finish (step budget); means include their partial '
            f'counts — raise max_steps or treat them as lower bounds',
            stacklevel=2)
    fault_pp = acc.state['fault_shots']            # [n_progs, n_codes]
    if strict and fault_pp.any():
        raise FaultError(fault_pp.sum(axis=0))
    return {
        'shots': shots_done,
        'n_progs': P,
        'engine': 'generic',
        'mean_pulses': acc.state['pulse_sum'] / shots_done,
        'err_rate': acc.state['err_shots'] / shots_done,
        'err_shots': np.asarray(acc.state['err_shots']).copy(),
        'mean_qclk': acc.state['qclk_sum'] / shots_done,
        'fault_shots': {name: fault_pp[:, i].copy()
                        for i, (name, _) in enumerate(FAULT_CODES)},
        'incomplete_batches': incomplete,
    }
