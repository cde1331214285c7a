"""Sharded sweep execution: shots, and one program's cores, over a mesh.

Counterpart of the JAX package's ``parallel/sweep.py``.  Each function
runs SPMD on every rank of a :mod:`.mesh` mesh where JAX runs one
``shard_map``: the rank takes its block of the global inputs (its
``'dp'`` row of the shots; on a cores mesh, its ``'cores'`` block of
the program's cores), runs the port's engine on it, and reduces over
the mesh with the collectives of :mod:`.mesh`.  Per-shot leaves come
back as the rank's shard (concatenated in mesh order they are JAX's
global array); statistics come back whole on every rank.

* dp: :func:`sharded_simulate`, :func:`sweep_stat_sums`,
  :func:`sweep_stats`, :func:`sharded_multi_stats`,
  :func:`sharded_physics_stat_sums`, :func:`sharded_physics_stats`,
  :func:`sharded_demod` (the local ``[S/dp, N/mp] @ [N/mp, 2M]`` product
  through the demod kernel K5, partial products summed over ``'mp'``).
  An explicit ``cfg.engine`` resolves through the engine ladder on each
  rank (``'pallas'``: the K1 span kernel); physics shards run K2, or K3
  under ``engine='fused'``.
* cores: :func:`sharded_cores_simulate`, :func:`sharded_cores_stat_sums`,
  :func:`sharded_cores_stats`, :func:`sharded_cores_rounds` — the
  distributed processor itself: the generic step reads the fproc fabric's
  and the sync barrier's producer words through one all-gather per step
  over ``'cores'`` (:class:`CoresShard`), the JAX ``_gat`` layer, so
  every output equals the single-device generic engine's.
  ``engine='block'`` runs that step at block boundaries and the bodies
  with K1 block on the rank's own cores.
* :func:`run_spanned` drives the sweep drivers' per-batch steps in spans.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import isa
from ..decoder import MultiMachineProgram, stack_machine_programs
from ..ops.demod import demod_iq
from ..sim.interpreter import (FAULT_CODES, FaultError, InterpreterConfig,
                               _block_plan, _check_fabric,
                               _check_single_round, _fault_policy,
                               _pad_meas, _run_injected, _soa_np,
                               ensemble_config, fault_shot_counts,
                               make_span_runner, resolve_engine,
                               simulate_multi_batch, torch_device)
from ..sim.physics import derive_seed, run_physics_batch
from .mesh import all_ranks, axis, gather_cat, psum

# outputs of a batch run that carry no shot axis: the sharded entries
# drop them, as the JAX package's do
_SCALAR_KEYS = ('steps', 'incomplete', 'op_hist')


def physics_batch_stats(out: dict) -> dict:
    """The per-batch reductions of a :func:`..sim.physics.run_physics_batch`
    result: per-core pulse sums, first-slot measured-1 sums, errored
    shots, per-code faulted shots, and the JOINT all-zeros count over
    clean shots (``allzero_sum``, the survival numerator of multi-qubit
    RB) with its denominator ``clean_shots`` — a shot is clean when no
    core has an error bit and every core's first slot was resolved."""
    first = out['meas_bits'][:, :, 0]
    errored = (out['err'] != 0).any(dim=1)
    clean = ~errored & out['meas_bits_valid'][:, :, 0].all(dim=1)
    return dict(
        pulse_sum=out['n_pulses'].sum(0),
        meas1_sum=first.sum(0),
        allzero_sum=((first == 0).all(dim=1) & clean).sum(),
        clean_shots=clean.sum(),
        err_shots=errored.sum(),
        fault_shots=fault_shot_counts(out['fault']),
    )


def multi_batch_stats(out: dict) -> dict:
    """The per-program reductions of a
    :func:`..sim.interpreter.simulate_multi_batch` result (leaves
    ``[P, B, ...]``): pulse sums ``[P, C]``, errored shots ``[P]``, qclk
    sums ``[P, C]``, per-code faulted shots ``[P, n_codes]`` and the
    incomplete flag ``[P]`` as 0/1."""
    bits = torch.tensor([bit for _, bit in FAULT_CODES], dtype=torch.int32,
                        device=out['fault'].device)
    faulted = ((out['fault'][..., None] & bits) != 0).any(dim=-2)
    return dict(
        pulse_sum=out['n_pulses'].sum(1),
        err_shots=(out['err'] != 0).any(dim=-1).sum(1),
        qclk_sum=out['qclk'].sum(1),
        fault_shots=faulted.sum(1),
        incomplete=out['incomplete'].to(torch.int32),
    )


def _injected_stats(out: dict) -> dict:
    """``pulse_sum [C]``, ``err_shots``, ``qclk_sum [C]`` and
    ``fault_shots`` of an injected-bits batch."""
    return dict(pulse_sum=out['n_pulses'].sum(0),
                err_shots=(out['err'] != 0).any(1).sum(),
                qclk_sum=out['qclk'].sum(0),
                fault_shots=fault_shot_counts(out['fault']))


def _int64(tree: dict) -> dict:
    return {k: v.to(torch.int64) for k, v in tree.items()}


def _drop_scalars(out: dict) -> dict:
    return {k: v for k, v in out.items() if k not in _SCALAR_KEYS}


def _block(x, mesh, name: str, dim: int, device, dtype=None,
           what: str = 'shots'):
    """This rank's block along ``dim`` of the global ``x`` over mesh axis
    ``name`` (a ``DTensor`` already sharded so is taken as it stands)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local().to(device=device, dtype=dtype)
    x = torch.as_tensor(x, dtype=dtype, device=device)
    n, i, _ = axis(mesh, name)
    if x.shape[dim] % n:
        raise ValueError(f'{x.shape[dim]} {what} not divisible by '
                         f'{name}={n}')
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def _shape(x) -> tuple:
    """The global shape of an array, tensor or ``DTensor``."""
    return tuple(x.shape) if hasattr(x, 'shape') else np.shape(x)


def _mesh_engine(mp, cfg: InterpreterConfig, device) -> str:
    """The engine of the shard-local run: the sharded paths always ran
    the generic engine, so ``cfg.engine=None`` keeps it; an explicit
    engine resolves through the ladder (``'pallas'``: K1 span)."""
    if cfg.engine is None:
        return 'generic'
    return resolve_engine(mp, cfg, device)


def _shotwise_init_regs(init_regs, n_shots: int, device):
    """``init_regs`` as ``None``, the per-core ``[n_cores, 16]`` form, or
    the per-shot ``[n_shots, n_cores, 16]`` form checked against
    ``n_shots``."""
    if init_regs is None:
        return None
    init_regs = torch.as_tensor(init_regs, dtype=torch.int32, device=device)
    if init_regs.ndim == 3 and init_regs.shape[0] != n_shots:
        raise ValueError(
            f'init_regs leading axis {init_regs.shape[0]} != n_shots '
            f'{n_shots} (pass [n_shots, n_cores, n_regs] or the 2-D '
            f'per-core form)')
    return init_regs


def _dp_inputs(meas_bits, mesh, init_regs, cfg, device):
    """The rank's dp rows of the injected bits and registers."""
    n_shots = _shape(meas_bits)[0]
    bits = _pad_meas(_block(meas_bits, mesh, 'dp', 0, device, torch.int32),
                     cfg.max_meas)
    regs = _shotwise_init_regs(init_regs, n_shots, device)
    if regs is not None and regs.ndim == 3:
        regs = _block(regs, mesh, 'dp', 0, device)
    return bits, regs


def sharded_simulate(mp, meas_bits, mesh, init_regs=None,
                     cfg: InterpreterConfig = None, device=None, **kw):
    """Run a shot batch sharded over the mesh dp axis.

    ``meas_bits``: the global ``[n_shots, n_cores, n_meas]`` with
    ``n_shots`` divisible by the dp axis size.  Returns this rank's
    shard (its dp row of the shots) of the :func:`simulate_batch`
    pytree, minus the scalar diagnostics."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    eng = _mesh_engine(mp, cfg, device)
    _check_fabric(cfg, mp.n_cores)
    bits, regs = _dp_inputs(meas_bits, mesh, init_regs, cfg, device)
    return _drop_scalars(_run_injected(mp, eng, bits, regs, cfg, device))


def sweep_stat_sums(mp, meas_bits, mesh, init_regs=None,
                    cfg: InterpreterConfig = None, device=None, **kw):
    """The integer sums under :func:`sweep_stats`: ``pulse_sum
    [n_cores]``, ``err_shots``, ``qclk_sum [n_cores]``, ``fault_shots``,
    summed over the mesh's dp axis only (the building block of a
    host-local run reduced by :func:`.multihost.cross_host_sum`)."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    _check_single_round(cfg)
    # statistics never read the pulse records
    cfg = replace(cfg, record_pulses=False)
    eng = _mesh_engine(mp, cfg, device)
    _check_fabric(cfg, mp.n_cores)
    bits, regs = _dp_inputs(meas_bits, mesh, init_regs, cfg, device)
    out = _run_injected(mp, eng, bits, regs, cfg, device)
    return psum(_int64(_injected_stats(out)), axis(mesh, 'dp')[2])


def _means(sums: dict, n_shots: int) -> dict:
    return dict(mean_pulses=sums['pulse_sum'] / n_shots,
                err_rate=sums['err_shots'] / n_shots,
                mean_qclk=sums['qclk_sum'] / n_shots,
                fault_shots=sums['fault_shots'])


def sweep_stats(mp, meas_bits, mesh, init_regs=None,
                cfg: InterpreterConfig = None, device=None, **kw):
    """A dp-sharded run reduced to global statistics: mean pulse
    counts, error rate, mean final qclk and per-code fault counts (the
    reduction is an all-reduce over ``'dp'``)."""
    sums = sweep_stat_sums(mp, meas_bits, mesh, init_regs=init_regs,
                           cfg=cfg, device=device, **kw)
    return _means(sums, _shape(meas_bits)[0])


def sharded_multi_stats(mps, meas_bits, mesh, init_regs=None,
                        cfg: InterpreterConfig = None, device=None, **kw):
    """A program ensemble reduced to per-program statistics on the mesh:
    the programs run as lanes of one generic-engine pass
    (:func:`..sim.interpreter.simulate_multi_batch`), shots shard over
    ``'dp'``.  ``meas_bits``: ``[n_progs, n_shots, n_cores, n_meas]``;
    ``init_regs``: optional ``[n_progs, n_cores, 16]``.  Returns
    ``mean_pulses [n_progs, n_cores]``, ``err_rate [n_progs]``,
    ``mean_qclk [n_progs, n_cores]`` and ``fault_shots``."""
    device = torch_device(device)
    mmp = mps if isinstance(mps, MultiMachineProgram) \
        else stack_machine_programs(mps)
    cfg = replace(ensemble_config(mmp, cfg, **kw), record_pulses=False,
                  straightline=False, engine=None)
    n_progs, n_cores = mmp.n_progs, mmp.n_cores
    shape = tuple(_shape(meas_bits))
    if len(shape) != 4 or shape[0] != n_progs:
        raise ValueError(
            f'meas_bits must be [n_progs={n_progs}, n_shots, n_cores, '
            f'n_meas]; got {shape}')
    bits = _block(meas_bits, mesh, 'dp', 1, device, torch.int32)
    if init_regs is None:
        init_regs = torch.zeros((n_progs, n_cores, isa.N_REGS),
                                dtype=torch.int32, device=device)
    out = simulate_multi_batch(mmp, bits, init_regs=init_regs, cfg=cfg,
                               device=device)
    sums = _int64(multi_batch_stats(out))
    sums.pop('incomplete')
    return _means(psum(sums, axis(mesh, 'dp')[2]), shape[1])


def _dp_seed(seed: int, mesh, dp_offset: int = 0, *words: int) -> int:
    """The seed of this rank's shard: a function of the sweep seed, the
    ``words`` (a batch index) and the GLOBAL dp row alone, so a
    host-local mesh placed at ``dp_offset`` draws the streams the global
    mesh would."""
    return derive_seed(seed, *words, axis(mesh, 'dp')[1] + dp_offset)


def sharded_physics_stat_sums(mp, model, seed: int, shots: int, mesh,
                              dp_offset: int = 0, cfg=None, device=None,
                              **kw):
    """The sums under :func:`sharded_physics_stats` (see
    :func:`physics_batch_stats` for the fields), summed over this mesh's
    dp axis only.  Row ``r`` of the mesh runs its ``shots / n_dp`` shots
    with ``derive_seed(seed, r + dp_offset)``: a host-local mesh holding
    rows ``[dp_offset, dp_offset + n_dp)`` of a multi-host run draws the
    streams the single global mesh would, so the cross-host sum of these
    integers equals the global run's.  ``shots`` is THIS mesh's shot
    count."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    cfg = replace(cfg, record_pulses=False)
    n_dp, _, group = axis(mesh, 'dp')
    if shots % n_dp:
        raise ValueError(f'{shots} shots not divisible by dp={n_dp}')
    out = run_physics_batch(mp, model, _dp_seed(seed, mesh, dp_offset),
                            shots // n_dp, cfg=cfg, device=device)
    return psum(_int64(physics_batch_stats(out)), group)


def sharded_physics_stats(mp, model, seed: int, shots: int, mesh,
                          cfg=None, device=None, **kw):
    """Physics-closed execution sharded over the mesh dp axis: every
    rank runs its own epoch loop (K2 per epoch, or K3 under
    ``engine='fused'``) on its shots, and the statistics are summed over
    ``'dp'``.  Returns ``mean_pulses [n_cores]``, ``err_rate``,
    ``meas1_rate [n_cores]`` and ``fault_shots``."""
    sums = sharded_physics_stat_sums(mp, model, seed, shots, mesh, cfg=cfg,
                                     device=device, **kw)
    return dict(mean_pulses=sums['pulse_sum'] / shots,
                err_rate=sums['err_shots'] / shots,
                meas1_rate=sums['meas1_sum'] / shots,
                fault_shots=sums['fault_shots'])


def sharded_demod(adc, weights, mesh, device=None):
    """Demod with shots over ``'dp'`` and the sample contraction over
    ``'mp'``: this rank's ``[S/dp, N/mp]`` ADC block against its
    ``[N/mp, 2M]`` weight block through the demod kernel K5
    (:func:`..ops.demod.demod_iq`), the partial products summed over
    ``'mp'``.  Returns this rank's ``[S/dp, M, 2]`` shard."""
    device = torch_device(device)
    a = _block(_block(adc, mesh, 'dp', 0, device, torch.float32),
               mesh, 'mp', 1, device, what='samples')
    w = _block(weights, mesh, 'mp', 0, device, torch.float32, 'samples')
    acc = demod_iq(a.contiguous(), w.contiguous())
    return psum({'acc': acc}, axis(mesh, 'mp')[2])['acc']


def run_spanned(step, acc, n_batches: int, span: int) -> None:
    """Drive a per-batch statistics ``step`` (``i -> dict of int64 sums``
    on the device) from ``acc.n_batches`` up to ``n_batches`` with
    ``span`` batches folded on the device per span
    (:func:`..sim.interpreter.make_span_runner`); the host fetches each
    span's sums once, after the next span ran, and folds them into the
    :class:`..utils.results.SweepAccumulator` ``acc``.

    Spans start on the ABSOLUTE batch grid (multiples of ``span``): a
    resume landing mid-span first runs the partial span that completes
    its cell, so checkpoint boundaries do not depend on where a previous
    run stopped."""
    runner = make_span_runner(step)
    in_flight = None
    i = acc.n_batches
    while i < n_batches:
        size = min(span - i % span, n_batches - i)
        cur = runner(i, size)
        if in_flight is not None:
            _fold(acc, *in_flight)
        in_flight = (cur, size)
        i += size
    if in_flight is not None:
        _fold(acc, *in_flight)


def _fold(acc, stats: dict, n: int) -> None:
    acc.add_span({k: v.cpu().numpy() for k, v in stats.items()}, n)


# ---------------------------------------------------------------------------
# The cores mesh: ONE program's core axis over the ranks of 'cores'.


class CoresShard:
    """This rank's block of a program's cores on a cores mesh, as the
    engines read it (:func:`..sim.interpreter._step`): ``core0``, its
    first core on the full axis; ``bits`` / ``valid``, the injected bits
    of its shots over EVERY core (each rank holds the global bits, so
    they need no gather); ``plan``, the full program's block plan (for
    ``engine='block'``); and the collectives over ``'cores'``."""

    def __init__(self, mesh, n_cores: int, bits, plan=None):
        self.size, self.index, self.group = axis(mesh, 'cores')
        self.core0 = self.index * (n_cores // self.size)
        self.bits = bits
        self.valid = torch.ones(bits.shape, dtype=torch.bool,
                                device=bits.device)
        self.plan = plan

    def gather_words(self, words: dict) -> dict:
        """``[B, C, ...]`` int32 or bool words of this rank's cores ->
        the same words over every core, in ONE all-gather (the words
        packed along a trailing axis)."""
        if not words:
            return {}
        cols = [v.to(torch.int32).reshape(v.shape[0], v.shape[1], -1)
                for v in words.values()]
        full = gather_cat(torch.cat(cols, -1), self.group, 1)
        out, at = {}, 0
        for (k, v), c in zip(words.items(), cols):
            w = full[..., at:at + c.shape[-1]]
            w = w.reshape(full.shape[0], full.shape[1], *v.shape[2:])
            out[k] = w.bool() if v.dtype == torch.bool else w
            at += c.shape[-1]
        return out

    def all_ranks(self, per_shot):
        """``all()`` of a ``[B]`` bool over the ranks of ``'cores'``."""
        return all_ranks(per_shot, self.group)


def _cores_cfg(mp, mesh, cfg: InterpreterConfig, device) -> tuple:
    """Validate a config for sharded-cores execution on ``mesh``: the
    mesh must carry ``('dp', 'cores')`` axes, the program's cores must
    split evenly over ``'cores'``, and the pair must be eligible
    (:func:`..sim.interpreter.resolve_engine` raises with the blocker
    :func:`..sim.interpreter.cores_ineligible` names).  Returns ``(cfg,
    engine)``."""
    names = tuple(mesh.mesh_dim_names or ())
    for name in ('dp', 'cores'):
        if name not in names:
            raise ValueError(
                f"sharded-cores execution needs a ('dp', 'cores') mesh "
                f'(parallel.mesh.make_cores_mesh); got axes {names}')
    if cfg.cores_axis is None:
        cfg = replace(cfg, cores_axis='cores')
    elif cfg.cores_axis != 'cores':
        raise ValueError(
            f"cfg.cores_axis={cfg.cores_axis!r} does not name this "
            f"mesh's 'cores' axis")
    n_shards = axis(mesh, 'cores')[0]
    if mp.n_cores % n_shards:
        raise ValueError(
            f'{mp.n_cores} program cores not divisible over the '
            f'cores axis ({n_shards} shards)')
    eng = resolve_engine(mp, cfg, device)
    _check_fabric(cfg, mp.n_cores)
    return cfg, eng


def _cores_inputs(mp, meas_bits, mesh, init_regs, cfg, eng, device,
                  shot_dim: int = 0):
    """``(bits, regs, shard)``: this rank's dp rows of the global bits
    over its own cores, its registers, and its :class:`CoresShard`."""
    n_shots = _shape(meas_bits)[shot_dim]
    rows = _pad_meas(_block(meas_bits, mesh, 'dp', shot_dim, device,
                            torch.int32), cfg.max_meas)
    plan = _block_plan(_soa_np(mp)) if eng == 'block' else None
    regs = _shotwise_init_regs(init_regs, n_shots, device)
    if regs is not None and regs.ndim == 3:
        regs = _block(regs, mesh, 'dp', 0, device)
    if shot_dim:                       # rounds: R x B lanes, round-major
        R = rows.shape[0]
        if regs is not None and regs.ndim == 3:
            regs = regs[None].expand(R, *regs.shape).reshape(
                -1, *regs.shape[1:])
        rows = rows.reshape(-1, *rows.shape[2:])
    shard = CoresShard(mesh, mp.n_cores, rows, plan)
    own = slice(shard.core0, shard.core0 + mp.n_cores // shard.size)
    if regs is not None:
        regs = regs[..., own, :]
    return rows[:, own].contiguous(), regs, shard


def _cores_strict(out: dict, mesh, strict: bool) -> None:
    """:func:`..sim.interpreter._check_strict` over the whole mesh: a
    shot trapped when any of its cores, on any rank, did."""
    if strict:
        full = gather_cat(out['fault'], axis(mesh, 'cores')[2], -1)
        counts = psum({'n': fault_shot_counts(full)},
                      axis(mesh, 'dp')[2])['n'].cpu().numpy()
        if counts.any():
            raise FaultError(counts)


def sharded_cores_simulate(mp, meas_bits, mesh, init_regs=None,
                           cfg: InterpreterConfig = None, device=None, **kw):
    """Run ONE program with its core axis sharded over the mesh
    ``'cores'`` axis (shots over ``'dp'``): each rank runs its own cores'
    lanes, and the fproc/sync fabric reads the other cores' words
    through one all-gather per step — the distributed processor, with
    the collectives standing in for the gateware's ``sync_iface`` /
    ``fproc`` wiring.  Every output equals the single-device generic
    engine's, the fault words included; ``engine='block'`` runs the
    block engine so, with K1 block bodies on the rank's own cores.

    ``meas_bits``: the global ``[n_shots, n_cores, n_meas]``, ``n_shots``
    divisible by the dp axis and ``n_cores`` by the cores axis.  Returns
    this rank's ``[n_shots / dp, n_cores / cores, ...]`` block of the
    :func:`simulate_batch` pytree, minus the scalar diagnostics."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    _check_single_round(cfg)
    cfg, strict = _fault_policy(cfg)
    cfg, eng = _cores_cfg(mp, mesh, cfg, device)
    bits, regs, shard = _cores_inputs(mp, meas_bits, mesh, init_regs, cfg,
                                      eng, device)
    out = _drop_scalars(_run_injected(mp, eng, bits, regs, cfg, device,
                                      cores=shard))
    _cores_strict(out, mesh, strict)
    return out


def sharded_cores_stat_sums(mp, meas_bits, mesh, init_regs=None,
                            cfg: InterpreterConfig = None, device=None,
                            **kw):
    """The integer sums under :func:`sharded_cores_stats`
    (:func:`sweep_stat_sums` parity) with the core axis sharded over
    ``'cores'`` and shots over ``'dp'``: per-core sums concatenate over
    ``'cores'`` (each core's sum lives on one rank), the cross-core
    folds (err and fault are any-over-cores) gather the full-width words
    first, and only the shot axis is summed over ``'dp'``.  Whole on
    every rank."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    _check_single_round(cfg)
    cfg = replace(cfg, record_pulses=False)
    cfg, eng = _cores_cfg(mp, mesh, cfg, device)
    bits, regs, shard = _cores_inputs(mp, meas_bits, mesh, init_regs, cfg,
                                      eng, device)
    out = _run_injected(mp, eng, bits, regs, cfg, device, cores=shard)
    full = shard.gather_words({'err': out['err'], 'fault': out['fault']})
    sums = dict(
        pulse_sum=gather_cat(out['n_pulses'].sum(0), shard.group, 0),
        err_shots=(full['err'] != 0).any(1).sum(),
        qclk_sum=gather_cat(out['qclk'].sum(0), shard.group, 0),
        fault_shots=fault_shot_counts(full['fault']))
    return psum(_int64(sums), axis(mesh, 'dp')[2])


def sharded_cores_stats(mp, meas_bits, mesh, init_regs=None,
                        cfg: InterpreterConfig = None, device=None, **kw):
    """A sharded-cores run reduced to global statistics
    (:func:`sweep_stats` parity)."""
    sums = sharded_cores_stat_sums(mp, meas_bits, mesh, init_regs=init_regs,
                                   cfg=cfg, device=device, **kw)
    return _means(sums, _shape(meas_bits)[0])


def sharded_cores_rounds(mp, meas_bits, mesh, init_regs=None,
                         cfg: InterpreterConfig = None, device=None, **kw):
    """R rounds of :func:`sharded_cores_simulate` in one engine call:
    ``meas_bits`` is the global ``[rounds, n_shots, n_cores, n_meas]``;
    the rounds run as ``R x B`` lanes (:func:`..sim.interpreter.
    simulate_rounds`), each from a fresh initial state with its round's
    bits; ``init_regs`` is shared across rounds.  Returns this rank's
    block of the :func:`sharded_cores_simulate` pytree with a leading
    round axis on every leaf."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    cfg, strict = _fault_policy(cfg)
    shape = tuple(_shape(meas_bits))
    if len(shape) != 4 or shape[2] != mp.n_cores:
        raise ValueError(
            f'meas_bits must be [rounds, n_shots, n_cores='
            f'{mp.n_cores}, n_meas]; got {shape}')
    R = shape[0]
    if cfg.rounds != 1 and cfg.rounds != R:
        raise ValueError(
            f'cfg.rounds={cfg.rounds} contradicts the meas_bits round '
            f'axis {R}')
    cfg, eng = _cores_cfg(mp, mesh, replace(cfg, rounds=R), device)
    bits, regs, shard = _cores_inputs(mp, meas_bits, mesh, init_regs, cfg,
                                      eng, device, shot_dim=1)
    out = _drop_scalars(_run_injected(mp, eng, bits, regs, cfg, device,
                                      groups=R, cores=shard))
    _cores_strict({'fault': out['fault'].flatten(0, 1)}, mesh, strict)
    return out
