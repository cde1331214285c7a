"""Batched PyTorch interpreter for the distributed-processor ISA: the
generic fetch-dispatch engine, the straight-line engine, the block
engine and the engine ladder.

Counterpart of ``distributed_processor_tpu/sim/interpreter.py`` (the
JAX engine, which is the reference).  The machine state is held in int32
tensors shaped ``[n_shots, n_cores, ...]``.

* The generic engine advances every core of every shot one *instruction*
  per step; the sync barrier and the measurement (fproc) fabric are
  masked reductions over the core axis each step (reference gateware:
  hdl/sync_iface.sv, hdl/fproc_meas.sv, hdl/core_state_mgr.sv).  The
  step loop is a Python ``while`` read with one ``.item()`` per step.
* The straight-line engine (:func:`_exec_straightline`) makes one pass
  over a forward-jump-only program, index by index.  It is the plain
  version of the span kernels K1 (``engine='pallas'``) and K3
  (``engine='fused'``, :mod:`.physics`), ``csrc/exec_span.cu``.
* The block engine (:func:`_exec_blocks`) runs any program, loops
  included: per iteration one generic step for cores at a branch, fproc
  read or sync, and one whole straight-line superinstruction for cores
  at a block start.  Its bodies (:func:`_apply_blocks`) are the plain
  version of the megastep kernel's block mode, K1 block
  (``engine='pallas'`` on a looping program).
* :func:`simulate` runs one shot: the batch entry at a batch of one.
* :func:`simulate_multi_batch` runs an ensemble of P programs x B shots
  as one generic-engine pass over ``P x B`` lanes, each lane fetching
  from its own program's rows; :func:`simulate_rounds` runs R
  independent rounds as ``R x B`` lanes of the resolved engine (one K1
  span launch on a loop-free program), with the in-loop decode of
  :mod:`..ops.decode`.  Both report ``steps``, ``incomplete`` and
  ``op_hist`` per program or round, as the JAX package's vmap and scan
  do (:func:`_exec_loop`'s ``group_steps``).
* A run sharded over a cores mesh (:mod:`..parallel.sweep`) hands the
  generic and block engines its rank's shard (``cores``): the lanes of
  the rank's own cores, with the fabric's and the sync barrier's reads
  of other cores through one all-gather per step (:func:`_step`) and the
  settle test over every rank.  The single-device entry points refuse a
  set ``cores_axis``.
* :func:`resolve_engine` is the JAX package's ladder; ``'auto'`` picks
  the K1 kernel (span or block mode) on a CUDA device where the JAX
  package picks its Pallas kernel on a TPU.

Dynamic indexing uses ``torch.gather`` where the JAX engine uses one-hot
multiply-reduce for the TPU's vector unit.  The contract is identical
integers: every output key, ``err`` and ``fault`` included, matches the
JAX run of the same engine on the same injected bits
(tests/test_torch_interpreter.py, tests/test_torch_straightline.py,
tests/test_torch_blocks.py).

Scope: physics mode on every device co-state of :mod:`.device` — the
parity counter and the Bloch vector (:func:`_device_1q_pulse`, shared by
every engine) and the entangling state vector (:func:`_statevec_pulse`,
the generic engine only, behind the discrete-event gate of
:func:`_step`; on a CUDA state one launch of ``csrc/statevec.cu`` a
step, :func:`..ops.statevec.statevec_pulse`) — and the ``'sticky'``,
``'fresh'`` and ``'lut'`` fabrics (the last: the time-indexed syndrome
LUT of hdl/fproc_lut.sv + meas_lut.sv, over a ``meas_time`` plane of
production clocks).
``trace=True`` records every step's pc, time and qclk origin per lane
(``trace_pc``, ``trace_time``, ``trace_off`` ``[B, C, max_steps]``) on
the generic engine, which the ladder forces for it, as in the JAX
package; :func:`..utils.vcd.write_vcd` writes one shot as a VCD file.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import isa
from ..decoder import MultiMachineProgram, stack_machine_programs
from ..obs.trace import host_span
from ..ops.decode import as_decode_spec, decode_history
from ..ops.exec_span import (block_table, exec_blocks, exec_span,
                             lut_min_read, span_table)
from ..ops.statevec import statevec_pulse, takes_kernel
from ..ops.waveform import PHASE_BITS
from ..utils.profiling import counter_get, counter_inc
from .device import DEVICE_KINDS, STATEVEC_MAX_CORES

# timing constants of the scalar golden model (the JAX package's
# sim/oracle.py): program start time, sync release -> qclk zero, rdlo
# pulse end -> bit available, and the sticky-fabric race window
INIT_TIME = 2
QCLK_RST_DELAY = 4
MEAS_LATENCY = 64
STICKY_RACE_MARGIN = 2

INT32_MAX = 2**31 - 1

# error bits (per core)
ERR_MISSED_TRIG = 1      # pulse/idle trigger time already passed at issue
ERR_PULSE_OVERFLOW = 2   # more pulses than the static record buffer
ERR_MEAS_OVERFLOW = 4    # more measurements than meas_bits provides
ERR_FPROC_DEADLOCK = 8   # fproc read with producer halted and no data
ERR_SYNC_DONE = 16       # barrier released with a participant already done
ERR_FPROC_ID = 32        # fproc func_id out of range
ERR_STICKY_RACE = 64     # sticky read raced a measurement's arrival
ERR_CW_MEAS = 128        # physics mode: measurement pulse with a CW envelope
ERR_COFIRE_ORDER = 256   # statevec: non-commuting equal-time co-fire

# fault trap codes (per lane, per core): the engine could not faithfully
# execute the program, so the shot's statistics are untrustworthy
FAULT_BUDGET_EXHAUSTED = 1   # steps hit max_steps with the lane live
FAULT_SYNC_DEADLOCK = 2      # barrier wait that can never release
FAULT_FPROC_STARVED = 4      # fproc wait with no producer able to deliver
FAULT_PULSE_OVERFLOW = 8     # emitted pulses exceed max_pulses
FAULT_MEAS_OVERFLOW = 16     # measurements exceed max_meas
FAULT_RESET_OVERFLOW = 32    # reset records exceed max_resets
FAULT_ILLEGAL_OP = 64        # decoded kind outside the ISA, or bad func_id
FAULT_JUMP_OOB = 128         # pc or taken branch target >= n_instr

# name <-> bit registry, in bit order (docs + aggregation schema)
FAULT_CODES = (
    ('budget_exhausted', FAULT_BUDGET_EXHAUSTED),
    ('sync_deadlock', FAULT_SYNC_DEADLOCK),
    ('fproc_starved', FAULT_FPROC_STARVED),
    ('pulse_overflow', FAULT_PULSE_OVERFLOW),
    ('meas_overflow', FAULT_MEAS_OVERFLOW),
    ('reset_overflow', FAULT_RESET_OVERFLOW),
    ('illegal_op', FAULT_ILLEGAL_OP),
    ('jump_oob', FAULT_JUMP_OOB),
)


class FaultError(RuntimeError):
    """Raised host-side under ``fault_mode='strict'`` when any lane
    trapped.  ``counts`` is the ``[len(FAULT_CODES)]`` per-code shot count
    (see :func:`fault_shot_counts`)."""

    def __init__(self, counts):
        self.counts = np.asarray(counts)
        parts = [f'{name}={int(n)}'
                 for (name, _), n in zip(FAULT_CODES, self.counts) if n]
        super().__init__('faulted shots: ' + (', '.join(parts) or 'none'))

    def __reduce__(self):
        # default exception pickling replays __init__ with the MESSAGE
        # as counts; rebuild from the counts array instead so the error
        # crosses the fleet wire (serve/transport.py) intact
        return (FaultError, (self.counts,))


def is_infrastructure_error(exc: BaseException) -> bool:
    """Classify an execution failure: ``True`` means the execution
    SUBSTRATE failed (a CUDA runtime fault, device loss, resource
    exhaustion, a chaos-injected crash) and the same program would
    plausibly succeed on a healthy executor — the serving tier's
    :class:`~..serve.supervise.RetryPolicy` may retry it.  ``False``
    means the failure is a property of the PROGRAM or the request
    itself (:class:`FaultError`, static-validation errors, bad
    arguments) and would reproduce identically anywhere: these always
    propagate to the caller on the first attempt.

    :class:`~..integrity.IntegrityError` (detected silent data
    corruption) is a plain RuntimeError and therefore
    infrastructure-class by design: a re-execution on another engine or
    device re-derives the correct bits, which is what the retry
    machinery does.  The port raises the JAX package's exception types
    at the same validation points, so a request the JAX service would
    not retry is not retried here either.
    """
    if isinstance(exc, (FaultError, ValueError, TypeError, KeyError,
                        IndexError, AssertionError,
                        NotImplementedError)):
        return False
    # decoder.ProgramValidationError by name: any *ValidationError is
    # program-class
    if type(exc).__name__.endswith('ValidationError'):
        return False
    return True


def torch_device(device=None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller
    names another.  Raises when CUDA is asked for and absent — a run
    meant for the card never falls back to the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return device


def fault_shot_counts(fault: torch.Tensor) -> torch.Tensor:
    """``fault [..., n_cores] -> [len(FAULT_CODES)]`` int64: shots where any
    core trapped with each code (any over cores, sum over shots)."""
    with host_span('h2d.wait'):
        bits = torch.tensor([bit for _, bit in FAULT_CODES],
                            dtype=torch.int32, device=fault.device)
    per_shot = ((fault[..., None] & bits) != 0).any(dim=-2)
    return per_shot.sum(dim=tuple(range(per_shot.ndim - 1)))


_PMASKS = (0xffffff, 0x1ffff, 0x1ff, 0xffff, 0xf)
# field order matches isa.PULSE_PARAM_ORDER = (env, phase, freq, amp, cfg)

# column order of the packed [n_cores, n_instr, F] program table
_FIELDS = ('kind', 'alu_op', 'in0_is_reg', 'imm', 'in0_reg', 'in1_reg',
           'out_reg', 'jump_addr', 'func_id', 'cmd_time',
           'p_env', 'p_phase', 'p_freq', 'p_amp', 'p_cfg',
           'p_wen', 'p_regsel', 'p_reg')
_F = {name: i for i, name in enumerate(_FIELDS)}

# pulse-record fields, kept as one [B, C, F, P] tensor
_REC_FIELDS = ('qtime', 'gtime', 'env', 'phase', 'freq', 'amp', 'cfg',
               'elem', 'dur')


@dataclass(frozen=True)
class InterpreterConfig:
    """Static execution parameters — the JAX package's
    ``InterpreterConfig`` field for field, so one config reads the same
    in both packages, and every field is served.  The carry layout knobs
    of the JAX package's Pallas kernel (``steps_per_iter``,
    ``packed_ctrl``, ``pallas_interpret``, ``packed_carry``) leave every
    engine's results unchanged and are accepted as no-ops: the port's
    K1 has one carry layout (:func:`use_packed_carry`,
    :func:`carry_stream_bytes`)."""
    max_steps: int = 4096
    max_pulses: int = 256
    max_meas: int = 64
    max_resets: int = 8
    fabric: str = 'sticky'        # 'sticky' | 'fresh' | 'lut'
    meas_elem: int = 2            # element index whose pulses are readouts
    meas_latency: int = MEAS_LATENCY
    lut_mask: tuple = ()
    lut_table: tuple = ()
    trace: bool = False
    record_pulses: bool = True
    physics: bool = False
    device: str = 'parity'
    drive_elem: int = 0
    x90_amp: int = 0
    cw_horizon: int = 0
    steps_per_iter: int = 1
    packed_ctrl: bool = False
    straightline: bool = False
    engine: str = None
    pallas_interpret: bool = None
    packed_carry: bool = None
    opcode_histogram: bool = False
    fault_mode: str = 'count'
    cores_axis: str = None
    rounds: int = 1
    alu_instr_clks: int = 5
    jump_cond_clks: int = 5
    jump_fproc_clks: int = 8
    pulse_regwrite_clks: int = 3
    pulse_load_clks: int = 3

    @classmethod
    def from_fpga_config(cls, fpga_config, **kw) -> 'InterpreterConfig':
        """A config with the timing constants of ``fpga_config`` (a
        :class:`~..hwconfig.FPGAConfig`); explicit ``kw`` win.  A
        configured measurement LUT flows into ``lut_mask`` /
        ``lut_table`` (the ``'lut'`` fabric's wiring; ``fabric`` itself
        stays the caller's choice)."""
        if getattr(fpga_config, 'meas_lut_mask', ()):
            kw.setdefault('lut_mask', tuple(fpga_config.meas_lut_mask))
            kw.setdefault('lut_table', tuple(fpga_config.meas_lut_table))
        return cls(alu_instr_clks=fpga_config.alu_instr_clks,
                   jump_cond_clks=fpga_config.jump_cond_clks,
                   jump_fproc_clks=fpga_config.jump_fproc_clks,
                   pulse_regwrite_clks=fpga_config.pulse_regwrite_clks,
                   pulse_load_clks=fpga_config.pulse_load_clks, **kw)


# ---------------------------------------------------------------------------
# The engine ladder — the JAX package's, rule for rule, so that both
# packages pick the same engine for the same program and config.

ENGINES = ('auto', 'generic', 'block', 'straightline', 'pallas', 'fused')

# AUTO straight-line cap: the JAX package unrolls the program into one
# module, whose compile time outgrows the run-time win past this size
SL_AUTO_MAX_INSTR = 256
# AUTO block-mode cap on the total deduplicated superinstruction length
BLOCK_AUTO_MAX_UNROLL = 512
# device types where 'auto' considers the megastep kernel, which exists
# only on the card (the JAX package's _PALLAS_AUTO_BACKENDS = ('tpu',))
_PALLAS_AUTO_DEVICES = ('cuda',)


def _soa_np(mp) -> np.ndarray:
    """The decoded program as one packed ``[C, N, F]`` int32 array,
    columns in :data:`_FIELDS` order."""
    return np.stack([np.asarray(getattr(mp.soa, f)) for f in _FIELDS],
                    axis=-1).astype(np.int32)


def use_straightline(mp, cfg: InterpreterConfig) -> bool:
    """Resolve the tri-state ``cfg.straightline`` against ``mp``."""
    if cfg.straightline is False:
        return False
    reason = straightline_ineligible(mp, cfg)
    if cfg.straightline is True:
        if reason:
            raise ValueError(f'straightline=True but the program is '
                             f'ineligible: {reason}')
        return True
    return reason is None and mp.n_instr <= SL_AUTO_MAX_INSTR


def straightline_ineligible(mp, cfg: InterpreterConfig) -> str:
    """Why ``(mp, cfg)`` cannot run on the straight-line engine
    (:func:`_exec_straightline`) — ``None`` when it can.

    Eligible programs are forward-jump-only (no loops), SYNC-free,
    DONE-terminated, with fproc reads only of the core's own sticky
    channel — the compiled active-reset + RB shape — or, under the
    ``'lut'`` fabric, LUT reads that every masked core's measurements
    precede (:func:`_lut_span_reject`)."""
    if cfg.trace:
        return 'trace mode records per-step state'
    if cfg.physics and cfg.device == 'statevec':
        return 'statevec device (event-ordering gate needs the ' \
               'generic engine)'
    soa_np = _soa_np(mp) if cfg.fabric == 'lut' else None
    return _sl_ineligible_fields(np.asarray(mp.soa.kind),
                                 np.asarray(mp.soa.jump_addr),
                                 np.asarray(mp.soa.func_id), cfg, soa_np)


def _sl_ineligible_fields(kind, jump_addr, func_id, cfg: InterpreterConfig,
                          soa_np=None) -> str:
    """The straight-line shape checks of :func:`straightline_ineligible`
    on ``[C, N]`` field arrays, shared with :func:`_pallas_mode` and
    :func:`fused_ineligible` so that dispatch and eligibility cannot
    drift.  ``soa_np``: the packed ``[C, N, F]`` program, needed only for
    the ``'lut'`` fabric's admission (:func:`_lut_span_reject`); ``None``
    rejects that combination."""
    C, N = kind.shape
    if np.any(kind == isa.K_SYNC):
        return 'SYNC barrier'
    idx = np.arange(N)[None, :]
    jmask = (kind == isa.K_JUMP_I) | (kind == isa.K_JUMP_COND) \
        | (kind == isa.K_JUMP_FPROC)
    if np.any(jmask & (jump_addr <= idx)):
        return 'backward jump (loop)'
    fmask = (kind == isa.K_ALU_FPROC) | (kind == isa.K_JUMP_FPROC)
    if np.any(fmask):
        if cfg.fabric == 'sticky':
            if np.any(fmask & (func_id != np.arange(C)[:, None])):
                return 'cross-core fproc read'
        elif cfg.fabric == 'lut':
            reason = _lut_span_reject(soa_np, fmask, func_id, cfg)
            if reason:
                return reason
        else:
            return f'fabric {cfg.fabric!r} with fproc reads'
    if np.any(kind[:, -1] != isa.K_DONE):
        return 'program not DONE-terminated'
    return None


def _lut_span_reject(soa_np, fmask, func_id,
                     cfg: InterpreterConfig) -> str:
    """Why ``'lut'``-fabric fproc reads cannot be served in a span pass
    (straight-line engine, K1 span, K3) — ``None`` when they can.

    The span serves a LUT read from the measurement planes at the read's
    index with no wait on the producers.  That equals the generic
    engine's time-indexed serve exactly when the planes are final at the
    read: every masked core's possibly-measurement trigger
    (:func:`_possibly_meas_mask`) lies at an index below every fproc
    read (``min_read``).  Own-fresh reads (``func_id == 0``) keep their
    per-step stall and stay with the block engine."""
    if soa_np is None:
        return "fabric 'lut' with fproc reads"
    if np.any(fmask & (func_id == 0)):
        return ("own-fresh fproc read (func_id=0) under fabric 'lut' "
                "(per-step stall semantics — block engine hosts it)")
    if cfg.lut_mask is None or cfg.lut_table is None:
        return "fabric 'lut' with fproc reads but no lut_mask/lut_table"
    C = fmask.shape[0]
    lmask = np.asarray(cfg.lut_mask, dtype=bool)
    if lmask.shape[0] != C:
        return f'lut_mask length {lmask.shape[0]} != n_cores {C}'
    pm = _possibly_meas_mask(soa_np, cfg)
    if pm is None:
        return "fabric 'lut' with fproc reads in a looping program"
    if np.any(pm[lmask, lut_min_read(fmask):]):
        return ("fabric 'lut': a masked core's possibly-measurement "
                "trigger at or after an fproc read index (measurement "
                "planes not final at the span serve; the block engine "
                "hosts this shape)")
    return None


def block_ineligible(mp, cfg: InterpreterConfig) -> str:
    """Why ``(mp, cfg)`` cannot run on the JAX package's block engine —
    ``None`` when it can (trace mode and the statevec gate only)."""
    if cfg.trace:
        return 'trace mode records per-instruction-step state'
    if cfg.physics and cfg.device == 'statevec':
        return 'statevec device (event-ordering gate needs the ' \
               'generic engine)'
    return None


def pallas_ineligible(mp, cfg: InterpreterConfig) -> str:
    """Why ``(mp, cfg)`` cannot run on the megastep engine
    (``engine='pallas'``) — ``None`` when it can: the straight-line rules
    or the block rules, minus trace mode and physics mode (the device
    co-state and the epoch resolver stay with the other engines)."""
    if cfg.trace:
        return 'trace mode records per-step state'
    if cfg.physics:
        return 'physics mode (device co-state + epoch resolver run ' \
               'on the XLA engines)'
    if straightline_ineligible(mp, cfg) is None:
        return None
    return block_ineligible(mp, cfg)


def fused_ineligible(mp, cfg: InterpreterConfig) -> str:
    """Why ``(mp, cfg)`` cannot run on the measure-in-megastep engine
    (``engine='fused'``) — ``None`` when it can: physics-closed runs on
    the parity device, span-shaped programs whose measurement count has
    a static bound within ``max_meas``, no CW windows.  The readout
    model's own gates (sigma = 0 and the rest) live in
    :func:`..sim.physics.run_physics_batch`."""
    if not cfg.physics:
        return ('injected-bits run (no readout window to demodulate) '
                '— the fused engine closes the physics loop; run via '
                'sim.physics.run_physics_batch')
    if cfg.device != 'parity':
        return (f'device {cfg.device!r} (the in-kernel discriminator '
                f'consumes the parity quarter-turn co-state)')
    if cfg.cw_horizon > 0:
        return 'CW measurement windows (cw_horizon > 0) have no ' \
               'static length'
    if cfg.trace:
        return 'trace mode records per-step state'
    soa_np = _soa_np(mp)
    reason = _sl_ineligible_fields(np.asarray(mp.soa.kind),
                                   np.asarray(mp.soa.jump_addr),
                                   np.asarray(mp.soa.func_id), cfg, soa_np)
    if reason:
        return reason
    mb, _ = _static_meas_bounds(soa_np, cfg)
    if mb is None:
        return 'measurement count not statically boundable'
    if mb > cfg.max_meas:
        return (f'static measurement bound {mb} exceeds max_meas='
                f'{cfg.max_meas} (overflow re-resolves the last slot '
                f'with epoch-boundary ordering)')
    return None


_JUMP_KINDS = (isa.K_JUMP_I, isa.K_JUMP_COND, isa.K_JUMP_FPROC)


def _possibly_meas_mask(soa_np, cfg: InterpreterConfig):
    """``[C, N]`` bool: True where the index is a ``K_PULSE_TRIG`` whose
    latched cfg nibble can select ``cfg.meas_elem`` — a forward
    possible-values analysis of the nibble (init 0; a register-sourced
    cfg write is any value) over the forward-only program.  A False
    trigger is provably a drive pulse.  ``None`` when a backward edge
    makes the single ascending pass invalid."""
    kind = soa_np[..., _F['kind']]
    C, N = kind.shape
    out = np.zeros((C, N), dtype=bool)
    for c in range(C):
        k = kind[c]
        wen = soa_np[c, :, _F['p_wen']]
        rsel = soa_np[c, :, _F['p_regsel']]
        pcfg = soa_np[c, :, _F['p_cfg']]
        ja = soa_np[c, :, _F['jump_addr']]
        is_p = np.isin(k, (isa.K_PULSE_WRITE, isa.K_PULSE_TRIG))
        jump_preds = [[] for _ in range(N)]
        for i in np.nonzero(np.isin(k, _JUMP_KINDS))[0]:
            t = int(ja[i])
            if 0 <= t < N:
                jump_preds[t].append(int(i))
        outs = [frozenset()] * N   # None = any nibble
        for i in range(N):
            s, top = (frozenset((0,)), False) if i == 0 \
                else (frozenset(), False)
            srcs = []
            if i > 0 and int(k[i - 1]) not in (isa.K_JUMP_I, isa.K_DONE):
                srcs.append(outs[i - 1])
            for jp in jump_preds[i]:
                if jp >= i:
                    return None                  # backward edge
                srcs.append(outs[jp])
            for o in srcs:
                if o is None:
                    top = True
                else:
                    s = s | o
            own = None if top else s
            if is_p[i] and (int(wen[i]) >> 4) & 1:
                own = None if (int(rsel[i]) >> 4) & 1 \
                    else frozenset((int(pcfg[i]) & 0xf,))
            outs[i] = own
            if int(k[i]) == isa.K_PULSE_TRIG and (
                    own is None
                    or any((v & 3) == cfg.meas_elem for v in own)):
                out[c, i] = True
    return out


def _static_meas_bounds(soa_np, cfg: InterpreterConfig):
    """``(meas_bound, reset_bound)``: per-core worst-case counts of
    measurement pulses and phase resets one span execution can retire
    (``meas_bound`` None when a backward edge voids the analysis)."""
    kind = soa_np[..., _F['kind']]
    C = kind.shape[0]
    n_rst = int(max((int(np.sum(kind[c] == isa.K_PULSE_RESET))
                     for c in range(C)), default=0))
    pm = _possibly_meas_mask(soa_np, cfg)
    if pm is None:
        return None, n_rst
    bound = int(max((int(pm[c].sum()) for c in range(C)), default=0))
    return bound, n_rst


# ---------------------------------------------------------------------------
# The JAX package's bit-packed megastep carry, as probes.  Its Pallas
# kernel can round-trip the machine state through HBM bit-packed, under a
# layout carry_packspec derives from a static analysis of the program;
# the port's K1 / K3 read and write one unpacked int32 / bool layout, so
# packed_carry is a no-op here.  carry_packspec is kept as the JAX
# package's analysis (its tuples equal JAX's:
# tests/test_torch_carry_probes.py) and carry_stream_bytes prices the
# port's own kernels.

_ERR_ALL = (ERR_MISSED_TRIG | ERR_PULSE_OVERFLOW | ERR_MEAS_OVERFLOW
            | ERR_FPROC_DEADLOCK | ERR_SYNC_DONE | ERR_FPROC_ID
            | ERR_STICKY_RACE | ERR_CW_MEAS | ERR_COFIRE_ORDER)
_FAULT_ALL = functools.reduce(lambda a, b: a | b,
                              (bit for _, bit in FAULT_CODES))
# pulse-latch regsel bits whose register sourcing makes pulse DURATION
# dynamic: env (bit 0, length nibble) and cfg (bit 4, element select)
_RSEL_TIMING = 0b10001


def _bl(x: int) -> int:
    return max(int(x).bit_length(), 1)


def _static_pc_width(soa_np):
    """Bits covering every value ``pc`` can hold: the fall-through
    range ``[0, N]`` plus every static jump target (a taken OOB jump
    parks the lane AT the raw target).  None when a negative target
    exists (sign bit needed — not worth a lane)."""
    kind = soa_np[..., _F['kind']]
    ja = soa_np[..., _F['jump_addr']]
    jm = np.isin(kind, _JUMP_KINDS)
    hi = int(soa_np.shape[1])
    if np.any(jm):
        t = ja[jm]
        if int(t.min()) < 0:
            return None
        hi = max(hi, int(t.max()))
    return _bl(hi)


def _static_clock_bound(soa_np, cfg: InterpreterConfig, spc_np, interp_np):
    """Upper bound on every clock value (``time`` / ``meas_avail`` /
    ``rst_time`` / ``meas_gtime``) one SPAN execution can produce, or
    None when the program makes clocks data-dependent (INC_QCLK
    rewrites the offset; a reg-sourced envelope/cfg latch makes pulse
    duration dynamic).  Walks each core's instruction list once —
    sound because a span index retires at most once — accumulating the
    per-kind time advances of ``_sl_apply_instr`` with every pulse
    charged the worst static duration."""
    kind = soa_np[..., _F['kind']]
    C, N = kind.shape
    if np.any(kind == isa.K_INC_QCLK):
        return None
    bound = 0
    for c in range(C):
        k = kind[c]
        wen = soa_np[c, :, _F['p_wen']].astype(np.int64)
        rsel = soa_np[c, :, _F['p_regsel']].astype(np.int64)
        penv = soa_np[c, :, _F['p_env']].astype(np.int64)
        cmd = soa_np[c, :, _F['cmd_time']].astype(np.int64)
        is_p = np.isin(k, (isa.K_PULSE_WRITE, isa.K_PULSE_TRIG))
        if np.any((wen[is_p] & rsel[is_p] & _RSEL_TIMING) != 0):
            return None
        # worst static duration: longest latched envelope at the
        # slowest element clock (CW 0xfff counts as 0 — physics-mode
        # CW measurement windows are gated out of the packed engines)
        lens = (penv[is_p & ((wen & 1) == 1)] >> 12) & 0xfff
        lens = lens[lens != 0xfff]
        interp_max = int(np.max(interp_np[c])) if interp_np[c].size else 1
        spc_min = max(int(np.min(spc_np[c])), 1) if spc_np[c].size else 1
        dur_max = 0
        for L in np.unique(lens).tolist():
            ns = int(L) * 4 * interp_max
            dur_max = max(dur_max, -(-ns // spc_min))
        t = int(INIT_TIME)
        for i in range(N):
            ki = int(k[i])
            if ki in (isa.K_PULSE_TRIG, isa.K_IDLE):
                t = max(t, max(int(cmd[i]), 0)) + cfg.pulse_load_clks
            elif ki in (isa.K_PULSE_WRITE, isa.K_PULSE_RESET):
                t += cfg.pulse_regwrite_clks
            elif ki == isa.K_REG_ALU:
                t += cfg.alu_instr_clks
            elif ki in (isa.K_JUMP_I, isa.K_JUMP_COND):
                t += cfg.jump_cond_clks
            elif ki in (isa.K_JUMP_FPROC, isa.K_ALU_FPROC):
                t += cfg.jump_fproc_clks
        bound = max(bound, t + dur_max + cfg.meas_latency)
    return bound if 0 <= bound < 2**31 else None


def use_packed_carry(cfg: InterpreterConfig) -> bool:
    """Resolve the ``cfg.packed_carry`` tri-state: an explicit value
    stands; AUTO (None) is False, because the port's K1 and K3 have one
    carry layout.  Either way the run is the same: the port accepts
    ``packed_carry`` as a no-op."""
    return bool(cfg.packed_carry)


def carry_packspec(mp, cfg: InterpreterConfig, trim_regs: bool = True,
                   fused: bool = False):
    """The JAX package's bit-packed carry layout for ``(mp, cfg)`` under
    its Pallas engine, as the same hashable nested tuple
    ``((state leaves), (const leaves))`` of ``(key, trim, fill, widths,
    sentinel)`` entries, or None when nothing packs.  ``trim_regs``
    must be False when the caller injects a nonzero initial register
    file; ``fused=True`` adds the measure-in-megastep co-state and
    needs a span-shaped program.  The port's kernels do not pack (see
    :func:`use_packed_carry`): this is the static analysis alone, whose
    bounds describe the program whichever layout runs it."""
    soa_np = _soa_np(mp)
    spc_np, interp_np = _element_geometry(mp)
    span = _pallas_mode(mp, cfg) == 'span'
    if fused and not span:
        raise ValueError('fused packspec needs a span-shaped program')
    kind = soa_np[..., _F['kind']]
    C, N = kind.shape
    PL = lambda trim=None, fill=0, widths=None, sentinel=None: \
        (trim, fill, widths, sentinel)
    st, co = {}, {}

    # flag/enum fields: width = the ISA's own value mask, any mode
    st['done'] = PL(widths=1)
    st['err'] = PL(widths=_bl(_ERR_ALL))
    st['fault'] = PL(widths=_bl(_FAULT_ALL))
    st['pp'] = PL(widths=tuple(int(m).bit_length() for m in _PMASKS) * C)
    w_pc = _static_pc_width(soa_np)
    if w_pc is not None:
        st['pc'] = PL(widths=w_pc)
    if trim_regs:
        wm = np.isin(kind, (isa.K_REG_ALU, isa.K_ALU_FPROC))
        written = sorted(set(
            int(r) for r in soa_np[..., _F['out_reg']][wm].tolist())
            & set(range(isa.N_REGS)))
        if len(written) < isa.N_REGS:
            st['regs'] = PL(trim=tuple(written) or (0,))

    if span:
        # span-only: every instruction index retires at most once from
        # the zeroed entry state, so counters, slot occupancy, and (in
        # the absence of INC_QCLK / reg-sourced durations) every clock
        # value have static program bounds
        tb = _static_clock_bound(soa_np, cfg, spc_np, interp_np)
        w_t = None
        if tb is not None:
            w_t = _bl(tb)
            if tb >= (1 << w_t) - 1:
                w_t += 1    # keep the all-ones code free as a sentinel
            st['time'] = PL(widths=w_t)
        if not np.any(kind == isa.K_INC_QCLK):
            st['offset'] = PL(widths=1)
        n_pt = int(max((int(np.sum(kind[c] == isa.K_PULSE_TRIG))
                        for c in range(C)), default=0))
        m_bound, n_rst = _static_meas_bounds(soa_np, cfg)
        mb = n_pt if m_bound is None else m_bound
        st['n_pulses'] = PL(widths=_bl(n_pt))
        st['n_resets'] = PL(widths=_bl(n_rst))
        st['n_meas'] = PL(widths=_bl(mb))
        M, R = cfg.max_meas, cfg.max_resets
        mk = max(min(mb, M), 1)
        rk = max(min(n_rst, R), 1)
        mtrim = tuple(range(mk)) if mk < M else None
        st['meas_avail'] = PL(
            trim=mtrim, fill=int(INT32_MAX), widths=w_t,
            sentinel=int(INT32_MAX) if w_t is not None else None)
        if cfg.fabric == 'lut':
            # production-clock plane (time-indexed LUT reads): the
            # same trim/width/sentinel envelope as meas_avail, since
            # avail = trig + dur + latency >= trig bounds the trigger
            st['meas_time'] = PL(
                trim=mtrim, fill=int(INT32_MAX), widths=w_t,
                sentinel=int(INT32_MAX) if w_t is not None else None)
        st['rst_time'] = PL(trim=tuple(range(rk)) if rk < R else None,
                            widths=w_t)
        if cfg.opcode_histogram:
            cnt = np.stack([np.sum(kind == kk, axis=1)
                            for kk in range(isa.N_KINDS)], axis=-1)
            st['op_hist'] = PL(widths=tuple(
                _bl(x) for x in cnt.reshape(-1).tolist()))
        if cfg.record_pulses and n_pt < cfg.max_pulses:
            P, keep = cfg.max_pulses, max(n_pt, 1)
            st['rec'] = PL(trim=tuple(
                fi * P + p for fi in range(len(_REC_FIELDS))
                for p in range(keep)))
        if fused:
            # measure-in-megastep: the demodulated bit and its physics
            # window parameters ride the carry as STATE; widths are the
            # pulse-param masks, slots trim to the same static
            # measurement bound
            st['meas_bits'] = PL(trim=mtrim, widths=1)
            st['meas_valid'] = PL(trim=mtrim, widths=1)
            st['phys_wait'] = PL(widths=1)
            st['meas_state'] = PL(trim=mtrim, widths=1)
            for key, w in (('meas_env', 24), ('meas_phase', 17),
                           ('meas_freq', 9), ('meas_amp', 16)):
                st[key] = PL(trim=mtrim, widths=w)
            st['meas_gtime'] = PL(trim=mtrim, widths=w_t)
            if cfg.x90_amp > 0:
                dq = (2 * int(_PMASKS[3]) + cfg.x90_amp) \
                    // (2 * cfg.x90_amp)
                st['qturns'] = PL(widths=_bl(2 + n_pt * dq))
        elif mtrim is not None:
            # injected-bits consts: values are caller-arbitrary int32
            # (never width-packed) but slots past the static bound are
            # never selected by the fproc read
            co['meas_bits'] = PL(trim=mtrim)
    else:
        # block mode loops, so only execution-count-independent fields
        # pack; the lane-activity const is a boolean mask
        co['act'] = PL(widths=1)

    clean = lambda d: {k: v for k, v in d.items()
                       if v[0] is not None or v[2] is not None}
    st, co = clean(st), clean(co)
    if not st and not co:
        return None
    enc = lambda d: tuple(sorted((k,) + v for k, v in d.items()))
    return (enc(st), enc(co))


def carry_stream_bytes(mp, cfg: InterpreterConfig, fused: bool = False):
    """``(unpacked, packed)`` per-shot bytes that one K1 span launch
    reads and writes for ``(mp, cfg)``: the carry read and written once
    (every leaf :func:`_init_state` makes for ``cfg``) plus the injected
    ``meas_bits [C, max_meas]`` int32 read once.  With ``fused=True``,
    K3's: the physics carry (``cfg`` in physics mode on the parity
    device) with the ``meas_bits`` / ``meas_valid`` planes riding it as
    state, read and written once.  The two numbers are equal: the
    port's kernels have one carry layout.  The JAX package prices its
    Pallas kernel's carry under its packed layout and multiplies by the
    megastep count (``2 x carry x steps``); K1 and K3 retire the whole
    program in one launch, so this is the whole per-shot stream."""
    C, M = mp.n_cores, cfg.max_meas
    if fused:
        cfg = replace(cfg, physics=True, device='parity')
    st = _init_state(1, C, cfg, None, 'meta')
    nbytes = sum(t.numel() * t.element_size() for t in st.values())
    if fused:
        # meas_bits int32 and meas_valid bool, both state
        total = 2 * (nbytes + C * M * 4 + C * M)
    else:
        total = 2 * nbytes + C * M * 4
    return total, total


@functools.lru_cache(maxsize=128)
def _block_plan_of(shape: tuple, content: bytes):
    soa_np = np.frombuffer(content, dtype=np.int32).reshape(shape)
    bid_at, bodies = isa.build_block_table(
        {name: soa_np[:, :, _F[name]] for name in _FIELDS})
    return bid_at, tuple(bodies)


def _block_plan(soa_np):
    """The block table of a packed ``[C, N, F]`` program: ``(bid_at,
    bodies)`` from :func:`isa.build_block_table`, cached on the
    program's content."""
    soa_np = np.ascontiguousarray(soa_np, dtype=np.int32)
    return _block_plan_of(soa_np.shape, soa_np.tobytes())


def _block_unroll_ok(mp) -> bool:
    """The block engine's ``'auto'`` size cap: at least one deduplicated
    superinstruction body (:func:`isa.build_block_table`), and their
    total length within :data:`BLOCK_AUTO_MAX_UNROLL`."""
    _, bodies = _block_plan(_soa_np(mp))
    return bool(bodies) and sum(L for _, L in bodies) \
        <= BLOCK_AUTO_MAX_UNROLL


def resolve_engine(mp, cfg: InterpreterConfig, device=None) -> str:
    """Resolve ``cfg.engine`` against the program: the engine ladder of
    the JAX package.  ``device``: the torch device of the run (default
    CUDA, as for the entry points).

    ``None`` follows the ``cfg.straightline`` tri-state (straight-line
    vs generic); ``'generic'``/``'straightline'``/``'block'``/
    ``'pallas'``/``'fused'`` force an engine and raise ``ValueError``
    with the reason when the program is ineligible; ``'auto'`` picks
    ``'pallas'`` on a CUDA device where eligible under the same size
    caps as the rung it subsumes, then ``'straightline'``, then
    ``'block'``, else ``'generic'``.  A set ``cfg.cores_axis`` (a run
    sharded over a cores mesh, :mod:`..parallel.sweep`) resolves to
    ``'generic'``, or ``'block'`` when forced, and raises with the
    blocker of :func:`cores_ineligible` otherwise."""
    eng = cfg.engine
    if cfg.cores_axis is not None:
        # the cross-rank fabric lives in the generic step, which is also
        # the block engine's boundary step; 'auto' stays on 'generic'
        reason = cores_ineligible(mp, cfg)
        if reason:
            raise ValueError(f'cores_axis={cfg.cores_axis!r} but the '
                             f'program/config is ineligible for '
                             f'sharded-cores execution: {reason}')
        return 'block' if eng == 'block' else 'generic'
    if eng is None:
        return 'straightline' if use_straightline(mp, cfg) else 'generic'
    if eng == 'generic':
        return 'generic'
    if eng == 'straightline':
        reason = straightline_ineligible(mp, cfg)
        if reason:
            raise ValueError(f"engine='straightline' but the program "
                             f"is ineligible: {reason}")
        return 'straightline'
    if eng == 'block':
        reason = block_ineligible(mp, cfg)
        if reason:
            raise ValueError(f"engine='block' but the program is "
                             f"ineligible: {reason}")
        return 'block'
    if eng == 'pallas':
        reason = pallas_ineligible(mp, cfg)
        if reason:
            raise ValueError(f"engine='pallas' but the program is "
                             f"ineligible: {reason}")
        return 'pallas'
    if eng == 'fused':
        reason = fused_ineligible(mp, cfg)
        if reason:
            raise ValueError(f"engine='fused' (measure-in-megastep) "
                             f"but the program/config is ineligible: "
                             f"{reason}")
        return 'fused'
    if eng == 'auto':
        sl_ok = straightline_ineligible(mp, cfg) is None
        dev_type = torch.device('cuda' if device is None else device).type
        if dev_type in _PALLAS_AUTO_DEVICES \
                and pallas_ineligible(mp, cfg) is None:
            if sl_ok and mp.n_instr <= SL_AUTO_MAX_INSTR:
                return 'pallas'
            if not sl_ok and _block_unroll_ok(mp):
                return 'pallas'
        if sl_ok and mp.n_instr <= SL_AUTO_MAX_INSTR:
            return 'straightline'
        if block_ineligible(mp, cfg) is None and _block_unroll_ok(mp):
            return 'block'
        return 'generic'
    raise ValueError(f'unknown engine {eng!r}; one of {ENGINES} or None')


def cores_ineligible(mp, cfg: InterpreterConfig) -> str:
    """Why ``(mp, cfg)`` cannot run sharded over a cores mesh
    (``cfg.cores_axis``) — ``None`` when it can.  The JAX package's
    rules: the sharded step is the generic engine's, reading other
    cores' words through one all-gather per step; ``engine='block'``
    runs its boundary step so and its bodies on the rank's own cores.
    Blocked: physics mode, the span-specialized engines, straight-line
    execution and trace mode."""
    if cfg.physics:
        return ('physics mode (the epoch resolver pauses host-side '
                'between epochs and draws global-shape noise streams)')
    if cfg.engine == 'block':
        reason = block_ineligible(mp, cfg)
        if reason:
            return (f"engine='block' under cores_axis but the program "
                    f'is block-ineligible: {reason}')
    elif cfg.engine not in (None, 'auto', 'generic'):
        return (f'engine={cfg.engine!r} (the span-specialized engines '
                f'trace per-program bodies with no collective fabric — '
                f'the generic step and the block engine read through '
                f'the cores-axis gathers)')
    if cfg.straightline:
        return ('straightline=True (emitted straight-line execution '
                'has no collective fabric)')
    if cfg.trace:
        return ('trace mode assembles the full-core-axis per-step '
                'trace on one device')
    return None


def _check_no_cores_axis(cfg: InterpreterConfig) -> None:
    """The single-device entry points run no collectives, so a set
    ``cores_axis`` is refused at the front door, as in the JAX
    package."""
    if cfg.cores_axis is not None:
        raise ValueError(
            f'cores_axis={cfg.cores_axis!r} names a shard_map mesh '
            f'axis the single-device entry points cannot bind — run '
            f'via parallel.sweep.sharded_cores_simulate (or clear '
            f'cores_axis for single-device execution)')


def _pallas_mode(mp, cfg: InterpreterConfig) -> str:
    """Which shape the megastep engine runs ``mp`` in: ``'span'`` (the
    whole forward-jump-only program as one kernel launch) or ``'block'``
    (superinstruction bodies inside the block engine's loop)."""
    soa_np = _soa_np(mp)
    span = _sl_ineligible_fields(soa_np[..., _F['kind']],
                                 soa_np[..., _F['jump_addr']],
                                 soa_np[..., _F['func_id']], cfg,
                                 soa_np) is None
    return 'span' if span else 'block'


def _check_fabric(cfg: InterpreterConfig, n_cores: int) -> None:
    if cfg.fabric not in ('sticky', 'fresh', 'lut'):
        raise ValueError(f"unknown fabric {cfg.fabric!r}; one of "
                         f"'sticky', 'fresh', 'lut'")
    if cfg.fabric == 'lut' and (len(cfg.lut_mask) != n_cores
                                or not cfg.lut_table):
        raise ValueError("fabric='lut' needs lut_mask (len n_cores) and "
                         "lut_table in the InterpreterConfig")


def check_supported(mp, cfg: InterpreterConfig, device=None) -> str:
    """Resolve the engine of a run on ``device`` and check its fabric;
    returns the engine."""
    eng = resolve_engine(mp, cfg, device)
    _check_fabric(cfg, mp.n_cores)
    return eng


def _check_single_round(cfg: InterpreterConfig) -> None:
    """The single-round entry points execute exactly one round per
    dispatch; a streaming config (``rounds > 1``) reaching them would
    silently serve one round of an R-round request — reject typed."""
    if cfg.rounds != 1:
        raise ValueError(
            f'cfg.rounds={cfg.rounds} is a streaming round count; the '
            f'single-round entry points execute one round per dispatch '
            f'— run via simulate_rounds (or clear rounds)')


def program_traits(mp) -> tuple:
    """Static program facts that let the step body skip whole blocks the
    program cannot exercise: ``(frozenset of instruction kinds, any
    in0-from-reg, any pulse-param-from-reg)``."""
    soa = mp.soa
    return (frozenset(int(k) for k in np.unique(np.asarray(soa.kind))),
            bool(np.any(np.asarray(soa.in0_is_reg))),
            bool(np.any(np.asarray(soa.p_regsel))))


def _max_elems(mp) -> int:
    """Element axis of the per-core geometry tables."""
    return max((len(t.elem_cfgs) for t in mp.tables), default=0) or 1


def _element_geometry(mp) -> tuple:
    """Per-element samples-per-clock and interpolation ``[C, E]`` int32
    numpy arrays of the decoded program."""
    n_cores, max_elems = mp.n_cores, _max_elems(mp)
    spc = np.ones((n_cores, max_elems), dtype=np.int32)
    interp = np.zeros((n_cores, max_elems), dtype=np.int32)
    for c, t in enumerate(mp.tables):
        for e, ec in enumerate(t.elem_cfgs):
            spc[c, e] = ec.samples_per_clk
            interp[c, e] = ec.interp_ratio
    return spc, interp


def _span_table(mp, cfg, device, fused: bool = False):
    """The span kernels' table of ``mp`` on ``device``
    (:func:`..ops.exec_span.span_table`, cached on the program's
    content)."""
    return span_table(_soa_np(mp), *_element_geometry(mp), cfg, device,
                      fused=fused)


def _program_constants(mp, device):
    """The decoded program as device tensors: the packed ``[C, N, F]``
    instruction table, per-element samples-per-clock and interpolation
    ``[C, E]``, and the sync participants ``[C]``."""
    spc, interp = _element_geometry(mp)
    with host_span('h2d.wait'):
        return (torch.as_tensor(_soa_np(mp), device=device),
                torch.as_tensor(spc, device=device),
                torch.as_tensor(interp, device=device),
                torch.as_tensor(np.asarray(mp.sync_participants),
                                device=device))


def _init_state(batch: int, n_cores: int, cfg: InterpreterConfig,
                init_regs, device) -> dict:
    B, C = batch, n_cores
    M, R, P = cfg.max_meas, cfg.max_resets, cfg.max_pulses

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    if init_regs is None:
        regs = z(B, C, isa.N_REGS)
    else:
        regs = torch.as_tensor(init_regs, dtype=torch.int32, device=device) \
            .expand(B, C, isa.N_REGS).clone()
    st = dict(
        pc=z(B, C), regs=regs,
        time=torch.full((B, C), INIT_TIME, dtype=torch.int32, device=device),
        offset=z(B, C),
        done=torch.zeros((B, C), dtype=torch.bool, device=device),
        err=z(B, C), fault=z(B, C), pp=z(B, C, 5), n_pulses=z(B, C),
        n_resets=z(B, C), rst_time=z(B, C, R), n_meas=z(B, C),
        meas_avail=torch.full((B, C, M), INT32_MAX, dtype=torch.int32,
                              device=device))
    if cfg.fabric == 'lut':
        # the lut fabric's production clock per slot (the trigger time)
        st['meas_time'] = torch.full((B, C, M), INT32_MAX, dtype=torch.int32,
                                     device=device)
    if cfg.record_pulses:
        st['rec'] = z(B, C, len(_REC_FIELDS), P)
    if cfg.trace:
        # the instruction trace: each step's pc, time and qclk origin
        T = cfg.max_steps
        st.update(trace_pc=z(B, C, T), trace_time=z(B, C, T),
                  trace_off=z(B, C, T))
    if cfg.opcode_histogram:
        st['op_hist'] = z(B, C, isa.N_KINDS)
    if cfg.physics:
        if cfg.device not in DEVICE_KINDS:
            raise ValueError(f'unknown device kind {cfg.device!r}; '
                             f'one of {DEVICE_KINDS}')
        # measurement records for the epoch resolver (sim/physics.py)
        # plus the device co-state
        st.update(meas_state=z(B, C, M), meas_amp=z(B, C, M),
                  meas_phase=z(B, C, M), meas_freq=z(B, C, M),
                  meas_env=z(B, C, M), meas_gtime=z(B, C, M),
                  phys_wait=torch.zeros((B, C), dtype=torch.bool,
                                        device=device),
                  **_device_state(cfg, B, C, M, device))
    return st


def _device_state(cfg: InterpreterConfig, B: int, C: int, M: int,
                  device) -> dict:
    """The device co-state per device kind (:mod:`.device`): the parity
    quarter-turn counter; the Bloch vector ``[B, C, 3]``; or one
    ``[B, 2^C]`` complex64 state vector per shot with the ``leaked``
    flags.  Bloch and statevec also carry the lane's last evolution time
    ``phys_t`` and the pre-projection P(1) per slot ``meas_p1``."""
    if cfg.device == 'parity':
        return {'qturns': torch.zeros((B, C), dtype=torch.int32,
                                      device=device)}
    cont = {'phys_t': torch.full((B, C), INIT_TIME, dtype=torch.int32,
                                 device=device),
            'meas_p1': torch.zeros((B, C, M), dtype=torch.float32,
                                   device=device)}
    if cfg.device == 'bloch':
        return {'bloch': torch.zeros((B, C, 3), dtype=torch.float32,
                                     device=device), **cont}
    if C > STATEVEC_MAX_CORES:
        raise ValueError(
            f"device='statevec' holds a [shots, 2^n_cores] state vector; "
            f"n_cores={C} exceeds the cap of {STATEVEC_MAX_CORES}")
    return {'psi': torch.zeros((B, 1 << C), dtype=torch.complex64,
                               device=device),
            'leaked': torch.zeros((B, C), dtype=torch.bool, device=device),
            **cont}


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the JAX int32 ops
    wrap; computing in int64 and wrapping keeps that exact)."""
    return (((x + 2**31) & 0xffffffff) - 2**31).to(torch.int32)


def _alu_vec(op, in0, in1):
    """8-op ALU on int32 lanes (reference: hdl/alu.v:20-51).  ``le`` is
    strict signed less-than (the RTL's ``sub[31] ^ sub_oflow``); ``ge``
    is its complement."""
    a, b = in0.long(), in1.long()
    return _select(
        [op == 0, op == 1, op == 2, op == 3, op == 4, op == 5, op == 6],
        [in0, _wrap32(a + b), _wrap32(a - b), (in0 == in1).to(torch.int32),
         (in0 < in1).to(torch.int32), (in0 >= in1).to(torch.int32), in1],
        torch.zeros_like(in0))


def _bit(cond, value: int):
    """``value`` where ``cond`` holds, else 0, as int32."""
    return cond.to(torch.int32) * value


def _select(conds, vals, default):
    """``jnp.select``: the value of the first true condition."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _take(arr, idx):
    """``arr[..., idx]`` per lane: ``[..., n]`` by ``[...]`` -> ``[...]``."""
    return arr.gather(-1, idx.long().unsqueeze(-1)).squeeze(-1)


def _slot_mask(idx, n: int):
    """``[...] -> [..., n]`` bool mask of slot ``idx``."""
    return idx.unsqueeze(-1) == torch.arange(n, dtype=idx.dtype,
                                             device=idx.device)


def _device_1q_pulse(st: dict, cfg: InterpreterConfig, dm, fire, elem, pp,
                     trig, slot, is_meas):
    """The per-core device co-state at a pulse trigger, shared by every
    engine (the JAX ``_device_1q_pulse``).  Returns ``(updates,
    state_bit)``: the device keys to write and the state bit each
    (shot, core) lane samples.

    ``'parity'``: each drive pulse adds ``round(amp / x90)`` quarter
    turns; the state bit is the half-turn parity.  ``'bloch'``: at a
    drive or readout pulse the lane first evolves freely over the gap
    since its previous one (detuning precession about z, T2 on x and y,
    T1 toward |0>); a drive pulse then rotates by ``theta = (pi/2) *
    amp / x90`` about the equatorial axis of its phase word (Rodrigues)
    and contracts by the depolarizing rate; a readout samples the
    evolved state against the slot's pre-drawn uniform
    (``dm['meas_u']``), collapses to the outcome pole and records P(1)
    in ``meas_p1``.  ``slot``: each lane's measurement slot (its count,
    clamped to the last slot); ``is_meas``: the lanes firing a
    readout."""
    if cfg.device == 'parity':
        qturns = st['qturns']
        if cfg.x90_amp > 0:
            x90 = cfg.x90_amp
            dq = torch.div(2 * pp[..., 3] + x90, 2 * x90,
                           rounding_mode='floor')
            qturns = qturns + torch.where(fire & (elem == cfg.drive_elem),
                                          dq, 0)
        return {'qturns': qturns}, (qturns >> 1) & 1
    if dm is None:
        raise ValueError(
            "device='bloch' needs device-model parameter arrays; "
            "run it via sim.physics.run_physics_batch (the "
            "injected-bits simulate/simulate_batch path has no "
            "device co-state to evolve)")
    f32 = torch.float32
    r = st['bloch']
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    is_drive = fire & (elem == cfg.drive_elem)
    touch = is_drive | is_meas
    dt = (trig - st['phys_t']).to(f32)
    alpha = (2 * np.pi) * dm['det'][None, :] * dt
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    e2 = torch.exp(-dt * dm['inv_t2'][None, :])
    e1 = torch.exp(-dt * dm['inv_t1'][None, :])
    xf = e2 * (x * ca - y * sa)
    yf = e2 * (x * sa + y * ca)
    zf = 1.0 + (z - 1.0) * e1
    phi = (2 * np.pi / (1 << PHASE_BITS)) * pp[..., 1].to(f32)
    theta = ((np.pi / 2) / cfg.x90_amp if cfg.x90_amp > 0 else 0.0) \
        * pp[..., 3].to(f32)
    nx, ny = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    ndot = nx * xf + ny * yf
    k1 = 1.0 - cth
    keep = dm['keep']
    rx = keep * (xf * cth + ny * zf * sth + nx * ndot * k1)
    ry = keep * (yf * cth - nx * zf * sth + ny * ndot * k1)
    rz = keep * (zf * cth + (nx * yf - ny * xf) * sth)
    p1 = ((1.0 - zf) * 0.5).clamp(0.0, 1.0)
    state_bit = (_take(dm['meas_u'], slot) < p1).to(torch.int32) \
        * is_meas.to(torch.int32)
    zc = 1.0 - 2.0 * state_bit.to(f32)
    x1 = torch.where(is_meas, 0.0, torch.where(is_drive, rx, x))
    y1 = torch.where(is_meas, 0.0, torch.where(is_drive, ry, y))
    z1 = torch.where(is_meas, zc, torch.where(is_drive, rz, z))
    mwr = _slot_mask(slot, cfg.max_meas) & is_meas[..., None]
    return dict(
        bloch=torch.stack([x1, y1, z1], dim=-1),
        phys_t=torch.where(touch, trig, st['phys_t']),
        meas_p1=torch.where(mwr, p1[..., None], st['meas_p1']),
    ), state_bit


# ---- statevec device helpers ---------------------------------------------
# Basis convention: core c is bit (C-1-c) of the state index, so
# ``psi.reshape(B, 2, 2, ...)`` puts core 0 on the first qubit axis.

_PAULI_1 = np.stack([
    np.eye(2), [[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]],
]).astype(np.complex64)                                 # I, X, Y, Z
_PAULI_2 = np.stack([np.kron(_PAULI_1[a], _PAULI_1[b])
                     for a in range(4) for b in range(4)])  # [16, 4, 4]


@functools.lru_cache(maxsize=None)
def _sv_zsign_np(C: int) -> np.ndarray:
    """``[C, 2^C]`` float32: Z eigenvalue (+1/-1) of core c in basis d."""
    d = np.arange(1 << C)
    return np.stack([1.0 - 2.0 * ((d >> (C - 1 - c)) & 1)
                     for c in range(C)]).astype(np.float32)


def _sv_apply_1q(psi, U, c: int, C: int):
    """Apply per-shot 2x2 ``U [B, 2, 2]`` to qubit ``c`` of ``psi
    [B, 2^C]``."""
    B = psi.shape[0]
    pn = psi.reshape((B,) + (2,) * C).movedim(1 + c, 1)
    sh = pn.shape
    pn = torch.einsum('bxu,bud->bxd', U, pn.reshape(B, 2, -1))
    return pn.reshape(sh).movedim(1, 1 + c).reshape(B, -1)


def _sv_apply_pair(psi, U4, cc: int, tt: int, C: int):
    """Apply per-shot 4x4 ``U4 [B, 4, 4]`` to qubits ``(cc, tt)`` (index
    within the 4-block is ``bit_cc * 2 + bit_tt``)."""
    B = psi.shape[0]
    pn = psi.reshape((B,) + (2,) * C).movedim((1 + cc, 1 + tt), (1, 2))
    sh = pn.shape
    pn = torch.einsum('bxu,bud->bxd', U4, pn.reshape(B, 4, -1))
    return pn.reshape(sh).movedim((1, 2), (1 + cc, 1 + tt)).reshape(B, -1)


def _sv_rot_1q(theta, phi):
    """``exp(-i theta/2 (cos phi X + sin phi Y))`` as ``[B, 2, 2]``
    complex64."""
    ch, sh = torch.cos(0.5 * theta), torch.sin(0.5 * theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    d = torch.complex(ch, torch.zeros_like(ch))
    o01 = torch.complex(-sh * sp, -sh * cp)       # -i e^{-i phi} sin
    o10 = torch.complex(sh * sp, -sh * cp)        # -i e^{+i phi} sin
    return torch.stack([torch.stack([d, o01], -1),
                        torch.stack([o10, d], -1)], -2)


def _sv_rot_zx(theta, phi):
    """``exp(-i theta/2 Z (x) (cos phi X + sin phi Y))`` as ``[B, 4, 4]``:
    block-diagonal (control-conditioned +/- rotation of the target)."""
    up, dn = _sv_rot_1q(theta, phi), _sv_rot_1q(-theta, phi)
    z = torch.zeros_like(up)
    return torch.cat([torch.cat([up, z], -1), torch.cat([z, dn], -1)], -2)


def _traj_uniforms(seed: int, step: int, shape: tuple, device):
    """The statevec trajectory's uniforms of one instruction step,
    ``shape`` float32 in [0, 1): a generator stream keyed by the run's
    trajectory seed and the step index, so draws are deterministic per
    (shot, core, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + int(step)) % (2**63 - 1))
    return torch.rand(shape, generator=gen, device=device)


def _statevec_traj_u(dm, step_i: int, B: int, C: int, device):
    """The statevec block's trajectory uniforms of one instruction step,
    drawn once for whichever path runs the block (the eager
    :func:`_statevec_pulse` or the kernel of
    :func:`..ops.statevec.statevec_pulse`): ``[B, C, n]`` float32 of
    :func:`_traj_uniforms`, per (shot, core) the T1 jump, the dephasing
    flip, the 1q Pauli's occurrence and pick, the 2q Pauli's occurrence
    and pick, then one for leakage and one for seepage where those are
    on; None where no stochastic channel is on."""
    if dm is None:
        raise ValueError(
            "device='statevec' needs device-model parameters; "
            "run it via sim.physics.run_physics_batch")
    (_cps, _det, has_decay, has_dp1, has_dp2, has_leak, _leak_bit,
     _leak1, _leak2, has_seep, _leak_iq) = dm['static']
    if not (has_decay or has_dp1 or has_dp2 or has_leak):
        return None
    return _traj_uniforms(
        dm['traj_seed'], step_i,
        (B, C, 6 + (1 if has_leak else 0) + (1 if has_seep else 0)), device)


def _norm2(psi):
    return psi.real ** 2 + psi.imag ** 2


def _sv_leak_jump(psi, leaked, c: int, p_eff, u, bit1):
    """The leakage channel of core ``c`` as a trajectory (the CPTP
    unraveling of ``sqrt(p)|2><1|``): with probability ``p_eff * P(|1>)``
    the state projects onto the core's |1> component and the core is
    marked leaked; otherwise the no-jump back-action damps the |1>
    amplitude by ``sqrt(1 - p_eff)`` and renormalizes."""
    p1c = (bit1[c][None] * _norm2(psi)).sum(-1)
    occ = u < p_eff * p1c
    proj = psi * (bit1[c][None, :]
                  / torch.sqrt(p1c.clamp(min=1e-12))[:, None])
    damp = 1.0 - (1.0 - torch.sqrt(1.0 - p_eff))[:, None] * bit1[c][None, :]
    nrm = torch.sqrt((1.0 - p_eff * p1c).clamp(min=1e-12))
    psi = torch.where(occ[:, None], proj, psi * (damp / nrm[:, None]))
    col = torch.arange(leaked.shape[1], device=leaked.device) == c
    return psi, leaked | (occ[:, None] & col[None, :])


def _statevec_cofire(couplings, cp_masks, leaked, has_leak, fire, trig,
                     is_1q, is_meas, pp):
    """``ERR_COFIRE_ORDER`` on a coupling's control core where an
    equal-trigger cross-core pulse does not commute with it (the stage
    order 1q -> couplings -> measurements would be a simulator-chosen
    ordering): a zx target leg against a different-axis 1q drive or a
    measurement of the target, a zz target leg against any 1q drive of
    the target, and overlapping couplings whose legs clash.  Under the
    event gate, cross-core pulses of one step have equal triggers."""
    B, C = fire.shape
    eff = []
    for mk, (c1, _fi, t1, _kd) in zip(cp_masks, couplings):
        if has_leak:
            mk = mk & ~leaked[:, c1] & ~leaked[:, t1]
        eff.append(mk)
    cols = [torch.zeros((B,), dtype=torch.bool, device=fire.device)] * C
    # equatorial axes agree mod pi <=> phase words agree mod a half turn
    half = 1 << (PHASE_BITS - 1)
    pw = pp[..., 1]
    ax_ne = lambda a, b: ((pw[:, a] - pw[:, b]) % half) != 0
    for i, (mi, (c1, _f1, t1, k1)) in enumerate(zip(eff, couplings)):
        tcc = trig[:, c1]
        same = lambda c: fire[:, c] & (trig[:, c] == tcc)
        bad = same(t1) & is_1q[:, t1]
        if k1 == 'zx':
            bad = bad & ax_ne(c1, t1)
            bad = bad | (same(t1) & is_meas[:, t1])
        for jj in range(i + 1, len(couplings)):
            mj, (c2, _f2, t2, k2) = eff[jj], couplings[jj]
            if k1 == 'zz' and k2 == 'zz':
                continue          # both diagonal: commute
            if k1 == 'zx' and k2 == 'zx':
                hard = (t1 == c2) or (t2 == c1)      # X vs Z
                soft = t1 == t2                      # X vs X
            elif k1 == 'zx':
                hard, soft = t1 in (c2, t2), False
            else:
                hard, soft = t2 in (c1, t1), False
            if hard:
                bad = bad | (mj & same(c2))
            elif soft:
                bad = bad | (mj & same(c2) & ax_ne(c1, c2))
        cols[c1] = cols[c1] | (mi & bad)
    return _bit(torch.stack(cols, dim=-1), ERR_COFIRE_ORDER)


def _statevec_pulse(st: dict, cfg: InterpreterConfig, dm, traj_u,
                    fire, elem, pp, trig, slot, is_meas):
    """The statevec device at one instruction step (the JAX ``_step``
    statevec block): one ``[B, 2^C]`` trajectory per shot.  In order:
    (1) detuning precession over each touched core's gap, (2) T1 and
    pure-dephasing quantum jumps, (3) 1q drive rotations with 1q
    depolarization folded in and the 1q leakage channel, (4) coupling
    pulses (ZX cross-resonance or ZZ) with 2q depolarization and
    coupling-induced leakage of the control, (5) joint projective
    measurement, sequentially conditioned across cores, then seepage.
    Stochastic channels read this step's uniforms ``traj_u``
    (:func:`_statevec_traj_u`).  Returns ``(updates, state_bit,
    cofire_err)``; with IQ-level leakage readout a leaked core records
    state 2 for the resolver."""
    if dm is None:
        raise ValueError(
            "device='statevec' needs device-model parameters; "
            "run it via sim.physics.run_physics_batch")
    (couplings, has_det, has_decay, has_dp1, has_dp2, has_leak, leak_bit,
     has_leak1, has_leak2, has_seep, leak_iq) = dm['static']
    f32 = torch.float32
    B, C = fire.shape
    dv = fire.device
    leaked = st['leaked']
    psi = st['psi']
    zsign = torch.as_tensor(_sv_zsign_np(C), device=dv)       # [C, D]
    bit1 = (1.0 - zsign) * 0.5                                # 1 where |1>
    is_drive = fire & (elem == cfg.drive_elem)
    freqw = pp[..., 2]
    # a drive pulse whose frequency word matches a coupling entry is a 2q
    # interaction, not a 1q rotation
    cp_masks = [is_drive[:, cc] & (freqw[:, cc] == fi)
                for (cc, fi, tt, kd) in couplings]
    core = torch.arange(C, device=dv)
    is_cr = torch.zeros((B, C), dtype=torch.bool, device=dv)
    for mk, (cc, fi, tt, kd) in zip(cp_masks, couplings):
        is_cr = is_cr | (mk[:, None] & (core == cc)[None, :])
    is_1q = is_drive & ~is_cr
    touch = is_drive | is_meas
    cofire_err = 0
    if couplings:
        cofire_err = _statevec_cofire(couplings, cp_masks, leaked, has_leak,
                                      fire, trig, is_1q, is_meas, pp)
    dt = torch.where(touch, (trig - st['phys_t']).to(f32), 0.0)
    # (1) free evolution: detuning precession, one diagonal Rz
    if has_det:
        alpha = (2 * np.pi) * dm['det'][None, :] * dt
        arg = torch.einsum('bc,cd->bd', -0.5 * alpha, zsign)
        psi = psi * torch.complex(torch.cos(arg), torch.sin(arg))
    # (2) T1 / pure-dephasing quantum jumps per touched core
    if has_decay:
        inv_t1, inv_t2 = dm['inv_t1'], dm['inv_t2']
        inv_phi = (inv_t2 - 0.5 * inv_t1).clamp(min=0.0)
        for c in range(C):
            p_dec = 1.0 - torch.exp(-dt[:, c] * inv_t1[c])
            if has_leak:
                # a leaked core's psi slot is a frozen |1> bookkeeping
                # state: it neither relaxes nor dephases
                p_dec = torch.where(leaked[:, c], 0.0, p_dec)
            p1c = (bit1[c][None] * _norm2(psi)).sum(-1)
            jump = traj_u[:, c, 0] < p_dec * p1c
            damp = 1.0 - (1.0 - torch.sqrt(1.0 - p_dec))[:, None] \
                * bit1[c][None, :]
            nrm = torch.sqrt((1.0 - p_dec * p1c).clamp(min=1e-12))
            psi_nj = psi * (damp / nrm[:, None])
            pn = psi.reshape((B,) + (2,) * C).movedim(1 + c, 1) \
                .reshape(B, 2, -1)
            pj = torch.stack([pn[:, 1, :], torch.zeros_like(pn[:, 0, :])], 1)
            pj = pj.reshape((B, 2) + (2,) * (C - 1)).movedim(1, 1 + c) \
                .reshape(B, -1)
            pj = pj / torch.sqrt(p1c.clamp(min=1e-12))[:, None]
            psi = torch.where(jump[:, None], pj, psi_nj)
            p_phi = 1.0 - torch.exp(-dt[:, c] * inv_phi[c])
            if has_leak:
                p_phi = torch.where(leaked[:, c], 0.0, p_phi)
            flip = traj_u[:, c, 1] < 0.5 * p_phi
            psi = torch.where(flip[:, None], psi * zsign[c][None, :], psi)
    # (3) 1q drive rotations (the bloch convention), 1q depolarization as
    # a stochastic X/Y/Z after the rotation, then 1q leakage
    theta1 = ((np.pi / 2) / cfg.x90_amp if cfg.x90_amp > 0 else 0.0) \
        * pp[..., 3].to(f32)
    theta1 = torch.where(is_1q, theta1, 0.0)
    if has_leak:
        # drives on a leaked core act on |2>: a no-op in the model
        theta1 = torch.where(leaked, 0.0, theta1)
    phi1 = (2 * np.pi / (1 << PHASE_BITS)) * pp[..., 1].to(f32)
    pauli1 = torch.as_tensor(_PAULI_1, device=dv)
    for c in range(C):
        U = _sv_rot_1q(theta1[:, c], phi1[:, c])
        if has_dp1:
            occ = (traj_u[:, c, 2] < dm['depol']) & is_1q[:, c]
            if has_leak:
                occ = occ & ~leaked[:, c]
            pick = (traj_u[:, c, 3] * 3).to(torch.int32).clamp(max=2) + 1
            sel = torch.where(occ, pick, 0)
            U = torch.einsum('bxy,byu->bxu', pauli1[sel.long()], U)
        psi = _sv_apply_1q(psi, U, c, C)
        if has_leak1:
            exposed = is_1q[:, c] & ~leaked[:, c]
            psi, leaked = _sv_leak_jump(
                psi, leaked, c, torch.where(exposed, dm['leak'], 0.0),
                traj_u[:, c, 6], bit1)
    # (4) coupling pulses: ZX / ZZ interactions, 2q depolarization,
    # coupling-induced leakage of the control
    amp_f = pp[..., 3].to(f32)
    pauli2 = torch.as_tensor(_PAULI_2, device=dv)
    for mk, (cc, fi, tt, kd) in zip(cp_masks, couplings):
        if has_leak:
            # interactions involving a leaked core no-op
            mk = mk & ~leaked[:, cc] & ~leaked[:, tt]
        ref = dm['zz90'] if kd == 'zz' else dm['zx90']
        th = torch.where(mk, (np.pi / 2) * amp_f[:, cc] / ref, 0.0)
        if kd == 'zz':
            zz_row = (zsign[cc] * zsign[tt])[None, :]
            arg = -0.5 * th[:, None] * zz_row
            psi = psi * torch.complex(torch.cos(arg), torch.sin(arg))
        else:
            psi = _sv_apply_pair(psi, _sv_rot_zx(th, phi1[:, cc]), cc, tt, C)
        if has_dp2:
            occ = (traj_u[:, cc, 4] < dm['depol2']) & mk
            pick = (traj_u[:, cc, 5] * 15).to(torch.int32).clamp(max=14)
            sel = torch.where(occ, pick + 1, 0)          # 0 = identity
            psi = _sv_apply_pair(psi, pauli2[sel.long()], cc, tt, C)
        if has_leak2:
            psi, leaked = _sv_leak_jump(
                psi, leaked, cc, torch.where(mk, dm['leak2'], 0.0),
                traj_u[:, cc, 6], bit1)
    # (5) measurement: joint projective collapse, sequentially
    # conditioned across cores
    u_sel = _take(dm['meas_u'], slot)                        # [B, C]
    p1_cols, bit_cols = [], []
    for c in range(C):
        mc = is_meas[:, c]
        p1c = (bit1[c][None] * _norm2(psi)).sum(-1).clamp(0.0, 1.0)
        if has_leak and not leak_iq:
            # a leaked core discriminates as leak_readout_bit: forcing
            # P(1) to 0/1 forces the comparison below
            p1c = torch.where(leaked[:, c], float(leak_bit), p1c)
        bitc = (u_sel[:, c] < p1c).to(torch.int32) * mc.to(torch.int32)
        if has_leak and leak_iq:
            # IQ-level leakage readout: the resolver synthesizes the
            # window with the |2> response
            bitc = torch.where(leaked[:, c] & mc, 2, bitc)
        keep = torch.where(bitc[:, None] == 1, bit1[c][None, :],
                           1.0 - bit1[c][None, :])
        p_sel = torch.where(bitc == 1, p1c, 1.0 - p1c)
        proj = psi * (keep / torch.sqrt(p_sel.clamp(min=1e-12))[:, None])
        do_proj = mc if not has_leak else mc & ~leaked[:, c]
        psi = torch.where(do_proj[:, None], proj, psi)
        p1_cols.append(torch.where(mc, p1c, 0.0))
        bit_cols.append(bitc)
    p1 = torch.stack(p1_cols, dim=-1)                          # [B, C]
    state_bit = torch.stack(bit_cols, dim=-1)
    if has_seep:
        # seepage |2> -> |1>: a drive on a core leaked before this step
        # un-leaks it from the next step; the seeping pulse no-ops
        leaked = leaked & ~(is_drive & st['leaked']
                            & (traj_u[..., 7] < dm['seep']))
    mwr = _slot_mask(slot, cfg.max_meas) & is_meas[..., None]
    return dict(
        psi=psi, leaked=leaked,
        phys_t=torch.where(touch, trig, st['phys_t']),
        meas_p1=torch.where(mwr, p1[..., None], st['meas_p1']),
    ), state_bit, cofire_err


def _lut_select(pv: dict, meas_bits, meas_valid, req,
                cfg: InterpreterConfig, core0: int = 0):
    """The ``'lut'`` fabric's time-indexed read (reference:
    hdl/fproc_lut.sv + meas_lut.sv) for every (shot, reader core) lane at
    its request time ``req [B, C]``, from the producers' words ``pv``
    (``n_meas``, ``meas_time``, ``meas_avail`` over every core of the
    program, ``[B, Cp, ...]``, with ``meas_bits`` and ``meas_valid``;
    the readers are cores ``core0 .. core0 + C - 1`` of them): per
    masked producer the newest bit
    PRODUCED strictly before the request, slot ``max(#{m < n_meas :
    meas_time[m] < req}, 1) - 1`` (:meth:`..ops.fabric.MeasLUT.
    timed_call`); the masked bits form the table address, LSB = the
    lowest masked core, and bit ``c`` of the entry is core ``c``'s data.
    Returns ``(data, valid, t_lut)`` ``[B, C]``: the reader's bit,
    whether every selected masked bit is valid, and the distribution
    time (the latest selected ``meas_avail`` over the mask, unwritten
    read as 0, and 0 from each unmasked core)."""
    B, C = req.shape
    Cp = pv['n_meas'].shape[1]
    dev = req.device
    lmask_np = np.asarray(cfg.lut_mask, dtype=bool)
    shifts = np.zeros(Cp, dtype=np.int64)
    shifts[lmask_np] = np.arange(int(lmask_np.sum()))
    lmask = torch.as_tensor(lmask_np, device=dev)
    M = cfg.max_meas
    rec = torch.arange(M, device=dev)[None, None, :] \
        < pv['n_meas'][:, :, None]                               # [B, Cp, M]
    early = rec[:, None] & (pv['meas_time'][:, None]
                            < req[:, :, None, None])             # [B,C,Cp,M]
    slot = (early.sum(-1, dtype=torch.int32) - 1).clamp(min=0)   # [B, C, Cp]
    pick = lambda plane: plane[:, None].expand(B, C, Cp, M).gather(
        -1, slot.long()[..., None])[..., 0]                      # [B, C, Cp]
    avail = pick(torch.where(pv['meas_avail'] == INT32_MAX, 0,
                             pv['meas_avail']))
    valid = torch.where(lmask, pick(meas_valid), True).all(-1)
    t_lut = torch.where(lmask, avail, 0).amax(-1)
    weight = torch.as_tensor(lmask_np.astype(np.int64) << shifts, device=dev)
    addr = _wrap32((pick(meas_bits).long() * weight).sum(-1))
    table = torch.as_tensor(np.asarray(cfg.lut_table, np.int64)
                            .astype(np.uint32).view(np.int32), device=dev)
    T = table.shape[0]
    entry = torch.where((addr >= 0) & (addr < T),
                        table[addr.clamp(0, T - 1).long()], 0)
    core = (core0 + torch.arange(C, dtype=torch.int32, device=dev)) \
        .clamp(max=31)
    return (entry >> core) & 1, valid, t_lut


def _lut_serve(pv: dict, meas_bits, meas_valid, req,
               cfg: InterpreterConfig, core0: int = 0):
    """The generic engine's LUT read (``func_id >= 1``): the time-indexed
    select of :func:`_lut_select`, served once it is causal — every
    masked producer has recorded a measurement and is done or has
    simulated to the request — and its bits are valid (else, causal but
    invalid, the physics pause).  Returns ``(ready, data, t_ready,
    phys)`` ``[B, C]``; ``pv`` also carries the producers' ``done`` and
    ``time``."""
    data, valid, t_lut = _lut_select(pv, meas_bits, meas_valid, req, cfg,
                                     core0)
    lmask = torch.as_tensor(np.asarray(cfg.lut_mask, dtype=bool),
                            device=req.device)
    ok = (pv['n_meas'] >= 1)[:, None, :] & (
        pv['done'][:, None, :] | (pv['time'][:, None, :] >= req[..., None]))
    causal = torch.where(lmask, ok, True).all(-1)
    return causal & valid, data, torch.maximum(req, t_lut), causal & ~valid


def _producer_planes(bits, valid, n_cores: int):
    """The injected ``bits`` and ``valid`` planes ``[B, CM, M]`` over the
    program's ``n_cores`` producer rows, read as the JAX package's
    one-hot producer select reads them (``sum(plane[:, None] * onehot,
    axis=2)``) when ``meas_bits`` carries another core axis than the
    program: one row broadcasts to every producer; a one-core program
    reads the SUM of every row, which its sticky and fresh reads take as
    valid only where exactly one row is (``== 1``), so with several rows
    every read behind a measurement stalls into ``ERR_FPROC_DEADLOCK``;
    any other pair of axes does not broadcast and raises ``TypeError``,
    as JAX's multiply does.  Returns ``(bits, valid, lut_valid)``, the
    last for the ``'lut'`` read, which tests each row's validity
    before it reduces."""
    CM = bits.shape[1]
    if CM == n_cores:
        return bits, valid, valid
    B, _, M = bits.shape
    if CM == 1:
        bits, valid = bits.expand(B, n_cores, M), valid.expand(B, n_cores, M)
        return bits, valid, valid
    if n_cores != 1:
        raise TypeError(
            f'meas_bits has {CM} cores, which does not broadcast against '
            f'the program\'s {n_cores}')
    return (bits.sum(1, keepdim=True, dtype=torch.int32),
            valid.sum(1, keepdim=True) == 1, valid.all(1, keepdim=True))


def _step(st: dict, soa, spc, interp, sync_part, meas_bits, meas_valid,
          cfg: InterpreterConfig, traits, dm=None, step_i: int = 0,
          prog=None, cores=None) -> dict:
    """One instruction step of every live (shot, core) lane — the JAX
    ``_step``.  ``dm``: the device-model parameters of a bloch or
    statevec physics run (:func:`..sim.physics.run_physics_batch`);
    ``step_i``: the run's step index, which keys the statevec
    trajectory's uniforms.

    ``soa`` is one program ``[C, N, F]`` with ``sync_part [C]``, or an
    ensemble ``[P, C, N, F]`` (:func:`simulate_multi_batch`) with each
    lane's program index ``prog [B]`` and its program's participants
    ``sync_part [B, C]``.

    ``cores``: this rank's shard of a run sharded over a cores mesh
    (:class:`..parallel.sweep.CoresShard`): the lanes are the rank's own
    cores, ``soa``/``spc``/``interp`` their rows, ``sync_part`` and the
    shard's bits and valid flags full-width.  What the fabric and the
    sync barrier read from other cores comes from one all-gather per
    step (the JAX ``_gat`` layer), so every rank sees the full-width
    words a single-device run computes.  Every rank makes the same
    collective calls: what is gathered depends on the program's traits
    and ``cfg`` alone."""
    B, C = st['pc'].shape
    N = soa.shape[-2]
    dev = st['pc'].device
    time, offset, regs = st['time'], st['offset'], st['regs']
    kinds = traits[0]
    any_in0_reg, any_regsel = traits[1], traits[2]
    has = lambda k: k in kinds
    any_fproc = has(isa.K_ALU_FPROC) or has(isa.K_JUMP_FPROC)
    any_in1_reg = has(isa.K_REG_ALU) or has(isa.K_JUMP_COND)
    any_regwrite = has(isa.K_REG_ALU) or has(isa.K_ALU_FPROC)
    has_sync = has(isa.K_SYNC)
    i32 = torch.int32

    # ---- program fetch: one row of the instruction table per lane ----
    core_idx = torch.arange(C, device=dev)[None, :]
    pc_idx = st['pc'].clamp(0, N - 1).long()
    if prog is None:
        fetched = soa[core_idx, pc_idx]                       # [B, C, F]
    else:
        fetched = soa[prog[:, None], core_idx, pc_idx]
    sync_part = sync_part if sync_part.ndim == 2 else sync_part[None, :]
    g = lambda f: fetched[..., _F[f]]
    kind = g('kind')
    live = ~st['done']

    def reg_read(idx):
        return _take(regs, idx)

    # ---- operand fetch ------------------------------------------------
    in0 = torch.where(g('in0_is_reg') == 1, reg_read(g('in0_reg')),
                      g('imm')) if any_in0_reg else g('imm')
    qclk = time - offset
    is_fproc = (kind == isa.K_ALU_FPROC) | (kind == isa.K_JUMP_FPROC)
    at_sync = live & (kind == isa.K_SYNC) if has_sync else None

    # ---- producer views: the words the fabric and the sync barrier read
    # from other cores, full-width over the program's cores (``cores``
    # sharded: gathered from every rank; ``core0`` places this rank's
    # lanes on the full core axis) ---------------------------------------
    pv = dict(time=time, done=st['done'], at_sync=at_sync,
              n_meas=st['n_meas'], meas_avail=st['meas_avail'],
              meas_time=st.get('meas_time'))
    P_bits, P_valid, core0 = meas_bits, meas_valid, 0
    if cores is not None:
        words = []
        if any_fproc or has_sync:
            words += ['time', 'done']
        if has_sync:
            words.append('at_sync')
        if any_fproc:
            words += ['n_meas', 'meas_avail']
            if cfg.fabric == 'lut':
                words.append('meas_time')
        pv = cores.gather_words({k: pv[k] for k in words})
        P_bits, P_valid, core0 = cores.bits, cores.valid, cores.core0

    # ---- discrete-event gate, stage A (statevec + couplings only) ------
    # Each core's frontier lower-bounds the trigger time of anything it
    # can still emit: its pending trigger if it sits at one, else its
    # clock; a sync-stalled core is raised to the release lower bound.
    pt_gate = cfg.physics and cfg.device == 'statevec' \
        and dm is not None and len(dm['static'][0]) > 0
    if pt_gate:
        is_ptk = kind == isa.K_PULSE_TRIG
        trig_e = torch.maximum(
            _wrap32(offset.long() + g('cmd_time').long()), time)
        fr_gate = torch.where(live & is_ptk, trig_e,
                              torch.where(live, time, INT32_MAX))
        at_sync_g = live & (kind == isa.K_SYNC)
        if has_sync:
            f_part = torch.where(sync_part, fr_gate, -INT32_MAX) \
                .amax(-1, keepdim=True)
            fr_gate = torch.where(at_sync_g, torch.maximum(fr_gate, f_part),
                                  fr_gate)

    # ---- fproc fabric (reference: hdl/fproc_meas.sv /
    # core_state_mgr.sv, selected statically by cfg.fabric) -------------
    fid = g('func_id')
    req = time
    zeros_b = torch.zeros((B, C), dtype=torch.bool, device=dev)
    fid_bad = f_race = f_deadlock = f_phys = zeros_b
    f_ready = torch.ones((B, C), dtype=torch.bool, device=dev)
    f_data = torch.zeros((B, C), dtype=i32, device=dev)
    f_tready = req
    if any_fproc:
        M = cfg.max_meas
        CF = pv['done'].shape[1]                      # the program's cores
        fid_bad = fid >= CF
        # func_id 0 reads the core's own channel under the 'lut' fabric
        prod = fid.clamp(0, CF - 1).long() if cfg.fabric != 'lut' \
            else (core0 + torch.arange(C, device=dev)).expand(B, C)
        sel = lambda arr: arr.gather(1, prod)               # [B,CF]->[B,C]
        prod_m = prod.unsqueeze(-1).expand(B, C, M)
        sel_m = lambda arr: arr.gather(1, prod_m)           # [B,C,M]
        mavail_p = sel_m(pv['meas_avail'])
        P_bits, P_valid, L_valid = _producer_planes(P_bits, P_valid, CF)
        bits_p = sel_m(P_bits)
        valid_p = sel_m(P_valid)
        if cfg.fabric == 'sticky':
            # bit latched at read time; the producer must have simulated
            # past `req`
            f_time_ok = sel(pv['done']) | (sel(pv['time']) >= req)
            if pt_gate:
                # under the event gate the latched snapshot is final once
                # the producer's frontier passes the request: anything it
                # can still measure lands past the race margin
                f_time_ok = f_time_ok | (sel(fr_gate) >= req)
            m_cnt = (mavail_p <= req[..., None]).sum(-1, dtype=i32)
            latest = (m_cnt - 1).clamp(min=0)
            latest_valid = (m_cnt == 0) | _take(valid_p, latest)
            f_ready = f_time_ok & latest_valid
            f_phys = f_time_ok & ~latest_valid
            f_data = torch.where(m_cnt > 0, _take(bits_p, latest), 0)
            # a measurement landing within the handshake window of the
            # read makes the hardware-latched value timing-dependent
            f_race = ((mavail_p > (req - STICKY_RACE_MARGIN)[..., None])
                      & (mavail_p <= (req + STICKY_RACE_MARGIN)[..., None])
                      ).any(-1)
        else:
            # 'fresh' (and the 'lut' fabric's own read, func_id 0): the
            # first measurement completing after the request
            fresh = (mavail_p > req[..., None]) & (
                torch.arange(M, device=dev)[None, None, :]
                < sel(pv['n_meas'])[..., None])
            exists = fresh.any(-1)
            j = fresh.to(i32).argmax(-1)
            sel_valid = _take(valid_p, j)
            ready = exists & sel_valid
            f_phys = exists & ~sel_valid
            f_data = torch.where(ready, _take(bits_p, j), 0)
            f_tready = torch.where(
                ready, torch.maximum(req, _take(mavail_p, j)), req)
            f_deadlock = ~exists & sel(pv['done'])
            f_ready = ready | f_deadlock
        if cfg.fabric == 'lut':
            fid_bad = zeros_b
            l_ready, l_data, l_tready, l_phys = _lut_serve(
                pv, P_bits, L_valid, req, cfg, core0)
            is_own = fid == 0
            f_ready = torch.where(is_own, f_ready, l_ready)
            f_data = torch.where(is_own, f_data, l_data)
            f_tready = torch.where(is_own, f_tready, l_tready)
            f_deadlock = is_own & f_deadlock
            f_phys = torch.where(is_own, f_phys, l_phys)
        f_ready = f_ready | fid_bad
        f_data = torch.where(fid_bad, 0, f_data)
        f_phys = f_phys & ~fid_bad

    # ---- ALU (in1 mux per reference: hdl/proc.sv:111) ------------------
    in1 = reg_read(g('in1_reg')) if any_in1_reg \
        else torch.zeros((B, C), dtype=i32, device=dev)
    if has(isa.K_INC_QCLK):
        in1 = torch.where(kind == isa.K_INC_QCLK, qclk, in1)
    if any_fproc:
        in1 = torch.where(is_fproc, f_data, in1)
    alu_res = _alu_vec(g('alu_op'), in0, in1)

    # ---- sync barrier (reference: ctrl.v:510-552 + qclk reset), over
    # the program's full core axis -----------------------------------------
    if has_sync:
        P_at, P_done = pv['at_sync'], pv['done']
        live_part = sync_part & ~P_done
        sync_ready = P_at.any(-1) & (~live_part | P_at).all(-1)
        release = torch.where(P_at, pv['time'], -INT32_MAX).amax(
            -1, keepdim=True) + QCLK_RST_DELAY                     # [B, 1]
        sync_adv = at_sync & sync_ready[:, None]
        sync_err = sync_ready & (sync_part & P_done).any(-1)

    # ---- stall mask ----------------------------------------------------
    stalled = is_fproc & ~f_ready
    if has_sync:
        stalled = stalled | (at_sync & ~sync_ready[:, None])
    if pt_gate:
        # the conservative discrete-event gate: a pulse trigger fires only
        # when no other live core could still produce an earlier-time op.
        # The frontiers are raised by a monotone fixpoint over stall
        # chains (a sync-stalled core's ops land at the release; a fresh
        # or LUT reader inherits its producers' frontier), C rounds
        # covering chains of any length.  The least pending trigger always
        # fires, so the gate cannot deadlock; equal triggers co-fire.
        fr = fr_gate
        inherit = any_fproc and cfg.fabric in ('fresh', 'lut')
        if inherit:
            fstall = is_fproc & live & ~f_ready & ~f_phys
            if cfg.fabric == 'lut':
                lmask_g = torch.as_tensor(
                    np.asarray(cfg.lut_mask, dtype=bool), device=dev)
        for _ in range(C if (has_sync or inherit) else 0):
            if has_sync:
                f_part = torch.where(sync_part, fr, -INT32_MAX) \
                    .amax(-1, keepdim=True)
                fr = torch.where(at_sync_g, torch.maximum(fr, f_part), fr)
            if inherit:
                if cfg.fabric == 'fresh':
                    prod_f = fr.gather(1, prod)
                else:
                    lut_f = torch.where(lmask_g[None, :], fr, -INT32_MAX) \
                        .amax(-1, keepdim=True)
                    prod_f = torch.where(fid == 0, fr, lut_f.expand_as(fr))
                fr = torch.where(fstall, torch.maximum(fr, prod_f), fr)
        eye = torch.eye(C, dtype=torch.bool, device=dev)
        pt_ok = ((trig_e[:, :, None] <= fr[:, None, :])
                 | ~live[:, None, :] | eye[None]).all(-1)
        held = is_ptk & live & ~pt_ok
        stalled = stalled | held
        # the gate's device counters, per (shot, core) and reduced once a
        # batch by sim.physics.run_physics_batch: core-steps it held, over
        # live core-steps
        dm['gate_stall'] += held
        dm['core_steps'] += live
    adv = live & ~stalled                     # cores executing this step

    # ---- pulse-register latch + trigger --------------------------------
    is_pw = kind == isa.K_PULSE_WRITE
    is_pt = kind == isa.K_PULSE_TRIG
    is_pulse = (is_pw | is_pt) & adv
    imm_vals = torch.stack([g('p_env'), g('p_phase'), g('p_freq'),
                            g('p_amp'), g('p_cfg')], dim=-1)     # [B, C, 5]
    five = torch.arange(5, dtype=i32, device=dev)
    with host_span('h2d.wait'):
        pmasks = torch.tensor(_PMASKS, dtype=i32, device=dev)
    wen = (g('p_wen')[..., None] >> five) & 1
    if any_regsel:
        rsel = (g('p_regsel')[..., None] >> five) & 1
        regval = reg_read(g('p_reg'))
        cand = torch.where(rsel == 1, regval[..., None], imm_vals) & pmasks
    else:
        cand = imm_vals & pmasks
    pp = torch.where(is_pulse[..., None] & (wen == 1), cand, st['pp'])

    cmd_time = g('cmd_time')                  # uint32 bit pattern
    trig = _wrap32(offset.long() + cmd_time.long())
    missed_trig = is_pt & adv & (trig < time)
    trig = torch.maximum(trig, time)
    elem = pp[..., 4] & 0b11
    elem_idx = elem.clamp(max=spc.shape[1] - 1).long()
    spc_e = spc.expand(B, C, -1).gather(-1, elem_idx[..., None])[..., 0]
    interp_e = interp.expand(B, C, -1).gather(-1, elem_idx[..., None])[..., 0]
    envw = pp[..., 0]
    env_len = (envw >> 12) & 0xfff
    nsamp = env_len * 4 * interp_e
    dur = torch.where(env_len == 0xfff, 0,
                      torch.div(nsamp + spc_e - 1, spc_e,
                                rounding_mode='floor'))

    # ---- pulse record: slot-indexed write -----------------------------
    fire = is_pt & adv
    rec_of = _bit(fire & (st['n_pulses'] >= cfg.max_pulses),
                  ERR_PULSE_OVERFLOW)
    upd = {}
    if cfg.record_pulses:
        rec_vals = torch.stack(
            [cmd_time, trig, pp[..., 0], pp[..., 1], pp[..., 2], pp[..., 3],
             pp[..., 4], elem, dur], dim=-1)                     # [B, C, 9]
        pwrite = _slot_mask(st['n_pulses'].clamp(max=cfg.max_pulses - 1),
                            cfg.max_pulses) \
            & (fire & (st['n_pulses'] < cfg.max_pulses))[..., None]
        upd['rec'] = torch.where(pwrite[:, :, None, :],
                                 rec_vals[..., None], st['rec'])
    n_pulses = st['n_pulses'] + fire.to(i32)

    is_meas_pulse = fire & (elem == cfg.meas_elem)
    meas_of = _bit(is_meas_pulse & (st['n_meas'] >= cfg.max_meas),
                   ERR_MEAS_OVERFLOW)
    mwr = _slot_mask(st['n_meas'].clamp(max=cfg.max_meas - 1),
                     cfg.max_meas) & is_meas_pulse[..., None]
    meas_avail = torch.where(mwr, (trig + dur + cfg.meas_latency)[..., None],
                             st['meas_avail'])
    if 'meas_time' in st:
        # production clock = the trigger time, written once per slot (the
        # CW rewrite below moves only meas_avail)
        upd['meas_time'] = torch.where(mwr, trig[..., None], st['meas_time'])
    n_meas = st['n_meas'] + is_meas_pulse.to(i32)

    # ---- physics co-state: the device model + measurement records -----
    cw_meas_err = cofire_err = 0
    if cfg.physics:
        if cfg.cw_horizon > 0:
            cw_clks = torch.div(cfg.cw_horizon + spc_e - 1, spc_e,
                                rounding_mode='floor')
            meas_avail = torch.where(
                mwr & (env_len == 0xfff)[..., None],
                (trig + cw_clks + cfg.meas_latency)[..., None], meas_avail)
        else:
            # a CW readout window has no length to demodulate
            cw_meas_err = _bit(is_meas_pulse & (env_len == 0xfff), ERR_CW_MEAS)
        slot = st['n_meas'].clamp(max=cfg.max_meas - 1)
        if cfg.device == 'statevec':
            # one kernel launch on a CUDA state, the eager block on any
            # other; both read the same uniforms
            with host_span('statevec.apply'):
                counter_inc('statevec.steps')
                pulse = statevec_pulse if takes_kernel(st['psi'].device) \
                    else _statevec_pulse
                dev_upd, state_bit, cofire_err = pulse(
                    st, cfg, dm, _statevec_traj_u(dm, step_i, *fire.shape,
                                                  fire.device),
                    fire, elem, pp, trig, slot, is_meas_pulse)
        else:
            dev_upd, state_bit = _device_1q_pulse(
                st, cfg, dm, fire, elem, pp, trig, slot, is_meas_pulse)
        upd.update(
            **dev_upd,
            meas_state=torch.where(mwr, state_bit[..., None],
                                   st['meas_state']),
            meas_amp=torch.where(mwr, pp[..., 3:4], st['meas_amp']),
            meas_phase=torch.where(mwr, pp[..., 1:2], st['meas_phase']),
            meas_freq=torch.where(mwr, pp[..., 2:3], st['meas_freq']),
            meas_env=torch.where(mwr, pp[..., 0:1], st['meas_env']),
            meas_gtime=torch.where(mwr, trig[..., None], st['meas_gtime']),
            phys_wait=is_fproc & live & f_phys & ~f_ready)

    # ---- phase reset record --------------------------------------------
    is_rst = (kind == isa.K_PULSE_RESET) & adv
    rmask = _slot_mask(st['n_resets'].clamp(max=cfg.max_resets - 1),
                       cfg.max_resets) & is_rst[..., None]
    rst_time = torch.where(rmask, time[..., None], st['rst_time'])
    n_resets = st['n_resets'] + is_rst.to(i32)

    # ---- idle ----------------------------------------------------------
    is_idle = (kind == isa.K_IDLE) & adv
    idle_end = _wrap32(offset.long() + cmd_time.long())
    missed_idle = is_idle & (time > idle_end)
    idle_end = torch.maximum(idle_end, time)

    # ---- register writeback --------------------------------------------
    if any_regwrite:
        wr_reg = ((kind == isa.K_REG_ALU) | (kind == isa.K_ALU_FPROC)) & adv
        wr_mask = _slot_mask(g('out_reg'), isa.N_REGS) & wr_reg[..., None]
        regs = torch.where(wr_mask, alu_res[..., None], regs)

    # ---- next pc -------------------------------------------------------
    pc = st['pc']
    branch_taken = (alu_res & 1) == 1
    pc_next = _select(
        [kind == isa.K_JUMP_I,
         (kind == isa.K_JUMP_COND) | (kind == isa.K_JUMP_FPROC)],
        [g('jump_addr'), torch.where(branch_taken, g('jump_addr'), pc + 1)],
        pc + 1)
    if has_sync:
        pc_next = torch.where(sync_adv, pc + 1, pc_next)
    is_done = (kind == isa.K_DONE) & adv
    pc_next = torch.where(adv & ~is_done, pc_next, pc)

    # ---- next time / qclk offset ---------------------------------------
    time_next = _select(
        [is_pt, is_pw | is_rst, is_idle,
         (kind == isa.K_REG_ALU) | (kind == isa.K_INC_QCLK),
         (kind == isa.K_JUMP_I) | (kind == isa.K_JUMP_COND),
         is_fproc],
        [trig + cfg.pulse_load_clks,
         time + cfg.pulse_regwrite_clks,
         idle_end + cfg.pulse_load_clks,
         time + cfg.alu_instr_clks,
         time + cfg.jump_cond_clks,
         f_tready + cfg.jump_fproc_clks],
        time)
    if has_sync:
        time_next = torch.where(sync_adv, release, time_next)
    time_next = torch.where(adv, time_next, time)

    # inc_qclk loads qclk = alu_res (reference: hdl/qclk.v:17); sync
    # resets qclk to 0 at release
    offset_next = offset
    if has(isa.K_INC_QCLK):
        offset_next = torch.where((kind == isa.K_INC_QCLK) & adv,
                                  _wrap32(time.long() - alu_res.long()),
                                  offset_next)
    if has_sync:
        offset_next = torch.where(sync_adv, release, offset_next)

    err = st['err'] | rec_of | meas_of | cw_meas_err | cofire_err \
        | _bit(missed_trig | missed_idle, ERR_MISSED_TRIG)
    if any_fproc:
        err = err \
            | _bit(is_fproc & adv & fid_bad, ERR_FPROC_ID) \
            | _bit(is_fproc & adv & f_deadlock, ERR_FPROC_DEADLOCK) \
            | _bit(is_fproc & adv & f_race, ERR_STICKY_RACE)
    if has_sync:
        err = err | _bit(sync_adv & sync_err[:, None], ERR_SYNC_DONE)

    # ---- fault word ----------------------------------------------------
    fault = st['fault'] \
        | _bit(rec_of != 0, FAULT_PULSE_OVERFLOW) \
        | _bit(meas_of != 0, FAULT_MEAS_OVERFLOW) \
        | _bit(is_rst & (st['n_resets'] >= cfg.max_resets),
               FAULT_RESET_OVERFLOW) \
        | _bit(adv & ((kind < 0) | (kind >= isa.N_KINDS)), FAULT_ILLEGAL_OP) \
        | _bit(adv & ~is_done & ((pc_next < 0) | (pc_next >= N)),
               FAULT_JUMP_OOB)
    if any_fproc:
        fault = fault \
            | _bit(is_fproc & adv & fid_bad, FAULT_ILLEGAL_OP) \
            | _bit(is_fproc & adv & f_deadlock, FAULT_FPROC_STARVED)
    if has_sync:
        fault = fault | _bit(sync_adv & sync_err[:, None], FAULT_SYNC_DEADLOCK)
    # lanes stalled AT a sync barrier this step: classifies a later hard
    # quiescence as SYNC_DEADLOCK vs FPROC_STARVED
    stall_sync = (at_sync & ~sync_ready[:, None] & live) if has_sync \
        else zeros_b

    if 'op_hist' in st:
        upd['op_hist'] = st['op_hist'] \
            + _slot_mask(kind, isa.N_KINDS).to(i32) * adv[..., None]
    if cfg.trace:
        # instruction-trace export, the simulator's VCD analog (the
        # reference traces RTL waveforms via Verilator --trace): every
        # lane's pc, time and qclk origin at the start of the step,
        # written in place at column step_i (< max_steps, the planes'
        # length)
        for name, val in (('trace_pc', st['pc']), ('trace_time', time),
                          ('trace_off', offset)):
            st[name][:, :, step_i] = val

    return dict(st, pc=pc_next, regs=regs, time=time_next,
                offset=offset_next, done=st['done'] | is_done, err=err,
                fault=fault, pp=pp, n_pulses=n_pulses, n_resets=n_resets,
                rst_time=rst_time, n_meas=n_meas, meas_avail=meas_avail,
                **upd), stall_sync


def _exec_loop(st: dict, steps: int, paused, soa, spc, interp, sync_part,
               meas_bits, meas_valid, cfg: InterpreterConfig, traits,
               dm=None, prog=None, group_steps=None, cores=None):
    """Step until every shot is done or, in physics mode, paused waiting
    for a measurement bit the epoch resolver has not produced yet.
    ``steps`` is the step count so far (the budget is shared across
    physics epochs; it is also each step's index); ``dm``: the device
    parameters of a bloch or statevec run; ``prog``: each lane's program
    in an ensemble (:func:`_step`).  Returns ``(st, steps, paused)``.

    ``group_steps``: a ``[G]`` int32 tensor over G equal contiguous lane
    groups (the programs of an ensemble, the rounds of a stream), which
    gains, each step, one for every group with an unsettled shot: the
    step count each group's own loop would have reached (a settled shot
    is left unchanged by further steps).

    ``cores``: the rank's shard of a cores-sharded run (:func:`_step`).
    The settle test and quiescence are then taken over the program's
    full core axis, so every rank of the cores axis reads the same
    predicate and takes the same number of steps, as its collectives
    need."""
    while steps < cfg.max_steps:
        settled = _all_cores(st['done'], cores)
        if cfg.physics:
            settled = settled | paused
        with host_span('step.wait'):
            stop = bool(settled.all())
        if stop:
            break
        if group_steps is not None:
            _count_group_step(group_steps, settled)
        st2, stall_sync = _step(st, soa, spc, interp, sync_part, meas_bits,
                                meas_valid, cfg, traits, dm, steps, prog,
                                cores)
        st, paused = _quiesce(st, st2, stall_sync, paused, cfg, cores)
        steps += 1
    return st, steps, paused


def _all_cores(mask, cores=None):
    """``all()`` over the program's full core axis of a ``[B, C]`` mask:
    over the ranks of the cores axis too when sharded (``cores``)."""
    per_shot = mask.all(-1)
    return per_shot if cores is None else cores.all_ranks(per_shot)


def _count_group_step(group_steps, settled) -> None:
    """Add one to ``group_steps [G]`` for each group of ``settled [B]``
    (G equal contiguous lane groups) that has an unsettled shot."""
    G = group_steps.shape[0]
    group_steps += (~settled.view(G, -1).all(-1)).to(torch.int32)


def _quiesce(st: dict, st2: dict, stall_sync, paused, cfg, cores=None):
    """End of one engine iteration from ``st`` to ``st2``: a shot in
    which no live core changed state is paused for the resolver (physics
    mode, a core awaiting an unresolved bit) or deadlocked — its undone
    cores are halted with ``ERR_FPROC_DEADLOCK`` and the fault of what
    they stall on (``stall_sync``: a sync barrier).  Quiescence is over
    the full core axis (``cores``: :func:`_all_cores`): a shard whose
    lanes froze must not halt while a core on another rank runs.
    Returns ``(st2, paused)``."""
    same = _all_cores((st2['pc'] == st['pc']) & (st2['time'] == st['time'])
                      & (st2['done'] == st['done']), cores)       # [B]
    if cfg.physics:
        # quiescent with a core awaiting an unresolved bit = pause for
        # the resolver; quiescent without one is a deadlock
        pending = (st2['phys_wait'] & ~st2['done']).any(-1)
        paused = paused | (same & pending)
        hard = same & ~pending
    else:
        hard = same
    undone = hard[:, None] & ~st2['done']
    st2['err'] = torch.where(undone, st2['err'] | ERR_FPROC_DEADLOCK,
                             st2['err'])
    st2['fault'] = st2['fault'] \
        | _bit(undone & stall_sync, FAULT_SYNC_DEADLOCK) \
        | _bit(undone & ~stall_sync, FAULT_FPROC_STARVED)
    st2['done'] = st2['done'] | hard[:, None]
    return st2, paused


# ---------------------------------------------------------------------------
# The block engine: one boundary step and one superinstruction per core per
# iteration — the plain torch version of the megastep kernel's block mode
# (K1 block, csrc/exec_span.cu).


def _block_ids(pc, bid_tab):
    """``bid_at[pc]`` per lane, -1 for a ``pc`` outside the program."""
    N = bid_tab.shape[0]
    inside = (pc >= 0) & (pc < N)
    return torch.where(inside, bid_tab[pc.clamp(0, N - 1).long()], -1)


def _exec_blocks(st: dict, steps: int, paused, soa, spc, interp, sync_part,
                 meas_bits, meas_valid, cfg: InterpreterConfig, traits,
                 dm=None, kernel: bool = False, group_steps=None,
                 cores=None):
    """The block-compiled engine — the JAX ``_exec_blocks``, with
    :func:`_exec_loop`'s calling shape: returns ``(st, steps, paused)``.

    Per iteration each core either takes ONE generic :func:`_step` (it
    is at a terminator: a branch, fproc read, sync or a position that
    starts no block) or retires a whole deduplicated straight-line body
    of :func:`isa.build_block_table`.  The boundary step runs first for
    every lane; cores parked at a block start are reverted to their
    iteration-start state, so cross-core fproc and sync reads see that
    state either way.  Block ids are then taken afresh, so a core the
    boundary step just moved onto a block start retires that block in
    the same iteration; a body that ends on another block's start waits
    for the next.  ``steps`` counts iterations, bounded by
    ``cfg.max_steps``; quiescence, deadlock and the physics pause are
    :func:`_exec_loop`'s.  The JAX engine's batch-wide exactness select
    is this loop's condition: an iteration runs only while some shot is
    unsettled and budget is left.

    ``dm``: the device parameters of a bloch run.  ``kernel``: run the
    bodies with the K1 block kernel (:func:`..ops.exec_span.exec_blocks`;
    ``engine='pallas'``, never in physics mode), else with their plain
    version :func:`_apply_blocks`.  ``group_steps``: per-group iteration
    counts, as in :func:`_exec_loop`.  ``cores``: the rank's shard of a
    cores-sharded run: the boundary step is the gathered generic step
    (:func:`_step`), the settle test and quiescence span every rank,
    and the bodies run on the rank's own cores from the full program's
    block plan (``cores.plan``) sliced to them."""
    soa_np = soa.cpu().numpy()
    plan = _block_plan(soa_np) if cores is None else cores.plan
    table = block_table(soa_np, *plan, spc, interp, cfg)
    run_bodies = exec_blocks if kernel \
        else functools.partial(_apply_blocks, dm=dm)
    B, C = st['pc'].shape
    while steps < cfg.max_steps:
        settled = _all_cores(st['done'], cores)
        if cfg.physics:
            settled = settled | paused
        with host_span('step.wait'):
            stop = bool(settled.all())
        if stop:
            break
        if group_steps is not None:
            _count_group_step(group_steps, settled)
        # (1) boundary step, undone for cores parked at a block start
        sup = _block_ids(st['pc'], table.bid) >= 0
        st2, stall_sync = _step(st, soa, spc, interp, sync_part, meas_bits,
                                meas_valid, cfg, traits, dm, steps,
                                cores=cores)
        stall_sync = stall_sync & ~sup
        st2 = {k: torch.where(sup.view(B, C, *(1,) * (v.ndim - 2)), st[k], v)
               for k, v in st2.items()}
        # (2) one superinstruction per core at a block start (the kernel
        # updates st2's fresh tensors in place)
        st2 = run_bodies(st2, table, cfg)
        st, paused = _quiesce(st, st2, stall_sync, paused, cfg, cores)
        steps += 1
    return st, steps, paused


def _apply_blocks(st: dict, table, cfg: InterpreterConfig,
                  dm=None) -> dict:
    """The plain version of one K1 block launch: every live lane whose
    ``pc`` starts a block retires that block's deduplicated body
    ``table.bodies[table.bid[pc]]`` (rows of ``table.soa_np [C, N, F]``;
    :func:`..ops.exec_span.block_table`).  The block ids are fixed
    before any body runs."""
    bid = _block_ids(st['pc'], table.bid)
    for k, (s, L) in enumerate(table.bodies):
        act = (bid == k) & ~st['done']
        st = _exec_block_body(st, act, table.soa_np[:, s:s + L, :],
                              table.spc, table.interp, cfg, dm)
    return st


def _exec_block_body(st: dict, act, rows_np, spc, interp,
                     cfg: InterpreterConfig, dm=None) -> dict:
    """One deduplicated superinstruction: the ``[C, L, F]`` rows
    ``rows_np`` applied in order to the lanes selected by ``act [B, C]``
    — the JAX ``_exec_block_body`` / ``_blk_apply_row``.

    A body holds only :data:`isa.BLOCK_BODY_KINDS` (its terminators are
    refined out by :func:`isa.build_block_table`), so each row is the
    straight-line engine's instruction body (:func:`_sl_apply_instr`)
    with ``pc`` advancing relatively (``pc + 1`` per retired row: a
    deduplicated body serves segments at other start addresses) and no
    ``pc == i`` gate.  A DONE row halts the lane inline without
    advancing ``pc``."""
    L = rows_np.shape[1]
    for off in range(L):
        f = {name: rows_np[:, off, _F[name]] for name in _FIELDS}
        st, _ = _sl_apply_instr(st, None, None, L, f, spc, interp, None,
                                None, cfg, act=act, dm=dm)
    return st


# ---------------------------------------------------------------------------
# The straight-line engine: one pass over a forward-jump-only program, the
# plain torch version of the span kernels K1 and K3 (csrc/exec_span.cu).


def _exec_straightline(st0: dict, soa_np, spc, interp, meas_bits,
                       meas_valid, cfg: InterpreterConfig,
                       fused: dict = None, dm=None) -> dict:
    """One pass over a forward-jump-only program ``soa_np [C, N, F]``.

    Each lane carries ``pc`` = next instruction index; a lane executes
    index ``i`` iff ``pc == i``, and jumps only go forward, so one pass
    over the indices in order retires every lane.  A physics-mode fproc
    read whose own bit is still invalid stalls the lane for the pass
    (``phys_wait``): the epoch resolver validates the bit and the next
    pass resumes at the same index.  The caller counts the pass as ``N``
    steps, as the JAX engine does.

    ``fused``: the sigma = 0 readout tables (:func:`_sl_apply_instr`);
    then ``meas_bits``/``meas_valid`` ride in ``st0`` as state and the
    arguments are ignored.  ``dm``: the device parameters of a bloch
    run."""
    N = soa_np.shape[1]
    st = dict(st0)
    stalled = torch.zeros(st['pc'].shape, dtype=torch.bool,
                          device=st['pc'].device)
    for i in range(N):
        f = {name: soa_np[:, i, _F[name]] for name in _FIELDS}
        if fused is not None:
            meas_bits, meas_valid = st['meas_bits'], st['meas_valid']
        st, stalled = _sl_apply_instr(st, stalled, i, N, f, spc, interp,
                                      meas_bits, meas_valid, cfg, fused,
                                      dm=dm)
    if cfg.physics:
        st['phys_wait'] = stalled
    return st


def _reg_read_static(regs, addr_c):
    """``regs[..., addr_c[c]]`` per core for a static address per core;
    an address outside the register file reads 0."""
    B, C, _ = regs.shape
    addr = np.asarray(addr_c)
    ok = (addr >= 0) & (addr < isa.N_REGS)
    idx = torch.as_tensor(np.where(ok, addr, 0), device=regs.device)
    val = regs.gather(-1, idx.long()[None, :, None].expand(B, C, 1))[..., 0]
    return torch.where(torch.as_tensor(ok, device=regs.device)[None],
                       val, 0)


def _sl_apply_instr(st: dict, stalled, i: int, N: int, f: dict, spc,
                    interp, meas_bits, meas_valid, cfg: InterpreterConfig,
                    fused: dict = None, act=None, dm=None):
    """Apply instruction index ``i`` (static fields ``f``, one value per
    core) to every lane with ``pc == i`` — the JAX ``_sl_apply_instr``.
    Returns ``(st, stalled)``.

    ``act``: block mode (:func:`_exec_block_body`) — apply the row to
    the live lanes of ``act [B, C]`` instead, advancing ``pc`` by one;
    the row is a body kind, so ``stalled`` and ``i`` are unused.

    ``fused``: the measure-in-megastep directive (K3's plain version):
    a measurement trigger also computes its window's sigma = 0 bit
    (:func:`_fused_window_energy`, :func:`_fused_discriminate`) and
    writes it into ``st['meas_bits']``/``st['meas_valid']``.  ``dm``:
    the device parameters of a bloch run (:func:`_device_1q_pulse`)."""
    st = dict(st)
    B, C = st['pc'].shape
    dev = st['pc'].device
    i32 = torch.int32
    kind = f['kind']
    m_pw, m_pt = kind == isa.K_PULSE_WRITE, kind == isa.K_PULSE_TRIG
    m_rst, m_idle = kind == isa.K_PULSE_RESET, kind == isa.K_IDLE
    m_regalu, m_incq = kind == isa.K_REG_ALU, kind == isa.K_INC_QCLK
    m_jmpi, m_jcond = kind == isa.K_JUMP_I, kind == isa.K_JUMP_COND
    m_jfp, m_afp = kind == isa.K_JUMP_FPROC, kind == isa.K_ALU_FPROC
    m_done = kind == isa.K_DONE
    m_fproc = m_jfp | m_afp
    m_alu = m_regalu | m_incq | m_jcond | m_fproc
    has = lambda m: bool(np.any(m))

    def j(a):
        """A static per-core value as a ``[1, C, ...]`` tensor."""
        with host_span('h2d.wait'):
            return torch.as_tensor(np.asarray(a), device=dev)[None]

    if act is None:
        active = (st['pc'] == i) & ~st['done'] & ~stalled
    else:
        active = act & ~st['done']
    time, offset, regs = st['time'], st['offset'], st['regs']
    err_i = torch.zeros((B, C), dtype=i32, device=dev)
    fault_i = torch.zeros((B, C), dtype=i32, device=dev)
    # an out-of-ISA kind retires as a no-op: trap it
    m_bad = (kind < 0) | (kind >= isa.N_KINDS)
    if has(m_bad):
        fault_i = fault_i | _bit(j(m_bad), FAULT_ILLEGAL_OP)

    # ---- fproc: own-core sticky read, or the time-indexed LUT read -----
    if has(m_fproc) and cfg.fabric == 'lut':
        # the span-lut serve: eligibility (_lut_span_reject) puts every
        # masked core's measurements at indices below every read, so the
        # planes are final here and the generic serve's causality wait
        # would change nothing but when the read is served
        req = time
        f_data, l_valid, t_lut = _lut_select(st, meas_bits, meas_valid,
                                             req, cfg)
        f_race = torch.zeros((B, C), dtype=torch.bool, device=dev)
        f_tready = torch.maximum(req, t_lut)
        # a masked producer that retired with no measurement starves the
        # reader: the generic engine's quiescence terminal, with the
        # reader's pc and time frozen at the read
        lmask = torch.as_tensor(np.asarray(cfg.lut_mask, dtype=bool),
                                device=dev)
        starved = (lmask & (st['n_meas'] == 0)).any(-1, keepdim=True)
        starve_i = active & j(m_fproc) & starved
        st['err'] = st['err'] | _bit(starve_i, ERR_FPROC_DEADLOCK)
        st['fault'] = st['fault'] | _bit(starve_i, FAULT_FPROC_STARVED)
        st['done'] = st['done'] | starve_i
        active = active & ~starve_i
        # an invalid selected bit stalls the lane (physics pause)
        stall_i = active & j(m_fproc) & ~l_valid
        stalled = stalled | stall_i
        active = active & ~stall_i
    elif has(m_fproc):
        req = f_tready = time
        mavail = st['meas_avail']
        m_cnt = (mavail <= req[..., None]).sum(-1, dtype=i32)
        latest = (m_cnt - 1).clamp(min=0)
        latest_valid = (m_cnt == 0) | _take(meas_valid, latest)
        f_data = torch.where(m_cnt > 0, _take(meas_bits, latest), 0)
        f_race = ((mavail > (req - STICKY_RACE_MARGIN)[..., None])
                  & (mavail <= (req + STICKY_RACE_MARGIN)[..., None])
                  ).any(-1)
        stall_i = active & j(m_fproc) & ~latest_valid
        stalled = stalled | stall_i
        active = active & ~stall_i

    # ---- ALU -----------------------------------------------------------
    alu_res = torch.zeros((B, C), dtype=i32, device=dev)
    if has(m_alu):
        in0 = j(f['imm']).expand(B, C)
        if np.any(f['in0_is_reg'][m_alu]):
            in0 = torch.where(j(f['in0_is_reg'] == 1),
                              _reg_read_static(regs, f['in0_reg']), in0)
        in1 = torch.zeros((B, C), dtype=i32, device=dev)
        if np.any(m_regalu | m_jcond):
            in1 = _reg_read_static(regs, f['in1_reg'])
        if has(m_incq):
            in1 = torch.where(j(m_incq), time - offset, in1)
        if has(m_fproc):
            in1 = torch.where(j(m_fproc), f_data, in1)
        alu_res = _alu_vec(j(f['alu_op']), in0, in1)
        if np.any(m_regalu | m_afp):
            wr = active & j(m_regalu | m_afp)
            wr_oh = np.asarray(f['out_reg'])[:, None] \
                == np.arange(isa.N_REGS)[None, :]
            regs = torch.where(wr[..., None] & j(wr_oh), alu_res[..., None],
                               regs)
            st['regs'] = regs

    # ---- pulse latch + trigger -----------------------------------------
    pp = st['pp']
    if has(m_pw | m_pt):
        is_pulse = active & j(m_pw | m_pt)
        pmasks = np.asarray(_PMASKS, np.int32)
        imm_vals = np.stack([f['p_env'], f['p_phase'], f['p_freq'],
                             f['p_amp'], f['p_cfg']], -1) & pmasks  # [C, 5]
        wen = ((f['p_wen'][:, None] >> np.arange(5)) & 1) == 1
        if np.any(f['p_regsel']):
            rsel = ((f['p_regsel'][:, None] >> np.arange(5)) & 1) == 1
            regval = _reg_read_static(regs, f['p_reg'])
            cand = torch.where(j(rsel), regval[..., None] & j(pmasks),
                               j(imm_vals))
        else:
            cand = j(imm_vals)
        pp = torch.where(is_pulse[..., None] & j(wen), cand, pp)
        st['pp'] = pp

    if has(m_pt):
        cmd_time = j(f['cmd_time']).expand(B, C)         # uint32 bit pattern
        trig = _wrap32(offset.long() + cmd_time.long())
        fire = active & j(m_pt)
        err_i = err_i | _bit(fire & (trig < time), ERR_MISSED_TRIG)
        trig = torch.maximum(trig, time)
        elem = pp[..., 4] & 0b11
        elem_idx = elem.clamp(max=spc.shape[1] - 1).long()[..., None]
        spc_e = spc.expand(B, C, -1).gather(-1, elem_idx)[..., 0]
        interp_e = interp.expand(B, C, -1).gather(-1, elem_idx)[..., 0]
        env_len = (pp[..., 0] >> 12) & 0xfff
        nsamp = env_len * 4 * interp_e
        dur = torch.where(env_len == 0xfff, 0,
                          torch.div(nsamp + spc_e - 1, spc_e,
                                    rounding_mode='floor'))
        over = fire & (st['n_pulses'] >= cfg.max_pulses)
        err_i = err_i | _bit(over, ERR_PULSE_OVERFLOW)
        fault_i = fault_i | _bit(over, FAULT_PULSE_OVERFLOW)
        if cfg.record_pulses:
            rec_vals = torch.stack(
                [cmd_time, trig, pp[..., 0], pp[..., 1], pp[..., 2],
                 pp[..., 3], pp[..., 4], elem, dur], dim=-1)   # [B, C, 9]
            pwrite = _slot_mask(st['n_pulses'].clamp(max=cfg.max_pulses - 1),
                                cfg.max_pulses) \
                & (fire & (st['n_pulses'] < cfg.max_pulses))[..., None]
            st['rec'] = torch.where(pwrite[:, :, None, :],
                                    rec_vals[..., None], st['rec'])
        st['n_pulses'] = st['n_pulses'] + fire.to(i32)

        is_meas = fire & (elem == cfg.meas_elem)
        mover = is_meas & (st['n_meas'] >= cfg.max_meas)
        err_i = err_i | _bit(mover, ERR_MEAS_OVERFLOW)
        fault_i = fault_i | _bit(mover, FAULT_MEAS_OVERFLOW)
        mslot = st['n_meas'].clamp(max=cfg.max_meas - 1)
        mwr = _slot_mask(mslot, cfg.max_meas) & is_meas[..., None]
        meas_avail = torch.where(
            mwr, (trig + dur + cfg.meas_latency)[..., None],
            st['meas_avail'])
        if cfg.physics and cfg.cw_horizon > 0:
            cw_clks = torch.div(cfg.cw_horizon + spc_e - 1, spc_e,
                                rounding_mode='floor')
            meas_avail = torch.where(
                mwr & (env_len == 0xfff)[..., None],
                (trig + cw_clks + cfg.meas_latency)[..., None], meas_avail)
        elif cfg.physics:
            err_i = err_i | _bit(is_meas & (env_len == 0xfff), ERR_CW_MEAS)
        st['meas_avail'] = meas_avail
        if 'meas_time' in st:
            # the lut fabric's production clock: the trigger time
            st['meas_time'] = torch.where(mwr, trig[..., None],
                                          st['meas_time'])
        st['n_meas'] = st['n_meas'] + is_meas.to(i32)

        if cfg.physics:
            dev_upd, state_bit = _device_1q_pulse(
                st, cfg, dm, fire, elem, pp, trig, mslot, is_meas)
            st.update(dev_upd)
            for key, val in (('meas_state', state_bit),
                             ('meas_amp', pp[..., 3]),
                             ('meas_phase', pp[..., 1]),
                             ('meas_freq', pp[..., 2]),
                             ('meas_env', pp[..., 0]),
                             ('meas_gtime', trig)):
                st[key] = torch.where(mwr, val[..., None], st[key])
            if fused is not None:
                energy = _fused_window_energy(fused, pp, nsamp, env_len)
                bit = _fused_discriminate(fused, energy, state_bit)
                st['meas_bits'] = torch.where(mwr, bit[..., None],
                                              st['meas_bits'])
                st['meas_valid'] = st['meas_valid'] | mwr

    # ---- phase reset / idle --------------------------------------------
    if has(m_rst):
        is_rst = active & j(m_rst)
        rmask = _slot_mask(st['n_resets'].clamp(max=cfg.max_resets - 1),
                           cfg.max_resets) & is_rst[..., None]
        st['rst_time'] = torch.where(rmask, time[..., None], st['rst_time'])
        fault_i = fault_i | _bit(is_rst & (st['n_resets'] >= cfg.max_resets),
                                 FAULT_RESET_OVERFLOW)
        st['n_resets'] = st['n_resets'] + is_rst.to(i32)
    if has(m_idle):
        is_idle = active & j(m_idle)
        idle_end = _wrap32(offset.long() + j(f['cmd_time']).long())
        err_i = err_i | _bit(is_idle & (time > idle_end), ERR_MISSED_TRIG)
        idle_end = torch.maximum(idle_end, time)

    # ---- race flag on the proceeding read ------------------------------
    if has(m_fproc):
        err_i = err_i | _bit(active & j(m_fproc) & f_race, ERR_STICKY_RACE)

    if 'op_hist' in st:
        oh_kind = kind[:, None] == np.arange(isa.N_KINDS)[None, :]
        st['op_hist'] = st['op_hist'] \
            + (active[..., None] & j(oh_kind)).to(i32)

    # ---- next pc / time / offset / done --------------------------------
    pc_next = st['pc'] + 1 if act is not None \
        else torch.full((B, C), i + 1, dtype=i32, device=dev)
    m_jump = m_jmpi | m_jcond | m_jfp
    if has(m_jump):
        branch = (alu_res & 1) == 1
        taken = j(m_jmpi) | (j(m_jcond | m_jfp) & branch)
        pc_next = torch.where(taken, j(f['jump_addr']), pc_next)
        # a taken jump past the program end leaves the lane undone: trap
        m_oob = (f['jump_addr'] < 0) | (f['jump_addr'] >= N)
        if has(m_oob & m_jump):
            st['fault'] = st['fault'] \
                | _bit(active & taken & j(m_oob), FAULT_JUMP_OOB)
    st['pc'] = torch.where(active & ~j(m_done), pc_next, st['pc'])
    time_next = time
    if has(m_pt):
        time_next = torch.where(j(m_pt), trig + cfg.pulse_load_clks,
                                time_next)
    if has(m_pw | m_rst):
        time_next = torch.where(j(m_pw | m_rst),
                                time + cfg.pulse_regwrite_clks, time_next)
    if has(m_idle):
        time_next = torch.where(j(m_idle), idle_end + cfg.pulse_load_clks,
                                time_next)
    if has(m_regalu | m_incq):
        time_next = torch.where(j(m_regalu | m_incq),
                                time + cfg.alu_instr_clks, time_next)
    if has(m_jmpi | m_jcond):
        time_next = torch.where(j(m_jmpi | m_jcond),
                                time + cfg.jump_cond_clks, time_next)
    if has(m_fproc):
        # served at the request time (sticky) or at max(request, the LUT's
        # distribution time)
        time_next = torch.where(j(m_fproc), f_tready + cfg.jump_fproc_clks,
                                time_next)
    st['time'] = torch.where(active, time_next, time)
    if has(m_incq):
        st['offset'] = torch.where(
            active & j(m_incq), _wrap32(time.long() - alu_res.long()),
            offset)
    st['err'] = st['err'] | torch.where(active, err_i, 0)
    st['fault'] = st['fault'] | torch.where(active, fault_i, 0)
    st['done'] = st['done'] | (active & j(m_done))
    return st, stalled


# chunk (DAC samples) of the plain version's masked energy sum: bounds
# its [B, C, chunk] float32 intermediate
_FUSED_ENERGY_CHUNK = 512


def _fused_window_energy(fused: dict, pp, nsamp, env_len):
    """Window energy ``amp^2 * sum_{s < count} e2[c, row, s]`` of the
    measurement pulse latched in ``pp`` — the scale of the sigma = 0
    matched-filter sums (the carrier's unit magnitude drops out).
    ``fused['e2']`` ``[C, R, Wp]`` holds the energy rows of the static
    envelope addresses ``fused['addrs']`` (:func:`..ops.resolve.
    build_energy_tables`); a CW window has count 0."""
    e2 = fused['e2']
    Wp = e2.shape[2]
    count = torch.where(env_len == 0xfff, 0, nsamp.clamp(max=fused['w']))
    addr = (pp[..., 0] & 0xfff) * 4
    chunk = min(int(fused.get('chunk') or _FUSED_ENERGY_CHUNK), Wp)
    tot = torch.zeros(addr.shape, dtype=torch.float32, device=addr.device)
    for r, a in enumerate(fused['addrs']):
        acc = torch.zeros_like(tot)
        for s0 in range(0, Wp, chunk):
            blk = e2[:, r, s0:s0 + chunk]                        # [C, L]
            s = s0 + torch.arange(blk.shape[1], device=addr.device)
            m = s[None, None, :] < count[..., None]
            acc = acc + torch.where(m, blk[None], 0.0).sum(-1)
        tot = tot + torch.where(addr == a, acc, 0.0)
    amp = pp[..., 3].to(torch.float32) / fused['amp_scale']
    return amp * amp * tot


def _fused_discriminate(fused: dict, energy, state_bit):
    """2-class threshold of the sigma = 0 sums ``g_s * E``: the
    projection of :func:`..sim.physics._discriminate_acc`.  With
    ``E >= 0`` its sign depends only on which response scaled it, so the
    bit does not depend on the order in which ``E`` was summed."""
    g0b, g1b = fused['g0'][None], fused['g1'][None]          # [1, C, 2]
    gs = torch.where(state_bit[..., None] == 1, g1b, g0b)    # [B, C, 2]
    acc_i = gs[..., 0] * energy
    acc_q = gs[..., 1] * energy
    a0_i, a0_q = g0b[..., 0] * energy, g0b[..., 1] * energy
    a1_i, a1_q = g1b[..., 0] * energy, g1b[..., 1] * energy
    proj = (acc_i - (a0_i + a1_i) / 2) * (a1_i - a0_i) \
        + (acc_q - (a0_q + a1_q) / 2) * (a1_q - a0_q)
    return (proj > 0).to(torch.int32)


def _finalize(st: dict, steps, cfg: InterpreterConfig,
              groups: int = None) -> dict:
    """The run's outputs from its final carry.  ``groups``: G equal
    contiguous lane groups (:func:`_run_injected`) — every leaf gains a
    leading group axis, and ``steps`` (an int, or the ``[G]`` counts of
    :func:`_exec_loop`), ``incomplete`` and ``op_hist`` are per group."""
    dev = st['pc'].device
    if cfg.record_pulses:
        rec = st.pop('rec')
        st.update({'rec_' + n: rec[:, :, i, :].contiguous()
                   for i, n in enumerate(_REC_FIELDS)})
    st['qclk'] = st['time'] - st['offset']
    # a lane still live after every loop returned ran out of budget
    st['fault'] = st['fault'] | _bit(~st['done'], FAULT_BUDGET_EXHAUSTED)
    if groups is None:
        if 'op_hist' in st:
            st['op_hist'] = st['op_hist'].sum((0, 1), dtype=torch.int32)
        with host_span('h2d.wait'):
            st['steps'] = torch.tensor(steps, dtype=torch.int32, device=dev)
        st['incomplete'] = ~st['done'].all()
        return st
    G = groups
    st = {k: v.reshape(G, -1, *v.shape[1:]) for k, v in st.items()}
    if 'op_hist' in st:
        st['op_hist'] = st['op_hist'].sum((1, 2), dtype=torch.int32)
    st['steps'] = steps if torch.is_tensor(steps) \
        else torch.full((G,), steps, dtype=torch.int32, device=dev)
    st['incomplete'] = ~st['done'].reshape(G, -1).all(-1)
    return st


def _fault_policy(cfg: InterpreterConfig):
    """Split ``cfg.fault_mode`` into (run cfg, strict flag)."""
    if cfg.fault_mode not in ('count', 'strict'):
        raise ValueError(f"fault_mode must be 'count' or 'strict'; got "
                         f"{cfg.fault_mode!r}")
    if cfg.fault_mode == 'strict':
        return replace(cfg, fault_mode='count'), True
    return cfg, False


def _check_strict(out: dict, strict: bool) -> dict:
    """Raise :class:`FaultError` when strict and any lane trapped."""
    if strict:
        counts = fault_shot_counts(out['fault']).cpu().numpy()
        if counts.any():
            raise FaultError(counts)
    return out


def _pad_meas(meas_bits: torch.Tensor, max_meas: int) -> torch.Tensor:
    n = meas_bits.shape[-1]
    if n > max_meas:
        return meas_bits[..., :max_meas]
    if n < max_meas:
        return torch.nn.functional.pad(meas_bits, (0, max_meas - n))
    return meas_bits


def _run_injected(mp, eng: str, meas_bits, init_regs,
                  cfg: InterpreterConfig, device, groups: int = None,
                  cores=None) -> dict:
    """Run ``mp`` on the resolved engine ``eng`` over the lanes of
    injected bits ``meas_bits [L, C, max_meas]`` (every bit valid from
    the start); ``init_regs``: ``None``, ``[C, 16]`` or ``[L, C, 16]``.
    ``mp`` may be a :class:`..decoder.MultiMachineProgram` of P programs
    on the generic engine, its lanes program-major (``L = P x B``).
    ``groups``: as in :func:`_finalize`.  ``cores``: this rank's shard of
    a cores-sharded run (generic or block engine): ``meas_bits`` and
    ``init_regs`` hold the rank's own cores, and the engine runs their
    rows of the program (:func:`_step`)."""
    if eng == 'fused':
        raise ValueError(
            "engine='fused' demodulates measurement windows in-kernel; "
            'the injected-bits entry points have no window — run via '
            'sim.physics.run_physics_batch')
    soa, spc, interp, sync_part = _program_constants(mp, device)
    C = mp.n_cores
    if cores is not None:
        _count_trace('cores_trace', (
            eng, cores.size, tuple(meas_bits.shape), tuple(soa.shape), cfg,
            program_traits(mp), _content_key(mp) if eng == 'block' else None,
            _device_key(device)))
        own = slice(cores.core0, cores.core0 + meas_bits.shape[1])
        soa, spc, interp = soa[own], spc[own], interp[own]
        C = soa.shape[0]
    elif groups is None and eng in ('pallas', 'block'):
        _count_trace(f'{eng}_trace', (
            tuple(meas_bits.shape), cfg, _content_key(mp),
            _device_key(device)))
    L = meas_bits.shape[0]
    if eng in ('straightline', 'pallas') and meas_bits.shape[1] != C:
        # the JAX package's straight-line and Pallas executors reshape
        # the bits to the program's core axis: they raise, or return a
        # state with no one core axis to match
        raise TypeError(
            f'meas_bits has {meas_bits.shape[1]} cores; the {eng} engine '
            f'runs the program\'s {C}')
    prog = None
    if soa.ndim == 4:
        # an ensemble: lane l runs program l // B, fetched from the shared
        # [P, C, N, F] table
        prog = torch.arange(soa.shape[0], device=device) \
            .repeat_interleave(L // soa.shape[0])
        sync_part = sync_part[prog]
    st = _init_state(L, C, cfg, init_regs, device)
    meas_valid = torch.ones(meas_bits.shape, dtype=torch.bool, device=device)
    group_steps = None if groups is None \
        else torch.zeros((groups,), dtype=torch.int32, device=device)
    # a looping program on 'pallas': the block engine with K1 block as
    # its bodies; a cores-sharded block run takes K1 block for its bodies
    kernel_blocks = (eng == 'pallas' and _pallas_mode(mp, cfg) == 'block') \
        or (eng == 'block' and cores is not None)
    if eng in ('generic', 'block') or kernel_blocks:
        paused = torch.zeros((L,), dtype=torch.bool, device=device)
        loop = functools.partial(_exec_loop, prog=prog) if eng == 'generic' \
            else functools.partial(_exec_blocks, kernel=kernel_blocks)
        st, steps, _ = loop(st, 0, paused, soa, spc, interp, sync_part,
                            meas_bits, meas_valid, cfg, program_traits(mp),
                            group_steps=group_steps, cores=cores)
        if group_steps is not None:
            steps = group_steps
    else:
        # one pass retires every lane: every injected bit is valid
        if eng == 'straightline':
            st = _exec_straightline(st, _soa_np(mp), spc, interp, meas_bits,
                                    meas_valid, cfg)
        else:   # 'pallas', span mode: the K1 kernel
            st = exec_span(st, _span_table(mp, cfg, device), meas_bits, cfg)
        steps = mp.n_instr
    st.pop('phys_wait', None)
    return _finalize(st, steps, cfg, groups)


def simulate_batch(mp, meas_bits, init_regs=None,
                   cfg: InterpreterConfig = None, device=None,
                   **kw) -> dict:
    """Execute ``mp`` on a batch of shots with injected measurement bits
    ``meas_bits [n_shots, n_cores, n_meas]`` (the cocotb-style path:
    every bit is valid from the start).  ``init_regs``: optional
    ``[n_cores, 16]`` or ``[n_shots, n_cores, 16]`` register file.
    ``device``: the torch device to run on (default CUDA).

    Returns the final machine state as tensors on ``device``: pulse
    records (``rec_*``, when ``cfg.record_pulses``), registers, qclk,
    per-core ``err`` and ``fault`` words, completion flags, ``steps``
    and ``incomplete``."""
    device = torch_device(device)
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    _check_single_round(cfg)
    _check_no_cores_axis(cfg)
    eng = check_supported(mp, cfg, device)
    cfg, strict = _fault_policy(cfg)
    meas_bits = _pad_meas(torch.as_tensor(meas_bits, dtype=torch.int32,
                                          device=device), cfg.max_meas)
    return _check_strict(_run_injected(mp, eng, meas_bits, init_regs, cfg,
                                       device), strict)


# outputs of a batch run that carry no shot axis
_UNBATCHED_KEYS = ('steps', 'incomplete', 'op_hist')


def simulate(mp, meas_bits=None, init_regs=None,
             cfg: InterpreterConfig = None, device=None, **kw) -> dict:
    """Execute ``mp`` on one shot: :func:`simulate_batch` at a batch of
    one, with the shot axis dropped from every output.

    ``meas_bits``: optional ``[n_cores, n_meas]`` injected bits (default
    zeros).  ``init_regs``: optional ``[n_cores, 16]`` register file.
    Returns the final machine state with pulse records ``rec_*`` of shape
    ``[n_cores, max_pulses]``, valid up to ``n_pulses``."""
    cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
    if meas_bits is None:
        meas_bits = np.zeros((mp.n_cores, cfg.max_meas), np.int32)
    meas_bits = torch.as_tensor(meas_bits, dtype=torch.int32)
    if meas_bits.ndim != 2:
        raise ValueError(f'simulate takes meas_bits [n_cores, n_meas]; got '
                         f'shape {tuple(meas_bits.shape)}')
    out = simulate_batch(mp, meas_bits[None], init_regs=init_regs, cfg=cfg,
                         device=device)
    return {k: (v if k in _UNBATCHED_KEYS else v[0]) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Program ensembles and streaming rounds: both fold their leading axis
# (programs, rounds) into the lanes of one engine call.


def ensemble_config(mmp, cfg: InterpreterConfig = None,
                    **kw) -> InterpreterConfig:
    """``cfg`` with ``kw`` applied; without ``cfg``, the budget derives
    from the ensemble's bucket shape (``max_steps = 2 * n_instr + 64``,
    ``max_pulses = n_instr + 2``) unless ``kw`` sets it."""
    if cfg is not None:
        return replace(cfg, **kw)
    kw.setdefault('max_steps', 2 * mmp.n_instr + 64)
    kw.setdefault('max_pulses', mmp.n_instr + 2)
    return InterpreterConfig(**kw)


def simulate_multi_batch(mps, meas_bits, init_regs=None,
                         cfg: InterpreterConfig = None, pad_to: int = None,
                         device=None, **kw) -> dict:
    """Execute P programs x B shots as one generic-engine pass over
    ``P x B`` lanes, each lane fetching from its own program's rows of
    the stacked ``[P, C, N, F]`` table.

    ``mps``: a list of :class:`..decoder.MachineProgram` (stacked here
    with shape-bucketed DONE padding, :func:`..decoder.
    stack_machine_programs`) or a ``MultiMachineProgram``.
    ``meas_bits``: ``[n_progs, n_shots, n_cores, n_meas]``, or ``[n_shots,
    n_cores, n_meas]`` broadcast to every program.  ``init_regs``:
    ``None``, ``[n_cores, 16]`` (shared), ``[n_progs, n_cores, 16]`` (per
    program) or ``[n_progs, n_shots, n_cores, 16]``.  ``device``: the
    torch device (default CUDA).

    When ``cfg`` is omitted the budget derives from the bucket shape
    (``max_steps = 2 * n_instr + 64``, ``max_pulses = n_instr + 2``), as
    in the JAX package.  Returns the :func:`simulate_batch` outputs with
    a leading program axis on every leaf; ``steps``, ``incomplete`` and
    ``op_hist`` are each program's own (``[n_progs]``, ``[n_progs]``,
    ``[n_progs, K]``).  The generic engine only, as in the JAX package:
    the other engines raise."""
    device = torch_device(device)
    mmp = mps if isinstance(mps, MultiMachineProgram) \
        else stack_machine_programs(mps, pad_to=pad_to)
    cfg = ensemble_config(mmp, cfg, **kw)
    if cfg.straightline or cfg.engine in ('straightline', 'block',
                                          'pallas', 'fused'):
        raise ValueError(
            'simulate_multi_batch runs the generic engine only: the '
            'straight-line, block, and pallas executors key their '
            'caches on program content, the per-sequence compile this '
            'path amortizes away')
    _check_single_round(cfg)
    _check_no_cores_axis(cfg)
    cfg = replace(cfg, straightline=False, engine=None)
    eng = check_supported(mmp, cfg, device)
    cfg, strict = _fault_policy(cfg)
    P, C = mmp.n_progs, mmp.n_cores
    with host_span('h2d.wait'):
        meas_bits = torch.as_tensor(meas_bits, dtype=torch.int32,
                                    device=device)
    meas_bits = _pad_meas(meas_bits, cfg.max_meas)
    if meas_bits.ndim == 3:
        meas_bits = meas_bits[None].expand(P, *meas_bits.shape)
    if meas_bits.ndim != 4 or meas_bits.shape[0] != P \
            or meas_bits.shape[2] != C:
        raise ValueError(
            f'meas_bits must be [n_progs={P}, n_shots, n_cores={C}, '
            f'n_meas]; got {tuple(meas_bits.shape)}')
    B = meas_bits.shape[1]
    if init_regs is not None:
        init_regs = torch.as_tensor(init_regs, dtype=torch.int32,
                                    device=device)
        if init_regs.ndim == 3:          # [P, C, R] per program
            if init_regs.shape[0] != P:
                raise ValueError(
                    f'3-D init_regs must be [n_progs={P}, n_cores, '
                    f'n_regs] (per-shot registers need the full 4-D '
                    f'form); got {tuple(init_regs.shape)}')
            init_regs = init_regs[:, None].expand(P, B, C, isa.N_REGS)
        if init_regs.ndim == 4:          # [P, B, C, R]
            init_regs = init_regs.reshape(P * B, C, isa.N_REGS)
    key = _aot_cache_key(P, B, C, mmp.n_instr, _max_elems(mmp),
                         cfg.max_meas, cfg, program_traits(mmp), device)
    if _aot_lookup(key):
        counter_inc('aot_hit')
    _count_trace('multi_trace', key)
    out = _run_injected(mmp, eng, meas_bits.reshape(P * B, C, -1),
                        init_regs, cfg, device, groups=P)
    return _check_strict(out, strict)


# ---------------------------------------------------------------------------
# Warm-up of the serving tier's multi-program dispatch: the JAX package's
# AOT executables.  Eager torch has no executable to compile ahead; what a
# first dispatch pays on the card is the caching allocator's growth to the
# batch's working set and the first launches of the step's kernels.
# aot_compile_batch pays it before traffic by running the bound spec's
# shape once through the generic multi engine, on zero bits on the
# device, and keeps JAX's bounded LRU of warmed shapes (same bound, same
# 'aot_compile' / 'aot_hit' / 'aot_evictions' counters), so the serving
# tier labels a dispatch cold, warm or aot as JAX labels it.

_AOT_LOCK = threading.Lock()
# _aot_cache_key(...) -> warm-up seconds, least-recently-used first
_AOT_CACHE: collections.OrderedDict = collections.OrderedDict()
_AOT_CACHE_CAP = int(os.environ.get('DPROC_AOT_CACHE_CAP', '256'))


def set_aot_cache_cap(cap: int) -> int:
    """Set the warm-shape cache bound (``DPROC_AOT_CACHE_CAP`` gives the
    process default); returns the previous cap.  Lowering the cap evicts
    immediately, oldest-used first."""
    global _AOT_CACHE_CAP
    if cap < 1:
        raise ValueError('aot cache cap must be >= 1')
    with _AOT_LOCK:
        old, _AOT_CACHE_CAP = _AOT_CACHE_CAP, cap
        _evict_aot_locked()
    return old


def _evict_aot_locked() -> None:
    while len(_AOT_CACHE) > _AOT_CACHE_CAP:
        _AOT_CACHE.popitem(last=False)
        counter_inc('aot_evictions')


def _device_key(device) -> tuple:
    """``(type, index)`` of ``device``, a CUDA device's index resolved
    to the current one."""
    device = torch.device(device)
    index = device.index
    if index is None and device.type == 'cuda':
        index = torch.cuda.current_device()
    return device.type, index


def _aot_cache_key(P, B, C, N, E, max_meas, cfg, traits, device):
    return (int(P), int(B), int(C), int(N), int(E), int(max_meas),
            cfg, traits, None if device is None else _device_key(device))


def _aot_cfg(spec):
    """The dispatch cfg of a bound spec, normalized as
    :func:`simulate_multi_batch` normalizes it, or None when the spec is
    unbound or names a content-keyed engine."""
    if spec.n_programs is None or spec.n_shots is None:
        return None
    cfg = spec.cfg
    if cfg.straightline or cfg.engine in ('straightline', 'block',
                                          'pallas', 'fused'):
        return None
    cfg = replace(cfg, straightline=False, engine=None)
    return _fault_policy(cfg)[0]


def _aot_lookup(key) -> bool:
    with _AOT_LOCK:
        if key not in _AOT_CACHE:
            return False
        _AOT_CACHE.move_to_end(key)
        return True


def aot_compile_batch(spec, device=None) -> float:
    """Warm the multi-program dispatch a bound
    :class:`~..serve.bucketspec.BucketSpec` describes on ``device``
    (default CUDA): one run of the spec's shape — ``n_programs`` programs
    of DONE over its cores, instruction bucket and element geometry, at
    ``n_shots`` shots of zero bits — through the generic multi engine,
    ended by a device sync.

    ``spec`` is duck-typed (``n_programs``/``n_shots``/``n_cores``/
    ``n_instr_bucket``/``geometry``/``max_elems``/``cfg``/``traits``/
    ``has_init_regs``).  Returns the wall seconds of the run, or 0.0
    when the shape was already warm on the device (idempotent: safe to
    replay a catalog on every start)."""
    if spec.n_programs is None or spec.n_shots is None:
        raise ValueError('aot_compile_batch needs a BOUND spec '
                         '(n_programs/n_shots set — BucketSpec.bind)')
    cfg = _aot_cfg(spec)
    if cfg is None:
        raise ValueError('AOT precompilation covers the generic '
                         'multi-program engine only (content-keyed '
                         'engines have no shape-only executable)')
    device = torch_device(device)
    P, B, C = spec.n_programs, spec.n_shots, spec.n_cores
    key = _aot_cache_key(P, B, C, spec.n_instr_bucket, spec.max_elems,
                         cfg.max_meas, cfg, spec.traits, device)
    with _AOT_LOCK:
        if key in _AOT_CACHE:
            _AOT_CACHE.move_to_end(key)
            return 0.0
    from ..decoder import machine_program_from_cmds
    from ..elements import TPUElementConfig
    mp = machine_program_from_cmds([[isa.done_cmd()]] * C)
    for table, geom in zip(mp.tables, spec.geometry):
        table.elem_cfgs = [TPUElementConfig(samples_per_clk=spc,
                                            interp_ratio=interp)
                           for spc, interp in geom]
    mmp = stack_machine_programs([mp] * P, pad_to=spec.n_instr_bucket)
    bits = torch.zeros((P, B, C, cfg.max_meas), dtype=torch.int32,
                       device=device)
    regs = torch.zeros((P, B, C, isa.N_REGS), dtype=torch.int32,
                       device=device) if spec.has_init_regs else None
    t0 = time.perf_counter()
    simulate_multi_batch(mmp, bits, regs, cfg=cfg, device=device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    with _AOT_LOCK:
        _AOT_CACHE.setdefault(key, dt)
        _AOT_CACHE.move_to_end(key)
        _evict_aot_locked()
    counter_inc('aot_compile')
    return dt


def aot_batch_cached(spec, device=None) -> bool:
    """Would a multi-batch dispatch of this bound spec on ``device`` find
    its shape warmed by :func:`aot_compile_batch`?  A pure lookup: warms
    nothing, and returns False for an unbound or content-keyed spec (the
    serving tier labels dispatch spans cold / warm / aot with it)."""
    cfg = _aot_cfg(spec)
    if cfg is None:
        return False
    return _aot_lookup(_aot_cache_key(
        spec.n_programs, spec.n_shots, spec.n_cores, spec.n_instr_bucket,
        spec.max_elems, cfg.max_meas, cfg, spec.traits, device))


def aot_cache_size() -> int:
    with _AOT_LOCK:
        return len(_AOT_CACHE)


def clear_aot_cache() -> int:
    """Drop every warmed shape; returns the number dropped."""
    with _AOT_LOCK:
        n = len(_AOT_CACHE)
        _AOT_CACHE.clear()
    return n


def aot_compile_count() -> int:
    """How many shapes this process has warmed (named counter
    ``'aot_compile'``); ``'aot_hit'`` counts dispatches that found one."""
    return counter_get('aot_compile')


def aot_eviction_count() -> int:
    """How many warmed shapes the LRU bound has evicted (named counter
    ``'aot_evictions'``)."""
    return counter_get('aot_evictions')


# ---------------------------------------------------------------------------
# Retrace probes: the JAX package counts each trace of its executors in
# named counters, and its retrace contract allows one trace per (bucket,
# engine) pair, mesh or rounds shape.  Eager torch traces nothing; what a
# JAX trace marks is the first run of an executor key this process has
# not run, and each probe counts exactly that, in the port's own
# registry (utils.profiling -> obs.metrics).  The keys hold the JAX jit
# caches' keys: the batch shape, the config, and the program content
# where JAX makes the program static (pallas, block) or its traits where
# the program is a traced argument (multi, cores).  Keys sit in a bounded
# LRU per counter; one that falls out counts again, as an evicted jit
# cache entry retraces.

_TRACE_LOCK = threading.Lock()
_TRACE_KEYS: dict = {}        # counter name -> OrderedDict of keys
_TRACE_KEYS_CAP = 1024


def _content_key(mp) -> tuple:
    """The program's content as a key (JAX's ``_soa_static``, as a
    digest), computed once per program object and kept on it."""
    key = mp.__dict__.get('_content_key')
    if key is None:
        arr = _soa_np(mp)
        key = arr.shape, hashlib.blake2b(arr.tobytes(),
                                         digest_size=16).digest()
        mp.__dict__['_content_key'] = key
    return key


def _count_trace(name: str, key) -> None:
    """Add one to counter ``name`` the first time this process runs
    ``key``."""
    with _TRACE_LOCK:
        seen = _TRACE_KEYS.setdefault(name, collections.OrderedDict())
        if key in seen:
            seen.move_to_end(key)
            return
        seen[key] = None
        if len(seen) > _TRACE_KEYS_CAP:
            seen.popitem(last=False)
    counter_inc(name)


def pallas_trace_count() -> int:
    """How many K1 / K3 executors this process has set up (named counter
    ``'pallas_trace'``): one per (batch shape, config, program content,
    device) first run on ``engine='pallas'`` (span or block mode,
    :func:`simulate_batch`) or ``engine='fused'``
    (:func:`..sim.physics.run_physics_batch`).  The retrace contract: a
    second call of the same key moves nothing."""
    return counter_get('pallas_trace')


def block_trace_count() -> int:
    """How many block-engine executors this process has set up (named
    counter ``'block_trace'``): one per (batch shape, config, program
    content, device) first run on ``engine='block'``."""
    return counter_get('block_trace')


def cores_trace_count() -> int:
    """How many sharded-cores executors this process has set up (named
    counter ``'cores_trace'``): one per (engine, cores shards, rank-local
    batch shape, program shape, config, traits, device) first run of
    :mod:`..parallel.sweep`'s cores-mesh entry points — program content
    is not part of the key (JAX traces the program as an argument), so
    a same-shape program moves nothing."""
    return counter_get('cores_trace')


def multi_trace_count() -> int:
    """How many multi-program executors this process has set up (named
    counter ``'multi_trace'``): one per bucket shape ``(P, B, C, N, E,
    max_meas)``, config, traits and device first run by
    :func:`simulate_multi_batch` — a second same-shape ensemble, fresh
    sequences included, moves nothing."""
    return counter_get('multi_trace')


def span_trace_count() -> int:
    """How many span runners' span values have run in this process
    (named counter ``'span_trace'``, :func:`make_span_runner`): a sweep
    whose span divides its batch count moves it by one."""
    return counter_get('span_trace')


def rounds_trace_count() -> int:
    """How many rounds executors this process has set up (named counter
    ``'rounds_trace'``): one per (rounds, batch shape, engine, config,
    decode, program — its content on a content-keyed engine, its traits
    on the generic one — device) first run by :func:`simulate_rounds`."""
    return counter_get('rounds_trace')


# per-program scalars of the simulate_multi_batch result: every other
# leaf carries a shot axis after the program axis is sliced away
_MULTI_SCALAR_KEYS = ('steps', 'incomplete', 'op_hist')


def demux_multi_batch(out: dict, prog: int, n_shots: int = None) -> dict:
    """Per-program view of a :func:`simulate_multi_batch` result: program
    ``prog`` sliced off the leading axis of every leaf, the
    :func:`simulate_batch` schema (``steps``/``incomplete`` scalars
    again).  ``n_shots`` also trims the shot axis to the first
    ``n_shots`` lanes; ``op_hist``, summed over the program's lanes, is
    passed through whole."""
    res = {}
    for k, v in out.items():
        vi = v[prog]
        if n_shots is not None and k not in _MULTI_SCALAR_KEYS:
            vi = vi[:n_shots]
        res[k] = vi
    return res


def simulate_rounds(mp, meas_bits, init_regs=None,
                    cfg: InterpreterConfig = None, device=None,
                    decode=None, **kw) -> dict:
    """Execute R syndrome rounds of one program in one engine call.

    ``meas_bits``: ``[rounds, n_shots, n_cores, n_meas]``.  Each round
    runs from a fresh initial state with its own injected bits, exactly
    what R sequential :func:`simulate_batch` calls compute; the rounds
    are independent, so they run as ``R x B`` lanes of the resolved
    engine (the engine ladder of :func:`simulate_batch`; ``'fused'``
    raises): one K1 span launch on a loop-free program with
    ``engine='pallas'`` or ``'auto'`` on the card, one K1 block launch
    per block-engine iteration on a looping one.

    Returns the :func:`simulate_batch` outputs with a leading round axis
    on every leaf (``steps`` and ``incomplete`` ``[rounds]``, ``op_hist``
    ``[rounds, K]``).  ``decode`` (a :class:`..ops.decode.DecodeSpec`,
    tuple or dict) adds ``syndrome_hist [n_shots, rounds, K]`` (the named
    cores' injected bits at the named slot) and ``decoded`` (the
    scheme's correction).  ``cfg.rounds`` may pre-declare the round
    count; it must then match the round axis.  ``init_regs`` is shared
    across rounds (``[n_cores, 16]`` or ``[n_shots, n_cores, 16]``)."""
    with host_span('rounds.call'):
        with host_span('rounds.prepare'):
            device = torch_device(device)
            cfg = replace(cfg, **kw) if cfg else InterpreterConfig(**kw)
            _check_no_cores_axis(cfg)
            cfg, strict = _fault_policy(cfg)
            meas_bits = torch.as_tensor(meas_bits, dtype=torch.int32,
                                        device=device)
            if meas_bits.ndim != 4 or meas_bits.shape[2] != mp.n_cores:
                raise ValueError(
                    f'meas_bits must be [rounds, n_shots, n_cores='
                    f'{mp.n_cores}, n_meas]; got {tuple(meas_bits.shape)}')
            R = int(meas_bits.shape[0])
            if R < 1:
                raise ValueError('meas_bits must carry >= 1 round')
            if cfg.rounds != 1 and cfg.rounds != R:
                raise ValueError(
                    f'cfg.rounds={cfg.rounds} contradicts the meas_bits round '
                    f'axis {R}')
            cfg = replace(cfg, rounds=R)
            if decode is not None:
                decode = as_decode_spec(decode)
                bad = [c for c in decode.cores if not 0 <= c < mp.n_cores]
                if bad:
                    raise ValueError(
                        f'decode.cores {bad} out of range for n_cores='
                        f'{mp.n_cores}')
                if not 0 <= decode.slot < cfg.max_meas:
                    raise ValueError(
                        f'decode.slot={decode.slot} out of range for '
                        f'max_meas={cfg.max_meas}')
            eng = check_supported(mp, cfg, device)
            meas_bits = _pad_meas(meas_bits, cfg.max_meas)
            B, C = meas_bits.shape[1], mp.n_cores
            if init_regs is not None:
                init_regs = torch.as_tensor(init_regs, dtype=torch.int32,
                                            device=device)
                if init_regs.ndim == 3:    # [B, C, R] -> every round's lanes
                    init_regs = init_regs[None].expand(R, *init_regs.shape) \
                        .reshape(R * B, C, isa.N_REGS)
            _count_trace('rounds_trace', (
                R, tuple(meas_bits.shape[1:]), eng, cfg, decode,
                _content_key(mp) if eng != 'generic' else program_traits(mp),
                _device_key(device)))
        with host_span('rounds.exec'):
            out = _run_injected(mp, eng, meas_bits.reshape(R * B, C, -1),
                                init_regs, cfg, device, groups=R)
        if decode is not None:
            with host_span('rounds.decode'):
                # the list index is a blocking copy to the device
                with host_span('h2d.wait'):
                    hist = meas_bits[:, :, list(decode.cores),
                                     decode.slot]
                hist = hist.permute(1, 0, 2).contiguous()
                out['syndrome_hist'] = hist
                out['decoded'] = decode_history(hist, decode.scheme)
        if strict:
            with host_span('rounds.wait'):
                out = _check_strict(out, strict)
        return out


def make_span_runner(step):
    """Wrap a per-batch statistics step (``i -> dict of int64 sums`` on
    the device, batch ``i``'s run) into a span runner: ``run_span(start,
    span)`` runs batches ``start .. start + span - 1`` and folds their
    sums in an on-device carry, so the host fetches once per span (the
    JAX ``make_span_runner``, whose ``lax.scan`` takes the batch key from
    the index as the step here takes its seed).  Integer addition is
    associative, so any span equals the per-batch loop bit for bit.
    Each runner counts its first call of each ``span`` in
    ``span_trace`` (:func:`span_trace_count`), as each span value of the
    JAX runner compiles once."""
    spans = set()

    def run_span(start: int, span: int) -> dict:
        if span not in spans:
            spans.add(span)
            counter_inc('span_trace')
        carry = None
        for i in range(start, start + span):
            stats = step(i)
            carry = stats if carry is None \
                else {k: carry[k] + v for k, v in stats.items()}
        return carry
    return run_span
