"""Batched PyTorch interpreter for the distributed-processor ISA: the
generic fetch-dispatch engine.

Counterpart of ``distributed_processor_tpu/sim/interpreter.py`` (the
JAX engine, which is the reference).  Every core of every shot advances
one *instruction* per step, with the machine state held in int32 tensors
shaped ``[n_shots, n_cores, ...]``; the sync barrier and the measurement
(fproc) fabric are masked reductions over the core axis each step
(reference gateware: hdl/sync_iface.sv, hdl/fproc_meas.sv,
hdl/core_state_mgr.sv).

What differs from the JAX engine is only the formulation: the step loop
is a Python ``while`` whose condition is read with one ``.item()`` per
step, and dynamic indexing (program fetch by pc, register reads, fproc
producer selection) uses ``torch.gather``/indexing where the JAX engine
uses one-hot multiply-reduce for the TPU's vector unit.  The contract is
identical integers: every output key, ``err`` and ``fault`` included,
matches the JAX ``engine='generic'`` run on the same injected bits
(tests/test_torch_interpreter.py).

Scope of this engine: the parity device and physics mode, the
``'sticky'`` and ``'fresh'`` fabrics.  Everything else raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import isa

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


def not_ported(what: str, item: int):
    """The error for a feature a later slice of the port brings."""
    return NotImplementedError(
        f'{what} is not ported to the torch package yet '
        f'(ROADMAP.md, queue 1, item {item})')


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
    bits = torch.tensor([bit for _, bit in FAULT_CODES], dtype=torch.int32,
                        device=fault.device)
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
    in both packages.  Fields that select an engine or feature this
    package does not port yet raise when a run uses them; the carry
    layout knobs (``steps_per_iter``, ``packed_ctrl``,
    ``pallas_interpret``, ``packed_carry``) leave the generic engine's
    results unchanged and are accepted as no-ops."""
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


ENGINES = ('auto', 'generic', 'block', 'straightline', 'pallas', 'fused')


def resolve_engine(mp, cfg: InterpreterConfig) -> str:
    """The engine a run takes.  The generic engine is the only one this
    package has: ``engine=None``/``'generic'``/``'auto'`` with
    ``straightline`` None or False resolve to it (the JAX package holds
    every engine bit-identical to the generic one); the specialized
    engines raise."""
    if cfg.engine is not None and cfg.engine not in ENGINES:
        raise ValueError(f'unknown engine {cfg.engine!r}; one of '
                         f'{ENGINES} or None')
    if cfg.engine == 'straightline' or cfg.straightline is True:
        raise not_ported('the straight-line engine', 1)
    if cfg.engine == 'block':
        raise not_ported('the block engine', 8)
    if cfg.engine in ('pallas', 'fused'):
        raise not_ported(f'engine={cfg.engine!r} (the megastep kernel)', 5)
    return 'generic'


def _check_fabric(cfg: InterpreterConfig) -> None:
    if cfg.fabric == 'lut':
        raise not_ported("fabric='lut'", 2)
    if cfg.fabric not in ('sticky', 'fresh'):
        raise ValueError(f"unknown fabric {cfg.fabric!r}; one of "
                         f"'sticky', 'fresh', 'lut'")


def check_supported(mp, cfg: InterpreterConfig) -> None:
    """Raise for what this slice of the port leaves out."""
    resolve_engine(mp, cfg)
    _check_fabric(cfg)
    if cfg.trace:
        raise not_ported('trace=True', 12)
    if cfg.physics and cfg.device != 'parity':
        raise not_ported(f'device={cfg.device!r}', 4)
    if cfg.cores_axis is not None:
        raise not_ported('cores_axis', 9)
    if cfg.rounds != 1:
        raise not_ported(f'rounds={cfg.rounds}', 8)


def program_traits(mp) -> tuple:
    """Static program facts that let the step body skip whole blocks the
    program cannot exercise: ``(frozenset of instruction kinds, any
    in0-from-reg, any pulse-param-from-reg)``."""
    soa = mp.soa
    return (frozenset(int(k) for k in np.unique(np.asarray(soa.kind))),
            bool(np.any(np.asarray(soa.in0_is_reg))),
            bool(np.any(np.asarray(soa.p_regsel))))


def _program_constants(mp, device):
    """The decoded program as device tensors: the packed ``[C, N, F]``
    instruction table, per-element samples-per-clock and interpolation
    ``[C, E]``, and the sync participants ``[C]``."""
    soa = torch.as_tensor(np.stack(
        [np.asarray(getattr(mp.soa, f)) for f in _FIELDS], axis=-1)
        .astype(np.int32), device=device)
    n_cores = mp.n_cores
    max_elems = max((len(t.elem_cfgs) for t in mp.tables), default=0) or 1
    spc = np.ones((n_cores, max_elems), dtype=np.int32)
    interp = np.zeros((n_cores, max_elems), dtype=np.int32)
    for c, t in enumerate(mp.tables):
        for e, ec in enumerate(t.elem_cfgs):
            spc[c, e] = ec.samples_per_clk
            interp[c, e] = ec.interp_ratio
    return (soa, torch.as_tensor(spc, device=device),
            torch.as_tensor(interp, device=device),
            torch.as_tensor(np.asarray(mp.sync_participants), device=device))


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
    if cfg.record_pulses:
        st['rec'] = z(B, C, len(_REC_FIELDS), P)
    if cfg.opcode_histogram:
        st['op_hist'] = z(B, C, isa.N_KINDS)
    if cfg.physics:
        # measurement records for the epoch resolver (sim/physics.py)
        # plus the parity device's quarter-turn counter
        st.update(meas_state=z(B, C, M), meas_amp=z(B, C, M),
                  meas_phase=z(B, C, M), meas_freq=z(B, C, M),
                  meas_env=z(B, C, M), meas_gtime=z(B, C, M),
                  phys_wait=torch.zeros((B, C), dtype=torch.bool,
                                        device=device),
                  qturns=z(B, C))
    return st


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


def _step(st: dict, soa, spc, interp, sync_part, meas_bits, meas_valid,
          cfg: InterpreterConfig, traits) -> dict:
    """One instruction step of every live (shot, core) lane — the JAX
    ``_step`` for the parity device and the sticky/fresh fabrics."""
    B, C = st['pc'].shape
    N = soa.shape[1]
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
    fetched = soa[core_idx, pc_idx]                           # [B, C, F]
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
        fid_bad = fid >= C
        prod = fid.clamp(0, C - 1).long()                     # [B, C]
        sel = lambda arr: arr.gather(1, prod)                 # [B,C]->[B,C]
        prod_m = prod.unsqueeze(-1).expand(B, C, M)
        sel_m = lambda arr: arr.gather(1, prod_m)             # [B,C,M]
        mavail_p = sel_m(st['meas_avail'])
        bits_p = sel_m(meas_bits)
        valid_p = sel_m(meas_valid)
        if cfg.fabric == 'sticky':
            # bit latched at read time; the producer must have simulated
            # past `req`
            f_time_ok = sel(st['done']) | (sel(time) >= req)
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
        else:   # 'fresh': first measurement completing after the request
            fresh = (mavail_p > req[..., None]) & (
                torch.arange(M, device=dev)[None, None, :]
                < sel(st['n_meas'])[..., None])
            exists = fresh.any(-1)
            j = fresh.to(i32).argmax(-1)
            sel_valid = _take(valid_p, j)
            ready = exists & sel_valid
            f_phys = exists & ~sel_valid
            f_data = torch.where(ready, _take(bits_p, j), 0)
            f_tready = torch.where(
                ready, torch.maximum(req, _take(mavail_p, j)), req)
            f_deadlock = ~exists & sel(st['done'])
            f_ready = ready | f_deadlock
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

    # ---- sync barrier (reference: ctrl.v:510-552 + qclk reset) ---------
    if has_sync:
        at_sync = live & (kind == isa.K_SYNC)
        live_part = sync_part[None, :] & ~st['done']
        sync_ready = at_sync.any(-1) & (~live_part | at_sync).all(-1)
        release = torch.where(at_sync, time, -INT32_MAX).amax(
            -1, keepdim=True) + QCLK_RST_DELAY                     # [B, 1]
        sync_adv = at_sync & sync_ready[:, None]
        sync_err = sync_ready & (sync_part[None, :] & st['done']).any(-1)

    # ---- stall mask ----------------------------------------------------
    stalled = is_fproc & ~f_ready
    if has_sync:
        stalled = stalled | (at_sync & ~sync_ready[:, None])
    adv = live & ~stalled                     # cores executing this step

    # ---- pulse-register latch + trigger --------------------------------
    is_pw = kind == isa.K_PULSE_WRITE
    is_pt = kind == isa.K_PULSE_TRIG
    is_pulse = (is_pw | is_pt) & adv
    imm_vals = torch.stack([g('p_env'), g('p_phase'), g('p_freq'),
                            g('p_amp'), g('p_cfg')], dim=-1)     # [B, C, 5]
    five = torch.arange(5, dtype=i32, device=dev)
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
    n_meas = st['n_meas'] + is_meas_pulse.to(i32)

    # ---- physics co-state: parity device + measurement records --------
    cw_meas_err = 0
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
        # parity device: each drive pulse adds round(amp / x90) quarter
        # turns; the state bit is the half-turn parity
        qturns = st['qturns']
        if cfg.x90_amp > 0:
            x90 = cfg.x90_amp
            dq = torch.div(2 * pp[..., 3] + x90, 2 * x90,
                           rounding_mode='floor')
            qturns = qturns + torch.where(fire & (elem == cfg.drive_elem),
                                          dq, 0)
        state_bit = (qturns >> 1) & 1
        upd.update(
            qturns=qturns,
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

    err = st['err'] | rec_of | meas_of | cw_meas_err \
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

    return dict(st, pc=pc_next, regs=regs, time=time_next,
                offset=offset_next, done=st['done'] | is_done, err=err,
                fault=fault, pp=pp, n_pulses=n_pulses, n_resets=n_resets,
                rst_time=rst_time, n_meas=n_meas, meas_avail=meas_avail,
                **upd), stall_sync


def _exec_loop(st: dict, steps: int, paused, soa, spc, interp, sync_part,
               meas_bits, meas_valid, cfg: InterpreterConfig, traits):
    """Step until every shot is done or, in physics mode, paused waiting
    for a measurement bit the epoch resolver has not produced yet.
    ``steps`` is the step count so far (the budget is shared across
    physics epochs); returns ``(st, steps, paused)``."""
    while steps < cfg.max_steps:
        settled = st['done'].all(-1)
        if cfg.physics:
            settled = settled | paused
        if bool(settled.all()):
            break
        st2, stall_sync = _step(st, soa, spc, interp, sync_part, meas_bits,
                                meas_valid, cfg, traits)
        # quiescence per shot: no live core changed state
        same = ((st2['pc'] == st['pc']) & (st2['time'] == st['time'])
                & (st2['done'] == st['done'])).all(-1)            # [B]
        if cfg.physics:
            # quiescent with a core awaiting an unresolved bit = pause
            # for the resolver; quiescent without one is a deadlock
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
        st = st2
        steps += 1
    return st, steps, paused


def _finalize(st: dict, steps: int, cfg: InterpreterConfig) -> dict:
    dev = st['pc'].device
    if cfg.record_pulses:
        rec = st.pop('rec')
        st.update({'rec_' + n: rec[:, :, i, :].contiguous()
                   for i, n in enumerate(_REC_FIELDS)})
    if 'op_hist' in st:
        st['op_hist'] = st['op_hist'].sum((0, 1), dtype=torch.int32)
    st['qclk'] = st['time'] - st['offset']
    st['steps'] = torch.tensor(steps, dtype=torch.int32, device=dev)
    st['incomplete'] = ~st['done'].all()
    # a lane still live after every loop returned ran out of budget
    st['fault'] = st['fault'] | _bit(~st['done'], FAULT_BUDGET_EXHAUSTED)
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
    check_supported(mp, cfg)
    cfg, strict = _fault_policy(cfg)
    soa, spc, interp, sync_part = _program_constants(mp, device)
    meas_bits = _pad_meas(torch.as_tensor(meas_bits, dtype=torch.int32,
                                          device=device), cfg.max_meas)
    B = meas_bits.shape[0]
    st = _init_state(B, mp.n_cores, cfg, init_regs, device)
    meas_valid = torch.ones(meas_bits.shape, dtype=torch.bool, device=device)
    paused = torch.zeros((B,), dtype=torch.bool, device=device)
    st, steps, _ = _exec_loop(st, 0, paused, soa, spc, interp, sync_part,
                              meas_bits, meas_valid, cfg, program_traits(mp))
    st.pop('phys_wait', None)
    return _check_strict(_finalize(st, steps, cfg), strict)
