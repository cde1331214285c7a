"""Scalar Python golden model of the distributed-processor execution.

A copy of the JAX package's ``sim/oracle.py`` (numpy only), the analog
of the reference's cocotb golden models (reference:
cocotb/proc/test_proc.py:639-653 `evaluate_alu_exp` plus the documented
FSM latency constants, test_proc.py:8-19): a slow, obviously correct
interpreter the batched engines are tested against on randomized
programs.

Timing model
------------
The oracle tracks, per core, the same two quantities the Schedule pass
uses (ir/passes.py `_TimedPass`):

* ``time`` — global clock; the point at which the next instruction may
  issue (``last_instr_end_t`` in the scheduler).  Seeded ``START_NCLKS``.
* ``offset`` — qclk origin: ``qclk = time - offset``.  SYNC resets the
  qclk (offset := release time + QCLK_RST_DELAY); ``inc_qclk`` shifts it.

A triggered pulse fires at global time ``offset + cmd_time`` — the cycle
at which the hardware comparator ``qclk_out == pulse_cmd_time`` matches
(reference: hdl/proc.sv:130-131).  Pulse *times* are therefore exact by
construction; the per-instruction costs only determine whether a trigger
could have been missed (an error, as in hardware, where a passed qclk
would spin for a full 2^32 wrap).

Measurement fabric
------------------
A pulse emitted on the measurement element (rdlo) schedules a
discriminated bit ``meas_latency`` clks after the pulse ends
(reference: python/distproc/hwconfig.py:9 FPROC_MEAS_CLKS).  Fproc reads
support both fabric semantics present in the reference gateware:

* ``'sticky'`` — return the most recent bit latched *at the read time*
  (reference: hdl/fproc_meas.sv:18-19 sticky meas_reg; 0 if none yet);
* ``'fresh'`` — block until the first measurement completing strictly
  after the read was issued (reference: hdl/core_state_mgr.sv:45-56
  WAIT_MEAS).

Reads past the supplied injected-bit budget return 0, matching the
vector engine's zero-padding (the cocotb injection strategy never
supplies fewer bits than the program consumes; padding keeps the two
engines bit-identical when a randomized program over-reads).

All time arithmetic wraps at 32 bits (hardware counter width, matching
the int32 batched engines): ``qclk``/``time``/``offset`` comparisons follow
two's-complement semantics once a timeline passes 2^31.
"""

from __future__ import annotations

import numpy as np

from .. import isa

START_NCLKS = 5       # schedule origin (ir/passes.py START_NCLKS)
# First instruction issues at INIT_TIME: the scheduler's START_NCLKS
# margin covers the initial command fetch plus the phase_reset the
# compiler prepends (cost pulse_regwrite_clks=3; 2 + 3 = START_NCLKS),
# so compiled programs meet their first pulse time by construction.
INIT_TIME = 2
QCLK_RST_DELAY = 4    # sync release -> qclk zero (cocotb test_proc.py:17)
MEAS_LATENCY = 64     # rdlo pulse end -> bit available (hwconfig FPROC_MEAS_CLKS)
# Sticky-fabric race window: hardware serves the latched bit through a
# 2-cycle registered handshake (reference: hdl/fproc_meas.sv:23-34), so
# a measurement landing within this many clks of the read time may or
# may not be included in the latched value on real hardware.  Both
# engines serve the deterministic latched-at-read-time bit AND flag the
# read ('sticky_race' / ERR_STICKY_RACE) so users see the hazard the
# simulation's determinism would otherwise hide (round-1 review item).
STICKY_RACE_MARGIN = 2

MASK32 = 0xffffffff

PULSE_FIELD_MASK = {'env': 0xffffff, 'phase': 0x1ffff, 'freq': 0x1ff,
                    'amp': 0xffff, 'cfg': 0xf}


def _i32(x: int) -> int:
    """Wrap to signed 32-bit (hardware register width)."""
    x &= MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def alu(op: int, in0: int, in1: int) -> int:
    """The 8-op ALU (reference: hdl/alu.v:31-51, hdl/instr_params.vh:5-12)."""
    if op == 0b000:      # id0
        return _i32(in0)
    if op == 0b001:      # add
        return _i32(in0 + in1)
    if op == 0b010:      # sub
        return _i32(in0 - in1)
    if op == 0b011:      # eq
        return int(_i32(in0) == _i32(in1))
    if op == 0b100:      # le: STRICT signed < (alu.v:25-27 — the sign
        return int(_i32(in0) < _i32(in1))     # of in0-in1, oflow-corrected)
    if op == 0b101:      # ge (signed, in0 >= in1 — ~le, alu.v:28)
        return int(_i32(in0) >= _i32(in1))
    if op == 0b110:      # id1
        return _i32(in1)
    if op == 0b111:      # zero
        return 0
    raise ValueError(f'bad alu op {op}')


class OracleCore:
    """State of one core during oracle execution."""

    def __init__(self, n_regs: int = isa.N_REGS):
        self.pc = 0
        self.regs = [0] * n_regs
        self.time = INIT_TIME
        self.offset = 0
        self.done = False
        self.err = []
        self.pulse_params = {k: 0 for k in PULSE_FIELD_MASK}
        self.pulses = []          # emitted pulse dicts
        self.resets = []          # phase-reset times (global)
        self.meas_avail = []      # global times at which bit n becomes valid
        self.meas_trig = []       # global times at which bit n was PRODUCED

    @property
    def qclk(self) -> int:
        return _i32(self.time - self.offset)


def _pulse_dur_clks(env_word: int, spc: int, interp: int) -> int:
    length = (env_word >> 12) & 0xfff
    if length == 0xfff:           # continuous-wave sentinel
        return 0
    nsamp = length * 4
    return -((-nsamp * interp) // spc)


def run_oracle(mp, meas_bits=None, fpga_config=None, fabric: str = 'sticky',
               meas_elem: int = 2, meas_latency: int = MEAS_LATENCY,
               lut_mask=None, lut_table=None,
               max_steps: int = 100000, consumed: set = None) -> dict:
    """Execute a decoded :class:`~..decoder.MachineProgram` scalar-style.

    ``meas_bits``: int array ``[n_cores, n_meas]`` — the discriminated bit
    produced by each core's n-th readout pulse (the testbench-injection
    strategy of the reference's cocotb suite).  ``consumed``: a set the
    run adds the ``(core, slot)`` of every bit a read serves to (the
    reads whose outcome the program's control flow depends on).
    """
    from ..hwconfig import FPGAConfig
    cfg = fpga_config or FPGAConfig()
    soa = mp.soa
    n_cores = mp.n_cores
    meas_bits = np.zeros((n_cores, 0), dtype=int) if meas_bits is None \
        else np.asarray(meas_bits)
    cores = [OracleCore() for _ in range(n_cores)]
    sync_part = mp.sync_participants

    # element geometry per core (for pulse durations)
    def dur_of(c, elem, env_word):
        cfgs = mp.tables[c].elem_cfgs
        if elem >= len(cfgs):
            return 0
        e = cfgs[elem]
        return _pulse_dur_clks(env_word, e.samples_per_clk, e.interp_ratio)

    def _fresh(core: OracleCore, prod: OracleCore, req: int):
        for m, t in enumerate(prod.meas_avail):
            if t > req:
                if consumed is not None:
                    consumed.add((cores.index(prod), m))
                bit = 0 if m >= meas_bits.shape[1] \
                    else int(meas_bits[cores.index(prod), m])   # zero-pad
                return True, bit, max(req, t)
        if prod.done:
            core.err.append('fproc_deadlock')
            return True, 0, req
        return False, 0, 0

    def fproc_read(c: int, core: OracleCore, func_id: int):
        """Return (ready, data, t_ready) for a fproc access at core.time."""
        req = core.time
        if fabric == 'lut':
            # reference: hdl/fproc_lut.sv — id 0: own fresh measurement;
            # id >= 1: syndrome LUT over the masked cores' latest bits
            if func_id == 0:
                return _fresh(core, core, req)
            masked = [i for i in range(n_cores) if lut_mask[i]]
            for i in masked:
                p = cores[i]
                if not p.meas_avail or not (p.done or p.time >= req):
                    return False, 0, 0
            # blocks until every masked input holds a valid bit
            # (meas_lut.sv LUT_WAIT); the served slot is TIME-INDEXED:
            # per producer, the newest bit PRODUCED strictly before the
            # read's required time (a producer at time == req can still
            # fire at trig == req, so the strict compare is what makes
            # the count final once causality clears).  A reader armed
            # before any production (count 0) takes slot 0 — the first
            # recorded bit, fixed once written — matching the
            # gateware's arm-then-accumulate LUT_WAIT behavior.
            addr = 0
            slots = []
            for rank, i in enumerate(masked):
                cnt = sum(1 for t in cores[i].meas_trig if t < req)
                m = max(cnt, 1) - 1
                slots.append((i, m))
                if consumed is not None:
                    consumed.add((i, m))
                if m >= meas_bits.shape[1]:
                    bit = 0               # zero-pad (see module doc)
                else:
                    bit = int(meas_bits[i, m])
                addr |= bit << rank
            t_lut = max(cores[i].meas_avail[m] for i, m in slots)
            return True, (int(lut_table[addr]) >> c) & 1, max(req, t_lut)
        if func_id >= n_cores:
            core.err.append('fproc_id')
            return True, 0, core.time
        prod = cores[func_id]
        if fabric == 'sticky':
            if not (prod.done or prod.time >= req):
                return False, 0, 0
            if any(req - STICKY_RACE_MARGIN < t <= req + STICKY_RACE_MARGIN
                   for t in prod.meas_avail):
                core.err.append('sticky_race')
            m = sum(1 for t in prod.meas_avail if t <= req)
            if consumed is not None and m > 0:
                consumed.add((func_id, m - 1))
            data = int(meas_bits[func_id, m - 1]) \
                if 0 < m <= meas_bits.shape[1] else 0   # zero-pad past budget
            return True, data, req
        elif fabric == 'fresh':
            return _fresh(core, prod, req)
        raise ValueError(f'unknown fabric {fabric!r}')

    for _ in range(max_steps):
        if all(c.done for c in cores):
            break
        # sync barrier resolution: all live participants waiting
        at_sync = [not c.done and soa.kind[i, c.pc] == isa.K_SYNC
                   for i, c in enumerate(cores)]
        if any(at_sync) and all(
                at_sync[i] or cores[i].done
                for i in range(n_cores) if sync_part[i]):
            release = max(c.time for i, c in enumerate(cores) if at_sync[i])
            for i, c in enumerate(cores):
                if sync_part[i] and c.done:
                    c.err.append('sync_done')
                if at_sync[i]:
                    c.offset = _i32(release + QCLK_RST_DELAY)
                    c.time = _i32(release + QCLK_RST_DELAY)
                    c.pc += 1
            continue

        progressed = False
        for ci, c in enumerate(cores):
            if c.done:
                continue
            i = c.pc
            kind = int(soa.kind[ci, i])
            if kind == isa.K_SYNC:
                continue   # handled collectively above
            progressed = True

            if kind in (isa.K_PULSE_WRITE, isa.K_PULSE_TRIG):
                wen, regsel = int(soa.p_wen[ci, i]), int(soa.p_regsel[ci, i])
                for b, name in enumerate(isa.PULSE_PARAM_ORDER):
                    if wen >> b & 1:
                        if regsel >> b & 1:
                            val = c.regs[int(soa.p_reg[ci, i])]
                        else:
                            val = int(getattr(soa, 'p_' + name)[ci, i])
                        c.pulse_params[name] = val & PULSE_FIELD_MASK[name]
                if kind == isa.K_PULSE_TRIG:
                    cmd_time = int(np.int64(soa.cmd_time[ci, i]) & MASK32)
                    trig = _i32(c.offset + cmd_time)
                    if trig < c.time:
                        c.err.append('missed_trig')
                        trig = c.time
                    elem = c.pulse_params['cfg'] & 0b11
                    dur = dur_of(ci, elem, c.pulse_params['env'])
                    c.pulses.append(dict(c.pulse_params, qtime=_i32(cmd_time),
                                         gtime=trig, elem=elem, dur=dur))
                    if elem == meas_elem:
                        c.meas_avail.append(_i32(trig + dur + meas_latency))
                        c.meas_trig.append(_i32(trig))
                    c.time = _i32(trig + cfg.pulse_load_clks)
                else:
                    c.time = _i32(c.time + cfg.pulse_regwrite_clks)
                c.pc += 1

            elif kind == isa.K_REG_ALU:
                in0 = c.regs[int(soa.in0_reg[ci, i])] if soa.in0_is_reg[ci, i] \
                    else int(soa.imm[ci, i])
                in1 = c.regs[int(soa.in1_reg[ci, i])]
                c.regs[int(soa.out_reg[ci, i])] = alu(int(soa.alu_op[ci, i]), in0, in1)
                c.time = _i32(c.time + cfg.alu_instr_clks)
                c.pc += 1

            elif kind == isa.K_JUMP_I:
                c.time = _i32(c.time + cfg.jump_cond_clks)
                c.pc = int(soa.jump_addr[ci, i])

            elif kind == isa.K_JUMP_COND:
                in0 = c.regs[int(soa.in0_reg[ci, i])] if soa.in0_is_reg[ci, i] \
                    else int(soa.imm[ci, i])
                in1 = c.regs[int(soa.in1_reg[ci, i])]
                res = alu(int(soa.alu_op[ci, i]), in0, in1)
                c.time = _i32(c.time + cfg.jump_cond_clks)
                c.pc = int(soa.jump_addr[ci, i]) if res & 1 else c.pc + 1

            elif kind in (isa.K_ALU_FPROC, isa.K_JUMP_FPROC):
                ready, data, t_ready = fproc_read(ci, c, int(soa.func_id[ci, i]))
                if not ready:
                    continue            # spin; producer advances next step
                in0 = c.regs[int(soa.in0_reg[ci, i])] if soa.in0_is_reg[ci, i] \
                    else int(soa.imm[ci, i])
                res = alu(int(soa.alu_op[ci, i]), in0, data)
                c.time = _i32(t_ready + cfg.jump_fproc_clks)
                if kind == isa.K_ALU_FPROC:
                    c.regs[int(soa.out_reg[ci, i])] = res
                    c.pc += 1
                else:
                    c.pc = int(soa.jump_addr[ci, i]) if res & 1 else c.pc + 1

            elif kind == isa.K_INC_QCLK:
                in0 = c.regs[int(soa.in0_reg[ci, i])] if soa.in0_is_reg[ci, i] \
                    else int(soa.imm[ci, i])
                # qclk loads the ALU result (in1 = current qclk) with the
                # hardware pipeline compensation (reference: hdl/qclk.v:17)
                c.offset = _i32(c.time - alu(int(soa.alu_op[ci, i]), in0, c.qclk))
                c.time = _i32(c.time + cfg.alu_instr_clks)
                c.pc += 1

            elif kind == isa.K_DONE:
                c.done = True

            elif kind == isa.K_PULSE_RESET:
                c.resets.append(c.time)
                c.time = _i32(c.time + cfg.pulse_regwrite_clks)
                c.pc += 1

            elif kind == isa.K_IDLE:
                end = _i32(c.offset + int(np.int64(soa.cmd_time[ci, i]) & MASK32))
                if c.time > end:
                    c.err.append('missed_idle')
                    end = c.time
                c.time = _i32(end + cfg.pulse_load_clks)
                c.pc += 1

            else:
                raise ValueError(f'core {ci}: bad kind {kind}')
        if not progressed and not all(c.done for c in cores):
            # every live core is blocked on fproc (or an unresolvable sync)
            for c in cores:
                if not c.done:
                    c.err.append('deadlock')
            break

    return {
        'pulses': [c.pulses for c in cores],
        'resets': [c.resets for c in cores],
        'regs': np.array([c.regs for c in cores]),
        'time': np.array([c.time for c in cores]),
        'qclk': np.array([c.qclk for c in cores]),
        'done': np.array([c.done for c in cores]),
        'err': [c.err for c in cores],
        'meas_avail': [c.meas_avail for c in cores],
        'meas_time': [c.meas_trig for c in cores],
    }
