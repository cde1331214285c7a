"""128-bit distributed-processor ISA: encoders, decoders, and the
structure-of-arrays (SoA) decoded form consumed by the interpreter.

The word layout is the binary contract shared with the QubiC gateware
(reference: hdl/instr_params.vh:4-28, hdl/proc.sv:89-103, hdl/pulse_reg.sv:10-12,
python/distproc/command_gen.py:16-48).  Everything else in this module —
the vectorised decoder, the SoA program representation, and the
numpy packing helpers — is designed for the TPU execution path: the
interpreter never touches 128-bit integers, it gathers from the int32
field arrays produced by :func:`decode_soa`.

Command word anatomy (bit positions are LSB-indexed into the 128-bit word):

* ALU-family ops use an 8-bit opcode ``cmd[127:120]`` =
  ``(op5 << 3) | alu_op3`` where bit 3 of the byte (``op5 & 1``) selects
  register (1) vs immediate (0) for ALU input 0.
* Pulse-family ops use only the top 5 bits ``cmd[127:123]``.
* Field positions::

      imm (alu in0, 32b two's complement)  @ 88
      alu in0 reg addr (4b)                @ 116
      alu in1 reg addr (4b)                @ 84
      reg write addr (4b)                  @ 80
      jump addr (8b)                       @ 68
      fproc func id (8b)                   @ 52
      sync barrier id (8b)                 @ 112
      pulse: cmd_time(32b)@5, cfg(4b+1)@37, amp(16b+2)@42,
             freq(9b+2)@60, phase(17b+2)@71, env(24b+2)@90,
             pulse reg addr(4b)@116

  Each pulse parameter carries control bits directly above its value
  field: ``{write_enable, use_register}`` (cfg has only write_enable).
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# opcode tables
# ---------------------------------------------------------------------------

ALU_OPS = {
    'id0': 0b000,
    'add': 0b001,
    'sub': 0b010,
    'eq': 0b011,
    'le': 0b100,
    'ge': 0b101,
    'id1': 0b110,
    'zero': 0b111,
}

# 5-bit primary opcodes (cmd[127:123]); for ALU-family ops the LSB of the
# 5-bit code selects register (1) / immediate (0) input 0.
OPCODES = {
    'pulse_write': 0b10000,
    'pulse_write_trig': 0b10010,
    'reg_alu_i': 0b00010,
    'reg_alu': 0b00011,
    'jump_i': 0b00100,
    'jump_cond_i': 0b00110,
    'jump_cond': 0b00111,
    'alu_fproc_i': 0b01000,
    'alu_fproc': 0b01001,
    'jump_fproc_i': 0b01010,
    'jump_fproc': 0b01011,
    'inc_qclk_i': 0b01100,
    'inc_qclk': 0b01101,
    'sync': 0b01110,
    'done': 0b10100,
    'pulse_reset': 0b10110,
    'idle': 0b11000,
}

CMD_BYTES = 16  # 128-bit commands
N_REGS = 16
REG_BITS = 4

# pulse parameter field widths / positions
PULSE_FIELDS = ('cmd_time', 'cfg', 'amp', 'freq', 'phase', 'env_word')
PULSE_WIDTH = {
    'cmd_time': 32, 'cfg': 4, 'amp': 16, 'freq': 9, 'phase': 17, 'env_word': 24,
}
# each param is followed by its control bits (1 for cfg, 2 for the rest)
PULSE_POS = {'cmd_time': 5}
PULSE_POS['cfg'] = PULSE_POS['cmd_time'] + PULSE_WIDTH['cmd_time']        # 37
PULSE_POS['amp'] = PULSE_POS['cfg'] + PULSE_WIDTH['cfg'] + 1              # 42
PULSE_POS['freq'] = PULSE_POS['amp'] + PULSE_WIDTH['amp'] + 2             # 60
PULSE_POS['phase'] = PULSE_POS['freq'] + PULSE_WIDTH['freq'] + 2          # 71
PULSE_POS['env_word'] = PULSE_POS['phase'] + PULSE_WIDTH['phase'] + 2     # 90

IMM_POS = 88
IN0_REG_POS = 116
IN1_REG_POS = 84
WRITE_REG_POS = 80
JUMP_ADDR_POS = 68
FUNC_ID_POS = 52
BARRIER_ID_POS = 112
PULSE_REG_POS = 116


def twos_complement(value, nbits: int = 32):
    """Two's complement encoding of a signed python int / array of ints."""
    arr = np.asarray(value, dtype=np.int64)
    if np.any((arr > 2 ** (nbits - 1) - 1) | (arr < -(2 ** (nbits - 1)))):
        raise ValueError(f'{value} out of range for {nbits}-bit signed')
    enc = np.where(arr < 0, arr + (1 << nbits), arr)
    if np.isscalar(value) or np.ndim(value) == 0:
        return int(enc)
    return enc


def from_twos_complement(word, nbits: int = 32):
    """Inverse of :func:`twos_complement`."""
    arr = np.asarray(word, dtype=np.int64)
    dec = np.where(arr >= (1 << (nbits - 1)), arr - (1 << nbits), arr)
    if np.isscalar(word) or np.ndim(word) == 0:
        return int(dec)
    return dec


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def pulse_cmd(freq_word=None, freq_regaddr=None, phase_word=None, phase_regaddr=None,
              amp_word=None, amp_regaddr=None, cfg_word=None,
              env_word=None, env_regaddr=None, cmd_time=None) -> int:
    """Encode a pulse command.

    Loads any subset of the five pulse-register parameters (at most one of
    them sourced from a processor register), and — iff ``cmd_time`` is given —
    schedules a trigger at that qclk timestamp (``pulse_write_trig``),
    otherwise only writes the parameters (``pulse_write``).
    """
    cmd = 0
    regaddr = None
    for name, word, reg in (('cfg', cfg_word, None),
                            ('amp', amp_word, amp_regaddr),
                            ('freq', freq_word, freq_regaddr),
                            ('phase', phase_word, phase_regaddr),
                            ('env_word', env_word, env_regaddr)):
        pos, width = PULSE_POS[name], PULSE_WIDTH[name]
        # control bits above the value field: {write_enable, use_register}
        # for amp/freq/phase/env (write_enable is the high bit); cfg has a
        # single write_enable bit
        wen_bit = width if name == 'cfg' else width + 1
        if word is not None:
            if reg is not None:
                raise ValueError(f'{name}: immediate and register are exclusive')
            if not 0 <= int(word) < (1 << width):
                raise ValueError(f'{name} word {word} out of range ({width} bits)')
            cmd += (int(word) + (1 << wen_bit)) << pos
        elif reg is not None:
            if regaddr is not None:
                raise ValueError('at most one pulse parameter may come from a register')
            if not 0 <= int(reg) < N_REGS:
                raise ValueError(f'{name} reg addr {reg} out of range')
            regaddr = int(reg)
            cmd += 0b11 << (pos + width)   # use_register + write_enable
    if regaddr is not None:
        cmd += regaddr << PULSE_REG_POS

    if cmd_time is not None:
        if not 0 <= int(cmd_time) < (1 << 32):
            raise ValueError(f'cmd_time {cmd_time} out of range')
        cmd += int(cmd_time) << PULSE_POS['cmd_time']
        opcode = OPCODES['pulse_write_trig']
    else:
        opcode = OPCODES['pulse_write']
    return cmd + (opcode << 123)


def alu_cmd(optype: str, im_or_reg: str, alu_in0, alu_op: str = None, alu_in1: int = 0,
            write_reg_addr: int = None, jump_cmd_ptr: int = None, func_id: int = None) -> int:
    """Encode any ALU-family command.

    ``optype`` in {reg_alu, jump_cond, alu_fproc, jump_fproc, inc_qclk};
    ``im_or_reg`` 'i' (``alu_in0`` is an immediate) or 'r' (register address).
    """
    cmd = 0
    if optype in ('reg_alu', 'jump_cond'):
        cmd += int(alu_in1) << IN1_REG_POS
    if optype in ('alu_fproc', 'jump_fproc') and func_id is not None:
        cmd += int(func_id) << FUNC_ID_POS
    if optype in ('jump_cond', 'jump_fproc'):
        cmd += int(jump_cmd_ptr) << JUMP_ADDR_POS
    if optype in ('reg_alu', 'alu_fproc'):
        cmd += int(write_reg_addr) << WRITE_REG_POS
    if optype == 'inc_qclk':
        if alu_op not in (None, 'add'):
            raise ValueError('inc_qclk only supports the add ALU op')
        alu_op = 'add'

    if im_or_reg == 'i':
        opkey = optype + '_i'
        cmd += twos_complement(int(alu_in0)) << IMM_POS
    elif im_or_reg == 'r':
        opkey = optype
        cmd += int(alu_in0) << IN0_REG_POS
    else:
        raise ValueError(f"im_or_reg must be 'i' or 'r', got {im_or_reg}")

    opcode = (OPCODES[opkey] << 3) + ALU_OPS[alu_op]
    return cmd + (opcode << 120)


def jump_i(instr_ptr_addr: int) -> int:
    return ((OPCODES['jump_i'] << 3) << 120) + (int(instr_ptr_addr) << JUMP_ADDR_POS)


def idle(cmd_time: int) -> int:
    if not 0 <= int(cmd_time) < (1 << 32):
        raise ValueError(f'idle end time {cmd_time} out of range')
    return (OPCODES['idle'] << 123) + (int(cmd_time) << PULSE_POS['cmd_time'])


def done_cmd() -> int:
    return OPCODES['done'] << 123


def pulse_reset() -> int:
    return OPCODES['pulse_reset'] << 123


def sync(barrier_id: int) -> int:
    return (OPCODES['sync'] << 123) + (int(barrier_id) << BARRIER_ID_POS)


def read_fproc(func_id: int, write_reg_addr: int) -> int:
    """Store the fproc result for ``func_id`` in a register (alu_fproc id1)."""
    return alu_cmd('alu_fproc', 'i', 0, 'id1', write_reg_addr=write_reg_addr,
                   func_id=func_id)


def cmds_to_bytes(cmds) -> bytes:
    """Serialise 128-bit command ints little-endian, 16 bytes each."""
    return b''.join(int(c).to_bytes(CMD_BYTES, 'little') for c in cmds)


def bytes_to_cmds(buf: bytes) -> list[int]:
    if len(buf) % CMD_BYTES:
        raise ValueError('command buffer length must be a multiple of 16 bytes')
    return [int.from_bytes(buf[i:i + CMD_BYTES], 'little')
            for i in range(0, len(buf), CMD_BYTES)]


# ---------------------------------------------------------------------------
# decoder → structure-of-arrays program (interpreter input)
# ---------------------------------------------------------------------------

# instruction kinds for the interpreter's lax.switch
K_PULSE_WRITE = 0
K_PULSE_TRIG = 1
K_REG_ALU = 2
K_JUMP_I = 3
K_JUMP_COND = 4
K_ALU_FPROC = 5
K_JUMP_FPROC = 6
K_INC_QCLK = 7
K_SYNC = 8
K_DONE = 9
K_PULSE_RESET = 10
K_IDLE = 11

N_KINDS = 12

_OP5_TO_KIND = {
    OPCODES['pulse_write']: K_PULSE_WRITE,
    OPCODES['pulse_write_trig']: K_PULSE_TRIG,
    OPCODES['reg_alu_i']: K_REG_ALU,
    OPCODES['reg_alu']: K_REG_ALU,
    OPCODES['jump_i']: K_JUMP_I,
    OPCODES['jump_cond_i']: K_JUMP_COND,
    OPCODES['jump_cond']: K_JUMP_COND,
    OPCODES['alu_fproc_i']: K_ALU_FPROC,
    OPCODES['alu_fproc']: K_ALU_FPROC,
    OPCODES['jump_fproc_i']: K_JUMP_FPROC,
    OPCODES['jump_fproc']: K_JUMP_FPROC,
    OPCODES['inc_qclk_i']: K_INC_QCLK,
    OPCODES['inc_qclk']: K_INC_QCLK,
    OPCODES['sync']: K_SYNC,
    OPCODES['done']: K_DONE,
    OPCODES['pulse_reset']: K_PULSE_RESET,
    OPCODES['idle']: K_IDLE,
    0: K_DONE,  # an all-zero opcode halts the core, like DONE (ctrl.v:382)
}

SOA_FIELDS = (
    'kind', 'alu_op', 'in0_is_reg', 'imm', 'in0_reg', 'in1_reg', 'out_reg',
    'jump_addr', 'func_id', 'barrier', 'cmd_time',
    'p_env', 'p_phase', 'p_freq', 'p_amp', 'p_cfg',
    'p_wen', 'p_regsel', 'p_reg',
)

# bit order of the per-parameter write-enable / register-select masks
PULSE_PARAM_ORDER = ('env', 'phase', 'freq', 'amp', 'cfg')


@dataclass
class SoAProgram:
    """Decoded machine program as parallel int32 field arrays.

    Every field has shape ``[..., n_instr]`` (a leading core axis is added by
    :func:`stack_soa`).  This is the representation the interpreter
    gathers from each step; it never re-decodes bits at trace time.
    """
    kind: np.ndarray
    alu_op: np.ndarray
    in0_is_reg: np.ndarray
    imm: np.ndarray          # signed int32 (two's complement decoded)
    in0_reg: np.ndarray
    in1_reg: np.ndarray
    out_reg: np.ndarray
    jump_addr: np.ndarray
    func_id: np.ndarray
    barrier: np.ndarray
    cmd_time: np.ndarray     # uint32 bit pattern stored in int32
    p_env: np.ndarray
    p_phase: np.ndarray
    p_freq: np.ndarray
    p_amp: np.ndarray
    p_cfg: np.ndarray
    p_wen: np.ndarray        # 5-bit write-enable mask, PULSE_PARAM_ORDER
    p_regsel: np.ndarray     # 5-bit from-register mask
    p_reg: np.ndarray        # source register for the (single) reg param

    @property
    def n_instr(self) -> int:
        return self.kind.shape[-1]

    def asdict(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f) for f in SOA_FIELDS}


def _bits(word: int, pos: int, width: int) -> int:
    return (word >> pos) & ((1 << width) - 1)


def decode_soa(cmds, use_native: bool = True) -> SoAProgram:
    """Decode a command buffer (bytes or list of 128-bit ints) into SoA form
    (the Python path only; ``use_native`` is accepted and ignored)."""
    if isinstance(cmds, (bytes, bytearray)):
        cmds = bytes_to_cmds(bytes(cmds))
    n = len(cmds)
    fields = {f: np.zeros(n, dtype=np.int32) for f in SOA_FIELDS}
    for i, cmd in enumerate(cmds):
        cmd = int(cmd)
        op5 = _bits(cmd, 123, 5)
        if op5 not in _OP5_TO_KIND:
            raise ValueError(f'instruction {i}: unknown opcode {op5:05b}')
        kind = _OP5_TO_KIND[op5]
        fields['kind'][i] = kind
        fields['alu_op'][i] = _bits(cmd, 120, 3)
        fields['in0_is_reg'][i] = op5 & 1 if kind in (
            K_REG_ALU, K_JUMP_COND, K_ALU_FPROC, K_JUMP_FPROC, K_INC_QCLK) else 0
        fields['imm'][i] = from_twos_complement(_bits(cmd, IMM_POS, 32))
        fields['in0_reg'][i] = _bits(cmd, IN0_REG_POS, REG_BITS)
        fields['in1_reg'][i] = _bits(cmd, IN1_REG_POS, REG_BITS)
        fields['out_reg'][i] = _bits(cmd, WRITE_REG_POS, REG_BITS)
        fields['jump_addr'][i] = _bits(cmd, JUMP_ADDR_POS, 8)
        fields['func_id'][i] = _bits(cmd, FUNC_ID_POS, 8)
        fields['barrier'][i] = _bits(cmd, BARRIER_ID_POS, 8)
        # cmd_time doubles as the idle end-time; keep the raw uint32 bit pattern
        fields['cmd_time'][i] = np.uint32(_bits(cmd, PULSE_POS['cmd_time'], 32)).view(np.int32)
        if kind in (K_PULSE_WRITE, K_PULSE_TRIG):
            wen = regsel = 0
            for b, name in enumerate(PULSE_PARAM_ORDER):
                pos, width = PULSE_POS[name if name != 'env' else 'env_word'], \
                    PULSE_WIDTH[name if name != 'env' else 'env_word']
                fields['p_' + name][i] = _bits(cmd, pos, width)
                if name == 'cfg':
                    w, r = _bits(cmd, pos + width, 1), 0
                else:
                    # {write_enable (high), use_register (low)}
                    ctl = _bits(cmd, pos + width, 2)
                    w, r = (ctl >> 1) & 1, ctl & 1
                wen |= w << b
                regsel |= r << b
            fields['p_wen'][i] = wen
            fields['p_regsel'][i] = regsel
            fields['p_reg'][i] = _bits(cmd, PULSE_REG_POS, REG_BITS)
    return SoAProgram(**fields)


def stack_soa(programs: list[SoAProgram], pad_to: int = None) -> SoAProgram:
    """Stack per-core SoA programs into ``[n_cores, n_instr]`` arrays.

    Shorter programs are padded with DONE instructions so a core that runs
    off the end simply halts — same behavior as all-zero command memory.
    """
    n = max(p.n_instr for p in programs)
    if pad_to is not None:
        n = max(n, pad_to)
    out = {f: np.zeros((len(programs), n), dtype=np.int32) for f in SOA_FIELDS}
    out['kind'][:] = K_DONE
    for c, prog in enumerate(programs):
        for f in SOA_FIELDS:
            out[f][c, :prog.n_instr] = getattr(prog, f)
    return SoAProgram(**out)


def shape_bucket(n_instr: int, min_size: int = 8) -> int:
    """Pad target for the multi-program path: ``n_instr`` rounded up to
    the next power of two (floored at ``min_size``).

    The multi-program executor keys its jit cache on array SHAPES, so
    every ensemble padded into the same bucket shares one compiled
    executable — all RB sequences of a depth band, say — and fresh
    random sequences of the same shape never retrace.
    """
    if n_instr <= 0:
        raise ValueError(f'n_instr must be positive, got {n_instr}')
    return max(min_size, 1 << (n_instr - 1).bit_length())


def stack_soa_multi(programs: list[SoAProgram],
                    pad_to: int = None) -> SoAProgram:
    """Stack already-stacked ``[n_cores, n_instr]`` SoA programs into
    ``[n_progs, n_cores, n_instr]`` arrays — the program-as-data tensor
    the multi-program executor vmaps over.

    Shorter programs pad with DONE exactly like :func:`stack_soa`: a
    padded core halts at its original DONE and the trailing rows never
    execute, so padding is semantically invisible.  Every program must
    share one ``n_cores``.
    """
    if not programs:
        raise ValueError('need at least one program to stack')
    n_cores = programs[0].kind.shape[0]
    for p in programs:
        if p.kind.ndim != 2 or p.kind.shape[0] != n_cores:
            raise ValueError(
                f'every program must be [n_cores={n_cores}, n_instr]; '
                f'got shape {p.kind.shape}')
    n = max(p.n_instr for p in programs)
    if pad_to is not None:
        n = max(n, pad_to)
    out = {f: np.zeros((len(programs), n_cores, n), dtype=np.int32)
           for f in SOA_FIELDS}
    out['kind'][:] = K_DONE
    for i, prog in enumerate(programs):
        for f in SOA_FIELDS:
            out[f][i, :, :prog.n_instr] = getattr(prog, f)
    return SoAProgram(**out)


# ---------------------------------------------------------------------------
# CFG block table (the block-compiled interpreter engine's program layout)
# ---------------------------------------------------------------------------

# Kinds that END a straight-line block: anything that branches, blocks on
# another core (fproc read / sync barrier), or otherwise needs the generic
# engine's dynamic dispatch.  K_ALU_FPROC / K_JUMP_FPROC here is what
# makes the block engine sound under EVERY fproc fabric — lut included:
# a read is always served at a boundary step by the generic fabric step
# with gathered producer state (and, under lut, the time-indexed
# meas_time plane), never from inside a superinstruction body
# (sim.interpreter.block_ineligible documents the per-fabric argument).
# DONE is deliberately NOT here: a halted core simply stops executing,
# so DONE rows are handled inline by the block bodies — otherwise the
# DONE padding that equalizes per-core program lengths (stack_soa)
# would shatter every block of a heterogeneous-length program.
BLOCK_TERMINATORS = frozenset(
    {K_JUMP_I, K_JUMP_COND, K_ALU_FPROC, K_JUMP_FPROC, K_SYNC})

# kinds a block body knows how to execute (everything else is a terminator)
BLOCK_BODY_KINDS = frozenset(
    {K_PULSE_WRITE, K_PULSE_TRIG, K_REG_ALU, K_INC_QCLK, K_PULSE_RESET,
     K_IDLE, K_DONE})

# below this, a block saves nothing over the generic boundary step but
# still costs a specialized trace — leave it to the generic engine
BLOCK_MIN_LEN = 2


def build_block_table(soa_or_fields, min_len: int = BLOCK_MIN_LEN):
    """Union-refined block table over a stacked ``[n_cores, n_instr]``
    program: the runtime layout of the block-compiled engine
    (``sim.interpreter._exec_blocks``).

    Block intervals live in the GLOBAL instruction-index space, shared
    by every core (cores of one lane sit at independent ``pc`` values,
    so a per-core table would need a per-core dispatch; a shared table
    needs one).  Boundaries are the union over cores of (a) every
    :data:`BLOCK_TERMINATORS` position and (b) every jump target — so
    no body interval contains, on ANY core, an instruction the body
    cannot execute, and no jump can land mid-body.

    Bodies with identical instruction content (every field, every core)
    are DEDUPLICATED: the engine traces one specialized body per
    distinct content and dispatches lanes onto it by block id, so the
    compile cost scales with the deduped total length, not the program
    length.

    ``soa_or_fields``: a :class:`SoAProgram` (or anything with
    ``.asdict()``) or a ``{field: [n_cores, n_instr] array}`` dict —
    at minimum ``kind`` and ``jump_addr``; ALL supplied fields enter
    the dedup key.

    Returns ``(bid_at, bodies)``: ``bid_at`` int32 ``[n_instr]`` maps a
    body-interval START to its deduplicated body id (−1 everywhere
    else); ``bodies`` is ``[(start, length)]`` per body id, ``start``
    being the representative interval whose rows define the body.
    """
    fields = soa_or_fields.asdict() if hasattr(soa_or_fields, 'asdict') \
        else dict(soa_or_fields)
    kind = np.asarray(fields['kind'])
    jump_addr = np.asarray(fields['jump_addr'])
    if kind.ndim != 2:
        raise ValueError(f'need stacked [n_cores, n_instr] fields; '
                         f'kind has shape {kind.shape}')
    C, N = kind.shape
    term_any = np.zeros(N, dtype=bool)
    for k in BLOCK_TERMINATORS:
        term_any |= np.any(kind == k, axis=0)
    jmask = (kind == K_JUMP_I) | (kind == K_JUMP_COND) \
        | (kind == K_JUMP_FPROC)
    leaders = {0}
    leaders.update(int(t) for t in jump_addr[jmask] if 0 <= int(t) < N)
    leaders.update(int(i) + 1 for i in np.nonzero(term_any)[0]
                   if int(i) + 1 < N)
    bounds = sorted(leaders) + [N]
    names = sorted(fields)
    bid_at = np.full(N, -1, dtype=np.int32)
    bodies: list = []
    index: dict = {}
    for s, e in zip(bounds, bounds[1:]):
        # a terminator position is always the LAST of its segment (its
        # successor is a leader), so the body is the segment minus at
        # most that one trailing instruction
        be = e - 1 if term_any[e - 1] else e
        if be - s < min_len:
            continue
        key = b''.join(
            np.ascontiguousarray(np.asarray(fields[f])[:, s:be]).tobytes()
            for f in names)
        bid = index.get(key)
        if bid is None:
            bid = len(bodies)
            index[key] = bid
            bodies.append((s, be - s))
        bid_at[s] = bid
    return bid_at, bodies


# ---------------------------------------------------------------------------
# human-readable disassembly (debugging / golden tests)
# ---------------------------------------------------------------------------

_KIND_NAMES = {
    K_PULSE_WRITE: 'pulse_write', K_PULSE_TRIG: 'pulse_write_trig',
    K_REG_ALU: 'reg_alu', K_JUMP_I: 'jump_i', K_JUMP_COND: 'jump_cond',
    K_ALU_FPROC: 'alu_fproc', K_JUMP_FPROC: 'jump_fproc',
    K_INC_QCLK: 'inc_qclk', K_SYNC: 'sync', K_DONE: 'done',
    K_PULSE_RESET: 'pulse_reset', K_IDLE: 'idle',
}
_ALU_NAMES = {v: k for k, v in ALU_OPS.items()}


def disassemble(cmds) -> list[dict]:
    """Decode a command buffer into a list of readable instruction dicts."""
    soa = decode_soa(cmds)
    out = []
    for i in range(soa.n_instr):
        kind = int(soa.kind[i])
        d = {'op': _KIND_NAMES[kind]}
        if kind in (K_PULSE_WRITE, K_PULSE_TRIG):
            wen, regsel = int(soa.p_wen[i]), int(soa.p_regsel[i])
            for b, name in enumerate(PULSE_PARAM_ORDER):
                if wen >> b & 1:
                    if regsel >> b & 1:
                        d[name] = ('reg', int(soa.p_reg[i]))
                    else:
                        d[name] = int(getattr(soa, 'p_' + name)[i])
            if kind == K_PULSE_TRIG:
                d['cmd_time'] = int(np.int32(soa.cmd_time[i]).view(np.uint32))
            env = d.pop('env', None)
            if env is not None:
                d['env_word'] = env
                if isinstance(env, int):
                    d['env_start'] = env & 0xfff
                    d['env_length'] = (env >> 12) & 0xfff
        elif kind == K_REG_ALU:
            d.update(alu_op=_ALU_NAMES[int(soa.alu_op[i])],
                     in0=('reg', int(soa.in0_reg[i])) if soa.in0_is_reg[i] else int(soa.imm[i]),
                     in1_reg=int(soa.in1_reg[i]), out_reg=int(soa.out_reg[i]))
        elif kind == K_JUMP_COND:
            d.update(alu_op=_ALU_NAMES[int(soa.alu_op[i])],
                     in0=('reg', int(soa.in0_reg[i])) if soa.in0_is_reg[i] else int(soa.imm[i]),
                     in1_reg=int(soa.in1_reg[i]), jump_addr=int(soa.jump_addr[i]))
        elif kind in (K_ALU_FPROC, K_JUMP_FPROC):
            d.update(alu_op=_ALU_NAMES[int(soa.alu_op[i])],
                     in0=('reg', int(soa.in0_reg[i])) if soa.in0_is_reg[i] else int(soa.imm[i]),
                     func_id=int(soa.func_id[i]))
            if kind == K_JUMP_FPROC:
                d['jump_addr'] = int(soa.jump_addr[i])
            else:
                d['out_reg'] = int(soa.out_reg[i])
        elif kind == K_JUMP_I:
            d['jump_addr'] = int(soa.jump_addr[i])
        elif kind == K_INC_QCLK:
            d['in0'] = ('reg', int(soa.in0_reg[i])) if soa.in0_is_reg[i] else int(soa.imm[i])
        elif kind == K_SYNC:
            d['barrier'] = int(soa.barrier[i])
        elif kind == K_IDLE:
            d['end_time'] = int(np.int32(soa.cmd_time[i]).view(np.uint32))
        out.append(d)
    return out
