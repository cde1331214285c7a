"""IR instruction set.

Each instruction is a small dataclass with a fixed ``name`` tag; the
program-input format is a list of dicts with matching field names
(documented in :mod:`distributed_processor_tpu_torch.compiler`; parity with the
reference circuit format, python/distproc/compiler.py:1-106).  Dicts are
resolved through an explicit registry (:func:`from_dict`) — unknown names
are treated as :class:`Gate` instructions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dfield
from typing import Any

import numpy as np


def _as_scope(scope):
    """Normalise a scope spec (list/tuple/set of channels or qubits) to a set."""
    return set(scope) if scope is not None else None


def resolve_freqname(qubit, freq) -> str | float | None:
    """Phase-tracker name resolution for virtual-z / bind_phase.

    * only ``freq`` given → ``freq`` (name or numeric);
    * only ``qubit`` given → ``'{qubit}.freq'``;
    * both given and freq is a name → ``'{qubit}.{freq}'``.
    """
    if isinstance(qubit, (list, tuple)):
        if len(qubit) != 1:
            raise ValueError('virtual-z instructions address exactly one qubit')
        qubit = qubit[0]
    if qubit is None:
        return freq
    if freq is None:
        return f'{qubit}.freq'
    if isinstance(freq, str):
        return f'{qubit}.{freq}'
    return freq


class Instruction:
    """Base: every IR instruction has a ``name`` and an optional ``scope``."""

    def to_dict(self) -> dict:
        out = {'name': self.name}
        for f in dataclasses.fields(self):
            if f.name in ('name',):
                continue
            val = getattr(self, f.name)
            if val is None:
                continue
            if isinstance(val, set):
                val = sorted(val)
            elif isinstance(val, np.ndarray):
                val = list(val)
            elif isinstance(val, list):
                val = [v.to_dict() if isinstance(v, Instruction) else v
                       for v in val]
            out[f.name] = val
        return out


@dataclass
class Gate(Instruction):
    """A named gate on one or more qubits, resolved via the QChip library."""
    name: str
    qubit: list
    modi: dict = None
    start_time: int = None
    scope: set = None

    def __post_init__(self):
        if isinstance(self.qubit, (str,)):
            self.qubit = [self.qubit]
        elif isinstance(self.qubit, tuple):
            self.qubit = list(self.qubit)
        self.scope = _as_scope(self.scope)

    def to_dict(self) -> dict:
        out = {'name': self.name, 'qubit': self.qubit}
        if self.modi is not None:
            out['modi'] = self.modi
        if self.start_time is not None:
            out['start_time'] = self.start_time
        if self.scope is not None:
            out['scope'] = sorted(self.scope)
        return out


@dataclass
class Pulse(Instruction):
    freq: Any = None            # Hz, freq name, or register name
    twidth: float = None
    env: Any = None             # ndarray of samples, paradict, or list of paradicts
    dest: str = None
    phase: Any = 0
    amp: Any = 1
    start_time: int = None
    tag: str = None
    name: str = dfield(default='pulse', init=False)

    def to_dict(self) -> dict:
        out = {'name': 'pulse', 'freq': self.freq, 'twidth': self.twidth,
               'dest': self.dest, 'phase': self.phase, 'amp': self.amp}
        out['env'] = list(self.env) if isinstance(self.env, np.ndarray) else self.env
        if self.tag is not None:
            out['tag'] = self.tag
        if self.start_time is not None:
            out['start_time'] = self.start_time
        return out


@dataclass
class VirtualZ(Instruction):
    phase: float = None
    qubit: Any = None
    freq: Any = None
    scope: set = None
    name: str = dfield(default='virtual_z', init=False)

    def __post_init__(self):
        self.freq = resolve_freqname(self.qubit, self.freq)
        if isinstance(self.qubit, (list, tuple)):
            self.qubit = self.qubit[0]
        self.scope = _as_scope(self.scope)

    def to_dict(self) -> dict:
        out = {'name': 'virtual_z', 'phase': self.phase, 'freq': self.freq}
        if self.scope is not None:
            out['scope'] = sorted(self.scope)
        return out


@dataclass
class DeclareFreq(Instruction):
    freq: float = None
    scope: set = None
    freqname: str = None
    freq_ind: int = None
    name: str = dfield(default='declare_freq', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class BindPhase(Instruction):
    """Bind a frequency's z-phase to a processor register (hardware virtual-z)."""
    var: str = None
    qubit: Any = None
    freq: Any = None
    scope: set = None
    name: str = dfield(default='bind_phase', init=False)

    def __post_init__(self):
        self.freq = resolve_freqname(self.qubit, self.freq)
        if isinstance(self.qubit, (list, tuple)):
            self.qubit = self.qubit[0]
        self.scope = _as_scope(self.scope)

    def to_dict(self) -> dict:
        out = {'name': 'bind_phase', 'var': self.var, 'freq': self.freq}
        if self.scope is not None:
            out['scope'] = sorted(self.scope)
        return out


@dataclass
class Barrier(Instruction):
    qubit: list = None
    scope: set = None
    name: str = dfield(default='barrier', init=False)


@dataclass
class Delay(Instruction):
    t: float = None
    qubit: list = None
    scope: set = None
    name: str = dfield(default='delay', init=False)


@dataclass
class Idle(Instruction):
    """Stall the core until qclk reaches ``end_time``."""
    end_time: int = None
    qubit: list = None
    scope: set = None
    name: str = dfield(default='idle', init=False)


@dataclass
class Hold(Instruction):
    """Wait until ``nclks`` after the end of the last pulse on ``ref_chans``.

    Resolved into :class:`Idle` by the scheduler.
    """
    nclks: int = None
    ref_chans: Any = None
    qubit: list = None
    scope: set = None
    name: str = dfield(default='hold', init=False)


@dataclass
class Loop(Instruction):
    cond_lhs: Any = None
    alu_cond: str = None
    cond_rhs: str = None
    scope: set = None
    body: list = None
    name: str = dfield(default='loop', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class JumpFproc(Instruction):
    alu_cond: str = None
    cond_lhs: Any = None
    func_id: Any = None
    scope: set = None
    jump_label: str = None
    jump_type: str = None
    name: str = dfield(default='jump_fproc', init=False)

    def __post_init__(self):
        if isinstance(self.func_id, list):
            self.func_id = tuple(self.func_id)
        self.scope = _as_scope(self.scope)


@dataclass
class BranchFproc(Instruction):
    alu_cond: str = None
    cond_lhs: Any = None
    func_id: Any = None
    scope: set = None
    true: list = None
    false: list = None
    name: str = dfield(default='branch_fproc', init=False)

    def __post_init__(self):
        if isinstance(self.func_id, list):
            self.func_id = tuple(self.func_id)
        self.scope = _as_scope(self.scope)


@dataclass
class ReadFproc(Instruction):
    func_id: Any = None
    var: str = None
    scope: set = None
    name: str = dfield(default='read_fproc', init=False)

    def __post_init__(self):
        if isinstance(self.func_id, list):
            self.func_id = tuple(self.func_id)
        self.scope = _as_scope(self.scope)


@dataclass
class AluFproc(Instruction):
    func_id: Any = None
    lhs: Any = None
    op: str = None
    out: str = None
    scope: set = None
    name: str = dfield(default='alu_fproc', init=False)

    def __post_init__(self):
        if isinstance(self.func_id, list):
            self.func_id = tuple(self.func_id)
        self.scope = _as_scope(self.scope)


@dataclass
class JumpLabel(Instruction):
    label: str = None
    scope: set = None
    name: str = dfield(default='jump_label', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class JumpCond(Instruction):
    cond_lhs: Any = None
    alu_cond: str = None
    cond_rhs: str = None
    scope: set = None
    jump_label: str = None
    jump_type: str = None
    name: str = dfield(default='jump_cond', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class BranchVar(Instruction):
    cond_lhs: Any = None
    alu_cond: str = None
    cond_rhs: str = None
    scope: set = None
    true: list = None
    false: list = None
    name: str = dfield(default='branch_var', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class JumpI(Instruction):
    scope: set = None
    jump_label: str = None
    jump_type: str = None
    name: str = dfield(default='jump_i', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class Declare(Instruction):
    var: str = None
    scope: set = None
    dtype: str = 'int'      # 'int', 'phase', or 'amp'
    name: str = dfield(default='declare', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class LoopEnd(Instruction):
    scope: set = None
    loop_label: str = None
    name: str = dfield(default='loop_end', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class Alu(Instruction):
    op: str = None
    lhs: Any = None
    rhs: str = None
    out: str = None
    scope: set = None
    name: str = dfield(default='alu', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


@dataclass
class SetVar(Instruction):
    value: Any = None
    var: str = None
    scope: set = None
    name: str = dfield(default='set_var', init=False)

    def __post_init__(self):
        self.scope = _as_scope(self.scope)


# name → class registry (explicit; no eval/reflection)
INSTRUCTION_CLASSES = {
    'pulse': Pulse,
    'virtual_z': VirtualZ,
    'virtualz': VirtualZ,
    'declare_freq': DeclareFreq,
    'bind_phase': BindPhase,
    'barrier': Barrier,
    'delay': Delay,
    'idle': Idle,
    'hold': Hold,
    'loop': Loop,
    'jump_fproc': JumpFproc,
    'branch_fproc': BranchFproc,
    'read_fproc': ReadFproc,
    'alu_fproc': AluFproc,
    'jump_label': JumpLabel,
    'jump_cond': JumpCond,
    'branch_var': BranchVar,
    'jump_i': JumpI,
    'declare': Declare,
    'loop_end': LoopEnd,
    'alu': Alu,
    'set_var': SetVar,
}


def from_dict(instr: dict) -> Instruction:
    """Resolve an instruction dict to its dataclass; unknown names → Gate."""
    instr = dict(instr)
    name = instr.pop('name')
    cls = INSTRUCTION_CLASSES.get(name)
    if cls is None:
        obj = Gate(name=name, **instr)
    else:
        obj = cls(**instr)
    # recursively resolve nested control-flow bodies
    for attr in ('true', 'false', 'body'):
        sub = getattr(obj, attr, None)
        if sub is not None and sub and isinstance(sub[0], dict):
            setattr(obj, attr, [from_dict(s) for s in sub])
    return obj


def program_from_dicts(instrs: list) -> list:
    return [from_dict(i) if isinstance(i, dict) else i for i in instrs]
