"""OpenQASM 3 -> native program translation.

Equivalent of the reference's ``QASMQubiCVisitor`` (reference:
python/distproc/openqasm/visitor.py:41-149), driven by the built-in
parser instead of the external ``openqasm3`` package:

* qubit declarations map through a :class:`~.gate_map.QubitMap`;
* gate calls map through a :class:`~.gate_map.GateMap`;
* ``reset`` expands to the read + branch_fproc active-reset idiom
  (reference: visitor.py:86-92);
* ``c[i] = measure q[j]`` emits a read and records which qubit feeds
  each classical bit, so later ``if (c[i] == v)`` branches become
  measurement branches (``branch_fproc``) — the part the reference left
  unfinished (visitor.py:113-119 "BranchingStatement unfinished");
* classical declarations/assignments become declare/set_var/alu chains
  with temporaries for nested expressions (reference: visitor.py:121-147).
"""

from __future__ import annotations

import numpy as np

from . import qasm_parser as qp
from .gate_map import GateMap, DefaultGateMap, QubitMap, DefaultQubitMap

_CMP_FLIP = {'==': '==', '<=': '>=', '>=': '<=', '<': '>', '>': '<'}


def _fold_nonstrict(op: str, const: int) -> int:
    """Fold ``const <= x`` / ``const > x`` onto the hardware's STRICT
    comparisons (alu.v:25-27: le is signed <, ge is >=):
    ``const <= x == const-1 < x``; ``const > x == const-1 >= x``.
    Rejects the INT32_MIN edge where the folded constant leaves the
    32-bit range (the condition is then trivial — drop it instead)."""
    if const == -2**31:
        raise QASMTranslationError(
            f'{op!r} against INT32_MIN folds out of the 32-bit range '
            f'(the condition is trivially '
            f'{"true" if op == "<=" else "false"} — drop it)')
    return const - 1


class QASMTranslationError(ValueError):
    pass


class QASMTranslator:
    """Stateful translator: one instance per QASM program."""

    def __init__(self, gate_map: GateMap = None, qubit_map: QubitMap = None):
        self.gate_map = gate_map or DefaultGateMap()
        self.qubit_map = qubit_map or DefaultQubitMap()
        self.qubit_regs: dict[str, int] = {}     # register name -> size
        self.bit_regs: dict[str, int] = {}
        self.int_vars: set[str] = set()
        self.bit_sources: dict[tuple, str] = {}  # (reg, idx) -> qubit name
        # QASM3 loop variables are loop-scoped: shadowing names map to
        # unique internal vars for the body's duration; sequential
        # sibling loops reuse one minted var (one hardware register)
        self._var_alias: dict[str, str] = {}
        self._loop_minted: dict[tuple, str] = {}
        self._tmp = 0

    # -- public ----------------------------------------------------------

    def translate(self, src: str) -> list[dict]:
        stmts = qp.parse_qasm(src)
        out = []
        for s in stmts:
            out.extend(self._stmt(s))
        return out

    # -- helpers ---------------------------------------------------------

    @property
    def all_qubits(self) -> list[str]:
        return [self.qubit_map.get_hardware_qubit(reg, i)
                for reg, size in self.qubit_regs.items()
                for i in range(size)]

    def _qubit(self, ref: qp.Ref) -> str:
        if ref.name not in self.qubit_regs:
            raise QASMTranslationError(f'{ref.name!r} is not a qubit register')
        return self.qubit_map.get_hardware_qubit(ref.name, ref.index)

    def _qubits_of(self, ref: qp.Ref) -> list[str]:
        """One hardware qubit for an indexed ref; the whole register for
        a bare-register ref (``delay[...] q;`` touches every qubit)."""
        if ref.index is None:
            if ref.name not in self.qubit_regs:
                raise QASMTranslationError(
                    f'{ref.name!r} is not a qubit register')
            return [self.qubit_map.get_hardware_qubit(ref.name, i)
                    for i in range(self.qubit_regs[ref.name])]
        return [self._qubit(ref)]

    def _tmpvar(self) -> str:
        self._tmp += 1
        return f'_qasm_tmp{self._tmp}'

    def _varname(self, name: str) -> str:
        """Resolve a source-level variable through active loop aliases."""
        return self._var_alias.get(name, name)

    def _operands_or_all(self, operands) -> list[str]:
        return [q for r in operands for q in self._qubits_of(r)] \
            or self.all_qubits

    # -- statements ------------------------------------------------------

    def _stmt(self, s) -> list[dict]:
        if isinstance(s, qp.Decl):
            return self._decl(s)
        if isinstance(s, qp.GateCall):
            qubits = [self._qubit(r) for r in s.operands]
            params = [self._const_expr(p) for p in s.params]
            return self.gate_map.get_qubic_gateinstr(s.name, qubits, params)
        if isinstance(s, qp.Reset):
            q = self._qubit(s.target)
            return [{'name': 'read', 'qubit': [q]},
                    {'name': 'branch_fproc', 'alu_cond': 'eq', 'cond_lhs': 1,
                     'func_id': f'{q}.meas', 'scope': [q],
                     'true': [{'name': 'X90', 'qubit': [q]},
                              {'name': 'X90', 'qubit': [q]}],
                     'false': []}]
        if isinstance(s, qp.Measure):
            q = self._qubit(s.target)
            if s.out is not None:
                if s.out.name not in self.bit_regs:
                    raise QASMTranslationError(
                        f'{s.out.name!r} is not a bit register')
                self.bit_sources[(s.out.name, s.out.index)] = q
            return [{'name': 'read', 'qubit': [q]}]
        if isinstance(s, qp.Barrier):
            return [{'name': 'barrier',
                     'qubit': self._operands_or_all(s.operands)}]
        if isinstance(s, qp.Assign):
            return self._assign(s)
        if isinstance(s, qp.If):
            return self._if(s)
        if isinstance(s, qp.For):
            return self._for(s)
        if isinstance(s, qp.While):
            return self._while(s)
        if isinstance(s, qp.Delay):
            return [{'name': 'delay', 't': s.duration,
                     'qubit': self._operands_or_all(s.operands)}]
        raise QASMTranslationError(f'unsupported statement {s}')

    def _decl(self, s: qp.Decl) -> list[dict]:
        if s.kind == 'qubit':
            self.qubit_regs[s.name] = s.size or 1
            return []
        if s.kind == 'bit':
            self.bit_regs[s.name] = s.size or 1
            return []
        # classical int/float variable
        self.int_vars.add(s.name)
        out = [{'name': 'declare', 'var': s.name, 'dtype': 'int',
                'scope': self.all_qubits}]
        if s.init is not None:
            pre, val = self._expr(s.init)
            out.extend(pre)
            out.append({'name': 'set_var', 'var': s.name, 'value': val})
        return out

    def _assign(self, s: qp.Assign) -> list[dict]:
        target = self._varname(s.target.name)
        if target not in self.int_vars:
            raise QASMTranslationError(
                f'{s.target.name!r} is not a declared variable')
        pre, val = self._expr(s.expr)
        if isinstance(val, str) or not pre:
            # simple value or variable: set_var / alu-into-target
            if pre and pre[-1].get('out') is not None:
                pre[-1]['out'] = target
                return pre
            return pre + [{'name': 'set_var', 'var': target,
                           'value': val}]
        pre[-1]['out'] = target
        return pre

    def _if(self, s: qp.If) -> list[dict]:
        if s.op not in _CMP_FLIP:
            raise QASMTranslationError(
                f'only ==/<=/>=/</> conditions supported, got {s.op!r}')
        op = s.op
        true = [i for st in s.true for i in self._stmt(st)]
        false = [i for st in s.false for i in self._stmt(st)]
        lhs, rhs = s.lhs, s.rhs
        # normalise: measured-bit or variable on the right, flipping the
        # comparison direction with the operand swap
        if isinstance(lhs, qp.Ref) and not isinstance(rhs, qp.Ref):
            lhs, rhs, op = rhs, lhs, _CMP_FLIP[op]
        if not isinstance(rhs, qp.Ref):
            raise QASMTranslationError('condition must involve a bit or var')
        # prefer constant folding (negative literals parse as BinOp(0-n))
        # so <=/> can fold into the constant; fall back to a register
        if isinstance(lhs, (qp.Ref, qp.BinOp)):
            try:
                pre, lhs_val = [], self._const_expr(lhs)
            except QASMTranslationError:
                pre, lhs_val = self._expr(lhs)
        else:
            pre, lhs_val = [], lhs
        # hardware triple is "lhs_val <alu_cond> rhs": le is STRICT
        # signed < (alu.v:25-27), so <=/> fold into an integer constant
        if op in ('==', '<', '>='):
            cond = {'==': 'eq', '<': 'le', '>=': 'ge'}[op]
        elif isinstance(lhs_val, (int, float)):
            if lhs_val != int(lhs_val):
                raise QASMTranslationError(
                    f'{op!r} against non-integer constant {lhs_val!r}: '
                    f'hardware comparisons are 32-bit integer')
            lhs_val = _fold_nonstrict(op, int(lhs_val))
            cond = 'le' if op == '<=' else 'ge'
        elif self._varname(rhs.name) in self.int_vars:
            # var-vs-var <=/>: swap operands with the flipped STRICT
            # complement — "a <= y" == "y >= a", "a > y" == "y < a" —
            # branch_var takes variables on both sides
            return pre + [{'name': 'branch_var',
                           'alu_cond': 'ge' if op == '<=' else 'le',
                           'cond_lhs': self._varname(rhs.name),
                           'cond_rhs': lhs_val,
                           'scope': self.all_qubits,
                           'true': true, 'false': false}]
        else:
            raise QASMTranslationError(
                f'{op!r} against a measured bit needs a constant side '
                f'(hardware le/ge are </>=)')
        key = (rhs.name, rhs.index)
        if key in self.bit_sources:          # measurement branch
            q = self.bit_sources[key]
            return pre + [{'name': 'branch_fproc', 'alu_cond': cond,
                           'cond_lhs': lhs_val, 'func_id': f'{q}.meas',
                           'scope': self.all_qubits,
                           'true': true, 'false': false}]
        if self._varname(rhs.name) in self.int_vars:   # variable branch
            return pre + [{'name': 'branch_var', 'alu_cond': cond,
                           'cond_lhs': lhs_val,
                           'cond_rhs': self._varname(rhs.name),
                           'scope': self.all_qubits,
                           'true': true, 'false': false}]
        raise QASMTranslationError(
            f'{rhs.name!r} is neither a measured bit nor a variable')

    def _loop_cond(self, lhs, op: str, rhs) -> tuple[int, str, str]:
        """Normalise a comparison to the hardware loop/branch triple
        ``(cond_lhs const, alu_cond in eq/ge/le, cond_rhs var)``.
        Strict comparisons fold into the integer constant (``x < K`` ==
        ``K-1 >= x``)."""
        if isinstance(lhs, qp.Ref) and self._varname(lhs.name) \
                in self.int_vars:
            if isinstance(rhs, qp.Ref):
                raise QASMTranslationError(
                    'loop conditions need one constant side')
            lhs, rhs, op = rhs, lhs, _CMP_FLIP.get(op, op)
        if not (isinstance(rhs, qp.Ref)
                and self._varname(rhs.name) in self.int_vars):
            raise QASMTranslationError(
                'loop condition must compare a declared variable')
        var = self._varname(rhs.name)
        const = self._const_expr(lhs)
        if const != int(const):
            raise QASMTranslationError('loop bounds must be integers')
        const = int(const)
        # condition is "const <alu_cond> var"; hardware le is STRICT
        # signed < (reference: hdl/alu.v:25-27), ge is >=, so the
        # non-native comparisons fold into the integer constant
        if op == '==':
            return const, 'eq', var
        if op == '<':
            return const, 'le', var
        if op == '>=':
            return const, 'ge', var
        if op in ('<=', '>'):
            return _fold_nonstrict(op, const), \
                ('le' if op == '<=' else 'ge'), var
        raise QASMTranslationError(f'unsupported loop comparison {op!r}')

    def _for(self, s: qp.For) -> list[dict]:
        """``for i in [a:step:b]`` -> hardware counter loop (the
        reference's loop instruction; the back-edge tests after each
        iteration, so a statically-empty range lowers to a no-op).
        The loop variable is loop-scoped per QASM3: shadowing an outer
        name maps it to a unique internal var for the body."""
        start = int(self._const_expr(s.start))
        step = int(self._const_expr(s.step))
        stop = int(self._const_expr(s.stop))
        if step == 0:
            raise QASMTranslationError('range step must be nonzero')
        if stop < start if step > 0 else stop > start:
            return []                        # statically empty: zero trips
        # minted vars are keyed by (enclosing alias context, name):
        # sequential siblings — at any nesting depth — share one
        # register (fresh vars per loop would exhaust the 16-register
        # file; set_var re-seeds it), while genuine shadowing (an
        # enclosing loop or a user variable owns the name) mints a
        # distinct internal var
        ctx = (self._var_alias.get(s.var), s.var)
        if ctx in self._loop_minted:
            var = self._loop_minted[ctx]
        elif ctx[0] is not None or s.var in self.int_vars:
            self._tmp += 1
            var = f'{s.var}__loop{self._tmp}'
            self._loop_minted[ctx] = var
        else:
            var = s.var
            self._loop_minted[ctx] = var
        declare = []
        if var not in self.int_vars:
            self.int_vars.add(var)
            declare = [{'name': 'declare', 'var': var, 'dtype': 'int',
                        'scope': self.all_qubits}]
        outer = self._var_alias.get(s.var)
        self._var_alias[s.var] = var
        try:
            body = [i for st in s.body for i in self._stmt(st)]
        finally:
            if outer is None:
                self._var_alias.pop(s.var, None)
            else:
                self._var_alias[s.var] = outer
        body.append({'name': 'alu', 'op': 'add', 'lhs': step,
                     'rhs': var, 'out': var})
        # QASM ranges are inclusive of `stop`: continue while
        # stop >= var (ascending) / var >= stop == stop-1 < var
        # (descending; hardware le is strict, alu.v:25-27)
        if step < 0 and stop == -2**31:
            raise QASMTranslationError(
                'descending range to INT32_MIN: the inclusive bound '
                'folds out of the 32-bit range')
        return declare + [
            {'name': 'set_var', 'var': var, 'value': start},
            {'name': 'loop',
             'cond_lhs': stop if step > 0 else stop - 1,
             'alu_cond': 'ge' if step > 0 else 'le',
             'cond_rhs': var, 'scope': self.all_qubits, 'body': body},
        ]

    def _while(self, s: qp.While) -> list[dict]:
        """``while (cond)`` -> branch_var guard around a do-while
        hardware loop (the loop's back-edge tests after the body, so the
        guard supplies the test-before-first-iteration semantics)."""
        cond_lhs, alu_cond, var = self._loop_cond(s.lhs, s.op, s.rhs)
        body = [i for st in s.body for i in self._stmt(st)]
        loop = {'name': 'loop', 'cond_lhs': cond_lhs,
                'alu_cond': alu_cond, 'cond_rhs': var,
                'scope': self.all_qubits, 'body': body}
        return [{'name': 'branch_var', 'alu_cond': alu_cond,
                 'cond_lhs': cond_lhs, 'cond_rhs': var,
                 'scope': self.all_qubits, 'true': [loop], 'false': []}]

    # -- expressions -----------------------------------------------------

    def _const_expr(self, e) -> float:
        """Fold a parameter expression to a number (pi supported)."""
        if isinstance(e, (int, float)):
            return e
        if isinstance(e, qp.Ref):
            if e.name in ('pi', 'π'):
                return np.pi
            if e.name in ('tau', 'τ'):
                return 2 * np.pi
            if e.name == 'euler':
                return np.e
            raise QASMTranslationError(
                f'gate parameters must be constant, got {e.name!r}')
        if isinstance(e, qp.BinOp):
            a, b = self._const_expr(e.lhs), self._const_expr(e.rhs)
            return {'+': a + b, '-': a - b, '*': a * b, '/': a / b,
                    '%': a % b}[e.op]
        raise QASMTranslationError(f'bad parameter expression {e}')

    def _expr(self, e) -> tuple[list[dict], object]:
        """Lower an expression to (instructions, value-or-varname) using
        temporaries for nesting (reference: visitor.py:121-147)."""
        if isinstance(e, (int, float)):
            return [], int(e)
        if isinstance(e, qp.Ref):
            name = self._varname(e.name)
            if name in self.int_vars:
                return [], name
            if e.name in ('pi', 'π'):
                return [], np.pi
            raise QASMTranslationError(f'unknown variable {e.name!r}')
        if isinstance(e, qp.BinOp):
            if e.op not in ('+', '-'):
                raise QASMTranslationError(
                    f'only +/- supported on variables, got {e.op!r}')
            pre_l, lhs = self._expr(e.lhs)
            pre_r, rhs = self._expr(e.rhs)
            # the processor ALU computes lhs <op> rhs with rhs a register
            if not isinstance(rhs, str):
                if isinstance(lhs, str) and e.op == '+':
                    lhs, rhs = rhs, lhs          # commute constant left
                else:
                    tmp = self._tmpvar()
                    pre_r += [
                        {'name': 'declare', 'var': tmp, 'dtype': 'int',
                         'scope': self.all_qubits},
                        {'name': 'set_var', 'var': tmp, 'value': rhs}]
                    rhs = tmp
            out = self._tmpvar()
            instrs = pre_l + pre_r + [
                {'name': 'declare', 'var': out, 'dtype': 'int',
                 'scope': self.all_qubits},
                {'name': 'alu', 'op': {'+': 'add', '-': 'sub'}[e.op],
                 'lhs': lhs, 'rhs': rhs, 'out': out}]
            return instrs, out
        raise QASMTranslationError(f'bad expression {e}')


def qasm_to_program(src: str, gate_map: GateMap = None,
                    qubit_map: QubitMap = None) -> list[dict]:
    """Translate OpenQASM 3 source to the native dict program format."""
    return QASMTranslator(gate_map, qubit_map).translate(src)
