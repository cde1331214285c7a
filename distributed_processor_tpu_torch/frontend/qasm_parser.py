"""Minimal OpenQASM 3 parser (self-contained; no external dependency).

The reference frontend leans on the ``openqasm3`` package for parsing
(reference: python/distproc/openqasm/visitor.py:1-40) and only walks the
AST.  That package is not available here, so this module provides a
small tokenizer + recursive-descent parser for the practical subset the
translator consumes:

* ``OPENQASM 3;`` / ``include`` headers (ignored)
* ``qubit[n] q;`` / ``bit[n] c;`` / ``int[32] x = expr;`` declarations
* gate calls with optional parameter lists: ``rz(pi/2) q[0];``
* ``reset q[i];``
* ``c[i] = measure q[j];`` and bare ``measure q[j];``
* classical assignment ``x = a + 2 * b;``
* ``if (cond) { ... } else { ... }`` with comparison conditions
* ``for uint i in [a:b] { ... }`` / ``[a:step:b]`` (inclusive ranges)
* ``while (cond) { ... }``
* ``delay[100ns] q[0];`` (units ns/us/ms/s)
* ``barrier q;``

Output is a tiny AST of plain dataclasses consumed by
:mod:`.visitor`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class QASMSyntaxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------

@dataclass
class Decl:
    kind: str            # 'qubit' | 'bit' | 'int' | 'float'
    name: str
    size: int | None = None
    init: object = None  # expression


@dataclass
class Ref:
    name: str
    index: int | None = None


@dataclass
class GateCall:
    name: str
    params: list = field(default_factory=list)   # expressions
    operands: list = field(default_factory=list)  # Refs


@dataclass
class Reset:
    target: Ref


@dataclass
class Measure:
    target: Ref
    out: Ref | None = None


@dataclass
class Assign:
    target: Ref
    expr: object


@dataclass
class If:
    lhs: object
    op: str              # '==' '!=' '<' '<=' '>' '>='
    rhs: object
    true: list = field(default_factory=list)
    false: list = field(default_factory=list)


@dataclass
class For:
    var: str
    start: object        # expressions (folded to ints by the visitor)
    step: object
    stop: object
    body: list = field(default_factory=list)


@dataclass
class While:
    lhs: object
    op: str
    rhs: object
    body: list = field(default_factory=list)


@dataclass
class Delay:
    duration: float      # seconds
    operands: list = field(default_factory=list)


@dataclass
class Barrier:
    operands: list = field(default_factory=list)


@dataclass
class BinOp:
    op: str
    lhs: object
    rhs: object


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'''
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?|\d+(e[+-]?\d+)?)
  | (?P<id>[A-Za-z_$][A-Za-z_0-9]*)
  | (?P<str>"[^"]*")
  | (?P<op>==|!=|<=|>=|->|[-+*/%(){}\[\];,=<>:])
''', re.VERBOSE | re.DOTALL)


def tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise QASMSyntaxError(f'bad token at {src[pos:pos+20]!r}')
        pos = m.end()
        if m.lastgroup == 'ws' or (m.lastgroup and m.group('ws')):
            continue
        kind = m.lastgroup
        out.append((kind, m.group()))
    out.append(('eof', ''))
    return out


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_KEYWORDS = {'qubit', 'bit', 'int', 'float', 'reset', 'measure', 'if',
             'else', 'barrier', 'include', 'OPENQASM', 'pragma', 'const',
             'for', 'while', 'in', 'delay', 'uint', 'angle'}

_TIME_UNITS = {'ns': 1e-9, 'us': 1e-6, 'ms': 1e-3, 's': 1.0}


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0

    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, text: str):
        kind, val = self.next()
        if val != text:
            raise QASMSyntaxError(f'expected {text!r}, got {val!r}')
        return val

    # -- grammar ---------------------------------------------------------

    def parse(self) -> list:
        stmts = []
        while self.peek()[0] != 'eof':
            s = self.statement()
            if s is not None:
                stmts.append(s)
        return stmts

    def block(self) -> list:
        if self.peek()[1] == '{':
            self.next()
            out = []
            while self.peek()[1] != '}':
                s = self.statement()
                if s is not None:
                    out.append(s)
            self.next()
            return out
        s = self.statement()
        return [] if s is None else [s]

    def statement(self):
        kind, val = self.peek()
        if val == ';':
            self.next()
            return None
        if val in ('OPENQASM', 'include', 'pragma'):
            while self.next()[1] != ';':
                pass
            return None
        if val in ('qubit', 'bit', 'int', 'float', 'uint', 'angle',
                   'const'):
            return self.decl()
        if val == 'for':
            return self.for_stmt()
        if val == 'while':
            return self.while_stmt()
        if val == 'delay':
            return self.delay_stmt()
        if val == 'reset':
            self.next()
            t = self.ref()
            self.expect(';')
            return Reset(t)
        if val == 'barrier':
            self.next()
            return Barrier(self._ref_list())
        if val == 'if':
            return self.if_stmt()
        if val == 'measure':
            self.next()
            t = self.ref()
            self.expect(';')
            return Measure(t)
        if kind == 'id':
            # assignment (`x = ...`, `c[0] = measure ...`) or gate call
            save = self.i
            target = self.ref()
            if self.peek()[1] == '=':
                self.next()
                if self.peek()[1] == 'measure':
                    self.next()
                    src = self.ref()
                    self.expect(';')
                    return Measure(src, out=target)
                e = self.expr()
                self.expect(';')
                return Assign(target, e)
            self.i = save
            return self.gate_call()
        raise QASMSyntaxError(f'unexpected token {val!r}')

    def decl(self) -> Decl:
        kind = self.next()[1]
        if kind == 'const':
            kind = self.next()[1]
        size = None
        if self.peek()[1] == '[':
            self.next()
            size = int(self.next()[1])
            self.expect(']')
        name = self.next()[1]
        init = None
        if self.peek()[1] == '=':
            self.next()
            init = self.expr()
        self.expect(';')
        return Decl(kind, name, size, init)

    def for_stmt(self) -> For:
        """``for <type> name in [start:(step:)?stop] block`` — QASM3
        ranges are inclusive on both ends."""
        self.expect('for')
        if self.peek()[1] in ('int', 'uint', 'float', 'angle'):
            self.next()
            if self.peek()[1] == '[':        # width designator
                self.next()
                self.next()
                self.expect(']')
        kind, name = self.next()
        if kind != 'id' or name in _KEYWORDS:
            raise QASMSyntaxError(f'bad loop variable {name!r}')
        self.expect('in')
        self.expect('[')
        parts = [self.expr()]
        while self.peek()[1] == ':':
            self.next()
            parts.append(self.expr())
        self.expect(']')
        if len(parts) == 2:
            start, step, stop = parts[0], 1, parts[1]
        elif len(parts) == 3:
            start, step, stop = parts
        else:
            raise QASMSyntaxError('range must be [start:stop] or '
                                  '[start:step:stop]')
        return For(name, start, step, stop, self.block())

    def while_stmt(self) -> While:
        self.expect('while')
        self.expect('(')
        lhs = self.expr()
        op = self.next()[1]
        # '!=' has no eq/ge/le hardware-loop lowering: reject at parse
        if op not in ('==', '<', '<=', '>', '>='):
            raise QASMSyntaxError(
                f'unsupported while comparison {op!r} (use ==/</<=/>/>=)')
        rhs = self.expr()
        self.expect(')')
        return While(lhs, op, rhs, self.block())

    def delay_stmt(self) -> Delay:
        self.expect('delay')
        self.expect('[')
        kind, val = self.next()
        if kind != 'num':
            raise QASMSyntaxError(f'expected duration, got {val!r}')
        ukind, unit = self.next()
        if unit not in _TIME_UNITS:
            raise QASMSyntaxError(
                f'unknown time unit {unit!r} (use ns/us/ms/s)')
        self.expect(']')
        return Delay(float(val) * _TIME_UNITS[unit], self._ref_list())

    def if_stmt(self) -> If:
        self.expect('if')
        self.expect('(')
        lhs = self.expr()
        op = self.next()[1]
        if op not in ('==', '!=', '<', '<=', '>', '>='):
            raise QASMSyntaxError(f'bad comparison {op!r}')
        rhs = self.expr()
        self.expect(')')
        true = self.block()
        false = []
        if self.peek()[1] == 'else':
            self.next()
            false = self.block()
        return If(lhs, op, rhs, true, false)

    def gate_call(self) -> GateCall:
        name = self.next()[1]
        params = []
        if self.peek()[1] == '(':
            self.next()
            while self.peek()[1] != ')':
                params.append(self.expr())
                if self.peek()[1] == ',':
                    self.next()
            self.next()
        operands = [self.ref()]
        while self.peek()[1] == ',':
            self.next()
            operands.append(self.ref())
        self.expect(';')
        return GateCall(name, params, operands)

    def _ref_list(self) -> list:
        """Comma-separated operand refs terminated by ';' (consumed)."""
        ops = []
        while self.peek()[1] != ';':
            ops.append(self.ref())
            if self.peek()[1] == ',':
                self.next()
        self.next()
        return ops

    def ref(self) -> Ref:
        kind, name = self.next()
        if kind != 'id':
            raise QASMSyntaxError(f'expected identifier, got {name!r}')
        if name in _KEYWORDS:
            raise QASMSyntaxError(f'{name!r} is a reserved keyword')
        index = None
        if self.peek()[1] == '[':
            self.next()
            index = int(self.next()[1])
            self.expect(']')
        return Ref(name, index)

    # precedence-climbing arithmetic
    def expr(self):
        return self._additive()

    def _additive(self):
        lhs = self._multiplicative()
        while self.peek()[1] in ('+', '-'):
            op = self.next()[1]
            lhs = BinOp(op, lhs, self._multiplicative())
        return lhs

    def _multiplicative(self):
        lhs = self._unary()
        while self.peek()[1] in ('*', '/', '%'):
            op = self.next()[1]
            lhs = BinOp(op, lhs, self._unary())
        return lhs

    def _unary(self):
        if self.peek()[1] == '-':
            self.next()
            return BinOp('-', 0, self._unary())
        if self.peek()[1] == '(':
            self.next()
            e = self.expr()
            self.expect(')')
            return e
        kind, val = self.next()
        if kind == 'num':
            return float(val) if ('.' in val or 'e' in val) else int(val)
        if kind == 'id':
            index = None
            if self.peek()[1] == '[':
                self.next()
                index = int(self.next()[1])
                self.expect(']')
            return Ref(val, index)
        raise QASMSyntaxError(f'unexpected token in expression: {val!r}')


def parse_qasm(src: str) -> list:
    return Parser(src).parse()
