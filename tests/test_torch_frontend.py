"""The port's OpenQASM 3 front end against the JAX package's, on the CPU.

Every QASM source literal of tests/test_frontend.py (read from that file,
so a case added there is held here too) goes through both packages'
``qasm_to_program``: equal dict programs, and equal
``machine_program_bytes`` once compiled; a source either package refuses
raises the same exception, by name and message, in the other.  The
8-qubit QASM headline (``chip_smoke.qasm_headline_source``) compiles to
equal bytes in both packages, through ``Simulator.compile`` and
``cached_compile_to_machine``, and to the bytes of the dict headline.
"""

import ast
import os
import warnings

import numpy as np
import pytest
import torch

from distributed_processor_tpu.compilecache import (
    CompileCache as JCompileCache, machine_program_bytes as j_mp_bytes)
from distributed_processor_tpu.frontend import (
    qasm_to_program as j_qasm_to_program)
from distributed_processor_tpu.frontend.qasm_parser import (
    parse_qasm as j_parse_qasm)
from distributed_processor_tpu.models import (
    make_default_qchip as j_make_default_qchip)
from distributed_processor_tpu.pipeline import (
    cached_compile_to_machine as j_cached_compile,
    compile_to_machine as j_compile_to_machine)
from distributed_processor_tpu.simulator import Simulator as JSimulator

import chip_smoke
from distributed_processor_tpu_torch import Simulator
from distributed_processor_tpu_torch.compilecache import (
    CompileCache, machine_program_bytes)
from distributed_processor_tpu_torch.frontend import qasm_to_program
from distributed_processor_tpu_torch.frontend.qasm_parser import (
    QASMSyntaxError, parse_qasm)
from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_program)
from distributed_processor_tpu_torch.pipeline import (
    cached_compile_to_machine, compile_to_machine)
from distributed_processor_tpu_torch.sim.interpreter import simulate

torch.set_num_threads(1)

_FRONTEND_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'test_frontend.py')


def _qasm_sources():
    """``(entry, line, source)`` of every string literal that
    tests/test_frontend.py hands to ``qasm_to_program`` or ``parse_qasm``
    (directly, or through a variable bound to a literal)."""
    with open(_FRONTEND_TESTS) as f:
        tree = ast.parse(f.read())
    bound = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant) \
                and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound[t.id] = node.value.value
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, 'attr', '')
        if name not in ('qasm_to_program', 'parse_qasm'):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((name, node.lineno, arg.value))
        elif isinstance(arg, ast.Name) and arg.id in bound:
            out.append((name, node.lineno, bound[arg.id]))
    return sorted(out, key=lambda c: c[1])


SOURCES = _qasm_sources()


def test_sources_were_found():
    # the JAX file's literal sources: a parse that found none would make
    # the parametrised cases below vacuous
    assert len(SOURCES) >= 20
    assert any(name == 'parse_qasm' for name, _, _ in SOURCES)


def _outcome(fn, src):
    """``('ok', value)`` or ``('raised', exception name, message)``."""
    try:
        return 'ok', fn(src)
    except Exception as e:          # compared across the packages below
        return 'raised', type(e).__name__, str(e)


def _n_qubits(program) -> int:
    """One more than the highest ``Qn`` a dict program names (nested
    branch and loop bodies included); at least 1."""
    hi = -1

    def walk(instrs):
        nonlocal hi
        for ins in instrs:
            for q in ins.get('qubit', []) or []:
                hi = max(hi, int(q[1:]))
            for key in ('true', 'false', 'body'):
                if isinstance(ins.get(key), list):
                    walk(ins[key])
    walk(program)
    return max(hi + 1, 1)


@pytest.mark.parametrize('entry,line,src', SOURCES,
                         ids=[f'{n}:{ln}' for n, ln, _ in SOURCES])
def test_source_matches_jax(entry, line, src):
    """Both packages' front ends on one source: the same dict program (or
    the same parse tree's repr), or the same exception."""
    j_fn = j_parse_qasm if entry == 'parse_qasm' else j_qasm_to_program
    t_fn = parse_qasm if entry == 'parse_qasm' else qasm_to_program
    want, got = _outcome(j_fn, src), _outcome(t_fn, src)
    if entry == 'parse_qasm':
        # the AST dataclasses are each package's own classes: compare
        # their reprs, which name the fields and values
        want = want if want[0] == 'raised' else ('ok', repr(want[1]))
        got = got if got[0] == 'raised' else ('ok', repr(got[1]))
    assert got == want


@pytest.mark.parametrize('entry,line,src',
                         [c for c in SOURCES if c[0] == 'qasm_to_program'],
                         ids=[f'{n}:{ln}' for n, ln, _ in SOURCES
                              if n == 'qasm_to_program'])
def test_source_compiles_to_jax_bytes(entry, line, src):
    """A source both front ends accept compiles to the same machine
    program bytes in both packages (or fails to compile the same way)."""
    want = _outcome(j_qasm_to_program, src)
    if want[0] == 'raised':
        # nothing to compile: the port refuses it the same way
        assert _outcome(qasm_to_program, src) == want
        return
    j_prog, prog = want[1], qasm_to_program(src)
    n = _n_qubits(j_prog)

    def compile_j(p):
        return j_mp_bytes(j_compile_to_machine(p, j_make_default_qchip(n),
                                               n_qubits=n))

    def compile_t(p):
        return machine_program_bytes(compile_to_machine(
            p, make_default_qchip(n), n_qubits=n))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        want = _outcome(compile_j, j_prog)
        got = _outcome(compile_t, prog)
    assert got == want


def test_bad_sources_raise_the_same_error():
    for src in ('qubit[2 q;', 'qubit[1] q; for uint 5 in [0:1] { sx q[0]; }',
                'qubit[1] q; while (1 != 2) { sx q[0]; }',
                'qubit[1] q; for uint i in [0:0:5] { sx q[0]; }',
                'qubit[1] q; frobnicate q[0];'):
        for j_fn, t_fn in ((j_parse_qasm, parse_qasm),
                           (j_qasm_to_program, qasm_to_program)):
            want, got = _outcome(j_fn, src), _outcome(t_fn, src)
            if want[0] == 'raised':
                assert got == want, src
    with pytest.raises(QASMSyntaxError):
        qasm_to_program('qubit[2 q;')


def test_qasm_end_to_end_simulation_matches_jax():
    """tests/test_frontend.py's end-to-end case: the QASM source through
    both facades, every integer output equal, the measured-1 branch's
    two extra X90 pulses on core 0."""
    src = '''
        OPENQASM 3;
        qubit[2] q;
        bit[2] c;
        h q[0];
        cx q[0], q[1];
        barrier q[0], q[1];
        c[0] = measure q[0];
        c[1] = measure q[1];
        if (c[0] == 1) { x q[0]; }
    '''
    sim, jsim = Simulator(n_qubits=2, device='cpu'), JSimulator(n_qubits=2)
    mp, jmp = sim.compile(src), jsim.compile(src)
    assert machine_program_bytes(mp) == j_mp_bytes(jmp)
    pulses = []
    for bits in (np.zeros((2, 4), np.int32), np.ones((2, 4), np.int32)):
        out = simulate(mp, meas_bits=bits, device='cpu')
        out_j = jsim.run(jmp, meas_bits=bits[None])
        out_t = sim.run(src, meas_bits=bits[None])
        for key in out_j:
            if key.startswith('_'):
                continue
            np.testing.assert_array_equal(out_t[key].numpy(),
                                          np.asarray(out_j[key]),
                                          err_msg=key)
        assert not out['err'].any()
        pulses.append(int(out['n_pulses'][0]))
    assert pulses[1] == pulses[0] + 2


def test_qasm_headline_compiles_to_jax_and_dict_bytes():
    """The 8-qubit QASM headline (active reset as ``reset q[i];``, the
    depth-12 RB as ``sx`` and ``rz``): the same bytes in both packages,
    through ``Simulator.compile`` and the compile cache, and the bytes of
    the dict headline (active reset + ``rb_program(.., 12, seed=1234)``)."""
    src = chip_smoke.qasm_headline_source(8, 12, 1234)
    n = 8
    qubits = [f'Q{i}' for i in range(n)]
    want = j_mp_bytes(JSimulator(n_qubits=n).compile(src))
    assert machine_program_bytes(Simulator(n_qubits=n,
                                           device='cpu').compile(src)) == want
    qchip, jqchip = make_default_qchip(n), j_make_default_qchip(n)
    cached = cached_compile_to_machine(src, qchip, n_qubits=n,
                                       cache=CompileCache())
    j_cached = j_cached_compile(src, jqchip, n_qubits=n,
                                cache=JCompileCache())
    assert machine_program_bytes(cached) == j_mp_bytes(j_cached) == want
    dict_prog = active_reset(qubits) + rb_program(qubits, 12, seed=1234)
    assert machine_program_bytes(compile_to_machine(
        dict_prog, qchip, n_qubits=n)) == want
