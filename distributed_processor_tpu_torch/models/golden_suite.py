"""Self-contained golden-test suite: programs + canonical outputs.

The port's copy of the JAX package's ``models/golden_suite.py``: the
same eleven programs, compiled by the port's own stack against the
built-in default qchip (models/default_qchip.py), rendered as the same
canonical JSON of the per-core assembly and the assembled byte buffers.
The committed goldens in tests/goldens/ are shared by both packages
(regenerate with ``python -m
distributed_processor_tpu_torch.models.golden_suite``);
tests/test_torch_golden_suite.py holds this module's bytes to them and
to the JAX package's.
"""

from __future__ import annotations

import json
import numpy as np

from ..hwconfig import FPGAConfig
from ..elements import TPUElementConfig
from ..assembler import GlobalAssembler
from .channels import make_channel_configs
from .default_qchip import make_default_qchip
from .experiments import active_reset, ghz_program, t2_echo_program
from .rb import rb_program


def _linear():
    return [{'name': 'X90', 'qubit': ['Q0']},
            {'name': 'X90', 'qubit': ['Q1']},
            {'name': 'read', 'qubit': ['Q0']}]


def _pulse_sequence():
    return [
        {'name': 'pulse', 'dest': 'Q0.qdrv', 'freq': 4.2e9, 'phase': 0.0,
         'amp': 0.5, 'twidth': 32e-9,
         'env': {'env_func': 'cos_edge_square',
                 'paradict': {'ramp_fraction': 0.25}}},
        {'name': 'barrier', 'qubit': ['Q0', 'Q1']},
        {'name': 'pulse', 'dest': 'Q1.qdrv', 'freq': 4.31e9,
         'phase': np.pi / 4, 'amp': 0.25, 'twidth': 24e-9,
         'env': {'env_func': 'square', 'paradict': {}}},
        {'name': 'delay', 't': 100e-9, 'qubit': ['Q0']},
        {'name': 'X90', 'qubit': ['Q0']},
        {'name': 'read', 'qubit': ['Q1']},
    ]


def _fproc_hold():
    return [{'name': 'read', 'qubit': ['Q0']},
            {'name': 'branch_fproc', 'alu_cond': 'eq', 'cond_lhs': 1,
             'func_id': 'Q0.meas', 'scope': ['Q0'],
             'true': [{'name': 'X90', 'qubit': ['Q0']},
                      {'name': 'X90', 'qubit': ['Q0']}],
             'false': [{'name': 'Z90', 'qubit': ['Q0']}]}]


def _simple_loop():
    return [{'name': 'X90', 'qubit': ['Q0']},
            {'name': 'declare', 'var': 'loopind', 'dtype': 'int',
             'scope': ['Q0']},
            {'name': 'loop', 'cond_lhs': 10, 'cond_rhs': 'loopind',
             'alu_cond': 'ge', 'scope': ['Q0'],
             'body': [{'name': 'X90', 'qubit': ['Q0']},
                      {'name': 'X90', 'qubit': ['Q0']}]},
            {'name': 'read', 'qubit': ['Q0']}]


def _nested_loop():
    return [{'name': 'declare', 'var': 'i', 'dtype': 'int', 'scope': ['Q0']},
            {'name': 'declare', 'var': 'j', 'dtype': 'int', 'scope': ['Q0']},
            {'name': 'loop', 'cond_lhs': 3, 'cond_rhs': 'i',
             'alu_cond': 'ge', 'scope': ['Q0'],
             'body': [{'name': 'X90', 'qubit': ['Q0']},
                      {'name': 'loop', 'cond_lhs': 2, 'cond_rhs': 'j',
                       'alu_cond': 'ge', 'scope': ['Q0'],
                       'body': [{'name': 'X90', 'qubit': ['Q0']}]}]},
            {'name': 'read', 'qubit': ['Q0']}]


def _hw_virtualz():
    return [{'name': 'declare', 'var': 'q0_phase', 'scope': ['Q0'],
             'dtype': 'phase'},
            {'name': 'bind_phase', 'var': 'q0_phase', 'freq': 'Q0.freq'},
            {'name': 'X90', 'qubit': ['Q0']},
            {'name': 'X90', 'qubit': ['Q1']},
            {'name': 'virtual_z', 'qubit': 'Q0', 'phase': np.pi / 2},
            {'name': 'X90', 'qubit': ['Q0']},
            {'name': 'read', 'qubit': ['Q0']}]


def _sw_virtualz():
    return [{'name': 'X90', 'qubit': ['Q0']},
            {'name': 'virtual_z', 'qubit': 'Q0', 'phase': np.pi / 2},
            {'name': 'X90', 'qubit': ['Q0']},
            {'name': 'virtual_z', 'qubit': 'Q0', 'phase': -np.pi / 4},
            {'name': 'X90', 'qubit': ['Q0']},
            {'name': 'read', 'qubit': ['Q0']}]


# name -> (n_qubits, program thunk); every entry compiles with the
# default qchip and default FPGAConfig — fully self-contained
GOLDEN_PROGRAMS = {
    'linear_x90_read': (2, _linear),
    'pulse_sequence': (2, _pulse_sequence),
    'active_reset_2q': (2, lambda: active_reset(['Q0', 'Q1'])),
    'fproc_hold': (1, _fproc_hold),
    'simple_loop': (1, _simple_loop),
    'nested_loop': (1, _nested_loop),
    'hw_virtualz': (2, _hw_virtualz),
    'sw_virtualz': (1, _sw_virtualz),
    'ghz_3q': (3, lambda: ghz_program(['Q0', 'Q1', 'Q2'])),
    't2_echo': (1, lambda: t2_echo_program('Q0', 1e-6)),
    'rb_2q_depth3': (2, lambda: rb_program(['Q0', 'Q1'], 3, seed=99)),
}


def compile_golden(name: str) -> dict:
    """Compile one golden program; returns the canonical JSON-safe dict
    {'asm': CompiledProgram.to_dict(), 'assembled': {core: hex bufs}}."""
    from ..pipeline import compile_program
    n_qubits, thunk = GOLDEN_PROGRAMS[name]
    qchip = make_default_qchip(max(n_qubits, 2))
    prog = compile_program(thunk(), qchip, FPGAConfig())
    asm = GlobalAssembler(prog, make_channel_configs(n_qubits),
                          TPUElementConfig)
    assembled = asm.get_assembled_program()
    return {
        'asm': prog.to_dict(),
        'assembled': {
            str(core): {
                'cmd_buf': bufs['cmd_buf'].hex(),
                'env_buffers': [b.hex() for b in bufs['env_buffers']],
                'freq_buffers': [b.hex() for b in bufs['freq_buffers']],
            } for core, bufs in assembled.items()},
    }


def canonical_json(obj) -> str:
    return json.dumps(obj, indent=1, sort_keys=True)


def main():
    """Regenerate tests/goldens/*.json from the current compiler."""
    import os
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    outdir = os.path.join(here, 'tests', 'goldens')
    os.makedirs(outdir, exist_ok=True)
    for name in GOLDEN_PROGRAMS:
        path = os.path.join(outdir, name + '.json')
        with open(path, 'w') as f:
            f.write(canonical_json(compile_golden(name)) + '\n')
        print('wrote', path)


if __name__ == '__main__':
    main()
