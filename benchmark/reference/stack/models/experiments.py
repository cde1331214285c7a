"""Canonical experiment programs.

Programs in the compiler's dict input format (same surface as the
reference's — reference: python/distproc/compiler.py:1-106): measurement
feedback via ``branch_fproc``, frame updates via ``virtual_z``, gate
parameter overrides via ``modi``.  These are the "model families" of the
framework — the programs users actually sweep and run.
"""

from __future__ import annotations

import numpy as np


def active_reset(qubits, n_rounds: int = 1) -> list[dict]:
    """Measurement-conditioned reset: read, flip if |1> (the idiom the
    reference's OpenQASM frontend emits for QuantumReset — reference:
    python/distproc/openqasm/visitor.py:86-92)."""
    program = []
    for _ in range(n_rounds):
        for q in qubits:
            program.append({'name': 'read', 'qubit': [q]})
            program.append({
                'name': 'branch_fproc', 'alu_cond': 'eq', 'cond_lhs': 1,
                'func_id': f'{q}.meas', 'scope': [q],
                'true': [{'name': 'X90', 'qubit': [q]},
                         {'name': 'X90', 'qubit': [q]}],
                'false': []})
    return program


def rabi_program(qubit: str, amplitude: float, pulse_name: str = 'X90') -> list[dict]:
    """Amplitude-Rabi point: drive at overridden amplitude, then read."""
    return [
        {'name': pulse_name, 'qubit': [qubit],
         'modi': {(0, 'amp'): float(amplitude)}},
        {'name': 'read', 'qubit': [qubit]},
    ]


def t1_program(qubit: str, delay_s: float) -> list[dict]:
    """T1 point: pi pulse (2x X90), wait, read."""
    return [
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'delay', 't': float(delay_s), 'qubit': [qubit]},
        {'name': 'read', 'qubit': [qubit]},
    ]


def ramsey_program(qubit: str, delay_s: float,
                   detuning_phase: float = 0.0) -> list[dict]:
    """Ramsey point: X90, wait (+ optional frame advance), X90, read."""
    out = [
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'delay', 't': float(delay_s), 'qubit': [qubit]},
    ]
    if detuning_phase:
        out.append({'name': 'virtual_z', 'qubit': [qubit],
                    'phase': float(detuning_phase)})
    out += [
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'read', 'qubit': [qubit]},
    ]
    return out


def t2_echo_program(qubit: str, delay_s: float) -> list[dict]:
    """Hahn echo point: X90 - wait/2 - X (echo) - wait/2 - X90, read."""
    half = {'name': 'delay', 't': float(delay_s) / 2, 'qubit': [qubit]}
    return [
        {'name': 'X90', 'qubit': [qubit]},
        dict(half),
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'X90', 'qubit': [qubit]},
        dict(half),
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'read', 'qubit': [qubit]},
    ]


def ghz_program(qubits) -> list[dict]:
    """GHZ-state preparation + readout: H on the first qubit, a CNOT
    chain, barrier, read all (uses the CNOT calibrations the default
    qchip defines for adjacent pairs).

    Every CNOT is fenced with a barrier over all qubits — on hardware
    (and in the schedule the statevec device's discrete-event gate
    replays in time order) this keeps a deep chain's drives from
    overlapping the neighbour's CR tone."""
    q0 = qubits[0]
    prog = [
        {'name': 'virtual_z', 'qubit': [q0], 'phase': np.pi / 2},
        {'name': 'X90', 'qubit': [q0]},
        {'name': 'virtual_z', 'qubit': [q0], 'phase': np.pi / 2},
    ]
    for a, b in zip(qubits, qubits[1:]):
        prog.append({'name': 'barrier', 'qubit': list(qubits)})
        prog.append({'name': 'CNOT', 'qubit': [a, b]})
    prog.append({'name': 'barrier', 'qubit': list(qubits)})
    for q in qubits:
        prog.append({'name': 'read', 'qubit': [q]})
    return prog


def loop_shots_program(body: list[dict], n_shots: int, scope) -> list[dict]:
    """Wrap a program body in an on-device shot loop (the reference's
    loop instruction with a var counter — qclk rewind keeps per-iteration
    schedules identical; reference: compiler.py:322-324)."""
    return [
        {'name': 'declare', 'var': 'shotcnt', 'dtype': 'int', 'scope': scope},
        {'name': 'set_var', 'var': 'shotcnt', 'value': 0},
        {'name': 'loop', 'cond_lhs': int(n_shots), 'alu_cond': 'ge',
         'cond_rhs': 'shotcnt', 'scope': scope,
         'body': list(body) + [
             {'name': 'alu', 'lhs': 1, 'op': 'add', 'rhs': 'shotcnt',
              'out': 'shotcnt'}]},
    ]
