"""Single-qubit Clifford randomized benchmarking sequences.

The reference has no experiment library (RB programs are authored by
hand against the compiler's input format); this module generates them:
each Clifford is realised in the virtual-Z style the compiler optimises
for — ``Z(a) X90 Z(b) X90 Z(c)`` with angles in multiples of pi/2, so a
Clifford costs exactly two physical pulses and three frame updates
(which the ResolveVirtualZ pass folds into pulse phases).

The 24-element group table is built numerically at import time and the
recovery Clifford is found by projective unitary comparison.
"""

from __future__ import annotations

import functools

import numpy as np

_X90 = np.array([[1, -1j], [-1j, 1]]) / np.sqrt(2)


def _rz(k: int) -> np.ndarray:
    """Rz by k * pi/2."""
    a = k * np.pi / 2
    return np.array([[np.exp(-1j * a / 2), 0], [0, np.exp(1j * a / 2)]])


def _proj_eq(u: np.ndarray, v: np.ndarray) -> bool:
    return abs(abs(np.trace(u.conj().T @ v)) - 2) < 1e-9


@functools.lru_cache()
def clifford_table():
    """The 24 single-qubit Cliffords as (a, b, c) Euler triples (units of
    pi/2) with their unitaries: ``U = Rz(c) @ X90 @ Rz(b) @ X90 @ Rz(a)``
    (program order: Z(a), X90, Z(b), X90, Z(c))."""
    triples, unitaries = [], []
    for a in range(4):
        for b in range(4):
            for c in range(4):
                u = _rz(c) @ _X90 @ _rz(b) @ _X90 @ _rz(a)
                if not any(_proj_eq(u, v) for v in unitaries):
                    triples.append((a, b, c))
                    unitaries.append(u)
    assert len(triples) == 24, f'expected 24 Cliffords, got {len(triples)}'
    return triples, np.array(unitaries)


def inverse_index(net: np.ndarray) -> int:
    """Table index of the Clifford inverting ``net`` (projectively)."""
    _, unitaries = clifford_table()
    for i, u in enumerate(unitaries):
        if _proj_eq(u @ net, np.eye(2)):
            return i
    raise ValueError('net unitary is not a Clifford')


def rb_sequence(rng, depth: int) -> list[int]:
    """Random Clifford indices of length ``depth`` plus the recovery."""
    _, unitaries = clifford_table()
    seq = [int(rng.integers(24)) for _ in range(depth)]
    net = np.eye(2)
    for i in seq:
        net = unitaries[i] @ net
    seq.append(inverse_index(net))
    return seq


def clifford_instructions(qubit: str, index: int) -> list[dict]:
    """One Clifford as compiler-input instructions (2 pulses + 3 vz)."""
    triples, _ = clifford_table()
    a, b, c = triples[index]
    out = []
    for k, is_pulse in ((a, False), (None, True), (b, False), (None, True),
                        (c, False)):
        if is_pulse:
            out.append({'name': 'X90', 'qubit': [qubit]})
        elif k:
            out.append({'name': 'virtual_z', 'qubit': [qubit],
                        'phase': k * np.pi / 2})
    return out


def rb_program(qubits, depth: int, rng=None, seed: int = 0,
               delay_before: float = 500e-9) -> list[dict]:
    """Simultaneous per-qubit RB: independent random sequences on every
    qubit, aligned with a barrier, ending in a read on each qubit."""
    rng = rng or np.random.default_rng(seed)
    program = [{'name': 'delay', 't': delay_before}]
    seqs = {q: rb_sequence(rng, depth) for q in qubits}
    for q, seq in seqs.items():
        for idx in seq:
            program.extend(clifford_instructions(q, idx))
    program.append({'name': 'barrier', 'qubit': list(qubits)})
    for q in qubits:
        program.append({'name': 'read', 'qubit': [q]})
    return program


def rb_ensemble(qubits, depth: int, n_seqs: int, seed: int = 0,
                delay_before: float = 500e-9) -> list[list[dict]]:
    """``n_seqs`` independent random RB programs of one depth — the
    multi-sequence ensemble an RB experiment actually averages over
    (a single fixed sequence measures that sequence, not the gate set).

    Every Clifford costs exactly two physical pulses regardless of the
    random draw, so all members of an ensemble compile to the same
    instruction-count band and share one shape bucket — execute them in
    one compile via ``sim.interpreter.simulate_multi_batch``.

    Sequence ``s`` seeds its own generator from ``(seed, s)``:
    ensembles are reproducible, and growing ``n_seqs`` extends an
    existing ensemble without re-randomizing the earlier members.
    """
    if n_seqs <= 0:
        raise ValueError(f'need n_seqs >= 1, got {n_seqs}')
    return [rb_program(qubits, depth,
                       rng=np.random.default_rng([seed, s]),
                       delay_before=delay_before)
            for s in range(n_seqs)]
