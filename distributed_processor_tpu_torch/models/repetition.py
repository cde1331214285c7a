"""Repetition-code syndrome round on the LUT measurement fabric.

Counterpart of the JAX package's ``models/repetition.py`` (numpy only).
Flagship demo of the fproc_lut path (reference: hdl/fproc_lut.sv +
meas_lut.sv): every data core measures, the fabric forms the syndrome
address from all data bits, and each core receives its own correction
bit from a majority-vote table — the distributed-feedback pattern the
gateware hard-codes, here generated for any code distance.
"""

from __future__ import annotations

import numpy as np

from .. import isa
from ..decoder import machine_program_from_cmds
from ..sim.interpreter import InterpreterConfig


def majority_lut(n_data: int) -> tuple:
    """LUT table: entry ``addr`` has bit i set iff data bit i disagrees
    with the majority of the measured pattern (i.e. core i needs an X
    correction to restore the codeword)."""
    table = []
    for addr in range(1 << n_data):
        bits = [(addr >> i) & 1 for i in range(n_data)]
        maj = 1 if sum(bits) * 2 > n_data else 0
        table.append(sum((1 << i) for i, b in enumerate(bits) if b != maj))
    return tuple(table)


def repetition_round_machine_program(n_data: int = 3,
                                     meas_time: int = 10,
                                     correct_time: int = 400):
    """One syndrome-measurement + correction round, one core per data
    qubit: measure (rdlo), read own correction bit from the LUT
    (func_id=1), conditionally flip (two X90 = X), halt."""
    cores = []
    for _ in range(n_data):
        cmds = [
            isa.pulse_cmd(freq_word=1, cfg_word=2, env_word=(2 << 12) | 0,
                          cmd_time=meas_time),
            isa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                        func_id=1),
            isa.jump_i(5),
            isa.pulse_cmd(freq_word=2, cfg_word=0, env_word=(2 << 12) | 0,
                          cmd_time=correct_time),
            isa.pulse_cmd(cmd_time=correct_time + 20),
            isa.done_cmd(),
        ]
        cores.append(cmds)
    return machine_program_from_cmds(cores)


def _lut_fabric_kwargs(n_data: int) -> dict:
    """The LUT-fabric wiring every repetition path shares: all data
    cores masked into the syndrome address, majority table loaded."""
    return dict(fabric='lut', lut_mask=(True,) * n_data,
                lut_table=majority_lut(n_data))


def repetition_config(n_data: int, **kw) -> InterpreterConfig:
    defaults = dict(max_steps=64, max_pulses=8, max_meas=2, max_resets=1,
                    **_lut_fabric_kwargs(n_data))
    defaults.update(kw)
    return InterpreterConfig(**defaults)


def repetition_round_program(n_data: int = 3,
                             slack_s: float = 3e-6) -> list[dict]:
    """Gate-level (compiled-path) repetition round, for physics-closed
    execution: every data qubit measures, branches on its own
    majority-vote correction bit from the syndrome LUT (``func_id=1``),
    and conditionally flips (two X90 = X).

    ``slack_s``: delay at the head of the correction branch — the LUT
    read blocks until every masked core's window demodulates (readout
    window + demod hold), a wait the static scheduler cannot see; the
    slack keeps the correction pulses' trigger times ahead of it.

    Run with ``repetition_physics_kwargs(n_data)`` as the interpreter
    configuration.
    """
    program = []
    for i in range(n_data):
        q = f'Q{i}'
        program += [
            {'name': 'read', 'qubit': [q]},
            {'name': 'branch_fproc', 'alu_cond': 'eq', 'cond_lhs': 1,
             'func_id': 1, 'scope': [q],
             'true': [{'name': 'delay', 't': slack_s, 'qubit': [q]},
                      {'name': 'X90', 'qubit': [q]},
                      {'name': 'X90', 'qubit': [q]}],
             'false': []},
        ]
    return program


def repetition_physics_kwargs(n_data: int) -> dict:
    """Interpreter-config kwargs for the physics-closed compiled round
    (pass to ``run_physics_batch``): the shared LUT wiring plus budgets
    sized for the gate-level program (more pulses per core than the
    hand-assembled machine round)."""
    return dict(max_pulses=16, max_meas=2, **_lut_fabric_kwargs(n_data))


def _zero_amp_pulse(dest_q: int, freq_q: int, qchip=None) -> dict:
    """A zero-amplitude drive pulse on ``Q<dest_q>.qdrv`` at qubit
    ``freq_q``'s frequency: rotates nothing, but gives the statevec
    device's stochastic error channels a pulse to fire on (1q depol
    when freq_q == dest_q, the 2q coupling channel otherwise).

    The frequency is resolved from ``qchip`` — it must match the target
    qubit's drive frequency exactly or the coupling map never fires and
    the 'noise' silently injects nothing (models/coupling.py matches by
    frequency value)."""
    if qchip is None:
        from .default_qchip import make_default_qchip
        qchip = make_default_qchip(max(dest_q, freq_q) + 1)
    return {'name': 'pulse', 'dest': f'Q{dest_q}.qdrv',
            'freq': qchip.get_qubit_freq(f'Q{freq_q}.freq'),
            'phase': 0.0, 'amp': 0.0, 'twidth': 24e-9,
            'env': {'env_func': 'square', 'paradict': {}}}


def correlated_noise_stage(pairs, qchip=None) -> list[dict]:
    """Pairwise-correlated error injection: one zero-amplitude
    cross-resonance pulse per (control, target) pair.  With
    ``DeviceModel.depol2_per_pulse = p``, each pair suffers one of the
    15 two-qubit Paulis with probability p — including the both-flip
    errors (4/15 of them) that defeat a distance-3 majority vote with a
    SINGLE event, which is what makes correlated noise strictly worse
    for the repetition code than independent noise of equal marginal
    strength (tests/test_repetition_correlated.py)."""
    out = []
    qubits = sorted({q for ab in pairs for q in ab})
    if qchip is None and pairs:
        from .default_qchip import make_default_qchip
        qchip = make_default_qchip(max(qubits) + 1)
    for a, b in pairs:
        out.append({'name': 'barrier',
                    'qubit': [f'Q{q}' for q in qubits]})
        out.append(_zero_amp_pulse(a, b, qchip))
    return out


def independent_noise_stage(qubits, qchip=None) -> list[dict]:
    """Per-qubit independent error injection: one zero-amplitude 1q
    drive pulse per qubit; ``DeviceModel.depol_per_pulse = p`` then
    flips each qubit independently with probability 2p/3."""
    qubits = list(qubits)
    if qchip is None and qubits:
        from .default_qchip import make_default_qchip
        qchip = make_default_qchip(max(qubits) + 1)
    return [_zero_amp_pulse(q, q, qchip) for q in qubits]


def repetition_logical_program(n_data: int = 3, noise: list = None,
                               slack_s: float = 3e-6) -> list[dict]:
    """Noise stage + one full syndrome round + verification readout:
    inject errors, measure every data qubit, apply the LUT
    majority-vote correction, then read again — the second-round
    majority is the logical state after correction.  Run with
    ``repetition_physics_kwargs(n_data)``."""
    qubits = [f'Q{i}' for i in range(n_data)]
    program = list(noise or [])
    program.append({'name': 'barrier', 'qubit': qubits})
    program += repetition_round_program(n_data, slack_s)
    program.append({'name': 'barrier', 'qubit': qubits})
    for q in qubits:
        program.append({'name': 'read', 'qubit': [q]})
    return program


def corrected_counts(out, n_data: int) -> np.ndarray:
    """Per-core correction count from a run's pulse records: cores that
    fired the 2-pulse flip after the readout."""
    n = np.asarray(out['n_pulses'])
    return (n - 1) // 2      # readout pulse + optionally 2 X90s
