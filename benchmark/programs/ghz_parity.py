"""Active reset, a GHZ chain, then a Z-basis readout or a parity analysis.

The standard GHZ-fidelity experiment (Sackett et al., Nature 404, 256
(2000); Monz et al., PRL 106, 130506 (2011)) on every qubit of the
board: the reset reads each qubit and flips it when it reads 1 (the
feed-forward of QubiC 2.0, arXiv:2309.10333), then H on Q0 and a CNOT
chain, each CNOT fenced by a barrier (the reference's frozen
``ghz_program`` without its reads).  Program 0 reads every qubit in Z
(the populations of 0...0 and 1...1); program ``1 + k`` first gives each
qubit ``virtual_z(phi_k)`` and ``X90``, with ``phi_k = 2 pi k / (n P)``
for ``k < P``, ``P`` phases over one period of the parity's
``cos(n phi)``.  ``program`` keys of the configuration: ``n_qubits``,
``phases`` (``P``).
"""

from __future__ import annotations

import math

import numpy as np

from ..reference.stack.models.default_qchip import make_default_qchip_dict
from ..reference.stack.models.experiments import active_reset, ghz_program


def _qubits(n: int) -> list:
    return [f'Q{i}' for i in range(n)]


def analysis_phases(program: dict) -> list:
    """Each program's analysis phase: None for the Z-basis readout."""
    n, P = program['n_qubits'], program['phases']
    return [None] + [2 * math.pi * k / (n * P) for k in range(P)]


def sources(program: dict, final_read: bool = True) -> list:
    """The dict-program sources, one per entry of
    :func:`analysis_phases` (``final_read=False`` leaves out the last
    reads: the state before them)."""
    qs = _qubits(program['n_qubits'])
    prep = active_reset(qs) + [e for e in ghz_program(qs)
                               if e['name'] != 'read']
    reads = [{'name': 'read', 'qubit': [q]} for q in qs] if final_read \
        else []
    out = []
    for phi in analysis_phases(program):
        turn = [] if phi is None else [
            e for q in qs for e in (
                {'name': 'virtual_z', 'qubit': [q], 'phase': phi},
                {'name': 'X90', 'qubit': [q]})]
        out.append(prep + turn + reads)
    return out


def qchip_source(program: dict) -> dict:
    """The calibration both sides compile against (the default qchip)."""
    return make_default_qchip_dict(program['n_qubits'])


def port_program(program: dict, source, qchip: dict):
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.qchip import QChip
    return compile_to_machine(source, QChip(qchip),
                              n_qubits=program['n_qubits'])


def port_couplings(mp, qchip: dict) -> tuple:
    """The statevec device's coupling map of the port's program."""
    from distributed_processor_tpu_torch.models import couplings_from_qchip
    from distributed_processor_tpu_torch.qchip import QChip
    return couplings_from_qchip(mp, QChip(qchip))


def reference_program(program: dict, source, qchip: dict):
    from ..reference.stack.pipeline import compile_to_machine
    from ..reference.stack.qchip import QChip
    return compile_to_machine(source, QChip(qchip),
                              n_qubits=program['n_qubits'])


def reference_couplings(rmp, qchip: dict, drive_elem: int = 0) -> tuple:
    """``(ctrl_core, freq_idx, target_core, kind)`` for every CNOT / CZ of
    the calibration whose interaction frequency the reference's compiled
    program uses: a CNOT's cross-resonance pulse (the control driven at
    the target's frequency) is ``'zx'``, a CZ's ef drive ``'zz'``, the
    control's own-frame pulses are single-qubit (docs/PHYSICS.md
    "Entangling model")."""
    from ..reference.stack.qchip import GatePulse, QChip
    chip = QChip(qchip)
    out = set()
    for name in chip.gates:
        if not (name.endswith('CNOT') or name.endswith('CZ')):
            continue
        head = name[:-4] if name.endswith('CNOT') else name[:-2]
        qs = head.replace('Q', ' Q').split()
        if len(qs) != 2:
            continue
        ctrl, tgt = int(qs[0][1:]), int(qs[1][1:])
        kind = 'zx' if name.endswith('CNOT') else 'zz'
        own = chip.get_qubit_freq(f'{qs[0]}.freq')
        for p in chip.get_gate(name).contents:
            if not (isinstance(p, GatePulse) and p.dest == f'{qs[0]}.qdrv'):
                continue
            if np.isclose(p.freq, own, rtol=1e-12) \
                    or max(ctrl, tgt) >= len(rmp.tables):
                continue
            freqs = np.asarray(rmp.tables[ctrl].freqs[drive_elem]['freq'],
                               np.float64)
            for i in np.nonzero(np.isclose(freqs, p.freq, rtol=1e-12,
                                           atol=1.0))[0]:
                out.add((ctrl, int(i), tgt, kind))
    return tuple(sorted(out))
