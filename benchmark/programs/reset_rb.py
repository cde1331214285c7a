"""Active reset, then single-qubit Clifford RB on every qubit.

The reset reads each qubit and flips it when it reads 1 (the
feed-forward of QubiC 2.0, arXiv:2309.10333); the RB sequence follows
Magesan et al., PRL 106, 180504.  ``program`` keys of the configuration:
``n_qubits``, ``depth``, ``rb_seed`` (the one sequence of a campaign,
``bench.py``'s headline seed).  A traffic file may ask for a pool of
``n_programs`` distinct sequences instead, drawn from the run's seed.
"""

from __future__ import annotations

from ..reference.stack.models.default_qchip import make_default_qchip_dict
from ..reference.stack.models.experiments import active_reset
from ..reference.stack.models.rb import rb_ensemble, rb_program


def _qubits(n: int) -> list:
    return [f'Q{i}' for i in range(n)]


def sources(program: dict, n_programs: int = None, seed: int = 0) -> list:
    """Dict-program sources: the configuration's one sequence, or a pool
    of ``n_programs`` sequences drawn from ``seed``."""
    qs = _qubits(program['n_qubits'])
    reset = active_reset(qs)
    if n_programs is None:
        return [reset + rb_program(qs, program['depth'],
                                   seed=program['rb_seed'])]
    return [reset + p for p in rb_ensemble(qs, program['depth'], n_programs,
                                           seed=seed)]


def qchip_source(program: dict) -> dict:
    """The calibration both sides compile against (the default qchip)."""
    return make_default_qchip_dict(program['n_qubits'])


def port_program(program: dict, source, qchip: dict):
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.qchip import QChip
    n = program['n_qubits']
    return compile_to_machine(source, QChip(qchip), n_qubits=n)


def reference_program(program: dict, source, qchip: dict):
    from ..reference.stack.pipeline import compile_to_machine
    from ..reference.stack.qchip import QChip
    n = program['n_qubits']
    return compile_to_machine(source, QChip(qchip), n_qubits=n)
