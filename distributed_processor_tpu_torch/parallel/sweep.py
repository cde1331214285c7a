"""Per-batch statistics of physics-closed runs and program ensembles.

Counterpart of :func:`physics_batch_stats` in the JAX package's
``parallel/sweep.py`` and of the per-program reduction of its
``run_multi_sweep``; the mesh-sharded executors are ported later
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..sim.interpreter import FAULT_CODES, fault_shot_counts


def physics_batch_stats(out: dict) -> dict:
    """The per-batch reductions of a :func:`..sim.physics.run_physics_batch`
    result: per-core pulse sums, first-slot measured-1 sums, errored
    shots, per-code faulted shots, and the JOINT all-zeros count over
    clean shots (``allzero_sum``, the survival numerator of multi-qubit
    RB) with its denominator ``clean_shots`` — a shot is clean when no
    core has an error bit and every core's first slot was resolved."""
    first = out['meas_bits'][:, :, 0]
    errored = (out['err'] != 0).any(dim=1)
    clean = ~errored & out['meas_bits_valid'][:, :, 0].all(dim=1)
    return dict(
        pulse_sum=out['n_pulses'].sum(0),
        meas1_sum=first.sum(0),
        allzero_sum=((first == 0).all(dim=1) & clean).sum(),
        clean_shots=clean.sum(),
        err_shots=errored.sum(),
        fault_shots=fault_shot_counts(out['fault']),
    )


def multi_batch_stats(out: dict) -> dict:
    """The per-program reductions of a
    :func:`..sim.interpreter.simulate_multi_batch` result (leaves
    ``[P, B, ...]``): pulse sums ``[P, C]``, errored shots ``[P]``, qclk
    sums ``[P, C]``, per-code faulted shots ``[P, n_codes]`` and the
    incomplete flag ``[P]`` as 0/1."""
    bits = torch.tensor([bit for _, bit in FAULT_CODES], dtype=torch.int32,
                        device=out['fault'].device)
    faulted = ((out['fault'][..., None] & bits) != 0).any(dim=-2)
    return dict(
        pulse_sum=out['n_pulses'].sum(1),
        err_shots=(out['err'] != 0).any(dim=-1).sum(1),
        qclk_sum=out['qclk'].sum(1),
        fault_shots=faulted.sum(1),
        incomplete=out['incomplete'].to(torch.int32),
    )
