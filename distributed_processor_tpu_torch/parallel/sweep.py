"""Per-batch statistics of physics-closed runs.

Counterpart of :func:`physics_batch_stats` in the JAX package's
``parallel/sweep.py``; the mesh-sharded executors are ported later
(ROADMAP.md).
"""

from __future__ import annotations

from ..sim.interpreter import fault_shot_counts


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
