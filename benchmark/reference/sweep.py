"""The sums a physics batch reduces to, from the per-pattern outcomes.

A batch's sums are the per-pattern outcomes of :mod:`.lanes` weighted by
how many shots of the batch started in each pattern: per-core pulse
sums, per-core first-slot ones, the shots that errored, the clean shots
(no error, every core's first slot resolved), the clean shots that read
all zeros in the first slot, per-code faulted shots (none is due: the
oracle has no fault) and the incomplete flag.
"""

from __future__ import annotations

import numpy as np


def expected_stats(table: dict, counts: np.ndarray, n_fault_codes: int) \
        -> dict:
    """``table``: per-pattern records ``[P, C, ...]``; ``counts [P]``: the
    batch's shots per pattern."""
    counts = np.asarray(counts, np.int64)
    first = table['meas_bits'][:, :, 0]
    errored = table['err'].any(axis=1)
    clean = ~errored & table['meas_bits_valid'][:, :, 0].astype(bool).all(1)
    allzero = (first == 0).all(axis=1) & clean
    return dict(
        pulse_sum=counts @ table['n_pulses'],
        meas1_sum=counts @ first,
        allzero_sum=np.int64(counts @ allzero),
        clean_shots=np.int64(counts @ clean),
        err_shots=np.int64(counts @ errored),
        fault_shots=np.zeros(n_fault_codes, np.int64),
        incomplete=np.int64(0),
    )


def stats_equal(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.array_equal(np.asarray(got[k], np.int64), want[k]) for k in want)
