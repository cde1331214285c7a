"""The majority decode of a repetition-code syndrome history, in numpy.

Per shot: each data qubit's strict majority over the rounds (ties to 0),
then the correction of the pattern's strict majority: bit i is set where
qubit i disagrees with the majority of the qubits (``majority_lut``'s
entry for that pattern).
"""

from __future__ import annotations

import numpy as np


def majority_decode(hist) -> np.ndarray:
    """``hist [B, R, K]`` 0/1 -> corrections ``[B, K]`` int32."""
    hist = np.asarray(hist, np.int64)
    per_qubit = 2 * hist.sum(axis=-2) > hist.shape[-2]
    pattern = 2 * per_qubit.sum(axis=-1, keepdims=True) > per_qubit.shape[-1]
    return (per_qubit != pattern).astype(np.int32)
