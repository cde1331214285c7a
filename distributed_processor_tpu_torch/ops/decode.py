"""Host-side QEC decoder oracles (numpy only).

Counterpart of the numpy half of the JAX package's ``ops/decode.py``:
the brute-force chain-matching oracle, which builds the chain-matching
LUT of :func:`..models.qec.chain_lut`, and the literal majority-LUT
walk.  The in-loop ``DecodeSpec`` decoders of the rounds scan come with
``simulate_rounds`` (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import numpy as np


def chain_matching_np(synd) -> np.ndarray:
    """Brute-force minimum-weight matching on ONE repetition-chain
    syndrome ``[A]``: search all ``2^(A+1)`` error patterns for the
    minimum-weight one consistent with the syndrome.  Patterns are
    enumerated with data qubit 0 in the high bit, so the first
    min-weight hit — the tie-break — is the candidate with qubit 0
    clear."""
    synd = np.asarray(synd, np.int32)
    n = synd.shape[-1] + 1
    best, best_w = None, n + 1
    for pattern in range(1 << n):
        e = np.array([(pattern >> (n - 1 - i)) & 1 for i in range(n)],
                     np.int32)
        if np.array_equal(e[:-1] ^ e[1:], synd):
            w = int(e.sum())
            if w < best_w:
                best, best_w = e, w
    return best


def majority_correction_np(bits) -> np.ndarray:
    """The correction of ONE pattern ``[K]`` read from the literal
    :func:`..models.repetition.majority_lut` table — the entry the fproc
    fabric serves per round."""
    from ..models.repetition import majority_lut
    bits = np.asarray(bits, np.int32)
    k = bits.shape[-1]
    addr = int(sum(int(b) << i for i, b in enumerate(bits)))
    entry = majority_lut(k)[addr]
    return np.array([(entry >> i) & 1 for i in range(k)], np.int32)
