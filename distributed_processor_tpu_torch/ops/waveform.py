"""Signal-generator element constants and the carrier NCO.

Counterpart of the JAX package's ``ops/waveform.py``: the pieces the
physics resolver needs (word scales, the I/Q helper and the
split-precision carrier phase).  Element synthesis (``synthesize_element``)
is ported with the waveform kernel, later (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHASE_BITS = 17
AMP_SCALE = float(2 ** 16 - 1)


def complex_to_iq(z) -> np.ndarray:
    z = np.asarray(z)
    return np.stack([np.real(z), np.imag(z)], axis=-1).astype(np.float32)


def carrier_phase(freq_rel: torch.Tensor, n: torch.Tensor, phase0=0.0):
    """Phase-coherent carrier phase ``2*pi*freq_rel*n + phase0`` via a
    split-precision NCO: the frequency's 16-bit-exact head accumulates in
    wrapping integer arithmetic (exact mod 1, like the hardware NCO), and
    only the residual (< 2^-17 cycles/sample) multiplies ``n`` in
    float32.  ``n`` is an int32 tensor; broadcasting applies.  The head
    product is taken in int64 — its low 16 bits equal those of the
    wrapping int32 product the JAX package computes."""
    freq_rel = freq_rel.to(torch.float32)
    inc_hi = torch.round(freq_rel * 65536.0).to(torch.int32)
    resid = freq_rel - inc_hi.to(torch.float32) / 65536.0
    frac = ((inc_hi.long() * n.long()) & 0xffff).to(torch.float32) / 65536.0
    return 2 * math.pi * (frac + resid * n.to(torch.float32)) + phase0
