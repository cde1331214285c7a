"""Readout calibration: centroid fitting and fidelity estimation.

Counterpart of the JAX package's ``models/calibration.py``: run
prepared-|0> and prepared-|1> calibration batches through the IQ
readout model, fit per-channel centroids, and report assignment
fidelities — the ``centers0``/``centers1`` that
:func:`..ops.demod.discriminate` consumes.  Randomness comes from a
``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import discriminate
from ..sim.interpreter import torch_device
from .readout import make_generator


def fit_centroids(iq0, iq1):
    """Mean IQ per channel from labelled calibration shots.

    ``iq0``/``iq1``: ``[shots, channels, 2]`` I/Q points measured with
    the qubit prepared in |0> / |1>.  Returns ``(c0, c1)`` as
    ``[channels, 2]`` float32 tensors on the points' device."""
    c0 = torch.as_tensor(iq0).to(torch.float32).mean(0)
    c1 = torch.as_tensor(iq1).to(torch.float32).mean(0)
    return c0, c1


def assignment_matrix(iq0, iq1, c0=None, c1=None) -> np.ndarray:
    """Per-channel assignment probabilities ``[channels, 2, 2]``: entry
    ``[c, prepared, measured]``.  Fits centroids from the data unless
    provided."""
    if c0 is None or c1 is None:
        c0, c1 = fit_centroids(iq0, iq1)
    m0 = discriminate(iq0, c0, c1).cpu().numpy()     # [S, C]
    m1 = discriminate(iq1, c0, c1).cpu().numpy()
    n_chan = m0.shape[1]
    out = np.zeros((n_chan, 2, 2))
    out[:, 0, 1] = m0.mean(axis=0)
    out[:, 0, 0] = 1 - out[:, 0, 1]
    out[:, 1, 1] = m1.mean(axis=0)
    out[:, 1, 0] = 1 - out[:, 1, 1]
    return out


def readout_fidelity(iq0, iq1, c0=None, c1=None) -> np.ndarray:
    """Per-channel assignment fidelity 1 - (P(1|0) + P(0|1))/2."""
    a = assignment_matrix(iq0, iq1, c0, c1)
    return 1 - (a[:, 0, 1] + a[:, 1, 0]) / 2


def calibrate_readout(model, generator, shots: int = 1024, device=None):
    """Run |0>/|1> calibration batches against an
    :class:`~.readout.IQReadoutModel`; returns ``(c0, c1, fidelity)``.

    ``generator``: a ``torch.Generator`` (the draws run on its device)
    or an int seed for a generator on ``device`` (default CUDA)."""
    if not isinstance(generator, torch.Generator):
        generator = make_generator(generator, torch_device(device))
    n = len(model.c0)
    dev = generator.device
    iq0 = model.sample_iq(generator, torch.zeros((shots, n),
                                                 dtype=torch.int32,
                                                 device=dev))
    iq1 = model.sample_iq(generator, torch.ones((shots, n),
                                                dtype=torch.int32,
                                                device=dev))
    c0, c1 = fit_centroids(iq0, iq1)
    return c0, c1, readout_fidelity(iq0, iq1, c0, c1)
