"""Statistical readout models: measurement-bit sources for the simulator.

Counterpart of the JAX package's ``models/readout.py``.  Randomness comes
from an explicit ``torch.Generator`` where the JAX package takes a key;
the streams differ (Philox/MT here, threefry there), so the two agree in
distribution, not bit for bit.

* :func:`sample_meas_bits` — Bernoulli bits per (shot, core, index);
* :func:`apply_assignment_error` — asymmetric bit flips;
* :class:`IQReadoutModel` — state-dependent Gaussian IQ clouds,
  discriminated through :func:`..ops.demod.discriminate`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import discriminate


def make_generator(seed, device='cpu') -> torch.Generator:
    """``seed`` (an int, or a ready ``torch.Generator``) as a generator."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63 - 1))
    return gen


def sample_meas_bits(generator: torch.Generator, p1, n_shots: int,
                     n_meas: int) -> torch.Tensor:
    """Bernoulli measurement bits ``[n_shots, n_cores, n_meas]`` (int32)
    on the generator's device.

    ``p1``: per-core probability of reading |1> (array ``[n_cores]``)."""
    dev = generator.device
    p1 = torch.as_tensor(np.array(p1, np.float32), device=dev)
    u = torch.rand((n_shots, p1.shape[0], n_meas), generator=generator,
                   device=dev)
    return (u < p1[None, :, None]).to(torch.int32)


def apply_assignment_error(generator: torch.Generator, bits, p01: float,
                           p10: float) -> torch.Tensor:
    """Flip bits with asymmetric assignment-error probabilities: a 0
    reads 1 with probability ``p01``, a 1 reads 0 with ``p10``."""
    bits = torch.as_tensor(bits, device=generator.device)
    u = torch.rand(bits.shape, generator=generator, device=generator.device)
    p_flip = torch.where(bits == 0, float(p01), float(p10))
    return torch.where(u < p_flip, 1 - bits, bits)


class IQReadoutModel:
    """Gaussian IQ-cloud readout: state -> IQ point -> discriminated bit.

    ``centers0``/``centers1``: complex ``[n_cores]`` cloud centres;
    ``sigma``: cloud standard deviation (same units).
    """

    def __init__(self, centers0, centers1, sigma: float):
        self.c0 = np.asarray(centers0, complex)
        self.c1 = np.asarray(centers1, complex)
        self.sigma = float(sigma)

    def sample_iq(self, generator: torch.Generator, states) -> torch.Tensor:
        """states ``[S, C]`` (0/1) -> IQ points ``[S, C, 2]`` float32."""
        dev = generator.device
        states = torch.as_tensor(states, device=dev)
        c0, c1 = (torch.as_tensor(
            np.stack([c.real, c.imag], -1).astype(np.float32), device=dev)
            for c in (self.c0, self.c1))
        mean = torch.where(states[..., None] == 1, c1[None], c0[None])
        noise = self.sigma * torch.randn(mean.shape, generator=generator,
                                         device=dev)
        return mean + noise

    def measure(self, generator: torch.Generator, states):
        """states ``[S, C]`` -> (bits ``[S, C]``, iq ``[S, C, 2]``)."""
        iq = self.sample_iq(generator, states)
        return discriminate(iq, self.c0, self.c1), iq
