"""In-loop QEC decoders over syndrome histories, and their numpy oracles.

Counterpart of the JAX package's ``ops/decode.py``.  The torch decoders
are what :func:`..sim.interpreter.simulate_rounds` applies to the
injected syndrome history of its R rounds.  They are plain elementwise
and reduction compositions on int32 tensors, shape-polymorphic over
leading batch axes, with no data-dependent control flow: the JAX
package computes them in jnp outside any Pallas kernel, so they have no
hand kernel here either.

Two schemes, matching the two workload layouts in :mod:`..models.qec`:

* ``'majority'`` — repetition-code rounds where every data core measures
  its own qubit each round: a per-qubit strict majority over the round
  axis, then the pattern majority picks the correction (the vectorized
  ``majority_lut`` entry).
* ``'matching'`` — surface-code-cycle-shaped rounds where ancilla cores
  measure the syndrome: a per-ancilla round majority, then the exact
  minimum-weight matching on the repetition chain in closed form.

The numpy ``*_np`` functions are the host-side oracles: the brute-force
chain-matching search, which also builds :func:`..models.qec.chain_lut`,
and the literal majority-LUT walk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DECODE_SCHEMES = ('majority', 'matching')


@dataclass(frozen=True)
class DecodeSpec:
    """Which cores' injected measurement bits form the syndrome history
    and how to decode it.

    ``scheme``: one of :data:`DECODE_SCHEMES`.  ``cores``: tuple of core
    indices whose bits are the history (data cores for ``'majority'``,
    ancilla cores for ``'matching'``).  ``slot``: which per-round
    measurement slot to read (the round programs of
    :mod:`..models.qec` measure once per round: slot 0)."""
    scheme: str
    cores: tuple
    slot: int = 0

    def __post_init__(self):
        if self.scheme not in DECODE_SCHEMES:
            raise ValueError(f'decode scheme must be one of '
                             f'{DECODE_SCHEMES}; got {self.scheme!r}')
        if not self.cores:
            raise ValueError('DecodeSpec.cores must name >= 1 core')
        object.__setattr__(self, 'cores',
                           tuple(int(c) for c in self.cores))


def as_decode_spec(decode) -> DecodeSpec:
    """Coerce a :class:`DecodeSpec`, ``(scheme, cores, slot)`` tuple, or
    mapping into a validated :class:`DecodeSpec`."""
    if decode is None:
        raise ValueError('decode is None')
    if isinstance(decode, DecodeSpec):
        return decode
    if isinstance(decode, dict):
        return DecodeSpec(**decode)
    return DecodeSpec(*decode)


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def majority_vote(hist) -> torch.Tensor:
    """Per-position majority over the round axis: ``hist [..., R, K]``
    -> ``[..., K]``.  Strict majority (``2 * count > R``, ties -> 0), the
    convention of :func:`..models.repetition.majority_lut`."""
    hist = _int32(hist)
    return (2 * hist.sum(-2) > hist.shape[-2]).to(torch.int32)


def bit_majority_correction(bits) -> torch.Tensor:
    """Pattern-majority correction: ``bits [..., K]`` -> ``[..., K]``
    with bit i set iff position i disagrees with the majority of the
    pattern — the vectorized ``majority_lut`` entry."""
    bits = _int32(bits)
    maj = (2 * bits.sum(-1, keepdim=True) > bits.shape[-1]).to(torch.int32)
    return (bits != maj).to(torch.int32)


def chain_matching(synd) -> torch.Tensor:
    """Exact minimum-weight matching on the repetition chain: ``synd
    [..., A]`` (ancilla i checks data qubits i and i+1) -> correction
    ``[..., A+1]``.

    A chain error pattern ``e`` with ``s_i = e_i ^ e_{i+1}`` is fixed by
    its first bit, ``e_{i+1} = e_0 ^ (s_0 ^ ... ^ s_i)``, so the two
    syndrome-consistent candidates are the prefix parity anchored at
    ``e_0 = 0`` and its complement; the lighter one wins, ties to the
    ``e_0 = 0`` branch (the anchor :func:`chain_matching_np`'s
    enumeration order tie-breaks to)."""
    synd = _int32(synd)
    prefix = torch.cumsum(synd, dim=-1) % 2
    e0 = torch.cat([torch.zeros(synd.shape[:-1] + (1,), dtype=torch.int32,
                                device=synd.device),
                    prefix.to(torch.int32)], dim=-1)
    e1 = 1 - e0
    lighter0 = e0.sum(-1, keepdim=True) <= e1.sum(-1, keepdim=True)
    return torch.where(lighter0, e0, e1).to(torch.int32)


def decode_history(hist, scheme: str) -> torch.Tensor:
    """Decode a syndrome history ``[..., R, K]`` under ``scheme``:
    ``'majority'`` -> ``[..., K]`` (K data qubits), ``'matching'`` ->
    ``[..., K+1]`` (K ancillas check K+1 data qubits)."""
    if scheme == 'majority':
        return bit_majority_correction(majority_vote(hist))
    if scheme == 'matching':
        return chain_matching(majority_vote(hist))
    raise ValueError(f'decode scheme must be one of {DECODE_SCHEMES}; '
                     f'got {scheme!r}')


# ---------------------------------------------------------------------------
# numpy oracles (host side: the fuzz reference and the LUT builders)


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
