"""Two-qubit Clifford randomized benchmarking sequences.

The single-qubit module (models/rb.py) realises the 24-element C1 group
as virtual-Z Euler sequences; this module provides genuine *two-qubit*
RB over the full 11,520-element two-qubit Clifford group C2, with the
entangling content supplied by the calibrated CZ gate (exact under the
statevec device model — sim/device.py).

Rather than transcribing a literature coset decomposition, the group is
generated numerically: a breadth-first closure over the generator set
{24 C1 on qubit a, 24 C1 on qubit b, CZ} with projective deduplication.
Each element is stored with its generator word, so sequence emission,
inverse lookup (the recovery Clifford), and exact survival predictions
all come from the same table.  BFS from these generators provably
reaches all of C2 (C1 x C1 and CZ generate it); the 11,520 count is
asserted at build time.

Survival under a pure two-qubit depolarizing channel of probability p
per CZ (DeviceModel.depol2_per_pulse) is EXACTLY
``P = 1/4 + 3/4 * (1 - 16 p / 15)^n_cz`` for a sequence with ``n_cz``
CZ pulses — global depolarization commutes with every Clifford — which
is what tests/test_rb2q.py pins the trajectory engine against.  A copy
of the JAX package's ``models/rb2q.py`` (numpy only).
"""

from __future__ import annotations

import functools

import numpy as np

from .rb import clifford_table, clifford_instructions

_CZ = np.diag([1.0, 1.0, 1.0, -1.0]).astype(complex)
N_CLIFFORD2 = 11520


def _canon_keys(us: np.ndarray) -> list[bytes]:
    """Projective canonical byte keys for a batch of unitaries [N,4,4]:
    divide out the phase of the first above-threshold entry, round."""
    flat = us.reshape(len(us), 16)
    first = np.argmax(np.abs(flat) > 0.25, axis=1)   # |entries| of a 4x4
    pivot = flat[np.arange(len(us)), first]          # unitary: max >= 1/2
    canon = flat / (pivot / np.abs(pivot))[:, None]
    canon = np.round(canon, 8) + (0.0 + 0.0j)        # kill -0.0 (re AND im)
    return [c.tobytes() for c in canon]


@functools.lru_cache()
def clifford2_table():
    """The two-qubit Clifford group as ``(words, unitaries, index)``:
    ``words[i]`` is a tuple of generator ids (0..23 = C1 on qubit a,
    24..47 = C1 on qubit b, 48 = CZ), ``unitaries[i]`` the 4x4 matrix
    (qubit a = MSB), ``index`` the canonical-key -> i lookup."""
    _, c1 = clifford_table()
    gens = np.concatenate([
        np.stack([np.kron(u, np.eye(2)) for u in c1]),
        np.stack([np.kron(np.eye(2), u) for u in c1]),
        _CZ[None]])                                   # [49, 4, 4]
    words = [()]
    unitaries = [np.eye(4, dtype=complex)]
    index = {_canon_keys(np.eye(4)[None])[0]: 0}
    frontier = [0]
    while frontier:
        fu = np.stack([unitaries[i] for i in frontier])
        prod = np.einsum('gxy,fyz->fgxz', gens, fu)   # gen AFTER element
        keys = _canon_keys(prod.reshape(-1, 4, 4))
        nxt = []
        for fi, i in enumerate(frontier):
            for g in range(len(gens)):
                k = keys[fi * len(gens) + g]
                if k not in index:
                    index[k] = len(words)
                    words.append(words[i] + (g,))
                    unitaries.append(prod[fi, g])
                    nxt.append(index[k])
        frontier = nxt
    assert len(words) == N_CLIFFORD2, len(words)
    return words, np.stack(unitaries), index


def inverse2_index(net: np.ndarray) -> int:
    """Table index of the Clifford inverting ``net`` (projectively)."""
    return element_index(np.asarray(net).conj().T)


def rb2q_sequence(rng, depth: int) -> list[int]:
    """Uniform random C2 indices of length ``depth`` plus the recovery."""
    words, unitaries, _ = clifford2_table()
    seq = [int(rng.integers(N_CLIFFORD2)) for _ in range(depth)]
    net = np.eye(4, dtype=complex)
    for i in seq:
        net = unitaries[i] @ net
    seq.append(inverse2_index(net))
    return seq


def clifford2_instructions(qa: str, qb: str, index: int) -> list[dict]:
    """One C2 element as compiler-input instructions.  Every CZ is
    fenced with barriers so the *schedule* (the physical ground truth
    the statevec engine replays in time order) serializes the
    entangler against both qubits' single-qubit pulses."""
    words, _, _ = clifford2_table()
    out = []
    for g in words[index]:
        if g < 24:
            out += clifford_instructions(qa, g)
        elif g < 48:
            out += clifford_instructions(qb, g - 24)
        else:
            out += [{'name': 'barrier', 'qubit': [qa, qb]},
                    {'name': 'CZ', 'qubit': [qa, qb]},
                    {'name': 'barrier', 'qubit': [qa, qb]}]
    return out


def count_cz(indices) -> int:
    """Total CZ pulses a sequence of C2 indices compiles to — the
    exponent of the exact depol2 survival prediction."""
    words, _, _ = clifford2_table()
    return sum(1 for i in indices for g in words[i] if g == 48)


def rb2q_program(qa: str, qb: str, depth: int, rng=None, seed: int = 0,
                 delay_before: float = 500e-9) -> tuple[list[dict], dict]:
    """A full two-qubit RB program: ``depth`` random C2 Cliffords plus
    the recovery, ending in a read on both qubits.  Returns
    ``(program, info)`` with ``info['n_cz']`` (for exact survival
    predictions) and ``info['indices']``."""
    rng = rng or np.random.default_rng(seed)
    seq = rb2q_sequence(rng, depth)
    return _emit_program(qa, qb, seq, delay_before)


def depol2_survival(p2: float, n_cz: int) -> float:
    """Exact |00> survival under depol2-only errors (see module doc)."""
    return 0.25 + 0.75 * (1.0 - 16.0 * p2 / 15.0) ** n_cz


def element_index(u: np.ndarray) -> int:
    """Table index of the C2 element projectively equal to ``u``."""
    _, _, index = clifford2_table()
    key = _canon_keys(np.asarray(u, complex)[None])[0]
    try:
        return index[key]
    except KeyError:
        raise ValueError('not a two-qubit Clifford')


def _emit_program(qa: str, qb: str, seq, delay_before: float
                  ) -> tuple[list[dict], dict]:
    """Shared emission tail: instructions for ``seq``, barrier, reads,
    and the info dict both RB program builders return."""
    program = [{'name': 'delay', 't': delay_before}]
    for i in seq:
        program += clifford2_instructions(qa, qb, i)
    program.append({'name': 'barrier', 'qubit': [qa, qb]})
    program += [{'name': 'read', 'qubit': [qa]},
                {'name': 'read', 'qubit': [qb]}]
    return program, {'indices': seq, 'n_cz': count_cz(seq)}


def rb2q_interleaved_program(qa: str, qb: str, depth: int, rng=None,
                             seed: int = 0,
                             delay_before: float = 500e-9
                             ) -> tuple[list[dict], dict]:
    """Interleaved two-qubit RB with the calibrated CZ as the target
    gate: each random C2 Clifford is followed by a bare CZ, and the
    recovery inverts the FULL product (C2 is a group, so the net is
    still an element and the recovery is exact).  Comparing the decay
    against the reference curve (:func:`rb2q_program` with the same
    depths) isolates the interleaved gate's error:
    ``alpha_CZ = alpha_int / alpha_ref``, ``EPC_CZ = 3/4 (1 - alpha_CZ)``
    — the standard interleaved-RB estimator, exact here for
    depolarizing errors.  Returns ``(program, info)`` with
    ``info['n_cz']`` counting every CZ pulse (random Cliffords' own
    plus the ``depth`` interleaves plus the recovery's)."""
    rng = rng or np.random.default_rng(seed)
    words, unitaries, _ = clifford2_table()
    cz_idx = element_index(_CZ)
    seq = []
    net = np.eye(4, dtype=complex)
    for _ in range(depth):
        i = int(rng.integers(N_CLIFFORD2))
        seq += [i, cz_idx]
        net = _CZ @ unitaries[i] @ net
    seq.append(inverse2_index(net))
    return _emit_program(qa, qb, seq, delay_before)
