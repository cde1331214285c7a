"""Every generator repeats exactly for a seed and differs across seeds;
the open loop offers every seed the same gaps in another order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.drivers import physics_batches, rounds_stream
from benchmark.drivers import service_open_loop as sol
from benchmark.programs import reset_rb

SEEDS = (2 ** 31 + 5, 2 ** 33 + 1)


def _init(seed):
    return physics_batches._init_states(seed, 3, 4096, 8, 0.15, 'cpu')


GENERATORS = {
    'campaign initial states': _init,
    'tenants arrivals': lambda s: sol.schedule(s, 25.0, 20.0),
    'tenants programs': lambda s: sol.assignment(s, 300, 64),
    'tenants bits': lambda s: np.stack(sol.bit_pool(s, 2, 256, 8,
                                                    [0.15, 0.5])),
    'tenants program pool': lambda s: np.array([repr(p) for p in
                                                reset_rb.sources(
                                                    {'n_qubits': 8,
                                                     'depth': 12},
                                                    n_programs=3, seed=s)]),
    'stream bits': lambda s: np.stack(rounds_stream.make_pool(
        s, 2, 6, 64, 8, 2, 0.02)),
}


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize('name', sorted(GENERATORS))
def test_generator_repeats_and_differs(name):
    gen = GENERATORS[name]
    assert _same(gen(SEEDS[0]), gen(SEEDS[0]))
    assert not _same(gen(SEEDS[0]), gen(SEEDS[1]))


def test_arrivals_same_gaps_every_seed():
    a, b = (sol.schedule(s, 25.0, 20.0) for s in SEEDS)
    ga, gb = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    np.testing.assert_allclose(np.sort(ga), np.sort(gb))
    assert len(a) == 500
    # exponential quantiles: the mean gap is within 1 % of 1 / rate
    assert abs(ga.mean() * 25.0 - 1.0) < 0.01


def test_programs_cycle_through_the_pool():
    w = sol.assignment(SEEDS[0], 130, 64)
    assert sorted(w[:64]) == list(range(64))
    assert sorted(w[64:128]) == list(range(64))


def test_stream_bits_are_noisy_codewords():
    bits = rounds_stream.make_pool(SEEDS[0], 1, 50, 2048, 8, 2, 0.02)[0]
    assert not bits[..., 1].any()
    word = (bits[..., 0].sum((0, 2)) * 2 > 50 * 8).astype(int)
    flips = bits[..., 0] ^ word[None, :, None]
    assert abs(flips.mean() - 0.02) < 0.002
