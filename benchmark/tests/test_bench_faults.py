"""A run with the timed path broken underneath reads ``correct`` false.

Each fault is planted in the port (the run's look for a card is skipped:
these run on the CPU at a small size) for every cell that can have it:
a step that returns its state unchanged; half of the batch left out, the
mean taken over the rest; an answer altered where it is produced.  No
cell exchanges anything between chips (all take one), so that fault has
no place here.
"""

from __future__ import annotations

import pytest
import torch

import distributed_processor_tpu_torch.parallel as par
import distributed_processor_tpu_torch.serve.service as service
import distributed_processor_tpu_torch.sim.interpreter as interp
import distributed_processor_tpu_torch.sim.physics as physics
from benchmark.tests.bench_small import run_small


def _half(axis: int):
    """The first half of the lanes along ``axis`` tiled over the rest:
    half of the batch left out (leaves ``[rounds, shots, ...]`` of a
    rounds call, ``[programs, shots, ...]`` of a coalesced batch)."""
    def wrap(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            return {k: _tile_half(v, axis) for k, v in out.items()}
        return wrapped
    return wrap


def _tile_half(v, axis: int):
    if torch.is_tensor(v) and v.ndim > axis + 1 and v.shape[axis] >= 2:
        n = v.shape[axis] // 2
        h = v.narrow(axis, 0, n)
        return torch.cat([h, h, v.narrow(axis, 2 * n, v.shape[axis] - 2 * n)],
                         dim=axis)
    return v


def _half_mean(fn):
    """Sums over the first half of the shots, doubled: the mean of half
    the batch taken for the whole."""
    def wrapped(out):
        B = out['meas_bits'].shape[0]
        half = {k: (v[: B // 2] if torch.is_tensor(v) and v.ndim >= 1
                    and v.shape[0] == B else v) for k, v in out.items()}
        return {k: 2 * v for k, v in fn(half).items()}
    return wrapped


def _flip(key: str, index: tuple):
    def wrap(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            v = out[key]
            v = v.clone() if torch.is_tensor(v) else v.copy()
            v[index] = 1 - v[index] if key != 'n_pulses' else v[index] + 1
            return dict(out, **{key: v})
        return wrapped
    return wrap


def _flip_first_correction(fn):
    def wrapped(hist, scheme):
        out = fn(hist, scheme).clone()
        out[0, 0] = 1 - out[0, 0]
        return out
    return wrapped


def _unchanged_straightline(st, *a, **k):
    return st


def _unchanged_loop(st, steps, paused, *a, **k):
    return st, steps, paused


def _unchanged_span(st, *a, **k):
    return st


FAULTS = {
    'rb8_reset.campaign': {
        'state unchanged': (physics, '_exec_straightline',
                            lambda fn: _unchanged_straightline),
        'half the batch': (par, 'physics_batch_stats', _half_mean),
        'answer altered': (physics, 'run_physics_batch',
                           _flip('meas_bits', (0, 0, 0))),
    },
    'rb8_reset.tenants': {
        'state unchanged': (interp, '_exec_loop', lambda fn: _unchanged_loop),
        'half the batch': (service, 'simulate_multi_batch', _half(1)),
        'answer altered': (service, 'demux_multi_batch',
                           _flip('n_pulses', (0, 0))),
    },
    'rep8_lut.stream': {
        'state unchanged': (interp, 'exec_span', lambda fn: _unchanged_span),
        'half the batch': (interp, '_run_injected', _half(1)),
        'answer altered': (interp, 'decode_history',
                           _flip_first_correction),
    },
}

CASES = [(cell, name) for cell, faults in sorted(FAULTS.items())
         for name in faults]


@pytest.mark.parametrize('cell,fault', CASES)
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    module, attr, make = FAULTS[cell][fault]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    result, checks = run_small(cell, 2 ** 32 + 11)
    assert not result['correct'], (fault, checks)
