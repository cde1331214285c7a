"""The K1 kernels' host side on the CPU: the span table and the tile
geometry (``distributed_processor_tpu_torch/ops/exec_span.py``).

``span_table`` checks a program's operands and moves the program to the
run's device once per program content: a second ``simulate_batch`` of a
program with the same content reuses the table, and the checks refuse
bad element geometry, ``x90_amp`` and bounds with the messages the
kernel wrappers gave.  ``tile_geometry``, with the lane -> warp -> slot
map of the tile kernel (``csrc/exec_span.cu`` ``exec_tile_kernel``)
restated below, cuts a ``[B, C]`` carry into every lane exactly once,
each warp one core's consecutive shots, inside the shared-memory
budget.  The kernels themselves, and so their own map, run on the card
(``tests/test_torch_cuda.py``: ragged tiles, every key identical).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_program)
from distributed_processor_tpu_torch.ops.exec_span import (
    SMEM_BUDGET, TILE_SHOTS, TILE_WARPS, _span_table_of, _tile_arg,
    span_table, tile_geometry)
from distributed_processor_tpu_torch.sim import interpreter
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, _element_geometry, _soa_np, simulate_batch)


def tile_slots(geom, C: int) -> np.ndarray:
    """``[lanes]``: the word of each lane of a tile in a staged column,
    as the tile kernel computes it: lane ``t * C + c`` (``t`` its shot in
    the tile) is item ``t // 32 * C + c``, word ``item * pitch + t %
    32``."""
    t, c = np.divmod(np.arange(geom.lanes), C)
    return (t // TILE_SHOTS * C + c) * geom.pitch + t % TILE_SHOTS


def tile_lanes(geom, B: int, C: int) -> np.ndarray:
    """``[n_tiles, items, 32]``: the carry lane (``shot * C + core``)
    that thread ``s`` of the warp serving ``item`` handles in each tile,
    -1 past the last shot, as the tile kernel maps them: item ``j * C +
    c`` is core ``c`` of the tile's shots ``32 j .. 32 j + 31``."""
    items = geom.sub * C
    item, s = np.meshgrid(np.arange(items), np.arange(TILE_SHOTS),
                          indexing='ij')
    local = (item // C * TILE_SHOTS + s) * C + item % C
    lane = np.arange(geom.n_tiles)[:, None, None] * geom.lanes + local
    return np.where(lane < B * C, lane, -1)


def _program():
    qubits = ['Q0', 'Q1']
    return compile_to_machine(active_reset(qubits)
                              + rb_program(qubits, 2, seed=3),
                              make_default_qchip(2), n_qubits=2)


def _cfg(mp, **kw):
    return InterpreterConfig(max_steps=2 * mp.n_instr + 64,
                             max_pulses=mp.max_pulses_per_core(1) + 4,
                             max_meas=2, max_resets=2, engine='pallas', **kw)


def test_span_table_built_once_per_program(monkeypatch):
    """Two ``simulate_batch`` runs of two compiles of one program build
    one span table; the second run reuses it."""
    tables = []
    kernel = interpreter.exec_span

    def capture(st, table, *args, **kw):
        tables.append(table)
        return kernel(st, table, *args, **kw)

    monkeypatch.setattr(interpreter, 'exec_span', capture)
    _span_table_of.cache_clear()
    rng = np.random.default_rng(4)
    outs = []
    for _ in range(2):
        mp = _program()
        bits = rng.integers(0, 2, (16, mp.n_cores, 2)).astype(np.int32)
        outs.append(simulate_batch(mp, bits, cfg=_cfg(mp), device='cpu'))
        want = simulate_batch(mp, bits, cfg=dataclasses.replace(
            _cfg(mp), engine='straightline'), device='cpu')
        for key in want:
            assert torch.equal(outs[-1][key], want[key]), key
    assert len(tables) == 2 and tables[0] is tables[1]
    info = _span_table_of.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert tables[0].prog.device.type == 'cpu'
    assert np.array_equal(tables[0].prog.numpy(), _soa_np(mp))


@pytest.mark.parametrize('what,match', [
    ('spc0', 'geometry'), ('interp_neg', 'geometry'),
    ('interp_huge', 'geometry'), ('x90_neg', 'x90_amp'),
    ('x90_big', 'x90_amp'), ('meas0', 'max_meas'), ('pulses0', 'max_meas'),
])
def test_span_table_refuses_bad_operands(what, match):
    """The kernel's truncating division agrees with the plain version's
    floor only on non-negative operands that do not overflow: the table
    refuses the rest when it is built."""
    mp = _program()
    soa = _soa_np(mp)
    spc, interp = _element_geometry(mp)
    cfg, fused = _cfg(mp), False
    if what == 'spc0':
        spc = np.zeros_like(spc)
    elif what == 'interp_neg':
        interp = interp - 5
    elif what == 'interp_huge':
        interp = np.full_like(interp, 2**20)
    elif what.startswith('x90'):
        fused = True
        cfg = dataclasses.replace(
            cfg, x90_amp=-1 if what == 'x90_neg' else 2**30)
    elif what == 'meas0':
        cfg = dataclasses.replace(cfg, max_meas=0)
    else:
        cfg = dataclasses.replace(cfg, max_pulses=0)
    with pytest.raises(ValueError, match=match):
        span_table(soa, spc, interp, cfg, 'cpu', fused=fused)
    # the same operands with a good table build
    if what in ('x90_neg', 'x90_big'):
        span_table(soa, spc, interp, cfg, 'cpu', fused=False)


def test_span_table_keys_the_device_once():
    """A device named as a string or as a ``torch.device`` is one cache
    entry: the same table comes back."""
    mp = _program()
    spc, interp = _element_geometry(mp)
    args = (_soa_np(mp), spc, interp, _cfg(mp))
    assert span_table(*args, 'cpu') is span_table(*args, torch.device('cpu'))


def test_span_table_refuses_a_misshapen_program():
    mp = _program()
    spc, interp = _element_geometry(mp)
    with pytest.raises(ValueError, match='do not fit'):
        span_table(_soa_np(mp)[:1], spc, interp, _cfg(mp), 'cpu')


@pytest.mark.parametrize('blocks', [False, True])
@pytest.mark.parametrize('C', [1, 3, 8, 16])
@pytest.mark.parametrize('B', [1, 31, 32, 33, 4097])
def test_tile_geometry_covers_every_lane_once(B, C, blocks):
    """The tile kernel's cut of a ``[B, C]`` carry: every lane exactly
    once, each warp's lanes one core's consecutive shots inside its
    tile's contiguous segment, each lane its own word of a staged column,
    within the shared-memory budget."""
    geom = tile_geometry(B, C, blocks)
    assert geom is not None and geom.smem <= SMEM_BUDGET
    items = geom.sub * C
    assert geom.lanes == items * TILE_SHOTS
    assert 1 <= geom.warps <= min(items, TILE_WARPS)
    slots = tile_slots(geom, C)
    assert len(set(slots.tolist())) == geom.lanes
    assert slots.min() >= 0 and slots.max() < geom.kst
    lanes = tile_lanes(geom, B, C)
    assert lanes.shape == (geom.n_tiles, items, TILE_SHOTS)
    got = np.sort(lanes[lanes >= 0])
    assert np.array_equal(got, np.arange(B * C))
    tile = np.arange(geom.n_tiles)[:, None, None]
    for t, warp in zip(*np.nonzero((lanes >= 0).any(-1))):
        row = lanes[t, warp]
        row = row[row >= 0]
        assert np.all(row % C == warp % C)          # one core per warp
        assert np.all(np.diff(row // C) == 1)       # consecutive shots
    ok = lanes >= 0
    assert np.all((lanes // geom.lanes == tile)[ok])
    # a lane past the last shot is masked, never one before it
    assert np.all(np.diff(ok.astype(int), axis=-1) <= 0)


@pytest.mark.parametrize('C', [1, 2, 4, 8, 16])
def test_tile_slots_spread_over_the_banks(C):
    """Both ways the kernel touches a staged column hit 32 distinct
    banks of shared memory: a warp serving an item (its 32 shots) and 32
    consecutive threads staging 32 consecutive lanes."""
    geom = tile_geometry(4096, C, blocks=True)
    slots = tile_slots(geom, C)
    items = geom.sub * C
    for item in range(items):
        warp = item * geom.pitch + np.arange(TILE_SHOTS)
        assert len(set(warp % 32)) == 32
    for start in range(0, geom.lanes, 32):
        assert len(set(slots[start:start + 32] % 32)) == 32


def _dur(n: int, spc: int) -> int:
    """The tile kernel's division of a pulse's sample count by the samples
    per clock (csrc/exec_span.cu make_dur, pulse_dur): ``(n * m) >> (31 +
    l)`` with ``l = ceil(log2 spc)``, ``m = ceil(2**(31 + l) / spc)``."""
    ell = (spc - 1).bit_length()
    m = -(-(1 << (31 + ell)) // spc)
    assert m < 2**32
    return (n * m) >> (31 + ell)


@pytest.mark.parametrize('spc', [1, 2, 3, 4, 7, 16, 1000, 2**20 + 1,
                                 2**30 - 1, 2**30 + 1, 2**31 - 1])
def test_multiply_shift_division_is_exact(spc):
    """On the numerators the wrapper admits (``[0, 2**31)``) the
    multiply-shift equals the floor division, at the edges of every
    multiple and on seeded draws."""
    rng = np.random.default_rng(spc % 1000)
    top = 2**31 - 1
    ns = [0, 1, spc - 1, spc, spc + 1, top, top - spc, top // spc * spc,
          top // spc * spc - 1] + rng.integers(0, 2**31, 500).tolist()
    for n in ns:
        if 0 <= n < 2**31:
            assert _dur(n, spc) == n // spc, n


def test_tile_geometry_falls_back_past_the_budget():
    """A tile too wide for shared memory runs the one-thread-per-lane
    kernel (a zero tile argument); one that fits passes its geometry."""
    assert tile_geometry(64, 64, blocks=True) is None
    assert list(_tile_arg(64, 64, True)) == [0, 0, 0, 0]
    geom = tile_geometry(64, 8, blocks=True)
    assert list(_tile_arg(64, 8, True)) == list(geom[:4])
    assert list(_tile_arg(64, 8, True, True)) == [0, 0, 0, 0]
