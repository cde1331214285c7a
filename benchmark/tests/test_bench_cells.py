"""Each cell end to end on the CPU at a small size: the port agrees
with the plain reference (``correct``), the control does not, and the
result line carries what the contract asks for."""

from __future__ import annotations

import importlib

import pytest

from benchmark.harness.cell import Context
from benchmark.harness.common import Cell
from benchmark.tests.bench_small import SECONDS, SIZES, run_small

CELLS = sorted(SIZES)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_correct_on_cpu(cell):
    result, checks = run_small(cell, 2 ** 33 + 7)
    assert result['correct'], checks
    assert all(value == 0 for _n, value, _l in checks)
    assert result['attempted'] > 0 and result['failed'] == 0
    names = {m['name'] for m in Cell(cell).end_to_end}
    assert set(result['metrics']) == names and 'setup_s' in names
    assert all(m['value'] > 0 for m in result['metrics'].values())


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reads_per_layer_metrics(cell):
    result, _checks = run_small(cell, 2 ** 31 + 3, trace=True)
    assert result['correct']
    dev = result['device']
    assert dev['window_s'] > 0 and dev['busy_s'] >= 0
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # no CUDA kernels on the CPU: the device-trace metrics stay silent,
    # the program's counters and spans do not
    per = {m['name']: m['source'] for m in Cell(cell).per_layer}
    assert set(result['metrics']) == {n for n, s in per.items()
                                      if s != 'device_trace'}


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_comparison(cell):
    """The reference with its feed-forward broken (every fproc or LUT
    read serves 0), put in the port's place, fails a compared number."""
    c = Cell(cell)
    ctx = Context(c, 12345, SECONDS[cell], False, 'cpu', SIZES[cell])
    driver = importlib.import_module(f'benchmark.drivers.{c.traffic["driver"]}')
    st = driver.setup(ctx)
    driver.release(st)
    checks = driver.control(ctx, st, 2)
    assert any(value > limit for _n, value, limit in checks), checks
