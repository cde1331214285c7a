"""On the card (marker ``cuda``): each cell at its own size is correct,
and its control fails the comparison.

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import importlib

import pytest

from benchmark.harness.cell import Context, run_cell
from benchmark.harness.common import Cell

pytestmark = pytest.mark.cuda

CELLS = ('rb8_reset.campaign', 'rb8_reset.tenants', 'rep8_lut.stream')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return 'cuda'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_correct_on_the_card(card, cell):
    result, checks = run_cell(cell, 2 ** 34 + 17, 3.0, False, device=card)
    assert result['correct'], checks


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_on_the_card(card, cell):
    c = Cell(cell)
    driver = importlib.import_module(f'benchmark.drivers.{c.traffic["driver"]}')
    ctx = Context(c, 2 ** 34 + 19, 3.0, False, card)
    st = driver.setup(ctx)
    driver.release(st)
    checks = driver.control(ctx, st, 4)
    assert any(v > lim for _n, v, lim in checks), checks
