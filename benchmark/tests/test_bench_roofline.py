"""The roofline's counts at the headline sizes equal the bounds that
``chip_smoke.py`` restates: K2 2.441 ms per epoch of 262144 x 8
full-length windows (issue-bound), K1 span 0.1780 ms for 74.4 M rows of
the headline program on seeded injected bits (operations)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.programs import reset_rb
from benchmark.reference import lanes
from benchmark.roofline import exec_rows, peaks, resolve

PROGRAM = {'n_qubits': 8, 'depth': 12, 'rb_seed': 1234}


def test_peaks():
    assert peaks.INT32_OPS_PER_S == pytest.approx(1.673e13, rel=1e-3)
    assert peaks.ISSUE_PER_S == pytest.approx(3.345e13, rel=1e-3)


def test_resolve_epoch_bound():
    windows = 262144 * 8
    s, bound = resolve.least_seconds(windows, windows * 1024)
    assert bound == 'issue'
    assert s * 1e3 == pytest.approx(2.441, abs=5e-4)


def test_exec_rows_bound_at_the_headline():
    src = reset_rb.sources(PROGRAM)[0]
    q = reset_rb.qchip_source(PROGRAM)
    mp = reset_rb.reference_program(PROGRAM, src, q)
    table = lanes.InjectedTable(mp, {}, 2, 2)
    # uniform injected bits: each core's reset read is 1 half the time
    codes = np.arange(1 << len(table.reads))
    retired = table.table(codes)['retired'].sum(1).mean()
    rows = 262144 * retired
    assert rows / 1e6 == pytest.approx(74.4, abs=0.05)
    s, bound = exec_rows.least_seconds(int(rows), 0)
    assert bound == 'operations'
    assert s * 1e3 == pytest.approx(0.1780, abs=5e-4)


def test_readout_window_samples_of_the_headline():
    src = reset_rb.sources(PROGRAM)[0]
    mp = reset_rb.reference_program(PROGRAM, src,
                                    reset_rb.qchip_source(PROGRAM))
    table = lanes.physics_table(mp, np.zeros((1, 8), np.int64), 2, 2, 31457)
    # two full-length windows of 1024 samples per core
    assert table['window_samples'].tolist() == [[2048] * 8]
    assert table['n_meas'].tolist() == [[2] * 8]


def test_result_bytes():
    assert exec_rows.result_bytes(1, 1, 2, 1) == 4 * (30 + 1 + 4) + 1
