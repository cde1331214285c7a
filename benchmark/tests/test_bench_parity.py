"""The GHZ parity-scan cell on the CPU at a small size: the port agrees
with the density-matrix reference (``correct``), the controls (the
reference held at half precision, and with the reset's feed-forward
removed) do not, the benchmark's frozen reference equals the port's on
the same schedule, and the cell's metric readers read the port's spans
and return nothing, without raising, where there is nothing to read."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from benchmark.harness.cell import Context, read_metric, run_cell
from benchmark.harness.common import Cell

CELL = 'ghz8_reset.parity_scan'
# one batch takes about 2 s on the CPU whatever its shots (the engine's
# eager steps); the window runs on until all 9 programs have run
SIZES = dict(shots=256, keep_batches=1, trace_seconds=0.2)
SECONDS = 2.0


def test_parity_scan_correct_on_cpu():
    result, checks = run_cell(CELL, 2 ** 33 + 11, SECONDS, False,
                              device='cpu', sizes=SIZES)
    assert result['correct'], checks
    got = {n: (v, lim) for n, v, lim in checks}
    assert got['programs_not_compared'][0] == 0
    drift, limit = got['norm_drift_median_worst']
    assert 0 <= drift < limit
    assert got['kept_shots_differing'][0] == 0
    assert result['attempted'] > 0 and result['failed'] == 0
    names = {m['name'] for m in Cell(CELL).end_to_end}
    assert set(result['metrics']) == names == {'shots_per_s', 'setup_s'}


def test_parity_scan_control_fails():
    """The reference held at float16 fails the norm and nothing else;
    without the feed-forward it fails the histogram and the kept shots."""
    cell = Cell(CELL)
    ctx = Context(cell, 12345, SECONDS, False, 'cpu', SIZES)
    driver = importlib.import_module(
        f'benchmark.drivers.{cell.traffic["driver"]}')
    st = driver.setup(ctx)
    driver.release(st)
    # three batches, for time: six programs go uncompared
    checks = {n: (v, lim) for n, v, lim in driver.control(ctx, st, 3)}
    assert [n for n, (v, lim) in checks.items() if v > lim] == \
        ['norm_drift_median_worst', 'programs_not_compared'], checks
    checks = {n: (v, lim)
              for n, v, lim in driver.control_feedforward(ctx, st, 3)}
    assert checks['outcome_chi2_worst_share_of_critical'][0] > 1.0, checks
    assert checks['kept_shots_differing'][0] > 0, checks
    assert checks['norm_drift_median_worst'][0] < 1e-12, checks


@pytest.mark.parametrize('dtype,lost', [('float64', False),
                                        ('float16', True)])
def test_held_reference_rounds_its_trace_away(dtype, lost):
    """Held at float64 the reference is unchanged; at float16 rounding
    loses more of the trace than the cell's limit, while the normalized
    distribution stays within a few parts in a thousand."""
    import torch
    from benchmark.drivers import parity_batches
    from benchmark.programs import ghz_parity
    from benchmark.reference import density
    cf = Cell(CELL).config
    program = dict(cf['program'], n_qubits=4)
    qchip = ghz_parity.qchip_source(program)
    rmp = ghz_parity.reference_program(
        program, ghz_parity.sources(program)[0], qchip)
    ch = density.channels_from_config(
        cf, ghz_parity.reference_couplings(rmp, qchip), 4)
    p = density.outcome_distribution(rmp, ch, -1)
    q = density.outcome_distribution(
        rmp, density.held_in(ch, getattr(torch, dtype)), -1)
    if not lost:
        np.testing.assert_array_equal(q, p)
        return
    assert 1.0 - q.sum() > parity_batches.NORM_DRIFT
    assert np.abs(q / q.sum() - p).max() < 5e-3


@pytest.mark.parametrize('feedback', [True, False])
def test_frozen_density_reference_equals_the_ports(feedback):
    """``benchmark/reference/density.py`` (the frozen oracle's schedule,
    the configuration's channels) and the port's
    ``sim/density_reference.py`` (the port's oracle and model) give the
    same distribution, on the Z-basis program and two analysis phases."""
    from distributed_processor_tpu_torch.sim.density_reference import \
        outcome_distribution
    from benchmark.drivers import parity_batches
    from benchmark.programs import ghz_parity
    from benchmark.reference import density
    cf = Cell(CELL).config
    program = dict(cf['program'], n_qubits=4)
    qchip = ghz_parity.qchip_source(program)
    for k in (0, 1, 3):
        src = ghz_parity.sources(program)[k]
        mp = ghz_parity.port_program(program, src, qchip)
        rmp = ghz_parity.reference_program(program, src, qchip)
        cps = ghz_parity.port_couplings(mp, qchip)
        assert ghz_parity.reference_couplings(rmp, qchip) == cps
        port = outcome_distribution(
            mp, parity_batches.port_model(cf, cps), -1, feedback=feedback)
        frozen = density.outcome_distribution(
            rmp, density.channels_from_config(cf, cps, 4), -1,
            feedback=feedback)
        np.testing.assert_allclose(frozen, port, rtol=0, atol=1e-12)


def test_span_readers_read_a_statevec_batch(monkeypatch):
    """On a synthetic statevec batch of two engine steps: the syncs are
    the step loop's waits under ``physics.batch`` (and the reduce's), the
    exec hop's enqueue is ``physics.exec``'s self time without its
    ``statevec.apply`` and wait children, as the campaign reads them."""
    trace = pytest.importorskip('distributed_processor_tpu_torch.obs.trace')
    ring = trace.HostSpanRing()
    monkeypatch.setattr(trace, 'HOST_SPANS', ring)
    n = iter(range(1, 100))

    def add(name, t0, t1, parent=None):
        i = next(n)
        ring.append(dict(name=name, t0=t0, t1=t1, args={}, id=i,
                         parent=parent, thread=1))
        return i
    b = add('physics.batch', 0, 10_000_000)
    e = add('physics.epoch', 0, 9_000_000, b)
    x = add('physics.exec', 0, 8_000_000, e)
    for k in range(2):
        t = 4_000_000 * k
        add('h2d.wait', t, t + 100_000, x)
        add('statevec.apply', t + 100_000, t + 2_100_000, x)
        add('step.wait', t + 2_100_000, t + 2_600_000, x)
    s = add('sweep.stats', 10_000_000, 10_500_000)
    add('physics.wait', 10_000_000, 10_200_000, s)
    r = dict(events=dict(window=(0, 20_000_000), device=[], spans=[],
                         outside=0), work={}, window={},
             layers=lambda layer: [])
    assert read_metric('host_syncs_per_batch.parity_scan', r) == 5.0
    assert read_metric('exec_enqueue_ms_per_batch.parity_scan', r) == \
        pytest.approx(8.0 - 2 * 2.6)
    assert read_metric('statevec_host_ms_per_batch.parity_scan', r) == \
        pytest.approx(4.0)
    for name in ('host_syncs_per_batch', 'exec_enqueue_ms_per_batch'):
        assert read_metric(f'{name}.parity_scan', r) == \
            read_metric(f'{name}.campaign', r)


def test_metric_readers_silent_without_readings():
    """A run whose port records no spans, returns no gate counters and
    launches no kernels (the parent side of a new cell) reads nothing."""
    rec = dict(events=dict(device=[], spans=[], window=(0, 1), outside=0),
               work={}, window={}, layers=lambda layer: [])
    for m in Cell(CELL).per_layer:
        assert read_metric(m['name'], rec) is None, m['name']
    rec['work'] = dict(gate_stall_steps=30, live_core_steps=120)
    assert read_metric('gate_stall_pct.parity_scan', rec) == 25.0
