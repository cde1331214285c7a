"""The port's closed calibration loop against the JAX package's.

Mirrors the ``calibrate`` and session cases of tests/test_calib.py: each
knob's gradient-descent loop, its candidates submitted through the port's
``ExecutionService.submit_source`` under a ``CalibrationSession`` on the
CPU, converges, writes back to the live qchip and flushes the stale
compile-cache epoch; a diverged loop is counted and never writes back;
the session refuses use after its terminal state; the loop linearizes at
the as-executed amplitude word.  Each loop takes the JAX package's
``calibrate`` step count on the same ``LossSpec`` and reaches its
parameter to ``PARAM_ATOL`` (the gradients themselves agree to rtol 1e-5,
tests/test_torch_grad.py; float32 steps accumulate their differences).
A calibration burst through the service re-hits its compile-cache
entries with no eviction.
"""

import numpy as np
import pytest

from distributed_processor_tpu.calib import calibrate as j_calibrate
from distributed_processor_tpu.models import \
    make_default_qchip as j_default_qchip
from distributed_processor_tpu.serve import ExecutionService as JService
from distributed_processor_tpu.sim.grad import LossSpec as JLossSpec

from distributed_processor_tpu_torch.calib import (CalibrationSession,
                                                   calibrate)
from distributed_processor_tpu_torch.calib.loops import _executed_amp
from distributed_processor_tpu_torch.models import make_default_qchip
from distributed_processor_tpu_torch.models.experiments import rabi_program
from distributed_processor_tpu_torch.serve import ExecutionService
from distributed_processor_tpu_torch.sim.grad import AMP_SCALE, LossSpec
from distributed_processor_tpu_torch.utils import profiling

from test_torch_serve import T

CPU = ['cpu']
# the largest difference allowed between the port's converged parameter
# and the JAX loop's: both stop within xtol of the optimum (1e-4 for the
# amplitude), so their endpoints may differ by float32 rounding of the
# steps, far below the loop's own stopping tolerance
PARAM_ATOL = {'amp': 1e-5, 'alpha': 1e-4, 'window_start': 1e-2}


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = profiling.registry_snapshot()
    yield
    profiling.registry_restore(snap)


def _jax_loop(knob, **kw):
    """The JAX package's loop on its own default qchip."""
    qchip = j_default_qchip(2)
    spec = kw.pop('spec', None)
    with JService() as svc:
        res = j_calibrate(svc, qchip, knob=knob, qubit='Q0',
                          spec=None if spec is None else JLossSpec(**spec),
                          n_qubits=2, result_timeout=T, **kw)
        return res, svc.stats()['calibration']


def _port_loop(knob, qchip, **kw):
    spec = kw.pop('spec', None)
    with ExecutionService(devices=CPU) as svc:
        res = calibrate(svc, qchip, knob=knob, qubit='Q0',
                        spec=None if spec is None else LossSpec(**spec),
                        n_qubits=2, result_timeout=T, device='cpu', **kw)
        return res, svc.stats(), svc.compile_cache.stats()


def _assert_same_trajectory(res, snap, jax_run):
    """The port's loop took the JAX loop's steps to its parameters, and
    its service counted the session as the JAX service did."""
    want, jax_cal = jax_run
    assert snap['calibration'] == jax_cal
    assert res.steps == want.steps
    assert res.converged == want.converged
    for name, x in want.params.items():
        assert res.params[name] == pytest.approx(x, abs=PARAM_ATOL[name])
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-4,
                               atol=1e-7)


def test_closed_loop_amplitude_converges_and_writes_back():
    spec = dict(knob='amplitude', x90_amp=0.52)
    qchip = make_default_qchip(2)
    assert qchip.gates['Q0X90'].contents[0].amp == pytest.approx(0.48)
    res, snap, cache_snap = _port_loop('amplitude', qchip, spec=spec,
                                       shots=4)
    assert res.converged and not res.diverged
    assert res.params['amp'] == pytest.approx(0.52, abs=5e-3)
    assert res.losses[-1] < res.losses[0]
    assert qchip.gates['Q0X90'].contents[0].amp \
        == pytest.approx(res.params['amp'])
    assert res.fp_before != res.fp_after == qchip.fingerprint()
    assert 1 <= res.flushed <= res.steps
    assert cache_snap['writeback_flushes'] == 1
    cal = snap['calibration']
    assert (cal['sessions_opened'], cal['converged'], cal['diverged'],
            cal['open_sessions'], cal['steps']) == (1, 1, 0, 0, res.steps)
    assert res.session['state'] == 'converged'
    _assert_same_trajectory(res, snap, _jax_loop('amplitude', spec=spec,
                                                 shots=4))


def test_closed_loop_readout_window_converges_and_writes_back():
    qchip = make_default_qchip(2)
    for pulse in qchip.gates['Q0read'].contents:
        assert pulse.t0 == pytest.approx(0.0)
    res, snap, _ = _port_loop('readout_window', qchip, shots=4)
    assert res.converged, res.detail
    start = res.params['window_start']
    assert 260.0 <= start <= 400.0
    assert res.losses[-1] < res.losses[0]
    for pulse in qchip.gates['Q0read'].contents:
        assert pulse.t0 == pytest.approx(start * 1e-9)
    assert res.fp_before != res.fp_after
    assert 1 <= res.flushed <= res.steps
    assert snap['calibration']['converged'] == 1
    _assert_same_trajectory(res, snap, _jax_loop('readout_window', shots=4))


def test_closed_loop_drag_converges():
    qchip = make_default_qchip(2)
    res, snap, _ = _port_loop('drag', qchip, shots=4)
    assert res.converged, res.detail
    assert res.params['alpha'] == pytest.approx(1.0, abs=0.25)
    assert res.losses[-1] < res.losses[0]
    gate = qchip.gates['Q0X90'].contents[0]
    assert gate.env['paradict']['alpha'] == pytest.approx(res.params['alpha'])
    assert res.fp_before != res.fp_after
    _assert_same_trajectory(res, snap, _jax_loop('drag', shots=4))


def test_diverged_loop_is_counted_and_never_writes_back():
    qchip = make_default_qchip(2)
    fp0 = qchip.fingerprint()
    res, snap, _ = _port_loop('amplitude', qchip, lr=5.0, shots=2)
    assert res.diverged and not res.converged and res.detail['reason']
    assert res.fp_before is None and res.fp_after is None
    assert res.flushed is None
    assert qchip.fingerprint() == fp0
    assert qchip.gates['Q0X90'].contents[0].amp == pytest.approx(0.48)
    cal = snap['calibration']
    assert (cal['diverged'], cal['converged'], cal['open_sessions']) \
        == (1, 0, 0)
    assert res.session['state'] == 'diverged'
    want, jax_cal = _jax_loop('amplitude', lr=5.0, shots=2)
    assert snap['calibration'] == jax_cal
    assert res.steps == want.steps
    assert res.detail['reason'].split('=')[0] \
        == want.detail['reason'].split('=')[0]


def test_session_rejects_use_after_terminal():
    qchip = make_default_qchip(2)
    with ExecutionService(devices=CPU) as svc:
        sess = svc.open_calibration(knob='amplitude')
        sess.submit_step(rabi_program('Q0', 0.3), qchip, shots=2,
                         n_qubits=2).result(timeout=T)
        sess.mark_converged({'amp': 0.3})
        with pytest.raises(RuntimeError):
            sess.mark_diverged('too late')
        summary = sess.close()
        with pytest.raises(RuntimeError):
            sess.submit_step(rabi_program('Q0', 0.3), qchip, shots=2,
                             n_qubits=2)
        assert svc.stats()['calibration']['open_sessions'] == 0
        with pytest.raises(ValueError, match='calib event kind'):
            svc.calib_event(sess.sid, 'exploded')
    assert isinstance(sess, CalibrationSession)
    assert summary['state'] == 'converged' and summary['steps'] == 1


def test_executed_amp_word_closes_the_loop():
    qchip = make_default_qchip(2)
    amp = 0.337
    with ExecutionService(devices=CPU) as svc:
        res = svc.submit_source(rabi_program('Q0', amp), qchip, shots=2,
                                n_qubits=2).result(timeout=T)
    x_exec = _executed_amp(res, amp)
    assert x_exec == pytest.approx(amp, abs=1.0 / AMP_SCALE)
    assert x_exec == int(round(amp * AMP_SCALE)) / AMP_SCALE
    with pytest.raises(RuntimeError):
        _executed_amp(res, 0.9991)


def test_calibration_burst_no_lru_thrash_through_service():
    qchip = make_default_qchip(2)
    amps = np.linspace(0.2, 0.65, 10)
    with ExecutionService(devices=CPU) as svc:
        for h in [svc.submit_source(rabi_program('Q0', float(a)), qchip,
                                    shots=2, n_qubits=2) for a in amps]:
            h.result(timeout=T)
        s1 = svc.compile_cache.stats()
        for h in [svc.submit_source(rabi_program('Q0', float(a)), qchip,
                                    shots=2, n_qubits=2) for a in amps]:
            h.result(timeout=T)
        s2 = svc.compile_cache.stats()
    assert s1['evictions'] == 0 and s2['evictions'] == 0
    assert s2['misses'] == s1['misses']
    assert s2['hits'] >= s1['hits'] + len(amps)
