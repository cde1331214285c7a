"""Gradient-descent calibration loops, closed through the serve tier.

Each loop tunes ONE knob of a live :class:`~..qchip.QChip` — drive
amplitude, DRAG coefficient, readout-window placement — by descending
the differentiable forward model in :mod:`..sim.grad`:

1. the current parameter guess becomes a candidate program (gate
   ``modi`` overrides — the same per-call parameterization hardware
   calibration sweeps use),
2. the candidate is submitted through the serving tier's compile front
   door (``submit_source`` under a :class:`~.session.
   CalibrationSession`), so it pays the full production path — content-
   addressed compile cache, tenant quotas, coalesced dispatch,
3. the demuxed result's as-executed pulse records close the loop: the
   candidate's quantized amplitude word is read back out of
   ``rec_amp`` and the gradient is evaluated at the value the device
   actually played (docs/CALIBRATION.md "Closing the loop"),
4. :func:`~..sim.grad.grad_loss` yields the step; convergence /
   divergence is decided on the loss trajectory.

On convergence the loop **writes back** to the live qchip object and
submits one post-writeback probe through the same service: the compile
cache's lineage tracking sees the mutated fingerprint and
flushes exactly the stale epoch's entries —
``compilecache.writeback_flushes`` counts these loops in production.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..models.experiments import rabi_program
from ..sim.grad import AMP_SCALE, LossSpec, PARAM_NAME, grad_loss

# ADC/DAC sample cadence of the forward model: one readout-window
# sample is 1 ns, so a window start of s samples writes back as a
# read-pulse t0 of s * 1e-9 seconds
SAMPLE_RATE = 1e9

# default step budget / step sizes per knob (the loss scales differ:
# see docs/CALIBRATION.md "Knobs")
_DEFAULTS = {
    'amplitude': dict(lr=0.3, xtol=1e-4, max_steps=40, start=0.30),
    'drag': dict(lr=1.0, xtol=1e-3, max_steps=40, start=0.1),
    'readout_window': dict(lr=3000.0, xtol=0.75, max_steps=80,
                           start=32.0),
}
# divergence guard rails: a parameter escaping its physical range is a
# diverged loop, not an exception
_BOUNDS = {
    'amplitude': (0.0, 1.5),
    'drag': (-5.0, 5.0),
    'readout_window': (0.0, None),   # upper bound bound to the horizon
}


@dataclass
class CalibResult:
    """Outcome of one calibration loop (JSON-able via ``to_dict``)."""
    knob: str
    converged: bool
    diverged: bool
    steps: int
    params: dict
    losses: list
    fp_before: str = None      # qchip fingerprint before writeback
    fp_after: str = None       # ... after (differs iff written back)
    flushed: int = None        # stale-epoch entries the probe flushed
    session: dict = None       # CalibrationSession.close() summary
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            'knob': self.knob, 'converged': self.converged,
            'diverged': self.diverged, 'steps': self.steps,
            'params': self.params, 'losses': self.losses,
            'fp_before': self.fp_before, 'fp_after': self.fp_after,
            'flushed': self.flushed, 'detail': self.detail,
        }


def _executed_amp(res, amp: float) -> float:
    """Close the loop on the demuxed pulse records: find the candidate
    amplitude's quantized word in the as-executed ``rec_amp`` record
    and return it as a fraction — the linearization point the gradient
    is evaluated at.  A missing word means the serving tier did not
    play the candidate we think it played; that is a loop bug, not a
    physics outcome, so it raises."""
    word = int(round(amp * AMP_SCALE))
    rec = np.asarray(res['rec_amp'])
    if not np.any(rec == word):
        raise RuntimeError(
            f'candidate amp word {word} absent from executed rec_amp '
            f'(words played: {sorted(set(rec.ravel().tolist()))[:8]})')
    return word / AMP_SCALE


def _make_candidate(knob: str, qubit: str, x: float,
                    nominal: dict) -> list:
    """The candidate program for one step: gate-``modi`` overrides of
    the knob's parameter (every candidate differs from its neighbors
    by one float — the compile-cache key stress shape)."""
    if knob == 'amplitude':
        return rabi_program(qubit, x)
    if knob == 'drag':
        para = dict(nominal['paradict'], alpha=float(x))
        return [
            {'name': 'X90', 'qubit': [qubit],
             'modi': {(0, 'env'): {'env_func': 'DRAG',
                                   'paradict': para}}},
            {'name': 'read', 'qubit': [qubit]},
        ]
    # readout_window: shift both read pulses (rdrv + rdlo) to the
    # candidate window start
    t0 = float(x) / SAMPLE_RATE
    return [
        {'name': 'X90', 'qubit': [qubit]},
        {'name': 'read', 'qubit': [qubit],
         'modi': {(0, 't0'): t0, (1, 't0'): t0}},
    ]


def _apply_writeback(qchip, knob: str, qubit: str, x: float) -> None:
    """Write the converged value into the LIVE qchip object — the
    real-writer side of the calibration-epoch machinery (the next
    submission through a lineage-tracking cache flushes the old
    epoch)."""
    if knob == 'amplitude':
        qchip.gates[qubit + 'X90'].contents[0].amp = float(x)
    elif knob == 'drag':
        gate = qchip.gates[qubit + 'X90'].contents[0]
        gate.env = dict(gate.env)
        gate.env['paradict'] = dict(gate.env['paradict'],
                                    alpha=float(x))
    else:
        t0 = float(x) / SAMPLE_RATE
        for pulse in qchip.gates[qubit + 'read'].contents:
            pulse.t0 = t0


def calibrate(service, qchip, *, knob: str = 'amplitude',
              qubit: str = 'Q0', spec: LossSpec = None,
              start: float = None, lr: float = None, xtol: float = None,
              max_steps: int = None, shots: int = 16,
              tenant: str = None, priority: int = 0,
              write_back: bool = True, n_qubits: int = 8,
              result_timeout: float = 300.0, device=None) -> CalibResult:
    """Run one knob's closed-loop calibration through ``service``.

    Opens a :class:`~.session.CalibrationSession`, descends
    :func:`~..sim.grad.grad_loss` with per-step candidate submissions
    (dependent traffic: step k+1's candidate is computed from step k's
    result), and on convergence writes the tuned value back to the
    live ``qchip`` and submits a post-writeback probe so the compile
    cache flushes exactly the stale epoch.  Returns a
    :class:`CalibResult`; a diverged loop returns (``diverged=True``)
    rather than raising — divergence is a counted, observable outcome
    (``serve.calib.diverged``), not an exception.  ``device`` is where
    the gradient is evaluated (default the card, as every entry point
    of the package).
    """
    d = _DEFAULTS[knob]   # KeyError = unknown knob, same set as grad.KNOBS
    lr = d['lr'] if lr is None else float(lr)
    xtol = d['xtol'] if xtol is None else float(xtol)
    max_steps = d['max_steps'] if max_steps is None else int(max_steps)
    x = float(d['start'] if start is None else start)
    if spec is None:
        if knob == 'drag':
            # the loss-model anharmonicity is softer than the gate's
            # nominal -270 MHz: at the nominal detuning the gaussian's
            # spectral weight underflows float32 and the gradient is
            # numerically zero (docs/CALIBRATION.md "Knobs")
            spec = LossSpec(knob='drag', drag_delta=-30e6)
        elif knob == 'readout_window':
            # a wider soft edge smooths the placement optimum's kink
            # (where the window starts falling off the record) enough
            # for plain gradient descent at the default step size
            spec = LossSpec(knob='readout_window', window_edge=8.0)
        else:
            spec = LossSpec(knob=knob)
    pname = PARAM_NAME[knob]
    lo, hi = _BOUNDS[knob]
    if knob == 'readout_window':
        hi = float(spec.window_horizon)
    nominal = {'paradict': {'alpha': 0.4, 'sigmas': 3, 'delta': -270e6}}
    session = service.open_calibration(knob=knob, tenant=tenant,
                                       priority=priority)
    converged = False
    reason = None
    prev_loss = None
    rising = 0
    with session:
        for _ in range(max_steps):
            program = _make_candidate(knob, qubit, x, nominal)
            handle = session.submit_step(program, qchip, shots=shots,
                                         n_qubits=n_qubits)
            res = handle.result(timeout=result_timeout)
            # close the loop on the as-executed records where the knob
            # is an amplitude; other knobs record the executed schedule
            x_exec = _executed_amp(res, x) if knob == 'amplitude' else x
            loss, grads = grad_loss({pname: x_exec}, spec, device=device)
            loss, g = float(loss), float(grads[pname])
            session.note_loss(loss)
            if not math.isfinite(loss) or not math.isfinite(g):
                reason = f'non-finite loss/gradient at {pname}={x:.6g}'
                break
            if prev_loss is not None and loss > prev_loss + 1e-12:
                rising += 1
                if rising >= 4:
                    reason = (f'loss rising for {rising} consecutive '
                              f'steps (lr too large?)')
                    break
            else:
                rising = 0
            prev_loss = loss
            step = lr * g
            if abs(step) < xtol:
                converged = True
                break
            x -= step
            if (lo is not None and x < lo) or \
                    (hi is not None and x > hi):
                reason = f'{pname}={x:.6g} escaped bounds ({lo}, {hi})'
                break
        if converged:
            session.mark_converged({pname: x})
        else:
            if reason is None:
                reason = f'step budget ({max_steps}) exhausted'
            session.mark_diverged(reason)
        steps = session.steps
        losses = list(session.losses)
    summary = {'sid': session.sid, 'state': session.state,
               'reason': session.reason}
    result = CalibResult(knob=knob, converged=converged,
                         diverged=not converged, steps=steps,
                         params={pname: x}, losses=losses,
                         session=summary,
                         detail={'reason': reason, 'lr': lr,
                                 'xtol': xtol, 'shots': shots})
    if converged and write_back:
        result.fp_before, result.fp_after, result.flushed = \
            _write_back_and_probe(service, qchip, knob, qubit, x,
                                  shots=shots, tenant=tenant,
                                  n_qubits=n_qubits,
                                  timeout=result_timeout)
    return result


def _write_back_and_probe(service, qchip, knob, qubit, x, *, shots,
                          tenant, n_qubits, timeout):
    """Mutate the live qchip and resubmit through the same service:
    the cache's lineage tracking flushes exactly the old epoch
    (counted by ``compilecache.writeback_flushes``)."""
    fp_before = qchip.fingerprint()
    _apply_writeback(qchip, knob, qubit, x)
    fp_after = qchip.fingerprint()
    cache = service.compile_cache
    flushed_before = cache.stats()['invalidated_entries']
    handle = service.submit_source(rabi_program(qubit, 0.48), qchip,
                                   shots=shots, tenant=tenant,
                                   n_qubits=n_qubits)
    handle.result(timeout=timeout)
    flushed = cache.stats()['invalidated_entries'] - flushed_before
    return fp_before, fp_after, flushed
