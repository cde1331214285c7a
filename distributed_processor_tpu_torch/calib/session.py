"""Calibration traffic class: gradient-descent tuning sessions.

The serving counterpart of :mod:`.loops` (docs/SERVING.md
"Calibration sessions"): a :class:`CalibrationSession` is a long-lived
handle over one knob's tuning loop, mirroring the
:class:`~..serve.stream.StreamSession` shape — opened by
``ExecutionService.open_calibration``, target-generic (it only needs
``submit_source`` / ``calib_event`` / ``close_calibration``), a
context manager, closed with a summary.

Where a stream's unit of traffic is a round chunk, a calibration
session's unit is a *step*: one candidate program (the current
parameter guess) submitted through the ordinary ``submit_source``
front door — so the compile cache, tenant quotas/metering, priority
lanes and overload control all apply unchanged — whose demuxed result
feeds the gradient step that produces the NEXT candidate.  Steps are
dependent by construction (candidate k+1 needs candidate k's result),
which is exactly the bursty nearly-identical-program traffic the
compile-cache key/LRU stress tests pin (tests/test_calib.py).

Observability: every step/convergence/divergence is reported to the
service (``serve.calib.*`` counters, ``stats()['calibration']``,
flight-recorder events for the terminal transitions).
"""

from __future__ import annotations


class CalibrationSession:
    """One open calibration loop: submit candidate steps, record the
    loss trajectory, mark the terminal state.

    Not thread-safe for concurrent ``submit_step`` calls (one
    optimizer per session — steps are sequentially dependent anyway).
    ``tenant`` is a SESSION property: every candidate inherits it, so
    a loop's compiles and shots are metered and fair-queued under the
    tenant that opened it (docs/SERVING.md "Tenants").
    """

    def __init__(self, target, sid: int, *, knob: str,
                 tenant: str = None, priority: int = 0):
        self._target = target
        self.sid = sid
        self.knob = knob
        self.tenant = tenant
        self.priority = priority
        self.steps = 0
        self.losses = []           # loss trajectory, submit order
        self.params = None         # last/converged parameter dict
        self.state = 'open'        # open | converged | diverged
        self.reason = None         # divergence reason, when diverged
        self._closed = False

    # -- producer side ---------------------------------------------------

    def submit_step(self, program, qchip, *, shots: int = None,
                    meas_bits=None, cfg=None, deadline_ms: float = None,
                    **kw):
        """Submit one candidate program through the target's compile
        front door; returns its handle immediately.  Counts the step
        against the session (``serve.calib.steps``)."""
        if self._closed:
            raise RuntimeError(f'calibration {self.sid} is closed')
        handle = self._target.submit_source(
            program, qchip, shots=shots, meas_bits=meas_bits, cfg=cfg,
            priority=self.priority, deadline_ms=deadline_ms,
            tenant=self.tenant, **kw)
        self.steps += 1
        self._target.calib_event(self.sid, 'step')
        return handle

    def note_loss(self, loss) -> None:
        """Record one step's loss (the trajectory the summary and the
        ``cli calibrate`` printout report)."""
        self.losses.append(float(loss))

    # -- terminal transitions --------------------------------------------

    def mark_converged(self, params: dict = None) -> None:
        """The loop met its tolerance: record the converged parameters
        and count the convergence (``serve.calib.converged``)."""
        self._require_open()
        self.state = 'converged'
        self.params = dict(params) if params else None
        self._target.calib_event(self.sid, 'converged', knob=self.knob,
                                 steps=self.steps)

    def mark_diverged(self, reason: str = None) -> None:
        """The loop failed (loss rising, NaN, step budget): count the
        divergence (``serve.calib.diverged``) with its reason."""
        self._require_open()
        self.state = 'diverged'
        self.reason = reason
        self._target.calib_event(self.sid, 'diverged', knob=self.knob,
                                 steps=self.steps, reason=reason)

    def _require_open(self):
        if self._closed or self.state != 'open':
            raise RuntimeError(
                f'calibration {self.sid} already {self.state}')

    # -- lifecycle -------------------------------------------------------

    def close(self) -> dict:
        """Deregister the session with the target and return the
        session summary (knob, step count, terminal state, loss
        trajectory, converged params)."""
        if self._closed:
            raise RuntimeError(
                f'calibration {self.sid} is already closed')
        self._closed = True
        self._target.close_calibration(self.sid)
        return {
            'sid': self.sid,
            'knob': self.knob,
            'steps': self.steps,
            'state': self.state,
            'losses': list(self.losses),
            'params': self.params,
            'reason': self.reason,
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        if not self._closed:
            self.close()
