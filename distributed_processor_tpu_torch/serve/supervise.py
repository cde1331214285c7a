"""Supervision policy objects for the self-healing execution service.

The service (``service.py``) runs a supervisor thread that health-checks
every device executor: a heartbeat per dispatch-loop iteration, a
wall-clock watchdog around every device dispatch (a hung device call is
*detected*, not waited out), and dead-thread detection with dispatcher
respawn.  This module holds the two policy objects that parameterize it
— pure data + arithmetic, no threads, no locks (the service owns the
concurrency, exactly like :class:`~.batcher.Coalescer`):

* :class:`RetryPolicy` — how many times an INFRASTRUCTURE failure
  (executor crash, hang, dead dispatcher — classified by
  :func:`~..sim.interpreter.is_infrastructure_error`) may be retried,
  and the exponential backoff between attempts.  Program-class errors
  (:class:`~..sim.interpreter.FaultError`, validation, bad arguments)
  are NEVER retried: they reproduce identically on any executor.
* :class:`CircuitBreaker` — the per-executor trip state machine:

  ::

      live --(threshold consecutive infra failures,
              or a hang / dead thread)--> quarantined
      quarantined --(cooldown elapsed)--> probing (half-open)
      probing --(canary ok, bit-identical)--> live   [re-admitted]
      probing --(canary failed)--> quarantined       [cooldown doubles]

  While quarantined/probing the executor receives no routed traffic
  and may not steal; its sticky buckets and queued backlog re-home to
  healthy executors through the existing migrate/absorb path (which
  re-runs every deadline/cancel check), and its in-flight batch is
  retried elsewhere under the :class:`RetryPolicy`.

docs/ROBUSTNESS.md "serving-layer failures" has the full taxonomy
table (which errors retry, which propagate) and the shedding policy.
"""

from __future__ import annotations

from dataclasses import dataclass

# executor health states (stats()['devices'][i]['health'])
HEALTH_LIVE = 'live'
HEALTH_QUARANTINED = 'quarantined'
HEALTH_PROBING = 'probing'          # half-open: canary in flight


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry of infrastructure failures.

    ``max_attempts`` counts EXECUTIONS, not retries: 3 means the
    original dispatch plus at most two retries; 1 disables retrying.
    When the budget is exhausted the request fails with the ORIGINAL
    infrastructure error (the first one it hit), never a generic
    "gave up".  Backoff is exponential with a cap: retry *k* (0-based)
    waits ``min(backoff_s * backoff_mult**k, max_backoff_s)`` parked
    outside the dispatch queues, so a crashing executor cannot
    hot-loop a doomed batch.
    """
    max_attempts: int = 3
    backoff_s: float = 0.02
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError('max_attempts must be >= 1')
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError('backoff must be >= 0')

    def delay_s(self, retry_index: int) -> float:
        """Backoff before retry ``retry_index`` (0-based)."""
        return min(self.backoff_s * self.backoff_mult ** retry_index,
                   self.max_backoff_s)


class CircuitBreaker:
    """Per-executor breaker bookkeeping (state lives here, transitions
    are driven by the service under its lock).

    Counts CONSECUTIVE infrastructure failures — any successful batch
    resets the streak.  ``trip`` arms the cooldown and escalates it
    (each successive trip doubles the wait, capped), ``readmit``
    resets the streak and restores the base cooldown.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25,
                 cooldown_mult: float = 2.0, max_cooldown_s: float = 30.0):
        if threshold < 1:
            raise ValueError('threshold must be >= 1')
        self.threshold = threshold
        self.base_cooldown_s = cooldown_s
        self.cooldown_mult = cooldown_mult
        self.max_cooldown_s = max_cooldown_s
        self.consecutive = 0
        self.trips = 0
        self.readmissions = 0
        self.cooldown_until = None
        self._next_cooldown_s = cooldown_s

    def record_failure(self) -> bool:
        """Count one infrastructure failure; True when the streak just
        reached the trip threshold (the caller quarantines)."""
        self.consecutive += 1
        return self.consecutive >= self.threshold

    def record_success(self) -> None:
        self.consecutive = 0

    def trip(self, now: float) -> None:
        """Arm (or re-arm, escalating) the cooldown."""
        self.trips += 1
        self.cooldown_until = now + self._next_cooldown_s
        self._next_cooldown_s = min(
            self._next_cooldown_s * self.cooldown_mult,
            self.max_cooldown_s)

    def ready_to_probe(self, now: float) -> bool:
        return self.cooldown_until is not None \
            and now >= self.cooldown_until

    def readmit(self) -> None:
        self.readmissions += 1
        self.consecutive = 0
        self.cooldown_until = None
        self._next_cooldown_s = self.base_cooldown_s

    def snapshot(self) -> dict:
        """JSON-able breaker state — the payload the service attaches
        to ``breaker_trip`` flight-recorder events
        (docs/OBSERVABILITY.md)."""
        return {'trips': self.trips,
                'consecutive': self.consecutive,
                'readmissions': self.readmissions,
                'next_cooldown_s': self._next_cooldown_s}
