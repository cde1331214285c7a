"""Request lifecycle for the execution service: the future-like handle.

A submission is decoupled from its execution: :meth:`ExecutionService.
submit` returns a :class:`RequestHandle` immediately and the dispatcher
thread fulfils it after the request rides a coalesced batch through the
interpreter.  The handle is the only object a submitter touches, so its
state machine is deliberately small and fully lock-guarded:

``queued``      in the coalescer, cancellable, deadline armed
``dispatched``  claimed by the dispatcher for the batch being built —
                cancellation no longer possible (the batch boundary IS
                the cancellation point)
``done``        result or exception set, ``result()`` unblocked

Every transition happens under the handle's own lock, so ``cancel()``
racing the dispatcher's claim has exactly one winner.  ``dispatched``
can move BACK to ``queued`` exactly one way: the supervision layer
re-queues a request whose batch died on executor infrastructure (crash,
hang, dead dispatcher — docs/ROBUSTNESS.md "serving-layer failures").
Each claim hands the dispatcher an **attempt token**; fulfilling or
failing with a stale token is a silent no-op, so a hung dispatch that
eventually returns after its request was retried elsewhere cannot
double-complete the handle, and ``cancel()`` racing a retry re-queue
still has exactly one winner (the re-queue invalidates the old token,
the cancel flips the state to done, the next claim loses).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class QueueFullError(RuntimeError):
    """Admission control: the service's bounded queue is full.

    Raised by ``submit`` (never stored on a handle) — backpressure is
    synchronous so the caller can shed load or retry, instead of the
    queue growing without bound under overload.
    """


class CancelledError(RuntimeError):
    """The request was cancelled (``handle.cancel()`` or a non-draining
    shutdown) before it was dispatched."""


class ShutdownError(CancelledError):
    """The service shut down before this request could run.

    Raised on handles still queued at ``shutdown(drain=False)`` and on
    any handle left unresolved when the last dispatcher exits — a
    forced shutdown must fail every outstanding handle so ``result()``
    can never block forever.  Subclasses :class:`CancelledError`: a
    shutdown IS a service-initiated cancellation, just a typed one.
    """


class OverloadError(RuntimeError):
    """Admission-control shed: the service refused (or evicted) this
    request because the estimated queue service time exceeds the
    configured bound (``max_est_wait_ms``) or provably exceeds the
    request's own ``deadline_ms``.  Shedding early and loudly beats
    queueing a request that can only expire — the caller can back off,
    retry elsewhere, or lower its demands (docs/SERVING.md
    "overload control")."""


class QuotaExceededError(ValueError):
    """Admission control: THIS TENANT is over one of its configured
    limits (max queued requests, shots/s, or compile-submissions/s —
    docs/SERVING.md "Tenants").

    Distinct from :class:`OverloadError` on purpose: an overload shed
    says "the service is busy, back off and retry" while a quota
    rejection says "your contract forbids this rate, retrying verbatim
    cannot succeed".  Subclasses :class:`ValueError` so the fault
    taxonomy (``is_infrastructure_error``) classifies it program-side:
    the retry/failover machinery surfaces it to the caller immediately
    instead of burning attempts on other replicas.
    """


class ExecutorLostError(RuntimeError):
    """The executor running this request's batch was lost (dispatcher
    thread died, or a dispatch hung past the watchdog) and the retry
    budget could not place it elsewhere.  Infrastructure-class: the
    supervision layer retries these under the service's
    :class:`~.supervise.RetryPolicy` before they ever surface."""


class DeadlineError(RuntimeError):
    """The request's deadline passed before a batch picked it up.

    Deadlines are honored at BATCH BOUNDARIES: a request already
    claimed for a batch runs to completion (the interpreter cannot be
    interrupted mid-dispatch); one still queued when its deadline
    expires is failed with this error at the next dispatch opportunity.
    """


class ServiceClosedError(RuntimeError):
    """``submit`` after ``shutdown`` began."""


_QUEUED, _DISPATCHED, _DONE = 'queued', 'dispatched', 'done'

# the tenant every unattributed submission is normalized onto at the
# admission boundary — single-tenant deployments never name a tenant
# and simply ARE the default tenant (docs/SERVING.md "Tenants")
DEFAULT_TENANT = 'default'


class RequestHandle:
    """Future-like handle for one submitted program.

    ``result(timeout)`` blocks for the per-request stats dict (the
    exact :func:`~...sim.interpreter.simulate_batch` schema, demuxed
    from the coalesced batch), re-raising the request's failure —
    :class:`~...sim.interpreter.FaultError` under strict fault mode,
    :class:`CancelledError`, :class:`DeadlineError` — and raising
    :class:`TimeoutError` if nothing arrived within ``timeout``
    seconds (the request itself stays live).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._state = _QUEUED
        self._result = None
        self._exception = None
        # attempt token: bumped by every _claim and every _requeue, so
        # an executor holding a stale token (its dispatch hung or
        # failed and the request was retried elsewhere) cannot
        # complete the handle
        self._attempt = 0
        # supervision counters (written under _lock by the service):
        # how many times the request was re-queued after an
        # infrastructure failure / migrated between executor queues
        self.retries = 0
        self.migrations = 0
        # observability context slot: None (untraced — the whole cost
        # of the tracing-off path) or the obs.trace.TraceContext the
        # serving layers append lifecycle spans to
        self._trace = None
        # exactly-once resolution hook: the service installs a callback
        # at admission and it fires on the SINGLE winning transition to
        # done — including the submitter-side cancel() path that never
        # re-enters the service — so per-tenant outstanding counts can
        # never drift.  Called as cb(ok: bool) outside the handle lock.
        self._on_done = None

    # -- submitter side -------------------------------------------------

    def result(self, timeout: float = None) -> dict:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f'request not completed within {timeout!r} s '
                f'(still {self._state})')
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: float = None):
        """The stored failure (or None), same blocking as ``result``."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f'request not completed within {timeout!r} s')
        return self._exception

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return isinstance(self._exception, CancelledError)

    def trace(self) -> list | None:
        """Recorded lifecycle spans (docs/OBSERVABILITY.md), or None
        when this request was not sampled for tracing.  Each span is a
        dict ``{name, t0, t1, args}`` with monotonic-clock seconds and
        ``t1 is None`` for instant hop events; the list is a snapshot
        and safe to mutate."""
        ctx = self._trace
        return None if ctx is None else list(ctx.spans)

    def cancel(self) -> bool:
        """Cancel if still queued.  Returns True when this call won —
        the request will never execute and ``result()`` raises
        :class:`CancelledError`.  Returns False when the request was
        already claimed by a batch or already done: past the batch
        boundary there is nothing left to cancel."""
        return self._fail(CancelledError('request cancelled'),
                          only_queued=True)

    # -- service side ---------------------------------------------------

    def _set_on_done(self, cb) -> bool:
        """Install the exactly-once resolution callback.  Returns False
        — NOT installed — when the handle already resolved (e.g. a
        submit_source handle cancelled during its compile), so the
        installer knows its accounting will never be balanced by the
        callback and must not open it."""
        with self._lock:
            if self._state == _DONE:
                return False
            self._on_done = cb
            return True

    def _claim(self):
        """Dispatcher: move queued -> dispatched.  Returns the attempt
        token (a truthy int) the claimer must present to ``_fulfill``/
        ``_fail``/``_requeue``, or 0 if the request was cancelled or
        failed first (the batch must skip it)."""
        with self._lock:
            if self._state != _QUEUED:
                return 0
            self._state = _DISPATCHED
            self._attempt += 1
            return self._attempt

    def _requeue(self, token: int) -> bool:
        """Supervision: move dispatched -> queued for a retry after an
        infrastructure failure.  Invalidates ``token`` (a straggling
        duplicate of the failed dispatch can no longer complete the
        handle) and bumps ``retries``.  False when the handle is
        already done (cancel/deadline won) or the token is stale (a
        different retry already happened)."""
        with self._lock:
            if self._state != _DISPATCHED or token != self._attempt:
                return False
            self._state = _QUEUED
            self._attempt += 1
            self.retries += 1
        if self._trace is not None:
            self._trace.instant('requeue', attempt=self.retries)
        return True

    def _fulfill(self, result: dict, token: int = None) -> bool:
        with self._lock:
            if self._state == _DONE:
                return False
            if token is not None and token != self._attempt:
                return False        # stale dispatch: retried elsewhere
            self._state = _DONE
            self._result = result
        if self._trace is not None:
            self._trace.instant('done', outcome='ok')
        self._event.set()
        self._notify_done(True)
        return True

    def _fail(self, exc: BaseException, only_queued: bool = False,
              token: int = None) -> bool:
        with self._lock:
            if self._state == _DONE or \
                    (only_queued and self._state != _QUEUED):
                return False
            if token is not None and token != self._attempt:
                return False        # stale dispatch: retried elsewhere
            self._state = _DONE
            self._exception = exc
        if self._trace is not None:
            self._trace.instant('done', outcome=type(exc).__name__)
        self._event.set()
        self._notify_done(False)
        return True

    def _notify_done(self, ok: bool) -> None:
        # pop-then-call: the slot is cleared before invocation so even
        # a re-entrant resolution attempt from inside the callback
        # cannot fire it twice
        cb, self._on_done = self._on_done, None
        if cb is not None:
            try:
                cb(ok)
            except Exception:
                pass        # accounting must never poison resolution


@dataclass
class Request:
    """One normalized submission, as the batcher sees it.

    ``meas_bits`` / ``init_regs`` are already validated and in their
    full per-shot forms (``[n_shots, n_cores, n_meas]`` /
    ``[n_shots, n_cores, N_REGS]`` or None); ``cfg`` is the normalized
    count-mode :class:`InterpreterConfig` that is part of the bucket
    key; ``strict`` records whether THIS request (not its batch-mates)
    wants ``FaultError`` on trapped shots.  ``deadline`` is an absolute
    ``time.monotonic()`` value or None; ``seq`` is the service-wide
    arrival number used as the FIFO tiebreak inside a priority lane.
    ``migrations`` counts how many times work stealing moved this
    request between per-device queues (each hop re-runs the
    deadline/cancel checks at the re-queue boundary; mirrored onto the
    handle).  ``claim_token`` is the attempt token the last ``_claim``
    returned — the batch executor presents it back so a stale dispatch
    (retried elsewhere meanwhile) cannot complete the handle.
    ``last_error`` records the most recent infrastructure failure so
    retry-budget exhaustion surfaces the ORIGINAL error, not a generic
    "gave up".

    Streaming round chunks (docs/SERVING.md "Streaming sessions")
    reuse this lifecycle unchanged: ``rounds`` is the chunk's round
    count (None for ordinary one-shot submissions — the dispatcher
    branches on it), ``meas_bits`` is then ``[rounds, n_shots,
    n_cores, n_meas]``, ``decode`` the optional static
    :class:`~...ops.decode.DecodeSpec`, and ``sid`` the owning
    session id.  Retry/steal/cancel semantics — including the attempt
    token — are inherited, which is exactly what makes stream chunks
    survive a chaos kill without lost or duplicated rounds.
    """
    mp: object
    meas_bits: object
    init_regs: object
    cfg: object
    strict: bool
    n_shots: int
    priority: int
    deadline: float
    seq: int
    handle: RequestHandle = field(default_factory=RequestHandle)
    submit_t: float = field(default_factory=time.monotonic)
    migrations: int = 0
    claim_token: int = 0
    last_error: BaseException = None
    rounds: int = None
    decode: object = None
    sid: int = None
    # tenant identity (docs/SERVING.md "Tenants"): every request
    # belongs to exactly one tenant; unattributed traffic lands on the
    # 'default' tenant at admission so the fair queue and the meters
    # never see None
    tenant: str = 'default'

    def expired(self, now: float) -> bool:
        """Whether the deadline has passed as of ``now`` (False when no
        deadline is armed) — shared by queue pruning and the stolen-
        batch re-queue check."""
        return self.deadline is not None and now >= self.deadline
