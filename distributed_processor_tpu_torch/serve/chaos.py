"""Serve-layer chaos harness: seeded fault injection under the service.

The supervision layer (supervisor thread, circuit breakers, bounded
retries, canary re-admission — docs/ROBUSTNESS.md "serving-layer
failures") is only trustworthy if it is EXERCISED: this module wraps a
live service's ``_run_batch`` with a :class:`ChaosMonkey` that injects
crashes, hangs, slowdowns and dispatcher deaths from a seeded RNG (or
a deterministic script prefix), and a :func:`soak` harness that submits
a stream of requests and asserts the service's whole contract under
fire — every handle terminates (no deadlocks), every completion is
bit-identical to the solo ``simulate_batch`` run, every failure is a
typed error.  The sim-layer analogue is the JAX package's
``sim/fuzz.py`` fault-injection fuzzer; this is the same discipline one
tier up.

Injection sits UNDER the service's retry/breaker machinery and ABOVE
the interpreter, exactly where real infrastructure faults (device
resets, runtime crashes, wedged calls) surface — so canary probes
draw injected faults too, and a quarantined executor only re-admits
once the chaos actually lets a probe through.

One tier further up, :func:`fleet_soak` drives the same contract
against a whole :class:`~.fleet.Fleet`: scripted process-level actions
(SIGKILL, SIGSTOP wedges, SIGCONT) fire at chosen points in the
submission stream while every completion is bit-checked and
timestamped, so the caller can assert not just "nothing hung" but
"goodput stayed positive through the kill window" (docs/FLEET.md).

The references run on ``device`` (default the card): a soak of a CPU
service or fleet names ``device='cpu'``.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..sim.interpreter import simulate_batch
from .request import RequestHandle
from .service import _to_host


def _solo(mp, bits, cfg, device) -> dict:
    """The solo ``simulate_batch`` reference, as host arrays."""
    return _to_host(simulate_batch(mp, bits, cfg=cfg, device=device))


class ChaosError(RuntimeError):
    """An injected executor crash.  Deliberately a plain RuntimeError:
    :func:`~..sim.interpreter.is_infrastructure_error` classifies it as
    infrastructure, so the retry/breaker path handles it — exactly like
    a real device runtime failure would be."""


class ChaosThreadDeath(BaseException):
    """An injected dispatcher death.  Subclasses BaseException ON
    PURPOSE: it escapes the service's ``except Exception`` batch-failure
    handling and genuinely kills the dispatcher thread, exercising the
    supervisor's dead-thread detection + respawn path."""


# injection outcomes, drawn per _run_batch call
OUTCOMES = ('crash', 'hang', 'slow', 'die', 'corrupt', 'ok')


@dataclass(frozen=True)
class ChaosPlan:
    """What the monkey injects.

    ``script`` is a deterministic prefix of forced outcomes (drawn
    first, in order, regardless of seed) — the way a test guarantees
    "this executor WILL trip its breaker" without depending on RNG
    draws.  After the script is exhausted, outcomes are drawn from the
    seeded RNG with the given probabilities (the remainder is 'ok').
    'hang' sleeps ``hang_s`` then runs the batch anyway — the hung
    dispatch eventually completes as a straggler, which the service
    must discard via the attempt token; 'slow' sleeps ``slow_s``
    (service-time jitter below the watchdog); 'die' raises
    :class:`ChaosThreadDeath` and kills the dispatcher; 'corrupt' runs
    the batch then flips ONE seeded bit in one request's result stats
    — the silent-data-corruption model (docs/ROBUSTNESS.md
    "Integrity"): no exception is raised, so only the audit fabric can
    catch it.
    """
    seed: int = 0
    script: tuple = ()
    p_crash: float = 0.0
    p_hang: float = 0.0
    p_slow: float = 0.0
    p_die: float = 0.0
    p_corrupt: float = 0.0
    hang_s: float = 0.25
    slow_s: float = 0.01

    def __post_init__(self):
        for out in self.script:
            if out not in OUTCOMES:
                raise ValueError(
                    f'script outcome {out!r} not in {OUTCOMES}')
        if self.p_crash + self.p_hang + self.p_slow + self.p_die \
                + self.p_corrupt > 1.0:
            raise ValueError('injection probabilities sum above 1')


class ChaosMonkey:
    """Wraps ``svc._run_batch`` with seeded fault injection.

    All draws happen under one lock so concurrent dispatchers consume
    the script/RNG in a serialized (hence reproducible-per-seed,
    though not per-thread-deterministic) order.  ``injected`` counts
    outcomes actually drawn.  Use as a context manager, or
    ``install()`` / ``uninstall()`` — uninstall restores the original
    bound method, so post-chaos traffic (and shutdown draining) runs
    clean.
    """

    def __init__(self, svc, plan: ChaosPlan):
        self.svc = svc
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._lock = threading.Lock()
        self._script = list(plan.script)
        self.injected = collections.Counter()
        self._orig = None
        self._orig_hook = None

    def _draw(self) -> str:
        with self._lock:
            if self._script:
                out = self._script.pop(0)
            else:
                r = float(self._rng.random())
                p = self.plan
                if r < p.p_crash:
                    out = 'crash'
                elif r < p.p_crash + p.p_hang:
                    out = 'hang'
                elif r < p.p_crash + p.p_hang + p.p_slow:
                    out = 'slow'
                elif r < p.p_crash + p.p_hang + p.p_slow + p.p_die:
                    out = 'die'
                elif r < p.p_crash + p.p_hang + p.p_slow + p.p_die \
                        + p.p_corrupt:
                    out = 'corrupt'
                else:
                    out = 'ok'
            self.injected[out] += 1
            return out

    def script_exhausted(self) -> bool:
        with self._lock:
            return not self._script

    def _corrupt_results(self, results):
        """One seeded bit flip in one request's result stats — in the
        first integer stat field, so the corruption always lands in
        bits the tenant would consume (meas/regs/fault words), never
        in a float that might round away.  Raises if the results carry
        no integer array: an injection that cannot corrupt must not be
        counted as one."""
        from ..integrity import flip_bit
        with self._lock:
            ri = int(self._rng.integers(len(results)))
            bit = int(self._rng.integers(0, 16))
            idx = int(self._rng.integers(0, 1 << 16))
        stats = dict(results[ri])
        for k in sorted(stats):
            a = np.asarray(stats[k])
            if a.dtype.kind in 'iu' and a.size:
                stats[k] = flip_bit(a, bit=bit, index=idx)
                break
        else:
            raise ValueError('corrupt injection found no integer '
                             'stat array to flip')
        out = list(results)
        out[ri] = stats
        return out

    def install(self) -> 'ChaosMonkey':
        if self._orig is not None:
            raise RuntimeError('chaos monkey already installed')
        orig = self.svc._run_batch
        plan = self.plan

        def chaotic_run_batch(ex, key, batch, cfg):
            out = self._draw()
            if out != 'ok':
                # the injection lands in the service's flight recorder
                # (and on any traced batch member) so a chaos-soak
                # failure reads as a timeline, not a moved counter
                rec = getattr(self.svc, 'flight_recorder', None)
                if rec is not None:
                    rec.record('chaos_inject', outcome=out,
                               executor=ex.label(), n=len(batch))
                for r in batch:
                    if r.handle._trace is not None:
                        r.handle._trace.instant('chaos', outcome=out,
                                                executor=ex.label())
            if out == 'crash':
                raise ChaosError(
                    f'injected crash on executor {ex.label()}')
            if out == 'die':
                raise ChaosThreadDeath(
                    f'injected dispatcher death on executor '
                    f'{ex.label()}')
            if out == 'hang':
                time.sleep(plan.hang_s)
            elif out == 'slow':
                time.sleep(plan.slow_s)
            elif out == 'corrupt':
                return self._corrupt_results(orig(ex, key, batch, cfg))
            return orig(ex, key, batch, cfg)

        self._orig = orig
        self.svc._run_batch = chaotic_run_batch
        # injected dispatcher deaths are EXPECTED — keep threading's
        # default excepthook from spewing their tracebacks to stderr
        # (anything else still reports through the original hook)
        self._orig_hook = threading.excepthook

        def quiet_hook(args):
            if args.exc_type is ChaosThreadDeath:
                return
            self._orig_hook(args)

        threading.excepthook = quiet_hook
        return self

    def uninstall(self) -> None:
        if self._orig is not None:
            self.svc._run_batch = self._orig
            self._orig = None
        if self._orig_hook is not None:
            threading.excepthook = self._orig_hook
            self._orig_hook = None

    def __enter__(self) -> 'ChaosMonkey':
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()


@dataclass
class SoakReport:
    """What :func:`soak` observed.  The invariants a healthy service
    must hold — ``hung == 0`` (every handle terminated) and
    ``bit_mismatches == 0`` (every completion bit-identical to its
    solo run) — are the caller's asserts; the rest is telemetry."""
    submitted: int = 0
    rejected: int = 0             # typed refusals AT submit
    completed: int = 0
    bit_mismatches: int = 0
    hung: int = 0                 # result() timed out: the bug class
    errors: collections.Counter = field(
        default_factory=collections.Counter)   # typed failures by name
    retries: int = 0              # summed over completed handles
    latencies_s: list = field(default_factory=list)

    def terminated(self) -> int:
        return self.completed + sum(self.errors.values())


def soak(svc, mps, cfg, *, n_requests: int = 100, shots: int = 3,
         seed: int = 0, result_timeout_s: float = 120.0,
         submit_hook=None, device=None) -> SoakReport:
    """Submit ``n_requests`` (cycling over ``mps``, seeded random
    measurement bits) and wait every handle out.

    Submission refusals (QueueFullError / OverloadError /
    ServiceClosedError) count as ``rejected``; a handle whose
    ``result(result_timeout_s)`` times out counts as ``hung`` — the
    failure mode the whole supervision layer exists to prevent; other
    failures are tallied by type name.  Every completion is bit-checked
    against the solo ``simulate_batch`` run of the same inputs (one
    reference per program, shared meas bits per program to keep the
    reference count bounded) on ``device``.  ``submit_hook(i)`` runs
    before each submission (pacing, mid-soak shutdown, ...).
    """
    rng = np.random.default_rng(seed)
    bits = {i: rng.integers(0, 2, size=(shots, mp.n_cores,
                                        cfg.max_meas)).astype(np.int32)
            for i, mp in enumerate(mps)}
    refs = {}
    report = SoakReport()
    pending = []
    for i in range(n_requests):
        if submit_hook is not None:
            submit_hook(i)
        pi = i % len(mps)
        t0 = time.monotonic()
        try:
            handle = svc.submit(mps[pi], bits[pi], cfg=cfg)
        except Exception as exc:     # noqa: BLE001 - typed refusal
            report.rejected += 1
            report.errors[type(exc).__name__] += 1
            continue
        report.submitted += 1
        pending.append((pi, handle, t0))
    for pi, handle, t0 in pending:
        assert isinstance(handle, RequestHandle)
        try:
            got = handle.result(timeout=result_timeout_s)
        except TimeoutError:
            report.hung += 1
            continue
        except Exception as exc:     # noqa: BLE001 - typed failure
            report.errors[type(exc).__name__] += 1
            continue
        report.completed += 1
        report.retries += handle.retries
        report.latencies_s.append(time.monotonic() - t0)
        if pi not in refs:
            refs[pi] = _solo(mps[pi], bits[pi], cfg, device)
        want = refs[pi]
        same = set(got) == set(want) and all(
            np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
            for k in want)
        if not same:
            report.bit_mismatches += 1
    return report


@dataclass
class TenantSoakReport(SoakReport):
    """:class:`SoakReport` plus the multi-tenant ledger: ``per_tenant``
    maps tenant → observed ground truth (submitted / completed / shed /
    quota_rejected / shots, counted from the caller's side of every
    handle), and ``meter_mismatches`` lists every disagreement between
    that ground truth and the service's billing meters
    (``stats()['tenants']``).  A healthy service under chaos holds
    ``hung == 0``, ``bit_mismatches == 0`` AND ``meter_mismatches ==
    []`` — injected crashes and retries may neither lose nor
    double-count a tenant's usage (docs/SERVING.md "Tenants")."""
    per_tenant: dict = field(default_factory=dict)
    meter_mismatches: list = field(default_factory=list)


def tenant_soak(svc, mps, cfg, *, tenants, n_requests: int = 100,
                shots: int = 3, seed: int = 0, greedy: str = None,
                greedy_factor: int = 4, result_timeout_s: float = 120.0,
                device=None) -> TenantSoakReport:
    """:func:`soak`, with every submission tagged to a tenant and the
    billing meters audited against caller-side ground truth.

    Submissions cycle over ``tenants``; when ``greedy`` names one of
    them, that tenant is scheduled ``greedy_factor`` extra slots per
    cycle — the adversarial shape: one tenant floods admission while
    the others trickle.  Greedy overflow is expected to bounce off its
    own quota (:class:`~.request.QuotaExceededError` counts as
    ``quota_rejected``, not an error); victim requests must complete.

    After every handle terminates, the report's ``meter_mismatches``
    records any tenant whose service-side meters disagree with what
    this harness actually observed: ``completed``, ``shed``,
    ``quota_rejected`` must match exactly, and ``shots`` must equal
    ``completed * shots`` — the exactly-once contract: a chaos retry
    that re-runs a batch may not bill the tenant twice, and a crash
    that loses an attempt may not bill at all.
    """
    tenants = list(tenants)
    if greedy is not None and greedy not in tenants:
        raise ValueError(f'greedy tenant {greedy!r} not in {tenants}')
    cycle = list(tenants)
    if greedy is not None:
        cycle = [greedy] * greedy_factor + \
            [t for t in tenants if t != greedy]
    rng = np.random.default_rng(seed)
    bits = {i: rng.integers(0, 2, size=(shots, mp.n_cores,
                                        cfg.max_meas)).astype(np.int32)
            for i, mp in enumerate(mps)}
    refs = {}
    report = TenantSoakReport()
    zero = dict(submitted=0, completed=0, shed=0, quota_rejected=0,
                shots=0)
    ledger = {t: dict(zero) for t in tenants}
    pending = []
    for i in range(n_requests):
        tenant = cycle[i % len(cycle)]
        pi = i % len(mps)
        t0 = time.monotonic()
        try:
            handle = svc.submit(mps[pi], bits[pi], cfg=cfg,
                                tenant=tenant)
        except Exception as exc:     # noqa: BLE001 - typed refusal
            report.rejected += 1
            report.errors[type(exc).__name__] += 1
            if type(exc).__name__ == 'QuotaExceededError':
                ledger[tenant]['quota_rejected'] += 1
            continue
        report.submitted += 1
        ledger[tenant]['submitted'] += 1
        pending.append((pi, tenant, handle, t0))
    for pi, tenant, handle, t0 in pending:
        assert isinstance(handle, RequestHandle)
        try:
            got = handle.result(timeout=result_timeout_s)
        except TimeoutError:
            report.hung += 1
            continue
        except Exception as exc:     # noqa: BLE001 - typed failure
            report.errors[type(exc).__name__] += 1
            if type(exc).__name__ == 'OverloadError':
                ledger[tenant]['shed'] += 1
            continue
        report.completed += 1
        report.retries += handle.retries
        report.latencies_s.append(time.monotonic() - t0)
        ledger[tenant]['completed'] += 1
        ledger[tenant]['shots'] += shots
        if pi not in refs:
            refs[pi] = _solo(mps[pi], bits[pi], cfg, device)
        want = refs[pi]
        same = set(got) == set(want) and all(
            np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
            for k in want)
        if not same:
            report.bit_mismatches += 1
    report.per_tenant = ledger
    metered = svc.stats().get('tenants', {})
    for t, truth in ledger.items():
        row = metered.get(t)
        if row is None:
            if any(truth.values()):
                report.meter_mismatches.append(
                    f'{t}: no meter row for active tenant')
            continue
        for k in ('completed', 'shed', 'quota_rejected', 'shots'):
            if row.get(k) != truth[k]:
                report.meter_mismatches.append(
                    f'{t}.{k}: metered {row.get(k)} != observed '
                    f'{truth[k]}')
    return report


@dataclass
class FleetSoakReport(SoakReport):
    """:class:`SoakReport` plus the timeline a fleet soak needs:
    ``actions`` records each chaos action as ``(t_rel_s, name, idx)``
    and ``samples`` records each request outcome as ``(t_rel_s,
    'ok' | error-type-name)`` — both relative to soak start — so the
    caller can compute goodput inside any window (e.g. the kill
    window) instead of only end-to-end totals."""
    actions: list = field(default_factory=list)
    samples: list = field(default_factory=list)

    def goodput(self, t0: float = 0.0, t1: float = None) -> float:
        """Completed-OK requests per second inside ``[t0, t1]``
        (relative seconds; ``t1`` defaults to the last sample)."""
        if t1 is None:
            t1 = max((t for t, _ in self.samples), default=0.0)
        n = sum(1 for t, out in self.samples
                if t0 <= t <= t1 and out == 'ok')
        return n / max(t1 - t0, 1e-9)

    def ok_in_window(self, t0: float, t1: float) -> int:
        return sum(1 for t, out in self.samples
                   if t0 <= t <= t1 and out == 'ok')


def fleet_soak(fleet, mps, cfg, *, n_requests: int = 100,
               shots: int = 3, seed: int = 0, rate_hz: float = None,
               actions=(), result_timeout_s: float = 120.0,
               device=None) -> FleetSoakReport:
    """:func:`soak`, against a :class:`~.fleet.Fleet`, with scripted
    process-level chaos.

    ``actions`` is a sequence of ``(at_request_index, method, idx)``
    triples — ``method`` is a Fleet chaos hook name (``'kill'``,
    ``'wedge'``, ``'unwedge'``) applied to replica ``idx`` just before
    submission ``at_request_index``; each firing is timestamped into
    the report.  ``idx = -1`` resolves AT FIRE TIME to the router's
    :meth:`~.router.FleetRouter.primary_replica` (the one carrying the
    load), so a scripted kill always lands on the serving path even
    when bucket affinity pinned the whole workload to one home — and
    an ``unwedge -1`` re-targets whatever the last ``wedge`` hit.
    ``rate_hz`` paces submissions (None = as fast as possible).
    Completions are timestamped by polling ``done()`` so the report's
    ``samples`` reflect when each handle actually resolved, not the
    order the caller happened to wait in; each is held against its
    program's solo run on ``device`` (default the card).

    The fleet contract under fire, assertable from the report:
    ``hung == 0``, ``bit_mismatches == 0``, every non-completion a
    typed error, and ``ok_in_window(kill_t, kill_t + w) > 0`` —
    serving never stops while a replica is down.
    """
    rng = np.random.default_rng(seed)
    bits = {i: rng.integers(0, 2, size=(shots, mp.n_cores,
                                        cfg.max_meas)).astype(np.int32)
            for i, mp in enumerate(mps)}
    refs = {}
    report = FleetSoakReport()
    start = time.monotonic()
    script = sorted(actions, key=lambda a: a[0])
    ai = 0
    resolved = {}                # method -> last concrete replica idx

    def fire(method, idx):
        if idx == -1:
            if method == 'unwedge' and 'wedge' in resolved:
                idx = resolved['wedge']
            else:
                rid = fleet.router.primary_replica()
                rids = fleet.replica_ids()
                idx = rids.index(rid) if rid in rids else 0
        resolved[method] = idx
        getattr(fleet, method)(idx)
        report.actions.append(
            (round(time.monotonic() - start, 4), method, idx))

    pending = {}                 # handle -> (program idx, submit time)
    for i in range(n_requests):
        while ai < len(script) and script[ai][0] <= i:
            _, method, idx = script[ai]
            ai += 1
            fire(method, idx)
        if rate_hz:
            time.sleep(1.0 / rate_hz)
        pi = i % len(mps)
        t0 = time.monotonic()
        try:
            handle = fleet.submit(mps[pi], bits[pi], cfg=cfg)
        except Exception as exc:     # noqa: BLE001 - typed refusal
            report.rejected += 1
            report.errors[type(exc).__name__] += 1
            report.samples.append((round(t0 - start, 4),
                                   type(exc).__name__))
            continue
        report.submitted += 1
        pending[handle] = (pi, t0)
    for _, method, idx in script[ai:]:   # actions past the last submit
        fire(method, idx)
    deadline = time.monotonic() + result_timeout_s
    while pending and time.monotonic() < deadline:
        for handle in [h for h in pending if h.done()]:
            pi, t0 = pending.pop(handle)
            t_rel = round(time.monotonic() - start, 4)
            exc = handle.exception(timeout=0)
            if exc is not None:
                report.errors[type(exc).__name__] += 1
                report.samples.append((t_rel, type(exc).__name__))
                continue
            got = handle.result(timeout=0)
            report.completed += 1
            report.latencies_s.append(time.monotonic() - t0)
            report.samples.append((t_rel, 'ok'))
            if pi not in refs:
                refs[pi] = _solo(mps[pi], bits[pi], cfg, device)
            want = refs[pi]
            same = set(got) == set(want) and all(
                np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                for k in want)
            if not same:
                report.bit_mismatches += 1
        time.sleep(0.005)
    report.hung += len(pending)
    return report
