"""Shape-bucketed coalescing: which requests may share one dispatch.

The whole point of the service is that co-batched requests share one
launch sequence of the multi-program generic engine
(``simulate_multi_batch`` runs P programs as ``P x B`` lanes of one
engine call, whatever their content).  The coalescing key is the set of
things that pick that call's shapes or change its semantics, as in the
JAX package, whose compiled executables key on them:

* ``n_cores`` — the stacked tensor's core axis;
* ``isa.shape_bucket(n_instr)`` — the power-of-two instruction bucket
  every member is DONE-padded into;
* the element geometry tuple — stacked programs share one set of
  per-core sample-rate constants (``stack_machine_programs`` would
  reject a mismatch; keying on it means mismatched submissions simply
  land in different buckets instead of failing a batch);
* the normalized :class:`InterpreterConfig`;
* the :func:`~..sim.interpreter.program_traits` tuple, carried on the
  key but left out of its equality (:mod:`.bucketspec`): programs with
  different instruction mixes share a batch, which runs the union of
  their traits.

The key is a :class:`~.bucketspec.BucketSpec` (unbound template): the
same value the AOT warmup path compiles against and the learned bucket
catalog persists — one identity from admission to dispatch.

Shot counts are deliberately NOT part of the key: short requests are
padded up to the batch's shot count by replicating their own rows
(deterministic execution makes replica lanes observationally inert;
``demux_multi_batch`` trims them back off).  Warmup *binds* the
template to concrete ``(n_programs, n_shots)`` before compiling.

Inside a bucket, requests order by priority lane (higher first) with
FIFO arrival as the tiebreak; a bucket becomes ripe when it holds
``max_batch_programs`` requests or its oldest member has waited
``max_wait_ms`` — the classic continuous-batching latency/throughput
dial (docs/SERVING.md).

With tenant fair queueing on (docs/SERVING.md "Tenants"), a deficit
round-robin layer sits ABOVE that order: each ``pop_batch`` replenishes
every backlogged tenant's credit by its configured weight, serves the
most-credited tenant first, and charges one credit per claimed request
— so claim order interleaves tenants by weight instead of strict
global FIFO, and a greedy tenant's thousandth request cannot starve a
victim's first.  Within a tenant, (priority desc, arrival asc) order
is unchanged, and a single-tenant queue reduces exactly to the legacy
behavior.
"""

from __future__ import annotations

import time

from .bucketspec import BucketSpec
from .request import DeadlineError, Request


def bucket_key(mp, cfg) -> BucketSpec:
    """The coalescing key: requests with equal keys may share a batch."""
    return BucketSpec.from_program(mp, cfg)


def shed_exempt(req: Request) -> bool:
    """Work the overload shedder may NEVER evict, regardless of another
    tenant's admission pressure: in-flight stream chunks (``rounds``/
    ``sid`` set — killing one round breaks a live session's exactly-
    once contract) and service-internal work carrying a negative
    ``seq`` (canary probes, SDC audit re-executions)."""
    return req.rounds is not None or req.sid is not None or req.seq < 0


class Coalescer:
    """Per-bucket pending queues.  NOT thread-safe on its own: every
    method is called under the service's lock — the coalescer is the
    data structure, the service owns the concurrency."""

    def __init__(self, max_batch_programs: int, max_wait_s: float,
                 tenant_weights: dict = None):
        self.max_batch_programs = max_batch_programs
        self.max_wait_s = max_wait_s
        # weighted fair queueing: None keeps the legacy global
        # (priority, arrival) claim order; a dict — the service's LIVE
        # view of configured weights, unknown tenants defaulting to
        # 1.0 — turns on deficit round-robin across tenants
        self._weights = tenant_weights
        self._deficit: dict = {}    # tenant -> accumulated DRR credit
        self._buckets: dict = {}     # key -> list[Request], arrival order
        self._depth = 0
        # buckets that ripened elsewhere and were migrated in by work
        # stealing: already past the latency dial once, so they stay
        # immediately dispatchable here even when the migration dropped
        # them below the count threshold
        self._forced: set = set()
        # requests observed leaving via handle.cancel() (dropped during
        # pruning or lost the claim race) — the service folds this into
        # its stats() 'cancelled' count
        self.dropped_cancelled = 0

    def __len__(self) -> int:
        return self._depth

    def push(self, key: tuple, req: Request,
             forced: bool = False) -> None:
        """``forced`` marks the bucket immediately dispatchable — used
        when re-queueing a parked retry, which already waited out its
        backoff and must not sit through the latency dial again."""
        self._buckets.setdefault(key, []).append(req)
        self._depth += 1
        if forced:
            self._forced.add(key)

    def cancel_all(self, exc: BaseException) -> int:
        """Fail every queued request (non-draining shutdown)."""
        n = 0
        for reqs in self._buckets.values():
            for req in reqs:
                if req.handle._fail(exc):
                    n += 1
        self._buckets.clear()
        self._forced.clear()
        self._depth = 0
        return n

    def _prune(self, now: float) -> list:
        """Drop cancelled requests; fail expired ones (batch-boundary
        deadline semantics).  Returns the expired requests so the
        service can count them."""
        expired = []
        for key in list(self._buckets):
            kept = []
            for req in self._buckets[key]:
                if req.handle.done():           # cancelled meanwhile
                    self._depth -= 1
                    if req.handle.cancelled():
                        self.dropped_cancelled += 1
                elif req.expired(now):
                    self._depth -= 1
                    if req.handle._fail(DeadlineError(
                            f'deadline passed while queued '
                            f'({now - req.submit_t:.3f} s after '
                            f'submission)')):
                        expired.append(req)
                else:
                    kept.append(req)
            if kept:
                self._buckets[key] = kept
            else:
                del self._buckets[key]
                self._forced.discard(key)
        return expired

    def _ripe(self, reqs: list, now: float, flush: bool) -> bool:
        if flush or len(reqs) >= self.max_batch_programs:
            return True
        return (now - min(r.submit_t for r in reqs)) >= self.max_wait_s

    def pop_batch(self, now: float = None, flush: bool = False):
        """Claim and return the next batch:
        ``(key, [Request, ...], expired)`` — ``key`` is None when
        nothing is ripe (``expired`` lists deadline-failed requests
        either way).

        Among ripe buckets the one whose best request has the highest
        priority wins (oldest arrival breaks the tie); within the
        bucket, up to ``max_batch_programs`` requests leave in
        (priority desc, arrival asc) order.  With tenant fair queueing
        on, deficit round-robin picks the serving tenant first and the
        bucket/claim order interleaves tenants by weight (see module
        docstring).  Every returned request has been atomically
        claimed — ``cancel()`` on it returns False from here on.
        """
        if now is None:
            now = time.monotonic()
        expired = self._prune(now)
        ripe = {key: reqs for key, reqs in self._buckets.items()
                if key in self._forced or self._ripe(reqs, now, flush)}
        if not ripe:
            return None, [], expired
        if self._weights is None:
            best_key, best_rank = None, None
            for key, reqs in ripe.items():
                head = min(reqs, key=lambda r: (-r.priority, r.seq))
                rank = (-head.priority, head.seq)
                if best_rank is None or rank < best_rank:
                    best_key, best_rank = key, rank
            reqs = sorted(self._buckets[best_key],
                          key=lambda r: (-r.priority, r.seq))
            take, leave = (reqs[:self.max_batch_programs],
                           reqs[self.max_batch_programs:])
        else:
            best_key, take, leave = self._pop_drr(ripe)
        batch = []
        for r in take:
            tok = r.handle._claim()
            if tok:
                # the attempt token travels with the request: the
                # executor presents it back at fulfill/fail time, so a
                # dispatch that hung (and whose request was retried
                # elsewhere) can never double-complete the handle
                r.claim_token = tok
                batch.append(r)
            elif r.handle.cancelled():   # lost the race to cancel()
                self.dropped_cancelled += 1
        if leave:
            self._buckets[best_key] = sorted(leave, key=lambda r: r.seq)
        else:
            del self._buckets[best_key]
            self._forced.discard(best_key)
        self._depth -= len(take)
        if not batch:       # every candidate was cancelled in the race
            return None, [], expired
        return best_key, batch, expired

    def _weight(self, tenant: str) -> float:
        try:
            w = float(self._weights.get(tenant, 1.0))
        except (TypeError, ValueError):
            w = 1.0
        return w if w > 0 else 1.0

    def _pop_drr(self, ripe: dict):
        """Deficit-round-robin selection: pick the serving tenant, then
        the bucket holding its best work, then claim up to
        ``max_batch_programs`` requests interleaving tenants.  Returns
        ``(key, take, leave)`` for ``pop_batch`` to claim/write back.

        Classic DRR rules: every tenant with ripe backlog earns its
        weight in credit per visit (capped at weight x batch size so an
        idle-then-bursting tenant cannot bank unbounded credit), a
        drained tenant forfeits its credit, and each claimed request
        costs one credit.  A single-tenant queue degenerates to the
        legacy (priority desc, arrival asc) order exactly.
        """
        oldest = {}
        for reqs in ripe.values():
            for r in reqs:
                if r.tenant not in oldest or r.seq < oldest[r.tenant]:
                    oldest[r.tenant] = r.seq
        for t in list(self._deficit):
            if t not in oldest:
                del self._deficit[t]
        cap = float(max(self.max_batch_programs, 1))
        for t in oldest:
            w = self._weight(t)
            # cap floor of 1.0 x batch: a sub-unit weight must still
            # be able to bank one whole credit, or it could never claim
            self._deficit[t] = min(self._deficit.get(t, 0.0) + w,
                                   max(w, 1.0) * cap)
        serve = min(oldest,
                    key=lambda t: (-self._deficit[t], oldest[t]))
        best_key, best_rank = None, None
        for key, reqs in ripe.items():
            mine = [r for r in reqs if r.tenant == serve]
            if not mine:
                continue
            head = min(mine, key=lambda r: (-r.priority, r.seq))
            rank = (-head.priority, head.seq)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        by_t = {}
        for r in self._buckets[best_key]:
            by_t.setdefault(r.tenant, []).append(r)
        for q in by_t.values():
            q.sort(key=lambda r: (-r.priority, r.seq))
        torder = sorted(by_t, key=lambda t: (
            t != serve, -self._deficit.get(t, 0.0),
            min(r.seq for r in by_t[t])))
        take = []
        while len(take) < self.max_batch_programs \
                and any(by_t.values()):
            progressed = False
            for t in torder:
                q = by_t[t]
                while q and len(take) < self.max_batch_programs \
                        and self._deficit.get(t, 0.0) >= 1.0:
                    take.append(q.pop(0))
                    self._deficit[t] -= 1.0
                    progressed = True
            if not progressed:
                # credit exhausted with batch slots still open: start
                # another DRR round for the tenants still backlogged
                # HERE, so one pop's composition honors the weights
                # (weight w > 0 guarantees this replenish eventually
                # banks a whole credit — the loop terminates)
                for t in torder:
                    if by_t[t]:
                        w = self._weight(t)
                        self._deficit[t] = min(
                            self._deficit.get(t, 0.0) + w,
                            max(w, 1.0) * cap)
        leave = [r for q in by_t.values() for r in q]
        return best_key, take, leave

    def ripe_keys(self, now: float = None, flush: bool = False) -> list:
        """Keys of the buckets a dispatcher could claim right now, best
        head first (the order ``pop_batch`` would prefer them).  A pure
        view — no pruning, no claiming — used by the work-stealing path
        to pick a victim bucket; staleness is fine because ``absorb``
        re-validates every request at the re-queue boundary."""
        if now is None:
            now = time.monotonic()
        ranked = []
        for key, reqs in self._buckets.items():
            live = [r for r in reqs if not r.handle.done()]
            if not live:
                continue
            if key not in self._forced \
                    and not self._ripe(live, now, flush):
                continue
            head = min(live, key=lambda r: (-r.priority, r.seq))
            ranked.append(((-head.priority, head.seq), key))
        return [key for _, key in sorted(ranked)]

    def migrate_bucket(self, key: tuple, max_n: int) -> list:
        """Remove up to ``max_n`` requests from ``key``'s bucket in
        claim order (priority desc, arrival asc) WITHOUT claiming them
        — work stealing moves whole ripened batches between per-device
        queues, and the requests must stay cancellable in flight.  The
        receiving queue's :meth:`absorb` re-runs the deadline/cancel
        checks the requests aged past while queued here."""
        reqs = self._buckets.get(key)
        if not reqs:
            return []
        ranked = sorted(reqs, key=lambda r: (-r.priority, r.seq))
        take, leave = ranked[:max_n], ranked[max_n:]
        if leave:
            self._buckets[key] = sorted(leave, key=lambda r: r.seq)
        else:
            del self._buckets[key]
            self._forced.discard(key)
        self._depth -= len(take)
        return take

    def migrate_all(self) -> dict:
        """Remove EVERY queued request, keyed by bucket — the
        quarantine path: a tripped/lost executor's whole backlog
        re-homes onto healthy executors via their :meth:`absorb` (which
        re-runs the deadline/cancel checks, exactly like a work-steal
        migration)."""
        out = {key: sorted(reqs, key=lambda r: (-r.priority, r.seq))
               for key, reqs in self._buckets.items()}
        self._buckets.clear()
        self._forced.clear()
        self._depth = 0
        return out

    def shed_candidate(self, below_priority: int,
                       tenant_pressure: dict = None):
        """The single most-sheddable queued request strictly below
        ``below_priority`` — the most-over-quota tenant first (per the
        service-supplied ``tenant_pressure`` map, higher = more over
        quota), then lowest priority, then newest arrival within it
        (the request that has invested the least waiting) — as
        ``(key, req)``, or None.  Stream chunks and service-internal
        work are exempt (:func:`shed_exempt`): another tenant's
        admission pressure must never break a live session.  A pure
        view: the service compares candidates ACROSS executor queues
        before calling :meth:`remove` on the loser's, then fails it
        with ``OverloadError`` (the overload-control eviction path)."""
        worst, worst_key, worst_rank = None, None, None
        for key, reqs in self._buckets.items():
            for r in reqs:
                if r.priority >= below_priority or r.handle.done():
                    continue
                if shed_exempt(r):
                    continue
                p = 0.0 if tenant_pressure is None else \
                    float(tenant_pressure.get(r.tenant, 0.0))
                rank = (-p, r.priority, -r.seq)
                if worst_rank is None or rank < worst_rank:
                    worst, worst_key, worst_rank = r, key, rank
        if worst is None:
            return None
        return worst_key, worst

    def remove(self, key: tuple, req: Request) -> bool:
        """Drop one specific queued request (the shed eviction);
        False when it already left the queue some other way."""
        reqs = self._buckets.get(key)
        if not reqs or req not in reqs:
            return False
        reqs.remove(req)
        if not reqs:
            del self._buckets[key]
            self._forced.discard(key)
        self._depth -= 1
        return True

    def absorb(self, key: tuple, reqs: list, now: float = None) -> list:
        """Re-queue migrated requests: the stolen batch's landing point.

        A request cancelled in flight is dropped (counted in
        ``dropped_cancelled``); one whose deadline passed while it sat
        in the victim's queue is failed with :class:`DeadlineError`
        HERE, at the re-queue boundary, so a migrated request can never
        outlive its ``deadline_ms`` silently.  Returns the expired
        requests for the service's stats."""
        if now is None:
            now = time.monotonic()
        expired = []
        for req in reqs:
            if req.handle.done():
                if req.handle.cancelled():
                    self.dropped_cancelled += 1
                continue
            if req.expired(now):
                if req.handle._fail(DeadlineError(
                        f'deadline passed while queued (expired during '
                        f'work-steal migration, {now - req.submit_t:.3f}'
                        f' s after submission)')):
                    expired.append(req)
                continue
            req.migrations += 1
            req.handle.migrations = req.migrations
            if req.handle._trace is not None:
                # the migration hop in the request's span chain
                # (steal / quarantine re-home — docs/OBSERVABILITY.md)
                req.handle._trace.instant('migrate', t=now,
                                          hop=req.migrations)
            self.push(key, req)
            # the batch already ripened at the victim; keep it
            # immediately dispatchable here even if the migration
            # dropped it below the count threshold
            self._forced.add(key)
        return expired

    def next_event(self, now: float = None) -> float:
        """Seconds until the next scheduled wake-up (a bucket ripening
        or a deadline expiring), or None when the queue is empty — the
        dispatcher's condition-wait timeout."""
        if not self._buckets:
            return None
        if self._forced:
            return 0.0          # a migrated-in bucket is ready now
        if now is None:
            now = time.monotonic()
        horizon = None
        for reqs in self._buckets.values():
            oldest = min(r.submit_t for r in reqs)
            events = [oldest + self.max_wait_s]
            events += [r.deadline for r in reqs if r.deadline is not None]
            t = min(events)
            horizon = t if horizon is None else min(horizon, t)
        return max(horizon - now, 0.0)
