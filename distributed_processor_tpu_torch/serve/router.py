"""FleetRouter: the front door that load-balances across replicas.

One router process fans ``submit`` / ``submit_source`` traffic out over
N :class:`~.service.ExecutionService` replicas (separate processes,
reached through :mod:`.transport`), and keeps serving — bit-identical
or typed — while replicas die, hang, or restart (docs/FLEET.md).  The
design deliberately re-uses the in-process supervision vocabulary one
ring out:

* **Health gossip.**  A gossip thread polls every replica's ``stats()``
  digest (queue depth, est_wait, health mix) on ``gossip_interval_ms``.
  Each response re-arms the replica's heartbeat; a replica whose last
  heartbeat exceeds ``liveness_window_ms`` is declared down
  (``gossip_stale`` + ``replica_down`` flight events) even when its TCP
  connection still accepts bytes — the wedged-process case a connection
  error can never surface.  A stale replica that beats again (a SIGCONT
  after a wedge) is simply re-admitted: its recovered requests already
  completed elsewhere, and the stale wire callbacks were forgotten, so
  resuming routing to it is safe.
* **Fleet-level circuit breakers.**  Each replica carries a
  :class:`~.supervise.CircuitBreaker`; consecutive infrastructure
  failures attributed to it (connection loss, ``OverloadError``, chaos
  crashes) quarantine it for the breaker cooldown, and the first
  heartbeat after cooldown re-admits it.
* **Cross-replica retry.**  In-flight requests on a dead replica are
  recovered from the router's shadow ledger and re-dispatched to a
  surviving replica under the shared :class:`~.supervise.RetryPolicy`:
  attempts are bounded, backoff is exponential, exhaustion surfaces the
  ORIGINAL infrastructure error.  Typed program-class errors
  (``FaultError``, validation — :func:`is_infrastructure_error`) and
  terminal request outcomes (``DeadlineError``, ``CancelledError`` /
  ``ShutdownError``) are NEVER retried.  Every dispatch carries an
  attempt token (mirroring :class:`~.request.RequestHandle`'s claim
  tokens): a straggling response or failure report whose token went
  stale is a silent no-op, so a request can never be double-completed
  or double-retried no matter how wire callbacks interleave.
* **Bucket affinity.**  Placement is sticky per
  :class:`~.bucketspec.BucketSpec` coalescing template: a bucket's home
  replica keeps its warmed shapes hot, exactly like the per-device
  sticky-bucket map inside the service; ties break to the least-loaded
  live replica by gossiped est_wait / queue depth.

The router owns no execution and no devices — it is restartable state:
everything here rebuilds from replicas' gossip within one interval.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time

import numpy as np

from ..integrity import IntegrityError, program_digest, stats_digest
from ..sim.interpreter import is_infrastructure_error
from ..utils import profiling
from ..obs import (ClockOffsetEstimator, FlightRecorder, Histogram,
                   Tracer, merged_prometheus_text,
                   prometheus_snapshot_lines, write_chrome_trace)
from .. import isa
from .batcher import bucket_key
from .request import (CancelledError, DeadlineError, RequestHandle,
                      ServiceClosedError, ShutdownError)
from .stream import StreamSession
from .supervise import CircuitBreaker, RetryPolicy
from .transport import ReplicaClient, ReplicaLostError

ROUTER_THREAD_PREFIX = 'dproc-serve-fleet'


def is_terminal_error(exc: BaseException) -> bool:
    """True when a failed attempt must surface to the caller instead of
    retrying on another replica: program-class errors reproduce
    anywhere (:func:`is_infrastructure_error` False), and expired
    deadlines / cancellations are properties of the REQUEST's clock —
    infrastructure-class by taxonomy, but re-execution cannot
    un-expire them."""
    return (not is_infrastructure_error(exc)
            or isinstance(exc, (DeadlineError, CancelledError)))


class _FleetRequest:
    """Router-side shadow of one submission: everything needed to
    re-dispatch it on another replica (the full payload), plus the
    retry ledger.  ``attempts`` doubles as the attempt token — each
    dispatch bumps it, and response/failure handlers that present a
    stale ``(rid, token)`` pair are dropped."""

    __slots__ = ('handle', 'op', 'payload', 'key', 'attempts',
                 'first_error', 'excluded', 'submit_t', 'rid',
                 'wire_id', 'done', 'trace', 'sent_t')

    def __init__(self, op, payload, key):
        self.handle = RequestHandle()
        self.op = op
        self.payload = payload
        self.key = key
        self.attempts = 0           # executions started == token
        self.first_error = None     # original infra error, kept for
        self.excluded = set()       # exhaustion (RetryPolicy rule)
        self.submit_t = time.monotonic()
        self.rid = None             # replica of the CURRENT attempt
        self.wire_id = None
        self.done = False
        self.trace = None           # router-side TraceContext or None
        self.sent_t = None          # wire send time of CURRENT attempt


class _Replica:
    __slots__ = ('rid', 'client', 'breaker', 'alive', 'quarantined',
                 'last_beat', 'digest', 'inflight', 'gossip_pending',
                 'reconnect_t')

    def __init__(self, rid, client, breaker):
        self.rid = rid
        self.client = client
        self.breaker = breaker
        self.alive = True
        self.quarantined = False
        self.last_beat = time.monotonic()
        self.digest = {}
        self.inflight = {}          # wire_id -> (_FleetRequest, token)
        self.gossip_pending = False
        self.reconnect_t = 0.0      # last re-dial attempt (throttle)

    def routable(self) -> bool:
        return self.alive and not self.quarantined \
            and self.client is not None and self.client.alive

    def load(self) -> tuple:
        # gossiped load: est_wait (None sorts as 0) then queue depth
        ew = self.digest.get('est_wait_ms') or 0.0
        return (float(ew), int(self.digest.get('queue_depth') or 0),
                len(self.inflight))


class FleetRouter:
    """Load-balancing, self-healing front door over replica clients.

    Replicas register through :meth:`add_replica` (the
    :class:`~.fleet.Fleet` process manager calls it at spawn and
    respawn); ``submit``/``submit_source`` mirror the service's
    signatures and return local :class:`RequestHandle`\\ s fulfilled
    from wire responses.  ``shutdown`` fails everything still pending
    with :class:`ShutdownError` — after it returns no handle can block
    forever, same contract as the service.
    """

    def __init__(self, *, default_cfg=None, retry_policy=None,
                 gossip_interval_ms: float = 25.0,
                 liveness_window_ms: float = 250.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_ms: float = 500.0,
                 name: str = None, flight_events: int = 512,
                 trace_sample: float = 0.0, trace_keep: int = 1024,
                 slo_budgets: dict = None,
                 slo_min_samples: int = 16,
                 integrity: bool = False):
        if liveness_window_ms <= gossip_interval_ms:
            raise ValueError('liveness window must exceed the gossip '
                             'interval (one missed beat is not death)')
        self.name = name or 'fleet'
        self._default_cfg = default_cfg
        self._retry_policy = retry_policy or RetryPolicy()
        self._gossip_interval_s = gossip_interval_ms / 1e3
        self._liveness_window_s = liveness_window_ms / 1e3
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_ms / 1e3
        self.flight_recorder = FlightRecorder(flight_events)
        self._latency_h = Histogram('fleet.latency_ms')
        # fleet observability (docs/OBSERVABILITY.md "Fleet
        # observability"): the router makes the sampling decision,
        # ships it on the wire, and stitches the replica's spans back
        # into the same context; per-replica clock offsets come from
        # the gossip heartbeat RTT; per-stage histograms feed the SLO
        # watch evaluated on the gossip cadence
        self._tracer = Tracer(trace_sample, keep=trace_keep)
        self._clock: dict = {}          # rid -> ClockOffsetEstimator
        self._stage_h: dict = {}        # stage name -> Histogram
        self._flight_cache: dict = {}   # rid -> last ring digest/pull
        self._slo_budgets = dict(slo_budgets or {})
        self._slo_min_samples = int(slo_min_samples)
        # integrity fabric (docs/ROBUSTNESS.md "Integrity"): stamp a
        # program content digest on every submit (the replica verifies
        # it survived the pickle round trip) and verify the replica's
        # result-stat digest on every reply — a mismatch becomes a
        # retryable IntegrityError, never delivered bits
        self._integrity = bool(integrity)
        self._slo_state: dict = {}      # stage -> currently-breached
        self._slo_last: dict = {}       # stage -> last evaluation
        self._slo_breaches = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._replicas: dict = {}       # rid -> _Replica
        self._home: dict = {}           # bucket identity -> rid
        self._pending: list = []        # heap of (eligible_t, seq, freq)
        self._pending_seq = 0
        self._closing = False
        # counters (written under _lock)
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._retries = 0
        self._retry_exhausted = 0
        self._failovers = 0             # requests recovered off a dead
        self._replica_down = 0          # replica and re-queued
        self._replica_up = 0
        self._gossip_stale = 0
        self._breaker_trips = 0
        self._readmissions = 0
        # streaming sessions (docs/SERVING.md "Streaming sessions"):
        # the router keeps its OWN session registry — chunks reach the
        # replica as detached rounds submissions, and stickiness comes
        # from the ('stream', sid) home key, so a replica death steals
        # the whole session to a new home without replica-side state
        self._stream_seq = itertools.count()
        self._stream_sessions: set = set()
        self._stream_rounds = 0
        self._gossip_thread = threading.Thread(
            target=self._gossip_loop,
            name=f'{ROUTER_THREAD_PREFIX}-gossip-{self.name}',
            daemon=True)
        self._retry_thread = threading.Thread(
            target=self._retry_loop,
            name=f'{ROUTER_THREAD_PREFIX}-retry-{self.name}',
            daemon=True)
        self._gossip_thread.start()
        self._retry_thread.start()

    # -- replica membership ---------------------------------------------

    def add_replica(self, rid: str, address) -> None:
        """Connect to (or reconnect to a respawned) replica at
        ``address`` and start routing to it."""
        client = ReplicaClient(
            address,
            # late-bound `client`: the loss guard must name the exact
            # connection that died, so a replaced client's death can
            # never take down its successor
            on_lost=lambda exc: self._replica_lost(rid, exc,
                                                   via=client))
        with self._lock:
            old = self._replicas.get(rid)
        if old is not None and old.alive:
            # replacing a live replica: fail its in-flight work over
            # first so nothing is silently dropped
            self._replica_lost(rid, ReplicaLostError(f'{rid} replaced'))
        with self._lock:
            old = self._replicas.get(rid)
            self._replicas[rid] = _Replica(
                rid, client,
                CircuitBreaker(self._breaker_threshold,
                               self._breaker_cooldown_s))
            self._replica_up += 1
            self._cv.notify_all()
        if old is not None and old.client is not None:
            old.client.close()
        profiling.counter_inc('fleet.replica_up')
        self.flight_recorder.record('replica_up', rid=rid,
                                    address=list(address))

    def remove_replica(self, rid: str) -> None:
        """Forget a replica (fleet scale-down): in-flight work fails
        over exactly as if it died."""
        self._replica_lost(rid, ReplicaLostError(f'{rid} removed'))
        with self._lock:
            rep = self._replicas.pop(rid, None)
        if rep is not None and rep.client is not None:
            rep.client.close()

    def replica_ids(self) -> list:
        with self._lock:
            return sorted(self._replicas)

    def primary_replica(self):
        """The routable replica carrying the most load right now
        (in-flight wire requests, then gossiped queue depth, then home
        buckets) — chaos tooling kills THIS one so the fault always
        lands on the serving path, even when bucket affinity has
        pinned a single-bucket workload to one home."""
        with self._lock:
            homes = collections.Counter(self._home.values())
            live = [r for r in self._replicas.values()
                    if r.routable()]
            if not live:
                return None
            best = max(live, key=lambda r: (
                len(r.inflight),
                int(r.digest.get('queue_depth') or 0),
                homes[r.rid], r.rid))
            return best.rid

    def call_replica(self, rid: str, op: str = 'stats', payload=None,
                     timeout_s: float = 30.0):
        """Synchronous wire call to ONE specific replica (fleet tests
        and tooling inspect individual replicas this way — e.g. the
        warmed-respawn assertion reads the new replica's compile
        counters directly)."""
        with self._lock:
            rep = self._replicas.get(rid)
            client = rep.client if rep is not None else None
        if client is None:
            raise KeyError(f'unknown replica {rid!r}')
        return client.call(op, payload or {}, timeout_s=timeout_s)

    # -- submission ------------------------------------------------------

    def submit(self, mp, meas_bits=None, *, shots: int = None,
               init_regs=None, cfg=None, priority: int = 0,
               deadline_ms: float = None,
               fault_mode: str = None,
               tenant: str = None) -> RequestHandle:
        payload = dict(mp=mp, meas_bits=meas_bits, shots=shots,
                       init_regs=init_regs,
                       cfg=cfg if cfg is not None else self._default_cfg,
                       priority=priority, deadline_ms=deadline_ms,
                       fault_mode=fault_mode, tenant=tenant)
        if self._integrity:
            payload['_crc'] = program_digest(mp)
        return self._enqueue('submit', payload,
                             self._affinity_key(mp, payload['cfg']))

    def submit_source(self, program, qchip, *, shots: int = None,
                      meas_bits=None, init_regs=None, cfg=None,
                      priority: int = 0, deadline_ms: float = None,
                      fault_mode: str = None, n_qubits: int = 8,
                      pad_to: int = None,
                      tenant: str = None) -> RequestHandle:
        payload = dict(program=program, qchip=qchip, shots=shots,
                       meas_bits=meas_bits, init_regs=init_regs,
                       cfg=cfg if cfg is not None else self._default_cfg,
                       priority=priority, deadline_ms=deadline_ms,
                       fault_mode=fault_mode, n_qubits=n_qubits,
                       pad_to=pad_to, tenant=tenant)
        # no machine program yet, so no bucket: least-loaded placement
        return self._enqueue('submit_source', payload, None)

    # -- streaming (docs/SERVING.md "Streaming sessions") ----------------

    def open_stream(self, mp, *, cfg=None, decode=None,
                    round_deadline_ms: float = None, priority: int = 0,
                    fault_mode: str = None,
                    tenant: str = None) -> StreamSession:
        """Open a fleet-served streaming session: every round chunk is
        one ``submit_rounds`` wire frame and every result one
        incremental resolve frame, so the stream rides the ordinary
        replica protocol unchanged.  The session's home REPLICA is
        sticky via its ``('stream', sid)`` placement key; chunks reach
        the replica as detached rounds submissions (the replica holds
        no session state), so a chaos-killed home simply moves the
        session — in-flight chunks are recovered by the shadow ledger
        and the attempt tokens keep results exactly-once."""
        with self._lock:
            if self._closing:
                raise ServiceClosedError(
                    f'fleet router {self.name!r} is shut down')
            sid = next(self._stream_seq)
            self._stream_sessions.add(sid)
        profiling.counter_inc('fleet.stream.sessions_opened')
        self.flight_recorder.record('stream_open', sid=sid,
                                    router=self.name)
        return StreamSession(self, mp, sid, cfg=cfg, decode=decode,
                             round_deadline_ms=round_deadline_ms,
                             priority=priority, fault_mode=fault_mode,
                             tenant=tenant)

    def submit_rounds(self, mp, meas_bits, *, init_regs=None, cfg=None,
                      decode=None, priority: int = 0,
                      deadline_ms: float = None,
                      round_deadline_ms: float = None,
                      fault_mode: str = None,
                      stream: int = None,
                      tenant: str = None) -> RequestHandle:
        """Route one R-round chunk (``meas_bits`` ``[rounds, n_shots,
        n_cores, n_meas]``) to the stream's home replica — or
        least-loaded placement for a detached (``stream=None``)
        chunk."""
        meas_bits = np.asarray(meas_bits, np.int32)
        if meas_bits.ndim != 4:
            raise ValueError(
                f'submit_rounds meas_bits must be [rounds, n_shots, '
                f'n_cores, n_meas]; got shape {meas_bits.shape}')
        key = None
        if stream is not None:
            with self._lock:
                if stream not in self._stream_sessions:
                    raise ValueError(
                        f'stream {stream} is not open on router '
                        f'{self.name!r} (closed or never opened)')
            key = ('stream', int(stream))
        payload = dict(mp=mp, meas_bits=meas_bits, init_regs=init_regs,
                       cfg=cfg if cfg is not None else self._default_cfg,
                       decode=decode, priority=priority,
                       deadline_ms=deadline_ms,
                       round_deadline_ms=round_deadline_ms,
                       fault_mode=fault_mode, tenant=tenant)
        if self._integrity:
            payload['_crc'] = program_digest(mp)
        handle = self._enqueue('submit_rounds', payload, key)
        with self._lock:
            self._stream_rounds += int(meas_bits.shape[0])
        profiling.counter_inc('fleet.stream.rounds_submitted',
                              int(meas_bits.shape[0]))
        return handle

    def close_stream(self, sid: int) -> bool:
        """Deregister a streaming session and drop its home pin.
        Idempotent; returns whether the session was open."""
        with self._lock:
            present = sid in self._stream_sessions
            self._stream_sessions.discard(sid)
            self._home.pop(('stream', sid), None)
        if present:
            profiling.counter_inc('fleet.stream.sessions_closed')
        return present

    def _affinity_key(self, mp, cfg):
        """The bucket-affinity identity: the same unbound BucketSpec
        template the replica's coalescer will key on.  Any failure to
        compute it (odd cfg, validation the replica will surface typed)
        degrades to least-loaded placement, never an error."""
        try:
            from .service import _normalize_cfg
            ncfg, _ = _normalize_cfg(cfg, isa.shape_bucket(mp.n_instr))
            return bucket_key(mp, ncfg).identity()
        except Exception:               # noqa: BLE001
            return None

    def _enqueue(self, op, payload, key) -> RequestHandle:
        freq = _FleetRequest(op, payload, key)
        ctx = self._tracer.maybe_start()
        if ctx is not None:
            # the id + decision ride the wire so the replica opens a
            # context for exactly this request; the stitched result
            # lands back on this same context at response time
            freq.trace = ctx
            freq.handle._trace = ctx
            payload['_trace'] = ctx.trace_id
            ctx.instant('submit', t=freq.submit_t, op=op,
                        router=self.name)
        with self._lock:
            if self._closing:
                raise ServiceClosedError(
                    f'fleet router {self.name!r} is shut down')
            self._submitted += 1
        profiling.counter_inc('fleet.submitted')
        self._dispatch(freq)
        return freq.handle

    # -- placement / dispatch -------------------------------------------

    def _place_locked(self, freq):
        live = [r for r in self._replicas.values() if r.routable()]
        candidates = [r for r in live if r.rid not in freq.excluded] \
            or live                     # all excluded: any live one
        if not candidates:
            return None
        if freq.key is not None:
            home = self._home.get(freq.key)
            for r in candidates:
                if r.rid == home:
                    return r
        best = min(candidates, key=lambda r: (r.load(), r.rid))
        if freq.key is not None:
            self._home[freq.key] = best.rid
        return best

    def _dispatch(self, freq) -> None:
        """Place and send one request; parks it (the retry pump re-tries
        placement) when no replica is routable right now."""
        t_place = time.monotonic()
        with self._lock:
            if freq.done:
                return
            if self._closing:
                self._fail_locked(freq, ShutdownError(
                    f'fleet router {self.name!r} is shut down'))
                return
            rep = self._place_locked(freq)
            if rep is None:
                if freq.trace is not None:
                    freq.trace.instant('park',
                                       reason='no-routable-replica')
                self._park_locked(freq, time.monotonic() + 0.02)
                return
            freq.attempts += 1
            token = freq.attempts
            freq.rid = rep.rid
            freq.wire_id = None
            client = rep.client
        ctx = freq.trace
        if ctx is not None:
            ctx.span('route', t_place, time.monotonic(), rid=rep.rid,
                     attempt=token)
        # stamp the send time BEFORE the send: the response callback
        # (another thread) reads it for the wire.await span, and may
        # fire before call_async even returns
        freq.sent_t = t_send = time.monotonic()
        try:
            wire_id = client.call_async(
                freq.op, freq.payload,
                lambda ok, resp: self._on_response(
                    freq, rep.rid, token, ok, resp))
            if ctx is not None:
                ctx.span('wire.send', t_send, time.monotonic(),
                         rid=rep.rid, attempt=token)
        except ReplicaLostError as exc:
            # the send failed (the client's loss path may have already
            # routed this attempt through _on_response — the token
            # guard makes this call a no-op in that case)
            self._attempt_failed(freq, rep.rid, token, exc)
            return
        with self._lock:
            r = self._replicas.get(rep.rid)
            if (not freq.done and freq.attempts == token
                    and freq.rid == rep.rid
                    and r is not None and r.client is client):
                freq.wire_id = wire_id
                r.inflight[wire_id] = (freq, token)

    def _park_locked(self, freq, eligible_t: float) -> None:
        self._pending_seq += 1
        heapq.heappush(self._pending,
                       (eligible_t, self._pending_seq, freq))
        self._cv.notify_all()

    # -- responses / failures -------------------------------------------

    def _stale(self, freq, rid, token) -> bool:
        # caller holds _lock: a report about attempt `token` on `rid`
        # is stale once the request completed, moved on to another
        # attempt, or was already failed-over off this replica
        return freq.done or freq.attempts != token or freq.rid != rid

    def _on_response(self, freq, rid, token, ok, payload) -> None:
        t_resp = time.monotonic()
        piggyback = None
        if ok and isinstance(payload, dict) and '__trace__' in payload:
            # replica-side spans piggybacked on the resolve reply
            # (transport docstring).  Unwrap unconditionally: the
            # replica may have sampled this request on its own even
            # when the router did not
            piggyback = payload['__trace__']
            payload = payload['result']
        if ok and isinstance(payload, dict) and '__icrc__' in payload:
            # replica-stamped result digest (innermost wrapper): a
            # stat block that mutated anywhere between the replica's
            # stamp and here fails verification and takes the
            # cross-replica retry path instead of reaching the handle
            want = payload['__icrc__']
            payload = payload['result']
            try:
                good = stats_digest(payload) == want
            except Exception:           # noqa: BLE001 - mangled stats
                good = False
            if not good:
                profiling.counter_inc('integrity.wire_checksum_fail')
                self.flight_recorder.record('integrity_violation',
                                            rid=rid,
                                            boundary='result-digest')
                ok = False
                payload = IntegrityError(
                    f'result-stat digest mismatch from replica {rid}: '
                    f'corrupted between replica stamp and router')
        with self._lock:
            if self._stale(freq, rid, token):
                return
            rep = self._replicas.get(rid)
            if rep is not None and freq.wire_id is not None:
                rep.inflight.pop(freq.wire_id, None)
            if ok:
                freq.done = True
                self._completed += 1
                if rep is not None:
                    rep.breaker.record_success()
                lat_ms = (time.monotonic() - freq.submit_t) * 1e3
        if ok:
            if freq.trace is not None:
                self._stitch(freq, rid, piggyback, t_resp)
            self._latency_h.observe(lat_ms)
            self._observe_stage('total', lat_ms)
            # per-tenant latency rides the same stage-histogram
            # machinery as execution stages, so SLO budgets keyed
            # 'tenant:<name>' work in _check_slo unchanged
            # (docs/SERVING.md "Tenants")
            tenant = freq.payload.get('tenant') or 'default'
            self._observe_stage(f'tenant:{tenant}', lat_ms)
            profiling.counter_inc('fleet.completed')
            freq.handle._fulfill(payload)
            return
        if is_terminal_error(payload):
            if freq.trace is not None and freq.sent_t is not None:
                freq.trace.span('wire.await', freq.sent_t, t_resp,
                                rid=rid, attempt=token,
                                error=type(payload).__name__)
            with self._lock:
                self._fail_locked(freq, payload)
            return
        self._attempt_failed(freq, rid, token, payload)

    def _observe_stage(self, stage: str, dur_ms: float) -> None:
        with self._lock:
            h = self._stage_h.get(stage)
            if h is None:
                h = self._stage_h[stage] = Histogram(
                    f'fleet.stage.{stage}_ms')
        h.observe(dur_ms)

    def _stitch(self, freq, rid, piggyback, t_resp: float) -> None:
        """Merge a completed attempt's replica-side spans into the
        router-side context, clock-aligned so cross-process stage
        ordering is monotone.

        The alignment: shift replica-clock times by the gossip-RTT
        clock offset (:class:`ClockOffsetEstimator`), falling back to
        centering the server-side window ``[mono_recv, mono_send]``
        inside the wire window when the estimate has no samples or
        lands the spans outside it; then clamp into the wire window —
        a uniform shift plus clamping preserves replica-side order and
        pins every replica span between ``wire.send`` and the response
        arrival, so the stitched waterfall is monotone by
        construction.  The ``wire.await`` span carries ``wire_ms``:
        the round trip minus the replica-observed window — pure
        wire + queueing cost of the hop."""
        ctx = freq.trace
        ws = freq.sent_t if freq.sent_t is not None else t_resp
        args = {'rid': rid, 'attempt': freq.attempts}
        spans = list(piggyback['spans'] or []) if piggyback else []
        if piggyback and piggyback.get('mono_recv') is not None:
            remote_win = max(
                0.0, piggyback['mono_send'] - piggyback['mono_recv'])
            args['wire_ms'] = round(
                max(0.0, (t_resp - ws) - remote_win) * 1e3, 3)
        ctx.span('wire.await', ws, t_resp, **args)
        self._observe_stage('wire.await', (t_resp - ws) * 1e3)
        if not spans:
            return
        with self._lock:
            est = self._clock.get(rid)
        delta = -est.offset if est is not None and est.n else None
        lo = min(s['t0'] for s in spans)
        hi = max(s['t1'] if s['t1'] is not None else s['t0']
                 for s in spans)
        if delta is None or not (ws <= lo + delta
                                 and hi + delta <= t_resp):
            mid_remote = None
            if piggyback.get('mono_recv') is not None:
                mid_remote = 0.5 * (piggyback['mono_recv']
                                    + piggyback['mono_send'])
            delta = 0.5 * (ws + t_resp) - (
                mid_remote if mid_remote is not None
                else 0.5 * (lo + hi))
        for s in spans:
            t0 = min(max(s['t0'] + delta, ws), t_resp)
            t1 = None if s['t1'] is None \
                else min(max(s['t1'] + delta, ws), t_resp)
            sargs = dict(s['args'])
            sargs['replica'] = rid
            ctx.spans.append({'name': s['name'], 't0': t0, 't1': t1,
                              'args': sargs})
            if s['t1'] is not None:
                # stage duration from the REPLICA's clock: offset
                # estimation error cancels inside one clock domain
                self._observe_stage(s['name'],
                                    (s['t1'] - s['t0']) * 1e3)

    def _fail_locked(self, freq, exc) -> None:
        if freq.done:
            return
        freq.done = True
        self._failed += 1
        profiling.counter_inc('fleet.failed')
        freq.handle._fail(exc)

    def _attempt_failed(self, freq, rid, token, exc) -> None:
        """One infrastructure-class attempt failure: breaker
        bookkeeping on the replica, then retry-or-exhaust under the
        fleet RetryPolicy."""
        t_fail = time.monotonic()
        with self._lock:
            if self._stale(freq, rid, token):
                return
            if freq.trace is not None and freq.sent_t is not None:
                freq.trace.span('wire.await', freq.sent_t, t_fail,
                                rid=rid, attempt=token,
                                error=type(exc).__name__)
                freq.sent_t = None
            if freq.first_error is None:
                freq.first_error = exc
            freq.excluded.add(rid)
            freq.rid = None
            freq.wire_id = None
            exhausted = freq.attempts >= self._retry_policy.max_attempts
            if exhausted:
                self._retry_exhausted += 1
                # exhaustion surfaces the ORIGINAL error, same rule as
                # the in-process retry path
                self._fail_locked(freq, freq.first_error)
            else:
                self._retries += 1
                if freq.trace is not None:
                    # the failover hop: this attempt died on `rid`,
                    # the retry pump will re-place it elsewhere
                    freq.trace.instant('failover', rid=rid,
                                       error=type(exc).__name__,
                                       attempt=token)
                self._park_locked(
                    freq, time.monotonic()
                    + self._retry_policy.delay_s(freq.attempts - 1))
        self._record_replica_failure(rid, exc)
        if exhausted:
            profiling.counter_inc('fleet.retry_exhausted')
        else:
            profiling.counter_inc('fleet.retries')
            self.flight_recorder.record(
                'fleet_retry', rid=rid, error=type(exc).__name__,
                attempt=token)

    def _record_replica_failure(self, rid, exc) -> None:
        trip = False
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            if rep.breaker.record_failure() and not rep.quarantined:
                rep.quarantined = True
                rep.breaker.trip(time.monotonic())
                self._breaker_trips += 1
                trip = True
        if trip:
            profiling.counter_inc('fleet.breaker_trips')
            self.flight_recorder.record(
                'fleet_breaker_trip', rid=rid,
                error=type(exc).__name__)

    def _replica_lost(self, rid, exc, via=None) -> None:
        """Connection death or gossip staleness: declare the replica
        down, recover every in-flight request it held, and retry each
        on a surviving replica.  ``via`` (a ReplicaClient) scopes the
        report to one specific connection — a replaced client's death
        must not take down its successor."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or not rep.alive \
                    or (via is not None and rep.client is not via):
                return
            rep.alive = False
            self._replica_down += 1
            recovered = list(rep.inflight.items())
            rep.inflight.clear()
            # re-home this replica's buckets on next placement
            for key in [k for k, r in self._home.items() if r == rid]:
                del self._home[key]
            self._failovers += len(recovered)
            client = rep.client
        profiling.counter_inc('fleet.replica_down')
        self.flight_recorder.record(
            'replica_down', rid=rid, reason=type(exc).__name__,
            recovered=len(recovered))
        # federated post-mortem: try to pull the victim's flight ring.
        # A SIGKILLed replica can't answer (the last gossiped digest
        # stands in); a WEDGED one answers after SIGCONT — async, so a
        # frozen socket never stalls the loss path
        if client is not None and client.alive:
            try:
                client.call_async(
                    'flight', {},
                    lambda ok, resp: self._on_flight_pull(
                        rid, ok, resp))
            except Exception:           # noqa: BLE001 - best effort
                pass
        for wire_id, (freq, token) in recovered:
            # a straggler response for this wire id must not complete
            # the handle after the retry lands elsewhere
            if client is not None:
                client.forget(wire_id)
            profiling.counter_inc('fleet.failover')
            self._attempt_failed(freq, rid, token, exc)

    # -- gossip ----------------------------------------------------------

    def _gossip_loop(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
                reps = list(self._replicas.values())
            for rep in reps:
                client = rep.client
                if client is None or not client.alive \
                        or rep.gossip_pending:
                    continue
                rep.gossip_pending = True
                t_send = time.monotonic()
                try:
                    client.call_async(
                        'gossip', {},
                        lambda ok, resp, rep=rep, t_send=t_send:
                        self._on_gossip(rep.rid, ok, resp, t_send))
                except ReplicaLostError:
                    rep.gossip_pending = False
            self._reconnect_dead(time.monotonic())
            self._check_staleness(time.monotonic())
            self._check_slo()
            with self._cv:
                if self._closing:
                    return
                self._cv.wait(self._gossip_interval_s)

    def _reconnect_dead(self, now: float) -> None:
        """Re-dial replicas whose TCP connection died while the
        process may have survived — e.g. a wire-corruption teardown
        (:class:`~.transport.WireCorruptionError` resets the
        connection by design) or a transient network blip.  Without
        this, a surviving replica whose socket dropped would stay
        delisted forever: the gossip revival path only helps replicas
        whose connection still works.  Throttled per replica to the
        liveness window; a process that is genuinely gone refuses the
        dial (swallowed — the fleet monitor respawns it with a fresh
        address and calls :meth:`add_replica` itself)."""
        targets = []
        with self._lock:
            if self._closing:
                return
            for rep in self._replicas.values():
                if rep.client is not None and not rep.client.alive \
                        and now - rep.reconnect_t \
                        >= self._liveness_window_s:
                    rep.reconnect_t = now
                    targets.append((rep.rid, rep.client.address))
        for rid, address in targets:
            try:
                self.add_replica(rid, address)
            except (OSError, ReplicaLostError):
                pass

    def _on_gossip(self, rid, ok, resp, t_send: float = None) -> None:
        t_recv = time.monotonic()
        recovered = readmitted = False
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            rep.gossip_pending = False
            if not ok:
                return
            rep.last_beat = time.monotonic()
            stats = resp.get('stats', resp)
            rep.digest = {
                'queue_depth': stats.get('queue_depth'),
                'est_wait_ms': stats.get('est_wait_ms'),
                'health': stats.get('health'),
                'completed': stats.get('completed'),
            }
            # clock probe: the heartbeat carried the replica's mono
            # clock; (t_send, mono, t_recv) is one NTP-style sample
            if t_send is not None and resp.get('mono') is not None:
                est = self._clock.get(rid)
                if est is None:
                    est = self._clock[rid] = ClockOffsetEstimator()
                est.add_sample(t_send, resp['mono'], t_recv)
            # flight digest: the newest ring tail this replica ever
            # gossiped — the post-mortem fallback when the process is
            # SIGKILLed and the ring can no longer be pulled
            fl = resp.get('flight')
            if fl is not None:
                self._flight_cache[rid] = {
                    'source': 'gossip', 'recorded': fl['recorded'],
                    'dropped': fl.get('dropped', 0),
                    'counts': fl['counts'], 'events': fl['tail'],
                    'mono': resp.get('mono'), 'cached_t': t_recv,
                }
            if not rep.alive:
                # a wedged replica resumed (SIGCONT): its connection
                # never died, its heartbeat just went stale; its
                # recovered requests completed elsewhere and their
                # wire callbacks were forgotten, so routing to it
                # again is safe
                rep.alive = True
                self._replica_up += 1
                recovered = True
            if rep.quarantined and rep.breaker.ready_to_probe(
                    time.monotonic()):
                rep.quarantined = False
                rep.breaker.readmit()
                self._readmissions += 1
                readmitted = True
        if recovered:
            profiling.counter_inc('fleet.replica_up')
            self.flight_recorder.record('replica_up', rid=rid,
                                        reason='heartbeat-recovered')
        if readmitted:
            profiling.counter_inc('fleet.readmissions')
            self.flight_recorder.record('fleet_readmit', rid=rid)

    def _check_staleness(self, now: float) -> None:
        stale = []
        with self._lock:
            for rep in self._replicas.values():
                if rep.alive and rep.client is not None \
                        and rep.client.alive \
                        and now - rep.last_beat \
                        > self._liveness_window_s:
                    stale.append(rep.rid)
        for rid in stale:
            self._gossip_stale += 1
            profiling.counter_inc('fleet.gossip_stale')
            self.flight_recorder.record('gossip_stale', rid=rid)
            self._replica_lost(rid, ReplicaLostError(
                f'{rid} heartbeat stale (> '
                f'{self._liveness_window_s * 1e3:.0f} ms)'))

    def _on_flight_pull(self, rid, ok, resp) -> None:
        if not ok or not isinstance(resp, dict):
            return
        with self._lock:
            self._flight_cache[rid] = {
                'source': 'pull', 'recorded': resp.get('recorded', 0),
                'dropped': resp.get('dropped', 0),
                'counts': resp.get('counts', {}),
                'events': resp.get('events', []),
                'mono': resp.get('mono'),
                'cached_t': time.monotonic(),
            }

    # -- SLO watch -------------------------------------------------------

    def _check_slo(self) -> None:
        """Evaluate live per-stage p50/p99 against the configured
        budgets (``slo_budgets={'execute': {'p99_ms': 50.0}, ...}``;
        stage ``'total'`` is submit→fulfil latency).  Breaches are
        edge-triggered: one ``slo_breach`` flight event + counter per
        excursion, not one per gossip tick."""
        if not self._slo_budgets:
            return
        breaches = []
        for stage, budget in self._slo_budgets.items():
            with self._lock:
                h = self._latency_h if stage == 'total' \
                    else self._stage_h.get(stage)
            if h is None or h.count < self._slo_min_samples:
                continue
            p50, p99 = h.percentile(50), h.percentile(99)
            bad = any(
                budget.get(k) is not None and p > budget[k]
                for k, p in (('p50_ms', p50), ('p99_ms', p99)))
            with self._lock:
                prev = self._slo_state.get(stage, False)
                self._slo_state[stage] = bad
                self._slo_last[stage] = {
                    'p50_ms': round(p50, 3), 'p99_ms': round(p99, 3),
                    'breached': bad, 'samples': h.count}
                if bad and not prev:
                    self._slo_breaches += 1
                    breaches.append((stage, p50, p99, budget))
        for stage, p50, p99, budget in breaches:
            profiling.counter_inc('fleet.slo_breach')
            self.flight_recorder.record(
                'slo_breach', stage=stage, p50_ms=round(p50, 3),
                p99_ms=round(p99, 3), budget=dict(budget))

    def slo_breached(self) -> bool:
        """True while ANY configured SLO budget (fleet-wide stage or
        per-tenant ``'tenant:<name>'``) is currently breached — the
        level signal the fleet autoscaler integrates over time
        (docs/FLEET.md "Autoscaling"); the flight events stay
        edge-triggered."""
        with self._lock:
            return any(self._slo_state.values())

    # -- fleet observability (docs/OBSERVABILITY.md) ---------------------

    def set_trace_sample(self, sample: float) -> None:
        """Retune request-trace sampling live (bench sweeps and chaos
        tooling); retained contexts survive the change."""
        self._tracer.set_sample(sample)

    def trace_contexts(self) -> list:
        """Retained stitched trace contexts, oldest first."""
        return self._tracer.contexts()

    def dump_trace(self, path: str) -> int:
        """Export the stitched fleet trace (router spans + clock-
        aligned replica spans, one ``tid`` row per sampled request) as
        Chrome Trace JSON; returns the event count."""
        return write_chrome_trace(path, self._tracer.contexts(),
                                  pid=f'fleet-{self.name}')

    def clock_offsets(self) -> dict:
        """Per-replica estimated clock offset (``replica - router``
        seconds) and its worst-case error bound."""
        with self._lock:
            ests = dict(self._clock)
        return {rid: {'offset_s': est.offset,
                      'uncertainty_s': est.uncertainty_s,
                      'samples': est.n}
                for rid, est in sorted(ests.items()) if est.n}

    def fleet_metrics(self, timeout_s: float = 10.0) -> dict:
        """Pull every reachable replica's metrics-registry snapshot
        (the ``fleet-metrics`` wire op); unreachable replicas are
        silently absent — this is an observability read, never a
        liveness judgement."""
        out = {}
        for rid in self.replica_ids():
            try:
                resp = self.call_replica(rid, 'fleet-metrics',
                                         timeout_s=timeout_s)
                out[rid] = resp['metrics']
            except Exception:           # noqa: BLE001 - best effort
                continue
        return out

    def prometheus_text(self, timeout_s: float = 10.0) -> str:
        """One pane of glass: every replica's ``serve.*`` /
        ``compile_cache.*`` metric re-exposed with a ``replica`` label
        plus fleet-level rollups (summed counters, merged histograms),
        followed by the router's own first-class fleet metrics —
        routable count, per-replica gossip staleness and clock offset,
        failover/park/SLO counters, per-stage latency histograms."""
        lines = merged_prometheus_text(self.fleet_metrics(timeout_s),
                                       label='replica')
        lines.extend(self._fleet_prom_lines())
        return '\n'.join(lines) + ('\n' if lines else '')

    def _fleet_prom_lines(self) -> list:
        from ..obs.metrics import _format_labels
        with self._lock:
            now = time.monotonic()
            counters = {
                'fleet.submitted': self._submitted,
                'fleet.completed': self._completed,
                'fleet.failed': self._failed,
                'fleet.retries': self._retries,
                'fleet.retry_exhausted': self._retry_exhausted,
                'fleet.failovers': self._failovers,
                'fleet.replica_down': self._replica_down,
                'fleet.replica_up': self._replica_up,
                'fleet.gossip_stale': self._gossip_stale,
                'fleet.breaker_trips': self._breaker_trips,
                'fleet.readmissions': self._readmissions,
                'fleet.slo_breaches': self._slo_breaches,
            }
            gauges = {
                'fleet.n_replicas': float(len(self._replicas)),
                'fleet.n_routable': float(sum(
                    1 for r in self._replicas.values()
                    if r.routable())),
                'fleet.parked': float(len(self._pending)),
            }
            beats = {rid: (now - rep.last_beat) * 1e3
                     for rid, rep in sorted(self._replicas.items())}
            offsets = {rid: est.offset * 1e3
                       for rid, est in sorted(self._clock.items())
                       if est.n}
            hists = {h.name: h.state()
                     for h in self._stage_h.values()}
            hists[self._latency_h.name] = self._latency_h.state()
        lines = prometheus_snapshot_lines(
            {'counters': counters, 'gauges': gauges,
             'histograms': hists})
        lines.append('# TYPE fleet_heartbeat_age_ms gauge')
        for rid, age in beats.items():
            lines.append(
                'fleet_heartbeat_age_ms'
                f'{_format_labels({"replica": rid})} {round(age, 3)}')
        if offsets:
            lines.append('# TYPE fleet_clock_offset_ms gauge')
            for rid, off in offsets.items():
                lines.append(
                    'fleet_clock_offset_ms'
                    f'{_format_labels({"replica": rid})} '
                    f'{round(off, 3)}')
        return lines

    def merged_flight(self, pull: bool = True,
                      timeout_s: float = 2.0) -> dict:
        """The federated incident timeline: the router's own ring plus
        every replica's (live-pulled when reachable, else the last
        gossiped digest), each event time-aligned onto the router's
        clock via the gossip-RTT offset and merged into one ordered
        stream.  Events carry ``origin`` (``router`` or the replica
        id) and ``t_router`` (aligned monotonic seconds)."""
        if pull:
            for rid in self.replica_ids():
                try:
                    resp = self.call_replica(rid, 'flight',
                                             timeout_s=timeout_s)
                    self._on_flight_pull(rid, True, resp)
                except Exception:       # noqa: BLE001 - cache stands
                    continue
        with self._lock:
            cache = {rid: dict(c)
                     for rid, c in self._flight_cache.items()}
            offsets = {rid: est.offset
                       for rid, est in self._clock.items() if est.n}
        merged = []
        for ev in self.flight_recorder.events():
            e = dict(ev)
            e['origin'] = 'router'
            e['t_router'] = ev.get('mono')
            merged.append(e)
        for rid, c in sorted(cache.items()):
            off = offsets.get(rid)
            for ev in c['events']:
                e = dict(ev)
                e['origin'] = rid
                m = ev.get('mono')
                e['t_router'] = None if m is None \
                    else (m - off if off is not None else m)
                merged.append(e)
        merged.sort(key=lambda e: (e['t_router'] is None,
                                   e['t_router'] or 0.0))
        return {
            'router': {'recorded': self.flight_recorder.recorded,
                       'dropped': self.flight_recorder.dropped,
                       'counts': self.flight_recorder.counts()},
            'replicas': {rid: {k: c.get(k) for k in
                               ('source', 'recorded', 'dropped',
                                'counts')}
                         for rid, c in sorted(cache.items())},
            'clock_offsets': self.clock_offsets(),
            'events': merged,
        }

    # -- retry pump ------------------------------------------------------

    def _retry_loop(self) -> None:
        while True:
            with self._cv:
                if self._closing:
                    return
                now = time.monotonic()
                if not self._pending:
                    self._cv.wait(0.1)
                    continue
                eligible_t, _seq, freq = self._pending[0]
                if eligible_t > now:
                    self._cv.wait(min(eligible_t - now, 0.1))
                    continue
                heapq.heappop(self._pending)
            self._dispatch(freq)

    # -- introspection / shutdown ---------------------------------------

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            replicas = {
                rid: {
                    'alive': rep.alive,
                    'quarantined': rep.quarantined,
                    'routable': rep.routable(),
                    'heartbeat_age_ms': (now - rep.last_beat) * 1e3,
                    'inflight': len(rep.inflight),
                    'breaker': rep.breaker.snapshot(),
                    'digest': dict(rep.digest),
                } for rid, rep in sorted(self._replicas.items())}
            snap = {
                'replicas': replicas,
                'n_replicas': len(self._replicas),
                'n_routable': sum(1 for r in self._replicas.values()
                                  if r.routable()),
                'submitted': self._submitted,
                'completed': self._completed,
                'failed': self._failed,
                'parked': len(self._pending),
                'retries': self._retries,
                'retry_exhausted': self._retry_exhausted,
                'failovers': self._failovers,
                'replica_down': self._replica_down,
                'replica_up': self._replica_up,
                'gossip_stale': self._gossip_stale,
                'breaker_trips': self._breaker_trips,
                'readmissions': self._readmissions,
                'home_buckets': len(self._home),
                'streaming': {
                    'open_sessions': len(self._stream_sessions),
                    'rounds_submitted': self._stream_rounds,
                },
                'slo_breaches': self._slo_breaches,
                'slo': {stage: dict(ev)
                        for stage, ev in sorted(self._slo_last.items())},
            }
        lat = np.asarray(self._latency_h.values(), np.float64)
        if lat.size:
            snap['latency_p50_ms'] = float(np.percentile(lat, 50))
            snap['latency_p99_ms'] = float(np.percentile(lat, 99))
        else:
            snap['latency_p50_ms'] = snap['latency_p99_ms'] = 0.0
        snap['latency_samples'] = int(lat.size)
        reg = profiling.registry()
        reg.set_gauge(f'fleet.{self.name}.n_routable',
                      snap['n_routable'])
        reg.set_gauge(f'fleet.{self.name}.parked', snap['parked'])
        return snap

    def shutdown(self) -> None:
        """Stop routing: fail every parked and in-flight request with
        :class:`ShutdownError`, close every client, join the gossip and
        retry threads.  Idempotent."""
        with self._cv:
            already = self._closing
            self._closing = True
            self._cv.notify_all()
        self._join_threads()
        if already:
            return
        with self._lock:
            doomed = [f for _, _, f in self._pending]
            self._pending.clear()
            for rep in self._replicas.values():
                doomed.extend(f for f, _tok in rep.inflight.values())
                rep.inflight.clear()
            clients = [rep.client for rep in self._replicas.values()
                       if rep.client is not None]
        err = ShutdownError(f'fleet router {self.name!r} shut down')
        with self._lock:
            for freq in doomed:
                self._fail_locked(freq, err)
        for client in clients:
            client.close()

    def _join_threads(self) -> None:
        for t in (self._gossip_thread, self._retry_thread):
            if t is not threading.current_thread():
                t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown()
