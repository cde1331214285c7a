"""The continuous-batching execution service.

:class:`ExecutionService` is the in-process serving runtime over the
interpreter: any thread calls :meth:`~ExecutionService.submit` with one
compiled :class:`~..decoder.MachineProgram` and gets a
:class:`~.request.RequestHandle` back immediately; dispatcher threads
drain the queues, coalesce compatible requests into shape-bucketed
batches (``batcher.bucket_key``), run each batch through
:func:`~..sim.interpreter.simulate_multi_batch` — one generic-engine
call over ``P x B`` lanes — copy the result to the host and demux
per-request stats back onto the handles.  The classic continuous-batching contract (vLLM-style,
transplanted from token generation to shot execution):

* latency/throughput dial: a bucket dispatches when it reaches
  ``max_batch_programs`` or its oldest member has waited
  ``max_wait_ms``;
* admission control: a bounded queue (``max_queue``) makes overload a
  synchronous :class:`QueueFullError` at submit, not unbounded growth;
* isolation: ``fault_mode='strict'`` raises
  :class:`~..sim.interpreter.FaultError` on the OFFENDING request's
  handle only — batch-mates are fulfilled normally (per-request fault
  slices are checked after demux, never batch-wide);
* cancellation/deadlines honored at batch boundaries — the claim into
  a batch is the point of no return;
* graceful ``shutdown(drain=True)`` flushes everything queued, then
  joins every dispatcher.

Multi-device sharding (``devices=``): the service runs a POOL of
per-device executors, each owning its own coalescer queue, its own
dispatcher thread and, on CUDA, its own stream, so executors that share
a card do not serialise on one stream.  A bucket-affinity router pins
each ``bucket_key`` to a home device (least-loaded at first sight,
sticky after) so a bucket's first-dispatch cost (allocator growth, first
launches) is paid once per device.  Work stealing migrates a ripened
batch to an idle device when the home is busy or backed up (counted in
``stats()`` as a cold hit and a steal).  The default ``devices=None``
is one executor on ``torch_device(None)``, the card: it raises where
there is no CUDA, and a CPU service names ``devices=['cpu']``.

Bit-identity guarantee (tests/test_serve.py, test_serve_multidevice.py):
a demuxed result equals the solo ``simulate_batch`` run of the same
request under the same normalized cfg, per stat including
``fault_shots`` — REGARDLESS of which device ran it.  The multi path is
the generic engine vmapped over programs, each program's step counter
freezes independently; short requests are padded by replicating their
OWN shot rows and (under ``pad_programs``) batches are padded to a
power-of-two program count by replicating the last request — both inert
under deterministic execution, trimmed off in
:func:`~..sim.interpreter.demux_multi_batch`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from .. import isa
from ..decoder import machine_program_from_cmds, stack_machine_programs
from ..integrity import IntegrityError, diff_stats
from ..obs import (HOST_SPANS, FlightRecorder, Histogram, Tracer, host_span,
                   write_chrome_trace)
from ..ops.decode import as_decode_spec
from ..sim.interpreter import (ENGINES, InterpreterConfig, FaultError,
                               aot_batch_cached, aot_compile_batch,
                               demux_multi_batch, fault_shot_counts,
                               is_infrastructure_error, program_traits,
                               resolve_engine, simulate_batch,
                               simulate_multi_batch, simulate_rounds,
                               torch_device)
from ..utils import profiling
from ..utils.results import host_array
from .batcher import Coalescer, bucket_key, shed_exempt
from .bucketspec import BucketSpec
from .catalog import BucketCatalog
from .request import (DEFAULT_TENANT, DeadlineError,
                      ExecutorLostError, OverloadError, QueueFullError,
                      QuotaExceededError, Request, RequestHandle,
                      ServiceClosedError, ShutdownError)
from .stream import StreamKey, StreamSession
from .supervise import (HEALTH_LIVE, HEALTH_PROBING, HEALTH_QUARANTINED,
                        CircuitBreaker, RetryPolicy)

# service threads carry these prefixes so the test harness can detect
# leaked services (tests/conftest.py prints the junit-gated marker —
# tools/check_junit.py — when one survives a test); the supervision
# layer's threads share the 'dproc-serve' stem the conftest probe scans
DISPATCH_THREAD_PREFIX = 'dproc-serve-dispatch'
SUPERVISE_THREAD_PREFIX = 'dproc-serve-supervise'
CANARY_THREAD_PREFIX = 'dproc-serve-canary'
COMPILE_THREAD_PREFIX = 'dproc-serve-compile'
WARMUP_THREAD_PREFIX = 'dproc-serve-warmup'
SCRUB_THREAD_PREFIX = 'dproc-serve-scrub'

_SERVICE_SEQ = itertools.count()


def _normalize_cfg(cfg: InterpreterConfig, n_instr_bucket: int):
    """One request cfg -> (bucket-keyed dispatch cfg, strict flag).

    Budgets default from the BUCKET shape exactly like
    ``simulate_multi_batch`` derives them (content-derived budgets
    would fragment the buckets and retrace per ensemble); the engine
    selector is normalized away (multi path is generic-only) and
    'strict' is split out as the per-request host policy.
    """
    if cfg is None:
        cfg = InterpreterConfig(max_steps=2 * n_instr_bucket + 64,
                                max_pulses=n_instr_bucket + 2)
    if cfg.straightline or cfg.engine in ('straightline', 'block',
                                          'pallas', 'fused'):
        raise ValueError(
            'the execution service coalesces onto the multi-program '
            'generic engine; of the engine ladder (auto / generic / '
            'block / straightline / pallas / fused) the straightline, '
            'block, pallas and fused engines key on program content '
            'and cannot serve a shared batch (use singleton_engine= '
            'for 1-program fallback dispatch)')
    if cfg.opcode_histogram:
        raise ValueError(
            'opcode_histogram=True cannot be served: op_hist is summed '
            'over shot lanes inside the jit, so the shot-replication '
            'padding used to coalesce unequal shot counts would '
            'contaminate it (run simulate_batch directly instead)')
    if cfg.cores_axis is not None:
        raise ValueError(
            f'cores_axis={cfg.cores_axis!r} (sharded-cores execution) '
            'cannot serve: the service dispatches single-device '
            'simulate_batch batches and the cores-sharded fabric rides '
            'shard_map collectives over a live device mesh — it only '
            'runs via parallel.sweep.sharded_cores_simulate / '
            'parallel.run_cores_sweep')
    strict = cfg.fault_mode == 'strict'
    if cfg.fault_mode not in ('count', 'strict'):
        raise ValueError(
            f"fault_mode must be 'count' or 'strict'; got "
            f"{cfg.fault_mode!r}")
    if strict or cfg.straightline is None or cfg.engine is not None:
        cfg = replace(cfg, fault_mode='count', straightline=False,
                      engine=None)
    return cfg, strict


def _normalize_stream_cfg(cfg: InterpreterConfig, n_instr_bucket: int):
    """One stream-chunk cfg -> (dispatch cfg, strict flag).

    Streaming chunks never coalesce across programs — each dispatch is
    one session's ``simulate_rounds`` scan — so unlike
    :func:`_normalize_cfg` the engine selector SURVIVES (a stream may
    ride the content-keyed block/pallas rungs; only the physics-closed
    'fused' engine is rejected, exactly as every injected-bits entry
    rejects it).  ``rounds`` is normalized to 1 here — the ROUTING key
    must not fragment per chunk length; each chunk's dispatch cfg
    rebinds ``rounds`` to its own round count.  ``record_pulses`` is
    forced off: an R-round pulse record is R times the largest leaf in
    the result frame, which defeats incremental streaming (run
    ``simulate_rounds`` directly for record-level debugging)."""
    if cfg is None:
        cfg = InterpreterConfig(max_steps=2 * n_instr_bucket + 64,
                                max_pulses=n_instr_bucket + 2)
    if cfg.engine == 'fused':
        raise ValueError(
            "engine='fused' demodulates measurement windows in-kernel; "
            'streaming sessions dispatch injected-bits rounds scans — '
            'physics-closed execution only runs via '
            'sim.physics.run_physics_batch')
    if cfg.opcode_histogram:
        raise ValueError(
            'opcode_histogram=True cannot stream: op_hist is summed '
            'over shot lanes inside the jit (run simulate_rounds '
            'directly instead)')
    if cfg.cores_axis is not None:
        raise ValueError(
            f'cores_axis={cfg.cores_axis!r} (sharded-cores execution) '
            'cannot serve: the service dispatches single-device '
            'scans — mesh-wide rounds run via '
            'parallel.sweep.sharded_cores_rounds')
    strict = cfg.fault_mode == 'strict'
    if cfg.fault_mode not in ('count', 'strict'):
        raise ValueError(
            f"fault_mode must be 'count' or 'strict'; got "
            f"{cfg.fault_mode!r}")
    if strict or cfg.record_pulses or cfg.rounds != 1:
        cfg = replace(cfg, fault_mode='count', record_pulses=False,
                      rounds=1)
    return cfg, strict


def _pad_shots(arr: np.ndarray, n_shots: int) -> np.ndarray:
    """Pad the leading shot axis up to ``n_shots`` by replicating the
    last row — the inert-lane padding ``demux_multi_batch`` trims."""
    if arr.shape[0] == n_shots:
        return arr
    reps = np.repeat(arr[-1:], n_shots - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _to_host(out: dict) -> dict:
    """A dispatch's result as host numpy arrays.  The copy waits for the
    dispatch's kernels, so it belongs inside the timed dispatch window
    that the EWMA, the hang watchdog and ``stats()`` read."""
    return {k: host_array(v) for k, v in out.items()}


class _TokenBucket:
    """Per-tenant admission rate limiter (docs/SERVING.md "Tenants").

    The bucket starts FULL at ``capacity`` (one burst's worth) and
    refills continuously at ``rate`` tokens/s; ``try_take`` is called
    under the service's lock, so no locking of its own."""

    __slots__ = ('rate', 'capacity', 'tokens', 't')

    def __init__(self, rate: float, capacity: float = None):
        self.rate = float(rate)
        self.capacity = float(capacity) if capacity is not None \
            else max(self.rate, 1.0)
        self.tokens = self.capacity
        self.t = time.monotonic()

    def try_take(self, n: float, now: float = None) -> bool:
        if now is None:
            now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


def _tenant_zero() -> dict:
    """One tenant's fresh accounting block — the exact key set the
    frozen manifest in tests/test_obs.py pins (plus 'weight', merged
    in by stats())."""
    return {'queued': 0, 'submitted': 0, 'completed': 0, 'failed': 0,
            'shed': 0, 'quota_rejected': 0, 'shots': 0,
            'device_ms': 0.0, 'compile_ms': 0.0, 'bytes_wire': 0}


def _bucket_label(key: BucketSpec) -> str:
    """Human/JSON-able label for a bucket key: the shape part only
    (cores x instruction bucket).  Distinct cfg/geometry variants of
    the same shape share a label — the per-bucket compile stats answer
    "which SHAPES are hot", not "which exact executables"."""
    return f'c{key.n_cores}i{key.n_instr_bucket}'


def _bucket_compile_view(per: dict) -> dict:
    """One bucket's cold/warm classification with its dispatch latency
    split: mean timed cold/warm dispatch ms, and their difference as a
    per-bucket compile-cost estimate (a cold dispatch is
    trace+compile+execute, a warm one execute only — the difference is
    what AOT warmup deletes from first-request latency).  The means are
    None until a timed dispatch of that class lands (AOT warmups
    classify cold but dispatch nothing)."""
    cold_ms = (per['cold_s'] * 1e3 / per['cold_timed']
               if per['cold_timed'] else None)
    warm_ms = (per['warm_s'] * 1e3 / per['warm_timed']
               if per['warm_timed'] else None)
    est = (max(cold_ms - warm_ms, 0.0)
           if cold_ms is not None and warm_ms is not None else None)
    return {'cold': per['cold'], 'warm': per['warm'],
            'cold_ms_mean': cold_ms, 'warm_ms_mean': warm_ms,
            'compile_ms_est': est}


class _DeviceExecutor:
    """One device's slice of the service: its own coalescer queue, its
    own dispatcher thread, its own CUDA stream, and its own counters.
    All mutable state is guarded by the service's condition variable;
    the executor is a struct, the service owns the concurrency."""

    def __init__(self, svc: 'ExecutionService', idx: int, device,
                 max_batch_programs: int, max_wait_s: float,
                 breaker: CircuitBreaker, tenant_weights: dict = None):
        self.idx = idx
        self.device = device
        # its own CUDA stream: executors that share a card overlap
        # instead of serialising on the legacy default stream; every
        # tensor of a dispatch is made, used and freed on it
        self.stream = torch.cuda.Stream(device) \
            if device.type == 'cuda' else None
        self.q = Coalescer(max_batch_programs, max_wait_s,
                           tenant_weights=tenant_weights)
        self.busy = False            # a batch is executing right now
        # -- supervision state (all under the service's cv) --------------
        self.health = HEALTH_LIVE
        self.breaker = breaker
        # (key, batch) currently executing: the supervisor's handle on
        # work to recover when the dispatch hangs or the thread dies
        self.inflight = None
        # wall-clock watchdog: absolute monotonic instant after which
        # the current dispatch counts as hung (None = no dispatch
        # running, or the watchdog is disabled)
        self.dispatch_deadline = None
        self.last_beat = time.monotonic()
        self.hangs = 0
        self.deaths = 0
        self.respawns = 0
        self.canary_ok = 0
        self.canary_fail = 0
        self.canary_thread = None
        # integrity fabric (docs/ROBUSTNESS.md "Integrity"): the last
        # audit's verdict (edge-triggers the integrity_violation
        # flight event) and the scrubber's consecutive-failure count
        self.integrity_bad = False
        self.scrub_fails = 0
        self.dispatches = 0
        self.programs_dispatched = 0
        self.occupancy = collections.Counter()          # batch size -> n
        self.engine_dispatches = collections.Counter()  # engine -> n
        self.steals = 0              # batches this executor stole
        self.stolen_from = 0         # batches stolen FROM this executor
        self.cold_compiles = 0
        self.warm_hits = 0
        # (bucket_key, shape signature) dispatched at least once on
        # this device: the host-side cold/warm classifier (a first
        # dispatch of a shape grows the allocator and makes the first
        # launches; the JAX package compiles an executable there)
        self.seen = set()
        self.spawn_thread(svc)

    def spawn_thread(self, svc: 'ExecutionService') -> None:
        """(Re)create the dispatcher thread — __init__, and the
        supervisor's dead-thread respawn path (a fresh Thread object:
        a died Thread cannot be restarted)."""
        self.thread = threading.Thread(
            target=svc._dispatch_loop, args=(self,),
            name=f'{DISPATCH_THREAD_PREFIX}-{svc.name}-d{self.idx}',
            daemon=True)

    def label(self) -> str:
        return str(self.device)

    def context(self):
        """Enter this executor's device and stream (a no-op on the
        CPU): every run on its behalf, from any thread, launches there."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


class ExecutionService:
    """In-process continuous-batching front end over the interpreter.

    Parameters
    ----------
    cfg:
        Default :class:`InterpreterConfig` for submissions that do not
        bring their own.  ``None`` (default) derives per-bucket budgets
        the same way ``simulate_multi_batch`` does.
    max_batch_programs:
        Coalescing ceiling — a bucket dispatches as soon as it holds
        this many requests.
    max_wait_ms:
        Coalescing deadline — a bucket with fewer requests dispatches
        once its oldest member has waited this long.  The
        latency/throughput dial: 0 approximates per-request dispatch,
        large values maximize occupancy.
    max_queue:
        Admission bound on TOTAL queued requests across buckets and
        devices; ``submit`` raises :class:`QueueFullError` beyond it.
    singleton_engine:
        Optional engine selector ('auto' / 'straightline' / 'block' /
        'pallas' / 'generic') for batches that end up with a single
        program: those gain nothing from the multi path, so they may
        ride :func:`simulate_batch` and the full engine ladder instead.
        Feedback programs (LUT-fabric fproc reads) dispatch on the
        fast rungs too — the timestamped fabric made their reads
        dispatch-granularity-invariant, so block/pallas serve them
        bit-identically (docs/PERF.md "Feedback on the fast
        engines"); tests/test_fproc_fast.py pins the dispatch.
        ('fused' is rejected at construction: the service dispatches
        injected-bits batches, and the fused measure-in-megastep engine
        only runs physics-closed.)
        Default None keeps everything on the one shared multi-program
        cache (the right call for compile-bound fleets).
    devices:
        How many executors the service shards across.  ``None``
        (default): ONE executor on ``torch_device(None)``, the card —
        it raises where there is no CUDA.  An int n / ``'all'``: one
        executor on each of the first n / all local CUDA devices
        (:func:`~..parallel.mesh.serving_devices`).  Or an explicit
        sequence of torch devices (``['cpu']`` on a host without a
        card; a device may repeat, one executor each).
    work_stealing:
        Allow an idle executor to migrate a ripened batch away from a
        busy or backed-up home device (a cold first dispatch on the
        thief, counted in stats).  Default True; meaningless with one
        executor.
    pad_programs:
        Pad each multi-program batch to a power-of-two program count by
        replicating the last request (inert, trimmed at demux) so
        odd-sized remainders and stolen batches reuse the pow2-shaped
        executables instead of compiling one per batch size.  Default
        True.
    supervision:
        Run the supervisor thread: per-executor heartbeats, hang
        watchdog, dead-dispatcher detection + respawn, circuit-breaker
        quarantine with canary-probed re-admission (docs/ROBUSTNESS.md
        "serving-layer failures").  Default True.  With it off,
        infrastructure failures are still retried under
        ``retry_policy`` but a broken executor is never quarantined
        and a dead dispatcher is only cleaned up at shutdown.
    retry_policy:
        :class:`~.supervise.RetryPolicy` bounding how often an
        INFRASTRUCTURE failure (executor crash / hang / death — never
        :class:`FaultError`, validation or deadline errors) is retried
        on a healthy executor, with exponential backoff.  None
        (default) uses ``RetryPolicy()``; ``RetryPolicy(max_attempts=
        1)`` disables retrying.
    hang_timeout_s:
        Wall-clock watchdog on every device dispatch: one exceeding
        this is declared hung, its executor quarantined, its requests
        retried elsewhere (the straggler's eventual completion is
        discarded by the attempt token).  Default None = off — a first
        use of a kernel runs ``nvcc`` (seconds) inside its dispatch, so
        only enable this on warmed-up services with a known
        service-time envelope.
    breaker_threshold / breaker_cooldown_ms:
        Circuit breaker: this many CONSECUTIVE infrastructure failures
        quarantine the executor; after the cooldown (doubling per
        re-trip, capped) a canary probe decides re-admission.
    max_est_wait_ms:
        Overload control: when the estimated queue service time (EWMA
        per-program batch time x queued programs / live executors)
        exceeds this bound, ``submit`` sheds the lowest-priority
        queued request (failing it with :class:`OverloadError`) to
        admit a higher-priority one, or rejects the submission
        outright; a request whose own ``deadline_ms`` provably cannot
        be met is rejected early instead of queueing to expire.
        Default None = off (the bounded queue / QueueFullError is
        then the only admission control, exactly as before).
    tenants:
        Per-tenant policy (docs/SERVING.md "Tenants"): a JSON-able
        dict ``{name: {'weight': 1.0, 'max_queued': None,
        'shots_per_s': None, 'shots_burst': None, 'compiles_per_s':
        None, 'compiles_burst': None}}``.  ``weight`` biases the
        deficit-round-robin fair queue; the quota/rate keys arm
        admission-time limits that raise the typed, non-retryable
        :class:`QuotaExceededError` (distinct from
        :class:`OverloadError`: "your contract forbids this", not
        "back off and retry").  Tenants not listed get weight 1.0 and
        no quotas — but ARE still metered.  Default None = no
        configured tenants; everything lands on the 'default' tenant.
    tenant_fair:
        Deficit-round-robin fair queueing across tenants in every
        coalescer (claim order interleaves tenants by weight instead
        of strict global FIFO; within a tenant, (priority, arrival)
        order is unchanged).  Default True; a single-tenant queue
        behaves identically either way.  Off restores the legacy
        global order — the ``tenant_isolation`` bench's baseline.

    ``warmup_catalog`` names a learned bucket catalog file
    (serve/catalog.py): every bucket this service dispatches is
    recorded there, and at construction any previously-recorded specs
    are replayed — AOT-compiled per device on a background
    ``dproc-serve-warmup-*`` thread (admission never blocks on it) —
    so a restarted service's first requests hit warm.  Progress is in
    ``stats()['warmup']``.  Default None = no catalog (explicit
    :meth:`warmup` calls still work).  Each construction opens a new
    catalog generation: specs not re-observed within
    ``catalog_max_age_runs`` generations are pruned, and the catalog
    is capped at ``catalog_max_specs`` entries (least-recently-seen
    evicted first) — a retired workload's buckets stop being
    recompiled at every startup.

    Observability (docs/OBSERVABILITY.md): ``trace_sample`` is the
    fraction of submissions that carry a per-request trace context
    recording typed lifecycle spans (queued / compile / coalesce-ripen
    / dispatch / execute / demux plus retry/steal/migration/park hops)
    readable via ``handle.trace()`` and exportable as Chrome Trace
    Event JSON via :meth:`dump_trace`.  Default 0.0 = off — the only
    per-request cost is the ``None`` context slot every handle already
    carries.  ``trace_keep`` bounds how many sampled traces are
    retained for export.  Every service also owns a
    :class:`~..obs.FlightRecorder` (``flight_events`` ring slots) that
    supervision, overload control, the chaos harness, and the compile
    cache record structured events into; it is dumped automatically on
    supervisor-detected executor deaths/hangs when ``flight_dump_dir``
    (or ``$DPROC_FLIGHT_DIR``) is set, and on demand via
    :meth:`dump_flight`.

    **Integrity fabric** (docs/ROBUSTNESS.md "Integrity"; all off by
    default, zero-cost on the hot path).  ``audit_sample=1/N``
    re-executes every Nth completed batch on a different engine (and
    different device when the pool has one) before delivery and
    bit-compares per stat, fault words included — a confirmed mismatch
    records an edge-triggered ``integrity_violation`` flight event and,
    under ``audit_mode='strict'``, fails the batch with a typed
    :class:`~..integrity.IntegrityError` (infrastructure-class: it
    retries, feeds the breaker, and never surfaces tainted bits).
    ``scrub_interval_s`` starts a background scrubber that replays the
    golden canary program per idle executor and routes
    ``breaker_threshold`` consecutive mismatches into the standard
    quarantine -> canary re-admission lifecycle.
    """

    def __init__(self, cfg: InterpreterConfig = None, *,
                 max_batch_programs: int = 16, max_wait_ms: float = 2.0,
                 max_queue: int = 256, singleton_engine: str = None,
                 name: str = None, devices=None,
                 work_stealing: bool = True, pad_programs: bool = True,
                 supervision: bool = True,
                 retry_policy: RetryPolicy = None,
                 hang_timeout_s: float = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_ms: float = 250.0,
                 supervise_interval_ms: float = 25.0,
                 max_est_wait_ms: float = None,
                 compile_cache=None, compile_workers: int = 2,
                 compile_cache_dir: str = None,
                 warmup_catalog: str = None,
                 catalog_max_specs: int = 512,
                 catalog_max_age_runs: int = 32,
                 trace_sample: float = 0.0, trace_keep: int = 1024,
                 flight_events: int = 512,
                 flight_dump_dir: str = None,
                 audit_sample: float = 0.0,
                 audit_mode: str = 'flag',
                 scrub_interval_s: float = None,
                 session_ttl_s: float = None,
                 tenants: dict = None,
                 tenant_fair: bool = True):
        if max_batch_programs < 1:
            raise ValueError('max_batch_programs must be >= 1')
        if max_queue < 1:
            raise ValueError('max_queue must be >= 1')
        if singleton_engine is not None and singleton_engine not in ENGINES:
            raise ValueError(
                f'singleton_engine must be one of {ENGINES} or None; '
                f'got {singleton_engine!r}')
        if singleton_engine == 'fused':
            raise ValueError(
                "singleton_engine='fused' (measure-in-megastep) cannot "
                'serve: the service dispatches injected-bits '
                'simulate_batch batches and the fused engine '
                'demodulates readout windows in-kernel — it only runs '
                'physics-closed via sim.physics.run_physics_batch')
        if cfg is not None and cfg.cores_axis is not None:
            raise ValueError(
                f'cores_axis={cfg.cores_axis!r} (sharded-cores '
                'execution) cannot serve: the service dispatches '
                'single-device simulate_batch batches and the '
                'cores-sharded fabric rides shard_map collectives over '
                'a live device mesh — it only runs via '
                'parallel.sweep.sharded_cores_simulate / '
                'parallel.run_cores_sweep')
        self._default_cfg = cfg
        self.max_batch_programs = max_batch_programs
        self.max_queue = max_queue
        self.singleton_engine = singleton_engine
        self.pad_programs = pad_programs
        self.name = name or f'svc{next(_SERVICE_SEQ)}'
        if devices is None:
            dev_list = [None]
        elif isinstance(devices, bool):
            raise ValueError('devices must be None, an int, "all", or '
                             'a sequence of torch devices')
        elif isinstance(devices, int):
            from ..parallel.mesh import serving_devices
            dev_list = serving_devices(devices)
        elif devices == 'all':
            from ..parallel.mesh import serving_devices
            dev_list = serving_devices()
        else:
            dev_list = list(devices)
            if not dev_list:
                raise ValueError('devices sequence must be non-empty')
        # every executor on a torch device: CUDA where there is none
        # raises here, before any thread starts
        dev_list = [torch_device(d) for d in dev_list]
        if hang_timeout_s is not None and hang_timeout_s <= 0:
            raise ValueError('hang_timeout_s must be positive or None')
        if max_est_wait_ms is not None and max_est_wait_ms <= 0:
            raise ValueError('max_est_wait_ms must be positive or None')
        if trace_sample < 0 or trace_sample > 1:
            raise ValueError('trace_sample must be in [0, 1]')
        if audit_sample < 0 or audit_sample > 1:
            raise ValueError('audit_sample must be in [0, 1]')
        if audit_mode not in ('flag', 'strict'):
            raise ValueError("audit_mode must be 'flag' or 'strict'; "
                             f'got {audit_mode!r}')
        if scrub_interval_s is not None and scrub_interval_s <= 0:
            raise ValueError('scrub_interval_s must be positive or '
                             'None')
        if session_ttl_s is not None and session_ttl_s <= 0:
            raise ValueError('session_ttl_s must be positive or None')
        # observability: per-request tracing (sampled) + flight
        # recorder — created before the executors so the first
        # dispatch can already emit into them
        self._tracer = Tracer(trace_sample, keep=trace_keep)
        self.flight_recorder = FlightRecorder(flight_events)
        self._flight_dump_dir = flight_dump_dir
        # submit→done latency in ms: per-service exact-percentile
        # window (stats() p50/p99, byte-compatible with the old
        # deque), mirrored into the process registry's fleet-wide
        # 'serve.latency_ms' histogram for Prometheus exposition
        self._latency_h = Histogram('serve.latency_ms', window=4096)
        self._supervision = bool(supervision)
        self._retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self._hang_timeout_s = hang_timeout_s
        self._supervise_interval_s = supervise_interval_ms / 1e3
        self._max_est_wait_s = None if max_est_wait_ms is None \
            else max_est_wait_ms / 1e3
        self._cv = threading.Condition()
        # -- tenant isolation fabric (docs/SERVING.md "Tenants") ---------
        # policy is parsed before the executors exist so every
        # coalescer shares ONE live weights dict (service-owned, read
        # under the cv like everything else)
        self._tenant_cfg = {}
        self._tenant_weights = {}
        for tname, spec in (tenants or {}).items():
            spec = dict(spec or {})
            w = float(spec.get('weight', 1.0))
            if w <= 0:
                raise ValueError(
                    f'tenant {tname!r}: weight must be > 0; got {w!r}')
            for k in ('max_queued', 'shots_per_s', 'compiles_per_s'):
                v = spec.get(k)
                if v is not None and v <= 0:
                    raise ValueError(
                        f'tenant {tname!r}: {k} must be positive or '
                        f'None; got {v!r}')
            self._tenant_cfg[str(tname)] = spec
            self._tenant_weights[str(tname)] = w
        self._tenant_fair = bool(tenant_fair)
        # name -> accounting block (_tenant_zero) — configured tenants
        # eagerly so stats()/fleet-status show them before first
        # traffic, everyone else lazily at first sight
        self._tenant_state = {t: _tenant_zero()
                              for t in self._tenant_cfg}
        self._tenant_shots_tb = {
            t: _TokenBucket(s['shots_per_s'], s.get('shots_burst'))
            for t, s in self._tenant_cfg.items()
            if s.get('shots_per_s') is not None}
        self._tenant_compile_tb = {
            t: _TokenBucket(s['compiles_per_s'],
                            s.get('compiles_burst'))
            for t, s in self._tenant_cfg.items()
            if s.get('compiles_per_s') is not None}
        self._executors = [
            _DeviceExecutor(self, i, d, max_batch_programs,
                            max_wait_ms / 1e3,
                            CircuitBreaker(breaker_threshold,
                                           breaker_cooldown_ms / 1e3),
                            tenant_weights=(self._tenant_weights
                                            if self._tenant_fair
                                            else None))
            for i, d in enumerate(dev_list)]
        self._stealing = bool(work_stealing) and len(self._executors) > 1
        self._home = {}                        # bucket_key -> executor idx
        self._home_counts = collections.Counter()
        self._seq = itertools.count()
        self._closing = False
        self._drain = True
        # stats (guarded by _cv's lock)
        self._submitted = 0
        self._completed = 0
        self._failed = 0          # FaultError / batch execution errors
        self._cancelled = 0
        self._expired = 0
        self._rejected = 0        # QueueFullError at admission
        self._dispatches = 0
        self._programs_dispatched = 0
        self._steals = 0
        self._warmups = 0
        # AOT warmup / learned-catalog state (docs/SERVING.md "cold
        # start & warmup"; guarded by _cv's lock)
        self._warmup_aot = 0           # executables actually compiled
        self._warmup_replayed = 0      # catalog specs replayed
        self._warmup_pending = 0       # (spec, device) replays still due
        self._warmup_thread = None
        self._occupancy = collections.Counter()   # batch size -> count
        self._engine_dispatches = collections.Counter()  # engine -> count
        # bucket label -> {'cold','warm'} counts plus timed dispatch
        # latency totals ({cold,warm}_s / _timed) for the compile-vs-
        # execute split stats() reports
        self._bucket_compiles = {}
        # -- supervision state (guarded by _cv's lock) -------------------
        # requests waiting out a retry backoff: (eligible_t, key, req),
        # pumped back into the queues by dispatchers and the supervisor
        self._parked = []
        self._stop_supervisor = False
        self._retries = 0
        self._retry_exhausted = 0
        self._shed = 0
        self._overload_rejected = 0
        self._breaker_trips = 0
        self._readmissions = 0
        self._executor_deaths = 0
        self._hangs = 0
        self._canary_ok = 0
        self._canary_fail = 0
        # EWMA of per-program batch service time (the overload
        # estimator's numerator); None until the first batch lands
        self._ewma_prog_s = None
        self._canary_mp = None         # lazily-built tiny probe program
        self._canary_ref = None        # first canary result: bit reference
        # -- streaming traffic class (docs/SERVING.md "Streaming
        # sessions"; guarded by _cv's lock).  _sessions maps an open
        # sid -> last-activity instant (the TTL sweep's input);
        # _stream_keys caches each session's sticky routing key;
        # _stream_live holds (handle, rounds) pairs so stats() can
        # count rounds in flight without walking every queue
        self._session_ttl_s = session_ttl_s
        self._stream_seq = itertools.count()
        self._sessions = {}
        self._stream_keys = {}
        self._stream_live = []
        self._stream_rounds_submitted = 0
        self._stream_rounds_served = 0
        self._stream_round_misses = 0
        self._stream_sessions_opened = 0
        self._stream_sessions_expired = 0
        # -- calibration traffic class (docs/SERVING.md "Calibration
        # sessions"; guarded by _cv's lock).  _calib_sessions maps an
        # open sid -> last-activity instant; sids draw from the same
        # sequence as streams so a sid names one session of either kind
        self._calib_sessions = {}
        self._calib_sessions_opened = 0
        self._calib_steps = 0
        self._calib_converged = 0
        self._calib_diverged = 0
        # -- integrity fabric (docs/ROBUSTNESS.md "Integrity") -----------
        # audit_sample=1/N re-executes every Nth completed batch on a
        # different engine (and device when the pool has one) before
        # delivery; the scrubber replays the canary program per
        # executor on an idle cadence.  Both feed the breaker /
        # quarantine machinery; all counters under _cv's lock.
        self._audit_sample = float(audit_sample)
        self._audit_every = 0 if audit_sample <= 0 \
            else max(1, round(1.0 / audit_sample))
        self._audit_mode = audit_mode
        self._audit_tick = 0
        self._audits = 0
        self._audit_mismatches = 0
        self._scrub_interval_s = scrub_interval_s
        self._scrubber_runs = 0
        self._scrubber_fail = 0
        self._integrity_quarantines = 0
        self._breaker_threshold = max(int(breaker_threshold), 1)
        # -- compile front door (guarded by _cv's lock where noted) ------
        if compile_workers < 1:
            raise ValueError('compile_workers must be >= 1')
        self._compile_cache = compile_cache
        if compile_cache is not None:
            # cache invalidations become flight-recorder events
            compile_cache.recorder = self.flight_recorder
        self._compile_cache_dir = compile_cache_dir
        self._compile_workers = compile_workers
        self._compile_pool = None      # lazily created on first submit_source
        self._source_submitted = 0
        self._source_handles = set()   # outer handles awaiting compile
        # learned bucket catalog: record every served bucket; replay
        # it at startup on a background thread so admission never
        # waits on warmup compiles
        self._catalog = None
        self._catalog_seen = set()
        replay_specs = []
        if warmup_catalog:
            self._catalog = BucketCatalog(
                warmup_catalog, max_specs=catalog_max_specs,
                max_age_runs=catalog_max_age_runs)
            # begin_run opens a new generation: aged-out / over-cap
            # specs are pruned before the replay set is taken
            replay_specs = self._catalog.begin_run()
            self._catalog_seen.update(s.identity() for s in replay_specs)
        for ex in self._executors:
            ex.thread.start()
        if replay_specs:
            self._warmup_pending = len(replay_specs) * len(self._executors)
            self._warmup_thread = threading.Thread(
                target=self._warmup_replay, args=(replay_specs,),
                name=f'{WARMUP_THREAD_PREFIX}-{self.name}',
                daemon=True)
            self._warmup_thread.start()
        self._supervisor = None
        if self._supervision:
            self._supervisor = threading.Thread(
                target=self._supervise_loop,
                name=f'{SUPERVISE_THREAD_PREFIX}-{self.name}',
                daemon=True)
            self._supervisor.start()
        self._scrubber = None
        if scrub_interval_s is not None:
            self._scrubber = threading.Thread(
                target=self._scrub_loop,
                name=f'{SCRUB_THREAD_PREFIX}-{self.name}',
                daemon=True)
            self._scrubber.start()

    # -- submission ------------------------------------------------------

    def traced_handle(self, trace_id: int) -> RequestHandle:
        """A fresh handle pre-bound to a forced :class:`TraceContext`:
        the fleet wire carries the ROUTER's sampling decision
        (deterministic on the trace id — docs/OBSERVABILITY.md "Fleet
        observability"), so the replica must trace exactly those
        requests regardless of its own sampling rate.  Pass it via
        ``_handle=`` so the submit path appends onto the same context
        the router will stitch."""
        h = RequestHandle()
        h._trace = self._tracer.start(trace_id)
        return h

    def submit(self, mp, meas_bits=None, *, shots: int = None,
               init_regs=None, cfg: InterpreterConfig = None,
               priority: int = 0, deadline_ms: float = None,
               fault_mode: str = None, tenant: str = None,
               _handle: RequestHandle = None):
        """Queue one program for execution; returns its
        :class:`RequestHandle` immediately.

        ``meas_bits`` is ``[n_shots, n_cores, n_meas]`` (or None with
        ``shots=`` for all-zero measurement feeds); ``init_regs`` is
        None, ``[n_cores, N_REGS]`` (shared across shots) or
        ``[n_shots, n_cores, N_REGS]``.  ``priority`` picks the lane
        (higher dispatches first); ``deadline_ms`` arms a
        relative-to-now deadline enforced at batch boundaries;
        ``fault_mode`` overrides the cfg's ('strict' raises
        :class:`FaultError` on THIS handle only, batch-mates are
        unaffected).  ``tenant`` names the submitting tenant
        (docs/SERVING.md "Tenants": fair queueing, quotas, metering);
        None lands on the 'default' tenant.
        """
        if meas_bits is None:
            if shots is None:
                raise ValueError('provide meas_bits or shots=')
            n_shots = int(shots)
            if n_shots < 1:
                raise ValueError('shots must be >= 1')
        else:
            meas_bits = np.asarray(meas_bits, np.int32)
            if meas_bits.ndim != 3 or meas_bits.shape[1] != mp.n_cores:
                raise ValueError(
                    f'meas_bits must be [n_shots, n_cores='
                    f'{mp.n_cores}, n_meas]; got '
                    f'{tuple(meas_bits.shape)}')
            if shots is not None and shots != meas_bits.shape[0]:
                raise ValueError(
                    f'shots={shots} contradicts meas_bits shot axis '
                    f'{meas_bits.shape[0]}')
            n_shots = meas_bits.shape[0]
            if n_shots < 1:
                raise ValueError('meas_bits must carry >= 1 shot')
        cfg = cfg if cfg is not None else self._default_cfg
        if fault_mode is not None:
            base = cfg if cfg is not None else InterpreterConfig(
                max_steps=2 * isa.shape_bucket(mp.n_instr) + 64,
                max_pulses=isa.shape_bucket(mp.n_instr) + 2)
            cfg = replace(base, fault_mode=fault_mode)
        cfg, strict = _normalize_cfg(cfg, isa.shape_bucket(mp.n_instr))
        if meas_bits is None:
            meas_bits = np.zeros((n_shots, mp.n_cores, cfg.max_meas),
                                 np.int32)
        elif meas_bits.shape[-1] != cfg.max_meas:
            # normalize the measurement width here (same truncate/zero-
            # pad as the interpreter's _pad_meas) so every member of a
            # bucket stacks into one [P, B, C, max_meas] tensor
            if meas_bits.shape[-1] > cfg.max_meas:
                meas_bits = meas_bits[..., :cfg.max_meas]
            else:
                meas_bits = np.pad(meas_bits, [
                    (0, 0), (0, 0),
                    (0, cfg.max_meas - meas_bits.shape[-1])])
        if init_regs is not None:
            init_regs = np.asarray(init_regs, np.int32)
            if init_regs.ndim == 2:
                init_regs = np.broadcast_to(
                    init_regs[None],
                    (n_shots,) + init_regs.shape).copy()
            if init_regs.ndim != 3 or init_regs.shape != (
                    n_shots, mp.n_cores, isa.N_REGS):
                raise ValueError(
                    f'init_regs must be [n_cores, {isa.N_REGS}] or '
                    f'[n_shots={n_shots}, n_cores={mp.n_cores}, '
                    f'{isa.N_REGS}]; got {tuple(init_regs.shape)}')
        deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms / 1e3
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        key = bucket_key(mp, cfg)
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
            if self._depth_locked() >= self.max_queue:
                self._rejected += 1
                profiling.counter_inc('serve.rejected')
                raise QueueFullError(
                    f'queue full ({self.max_queue} requests pending)')
            # tenant quota BEFORE overload control: an over-quota
            # submission must never shed another tenant's queued work
            self._admit_tenant_locked(tenant, shots=n_shots)
            self._admit_overload_locked(priority, deadline)
            # _handle: submit_source hands over the outer handle it
            # already returned to the tenant, so the dispatcher fulfills
            # that handle directly (no compile-pool thread ever blocks
            # on execution)
            hkw = {} if _handle is None else {'handle': _handle}
            req = Request(mp=mp, meas_bits=meas_bits,
                          init_regs=init_regs, cfg=cfg, strict=strict,
                          n_shots=n_shots, priority=priority,
                          deadline=deadline, seq=next(self._seq),
                          tenant=tenant, **hkw)
            self._open_tenant_locked(req)
            # tracing: submit_source already made the sampling call
            # for its outer handle; everything else draws here.  With
            # sampling off maybe_start returns None without allocating
            # — the handle's context slot stays None
            ctx = req.handle._trace if _handle is not None \
                else self._tracer.maybe_start()
            if ctx is not None:
                req.handle._trace = ctx
                ctx.instant('submit', t=req.submit_t, seq=req.seq,
                            bucket=key.label(), priority=priority)
            tgt = self._route_locked(key)
            if tgt is None:
                # every executor is quarantined/probing: park the
                # request; the first re-admission pumps it back in
                self._parked.append((time.monotonic(), key, req))
                if ctx is not None:
                    ctx.instant('park', reason='no-live-executor')
            else:
                tgt.q.push(key, req)
            self._submitted += 1
            profiling.counter_inc('serve.submitted')
            self._cv.notify_all()
        return req.handle

    # -- streaming traffic class (docs/SERVING.md "Streaming sessions") --

    def open_stream(self, mp, *, cfg: InterpreterConfig = None,
                    decode=None, round_deadline_ms: float = None,
                    priority: int = 0, fault_mode: str = None,
                    tenant: str = None) -> StreamSession:
        """Open a long-lived streaming session for ``mp``: returns a
        :class:`~.stream.StreamSession` whose ``submit_rounds`` chunks
        dispatch as device-resident R-round scans
        (:func:`~..sim.interpreter.simulate_rounds`) with ``decode``
        (a :class:`~..ops.decode.DecodeSpec`) run in-loop.  All chunks
        of a session share one sticky routing key, so the session
        lives on a home executor with a warm scan executable;
        ``round_deadline_ms`` arms each chunk with ``rounds x`` that
        budget, honored at scan-chunk boundaries."""
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
            sid = next(self._stream_seq)
            self._sessions[sid] = time.monotonic()
            self._stream_sessions_opened += 1
        profiling.counter_inc('serve.stream.sessions_opened')
        self.flight_recorder.record('stream_open', sid=sid)
        return StreamSession(self, mp, sid, cfg=cfg, decode=decode,
                             round_deadline_ms=round_deadline_ms,
                             priority=priority, fault_mode=fault_mode,
                             tenant=tenant)

    def close_stream(self, sid: int) -> bool:
        """Deregister an open session (idempotent; the TTL sweep and
        the session's own ``close`` both land here).  Outstanding
        chunk handles are unaffected — they are ordinary requests and
        complete or fail on their own lifecycle."""
        with self._cv:
            known = self._sessions.pop(sid, None) is not None
            self._stream_keys.pop(sid, None)
        if known:
            profiling.counter_inc('serve.stream.sessions_closed')
        return known

    # -- calibration traffic class (docs/SERVING.md "Calibration
    # sessions") ---------------------------------------------------------

    def open_calibration(self, *, knob: str = 'amplitude',
                         tenant: str = None, priority: int = 0):
        """Open a calibration session: returns a
        :class:`~..calib.session.CalibrationSession` whose per-step
        candidate programs ride the ordinary ``submit_source`` front
        door under the session's tenant identity.  The service counts
        the session's steps and its terminal transition
        (``stats()['calibration']``, ``serve.calib.*`` counters);
        convergence/divergence land in the flight recorder."""
        from ..calib.session import CalibrationSession
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
            sid = next(self._stream_seq)
            self._calib_sessions[sid] = time.monotonic()
            self._calib_sessions_opened += 1
        profiling.counter_inc('serve.calib.sessions_opened')
        self.flight_recorder.record('calib_open', sid=sid, knob=knob)
        return CalibrationSession(self, sid, knob=knob, tenant=tenant,
                                  priority=priority)

    def close_calibration(self, sid: int) -> bool:
        """Deregister an open calibration session (idempotent).
        Outstanding candidate handles are unaffected — they are
        ordinary requests and complete on their own lifecycle."""
        with self._cv:
            known = self._calib_sessions.pop(sid, None) is not None
        if known:
            profiling.counter_inc('serve.calib.sessions_closed')
        return known

    def calib_event(self, sid: int, kind: str, **info) -> None:
        """Observability sink for a session's loop: ``kind`` is
        ``'step' | 'converged' | 'diverged'``.  Steps advance the
        session's activity instant and the step counters; the terminal
        kinds additionally land in the flight recorder (a diverged
        calibration is an incident-timeline event)."""
        if kind not in ('step', 'converged', 'diverged'):
            raise ValueError(
                f"calib event kind must be 'step', 'converged' or "
                f"'diverged'; got {kind!r}")
        with self._cv:
            if kind == 'step':
                self._calib_steps += 1
            elif kind == 'converged':
                self._calib_converged += 1
            else:
                self._calib_diverged += 1
            if sid in self._calib_sessions:
                self._calib_sessions[sid] = time.monotonic()
        profiling.counter_inc(f'serve.calib.{kind}s' if kind == 'step'
                              else f'serve.calib.{kind}')
        if kind != 'step':
            self.flight_recorder.record(f'calib_{kind}', sid=sid,
                                        **info)

    def submit_rounds(self, mp, meas_bits, *, init_regs=None,
                      cfg: InterpreterConfig = None, decode=None,
                      priority: int = 0, deadline_ms: float = None,
                      round_deadline_ms: float = None,
                      fault_mode: str = None, stream: int = None,
                      tenant: str = None,
                      _handle: RequestHandle = None):
        """Queue one R-round streaming chunk; returns its
        :class:`RequestHandle` immediately.  ``meas_bits`` is
        ``[rounds, n_shots, n_cores, n_meas]``; the dispatcher runs
        the whole chunk as ONE :func:`~..sim.interpreter.
        simulate_rounds` scan (with ``decode`` in-loop), so the result
        is the rounds pytree — leading round axis per leaf.

        ``stream`` binds the chunk to an open session (sticky home
        executor, TTL accounting); None submits a detached one-shot
        chunk under its own fresh sid.  ``round_deadline_ms`` arms a
        ``rounds x round_deadline_ms`` chunk deadline (mutually
        exclusive with ``deadline_ms``); a chunk expiring counts every
        round it carried as a round-deadline miss.  Retry, steal,
        priority and overload semantics are exactly :meth:`submit`'s.
        """
        meas_bits = np.asarray(meas_bits, np.int32)
        if meas_bits.ndim != 4 or meas_bits.shape[2] != mp.n_cores:
            raise ValueError(
                f'meas_bits must be [rounds, n_shots, n_cores='
                f'{mp.n_cores}, n_meas]; got {tuple(meas_bits.shape)}')
        rounds, n_shots = int(meas_bits.shape[0]), int(meas_bits.shape[1])
        if rounds < 1:
            raise ValueError('meas_bits must carry >= 1 round')
        if n_shots < 1:
            raise ValueError('meas_bits must carry >= 1 shot')
        if deadline_ms is not None and round_deadline_ms is not None:
            raise ValueError(
                'pass deadline_ms or round_deadline_ms, not both')
        cfg = cfg if cfg is not None else self._default_cfg
        if fault_mode is not None:
            base = cfg if cfg is not None else InterpreterConfig(
                max_steps=2 * isa.shape_bucket(mp.n_instr) + 64,
                max_pulses=isa.shape_bucket(mp.n_instr) + 2)
            cfg = replace(base, fault_mode=fault_mode)
        cfg, strict = _normalize_stream_cfg(
            cfg, isa.shape_bucket(mp.n_instr))
        if decode is not None:
            decode = as_decode_spec(decode)
            bad = [c for c in decode.cores
                   if not 0 <= c < mp.n_cores]
            if bad:
                raise ValueError(
                    f'decode.cores {bad} out of range for n_cores='
                    f'{mp.n_cores}')
        if meas_bits.shape[-1] != cfg.max_meas:
            if meas_bits.shape[-1] > cfg.max_meas:
                meas_bits = meas_bits[..., :cfg.max_meas]
            else:
                meas_bits = np.pad(meas_bits, [
                    (0, 0), (0, 0), (0, 0),
                    (0, cfg.max_meas - meas_bits.shape[-1])])
        if init_regs is not None:
            init_regs = np.asarray(init_regs, np.int32)
            if init_regs.ndim == 2:
                init_regs = np.broadcast_to(
                    init_regs[None],
                    (n_shots,) + init_regs.shape).copy()
            if init_regs.ndim != 3 or init_regs.shape != (
                    n_shots, mp.n_cores, isa.N_REGS):
                raise ValueError(
                    f'init_regs must be [n_cores, {isa.N_REGS}] or '
                    f'[n_shots={n_shots}, n_cores={mp.n_cores}, '
                    f'{isa.N_REGS}]; got {tuple(init_regs.shape)}')
        if round_deadline_ms is not None:
            deadline_ms = rounds * round_deadline_ms
        deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms / 1e3
        # the chunk's dispatch cfg rebinds rounds; the ROUTING key
        # keeps the rounds=1 normalized cfg so every chunk of the
        # session shares one sticky key regardless of chunk length
        rcfg = replace(cfg, rounds=rounds)
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
            if stream is None:
                sid = next(self._stream_seq)
            else:
                sid = stream
                if sid not in self._sessions:
                    raise ValueError(f'stream {sid} is not open '
                                     f'(expired or closed)')
                self._sessions[sid] = time.monotonic()
            key = self._stream_keys.get(sid)
            if key is None:
                key = StreamKey(sid=sid, n_cores=mp.n_cores,
                                n_instr_bucket=isa.shape_bucket(
                                    mp.n_instr), cfg=cfg)
                self._stream_keys[sid] = key
            if self._depth_locked() >= self.max_queue:
                self._rejected += 1
                profiling.counter_inc('serve.rejected')
                raise QueueFullError(
                    f'queue full ({self.max_queue} requests pending)')
            # shot-rounds are the billed unit of a streaming chunk:
            # an R-round B-shot chunk draws R x B from the bucket
            self._admit_tenant_locked(tenant, shots=rounds * n_shots)
            self._admit_overload_locked(priority, deadline)
            hkw = {} if _handle is None else {'handle': _handle}
            req = Request(mp=mp, meas_bits=meas_bits,
                          init_regs=init_regs, cfg=rcfg, strict=strict,
                          n_shots=n_shots, priority=priority,
                          deadline=deadline, seq=next(self._seq),
                          rounds=rounds, decode=decode, sid=sid,
                          tenant=tenant, **hkw)
            self._open_tenant_locked(req)
            ctx = req.handle._trace if _handle is not None \
                else self._tracer.maybe_start()
            if ctx is not None:
                req.handle._trace = ctx
                ctx.instant('submit', t=req.submit_t, seq=req.seq,
                            bucket=key.label(), priority=priority,
                            rounds=rounds)
            tgt = self._route_locked(key)
            if tgt is None:
                self._parked.append((time.monotonic(), key, req))
                if ctx is not None:
                    ctx.instant('park', reason='no-live-executor')
            else:
                tgt.q.push(key, req)
            self._submitted += 1
            self._stream_rounds_submitted += rounds
            self._stream_live.append((req.handle, rounds))
            profiling.counter_inc('serve.submitted')
            profiling.counter_inc('serve.stream.rounds_submitted',
                                  rounds)
            self._cv.notify_all()
        return req.handle

    def _expire_sessions_locked(self, now: float) -> None:
        """TTL sweep (supervisor tick): an open session idle past
        ``session_ttl_s`` is deregistered — ``session_expired`` flight
        event, ``serve.stream.sessions_expired`` counter — so an
        abandoned producer cannot pin its home-executor affinity
        forever.  Outstanding chunks complete normally; the session
        object's next ``submit_rounds`` is rejected."""
        if self._session_ttl_s is None or not self._sessions:
            return
        dead = [sid for sid, t in self._sessions.items()
                if now - t > self._session_ttl_s]
        for sid in dead:
            del self._sessions[sid]
            self._stream_keys.pop(sid, None)
            self._stream_sessions_expired += 1
            profiling.counter_inc('serve.stream.sessions_expired')
            self.flight_recorder.record(
                'session_expired', sid=sid,
                ttl_s=self._session_ttl_s)

    # -- the compile front door ------------------------------------------

    @property
    def compile_cache(self):
        """The service's :class:`~..compilecache.CompileCache` (created
        on first touch unless one was injected at construction)."""
        with self._cv:
            if self._compile_cache is None:
                from ..compilecache import CompileCache
                self._compile_cache = CompileCache(
                    cache_dir=self._compile_cache_dir)
                self._compile_cache.recorder = self.flight_recorder
            return self._compile_cache

    def submit_source(self, program, qchip, *, shots: int = None,
                      meas_bits=None, init_regs=None,
                      cfg: InterpreterConfig = None, priority: int = 0,
                      deadline_ms: float = None, fault_mode: str = None,
                      n_qubits: int = 8, pad_to: int = None,
                      channel_configs=None, fpga_config=None,
                      compiler_flags=None, tenant: str = None,
                      _handle: RequestHandle = None):
        """Submit PROGRAM SOURCE — a dict-instruction list or OpenQASM 3
        text — instead of a pre-built MachineProgram; returns a
        :class:`RequestHandle` immediately.

        The program compiles-or-hits through the service's content-
        addressed :class:`~..compilecache.CompileCache` on a small
        compile worker pool (``compile_workers``), so compilation never
        blocks the dispatcher threads; the compiled request then flows
        through :meth:`submit` onto the SAME handle.  Results are
        bit-identical to ``compile_to_machine`` + ``submit``
        (tests/test_compilecache.py pins it).  Failures surface typed
        on the handle: :class:`~..decoder.ProgramValidationError` with
        ``(core, instr)`` coordinates for a malformed program,
        :class:`QueueFullError`/:class:`OverloadError` at admission,
        :class:`ShutdownError` when the service closes first.
        ``deadline_ms`` arms at dispatch (compile time is not charged
        against it).
        """
        # _handle: the fleet wire hands over a pre-made handle (and
        # possibly a forced trace context carrying the router's
        # sampling decision); everything else gets a fresh handle and
        # draws the sampling decision here, at the tenant-visible
        # boundary, so the compile span lands on the same context the
        # dispatch spans will
        handle = _handle if _handle is not None else RequestHandle()
        ctx = handle._trace if _handle is not None \
            else self._tracer.maybe_start()
        if ctx is not None:
            handle._trace = ctx
            ctx.instant('submit_source')
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
            # compile-rate gate at the front door, SYNCHRONOUS: an
            # over-rate tenant is told no before a compile worker is
            # ever tied up on its program
            self._admit_tenant_locked(tenant, compile_sub=True)
            if self._compile_pool is None:
                self._compile_pool = ThreadPoolExecutor(
                    max_workers=self._compile_workers,
                    thread_name_prefix=(
                        f'{COMPILE_THREAD_PREFIX}-{self.name}'))
            pool = self._compile_pool
            self._source_submitted += 1
            self._source_handles.add(handle)
        cache = self.compile_cache

        def _compile_and_submit():
            try:
                if handle.cancelled():
                    return
                t_c = time.monotonic()
                mp, _status, _key = cache.get_or_compile(
                    program, qchip, channel_configs=channel_configs,
                    fpga_config=fpga_config,
                    compiler_flags=compiler_flags, n_qubits=n_qubits,
                    pad_to=pad_to)
                t_done = time.monotonic()
                # compile-ms is billed to the submitting tenant even
                # on a cache hit (the hit costs ~0 ms — the meter is
                # wall time spent, not a flat fee)
                self._meter_compile(tenant, (t_done - t_c) * 1e3)
                if handle._trace is not None:
                    handle._trace.span('compile', t_c, t_done,
                                       status=_status)
                self.submit(mp, meas_bits, shots=shots,
                            init_regs=init_regs, cfg=cfg,
                            priority=priority, deadline_ms=deadline_ms,
                            fault_mode=fault_mode, tenant=tenant,
                            _handle=handle)
            except BaseException as e:
                handle._fail(e)
            finally:
                with self._cv:
                    self._source_handles.discard(handle)

        try:
            pool.submit(_compile_and_submit)
        except RuntimeError as e:
            # pool shut down between our check and the enqueue
            with self._cv:
                self._source_handles.discard(handle)
            handle._fail(ServiceClosedError(
                f'service {self.name!r} is shut down'))
            raise ServiceClosedError(
                f'service {self.name!r} is shut down') from e
        profiling.counter_inc('serve.source_submitted')
        return handle

    # -- tenant isolation fabric (docs/SERVING.md "Tenants") -------------

    def _tenant_locked(self, tenant: str) -> dict:
        ts = self._tenant_state.get(tenant)
        if ts is None:
            ts = self._tenant_state[tenant] = _tenant_zero()
        return ts

    def _admit_tenant_locked(self, tenant: str, *, shots: int = 0,
                             compile_sub: bool = False) -> None:
        """Admission-time quota gate: max queued requests, shots/s and
        compile-submissions/s token buckets.  Raises the typed,
        non-retryable :class:`QuotaExceededError`; tenants with no
        configured policy pass through untouched (still metered)."""
        spec = self._tenant_cfg.get(tenant)
        if spec is None:
            return
        ts = self._tenant_locked(tenant)
        mq = spec.get('max_queued')
        if mq is not None and not compile_sub and ts['queued'] >= mq:
            self._reject_quota_locked(
                tenant, ts, f'max_queued={mq} requests already pending')
        if shots:
            tb = self._tenant_shots_tb.get(tenant)
            if tb is not None and not tb.try_take(shots):
                self._reject_quota_locked(
                    tenant, ts,
                    f'shots/s rate limit ({tb.rate:g}/s, burst '
                    f'{tb.capacity:g}) cannot cover {shots} shots')
        if compile_sub:
            ctb = self._tenant_compile_tb.get(tenant)
            if ctb is not None and not ctb.try_take(1):
                self._reject_quota_locked(
                    tenant, ts,
                    f'compile-submissions/s rate limit '
                    f'({ctb.rate:g}/s, burst {ctb.capacity:g}) '
                    f'exhausted')

    def _reject_quota_locked(self, tenant: str, ts: dict,
                             why: str) -> None:
        ts['quota_rejected'] += 1
        profiling.counter_inc(f'tenant.{tenant}.quota_rejected')
        self.flight_recorder.record('quota_reject', tenant=tenant,
                                    reason=why)
        raise QuotaExceededError(
            f'tenant {tenant!r} over quota: {why} — quota rejections '
            f'are not retryable (distinct from OverloadError '
            f'backpressure; see docs/SERVING.md "Tenants")')

    def _open_tenant_locked(self, req: Request) -> None:
        """Open one request's tenant accounting: count the submission
        and install the exactly-once resolution callback that closes
        it (outstanding count down, completed/failed up) on WHATEVER
        path resolves the handle — fulfill, fail, shed, deadline, or
        a submitter-side cancel that never re-enters the service."""
        tenant = req.tenant
        ts = self._tenant_locked(tenant)
        ts['submitted'] += 1
        profiling.counter_inc(f'tenant.{tenant}.submitted')

        def _done(ok: bool, _ts=ts, _t=tenant):
            with self._cv:
                _ts['queued'] -= 1
                _ts['completed' if ok else 'failed'] += 1
            profiling.counter_inc(
                f'tenant.{_t}.completed' if ok
                else f'tenant.{_t}.failed')

        if req.handle._set_on_done(_done):
            ts['queued'] += 1
        # else: the handle resolved before admission finished (e.g. a
        # submit_source handle cancelled mid-compile) — the callback
        # will never fire, so the outstanding count never opened

    def _tenant_pressure_locked(self) -> dict:
        """How far over its admission quota each tenant is (queued /
        max_queued) — the shed selector's primary rank: the most-
        over-quota tenant's newest work is evicted first.  Tenants
        with no max_queued quota carry no pressure (0.0 implied)."""
        out = {}
        for t, ts in self._tenant_state.items():
            mq = (self._tenant_cfg.get(t) or {}).get('max_queued')
            if mq:
                out[t] = ts['queued'] / float(mq)
        return out

    def _meter_compile(self, tenant: str, ms: float) -> None:
        with self._cv:
            self._tenant_locked(tenant)['compile_ms'] += ms
        profiling.counter_inc(f'tenant.{tenant}.compile_ms',
                              int(round(ms)))

    def meter_wire(self, tenant: str, nbytes: int) -> None:
        """Billing-grade bytes-on-wire metering hook for the fleet
        transport: the replica server calls this with each submit-op
        request frame's size and its response frame's size, attributed
        to the frame's tenant (docs/OBSERVABILITY.md)."""
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        nbytes = int(nbytes)
        with self._cv:
            self._tenant_locked(tenant)['bytes_wire'] += nbytes
        profiling.counter_inc(f'tenant.{tenant}.bytes_wire', nbytes)

    def _admit_overload_locked(self, priority: int, deadline) -> None:
        """Overload control (``max_est_wait_ms``): estimate how long
        the queue will take to serve, reject a submission that provably
        cannot meet its own deadline, and above the bound either shed
        the lowest-priority queued request to make room or reject the
        newcomer (docs/ROBUSTNESS.md "serving-layer failures")."""
        if self._max_est_wait_s is None:
            return
        est_s = self._est_wait_s_locked()
        if est_s is None:       # no completed batch yet: no estimate
            return
        now = time.monotonic()
        if deadline is not None and now + est_s >= deadline:
            self._overload_rejected += 1
            profiling.counter_inc('serve.overload_rejected')
            self.flight_recorder.record(
                'overload_reject', reason='deadline-unmeetable',
                est_wait_ms=round(est_s * 1e3, 3))
            raise OverloadError(
                f'deadline cannot be met: estimated queue wait '
                f'{est_s * 1e3:.1f} ms exceeds the '
                f'{(deadline - now) * 1e3:.1f} ms remaining — '
                f'rejected at admission instead of queueing to expire')
        if est_s <= self._max_est_wait_s:
            return
        if self._shed_locked(priority) is None:
            self._overload_rejected += 1
            profiling.counter_inc('serve.overload_rejected')
            self.flight_recorder.record(
                'overload_reject', reason='nothing-to-shed',
                est_wait_ms=round(est_s * 1e3, 3))
            raise OverloadError(
                f'overloaded: estimated queue wait {est_s * 1e3:.1f} '
                f'ms exceeds max_est_wait_ms='
                f'{self._max_est_wait_s * 1e3:g} and nothing of lower '
                f'priority is queued to shed')

    def _est_wait_s_locked(self):
        """Estimated service time of the current backlog: queued
        programs x EWMA per-program batch time / live executors.
        None until the first batch completes."""
        if self._ewma_prog_s is None:
            return None
        live = sum(1 for ex in self._executors
                   if ex.health == HEALTH_LIVE) or 1
        return self._depth_locked() * self._ewma_prog_s / live

    def _shed_locked(self, below_priority: int):
        """Evict the globally most-sheddable queued/parked request
        strictly below ``below_priority`` — the most-over-quota
        tenant's newest work first (``_tenant_pressure_locked``), then
        lowest priority, newest arrival (least invested) — failing it
        with :class:`OverloadError`.  Stream chunks and service-
        internal work are exempt (``batcher.shed_exempt``): another
        tenant's admission pressure never breaks a live session or an
        audit.  Returns the shed request or None."""
        pressure = self._tenant_pressure_locked()
        best = None                      # (rank, executor-or-None, key, req)
        for ex in self._executors:
            cand = ex.q.shed_candidate(below_priority, pressure)
            if cand is None:
                continue
            key, req = cand
            rank = (-pressure.get(req.tenant, 0.0),
                    req.priority, -req.seq)
            if best is None or rank < best[0]:
                best = (rank, ex, key, req)
        for _, key, req in self._parked:
            if req.priority >= below_priority or req.handle.done() \
                    or shed_exempt(req):
                continue
            rank = (-pressure.get(req.tenant, 0.0),
                    req.priority, -req.seq)
            if best is None or rank < best[0]:
                best = (rank, None, key, req)
        if best is None:
            return None
        _, ex, key, req = best
        if ex is None:
            self._parked = [it for it in self._parked
                            if it[2] is not req]
        elif not ex.q.remove(key, req):
            return None
        if req.handle._fail(OverloadError(
                f'shed under overload: estimated queue wait exceeds '
                f'max_est_wait_ms={self._max_est_wait_s * 1e3:g} and '
                f'a higher-priority request arrived')):
            self._shed += 1
            profiling.counter_inc('serve.shed')
            ts = self._tenant_locked(req.tenant)
            ts['shed'] += 1
            profiling.counter_inc(f'tenant.{req.tenant}.shed')
            self.flight_recorder.record('shed', req=req.seq,
                                        priority=req.priority,
                                        tenant=req.tenant)
        return req

    # -- routing / stealing ----------------------------------------------

    def _depth_locked(self) -> int:
        return sum(len(ex.q) for ex in self._executors) \
            + len(self._parked)

    def _route_locked(self, key) -> _DeviceExecutor:
        """Bucket-affinity router: the first sighting of a bucket pins
        it to the least-loaded LIVE executor (queue depth, then how
        many home buckets it already carries, then index —
        deterministic); every later submission of the bucket lands on
        the same home so its first-dispatch cost is paid once.  A
        home that got quarantined re-pins to a live peer; None when no
        executor is live (the caller parks the request)."""
        idx = self._home.get(key)
        if idx is not None \
                and self._executors[idx].health == HEALTH_LIVE:
            return self._executors[idx]
        live = [ex for ex in self._executors
                if ex.health == HEALTH_LIVE]
        if not live:
            return None
        if idx is not None:
            self._home_counts[idx] -= 1
        ex = min(live, key=lambda e: (len(e.q),
                                      self._home_counts[e.idx],
                                      e.idx))
        self._home[key] = ex.idx
        self._home_counts[ex.idx] += 1
        return ex

    def _try_steal_locked(self, thief: _DeviceExecutor, now: float,
                          flush: bool = False) -> bool:
        """Migrate one ripened batch from the deepest eligible victim
        queue into ``thief``'s.  A victim is eligible when it has a
        ripe bucket it cannot serve promptly: it is mid-execution, or
        more than one bucket ripened at once (or the service is
        draining, when any backlog is fair game).  Returns True when
        requests actually moved; the thief's own pop_batch then claims
        them (``absorb`` re-ran the deadline/cancel checks — a stolen
        request never outlives its deadline silently)."""
        best = None
        for v in self._executors:
            if v is thief or len(v.q) == 0:
                continue
            ripe = v.q.ripe_keys(now, flush=flush)
            if not ripe:
                continue
            if not (flush or v.busy or len(ripe) > 1):
                continue
            if best is None or len(v.q) > len(best[0].q):
                best = (v, ripe[0])
        if best is None:
            return False
        victim, key = best
        reqs = victim.q.migrate_bucket(key, self.max_batch_programs)
        if not reqs:
            return False
        victim.stolen_from += 1
        thief.steals += 1
        self._steals += 1
        profiling.counter_inc('serve.steals')
        self.flight_recorder.record('steal', victim=victim.label(),
                                    thief=thief.label(),
                                    bucket=key.label(), n=len(reqs))
        if self._tracer.enabled:
            for r in reqs:
                if r.handle._trace is not None:
                    r.handle._trace.instant('steal',
                                            src=victim.label(),
                                            dst=thief.label())
        expired = thief.q.absorb(key, reqs, now)
        self._count_expired_locked(expired)
        return True

    def _count_expired_locked(self, expired) -> None:
        if expired:
            self._expired += len(expired)
            profiling.counter_inc('serve.expired', len(expired))
            # a streaming chunk expiring misses EVERY round it carried
            # (per-round deadlines are honored at scan-chunk
            # boundaries — the whole chunk is the deadline unit)
            missed = sum(r.rounds for r in expired
                         if r.rounds is not None)
            if missed:
                self._stream_round_misses += missed
                profiling.counter_inc(
                    'serve.stream.round_deadline_misses', missed)

    # -- supervision -----------------------------------------------------

    def _pump_parked_locked(self, now: float, flush: bool = False):
        """Move parked retries whose backoff elapsed back into a live
        executor's queue (forced: they already waited out the latency
        dial once).  Deadlines are re-checked here — a parked request
        never outlives its ``deadline_ms`` silently — and with no live
        executor the request stays parked until a re-admission (or, on
        a draining shutdown, drains through ANY executor)."""
        if not self._parked:
            return
        keep = []
        for item in self._parked:
            t, key, req = item
            if req.handle.done():
                if req.handle.cancelled():
                    self._cancelled += 1
                continue
            if not flush and t > now:
                keep.append(item)
                continue
            if req.expired(now):
                if req.handle._fail(DeadlineError(
                        f'deadline passed while parked for retry '
                        f'({now - req.submit_t:.3f} s after '
                        f'submission)')):
                    self._count_expired_locked([req])
                continue
            tgt = self._route_locked(key)
            if tgt is None and flush:
                tgt = min(self._executors,
                          key=lambda e: (len(e.q), e.idx))
            if tgt is None:
                keep.append(item)
                continue
            if req.handle._trace is not None:
                req.handle._trace.instant('unpark',
                                          executor=tgt.label())
            tgt.q.push(key, req, forced=True)
        self._parked = keep

    def _quarantine_locked(self, ex: _DeviceExecutor, now: float):
        """Trip the breaker: mark ``ex`` quarantined (no routed
        traffic, no stealing), arm its cooldown, strip its bucket
        homes, and re-home its whole backlog onto healthy executors
        via the absorb path (re-running every deadline/cancel check,
        exactly like a work-steal migration)."""
        ex.health = HEALTH_QUARANTINED
        ex.breaker.trip(now)
        self._breaker_trips += 1
        profiling.counter_inc('serve.breaker_trips')
        self.flight_recorder.record('breaker_trip',
                                    executor=ex.label(),
                                    breaker=ex.breaker.snapshot())
        for key in [k for k, i in self._home.items() if i == ex.idx]:
            del self._home[key]
            self._home_counts[ex.idx] -= 1
        for key, reqs in ex.q.migrate_all().items():
            tgt = self._route_locked(key)
            if self._tracer.enabled:
                dst = 'parked' if tgt is None else tgt.label()
                for r in reqs:
                    if r.handle._trace is not None:
                        r.handle._trace.instant('migrate',
                                                src=ex.label(),
                                                dst=dst,
                                                reason='quarantine')
            if tgt is None:
                self._parked.extend((now, key, r) for r in reqs)
            else:
                self._count_expired_locked(
                    tgt.q.absorb(key, reqs, now))
        self._cv.notify_all()

    def _supervise_loop(self):
        """The supervisor thread: every tick it pumps parked retries,
        checks each executor for a dead dispatcher thread (respawn +
        quarantine + retry its in-flight batch), a dispatch past the
        hang watchdog (quarantine + retry elsewhere; the straggler's
        eventual completion is token-stale), and a quarantined
        executor whose cooldown elapsed (launch a canary probe)."""
        while True:
            with self._cv:
                if self._stop_supervisor:
                    return
                now = time.monotonic()
                self._pump_parked_locked(now)
                self._expire_sessions_locked(now)
                for ex in self._executors:
                    if not ex.thread.is_alive() and not self._closing:
                        self._on_executor_death_locked(ex, now)
                    elif ex.dispatch_deadline is not None \
                            and now > ex.dispatch_deadline:
                        self._on_executor_hang_locked(ex, now)
                    if ex.health == HEALTH_QUARANTINED \
                            and ex.canary_thread is None \
                            and not self._closing \
                            and ex.breaker.ready_to_probe(now):
                        self._start_canary_locked(ex)
                self._cv.wait(self._supervise_interval_s)

    def _on_executor_death_locked(self, ex: _DeviceExecutor,
                                  now: float):
        """The dispatcher thread died (a non-Exception throwable out
        of a dispatch, or a bug): recover its in-flight batch into the
        retry path, quarantine the executor, and respawn a fresh
        dispatcher so the pool never shrinks permanently."""
        self._executor_deaths += 1
        ex.deaths += 1
        profiling.counter_inc('serve.executor_deaths')
        self.flight_recorder.record(
            'executor_death', executor=ex.label(),
            inflight=0 if ex.inflight is None else len(ex.inflight[1]))
        inflight, ex.inflight = ex.inflight, None
        ex.busy = False
        ex.dispatch_deadline = None
        self._quarantine_locked(ex, now)
        if inflight is not None:
            key, batch = inflight
            self._retry_batch_locked(key, batch, ExecutorLostError(
                f'dispatcher thread for executor {ex.label()} died '
                f'mid-dispatch'), now)
        ex.respawns += 1
        ex.spawn_thread(self)
        ex.thread.start()
        self.flight_recorder.record('respawn', executor=ex.label(),
                                    respawns=ex.respawns)
        self._dump_flight_auto()
        self._cv.notify_all()

    def _on_executor_hang_locked(self, ex: _DeviceExecutor,
                                 now: float):
        """The current dispatch blew past ``hang_timeout_s``: retry
        its batch on healthy executors NOW (fresh attempt tokens make
        the hung dispatch's eventual completion a no-op) and
        quarantine the executor — the canary decides when it is
        trustworthy again."""
        self._hangs += 1
        ex.hangs += 1
        profiling.counter_inc('serve.hangs')
        self.flight_recorder.record(
            'hang', executor=ex.label(),
            hang_timeout_s=self._hang_timeout_s,
            inflight=0 if ex.inflight is None else len(ex.inflight[1]))
        inflight, ex.inflight = ex.inflight, None
        ex.dispatch_deadline = None
        self._quarantine_locked(ex, now)
        if inflight is not None:
            key, batch = inflight
            self._retry_batch_locked(key, batch, ExecutorLostError(
                f'dispatch on executor {ex.label()} exceeded '
                f'hang_timeout_s={self._hang_timeout_s}'), now)
        self._dump_flight_auto()
        self._cv.notify_all()

    def _start_canary_locked(self, ex: _DeviceExecutor):
        """Half-open probe: run one tiny known program on the
        quarantined executor in a short-lived thread (through
        ``_run_batch``, so fault injection exercises this path too)."""
        ex.health = HEALTH_PROBING
        ex.canary_thread = threading.Thread(
            target=self._canary_probe, args=(ex,),
            name=f'{CANARY_THREAD_PREFIX}-{self.name}-d{ex.idx}',
            daemon=True)
        ex.canary_thread.start()

    def _canary_work(self):
        """The canary workload: a tiny branch-free single-core
        program (its own 1-program bucket, so a canary compile never
        perturbs serving buckets), built once and reused."""
        if self._canary_mp is None:
            core = [isa.pulse_cmd(amp_word=1000, cfg_word=0,
                                  env_word=3, cmd_time=10),
                    isa.done_cmd()]
            self._canary_mp = machine_program_from_cmds([core])
        mp = self._canary_mp
        ncfg, _ = _normalize_cfg(None, isa.shape_bucket(mp.n_instr))
        key = bucket_key(mp, ncfg)
        meas = np.zeros((1, mp.n_cores, ncfg.max_meas), np.int32)
        req = Request(mp=mp, meas_bits=meas, init_regs=None, cfg=ncfg,
                      strict=False, n_shots=1, priority=0,
                      deadline=None, seq=-1)
        return key, [req], ncfg

    def _canary_probe(self, ex: _DeviceExecutor):
        """Runs on the canary thread.  Success needs a clean run AND
        bit-identity with the first successful canary anywhere in the
        pool — a device that computes WRONG bits stays quarantined
        just like one that crashes.  Success re-admits the executor
        (health live, breaker reset, parked work pumped); failure
        re-arms the quarantine with an escalated cooldown."""
        ok = False
        try:
            key, batch, ncfg = self._canary_work()
            out = self._run_batch(ex, key, batch, ncfg)[0]
            ref = {k: np.asarray(v) for k, v in out.items()}
            clean = not np.asarray(ref.get('fault', 0)).any()
            with self._cv:
                if self._canary_ref is None:
                    self._canary_ref = ref
                    ok = clean
                else:
                    ok = clean and set(ref) == set(self._canary_ref) \
                        and all(np.array_equal(ref[k],
                                               self._canary_ref[k])
                                for k in self._canary_ref)
        except BaseException:   # noqa: BLE001 - injected faults included
            ok = False
        now = time.monotonic()
        with self._cv:
            ex.canary_thread = None
            self.flight_recorder.record('canary', executor=ex.label(),
                                        ok=ok)
            if ok:
                ex.canary_ok += 1
                self._canary_ok += 1
                profiling.counter_inc('serve.canary.ok')
                ex.health = HEALTH_LIVE
                ex.breaker.readmit()
                self._readmissions += 1
                profiling.counter_inc('serve.readmissions')
                self.flight_recorder.record('readmission',
                                            executor=ex.label())
                self._pump_parked_locked(now)
            else:
                ex.canary_fail += 1
                self._canary_fail += 1
                profiling.counter_inc('serve.canary.fail')
                ex.health = HEALTH_QUARANTINED
                ex.breaker.trip(now)
            self._cv.notify_all()

    # -- background scrubber (docs/ROBUSTNESS.md "Integrity") ------------

    def _scrub_loop(self):
        """The scrubber thread: every ``scrub_interval_s`` it replays
        the golden canary program on each idle live executor and
        bit-compares against the pool-wide canary reference.  A
        device that has started corrupting fails ``breaker_threshold``
        consecutive scrubs and goes through the standard
        quarantine -> canary re-admission lifecycle — benched by the
        same machinery that benches a crashing one, without waiting
        for tenant traffic to trip an audit."""
        while True:
            with self._cv:
                if self._closing:
                    return
                self._cv.wait(self._scrub_interval_s)
                if self._closing:
                    return
                idle = [ex for ex in self._executors
                        if ex.health == HEALTH_LIVE and not ex.busy]
            for ex in idle:
                self._scrub_one(ex)

    def _scrub_one(self, ex: _DeviceExecutor):
        with self._cv:
            if self._closing or ex.health != HEALTH_LIVE or ex.busy:
                return
            self._scrubber_runs += 1
        profiling.counter_inc('integrity.scrubber_runs')
        ok = False
        try:
            key, batch, ncfg = self._canary_work()
            # through _run_batch, so chaos injection (including
            # 'corrupt') exercises the scrubber exactly like traffic
            out = self._run_batch(ex, key, batch, ncfg)[0]
            ref = {k: np.asarray(v) for k, v in out.items()}
            with self._cv:
                if self._canary_ref is None:
                    clean = not np.asarray(ref.get('fault', 0)).any()
                    if clean:
                        self._canary_ref = ref
                    ok = clean
                else:
                    ok = not diff_stats(ref, self._canary_ref)
        except BaseException:   # noqa: BLE001 - injected faults included
            ok = False
        now = time.monotonic()
        with self._cv:
            if ok:
                ex.scrub_fails = 0
                return
            ex.scrub_fails += 1
            self._scrubber_fail += 1
            self.flight_recorder.record('scrubber_fail',
                                        executor=ex.label(),
                                        consecutive=ex.scrub_fails)
            if ex.scrub_fails >= self._breaker_threshold \
                    and ex.health == HEALTH_LIVE and self._supervision:
                self._integrity_quarantines += 1
                profiling.counter_inc('integrity.quarantines')
                ex.scrub_fails = 0
                self._quarantine_locked(ex, now)

    # -- dispatcher ------------------------------------------------------

    def _dispatch_loop(self, ex: _DeviceExecutor):
        while True:
            with self._cv:
                while True:
                    now = time.monotonic()
                    ex.last_beat = now       # supervisor heartbeat
                    flush = self._closing and self._drain
                    self._pump_parked_locked(now, flush=flush)
                    # a quarantined/probing executor receives no routed
                    # traffic and may not pop or steal — except during a
                    # draining shutdown, when everyone helps flush
                    if ex.health == HEALTH_LIVE or flush:
                        key, batch, expired = ex.q.pop_batch(
                            now, flush=flush)
                        self._count_expired_locked(expired)
                        if key is None and self._stealing:
                            if self._try_steal_locked(ex, now,
                                                      flush=flush):
                                continue     # absorbed work: pop it now
                        if key is not None:
                            ex.busy = True
                            ex.inflight = (key, batch)
                            self._trace_claimed(ex, key, batch, now)
                            if self._hang_timeout_s is not None:
                                ex.dispatch_deadline = \
                                    now + self._hang_timeout_s
                            # wake idle peers: the remaining ripe
                            # buckets just became stealable
                            self._cv.notify_all()
                            break
                    if self._closing and (not self._drain
                                          or self._depth_locked() == 0):
                        return
                    if ex.health != HEALTH_LIVE:
                        self._cv.wait(0.25)
                        continue
                    timeout = self._wait_timeout_locked(ex, now)
                    if timeout is None:
                        self._cv.wait()
                    elif timeout > 0:
                        self._cv.wait(timeout)
                    else:
                        # something is ripe somewhere but not claimable
                        # by this executor yet: bounded re-check
                        self._cv.wait(0.002)
            done = False
            try:
                self._execute(ex, key, batch)
                done = True
            finally:
                with self._cv:
                    ex.busy = False
                    ex.dispatch_deadline = None
                    if done:
                        ex.inflight = None
                    # else the thread is dying on a non-Exception
                    # throwable mid-dispatch: leave inflight for the
                    # supervisor's dead-thread recovery to retry
                    self._cv.notify_all()

    def _wait_timeout_locked(self, ex: _DeviceExecutor,
                             now: float) -> float:
        """Condition-wait horizon: this executor's next queue event,
        or — with stealing on — any peer's (a peer's bucket ripening
        may become this executor's work)."""
        t = ex.q.next_event(now)
        if self._stealing:
            for v in self._executors:
                if v is ex:
                    continue
                tv = v.q.next_event(now)
                if tv is not None:
                    t = tv if t is None else min(t, tv)
        if self._parked:
            # a parked retry becoming eligible is a queue event too —
            # without this, a dispatcher could sleep unbounded while a
            # retry waits out its backoff (supervision may be off)
            tp = max(min(e[0] for e in self._parked) - now, 0.0)
            t = tp if t is None else min(t, tp)
        return t

    # -- tracing emission (docs/OBSERVABILITY.md) ------------------------

    def _trace_claimed(self, ex: _DeviceExecutor, key, batch,
                       now: float) -> None:
        """Close the queued + coalesce-ripen spans of every traced
        batch member at the moment the dispatcher claims the batch
        (called under the cv, right where pop_batch claimed)."""
        if not self._tracer.enabled:
            return
        oldest = min(r.submit_t for r in batch)
        for r in batch:
            ctx = r.handle._trace
            if ctx is None:
                continue
            # a retried request re-queues mid-flight: clamp the queued
            # span to start no earlier than its previous claim so the
            # per-attempt chain stays ordered
            t_q = r.submit_t if ctx.last_claim is None \
                else max(r.submit_t, ctx.last_claim)
            ctx.span('queued', t_q, now, bucket=key.label(),
                     executor=ex.label(),
                     attempt=r.handle.retries + 1)
            ctx.span('coalesce.ripen', max(oldest, t_q), now,
                     occupancy=len(batch))
            ctx.last_claim = now

    def _trace_dispatch(self, batch, ex: _DeviceExecutor, label: str,
                        klass: str, engine: str,
                        occupancy: int) -> None:
        """Record the dispatch span (claim → simulate entry) with the
        device, the bound-bucket identity, and the compile
        classification (cold / warm / aot)."""
        now = time.monotonic()
        for r in batch:
            ctx = r.handle._trace
            if ctx is None:
                continue
            t0 = now if ctx.last_claim is None else ctx.last_claim
            ctx.span('dispatch', t0, now, device=ex.label(),
                     bucket=label, classification=klass,
                     engine=engine, occupancy=occupancy)

    def _execute(self, ex: _DeviceExecutor, key, batch):
        cfg = key.cfg
        t0 = time.monotonic()
        try:
            results = self._run_batch(ex, key, batch, cfg)
        except Exception as exc:      # noqa: BLE001 - fail the batch, live on
            self._on_batch_failure(ex, key, batch, exc)
            return
        # streaming chunks are excluded from the differential audit:
        # its re-execution path is single-round simulate_batch, which
        # cannot consume the [R, B, C, M] rounds layout
        if self._audit_every and batch[0].rounds is None:
            with self._cv:
                self._audit_tick += 1
                do_audit = self._audit_tick % self._audit_every == 0
            if do_audit:
                bad = self._audit_batch(ex, key, batch, cfg, results)
                if bad is not None:
                    # strict policy: the tainted bits never reach a
                    # handle — the batch takes the infrastructure
                    # retry path (fresh execution re-derives the
                    # truth) and the breaker hears about it
                    self._on_batch_failure(ex, key, batch, bad)
                    return
        t_run = time.monotonic()
        completed = failed = served_rounds = 0
        served = []     # token-valid resolutions: the billable set
        for req, res in zip(batch, results):
            # every completion presents the attempt token: if this
            # dispatch was declared hung and the request retried
            # elsewhere, the token is stale and the write is a no-op
            if req.strict:
                counts = fault_shot_counts(
                    torch.as_tensor(res['fault'])).numpy()
                if counts.any():
                    if req.handle._fail(FaultError(counts),
                                        token=req.claim_token):
                        failed += 1
                        served.append(req)
                    continue
            if req.handle._fulfill(res, token=req.claim_token):
                completed += 1
                served.append(req)
                if req.rounds is not None:
                    served_rounds += req.rounds
        now = time.monotonic()
        if self._tracer.enabled:
            for req in batch:
                ctx = req.handle._trace
                if ctx is not None:
                    ctx.span('execute', t0, t_run, device=ex.label(),
                             bucket=key.label())
                    ctx.span('demux', t_run, now)
        with self._cv:
            self._dispatches += 1
            self._programs_dispatched += len(batch)
            self._occupancy[len(batch)] += 1
            ex.dispatches += 1
            ex.programs_dispatched += len(batch)
            ex.occupancy[len(batch)] += 1
            self._completed += completed
            self._failed += failed
            if served_rounds:
                self._stream_rounds_served += served_rounds
            # round-deadline misses at the scan-chunk boundary: a
            # chunk that completed PAST its deadline still served its
            # bits, but every round it carried missed its budget
            late = sum(req.rounds for req in batch
                       if req.rounds is not None
                       and req.deadline is not None
                       and now > req.deadline)
            if late:
                self._stream_round_misses += late
            for req in batch:
                if req.sid is not None and req.sid in self._sessions:
                    self._sessions[req.sid] = now
            ex.breaker.record_success()
            per_prog = (now - t0) / len(batch)
            self._ewma_prog_s = per_prog if self._ewma_prog_s is None \
                else 0.25 * per_prog + 0.75 * self._ewma_prog_s
            for req in batch:
                lat_ms = (now - req.submit_t) * 1e3
                self._latency_h.observe(lat_ms)
                profiling.registry().observe('serve.latency_ms',
                                             lat_ms)
            # usage metering, exactly-once by construction: only the
            # token-valid resolutions above are billed, so a chaos
            # kill + retry can neither lose nor double-count a
            # request's usage (a stale straggler's write was a no-op
            # and never reached `served`)
            per_prog_ms = per_prog * 1e3
            for req in served:
                ts = self._tenant_locked(req.tenant)
                sh = req.n_shots * (req.rounds or 1)
                ts['shots'] += sh
                ts['device_ms'] += per_prog_ms
                profiling.counter_inc(f'tenant.{req.tenant}.shots', sh)
                profiling.counter_inc(f'tenant.{req.tenant}.device_ms',
                                      int(round(per_prog_ms)))
        profiling.counter_inc('serve.dispatches')
        profiling.counter_inc('serve.programs_dispatched', len(batch))
        profiling.counter_inc('serve.batch_ms',
                              int((now - t0) * 1e3))
        if served_rounds:
            profiling.counter_inc('serve.stream.rounds_served',
                                  served_rounds)
        if late:
            profiling.counter_inc('serve.stream.round_deadline_misses',
                                  late)

    def _on_batch_failure(self, ex: _DeviceExecutor, key, batch, exc):
        """A batch raised out of ``_run_batch``.  Program-class errors
        (:func:`is_infrastructure_error` False — validation, bad
        arguments: they reproduce identically anywhere) propagate to
        every handle immediately; infrastructure-class errors feed the
        executor's circuit breaker and send the batch through the
        bounded-retry path."""
        profiling.counter_inc('serve.batch_failures')
        infra = is_infrastructure_error(exc)
        self.flight_recorder.record('batch_failure',
                                    executor=ex.label(),
                                    error=type(exc).__name__,
                                    infra=infra, n=len(batch))
        if self._tracer.enabled:
            for req in batch:
                ctx = req.handle._trace
                if ctx is not None:
                    ctx.instant('batch_error',
                                error=type(exc).__name__,
                                executor=ex.label())
        if not infra:
            failed = 0
            for req in batch:
                if req.handle._fail(exc, token=req.claim_token):
                    failed += 1
            with self._cv:
                self._failed += failed
            return
        now = time.monotonic()
        with self._cv:
            tripped = ex.breaker.record_failure()
            if tripped and ex.health == HEALTH_LIVE \
                    and self._supervision:
                if isinstance(exc, IntegrityError):
                    self._integrity_quarantines += 1
                    profiling.counter_inc('integrity.quarantines')
                self._quarantine_locked(ex, now)
            self._retry_batch_locked(key, batch, exc, now)
            self._cv.notify_all()

    def _retry_batch_locked(self, key, batch, exc, now: float):
        """Send a batch that died on executor infrastructure through
        the :class:`RetryPolicy`: each request re-queues (invalidating
        its old attempt token) and parks until its backoff elapses;
        one out of budget fails with the ORIGINAL infrastructure error
        it hit.  Requests already resolved (cancel / deadline / a
        racing completion) are skipped by the token guard."""
        policy = self._retry_policy
        for req in batch:
            if req.last_error is None:
                req.last_error = exc
            if req.handle.retries + 1 >= policy.max_attempts:
                if req.handle._fail(req.last_error,
                                    token=req.claim_token):
                    self._failed += 1
                    self._retry_exhausted += 1
                    profiling.counter_inc('serve.retry_exhausted')
                    self.flight_recorder.record(
                        'retry_exhausted', req=req.seq,
                        attempts=req.handle.retries + 1,
                        error=type(req.last_error).__name__)
            elif req.handle._requeue(req.claim_token):
                self._retries += 1
                profiling.counter_inc('serve.retries')
                delay = policy.delay_s(req.handle.retries - 1)
                self.flight_recorder.record(
                    'retry', req=req.seq, attempt=req.handle.retries,
                    delay_ms=round(delay * 1e3, 3),
                    error=type(exc).__name__)
                ctx = req.handle._trace
                if ctx is not None:
                    ctx.instant('retry', attempt=req.handle.retries,
                                backoff_ms=round(delay * 1e3, 3),
                                error=type(exc).__name__)
                    ctx.instant('park', reason='retry-backoff')
                self._parked.append((now + delay, key, req))

    # -- differential audit (docs/ROBUSTNESS.md "Integrity") -------------

    def _audit_engine(self, mp, cfg, served: str, device) -> str:
        """The audit rung: the first engine of the CPU-safe ladder
        subset that is not the one that served and accepts this
        program — a differential re-execution is only evidence when
        the second opinion goes through an independent code path."""
        for eng in ('block', 'straightline', 'generic'):
            if eng == served:
                continue
            try:
                resolve_engine(mp, replace(cfg, engine=eng), device)
                return eng
            except ValueError:
                continue
        return 'generic'

    def _audit_batch(self, ex: _DeviceExecutor, key, batch, cfg,
                     results):
        """Re-execute every request of a completed batch on a
        DIFFERENT engine (and a different live device when the pool
        has one) and bit-compare per stat, fault words included.

        Timing-dependent fault codes (budget exhaustion, deadlock,
        starvation) legitimately differ across engines, so a
        cross-engine disagreement alone is not corruption: it
        escalates to a confirm re-run under the exact served
        configuration, and only a confirmed mismatch counts — a real
        bit flip disagrees with ANY correct re-execution, so
        detection survives the escalation while legitimate engine
        divergence never cries wolf.  Audit-internal failures are
        inconclusive and never punish the batch.

        Returns the :class:`IntegrityError` to fail the batch with
        under ``audit_mode='strict'``, else None (flag mode records
        the violation and lets delivery proceed)."""
        with self._cv:
            self._audits += 1
            alts = [v.device for v in self._executors
                    if v is not ex and v.health == HEALTH_LIVE]
        profiling.counter_inc('integrity.audits')
        alt_dev = alts[0] if alts else ex.device
        singleton = len(batch) == 1 and self.singleton_engine is not None
        bad = []
        for req, res in zip(batch, results):
            try:
                want = {k: np.asarray(v) for k, v in res.items()}
                if singleton:
                    scfg = replace(cfg, engine=self.singleton_engine)
                    served = resolve_engine(req.mp, scfg, ex.device)
                else:
                    # the multi path is the generic engine; the solo
                    # generic run is its documented bit-identical
                    # equivalent (padding is inert, demux trims it)
                    scfg = replace(cfg, engine='generic')
                    served = 'generic'
                alt = self._audit_engine(req.mp, cfg, served, alt_dev)
                got = _to_host(simulate_batch(
                    req.mp, req.meas_bits, req.init_regs,
                    cfg=replace(cfg, engine=alt), device=alt_dev))
                keys = diff_stats(got, want)
                if keys and alt != served:
                    got = _to_host(simulate_batch(
                        req.mp, req.meas_bits, req.init_regs,
                        cfg=scfg, device=alt_dev))
                    keys = diff_stats(got, want)
                if keys:
                    bad.append((req.seq, keys))
            except Exception:   # noqa: BLE001 - inconclusive audit
                continue
        with self._cv:
            self._audit_mismatches += len(bad)
            was_bad = ex.integrity_bad
            ex.integrity_bad = bool(bad)
        if not bad:
            return None
        profiling.counter_inc('integrity.mismatches', len(bad))
        if not was_bad:
            # edge-triggered: a persistently-corrupting executor logs
            # one violation event, not one per audited batch
            self.flight_recorder.record(
                'integrity_violation', executor=ex.label(),
                mode=self._audit_mode, n=len(bad),
                stats=sorted({k for _, keys in bad for k in keys}))
        if self._audit_mode != 'strict':
            return None
        seqs = [seq for seq, _ in bad]
        return IntegrityError(
            f'audit mismatch on executor {ex.label()}: requests '
            f'{seqs} disagree with differential re-execution '
            f'(silent data corruption)')

    def _run_batch(self, ex: _DeviceExecutor, key, batch, cfg):
        """Execute one coalesced batch on ``ex``'s device and stream;
        returns per-request stats dicts in batch order (host numpy,
        padding trimmed)."""
        with ex.context():
            return self._dispatch_batch(ex, key, batch, cfg)

    def _dispatch_batch(self, ex: _DeviceExecutor, key, batch, cfg):
        if batch[0].rounds is not None:
            return self._run_stream_batch(ex, key, batch)
        if len(batch) == 1 and self.singleton_engine is not None:
            req = batch[0]
            scfg = replace(cfg, engine=self.singleton_engine)
            eng = resolve_engine(req.mp, scfg, ex.device)
            self._count_engine_locked(ex, eng)
            cold = self._classify_compile(
                ex, key, ('solo', eng, req.n_shots,
                          req.init_regs is None))
            if self._tracer.enabled:
                self._trace_dispatch(batch, ex, key.label(),
                                     'cold' if cold else 'warm', eng,
                                     1)
            t0 = time.monotonic()
            with host_span('serve.enqueue'):
                out = simulate_batch(req.mp, req.meas_bits, req.init_regs,
                                     cfg=scfg, device=ex.device)
            with host_span('serve.copy'):
                res = [_to_host(out)]
            self._record_bucket_ms(key, cold, time.monotonic() - t0)
            return res
        # everything before the enqueue: the stacked inputs and program,
        # the bucket bookkeeping
        with host_span('serve.pack'):
            B = max(r.n_shots for r in batch)
            P = _pow2(len(batch)) if self.pad_programs else len(batch)
            pad = P - len(batch)
            # program-count padding replicates the LAST request: its lanes
            # are deterministic copies, and demux only reads the first
            # len(batch) program slots — inert, but it keeps odd-sized
            # remainders and stolen batches on the pow2-shaped buckets
            meas = np.stack(
                [_pad_shots(r.meas_bits, B) for r in batch]
                + [_pad_shots(batch[-1].meas_bits, B)] * pad)
            if any(r.init_regs is not None for r in batch):
                rows = [_pad_shots(r.init_regs, B) if r.init_regs is not None
                        else np.zeros((B, r.mp.n_cores, isa.N_REGS), np.int32)
                        for r in batch]
                init = np.stack(rows + [rows[-1]] * pad)
            else:
                init = None
            mmp = stack_machine_programs(
                [r.mp for r in batch] + [batch[-1].mp] * pad,
                pad_to=key_bucket(batch))
            self._count_engine_locked(ex, 'generic')
            cold = self._classify_compile(ex, key,
                                          ('multi', P, B, init is None))
            # the catalog stores the EXACT dispatch identity: the stacked
            # batch's trait union, not any one member's traits
            bspec = replace(key, traits=program_traits(mmp)).bind(
                n_programs=P, n_shots=B, has_init_regs=init is not None)
            self._record_catalog(bspec)
            if self._tracer.enabled:
                # three-way dispatch classification: a shape warmed by
                # aot_compile_batch beats the cold/warm split (the lookup
                # the interpreter itself makes on dispatch)
                klass = 'aot' if aot_batch_cached(bspec, ex.device) \
                    else ('cold' if cold else 'warm')
                self._trace_dispatch(batch, ex, bspec.label(), klass,
                                     'generic', P)
        t0 = time.monotonic()
        with host_span('serve.enqueue'):
            out = simulate_multi_batch(mmp, meas, init, cfg=cfg,
                                       device=ex.device)
        # the host copy waits for the kernels, so the timed window
        # covers the whole dispatch — the cold/warm latency split
        # stats() turns into a first-dispatch cost estimate per bucket
        with host_span('serve.copy'):
            host = _to_host(out)
        self._record_bucket_ms(key, cold, time.monotonic() - t0)
        with host_span('serve.demux'):
            return [demux_multi_batch(host, i, n_shots=r.n_shots)
                    for i, r in enumerate(batch)]

    def _run_stream_batch(self, ex: _DeviceExecutor, key, batch):
        """Execute streaming round chunks: one
        :func:`~..sim.interpreter.simulate_rounds` call per request
        (chunks of one session coalescing under their shared sticky
        key still execute sequentially — each carries its own round
        count, and the rounds' lanes ARE the batching).  The chunk cfg rides the
        REQUEST (``rounds`` rebound per chunk), not the routing key."""
        results = []
        for req in batch:
            rcfg = req.cfg
            eng = resolve_engine(req.mp, rcfg, ex.device)
            self._count_engine_locked(ex, eng)
            cold = self._classify_compile(
                ex, key, ('stream', eng, req.rounds, req.n_shots,
                          req.init_regs is None, req.decode))
            if self._tracer.enabled:
                self._trace_dispatch([req], ex, key.label(),
                                     'cold' if cold else 'warm', eng,
                                     1)
            t0 = time.monotonic()
            out = simulate_rounds(req.mp, req.meas_bits, req.init_regs,
                                  cfg=rcfg, device=ex.device,
                                  decode=req.decode)
            with host_span('serve.copy'):
                results.append(_to_host(out))
            self._record_bucket_ms(key, cold, time.monotonic() - t0)
        return results

    def _count_engine_locked(self, ex: _DeviceExecutor, eng: str):
        """Record which ladder rung a dispatch actually ran on (the
        multi path is generic by construction; the singleton path
        resolves 'auto' the same way ``simulate_batch`` will)."""
        with self._cv:
            self._engine_dispatches[eng] += 1
            ex.engine_dispatches[eng] += 1
        profiling.counter_inc(f'serve.engine.{eng}')

    def _classify_compile(self, ex: _DeviceExecutor, key,
                          shape_sig: tuple) -> bool:
        """Host-side cold/warm classification: the first dispatch of a
        (bucket, shape signature) on a device is cold (the allocator
        grows to its working set, its kernels launch for the first
        time; the JAX package compiles there), every repeat is warm —
        tracked per executor because that cost is per device.  (An
        estimate: a shape another bucket already grew the allocator to
        makes a "cold" entry cheap.)  :meth:`warmup` pays it ahead.
        """
        sig = (key, shape_sig)
        with self._cv:
            cold = sig not in ex.seen
            if cold:
                ex.seen.add(sig)
                ex.cold_compiles += 1
            else:
                ex.warm_hits += 1
            per = self._bucket_label_entry_locked(key)
            per['cold' if cold else 'warm'] += 1
        profiling.counter_inc(
            'serve.compile.cold' if cold else 'serve.compile.warm')
        return cold

    def _bucket_label_entry_locked(self, key) -> dict:
        return self._bucket_compiles.setdefault(
            _bucket_label(key),
            {'cold': 0, 'warm': 0, 'cold_s': 0.0, 'warm_s': 0.0,
             'cold_timed': 0, 'warm_timed': 0})

    def _record_bucket_ms(self, key, cold: bool, dt_s: float) -> None:
        """Accrue one timed dispatch into the bucket's cold/warm
        latency split (warmup classifications are untimed, so counts
        and timed-sample counts are tracked separately)."""
        with self._cv:
            per = self._bucket_label_entry_locked(key)
            which = 'cold' if cold else 'warm'
            per[which + '_s'] += dt_s
            per[which + '_timed'] += 1

    def _record_catalog(self, spec: BucketSpec) -> None:
        """Persist a dispatched bucket into the learned catalog (no-op
        without one; deduped in memory so steady-state dispatch never
        touches the filesystem)."""
        if self._catalog is None:
            return
        with self._cv:
            if spec.identity() in self._catalog_seen:
                return
            self._catalog_seen.add(spec.identity())
        self._catalog.record(spec)

    # -- warmup ----------------------------------------------------------

    def bucket_spec(self, mp, *, shots: int = 1, n_programs: int = None,
                    cfg: InterpreterConfig = None) -> BucketSpec:
        """The BOUND :class:`BucketSpec` a ``(mp, cfg)`` submission
        would dispatch into at ``n_programs`` batch occupancy (default
        ``max_batch_programs``; pow2-padded exactly like live
        dispatch) and ``shots`` — the value :meth:`warmup` compiles
        and the catalog stores."""
        n_programs = n_programs if n_programs is not None \
            else self.max_batch_programs
        n_programs = max(1, min(n_programs, self.max_batch_programs))
        base = cfg if cfg is not None else self._default_cfg
        ncfg, _ = _normalize_cfg(base, isa.shape_bucket(mp.n_instr))
        P = _pow2(n_programs) if self.pad_programs else n_programs
        return bucket_key(mp, ncfg).bind(n_programs=P,
                                         n_shots=int(shots))

    def warmup(self, specs=None, *, shots: int = 1,
               n_programs: int = None,
               cfg: InterpreterConfig = None) -> list:
        """Warm serving shapes on EVERY device executor
        (``sim.interpreter.aot_compile_batch`` — one run of the shape
        on zero bits, no real program dispatched), so the first real
        request in a warmed bucket does not pay the first dispatch's
        allocator growth and first launches inside its latency budget.

        ``specs`` is a bound :class:`BucketSpec`, an iterable of them,
        or (backward compatible) a machine program — then
        ``shots``/``n_programs``/``cfg`` describe the representative
        batch exactly as before and :meth:`bucket_spec` derives the
        spec.  A warmed shape is exact — (programs, shots, cores,
        instruction bucket, cfg) — so warm coverage needs the
        occupancies traffic will actually dispatch (the benches warm
        every power of two up to ``max_batch_programs``).

        Counted in ``stats()['compile']`` / ``serve.compile.*`` like a
        dispatch (warmup compiles classify cold; the first real
        request then classifies warm).  Returns one ``{'device',
        'spec', 'cold', 'compile_ms'}`` dict per (spec, executor) —
        ``compile_ms`` 0.0 when the shape was already warm.

        Covers the coalesced multi-program path; a ``singleton_engine``
        fallback dispatch is content-keyed and cannot be warmed from a
        shape alone."""
        with self._cv:
            if self._closing:
                raise ServiceClosedError(
                    f'service {self.name!r} is shut down')
        if specs is None:
            raise ValueError('warmup needs a bound BucketSpec, an '
                             'iterable of them, or a machine program')
        if hasattr(specs, 'n_instr'):      # a MachineProgram (legacy)
            specs = [self.bucket_spec(specs, shots=shots,
                                      n_programs=n_programs, cfg=cfg)]
        elif isinstance(specs, BucketSpec):
            specs = [specs]
        else:
            specs = list(specs)
        report = []
        for spec in specs:
            if not spec.bound:
                raise ValueError(
                    f'warmup needs BOUND specs (BucketSpec.bind / '
                    f'bucket_spec); got template {spec.label()!r}')
            for ex in self._executors:
                with ex.context():
                    dt = aot_compile_batch(spec, ex.device)
                cold = self._classify_compile(ex, spec.template(),
                                              spec.shape_sig())
                with self._cv:
                    self._warmups += 1
                    if dt > 0:
                        self._warmup_aot += 1
                profiling.counter_inc('serve.warmups')
                report.append({'device': ex.label(),
                               'spec': spec.label(), 'cold': cold,
                               'compile_ms': dt * 1e3})
        return report

    def _warmup_replay(self, specs: list) -> None:
        """Background catalog replay (the ``dproc-serve-warmup-*``
        thread): AOT-compile every recorded spec on every executor.
        Never blocks admission — dispatch takes the lazy path for any
        bucket whose replay has not landed yet — and a bad catalog
        entry is skipped, never surfaced to a request."""
        for spec in specs:
            compiled_any = False
            for ex in self._executors:
                with self._cv:
                    if self._closing:
                        self._warmup_pending = 0
                        return
                try:
                    with ex.context():
                        dt = aot_compile_batch(spec, ex.device)
                except Exception:   # noqa: BLE001 - tolerate bad entries
                    with self._cv:
                        self._warmup_pending -= 1
                    continue
                # mark the (bucket, shape) seen so the first real
                # request classifies warm — which it IS, it will hit
                # the precompiled executable
                self._classify_compile(ex, spec.template(),
                                       spec.shape_sig())
                with self._cv:
                    self._warmup_pending -= 1
                    if dt > 0:
                        self._warmup_aot += 1
                    compiled_any = True
            with self._cv:
                if compiled_any:
                    self._warmup_replayed += 1
                self._cv.notify_all()
        profiling.counter_inc('serve.warmup_replays')

    # -- introspection / lifecycle ---------------------------------------

    def stats(self) -> dict:
        """Snapshot of the service counters: aggregate queue depth,
        batch occupancy histogram, coalescing efficiency (programs per
        dispatch), p50/p99 submit-to-done latency in ms, cold/warm
        dispatches per bucket, and a per-device breakdown (queue
        depth, occupancy, steals, compile hits) for the multi-device
        pool."""
        with self._cv:
            lat = np.asarray(self._latency_h.values(), np.float64)
            occ = dict(sorted(self._occupancy.items()))
            # prune resolved stream chunks lazily: stats() is the only
            # reader of rounds-in-flight, so the live list never grows
            # past the outstanding chunk count between snapshots
            self._stream_live = [(h, r) for h, r in self._stream_live
                                 if not h.done()]
            rounds_in_flight = sum(r for _, r in self._stream_live)
            devices = [{
                'device': ex.label(),
                'index': ex.idx,
                'busy': ex.busy,
                'health': ex.health,
                'queue_depth': len(ex.q),
                'dispatches': ex.dispatches,
                'programs_dispatched': ex.programs_dispatched,
                'batch_occupancy': dict(sorted(ex.occupancy.items())),
                'engine_dispatches': dict(sorted(
                    ex.engine_dispatches.items())),
                'steals': ex.steals,
                'stolen_from': ex.stolen_from,
                'cold_compiles': ex.cold_compiles,
                'warm_hits': ex.warm_hits,
                'home_buckets': self._home_counts[ex.idx],
                'breaker_trips': ex.breaker.trips,
                'consecutive_failures': ex.breaker.consecutive,
                'readmissions': ex.breaker.readmissions,
                'hangs': ex.hangs,
                'deaths': ex.deaths,
                'respawns': ex.respawns,
                'canary_ok': ex.canary_ok,
                'canary_fail': ex.canary_fail,
                'integrity_bad': ex.integrity_bad,
            } for ex in self._executors]
            health = collections.Counter(
                ex.health for ex in self._executors)
            est_s = self._est_wait_s_locked()
            snap = {
                'queue_depth': self._depth_locked(),
                'submitted': self._submitted,
                'completed': self._completed,
                'failed': self._failed,
                'cancelled': self._cancelled + sum(
                    ex.q.dropped_cancelled for ex in self._executors),
                'expired': self._expired,
                'rejected': self._rejected,
                'dispatches': self._dispatches,
                'programs_dispatched': self._programs_dispatched,
                'batch_occupancy': occ,
                'engine_dispatches': dict(sorted(
                    self._engine_dispatches.items())),
                'coalesce_efficiency': (
                    self._programs_dispatched / self._dispatches
                    if self._dispatches else 0.0),
                'n_devices': len(self._executors),
                'work_stealing': self._stealing,
                'steals': self._steals,
                'warmups': self._warmups,
                'warmup': {
                    'aot_compiled': self._warmup_aot,
                    'replayed': self._warmup_replayed,
                    'in_progress': self._warmup_pending,
                },
                'supervision': self._supervision,
                'health': {state: health.get(state, 0)
                           for state in (HEALTH_LIVE,
                                         HEALTH_QUARANTINED,
                                         HEALTH_PROBING)},
                'parked': len(self._parked),
                'retries': self._retries,
                'retry_exhausted': self._retry_exhausted,
                'shed': self._shed,
                'overload_rejected': self._overload_rejected,
                'breaker_trips': self._breaker_trips,
                'readmissions': self._readmissions,
                'executor_deaths': self._executor_deaths,
                'hangs': self._hangs,
                'canary': {'ok': self._canary_ok,
                           'fail': self._canary_fail},
                'integrity': {
                    'audit_sample': self._audit_sample,
                    'audit_mode': self._audit_mode,
                    'audits': self._audits,
                    'mismatches': self._audit_mismatches,
                    'scrubber_runs': self._scrubber_runs,
                    'scrubber_fail': self._scrubber_fail,
                    'quarantines': self._integrity_quarantines,
                },
                'streaming': {
                    'open_sessions': len(self._sessions),
                    'rounds_in_flight': rounds_in_flight,
                    'rounds_submitted': self._stream_rounds_submitted,
                    'rounds_served': self._stream_rounds_served,
                    'round_deadline_misses': self._stream_round_misses,
                    'sessions_opened': self._stream_sessions_opened,
                    'sessions_expired': self._stream_sessions_expired,
                },
                # calibration traffic (docs/SERVING.md "Calibration
                # sessions"): loop steps ride submit_source, so shots/
                # compiles are already under the ordinary counters —
                # this block is the session-lifecycle view
                'calibration': {
                    'open_sessions': len(self._calib_sessions),
                    'sessions_opened': self._calib_sessions_opened,
                    'steps': self._calib_steps,
                    'converged': self._calib_converged,
                    'diverged': self._calib_diverged,
                },
                'est_wait_ms': None if est_s is None
                else float(est_s * 1e3),
                'compile': {
                    'cold': sum(ex.cold_compiles
                                for ex in self._executors),
                    'warm': sum(ex.warm_hits
                                for ex in self._executors),
                    'per_bucket': {
                        k: _bucket_compile_view(v) for k, v in sorted(
                            self._bucket_compiles.items())},
                },
                'source': {
                    'submitted': self._source_submitted,
                    'pending_compile': len(self._source_handles),
                },
                # per-tenant accounting (docs/SERVING.md "Tenants"):
                # queued/served/shed/quota-rejected plus the billing
                # meters; configured tenants appear even before their
                # first request, unconfigured ones at first sight
                'tenants': {
                    t: dict(ts,
                            weight=self._tenant_weights.get(t, 1.0))
                    for t, ts in sorted(self._tenant_state.items())},
                'devices': devices,
            }
            cache = self._compile_cache
        # program-compile front door counters (hit/miss/singleflight/
        # evict/invalidation + compile-time percentiles); None until the
        # first submit_source/compile_cache touch
        snap['compile_cache'] = None if cache is None else cache.stats()
        if lat.size:
            # the histogram window holds ms already (obs.metrics);
            # same exact-percentile math the old seconds deque used
            snap['latency_p50_ms'] = float(np.percentile(lat, 50))
            snap['latency_p99_ms'] = float(np.percentile(lat, 99))
        else:
            snap['latency_p50_ms'] = snap['latency_p99_ms'] = 0.0
        snap['latency_samples'] = int(lat.size)
        # mirror the load-shaped readings into the registry as gauges
        # (per-service names: a process may run several services)
        reg = profiling.registry()
        reg.set_gauge(f'serve.{self.name}.queue_depth',
                      snap['queue_depth'])
        reg.set_gauge(f'serve.{self.name}.parked', snap['parked'])
        return snap

    # -- observability export (docs/OBSERVABILITY.md) --------------------

    def dump_trace(self, path: str, base_ns: int = None) -> int:
        """Export every retained sampled request trace as Chrome Trace
        Event JSON — loadable in Perfetto / ``chrome://tracing``, and
        summarized per stage by ``cli trace-view``
        (tools/traceview.py).  Returns the event count written.

        With ``base_ns`` (a ``torch.profiler`` trace's
        ``baseTimeNanoseconds``, as ``utils.profiling.device_profile``
        yields it) the request spans go on the profiler's clock, with the
        process's host spans (``obs.trace.HOST_SPANS``) beside them, so
        the file opens on the profile's timeline."""
        return write_chrome_trace(
            path, self._tracer.contexts(), pid=self.name, base_ns=base_ns,
            host_spans=HOST_SPANS.spans() if base_ns is not None else ())

    def dump_flight(self, path: str = None) -> str | None:
        """Write the flight-recorder ring to ``path``.  With no path,
        falls back to ``flight_dump_dir`` (or ``$DPROC_FLIGHT_DIR``),
        writing ``flight-<service>.json`` there; returns the written
        path, or None when no destination is configured."""
        if path is None:
            d = self._flight_dump_dir \
                or os.environ.get('DPROC_FLIGHT_DIR')
            if not d:
                return None
            path = os.path.join(d, f'flight-{self.name}.json')
        self.flight_recorder.dump(path)
        return path

    def _dump_flight_auto(self) -> None:
        """Supervisor-detected failure: capture the evidence now,
        best-effort — observability I/O must never take supervision
        down with it."""
        try:
            self.dump_flight()
        except OSError:
            pass

    def shutdown(self, drain: bool = True, timeout: float = None):
        """Stop the service.  ``drain=True`` (default) flushes every
        queued request through dispatch first (all executors keep
        draining — including by stealing — until every queue is empty);
        ``drain=False`` fails queued requests with
        :class:`ShutdownError` (a :class:`CancelledError` subclass;
        in-flight batches still complete).  Joins every dispatcher,
        supervisor and canary thread (up to ``timeout`` seconds EACH),
        then force-fails ANY handle still unresolved — after shutdown
        returns, ``result()`` can never block forever, even when a
        dispatch hung or a dispatcher died (the late straggler's
        completion is discarded as stale).  Idempotent.

        The compile front door participates: ``drain=True`` finishes
        every pending ``submit_source`` compile BEFORE the queues close
        (so its requests flush with the rest); ``drain=False`` cancels
        queued compiles and fails their handles with
        :class:`ShutdownError`."""
        with self._cv:
            pool = self._compile_pool
        if drain and pool is not None:
            # let in-flight source submissions compile and enqueue
            # before the intake closes; their requests then drain below
            pool.shutdown(wait=True)
        with self._cv:
            if not self._closing:
                self._closing = True
                self._drain = drain
                # streaming/calibration sessions close with the
                # service; their outstanding chunks/candidates drain
                # or fail with the rest
                self._sessions.clear()
                self._stream_keys.clear()
                self._calib_sessions.clear()
                if not drain:
                    exc = ShutdownError(
                        f'service {self.name!r} shut down without '
                        f'draining')
                    n = 0
                    for ex in self._executors:
                        n += ex.q.cancel_all(exc)
                    for _, _, req in self._parked:
                        if req.handle._fail(exc):
                            n += 1
                    self._parked = []
                    self._cancelled += n
                    if n:
                        profiling.counter_inc('serve.cancelled', n)
            self._cv.notify_all()
        if not drain and pool is not None:
            # cancel queued compiles; a compile already running hits
            # the closed intake (ServiceClosedError) and fails its own
            # handle.  wait=True keeps the thread-leak probe clean.
            pool.shutdown(wait=True, cancel_futures=True)
            exc = ShutdownError(
                f'service {self.name!r} shut down without draining')
            with self._cv:
                pending_src = list(self._source_handles)
                self._source_handles.clear()
            n = 0
            for h in pending_src:
                if h._fail(exc):
                    n += 1
            if n:
                with self._cv:
                    self._cancelled += n
                profiling.counter_inc('serve.cancelled', n)
        wt = self._warmup_thread
        if wt is not None:
            # the replay loop observes _closing between compiles and
            # exits; join keeps the thread-leak probe clean
            wt.join(timeout)
        for ex in self._executors:
            ex.thread.join(timeout)
        if self._supervisor is not None:
            with self._cv:
                self._stop_supervisor = True
                self._cv.notify_all()
            self._supervisor.join(timeout)
        if self._scrubber is not None:
            # the scrub loop observes _closing (set above, cv
            # notified) both before and after its interval wait
            self._scrubber.join(timeout)
        for ex in self._executors:
            t = ex.canary_thread
            if t is not None:
                t.join(timeout)
        # forced-shutdown guarantee: whatever the joins left behind
        # (a hung dispatch past its join timeout, a dead dispatcher's
        # recovered-but-unserved batch, a parked retry) fails typed NOW
        exc = ShutdownError(
            f'service {self.name!r} shut down with this request '
            f'unresolved')
        with self._cv:
            leftovers = []
            for ex in self._executors:
                if ex.inflight is not None:
                    leftovers.extend(ex.inflight[1])
                    if not ex.thread.is_alive():
                        ex.inflight = None
                leftovers.extend(
                    r for reqs in ex.q.migrate_all().values()
                    for r in reqs)
            leftovers.extend(r for _, _, r in self._parked)
            self._parked = []
            n = 0
            for h in self._source_handles:
                if h._fail(exc):
                    n += 1
            self._source_handles.clear()
            for req in leftovers:
                if req.handle._fail(exc):
                    n += 1
            self._cancelled += n
            if n:
                profiling.counter_inc('serve.cancelled', n)
            self._cv.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown(drain=exc_info[0] is None)


def key_bucket(batch) -> int:
    """The instruction bucket every member of a coalesced batch pads
    into — identical across the batch by construction (it is part of
    the coalescing key)."""
    return isa.shape_bucket(batch[0].mp.n_instr)
