"""Continuous-batching execution service: the in-process serving tier.

The port of the JAX package's ``serve/`` in-process runtime: many
independent callers submit compiled machine programs asynchronously;
dispatcher threads coalesce them into shape-bucketed batches that run as
one ``simulate_multi_batch`` call over ``P x B`` lanes, then demux
per-request stats back onto future-like handles.  With ``devices=`` the
service shards into a pool of per-device executors with bucket-affinity
routing and work stealing.  Single-program batches may take the engine
ladder instead (``singleton_engine=``: K1 span or K1 block on the card),
and streaming QEC rounds dispatch as one ``simulate_rounds`` call per
chunk.

The service is self-healing (a supervisor thread with heartbeats, a hang
watchdog and dead-thread respawn; per-executor circuit breakers with
canary re-admission; bounded retries of infrastructure failures; overload
shedding) and tenant-fair (deficit round-robin, quotas with the typed
:class:`QuotaExceededError`, exactly-once metering).  :mod:`.chaos`
injects seeded crashes, hangs, slowdowns, deaths and bit flips under
``_run_batch`` to prove it.

One ring out, the multi-process tier: a :class:`Fleet` runs N services
as replica processes (:mod:`.replica_main`, one CUDA context each),
reached over a framed-pickle wire (:mod:`.transport`) through a
:class:`FleetRouter` with health gossip, fleet-level breakers,
cross-replica retry and bucket affinity; :func:`fleet_soak` scripts
SIGKILL / SIGSTOP chaos against it, and :mod:`.benchmark` times every
tier.
"""

from ..integrity import IntegrityError
from .batcher import Coalescer, bucket_key
from .bucketspec import BucketSpec
from .catalog import BucketCatalog
from .chaos import (ChaosError, ChaosMonkey, ChaosPlan, ChaosThreadDeath,
                    FleetSoakReport, SoakReport, TenantSoakReport,
                    fleet_soak, soak, tenant_soak)
from .fleet import AutoscalePolicy, Fleet
from .request import (CancelledError, DeadlineError, ExecutorLostError,
                      OverloadError, QueueFullError, QuotaExceededError,
                      RequestHandle, ServiceClosedError, ShutdownError)
from .router import ROUTER_THREAD_PREFIX, FleetRouter, is_terminal_error
from .service import (CANARY_THREAD_PREFIX, DISPATCH_THREAD_PREFIX,
                      SUPERVISE_THREAD_PREFIX, WARMUP_THREAD_PREFIX,
                      ExecutionService)
from .stream import StreamKey, StreamSession
from .supervise import (HEALTH_LIVE, HEALTH_PROBING, HEALTH_QUARANTINED,
                        CircuitBreaker, RetryPolicy)
from .transport import (WIRE_THREAD_PREFIX, ReplicaClient, ReplicaLostError,
                        ReplicaServer, WireCorruptionError)

__all__ = [
    'AutoscalePolicy',
    'BucketCatalog',
    'BucketSpec',
    'CANARY_THREAD_PREFIX',
    'CancelledError',
    'ChaosError',
    'ChaosMonkey',
    'ChaosPlan',
    'ChaosThreadDeath',
    'CircuitBreaker',
    'Coalescer',
    'DISPATCH_THREAD_PREFIX',
    'DeadlineError',
    'ExecutionService',
    'ExecutorLostError',
    'Fleet',
    'FleetRouter',
    'FleetSoakReport',
    'HEALTH_LIVE',
    'HEALTH_PROBING',
    'HEALTH_QUARANTINED',
    'IntegrityError',
    'OverloadError',
    'QueueFullError',
    'QuotaExceededError',
    'ROUTER_THREAD_PREFIX',
    'ReplicaClient',
    'ReplicaLostError',
    'ReplicaServer',
    'RequestHandle',
    'RetryPolicy',
    'SUPERVISE_THREAD_PREFIX',
    'ServiceClosedError',
    'ShutdownError',
    'SoakReport',
    'StreamKey',
    'StreamSession',
    'TenantSoakReport',
    'WARMUP_THREAD_PREFIX',
    'WIRE_THREAD_PREFIX',
    'WireCorruptionError',
    'bucket_key',
    'fleet_soak',
    'is_terminal_error',
    'soak',
    'tenant_soak',
]
