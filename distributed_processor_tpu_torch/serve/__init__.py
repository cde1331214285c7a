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
``_run_batch`` to prove it.  The multi-process tier of the JAX package
(transport, router, fleet) is not part of this package.
"""

from ..integrity import IntegrityError
from .batcher import Coalescer, bucket_key
from .bucketspec import BucketSpec
from .catalog import BucketCatalog
from .chaos import (ChaosError, ChaosMonkey, ChaosPlan, ChaosThreadDeath,
                    SoakReport, TenantSoakReport, soak, tenant_soak)
from .request import (CancelledError, DeadlineError, ExecutorLostError,
                      OverloadError, QueueFullError, QuotaExceededError,
                      RequestHandle, ServiceClosedError, ShutdownError)
from .service import (CANARY_THREAD_PREFIX, DISPATCH_THREAD_PREFIX,
                      SUPERVISE_THREAD_PREFIX, WARMUP_THREAD_PREFIX,
                      ExecutionService)
from .stream import StreamKey, StreamSession
from .supervise import (HEALTH_LIVE, HEALTH_PROBING, HEALTH_QUARANTINED,
                        CircuitBreaker, RetryPolicy)

__all__ = [
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
    'HEALTH_LIVE',
    'HEALTH_PROBING',
    'HEALTH_QUARANTINED',
    'IntegrityError',
    'OverloadError',
    'QueueFullError',
    'QuotaExceededError',
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
    'bucket_key',
    'soak',
    'tenant_soak',
]
