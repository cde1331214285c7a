"""Learned bucket catalog: which executables a deployment actually serves.

The service cannot know ahead of time which ``(shape bucket, cfg,
occupancy, shots)`` combinations its traffic produces — but its own
dispatch history does.  :class:`BucketCatalog` persists every bound
:class:`~.bucketspec.BucketSpec` the service dispatches into a small
versioned JSON file; ``ExecutionService(warmup_catalog=...)`` replays
that file at startup on a background thread, AOT-compiling each spec
per device (``sim.interpreter.aot_compile_batch``: one run of the
spec's shape, which grows the allocator and makes the first launches)
so the first real request of the new process finds its shape warm.

Write discipline mirrors ``compilecache/store.py``: a magic + version
stamp, tmp-file + ``os.replace`` atomic rewrites (a reader or a crash
never sees a torn file), and a tolerant loader — any parse/version
problem means "empty catalog", never an exception into the serving
path.  The file is small (one dict per distinct bucket; diverse
production traffic is tens of buckets, not thousands) so each record
rewrites the whole file rather than appending.  Because fleet replicas
share ONE catalog file as a warm tier (docs/FLEET.md), every rewrite
happens under an advisory ``flock`` on a ``.lock`` sidecar with a
merge-from-disk first — concurrent recorders compose their entries
instead of last-writer-wins, and a replica's ``begin_run`` replays
what its peers learned, not just its own history.

A catalog left to itself only grows — a retired workload's buckets
would be AOT-recompiled at every startup forever.  So the catalog
ages: each process generation that calls :meth:`begin_run` bumps a
run counter, every dispatch re-stamps its spec's last-seen run, and
``begin_run`` prunes specs not re-observed within ``max_age_runs``
runs plus anything over the ``max_specs`` cap (least-recently-seen
evicted first).  The run/last-seen metadata rides in the same v1
file under keys old readers ignore, so catalogs written by either
side of this change stay mutually loadable.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading

try:
    import fcntl
except ImportError:          # pragma: no cover - non-posix
    fcntl = None

from ..utils import profiling
from .bucketspec import BucketSpec

CATALOG_MAGIC = 'dproc-bucket-catalog'
CATALOG_VERSION = 1


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory cross-process writer lock on ``path + '.lock'``.

    Fleet replicas share one catalog file (docs/FLEET.md "shared warm
    tiers"); without a lock two concurrent record()s interleave their
    read-modify-rewrite cycles and the later ``os.replace`` silently
    drops the earlier writer's specs.  Best-effort like everything else
    here: if locking is unavailable (non-posix, unwritable dir) the
    body still runs — atomic rename keeps the file un-torn, and a lost
    entry costs one future cold compile, never a request.
    """
    fd = None
    try:
        if fcntl is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            fd = os.open(path + '.lock', os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_EX)
    except OSError:
        if fd is not None:
            os.close(fd)
        fd = None
    try:
        yield
    finally:
        if fd is not None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)


class BucketCatalog:
    """Durable, deduplicated set of bound BucketSpecs at ``path``.

    Thread-safe; every mutation rewrites the file atomically.  I/O
    errors on record are swallowed after the in-memory set updates —
    losing a catalog entry costs one future cold compile, never a
    request.

    ``max_specs`` caps the catalog size (least-recently-seen specs
    evicted first); ``max_age_runs`` ages out specs not re-observed
    within that many :meth:`begin_run` generations.  Either may be
    None (unbounded / no aging).
    """

    def __init__(self, path: str, max_specs: int = None,
                 max_age_runs: int = None):
        if max_specs is not None and max_specs < 1:
            raise ValueError('max_specs must be >= 1')
        if max_age_runs is not None and max_age_runs < 1:
            raise ValueError('max_age_runs must be >= 1')
        self.path = path
        self.max_specs = max_specs
        self.max_age_runs = max_age_runs
        self._lock = threading.Lock()
        self._specs: dict = {}       # spec.identity() -> spec, ordered
        self._last_seen: dict = {}   # spec.identity() -> run number
        self._run = 0
        self._loaded = False

    # -- read ----------------------------------------------------------

    def load(self) -> list:
        """Specs in insertion order; [] for a missing/corrupt file."""
        with self._lock:
            self._load_locked()
            return list(self._specs.values())

    def begin_run(self) -> list:
        """Open a new process generation: bump the run counter, prune
        aged/over-cap specs, persist, and return the surviving specs
        (the startup warmup replay set).  The service calls this once
        at construction; a catalog opened only via :meth:`load` never
        ages.  Holds the cross-process writer lock around a fresh
        merge-from-disk, so a fleet replica starting up replays specs
        its PEERS recorded, not just its own last generation."""
        with self._lock:
            self._loaded = True
            with _file_lock(self.path):
                self._merge_disk_locked()
                self._run += 1
                self._prune_locked()
                try:
                    self._write_locked()
                except OSError:
                    pass    # durability is best-effort; serving is not
            return list(self._specs.values())

    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._merge_disk_locked()

    def _merge_disk_locked(self) -> None:
        """Fold the on-disk catalog into memory: union of specs, age
        stamps max-merged, run counter max-merged.  A parse/version
        problem merges nothing (in-memory state is never discarded);
        called at first load and — under :func:`_file_lock` — before
        every rewrite, so concurrent replicas' writes compose instead
        of last-writer-wins.  Spec entries are validated ONE AT A
        TIME: a peer that wrote one garbled spec (torn write on a
        non-posix filesystem, a buggy or older writer) costs exactly
        that spec — counted under ``catalog.merge_drops`` — instead of
        aborting the merge and poisoning every replica that shares the
        file."""
        try:
            with open(self.path, 'r', encoding='utf-8') as f:
                doc = json.load(f)
            if doc.get('magic') != CATALOG_MAGIC \
                    or doc.get('version') != CATALOG_VERSION:
                return
            # aging metadata is optional: a file written before the
            # aging change loads with every spec treated as just-seen
            self._run = max(self._run, int(doc.get('runs', 0)))
            last_seen = doc.get('last_seen', {})
            if not isinstance(last_seen, dict):
                last_seen = {}
            dropped = 0
            for d in doc.get('specs', ()):
                try:
                    spec = BucketSpec.from_json(d)
                    ident = spec.identity()
                    seen = int(last_seen.get(self._ident_key(ident),
                                             self._run))
                except (ValueError, TypeError, KeyError,
                        AttributeError):
                    dropped += 1
                    continue
                if ident not in self._specs:
                    self._specs[ident] = spec
                    self._last_seen[ident] = seen
                else:
                    self._last_seen[ident] = max(
                        self._last_seen[ident], seen)
            if dropped:
                profiling.counter_inc('catalog.merge_drops', dropped)
        except (OSError, ValueError, TypeError, KeyError):
            pass

    @staticmethod
    def _ident_key(ident) -> str:
        """JSON object keys must be strings; the identity tuple's repr
        is stable across processes (plain ints/strs/tuples only)."""
        return repr(ident)

    def _prune_locked(self) -> None:
        if self.max_age_runs is not None:
            horizon = self._run - self.max_age_runs
            stale = [i for i, seen in self._last_seen.items()
                     if seen < horizon]
            for ident in stale:
                del self._specs[ident]
                del self._last_seen[ident]
        if self.max_specs is not None \
                and len(self._specs) > self.max_specs:
            # least-recently-seen first; insertion order breaks ties
            order = {i: k for k, i in enumerate(self._specs)}
            victims = sorted(self._specs,
                             key=lambda i: (self._last_seen[i],
                                            order[i]))
            for ident in victims[:len(self._specs) - self.max_specs]:
                del self._specs[ident]
                del self._last_seen[ident]

    # -- write ---------------------------------------------------------

    def record(self, spec: BucketSpec) -> bool:
        """Add one bound spec; False when already present.  The file is
        rewritten atomically on every new spec."""
        if not spec.bound:
            raise ValueError('catalog stores BOUND specs only '
                             '(BucketSpec.bind)')
        with self._lock:
            self._load_locked()
            ident = spec.identity()
            if ident in self._specs:
                # a re-observation refreshes the age stamp in memory;
                # persistence rides the next new-spec or begin_run write
                self._last_seen[ident] = self._run
                return False
            self._specs[ident] = spec
            self._last_seen[ident] = self._run
            with _file_lock(self.path):
                # merge peers' concurrent writes before rewriting, so
                # N replicas recording into one shared catalog never
                # drop each other's entries (two-process contention
                # test in tests/test_fleet.py)
                self._merge_disk_locked()
                self._prune_locked()
                try:
                    self._write_locked()
                except OSError:
                    pass    # durability is best-effort; serving is not
            return True

    def _write_locked(self) -> None:
        doc = {'magic': CATALOG_MAGIC, 'version': CATALOG_VERSION,
               'runs': self._run,
               'last_seen': {self._ident_key(i): seen
                             for i, seen in self._last_seen.items()},
               'specs': [s.to_json() for s in self._specs.values()]}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix='.catalog-',
                                   suffix='.tmp')
        try:
            with os.fdopen(fd, 'w', encoding='utf-8') as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        with self._lock:
            self._load_locked()
            return len(self._specs)
