"""The content-addressed compile cache: source -> MachineProgram.

:class:`CompileCache` turns compilation into a service-grade stage in
front of :func:`~..pipeline.compile_to_machine`:

* **content addressing** — :func:`~.key.content_key` over (program
  source, qchip calibration fingerprint, FPGAConfig, CompilerFlags,
  channel geometry).  Identical tenant submissions — including
  re-ordered instruction dicts and byte-identical QASM text — hit one
  entry; a hit returns the SAME MachineProgram arrays a direct compile
  would produce (bit-identity is pinned in tests/test_compilecache.py).
* **LRU memory tier** over an optional persistent disk tier
  (:class:`~.store.PersistentStore`): eviction drops the in-memory
  entry only, so an evicted program comes back as a cheap disk hit,
  and a process restart starts warm.
* **singleflight** — N concurrent identical submissions block on ONE
  compile; the stampede wakes together on the winner's result (or its
  typed failure).  ``stats()['singleflight_waits']`` counts the
  dedup that saved a compile each.
* **admission validation** — the freshly-compiled program runs
  :func:`~..decoder.validate_program` before it is admitted, so a
  malformed tenant program is rejected with ``(code, core, instr)``
  coordinates and never cached, never dispatched.
* **calibration-epoch invalidation** — each entry is tagged with its
  qchip fingerprint.  Resubmitting through a mutated ``QChip`` object
  (same identity, new fingerprint) auto-flushes exactly the stale
  epoch's entries, memory and disk; other qchips' entries stay warm.
  :meth:`invalidate_epoch` does the same explicitly.

Thread-safe throughout; compilation itself runs outside the lock.
"""

from __future__ import annotations

import collections
import threading
import time

from .key import content_key
from .store import PersistentStore
from ..utils import profiling

# get_or_compile outcome labels (the `status` the caller sees)
HIT = 'hit'            # in-memory LRU hit
DISK = 'disk'          # persistent-store hit (promoted to memory)
MISS = 'miss'          # compiled here
WAIT = 'wait'          # singleflight: waited on another thread's compile


class _Flight:
    """One in-progress compile other threads can wait on."""

    __slots__ = ('event', 'result', 'exc')

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.exc = None


class CompileCache:
    """See module docstring.  ``capacity`` bounds the in-memory LRU;
    ``cache_dir`` (optional) adds the persistent tier; ``validate``
    gates admission-time :func:`validate_program`; ``compile_fn``
    overrides the compile callable (tests inject slow/broken
    compilers) — it receives the dict-instruction program plus the
    same keyword surface as :func:`compile_to_machine`."""

    def __init__(self, capacity: int = 256, cache_dir: str = None,
                 validate: bool = True, compile_fn=None,
                 latency_window: int = 4096):
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        self.capacity = capacity
        self.validate = validate
        self._compile_fn = compile_fn
        self._store = PersistentStore(cache_dir) if cache_dir else None
        self._lock = threading.Lock()
        self._lru = collections.OrderedDict()   # key -> (mp, qchip_fp)
        self._flights = {}                      # key -> _Flight
        self._lineage = {}                      # id(qchip) -> fingerprint
        self._compile_s = collections.deque(maxlen=latency_window)
        self._hits = 0
        self._misses = 0
        self._disk_hits = 0
        self._evictions = 0
        self._singleflight_waits = 0
        self._invalidations = 0         # epoch flush events
        self._invalidated_entries = 0   # entries flushed by them
        self._writeback_flushes = 0     # ... triggered by a live-qchip
        #                                 mutation (calibration writer)
        self._validation_rejects = 0
        # optional FlightRecorder (set by ExecutionService) — epoch
        # invalidations land in the serving tier's incident timeline
        self.recorder = None

    # -- the front door --------------------------------------------------

    def get_or_compile(self, program, qchip, *, channel_configs=None,
                       fpga_config=None, compiler_flags=None,
                       n_qubits: int = 8, pad_to=None, element_cls=None):
        """Compile-or-hit: returns ``(MachineProgram, status, key)``
        where status is one of ``'hit' | 'disk' | 'miss' | 'wait'``.

        Raises :class:`~..decoder.ProgramValidationError` (with
        instruction coordinates) when the compiled program fails
        admission validation — every stampeded waiter of the same
        submission gets the same typed error.
        """
        qchip_fp = qchip.fingerprint()
        self._note_epoch(qchip, qchip_fp)
        key = content_key(program, qchip, channel_configs=channel_configs,
                          fpga_config=fpga_config,
                          compiler_flags=compiler_flags,
                          n_qubits=n_qubits, pad_to=pad_to,
                          element_cls=element_cls,
                          qchip_fingerprint=qchip_fp)
        while True:
            with self._lock:
                hit = self._lru.get(key)
                if hit is not None:
                    self._lru.move_to_end(key)
                    self._hits += 1
                    profiling.counter_inc('compilecache.hits')
                    return hit[0], HIT, key
                flight = self._flights.get(key)
                if flight is None:
                    flight = _Flight()
                    self._flights[key] = flight
                    owner = True
                else:
                    self._singleflight_waits += 1
                    profiling.counter_inc('compilecache.singleflight_waits')
                    owner = False
            if not owner:
                flight.event.wait()
                if flight.exc is not None:
                    raise flight.exc
                return flight.result, WAIT, key
            return self._fill_flight(flight, key, qchip_fp, program, qchip,
                                     channel_configs, fpga_config,
                                     compiler_flags, n_qubits, pad_to,
                                     element_cls)

    def _fill_flight(self, flight, key, qchip_fp, program, qchip,
                     channel_configs, fpga_config, compiler_flags,
                     n_qubits, pad_to, element_cls):
        """Flight owner: disk probe, else compile+validate; publish the
        result (or the typed failure) to every waiter."""
        try:
            mp = self._store.load(key, qchip_fp) if self._store else None
            if mp is not None:
                status = DISK
                with self._lock:
                    self._disk_hits += 1
                profiling.counter_inc('compilecache.disk_hits')
            else:
                status = MISS
                mp = self._compile(program, qchip, channel_configs,
                                   fpga_config, compiler_flags, n_qubits,
                                   pad_to, element_cls)
            self._admit(key, qchip_fp, mp, write_disk=(status == MISS))
        except BaseException as e:
            flight.exc = e
            raise
        else:
            flight.result = mp
            return mp, status, key
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()

    def _compile(self, program, qchip, channel_configs, fpga_config,
                 compiler_flags, n_qubits, pad_to, element_cls):
        from ..decoder import validate_program
        t0 = time.perf_counter()
        if isinstance(program, str):
            from ..frontend import qasm_to_program
            program = qasm_to_program(program)
        if self._compile_fn is not None:
            mp = self._compile_fn(program, qchip,
                                  channel_configs=channel_configs,
                                  fpga_config=fpga_config,
                                  compiler_flags=compiler_flags,
                                  n_qubits=n_qubits, pad_to=pad_to)
        else:
            from ..pipeline import compile_to_machine
            kw = {} if element_cls is None else {'element_cls': element_cls}
            mp = compile_to_machine(program, qchip,
                                    channel_configs=channel_configs,
                                    fpga_config=fpga_config,
                                    compiler_flags=compiler_flags,
                                    n_qubits=n_qubits, pad_to=pad_to, **kw)
        dt = time.perf_counter() - t0
        if self.validate:
            try:
                validate_program(mp)
            except Exception:
                with self._lock:
                    self._validation_rejects += 1
                raise
        with self._lock:
            self._misses += 1
            self._compile_s.append(dt)
        profiling.counter_inc('compilecache.misses')
        profiling.registry().observe('compilecache.compile_ms', dt * 1e3)
        return mp

    def _admit(self, key, qchip_fp, mp, write_disk: bool):
        with self._lock:
            self._lru[key] = (mp, qchip_fp)
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
                self._evictions += 1
        if write_disk and self._store is not None:
            self._store.save(key, qchip_fp, mp)

    # -- calibration epochs ----------------------------------------------

    def _note_epoch(self, qchip, qchip_fp: str) -> None:
        """Auto epoch tracking: the cache remembers the fingerprint it
        last saw for each live QChip OBJECT; a resubmission through a
        mutated qchip (one gate amplitude retuned) flushes exactly the
        stale epoch's entries.  Object identity only ties a mutation to
        its previous epoch — correctness never depends on it, since the
        fingerprint is part of every content key (a missed flush costs
        memory, never staleness)."""
        flush = None
        with self._lock:
            prev = self._lineage.get(id(qchip))
            if prev is not None and prev != qchip_fp:
                flush = prev
            self._lineage[id(qchip)] = qchip_fp
        if flush is not None:
            # a lineage-triggered flush means a LIVE qchip was written
            # between submissions — the calibration-writeback signature
            # (calib/loops.py); counted separately from explicit
            # invalidate_epoch calls so dashboards can tell retunes
            # from administrative flushes
            with self._lock:
                self._writeback_flushes += 1
            profiling.counter_inc('compilecache.writeback_flushes')
            self.invalidate_epoch(flush)

    def invalidate_epoch(self, qchip_fp: str) -> int:
        """Flush every entry (memory + disk) keyed to this calibration
        fingerprint; other epochs' entries stay warm.  Returns the
        number of entries flushed."""
        with self._lock:
            stale = [k for k, (_, fp) in self._lru.items()
                     if fp == qchip_fp]
            for k in stale:
                del self._lru[k]
            n = len(stale)
        if self._store is not None:
            n += self._store.invalidate_epoch(qchip_fp)
        with self._lock:
            self._invalidations += 1
            self._invalidated_entries += n
        profiling.counter_inc('compilecache.invalidations')
        if self.recorder is not None:
            self.recorder.record('cache_invalidate', qchip_fp=qchip_fp,
                                 entries=n)
        return n

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        """Counter snapshot + compile-time percentiles, shaped for
        ``ExecutionService.stats()['compile_cache']``."""
        with self._lock:
            times = sorted(self._compile_s)
            snap = {
                'size': len(self._lru),
                'capacity': self.capacity,
                'hits': self._hits,
                'misses': self._misses,
                'disk_hits': self._disk_hits,
                'evictions': self._evictions,
                'singleflight_waits': self._singleflight_waits,
                'invalidations': self._invalidations,
                'invalidated_entries': self._invalidated_entries,
                'writeback_flushes': self._writeback_flushes,
                'validation_rejects': self._validation_rejects,
                'persistent': self._store.path if self._store else None,
            }
        if times:
            def pct(p):
                return times[min(len(times) - 1,
                                 int(p / 100.0 * len(times)))]
            snap['compile_ms_p50'] = round(pct(50) * 1e3, 3)
            snap['compile_ms_p99'] = round(pct(99) * 1e3, 3)
        else:
            snap['compile_ms_p50'] = snap['compile_ms_p99'] = 0.0
        snap['compile_samples'] = len(times)
        return snap

    def clear(self) -> None:
        """Drop the memory tier (the persistent tier is untouched —
        use ``PersistentStore.clear`` via ``.store`` for that)."""
        with self._lock:
            self._lru.clear()

    @property
    def store(self) -> PersistentStore | None:
        return self._store


_DEFAULT_CACHE = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> CompileCache:
    """Process-wide shared cache (memory tier only) — the zero-config
    front door used by :func:`~..pipeline.cached_compile_to_machine`."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        if _DEFAULT_CACHE is None:
            _DEFAULT_CACHE = CompileCache()
        return _DEFAULT_CACHE
