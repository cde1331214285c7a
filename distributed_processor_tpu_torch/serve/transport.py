"""Fleet wire protocol: framed-pickle RPC between router and replicas.

The fleet tier (docs/FLEET.md) runs N :class:`~.service.ExecutionService`
replicas as separate OS processes; this module is the only thing that
crosses the process boundary.  The protocol is deliberately minimal —
length-prefixed pickle frames over a localhost TCP socket (the same
wire works across hosts), request-id multiplexed so ONE connection
carries many in-flight submissions:

    client -> server   (req_id, op, payload)
    server -> client   (req_id, ok: bool, payload)

``op`` is one of ``submit`` / ``submit_source`` / ``stats`` / ``ping``
/ ``gossip`` / ``fleet-metrics`` / ``flight`` / ``shutdown``.  A
``submit`` gets exactly one response — sent when the request RESOLVES,
so admission errors (``QueueFullError``, ``OverloadError``), typed
program failures (``FaultError``, validation) and results all ride the
same frame, preserving the
:func:`~..sim.interpreter.is_infrastructure_error` taxonomy across the
wire: both sides share this codebase, so exceptions pickle as their
real types and the router can re-apply the retry rules the in-process
supervision layer uses.

Fleet observability rides the same frames (docs/OBSERVABILITY.md
"Fleet observability"): a submit payload may carry ``_trace``, the
router's trace id for a SAMPLED request — the server opens a forced
replica-side :class:`TraceContext` for it and piggybacks the recorded
spans back on the resolve reply as ``{'__trace__': {'spans': [...],
'mono_recv': ..., 'mono_send': ...}, 'result': <stats>}`` (the two
``mono`` stamps are replica-clock bounds of the server-side window, so
the router can split wire time from replica time).  ``gossip`` returns
the stats digest plus the replica's monotonic clock (the router's
clock-offset probe) and a flight-ring digest; ``fleet-metrics``
returns the replica's whole metrics-registry snapshot for labeled
re-exposition; ``flight`` returns the full flight ring for the
federated post-mortem pull.

Every frame carries a CRC32 content checksum in its header
(docs/ROBUSTNESS.md "Integrity"): the sender digests the pickle bytes,
the receiver verifies before unpickling, and a mismatch — or a
declared length past the wire bound, or a payload that truncates
mid-read — raises :class:`WireCorruptionError` and tears the
connection down.  A garbled frame therefore becomes a typed,
connection-scoped event the fleet retry machinery recovers from
(:class:`ReplicaLostError` -> re-dispatch; the router re-dials torn
connections on the gossip cadence), never a hang and never a
silently-wrong unpickle.  The check is a single C-speed pass over
bytes already in hand — negligible next to the pickle itself — so it
is always on.

Server side, submissions are enqueued into the service from the
connection's reader thread (``ExecutionService.submit`` never blocks on
execution) and a small waiter pool sends each response when its handle
resolves — a slow batch never stalls the connection.  Client side, a
reader thread demultiplexes responses to per-request callbacks; a dead
connection fails every pending callback with :class:`ReplicaLostError`
(a plain RuntimeError: infrastructure-class, hence retryable at the
fleet level) and fires ``on_lost`` exactly once.

Everything that crosses the wire is numpy or plain Python: the
service copies every result to host arrays inside its dispatch window,
and the server refuses (with a typed ``TypeError`` reply) a result that
still holds a torch tensor — a CUDA tensor would drag a CUDA context
into the router's process on unpickle.  A frame is read into one
preallocated buffer through ``recv_into``, so a 200 MB result frame
costs one pass over its bytes, not one copy of the growing buffer per
socket read.

All threads carry the ``dproc-serve`` name prefix, so the conftest
thread-leak probe holds this tier to the same no-leak contract as the
service's dispatchers.
"""

from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils import profiling

WIRE_THREAD_PREFIX = 'dproc-serve-wire'

_HDR = struct.Struct('>II')   # (payload length, payload CRC32)
_MAX_FRAME = 1 << 29          # 512 MiB: desync/corruption guard

OPS = ('submit', 'submit_source', 'submit_rounds', 'close_stream',
       'stats', 'ping', 'gossip', 'fleet-metrics', 'flight',
       'shutdown')


class ReplicaLostError(RuntimeError):
    """The connection to a replica died (process SIGKILLed, socket
    closed, unreadable frame) with requests still in flight.
    Deliberately a plain RuntimeError so
    :func:`~..sim.interpreter.is_infrastructure_error` classifies it
    retryable — replica loss is the fleet-level analog of an executor
    crash."""


class WireCorruptionError(ConnectionError):
    """A frame failed its integrity checks: header CRC32 mismatch or a
    declared length past the wire bound.  A ConnectionError subclass
    on purpose — every existing teardown path (server per-connection
    loop, client reader loop) already treats ConnectionError as
    "this connection is no longer trustworthy", which is exactly the
    right response to corruption: reset, re-dial, retry; NEVER unpickle
    the garbled bytes."""


# test/chaos hook (docs/ROBUSTNESS.md "Integrity"): a callable
# ``bytes -> bytes`` applied to every received payload BEFORE the CRC
# check, simulating corruption on the wire so detection — not
# injection — is what gets exercised.  Process-global by design: the
# chaos harness corrupts every connection the process reads.
_wire_corruptor = None


def install_wire_corruptor(fn):
    """Install (or with None, remove) the receive-path corruptor;
    returns the previous hook so tests can restore it."""
    global _wire_corruptor
    prev = _wire_corruptor
    _wire_corruptor = fn
    return prev


def send_frame(sock: socket.socket, obj, lock: threading.Lock) -> int:
    """Pickle ``obj`` and write one CRC-stamped length-prefixed frame.
    ``lock`` serializes concurrent writers (responses from the waiter
    pool interleave with reader-thread error replies).  Returns the
    total bytes written (header + payload) so callers can meter
    bytes-on-wire per tenant (docs/SERVING.md "Tenants")."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with lock:
        sock.sendall(_HDR.pack(len(data), zlib.crc32(data)) + data)
    return _HDR.size + len(data)


def recv_frame(sock: socket.socket):
    """Read and verify one frame; raises :class:`WireCorruptionError`
    on an oversized declared length or a CRC mismatch, plain
    ConnectionError on EOF / mid-frame truncation.  The payload is
    only unpickled after its checksum passes."""
    obj, _n = recv_frame_sized(sock)
    return obj


def recv_frame_sized(sock: socket.socket):
    """Like :func:`recv_frame` but returns ``(obj, nbytes)`` where
    ``nbytes`` counts header + payload as received — the server side
    uses it to attribute request bytes to the submitting tenant."""
    head = _recv_exact(sock, _HDR.size)
    n, crc = _HDR.unpack(head)
    if n > _MAX_FRAME:
        profiling.counter_inc('integrity.wire_checksum_fail')
        raise WireCorruptionError(
            f'frame of {n} bytes exceeds wire bound '
            f'({_MAX_FRAME}): header corrupt or stream desynced')
    data = _recv_exact(sock, n)
    if _wire_corruptor is not None:
        data = _wire_corruptor(bytes(data))
    if zlib.crc32(data) != crc:
        profiling.counter_inc('integrity.wire_checksum_fail')
        raise WireCorruptionError(
            f'frame CRC mismatch ({n} bytes): payload corrupted on '
            f'the wire')
    return pickle.loads(data), _HDR.size + n


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, read into one preallocated buffer: each read
    fills the next stretch in place, so a frame costs one pass over its
    bytes however many reads it takes."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError('connection closed mid-frame')
        got += k
    return buf


def _tensor_leaves(obj, path: str = '$') -> list:
    """Paths of the torch tensors inside a result (dicts, lists and
    tuples walked); empty for host data."""
    if isinstance(obj, torch.Tensor):
        return [path]
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _tensor_leaves(v, f'{path}.{k}')]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _tensor_leaves(v, f'{path}[{i}]')]
    return []


def _picklable_error(exc: BaseException) -> BaseException:
    """The error as it will cross the wire: the exception itself when
    it pickle-round-trips, else a RuntimeError carrying its type name
    (still infrastructure-class — an unpicklable error is by
    construction not one of the typed program-class failures, which
    all round-trip; tests pin FaultError/ProgramValidationError)."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f'{type(exc).__name__}: {exc}')


class ReplicaServer:
    """Serves one :class:`ExecutionService` over the fleet wire.

    ``on_shutdown`` (optional) runs when a ``shutdown`` op arrives —
    the replica main loop uses it to exit.  ``close()`` stops
    accepting, closes every connection and joins every wire thread; it
    does NOT shut the service down (the owner does).
    """

    def __init__(self, svc, host: str = '127.0.0.1', port: int = 0,
                 max_waiters: int = 32, on_shutdown=None,
                 flight_tail: int = 32):
        self._svc = svc
        self._on_shutdown = on_shutdown
        self._flight_tail = int(flight_tail)
        self._closing = False
        self._conns = set()
        self._conn_threads = []
        self._conns_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_waiters,
            thread_name_prefix=f'{WIRE_THREAD_PREFIX}-wait')
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f'{WIRE_THREAD_PREFIX}-accept', daemon=True)
        self._accept_thread.start()

    # -- accept / per-connection ----------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                     # closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.add(conn)
                t = threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name=f'{WIRE_THREAD_PREFIX}-conn', daemon=True)
                self._conn_threads = [c for c in self._conn_threads
                                      if c.is_alive()] + [t]
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        try:
            while True:
                (req_id, op, payload), nbytes = recv_frame_sized(conn)
                self._dispatch(conn, wlock, req_id, op, payload,
                               nbytes)
        except (ConnectionError, OSError, EOFError,
                pickle.UnpicklingError):
            pass                           # router went away
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, wlock, req_id, op, payload,
                  nbytes: int = 0) -> None:
        try:
            if op in ('submit', 'submit_source', 'submit_rounds'):
                t_recv = time.monotonic()
                # request-frame bytes bill to the submitting tenant
                # (docs/SERVING.md "Tenants"); response bytes are
                # metered when the resolve reply is sent
                tenant = payload.get('tenant')
                self._svc.meter_wire(tenant, nbytes)
                # `_trace` = the router's sampling decision for this
                # request: open a forced replica-side context so the
                # spans recorded here ship back on the resolve reply
                trace_id = payload.pop('_trace', None)
                # `_crc` = the router's submit-time program digest
                # (docs/ROBUSTNESS.md "Integrity"): verify the decoded
                # program content-matches what the caller submitted —
                # a frame CRC covers the wire, this covers the
                # pickle/unpickle round trip and anything between
                # digest and send.  Its presence also asks for a
                # result-stat digest on the resolve reply.
                want_crc = payload.pop('_crc', None)
                if want_crc is not None \
                        and payload.get('mp') is not None:
                    from ..integrity import (IntegrityError,
                                             program_digest)
                    got_crc = program_digest(payload['mp'])
                    if got_crc != want_crc:
                        profiling.counter_inc(
                            'integrity.wire_checksum_fail')
                        raise IntegrityError(
                            f'submitted program digest mismatch '
                            f'(want {want_crc:#010x}, decoded '
                            f'{got_crc:#010x}): corrupted in transit')
                kw = dict(payload)
                if trace_id is not None:
                    kw['_handle'] = self._svc.traced_handle(
                        int(trace_id))
                if op == 'submit':
                    handle = self._svc.submit(**kw)
                elif op == 'submit_rounds':
                    # stream chunk: same resolve-time reply path, so
                    # every chunk's result ships as one incremental
                    # frame (docs/SERVING.md "Streaming sessions")
                    handle = self._svc.submit_rounds(**kw)
                else:
                    handle = self._svc.submit_source(**kw)
                self._pool.submit(self._send_on_resolve, conn, wlock,
                                  req_id, handle, t_recv,
                                  want_crc is not None, tenant)
                return
            if op == 'close_stream':
                self._reply(conn, wlock, req_id, True, {
                    'closed': self._svc.close_stream(
                        int(payload['sid']))})
                return
            if op == 'stats':
                self._reply(conn, wlock, req_id, True,
                            self._svc.stats())
                return
            if op == 'ping':
                self._reply(conn, wlock, req_id, True,
                            {'pong': True, 'mono': time.monotonic()})
                return
            if op == 'gossip':
                # one frame = heartbeat + clock probe + flight digest:
                # the router re-arms liveness, feeds its offset
                # estimator, and caches the event tail for the
                # federated post-mortem (docs/OBSERVABILITY.md)
                fl = self._svc.flight_recorder
                self._reply(conn, wlock, req_id, True, {
                    'stats': self._svc.stats(),
                    'mono': time.monotonic(),
                    'flight': {'recorded': fl.recorded,
                               'dropped': fl.dropped,
                               'counts': fl.counts(),
                               'tail': fl.events()[-self._flight_tail:]},
                })
                return
            if op == 'fleet-metrics':
                self._reply(conn, wlock, req_id, True, {
                    'mono': time.monotonic(),
                    'metrics': profiling.registry().snapshot()})
                return
            if op == 'flight':
                doc = self._svc.flight_recorder.to_json()
                doc['mono'] = time.monotonic()
                self._reply(conn, wlock, req_id, True, doc)
                return
            if op == 'shutdown':
                self._reply(conn, wlock, req_id, True, {'bye': True})
                if self._on_shutdown is not None:
                    self._on_shutdown()
                return
            raise ValueError(f'unknown wire op {op!r}')
        except BaseException as exc:       # noqa: BLE001 - typed reply
            self._reply(conn, wlock, req_id, False,
                        _picklable_error(exc))

    def _send_on_resolve(self, conn, wlock, req_id, handle,
                         t_recv: float = None,
                         want_digest: bool = False,
                         tenant: str = None) -> None:
        # blocks until the service resolves the handle: shutdown
        # force-fails every unresolved handle, so this always returns
        try:
            exc = handle.exception(timeout=None)
        except BaseException as exc2:      # noqa: BLE001
            exc = exc2
        try:
            if exc is None:
                result = handle.result()
                leaves = _tensor_leaves(result)
                if leaves:
                    exc = TypeError(
                        f'a served result crosses the wire as host data; '
                        f'{leaves[:4]} hold torch tensors')
            if exc is None:
                if want_digest:
                    # stamp the result-stat digest before any other
                    # wrapping (innermost: the router unwraps the
                    # trace envelope first, then verifies this) so the
                    # digest covers exactly the stat block the tenant
                    # would receive
                    from ..integrity import stats_digest
                    result = {'__icrc__': stats_digest(result),
                              'result': result}
                if handle._trace is not None:
                    # piggyback the replica-side spans (replica-clock
                    # times; the two mono stamps bound the server-side
                    # window so the router can price the wire hop)
                    result = {'__trace__': {
                        'spans': handle.trace(),
                        'mono_recv': t_recv,
                        'mono_send': time.monotonic()},
                        'result': result}
                n = self._reply(conn, wlock, req_id, True, result)
            else:
                n = self._reply(conn, wlock, req_id, False,
                                _picklable_error(exc))
            # response bytes bill to the same tenant as the request
            self._svc.meter_wire(tenant, n)
        except (ConnectionError, OSError):
            pass                           # router gone: drop response

    @staticmethod
    def _reply(conn, wlock, req_id, ok, payload) -> int:
        return send_frame(conn, (req_id, ok, payload), wlock)

    def close(self) -> None:
        self._closing = True
        try:
            # shutdown() wakes a concurrently-blocked accept() (close()
            # alone does not on Linux), so the accept thread always
            # joins instead of outliving the server
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._pool.shutdown(wait=True)
        self._accept_thread.join(timeout=5.0)
        # each connection's reader ends once its socket is shut down
        with self._conns_lock:
            readers = list(self._conn_threads)
        for t in readers:
            if t is not threading.current_thread():
                t.join(timeout=5.0)


class ReplicaClient:
    """Router-side end of one replica connection.

    ``call_async(op, payload, on_done)`` sends a frame and returns its
    request id; ``on_done(ok, payload)`` fires from the reader thread
    when the response lands.  ``forget(req_id)`` drops a pending
    callback — the router's failover path uses it so a straggler
    response from a replica that was declared dead (and whose request
    was retried elsewhere) is discarded, the wire-level mirror of the
    handle's stale-attempt-token rule.  When the connection dies, every
    pending callback fails with :class:`ReplicaLostError` and
    ``on_lost(exc)`` fires exactly once.
    """

    def __init__(self, address, *, connect_timeout_s: float = 10.0,
                 on_lost=None):
        self.address = tuple(address)
        self._on_lost = on_lost
        self._sock = socket.create_connection(
            self.address, timeout=connect_timeout_s)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: dict = {}           # req_id -> on_done
        self._ids = itertools.count(1)
        self._lost = None                  # the ReplicaLostError, once
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f'{WIRE_THREAD_PREFIX}-client', daemon=True)
        self._reader.start()

    @property
    def alive(self) -> bool:
        return self._lost is None

    def call_async(self, op: str, payload, on_done) -> int:
        with self._plock:
            if self._lost is not None:
                raise ReplicaLostError(
                    f'replica {self.address} lost: {self._lost}')
            req_id = next(self._ids)
            self._pending[req_id] = on_done
        try:
            send_frame(self._sock, (req_id, op, payload), self._wlock)
        except (OSError, ConnectionError) as exc:
            self._fail_all(exc)
            raise ReplicaLostError(
                f'replica {self.address} lost: {exc}') from exc
        return req_id

    def call(self, op: str, payload=None, timeout_s: float = 30.0):
        """Synchronous round trip; raises the remote error, or
        :class:`ReplicaLostError`/:class:`TimeoutError`."""
        ev = threading.Event()
        box = {}

        def done(ok, resp):
            box['ok'], box['resp'] = ok, resp
            ev.set()

        req_id = self.call_async(op, payload or {}, done)
        if not ev.wait(timeout_s):
            self.forget(req_id)
            raise TimeoutError(
                f'{op} to replica {self.address} timed out '
                f'({timeout_s}s)')
        if not box['ok']:
            raise box['resp']
        return box['resp']

    def forget(self, req_id: int) -> bool:
        """Drop the pending callback; True when it was still pending
        (a response arriving later is silently discarded)."""
        with self._plock:
            return self._pending.pop(req_id, None) is not None

    def _read_loop(self) -> None:
        try:
            while True:
                req_id, ok, payload = recv_frame(self._sock)
                with self._plock:
                    on_done = self._pending.pop(req_id, None)
                if on_done is not None:
                    on_done(ok, payload)
        except (ConnectionError, OSError, EOFError,
                pickle.UnpicklingError) as exc:
            self._fail_all(exc)

    def _fail_all(self, cause) -> None:
        with self._plock:
            if self._lost is not None:
                return
            self._lost = cause
            pending = list(self._pending.items())
            self._pending.clear()
        err = ReplicaLostError(
            f'replica {self.address} lost: {cause}')
        for _req_id, on_done in pending:
            try:
                on_done(False, err)
            except Exception:              # noqa: BLE001
                pass                       # callbacks must not kill IO
        if self._on_lost is not None:
            cb, self._on_lost = self._on_lost, None
            try:
                cb(err)
            except Exception:              # noqa: BLE001
                pass

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)
