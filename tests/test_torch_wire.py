"""The port's fleet wire (``serve/transport.py``) against the JAX package.

Frames are the JAX package's: a ``>II`` header (payload length, CRC32)
and a highest-protocol pickle, so the two packages write the same bytes
for the same plain object.  A garbled frame or a length past the wire
bound raises :class:`WireCorruptionError`; a frame far larger than the
socket buffer round-trips (the port reads a frame into one preallocated
buffer); the program-class errors pickle round-trip with their counts;
a result that still holds a torch tensor never crosses the wire.  The
server and client run in-process here over a loopback socket.
"""

import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from distributed_processor_tpu.decoder import \
    ProgramValidationError as JValidationError
from distributed_processor_tpu.serve import transport as jwire
from distributed_processor_tpu.sim.interpreter import \
    FaultError as JFaultError

from distributed_processor_tpu_torch.decoder import ProgramValidationError
from distributed_processor_tpu_torch.integrity import flip_payload_bit
from distributed_processor_tpu_torch.serve import (ExecutionService,
                                                   ReplicaClient,
                                                   ReplicaLostError,
                                                   ReplicaServer,
                                                   WireCorruptionError,
                                                   is_terminal_error)
from distributed_processor_tpu_torch.serve import transport as wire
from distributed_processor_tpu_torch.serve.benchmark import (_solo_refs,
                                                             _workload)
from distributed_processor_tpu_torch.sim.interpreter import FaultError
from distributed_processor_tpu_torch.utils import profiling as t_profiling

T = 60           # every wire wait is bounded


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def _read_all(sock, n):
    buf = b''
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, 'peer closed early'
        buf += chunk
    return buf


PLAIN = (7, 'submit', {'meas_bits': np.arange(24, dtype=np.int32)
                       .reshape(2, 3, 4),
                       'shots': None, 'tenant': 'alice',
                       'cfg': {'max_meas': 2, 'rates': [0.5, 1.25]},
                       'ids': (1, 2, 3)})


def test_send_frame_writes_jax_bytes():
    """The same plain object is the same frame, byte for byte, from
    either package: the header, the CRC and the pickle."""
    frames = []
    for mod in (jwire, wire):
        a, b = socket.socketpair()
        try:
            n = mod.send_frame(a, PLAIN, threading.Lock())
            frames.append(_read_all(b, n))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    n, crc = struct.unpack('>II', frames[1][:8])
    assert n == len(frames[1]) - 8
    assert crc == __import__('zlib').crc32(frames[1][8:])


class _Capture:
    """A socket that keeps every ``sendall``."""

    def __init__(self):
        self.writes = []

    def sendall(self, data):
        self.writes.append(bytes(data))


@pytest.mark.parametrize('obj', [
    (3, True, {'rec': np.arange(1 << 18, dtype=np.int32).reshape(-1, 8),
               'bits': np.ones((4096, 8, 2), np.int32),
               'note': 'x' * 70000, 'n': 5}),
    (9, False, ValueError('unknown wire op')),
], ids=['result', 'error'])
def test_send_frame_in_pieces_writes_jax_bytes(obj):
    """A frame of arrays past the one-write size is pickled piece by
    piece (several writes) and is still JAX's frame byte for byte; a
    small one goes out in one write."""
    frames = []
    for mod in (jwire, wire):
        cap = _Capture()
        n = mod.send_frame(cap, obj, threading.Lock())
        frames.append((b''.join(cap.writes), len(cap.writes)))
        assert n == len(frames[-1][0])
    data, writes = frames[1]
    assert data == frames[0][0]
    assert (writes > 1) == (len(data) > 8 + (1 << 16))
    got = wire.recv_frame(_Replay(data))
    assert got[:2] == obj[:2]
    if isinstance(obj[2], dict):
        for k in ('rec', 'bits'):
            np.testing.assert_array_equal(got[2][k], obj[2][k])


class _Replay:
    """A socket that replays bytes to ``recv_into``."""

    def __init__(self, data):
        self.data = memoryview(data)

    def recv_into(self, view, n):
        k = min(n, len(self.data), 1 << 20)
        view[:k] = self.data[:k]
        self.data = self.data[k:]
        return k


def _longest_hold(fn) -> float:
    """The longest stretch (s) a busy probe thread went without the
    interpreter lock while ``fn`` ran: the longest single hold of the
    lock by ``fn``'s threads (plus the host's scheduling noise)."""
    stop, gap = threading.Event(), [0.0]

    def probe():
        last = time.perf_counter()
        while not stop.is_set():
            now = time.perf_counter()
            gap[0] = max(gap[0], now - last)
            last = now

    th = threading.Thread(target=probe)
    th.start()
    time.sleep(0.02)
    try:
        fn()
    finally:
        stop.set()
        th.join(T)
    return gap[0]


def test_large_frame_never_holds_the_interpreter_lock_long():
    """A 128 MB result frame sent and received over a socket holds the
    interpreter lock at most a third as long as ``pickle.dumps`` +
    ``pickle.loads`` of the same object hold it in one call each: the
    heartbeat threads of a replica and of the router keep running while
    a large frame is pickled, read and unpickled.  Best of two runs
    each, in the same process under the same load."""
    obj = (4, True, {'rec': np.arange(32 << 20, dtype=np.int32)})

    def whole():
        pickle.loads(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def wire_round_trip():
        a, b = socket.socketpair()
        got = {}
        rd = threading.Thread(target=lambda: got.update(
            v=wire.recv_frame(b)))
        rd.start()
        try:
            wire.send_frame(a, obj, threading.Lock())
            rd.join(T)
        finally:
            a.close()
            b.close()
        np.testing.assert_array_equal(got['v'][2]['rec'], obj[2]['rec'])

    ref = min(_longest_hold(whole) for _ in range(2))
    held = min(_longest_hold(wire_round_trip) for _ in range(2))
    assert held * 3 < ref, (held, ref)


@pytest.mark.parametrize('sender,receiver', [(jwire, wire), (wire, jwire)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_frames_cross_packages(sender, receiver):
    a, b = socket.socketpair()
    try:
        n = sender.send_frame(a, PLAIN, threading.Lock())
        obj, got = receiver.recv_frame_sized(b)
    finally:
        a.close()
        b.close()
    assert got == n
    assert obj[:2] == PLAIN[:2]
    np.testing.assert_array_equal(obj[2]['meas_bits'],
                                  PLAIN[2]['meas_bits'])
    assert {k: v for k, v in obj[2].items() if k != 'meas_bits'} == \
        {k: v for k, v in PLAIN[2].items() if k != 'meas_bits'}


def test_corrupted_frame_raises_wire_corruption():
    """A flipped payload bit fails the CRC before anything is
    unpickled, and counts the integrity metric."""
    a, b = socket.socketpair()
    prev = wire.install_wire_corruptor(
        lambda data: flip_payload_bit(data, bit_index=77))
    try:
        wire.send_frame(a, PLAIN, threading.Lock())
        before = t_profiling.counter_get('integrity.wire_checksum_fail')
        with pytest.raises(WireCorruptionError, match='CRC mismatch'):
            wire.recv_frame(b)
        assert t_profiling.counter_get(
            'integrity.wire_checksum_fail') == before + 1
    finally:
        wire.install_wire_corruptor(prev)
        a.close()
        b.close()
    assert issubclass(WireCorruptionError, ConnectionError)


def test_length_past_bound_raises_wire_corruption():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack('>II', wire._MAX_FRAME + 1, 0))
        with pytest.raises(WireCorruptionError, match='exceeds wire bound'):
            wire.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert wire._MAX_FRAME == jwire._MAX_FRAME == 1 << 29


def test_truncated_frame_is_connection_error():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack('>II', 100, 0) + b'x' * 40)
        a.close()
        with pytest.raises(ConnectionError, match='mid-frame'):
            wire.recv_frame(b)
    finally:
        b.close()


def test_large_frame_round_trips():
    """A 64 MB frame, many times the socket buffer, arrives whole: the
    receiver fills one preallocated buffer, so the read is one pass
    over the bytes."""
    big = np.random.default_rng(0).integers(
        0, 2 ** 31, size=16 << 20, dtype=np.int32)     # 64 MiB
    a, b = socket.socketpair()
    sent = {}

    def send():
        sent['n'] = wire.send_frame(a, {'bits': big}, threading.Lock())

    t = threading.Thread(target=send)
    try:
        t0 = time.perf_counter()
        t.start()
        obj, n = wire.recv_frame_sized(b)
        dt = time.perf_counter() - t0
        t.join(T)
    finally:
        a.close()
        b.close()
    assert not t.is_alive()
    assert n == sent['n'] > big.nbytes
    np.testing.assert_array_equal(obj['bits'], big)
    assert dt < 30.0


def test_recv_exact_counts_reads():
    """The receive loop asks the socket for exactly the bytes still
    missing, into the right place of the buffer."""
    class Dribble:
        def __init__(self, data, step):
            self.data, self.step, self.calls = data, step, 0

        def recv_into(self, view, n):
            self.calls += 1
            k = min(n, self.step, len(self.data))
            view[:k] = self.data[:k]
            self.data = self.data[k:]
            return k

    data = bytes(range(256)) * 40
    sock = Dribble(data, 1000)
    assert bytes(wire._recv_exact(sock, len(data))) == data
    assert sock.calls == -(-len(data) // 1000)


def test_typed_errors_pickle_roundtrip():
    """The two program-class errors round-trip with their payloads, as
    JAX's do: FaultError keeps its per-code counts."""
    counts = [2, 0, 1, 0, 0, 0]
    fe = pickle.loads(pickle.dumps(FaultError(counts)))
    jfe = pickle.loads(pickle.dumps(JFaultError(counts)))
    assert isinstance(fe, FaultError)
    np.testing.assert_array_equal(fe.counts, counts)
    np.testing.assert_array_equal(fe.counts, jfe.counts)
    assert str(fe) == str(jfe)
    errs = [('sync_mismatch', None, None, 'sync sets differ')]
    pe = pickle.loads(pickle.dumps(ProgramValidationError(errs)))
    jpe = pickle.loads(pickle.dumps(JValidationError(errs)))
    assert isinstance(pe, ProgramValidationError)
    assert pe.errors == jpe.errors == errs
    assert pe.codes == jpe.codes == {'sync_mismatch'}
    assert str(pe) == str(jpe)
    assert wire._picklable_error(fe) is fe

    class Local(Exception):      # locally defined: unpicklable
        pass

    wired = wire._picklable_error(Local('boom'))
    assert isinstance(wired, RuntimeError)
    assert 'Local' in str(wired) and 'boom' in str(wired)
    assert not is_terminal_error(wired)


def test_tensor_leaves():
    assert wire._tensor_leaves({'a': np.zeros(2), 'b': [1, (2, 'x')]}) == []
    assert wire._tensor_leaves(
        {'a': torch.zeros(2), 'b': [np.zeros(1), (torch.ones(1),)]}) == \
        ['$.a', '$.b[1][0]']


# ---------------------------------------------------------------------------
# server and client in this process, over a loopback socket
# ---------------------------------------------------------------------------

@pytest.fixture
def served():
    """A CPU service behind a ReplicaServer and a client on it; every
    thread joined at teardown."""
    svc = ExecutionService(devices=['cpu'], max_batch_programs=4,
                           max_wait_ms=5.0)
    server = ReplicaServer(svc)
    client = ReplicaClient(server.address)
    try:
        yield svc, server, client
    finally:
        client.close()
        server.close()
        svc.shutdown(timeout=T)


def test_server_round_trip_equals_solo(served):
    _svc, _server, client = served
    mps, bits, cfg = _workload(3, 2, 2, 4, 5)
    refs = _solo_refs(mps, bits, cfg, 'cpu')
    for mp, b, want in zip(mps, bits, refs):
        got = client.call('submit', dict(mp=mp, meas_bits=b, cfg=cfg),
                          timeout_s=T)
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], (np.ndarray, np.generic)), k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pong = client.call('ping', timeout_s=T)
    assert pong['pong'] is True and isinstance(pong['mono'], float)
    g = client.call('gossip', timeout_s=T)
    assert {'stats', 'mono', 'flight'} <= set(g)
    assert g['stats']['completed'] == len(mps)
    assert {'recorded', 'dropped', 'counts', 'tail'} <= set(g['flight'])
    m = client.call('fleet-metrics', timeout_s=T)
    assert m['metrics']['counters']['serve.submitted'] == len(mps)


def test_server_sends_typed_errors(served):
    _svc, _server, client = served
    with pytest.raises(ValueError, match='unknown wire op'):
        client.call('nope', timeout_s=T)
    mps, bits, cfg = _workload(1, 2, 2, 4, 5)
    with pytest.raises(ValueError):
        client.call('submit', dict(mp=mps[0], meas_bits=bits[0][0],
                                   cfg=cfg), timeout_s=T)


def test_server_refuses_tensor_results(served):
    """A result holding a torch tensor is answered with a typed
    TypeError instead of a frame that would carry the tensor."""
    svc, _server, client = served

    class Handle:
        _trace = None

        def exception(self, timeout=None):
            return None

        def result(self, timeout=None):
            return {'steps': torch.tensor(3), 'err': np.zeros(2)}

    svc.submit = lambda **kw: Handle()
    mps, bits, cfg = _workload(1, 2, 2, 4, 5)
    with pytest.raises(TypeError, match=r"\$\.steps"):
        client.call('submit', dict(mp=mps[0], meas_bits=bits[0], cfg=cfg),
                    timeout_s=T)


def test_client_loss_fails_pending(served):
    """Closing the server fails the client's pending calls with
    ReplicaLostError and fires ``on_lost`` once."""
    _svc, server, _client = served
    lost = []
    c = ReplicaClient(server.address, on_lost=lost.append)
    ev = threading.Event()
    box = {}

    def done(ok, resp):
        box['ok'], box['resp'] = ok, resp
        ev.set()

    # a gossip answered before close, then loss on a server close
    c.call('ping', timeout_s=T)
    server.close()
    deadline = time.monotonic() + T
    while c.alive and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not c.alive
    with pytest.raises(ReplicaLostError):
        c.call_async('ping', {}, done)
    assert len(lost) == 1 and isinstance(lost[0], ReplicaLostError)
    c.close()
