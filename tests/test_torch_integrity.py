"""The port's integrity digests against the JAX package's, on the CPU.

``content_crc32``, ``program_digest`` (of a program each package compiles
from the same source), ``stats_digest`` (of CPU tensors, equal to the
digest of their numpy copies), ``diff_stats``, ``flip_bit`` and
``flip_payload_bit`` give the JAX package's answers on the same inputs;
a corrupted store entry is a counted miss on the port's own registry.
"""

import os
import pickle
import zlib

import numpy as np
import pytest
import torch

from distributed_processor_tpu import integrity as j_int
from distributed_processor_tpu import isa as j_isa
from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu.models import (
    active_reset as j_active_reset, make_default_qchip as j_qchip,
    rb_program as j_rb_program)
from distributed_processor_tpu.pipeline import compile_to_machine as j_compile
from distributed_processor_tpu.sim.interpreter import \
    simulate_batch as j_simulate_batch

import chip_smoke
from distributed_processor_tpu_torch import integrity as t_int
from distributed_processor_tpu_torch import isa as t_isa
from distributed_processor_tpu_torch.compilecache.store import \
    PersistentStore
from distributed_processor_tpu_torch.decoder import \
    machine_program_from_cmds as t_from_cmds
from distributed_processor_tpu_torch.models import (
    active_reset as t_active_reset, make_default_qchip as t_qchip,
    rb_program as t_rb_program)
from distributed_processor_tpu_torch.pipeline import \
    compile_to_machine as t_compile
from distributed_processor_tpu_torch.simulator import Simulator
from distributed_processor_tpu_torch.sim.interpreter import (
    fault_shot_counts, simulate_batch)
from distributed_processor_tpu_torch.utils import profiling as t_profiling

torch.set_num_threads(1)

QUBITS = ['Q0', 'Q1']


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def _mp(from_cmds, isa, salt=0):
    core = [isa.pulse_cmd(amp_word=1000 + 7 * salt + 13 * i, cfg_word=0,
                          env_word=3, cmd_time=10 + 20 * i)
            for i in range(3)] + [isa.done_cmd()]
    return from_cmds([core])


def test_content_crc32_agrees():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 4096):
        chunks = [rng.bytes(n), b'', rng.bytes(n // 2 + 1)]
        assert t_int.content_crc32(chunks) == j_int.content_crc32(chunks)


def test_program_digest_agrees_across_packages():
    """A program digest names the decoded arrays, which both packages'
    compile stacks produce byte for byte: equal for the same source."""
    progs = [j_active_reset(QUBITS) + j_rb_program(QUBITS, 3, seed=s)
             for s in (1, 2)]
    t_progs = [t_active_reset(QUBITS) + t_rb_program(QUBITS, 3, seed=s)
               for s in (1, 2)]
    digests = []
    for jp, tp in zip(progs, t_progs):
        jd = j_int.program_digest(j_compile(jp, j_qchip(2), n_qubits=2))
        td = t_int.program_digest(t_compile(tp, t_qchip(2), n_qubits=2))
        assert td == jd
        digests.append(td)
    assert digests[0] != digests[1]
    src = chip_smoke.qasm_headline_source(8, 12, 1234)
    from distributed_processor_tpu.simulator import Simulator as JSimulator
    assert t_int.program_digest(Simulator(n_qubits=8, device='cpu')
                                .compile(src)) \
        == j_int.program_digest(JSimulator(n_qubits=8).compile(src))
    tmp = _mp(t_from_cmds, t_isa, 1)
    assert t_int.program_digest(tmp) == j_int.program_digest(
        _mp(j_from_cmds, j_isa, 1))
    assert t_int.program_digest(pickle.loads(pickle.dumps(tmp))) \
        == t_int.program_digest(tmp)


def _run_both(seed):
    mp_j = _mp(j_from_cmds, j_isa, seed)
    mp_t = _mp(t_from_cmds, t_isa, seed)
    bits = np.random.default_rng(seed).integers(0, 2, (3, 1, 2)) \
        .astype(np.int32)
    kw = dict(max_steps=80, max_pulses=10, max_meas=2, max_resets=2)
    out_j = {k: np.asarray(v)
             for k, v in j_simulate_batch(mp_j, bits, **kw).items()}
    out_t = simulate_batch(mp_t, bits, device='cpu', **kw)
    return out_j, out_t


def test_stats_digest_of_tensors_is_their_numpy_copy():
    out_j, out_t = _run_both(3)
    host = {k: v.numpy() for k, v in out_t.items()}
    d = t_int.stats_digest(out_t)
    assert d == t_int.stats_digest(host)
    assert d == t_int.stats_digest(dict(reversed(list(out_t.items()))))
    # the same arrays in both packages (every simulate_batch stat has
    # the JAX package's dtype): the same digest
    assert d == j_int.stats_digest(out_j)
    # a stat whose dtype differs by design (the port's fault counts are
    # int64, JAX's int32): same values, another digest
    counts = fault_shot_counts(out_t['fault'])
    assert counts.dtype == torch.int64
    assert t_int.stats_digest({'c': counts}) != t_int.stats_digest(
        {'c': counts.to(torch.int32)})
    bad = dict(out_t, regs=torch.as_tensor(t_int.flip_bit(out_t['regs'],
                                                          bit=3, index=1)))
    assert t_int.stats_digest(bad) != d


def test_diff_stats_agrees():
    out_j, out_t = _run_both(4)
    assert t_int.diff_stats(out_t, out_j) == [] == j_int.diff_stats(out_j,
                                                                    out_j)
    bad_t = dict(out_t, n_pulses=torch.as_tensor(
        t_int.flip_bit(out_t['n_pulses'], bit=0, index=2)))
    bad_j = dict(out_j, n_pulses=j_int.flip_bit(out_j['n_pulses'], bit=0,
                                                index=2))
    del bad_t['steps'], bad_j['steps']
    bad_t['time'] = bad_t['time'][:2]
    bad_j['time'] = bad_j['time'][:2]
    want = j_int.diff_stats(bad_j, out_j)
    assert want == ['n_pulses', 'steps', 'time']
    assert t_int.diff_stats(bad_t, out_t) == want
    assert t_int.diff_stats(bad_t, out_j) == want


@pytest.mark.parametrize('dtype', [np.int32, np.int64, np.uint8, np.int16])
def test_flip_bit_agrees(dtype):
    a = np.arange(12, dtype=dtype).reshape(3, 4)
    for bit, index in ((0, 0), (4, 7), (70, 30), (7, -1)):
        want = j_int.flip_bit(a, bit=bit, index=index)
        for arr in (a, torch.as_tensor(a)):
            got = t_int.flip_bit(arr, bit=bit, index=index)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert int(np.sum(want != a)) == 1


@pytest.mark.parametrize('bad', [np.zeros(3, np.float32),
                                 np.zeros(0, np.int32)],
                         ids=['float', 'empty'])
def test_flip_bit_refuses_the_same(bad):
    with pytest.raises(ValueError) as e_j:
        j_int.flip_bit(bad)
    for arr in (bad, torch.as_tensor(bad)):
        with pytest.raises(ValueError) as e_t:
            t_int.flip_bit(arr)
        assert str(e_t.value) == str(e_j.value)


def test_flip_payload_bit_agrees():
    data = b'integrity'
    for i in (0, 11, 71, 1000):
        assert t_int.flip_payload_bit(data, bit_index=i) \
            == j_int.flip_payload_bit(data, bit_index=i)
    assert t_int.flip_payload_bit(b'') == b''
    assert issubclass(t_int.IntegrityError, RuntimeError)


def test_store_digest_mismatch_is_counted_miss(tmp_path):
    """A store entry whose program bytes changed after it was written is
    a miss that counts ``integrity.store_digest_fail`` on the port's
    registry and removes the entry."""
    store = PersistentStore(str(tmp_path))
    mp = _mp(t_from_cmds, t_isa, 3)
    store.save('k1', 'f' * 16, mp)
    loaded = store.load('k1', 'f' * 16)
    assert t_int.program_digest(loaded) == t_int.program_digest(mp)
    fname = store._fname('k1', 'f' * 16)
    with open(fname, 'rb') as f:
        payload = pickle.loads(zlib.decompress(f.read()))
    payload['mp_pickle'] = t_int.flip_payload_bit(payload['mp_pickle'],
                                                  bit_index=321)
    with open(fname, 'wb') as f:
        f.write(zlib.compress(pickle.dumps(payload)))
    before = t_profiling.counter_get('integrity.store_digest_fail')
    assert store.load('k1', 'f' * 16) is None
    assert t_profiling.counter_get('integrity.store_digest_fail') \
        == before + 1
    assert not os.path.exists(fname)
