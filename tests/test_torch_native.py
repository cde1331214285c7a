"""The port's native codec (``native/``) against the port's Python
codec and the JAX package's native codec.

The codec builds on this host (``g++``), so ``available()`` must hold:
the native path is what these tests check, not the fallback.  Decode is
bit-exact on the random command mix of tests/test_native.py; encode
equals bytes built with ``isa.pulse_cmd``; a bad length and an unknown
opcode raise JAX's ``ValueError``; a library older than its source is
rebuilt.
"""

import os

import numpy as np
import pytest

from distributed_processor_tpu import native as jnative

from distributed_processor_tpu_torch import isa, native

from test_native import _random_cmds


def test_available():
    assert native.available()
    assert native.get_lib() is native.get_lib()
    assert os.path.dirname(native.library_path()) == native.BUILD


@pytest.mark.parametrize('seed', range(3))
def test_decode_bit_exact(seed):
    buf = isa.cmds_to_bytes(_random_cmds(np.random.default_rng(seed)))
    nat = isa.decode_soa(buf, use_native=True)
    py = isa.decode_soa(buf, use_native=False)
    fields = native.decode_soa_fields(buf)
    jfields = jnative.decode_soa_fields(buf)
    assert fields.dtype == np.int32 and fields.shape == (
        native.N_FIELDS, len(buf) // native.CMD_BYTES)
    np.testing.assert_array_equal(fields, jfields)
    for i, f in enumerate(isa.SOA_FIELDS):
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f),
                                      err_msg=f)
        np.testing.assert_array_equal(fields[i], getattr(py, f), err_msg=f)


def test_encode_matches_pulse_cmd():
    rng = np.random.default_rng(1)
    n = 100
    t = rng.integers(0, 1 << 32, n)
    env = rng.integers(0, 1 << 24, n)
    ph = rng.integers(0, 1 << 17, n)
    fr = rng.integers(0, 1 << 9, n)
    am = rng.integers(0, 1 << 16, n)
    cf = rng.integers(0, 1 << 4, n)
    args = (np.asarray(t, np.uint32).view(np.int32), env, ph, fr, am, cf)
    got = native.encode_pulse_batch(*args)
    want = isa.cmds_to_bytes([
        isa.pulse_cmd(freq_word=int(fr[i]), phase_word=int(ph[i]),
                      amp_word=int(am[i]), env_word=int(env[i]),
                      cfg_word=int(cf[i]), cmd_time=int(t[i]))
        for i in range(n)])
    assert got == want
    assert got == jnative.encode_pulse_batch(*args)


def test_errors_equal_jax():
    for fn in (native.decode_soa_fields, jnative.decode_soa_fields):
        with pytest.raises(ValueError, match='multiple of 16'):
            fn(b'\0' * 17)
    bad = bytearray(isa.cmds_to_bytes([isa.done_cmd(), isa.done_cmd()]))
    bad[-1] = 0xff                       # opcode bits of instruction 1
    msgs = []
    for fn in (native.decode_soa_fields, jnative.decode_soa_fields):
        with pytest.raises(ValueError, match='unknown opcode') as e:
            fn(bytes(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == 'instruction 1: unknown opcode'
    with pytest.raises(ValueError, match='equal length'):
        native.encode_pulse_batch([1, 2], [1], [1], [1], [1], [1])


def test_rebuilds_when_stale(tmp_path):
    """A fresh library is kept; one older than the source is rebuilt;
    a build leaves no temporary file behind."""
    lib = native.build(str(tmp_path))
    assert lib == native.library_path(str(tmp_path))
    assert not native.stale(lib)
    mtime = os.path.getmtime(lib)
    assert native.build(str(tmp_path)) == lib
    assert os.path.getmtime(lib) == mtime
    old = os.path.getmtime(native.SRC) - 100
    os.utime(lib, (old, old))
    assert native.stale(lib)
    native.build(str(tmp_path))
    assert not native.stale(lib)
    assert os.path.getmtime(lib) > old
    assert sorted(os.listdir(tmp_path)) == ['libsoacodec.so']
