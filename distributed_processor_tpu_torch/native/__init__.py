"""Native (C++) host-runtime components, loaded via ctypes.

The command-buffer codec at the FPGA-BRAM boundary (``soa_codec.cpp``),
the JAX package's ``native/`` ported as is: compiled on first use with
the system toolchain (``g++ -O2 -shared -fPIC``) into
``distributed_processor_tpu_torch/_build/`` (git-ignored), beside the
CUDA kernels' builds, and rebuilt when the source is newer than the
library.  Each process builds at most once, under a lock, into a
temporary file renamed into place, so parallel processes never load a
torn library.  Every entry point has a pure-Python fallback (the
:mod:`..isa` codec) for a host with no C++ toolchain; bit-exactness
between the two is covered by tests/test_torch_native.py.  This is host
code: the codec runs on the CPU whatever device the program runs on.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, 'soa_codec.cpp')
BUILD = os.path.join(os.path.dirname(_HERE), '_build')

_lock = threading.Lock()
_lib = None
_tried = False

N_FIELDS = 19
CMD_BYTES = 16


def library_path(build_dir: str = BUILD) -> str:
    return os.path.join(build_dir, 'libsoacodec.so')


def stale(lib: str) -> bool:
    """True when ``lib`` is missing or older than the source."""
    return not os.path.exists(lib) \
        or os.path.getmtime(lib) < os.path.getmtime(SRC)


def build(build_dir: str = BUILD, force: bool = False) -> str:
    """Compile the codec into ``build_dir`` unless its library is fresh
    (or ``force``); returns the library path.  Raises ``OSError`` or
    ``subprocess.SubprocessError`` when the toolchain is missing or
    fails."""
    lib = library_path(build_dir)
    if not force and not stale(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=build_dir)
    os.close(fd)
    try:
        subprocess.run(['g++', '-O2', '-shared', '-fPIC', '-o', tmp, SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def get_lib():
    """ctypes handle to the codec library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            try:
                lib = ctypes.CDLL(build())
            except OSError:
                # a library built on another host may not load here
                lib = ctypes.CDLL(build(force=True))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.soa_decode.restype = ctypes.c_int
        lib.soa_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')]
        lib.encode_pulse_batch.restype = None
        lib.encode_pulse_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')] * 6 + [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode_soa_fields(buf: bytes):
    """Decode a command buffer to the ``[N_FIELDS, n]`` int32 array
    (SOA_FIELDS order), or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if len(buf) % CMD_BYTES:
        raise ValueError('command buffer length must be a multiple of 16')
    n = len(buf) // CMD_BYTES
    out = np.zeros((N_FIELDS, n), dtype=np.int32)
    rc = lib.soa_decode(bytes(buf), n, out)
    if rc:
        raise ValueError(f'instruction {rc - 1}: unknown opcode')
    return out


def encode_pulse_batch(cmd_time, env, phase, freq, amp, cfg):
    """Batch-encode full-parameter timed pulse commands -> bytes, or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (cmd_time, env, phase, freq, amp, cfg)]
    n = len(arrs[0])
    if any(len(a) != n for a in arrs):
        raise ValueError('field arrays must have equal length')
    out = np.zeros(n * CMD_BYTES, dtype=np.uint8)
    lib.encode_pulse_batch(arrs[0], arrs[1], arrs[2], arrs[3], arrs[4],
                           arrs[5], n, out)
    return out.tobytes()
