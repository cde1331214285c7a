"""End-to-end integrity fabric: content digests and typed SDC errors.

The stack's value proposition is bit-exact execution, yet every trust
boundary it crosses — pickled wire frames, shared on-disk warm tiers,
device memory — can silently flip a bit and nothing downstream would
notice: a corrupted frame unpickles cleanly into wrong numbers, a
corrupted store entry loads as a valid-looking MachineProgram, a
degrading device returns plausible garbage.  This module is the shared
vocabulary every detection point uses (docs/ROBUSTNESS.md
"Integrity"):

* :func:`content_crc32` / :func:`program_digest` / :func:`stats_digest`
  — cheap content checksums over raw buffers.  The algorithm is
  ``zlib.crc32`` (CRC-32/ISO-HDLC): it is C-speed, in the stdlib, and
  identical in every process that shares this codebase.  CRC32C
  (Castagnoli) would be marginally stronger against some burst
  patterns but needs either a hardware instruction binding or a
  third-party package — for a *detection* checksum over kilobyte-scale
  frames the ISO polynomial's guarantees are equivalent in practice,
  so we stay dependency-free.
* :func:`diff_stats` — the per-stat comparison (shape, dtype-exact
  values, fault words included) the audit sampler and scrubber use to
  judge two executions of the same program.
* :class:`IntegrityError` — the typed failure every detection point
  raises.  Deliberately a plain RuntimeError subclass so
  :func:`~.sim.interpreter.is_infrastructure_error` classifies it
  retryable: detected corruption is an infrastructure fault (retry on
  a different engine/device/replica re-derives the truth), never a
  program-class error.
* :func:`flip_bit` — the seeded single-bit corrupter the chaos harness
  and tests inject with, kept here so injection and detection agree on
  what "one flipped bit" means.

Everything here is pure computation over host arrays, with no I/O, so
the compile cache can import it without cycles.  A torch tensor, on any
device, is copied to the host first: its digest is its numpy copy's.
A program digest agrees with the JAX package's for the same source (the
decoded arrays are the same bytes); a stats digest is a check within
one package only, since the port's stat dtypes differ from the JAX
package's where they differ by design (``fault_shot_counts`` is int64
here), and a differing dtype is a differing digest.
"""

from __future__ import annotations

import zlib
from dataclasses import fields as _dc_fields

import numpy as np

from .utils.results import host_array


class IntegrityError(RuntimeError):
    """Silent data corruption was DETECTED at a trust boundary (wire
    frame digest, store digest, differential audit, scrubber).  A
    plain RuntimeError on purpose:
    :func:`~.sim.interpreter.is_infrastructure_error` classifies it
    infrastructure-class, so the serve retry/breaker machinery and the
    fleet router both re-execute instead of surfacing tainted bits —
    and :func:`~.serve.router.is_terminal_error` leaves it retryable
    across replicas."""


def content_crc32(chunks) -> int:
    """CRC32 folded over an iterable of ``bytes`` chunks."""
    crc = 0
    for chunk in chunks:
        crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _array_chunks(name: str, value):
    """The canonical byte stream for one named array: name, dtype,
    shape, then the C-contiguous buffer — so a digest mismatch means
    the *content* differs, not the memory layout."""
    a = np.ascontiguousarray(host_array(value))
    yield name.encode('utf-8')
    yield str(a.dtype).encode('ascii')
    yield np.asarray(a.shape, np.int64).tobytes()
    yield a.tobytes()


def program_digest(mp) -> int:
    """Content digest of a :class:`~.decoder.MachineProgram`: every
    SoA field array plus the pulse element/duration side tables — the
    exact buffers the interpreter gathers from, so any bit that could
    change execution changes the digest.  Computed at submit, verified
    where the program crosses a trust boundary (wire receive, store
    load)."""
    chunks = []
    for f in _dc_fields(mp.soa):
        chunks.extend(_array_chunks(f.name, getattr(mp.soa, f.name)))
    chunks.extend(_array_chunks('p_elem', mp.p_elem))
    chunks.extend(_array_chunks('p_dur', mp.p_dur))
    return content_crc32(chunks)


def stats_digest(stats: dict) -> int:
    """Content digest of a per-request result stat block (the dict
    ``simulate_batch`` returns: meas, regs, fault words, ...), key
    order independent."""
    chunks = []
    for k in sorted(stats):
        chunks.extend(_array_chunks(k, stats[k]))
    return content_crc32(chunks)


def diff_stats(got: dict, want: dict) -> list:
    """Stat keys on which two executions of the same program disagree
    (missing key, shape skew, or any value difference — fault words
    included).  Empty list = bit-identical."""
    bad = []
    for k in sorted(set(got) | set(want)):
        if k not in got or k not in want:
            bad.append(k)
            continue
        a = host_array(got[k])
        b = host_array(want[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(k)
    return bad


def flip_bit(arr, *, bit: int = 0, index: int = 0):
    """A copy of ``arr`` with exactly one bit flipped in its flattened
    element ``index`` — the canonical single-event-upset model the
    chaos ``corrupt`` action and the integrity tests inject.  Only
    integer arrays qualify (every interpreter stat is int32/int64);
    raises ValueError otherwise so a silent no-op corruption can never
    make a detection test vacuously pass."""
    a = np.array(host_array(arr), copy=True)
    if a.dtype.kind not in 'iu' or a.size == 0:
        raise ValueError(
            f'flip_bit needs a non-empty integer array, got '
            f'dtype={a.dtype} size={a.size}')
    flat = a.reshape(-1)
    i = index % flat.size
    flat[i] = flat[i] ^ np.asarray(
        1 << (bit % (8 * a.dtype.itemsize)), a.dtype)
    return a


def flip_payload_bit(data: bytes, *, bit_index: int = 0) -> bytes:
    """``data`` with one bit flipped (byte-granular index wraps) — the
    wire-frame corruption model for the transport chaos hook and the
    raw-socket regression tests."""
    if not data:
        return data
    buf = bytearray(data)
    i = (bit_index // 8) % len(buf)
    buf[i] ^= 1 << (bit_index % 8)
    return bytes(buf)
