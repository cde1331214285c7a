"""Content addressing for the compile front door.

A cache key must name everything that can change the compiled
:class:`~..decoder.MachineProgram` and nothing else, or identical tenant
submissions stop deduplicating (over-keying) / calibration updates serve
stale pulses (under-keying).  The key covers five components:

* **program source** — a dict-instruction list (canonicalized: dict-key
  order, tuples-vs-lists and numpy scalars are normalized away, so two
  tenants building "the same" program with different dict orderings
  collide onto one entry) or raw OpenQASM 3 text (keyed byte-for-byte:
  a cache hit never even parses);
* **qchip calibration epoch** — :meth:`~..qchip.QChip.fingerprint`, a
  stable hash of the frequency table + gate library, so a recalibration
  is a new key (and the old epoch's entries are flushable as a group);
* **FPGAConfig** — every timing constant changes scheduling;
* **CompilerFlags** — resolve/schedule toggles change the IR pipeline;
* **channel geometry** — ``n_qubits``/``pad_to``/the channel-config map
  and the element class decide buffer layout and decode shapes.

The canonical form is a tagged JSON tree (``_canon``) hashed with
sha256; ``KEY_VERSION`` is baked into the digest so a canonicalization
change can never alias old persistent-store entries.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import is_dataclass

KEY_VERSION = 1


def _canon(obj):
    """Recursively convert ``obj`` to a canonical JSON-able tree.

    Dicts become sorted ``['__dict__', [[k, v], ...]]`` pairs (the
    whole point: instruction dicts hash identically regardless of key
    insertion order), tuples/lists are tagged distinctly (a ``('reg',
    0)`` operand must not collide with ``['reg', 0]`` — they are the
    same to the compiler but tagging both ways costs nothing and keeps
    the mapping injective), numpy arrays/scalars go through ``tolist``
    with dtype+shape preserved, dataclasses and plain objects flatten
    to their field dicts, and anything else falls back to ``repr``.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, complex):
        return ['__complex__', float(obj.real), float(obj.imag)]
    if isinstance(obj, dict):
        try:
            # the hot path: homogeneous (string) keys sort natively
            items = sorted(obj.items())
        except TypeError:
            items = sorted(obj.items(),
                           key=lambda kv: json.dumps(_canon(kv[0]),
                                                     sort_keys=True))
        return ['__dict__', [[_canon(k), _canon(v)] for k, v in items]]
    if isinstance(obj, (list, tuple)):
        return ['__tuple__' if isinstance(obj, tuple) else '__list__',
                [_canon(v) for v in obj]]
    if is_dataclass(obj) and not isinstance(obj, type):
        return ['__dataclass__', type(obj).__name__, _canon(vars(obj))]
    if hasattr(obj, 'dtype') and hasattr(obj, 'tolist'):
        # numpy array or scalar, without importing numpy here
        shape = list(getattr(obj, 'shape', ()))
        return ['__ndarray__', str(obj.dtype), shape, _canon(obj.tolist())]
    if hasattr(obj, '__dict__'):
        return ['__object__', type(obj).__name__, _canon(vars(obj))]
    return ['__repr__', repr(obj)]


def canonical_json(obj) -> str:
    """Deterministic JSON encoding of ``_canon(obj)`` (no whitespace,
    sorted containers already canonicalized)."""
    return json.dumps(_canon(obj), separators=(',', ':'))


def canonical_program(program):
    """Canonical form of a program source: QASM3 text keys as raw bytes
    (a warm hit never parses), dict-instruction lists key on the
    order-insensitive canonical tree."""
    if isinstance(program, str):
        return ['qasm3', program]
    return ['dict', _canon(list(program))]


def content_key(program, qchip, *, channel_configs=None, fpga_config=None,
                compiler_flags=None, n_qubits: int = 8, pad_to=None,
                element_cls=None, qchip_fingerprint: str = None) -> str:
    """The content-addressed cache key: sha256 hex digest over every
    compile input (see module docstring for the anatomy).

    ``qchip_fingerprint`` short-circuits the qchip hash when the caller
    already computed it (the cache computes it once per submission to
    drive epoch invalidation too).  Defaults are resolved the same way
    :func:`~..pipeline.compile_to_machine` resolves them, so an
    explicitly-passed default object and an omitted argument produce
    the SAME key.
    """
    from ..compiler import CompilerFlags
    from ..elements import TPUElementConfig
    from ..hwconfig import FPGAConfig
    if qchip_fingerprint is None:
        qchip_fingerprint = qchip.fingerprint()
    if fpga_config is None:
        fpga_config = FPGAConfig(n_cores=n_qubits)
    if compiler_flags is None:
        compiler_flags = CompilerFlags()
    if element_cls is None:
        element_cls = TPUElementConfig
    chan = (['auto', int(n_qubits)] if channel_configs is None
            else _canon(channel_configs))
    # every component below is ALREADY canonical, so the payload is a
    # fixed-order list dumped directly — re-running _canon over it
    # (canonical_json) would double the per-hit key cost for nothing
    payload = [
        'key_version', KEY_VERSION,
        'program', canonical_program(program),
        'qchip', qchip_fingerprint,
        'fpga_config', _canon(fpga_config),
        'compiler_flags', _canon(compiler_flags),
        'channels', chan,
        'n_qubits', int(n_qubits),
        'pad_to', None if pad_to is None else int(pad_to),
        'element_cls', f'{element_cls.__module__}.{element_cls.__qualname__}',
    ]
    blob = json.dumps(payload, separators=(',', ':'))
    return hashlib.sha256(blob.encode()).hexdigest()


def machine_program_bytes(mp) -> bytes:
    """Canonical byte serialization of a :class:`MachineProgram` —
    the determinism oracle: two compiles of the same source are correct
    iff these bytes are equal (tests/test_compilecache.py pins it).

    Arrays contribute dtype+shape+raw bytes in fixed field order; the
    non-array remainder (core indices, register maps, element configs)
    contributes its canonical JSON.
    """
    from .. import isa
    parts = []

    def _arr(a):
        import numpy as np
        a = np.ascontiguousarray(a)
        parts.append(f'{a.dtype}{a.shape}'.encode())
        parts.append(a.tobytes())

    for f in isa.SOA_FIELDS:
        _arr(getattr(mp.soa, f))
    _arr(mp.p_elem)
    _arr(mp.p_dur)
    for t in mp.tables:
        for e in t.envs:
            _arr(e)
        for fr in t.freqs:
            _arr(fr['freq'])
            _arr(fr['iq15'])
        parts.append(canonical_json(t.elem_cfgs).encode())
    parts.append(canonical_json(
        {'core_inds': list(mp.core_inds),
         'reg_maps': mp.reg_maps}).encode())
    return b'\x00'.join(parts)
