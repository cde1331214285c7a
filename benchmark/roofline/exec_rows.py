"""The exec hop's work: retiring every instruction of every lane.

Per retired instruction row, whatever retires it: decode and dispatch,
the ALU, the pulse latch and trigger, the next pc and time: 40 32-bit
integer operations (``chip_smoke.py``'s restated K1 bound), at the
derived INT32 issue rate of :mod:`.peaks`.  Bytes: the injected bits
read once, and the result's per-core words written once: ``pc``,
``time``, ``offset``, ``err``, ``fault``, ``n_pulses``, ``n_resets``,
``n_meas``, ``qclk``, 16 registers, 5 latched pulse parameters, one
reset time per reset slot and two times (available, triggered) per
measurement slot, four bytes each, and the one-byte ``done`` flag.
"""

from __future__ import annotations

from . import peaks

OPS_PER_ROW = 40
CORE_WORDS = 9 + 16 + 5


def result_bytes(lanes: int, cores: int, max_meas: int,
                 max_resets: int) -> int:
    words = CORE_WORDS + max_resets + 2 * max_meas
    return lanes * cores * (4 * words + 1)


def least_seconds(rows: int, nbytes: int) -> tuple:
    """``(seconds, bound)`` of ``rows`` retired rows moving ``nbytes``."""
    t = {'operations': rows * OPS_PER_ROW / peaks.INT32_OPS_PER_S,
         'bytes': nbytes / peaks.HBM_BYTES_PER_S}
    bound = max(t, key=t.get)
    return t[bound], bound
