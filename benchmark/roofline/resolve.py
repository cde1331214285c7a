"""The resolve hop's work: demodulating every fired readout window.

Per noisy ADC sample, whatever computes it: half a Philox4x32-10 call
(10 32x32->64-bit multiplies, 10 three-way xors), Box-Muller (2 uniforms
from random bits, 3 shifts and ors each; log, sqrt, sin and cos on the
special-function unit; the log's scale, the angle and 2 radius products)
and the 4-FMA projection onto the window's carrier: 38 instructions, 4 of
them special-function operations and 10 multiplies.  Per window: its
scalars, the row select, the prefix reads, the deterministic products
and the reduce, 32 instructions; its bytes are 8 four-byte scalars in
(amplitude, carrier angle's cosine and sine, frequency index, envelope
address, sample count, the state's I and Q response) and 3 float32 sums
out.  These are ``chip_smoke.py``'s restated K2 bound (38 + 32
instructions, 44 bytes), counted here for the windows a cell's inputs
fire, not for the kernel that happens to compute them.
"""

from __future__ import annotations

from . import peaks

SAMPLE_INSTR, SAMPLE_SFU, SAMPLE_IMUL = 38, 4, 10
WINDOW_INSTR = 32
WINDOW_BYTES = 8 * 4 + 3 * 4


def least_seconds(windows: int, samples: int) -> tuple:
    """``(seconds, bound)``: the least time of ``windows`` readout
    windows holding ``samples`` noisy samples in all, and what bounds it
    (``'issue'``, ``'special-function'``, ``'multiplies'`` or
    ``'bytes'``)."""
    t = {'issue': (samples * SAMPLE_INSTR + windows * WINDOW_INSTR)
         / peaks.ISSUE_PER_S,
         'special-function': samples * SAMPLE_SFU / peaks.SFU_PER_S,
         'multiplies': samples * SAMPLE_IMUL / peaks.IMUL_PER_S,
         'bytes': windows * WINDOW_BYTES / peaks.HBM_BYTES_PER_S}
    bound = max(t, key=t.get)
    return t[bound], bound
