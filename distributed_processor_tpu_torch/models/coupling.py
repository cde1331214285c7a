"""Derive the statevec device's two-qubit coupling map from a compiled
program and its gate library.

The statevec model (sim/device.py) identifies entangling pulses by
``(core, frequency-word)``: a drive pulse whose frequency table entry is
another qubit's drive frequency is a cross-resonance (ZX) interaction,
and one at the control's own ef transition is a ZZ (CZ-style) drive.
The mapping from frequency *values* to per-core table *indices* is a
property of the compiled machine program (the assembler builds each
core's frequency table from the pulses the program actually plays,
assembler.py add_freq), so the coupling map is derived per-program here
and handed to :class:`~..sim.device.DeviceModel` as static
configuration.

The reference treats two-qubit calibrations as first-class gate-library
entries (reference: python/test/qubitcfg.json:1152 Q5Q4CNOT) but models
no physics for them — hardware entangles; this map is what lets the
simulator's closed loop entangle in-sim.  A copy of the JAX package's
``models/coupling.py`` (numpy only).
"""

from __future__ import annotations

import re

import numpy as np

from ..qchip import QChip, GatePulse

_GATE_RE = re.compile(r'(Q\d+)(Q\d+)(CNOT|CZ)')


def couplings_from_qchip(mp, qchip: QChip, drive_elem: int = 0) -> tuple:
    """Coupling entries ``(ctrl_core, freq_idx, target_core, kind)`` for
    every two-qubit gate in ``qchip`` whose interaction frequency the
    compiled program ``mp`` actually uses.

    Qubit ``Qn`` maps to core ``n`` (the models/channels.py layout).  A
    CNOT's CR pulses (control driven at the target's frequency) become
    ``'zx'`` entries; a CZ's ef drive becomes ``'zz'``.  The control's
    own-frame echo pulses are excluded by frequency.
    """
    out = set()
    for name in qchip.gates:
        m = _GATE_RE.fullmatch(name)
        if not m:
            continue
        ctrl_q, tgt_q, gname = m.group(1), m.group(2), m.group(3)
        ctrl, tgt = int(ctrl_q[1:]), int(tgt_q[1:])
        kind = 'zx' if gname == 'CNOT' else 'zz'
        own_freq = qchip.get_qubit_freq(f'{ctrl_q}.freq')
        gate = qchip.get_gate(name)
        for p in gate.contents:
            if not (isinstance(p, GatePulse)
                    and p.dest == f'{ctrl_q}.qdrv'):
                continue
            if np.isclose(p.freq, own_freq, rtol=1e-12):
                continue                      # own-frame echo pulse: 1q
            if ctrl >= len(mp.tables) or tgt >= len(mp.tables):
                continue
            freq_tabs = mp.tables[ctrl].freqs
            if drive_elem >= len(freq_tabs):
                continue
            freqs = np.asarray(freq_tabs[drive_elem]['freq'], np.float64)
            for i in np.nonzero(np.isclose(freqs, p.freq, rtol=1e-12,
                                           atol=1.0))[0]:
                out.add((ctrl, int(i), tgt, kind))
    return tuple(sorted(out))
