"""Built-in N-qubit calibration: a self-contained QChip gate library.

The reference requires an external calibration JSON (the out-of-repo
``qubitconfig`` package's qubitcfg.json); this generates an equivalent
library programmatically — per-qubit X90 (DRAG), Z90 (virtual), read
(flat-top rdrv + square rdlo) — so benchmarks and demos run without any
external files.  Schema matches :class:`~..qchip.QChip`.
"""

from __future__ import annotations

from ..qchip import QChip

# cross-resonance / ef-drive reference amplitudes: a full-amplitude CR
# pulse is a pi/2 ZX rotation (sim/device.py ZX90_AMP_DEFAULT =
# round(CR_AMP * 0xffff)), the CZ ef drive a pi/2 ZZ rotation
CR_AMP = 0.35
CZ_AMP = 0.42


def make_default_qchip_dict(n_qubits: int = 8) -> dict:
    qubits, gates = {}, {}
    for i in range(n_qubits):
        q = f'Q{i}'
        qubits[q] = {
            'freq': 4.2e9 + 0.11e9 * i,
            'freq_ef': 4.0e9 + 0.11e9 * i,
            'readfreq': 6.4e9 + 0.08e9 * i,
        }
        gates[q + 'X90'] = [{
            'dest': q + '.qdrv', 'freq': q + '.freq', 'phase': 0.0,
            'amp': 0.48, 't0': 0.0, 'twidth': 24e-9,
            'env': {'env_func': 'DRAG',
                    'paradict': {'alpha': 0.4, 'sigmas': 3,
                                 'delta': -270e6}},
        }]
        gates[q + 'Z90'] = [{'gate': 'virtualz', 'freq': q + '.freq',
                             'phase': 1.5707963267948966}]
        gates[q + 'read'] = [
            {'dest': q + '.rdrv', 'freq': q + '.readfreq', 'phase': 0.0,
             'amp': 0.25, 't0': 0.0, 'twidth': 512e-9,
             'env': {'env_func': 'cos_edge_square',
                     'paradict': {'ramp_fraction': 0.25}}},
            {'dest': q + '.rdlo', 'freq': q + '.readfreq', 'phase': 0.0,
             'amp': 1.0, 't0': 0.0, 'twidth': 512e-9,
             'env': {'env_func': 'square', 'paradict': {'phase': 0.0,
                                                        'amplitude': 1.0}}},
        ]
    # Two-qubit gates for adjacent pairs, designed to compose EXACTLY to
    # CNOT / CZ under the statevec device model's interaction semantics
    # (sim/device.py: a drive on the control at the target's frequency
    # is exp(-i th/2 Z_c X_t^phi) with th = (pi/2) * amp / zx90_amp; an
    # ef-frequency drive is exp(-i th/2 Z_c Z_t)); pinned by
    # tests/test_device_statevec.py.
    #
    # CNOT = e^{i pi/4} Rz_c(pi/2) Rx_t(pi/2) R_zx(-pi/2): the R_zx via
    # an echoed cross-resonance pair — CR(pi/4, phase pi), X180_c,
    # CR(pi/4, phase 0), X180_c == R_zx(-pi/2) about any folded control
    # frame — then X90 on the target and virtual-z on the control
    # (virtual_z(p) realizes Rz(-p) for Z-measured circuits).
    for i in range(n_qubits - 1):
        c, t = f'Q{i}', f'Q{i+1}'
        cr = {'env_func': 'cos_edge_square', 'paradict': {'ramp_fraction': 0.3}}
        half_cr = CR_AMP / 2
        gates[c + t + 'CNOT'] = [
            {'dest': c + '.qdrv', 'freq': t + '.freq',
             'phase': 3.141592653589793, 'amp': half_cr, 't0': 0.0,
             'twidth': 120e-9, 'env': cr},
            {'gate': c + 'X90', 't0': 120e-9},
            {'gate': c + 'X90', 't0': 144e-9},
            {'dest': c + '.qdrv', 'freq': t + '.freq', 'phase': 0.0,
             'amp': half_cr, 't0': 168e-9, 'twidth': 120e-9, 'env': cr},
            {'gate': c + 'X90', 't0': 288e-9},
            {'gate': c + 'X90', 't0': 312e-9},
            {'gate': t + 'X90', 't0': 336e-9},
            {'gate': 'virtualz', 'freq': c + '.freq',
             'phase': -1.5707963267948966},
        ]
        # CZ = e^{-i pi/4} Rz_c(-pi/2) Rz_t(-pi/2) R_zz(pi/2): one
        # ef drive (th_zz = pi/2 at amp = CZ_AMP = zz90_amp) plus
        # virtual-z pi/2 on both frames (Rz(-pi/2) each)
        gates[c + t + 'CZ'] = [
            {'dest': c + '.qdrv', 'freq': c + '.freq_ef', 'phase': 0.0,
             'amp': CZ_AMP, 't0': 0.0, 'twidth': 80e-9, 'env': cr},
            {'gate': 'virtualz', 'freq': c + '.freq',
             'phase': 1.5707963267948966},
            {'gate': 'virtualz', 'freq': t + '.freq',
             'phase': 1.5707963267948966},
        ]
    return {'Qubits': qubits, 'Gates': gates}


def make_default_qchip(n_qubits: int = 8) -> QChip:
    return QChip(make_default_qchip_dict(n_qubits))
