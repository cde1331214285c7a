"""QASM gate/qubit name mapping (reference: python/distproc/openqasm/
gate_map.py, qubit_map.py).

``GateMap`` translates a QASM gate call into native instruction dicts;
the default decomposes onto the X90 + virtual-Z native set the gate
library calibrates (reference DefaultGateMap: h -> vz + Y90, x -> two
X90, z -> vz(pi), gate_map.py:22-46).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class QubitMap(ABC):
    @abstractmethod
    def get_hardware_qubit(self, register: str, index: int) -> str: ...


class DefaultQubitMap(QubitMap):
    """``q[i] -> Qi`` (reference: qubit_map.py:9)."""

    def get_hardware_qubit(self, register: str, index: int) -> str:
        return f'Q{index if index is not None else 0}'


class GateMap(ABC):
    @abstractmethod
    def get_qubic_gateinstr(self, name: str, qubits: list[str],
                            params: list) -> list[dict]: ...


def _vz(qubit, phase):
    return {'name': 'virtual_z', 'qubit': [qubit], 'phase': float(phase)}


def _x90(qubit):
    return {'name': 'X90', 'qubit': [qubit]}


class DefaultGateMap(GateMap):
    """Decomposition onto {X90, virtual-Z, CNOT, read}.

    Single-qubit maps use the standard Euler identities (all equal to
    the named gate up to global phase):

    * ``h  = Z(pi/2) X90 Z(pi/2)``
    * ``x  = X90 X90``,  ``sx = X90``
    * ``y  = Z(pi) X90 X90``  (X90 pair in the rotated frame)
    * ``z/s/sdg/t/tdg/rz/p`` -> pure virtual-Z
    * ``ry(t) = Z(-pi/2) rx(t) Z(pi/2)``; generic ``rx`` only for
      t = ±pi/2, pi (native-set multiples)
    """

    def get_qubic_gateinstr(self, name: str, qubits: list[str],
                            params: list) -> list[dict]:
        q = qubits[0]
        name = name.lower()
        if name == 'h':
            return [_vz(q, np.pi / 2), _x90(q), _vz(q, np.pi / 2)]
        if name == 'x':
            return [_x90(q), _x90(q)]
        if name == 'sx':
            return [_x90(q)]
        if name == 'y':
            return [_vz(q, np.pi), _x90(q), _x90(q)]
        if name == 'z':
            return [_vz(q, np.pi)]
        if name == 's':
            return [_vz(q, np.pi / 2)]
        if name == 'sdg':
            return [_vz(q, -np.pi / 2)]
        if name == 't':
            return [_vz(q, np.pi / 4)]
        if name == 'tdg':
            return [_vz(q, -np.pi / 4)]
        if name in ('rz', 'p', 'phase'):
            return [_vz(q, params[0])]
        if name == 'rx':
            return self._rx(q, params[0])
        if name == 'ry':
            return [_vz(q, -np.pi / 2)] + self._rx(q, params[0]) \
                + [_vz(q, np.pi / 2)]
        if name in ('cx', 'cnot'):
            return [{'name': 'CNOT', 'qubit': list(qubits)}]
        if name == 'cz':
            return [{'name': 'CZ', 'qubit': list(qubits)}]
        # fall through: assume a native gate name in the gate library
        return [{'name': name.upper() if name == 'x90' else name,
                 'qubit': list(qubits)}]

    def _rx(self, q, theta) -> list[dict]:
        theta = float(theta) % (2 * np.pi)
        if np.isclose(theta, np.pi / 2):
            return [_x90(q)]
        if np.isclose(theta, np.pi):
            return [_x90(q), _x90(q)]
        if np.isclose(theta, 0):
            return []
        # general angle (ZXZXZ Euler form, program order):
        # Rx(theta) = Z(pi/2) . X90 . Z(theta + pi) . X90 . Z(pi/2)
        return [_vz(q, np.pi / 2), _x90(q), _vz(q, theta + np.pi),
                _x90(q), _vz(q, np.pi / 2)]
