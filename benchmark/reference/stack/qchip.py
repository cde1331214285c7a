"""Gate-library subsystem: qubit frequencies and calibrated gate definitions.

The reference imports this from the external ``qubitconfig`` package (loaded
from qubitcfg.json files; see reference python/test/qubitcfg.json and the
usage in python/distproc/ir/passes.py:308-357).  This is a self-contained
reimplementation of the behaviour the compiler depends on:

* ``QChip.gates['Q0X90']`` → :class:`Gate`, a sequence of
  :class:`GatePulse` / :class:`GateVirtualZ` entries;
* named-frequency resolution (``'Q0.freq'`` → Qubits table lookup);
* per-call gate parameter modification (``modi``) and lazy dereferencing of
  frequency names / symbolic phases.

JSON format::

    {"Qubits": {"Q0": {"freq": ..., "readfreq": ...}, ...},
     "Gates": {"Q0X90": [ {pulse fields...}, {"gate": "virtualz", ...} ]}}
"""

from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass, field

from .utils import eval_numeric


@dataclass
class GateVirtualZ:
    """A virtual-Z entry inside a gate definition."""
    freq: str          # resolved ('global') frequency name, e.g. 'Q0.freq'
    phase: float

    @property
    def global_freqname(self) -> str:
        return self.freq

    def to_dict(self) -> dict:
        return {'gate': 'virtualz', 'freq': self.freq, 'phase': self.phase}


@dataclass
class GatePulse:
    """One calibrated pulse inside a gate definition."""
    dest: str
    twidth: float
    env: list | dict | None = None
    t0: float = 0.0
    amp: float = 1.0
    phase: float = 0.0
    freq: float | str | None = None     # numeric after dereference()
    freqname: str | None = None         # name preserved for the compiler

    def dereference(self, qchip: 'QChip'):
        if isinstance(self.freq, str):
            self.freqname = self.freq
            self.freq = qchip.get_qubit_freq(self.freqname)
        self.phase = eval_numeric(self.phase)
        self.amp = eval_numeric(self.amp)

    def to_dict(self) -> dict:
        d = {'dest': self.dest, 'phase': self.phase, 't0': self.t0,
             'twidth': self.twidth, 'amp': self.amp}
        d['freq'] = self.freqname if self.freqname is not None else self.freq
        if self.env is not None:
            d['env'] = self.env
        return d


@dataclass
class GateRef:
    """A composite-gate entry referencing another named gate, played with an
    optional time offset (e.g. Y-90 = virtualz . X90 . virtualz)."""
    gatename: str
    t0: float = 0.0

    def to_dict(self) -> dict:
        return {'gate': self.gatename, 't0': self.t0}


def _entry_from_dict(d: dict):
    if d.get('gate') == 'virtualz':
        return GateVirtualZ(freq=d['freq'], phase=eval_numeric(d['phase']))
    if 'gate' in d:
        return GateRef(gatename=d['gate'], t0=d.get('t0', 0.0))
    fields = {k: v for k, v in d.items() if k in
              ('dest', 'twidth', 'env', 't0', 'amp', 'phase', 'freq')}
    return GatePulse(**fields)


@dataclass
class Gate:
    """A named gate: an ordered list of pulses and virtual-z rotations."""
    name: str
    contents: list = field(default_factory=list)

    def get_pulses(self):
        return self.contents

    def get_updated_copy(self, modi: dict) -> 'Gate':
        """Return a copy with per-pulse parameter modifications applied.

        ``modi`` maps ``(pulse_index, attribute)`` → new value, e.g.
        ``{(0, 'amp'): 0.5}`` (the reference circuit format's gate
        ``modi`` field, python/distproc/compiler.py:8).
        """
        new = copy.deepcopy(self)
        for key, value in modi.items():
            ind, attr = key
            setattr(new.contents[ind], attr, value)
        return new

    def dereference(self, qchip: 'QChip'):
        """Resolve frequency names / symbolic phases and expand composite
        gate references (recursively, with the reference's t0 offset added
        to each expanded pulse)."""
        expanded = []
        for entry in self.contents:
            if isinstance(entry, GateRef):
                sub = qchip.get_gate(entry.gatename)
                for sub_entry in sub.contents:
                    if isinstance(sub_entry, GatePulse):
                        sub_entry.t0 += entry.t0
                    expanded.append(sub_entry)
            else:
                if isinstance(entry, GatePulse):
                    entry.dereference(qchip)
                expanded.append(entry)
        self.contents = expanded

    @property
    def dest_channels(self) -> set:
        return {p.dest for p in self.contents if isinstance(p, GatePulse)}

    def to_dict(self) -> list:
        return [c.to_dict() for c in self.contents]


class QChip:
    """The chip calibration object: qubit frequency table + gate library."""

    def __init__(self, source: str | dict):
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        self.qubits: dict = copy.deepcopy(source.get('Qubits', {}))
        self.gates: dict[str, Gate] = {}
        for name, entries in source.get('Gates', {}).items():
            self.gates[name] = Gate(
                name, [_entry_from_dict(e) for e in entries])

    def get_qubit_freq(self, freqname: str) -> float:
        """Resolve 'Q0.freq'-style names against the Qubits table."""
        if not isinstance(freqname, str):
            return freqname
        try:
            qubit, attr = freqname.split('.', 1)
            return float(self.qubits[qubit][attr])
        except (ValueError, KeyError):
            raise KeyError(f'cannot resolve frequency name {freqname!r}')

    def get_gate(self, name: str, modi: dict = None) -> Gate:
        """Fetch a dereferenced (numeric-frequency) copy of a gate."""
        gate = self.gates[name]
        if modi is not None:
            gate = gate.get_updated_copy(modi)
        else:
            gate = copy.deepcopy(gate)
        gate.dereference(self)
        return gate

    @property
    def dest_channels(self) -> set:
        out = set()
        for gate in self.gates.values():
            out |= gate.dest_channels
        return out

    def to_dict(self) -> dict:
        return {'Qubits': copy.deepcopy(self.qubits),
                'Gates': {name: g.to_dict() for name, g in self.gates.items()}}

    def fingerprint(self) -> str:
        """Stable content hash of the calibration state (frequency table
        + gate library): equal for two QChips built from the same source
        regardless of dict-key order, changed by any retune — one gate
        amplitude, one qubit frequency.  This names the *calibration
        epoch* in compile-cache keys (see compilecache/), so a qchip
        update invalidates exactly the entries compiled against it.
        """
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          default=_fingerprint_default,
                          separators=(',', ':'))
        return hashlib.sha256(blob.encode()).hexdigest()


def _fingerprint_default(obj):
    """json.dumps fallback for calibration values that aren't JSON
    scalars: numpy arrays/scalars (duck-typed, no numpy import here)
    and complex amplitudes; anything else keys on its repr."""
    if isinstance(obj, complex):
        return ['__complex__', obj.real, obj.imag]
    if hasattr(obj, 'dtype') and hasattr(obj, 'tolist'):
        return obj.tolist()
    return repr(obj)
