"""IR program container: a control-flow graph of basic blocks, plus the
frequency / variable / loop registries and JSON (de)serialisation.

Structure parity with the reference (python/distproc/ir/ir.py): nodes are
basic blocks carrying ``instructions`` (list), ``scope`` (set of channels)
and ``ind`` (source order); edges are possible control-flow paths added by
the GenerateCFG pass (loop back-edges excluded so the graph stays a DAG for
topological scheduling).
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from dataclasses import dataclass

import networkx as nx
import numpy as np

from . import instructions as iri
from ..utils import match_pattern

DEFAULT_QUBIT_GROUPING = ('{qubit}.qdrv', '{qubit}.rdrv', '{qubit}.rdlo')
DEFAULT_PROC_GROUPING = [('{qubit}.qdrv', '{qubit}.rdrv', '{qubit}.rdlo')]


@dataclass
class _Frequency:
    freq: float
    zphase: float
    scope: set = None


@dataclass
class _Variable:
    name: str
    scope: set
    dtype: str = 'int'   # 'int', 'phase', or 'amp'

    def to_dict(self):
        return {'scope': sorted(self.scope) if self.scope else [],
                'dtype': self.dtype}


@dataclass
class _Loop:
    name: str
    scope: set
    start_time: int
    delta_t: int = None

    def to_dict(self):
        return {'scope': sorted(self.scope) if self.scope else [],
                'start_time': self.start_time, 'delta_t': self.delta_t}


class _JSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, set):
            return sorted(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return super().default(obj)


class IRProgram:
    """An IR program: CFG of basic blocks + freq/var/loop registries.

    Accepts a list of instructions (dicts or instruction objects), a dict
    with a ``program`` field (list or {blockname: instrs}) plus optional
    metadata, or a JSON string of the same.
    """

    def __init__(self, source):
        self._freqs: dict = {}
        self._vars: dict[str, _Variable] = {}
        self._hw_zphase_bindings: dict[str, str] = {}
        self.loops: dict[str, _Loop] = {}
        self.fpga_config = None
        self.control_flow_graph = nx.DiGraph()

        if isinstance(source, str):
            source = json.loads(source)
        if isinstance(source, list):
            self._blocks_from_list(source)
        elif isinstance(source, dict):
            prog = source['program']
            if isinstance(prog, list):
                self._blocks_from_list(prog)
            else:
                for i, (blockname, instrs) in enumerate(prog.items()):
                    self.control_flow_graph.add_node(
                        blockname, instructions=iri.program_from_dicts(instrs), ind=i)
            for varname, vd in source.get('vars', {}).items():
                self.register_var(varname, vd['scope'], vd['dtype'])
            for freqname, freq in source.get('freqs', {}).items():
                self.register_freq(freqname, freq)
            for loopname, ld in source.get('loops', {}).items():
                self.register_loop(loopname, ld['scope'], ld['start_time'],
                                   ld.get('delta_t'))
            for freq, var in source.get('hw_zphase_bindings', {}).items():
                self.register_phase_binding(freq, var)
            for node, targets in source.get('control_flow_graph', {}).items():
                for target in targets:
                    self.control_flow_graph.add_edge(node, target)
            for blockname, scope in source.get('scope', {}).items():
                self.control_flow_graph.nodes[blockname]['scope'] = set(scope)
        else:
            raise TypeError(f'invalid program source: {type(source)}')

    def _blocks_from_list(self, instr_list):
        self.control_flow_graph.add_node(
            'block_0', instructions=iri.program_from_dicts(instr_list), ind=0)

    # -- accessors --------------------------------------------------------

    @property
    def blocks(self):
        return self.control_flow_graph.nodes

    @property
    def blocknames_by_ind(self) -> list[str]:
        return sorted(self.control_flow_graph.nodes,
                      key=lambda n: self.control_flow_graph.nodes[n]['ind'])

    @property
    def freqs(self) -> dict:
        return self._freqs

    @property
    def vars(self) -> dict:
        return self._vars

    @property
    def bound_zphase_freqs(self) -> list:
        return list(self._hw_zphase_bindings.keys())

    @property
    def scope(self) -> set:
        return set().union(*(self.blocks[n]['scope'] for n in self.blocks))

    def get_zphase_var(self, freq) -> str:
        return self._hw_zphase_bindings[freq]

    # -- registries -------------------------------------------------------

    def register_freq(self, key, freq):
        if key in self._freqs and self._freqs[key] != freq:
            raise ValueError(
                f'frequency {key} already registered as {self._freqs[key]}, '
                f'conflicting value {freq}')
        self._freqs[key] = freq

    def register_var(self, varname, scope, dtype):
        if varname in self._vars:
            raise ValueError(f'variable {varname} already declared')
        self._vars[varname] = _Variable(varname, set(scope), dtype)

    def register_loop(self, name, scope, start_time, delta_t=None):
        self.loops[name] = _Loop(name, set(scope), start_time, delta_t)

    def register_phase_binding(self, freq, varname):
        if varname not in self._vars:
            raise ValueError(f'bind_phase var {varname} must be declared first')
        if self._vars[varname].dtype != 'phase':
            raise ValueError(f'bind_phase var {varname} must have phase dtype')
        if freq in self._hw_zphase_bindings:
            raise ValueError(
                f'frequency {freq} already bound to {self._hw_zphase_bindings[freq]}')
        self._hw_zphase_bindings[freq] = varname

    # -- serialization ----------------------------------------------------

    def serialize(self) -> str:
        out: dict = {'program': {
            name: [i.to_dict() for i in self.blocks[name]['instructions']]
            for name in self.blocknames_by_ind}}
        if self._vars:
            out['vars'] = {n: v.to_dict() for n, v in self._vars.items()}
        if self._freqs:
            out['freqs'] = dict(self._freqs)
        if self.loops:
            out['loops'] = {n: l.to_dict() for n, l in self.loops.items()}
        if self._hw_zphase_bindings:
            out['hw_zphase_bindings'] = dict(self._hw_zphase_bindings)
        if 'scope' in self.blocks[self.blocknames_by_ind[0]]:
            out['scope'] = {n: self.blocks[n]['scope']
                            for n in self.blocknames_by_ind}
        out['control_flow_graph'] = {
            n: list(self.control_flow_graph.successors(n)) for n in self.blocks}
        return json.dumps(out, indent=4, cls=_JSONEncoder)


class Pass(ABC):
    """A compiler pass: transforms an IRProgram in place."""

    @abstractmethod
    def run_pass(self, ir_prog: IRProgram):
        ...


class QubitScoper:
    """Maps qubits to their channel scope.

    A gate on Q1 is scoped to all Q1.* channels so nothing else can be
    scheduled on that qubit concurrently.  Inputs that already name a
    channel (match one of the grouping patterns) pass through unchanged.
    """

    def __init__(self, mapping=DEFAULT_QUBIT_GROUPING):
        self._mapping = tuple(mapping)

    def get_scope(self, qubits) -> set:
        if isinstance(qubits, str):
            qubits = [qubits]
        channels = set()
        for qubit in qubits:
            if any(match_pattern(pat, qubit) is not None for pat in self._mapping):
                channels.add(qubit)
            else:
                channels.update(pat.format(qubit=qubit) for pat in self._mapping)
        return channels


class CoreScoper:
    """Groups destination channels into processor cores.

    Cores are named by the tuple of channels they drive, e.g.
    ``('Q0.qdrv', 'Q0.rdrv', 'Q0.rdlo')``.
    """

    def __init__(self, dest_channels, proc_grouping=None):
        if proc_grouping is None:
            proc_grouping = DEFAULT_PROC_GROUPING
        self.proc_groupings: dict[str, tuple] = {}
        for dest in dest_channels:
            for group in proc_grouping:
                for pattern in group:
                    fields = match_pattern(pattern, dest)
                    if fields is not None:
                        self.proc_groupings[dest] = tuple(
                            p.format(**fields) for p in group)
        self.proc_groupings_flat = set(self.proc_groupings.values())

    def get_groups_bydest(self, dests) -> set:
        return {self.proc_groupings[dest] for dest in dests}
