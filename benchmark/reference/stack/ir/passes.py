"""The compilation pass pipeline.

Pass order and semantics maintain parity with the reference pipeline
(python/distproc/ir/passes.py; canonical order in
python/distproc/compiler.py:139-174):

FlattenProgram → MakeBasicBlocks → ScopeProgram → RegisterVarsAndFreqs →
ResolveGates → GenerateCFG → ResolveHWVirtualZ → ResolveVirtualZ →
ResolveFreqs → ResolveFPROCChannels → RescopeVars → Schedule|LintSchedule

The scheduler tracks two clock families per basic block (parity with
reference passes.py:596-742, the timing contract in BASELINE.md):

* ``cur_t[dest]`` — the pulse-end time per destination channel;
* ``last_instr_end_t[core]`` — the instruction-issue-pipeline time per
  processor core, advanced by the FPGAConfig per-instruction costs.

Loops are scheduled once: the loop body's schedule is referenced to the
loop start, and a negative ``inc_qclk`` (delta_t) emitted at loop end
rewinds the hardware clock so every iteration reuses the same offsets.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import networkx as nx

from . import instructions as iri
from .program import IRProgram, Pass, QubitScoper, CoreScoper

logger = logging.getLogger(__name__)


class FlattenProgram(Pass):
    """Lower nested control flow (branch_fproc/branch_var/loop) to jumps.

    A branch becomes ``jump → [false block] → jump_i end → true: [true
    block] → end``; a loop becomes ``label; barrier; body; loop_end;
    jump_cond(label, jump_type='loopctrl')``.
    """

    def run_pass(self, ir_prog: IRProgram):
        assert len(ir_prog.control_flow_graph.nodes) == 1
        blockname = next(iter(ir_prog.control_flow_graph.nodes))
        instrs = ir_prog.blocks[blockname]['instructions']
        self._used_labels = set()
        ir_prog.blocks[blockname]['instructions'] = self._flatten(instrs)

    def _unique(self, label: str) -> str:
        """Sibling bodies flattened in separate recursive calls restart
        their local index, so generated names can collide (e.g. two
        sequential branch-wrapped loops both yielding
        ``true_loop_0_loopctrl``); MakeBasicBlocks would then silently
        overwrite the first block.  First occurrence keeps the
        reference-compatible name; collisions get a ``_u<n>`` suffix."""
        out, n = label, 0
        while out in self._used_labels:
            n += 1
            out = f'{label}_u{n}'
        self._used_labels.add(out)
        return out

    def _flatten(self, program, label_prefix=''):
        out = []
        branchind = 0
        for statement in program:
            statement = copy.deepcopy(statement)
            if statement.name in ('branch_fproc', 'branch_var'):
                flat_true = self._flatten(statement.true, 'true_' + label_prefix)
                flat_false = self._flatten(statement.false, 'false_' + label_prefix)
                label_false = self._unique(f'{label_prefix}false_{branchind}')
                label_end = self._unique(f'{label_prefix}end_{branchind}')

                if statement.name == 'branch_fproc':
                    jump = iri.JumpFproc(alu_cond=statement.alu_cond,
                                         cond_lhs=statement.cond_lhs,
                                         func_id=statement.func_id,
                                         scope=statement.scope, jump_label=None)
                else:
                    jump = iri.JumpCond(alu_cond=statement.alu_cond,
                                        cond_lhs=statement.cond_lhs,
                                        cond_rhs=statement.cond_rhs,
                                        scope=statement.scope, jump_label=None)
                label_true = self._unique(f'{label_prefix}true_{branchind}')
                jump.jump_label = label_true if flat_true else label_end
                out.append(jump)

                out.append(iri.JumpLabel(label=label_false, scope=statement.scope))
                out.extend(flat_false)
                out.append(iri.JumpI(jump_label=label_end, scope=statement.scope))
                if flat_true:
                    out.append(iri.JumpLabel(label=label_true, scope=statement.scope))
                    out.extend(flat_true)
                out.append(iri.JumpLabel(label=label_end, scope=statement.scope))
                branchind += 1

            elif statement.name == 'loop':
                flat_body = self._flatten(statement.body, 'loop_body_' + label_prefix)
                # loopctrl suffix is load-bearing (block naming): keep it
                # terminal when disambiguating
                base = f'{label_prefix}loop_{branchind}'
                out_base, n = base, 0
                while f'{out_base}_loopctrl' in self._used_labels:
                    n += 1
                    out_base = f'{base}_u{n}'
                loop_label = f'{out_base}_loopctrl'
                self._used_labels.add(loop_label)
                out.append(iri.JumpLabel(label=loop_label, scope=statement.scope))
                out.append(iri.Barrier(qubit=statement.scope))
                out.extend(flat_body)
                out.append(iri.LoopEnd(loop_label=loop_label, scope=statement.scope))
                out.append(iri.JumpCond(cond_lhs=statement.cond_lhs,
                                        cond_rhs=statement.cond_rhs,
                                        alu_cond=statement.alu_cond,
                                        jump_label=loop_label,
                                        scope=statement.scope,
                                        jump_type='loopctrl'))
                branchind += 1
            else:
                out.append(statement)
        return out


class MakeBasicBlocks(Pass):
    """Split the flattened program into basic blocks at jumps and labels.

    Jump instructions are placed in their own control block (named
    ``<label>_ctrl`` for loop-control jumps, ``<block>_ctrl`` otherwise);
    labelled positions start a new block named after the label.
    """

    def run_pass(self, ir_prog: IRProgram):
        assert len(ir_prog.control_flow_graph.nodes) == 1
        g = ir_prog.control_flow_graph
        cur_blockname = next(iter(g.nodes))
        full_program = g.nodes[cur_blockname]['instructions']
        g.nodes[cur_blockname]['instructions'] = []

        blockname_ind = 1
        block_ind = 0
        cur_block: list = []
        for statement in full_program:
            if statement.name in ('jump_fproc', 'jump_cond', 'jump_i'):
                g.add_node(cur_blockname, instructions=cur_block, ind=block_ind)
                block_ind += 1
                if statement.jump_label.split('_')[-1] == 'loopctrl':
                    ctrl_blockname = f'{statement.jump_label}_ctrl'
                else:
                    ctrl_blockname = f'{cur_blockname}_ctrl'
                # networkx add_node REPLACES a same-named node: a branch
                # jump inside a loop body would otherwise collide with
                # (and be overwritten by) the loop back-edge's
                # '<label>_ctrl' block, silently dropping the branch
                base, n = ctrl_blockname, 0
                while ctrl_blockname in g:
                    n += 1
                    ctrl_blockname = f'{base}_u{n}'
                g.add_node(ctrl_blockname, instructions=[statement], ind=block_ind)
                block_ind += 1
                cur_blockname = f'block_{blockname_ind}'
                blockname_ind += 1
                cur_block = []
            elif statement.name == 'jump_label':
                g.add_node(cur_blockname, instructions=cur_block, ind=block_ind)
                block_ind += 1
                cur_block = [statement]
                cur_blockname = statement.label
            elif statement.name in ('branch_fproc', 'branch_var', 'loop'):
                raise ValueError(
                    f'{statement.name} found: flatten control flow before '
                    'forming basic blocks')
            else:
                cur_block.append(statement)

        g.add_node(cur_blockname, instructions=cur_block, ind=block_ind)
        for node in tuple(g.nodes):
            if g.nodes[node]['instructions'] == []:
                g.remove_node(node)


class ScopeProgram(Pass):
    """Resolve instruction and block scopes to sets of channels.

    Unscoped barriers/delays/idles are widened to the whole program scope.
    """

    def __init__(self, qubit_grouping: tuple, rescope_barriers_and_delays=True):
        self._scoper = QubitScoper(qubit_grouping)
        self._rescope = rescope_barriers_and_delays

    def run_pass(self, ir_prog: IRProgram):
        for node in ir_prog.blocks:
            scope = set()
            for instr in ir_prog.blocks[node]['instructions']:
                if getattr(instr, 'scope', None) is not None:
                    instr.scope = self._scoper.get_scope(instr.scope)
                    scope |= instr.scope
                elif getattr(instr, 'qubit', None) is not None:
                    instr.scope = self._scoper.get_scope(instr.qubit)
                    scope |= instr.scope
                elif hasattr(instr, 'dest'):
                    scope |= self._scoper.get_scope(instr.dest)
            ir_prog.blocks[node]['scope'] = scope

        if self._rescope:
            prog_scope = ir_prog.scope
            for node in ir_prog.blocks:
                for instr in ir_prog.blocks[node]['instructions']:
                    if instr.name in ('barrier', 'delay', 'idle') and instr.scope is None:
                        instr.scope = prog_scope


class RegisterVarsAndFreqs(Pass):
    """Register declared frequencies/variables; scope var-using ALU ops.

    Pulse frequencies referenced by name resolve through the QChip if one
    is provided (gate frequencies are registered by ResolveGates instead).
    """

    def __init__(self, qchip=None):
        self._qchip = qchip

    def run_pass(self, ir_prog: IRProgram):
        for node in ir_prog.blocks:
            for instr in ir_prog.blocks[node]['instructions']:
                if instr.name == 'declare_freq':
                    freqname = instr.freqname if instr.freqname is not None else instr.freq
                    ir_prog.register_freq(freqname, instr.freq)
                elif instr.name == 'declare':
                    ir_prog.register_var(instr.var, instr.scope, instr.dtype)
                elif instr.name == 'pulse':
                    if instr.freq not in ir_prog.freqs:
                        if isinstance(instr.freq, str):
                            if self._qchip is None:
                                raise ValueError(
                                    f'undefined frequency {instr.freq} and no QChip provided')
                            ir_prog.register_freq(
                                instr.freq, self._qchip.get_qubit_freq(instr.freq))
                        else:
                            ir_prog.register_freq(instr.freq, instr.freq)
                elif instr.name == 'alu':
                    if isinstance(instr.lhs, str):
                        instr.scope = ir_prog.vars[instr.rhs].scope \
                            | ir_prog.vars[instr.lhs].scope
                    else:
                        instr.scope = set(ir_prog.vars[instr.rhs].scope)
                    if not ir_prog.vars[instr.out].scope.issubset(instr.scope):
                        raise ValueError(
                            f'alu output {instr.out} scope exceeds operand scope')
                elif instr.name in ('set_var', 'read_fproc'):
                    instr.scope = set(ir_prog.vars[instr.var].scope)
                elif instr.name == 'alu_fproc':
                    # note: reference scopes this via a nonexistent rhs attr
                    # (passes.py:281-283, latent bug); we use the lhs var scope
                    if isinstance(instr.lhs, str):
                        instr.scope = set(ir_prog.vars[instr.lhs].scope)

        # widen block scopes with the var-derived instruction scopes: a
        # block whose only instructions are var-scoped (e.g. a bare
        # set_var between two hardware loops) otherwise has an empty
        # scope, gets no sequential CFG edge, and the scheduler never
        # seeds its clocks (KeyError in Schedule)
        for node in ir_prog.blocks:
            blk = ir_prog.blocks[node]
            for instr in blk['instructions']:
                sc = getattr(instr, 'scope', None)
                if sc:
                    blk['scope'] = set(blk['scope']) | set(sc)


class ResolveGates(Pass):
    """Expand Gate instructions into Barrier + Pulse/VirtualZ sequences
    using the QChip gate library.  Named gate frequencies are registered
    and pulses keep the name (resolved later by ResolveFreqs)."""

    def __init__(self, qchip, qubit_grouping):
        self._qchip = qchip
        self._scoper = QubitScoper(qubit_grouping)

    def run_pass(self, ir_prog: IRProgram):
        for node in ir_prog.blocks:
            block = ir_prog.blocks[node]['instructions']
            i = 0
            while i < len(block):
                if not isinstance(block[i], iri.Gate):
                    i += 1
                    continue
                instr = block.pop(i)
                gatename = ''.join(instr.qubit) + instr.name
                gate = self._qchip.get_gate(gatename, instr.modi)

                block.insert(i, iri.Barrier(scope=self._scoper.get_scope(instr.qubit)))
                i += 1
                for pulse in gate.get_pulses():
                    if hasattr(pulse, 'global_freqname'):   # virtual-z entry
                        block.insert(i, iri.VirtualZ(
                            freq=pulse.global_freqname, phase=pulse.phase))
                        i += 1
                        continue
                    if pulse.freqname is not None:
                        if pulse.freqname not in ir_prog.freqs:
                            ir_prog.register_freq(pulse.freqname, pulse.freq)
                        elif pulse.freq != ir_prog.freqs[pulse.freqname]:
                            logger.warning(
                                '%s = %s differs from qchip value %s',
                                pulse.freqname, ir_prog.freqs[pulse.freqname],
                                pulse.freq)
                        freq = pulse.freqname
                    else:
                        if pulse.freq not in ir_prog.freqs:
                            ir_prog.register_freq(pulse.freq, pulse.freq)
                        freq = pulse.freq
                    if pulse.t0 != 0:
                        block.insert(i, iri.Delay(t=pulse.t0, scope={pulse.dest}))
                        i += 1
                    block.insert(i, iri.Pulse(
                        freq=freq, phase=pulse.phase, amp=pulse.amp,
                        env=pulse.env, twidth=pulse.twidth, dest=pulse.dest))
                    i += 1


class GenerateCFG(Pass):
    """Add control-flow edges between basic blocks.

    Sequential edges follow the last block that touched each destination
    channel; jump edges go to the target label's block.  Loop-control
    back-edges are *excluded* so the CFG remains a DAG for scheduling.
    """

    def run_pass(self, ir_prog: IRProgram):
        lastblock = {dest: None for dest in ir_prog.scope}
        for blockname in ir_prog.blocknames_by_ind:
            block = ir_prog.blocks[blockname]
            for dest in block['scope']:
                if lastblock[dest] is not None:
                    ir_prog.control_flow_graph.add_edge(lastblock[dest], blockname)

            last_instr = block['instructions'][-1]
            if last_instr.name in ('jump_fproc', 'jump_cond'):
                if last_instr.jump_type != 'loopctrl':
                    ir_prog.control_flow_graph.add_edge(
                        blockname, last_instr.jump_label)
                for dest in block['scope']:
                    lastblock[dest] = blockname
            elif last_instr.name == 'jump_i':
                ir_prog.control_flow_graph.add_edge(blockname, last_instr.jump_label)
                for dest in block['scope']:
                    lastblock[dest] = None
            else:
                for dest in block['scope']:
                    lastblock[dest] = blockname


class ResolveHWVirtualZ(Pass):
    """Apply bind_phase: virtual-z on bound frequencies becomes runtime
    register arithmetic, and pulses on those frequencies take their phase
    from the bound register.  Run before ResolveVirtualZ."""

    def run_pass(self, ir_prog: IRProgram):
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            instructions = ir_prog.blocks[nodename]['instructions']
            i = 0
            while i < len(instructions):
                instr = instructions[i]
                if instr.name == 'bind_phase':
                    ir_prog.register_phase_binding(instr.freq, instr.var)
                    instructions[i] = iri.SetVar(
                        value=0, var=instr.var,
                        scope=ir_prog.vars[instr.var].scope)
                elif isinstance(instr, iri.VirtualZ):
                    if instr.freq in ir_prog.bound_zphase_freqs:
                        var = ir_prog.get_zphase_var(instr.freq)
                        if instr.scope is not None and \
                                not set(instr.scope).issubset(ir_prog.vars[var].scope):
                            raise ValueError(
                                f'virtual-z scope exceeds bound var scope for {instr.freq}')
                        instructions[i] = iri.Alu(
                            op='add', lhs=instr.phase, rhs=var, out=var,
                            scope=ir_prog.vars[var].scope)
                elif instr.name == 'pulse':
                    if instr.freq in ir_prog.bound_zphase_freqs:
                        instr.phase = ir_prog.get_zphase_var(instr.freq)
                elif isinstance(instr, iri.Gate):
                    raise ValueError('resolve Gates before ResolveHWVirtualZ')
                i += 1


class ResolveVirtualZ(Pass):
    """Software virtual-z: accumulate z-phases per frequency along the CFG
    and fold them into downstream pulse phases.  Phase accumulators must
    agree across CFG predecessors (otherwise the z-phase must be bound to
    a hardware register with bind_phase)."""

    def run_pass(self, ir_prog: IRProgram):
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            zphase_acc: dict = {}
            for pred in ir_prog.control_flow_graph.predecessors(nodename):
                for freqname, phase in ir_prog.blocks[pred]['ending_zphases'].items():
                    if freqname in zphase_acc:
                        if phase != zphase_acc[freqname]:
                            raise ValueError(
                                f'z-phase mismatch on {freqname} entering {nodename} '
                                f'from {pred} ({phase} rad)')
                    else:
                        zphase_acc[freqname] = phase

            instructions = ir_prog.blocks[nodename]['instructions']
            i = 0
            while i < len(instructions):
                instr = instructions[i]
                if isinstance(instr, iri.Pulse):
                    if instr.freq in zphase_acc:
                        instr.phase += zphase_acc[instr.freq]
                elif isinstance(instr, iri.VirtualZ):
                    if instr.freq not in ir_prog.freqs:
                        logger.warning('virtual-z on unused frequency: %s', instr.freq)
                    instructions.pop(i)
                    i -= 1
                    zphase_acc[instr.freq] = zphase_acc.get(instr.freq, 0) + instr.phase
                elif isinstance(instr, iri.Gate):
                    raise ValueError('resolve Gates before ResolveVirtualZ')
                elif isinstance(instr, iri.JumpCond) and instr.jump_type == 'loopctrl':
                    logger.warning('z-phase resolution inside loops is unsupported')
                i += 1

            ir_prog.blocks[nodename]['ending_zphases'] = zphase_acc


class ResolveFreqs(Pass):
    """Resolve named pulse frequencies to Hz (var-parameterised ones stay)."""

    def run_pass(self, ir_prog: IRProgram):
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            for instr in ir_prog.blocks[nodename]['instructions']:
                if instr.name == 'pulse' and isinstance(instr.freq, str):
                    if instr.freq in ir_prog.vars:
                        if instr.dest not in ir_prog.vars[instr.freq].scope:
                            raise ValueError(
                                f'pulse dest {instr.dest} outside freq var scope')
                    else:
                        instr.freq = ir_prog.freqs[instr.freq]


class ResolveFPROCChannels(Pass):
    """Lower named fproc channels to hardware ids and insert Hold
    instructions so fproc reads land after the referenced measurement."""

    def __init__(self, fpga_config):
        self._fpga_config = fpga_config

    def run_pass(self, ir_prog: IRProgram):
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            instructions = ir_prog.blocks[nodename]['instructions']
            i = 0
            while i < len(instructions):
                instr = instructions[i]
                if isinstance(instr, (iri.ReadFproc, iri.JumpFproc, iri.AluFproc)):
                    if instr.func_id in self._fpga_config.fproc_channels:
                        chan = self._fpga_config.fproc_channels[instr.func_id]
                        instructions.insert(i, iri.Hold(
                            nclks=chan.hold_nclks,
                            ref_chans=chan.hold_after_chans,
                            scope=instr.scope))
                        i += 1
                        instr.func_id = chan.id
                    elif not isinstance(instr.func_id, (int, tuple)):
                        raise ValueError(f'unresolvable fproc channel {instr.func_id}')
                i += 1


class RescopeVars(Pass):
    """Widen variable scopes to wherever the variables are used."""

    def run_pass(self, ir_prog: IRProgram):
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            instructions = ir_prog.blocks[nodename]['instructions']
            rescope_block = False
            for instr in instructions:
                if instr.name == 'pulse':
                    if instr.phase in ir_prog.vars and \
                            instr.dest not in ir_prog.vars[instr.phase].scope:
                        ir_prog.vars[instr.phase].scope.add(instr.dest)
                        rescope_block = True
                elif instr.name in ('jump_cond', 'jump_fproc'):
                    if instr.cond_lhs in ir_prog.vars and \
                            not instr.scope.issubset(ir_prog.vars[instr.cond_lhs].scope):
                        ir_prog.vars[instr.cond_lhs].scope |= instr.scope
                        rescope_block = True
                    if instr.name == 'jump_cond' and \
                            not instr.scope.issubset(ir_prog.vars[instr.cond_rhs].scope):
                        ir_prog.vars[instr.cond_rhs].scope |= instr.scope
                        rescope_block = True
            if rescope_block:
                for instr in instructions:
                    if instr.name in ('declare', 'set_var'):
                        instr.scope = set(ir_prog.vars[instr.var].scope)
                    elif instr.name == 'alu':
                        instr.scope = set(ir_prog.vars[instr.out].scope)


START_NCLKS = 5   # schedule origin: first possible pulse issue


class _TimedPass(Pass):
    """Shared per-instruction clock accounting for Schedule/LintSchedule."""

    def __init__(self, fpga_config, proc_grouping: list):
        self._fpga_config = fpga_config
        self._proc_grouping = proc_grouping
        self._start_nclks = START_NCLKS

    def _pulse_nclks(self, length_secs: float) -> int:
        return int(np.ceil(length_secs / self._fpga_config.fpga_clk_period))

    def _instr_cost(self, name: str) -> int:
        cfg = self._fpga_config
        return {'alu': cfg.alu_instr_clks, 'set_var': cfg.alu_instr_clks,
                'loop_end': cfg.alu_instr_clks,
                'jump_fproc': cfg.jump_fproc_clks,
                'read_fproc': cfg.jump_fproc_clks,
                'alu_fproc': cfg.jump_fproc_clks,
                'jump_i': cfg.jump_cond_clks,
                'jump_cond': cfg.jump_cond_clks}[name]


class Schedule(_TimedPass):
    """Assign start times to pulses, resolve Hold→Idle, drop
    Barrier/Delay, and compute loop delta_t (see module docstring)."""

    def run_pass(self, ir_prog: IRProgram):
        self._core_scoper = CoreScoper(ir_prog.scope, self._proc_grouping)
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            cur_t = {dest: self._start_nclks for dest in ir_prog.scope}
            last_instr_end_t = {
                grp: self._start_nclks for grp in
                self._core_scoper.get_groups_bydest(ir_prog.blocks[nodename]['scope'])}

            for pred in ir_prog.control_flow_graph.predecessors(nodename):
                pred_block = ir_prog.blocks[pred]
                for dest in cur_t:
                    if dest in pred_block['scope']:
                        cur_t[dest] = max(cur_t[dest], pred_block['block_end_t'][dest])
                for grp in last_instr_end_t:
                    if grp in pred_block['last_instr_end_t']:
                        last_instr_end_t[grp] = max(
                            last_instr_end_t[grp], pred_block['last_instr_end_t'][grp])

            if nodename.split('_')[-1] == 'loopctrl':
                ir_prog.register_loop(nodename, ir_prog.blocks[nodename]['scope'],
                                      max(cur_t.values()))

            self._schedule_block(
                ir_prog.blocks[nodename]['instructions'], cur_t, last_instr_end_t,
                ir_prog)

            last_instr = ir_prog.blocks[nodename]['instructions'][-1] \
                if ir_prog.blocks[nodename]['instructions'] else None
            if isinstance(last_instr, iri.JumpCond) and last_instr.jump_type == 'loopctrl':
                loop = ir_prog.loops[last_instr.jump_label]
                ir_prog.blocks[nodename]['block_end_t'] = {
                    dest: loop.start_time for dest in ir_prog.blocks[nodename]['scope']}
                ir_prog.blocks[nodename]['last_instr_end_t'] = {
                    grp: loop.start_time for grp in
                    self._core_scoper.get_groups_bydest(ir_prog.blocks[nodename]['scope'])}
                loop.delta_t = max(max(last_instr_end_t.values()),
                                   max(cur_t.values())) - loop.start_time
            else:
                ir_prog.blocks[nodename]['block_end_t'] = cur_t
                ir_prog.blocks[nodename]['last_instr_end_t'] = last_instr_end_t

        ir_prog.fpga_config = self._fpga_config

    def _schedule_block(self, instructions, cur_t, last_instr_end_t, ir_prog):
        groupings = self._core_scoper.proc_groupings
        i = 0
        while i < len(instructions):
            instr = instructions[i]
            if instr.name == 'pulse':
                grp = groupings[instr.dest]
                instr.start_time = max(last_instr_end_t[grp], cur_t[instr.dest])
                last_instr_end_t[grp] = instr.start_time \
                    + self._fpga_config.pulse_load_clks
                cur_t[instr.dest] = instr.start_time + self._pulse_nclks(instr.twidth)

            elif instr.name == 'barrier':
                max_t = max(max(cur_t[dest] for dest in instr.scope),
                            max(last_instr_end_t[groupings[dest]]
                                for dest in instr.scope))
                for dest in instr.scope:
                    cur_t[dest] = max_t
                instructions.pop(i)
                i -= 1

            elif instr.name == 'delay':
                for dest in instr.scope:
                    cur_t[dest] += self._pulse_nclks(instr.t)
                instructions.pop(i)
                i -= 1

            elif instr.name == 'hold':
                idle_end_t = max(cur_t[dest] for dest in instr.ref_chans) + instr.nclks
                idle_scope = set()
                for grp in self._core_scoper.get_groups_bydest(instr.scope):
                    if last_instr_end_t[grp] >= idle_end_t:
                        logger.info('skipping hold on core %s: timestamp exceeded', grp)
                    else:
                        idle_scope |= set(grp)
                        last_instr_end_t[grp] = idle_end_t \
                            + self._fpga_config.pulse_load_clks
                if idle_scope:
                    instructions[i] = iri.Idle(end_time=idle_end_t, scope=idle_scope)
                else:
                    instructions.pop(i)
                    i -= 1

            elif instr.name in ('alu', 'set_var', 'jump_fproc', 'read_fproc',
                                'alu_fproc', 'jump_i', 'jump_cond', 'loop_end'):
                cost = self._instr_cost(instr.name)
                for grp in self._core_scoper.get_groups_bydest(instr.scope):
                    last_instr_end_t[grp] += cost

            elif isinstance(instr, iri.Gate):
                raise ValueError('resolve Gates before scheduling')

            i += 1


class LintSchedule(_TimedPass):
    """Check user-provided start times against the issue-pipeline model;
    raises if a pulse or idle would stall the core."""

    def run_pass(self, ir_prog: IRProgram):
        self._core_scoper = CoreScoper(ir_prog.scope, self._proc_grouping)
        for nodename in nx.topological_sort(ir_prog.control_flow_graph):
            last_instr_end_t = {
                grp: self._start_nclks for grp in
                self._core_scoper.get_groups_bydest(ir_prog.blocks[nodename]['scope'])}
            for pred in ir_prog.control_flow_graph.predecessors(nodename):
                for grp in last_instr_end_t:
                    if grp in ir_prog.blocks[pred]['last_instr_end_t']:
                        last_instr_end_t[grp] = max(
                            last_instr_end_t[grp],
                            ir_prog.blocks[pred]['last_instr_end_t'][grp])

            self._lint_block(ir_prog.blocks[nodename]['instructions'], last_instr_end_t)

            last_instr = ir_prog.blocks[nodename]['instructions'][-1] \
                if ir_prog.blocks[nodename]['instructions'] else None
            if isinstance(last_instr, iri.JumpCond) and last_instr.jump_type == 'loopctrl':
                loop = ir_prog.loops[last_instr.jump_label]
                ir_prog.blocks[nodename]['last_instr_end_t'] = {
                    grp: loop.start_time for grp in
                    self._core_scoper.get_groups_bydest(ir_prog.blocks[nodename]['scope'])}
            else:
                ir_prog.blocks[nodename]['last_instr_end_t'] = last_instr_end_t

        ir_prog.fpga_config = self._fpga_config

    def _lint_block(self, instructions, last_instr_end_t):
        groupings = self._core_scoper.proc_groupings
        for i, instr in enumerate(instructions):
            if instr.name == 'pulse':
                grp = groupings[instr.dest]
                if instr.start_time < last_instr_end_t[grp]:
                    raise ValueError(
                        f'instruction {i}: {instr}: start time too early; '
                        f'must be >= {last_instr_end_t[grp]}')
                last_instr_end_t[grp] = instr.start_time \
                    + self._fpga_config.pulse_load_clks
            elif instr.name == 'idle':
                for grp in self._core_scoper.get_groups_bydest(instr.scope):
                    if instr.end_time < last_instr_end_t[grp]:
                        raise ValueError(
                            f'instruction {i}: {instr}: end time too early; '
                            f'must be >= {last_instr_end_t[grp]}')
                    last_instr_end_t[grp] = instr.end_time \
                        + self._fpga_config.pulse_load_clks
            elif instr.name in ('alu', 'set_var', 'jump_fproc', 'read_fproc',
                                'alu_fproc', 'jump_i', 'jump_cond', 'loop_end'):
                cost = self._instr_cost(instr.name)
                for grp in self._core_scoper.get_groups_bydest(instr.scope):
                    last_instr_end_t[grp] += cost
            elif isinstance(instr, iri.Gate):
                raise ValueError('resolve Gates before scheduling')
