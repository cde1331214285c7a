"""Compiler driver: QubiC-format circuit → per-core assembly programs.

Input program format (parity with the reference circuit format,
python/distproc/compiler.py:1-106): a list of instruction dicts —

* gates: ``{'name': gatename, 'qubit': [qubitid], 'modi': {...}}``
* pulses: ``{'name': 'pulse', 'freq', 'phase', 'amp', 'twidth', 'env',
  'dest', ['start_time']}``
* virtual-z: ``{'name': 'virtual_z', 'qubit'/'freq', 'phase'}``
* ``declare_freq``, ``bind_phase``, ``read_fproc``, ``alu_fproc``,
  ``barrier``, ``delay``, ``branch_fproc``, ``branch_var``, ``loop``,
  ``alu``, ``set_var``, ``declare`` — see the IR instruction classes.

Compilation: lower to IR → run the pass pipeline (:func:`get_passes`) →
:meth:`Compiler.compile` splits instructions across processor cores and
emits the assembly dialect consumed by
:mod:`distributed_processor_tpu_torch.assembler`.
"""

from __future__ import annotations

import copy
import json
import logging
from dataclasses import dataclass, field

import numpy as np

from . import hwconfig as hw
from .ir import IRProgram, CoreScoper, passes
from .ir.program import DEFAULT_PROC_GROUPING

logger = logging.getLogger(__name__)


@dataclass
class CompilerFlags:
    resolve_gates: bool = True
    schedule: bool = True


def get_passes(fpga_config: hw.FPGAConfig, qchip=None,
               compiler_flags: CompilerFlags | dict = None,
               qubit_grouping=('{qubit}.qdrv', '{qubit}.rdrv', '{qubit}.rdlo'),
               proc_grouping=DEFAULT_PROC_GROUPING) -> list:
    """The canonical pass pipeline (see module docstring of ir.passes)."""
    if compiler_flags is None:
        compiler_flags = CompilerFlags()
    elif isinstance(compiler_flags, dict):
        compiler_flags = CompilerFlags(**compiler_flags)

    cur_passes = [passes.FlattenProgram(),
                  passes.MakeBasicBlocks(),
                  passes.ScopeProgram(qubit_grouping),
                  passes.RegisterVarsAndFreqs(qchip)]
    if compiler_flags.resolve_gates:
        if qchip is None:
            raise ValueError('a QChip object is required to resolve gates')
        cur_passes.append(passes.ResolveGates(qchip, qubit_grouping))
    cur_passes.extend([passes.GenerateCFG(),
                       passes.ResolveHWVirtualZ(),
                       passes.ResolveVirtualZ(),
                       passes.ResolveFreqs(),
                       passes.ResolveFPROCChannels(fpga_config),
                       passes.RescopeVars()])
    if compiler_flags.schedule:
        cur_passes.append(passes.Schedule(fpga_config, proc_grouping))
    else:
        cur_passes.append(passes.LintSchedule(fpga_config, proc_grouping))
    return cur_passes


class Compiler:
    """Compile a circuit down to per-core assembly.

    Usage::

        compiler = Compiler(program)
        compiler.run_ir_passes(get_passes(fpga_config, qchip))
        compiled = compiler.compile()
    """

    def __init__(self, program, proc_grouping=DEFAULT_PROC_GROUPING):
        self.ir_prog = IRProgram(program)
        self._proc_grouping = proc_grouping

    def run_ir_passes(self, pass_list: list):
        for ir_pass in pass_list:
            ir_pass.run_pass(self.ir_prog)

    def compile(self) -> 'CompiledProgram':
        self._core_scoper = CoreScoper(self.ir_prog.scope, self._proc_grouping)
        asm_progs = {grp: [{'op': 'phase_reset'}]
                     for grp in self._core_scoper.proc_groupings_flat}
        for blockname in self.ir_prog.blocknames_by_ind:
            self._compile_block(
                asm_progs, self.ir_prog.blocks[blockname]['instructions'])
        for grp in self._core_scoper.proc_groupings_flat:
            asm_progs[grp].append({'op': 'done_stb'})
        return CompiledProgram(asm_progs, fpga_config=self.ir_prog.fpga_config)

    def _compile_block(self, asm_progs, instructions):
        groups_bydest = self._core_scoper.proc_groupings
        for instr in instructions:
            if instr.name == 'pulse':
                env = instr.env
                if isinstance(env, (list, tuple)) and env and isinstance(env[0], dict):
                    if len(env) > 1:
                        logger.warning('only the first env paradict of %s is used', env)
                    env = env[0]
                if isinstance(env, dict):
                    if 'twidth' not in env['paradict']:
                        env = copy.deepcopy(env)
                        env['paradict']['twidth'] = instr.twidth
                    elif env['paradict']['twidth'] != instr.twidth:
                        raise ValueError('pulse twidth differs from envelope twidth')
                asm = {'op': 'pulse', 'freq': instr.freq, 'phase': instr.phase,
                       'amp': instr.amp, 'env': env,
                       'start_time': instr.start_time, 'dest': instr.dest}
                if instr.tag is not None:
                    asm['tag'] = instr.tag
                asm_progs[groups_bydest[instr.dest]].append(asm)
                continue

            if instr.name == 'jump_label':
                emit = {'op': 'jump_label', 'dest_label': instr.label}
            elif instr.name == 'declare':
                dtype = instr.dtype
                if dtype in ('phase', 'amp'):
                    dtype = (dtype, 0)
                emit = {'op': 'declare_reg', 'name': instr.var, 'dtype': dtype}
            elif instr.name == 'alu':
                emit = {'op': 'reg_alu', 'in0': instr.lhs, 'in1_reg': instr.rhs,
                        'alu_op': instr.op, 'out_reg': instr.out}
            elif instr.name == 'set_var':
                emit = {'op': 'reg_alu', 'in0': instr.value, 'in1_reg': instr.var,
                        'alu_op': 'id0', 'out_reg': instr.var}
            elif instr.name == 'read_fproc':
                emit = {'op': 'alu_fproc', 'in0': 0, 'alu_op': 'id1',
                        'func_id': instr.func_id, 'out_reg': instr.var}
            elif instr.name == 'alu_fproc':
                emit = {'op': 'alu_fproc', 'in0': instr.lhs, 'alu_op': instr.op,
                        'func_id': instr.func_id, 'out_reg': instr.out}
            elif instr.name == 'jump_fproc':
                emit = {'op': 'jump_fproc', 'in0': instr.cond_lhs,
                        'alu_op': instr.alu_cond, 'jump_label': instr.jump_label,
                        'func_id': instr.func_id}
            elif instr.name == 'jump_cond':
                emit = {'op': 'jump_cond', 'in0': instr.cond_lhs,
                        'alu_op': instr.alu_cond, 'jump_label': instr.jump_label,
                        'in1_reg': instr.cond_rhs}
            elif instr.name == 'jump_i':
                emit = {'op': 'jump_i', 'jump_label': instr.jump_label}
            elif instr.name == 'loop_end':
                emit = {'op': 'inc_qclk',
                        'in0': -self.ir_prog.loops[instr.loop_label].delta_t}
            elif instr.name == 'idle':
                emit = {'op': 'idle', 'end_time': instr.end_time}
            else:
                raise NotImplementedError(f'cannot compile {instr.name}')

            for core in self._core_scoper.get_groups_bydest(instr.scope):
                asm_progs[core].append(dict(emit))


@dataclass
class CompiledProgram:
    """Per-core assembly output of the compiler.

    ``program`` maps proc-group tuples (the channels driven by one core,
    e.g. ``('Q0.qdrv', 'Q0.rdrv', 'Q0.rdlo')``) to assembly instruction
    lists in the dialect of :mod:`distributed_processor_tpu_torch.assembler`
    (pulse statements carry a ``dest`` channel instead of ``elem_ind``).
    """

    program: dict
    fpga_config: hw.FPGAConfig = None

    @property
    def proc_groups(self):
        return self.program.keys()

    def to_dict(self) -> dict:
        progdict = {}
        for grp, instrs in self.program.items():
            # '|'-join keeps tuple keys JSON-safe; a trailing '|' marks a
            # single-channel group so from_dict restores the right type
            key = ('|'.join(grp) if len(grp) > 1 else grp[0] + '|') \
                if isinstance(grp, tuple) else grp
            out_instrs = []
            for instr in instrs:
                instr = dict(instr)
                if isinstance(instr.get('env'), np.ndarray):
                    env = instr['env']
                    instr['env'] = {'__ndarray__': True,
                                    're': np.real(env).tolist(),
                                    'im': np.imag(env).tolist()}
                if isinstance(instr.get('func_id'), tuple):
                    instr['func_id'] = {'__tuple__': list(instr['func_id'])}
                if isinstance(instr.get('dtype'), tuple):
                    instr['dtype'] = {'__tuple__': list(instr['dtype'])}
                out_instrs.append(instr)
            progdict[key] = out_instrs
        out = {'program': progdict}
        if self.fpga_config is not None:
            out['fpga_config'] = self.fpga_config.to_dict()
        return out

    def save(self, filename: str):
        """Serialise to JSON (the reference's save/load is stubbed;
        this one round-trips, see :func:`load_compiled_program`)."""
        with open(filename, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> 'CompiledProgram':
        program = {}
        for key, instrs in d['program'].items():
            grp = tuple(s for s in key.split('|') if s) if '|' in key else key
            out_instrs = []
            for instr in instrs:
                instr = dict(instr)
                env = instr.get('env')
                if isinstance(env, dict) and env.get('__ndarray__'):
                    instr['env'] = np.array(env['re']) + 1j * np.array(env['im'])
                for k in ('func_id', 'dtype'):
                    if isinstance(instr.get(k), dict) and '__tuple__' in instr[k]:
                        instr[k] = tuple(instr[k]['__tuple__'])
                out_instrs.append(instr)
            program[grp] = out_instrs
        fpga_config = None
        if 'fpga_config' in d:
            fpga_config = hw.FPGAConfig(**d['fpga_config'])
        return cls(program, fpga_config)


def load_compiled_program(filename: str) -> CompiledProgram:
    with open(filename) as f:
        return CompiledProgram.from_dict(json.load(f))
