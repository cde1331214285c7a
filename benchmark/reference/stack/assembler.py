"""Assembler: per-core assembly dialect → 128-bit machine code + element
envelope/frequency buffers.

Assembly dialect (parity with the reference asm format,
python/distproc/assembler.py:1-47):

* ``{'op': 'declare_reg', 'name', 'dtype': ('int',) | ('phase', elem) | ('amp', elem)}``
* ``{'op': 'declare_freq', 'freq', 'elem_ind', ['freq_ind']}``
* ``{'op': 'pulse', 'freq', 'env', 'phase', 'amp', 'start_time', 'elem_ind',
  ['label'], ['tag']}`` — freq/phase/amp may be register names (at most one
  per machine instruction; multi-register pulses split automatically)
* ``{'op': 'reg_alu', 'in0', 'alu_op', 'in1_reg', 'out_reg', ['label']}``
* ``{'op': 'inc_qclk', 'in0'}``, ``{'op': 'jump_cond', ...}``,
  ``{'op': 'jump_fproc', ...}``, ``{'op': 'alu_fproc', ...}``
* ``{'op': 'jump_i', 'jump_label'}``, ``{'op': 'jump_label', 'dest_label'}``
* ``{'op': 'phase_reset'}``, ``{'op': 'done_stb'}``, ``{'op': 'idle', 'end_time'}``

:class:`GlobalAssembler` consumes a CompiledProgram, resolves pulse
destinations and named fproc channels against the channel configs, and
assembles every core.
"""

from __future__ import annotations

import copy
import json
import logging
import warnings

import numpy as np

from . import isa
from . import hwconfig as hw

logger = logging.getLogger(__name__)

N_MAX_REGS = isa.N_REGS


class SingleCoreAssembler:
    """Assemble one core's program against its element configs.

    ``elem_cfgs``: ordered list of :class:`ElementConfig` — one per signal
    element attached to this core (element index = list position).
    """

    def __init__(self, elem_cfgs: list):
        self.n_element = len(elem_cfgs)
        self._elem_cfgs = elem_cfgs
        self._env_dicts = [dict() for _ in range(self.n_element)]
        self._freq_lists: list[list] = [[] for _ in range(self.n_element)]
        self._program: list[dict] = []
        self._regs: dict[str, dict] = {}

    # -- program construction -------------------------------------------

    def from_list(self, cmd_list: list[dict]):
        cmd_list = [dict(c) for c in cmd_list]   # do not mutate caller's program
        pending_labels = []
        for cmd in cmd_list:
            op = cmd['op']
            # declare_* emit no machine instruction: labels pending at a
            # declaration bind to the next real instruction (e.g. a loop
            # label whose block starts with a declare).  Several labels
            # may accumulate (label, declares, label); all alias the
            # same instruction address.
            if pending_labels and op not in ('declare_reg', 'declare_freq',
                                             'jump_label'):
                cmd = {**cmd, 'label': pending_labels[0]
                       if len(pending_labels) == 1 else tuple(pending_labels)}
                pending_labels = []
            args = {k: v for k, v in cmd.items() if k != 'op'}
            if op == 'pulse':
                n_reg_params = sum(isinstance(cmd.get(k), str)
                                   for k in ('freq', 'amp', 'phase'))
                if n_reg_params > 1:
                    warnings.warn(
                        f'{cmd} will be split into multiple instructions, '
                        'which may cause timing problems')
                self.add_pulse(**args)
            elif op in ('reg_alu', 'jump_cond', 'alu_fproc', 'jump_fproc'):
                self.add_alu_cmd(op, **args)
            elif op == 'inc_qclk':
                self.add_inc_qclk(**args)
            elif op == 'reg_write':
                self.add_reg_write(**args)
            elif op == 'phase_reset':
                self.add_phase_reset(**args)
            elif op == 'done_stb':
                self.add_done_stb(**args)
            elif op == 'declare_freq':
                self.add_freq(**args)
            elif op == 'declare_reg':
                self.declare_reg(**args)
            elif op == 'idle':
                self.add_idle(**args)
            elif op == 'jump_i':
                self.add_jump_i(**args)
            elif op == 'jump_label':
                pending_labels.append(args['dest_label'])
            else:
                raise ValueError(f'unsupported assembly op: {cmd}')
        if pending_labels:
            raise ValueError(
                f'jump label(s) {pending_labels} at end of program')

    @property
    def register_map(self) -> dict:
        """Declared variables: ``{name: {'index': i, 'dtype': (...)}}``."""
        return {n: dict(index=r['index'], dtype=tuple(r['dtype']))
                for n, r in self._regs.items()}

    def declare_reg(self, name: str, dtype=('int',)):
        if name in self._regs:
            raise ValueError(f'register {name} already declared')
        used = {r['index'] for r in self._regs.values()}
        index = next(i for i in range(N_MAX_REGS + 1) if i not in used)
        if index >= N_MAX_REGS:
            raise ValueError(f'out of registers (max {N_MAX_REGS})')
        if isinstance(dtype, str):
            dtype = (dtype,)
        self._regs[name] = {'index': index, 'dtype': tuple(dtype)}

    def add_alu_cmd(self, op: str, in0, alu_op: str, in1_reg: str = None,
                    out_reg: str = None, jump_label: str = None,
                    func_id=None, label: str = None):
        if op not in ('reg_alu', 'jump_cond', 'alu_fproc', 'jump_fproc', 'inc_qclk'):
            raise ValueError(f'bad alu op {op}')
        if in1_reg is not None and in1_reg not in self._regs:
            raise ValueError(f'undeclared register {in1_reg}')
        if isinstance(in0, str) and in0 not in self._regs:
            raise ValueError(f'undeclared register {in0}')

        cmd = {'op': op, 'in0': in0, 'alu_op': alu_op}
        if op in ('reg_alu', 'jump_cond'):
            assert in1_reg is not None and func_id is None
            if isinstance(in0, str):
                assert self._regs[in0]['dtype'] == self._regs[in1_reg]['dtype']
            cmd['in1_reg'] = in1_reg
        else:
            assert in1_reg is None
        if op in ('reg_alu', 'alu_fproc'):
            assert out_reg is not None
            if isinstance(in0, str):
                assert self._regs[in0]['dtype'] == self._regs[out_reg]['dtype']
            if in1_reg is not None:
                assert self._regs[in1_reg]['dtype'] == self._regs[out_reg]['dtype']
            cmd['out_reg'] = out_reg
        else:
            assert out_reg is None
        if op in ('jump_cond', 'jump_fproc'):
            assert jump_label is not None
            cmd['jump_label'] = jump_label
        if op in ('alu_fproc', 'jump_fproc'):
            cmd['func_id'] = func_id
        else:
            assert func_id is None
        if label is not None:
            cmd['label'] = label
        self._program.append(cmd)

    def add_reg_alu(self, in0, alu_op, in1_reg, out_reg, label=None):
        self.add_alu_cmd('reg_alu', in0, alu_op, in1_reg, out_reg, label=label)

    def add_reg_write(self, name, value, dtype=None, label=None):
        """Write an immediate to a named register, declaring it on first use."""
        if name not in self._regs:
            self.declare_reg(name, dtype if dtype is not None else ('int',))
        elif dtype is not None:
            assert tuple(dtype) == self._regs[name]['dtype']
        self.add_reg_alu(value, 'id0', name, name, label)

    def add_jump_cond(self, in0, alu_op, in1_reg, jump_label, label=None):
        self.add_alu_cmd('jump_cond', in0, alu_op, in1_reg,
                         jump_label=jump_label, label=label)

    def add_jump_fproc(self, in0, alu_op, jump_label, func_id=None, label=None):
        self.add_alu_cmd('jump_fproc', in0, alu_op, jump_label=jump_label,
                         func_id=func_id, label=label)

    def add_inc_qclk(self, in0, label=None):
        self.add_alu_cmd('inc_qclk', in0, 'add', label=label)

    def add_phase_reset(self, label=None):
        self._append({'op': 'pulse_reset'}, label)

    def add_done_stb(self, label=None):
        self._append({'op': 'done_stb'}, label)

    def add_idle(self, end_time, label=None):
        self._append({'op': 'idle', 'end_time': end_time}, label)

    def add_jump_i(self, jump_label, label=None):
        self._append({'op': 'jump_i', 'jump_label': jump_label}, label)

    def _append(self, cmd, label=None):
        if label is not None:
            cmd['label'] = label
        self._program.append(cmd)

    def add_env(self, name, env, elem_ind):
        if np.any(np.abs(env) > 1):
            raise ValueError('envelope magnitude must be <= 1')
        self._env_dicts[elem_ind][name] = env

    def add_freq(self, freq, elem_ind, freq_ind=None):
        freqs = self._freq_lists[elem_ind]
        if freq_ind is None:
            freqs.append(freq)
        elif freq_ind >= len(freqs):
            freqs.extend([None] * (freq_ind - len(freqs)))
            freqs.append(freq)
        elif freqs[freq_ind] is None:
            freqs[freq_ind] = freq
        else:
            raise ValueError(f'frequency index {freq_ind} already occupied')

    def add_pulse(self, freq, phase, amp, start_time, env, elem_ind,
                  label=None, tag=None):
        """Add a pulse; freq/phase/amp may name (typed) registers.

        At most one parameter per machine instruction can be
        register-sourced; extra register parameters are loaded by
        preceding parameter-write-only instructions.
        """
        if isinstance(env, np.ndarray):
            if np.any((np.abs(np.real(env)) > 1) | (np.abs(np.imag(env)) > 1)):
                raise ValueError('envelope must lie within the unit square')
            envkey = self._hash_env(env)
            self._env_dicts[elem_ind].setdefault(envkey, env)
        elif isinstance(env, dict):
            envkey = self._hash_env(env)
            self._env_dicts[elem_ind].setdefault(envkey, env)
        elif isinstance(env, str):
            envkey = env
            if envkey not in self._env_dicts[elem_ind]:
                if envkey == 'cw':
                    self._env_dicts[elem_ind][envkey] = 'cw'
                else:
                    raise ValueError(f'envelope not found: {envkey}')
        else:
            raise TypeError('env must be an array, paradict, or name')

        if isinstance(freq, str):
            assert freq in self._regs and self._regs[freq]['dtype'] == ('int',)
        elif freq not in self._freq_lists[elem_ind]:
            self.add_freq(freq, elem_ind)
        if isinstance(amp, str):
            assert amp in self._regs and self._regs[amp]['dtype'] == ('amp', elem_ind)
        if isinstance(phase, str):
            assert phase in self._regs and self._regs[phase]['dtype'] == ('phase', elem_ind)

        # split out extra register-sourced parameters into write-only cmds
        reg_params = [k for k, v in (('freq', freq), ('amp', amp), ('phase', phase))
                      if isinstance(v, str)]
        params = {'freq': freq, 'amp': amp, 'phase': phase}
        first = True
        for extra in reg_params[:-1]:
            write = {'op': 'pulse', extra: params.pop(extra),
                     'elem': elem_ind}
            if label is not None and first:
                # the label must address the whole split group: a jump
                # landing here (e.g. a loop back-edge) must re-execute
                # the parameter writes, not just the final trigger
                write['label'] = label
                first = False
            self._program.append(write)
        cmd = {'op': 'pulse', **params, 'start_time': start_time,
               'env': envkey, 'elem': elem_ind}
        if label is not None and first:
            cmd['label'] = label
        if tag is not None:
            cmd['tag'] = tag
        self._program.append(cmd)

    # -- assembly --------------------------------------------------------

    def get_compiled_program(self):
        """Assemble: returns (cmd_buf bytes, env buffers, freq buffers)."""
        cmd_words = []
        env_raw, env_word_maps = self._get_env_buffers()
        freq_raw, freq_ind_maps = self._get_freq_buffers()
        labelmap = self._get_cmd_labelmap()

        for cmd in self._program:
            op = cmd['op']
            if op == 'pulse':
                elem = cmd['elem']
                cfg = self._elem_cfgs[elem]
                args = {}
                if 'freq' in cmd:
                    if isinstance(cmd['freq'], str):
                        args['freq_regaddr'] = self._regs[cmd['freq']]['index']
                    else:
                        args['freq_word'] = cfg.get_freq_addr(
                            freq_ind_maps[elem][cmd['freq']])
                if 'phase' in cmd:
                    if isinstance(cmd['phase'], str):
                        args['phase_regaddr'] = self._regs[cmd['phase']]['index']
                    else:
                        args['phase_word'] = cfg.get_phase_word(cmd['phase'])
                if 'amp' in cmd:
                    if isinstance(cmd['amp'], str):
                        args['amp_regaddr'] = self._regs[cmd['amp']]['index']
                    else:
                        args['amp_word'] = cfg.get_amp_word(cmd['amp'])
                if 'env' in cmd:
                    args['env_word'] = env_word_maps[elem][cmd['env']]
                if 'start_time' in cmd:
                    args['cmd_time'] = cmd['start_time']
                args['cfg_word'] = cfg.get_cfg_word(elem, None)
                cmd_words.append(isa.pulse_cmd(**args))

            elif op in ('reg_alu', 'jump_cond', 'alu_fproc', 'jump_fproc', 'inc_qclk'):
                if isinstance(cmd['in0'], str):
                    in0 = self._regs[cmd['in0']]['index']
                    im_or_reg = 'r'
                else:
                    in0 = cmd['in0']
                    im_or_reg = 'i'
                    # immediates interacting with typed registers are encoded
                    # in that register's hardware representation
                    key = cmd.get('out_reg') or cmd.get('in1_reg')
                    if key is not None:
                        dtype = self._regs[key]['dtype']
                        if dtype[0] == 'phase':
                            in0 = self._elem_cfgs[dtype[1]].get_phase_word(in0)
                        elif dtype[0] == 'amp':
                            in0 = self._elem_cfgs[dtype[1]].get_amp_word(in0)
                cmd_words.append(isa.alu_cmd(
                    op, im_or_reg, in0, cmd.get('alu_op'),
                    self._regs[cmd['in1_reg']]['index'] if 'in1_reg' in cmd else 0,
                    self._regs[cmd['out_reg']]['index'] if 'out_reg' in cmd else None,
                    labelmap[cmd['jump_label']] if 'jump_label' in cmd else None,
                    cmd.get('func_id')))

            elif op == 'jump_i':
                cmd_words.append(isa.jump_i(labelmap[cmd['jump_label']]))
            elif op == 'pulse_reset':
                cmd_words.append(isa.pulse_reset())
            elif op == 'idle':
                cmd_words.append(isa.idle(cmd['end_time']))
            elif op == 'done_stb':
                cmd_words.append(isa.done_cmd())
            elif op == 'sync':
                cmd_words.append(isa.sync(cmd['barrier_id']))
            else:
                raise ValueError(f'unsupported op {op}')

        return isa.cmds_to_bytes(cmd_words), env_raw, freq_raw

    def get_sim_program(self) -> list[dict]:
        """The program with envelope names replaced by data (for simulators)."""
        out = []
        for cmd in self._program:
            cmd = copy.deepcopy(cmd)
            if cmd['op'] == 'pulse' and 'env' in cmd:
                cmd['env'] = self._env_dicts[cmd['elem']][cmd['env']]
            out.append(cmd)
        return out

    @property
    def regs(self) -> dict:
        return {name: dict(r) for name, r in self._regs.items()}

    def _get_cmd_labelmap(self) -> dict:
        labelmap = {}
        for i, cmd in enumerate(self._program):
            if 'label' in cmd:
                labels = cmd['label'] if isinstance(cmd['label'], tuple) \
                    else (cmd['label'],)
                for label in labels:
                    if label in labelmap:
                        raise ValueError(f'label {label} used twice')
                    labelmap[label] = i
        return labelmap

    def _get_env_buffer(self, elem_ind):
        cur_ind = 0
        env_word_map = {}
        chunks = []
        for envkey, env in self._env_dicts[elem_ind].items():
            buf = self._elem_cfgs[elem_ind].get_env_buffer(env)
            if envkey == 'cw':
                env_word_map[envkey] = self._elem_cfgs[elem_ind].get_cw_env_word(cur_ind)
            else:
                env_word_map[envkey] = self._elem_cfgs[elem_ind].get_env_word(
                    cur_ind, len(buf))
            cur_ind += len(buf)
            chunks.append(np.asarray(buf))
        env_raw = np.concatenate(chunks) if chunks else np.zeros(0)
        return env_raw, env_word_map

    def _get_env_buffers(self):
        data, maps = [], []
        for i in range(self.n_element):
            d, m = self._get_env_buffer(i)
            data.append(np.asarray(d, dtype=np.uint32).tobytes())
            maps.append(m)
        return data, maps

    def _get_freq_buffers(self):
        data, maps = [], []
        for i in range(self.n_element):
            buf = self._elem_cfgs[i].get_freq_buffer(self._freq_lists[i])
            data.append(np.asarray(buf, dtype=np.uint32).tobytes())
            maps.append({f: self._freq_lists[i].index(f)
                         for f in self._freq_lists[i] if f is not None})
        return data, maps

    @staticmethod
    def _hash_env(env) -> str:
        if isinstance(env, np.ndarray):
            return str(hash(env.data.tobytes()))
        if isinstance(env, dict):
            return str(hash(json.dumps(env, sort_keys=True)))
        raise TypeError(f'cannot hash envelope of type {type(env)}')


class GlobalAssembler:
    """Assemble a CompiledProgram for every processor core.

    Resolves pulse ``dest`` channels to element indices and named fproc
    func_ids to hardware ids using the channel configs, then delegates to
    one :class:`SingleCoreAssembler` per core.
    """

    def __init__(self, compiled_program, channel_configs: dict,
                 elementconfig_class):
        self.assemblers: dict[str, SingleCoreAssembler] = {}
        self.channel_configs = channel_configs
        compiled_program = copy.deepcopy(compiled_program)

        if compiled_program.fpga_config is not None:
            hw_clk = int(np.round(channel_configs['fpga_clk_freq']))
            prog_clk = int(np.round(compiled_program.fpga_config.fpga_clk_freq))
            if hw_clk != prog_clk:
                raise ValueError(
                    f'program target clock {prog_clk} Hz != hardware clock {hw_clk} Hz')

        for proc_group in compiled_program.proc_groups:
            elem_cfgs = {}
            core_ind = str(channel_configs[proc_group[0]].core_ind)
            for chan in proc_group:
                chan_cfg = channel_configs[chan]
                if chan_cfg.core_ind != int(core_ind):
                    raise ValueError(f'{chan}: inconsistent core index in group')
                elem_cfgs[chan_cfg.elem_ind] = elementconfig_class(**chan_cfg.elem_params)
            inds = sorted(elem_cfgs)
            if inds != list(range(len(inds))):
                raise ValueError('element indices must be 0..n-1 within a core')

            program = compiled_program.program[proc_group]
            program = self._resolve_dests_and_fproc(program)
            program = self._resolve_duplicate_jump_labels(program)
            asm = SingleCoreAssembler([elem_cfgs[i] for i in inds])
            asm.from_list(program)
            self.assemblers[core_ind] = asm

    def _resolve_dests_and_fproc(self, program: list[dict]) -> list[dict]:
        out = []
        for statement in program:
            statement = dict(statement)
            if statement['op'] == 'pulse':
                statement['elem_ind'] = self.channel_configs[statement['dest']].elem_ind
                del statement['dest']
            elif statement['op'] in ('alu_fproc', 'jump_fproc'):
                func_id = statement.get('func_id')
                if isinstance(func_id, tuple):
                    statement['func_id'] = getattr(
                        self.channel_configs[func_id[0]], func_id[1])
                elif isinstance(func_id, str):
                    statement['func_id'] = self.channel_configs[func_id]
                elif func_id is not None and not isinstance(func_id, int):
                    raise TypeError(f'bad func_id {func_id}')
            out.append(statement)
        return out

    @staticmethod
    def _resolve_duplicate_jump_labels(program: list[dict]) -> list[dict]:
        """Merge runs of consecutive jump_label statements into one."""
        out = []
        combined: dict[str, str] = {}
        cur_label = None
        for statement in program:
            if statement['op'] == 'jump_label':
                if cur_label is None:
                    cur_label = statement['dest_label']
                    out.append(statement)
                else:
                    combined[statement['dest_label']] = cur_label
            else:
                cur_label = None
                out.append(statement)
        if combined:
            out = [dict(s, jump_label=combined[s['jump_label']])
                   if s.get('jump_label') in combined else s for s in out]
        return out

    @property
    def register_maps(self) -> dict:
        """Declared variables per core:
        ``{core_ind: {name: {'index', 'dtype'}}}`` — the handle a host
        needs to preload register-parameterized programs (the reference
        writes these registers over the FPGA bus at run time; here they
        seed ``init_regs``).  Kept out of ``get_assembled_program`` so
        its output stays format-identical to the reference's BRAM
        buffers (pinned by the golden-parity tests)."""
        return {core_ind: asm.register_map
                for core_ind, asm in self.assemblers.items()}

    def get_assembled_program(self) -> dict:
        """Returns {core_ind: {'cmd_buf', 'env_buffers', 'freq_buffers'}}."""
        assembled = {}
        for core_ind, asm in self.assemblers.items():
            cmd_buf, env_raw, freq_raw = asm.get_compiled_program()
            assembled[core_ind] = {'cmd_buf': cmd_buf, 'env_buffers': env_raw,
                                   'freq_buffers': freq_raw}
        return assembled
