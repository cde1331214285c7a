"""The port's generic interpreter against the JAX generic engine.

Same program, same injected measurement bits, same config: every output
key of ``simulate_batch`` — pulse records, registers, clocks, ``err``,
``fault``, the opcode histogram, ``steps`` — must be identical, value and
dtype.  Programs: the golden programs, the RTL-derived timing vectors
(tests/goldens/rtl_timing_vectors.json), the oracle fuzz programs of
tests/test_interpreter.py, and a feedback fuzz with measurement pulses,
fproc reads (in and out of range), sync barriers, qclk loads and
register-sourced pulse parameters, under the sticky and fresh fabrics.
The port receives each JAX-compiled program through
``machine_program_from_arrays``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from distributed_processor_tpu import isa, models, pipeline
from distributed_processor_tpu.decoder import machine_program_from_cmds
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate_batch as torch_simulate_batch)

from test_interpreter import _random_program

_RTL = os.path.join(os.path.dirname(__file__), 'goldens',
                    'rtl_timing_vectors.json')
with open(_RTL) as f:
    RTL_CASES = json.load(f)['cases']

B = 8


def _to_port(mp):
    return machine_program_from_arrays(machine_program_to_arrays(mp))


def assert_same_as_jax(mp, meas_bits, init_regs=None, **kw):
    """Run both engines; every output key equal in value and dtype."""
    out_j = jax_simulate_batch(mp, meas_bits, init_regs=init_regs,
                               cfg=JCfg(engine='generic', **kw))
    out_t = torch_simulate_batch(_to_port(mp), meas_bits,
                                 init_regs=init_regs, cfg=TCfg(**kw),
                                 device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)
    return out_t


def _bits(rng, mp, m=4):
    return rng.integers(0, 2, (B, mp.n_cores, m)).astype(np.int32)


def _golden_cases():
    cases = []
    for name in sorted(GOLDEN_PROGRAMS):
        fabrics = ('sticky', 'fresh') if name in (
            'active_reset_2q', 'fproc_hold') else ('sticky',)
        cases += [(name, fab) for fab in fabrics]
    return cases


@pytest.mark.parametrize('name,fabric', _golden_cases())
def test_golden_programs(name, fabric):
    n, thunk = J_GOLDEN_PROGRAMS[name]      # the JAX compile
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        mp = pipeline.compile_to_machine(
            thunk(), models.make_default_qchip(max(n, 2)), n_qubits=n)
    rng = np.random.default_rng(sum(map(ord, name)))
    assert_same_as_jax(mp, _bits(rng, mp), fabric=fabric, max_meas=4,
                       max_steps=300, opcode_histogram=True)


def _rtl_program(case):
    return machine_program_from_cmds(
        [[getattr(isa, ins['fn'])(**ins['kw']) for ins in core]
         for core in case['cores']])


@pytest.mark.parametrize('case', RTL_CASES, ids=[c['name'] for c in RTL_CASES])
def test_rtl_timing_vectors(case):
    mp = _rtl_program(case)
    rng = np.random.default_rng(7)
    meas = _bits(rng, mp)
    if case.get('meas_bits') is not None:
        fixed = np.asarray(case['meas_bits'], np.int32)
        meas[:, :, :fixed.shape[-1]] = fixed[None, :, :4]
    fabric = case.get('fabric', 'sticky')
    kw = dict(fabric=fabric, max_meas=4)
    if fabric == 'lut':
        kw.update(lut_mask=tuple(case['lut_mask']),
                  lut_table=tuple(case['lut_table']))
    out = assert_same_as_jax(mp, meas, **kw)
    # the vectors' own expectations hold on the port too
    exp = case['expected']
    for key in ('time', 'qclk'):
        for c, want in enumerate(exp.get(key, [])):
            assert int(out[key][0, c]) == want, (key, c)


@pytest.mark.parametrize('fabric', ['sticky', 'fresh'])
@pytest.mark.parametrize('seed', range(4))
def test_oracle_fuzz_programs(seed, fabric):
    rng = np.random.default_rng(100 + seed)
    mp = _random_program(rng)
    assert_same_as_jax(mp, _bits(rng, mp, 8), fabric=fabric, max_pulses=64,
                       max_meas=8)


def _feedback_program(rng, n_cores=3, n_instr=24):
    """Random halting programs that exercise the fabric: measurement
    pulses (element 2), fproc reads of any core (rarely one id past the
    last core), forward fproc branches, sync barriers at the same
    positions on every core, qclk loads, resets, idles and
    register-sourced pulse parameters."""
    kinds = ['alu'] * 2 + ['pulse'] * 4 + ['reg_pulse', 'read', 'branch',
                                           'qclk', 'idle']
    syncs = set(rng.choice(n_instr, 2, replace=False).tolist())
    progs = []
    for _ in range(n_cores):
        cmds, t = [], 40
        for i in range(n_instr):
            kind = kinds[int(rng.integers(len(kinds)))]
            if i in syncs:
                cmds.append(isa.sync(0))
            elif kind == 'alu':
                cmds.append(isa.alu_cmd(
                    'reg_alu', 'i', int(rng.integers(-1000, 1000)),
                    list(isa.ALU_OPS)[int(rng.integers(8))],
                    int(rng.integers(4)),
                    write_reg_addr=int(rng.integers(4))))
            elif kind == 'pulse':
                t += int(rng.integers(10, 80))
                cmds.append(isa.pulse_cmd(
                    freq_word=int(rng.integers(1 << 9)),
                    phase_word=int(rng.integers(1 << 17)),
                    amp_word=int(rng.integers(1 << 16)),
                    env_word=(int(rng.integers(1, 8)) << 12),
                    cfg_word=int(rng.integers(3)), cmd_time=t))
            elif kind == 'reg_pulse':
                cmds.append(isa.pulse_cmd(amp_regaddr=int(rng.integers(4))))
            elif kind == 'read':
                fid = n_cores if rng.random() < 0.1 \
                    else int(rng.integers(n_cores))
                cmds.append(isa.alu_cmd(
                    'alu_fproc', 'i', int(rng.integers(-2, 3)),
                    list(isa.ALU_OPS)[int(rng.integers(8))],
                    func_id=fid, write_reg_addr=int(rng.integers(4))))
            elif kind == 'branch':
                target = len(cmds) + 1 + int(rng.integers(1, 3))
                cmds.append(isa.alu_cmd(
                    'jump_fproc', 'i', int(rng.integers(0, 2)),
                    rng.choice(['eq', 'le', 'ge']),
                    func_id=int(rng.integers(n_cores)),
                    jump_cmd_ptr=min(target, n_instr)))
            elif kind == 'qclk':
                cmds.append(isa.alu_cmd('inc_qclk', 'i',
                                        int(rng.integers(-50, 50))))
            else:
                t += int(rng.integers(150))
                cmds.append(isa.idle(t) if rng.integers(2)
                            else isa.pulse_reset())
            t += 60
        cmds.append(isa.done_cmd())
        progs.append(cmds)
    return machine_program_from_cmds(progs)


@pytest.mark.parametrize('fabric', ['sticky', 'fresh'])
@pytest.mark.parametrize('seed', range(4))
def test_feedback_fuzz_programs(seed, fabric):
    rng = np.random.default_rng(500 + seed)
    mp = _feedback_program(rng)
    init = rng.integers(-5, 5, (B, mp.n_cores, isa.N_REGS)).astype(np.int32)
    out = assert_same_as_jax(mp, _bits(rng, mp), init_regs=init,
                             fabric=fabric, max_meas=4, max_pulses=16,
                             max_steps=200)
    assert int(out['steps']) > 0


def test_sticky_race_window_edges():
    """A reader whose request lands at every clock around a producer's
    measurement arrival: the served bit and the ERR_STICKY_RACE flag at
    both edges of the race window agree with JAX."""
    flagged = set()
    meas = np.ones((2, 2, 4), np.int32)
    for t in range(60, 86):
        mp = machine_program_from_cmds([
            [isa.pulse_cmd(env_word=1 << 12, cfg_word=2, cmd_time=10),
             isa.done_cmd()],
            [isa.idle(t), isa.read_fproc(0, 1), isa.done_cmd()]])
        out = assert_same_as_jax(mp, meas, fabric='sticky', max_meas=4)
        if int(out['err'][0, 1]) & 64:
            flagged.add(t)
    # the window is 2 * STICKY_RACE_MARGIN clocks wide, edges included
    assert len(flagged) == 4, sorted(flagged)


@pytest.mark.parametrize('fabric', ['sticky', 'fresh'])
def test_read_of_finished_producer(fabric):
    """A read of a core that finished without measuring: the fresh
    fabric serves it as a deadlock (0, ERR_FPROC_DEADLOCK) and the
    reader runs on; the sticky fabric serves the latched 0."""
    mp = machine_program_from_cmds([
        [isa.done_cmd()],
        [isa.read_fproc(0, 1),
         isa.pulse_cmd(amp_word=5, env_word=1 << 12, cmd_time=100),
         isa.done_cmd()]])
    out = assert_same_as_jax(mp, np.ones((2, 2, 4), np.int32),
                             fabric=fabric, max_meas=4)
    assert out['n_pulses'][:, 1].tolist() == [1, 1]


def test_engine_selection():
    mp_j = _random_program(np.random.default_rng(1))
    mp = _to_port(mp_j)
    meas = np.zeros((2, mp.n_cores, 2), np.int32)
    ref = torch_simulate_batch(mp, meas, device='cpu')
    for kw in ({}, {'engine': 'generic'}, {'engine': 'auto'},
               {'straightline': None}, {'engine': 'straightline'},
               {'engine': 'pallas'}, {'straightline': True},
               {'engine': 'block'}):
        out = torch_simulate_batch(mp, meas, device='cpu', **kw)
        for key in ref:
            if key != 'steps':
                assert torch.equal(out[key], ref[key]), (kw, key)
    # trace mode runs on the generic engine, every key (the per-step
    # traces included) equal to the JAX package's
    traced = assert_same_as_jax(mp_j, meas, trace=True)
    assert {'trace_pc', 'trace_time', 'trace_off'} <= set(traced)
    # a set cores_axis: the JAX package's ValueError, message and all
    with pytest.raises(ValueError, match='sharded_cores_simulate') as e_t:
        torch_simulate_batch(mp, meas, device='cpu', cores_axis='cores')
    with pytest.raises(ValueError) as e_j:
        jax_simulate_batch(mp_j, meas, cores_axis='cores')
    assert str(e_t.value) == str(e_j.value)
    # the fused engine closes the physics loop: not on injected bits
    with pytest.raises(ValueError, match='fused'):
        torch_simulate_batch(mp, meas, device='cpu', engine='fused')
    with pytest.raises(ValueError):
        torch_simulate_batch(mp, meas, device='cpu', engine='nope')


def _reset_program(n_cores: int):
    """Each of ``n_cores`` cores measures, waits for the result and
    reads its own bit through the fabric into a register."""
    cores = []
    for c in range(n_cores):
        cores.append([
            isa.pulse_cmd(amp_word=3, env_word=1 << 12, cfg_word=2,
                          cmd_time=5),
            isa.idle(400),
            isa.read_fproc(c, 1),
            isa.done_cmd()])
    return machine_program_from_cmds(cores)


@pytest.mark.parametrize('n_cores,bit_cores,fabric,engine', [
    (1, 2, 'sticky', None), (1, 2, 'fresh', None), (1, 3, 'sticky', None),
    (1, 2, 'sticky', 'generic'), (1, 2, 'sticky', 'block'),
    (2, 1, 'sticky', None), (2, 1, 'fresh', 'block'),
    (1, 2, 'sticky', 'straightline'), (1, 2, 'sticky', 'auto'),
    (2, 3, 'sticky', None)])
def test_meas_bits_core_axis(n_cores, bit_cores, fabric, engine):
    """``meas_bits`` whose core axis differs from the program's: every
    key equal to the JAX package's run (a one-core program reads the
    rows' sum, valid only from one row; one row broadcasts to every
    core), or JAX's error type where JAX raises (the straight-line
    executor, and axes that do not broadcast)."""
    mp_j = _reset_program(n_cores)
    bits = np.random.default_rng(n_cores + bit_cores).integers(
        0, 2, (B, bit_cores, 2)).astype(np.int32)
    kw = dict(fabric=fabric, max_meas=2)
    if engine in ('straightline', 'auto') or bit_cores > 1 < n_cores:
        # the port raises JAX's TypeError; JAX's straight-line executor
        # raises it or returns a state whose core axes disagree (the
        # bits' on done/pc/regs, the program's on the records)
        with pytest.raises(TypeError):
            torch_simulate_batch(_to_port(mp_j), bits,
                                 cfg=TCfg(engine=engine, **kw),
                                 device='cpu')
        try:
            out_j = jax_simulate_batch(mp_j, bits,
                                       cfg=JCfg(engine=engine, **kw))
        except TypeError:
            return
        assert engine in ('straightline', 'auto')
        assert np.asarray(out_j['done']).shape[1] \
            != np.asarray(out_j['n_pulses']).shape[1]
        return
    out_j = jax_simulate_batch(mp_j, bits, cfg=JCfg(engine=engine, **kw))
    out_t = torch_simulate_batch(_to_port(mp_j), bits,
                                 cfg=TCfg(engine=engine, **kw), device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    if bit_cores > 1:
        # several rows for one core: every read of a measured bit stalls
        assert (out_t['err'].numpy() & 8).all()
