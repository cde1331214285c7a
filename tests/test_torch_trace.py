"""The port's ``trace=True`` and VCD export against the JAX package's.

With ``trace=True`` every step writes each lane's pc, time and qclk
origin (``trace_pc``, ``trace_time``, ``trace_off`` ``[B, C,
max_steps]``) on the generic engine, which the ladder forces for it.
Every output key, the traces included, equals the JAX run's on the same
injected bits: ``simulate_batch`` and ``simulate`` over an active-reset
program, a looping program (the on-device shot loop) and the 3-core
``lut`` repetition round; the physics-closed run at sigma = 0 with
explicit initial states; ``Simulator.run``.  ``write_vcd`` of the port's
result writes the bytes of JAX's ``write_vcd`` of JAX's result.
"""

import warnings

import numpy as np
import pytest
import torch

from distributed_processor_tpu.models import (
    active_reset as j_active_reset, make_default_qchip as j_qchip,
    rb_program as j_rb_program)
from distributed_processor_tpu.models.experiments import \
    loop_shots_program as j_loop_shots
from distributed_processor_tpu.models.repetition import (
    repetition_config as j_rep_config,
    repetition_round_machine_program as j_rep_round)
from distributed_processor_tpu.pipeline import compile_to_machine as j_compile
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, resolve_engine as j_resolve_engine,
    simulate as j_simulate, simulate_batch as j_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as j_run_physics)
from distributed_processor_tpu.simulator import Simulator as JSimulator
from distributed_processor_tpu.utils.vcd import write_vcd as j_write_vcd

from distributed_processor_tpu_torch import Simulator
from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, resolve_engine, simulate, simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, run_physics_batch)
from distributed_processor_tpu_torch.utils.vcd import write_vcd

torch.set_num_threads(1)

B = 6
QUBITS = ['Q0', 'Q1']
TRACE_KEYS = ('trace_pc', 'trace_time', 'trace_off')


def _to_port(mp):
    return machine_program_from_arrays(machine_program_to_arrays(mp))


def _active_reset():
    prog = j_active_reset(QUBITS) + j_rb_program(QUBITS, 2, seed=3)
    mp = j_compile(prog, j_qchip(2), n_qubits=2)
    return mp, dict(max_steps=2 * mp.n_instr + 16, max_meas=2, max_resets=2)


def _looping():
    body = j_active_reset(QUBITS) + j_rb_program(QUBITS, 1, seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        mp = j_compile(j_loop_shots(body, 2, scope=QUBITS), j_qchip(2),
                       n_qubits=2)
    return mp, dict(mp.static_bounds(), max_meas=6, max_resets=2)


def _lut3():
    cfg = j_rep_config(3)
    kw = {f: getattr(cfg, f) for f in ('max_steps', 'max_pulses',
                                       'max_meas', 'max_resets', 'fabric',
                                       'lut_mask', 'lut_table')}
    return j_rep_round(3), kw


PROGRAMS = {'active_reset': _active_reset, 'looping': _looping,
            'lut3': _lut3}


def _bits(mp, kw, seed, shots=B):
    return np.random.default_rng(seed).integers(
        0, 2, (shots, mp.n_cores, kw['max_meas'])).astype(np.int32)


def _assert_same(out_t, out_j):
    keys = {k for k in out_j if not k.startswith('_')}
    assert keys == {k for k in out_t if not k.startswith('_')}
    for key in sorted(keys):
        want, got = np.asarray(out_j[key]), out_t[key].numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_simulate_batch_trace_matches_jax(name):
    mp, kw = PROGRAMS[name]()
    bits = _bits(mp, kw, 11)
    out_j = j_simulate_batch(mp, bits, cfg=JCfg(trace=True, **kw))
    out_t = simulate_batch(_to_port(mp), bits, cfg=TCfg(trace=True, **kw),
                           device='cpu')
    _assert_same(out_t, out_j)
    steps = int(out_t['steps'])
    assert tuple(out_t['trace_pc'].shape) == (B, mp.n_cores,
                                              kw['max_steps'])
    # every executed step is recorded, nothing past the last one
    assert 0 < steps <= kw['max_steps']
    assert not out_t['trace_time'][:, :, steps:].any()
    assert bool((out_t['trace_time'][:, :, :steps] > 0).all())
    # the untraced run's outputs are the traced run's minus the traces
    plain = simulate_batch(_to_port(mp), bits, cfg=TCfg(**kw), device='cpu')
    assert set(out_t) - set(plain) == set(TRACE_KEYS)
    for key in plain:
        assert torch.equal(plain[key], out_t[key]), key


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_simulate_trace_matches_jax(name):
    mp, kw = PROGRAMS[name]()
    bits = _bits(mp, kw, 12, shots=1)[0]
    out_j = j_simulate(mp, bits, cfg=JCfg(trace=True, **kw))
    out_t = simulate(_to_port(mp), bits, cfg=TCfg(trace=True, **kw),
                     device='cpu')
    _assert_same(out_t, out_j)
    assert tuple(out_t['trace_pc'].shape) == (mp.n_cores, kw['max_steps'])


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_trace_forces_the_generic_engine(name):
    """Every rung but the generic engine refuses trace mode with JAX's
    reason; ``engine=None`` and ``'auto'`` take the generic engine."""
    mp, kw = PROGRAMS[name]()
    mp_t = _to_port(mp)
    for eng in (None, 'auto', 'generic'):
        assert resolve_engine(mp_t, TCfg(trace=True, engine=eng, **kw),
                              'cuda') == 'generic' \
            == j_resolve_engine(mp, JCfg(trace=True, engine=eng, **kw))
    for eng in ('straightline', 'block', 'pallas', 'fused'):
        with pytest.raises(ValueError) as e_j:
            j_resolve_engine(mp, JCfg(trace=True, engine=eng, **kw))
        with pytest.raises(ValueError) as e_t:
            resolve_engine(mp_t, TCfg(trace=True, engine=eng, **kw), 'cuda')
        assert str(e_t.value) == str(e_j.value)


def test_physics_trace_matches_jax():
    """A physics-closed run at sigma = 0 with explicit initial states,
    traced: every key equal, the traces across both epochs included."""
    mp, kw = _active_reset()
    init = np.random.default_rng(4).integers(0, 2, (B, 2)).astype(np.int32)
    kw = dict(kw, max_pulses=int(mp.max_pulses_per_core(1)) + 4,
              record_pulses=True, trace=True)
    model = dict(sigma=0.0, p1_init=0.15, resolve_chunk=256)
    out_j = j_run_physics(mp, JPhysics(**model), 0, B, init_states=init,
                          cfg=JCfg(**kw))
    out_t = run_physics_batch(_to_port(mp), ReadoutPhysics(**model), 0, B,
                              init_states=init, cfg=TCfg(**kw), device='cpu')
    _assert_same(out_t, out_j)
    assert int(out_t['epochs']) == 2


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_write_vcd_bytes_match_jax(name, tmp_path):
    mp, kw = PROGRAMS[name]()
    bits = _bits(mp, kw, 13)
    out_j = j_simulate_batch(mp, bits, cfg=JCfg(trace=True, **kw))
    out_t = simulate_batch(_to_port(mp), bits, cfg=TCfg(trace=True, **kw),
                           device='cpu')
    for shot in (0, B - 1):
        pj, pt = tmp_path / f'j{shot}.vcd', tmp_path / f't{shot}.vcd'
        n_j = j_write_vcd(str(pj), out_j, shot=shot,
                          core_labels=list(mp.core_inds))
        n_t = write_vcd(str(pt), out_t, shot=shot,
                        core_labels=list(mp.core_inds))
        assert n_t == n_j > 0
        assert pt.read_bytes() == pj.read_bytes()
    # one core, and the unbatched run
    write_vcd(str(tmp_path / 'c.vcd'), out_t, shot=1, cores=[0])
    j_write_vcd(str(tmp_path / 'cj.vcd'), out_j, shot=1, cores=[0])
    assert (tmp_path / 'c.vcd').read_bytes() \
        == (tmp_path / 'cj.vcd').read_bytes()
    one_j = j_simulate(mp, bits[0], cfg=JCfg(trace=True, **kw))
    one_t = simulate(_to_port(mp), bits[0], cfg=TCfg(trace=True, **kw),
                     device='cpu')
    assert write_vcd(str(tmp_path / 'o.vcd'), one_t) \
        == j_write_vcd(str(tmp_path / 'oj.vcd'), one_j)
    assert (tmp_path / 'o.vcd').read_bytes() \
        == (tmp_path / 'oj.vcd').read_bytes()


def test_rounds_and_ensemble_trace_match_jax():
    """The lane-folded entry points trace too: ``simulate_rounds`` (3
    rounds of the ``lut`` round, a leading round axis) and
    ``simulate_multi_batch`` (3 programs), every key equal to JAX's."""
    from distributed_processor_tpu.models import rb_ensemble as j_ens
    from distributed_processor_tpu.sim.interpreter import (
        simulate_multi_batch as j_multi, simulate_rounds as j_rounds)
    from distributed_processor_tpu_torch.sim.interpreter import (
        simulate_multi_batch, simulate_rounds)
    mp, kw = _lut3()
    bits = np.random.default_rng(16).integers(0, 2, (3, 4, 3, 2)) \
        .astype(np.int32)
    cfg = dict(kw, engine='generic', trace=True)
    out_j = j_rounds(mp, bits, cfg=JCfg(**cfg))
    out_t = simulate_rounds(_to_port(mp), bits, cfg=TCfg(**cfg),
                            device='cpu')
    _assert_same(out_t, out_j)
    assert tuple(out_t['trace_pc'].shape) == (3, 4, 3, kw['max_steps'])
    mps = [j_compile(j_active_reset(QUBITS) + p, j_qchip(2), n_qubits=2)
           for p in j_ens(QUBITS, 2, 3, seed=1)]
    bits = np.random.default_rng(17).integers(0, 2, (3, 4, 2, 2)) \
        .astype(np.int32)
    kw = dict(max_meas=2, max_resets=2, max_steps=60, trace=True)
    out_j = j_multi(mps, bits, **kw)
    out_t = simulate_multi_batch([_to_port(m) for m in mps], bits,
                                 device='cpu', **kw)
    _assert_same(out_t, out_j)


def test_write_vcd_refuses_like_jax(tmp_path):
    mp, kw = _active_reset()
    bits = _bits(mp, kw, 14)
    for cfg_kw, shot in (({}, 0), ({'trace': True, 'record_pulses': False},
                                   0), ({'trace': True}, None)):
        out_j = j_simulate_batch(mp, bits, cfg=JCfg(**dict(kw, **cfg_kw)))
        out_t = simulate_batch(_to_port(mp), bits,
                               cfg=TCfg(**dict(kw, **cfg_kw)), device='cpu')
        with pytest.raises(ValueError) as e_j:
            j_write_vcd(str(tmp_path / 'j.vcd'), out_j, shot=shot)
        with pytest.raises(ValueError) as e_t:
            write_vcd(str(tmp_path / 't.vcd'), out_t, shot=shot)
        assert str(e_t.value) == str(e_j.value)


def test_simulator_run_trace_matches_jax():
    """The facade: ``Simulator.run(program, trace=True)`` of OpenQASM
    text, every key equal to the JAX facade's run."""
    src = ('OPENQASM 3; qubit[2] q; bit[2] c; reset q[0]; h q[1]; '
           'c[1] = measure q[1]; if (c[1] == 1) { x q[0]; } '
           'c[0] = measure q[0];')
    bits = np.random.default_rng(15).integers(0, 2, (4, 2, 4)) \
        .astype(np.int32)
    out_t = Simulator(n_qubits=2, device='cpu').run(src, shots=4,
                                                    meas_bits=bits,
                                                    trace=True)
    out_j = JSimulator(n_qubits=2).run(src, shots=4, meas_bits=bits,
                                       trace=True)
    _assert_same(out_t, out_j)
    assert set(TRACE_KEYS) <= set(out_t)
