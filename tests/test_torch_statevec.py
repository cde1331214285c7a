"""The port's statevec device (``DeviceModel('statevec')``) against the
JAX package's, on the CPU.

The state is one ``[shots, 2^C]`` complex64 trajectory per shot on the
generic engine, behind the discrete-event gate.  Against JAX
``run_physics_batch`` the port runs with the JAX run's own random numbers
substituted (the projective-measurement uniforms, ``fold_in(key,
0x424c4f43)``, and each step's trajectory uniforms, ``fold_in(fold_in(key,
0x53563251), step)``, recomputed here and patched over the port's
module-level draws), so even the stochastic channels are held shot for
shot: ``meas_bits``, ``leaked``, ``meas_class``, ``err`` (with
``ERR_COFIRE_ORDER``) and every other integer key identical, ``|psi|^2``
and the float keys to atol 1e-5.  The cases: GHZ-3 through the compiled
CNOT chain; GHZ-2 with every channel on (detuning, T1, T2, 1q and 2q
depolarization, both leakage channels, seepage); the deterministic
leakage of tests/test_leakage.py (``leak_per_pulse = 1.0``); IQ-level
leakage readout with 3-class discrimination; the co-fire lint cases of
tests/test_cofire.py; the event-gate no-deadlock cases of
tests/test_device_statevec.py.  On the port alone: the CNOT truth table,
GHZ-3 and GHZ-8 parity, the core cap and the coupling-map warning.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu.pipeline import compile_to_machine as j_compile
from distributed_processor_tpu.models import (
    couplings_from_qchip as j_couplings, ghz_program as j_ghz,
    make_default_qchip as j_qchip)
from distributed_processor_tpu.sim.device import DeviceModel as JDevice
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run)

from distributed_processor_tpu_torch import isa
from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_from_cmds,
    machine_program_to_arrays)
from distributed_processor_tpu_torch.models import (
    couplings_from_qchip, ghz_program, make_default_qchip)
from distributed_processor_tpu_torch.pipeline import compile_to_machine
from distributed_processor_tpu_torch.sim import interpreter as tinterp
from distributed_processor_tpu_torch.sim import physics as tphysics
from distributed_processor_tpu_torch.sim.device import (DeviceModel,
                                                        STATEVEC_MAX_CORES)
from distributed_processor_tpu_torch.sim.interpreter import ERR_COFIRE_ORDER
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, physics_from_dict, run_physics_batch)

torch.set_num_threads(1)

PI_PULSE = {'name': 'pulse', 'dest': 'Q0.qdrv', 'freq': 4.2e9,
            'phase': 0.0, 'amp': 0.96, 'twidth': 24e-9,
            'env': {'env_func': 'square', 'paradict': {}}}
READ = lambda q: {'name': 'read', 'qubit': [q]}


@pytest.fixture
def jax_draws(monkeypatch):
    """Substitute the JAX run's measurement and trajectory uniforms for
    the port's draws (the run's key is ``PRNGKey(seed)``)."""
    state = {}

    def meas(seed, shots, C, M, device):
        key = jax.random.PRNGKey(seed)
        state['traj'] = jax.random.fold_in(key, 0x53563251)
        return torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(key, 0x424c4f43), (shots, C, M),
            jnp.float32)), device=device)

    def traj(seed, step, shape, device):
        return torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(state['traj'], step), shape, jnp.float32)),
            device=device)
    monkeypatch.setattr(tphysics, '_meas_uniforms', meas)
    monkeypatch.setattr(tinterp, '_traj_uniforms', traj)


def _to_port(mp_j):
    return machine_program_from_arrays(machine_program_to_arrays(mp_j))


def _assert_matches(out_t, out_j):
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want, got = np.asarray(out_j[key]), out_t[key].numpy()
        if key == 'psi':
            np.testing.assert_allclose(np.abs(got) ** 2, np.abs(want) ** 2,
                                       atol=1e-5, err_msg=key)
        elif want.dtype.kind == 'f':
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _run_both(mp_j, model_kw, shots, seed, init=None, **kw):
    """The same model on the JAX program and its port copy, from the
    same initial states (thermal ones drawn with numpy when not given)."""
    if init is None:
        p1 = model_kw.get('p1_init', 0.1)
        init = (np.random.default_rng(seed).random((shots, mp_j.n_cores))
                < p1).astype(np.int32)
    jm = JPhysics(**model_kw)
    tm = physics_from_dict(dataclasses.asdict(jm))
    out_j = jax_run(mp_j, jm, seed, shots, init_states=init, **kw)
    out_t = run_physics_batch(_to_port(mp_j), tm, seed, shots,
                              init_states=init, device='cpu', **kw)
    return out_t, out_j


def _compiled(prog, n):
    mp_j = j_compile(prog, j_qchip(n), n_qubits=n)
    return mp_j, j_couplings(mp_j, j_qchip(n))


ALL_CHANNELS = dict(detuning_hz=1e5, t1_s=20e-6, t2_s=15e-6,
                    depol_per_pulse=0.02, depol2_per_pulse=0.05,
                    leak_per_pulse=0.1, leak2_per_pulse=0.1,
                    seep_per_pulse=0.2)


def _case(name):
    """``(mp_j, model_kw, shots, seed, run_kw)`` of a JAX comparison."""
    kw = dict(max_steps=4000, max_pulses=64, max_meas=4)
    if name == 'ghz3':
        mp_j, cps = _compiled(j_ghz(['Q0', 'Q1', 'Q2']), 3)
        return mp_j, dict(sigma=0.0, p1_init=0.0, device=JDevice(
            'statevec', couplings=cps)), 64, 5, kw
    if name == 'ghz2_all_channels':
        mp_j, cps = _compiled(j_ghz(['Q0', 'Q1']), 2)
        return mp_j, dict(sigma=0.0, p1_init=0.2, device=JDevice(
            'statevec', couplings=cps, **ALL_CHANNELS)), 96, 6, kw
    if name == 'leak_deterministic':
        mp_j, cps = _compiled([dict(PI_PULSE)] * 4 + [READ('Q0')], 2)
        return mp_j, dict(sigma=0.0, p1_init=0.0, device=JDevice(
            'statevec', couplings=cps, leak_per_pulse=1.0)), 32, 1, kw
    if name == 'iq_classify3':
        mp_j, cps = _compiled([dict(PI_PULSE), READ('Q0'), READ('Q0')], 2)
        return mp_j, dict(sigma=0.0, p1_init=0.0, g2=-0.9 - 0.4j,
                          classify3=True, device=JDevice(
                              'statevec', couplings=cps,
                              leak_per_pulse=0.5)), 64, 11, kw
    raise KeyError(name)


@pytest.mark.parametrize('name', ['ghz3', 'ghz2_all_channels',
                                  'leak_deterministic', 'iq_classify3'])
def test_statevec_matches_jax(jax_draws, name):
    mp_j, model_kw, shots, seed, kw = _case(name)
    out_t, out_j = _run_both(mp_j, model_kw, shots, seed, **kw)
    _assert_matches(out_t, out_j)
    assert not bool(out_t['incomplete'])
    if name == 'leak_deterministic':
        assert bool(out_t['leaked'][:, 0].all())
        assert bool((out_t['meas_bits'][:, 0, 0] == 1).all())
    if name == 'iq_classify3':
        leaked = out_t['leaked'][:, 0]
        cls = out_t['meas_class'][:, 0, :2]
        assert 0 < int(leaked.sum()) < len(leaked)
        assert bool((cls[leaked] == 2).all())
        assert bool((cls[~leaked] == 1).all())
        assert bool((out_t['meas_bits'][:, 0, :2] == 1).all())
    if name == 'ghz2_all_channels':
        assert bool(out_t['leaked'].any())


def _cofire_pair(c1_t, kind, c1_meas=False, c1_phase=40000):
    """tests/test_cofire.py's two-core case in both packages: core 0
    fires a coupling pulse at 100, core 1 a 1q drive or a measurement."""
    def cmds(m):
        return [
            [m.pulse_cmd(cmd_time=100, cfg_word=0, env_word=4096,
                         amp_word=20000, phase_word=0), m.done_cmd()],
            [m.pulse_cmd(cmd_time=c1_t, cfg_word=2 if c1_meas else 0,
                         env_word=(8 << 12) if c1_meas else 4096,
                         amp_word=30000, phase_word=c1_phase),
             m.done_cmd()]]
    mp_j = j_from_cmds(cmds(jisa))
    if c1_meas:
        for t in mp_j.tables:
            t.envs[2] = np.ones(32, complex)
            t.freqs[2] = {'freq': np.array([0.0]),
                          'iq15': np.zeros((1, 15))}
    return mp_j, ((0, 0, 1, kind),)


def _shared_target(ph1):
    mp_j = j_from_cmds([
        [jisa.pulse_cmd(cmd_time=100, cfg_word=0, env_word=4096,
                        amp_word=20000, phase_word=0), jisa.done_cmd()],
        [jisa.pulse_cmd(cmd_time=100, cfg_word=0, env_word=4096,
                        amp_word=20000, phase_word=ph1), jisa.done_cmd()],
        [jisa.done_cmd()]])
    return mp_j, ((0, 0, 2, 'zx'), (1, 0, 2, 'zx'))


_COFIRE = {
    'zx_target_drive': (lambda: _cofire_pair(100, 'zx'), True),
    'zx_same_axis': (lambda: _cofire_pair(100, 'zx', c1_phase=1 << 16),
                     False),
    'zz_target_drive': (lambda: _cofire_pair(100, 'zz'), True),
    'zx_target_measurement': (lambda: _cofire_pair(100, 'zx', True), True),
    'zz_measurement': (lambda: _cofire_pair(100, 'zz', True), False),
    'separated': (lambda: _cofire_pair(200, 'zx'), False),
    'shared_target_axes': (lambda: _shared_target(40000), True),
}


@pytest.mark.parametrize('name', sorted(_COFIRE))
def test_cofire_lint_matches_jax(jax_draws, name):
    build, flagged = _COFIRE[name]
    mp_j, cps = build()
    out_t, out_j = _run_both(mp_j, dict(sigma=0.0, device=JDevice(
        'statevec', couplings=cps)), 4, 0, max_steps=256)
    _assert_matches(out_t, out_j)
    assert not bool(out_t['incomplete'])
    hit = (out_t['err'] & ERR_COFIRE_ORDER) != 0
    assert bool(hit[:, 0].all()) if flagged else not bool(hit.any())


def _gate_sync(m):
    return [[m.pulse_cmd(cmd_time=500, cfg_word=0), m.sync(0), m.done_cmd()],
            [m.sync(0), m.pulse_cmd(cmd_time=20, cfg_word=0),
             m.done_cmd()]], {}


def _gate_fproc(m):
    return [[m.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=2,
                       func_id=1),
             m.jump_i(3),
             m.pulse_cmd(cmd_time=900, cfg_word=0, env_word=(2 << 12)),
             m.done_cmd()],
            [m.pulse_cmd(cmd_time=400, cfg_word=2, env_word=(2 << 12)),
             m.done_cmd()]], dict(fabric='fresh')


def _gate_sticky(m):
    return [[m.pulse_cmd(cmd_time=10, cfg_word=2, env_word=(8 << 12),
                         amp_word=30000),
             m.pulse_cmd(cmd_time=1000, cfg_word=0, env_word=4096),
             m.done_cmd()],
            [m.idle(114),
             m.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                       func_id=0),
             m.jump_i(4),
             m.pulse_cmd(cmd_time=130, cfg_word=0, env_word=4096),
             m.done_cmd()]], dict(fabric='sticky')


def _gate_chain(m):
    return [[m.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=2,
                       func_id=1), m.jump_i(2), m.done_cmd()],
            [m.sync(0), m.pulse_cmd(cmd_time=5, cfg_word=2, env_word=0),
             m.done_cmd()],
            [m.pulse_cmd(cmd_time=100, cfg_word=0, env_word=4096),
             m.sync(0), m.done_cmd()]], dict(fabric='fresh')


@pytest.mark.parametrize('build', [_gate_sync, _gate_fproc, _gate_sticky,
                                   _gate_chain],
                         ids=['sync', 'fproc', 'sticky', 'chain'])
def test_event_gate_no_deadlock_matches_jax(jax_draws, build):
    """tests/test_device_statevec.py's regressions: the gate neither
    deadlocks against a sync-stalled core, nor against a reader waiting
    on an unfired measurement (directly or through a chain), and a
    sticky read whose producer sits at a far trigger is served."""
    cmds, kw = build(jisa)
    mp_j = j_from_cmds(cmds)
    if build is _gate_sticky:
        for t in mp_j.tables:
            t.envs[2] = np.ones(32, complex)
            t.freqs[2] = {'freq': np.array([0.0]),
                          'iq15': np.zeros((1, 15))}
        init = np.ones((4, 2), np.int32)
    else:
        init = None
    out_t, out_j = _run_both(mp_j, dict(
        sigma=0.0, p1_init=1.0 if init is not None else 0.1,
        device=JDevice('statevec', couplings=((0, 0, 1, 'zx'),))), 4, 0,
        init, max_steps=512, **kw)
    _assert_matches(out_t, out_j)
    assert not bool(out_t['incomplete'])
    assert not bool(out_t['err'].any())
    if build is _gate_sticky:
        assert bool((out_t['n_pulses'][:, 1] == 1).all())


def _port_ghz(n, shots, seed, **kw):
    mp = compile_to_machine(ghz_program([f'Q{i}' for i in range(n)]),
                            make_default_qchip(n), n_qubits=n)
    cps = couplings_from_qchip(mp, make_default_qchip(n))
    assert len(cps) == n - 1
    model = ReadoutPhysics(sigma=0.0, device=DeviceModel(
        'statevec', couplings=cps))
    out = run_physics_batch(mp, model, seed, shots,
                            init_states=np.zeros((shots, n), np.int32),
                            device='cpu', **kw)
    assert not bool(out['incomplete']) and not bool(out['err'].any())
    return out['meas_bits'][:, :, 0].numpy()


@pytest.mark.parametrize('n, shots', [(3, 256), (8, 32)],
                         ids=['ghz3', 'ghz8'])
def test_ghz_parity_on_the_port(n, shots):
    """Every shot's bits agree across the chain; the marginal is within
    5 binomial SE of 1/2."""
    bits = _port_ghz(n, shots, 2, max_steps=40000, max_pulses=256,
                     max_meas=4)
    assert np.all(bits == bits[:, :1])
    assert abs(bits[:, 0].mean() - 0.5) < 5 * 0.5 / np.sqrt(shots)


def test_cnot_truth_table_on_the_port():
    mp = compile_to_machine(
        [{'name': 'CNOT', 'qubit': ['Q0', 'Q1']},
         {'name': 'barrier', 'qubit': ['Q0', 'Q1']}, READ('Q0'), READ('Q1')],
        make_default_qchip(2), n_qubits=2)
    model = ReadoutPhysics(sigma=0.0, device=DeviceModel(
        'statevec', couplings=couplings_from_qchip(mp,
                                                   make_default_qchip(2))))
    init = np.array([[0, 0], [0, 1], [1, 0], [1, 1]] * 4, np.int32)
    out = run_physics_batch(mp, model, 0, len(init), init_states=init,
                            max_steps=4000, max_pulses=64, max_meas=4,
                            device='cpu')
    assert not bool(out['err'].any())
    bits = out['meas_bits'][:, :, 0].numpy()
    np.testing.assert_array_equal(bits[:, 0], init[:, 0])
    np.testing.assert_array_equal(bits[:, 1], init[:, 1] ^ init[:, 0])


def test_core_cap_and_coupling_warning():
    wide = machine_program_from_cmds(
        [[isa.pulse_cmd(cmd_time=10), isa.done_cmd()]]
        * (STATEVEC_MAX_CORES + 1))
    with pytest.raises(ValueError, match='exceeds the cap'):
        run_physics_batch(wide, ReadoutPhysics(
            device=DeviceModel('statevec')), 0, 1, device='cpu')
    # a CNOT's cross-resonance tone with no coupling map: the JAX
    # package's warning
    mp = compile_to_machine(
        [{'name': 'CNOT', 'qubit': ['Q0', 'Q1']}, READ('Q1')],
        make_default_qchip(2), n_qubits=2)
    with pytest.warns(UserWarning, match='cross-resonance signature'):
        run_physics_batch(mp, ReadoutPhysics(
            sigma=0.0, device=DeviceModel('statevec')), 0, 2,
            max_steps=4000, max_pulses=64, max_meas=4, device='cpu')
