"""The port's Bloch device (``DeviceModel('bloch')``) against the JAX
package's, on the CPU.

The headline program cut to 2 qubits and depth 2 (active reset + RB) runs
physics-closed with detuning, T1, T2 and depolarization at sigma = 0,
with explicit initial states and the JAX run's own projective-measurement
uniforms substituted into the port (recomputed here as JAX draws them,
``jax.random.uniform(fold_in(PRNGKey(seed), 0x424c4f43), ...)``, and
patched over the port's module-level draw).  On the generic, straight-line
and block engines every output key matches: the integer ones exactly
(a lane whose uniform lies within 1e-6 of its P(1) could round either
way: such tie lanes are counted and none occur), ``bloch``, ``meas_p1``
to atol 1e-5.  Rabi and Ramsey run on the port alone: ``meas_p1``
against the closed forms at the recorded pulse times, and the sampled
bits against ``meas_p1`` within 5 binomial standard errors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
import jax
import jax.numpy as jnp

from distributed_processor_tpu.sim.device import DeviceModel as JDevice
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run)

from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.models import (
    make_default_qchip, rabi_program, ramsey_program)
from distributed_processor_tpu_torch.pipeline import compile_to_machine
from distributed_processor_tpu_torch.sim import physics as tphysics
from distributed_processor_tpu_torch.sim.device import DeviceModel
from distributed_processor_tpu_torch.sim.interpreter import \
    InterpreterConfig as TCfg
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, physics_from_dict, run_physics_batch)

torch.set_num_threads(1)

B = 48
SEED = 5
X90_WORD = 31457          # the default qchip's X90 amplitude word
CLK_S = 2e-9              # DeviceModel.clk_period_s
DEVICE_KW = dict(detuning_hz=50e3, t1_s=80e-6, t2_s=60e-6,
                 depol_per_pulse=1e-3)


def jax_meas_uniforms(seed, shots, C, M):
    """The JAX package's projective-measurement uniforms of a run."""
    return np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0x424c4f43),
        (shots, C, M), jnp.float32))


@pytest.fixture
def jax_uniforms(monkeypatch):
    """Substitute the JAX run's uniforms for the port's draw."""
    def draw(seed, shots, C, M, device):
        return torch.as_tensor(jax_meas_uniforms(seed, shots, C, M),
                               device=device)
    monkeypatch.setattr(tphysics, '_meas_uniforms', draw)


@pytest.fixture(scope='module')
def headline():
    mp_j = bench.build_machine_program(2, 2)
    mp_t = machine_program_from_arrays(machine_program_to_arrays(mp_j))
    cfg = dict(max_steps=2 * mp_j.n_instr + 64,
               max_pulses=int(mp_j.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2)
    init = np.random.default_rng(3).integers(0, 2, (B, 2)).astype(np.int32)
    return mp_j, mp_t, cfg, init


def tie_lanes(out, u) -> int:
    """Measured slots whose uniform lies within 1e-6 of their P(1)."""
    n = out['n_meas'].numpy()[..., None]
    fired = np.arange(u.shape[-1])[None, None, :] < n
    return int((fired & (np.abs(u - out['meas_p1'].numpy()) < 1e-6)).sum())


@pytest.mark.parametrize('engine', [
    dict(straightline=False), dict(straightline=True),
    dict(engine='block')], ids=['generic', 'straightline', 'block'])
def test_bloch_matches_jax(headline, jax_uniforms, engine):
    mp_j, mp_t, cfg, init = headline
    jm = JPhysics(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                  resolve_mode='fused', device=JDevice('bloch', **DEVICE_KW))
    tm = physics_from_dict(dataclasses.asdict(jm))
    out_j = jax_run(mp_j, jm, SEED, B, init_states=init,
                    cfg=JCfg(**cfg, **engine))
    out_t = run_physics_batch(mp_t, tm, SEED, B, init_states=init,
                              cfg=TCfg(**cfg, **engine), device='cpu')
    assert tie_lanes(out_t, jax_meas_uniforms(SEED, B, 2, 2)) == 0
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want, got = np.asarray(out_j[key]), out_t[key].numpy()
        if want.dtype.kind == 'f':
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # the device did something: some readouts were mixed states
    p1 = out_t['meas_p1'].numpy()
    assert np.any((p1 > 0.01) & (p1 < 0.99))
    assert not bool(out_t['err'].any()) and not bool(out_t['incomplete'])


def _run1(prog, model, shots, seed, **kw):
    mp = compile_to_machine(prog, make_default_qchip(1), n_qubits=1)
    out = run_physics_batch(mp, model, seed, shots,
                            init_states=np.zeros((shots, 1), np.int32),
                            max_steps=2000, max_pulses=128, max_meas=4,
                            device='cpu', **kw)
    assert not bool(out['incomplete']) and not bool(out['err'].any())
    return out


def test_rabi_on_the_port():
    """P(1) = sin^2(theta / 2), theta = (pi / 2) amp / x90, at each
    amplitude; the sampled bits' mean within 5 binomial SE of it."""
    model = ReadoutPhysics(sigma=0.0, device=DeviceModel('bloch'))
    shots = 1024
    for amp in (0.0, 0.12, 0.24, 0.48, 0.72, 0.96):
        out = _run1(rabi_program('Q0', amp), model, shots, 7)
        word = int(out['rec_amp'][0, 0, 0])
        want = np.sin(np.pi / 2 * word / X90_WORD / 2) ** 2
        np.testing.assert_allclose(out['meas_p1'][:, 0, 0].numpy(), want,
                                   atol=1e-5)
        mean = float(out['meas_bits'][:, 0, 0].float().mean())
        assert abs(mean - want) <= 5 * np.sqrt(want * (1 - want) / shots)


def test_ramsey_on_the_port():
    """Fringes at the programmed detuning under T2: P(1) = (1 +
    exp(-dt / T2) cos(2 pi delta dt)) / 2 with dt the time between the
    two X90 triggers (recorded), full contrast across the sweep, and the
    sampled bits within 5 binomial SE."""
    det, t2 = 0.7e6, 15e-6
    model = ReadoutPhysics(sigma=0.0, device=DeviceModel(
        'bloch', detuning_hz=det, t2_s=t2))
    shots, p1s = 512, []
    for d in np.linspace(0, 2e-6, 9):
        out = _run1(ramsey_program('Q0', float(d)), model, shots, 11)
        dt = float(out['rec_gtime'][0, 0, 1] - out['rec_gtime'][0, 0, 0]) \
            * CLK_S
        want = (1 + np.exp(-dt / t2) * np.cos(2 * np.pi * det * dt)) / 2
        p1 = out['meas_p1'][:, 0, 0].numpy()
        np.testing.assert_allclose(p1, want, atol=1e-5)
        mean = float(out['meas_bits'][:, 0, 0].float().mean())
        assert abs(mean - want) <= 5 * np.sqrt(want * (1 - want) / shots) \
            + 1e-9
        p1s.append(float(p1[0]))
    assert max(p1s) > 0.9 and min(p1s) < 0.1


def test_bloch_seeds_repeat(headline):
    _mp_j, mp_t, cfg, _init = headline
    model = ReadoutPhysics(sigma=0.05, p1_init=0.3, resolve_chunk=256,
                           device=DeviceModel('bloch', **DEVICE_KW))
    runs = [run_physics_batch(mp_t, model, s, 256, cfg=TCfg(**cfg),
                              device='cpu') for s in (2, 2, 3)]
    assert torch.equal(runs[0]['meas_bits'], runs[1]['meas_bits'])
    assert torch.equal(runs[0]['bloch'], runs[1]['bloch'])
    assert not torch.equal(runs[0]['meas_bits'], runs[2]['meas_bits'])


def test_injected_bits_refuse_bloch(headline):
    """The injected-bits path has no device parameters: the JAX
    package's ValueError."""
    _mp_j, mp_t, cfg, _init = headline
    from distributed_processor_tpu_torch.sim.interpreter import simulate
    with pytest.raises(ValueError, match="device='bloch'"):
        simulate(mp_t, cfg=TCfg(physics=True, device='bloch',
                                x90_amp=X90_WORD, **cfg), device='cpu')
