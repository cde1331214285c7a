"""The calibration user's analysis layer in the port against the JAX
package's: the curve fits, readout calibration, register-parameterized
sweeps and the scalar golden model.

* ``analysis.fit_exp_decay`` / ``fit_t1`` / ``fit_rb`` / ``fit_ramsey``:
  the same Levenberg-Marquardt (100 iterations, float32) on the same
  data, the parameters within rtol 1e-4 of JAX's — and, for one whose
  value is near 0 (an offset, a phase), within 1e-4 of the curve's
  amplitude — (two float32 solvers whose Jacobians and 3x3 / 5x5 solves
  round differently) and within the JAX test's tolerances of the truth.
* ``models.calibration``: ``fit_centroids``, ``assignment_matrix`` and
  ``readout_fidelity`` exactly equal on the same IQ arrays (dyadic
  points, so every order of summation is exact; float32-close on
  Gaussian ones); ``calibrate_readout``'s fidelity within 5 standard
  errors of JAX's (the draws differ: a torch generator against a
  threefry key).
* ``parallel.param_sweep``: the swept program's bytes, ``grid_init_regs``
  and ``sweep_cfg`` identical, and the grid's run identical.
* ``sim.oracle.run_oracle`` (a copy): identical to JAX's on the random
  compiled programs of tests/test_fuzz_pipeline.py and the branch program
  of tests/test_param_sweep.py, and the port's engine equal to it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from distributed_processor_tpu import analysis as jan
from distributed_processor_tpu.models import calibration as jcal
from distributed_processor_tpu.models.readout import \
    IQReadoutModel as JIQModel
from distributed_processor_tpu.parallel import param_sweep as jps
from distributed_processor_tpu.sim import oracle as jorc
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch import analysis as tan
from distributed_processor_tpu_torch.decoder import machine_program_to_arrays
from distributed_processor_tpu_torch.models import calibration as tcal
from distributed_processor_tpu_torch.models.readout import \
    IQReadoutModel as TIQModel
from distributed_processor_tpu_torch.parallel import param_sweep as tps
from distributed_processor_tpu_torch.sim import oracle as torc
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate, simulate_batch)

from test_fuzz_pipeline import _random_program
from test_torch_compile import _assert_arrays_equal
from test_torch_interpreter import _to_port

FIT_RTOL = 1e-4


def _exp_data():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 100e-6, 40)
    return x, 0.9 * np.exp(-x / 25e-6) + 0.05 + rng.normal(0, 0.01, x.shape)


def _rb_data():
    rng = np.random.default_rng(1)
    depths = np.array([1, 2, 4, 8, 16, 32, 64, 128])
    return depths, 0.48 * 0.985 ** depths + 0.5 \
        + rng.normal(0, 0.004, depths.shape)


def _ramsey_data():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 20e-6, 200)
    return t, 0.45 * np.exp(-t / 8e-6) * np.cos(2 * np.pi * 350e3 * t) \
        + 0.5 + rng.normal(0, 0.01, t.shape)


def _close(got, want, what, scale=0.0):
    """Within ``FIT_RTOL`` of JAX's; a parameter whose value is near 0
    (an offset or a phase) within ``FIT_RTOL`` of ``scale``, the
    curve's amplitude."""
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want,
                                                                  float),
                               rtol=FIT_RTOL, atol=FIT_RTOL * abs(scale),
                               err_msg=what)


def test_exp_decay_matches_jax():
    x, y = _exp_data()
    got = tan.fit_exp_decay(x, y, device='cpu')
    _close(got, jan.fit_exp_decay(x, y), 'exp decay')
    a, tau, c = got
    assert abs(a - 0.9) < 0.05 and abs(tau - 25e-6) < 2e-6 \
        and abs(c - 0.05) < 0.03


def test_t1_matches_jax():
    x = np.linspace(0, 200e-6, 30)
    y = np.exp(-x / 42e-6)
    t1, params = tan.fit_t1(x, y, device='cpu')
    t1_j, params_j = jan.fit_t1(x, y)
    _close(params, params_j, 't1', scale=params_j[0])
    assert abs(t1 - 42e-6) < 1e-6


@pytest.mark.parametrize('plateau', [True, False])
def test_rb_matches_jax(plateau):
    if plateau:
        depths, surv = _rb_data()
    else:       # a sweep that stops before the survival plateau
        depths = np.array([1, 2, 4, 8, 16, 32])
        surv = 0.5 * 0.99 ** depths + 0.5
    p, epc, params = tan.fit_rb(depths, surv, device='cpu')
    p_j, epc_j, params_j = jan.fit_rb(depths, surv)
    _close([p, epc], [p_j, epc_j], 'rb p, epc')
    _close(params, params_j, 'rb params')
    assert abs(p - (0.985 if plateau else 0.99)) < 0.004


def test_ramsey_matches_jax():
    t, y = _ramsey_data()
    f, t2, params = tan.fit_ramsey(t, y, device='cpu')
    f_j, t2_j, params_j = jan.fit_ramsey(t, y)
    _close([f, t2], [f_j, t2_j], 'ramsey f, t2')
    _close(params, params_j, 'ramsey params', scale=params_j[0])
    assert abs(f - 350e3) / 350e3 < 0.02 and abs(t2 - 8e-6) / 8e-6 < 0.25


def test_fits_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    x, y = _exp_data()
    with pytest.raises(RuntimeError, match='CUDA'):
        tan.fit_exp_decay(x, y)


def _dyadic_iq(rng, shots, chans, center, scale):
    """IQ points on a 1/64 grid: float32 sums of them are exact in any
    order."""
    pts = np.round((center + scale * rng.normal(size=(shots, chans, 2)))
                   * 64) / 64
    return pts.astype(np.float32)


@pytest.mark.parametrize('grid', ['dyadic', 'gaussian'])
def test_centroids_assignment_fidelity_match_jax(grid):
    rng = np.random.default_rng(3)
    if grid == 'dyadic':
        iq0 = _dyadic_iq(rng, 512, 3, np.array([1.0, 0.0]), 0.7)
        iq1 = _dyadic_iq(rng, 512, 3, np.array([-0.5, 0.8]), 0.7)
    else:
        iq0 = (np.array([1.0, 0.0]) + 0.7 * rng.normal(size=(512, 3, 2))) \
            .astype(np.float32)
        iq1 = (np.array([-0.5, 0.8]) + 0.7 * rng.normal(size=(512, 3, 2))) \
            .astype(np.float32)
    c0, c1 = tcal.fit_centroids(iq0, iq1)
    c0_j, c1_j = jcal.fit_centroids(iq0, iq1)
    assert c0.dtype == torch.float32 and tuple(c0.shape) == (3, 2)
    if grid == 'dyadic':
        np.testing.assert_array_equal(c0.numpy(), np.asarray(c0_j))
        np.testing.assert_array_equal(c1.numpy(), np.asarray(c1_j))
        np.testing.assert_array_equal(tcal.assignment_matrix(iq0, iq1),
                                      jcal.assignment_matrix(iq0, iq1))
        np.testing.assert_array_equal(tcal.readout_fidelity(iq0, iq1),
                                      jcal.readout_fidelity(iq0, iq1))
    else:
        np.testing.assert_allclose(c0.numpy(), np.asarray(c0_j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(c1.numpy(), np.asarray(c1_j), rtol=1e-6,
                                   atol=1e-6)
    # with the centroids given, the two discriminators agree exactly
    cj = (np.asarray(c0_j), np.asarray(c1_j))
    np.testing.assert_array_equal(tcal.assignment_matrix(iq0, iq1, *cj),
                                  jcal.assignment_matrix(iq0, iq1, *cj))
    np.testing.assert_array_equal(tcal.readout_fidelity(iq0, iq1, *cj),
                                  jcal.readout_fidelity(iq0, iq1, *cj))


@pytest.mark.parametrize('sigma', [0.4, 1.0])
def test_calibrate_readout_within_clt_of_jax(sigma):
    """Each channel's fidelity within 5 standard errors of the
    difference of two independent estimates; the centroids within 5
    standard errors of their means."""
    shots = 4096
    c0s, c1s = np.array([1 + 0j, 0 + 1j]), np.array([-1 + 0j, 0 - 1j])
    c0, c1, fid = tcal.calibrate_readout(TIQModel(c0s, c1s, sigma), 7,
                                         shots, device='cpu')
    c0_j, c1_j, fid_j = jcal.calibrate_readout(JIQModel(c0s, c1s, sigma),
                                               jax.random.PRNGKey(7), shots)
    var = fid * (1 - fid) / shots       # the two error rates, halved
    tol = 5 * np.sqrt(2 * var) + 1e-12
    assert np.all(np.abs(fid - fid_j) <= tol), (fid, fid_j, tol)
    c_tol = 5 * sigma * np.sqrt(2 / shots)
    np.testing.assert_allclose(c0.numpy(), np.asarray(c0_j), atol=c_tol)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c1_j), atol=c_tol)
    gen = torch.Generator()
    gen.manual_seed(7)
    again = tcal.calibrate_readout(TIQModel(c0s, c1s, sigma), gen, shots)
    np.testing.assert_array_equal(again[2], fid)     # seeded: repeatable


@pytest.mark.parametrize('n_cores,n_pulses,readout', [(2, 2, True),
                                                      (3, 1, False)])
def test_param_sweep_matches_jax(n_cores, n_pulses, readout):
    """The swept program's bytes, the grid's registers and the config
    equal, and the grid's run equal on every key."""
    mp_j = jps.swept_pulse_machine_program(n_cores, n_pulses=n_pulses,
                                           readout=readout)
    mp_t = tps.swept_pulse_machine_program(n_cores, n_pulses=n_pulses,
                                           readout=readout)
    _assert_arrays_equal(machine_program_to_arrays(mp_t),
                         machine_program_to_arrays(mp_j))
    amps, freqs = [0x1000, 0x2000, 0x3000], [0, 1]
    regs = tps.grid_init_regs(amps, freqs, n_cores)
    np.testing.assert_array_equal(regs, jps.grid_init_regs(amps, freqs,
                                                           n_cores))
    assert regs.dtype == np.int32 and regs.shape == (6, n_cores, 16)
    cfg_t = tps.sweep_cfg(mp_t, n_pulses_per_core=n_pulses + 1)
    cfg_j = jps.sweep_cfg(mp_j, n_pulses_per_core=n_pulses + 1)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    bits = np.zeros((6, n_cores, cfg_t.max_meas), np.int32)
    out_t = simulate_batch(mp_t, bits, init_regs=regs, cfg=cfg_t,
                           device='cpu')
    out_j = jax_simulate_batch(mp_j, bits, init_regs=regs,
                               cfg=dataclasses.replace(cfg_j,
                                                       engine='generic'))
    for k in out_j:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]),
                                      err_msg=k)
    assert tps.AMP_REG == jps.AMP_REG and tps.FREQ_REG == jps.FREQ_REG


def _assert_oracles_equal(orc_t, orc_j, what):
    assert set(orc_t) == set(orc_j), what
    for k in orc_j:
        if isinstance(orc_j[k], np.ndarray):
            np.testing.assert_array_equal(orc_t[k], orc_j[k],
                                          err_msg=f'{what}: {k}')
        else:
            assert orc_t[k] == orc_j[k], (what, k)


@pytest.mark.parametrize('seed', range(8))
def test_run_oracle_matches_jax_on_random_programs(seed):
    """The random compiled programs of tests/test_fuzz_pipeline.py: the
    port's oracle equals JAX's on every output, and the port's generic
    engine equals the oracle (registers, qclk, completion, pulses)."""
    rng = np.random.default_rng(3000 + seed)
    sim = JSimulator(n_qubits=2)
    mp_j = sim.compile(_random_program(rng, ['Q0', 'Q1']))
    mp_t = _to_port(mp_j)
    bits = rng.integers(0, 2, size=(mp_j.n_cores, 6))
    cfg = sim.interpreter_config(mp_j, max_meas=6)
    orc_t = torc.run_oracle(mp_t, meas_bits=bits, max_steps=cfg.max_steps)
    orc_j = jorc.run_oracle(mp_j, meas_bits=bits, max_steps=cfg.max_steps)
    _assert_oracles_equal(orc_t, orc_j, f'seed {seed}')
    out = simulate(mp_t, meas_bits=bits, device='cpu',
                   cfg=TCfg(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(out['regs'].numpy(), orc_t['regs'])
    np.testing.assert_array_equal(out['qclk'].numpy(), orc_t['qclk'])
    assert np.all(out['done'].numpy() == orc_t['done'])
    for c in range(mp_t.n_cores):
        n = int(out['n_pulses'][c])
        assert n == len(orc_t['pulses'][c]), (seed, c)
        got = out['rec_gtime'][c, :n].numpy()
        want = np.array([p['gtime'] for p in orc_t['pulses'][c]], dtype=int)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('fabric', ['sticky', 'fresh'])
def test_run_oracle_matches_jax_on_branch_program(fabric):
    """The register-gated branch program of tests/test_param_sweep.py
    (``test_sweep_stats_uses_init_regs``), with measurements read back
    through each fabric."""
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    assert torc.START_NCLKS == jorc.START_NCLKS
    t = torc.START_NCLKS
    cores = []
    for c in range(2):
        cores.append([
            isa.alu_cmd('jump_cond', 'r', 2, 'id0', jump_cmd_ptr=2),
            isa.pulse_cmd(freq_word=0, phase_word=0, amp_word=0x8000,
                          env_word=3 << 12, cfg_word=0, cmd_time=t),
            isa.pulse_cmd(freq_word=0, phase_word=0, amp_word=0xffff,
                          env_word=3 << 12, cfg_word=2, cmd_time=t + 40),
            isa.alu_cmd('jump_fproc', 'i', 1, 'eq', func_id=c,
                        jump_cmd_ptr=5),
            isa.pulse_cmd(freq_word=0, phase_word=0, amp_word=0x4000,
                          env_word=3 << 12, cfg_word=0, cmd_time=t + 400),
            isa.done_cmd()])
    mp_t = machine_program_from_cmds(cores)
    from distributed_processor_tpu.decoder import \
        machine_program_from_cmds as jax_from_cmds
    mp_j = jax_from_cmds(cores)
    for bits in ([[0], [1]], [[1], [1]]):
        orc_t = torc.run_oracle(mp_t, meas_bits=bits, fabric=fabric)
        orc_j = jorc.run_oracle(mp_j, meas_bits=bits, fabric=fabric)
        _assert_oracles_equal(orc_t, orc_j, f'{fabric} {bits}')
