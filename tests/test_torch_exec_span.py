"""The span kernels' paths on the CPU against the JAX package's kernels.

K1 (``engine='pallas'``) and K3 (``engine='fused'``) run
``csrc/exec_span.cu`` on the card; on the CPU their wrappers
(``ops.exec_span``) take the plain version, the port's straight-line
engine.  Here that path is held against the JAX package's Pallas kernel
run in interpret mode (``pallas_interpret=True``) at a small batch: every
output key identical, value and dtype, ``steps`` and ``epochs``
included.  K3 is held at sigma = 0 with explicit initial states, also
against the port's generic engine (one epoch instead of two).
``build_energy_tables`` (K3's energy rows) is held against JAX's at
rtol 1e-6, and ``build_energy_prefix`` (the prefix sums the kernel reads,
one per window) against their float64 cumulative sum; the kernel's
prefix read, emulated in torch inside the plain fused engine, matches
the masked row sum to rtol 1e-6 and gives identical outputs on the
8-qubit headline.  The model gates of the fused engine raise the JAX package's
exception types.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from distributed_processor_tpu.ops.resolve_pallas import \
    build_energy_tables as jax_energy_tables
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run_physics,
    _static_meas_env_addrs as jax_env_addrs)

from distributed_processor_tpu_torch.ops import exec_span, exec_span_fused
from distributed_processor_tpu_torch.ops.resolve import (
    build_energy_prefix, build_energy_tables)
from distributed_processor_tpu_torch.sim import interpreter as tinterp
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate_batch as torch_simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    fused_readout, physics_from_dict, prepare_physics_tables,
    run_physics_batch, _physics_tables, _static_meas_env_addrs)

from test_torch_interpreter import _to_port
from test_torch_straightline import _sl_feedback_program

B = 8


@pytest.fixture(scope='module')
def headline():
    mp_j = bench.build_machine_program(2, 2)
    cfg = dict(max_steps=2 * mp_j.n_instr + 64,
               max_pulses=int(mp_j.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2)
    return mp_j, _to_port(mp_j), cfg


def _assert_equal(out_t, out_j):
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)


def _k1_cases():
    return [('headline', 0), ('feedback', 900)]


@pytest.mark.parametrize('program,seed', _k1_cases())
def test_pallas_matches_jax_interpret(headline, program, seed):
    """``engine='pallas'`` on the CPU (K1's plain version) against the
    JAX Pallas kernel in interpret mode: records, histogram, registers,
    clocks, ``err``, ``fault`` and ``steps`` identical."""
    rng = np.random.default_rng(seed)
    if program == 'headline':
        mp, _, cfg = headline
    else:
        mp = _sl_feedback_program(rng)
        cfg = dict(max_meas=4, max_pulses=12, max_resets=2)
    bits = rng.integers(0, 2, (B, mp.n_cores, cfg['max_meas'])) \
        .astype(np.int32)
    init = rng.integers(-5, 5, (B, mp.n_cores, 16)).astype(np.int32)
    kw = dict(engine='pallas', opcode_histogram=True, **cfg)
    out_j = jax_simulate_batch(mp, bits, init_regs=init,
                               cfg=JCfg(pallas_interpret=True, **kw))
    before = exec_span.launches
    out_t = torch_simulate_batch(_to_port(mp), bits, init_regs=init,
                                 cfg=TCfg(**kw), device='cpu')
    # the CPU path is the plain version: no kernel launch is counted
    assert exec_span.launches == before
    _assert_equal(out_t, out_j)
    assert int(out_t['steps']) == mp.n_instr


def _model_pair(**kw):
    jm = JPhysics(**kw)
    return jm, physics_from_dict(dataclasses.asdict(jm))


def test_fused_matches_jax_interpret(headline):
    """``engine='fused'`` at sigma = 0 (K3's plain version) against the
    JAX fused kernel in interpret mode: every key, bits, valid flags,
    ``epochs`` (1) and ``steps`` included."""
    mp_j, mp_t, cfg = headline
    init = np.random.default_rng(3).integers(0, 2, (B, 2)).astype(np.int32)
    jm, tm = _model_pair(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                         resolve_mode='fused')
    kw = dict(engine='fused', record_pulses=False, **cfg)
    out_j = jax_run_physics(mp_j, jm, 0, B, init_states=init,
                            cfg=JCfg(pallas_interpret=True, **kw))
    before = exec_span_fused.launches
    out_t = run_physics_batch(mp_t, tm, 0, B, init_states=init,
                              cfg=TCfg(**kw), device='cpu')
    assert exec_span_fused.launches == before
    _assert_equal(out_t, out_j)
    assert int(out_t['epochs']) == 1
    assert int(out_t['steps']) == mp_t.n_instr


@pytest.mark.parametrize('qubits,depth', [(2, 2), (3, 4)])
def test_fused_matches_generic(qubits, depth):
    """At sigma = 0 the fused engine's bits and integer outputs equal the
    generic engine's, in one epoch where the generic loop takes two."""
    mp = _to_port(bench.build_machine_program(qubits, depth))
    cfg = dict(max_steps=2 * mp.n_instr + 64,
               max_pulses=int(mp.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2, record_pulses=False)
    init = np.random.default_rng(qubits).integers(0, 2, (32, qubits))
    model = physics_from_dict(dataclasses.asdict(JPhysics(
        sigma=0.0, p1_init=0.15, resolve_chunk=256, resolve_mode='fused')))
    outs = {eng: run_physics_batch(mp, model, 1, 32, init_states=init,
                                   cfg=TCfg(engine=eng, **cfg), device='cpu')
            for eng in ('fused', 'generic')}
    for key in outs['generic']:
        if key not in ('epochs', 'steps'):
            assert torch.equal(outs['fused'][key], outs['generic'][key]), key
    assert int(outs['fused']['epochs']) == 1
    assert int(outs['generic']['epochs']) == 2
    assert bool(outs['fused']['meas_bits_valid'].all())


def test_energy_tables_match_jax(headline):
    mp_j, mp_t, _cfg = headline
    model = physics_from_dict(dataclasses.asdict(JPhysics(
        resolve_chunk=256, resolve_mode='fused')))
    tabs = prepare_physics_tables(mp_t, model, 'cpu')
    _env, _freq, _spc, interp_m, W = _physics_tables(mp_t, model.meas_elem)
    rows = _static_meas_env_addrs(mp_t)
    assert rows == jax_env_addrs(mp_j)
    interps = tuple(int(x) for x in interp_m)
    env = tabs['env']
    got = build_energy_tables((env[:, 0], env[:, 1]), rows, W, interps)
    want = np.asarray(jax_energy_tables(
        (env[:, 0].numpy(), env[:, 1].numpy()), rows, W, interps))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got.max()) > 0


def test_energy_prefix_is_cumsum_of_jax_rows(headline):
    mp_j, mp_t, _cfg = headline
    model = physics_from_dict(dataclasses.asdict(JPhysics(
        resolve_chunk=256, resolve_mode='fused')))
    tabs = prepare_physics_tables(mp_t, model, 'cpu')
    _env, _freq, _spc, interp_m, W = _physics_tables(mp_t, model.meas_elem)
    rows = _static_meas_env_addrs(mp_t)
    env = tabs['env']
    e2_j = np.asarray(jax_energy_tables(
        (env[:, 0].numpy(), env[:, 1].numpy()), rows, W,
        tuple(int(x) for x in interp_m)), np.float64)
    want = np.concatenate([np.zeros(e2_j.shape[:-1] + (1,)),
                           np.cumsum(e2_j, -1)], -1)
    got = build_energy_prefix(torch.as_tensor(e2_j, dtype=torch.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[..., 0].abs().max()) == 0.0
    fused = fused_readout(mp_t, model, tabs)
    assert torch.equal(fused['e2p'], build_energy_prefix(fused['e2']))


def _prefix_energy(fused, pp, nsamp, env_len):
    """K3's window energy as the kernel reads it (test only): one entry
    of the prefix table ``e2p[c, row, count]`` per window."""
    e2p = fused['e2p']
    count = torch.where(env_len == 0xfff, 0, nsamp.clamp(max=fused['w']))
    addr = (pp[..., 0] & 0xfff) * 4
    c = torch.arange(e2p.shape[0])[None, :]
    tot = torch.zeros(addr.shape, dtype=torch.float32)
    for r, a in enumerate(fused['addrs']):
        tot = tot + torch.where(addr == a, e2p[c, r, count.long()], 0.0)
    amp = pp[..., 3].to(torch.float32) / fused['amp_scale']
    return amp * amp * tot


def test_prefix_energy_read_matches_masked_sum_headline(monkeypatch):
    """The 8-qubit headline at sigma = 0 through the plain fused engine,
    once with the masked row sum and once with the kernel's prefix read:
    the energies agree to rtol 1e-6 at every measurement and every
    output is identical."""
    mp = _to_port(bench.build_machine_program(8, 12))
    cfg = TCfg(engine='fused', max_steps=2 * mp.n_instr + 64,
               max_pulses=int(mp.max_pulses_per_core(1)) + 4, max_meas=2,
               max_resets=2, record_pulses=False)
    init = np.random.default_rng(8).integers(0, 2, (64, 8))
    model = physics_from_dict(dataclasses.asdict(JPhysics(
        sigma=0.0, p1_init=0.15, resolve_chunk=256, resolve_mode='fused')))
    want = run_physics_batch(mp, model, 1, 64, init_states=init, cfg=cfg,
                             device='cpu')
    masked_sum, seen = tinterp._fused_window_energy, []

    def prefix_read(fused, pp, nsamp, env_len):
        ref = masked_sum(fused, pp, nsamp, env_len)
        got = _prefix_energy(fused, pp, nsamp, env_len)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=0)
        seen.append(int((ref > 0).sum()))
        return got
    monkeypatch.setattr(tinterp, '_fused_window_energy', prefix_read)
    got = run_physics_batch(mp, model, 1, 64, init_states=init, cfg=cfg,
                            device='cpu')
    assert sum(seen) > 0
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    bits = want['meas_bits'][..., 0]
    assert 0 < float(bits.float().mean()) < 1


@pytest.mark.parametrize('model_kw', [
    dict(sigma=0.05), dict(sigma=0.0, ring_tau=30.0),
    dict(sigma=0.0, noise_ar1=0.5, resolve_mode='persample')],
    ids=['sigma', 'ring_tau', 'noise_ar1'])
def test_fused_model_gates_match_jax(headline, model_kw):
    mp_j, mp_t, cfg = headline
    jm, tm = _model_pair(**model_kw)
    kw = dict(engine='fused', record_pulses=False, **cfg)
    with pytest.raises(ValueError, match='readout model'):
        jax_run_physics(mp_j, jm, 0, 4, cfg=JCfg(**kw))
    with pytest.raises(ValueError, match='readout model'):
        run_physics_batch(mp_t, tm, 0, 4, cfg=TCfg(**kw), device='cpu')


def test_fused_program_gates_match_jax(headline):
    """An injected-bits run, a ``max_meas`` below the static measurement
    bound and CW windows are fused-ineligible in both packages."""
    mp_j, mp_t, cfg = headline
    bits = np.zeros((2, 2, 2), np.int32)
    with pytest.raises(ValueError, match='injected-bits'):
        jax_simulate_batch(mp_j, bits, cfg=JCfg(engine='fused', **cfg))
    with pytest.raises(ValueError, match='injected-bits'):
        torch_simulate_batch(mp_t, bits, cfg=TCfg(engine='fused', **cfg),
                             device='cpu')
    for model_kw, kw, match in ((dict(sigma=0.0), dict(max_meas=1),
                                 'max_meas'),
                                (dict(sigma=0.0, cw_horizon=16), {}, 'CW')):
        jm, tm = _model_pair(**model_kw)
        run_cfg = dict(cfg, engine='fused', **kw)
        with pytest.raises(ValueError, match=match):
            jax_run_physics(mp_j, jm, 0, 2, cfg=JCfg(**run_cfg))
        with pytest.raises(ValueError, match=match):
            run_physics_batch(mp_t, tm, 0, 2, cfg=TCfg(**run_cfg),
                              device='cpu')


def test_wrappers_refuse_other_devices(headline):
    """A wrapper launches the kernel on CUDA tensors and takes the plain
    version on CPU tensors only; any other device raises."""
    _mp_j, mp_t, cfg = headline
    from distributed_processor_tpu_torch.sim.interpreter import (
        _init_state, _span_table)
    c = TCfg(**cfg)
    st = _init_state(2, mp_t.n_cores, c, None, 'meta')
    bits = torch.zeros((2, mp_t.n_cores, 2), dtype=torch.int32,
                       device='meta')
    with pytest.raises(ValueError, match='device'):
        exec_span(st, _span_table(mp_t, c, 'meta'), bits, c)
