"""The port's readout models against the JAX package's, on the CPU.

* ``resolve_mode='analytic'`` (the closed form of the white-noise matched
  filter): at sigma = 0 every output key of the port equals the JAX
  package's on the headline program cut to 2 qubits and depth 2, and its
  bits equal the port's own per-sample chain.
* CW readout (``cw_horizon``): the read program with its rdlo envelope
  word patched to the CW sentinel (as tests/test_cw_readout.py does)
  gives, at a horizon equal to the finite window, the finite program's
  bits exactly in every mode and engine, noisy or not, and at sigma = 0
  the JAX package's bits.
* AR(1) ADC noise: the plain version's triangular coloring against a
  sequential IIR on the same whites (rtol 1e-5), its tables against JAX
  ``_ar1_tables``, and the variance of the noise projection against the
  closed form ``sigma^2 a^2 sum_{s,t} rho^|s-t| Re(z_s conj(z_t))``
  within 5 standard errors (the counterpart of
  tests/test_ringdown.py::test_colored_noise_statistics).
* The model checks: the same exception type and message as the JAX
  package for each invalid model, and the analytic-with-ring-up warning.
"""

import copy
import dataclasses
import re
import warnings

import numpy as np
import pytest
import torch

import bench
import jax
import jax.numpy as jnp

import distributed_processor_tpu.pipeline as jpipe
import distributed_processor_tpu.models as jmodels
from distributed_processor_tpu.elements import ENV_CW_SENTINEL
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run, _ar1_tables)

from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.ops.resolve import (
    ar1_tables, build_fused_tables, resolve_windows_reference)
from distributed_processor_tpu_torch.sim.interpreter import (
    ERR_CW_MEAS, InterpreterConfig as TCfg)
from distributed_processor_tpu_torch.sim import physics as tphysics
from distributed_processor_tpu_torch.sim.physics import (
    physics_from_dict, prepare_physics_tables, run_physics_batch)

torch.set_num_threads(1)

B = 32
KW = dict(max_steps=1024, max_pulses=8, max_meas=2)


def _to_port(mp_j):
    return machine_program_from_arrays(machine_program_to_arrays(mp_j))


def _model_pair(**kw):
    jm = JPhysics(**kw)
    return jm, physics_from_dict(dataclasses.asdict(jm))


@pytest.fixture(scope='module')
def headline():
    mp_j = bench.build_machine_program(2, 2)
    cfg = dict(max_steps=2 * mp_j.n_instr + 64,
               max_pulses=int(mp_j.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2, record_pulses=False)
    init = np.random.default_rng(3).integers(0, 2, (B, 2)).astype(np.int32)
    return mp_j, _to_port(mp_j), cfg, init


@pytest.fixture(scope='module')
def cw_programs():
    """``(finite_mp, cw_mp, n_samp)`` of the JAX package: an X90 and a
    read, the copy's rdlo env word patched to the CW sentinel."""
    mp = jpipe.compile_to_machine(
        [{'name': 'X90', 'qubit': ['Q0']}, {'name': 'read', 'qubit': ['Q0']}],
        jmodels.make_default_qchip(1), n_qubits=1)
    meas_rows = (np.asarray(mp.soa.p_cfg) & 0b11) == 2
    envw = int(np.asarray(mp.soa.p_env)[meas_rows][0])
    n_words, addr = (envw >> 12) & 0xfff, envw & 0xfff
    n_samp = n_words * 4 * int(mp.tables[0].elem_cfgs[2].interp_ratio)
    cw_mp = copy.deepcopy(mp)
    cw_mp.soa.p_env[np.asarray(meas_rows)] = (ENV_CW_SENTINEL << 12) | addr
    return mp, cw_mp, n_samp


def _assert_same(out_t, out_j):
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)


@pytest.mark.parametrize('straightline', [None, False],
                         ids=['bench_config', 'generic'])
def test_analytic_sigma0_matches_jax(headline, straightline):
    mp_j, mp_t, cfg, init = headline
    jm, tm = _model_pair(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                         resolve_mode='analytic')
    out_j = jax_run(mp_j, jm, 0, B, init_states=init,
                    cfg=JCfg(**cfg, straightline=straightline))
    out_t = run_physics_batch(mp_t, tm, 0, B, init_states=init,
                              cfg=TCfg(**cfg, straightline=straightline),
                              device='cpu')
    _assert_same(out_t, out_j)
    # the closed form gives the per-sample chain's bits at sigma = 0
    ps = run_physics_batch(
        mp_t, dataclasses.replace(tm, resolve_mode='persample'), 0, B,
        init_states=init, cfg=TCfg(**cfg, straightline=straightline),
        device='cpu')
    assert torch.equal(out_t['meas_bits'], ps['meas_bits'])
    assert bool(out_t['meas_bits_valid'].all())


def test_analytic_noise_is_fixed_per_slot(headline):
    """The analytic draws are one per (shot, core, slot), fixed by the
    seed: a rerun repeats every bit, another seed changes some, and the
    assignment error at a large sigma is what the closed form's SNR
    gives (nonzero, well below a coin)."""
    _mp_j, mp_t, cfg, init = headline
    model = physics_from_dict(dataclasses.asdict(JPhysics(
        sigma=20.0, p1_init=0.5, resolve_chunk=256,
        resolve_mode='analytic')))
    runs = [run_physics_batch(mp_t, model, s, 256, cfg=TCfg(**cfg),
                              device='cpu') for s in (4, 4, 5)]
    assert torch.equal(runs[0]['meas_bits'], runs[1]['meas_bits'])
    assert not torch.equal(runs[0]['meas_bits'], runs[2]['meas_bits'])
    err = (runs[0]['meas_bits'][..., 0]
           != runs[0]['meas_state'][..., 0]).float().mean()
    assert 0.0 < float(err) < 0.4


def jax_analytic_xi(seed, B, C, M):
    """The JAX package's analytic draws of a run keyed ``PRNGKey(seed)``:
    the noise half of the run key split into the I and Q normals."""
    _k_init, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    k_i, k_q = jax.random.split(k_noise)
    return np.stack([np.array(jax.random.normal(k, (B, C, M), jnp.float32))
                     for k in (k_i, k_q)])


@pytest.mark.parametrize('straightline', [None, False],
                         ids=['bench_config', 'generic'])
def test_analytic_noisy_matches_jax(headline, straightline, monkeypatch):
    """With the JAX run's normals substituted for the port's draw, every
    output of a noisy analytic run (sigma = 20, assignment errors on a
    few percent of the bits or more) equals the JAX package's shot for
    shot: the closed form's energy and noise scale are JAX's."""
    mp_j, mp_t, cfg, _init = headline
    monkeypatch.setattr(
        tphysics, '_analytic_xi', lambda seed, B, C, M, device:
        torch.as_tensor(jax_analytic_xi(seed, B, C, M), device=device))
    shots = 256
    init = np.random.default_rng(8).integers(0, 2, (shots, 2)) \
        .astype(np.int32)
    jm, tm = _model_pair(sigma=20.0, p1_init=0.5, resolve_chunk=256,
                         resolve_mode='analytic')
    out_j = jax_run(mp_j, jm, 5, shots, init_states=init,
                    cfg=JCfg(**cfg, straightline=straightline))
    out_t = run_physics_batch(mp_t, tm, 5, shots, init_states=init,
                              cfg=TCfg(**cfg, straightline=straightline),
                              device='cpu')
    err = (out_t['meas_bits'] != out_t['meas_state']).float().mean()
    assert 0.02 < float(err) < 0.4
    _assert_same(out_t, out_j)


def test_analytic_energy_matches_per_sample_chain(headline):
    """The closed form's window energy against the plain resolver's
    per-sample sum of |y|^2 (sigma = 0) on the same windows, ragged:
    windows that run past the padded table (the held last sample), and
    sample counts that are not a multiple of the interpolation ratio
    (the trailing partial sample).  rtol 1e-4 (float32 prefix sums
    against float32 per-sample sums over up to W samples)."""
    _mp_j, mp_t, _cfg, _init = headline
    model = physics_from_dict(dict(sigma=0.0, resolve_mode='analytic',
                                   resolve_chunk=256))
    tables = prepare_physics_tables(mp_t, model, 'cpu')
    C, Lp = tables['env'].shape[0], tables['env'].shape[2]
    W, F = tables['bas'].shape[3], tables['bas'].shape[2]
    interps = tables['interps']
    rng = np.random.default_rng(12)
    Bw = 512
    # a third of the windows start within W / interp samples of the
    # table's end, so they overrun it
    near_end = rng.integers(max(Lp - W // int(interps.min()), 0), Lp,
                            (Bw, C))
    addr = np.where(rng.random((Bw, C)) < 1 / 3, near_end,
                    rng.integers(0, Lp, (Bw, C)))
    n_samp = rng.integers(0, W + 64, (Bw, C))
    phase = rng.uniform(0, 2 * np.pi, (Bw, C))
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt)[..., None]
    sc = dict(amp=t(rng.uniform(0.1, 1.0, (Bw, C))),
              cosA=t(np.cos(phase)), sinA=t(np.sin(phase)),
              f_idx=t(rng.integers(0, F, (Bw, C)), torch.int32),
              addr=t(addr, torch.int32), n_samp=t(n_samp, torch.int32),
              interp_c=interps[None, :, None])
    partial = n_samp % interps.numpy()[None, :] != 0
    overrun = addr + n_samp // interps.numpy()[None, :] > Lp
    assert partial.mean() > 0.5 and overrun.sum() > 50
    zeros = torch.zeros((Bw, C))
    _ai, _aq, want = resolve_windows_reference(
        sc, tables, zeros, zeros, 0.0, 0.0, 0, W, Lp)
    got = tphysics._analytic_energy(sc, tables['env'], W)[..., 0]
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * float(want.max()))


@pytest.mark.parametrize('straightline', [None, False],
                         ids=['straightline', 'generic'])
@pytest.mark.parametrize('mode', ['persample', 'fused', 'analytic'])
def test_cw_matches_finite_window(cw_programs, mode, straightline):
    """CW at a horizon of the finite window's samples: the finite
    program's bits exactly, noisy (same seed) and noiseless, and at
    sigma = 0 the JAX package's."""
    mp_j, cw_j, n_samp = cw_programs
    mp_t, cw_t = _to_port(mp_j), _to_port(cw_j)
    kw = dict(KW, straightline=straightline)
    noisy = dict(sigma=15.0, p1_init=0.5, resolve_mode=mode)
    fin = run_physics_batch(mp_t, physics_from_dict(noisy), 7, 256,
                            device='cpu', **kw)
    cw = run_physics_batch(cw_t, physics_from_dict(
        dict(noisy, cw_horizon=n_samp)), 7, 256, device='cpu', **kw)
    for out in (fin, cw):
        assert not bool(out['err'].any()) and not bool(out['incomplete'])
    assert torch.equal(fin['meas_bits'], cw['meas_bits'])
    mism = (cw['meas_bits'][:, 0, 0] != cw['meas_state'][:, 0, 0])
    assert 0.0 < float(mism.float().mean()) < 0.5
    init = (np.arange(B) % 2).astype(np.int32).reshape(B, 1)
    jm, tm = _model_pair(sigma=0.0, p1_init=0.5, resolve_mode=mode,
                         cw_horizon=n_samp)
    out_j = jax_run(cw_j, jm, 3, B, init_states=init,
                    cfg=JCfg(**kw))
    out_t = run_physics_batch(cw_t, tm, 3, B, init_states=init,
                              cfg=TCfg(**kw), device='cpu')
    _assert_same(out_t, out_j)


def test_cw_without_horizon_is_an_error(cw_programs):
    _mp_j, cw_j, _n = cw_programs
    out = run_physics_batch(_to_port(cw_j), physics_from_dict(
        dict(sigma=0.0)), 0, 4, device='cpu', **KW)
    assert bool((out['err'] & ERR_CW_MEAS).all())


def test_cw_shorter_horizon_less_energy(cw_programs):
    """A quarter of the horizon integrates a quarter of the energy: the
    assignment error at a fixed sigma rises."""
    _mp_j, cw_j, n_samp = cw_programs
    cw_t = _to_port(cw_j)
    errs = []
    for h in (n_samp, n_samp // 4):
        out = run_physics_batch(cw_t, physics_from_dict(
            dict(sigma=12.0, p1_init=0.5, cw_horizon=h)), 11, 1024,
            device='cpu', **KW)
        errs.append(float((out['meas_bits'][:, 0, 0]
                           != out['meas_state'][:, 0, 0]).float().mean()))
    assert errs[1] > errs[0] * 1.5, errs


def _window_case(C=2, W=300, Bw=5, seed=0):
    """Random resolver inputs: one window per (shot, core), ragged sample
    counts (one past W, one of zero), two static rows and frequencies."""
    rng = np.random.default_rng(seed)
    Lp = 96
    env = torch.as_tensor(rng.normal(size=(C, 2, Lp)).astype(np.float32))
    s = np.arange(W)
    f = rng.uniform(0.01, 0.2, size=(C, 2))
    bas = np.stack([np.cos(2 * np.pi * f[..., None] * s),
                    np.sin(2 * np.pi * f[..., None] * s)], 1)
    tables = build_fused_tables((env[:, 0], env[:, 1]),
                                (torch.as_tensor(bas[:, 0]),
                                 torch.as_tensor(bas[:, 1])),
                                W, [2] * C, rows=(0, 8))
    lane = lambda a, dt: torch.as_tensor(np.asarray(a, dt)[..., None])
    nsamp = rng.integers(1, W, size=(Bw, C))
    nsamp[0, 0], nsamp[-1, -1] = W + 7, 0
    A = rng.uniform(0, 6, (Bw, C))
    sc = dict(amp=lane(rng.uniform(0.2, 1.0, (Bw, C)), np.float32),
              cosA=lane(np.cos(A), np.float32),
              sinA=lane(np.sin(A), np.float32),
              f_idx=lane(rng.integers(0, 2, (Bw, C)), np.int32),
              addr=lane(rng.choice([0, 8], (Bw, C)), np.int32),
              n_samp=lane(nsamp, np.int32))
    gs = [torch.as_tensor(rng.normal(size=(Bw, C)).astype(np.float32))
          for _ in range(2)]
    return sc, tables, gs, Lp


@pytest.mark.parametrize('rho', [0.1, 0.9])
def test_ar1_triangular_matches_sequential_iir(rho):
    """The plain version colors streamed whites by its triangular product
    per chunk (128 samples over W = 300: two seams and a partial chunk);
    a sequential float64 IIR on the same whites, streamed as noise with
    rho = 0, gives the same sums (rtol 1e-5)."""
    C, W, Bw = 2, 300, 5
    sc, tables, (gi, gq), Lp = _window_case(C, W, Bw)
    rng = np.random.default_rng(1)
    sigma = 0.3
    white = sigma * rng.normal(size=(2, C, Bw, W))
    n0 = sigma * rng.normal(size=(2, C, Bw))
    colored = np.empty_like(white)
    n, c = n0.copy(), np.sqrt(1 - rho * rho)
    for t in range(W):
        n = rho * n + c * white[..., t]
        colored[..., t] = n
    f32 = lambda a: torch.as_tensor(a.astype(np.float32))
    got = resolve_windows_reference(sc, tables, gi, gq, sigma, 0.0, 0, W,
                                    Lp, noise=f32(white), ck=128, rho=rho,
                                    noise0=f32(n0))
    want = resolve_windows_reference(sc, tables, gi, gq, sigma, 0.0, 0, W,
                                     Lp, noise=f32(colored), ck=128)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    T, rpow = ar1_tables(rho, 128)
    Tj, rpowj = _ar1_tables(jnp.float32(rho), 128)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(rpow.numpy(), np.asarray(rpowj), rtol=1e-6,
                               atol=1e-30)


def test_ar1_projection_variance_closed_form():
    """Drawn AR(1) noise (the plain version's generator): the variance of
    the noise projection ``acc - acc(sigma = 0)`` of one window matches
    ``sigma^2 a^2 sum_{s,t} rho^|s-t| Re(z_s conj(z_t))`` within 5
    standard errors, on both components, across chunk seams."""
    C, W, rho, sigma, n = 1, 256, 0.8, 0.5, 4096
    sc1, tables, (gi, gq), Lp = _window_case(C, W, 1, seed=2)
    sc1['n_samp'][...] = 200
    sc1['addr'][...] = 8
    sc = {k: v.expand(n, C, 1).contiguous() for k, v in sc1.items()}
    gi, gq = gi.expand(n, C).contiguous(), gq.expand(n, C).contiguous()
    clean = resolve_windows_reference(sc, tables, gi, gq, 0.0, 0.0, 0, W,
                                      Lp, ck=96)
    noisy = resolve_windows_reference(sc, tables, gi, gq, sigma, 0.0, 9, W,
                                      Lp, ck=96, rho=rho)
    # the window's z = y / (a e^{iA}): envelope row 8 times the carrier
    a = float(sc1['amp'][0, 0, 0])
    k = np.minimum(8 + np.arange(200) // 2, Lp - 1)
    env = tables['env'][0].numpy().astype(np.float64)
    f = int(sc1['f_idx'][0, 0, 0])
    bas = tables['bas'][0, :, f, :200].numpy().astype(np.float64)
    z = (env[0, k] + 1j * env[1, k]) * (bas[0] + 1j * bas[1])
    lag = np.abs(np.arange(200)[:, None] - np.arange(200)[None, :])
    var = sigma ** 2 * a ** 2 * np.real(
        (rho ** lag * z[:, None] * np.conj(z[None, :])).sum())
    for comp in (0, 1):
        d = (noisy[comp] - clean[comp]).numpy()[:, 0].astype(np.float64)
        se = var * np.sqrt(2.0 / (n - 1))
        assert abs(d.var(ddof=1) - var) < 5 * se, (comp, d.var(), var)
        assert abs(d.mean()) < 5 * np.sqrt(var / n)
    # colored noise is not white: the white variance differs
    white_var = sigma ** 2 * a ** 2 * float((np.abs(z) ** 2).sum())
    assert abs(var - white_var) > 10 * var * np.sqrt(2.0 / (n - 1))


_BAD_MODELS = {
    'unknown_mode': dict(resolve_mode='bogus'),
    'cw_above_window': dict(cw_horizon=10 ** 6),
    'cw_negative': dict(cw_horizon=-1),
    'ar1_pole': dict(noise_ar1=1.5),
    'g2_no_leak': dict(g2=0.5 + 0.5j),
    'classify3_no_g2': dict(classify3=True),
    'ar1_analytic': dict(noise_ar1=0.5, resolve_mode='analytic'),
    'ar1_fused': dict(noise_ar1=0.5, resolve_mode='fused'),
}


@pytest.mark.parametrize('case', sorted(_BAD_MODELS))
def test_model_validation_matches_jax(headline, case):
    mp_j, mp_t, cfg, _init = headline
    jm, tm = _model_pair(sigma=0.1, **_BAD_MODELS[case])
    with pytest.raises(ValueError) as jerr:
        jax_run(mp_j, jm, 0, 2, cfg=JCfg(**cfg))
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        run_physics_batch(mp_t, tm, 0, 2, cfg=TCfg(**cfg), device='cpu')


def test_analytic_with_ring_warns_as_jax(headline):
    mp_j, mp_t, cfg, init = headline
    jm, tm = _model_pair(sigma=0.0, ring_tau=20.0, resolve_chunk=256,
                         resolve_mode='analytic')
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter('always')
        out_j = jax_run(mp_j, jm, 0, B, init_states=init, cfg=JCfg(**cfg))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter('always')
        out_t = run_physics_batch(mp_t, tm, 0, B, init_states=init,
                                  cfg=TCfg(**cfg), device='cpu')
    msg = lambda ws: [str(w.message) for w in ws if 'ring-up' in
                      str(w.message)]
    assert msg(tw) and msg(tw) == msg(jw)
    # the flat-response approximation: the ring is ignored, as in JAX
    np.testing.assert_array_equal(out_t['meas_bits'].numpy(),
                                  np.asarray(out_j['meas_bits']))
