"""The port's DSP ops against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its
counterpart in ``distributed_processor_tpu_torch``:

* ``synthesize_element`` (here the plain version of the waveform kernel
  ``csrc/waveform.cu``) against ``synthesize_element_pallas`` in Pallas
  interpret mode — both run the exact 32-bit NCO, so atol 1e-4 — and
  against the XLA ``synthesize_element``, whose split-precision carrier
  differs by float32 rounding of the residual phase: atol 2e-3, the JAX
  package's own tolerance between its two;
* ``demod_iq`` (the plain version of ``csrc/demod.cu``) against JAX
  ``demod_iq`` and ``demod_iq_pallas`` in interpret mode: the sums are
  taken in other orders, so rtol 1e-5 at N = 64 — with atol 1e-5, a few
  float32 roundings of the terms (of order 1), for the sums that cancel —
  and rtol 2e-4 / atol 2e-3 at N = 1024 (the JAX self-test's tolerance);
* ``discriminate`` / ``demod_and_discriminate`` bits, and the numpy
  helpers ``stack_window_weights`` / ``pulse_window_weights`` /
  ``resolve_pulse_freqs``: equal;
* ``simulate`` and ``InterpreterConfig.from_fpga_config``: every key and
  field equal;
* the sampled readout models: held to CLT bounds (the generators differ).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_processor_tpu import models, pipeline
from distributed_processor_tpu import ops as jops
from distributed_processor_tpu.elements import ENV_CW_SENTINEL
from distributed_processor_tpu.hwconfig import FPGAConfig as JFPGAConfig
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.ops.waveform_pallas import \
    synthesize_element_pallas
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate as jax_simulate)

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch import models as tmodels
from distributed_processor_tpu_torch import ops as tops
from distributed_processor_tpu_torch import pipeline as tpipeline
from distributed_processor_tpu_torch.hwconfig import FPGAConfig as TFPGAConfig
from distributed_processor_tpu_torch.models.readout import (
    IQReadoutModel, apply_assignment_error, make_generator,
    sample_meas_bits)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate as torch_simulate)

torch.set_num_threads(1)

_FIELDS = ('gtime', 'env', 'phase', 'freq_rel', 'amp', 'elem')


def _rec(pulses, max_p=8):
    """A pulse-record dict (numpy) from a list of pulse dicts."""
    rec = {f: np.zeros(max_p, np.float32 if f == 'freq_rel' else np.int32)
           for f in _FIELDS}
    for i, p in enumerate(pulses):
        for f in _FIELDS:
            rec[f][i] = p.get(f, 0)
    rec['n_pulses'] = np.int32(len(pulses))
    return rec


def _jrec(rec):
    return {k: jnp.asarray(v) for k, v in rec.items()}


def _rand_rec(rng, n_pulses, spc, env_slots, max_p=16, elems=(0,)):
    """Random non-overlapping pulse records, phase words included."""
    pulses, t = [], 2
    for _ in range(n_pulses):
        L = int(rng.integers(1, 4))          # env length in 4-sample groups
        t += int(rng.integers(2, 8))
        pulses.append(dict(
            gtime=t, env=(L << 12) | int(rng.integers(0, env_slots - L)),
            phase=int(rng.integers(1 << 17)),
            freq_rel=float(rng.uniform(0, 0.4)),
            amp=int(rng.integers(1 << 16)),
            elem=int(rng.choice(elems))))
        t += (L * 4) // spc + 2
    return _rec(pulses, max_p=max_p)


def _selftest_rec():
    """The records of the JAX package's waveform self-test."""
    return dict(
        gtime=np.array([4, 40, 90, 0], np.int32),
        env=np.array([(32 << 12) | 0, (48 << 12) | 16,
                      (ENV_CW_SENTINEL << 12) | 8, 0], np.int32),
        phase=np.array([0, 1 << 15, 1 << 14, 0], np.int32),
        freq_rel=np.array([0.1, 0.23, 0.05, 0], np.float32),
        amp=np.array([0xffff, 0x8000, 0x4000, 0], np.int32),
        elem=np.zeros(4, np.int32), n_pulses=np.int32(3))


_CW_PAIR = [dict(gtime=0, env=(ENV_CW_SENTINEL << 12) | 0, amp=0xffff),
            dict(gtime=16, env=(1 << 12) | 1, amp=0xffff)]
_CW_ENV = np.concatenate([np.ones(4), 0.25 * np.ones(4)]).astype(complex)


def _waveform_cases():
    cases = []
    for seed in range(3):                    # two 512-sample blocks
        rng = np.random.default_rng(seed)
        env = (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64)) * 0.9
        cases.append((f'random{seed}', _rand_rec(rng, 5, 4, 12), env,
                      4, 1, 256))
    cases.append(('cw_interp1', _rec(_CW_PAIR), _CW_ENV, 4, 1, 128))
    cases.append(('cw_interp2', _rec(_CW_PAIR), _CW_ENV, 4, 2, 128))
    cases.append(('overrun_hold_last',
                  _rec([dict(gtime=0, env=(4 << 12) | 0, amp=0xffff)]),
                  np.full(8, 0.5, complex), 4, 1, 128))
    rng = np.random.default_rng(1)
    cases.append(('selftest', _selftest_rec(),
                  (rng.standard_normal(256)
                   + 1j * rng.standard_normal(256)) * 0.5, 4, 1, 128))
    rng = np.random.default_rng(5)
    env = (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64)) * 0.9
    cases.append(('interp4_spc16', _rand_rec(rng, 6, 16, 12), env,
                  16, 4, 128))
    return cases


_WAVEFORM_CASES = _waveform_cases()


@pytest.mark.parametrize('name,rec,env,spc,interp,n_clks', _WAVEFORM_CASES,
                         ids=[c[0] for c in _WAVEFORM_CASES])
def test_synthesize_element_matches_jax(name, rec, env, spc, interp, n_clks):
    got = tops.synthesize_element(rec, env, spc, interp, n_clks,
                                  device='cpu').numpy()
    assert got.dtype == np.float32 and got.shape == (n_clks * spc, 2)
    pallas = np.asarray(synthesize_element_pallas(
        _jrec(rec), env, spc=spc, interp=interp, n_clks=n_clks,
        interpret=True))
    # the same 32-bit NCO on both sides: float32 rounding of sin/cos only
    np.testing.assert_allclose(got, pallas, atol=1e-4)
    xla = np.asarray(jops.synthesize_element(_jrec(rec), env, spc=spc,
                                             interp=interp, n_clks=n_clks))
    # the XLA version's split-precision carrier: JAX's own tolerance
    np.testing.assert_allclose(got, xla, atol=2e-3)
    assert np.abs(got).max() > 0.1           # the case renders something


def test_synthesize_element_overrun_value():
    rec = _rec([dict(gtime=0, env=(4 << 12) | 0, amp=0xffff)])
    got = tops.synthesize_element(rec, np.full(8, 0.5, complex), 4, 1, 128,
                                  device='cpu').numpy()
    assert abs(got[12, 0] - 0.5) < 1e-6      # held past the table end
    assert np.all(got[16:] == 0)


@pytest.mark.parametrize('n_clks', [37, 130, 257])
def test_synthesize_element_any_length(n_clks):
    """A trace length that is no multiple of 512 samples (the Pallas entry
    refuses it): held against the XLA version, atol 2e-3."""
    rng = np.random.default_rng(n_clks)
    env = (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64)) * 0.9
    rec = _rand_rec(rng, 5, 4, 12)
    rec['env'][2] = (ENV_CW_SENTINEL << 12) | 3      # a CW pulse too
    got = tops.synthesize_element(rec, env, 4, 1, n_clks,
                                  device='cpu').numpy()
    assert got.shape == (4 * n_clks, 2)
    with pytest.raises(ValueError, match='multiple'):
        synthesize_element_pallas(_jrec(rec), env, spc=4, interp=1,
                                  n_clks=n_clks, interpret=True)
    xla = np.asarray(jops.synthesize_element(_jrec(rec), env, spc=4,
                                             interp=1, n_clks=n_clks))
    np.testing.assert_allclose(got, xla, atol=2e-3)


def test_synthesize_element_selects_element_and_accepts_tensors():
    rng = np.random.default_rng(11)
    env = (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64)) * 0.9
    rec = _rand_rec(rng, 8, 4, 12, elems=(0, 1, 2))
    trec = {k: torch.as_tensor(v) for k, v in rec.items()}
    for elem in (0, 1, 2):
        got = tops.synthesize_element(trec, tops.complex_to_iq(env), 4, 1,
                                      256, elem=elem)      # CPU tensors
        assert got.device.type == 'cpu'
        ref = tops.synthesize_element_reference(rec, env, 4, 1, 256,
                                                elem=elem)
        assert torch.equal(got, ref)
        pallas = np.asarray(synthesize_element_pallas(
            _jrec(rec), env, spc=4, interp=1, n_clks=256, elem=elem,
            interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4)
    # no pulse on the element, and an empty table: zeros
    none = tops.synthesize_element(rec, env, 4, 1, 64, elem=3, device='cpu')
    assert none.shape == (256, 2) and not none.any()
    empty = tops.synthesize_element(rec, np.zeros(0, complex), 4, 1, 64,
                                    device='cpu')
    assert not empty.any()


def test_synthesize_element_long_trace_phase_is_exact():
    """A pulse a million samples in: the 32-bit NCO keeps the phase that
    float64 arithmetic gives (atol 1e-5)."""
    freq_rel, gtime, spc = np.float32(0.1234567), 65000, 16
    rec = _rec([dict(gtime=gtime, env=(4 << 12) | 0, freq_rel=freq_rel,
                     amp=0xffff)])
    got = tops.iq_to_complex(tops.synthesize_element(
        rec, np.ones(16, complex), spc, 1, gtime + 8, device='cpu'))
    n = gtime * spc + np.arange(16)
    inc = int(np.round(np.float64(freq_rel) * 2 ** 32))
    want = np.exp(2j * np.pi * ((inc * n) % (1 << 32)) / 2 ** 32)
    np.testing.assert_allclose(got[n], want, atol=1e-5)


def test_synthesize_element_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA'):
        tops.synthesize_element(_selftest_rec(), np.ones(64, complex), 4, 1,
                                128)


@pytest.mark.parametrize('shape,tol', [
    ((37, 64, 6), dict(rtol=1e-5, atol=1e-5)),
    ((1000, 1024, 8), dict(rtol=2e-4, atol=2e-3)),
    ((5, 130, 2), dict(rtol=1e-5, atol=1e-5)),
], ids=['37x64x6', '1000x1024x8', '5x130x2'])
def test_demod_iq_matches_jax(shape, tol):
    S, N, J = shape
    rng = np.random.default_rng(0)
    adc = rng.standard_normal((S, N)).astype(np.float32)
    w = rng.standard_normal((N, J)).astype(np.float32)
    got = tops.demod_iq(adc, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, J // 2, 2)
    assert torch.equal(got, tops.demod_iq_reference(torch.as_tensor(adc), w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.demod_iq(adc, w)),
                               **tol)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jops.demod_iq_pallas(adc, w, block_s=16, interpret=True)),
        **tol)


def test_demod_iq_rejects_bad_shapes():
    with pytest.raises(ValueError, match='2M'):
        tops.demod_iq(np.zeros((4, 8), np.float32), np.zeros((8, 3)))
    with pytest.raises(ValueError, match='2M'):
        tops.demod_iq(np.zeros((4, 8), np.float32), np.zeros((7, 2)))


def test_demod_matched_filter():
    fsamp, fr, spc, n_clks = 2e9, 0.125, 4, 16
    n = np.arange(n_clks * spc)
    adc = np.real(0.7 * np.exp(2j * np.pi * fr * n))[None, :]
    w = tops.pulse_window_weights(0, n_clks, spc, fr * fsamp, fsamp)
    iq = tops.iq_to_complex(tops.demod_iq(adc, w))
    assert abs(iq[0, 0].real - 0.7 * len(n) / 2) < 1e-2
    w2 = tops.pulse_window_weights(0, n_clks, spc, 0.25 * fsamp, fsamp)
    assert abs(tops.iq_to_complex(tops.demod_iq(adc, w2))[0, 0]) \
        < 1e-3 * len(n)


def test_discriminate_matches_jax():
    rng = np.random.default_rng(3)
    iq = rng.standard_normal((200, 3, 2)).astype(np.float32) * 2
    c0 = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    c1 = c0 + 2 * np.exp(1j * rng.uniform(0, 6, 3))
    for thr in (0.0, 0.5):
        want = np.asarray(jops.discriminate(iq, c0, c1, thr))
        got = tops.discriminate(iq, c0, c1, thr)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # real [M, 2] centroids are accepted too
    got = tops.discriminate(torch.as_tensor(iq), tops.complex_to_iq(c0),
                            tops.complex_to_iq(c1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.discriminate(iq, c0, c1)))
    bits = tops.discriminate(np.array([[[0.1, 0.1]], [[1.9, 1.8]],
                                       [[0.9, 1.2]]]),
                             np.array([0j]), np.array([2 + 2j]))
    assert bits[:, 0].tolist() == [0, 1, 1]


@pytest.mark.parametrize('use_pallas', [False, True])
def test_readout_chain_matches_jax(use_pallas):
    """Tones for states 0/1 with noise -> demod -> threshold: bits equal
    to the JAX chain's, fidelity high at this SNR."""
    rng = np.random.default_rng(1)
    fsamp, fr, spc, n_clks, shots = 2e9, 0.05, 4, 64, 512
    N = n_clks * spc
    n = np.arange(N)
    states = rng.integers(0, 2, shots)
    phase = np.where(states, np.pi / 2, 0.0)
    adc = np.real(np.exp(2j * np.pi * fr * n[None, :] + 1j * phase[:, None]))
    adc = (adc + 0.5 * rng.standard_normal((shots, N))).astype(np.float32)
    w = tops.stack_window_weights(
        [tops.pulse_window_weights(0, n_clks, spc, fr * fsamp, fsamp)], N)
    c0 = np.array([N / 2 + 0j])
    c1 = np.array([(N / 2) * np.exp(1j * np.pi / 2)])
    bits, iq = tops.demod_and_discriminate(adc, w, c0, c1,
                                           use_pallas=use_pallas,
                                           interpret=True)
    jbits, jiq = jops.demod_and_discriminate(adc, w, c0, c1,
                                             use_pallas=use_pallas,
                                             interpret=True)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(iq.numpy(), np.asarray(jiq), rtol=2e-4,
                               atol=2e-3)
    assert np.mean(bits.numpy()[:, 0] == states) > 0.99


def test_window_helpers_equal_jax():
    rng = np.random.default_rng(2)
    env = rng.standard_normal(4 * 20) + 1j * rng.standard_normal(4 * 20)
    for kw in (dict(), dict(env=env)):
        np.testing.assert_array_equal(
            tops.pulse_window_weights(7, 20, 4, 6.1e9, 8e9, **kw),
            jops.pulse_window_weights(7, 20, 4, 6.1e9, 8e9, **kw))
    ws = [rng.standard_normal((k, 2)).astype(np.float32) for k in (4, 9, 6)]
    for starts in (None, [0, 3, 10]):
        np.testing.assert_array_equal(
            tops.stack_window_weights(ws, 12, starts=starts),
            jops.stack_window_weights(ws, 12, starts=starts))
    z = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    np.testing.assert_array_equal(tops.complex_to_iq(z), jops.complex_to_iq(z))
    np.testing.assert_array_equal(
        tops.iq_to_complex(tops.complex_to_iq(z)),
        jops.iq_to_complex(jops.complex_to_iq(z)))
    table = rng.uniform(4e9, 7e9, 5)
    idx = np.array([0, 4, 5, 9, -1, 2], np.int32)
    want = np.asarray(jops.resolve_pulse_freqs(jnp.asarray(idx), table, 8e9))
    np.testing.assert_array_equal(
        tops.resolve_pulse_freqs(idx, table, 8e9), want)
    np.testing.assert_array_equal(
        tops.resolve_pulse_freqs(torch.as_tensor(idx), table, 8e9).numpy(),
        want)


# ---------------------------------------------------------------------------
# one-shot simulate and the config factory


@pytest.mark.parametrize('name', ['active_reset_2q', 'fproc_hold'])
@pytest.mark.parametrize('with_inputs', [False, True])
def test_simulate_matches_jax(name, with_inputs):
    n, thunk = GOLDEN_PROGRAMS[name]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        mp = pipeline.compile_to_machine(
            J_GOLDEN_PROGRAMS[name][1](),
            models.make_default_qchip(max(n, 2)), n_qubits=n)
        tmp = tpipeline.compile_to_machine(
            thunk(), tmodels.make_default_qchip(max(n, 2)), n_qubits=n)
    rng = np.random.default_rng(len(name))
    kw = dict(max_meas=4, max_steps=300, opcode_histogram=True)
    args = {}
    if with_inputs:
        args = dict(
            meas_bits=rng.integers(0, 2, (mp.n_cores, 3)).astype(np.int32),
            init_regs=rng.integers(-4, 4, (mp.n_cores, 16)).astype(np.int32))
    want = jax_simulate(mp, cfg=JCfg(engine='generic', **kw), **args)
    got = torch_simulate(tmp, cfg=TCfg(**kw), device='cpu', **args)
    assert set(got) == set(want)
    for key in sorted(want):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    with pytest.raises(ValueError, match='n_cores, n_meas'):
        torch_simulate(tmp, meas_bits=np.zeros((2, mp.n_cores, 3)),
                       device='cpu')


def test_from_fpga_config_matches_jax():
    import dataclasses
    kw = dict(alu_instr_clks=7, jump_cond_clks=6, jump_fproc_clks=9,
              pulse_regwrite_clks=4, pulse_load_clks=2)
    want = JCfg.from_fpga_config(JFPGAConfig(**kw), max_meas=3,
                                 fabric='fresh')
    got = TCfg.from_fpga_config(TFPGAConfig(**kw), max_meas=3,
                                fabric='fresh')
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(TCfg.from_fpga_config(TFPGAConfig())) \
        == dataclasses.asdict(JCfg.from_fpga_config(JFPGAConfig()))
    # a configured measurement LUT flows into lut_mask / lut_table
    lut = dict(n_cores=2, meas_lut_mask=(True, True),
               meas_lut_table=(0, 1, 2, 3))
    assert dataclasses.asdict(TCfg.from_fpga_config(TFPGAConfig(**lut))) \
        == dataclasses.asdict(JCfg.from_fpga_config(JFPGAConfig(**lut)))


# ---------------------------------------------------------------------------
# sampled readout models: CLT bounds (torch's generator is not threefry)


def test_sample_meas_bits_rates():
    p1 = np.array([0.1, 0.5, 0.85, 0.0, 1.0], np.float32)
    shots, n_meas = 4000, 3
    bits = sample_meas_bits(make_generator(5), p1, shots, n_meas)
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (shots, len(p1), n_meas)
    assert set(np.unique(bits.numpy())) <= {0, 1}
    n = shots * n_meas
    rate = bits.float().mean((0, 2)).numpy()
    # 5 sigma of a binomial mean over n draws per core
    tol = 5 * np.sqrt(p1 * (1 - p1) / n)
    assert np.all(np.abs(rate - p1) <= tol + 1e-12), (rate, tol)
    again = sample_meas_bits(make_generator(5), p1, shots, n_meas)
    assert torch.equal(bits, again)          # same seed, same bits


def test_apply_assignment_error_rates():
    rng = np.random.default_rng(0)
    bits = torch.as_tensor(rng.integers(0, 2, (20000, 4)).astype(np.int32))
    p01, p10 = 0.08, 0.25
    out = apply_assignment_error(make_generator(9), bits, p01, p10)
    assert out.dtype == bits.dtype and out.shape == bits.shape
    flipped = (out != bits)
    for value, p in ((0, p01), (1, p10)):
        sel = bits == value
        n = int(sel.sum())
        rate = float(flipped[sel].float().mean())
        assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / n), (value, rate)
    same = apply_assignment_error(make_generator(9), bits, 0.0, 0.0)
    assert torch.equal(same, bits)


def test_iq_readout_model_clouds():
    c0 = np.array([1 + 0j, 0.5 + 0.5j])
    c1 = np.array([-0.6 + 0.8j, -0.5 - 0.5j])
    model = IQReadoutModel(c0, c1, sigma=0.2)
    rng = np.random.default_rng(4)
    states = rng.integers(0, 2, (20000, 2))
    bits, iq = model.measure(make_generator(3), states)
    assert tuple(iq.shape) == (20000, 2, 2) and iq.dtype == torch.float32
    # cloud means within 5 sigma/sqrt(n) of the centres, per core and state
    for c in range(2):
        for s, centre in ((0, c0[c]), (1, c1[c])):
            pts = iq[:, c][torch.as_tensor(states[:, c] == s)].numpy()
            tol = 5 * 0.2 / np.sqrt(len(pts))
            assert abs(pts[:, 0].mean() - centre.real) < tol
            assert abs(pts[:, 1].mean() - centre.imag) < tol
    # the clouds are > 4 sigma apart: assignment nearly always right
    assert np.mean(bits.numpy() == states) > 0.99
