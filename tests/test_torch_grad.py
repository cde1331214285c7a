"""The port's differentiable physics (``sim/grad.py`` on torch autograd)
against the JAX package's, on the CPU.

* Each function's value and gradient matches JAX's to rtol 1e-5 on the
  same float32 inputs.
* ``grad_loss`` agrees with central finite differences for every knob to
  rtol 0.02 at tests/test_calib.py's probe points.
* The hard threshold's gradient is exactly zero; ``st_threshold`` is the
  hard bit forward and the sigmoid surrogate backward, with zero
  gradient for ``temp`` (also under ``torch.func.vmap``).
* ``score_function_grad`` is unbiased within a CLT bound.
* ``grad_loss_batch`` (one ``torch.func.vmap`` call) is bit-identical to
  the sequential per-candidate path.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_processor_tpu.sim.grad as J

import distributed_processor_tpu_torch.sim.grad as T

torch.set_num_threads(1)

RTOL = 1e-5            # port against JAX, float32 both
FD_RTOL = 0.02         # tests/test_calib.py's finite-difference tolerance
CPU = 'cpu'

# tests/test_calib.py's specs and probe points, per knob
SPECS = {'amplitude': dict(knob='amplitude', x90_amp=0.48),
         'drag': dict(knob='drag', drag_delta=-30e6),
         'readout_window': dict(knob='readout_window', window_edge=8.0)}
PROBES = {'amplitude': (0.30, 0.45, 0.65), 'drag': (0.2, 0.6, 1.5),
          'readout_window': (48.0, 160.0, 280.0)}
FD_EPS = {'amplitude': 1e-3, 'drag': 1e-2, 'readout_window': 1.0}
CASES = [(k, x) for k in SPECS for x in PROBES[k]]


def _specs(knob):
    return J.LossSpec(**SPECS[knob]), T.LossSpec(**SPECS[knob])


def _t(x, requires_grad=False):
    return torch.tensor(x, dtype=torch.float32, requires_grad=requires_grad)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize('knob,x', CASES, ids=[f'{k}-{x}' for k, x in CASES])
def test_grad_loss_matches_jax(knob, x):
    jspec, tspec = _specs(knob)
    name = J.PARAM_NAME[knob]
    jl, jg = J.grad_loss({name: x}, jspec)
    tl, tg = T.grad_loss({name: x}, tspec, device=CPU)
    assert tl.dtype == tg[name].dtype == torch.float32
    assert set(tg) == set(jg) == {name}
    _close(float(tl), float(jl))
    _close(float(tg[name]), float(jg[name]))


@pytest.mark.parametrize('knob,x', CASES, ids=[f'{k}-{x}' for k, x in CASES])
def test_fd_agreement(knob, x):
    """tests/test_calib.py's contract on the port: the gradient agrees
    with central differences through the same float32 front door."""
    _, spec = _specs(knob)
    name, eps = T.PARAM_NAME[knob], FD_EPS[knob]
    _, grads = T.grad_loss({name: x}, spec, device=CPU)
    lp, _ = T.grad_loss({name: x + eps}, spec, device=CPU)
    lm, _ = T.grad_loss({name: x - eps}, spec, device=CPU)
    fd = (float(lp) - float(lm)) / (2.0 * eps)
    assert float(grads[name]) == pytest.approx(fd, rel=FD_RTOL)


@pytest.mark.parametrize('amp,alpha', [(0.5, 0.0), (0.9, 0.7), (1.3, -2.0)])
def test_drag_envelope_matches_jax(amp, alpha):
    kw = dict(delta=-30e6)
    ji, jq = J.drag_envelope(amp, alpha, **kw)
    ti, tq = T.drag_envelope(amp, _t(alpha), **kw)
    assert ti.dtype == torch.float32 and ti.shape == (24,)
    _close(ti.numpy(), ji, atol=1e-7)
    _close(tq.numpy(), jq, atol=1e-7)

    def jf(a, b):
        i, q = J.drag_envelope(a, b, **kw)
        return jnp.sum(i * jnp.arange(24.0)) + jnp.sum(q ** 2)

    def tf(a, b):
        i, q = T.drag_envelope(a, b, **kw)
        return torch.sum(i * torch.arange(24.0)) + torch.sum(q ** 2)

    jg = jax.grad(jf, argnums=(0, 1))(jnp.float32(amp), jnp.float32(alpha))
    tg = torch.func.grad(tf, argnums=(0, 1))(_t(amp), _t(alpha))
    for g_t, g_j in zip(tg, jg):
        _close(float(g_t), float(g_j))


def _pairs(fj, ft, args):
    """Value and gradient in every argument of ``fj`` (JAX) and ``ft``
    (torch) on the same float32 scalars."""
    n = len(args)
    jv = fj(*[jnp.float32(a) for a in args])
    tv = ft(*[_t(a) for a in args])
    _close(float(tv), float(jv))
    jg = jax.grad(fj, argnums=tuple(range(n)))(*[jnp.float32(a)
                                                 for a in args])
    tg = torch.func.grad(ft, argnums=tuple(range(n)))(*[_t(a)
                                                        for a in args])
    for g_t, g_j in zip(tg, jg):
        _close(float(g_t), float(g_j), atol=1e-12)


@pytest.mark.parametrize('amp', [0.1, 0.48, 0.9])
def test_bloch_p1_matches_jax(amp):
    _pairs(lambda a, x: J.bloch_p1(a, x), lambda a, x: T.bloch_p1(a, x),
           (amp, 0.47))


# windows cut by the record's start or end: a window wholly inside it has
# a mask energy whose derivative is zero up to float32 rounding, which
# no relative tolerance can compare
@pytest.mark.parametrize('start', [-20.0, 210.0, 400.0])
def test_window_functions_match_jax(start):
    _pairs(lambda s: jnp.sum(J.window_mask(s, 64.0, 256) ** 2),
           lambda s: torch.sum(T.window_mask(s, 64.0, 256) ** 2), (start,))
    _pairs(lambda s: J.window_snr(s, width=64.0, horizon=256),
           lambda s: T.window_snr(s, width=64.0, horizon=256), (start,))
    _pairs(lambda a: J.drag_leakage(a, delta=-30e6),
           lambda a: T.drag_leakage(a, delta=-30e6), (start / 100.0,))


def test_matched_filter_and_error_prob_match_jax():
    g0, g1 = (0.3, -0.2), (-0.5, 0.4)
    for acc_i, acc_q, energy in ((1.0, -2.0, 3.0), (-0.4, 0.9, 12.5),
                                 (0.0, 0.0, 0.25)):
        _pairs(lambda a, b, e: J.matched_filter_projection(a, b, e, g0, g1),
               lambda a, b, e: T.matched_filter_projection(a, b, e, g0, g1),
               (acc_i, acc_q, energy))
    for energy in (0.01, 1.0, 40.0):
        for sigma in (0.3, 2.0):
            _pairs(lambda e, s: J.assignment_error_prob(e, g0, g1, s),
                   lambda e, s: T.assignment_error_prob(e, g0, g1, s),
                   (energy, sigma))


def test_hard_threshold_gradient_exactly_zero():
    proj = _t([-2.0, -1e-6, 0.0, 1e-6, 2.0])
    g = torch.func.grad(lambda s: torch.sum(T.hard_threshold(s * proj)))(
        _t(1.0))
    assert float(g) == 0.0
    np.testing.assert_array_equal(
        T.hard_threshold(proj).numpy(),
        np.asarray(J.hard_threshold(jnp.asarray(proj.numpy()))))


def test_st_threshold_forward_is_hard_bit_backward_is_surrogate():
    proj = _t([-3.0, -0.5, 0.0, 0.5, 3.0])
    np.testing.assert_array_equal(T.st_threshold(proj).numpy(),
                                  T.hard_threshold(proj).numpy())
    temp = 0.7
    g = torch.func.grad(
        lambda p: torch.sum(T.st_threshold(p, _t(temp))))(proj)
    sg = torch.sigmoid(proj / temp)
    _close(g.numpy(), (sg * (1 - sg) / temp).numpy(), rtol=1e-6)
    jg = jax.grad(lambda p: jnp.sum(J.st_threshold(p, jnp.float32(temp))))(
        jnp.asarray(proj.numpy()))
    _close(g.numpy(), jg, rtol=RTOL)
    # temp is an estimator knob, not a physical parameter: zero grad
    gt = torch.func.grad(lambda t: torch.sum(T.st_threshold(proj, t)))(
        _t(temp))
    assert float(gt) == 0.0
    # autograd directly, and the batched (vmap) rule
    p = proj.clone().requires_grad_()
    T.st_threshold(p, temp).sum().backward()
    assert torch.equal(p.grad, g)
    batch = torch.stack([proj, -proj, 2 * proj])
    bg = torch.func.vmap(torch.func.grad(
        lambda p: torch.sum(T.st_threshold(p, _t(temp)))))(batch)
    for row, want in zip(bg, batch):
        assert torch.equal(row, torch.func.grad(
            lambda p: torch.sum(T.st_threshold(p, _t(temp))))(want))


def test_score_function_grad_unbiased():
    """REINFORCE on sampled branch bits: for f(b) = 2b + 1 the exact
    derivative of E[f] is f(1) - f(0) = 2; the estimate over 20000
    seeded draws lands within 5 of its standard errors, and equals JAX's
    estimate on the same bits."""
    rng = np.random.default_rng(20)
    p, n = 0.3, 20000
    bits = (rng.random(n) < p).astype(np.float32)
    f_vals = 2.0 * bits + 1.0
    est = float(T.score_function_grad(p, bits, f_vals, device=CPU))
    score = bits / p - (1 - bits) / (1 - p)
    se = float(np.std(f_vals * score) / np.sqrt(n))
    assert abs(est - 2.0) < 5 * se
    _close(est, float(J.score_function_grad(p, bits, f_vals)))


@pytest.mark.parametrize('knob,vals', [
    ('amplitude', np.linspace(0.2, 0.8, 9)),
    ('drag', np.linspace(0.1, 1.9, 5)),
    ('readout_window', np.linspace(16.0, 400.0, 7)),
])
def test_grad_loss_batch_bit_identical_to_sequential(knob, vals):
    """One batched call over the candidates equals the per-candidate
    path bit for bit, and JAX's batch to rtol 1e-5."""
    _, spec = _specs(knob)
    name = T.PARAM_NAME[knob]
    vals = np.asarray(vals, np.float32)
    b_loss, b_grads = T.grad_loss_batch({name: vals}, spec, device=CPU)
    assert b_loss.shape == b_grads[name].shape == (len(vals),)
    for i, v in enumerate(vals):
        loss, grads = T.grad_loss({name: v}, spec, device=CPU)
        assert torch.equal(b_loss[i], loss)
        assert torch.equal(b_grads[name][i], grads[name])
    j_loss, j_grads = J.grad_loss_batch({name: vals}, J.LossSpec(
        **SPECS[knob]))
    _close(b_loss.numpy(), j_loss)
    _close(b_grads[name].numpy(), j_grads[name])


def test_loss_spec_and_constants_match_jax():
    assert T.KNOBS == J.KNOBS and T.PARAM_NAME == J.PARAM_NAME
    assert T.AMP_SCALE == J.AMP_SCALE
    assert dataclasses.asdict(T.LossSpec()) == dataclasses.asdict(
        J.LossSpec())
    with pytest.raises(ValueError) as e_t:
        T.LossSpec(knob='nope')
    with pytest.raises(ValueError) as e_j:
        J.LossSpec(knob='nope')
    assert str(e_t.value) == str(e_j.value)
    # the default spec's loss at the nominal amplitude: equal values
    tl, _ = T.grad_loss({'amp': 0.48}, device=CPU)
    jl, _ = J.grad_loss({'amp': 0.48})
    _close(float(tl), float(jl))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    for call in (lambda: T.grad_loss({'amp': 0.5}),
                 lambda: T.grad_loss_batch({'amp': [0.5, 0.6]}),
                 lambda: T.window_snr(100.0),
                 lambda: T.drag_envelope(1.0, 0.5),
                 lambda: T.score_function_grad(0.3, [0.0, 1.0], [1.0, 3.0])):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
    # a tensor argument's device is the device of the work
    assert T.window_snr(_t(100.0)).device.type == 'cpu'
