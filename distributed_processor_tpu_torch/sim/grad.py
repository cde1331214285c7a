"""Differentiable physics: gradients through the readout/drive chain.

Counterpart of the JAX package's ``sim/grad.py`` on torch autograd.  Two
points in the chain are non-differentiable by construction: the
measurement *branch* (traffic-dependent control flow on fproc bits) and
the discrimination threshold (a hard ``proj > 0``).  This module gives
calibration a differentiable mirror of the pulse -> envelope ->
window-synthesis -> demod -> discrimination path plus explicit
estimator choices at the discrete points:

* **smooth observables** — everything upstream of the threshold
  (matched-filter projection, window energy, assignment-error
  probability via the Gaussian error function) differentiates exactly;
  finite-difference agreement is pinned in tests/test_torch_grad.py.
* **straight-through** (:func:`st_threshold`) — forward pass is the
  exact hard bit, backward pass substitutes a sigmoid surrogate (a
  ``torch.autograd.Function``); the hard threshold itself has an
  exactly-zero gradient (also pinned).
* **score function** (:func:`score_function_grad`) — REINFORCE for
  losses of *sampled* bits where the branch taken depends on traffic:
  unbiased, needs no path derivative through the branch at all.

Everything here is float32 (the interpreter's native dtype).  A
function that makes tensors of its own (an envelope, a window, the
loss front doors) runs on ``device=`` if given, else on the device of
its tensor argument, else on CUDA, like every entry point of the port;
the others compute on their inputs' device.  The envelope mirrors
:func:`~..envelopes.drag` numerically, and the discriminator mirrors
the physics resolver's ``_discriminate_acc`` term for term, so a
gradient taken here linearizes the same arithmetic the simulator
executes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .interpreter import torch_device

# the interpreter's amplitude word scale: gate amp a in [0, 1] compiles
# to round(a * AMP_SCALE) (isa amp_word); executed rec_amp words map
# back through the same constant
AMP_SCALE = float(2 ** 16 - 1)

F32 = torch.float32


def _device(x, device) -> torch.device:
    """``device`` if given, else ``x``'s device if it is a tensor, else
    the entry points' default (CUDA, :func:`~.interpreter.torch_device`)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return torch_device(device)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# differentiable envelope synthesis (mirror of envelopes.drag)
# ---------------------------------------------------------------------------

def drag_envelope(amp, alpha, *, twidth: float = 24e-9,
                  sigmas: float = 3.0, delta: float = -270e6,
                  sample_rate: float = 1e9, device=None):
    """Complex DRAG envelope, differentiable in ``amp`` and ``alpha``.

    Numerically mirrors :func:`~..envelopes.drag` (gaussian I with
    edge lift, Q = alpha * dI/dt / (2 pi delta), peak renorm when the
    peak exceeds 1) with torch ops so autograd flows through both the
    amplitude and the DRAG coefficient.  Returns ``(env_i, env_q)``
    float32 tensors of ``round(twidth * sample_rate)`` samples.
    """
    dev = _device(alpha if isinstance(alpha, torch.Tensor) else amp,
                  device)
    n = int(round(twidth * sample_rate))
    sigma = twidth / sigmas
    t = (torch.arange(n, dtype=F32, device=dev) + 0.5) / sample_rate \
        - twidth / 2
    env_i = torch.exp(-t ** 2 / (2 * sigma ** 2))
    edge = torch.exp(_f32(-(twidth / 2) ** 2 / (2 * sigma ** 2), dev))
    env_i = (env_i - edge) / (1 - edge)
    d_env = -(t / sigma ** 2) * torch.exp(-t ** 2 / (2 * sigma ** 2)) \
        / (1 - edge)
    env_q = alpha * d_env / (2 * math.pi * delta)
    peak = torch.sqrt(torch.max(env_i ** 2 + env_q ** 2))
    renorm = torch.maximum(peak, torch.ones_like(peak))
    scale = amp / renorm
    return (scale * env_i).to(F32), (scale * env_q).to(F32)


def drag_leakage(alpha, *, twidth: float = 24e-9, sigmas: float = 3.0,
                 delta: float = -270e6, sample_rate: float = 1e9,
                 device=None):
    """Spectral leakage proxy for the DRAG knob: the envelope's power
    at the anharmonic transition's detuning ``delta``.

    ``|sum_t (I(t) + iQ(t)) exp(-2 pi i delta t)|^2``, normalized by
    the zero-detuning power so the loss is O(1).  To first order the
    derivative quadrature cancels the gaussian's spectral weight at
    ``delta``, so the minimum sits near alpha = 1 (the discrete
    sampling and edge lift shift it slightly); gradient descent on
    this loss is the DRAG-coefficient calibration loop's inner model.
    """
    dev = _device(alpha, device)
    env_i, env_q = drag_envelope(1.0, alpha, twidth=twidth,
                                 sigmas=sigmas, delta=delta,
                                 sample_rate=sample_rate, device=dev)
    n = env_i.shape[0]
    t = (torch.arange(n, dtype=F32, device=dev) + 0.5) / sample_rate
    ph = -2 * math.pi * delta * t
    c, s = torch.cos(ph), torch.sin(ph)
    # (I + iQ) * (cos + i sin), accumulated
    re = torch.sum(env_i * c - env_q * s)
    im = torch.sum(env_i * s + env_q * c)
    norm = torch.sum(env_i) ** 2 + torch.sum(env_q) ** 2
    return (re ** 2 + im ** 2) / norm


# ---------------------------------------------------------------------------
# differentiable drive response (amplitude knob)
# ---------------------------------------------------------------------------

def bloch_p1(amp, x90_amp):
    """Excited-state population after one drive at ``amp``: the Bloch
    rotation model the statevec device implements — a drive is a
    rotation by ``theta = (pi/2) * amp / x90_amp`` about X, so
    ``p1 = sin^2(theta / 2)``.  Smooth in ``amp``; the amplitude
    calibration loss ``(p1 - 1/2)^2`` has its minimum exactly at the
    device's true X90 amplitude."""
    theta = (math.pi / 2) * amp / x90_amp
    return torch.sin(theta / 2) ** 2


# ---------------------------------------------------------------------------
# differentiable readout window (placement knob)
# ---------------------------------------------------------------------------

def window_mask(start, width, horizon: int, *, edge: float = 4.0,
                device=None):
    """Soft-edged integration window over ``horizon`` ADC samples:
    ``sigmoid((s - start)/edge) - sigmoid((s - start - width)/edge)``.
    Differentiable in ``start`` (the placement knob); samples past the
    horizon simply do not exist, which is what makes the placement
    optimum interior (see :func:`window_snr`)."""
    s = torch.arange(horizon, dtype=F32, device=_device(start, device))
    return torch.sigmoid((s - start) / edge) \
        - torch.sigmoid((s - start - width) / edge)


def window_snr(start, *, width: float = 192.0, horizon: int = 512,
               ring_tau: float = 96.0, edge: float = 4.0, device=None):
    """Matched-filter SNR of a soft window placed at ``start`` over a
    resonator ring-up ``r(s) = 1 - exp(-(s+1)/ring_tau)`` (the same
    weighting the physics resolver applies to the signal path).

    ``snr = (sum m r)^2 / sum m`` — signal integrates the rung-up
    transmission, noise variance integrates the window (white ADC
    noise).  Opening the window later trades low-amplitude early
    samples for rung-up ones until the window starts falling off the
    ``horizon``-sample record: the optimum is interior, which is what
    the readout-window placement loop descends to."""
    dev = _device(start, device)
    m = window_mask(start, width, horizon, edge=edge, device=dev)
    s = torch.arange(horizon, dtype=F32, device=dev)
    r = 1.0 - torch.exp(-(s + 1.0) / ring_tau)
    sig = torch.sum(m * r)
    noise = torch.sum(m) + 1e-6
    return sig ** 2 / noise


# ---------------------------------------------------------------------------
# demod + discrimination (mirror of the resolver's _discriminate_acc)
# ---------------------------------------------------------------------------

def matched_filter_projection(acc_i, acc_q, energy, g0, g1):
    """The |0>-|1> axis projection of a matched-filter accumulation —
    term-for-term the pre-threshold arithmetic of the physics
    resolver's ``_discriminate_acc`` (clean responses ``a_s = g_s *
    E``), without the trailing ``> 0``.  Smooth in every input; the
    hard bit is ``proj > 0``."""
    a0_i, a0_q = g0[0] * energy, g0[1] * energy
    a1_i, a1_q = g1[0] * energy, g1[1] * energy
    return (acc_i - (a0_i + a1_i) / 2) * (a1_i - a0_i) \
        + (acc_q - (a0_q + a1_q) / 2) * (a1_q - a0_q)


def assignment_error_prob(energy, g0, g1, sigma):
    """Smooth readout assignment-error probability.

    Under the analytic matched-filter model (``acc = g_s E + sigma
    sqrt(E) xi``, ``xi ~ N(0, I2)``) the projection is Gaussian with
    mean ``+-|g1-g0|^2 E^2 / 2`` and std ``sigma sqrt(E) |g1-g0| E``, so
    ``p_err = 0.5 erfc(|g1 - g0| sqrt(E) / (2 sqrt(2) sigma))``.
    Differentiable in ``energy`` — and through it in window placement
    and drive amplitude — unlike the empirical error *rate*, which is
    a mean of hard bits.  ``energy`` is a tensor; the result is on its
    device."""
    dev = energy.device
    dg = torch.sqrt(_f32((g1[0] - g0[0]) ** 2 + (g1[1] - g0[1]) ** 2, dev))
    z = dg * torch.sqrt(energy) / (2 * torch.sqrt(_f32(2.0, dev)) * sigma)
    return 0.5 * torch.special.erfc(z)


def hard_threshold(proj):
    """The exact discrimination bit, ``(proj > 0)`` as float32.  Its
    gradient is identically ZERO everywhere (the comparison is
    piecewise constant) — pinned in tests/test_torch_grad.py as the
    documented behavior at the discrimination boundary; use
    :func:`st_threshold` when a surrogate gradient is wanted."""
    return (proj > 0).to(F32)


class _StraightThrough(torch.autograd.Function):
    """The hard bit forward, the sigmoid surrogate's derivative
    backward, zero for ``temp`` (the JAX package's ``custom_vjp``).
    ``generate_vmap_rule``: :func:`torch.func.vmap` batches it through
    its torch ops, so :func:`grad_loss_batch`-style callers can use it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(proj, temp):
        return (proj > 0).to(F32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        proj, temp = ctx.saved_tensors
        sg = torch.sigmoid(proj / temp)
        return g * sg * (1 - sg) / temp, torch.zeros_like(temp)


def st_threshold(proj, temp=1.0):
    """Straight-through discrimination bit: forward is the exact hard
    bit ``(proj > 0)``, backward substitutes the sigmoid surrogate
    ``d/dproj sigmoid(proj / temp)``.  ``temp`` sets the surrogate's
    sharpness; its own gradient is defined as zero (it is an estimator
    knob, not a physical parameter)."""
    return _StraightThrough.apply(proj, _f32(temp, proj.device))


def score_function_grad(p, bits, f_vals, device=None):
    """REINFORCE estimator for traffic-dependent branches: an unbiased
    estimate of ``d/dp E_{b~Bern(p)}[f(b)]`` from sampled bits.

    ``grad = mean(f(b) * d log P(b) / dp)
          = mean(f * (b/p - (1-b)/(1-p)))`` — no derivative ever flows
    through the branch itself, so this is the estimator of record when
    the simulated traffic BRANCHES on the measured bit (active reset,
    QEC feedback) and the pathwise surrogate of :func:`st_threshold`
    has no path to follow.  Exact expectation is ``f(1) - f(0)``
    (pinned statistically in tests/test_torch_grad.py)."""
    dev = _device(bits, device)
    p = torch.clamp(_f32(p, dev), 1e-6, 1 - 1e-6)
    bits = _f32(bits, dev)
    score = bits / p - (1.0 - bits) / (1.0 - p)
    return torch.mean(_f32(f_vals, dev) * score)


# ---------------------------------------------------------------------------
# the calibration losses + grad_loss front door
# ---------------------------------------------------------------------------

KNOBS = ('amplitude', 'drag', 'readout_window')


@dataclass(frozen=True)
class LossSpec:
    """Static description of one calibration loss.

    ``knob`` picks the loss; the remaining fields parameterize the
    forward model — ``x90_amp`` is the DEVICE-TRUTH quarter-turn
    amplitude the amplitude loop estimates (the nominal calibration
    may have drifted from it; that drift is what calibration
    corrects), ``target_p1`` the drive setpoint (1/2 for an X90),
    the ``window_*``/``ring_tau`` fields the readout-window SNR
    model, and the ``drag_*`` fields the leakage model."""
    knob: str = 'amplitude'
    # amplitude knob
    x90_amp: float = 0.48
    target_p1: float = 0.5
    # readout-window knob (units: ADC samples)
    window_width: float = 192.0
    window_horizon: int = 512
    ring_tau: float = 96.0
    window_edge: float = 4.0
    # drag knob
    drag_twidth: float = 24e-9
    drag_sigmas: float = 3.0
    drag_delta: float = -270e6
    sample_rate: float = 1e9

    def __post_init__(self):
        if self.knob not in KNOBS:
            raise ValueError(
                f'unknown knob {self.knob!r}; one of {KNOBS}')


# per-knob parameter name inside the pulse_params dict
PARAM_NAME = {'amplitude': 'amp', 'drag': 'alpha',
              'readout_window': 'window_start'}


def loss_fn(pulse_params, spec: LossSpec):
    """Scalar calibration loss for ``spec.knob`` at ``pulse_params``
    (a dict holding at least the knob's parameter as a float32 tensor,
    see :data:`PARAM_NAME`), on that tensor's device.  Smooth by
    construction: each knob's loss is built from the smooth observables
    above, so its gradient is exact (no estimator involved)."""
    if spec.knob == 'amplitude':
        p1 = bloch_p1(pulse_params['amp'], spec.x90_amp)
        return (p1 - spec.target_p1) ** 2
    if spec.knob == 'drag':
        return drag_leakage(pulse_params['alpha'],
                            twidth=spec.drag_twidth,
                            sigmas=spec.drag_sigmas,
                            delta=spec.drag_delta,
                            sample_rate=spec.sample_rate)
    # readout_window: maximize SNR == descend its negation (scaled to
    # O(1) so one learning rate serves every knob)
    snr = window_snr(pulse_params['window_start'],
                     width=spec.window_width,
                     horizon=spec.window_horizon,
                     ring_tau=spec.ring_tau,
                     edge=spec.window_edge)
    return -snr / spec.window_width


def _value_and_grad(spec: LossSpec):
    """``params -> (loss, grads)`` of :func:`loss_fn`, composable with
    :func:`torch.func.vmap`."""
    grad_and_value = torch.func.grad_and_value(lambda p: loss_fn(p, spec))

    def f(params):
        grads, loss = grad_and_value(params)
        return loss, grads
    return f


def grad_loss(pulse_params, spec: LossSpec = LossSpec(), device=None):
    """``(loss, grads)`` of the calibration loss at ``pulse_params`` on
    ``device`` (default CUDA) — the calibration front door.  ``grads``
    mirrors the ``pulse_params`` dict; finite-difference agreement is
    pinned in tests/test_torch_grad.py.
    """
    dev = torch_device(device)
    params = {k: _f32(v, dev) for k, v in pulse_params.items()}
    return _value_and_grad(spec)(params)


def grad_loss_batch(pulse_params, spec: LossSpec = LossSpec(),
                    device=None):
    """:func:`grad_loss` over a population of candidates in one batched
    call (``torch.func.vmap``) on ``device`` (default CUDA): each leaf
    of ``pulse_params`` carries a leading candidate axis.  Agreement
    with the sequential per-candidate path is pinned in
    tests/test_torch_grad.py."""
    dev = torch_device(device)
    params = {k: torch.atleast_1d(_f32(v, dev))
              for k, v in pulse_params.items()}
    return torch.func.vmap(_value_and_grad(spec))(params)
