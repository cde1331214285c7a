"""Experiment-curve fitting for the models/experiments generators.

Counterpart of the JAX package's ``analysis.py``: T1, RB and Ramsey fits
as Levenberg-Marquardt refinements in float32 torch, so a sweep's
statistics can stay on the device end to end.  The same solver (100
iterations, damping from 1e-3, x0.1 on an improving step and x10 on a
rejected one, clipped to [1e-12, 1e12]), the same parameterization and
the same initializations as the JAX package; the Jacobian comes from
``torch.func.jacfwd``.

Decay constants are fitted in log space (``tau = exp(theta)``, ``p =
exp(theta)``): the parameterization is smooth and positive by
construction, so an overshooting step cannot land in a clipped
zero-gradient region.

Each fitter takes plain arrays and returns plain floats; ``device`` is
the torch device the fit runs on (default CUDA; ``'cpu'`` runs it on
the host).
"""

from __future__ import annotations

import numpy as np
import torch

from .sim.interpreter import torch_device


def _gauss_newton(residual_fn, theta0, n_iter: int = 100):
    """Levenberg-Marquardt (adaptively damped Gauss-Newton).

    ``residual_fn(theta) -> [N]``; returns the refined parameter vector.
    The damping shrinks 10x on improving steps and grows 10x on rejected
    ones (rejected steps keep the previous iterate).  A fixed iteration
    count and device-side selects keep the loop free of host syncs."""
    jac_fn = torch.func.jacfwd(residual_fn)
    theta = theta0
    lam = torch.tensor(1e-3, dtype=torch.float32, device=theta.device)
    eye = torch.eye(theta.shape[0], dtype=torch.float32, device=theta.device)
    for _ in range(n_iter):
        r = residual_fn(theta)
        J = jac_fn(theta)
        # solve_ex leaves a singular system's non-finite step to the
        # improvement test (which rejects it) instead of raising
        step = torch.linalg.solve_ex(J.T @ J + lam * eye, J.T @ r)[0]
        cand = theta - step
        better = (residual_fn(cand) ** 2).sum() < (r ** 2).sum()
        theta = torch.where(better, cand, theta)
        lam = torch.where(better, lam * 0.1, lam * 10.0).clamp(1e-12, 1e12)
    return theta


def _fit_exp(x, y):
    # init: c from the tail, a from the head, tau from the log-slope of
    # the first half (guarded against non-positive values)
    c0 = y[-1]
    a0 = y[0] - c0
    half = max(x.shape[0] // 2, 2)
    z = torch.log((y[:half] - c0).abs().clamp(min=1e-9))
    slope = (z[-1] - z[0]) / (x[half - 1] - x[0] + 1e-30)
    tau0 = torch.where(slope < 0, -1.0 / slope, (x[-1] - x[0]) / 2)

    def resid(th):
        a, log_tau, c = th
        return a * torch.exp(-x * torch.exp(-log_tau)) + c - y

    a, log_tau, c = _gauss_newton(
        resid, torch.stack([a0, torch.log(tau0.clamp(min=1e-30)), c0]))
    return torch.stack([a, torch.exp(log_tau), c])


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def fit_exp_decay(x, y, device=None):
    """Fit ``y = a * exp(-x / tau) + c``.  Returns ``(a, tau, c)``."""
    device = torch_device(device)
    a, tau, c = _fit_exp(_f32(x, device), _f32(y, device)).cpu().tolist()
    return float(a), float(tau), float(c)


def fit_t1(delays_s, p_excited, device=None):
    """T1 from an excited-population decay curve (models/experiments
    ``t1_program`` sweeps).  Returns ``(t1_s, fit_params)``."""
    a, tau, c = fit_exp_decay(delays_s, p_excited, device)
    return tau, (a, tau, c)


def _fit_rb(m, y):
    B0 = y[-1]
    A0 = y[0] - B0
    # p init from the ratio of successive decays
    ratio = ((y[1] - B0) / torch.where((y[0] - B0).abs() < 1e-9,
                                       torch.full_like(y[0], 1e-9),
                                       y[0] - B0)).clamp(1e-6, 1.0)
    p0 = ratio ** (1.0 / (m[1] - m[0]).clamp(min=1e-30))

    def resid(th):
        A, log_p, B = th
        return A * torch.exp(m * log_p) + B - y       # p**m, p = e^log_p

    A, log_p, B = _gauss_newton(
        resid, torch.stack([A0, torch.log(p0.clamp(min=1e-6)), B0]))
    return torch.stack([A, torch.exp(log_p), B])


def fit_rb(depths, survival, device=None):
    """Randomized-benchmarking decay fit: ``survival = A * p**m + B``.

    Returns ``(p, error_per_clifford, (A, p, B))`` with the standard
    single-qubit (d=2) average error per Clifford ``r = (1-p)/2``."""
    device = torch_device(device)
    A, p, B = _fit_rb(_f32(depths, device), _f32(survival, device)) \
        .cpu().tolist()
    p = float(np.clip(p, 0.0, 1.0))
    return p, (1.0 - p) / 2.0, (float(A), p, float(B))


def _fit_ramsey(t, y, theta0):
    def resid(th):
        a, log_tau, f, phi, c = th
        return (a * torch.exp(-t * torch.exp(-log_tau))
                * torch.cos(2 * np.pi * f * t + phi) + c - y)
    a, log_tau, f, phi, c = _gauss_newton(resid, theta0, n_iter=100)
    return torch.stack([a, torch.exp(log_tau), f, phi, c])


def fit_ramsey(delays_s, p_excited, device=None):
    """Damped-cosine fit for Ramsey fringes:
    ``p = a * exp(-t/tau) * cos(2*pi*f*t + phi) + c``.

    Returns ``(f_hz, t2_star_s, params)``; the frequency initializer
    takes the dominant nonzero FFT bin, so the sweep should cover at
    least one oscillation period."""
    device = torch_device(device)
    t = np.asarray(delays_s, np.float64)
    y = np.asarray(p_excited, np.float64)
    c0 = float(y.mean())
    # dominant frequency from the (uniformly-sampled) FFT
    dt = float(t[1] - t[0])
    spec = np.abs(np.fft.rfft(y - c0))
    freqs = np.fft.rfftfreq(len(y), dt)
    f0 = float(freqs[1 + int(np.argmax(spec[1:]))])
    a0 = float(2 * spec.max() / len(y))
    tau0 = float(t[-1] - t[0]) / 2

    theta0 = _f32([a0, np.log(tau0), f0, 0.0, c0], device)
    a, tau, f, phi, c = _fit_ramsey(_f32(t, device), _f32(y, device),
                                    theta0).cpu().tolist()
    return abs(float(f)), float(tau), (float(a), float(tau), float(f),
                                       float(phi), float(c))
