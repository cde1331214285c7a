"""Pulse-envelope function library.

The reference outsources envelope synthesis to its signal-generator element
(external LBL-QubiC/gateware repo); only the parametric *description* format
appears in its configs (python/test/qubitcfg.json: ``{'env_func': name,
'paradict': {...}}``).  This module defines the numerical envelope functions
for the TPU backend.  Envelopes are complex baseband arrays normalised to
|env| <= 1, sampled at the element's envelope sample rate.

All functions take ``(paradict, twidth, sample_rate)`` and return a complex
numpy array.  Register a new shape with :func:`register_env_func`.
"""

from __future__ import annotations

import numpy as np

_ENV_FUNCS: dict = {}


def register_env_func(name: str):
    def deco(fn):
        _ENV_FUNCS[name] = fn
        return fn
    return deco


def get_env_func(name: str):
    try:
        return _ENV_FUNCS[name]
    except KeyError:
        raise KeyError(f'unknown env_func {name!r}; registered: {sorted(_ENV_FUNCS)}')


def n_samples(twidth: float, sample_rate: float) -> int:
    return int(np.round(twidth * sample_rate))


def sample_env(env_desc: dict, sample_rate: float, twidth: float = None) -> np.ndarray:
    """Synthesise an envelope from a ``{'env_func', 'paradict'}`` description."""
    paradict = dict(env_desc['paradict'])
    if twidth is None:
        twidth = paradict['twidth']
    paradict.setdefault('twidth', twidth)
    return get_env_func(env_desc['env_func'])(paradict, twidth, sample_rate)


@register_env_func('square')
def square(paradict: dict, twidth: float, sample_rate: float) -> np.ndarray:
    """Constant envelope: amplitude * exp(i phase)."""
    amplitude = paradict.get('amplitude', 1.0)
    phase = paradict.get('phase', 0.0)
    n = n_samples(twidth, sample_rate)
    return np.full(n, amplitude * np.exp(1j * phase), dtype=np.complex128)


@register_env_func('cos_edge_square')
def cos_edge_square(paradict: dict, twidth: float, sample_rate: float) -> np.ndarray:
    """Flat-top pulse with raised-cosine rising/falling edges.

    ``ramp_fraction``: fraction of the total width taken by the two ramps
    combined (each edge is ramp_fraction/2 of the width); alternatively an
    absolute per-edge ``ramp_length`` in seconds overrides it.
    """
    n = n_samples(twidth, sample_rate)
    if 'ramp_length' in paradict:
        n_ramp = min(n_samples(paradict['ramp_length'], sample_rate), n // 2)
    else:
        n_ramp = int(np.round(paradict.get('ramp_fraction', 0.25) * n / 2))
    t = np.arange(n) / sample_rate
    env = np.ones(n, dtype=np.complex128)
    if n_ramp > 0:
        t_ramp = n_ramp / sample_rate
        env[:n_ramp] = 0.5 * (1 - np.cos(np.pi * t[:n_ramp] / t_ramp))
        env[n - n_ramp:] = 0.5 * (1 - np.cos(np.pi * (twidth - t[n - n_ramp:]) / t_ramp))
    return env * paradict.get('amplitude', 1.0)


@register_env_func('gaussian')
def gaussian(paradict: dict, twidth: float, sample_rate: float) -> np.ndarray:
    """Truncated gaussian, edges lifted to zero and peak renormalised to 1.

    ``sigmas``: total width expressed in standard deviations (sigma =
    twidth / sigmas).
    """
    n = n_samples(twidth, sample_rate)
    sigma = twidth / paradict.get('sigmas', 3)
    t = (np.arange(n) + 0.5) / sample_rate - twidth / 2
    env = np.exp(-t ** 2 / (2 * sigma ** 2))
    edge = np.exp(-(twidth / 2) ** 2 / (2 * sigma ** 2))
    env = (env - edge) / (1 - edge)
    return (env * paradict.get('amplitude', 1.0)).astype(np.complex128)


@register_env_func('DRAG')
def drag(paradict: dict, twidth: float, sample_rate: float) -> np.ndarray:
    """DRAG pulse: gaussian I with a derivative-quadrature correction.

    Q(t) = alpha * dI/dt / (2 pi delta); ``delta`` is the anharmonicity in
    Hz, ``alpha`` the DRAG coefficient, ``sigmas`` as for ``gaussian``.
    """
    n = n_samples(twidth, sample_rate)
    sigma = twidth / paradict.get('sigmas', 3)
    alpha = paradict.get('alpha', 0.0)
    delta = paradict['delta']
    t = (np.arange(n) + 0.5) / sample_rate - twidth / 2
    env_i = np.exp(-t ** 2 / (2 * sigma ** 2))
    edge = np.exp(-(twidth / 2) ** 2 / (2 * sigma ** 2))
    env_i = (env_i - edge) / (1 - edge)
    d_env = -(t / sigma ** 2) * np.exp(-t ** 2 / (2 * sigma ** 2)) / (1 - edge)
    env_q = alpha * d_env / (2 * np.pi * delta)
    env = env_i + 1j * env_q
    peak = np.max(np.abs(env))
    if peak > 1:
        env = env / peak
    return (env * paradict.get('amplitude', 1.0)).astype(np.complex128)
