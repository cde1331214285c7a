"""Readout demodulation and state discrimination.

Counterpart of the JAX package's ``ops/demod.py``.  Demodulation is the
matched-filter product ``acc[shot, 2m:2m+2] = adc[shot, :] @ W[:, 2m:2m+2]``
with the conj-reference weights of
:func:`..ops.waveform.pulse_window_weights`; discrimination projects the
I/Q point onto the |0>-|1> axis and thresholds.

* :func:`demod_iq` — the one entry.  A CUDA tensor launches the
  hand-written kernel ``csrc/demod.cu`` (one launch per call, the product
  computed in the kernel's own body); a CPU tensor or a numpy array takes
  :func:`demod_iq_reference`.  Any other device raises.
* :func:`demod_iq_reference` — the plain version, ``adc @ weights`` in
  float32.  The CPU tests and the kernel's on-card comparison use it.
* :func:`discriminate` — plain torch on any device (it is no kernel in
  the JAX package either).

I/Q results are real float32 with a trailing axis of 2.  The kernel sums
each row in another order than ``torch.matmul``: the two agree to float32
rounding of an N-term sum, not bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda


def _as_iq_centers(c, device) -> torch.Tensor:
    """Accept complex ``[M]`` or real ``[M, 2]`` calibration centroids."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    c = np.asarray(c)
    if np.iscomplexobj(c) or c.ndim == 1:
        c = np.stack([np.real(c), np.imag(c)], axis=-1)
    return torch.as_tensor(c.astype(np.float32), device=device)


def stack_window_weights(weight_list, n_samples: int,
                         starts=None) -> np.ndarray:
    """Stack per-measurement ``[n, 2]`` window weights into the dense
    ``[n_samples, 2M]`` demod matrix (zero outside each window)."""
    M = len(weight_list)
    W = np.zeros((n_samples, 2 * M), dtype=np.float32)
    for m, w in enumerate(weight_list):
        s = 0 if starts is None else int(starts[m])
        n = min(len(w), n_samples - s)
        W[s:s + n, 2 * m] = w[:n, 0]
        W[s:s + n, 2 * m + 1] = w[:n, 1]
    return W


def _operands(adc, weights):
    """``adc`` and ``weights`` as float32 tensors on ``adc``'s device
    (numpy data lies on the CPU)."""
    adc = torch.as_tensor(adc).to(torch.float32)
    weights = torch.as_tensor(weights).to(device=adc.device,
                                          dtype=torch.float32)
    if adc.ndim != 2 or weights.ndim != 2 \
            or adc.shape[1] != weights.shape[0] or weights.shape[1] % 2:
        raise ValueError(
            f'demod: adc must be [S, N] and weights [N, 2M]; got '
            f'{tuple(adc.shape)} and {tuple(weights.shape)}')
    return adc, weights


def demod_iq_reference(adc, weights) -> torch.Tensor:
    """The demod in plain torch: ``adc @ weights`` as ``[S, M, 2]``."""
    adc, weights = _operands(adc, weights)
    acc = adc @ weights                       # [S, 2M]
    return acc.reshape(acc.shape[0], -1, 2)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built, loaded and typed once."""
    fn = _cuda.load('demod').dp_demod_iq
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def demod_iq(adc, weights) -> torch.Tensor:
    """Demod ``[S, N]`` ADC traces against ``[N, 2M]`` window weights.

    Returns float32 ``[S, M, 2]`` I/Q accumulations on ``adc``'s device
    (columns ``2m``/``2m+1`` of ``weights`` are measurement m's I and Q
    references).  A CUDA ``adc`` launches ``csrc/demod.cu`` on the current
    stream and counts one in ``demod_iq.launches``; CPU data takes the
    plain version.  Any ``S``, ``N`` and ``M`` below 2^31 are served."""
    adc, weights = _operands(adc, weights)
    device = adc.device
    if device.type == 'cpu':
        return demod_iq_reference(adc, weights)
    if device.type != 'cuda':
        raise ValueError(f'demod kernel: unsupported device {device}')
    adc, weights = adc.contiguous(), weights.contiguous()
    (S, N), J = adc.shape, weights.shape[1]
    if max(S, N, J) >= 1 << 31:
        raise ValueError(f'demod kernel: S={S}, N={N} and 2M={J} must each '
                         f'be below 2^31')
    if S == 0 or J == 0:
        return torch.empty((S, J // 2, 2), dtype=torch.float32,
                           device=device)
    if N == 0:
        return torch.zeros((S, J // 2, 2), dtype=torch.float32,
                           device=device)
    out = torch.empty((S, J), dtype=torch.float32, device=device)
    rc = _kernel_fn()(adc.data_ptr(), weights.data_ptr(), out.data_ptr(),
                      S, N, J, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'demod kernel launch failed: cudaError {rc}')
    _cuda.count_launch(demod_iq)
    return out.reshape(S, -1, 2)


demod_iq.launches = 0


def discriminate(iq, centers0, centers1, threshold: float = 0.0):
    """Binary state discrimination by projection onto the |0>-|1> axis.

    ``iq``: ``[S, M, 2]`` I/Q points (tensor on any device, or numpy);
    ``centers0``/``centers1``: per-channel calibration centroids (complex
    ``[M]`` or real ``[M, 2]``).  Returns int32 bits ``[S, M]`` on
    ``iq``'s device."""
    iq = torch.as_tensor(iq).to(torch.float32)
    c0 = _as_iq_centers(centers0, iq.device)
    c1 = _as_iq_centers(centers1, iq.device)
    axis = c1 - c0                            # [M, 2]
    mid = (c0 + c1) / 2
    proj = ((iq - mid[None]) * axis[None]).sum(-1)
    return (proj > threshold).to(torch.int32)


def demod_and_discriminate(adc, weights, centers0, centers1,
                           use_pallas: bool = False,
                           interpret: bool = False):
    """ADC trace -> discriminated bits (the full readout chain); returns
    ``(bits [S, M], iq [S, M, 2])``.  ``use_pallas`` and ``interpret``
    select the JAX package's kernel path; here the device of ``adc``
    decides (see :func:`demod_iq`) and both are accepted as no-ops."""
    iq = demod_iq(adc, weights)
    return discriminate(iq, centers0, centers1), iq
