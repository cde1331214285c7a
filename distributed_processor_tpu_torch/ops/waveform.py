"""Signal-generator element: DAC waveform synthesis from pulse records.

Counterpart of the JAX package's ``ops/waveform.py`` and
``ops/waveform_pallas.py``: given the interpreter's pulse records and the
assembler's envelope table, the baseband output of one element.

I/Q values are a trailing axis of size 2 (``[..., 0]`` = I, ``[..., 1]``
= Q) in float32.  Numeric contract of :func:`synthesize_element`, per
output sample ``n`` of the trace ``[n_clks * spc, 2]``: the sum over the
element's valid pulses ``p`` with ``start_p <= n < end_p`` of
``amp_p * env_p(n) * exp(i * theta_p(n))``, where

* ``theta`` is the exact 32-bit NCO of the JAX package's waveform kernel:
  ``pa = inc * n + phase0`` in wrapping 32-bit arithmetic, ``inc =
  round(freq_rel * 2^32) mod 2^32``, ``phase0 = (phase_word << 15) mod
  2^32``, ``theta = int32(pa) * 2 * pi / 2^32`` — phase stays exact for
  arbitrarily long traces (the physics resolver keeps the split-precision
  :func:`carrier_phase`);
* ``amp = amp_word / (2^16 - 1)``;
* ``env_p(n)`` is sample ``clamp(env_addr * interp + (n - start_p), 0,
  L * interp - 1) // interp`` of the ``[L, 2]`` envelope table, ``env_addr
  = (env_word & 0xfff) * 4``: a window that runs past the table holds its
  last sample; an empty table reads zeros;
* a continuous-wave pulse (length field ``ENV_CW_SENTINEL``) holds the
  sample at ``env_addr`` from its start to the next pulse start on the
  element or the end of the trace;
* a fixed-length pulse ends at ``start + n_words * 4 * interp``, ``start =
  gtime * spc``.

:func:`synthesize_element` is the one entry: on a CUDA device it launches
the hand-written kernel ``csrc/waveform.cu`` (one launch per call), on
the CPU it takes :func:`synthesize_element_reference`, the same
arithmetic in plain torch.  The pulse descriptors (valid-pulse filter, CW
ends from the sorted starts, NCO words) are prepared on the host in numpy
for both.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..elements import ENV_CW_SENTINEL
from . import _cuda

PHASE_BITS = 17
AMP_SCALE = float(2 ** 16 - 1)
# float32(2 * pi / 2^32): NCO phase units to radians
_TWO_PI_OVER_2_32 = float(np.float32(2 * np.pi / 2 ** 32))
# rows of the pulse-descriptor table [7, P] (int32)
_DESC_FIELDS = ('start', 'end', 'env_addr', 'inc', 'phase0', 'amp', 'is_cw')


def iq_to_complex(x):
    """Host-side view: ``[..., 2]`` I/Q pairs -> complex array."""
    x = _to_numpy(x)
    return x[..., 0] + 1j * x[..., 1]


def complex_to_iq(z) -> np.ndarray:
    z = np.asarray(z)
    return np.stack([np.real(z), np.imag(z)], axis=-1).astype(np.float32)


def carrier_phase(freq_rel: torch.Tensor, n: torch.Tensor, phase0=0.0):
    """Phase-coherent carrier phase ``2*pi*freq_rel*n + phase0`` via a
    split-precision NCO: the frequency's 16-bit-exact head accumulates in
    wrapping integer arithmetic (exact mod 1, like the hardware NCO), and
    only the residual (< 2^-17 cycles/sample) multiplies ``n`` in
    float32.  ``n`` is an int32 tensor; broadcasting applies.  The head
    product is taken in int64 — its low 16 bits equal those of the
    wrapping int32 product the JAX package computes."""
    freq_rel = freq_rel.to(torch.float32)
    inc_hi = torch.round(freq_rel * 65536.0).to(torch.int32)
    resid = freq_rel - inc_hi.to(torch.float32) / 65536.0
    frac = ((inc_hi.long() * n.long()) & 0xffff).to(torch.float32) / 65536.0
    return 2 * math.pi * (frac + resid * n.to(torch.float32)) + phase0


def resolve_pulse_freqs(rec_freq, freq_table_hz, fsamp: float):
    """Map 9-bit frequency-buffer addresses to freq/fsamp ratios
    (float32; addresses past the table read 0)."""
    table = np.pad(np.asarray(freq_table_hz, np.float32) / np.float32(fsamp),
                   (0, 1))
    if isinstance(rec_freq, torch.Tensor):
        idx = rec_freq.long().clamp(0, len(table) - 1)
        return torch.as_tensor(table, device=rec_freq.device)[idx]
    return table[np.clip(np.asarray(rec_freq), 0, len(table) - 1)]


def pulse_window_weights(start_clk: int, n_clks: int, spc: int,
                         freq_hz: float, fsamp: float,
                         env=None) -> np.ndarray:
    """Demodulation weights for a readout window: conj reference carrier
    (optionally envelope-weighted) over ``[start, start + n)`` clocks.

    Host-side helper producing the ``[n_samples, 2]`` (I, Q) weight matrix
    consumed by :func:`..ops.demod.demod_iq`."""
    n = np.arange(start_clk * spc, (start_clk + n_clks) * spc)
    ref = np.exp(-2j * np.pi * freq_hz * n / fsamp)
    if env is not None:
        ref = ref * np.conj(np.asarray(env))
    return np.stack([np.real(ref), np.imag(ref)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# element synthesis: host preparation, the plain version, the kernel wrapper


def _to_numpy(x) -> np.ndarray:
    """A record field as numpy, whether it arrives as numpy or as a
    tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _env_table_iq(env_table) -> np.ndarray:
    """Envelope memory (complex ``[L]`` or I/Q ``[L, 2]``) as float32
    ``[L, 2]``; an empty table becomes one zero sample."""
    env = _to_numpy(env_table)
    if env.ndim == 1:
        env = np.stack([env.real, env.imag], -1)
    env = env.astype(np.float32).reshape(-1, 2)
    return env if len(env) else np.zeros((1, 2), np.float32)


def element_descriptors(rec: dict, spc: int, interp: int, n_clks: int,
                        elem: int = 0) -> np.ndarray:
    """The element's valid pulses as the int32 table ``[7, P]`` both the
    kernel and the plain version read (rows: ``_DESC_FIELDS``).  ``inc``
    and ``phase0`` hold uint32 bit patterns."""
    n_samples = n_clks * spc
    r = {k: _to_numpy(rec[k]) for k in
         ('gtime', 'env', 'phase', 'freq_rel', 'amp', 'elem', 'n_pulses')}
    P = min(int(r['n_pulses']), len(r['gtime']))
    idx = np.nonzero(r['elem'][:P] == elem)[0]
    starts = r['gtime'][idx].astype(np.int64) * spc
    env_words = r['env'][idx].astype(np.int64)
    env_nw = (env_words >> 12) & 0xfff
    is_cw = env_nw == ENV_CW_SENTINEL
    # a CW pulse ends at the next pulse start on the element
    order = np.argsort(starts, kind='stable')
    nxt = np.full(len(idx), n_samples, dtype=np.int64)
    nxt[order[:-1]] = starts[order][1:]
    ends = np.where(is_cw, np.minimum(nxt, n_samples),
                    starts + env_nw * 4 * interp)
    desc = np.zeros((len(_DESC_FIELDS), len(idx)), dtype=np.int64)
    desc[0], desc[1] = starts, ends
    desc[2] = (env_words & 0xfff) * 4
    desc[3] = np.round(r['freq_rel'][idx].astype(np.float64)
                       * 2 ** 32).astype(np.int64) % (1 << 32)
    desc[4] = (r['phase'][idx].astype(np.int64) << 15) % (1 << 32)
    desc[5] = r['amp'][idx]
    desc[6] = is_cw
    return desc.astype(np.uint32).view(np.int32)


def _synthesize_plain(desc: np.ndarray, env: torch.Tensor, interp: int,
                      n_samples: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, pulse by pulse over each
    pulse's own window.  ``desc``: host ``[7, P]`` int32; ``env``:
    ``[L, 2]`` float32 on the device the trace is made on."""
    out = torch.zeros((n_samples, 2), dtype=torch.float32, device=env.device)
    L = env.shape[0]
    for start, end, addr, inc, phase0, ampw, is_cw in desc.T.tolist():
        lo, hi = max(start, 0), min(end, n_samples)
        if hi <= lo:
            continue
        n = torch.arange(lo, hi, dtype=torch.int64, device=env.device)
        k = addr * interp + (0 if is_cw else n - start)
        k = torch.as_tensor(k, device=env.device).clamp(0, L * interp - 1)
        ev = env[torch.div(k, interp, rounding_mode='floor')].reshape(-1, 2)
        # the 32-bit accumulator: wrap the int64 product to int32
        pa = ((inc & 0xffffffff) * n + (phase0 & 0xffffffff)) & 0xffffffff
        pa = torch.where(pa >= 1 << 31, pa - (1 << 32), pa).to(torch.int32)
        theta = pa.to(torch.float32) * _TWO_PI_OVER_2_32
        c, s = torch.cos(theta), torch.sin(theta)
        amp = float(np.float32(ampw) / np.float32(AMP_SCALE))
        out[lo:hi, 0] += amp * (ev[:, 0] * c - ev[:, 1] * s)
        out[lo:hi, 1] += amp * (ev[:, 0] * s + ev[:, 1] * c)
    return out


def synthesize_element_reference(rec: dict, env_table, spc: int, interp: int,
                                 n_clks: int, elem: int = 0,
                                 device='cpu') -> torch.Tensor:
    """:func:`synthesize_element` in plain torch on ``device`` — what the
    CPU path runs and what the kernel is held against on the card."""
    env = torch.as_tensor(_env_table_iq(env_table), device=device)
    desc = element_descriptors(rec, spc, interp, n_clks, elem)
    return _synthesize_plain(desc, env, int(interp), int(n_clks * spc))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built, loaded and typed once."""
    fn = _cuda.load('waveform').dp_synthesize_element
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _record_device(rec: dict, device):
    """The device a trace is made on: ``device`` when given, else the
    device of the record tensors, else (numpy records) the package's
    default, CUDA."""
    from ..sim.interpreter import torch_device
    if device is None and isinstance(rec['gtime'], torch.Tensor):
        return rec['gtime'].device
    return torch_device(device)


def synthesize_prepared(desc: torch.Tensor, env: torch.Tensor, interp: int,
                        n_samples: int) -> torch.Tensor:
    """Launch the waveform kernel on prepared inputs on the card:
    ``desc`` the int32 descriptor table ``[7, P]``
    (:func:`element_descriptors`), ``env`` the float32 table ``[L, 2]``,
    ``L >= 1``.  One launch on the current stream, counted in
    ``synthesize_element.launches``.  Returns ``float32 [n_samples, 2]``."""
    device = env.device
    if device.type != 'cuda':
        raise ValueError(f'waveform kernel: unsupported device {device}')
    for name, t, dtype, shape in (
            ('desc', desc, torch.int32, (len(_DESC_FIELDS), desc.shape[-1])),
            ('env', env, torch.float32, (env.shape[0], 2))):
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f'waveform kernel: {name} must be a contiguous {dtype} '
                f'tensor of shape {shape} on {device}; got {t.dtype} '
                f'{tuple(t.shape)} on {t.device}')
    interp, n_samples = int(interp), int(n_samples)
    if interp < 1 or env.shape[0] < 1 or not 0 <= n_samples < 1 << 31:
        raise ValueError(
            f'waveform kernel: interp={interp} and the table length '
            f'{env.shape[0]} must be >= 1 and n_samples={n_samples} in '
            f'[0, 2^31)')
    out = torch.empty((n_samples, 2), dtype=torch.float32, device=device)
    if n_samples == 0:
        return out
    rc = _kernel_fn()(desc.data_ptr(), desc.shape[1], env.data_ptr(),
                      env.shape[0], interp, n_samples, out.data_ptr(),
                      torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'waveform kernel launch failed: cudaError {rc}')
    synthesize_element.launches += 1
    return out


def synthesize_element(rec: dict, env_table, spc: int, interp: int,
                       n_clks: int, elem: int = 0, device=None):
    """Render one element's baseband trace from pulse records.

    ``rec``: dict with 1-D ``gtime, env, phase, freq_rel, amp, elem`` (one
    entry per emitted pulse; ``freq_rel = freq / fsamp``) and scalar
    ``n_pulses``, as numpy arrays or tensors on any device.
    ``env_table``: the element's envelope memory, complex ``[L]`` or I/Q
    ``[L, 2]`` (fractional).  ``device``: where the trace is made (default:
    the record tensors' device; CUDA for numpy records, raising without
    it).  Any ``n_clks`` is served.

    A CUDA device launches ``csrc/waveform.cu``
    (:func:`synthesize_prepared`) and counts one in
    ``synthesize_element.launches``; the CPU takes the plain version.
    Returns ``float32 [n_clks * spc, 2]`` on that device."""
    device = _record_device(rec, device)
    if device.type == 'cpu':
        return synthesize_element_reference(rec, env_table, spc, interp,
                                            n_clks, elem, device)
    desc = element_descriptors(rec, spc, interp, n_clks, elem)
    return synthesize_prepared(
        torch.as_tensor(np.ascontiguousarray(desc), device=device),
        torch.as_tensor(_env_table_iq(env_table), device=device),
        interp, int(n_clks) * int(spc))


synthesize_element.launches = 0
