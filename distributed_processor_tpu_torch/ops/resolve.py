"""Readout-window resolution: the fused CUDA kernel and its plain torch
version.

Counterpart of the JAX package's ``ops/resolve_pallas.py``.  For every
(shot, core) window the per-sample readout chain is: envelope playback
(hold-last-sample overrun), phase-coherent carrier ``e^{iA} * basis[f]``,
window mask ``s < nsamp``, amplitude, state-dependent channel
``w(s) * g_s * y`` (ring-up ``w(s) = 1 - exp(-(s+1) / ring_tau)`` when
``ring``), additive ADC noise (white, or AR(1) with pole ``rho``: ``n_t =
rho n_{t-1} + sqrt(1 - rho^2) w_t`` from a stationary unit-variance
start), and the matched-filter sums ``acc_i``, ``acc_q`` and
``energy``.

* :func:`resolve_windows_fused` — the wrapper.  CUDA tensors launch the
  hand-written kernel ``csrc/resolve.cu`` (one launch per epoch, noise
  drawn in-kernel with Philox unless ``noise`` is given); CPU tensors take
  :func:`resolve_windows_reference`.  Any other device raises.
* :func:`resolve_windows_reference` — the same chain in plain torch,
  streamed over chunks of ``ck`` samples like the JAX ``physics._resolve``
  (AR(1) noise as its triangular product per chunk, one sample carried
  across chunks).  The CPU tests and the kernel's on-card comparison use
  it.
* :func:`build_prefix_tables` — what the kernel reads in rows mode.  With
  ``y(s) = a e^{iA} z(s)``, ``z(s) = env(base + s // interp) basis_f(s)``,
  the sums factor exactly:
  ``acc = g a^2 |e^{iA}|^2 sum_{s<n} w(s)|z(s)|^2 + a e^{-iA} sum_{s<n}
  noise(s) conj(z(s))`` and ``energy = a^2 |e^{iA}|^2 sum_{s<n} |z(s)|^2``.
  The deterministic sums depend only on (core, static row, frequency,
  n), so they are prefix tables, one read per window; only the noise
  projection is left per sample.

Numbers: at sigma = 0 the two agree to float32 rounding (the kernel
reads float64 prefix sums stored as float32, the reference sums chunk by
chunk); with the same streamed ``noise`` likewise; with the kernel's own
Philox noise they agree in distribution.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_chunk(chunk, W: int) -> int:
    """Reference chunk width for a requested ``resolve_chunk``: capped at
    W and rounded up to 128 samples (the JAX kernel's chunk rule)."""
    return _round_up(min(chunk or W, W), 128)


def build_fused_tables(env_pads, basis, W: int, interps,
                       rows: tuple = None) -> dict:
    """Per-core constants of the resolver, built once per run.

    ``env_pads``: the I/Q envelope planes ``[C, Lp]`` each, padded with
    copies of the final sample (``physics._pad_env_planes``).
    ``basis``: carrier ``(cos, sin)`` rows ``[C, F, >= W]``.  ``rows``:
    the static envelope start addresses (``physics._static_meas_env_addrs``)
    or None for the full clamped table.

    Returns ``{'env': [C, 2, Lp], 'bas': [C, 2, F, W]`` float32,
    ``'rows': [R]`` int32 (empty in full-table mode), ``'interps': [C]``
    int32``}``.  A window's envelope sample ``s`` is
    ``env[c, p, min(base + s // interp_c, Lp - 1)]`` where ``base`` is the
    row whose address equals the window's (row 0 when none does) or, in
    full-table mode, the address clipped to ``[0, Lp - 1]`` — the rows of
    the JAX kernel's DAC-resolution table, read directly."""
    env_i, env_q = env_pads
    dev = env_i.device
    bas_cos, bas_sin = basis
    return {
        'env': torch.stack([env_i, env_q], 1).to(torch.float32).contiguous(),
        'bas': torch.stack([bas_cos[..., :W], bas_sin[..., :W]], 1)
        .to(torch.float32).contiguous(),
        'rows': torch.as_tensor(list(rows) if rows is not None else [],
                                dtype=torch.int32, device=dev),
        'interps': torch.as_tensor(np.asarray(interps, np.int32),
                                   device=dev),
    }


def build_energy_tables(env_pads, addrs, W: int, interps, lane: int = 128):
    """Per-address envelope energy rows for the sigma = 0 readout of the
    span kernel K3 (``engine='fused'``): the clamped hold-last envelope
    of :func:`build_fused_tables` collapsed to ``|env|^2`` over the static
    envelope start addresses ``addrs``.

    Returns ``[C, R, Wp]`` float32 with
    ``E2[c, r, s] = |env[c, min(addrs[r] + s // interp_c, Lp - 1)]|^2``,
    ``Wp`` = W rounded up to ``lane`` (the JAX package's layout)."""
    env_i, env_q = env_pads                               # [C, Lp] each
    env2 = env_i * env_i + env_q * env_q
    C, Lp = env2.shape
    s = np.arange(_round_up(W, lane), dtype=np.int64)
    rows = []
    for c in range(C):
        it = max(int(interps[c]), 1)
        idx = np.minimum(np.asarray(addrs, np.int64)[:, None]
                         + s[None, :] // it, Lp - 1)      # [R, Wp]
        rows.append(env2[c][torch.as_tensor(idx, device=env2.device)])
    return torch.stack(rows, 0).to(torch.float32)


def build_energy_prefix(e2) -> torch.Tensor:
    """Prefix sums along the last axis, ``out[..., n] = sum_{s < n}
    e2[..., s]`` for ``n = 0..len``, accumulated in float64 and stored as
    float32 with a leading 0: for K3's energy rows
    (:func:`build_energy_tables`, ``[C, R, Wp]`` -> ``[C, R, Wp + 1]``)
    a window's energy is one read at its sample count."""
    acc = torch.cumsum(e2.to(torch.float64), -1)
    return torch.nn.functional.pad(acc, (1, 0)).to(torch.float32) \
        .contiguous()


def build_prefix_tables(tables: dict, inv_ring: float = None) -> dict:
    """The rows-mode kernel's tables, from ``tables`` of
    :func:`build_fused_tables` (static rows, not full-table mode) exactly
    as the chain reads them: for core ``c``, row ``r`` and frequency
    ``f``, ``z[c, r, f, s] = env_c[min(rows[r] + s // interp_c, Lp - 1)]
    * (bas_cos + i bas_sin)[c, f, s]`` and

    * ``'p1'``: ``P1[c, r, f, n] = sum_{s < n} |z|^2``, ``n = 0..W``;
    * ``'pw'``: ``Pw[c, r, f, n] = sum_{s < n} w(s) |z|^2`` with the
      ring-up of ``inv_ring`` (float32 value; None: ``w = 1``, ``Pw`` is
      ``P1``);
    * ``'z'``: ``z`` as ``[C, R, F, W, 2]`` (real, imaginary).

    Accumulated in float64, stored as float32 ``[C, R, F, W + 1]``."""
    rows = tables['rows']
    if rows.numel() == 0:
        raise ValueError('prefix tables need the static row list; '
                         'full-table mode reads the envelope per sample')
    env = tables['env'].to(torch.float64)                  # [C, 2, Lp]
    bas = tables['bas'].to(torch.float64)                  # [C, 2, F, W]
    C, _two, Lp = env.shape
    W, dev = bas.shape[3], env.device
    s = torch.arange(W, device=dev)
    it = tables['interps'].long()[:, None, None]
    idx = (rows.long()[None, :, None]
           + torch.div(s[None, None, :], it, rounding_mode='floor')
           ).clamp(max=Lp - 1)                              # [C, R, W]
    e_i = env[:, 0].gather(1, idx.flatten(1)).view(idx.shape)[:, :, None]
    e_q = env[:, 1].gather(1, idx.flatten(1)).view(idx.shape)[:, :, None]
    b_c, b_s = bas[:, 0, None], bas[:, 1, None]            # [C, 1, F, W]
    z_re = e_i * b_c - e_q * b_s                           # [C, R, F, W]
    z_im = e_i * b_s + e_q * b_c
    z2 = z_re * z_re + z_im * z_im
    out = {'p1': build_energy_prefix(z2),
           'z': torch.stack([z_re, z_im], -1).to(torch.float32)
           .contiguous()}
    if inv_ring is None:
        out['pw'] = out['p1']
    else:
        s1 = torch.arange(1, W + 1, dtype=torch.float64, device=dev)
        out['pw'] = build_energy_prefix(z2 * -torch.expm1(-s1 * inv_ring))
    return out


def _prefix_tables(tables: dict, inv_ring: float, ring: bool) -> dict:
    """:func:`build_prefix_tables` of ``tables``, built on first use and
    cached in ``tables['prefix']``, keyed by the float32 ``inv_ring``
    (None without a ring): once per run, never per epoch."""
    key = float(np.float32(inv_ring)) if ring else None
    cache = tables.setdefault('prefix', {})
    if key not in cache:
        cache[key] = build_prefix_tables(tables, key)
    return cache[key]


def _window_base(addr, rows, Lp: int):
    """Start row of each window: the static row equal to its address
    (row 0 when none is), or the address clipped into the table."""
    if rows.numel() == 0:
        return addr.clamp(0, Lp - 1)
    base = torch.full_like(addr, int(rows[0]))
    for r in rows[1:].tolist():
        base = torch.where(addr == r, r, base)
    return base


def ar1_tables(rho: float, ck: int, device=None):
    """AR(1) coloring of one chunk as a lower-triangular product (the
    JAX ``physics._ar1_tables``): ``n[i] = sum_j T[i, j] w[j] + rpow[i] *
    n_carry`` with ``T[i, j] = c rho^(i-j)`` for ``i >= j`` (``c = sqrt(1 -
    rho^2)``) and ``rpow[i] = rho^(i+1)``; float32 ``[ck, ck]`` and
    ``[ck]``."""
    r = torch.tensor(rho, dtype=torch.float32, device=device)
    i = torch.arange(ck, dtype=torch.float32, device=device)
    d = i[:, None] - i[None, :]
    c = torch.sqrt((1.0 - r * r).clamp(min=0.0))
    T = torch.where(d >= 0, c * r ** d, 0.0)
    return T, r ** (i + 1.0)


def _noise_generator(device, seed: int, epoch: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + int(epoch)) % (2**63 - 1))
    return gen


def resolve_windows_reference(sc: dict, tables: dict, gs_i, gs_q,
                              sigma: float, inv_ring: float, seed: int,
                              W: int, Lp: int, *, ring: bool = False,
                              noise=None, epoch: int = 0,
                              ck: int = 256, rho: float = 0.0,
                              noise0=None):
    """The resolver in plain torch, chunk by chunk (``ck`` samples).

    ``sc``: per-window scalars ``amp``, ``cosA``, ``sinA``, ``f_idx``,
    ``addr``, ``n_samp``, each ``[B, C, 1]`` (``physics._window_scalars``
    of the compacted pending slot).  ``gs_i``/``gs_q``: ``[B, C]`` channel
    response.  ``noise``: optional ``[2, C, B, W]`` additive noise (already
    scaled by sigma); without it, ``sigma * N(0, 1)`` is drawn per chunk
    from a generator seeded by ``(seed, epoch)``.  ``rho > 0``: AR(1)
    noise colored from those whites by :func:`ar1_tables`, starting from
    ``noise0 [2, C, B]`` (scaled by sigma) when ``noise`` is given, else
    from ``N(0, 1)`` drawn first from the generator.  Returns ``(acc_i,
    acc_q, energy)``, each ``[B, C]`` float32."""
    amp = sc['amp'][..., 0].to(torch.float32)
    cosa = sc['cosA'][..., 0].to(torch.float32)
    sina = sc['sinA'][..., 0].to(torch.float32)
    f_idx = sc['f_idx'][..., 0].long()
    nsamp = sc['n_samp'][..., 0].clamp(max=W)
    B, C = amp.shape
    dev = amp.device
    base = _window_base(sc['addr'][..., 0], tables['rows'], Lp)
    env, bas = tables['env'], tables['bas']
    interp = tables['interps'][None, :, None]
    env_i = env[:, 0].expand(B, C, Lp)
    env_q = env[:, 1].expand(B, C, Lp)
    c_idx = torch.arange(C, device=dev)[None, :]
    gen = None
    if noise is None and sigma != 0:
        gen = _noise_generator(dev, seed, epoch)
    colored = rho != 0 and (noise is not None or gen is not None)
    if colored:
        T, rpow = ar1_tables(rho, ck, dev)
        # the IIR carry [2, B, C]: the stationary start, then the last
        # sample of each chunk
        n_prev = noise0.transpose(1, 2) if noise is not None \
            else sigma * torch.randn((2, B, C), generator=gen, device=dev)
    acc_i = torch.zeros((B, C), dtype=torch.float32, device=dev)
    acc_q = torch.zeros_like(acc_i)
    energy = torch.zeros_like(acc_i)
    for s0 in range(0, W, ck):
        s1 = min(s0 + ck, W)
        s = torch.arange(s0, s1, dtype=torch.int32, device=dev)
        k = (base[..., None] + torch.div(s, interp, rounding_mode='floor')
             ).clamp(max=Lp - 1).long()                       # [B, C, w]
        e_i, e_q = env_i.gather(-1, k), env_q.gather(-1, k)
        bc = bas[:, 0, :, s0:s1][c_idx, f_idx]                # [B, C, w]
        bs = bas[:, 1, :, s0:s1][c_idx, f_idx]
        cth = cosa[..., None] * bc - sina[..., None] * bs
        sth = sina[..., None] * bc + cosa[..., None] * bs
        gain = (s < nsamp[..., None]).to(torch.float32) * amp[..., None]
        y_i = gain * (e_i * cth - e_q * sth)
        y_q = gain * (e_i * sth + e_q * cth)
        if ring:
            w = 1.0 - torch.exp(-(s + 1).to(torch.float32) * inv_ring)
        else:
            w = 1.0
        r_i = w * (gs_i[..., None] * y_i - gs_q[..., None] * y_q)
        r_q = w * (gs_i[..., None] * y_q + gs_q[..., None] * y_i)
        nz = None
        if noise is not None:
            nz = noise[:, :, :, s0:s1].transpose(1, 2)          # [2, B, C, w]
        elif gen is not None:
            nz = sigma * torch.randn((2, B, C, s1 - s0), generator=gen,
                                     device=dev)
        if nz is not None and colored:
            w_ = s1 - s0
            nz = torch.einsum('zbcs,ts->zbct', nz, T[:w_, :w_]) \
                + n_prev[..., None] * rpow[:w_]
            n_prev = nz[..., -1]
        if nz is not None:
            r_i, r_q = r_i + nz[0], r_q + nz[1]
        acc_i += (r_i * y_i + r_q * y_q).sum(-1)
        acc_q += (r_q * y_i - r_i * y_q).sum(-1)
        energy += (y_i * y_i + y_q * y_q).sum(-1)
    return acc_i, acc_q, energy


def _lane(x, dtype) -> torch.Tensor:
    """``[B, C, 1]`` or ``[B, C]`` -> contiguous ``[B, C]`` of ``dtype``."""
    if x.ndim == 3:
        x = x[..., 0]
    return x.to(dtype).contiguous()


_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_uint64]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built, loaded and typed once."""
    fn = _cuda.load('resolve').dp_resolve_windows
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'resolve kernel: {name} must be a contiguous {dtype} tensor of '
            f'shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on '
            f'{t.device} (contiguous={t.is_contiguous()})')


def resolve_windows_fused(sc: dict, tables: dict, gs_i, gs_q,
                          sigma: float, inv_ring: float, seed: int,
                          W: int, Lp: int, *, ring: bool = False,
                          noise=None, epoch: int = 0, ck: int = 256,
                          rho: float = 0.0, noise0=None):
    """Matched-filter accumulators for one compacted window per (B, C).

    Arguments as :func:`resolve_windows_reference`; ``seed`` (64 bits)
    and ``epoch`` key the kernel's in-kernel Philox noise, ``rho`` colors
    it AR(1) (a warp scan in rows mode, the recursion in full-table
    mode).  CUDA tensors launch ``csrc/resolve.cu`` on the current stream
    and count one in ``resolve_windows_fused.launches``; with a static
    row list (rows mode) the kernel reads :func:`build_prefix_tables`,
    built on the first call and cached in ``tables``, and without one
    (full-table mode) the per-sample chain.  CPU tensors take the plain
    version (``ck`` applies to it only).  Returns ``(acc_i, acc_q,
    energy)``, each ``[B, C]`` float32."""
    device = sc['amp'].device
    if device.type == 'cpu':
        return resolve_windows_reference(
            sc, tables, gs_i, gs_q, sigma, inv_ring, seed, W, Lp,
            ring=ring, noise=noise, epoch=epoch, ck=ck, rho=rho,
            noise0=noise0)
    if device.type != 'cuda':
        raise ValueError(f'resolve kernel: unsupported device {device}')
    B, C = sc['amp'].shape[:2]
    f32, i32 = torch.float32, torch.int32
    lanes = [_lane(sc['amp'], f32), _lane(sc['cosA'], f32),
             _lane(sc['sinA'], f32), _lane(gs_i, f32), _lane(gs_q, f32),
             _lane(sc['f_idx'], i32), _lane(sc['addr'], i32),
             _lane(sc['n_samp'], i32)]
    env, bas = tables['env'], tables['bas']
    rows, interps = tables['rows'], tables['interps']
    F = bas.shape[2]
    for i, t in enumerate(lanes):
        _check(f'lane input {i}', t, f32 if i < 5 else i32, (B, C), device)
    _check('env', env, f32, (C, 2, Lp), device)
    _check('bas', bas, f32, (C, 2, F, W), device)
    _check('rows', rows, i32, (rows.numel(),), device)
    _check('interps', interps, i32, (C,), device)
    if noise is not None:
        _check('noise', noise, f32, (2, C, B, W), device)
        if rho != 0:
            if noise0 is None:
                raise ValueError('resolve kernel: AR(1) with streamed noise '
                                 'needs noise0, the initial states')
            _check('noise0', noise0, f32, (2, C, B), device)
    if not 0.0 <= rho < 1.0:
        raise ValueError(f'resolve kernel: rho={rho} must be in [0, 1)')
    p1 = pw = z = None
    R = rows.numel()
    if R:
        pre = _prefix_tables(tables, inv_ring, ring)
        p1, pw, z = pre['p1'], pre['pw'], pre['z']
        _check('p1', p1, f32, (C, R, F, W + 1), device)
        _check('pw', pw, f32, (C, R, F, W + 1), device)
        _check('z', z, f32, (C, R, F, W, 2), device)
    outs = [torch.empty((B, C), dtype=f32, device=device) for _ in range(3)]
    if B == 0:
        return tuple(outs)
    fn = _kernel_fn()
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = fn(*[ptr(t) for t in lanes], ptr(env), ptr(bas), ptr(rows), R,
            ptr(interps), ptr(p1), ptr(pw), ptr(z), ptr(noise),
            ptr(noise0 if rho != 0 else None), float(rho),
            float(sigma), float(inv_ring), int(bool(ring)),
            int(seed) & 0xffffffffffffffff, int(epoch), B, C, W, Lp, F,
            *[ptr(t) for t in outs],
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'resolve kernel launch failed: cudaError {rc}')
    _cuda.count_launch(resolve_windows_fused)
    return tuple(outs)


resolve_windows_fused.launches = 0
