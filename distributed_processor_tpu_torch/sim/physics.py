"""Physics-closed measurement feedback: epoch execution.

Counterpart of the JAX package's ``sim/physics.py``.  The reference
closes its measurement loop in hardware (rdlo pulse -> demodulator ->
``meas``/``meas_valid`` -> fproc fabric; reference:
hdl/core_state_mgr.sv:45-56).  Here, as in the JAX package, each epoch

1. **executes** every (shot, core) lane on the resolved engine (generic,
   block, or one straight-line pass) until it is done or stalled on an
   fproc read whose bit is fired but not yet demodulated;
2. **resolves** the first fired-but-unresolved readout window of every
   lane through the per-sample chain (:mod:`..ops.resolve`: the CUDA
   kernel on the card, its plain torch version on the CPU) and
   discriminates it against the clean |0>/|1> responses (with IQ-level
   leakage readout, |2> too);
3. **resumes** with the resolved bits, until every shot is done.

``engine='fused'`` (sigma = 0 only) collapses the loop to one pass of
the span kernel K3 (:func:`..ops.exec_span.exec_span_fused`), which
resolves each window at its trigger.  On a CUDA device the straight-line
engine's pass is one launch of K3 with its readout left to the resolver
(:func:`..ops.exec_span.exec_span_physics`) wherever K3 takes the
program and configuration (:func:`exec_path`).  The epoch loop is a
Python ``while`` whose condition is read with one ``.item()`` per
epoch.
``resolve_mode='fused'`` and ``'persample'`` select the same per-sample
chain here (the JAX package holds its two formulations bit-identical at
sigma = 0), over the program's static envelope rows where it has them;
only ``'persample'`` takes AR(1) ADC noise (``noise_ar1``), colored in
the kernel.  ``'analytic'`` is the closed form of the white-noise
matched filter, ``acc = g_s E + sigma sqrt(E) xi``, every fired window at
once.  CW readout windows (``cw_horizon > 0``) integrate over the
horizon.  The qubit is the device co-state of :mod:`.device`: the
parity counter, the Bloch vector, or the entangling state vector (the
generic engine only, as in the JAX package).
"""

from __future__ import annotations

import math
import warnings
import zlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..elements import ENV_CW_SENTINEL, IQ_SCALE
from ..obs.trace import host_span
from ..ops.exec_span import exec_span_fused, exec_span_physics
from ..ops.resolve import build_energy_prefix, build_energy_tables, \
    build_fused_tables, fused_chunk, resolve_windows_fused
from ..ops.waveform import PHASE_BITS, AMP_SCALE, complex_to_iq, \
    carrier_phase
from .device import DeviceModel
from .interpreter import (InterpreterConfig, _program_constants,
                          _span_table, _init_state, _exec_blocks, _exec_loop,
                          _content_key, _count_trace, _device_key,
                          _exec_straightline, _finalize, _fault_policy,
                          _check_fabric, _check_strict, _soa_np,
                          check_supported, fused_ineligible, program_traits,
                          torch_device)

# default-qchip X90 amplitude word: round(0.48 * (2^16 - 1))
X90_AMP_DEFAULT = 31457


@dataclass(frozen=True)
class ReadoutPhysics:
    """Readout-chain + classical-device model parameters — the JAX
    package's ``ReadoutPhysics`` field for field.

    ``g0``/``g1``: complex channel response for |0> / |1> (scalar or per
    core).  ``sigma``: per-sample ADC noise standard deviation in units of
    the full-scale window.  ``p1_init``: thermal excited-state probability
    at t = 0.  ``x90_amp``: drive amp word of one quarter turn.
    ``window_samples``: readout-window length (None = sized from the
    envelope tables).  ``device``: the qubit co-state model
    (:class:`~.device.DeviceModel`, not a torch device).  ``ring_tau``:
    resonator ring-up time constant in DAC samples (0 = instantaneous).
    ``resolve_chunk``: samples per chunk of the plain resolver.
    ``resolve_mode``: 'persample' or 'fused' (the same chain here) or
    'analytic' (the white-noise closed form).  ``g2``: the |2> response
    of IQ-level leakage readout (statevec with leakage); ``classify3``:
    3-class nearest-centroid discrimination (output ``meas_class``).
    ``cw_horizon``: the integration horizon of CW readout windows in DAC
    samples (0: a CW window is ``ERR_CW_MEAS``).  ``noise_ar1``: the AR(1)
    pole of the ADC noise ('persample' only).  ``fused_native_rng`` is
    accepted and changes nothing here (the kernel always draws Philox).
    """
    g0: complex = 1.0 + 0.0j
    g1: complex = -0.6 + 0.8j
    g2: complex = None
    classify3: bool = False
    sigma: float = 0.05
    p1_init: float = 0.1
    x90_amp: int = X90_AMP_DEFAULT
    drive_elem: int = 0
    meas_elem: int = 2
    window_samples: int = None
    device: DeviceModel = DeviceModel(kind='parity')
    ring_tau: float = 0.0
    resolve_chunk: int = 512
    cw_horizon: int = 0
    noise_ar1: float = 0.0
    fused_native_rng: bool = None
    resolve_mode: str = 'persample'


def physics_from_dict(d: dict) -> ReadoutPhysics:
    """Rebuild a :class:`ReadoutPhysics` from its fields — e.g. those of
    the JAX package's model (``dataclasses.asdict``)."""
    d = dict(d)
    dev = dict(d.get('device') or {'kind': 'parity'})
    if 'couplings' in dev:
        dev['couplings'] = tuple(tuple(cp) for cp in dev['couplings'])
    for k in ('detuning_hz', 't1_s', 't2_s'):
        if isinstance(dev.get(k), list):
            dev[k] = tuple(dev[k])
    d['device'] = DeviceModel(**dev)
    for k in ('g0', 'g1', 'g2'):
        if isinstance(d.get(k), (list, tuple)) and len(d[k]) == 2 \
                and not isinstance(d[k][0], (list, tuple, complex)):
            d[k] = complex(d[k][0], d[k][1])
    return ReadoutPhysics(**d)


def _physics_tables(mp, meas_elem: int):
    """Per-core measurement-element tables as dense numpy constants:
    ``(env [C, L, 2], freq [C, F], spc [C], interp [C], W_auto)``."""
    C = mp.n_cores
    envs, frels, spcs, interps = [], [], [], []
    for c in range(C):
        t = mp.tables[c]
        if meas_elem < len(t.elem_cfgs):
            ec = t.elem_cfgs[meas_elem]
            spcs.append(int(ec.samples_per_clk))
            interps.append(int(ec.interp_ratio))
            env = np.asarray(t.envs[meas_elem]) if meas_elem < len(t.envs) \
                else np.zeros(0, complex)
            if meas_elem < len(t.freqs) and len(t.freqs[meas_elem]['freq']):
                fr = np.asarray(t.freqs[meas_elem]['freq'],
                                np.float64) / ec.sample_freq
            else:
                fr = np.zeros(0)
        else:
            spcs.append(4)
            interps.append(1)
            env, fr = np.zeros(0, complex), np.zeros(0)
        envs.append(complex_to_iq(env / IQ_SCALE) if len(env)
                    else np.zeros((0, 2), np.float32))
        frels.append(fr.astype(np.float32))
    L = max((len(e) for e in envs), default=0) or 1
    F = max((len(f) for f in frels), default=0) or 1
    env_stack = np.zeros((C, L, 2), np.float32)
    freq_stack = np.zeros((C, F), np.float32)
    for c in range(C):
        env_stack[c, :len(envs[c])] = envs[c]
        freq_stack[c, :len(frels[c])] = frels[c]
    w_auto = max((len(envs[c]) * interps[c] for c in range(C)), default=0) \
        or 1
    return (env_stack, freq_stack, np.asarray(spcs, np.int32),
            np.asarray(interps, np.int32), int(w_auto))


def _window_scalars(st: dict, tables, cw_samp: int = 0) -> dict:
    """Per-measurement synthesis scalars, ``[B, C, M]`` each.
    ``tables``: ``(freq [C, F], spc [C], interp [C])`` tensors."""
    freq_stack, spc_m, interp_m = tables
    B, C, M = st['meas_env'].shape
    amp = st['meas_amp'].to(torch.float32) / AMP_SCALE
    ph = 2 * math.pi * st['meas_phase'].to(torch.float32) \
        / (1 << PHASE_BITS)
    F = freq_stack.shape[1]
    f_idx = st['meas_freq'].clamp(0, F - 1)
    c_idx = torch.arange(C, device=f_idx.device)[None, :, None]
    f_rel = freq_stack[c_idx, f_idx.long()]
    envw = st['meas_env']
    addr = (envw & 0xfff) * 4
    nw = (envw >> 12) & 0xfff
    interp_c = interp_m[None, :, None]
    spc_c = spc_m[None, :, None]
    n_samp = torch.where(nw == ENV_CW_SENTINEL, cw_samp, nw * 4 * interp_c)
    n0_car = st['meas_gtime'] * spc_c
    # factored carrier: theta(s) = A + 2*pi*f*s with the per-window
    # scalar A = 2*pi*f*n0 + ph (split-precision NCO keeps A exact)
    A = carrier_phase(f_rel, n0_car, ph)
    return dict(amp=amp, ph=ph, f_rel=f_rel, addr=addr, n_samp=n_samp,
                interp_c=interp_c, n0_car=n0_car, cosA=torch.cos(A),
                sinA=torch.sin(A), f_idx=f_idx)


def _aligned_chunk(chunk: int, W: int, interps) -> int:
    """Chunk width capped at W, rounded up to a multiple of every interp
    ratio (sizes the env-plane padding, as in the JAX package)."""
    chunk = min(chunk or W, W)
    align = int(np.lcm.reduce(np.asarray(interps))) if len(interps) else 1
    return -(-chunk // align) * align


def _pad_env_planes(env_stack: torch.Tensor, pad: int):
    """Split ``[C, L, 2]`` env tables into I/Q planes padded with ``pad``
    copies of the final sample (hold-last-sample overrun)."""
    C = env_stack.shape[0]
    last = env_stack[:, -1:, :].expand(C, pad, 2)
    env_pad = torch.cat([env_stack, last], dim=1)
    return env_pad[..., 0].contiguous(), env_pad[..., 1].contiguous()


def _carrier_basis(freq_stack: torch.Tensor, W: int):
    """Carrier basis ``cos/sin(2*pi*f*s)`` per table frequency:
    ``[C, F, W]`` each."""
    s = torch.arange(W, dtype=torch.int32, device=freq_stack.device)
    theta = carrier_phase(freq_stack[..., None], s)
    return torch.cos(theta), torch.sin(theta)


def _compact_pending_slot(st: dict, valid, tables, cw_samp: int = 0):
    """First fired-but-unresolved measurement slot per (shot, core).

    Returns ``(sc, state_sel, slot, has_pending)``: the window scalars of
    that slot (each ``[B, C, 1]``), its device-state bit ``[B, C, 1]``,
    the slot index ``[B, C]`` and the lanes that have a pending slot."""
    B, C, M = valid.shape
    fired = torch.arange(M, device=valid.device)[None, None, :] \
        < st['n_meas'][..., None]
    pending = fired & ~valid
    has_pending = pending.any(-1)
    slot = pending.to(torch.int32).argmax(-1)
    idx = slot[..., None]
    take = lambda a: a.gather(-1, idx)
    st_sel = {k: take(st[k]) for k in
              ('meas_amp', 'meas_phase', 'meas_freq', 'meas_env',
               'meas_gtime')}
    sc = _window_scalars(st_sel, tables, cw_samp)
    return sc, take(st['meas_state']), slot, has_pending


def _scatter_slot_bit(bits, valid, new_bit, slot, has_pending):
    """Write the resolved bit ``[B, C]`` into its slot and mark it valid,
    only on lanes that had a pending slot."""
    M = bits.shape[-1]
    resolved = (slot[..., None] == torch.arange(M, device=slot.device)) \
        & has_pending[..., None]
    bits = torch.where(resolved, new_bit[..., None], bits)
    return bits, valid | resolved


def _bcast(g, k: int, like) -> torch.Tensor:
    """Component ``k`` of a ``[C, 2]`` response, shaped to broadcast
    against ``like`` (``[B, C]`` or ``[B, C, M]``)."""
    return g[:, k].view((1, -1) + (1,) * (like.ndim - 2))


def _discriminate_acc(acc_i, acc_q, energy, g0, g1):
    """Project the matched-filter sums onto the |0>-|1> axis (clean
    responses ``g_s * E``) and threshold."""
    a0_i, a0_q = _bcast(g0, 0, energy) * energy, _bcast(g0, 1, energy) * energy
    a1_i, a1_q = _bcast(g1, 0, energy) * energy, _bcast(g1, 1, energy) * energy
    proj = (acc_i - (a0_i + a1_i) / 2) * (a1_i - a0_i) \
        + (acc_q - (a0_q + a1_q) / 2) * (a1_q - a0_q)
    return (proj > 0).to(torch.int32)


def _classify3_acc(acc_i, acc_q, energy, g0, g1, g2):
    """Nearest-centroid 3-class discrimination in the IQ plane against
    ``g_s * E`` (maximum likelihood under the isotropic matched-filter
    noise): classes in {0, 1, 2}."""
    def dist2(g):
        return (acc_i - _bcast(g, 0, energy) * energy) ** 2 \
            + (acc_q - _bcast(g, 1, energy) * energy) ** 2
    d0, d1, d2 = dist2(g0), dist2(g1), dist2(g2)
    cls = torch.where(d1 < d0, 1, 0)
    return torch.where(d2 < torch.minimum(d0, d1), 2, cls).to(torch.int32)


def _acc_to_bit(acc_i, acc_q, energy, g0, g1, iq3):
    """The shared tail of every resolve mode: ``(bit, cls)`` — the 2-class
    threshold, or with ``classify3`` the 3-class classes and the fabric
    bit that maps class 2 to ``leak_readout_bit``.  ``iq3``: ``(g2,
    classify3, leak_bit)`` or None; ``cls`` is None when 2-class."""
    g2, classify3, leak_bit = iq3 if iq3 is not None else (None, False, 1)
    if not classify3:
        return _discriminate_acc(acc_i, acc_q, energy, g0, g1), None
    cls = _classify3_acc(acc_i, acc_q, energy, g0, g1, g2)
    return torch.where(cls == 2, leak_bit, cls).to(torch.int32), cls


def _channel(state, g0, g1, g2):
    """The state-dependent response per lane: ``g1`` where ``state`` is
    1, ``g2`` where it is 2 (a leaked core under IQ-level leakage
    readout), else ``g0``; the responses broadcast against ``state``."""
    gs = torch.where(state == 1, g1, g0)
    return gs if g2 is None else torch.where(state == 2, g2, gs)


def _analytic_energy(sc: dict, env, W: int):
    """The window energy ``E = sum |y|^2`` of the analytic mode, shaped
    like ``sc['addr']``: ``amp^2 * (interp * (pref[b] - pref[a] + held) +
    partial)`` from a prefix sum of |env|^2 over the padded plane ``env
    [C, 2, Lp]`` (the carrier drops out): whole envelope samples in the
    table, samples past it holding the last value, and the trailing
    partial sample.  ``sc``: :func:`_window_scalars` (``addr``,
    ``n_samp``, ``amp``, ``interp_c`` ``[1, C, 1]``)."""
    env_i, env_q = env[:, 0], env[:, 1]                       # [C, Lp]
    C, Lp = env_i.shape
    dv = env_i.device
    env2 = env_i * env_i + env_q * env_q
    pref = torch.cat([torch.zeros((C, 1), dtype=torch.float32, device=dv),
                      torch.cumsum(env2, -1)], -1)
    interp_c = sc['interp_c']
    count = sc['n_samp'].clamp(max=W)
    n_full = torch.div(count, interp_c, rounding_mode='floor')
    n_part = count - n_full * interp_c
    addr = sc['addr']
    a = addr.clamp(0, Lp).long()
    b = (addr + n_full).clamp(0, Lp).long()
    c_idx = torch.arange(C, device=dv)[None, :, None]
    in_table = pref[c_idx, b] - pref[c_idx, a]
    held = (n_full - (b - a)).to(torch.float32) * env2[:, -1][c_idx]
    part_val = env2[c_idx, (addr + n_full).clamp(0, Lp - 1).long()]
    amp = sc['amp']
    return amp * amp * (interp_c.to(torch.float32) * (in_table + held)
                        + n_part.to(torch.float32) * part_val)


def _resolve_analytic(st: dict, bits, valid, xi, window_tables, env, g,
                      sigma: float, W: int, cw: int, iq3, cls):
    """The closed form of the white-noise matched filter (the JAX
    ``_resolve_analytic``), every fired-but-unresolved slot at once.

    The filter is linear, so demodulating ``g_s y + noise`` against
    ``y`` gives ``acc = g_s E + sigma sqrt(E) xi``, ``E = sum |y|^2``
    (:func:`_analytic_energy`), ``xi ~ N(0, I2)``.  ``xi [2, B, C, M]``
    is drawn once per run (:func:`_analytic_xi`; None at sigma = 0), so
    each slot's noise is fixed by its position.  With ``ring_tau > 0``
    this is the flat-response approximation."""
    g0, g1, g2 = g
    B, C, M = bits.shape
    dv = bits.device
    fired = torch.arange(M, device=dv)[None, None, :] < st['n_meas'][..., None]
    pending = fired & ~valid
    energy = _analytic_energy(_window_scalars(st, window_tables, cw), env, W)
    state = st['meas_state'][..., None]
    gs = _channel(state, g0[None, :, None], g1[None, :, None],
                  None if g2 is None else g2[None, :, None])
    acc_i, acc_q = gs[..., 0] * energy, gs[..., 1] * energy
    if xi is not None:
        root_e = torch.sqrt(energy)
        acc_i = acc_i + sigma * root_e * xi[0]
        acc_q = acc_q + sigma * root_e * xi[1]
    new_bit, new_cls = _acc_to_bit(acc_i, acc_q, energy, g0, g1, iq3)
    if new_cls is not None:
        cls = torch.where(pending, new_cls, cls)
    return torch.where(pending, new_bit, bits), valid | fired, cls


def _static_meas_env_addrs(mp, max_rows: int = 8):
    """The envelope-table addresses the resolver can ever see, derived
    statically from the program (the pulse env latch only holds 0 or an
    immediate the program writes), or None when a register sources an
    env word or more than ``max_rows`` addresses occur."""
    soa = mp.soa
    wen_env = (np.asarray(soa.p_wen) & 1) == 1
    if np.any(((np.asarray(soa.p_regsel) & 1) == 1) & wen_env):
        return None
    words = np.asarray(soa.p_env)[wen_env]
    addrs = sorted({0} | {int((w & 0xfff) * 4) for w in words.ravel()})
    return tuple(addrs) if len(addrs) <= max_rows else None


def _tables_meta(model: ReadoutPhysics, W: int, mp) -> tuple:
    """Build parameters prebuilt tables must match: window, chunk,
    measurement element and a digest of the measurement-element envelope
    and frequency content."""
    h = 0
    for c in range(mp.n_cores):
        t = mp.tables[c]
        if model.meas_elem < len(t.envs):
            h = zlib.crc32(np.ascontiguousarray(
                np.asarray(t.envs[model.meas_elem])).tobytes(), h)
        if model.meas_elem < len(t.freqs):
            h = zlib.crc32(np.ascontiguousarray(np.asarray(
                t.freqs[model.meas_elem]['freq'], np.float64)).tobytes(), h)
    return (W, fused_chunk(model.resolve_chunk, W), int(model.meas_elem),
            model.resolve_mode, int(h) & 0x7fffffff)


def _fused_blockers(model: ReadoutPhysics, rows) -> None:
    """Raise the JAX package's ``ValueError`` when the readout model is
    not the one the measure-in-megastep engine specializes: the sigma = 0
    matched filter over statically enumerable envelopes."""
    blockers = []
    if float(model.sigma) != 0.0:
        blockers.append(
            f'sigma={model.sigma} (the in-kernel demodulator is the '
            f'sigma=0 matched filter; noise draws stay with the epoch '
            f'resolver)')
    if model.ring_tau > 0:
        blockers.append('ring_tau > 0 (the resonator ring-up transient '
                        'needs the per-sample resolver)')
    if model.noise_ar1 > 0:
        blockers.append("noise_ar1 > 0 (colored ADC noise needs "
                        "resolve_mode='persample')")
    if rows is None:
        blockers.append('envelope addresses not statically enumerable (a '
                        'register-sourced envelope write, or more than 8 '
                        'distinct addresses)')
    if blockers:
        raise ValueError(
            "engine='fused' (measure-in-megastep) is ineligible for this "
            'readout model: ' + '; '.join(blockers)
            + " — use resolve_mode='fused' (the in-kernel epoch resolver) "
            'for the general model')


def _check_model(model: ReadoutPhysics, W: int) -> None:
    """The JAX ``run_physics_batch``'s readout-model checks, in its order,
    with its exception types and messages; the analytic mode with a
    ring-up warns."""
    if model.resolve_mode not in ('persample', 'fused', 'analytic'):
        raise ValueError(f'unknown resolve_mode {model.resolve_mode!r}')
    if model.cw_horizon < 0 or model.cw_horizon > W:
        raise ValueError(
            f'cw_horizon={model.cw_horizon} must lie in [0, W={W}] — '
            f'the resolve tables cover W samples; raise '
            f'window_samples to integrate longer CW windows')
    if not 0.0 <= model.noise_ar1 < 1.0:
        raise ValueError(f'noise_ar1={model.noise_ar1} must be in [0, 1)')
    if model.g2 is not None and (
            model.device.kind != 'statevec'
            or not (np.any(np.asarray(model.device.leak_per_pulse,
                                      np.float64))
                    or np.any(np.asarray(model.device.leak2_per_pulse,
                                         np.float64)))):
        raise ValueError(
            'g2 (the |2> IQ response) needs device=statevec with '
            'leak_per_pulse > 0 or leak2_per_pulse > 0 — no leakage '
            'channel, no |2> population')
    if model.classify3 and model.g2 is None:
        raise ValueError(
            'classify3 (3-class discrimination) needs g2 (the |2> '
            'response) set')
    if model.noise_ar1 > 0 and model.resolve_mode != 'persample':
        raise ValueError(
            f"resolve_mode={model.resolve_mode!r} generates white ADC "
            f"noise (analytic: closed form; fused: in-kernel "
            f"generator); colored noise (noise_ar1 > 0) needs "
            f"resolve_mode='persample'")
    if model.ring_tau > 0 and model.resolve_mode == 'analytic':
        warnings.warn(
            "resolve_mode='analytic' ignores the resonator ring-up "
            '(ring_tau > 0): bits follow the flat-response model, which '
            'is optimistic at short windows — use persample/fused for '
            'the structured channel', stacklevel=3)


def _has_cross_core_freqs(mp, drive_elem: int = 0) -> bool:
    """Does any core's drive-element frequency table hold a value that
    appears in another core's — the cross-resonance signature, used to
    warn when a statevec run has no coupling map.  CZ-style ef drives
    live in the control core's own table and are not caught."""
    per_core = []
    for t in mp.tables:
        if drive_elem < len(t.freqs):
            per_core.append(np.asarray(t.freqs[drive_elem]['freq'],
                                       np.float64))
        else:
            per_core.append(np.zeros(0))
    for c, fc in enumerate(per_core):
        for o, fo in enumerate(per_core):
            if o == c or not len(fc) or not len(fo):
                continue
            if np.any(np.isclose(fc[:, None], fo[None, :], rtol=1e-12,
                                 atol=1.0)):
                return True
    return False


def _as_iq(g, C: int, device) -> torch.Tensor:
    """A complex response (scalar or per core) as ``[C, 2]`` float32."""
    g = np.broadcast_to(np.asarray(g, complex), (C,))
    with host_span('h2d.wait'):
        return torch.as_tensor(np.stack([g.real, g.imag], axis=-1)
                               .astype(np.float32), device=device)


def fused_readout(mp, model: ReadoutPhysics, tables: dict) -> dict:
    """The sigma = 0 readout directive of the span kernel K3: the energy
    rows of the program's static envelope addresses over the envelope
    planes of ``tables`` (:func:`prepare_physics_tables`) and their
    prefix sums (the kernel reads one prefix per window, the plain
    version sums the row), the clean responses and the window."""
    _env, _freq, _spc, interp_m, w_auto = _physics_tables(mp,
                                                          model.meas_elem)
    W = int(model.window_samples or w_auto)
    rows = _static_meas_env_addrs(mp)
    env = tables['env']
    e2 = build_energy_tables((env[:, 0], env[:, 1]), rows, W,
                             tuple(int(x) for x in interp_m))
    return {'e2': e2, 'e2p': build_energy_prefix(e2),
            'g0': _as_iq(model.g0, mp.n_cores, env.device),
            'g1': _as_iq(model.g1, mp.n_cores, env.device),
            'addrs': rows, 'w': W, 'amp_scale': float(AMP_SCALE)}


def physics_config(base: InterpreterConfig, model: ReadoutPhysics,
                   **kw) -> InterpreterConfig:
    """The effective interpreter config of a physics run: the model is
    authoritative for ``x90_amp``/``drive_elem``/``meas_elem``/
    ``cw_horizon`` and the device kind; conflicting values raise."""
    base = base if base is not None else InterpreterConfig()
    defaults = InterpreterConfig()
    overrides = {}
    for name in ('x90_amp', 'drive_elem', 'meas_elem', 'cw_horizon'):
        if name in kw:
            raise ValueError(
                f'{name} is set on the ReadoutPhysics model for physics '
                f'runs, not in the interpreter config')
        mv, bv = int(getattr(model, name)), int(getattr(base, name))
        if bv != int(getattr(defaults, name)) and bv != mv:
            raise ValueError(
                f'conflicting {name}: interpreter config has {bv}, '
                f'ReadoutPhysics has {mv}; set it on the model')
        overrides[name] = mv
    if 'device' in kw:
        raise ValueError('the device model is set via '
                         'ReadoutPhysics.device, not the interpreter config')
    if base.device != defaults.device and base.device != model.device.kind:
        raise ValueError(
            f'conflicting device: interpreter config has {base.device!r}, '
            f'ReadoutPhysics.device has {model.device.kind!r}')
    return replace(base, physics=True, device=model.device.kind,
                   **overrides, **kw)


def prepare_physics_tables(mp, model: ReadoutPhysics, device=None) -> dict:
    """Build the resolve tables for ``(mp, model)`` once, on ``device``
    (default CUDA), for reuse across batches (pass as ``tables=`` to
    :func:`run_physics_batch`)."""
    device = torch_device(device)
    env_stack, freq_stack, _spc, interp_m, w_auto = \
        _physics_tables(mp, model.meas_elem)
    W = int(model.window_samples or w_auto)
    interps = tuple(int(x) for x in interp_m)
    env_pads = _pad_env_planes(
        torch.as_tensor(env_stack, device=device),
        _aligned_chunk(model.resolve_chunk, W, interps))
    # the static row select is the 'fused' mode's envelope fetch in the
    # JAX package, and 'persample' here reads it too: a window's address
    # is always one of the rows, so both give the envelope samples of the
    # full clamped table, which remains for programs without a static row
    # list ('analytic' reads only the padded planes)
    rows = _static_meas_env_addrs(mp) \
        if model.resolve_mode in ('fused', 'persample') else None
    tabs = build_fused_tables(
        env_pads, _carrier_basis(torch.as_tensor(freq_stack, device=device),
                                 W), W, interps, rows)
    tabs['meta'] = _tables_meta(model, W, mp)
    return tabs


def _validate_tables(mp, model: ReadoutPhysics, tables: dict, W: int) -> None:
    """Check prebuilt tables were built for THIS program and model: the
    build parameters (``'meta'``) and, where the resolver reads them, the
    static envelope rows (``'rows'``).  A stale row list makes a window
    whose address is missing from it read row 0, the wrong envelope.
    The JAX package checks the rows in ``'fused'`` mode; here
    ``'persample'`` reads them too, so both modes check them."""
    if tables.get('meta') != _tables_meta(model, W, mp):
        raise ValueError(
            f"prebuilt tables were built for {tables.get('meta')}, but "
            f'this program/model needs {_tables_meta(model, W, mp)} — '
            f'rebuild with prepare_physics_tables(mp, model)')
    if model.resolve_mode in ('fused', 'persample'):
        rows = _static_meas_env_addrs(mp)
        want = [] if rows is None else list(rows)
        with host_span('physics.wait'):
            have = tables['rows'].tolist() if 'rows' in tables else None
        if have != want:
            raise ValueError(
                f'prebuilt tables were built for envelope addresses '
                f'{have}, but this program/model needs {want} — '
                f'rebuild with prepare_physics_tables(mp, model)')


def validate_physics_tables(mp, model: ReadoutPhysics, tables: dict) -> None:
    """Validate prebuilt tables against ``(mp, model)``: the check
    :func:`run_physics_batch` makes on every ``tables=`` it is given,
    for a caller that caches :func:`prepare_physics_tables` output."""
    W = int(model.window_samples or _physics_tables(mp, model.meas_elem)[4])
    _validate_tables(mp, model, tables, W)


_MASK64 = (1 << 64) - 1


def derive_seed(seed: int, *words: int) -> int:
    """A 64-bit seed derived from ``seed`` and ``words`` (splitmix64
    folds): independent streams for initial states, ADC noise and sweep
    batches from one user seed."""
    x = int(seed) & _MASK64
    for w in (0,) + words:
        x = ((x ^ (int(w) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x


# seed words of the independent streams of a run (derive_seed): initial
# states 1, ADC noise 2, the analytic mode's draws 3; the projective-
# measurement uniforms and the statevec trajectory take the JAX package's
# fold_in words
ANALYTIC_WORD = 3
MEAS_U_WORD = 0x424c4f43
TRAJ_WORD = 0x53563251


def _meas_uniforms(seed: int, shots: int, C: int, M: int, device):
    """The projective-measurement uniforms of a bloch or statevec run, one
    per (shot, core, slot), ``[shots, C, M]`` float32 drawn on ``device``
    from their own stream, independent of the initial states and the ADC
    noise (the trajectory's uniforms are drawn the same way).  The CPU's
    and the card's generators give different draws for one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, MEAS_U_WORD) >> 1)
    return torch.rand((shots, C, M), generator=gen, device=device)


def _analytic_xi(seed: int, B: int, C: int, M: int, device):
    """The analytic mode's unit normals ``[2, B, C, M]`` (I, Q), one per
    (shot, core, slot), fixed for the run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, ANALYTIC_WORD) >> 1)
    return torch.randn((2, B, C, M), generator=gen, device=device)


def _device_params(mp, model: ReadoutPhysics, seed: int, shots: int, M: int,
                   device):
    """The device-model parameters the engines read (None for parity):
    per-core per-clock detuning and decay rates, the depolarizing keep
    factor, the measurement uniforms and, for statevec, the 2q, leakage
    and seepage rates, the trajectory seed, the static channel
    facts (:meth:`~.device.DeviceModel.statevec_static` plus whether
    leaked cores read out at the IQ level) and the event gate's two
    int32 ``[shots, n_cores]`` device counters (``gate_stall``,
    ``core_steps``).  Scalars are
    float32 values, as the JAX package traces them."""
    d = model.device
    if d.kind == 'parity':
        return None
    C = mp.n_cores
    f32 = np.float32
    det, it1, it2 = d.per_clock_rates(C)
    dm = dict(det=torch.as_tensor(det, device=device),
              inv_t1=torch.as_tensor(it1, device=device),
              inv_t2=torch.as_tensor(it2, device=device),
              depol=float(f32(d.depol_per_pulse)),
              keep=float(f32(1.0) - f32(d.depol_per_pulse)),
              meas_u=_meas_uniforms(seed, shots, C, M, device))
    if d.kind == 'statevec':
        if not d.couplings and _has_cross_core_freqs(mp):
            warnings.warn(
                "device='statevec' with couplings=() but the program "
                'drives cross-core frequencies (the cross-resonance '
                'signature): entangling pulses will execute as 1q '
                'rotations.  Derive the map with '
                'models.coupling.couplings_from_qchip(mp, qchip) or '
                'run via Simulator.run (auto-derives).  (CZ-style '
                'ef drives cannot be detected without the gate '
                'library — derive the map explicitly for those.)',
                stacklevel=3)
        dm.update(depol2=float(f32(d.depol2_per_pulse)),
                  zx90=float(f32(d.zx90_amp)), zz90=float(f32(d.zz90_amp)),
                  leak=float(f32(d.leak_per_pulse)),
                  leak2=float(f32(d.leak2_per_pulse)),
                  seep=float(f32(d.seep_per_pulse)),
                  traj_seed=derive_seed(seed, TRAJ_WORD),
                  static=d.statevec_static() + (model.g2 is not None,),
                  # the event gate's counters, summed on the device
                  gate_stall=torch.zeros((shots, C), dtype=torch.int32,
                                         device=device),
                  core_steps=torch.zeros((shots, C), dtype=torch.int32,
                                         device=device))
    return dm


def statevec_step_budget(cfg: InterpreterConfig, model: ReadoutPhysics,
                         n_cores: int) -> InterpreterConfig:
    """``cfg`` with its step budget scaled by the core count for a
    statevec run with couplings: the discrete-event gate can serialize
    cross-core pulse triggers, one core per step at worst."""
    if model.device.kind == 'statevec' and model.device.couplings:
        return replace(cfg, max_steps=cfg.max_steps * n_cores)
    return cfg


def _init_device(st: dict, kind: str, init_states) -> None:
    """Set the device co-state from the initial qubit bits: the parity
    counter at two quarter turns per excited qubit, the Bloch vector at
    the pole, or the basis state (core 0 the most significant bit)."""
    B, C = init_states.shape
    if kind == 'parity':
        st['qturns'] = 2 * init_states
    elif kind == 'bloch':
        zf = torch.zeros((B, C), dtype=torch.float32,
                         device=init_states.device)
        st['bloch'] = torch.stack(
            [zf, zf, 1.0 - 2.0 * init_states.to(torch.float32)], dim=-1)
    else:
        weights = torch.tensor([1 << (C - 1 - c) for c in range(C)],
                               dtype=torch.int32, device=init_states.device)
        idx = (init_states * weights[None, :]).sum(-1)
        st['psi'] = (idx[:, None] == torch.arange(
            1 << C, device=init_states.device)[None, :]).to(torch.complex64)


def exec_path(mp, cfg: InterpreterConfig, eng: str, device) -> str:
    """How the exec hop of a physics run on ``device`` retires an epoch
    on its resolved engine ``eng``: ``'kernel'`` — one launch of a span
    kernel (K3 for ``'fused'``; for ``'straightline'``, K3 with its readout
    left to the resolver, :func:`..ops.exec_span.exec_span_physics`) — on
    a CUDA device where K3 takes the program and the configuration
    (:func:`..sim.interpreter.fused_ineligible`: the parity device, no CW
    windows, no trace mode, a span-shaped program, a static measurement
    bound within ``max_meas``); ``'plain'`` — the engine's eager torch
    pass, or on the CPU the kernels' plain versions — otherwise."""
    if torch.device(device).type != 'cuda' \
            or eng not in ('straightline', 'fused'):
        return 'plain'
    if eng == 'fused':
        return 'kernel'
    # asked once per program object and configuration (a campaign asks
    # every batch; the analysis takes milliseconds of host time)
    known = mp.__dict__.setdefault('_k3_takes', {})
    if cfg not in known:
        known[cfg] = fused_ineligible(mp, cfg) is None
    return 'kernel' if known[cfg] else 'plain'


def run_physics_batch(mp, model: ReadoutPhysics, seed: int, shots: int,
                      init_states=None, init_regs=None,
                      cfg: InterpreterConfig = None, tables: dict = None,
                      device=None, **kw) -> dict:
    """Execute ``shots`` shots with the measurement loop closed by DSP.

    ``seed``: integer run seed (initial states, ADC noise, measurement
    uniforms and the statevec trajectory derive from it).
    ``init_states``: optional ``[shots, n_cores]`` 0/1 initial qubit
    states (default: thermal at ``model.p1_init``).  ``init_regs``:
    optional ``[n_cores, 16]`` or ``[shots, n_cores, 16]`` register
    file.  ``tables``: optional :func:`prepare_physics_tables` output.
    ``device``: the torch device (default CUDA; raises without it).

    Returns the interpreter's final state plus ``meas_bits`` /
    ``meas_bits_valid`` ``[shots, n_cores, max_meas]``, ``epochs`` and the
    device co-state: ``qturns`` (parity); ``bloch`` ``[shots, n_cores,
    3]`` (bloch) or ``psi`` ``[shots, 2^n_cores]`` and ``leaked``
    (statevec), with ``meas_p1`` (pre-projection P(1) per slot) and
    ``phys_t``; with ``classify3``, ``meas_class``.  A statevec run also
    returns the discrete-event gate's int64 device counters:
    ``gate_stall_steps``, the (shot, core) steps the gate held a pulse
    trigger, and ``live_core_steps``, the (shot, core) steps live in all
    (both 0 without couplings, where no gate runs); they are summed on
    the device and read with the run's other outputs.  Tensors on
    ``device``."""
    with host_span('physics.batch', 'shots', shots) as batch:
        with host_span('physics.prepare'):
            device = torch_device(device)
            # a caller-built cfg or max_steps counts as a sized budget;
            # only the default one is scaled for the statevec event gate
            # below
            explicit_steps = 'max_steps' in kw or cfg is not None
            cfg = physics_config(cfg, model, **kw)
            cfg, strict = _fault_policy(cfg)
            _check_fabric(cfg, mp.n_cores)
            _env, freq_stack, spc_m, interp_m, w_auto = \
                _physics_tables(mp, model.meas_elem)
            W = int(model.window_samples or w_auto)
            C, M = mp.n_cores, cfg.max_meas
            dm = _device_params(mp, model, seed, shots, M, device)
            if not explicit_steps:
                cfg = statevec_step_budget(cfg, model, C)
            _check_model(model, W)
            eng = check_supported(mp, cfg, device)
            path = exec_path(mp, cfg, eng, device)
            batch.arg('engine', eng)
            batch.arg('exec', path)
            batch.arg('device', model.device.kind)
            if eng == 'fused':
                _fused_blockers(model, _static_meas_env_addrs(mp))
            soa, spc, interp, sync_part = _program_constants(mp, device)
            if tables is None:
                tables = prepare_physics_tables(mp, model, device)
            else:
                _validate_tables(mp, model, tables, W)
            Lp = tables['env'].shape[2]
            ck = fused_chunk(model.resolve_chunk, W)

            if init_states is None:
                p1 = torch.as_tensor(np.broadcast_to(
                    np.asarray(model.p1_init, np.float32), (C,)).copy(),
                    device=device)
                gen = torch.Generator(device=device)
                gen.manual_seed(derive_seed(seed, 1) >> 1)
                init_states = (torch.rand((shots, C), generator=gen,
                                          device=device)
                               < p1[None, :]).to(torch.int32)
            init_states = torch.as_tensor(init_states, dtype=torch.int32,
                                          device=device)

            g0, g1 = _as_iq(model.g0, C, device), _as_iq(model.g1, C, device)
            g2 = None if model.g2 is None else _as_iq(model.g2, C, device)
            leak_bit = int(dm['static'][6]) \
                if model.device.kind == 'statevec' else 1
            iq3 = (g2, bool(model.classify3), leak_bit) \
                if g2 is not None else None
            sigma = float(np.float32(model.sigma))
            inv_ring = float(np.float32(0.0 if model.ring_tau <= 0
                                        else 1.0 / model.ring_tau))
            noise_seed = derive_seed(seed, 2)
            with host_span('h2d.wait'):
                window_tables = (
                    torch.as_tensor(freq_stack, device=device),
                    torch.as_tensor(spc_m, device=device),
                    torch.as_tensor(interp_m, device=device))
            traits = program_traits(mp)
            soa_np = _soa_np(mp)
            fused = fused_readout(mp, model, tables) \
                if eng == 'fused' else None
            span = _span_table(mp, cfg, device, fused=True) \
                if eng == 'fused' or path == 'kernel' else None
            cw = int(model.cw_horizon)

            B = init_states.shape[0]
            if eng == 'fused':
                _count_trace('pallas_trace', ('fused', B, cfg,
                                              _content_key(mp),
                                              _device_key(device)))
            st = _init_state(B, C, cfg, init_regs, device)
            _init_device(st, model.device.kind, init_states)
            bits = torch.zeros((B, C, M), dtype=torch.int32, device=device)
            valid = torch.zeros((B, C, M), dtype=torch.bool, device=device)
            cls = torch.zeros((B, C, M), dtype=torch.int32, device=device) \
                if model.classify3 else None
            xi = _analytic_xi(seed, B, C, M, device) \
                if model.resolve_mode == 'analytic' and sigma != 0 else None
            paused = torch.zeros((B,), dtype=torch.bool, device=device)
            slots = torch.arange(M, device=device)[None, None, :]
            # epoch bound: each epoch resolves at least one measurement
            # and a cross-core dependency chain can serialize them
            max_epochs, steps, ep = C * M + 1, 0, 0
        while ep < max_epochs:
            with host_span('physics.epoch', 'ep', ep):
                more = ((slots < st['n_meas'][..., None]) & ~valid).any()
                # the straight-line engines end by structure (one visit
                # per index), so only the generic and block engines spend
                # the step budget
                if eng in ('straightline', 'fused') \
                        or steps < cfg.max_steps:
                    more = more | ~st['done'].all()
                with host_span('physics.wait'):
                    more = bool(more)
                if not more:
                    break
                if eng == 'fused':
                    # the K3 kernel: exec and resolve in one pass, every
                    # bit landing in its slot at its trigger
                    with host_span('physics.exec'):
                        st, bits, valid = exec_span_fused(
                            st, span, bits, valid, cfg, fused)
                    steps += soa_np.shape[1]
                    ep += 1
                    continue
                with host_span('physics.exec'):
                    if path == 'kernel':
                        # one launch: the readout is the resolver's below
                        st = exec_span_physics(st, span, bits, valid, cfg)
                        steps += soa_np.shape[1]
                    elif eng == 'straightline':
                        st = _exec_straightline(st, soa_np, spc, interp,
                                                bits, valid, cfg, dm=dm)
                        steps += soa_np.shape[1]
                    elif eng == 'block':
                        # a fproc read pauses only in the boundary step, as
                        # in the generic engine
                        st, steps, paused = _exec_blocks(
                            st, steps, paused, soa, spc, interp, sync_part,
                            bits, valid, cfg, traits, dm)
                    else:
                        st, steps, paused = _exec_loop(
                            st, steps, paused, soa, spc, interp, sync_part,
                            bits, valid, cfg, traits, dm)
                with host_span('physics.resolve'):
                    if model.resolve_mode == 'analytic':
                        bits, valid, cls = _resolve_analytic(
                            st, bits, valid, xi, window_tables, tables['env'],
                            (g0, g1, g2), sigma, W, cw, iq3, cls)
                    else:
                        sc, state_sel, slot, has_pending = \
                            _compact_pending_slot(st, valid, window_tables,
                                                  cw)
                        gs = _channel(state_sel, g0[None], g1[None],
                                      None if g2 is None else g2[None])
                        acc_i, acc_q, energy = resolve_windows_fused(
                            sc, tables, gs[..., 0].contiguous(),
                            gs[..., 1].contiguous(), sigma, inv_ring,
                            noise_seed, W, Lp, ring=model.ring_tau > 0,
                            epoch=ep, ck=ck,
                            rho=float(np.float32(model.noise_ar1)))
                        new_bit, new_cls = _acc_to_bit(acc_i, acc_q, energy,
                                                       g0, g1, iq3)
                        if new_cls is not None:
                            cls, _ = _scatter_slot_bit(cls, valid, new_cls,
                                                       slot, has_pending)
                        bits, valid = _scatter_slot_bit(bits, valid, new_bit,
                                                        slot, has_pending)
                paused = torch.zeros_like(paused)
                ep += 1
        with host_span('physics.finalize'):
            out = _finalize(st, steps, cfg)
            out['meas_bits'] = bits
            out['meas_bits_valid'] = valid
            with host_span('h2d.wait'):
                out['epochs'] = torch.tensor(ep, dtype=torch.int32,
                                             device=device)
            if cls is not None:
                out['meas_class'] = cls
            if model.device.kind == 'statevec':
                out['gate_stall_steps'] = dm['gate_stall'].sum(
                    dtype=torch.int64)
                out['live_core_steps'] = dm['core_steps'].sum(
                    dtype=torch.int64)
            if strict:
                with host_span('physics.wait'):
                    out = _check_strict(out, strict)
        return out
