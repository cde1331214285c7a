"""Physics-closed measurement feedback: epoch execution (parity device).

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
   discriminates it against the clean |0>/|1> responses;
3. **resumes** with the resolved bits, until every shot is done.

``engine='fused'`` (sigma = 0 only) collapses the loop to one pass of
the span kernel K3 (:func:`..ops.exec_span.exec_span_fused`), which
resolves each window at its trigger.  The epoch loop is a Python
``while`` whose condition is read with one ``.item()`` per epoch.
``resolve_mode='fused'`` and ``'persample'`` select the same per-sample
chain here (the JAX package holds its two formulations bit-identical at
sigma = 0).  The qubit is the parity co-state: each drive pulse adds
``round(amp / x90_amp)`` quarter turns and the state bit is the
half-turn parity.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..elements import ENV_CW_SENTINEL, IQ_SCALE
from ..ops.exec_span import exec_span_fused
from ..ops.resolve import build_energy_prefix, build_energy_tables, \
    build_fused_tables, fused_chunk, resolve_windows_fused
from ..ops.waveform import PHASE_BITS, AMP_SCALE, complex_to_iq, \
    carrier_phase
from .device import DeviceModel
from .interpreter import (InterpreterConfig, _program_constants,
                          _span_table, _init_state, _exec_blocks, _exec_loop,
                          _exec_straightline, _finalize, _fault_policy,
                          _check_strict, _soa_np, check_supported,
                          program_traits, not_ported, torch_device)

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
    ``resolve_mode``: 'persample' or 'fused' (the same chain here).
    This slice raises for ``g2``/``classify3``, ``cw_horizon > 0``,
    ``noise_ar1 > 0``, ``resolve_mode='analytic'`` and devices other than
    'parity'.
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


def _discriminate_acc(acc_i, acc_q, energy, g0, g1):
    """Project the matched-filter sums ``[B, C]`` onto the |0>-|1> axis
    (clean responses ``g_s * E``) and threshold — the 2-class
    ``_acc_to_bit``."""
    a0_i, a0_q = g0[None, :, 0] * energy, g0[None, :, 1] * energy
    a1_i, a1_q = g1[None, :, 0] * energy, g1[None, :, 1] * energy
    proj = (acc_i - (a0_i + a1_i) / 2) * (a1_i - a0_i) \
        + (acc_q - (a0_q + a1_q) / 2) * (a1_q - a0_q)
    return (proj > 0).to(torch.int32)


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


def _check_model(model: ReadoutPhysics, eng: str) -> None:
    """Raise for invalid readout models, and for those this slice does
    not port.  Under ``engine='fused'`` the resolver never runs, so only
    the fused engine's own gates apply to it."""
    if model.resolve_mode not in ('persample', 'fused', 'analytic'):
        raise ValueError(f'unknown resolve_mode {model.resolve_mode!r}')
    if not 0.0 <= model.noise_ar1 < 1.0:
        raise ValueError(f'noise_ar1={model.noise_ar1} must be in [0, 1)')
    if eng != 'fused':
        if model.resolve_mode == 'analytic':
            raise not_ported("resolve_mode='analytic'", 3)
        if model.noise_ar1 > 0:
            raise not_ported('AR(1) ADC noise (noise_ar1 > 0)', 3)
    if model.g2 is not None or model.classify3:
        raise not_ported('IQ-level leakage readout (g2, classify3)', 3)
    if model.cw_horizon < 0:
        raise ValueError(f'cw_horizon={model.cw_horizon} must be >= 0')
    if model.cw_horizon > 0:
        raise not_ported('CW readout (cw_horizon > 0)', 3)
    if model.device.kind != 'parity':
        raise not_ported(f'device {model.device.kind!r}', 4)


def _as_iq(g, C: int, device) -> torch.Tensor:
    """A complex response (scalar or per core) as ``[C, 2]`` float32."""
    g = np.broadcast_to(np.asarray(g, complex), (C,))
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
    # JAX package; 'persample' reads the full clamped table — both give
    # the same envelope samples
    rows = _static_meas_env_addrs(mp) if model.resolve_mode == 'fused' \
        else None
    tabs = build_fused_tables(
        env_pads, _carrier_basis(torch.as_tensor(freq_stack, device=device),
                                 W), W, interps, rows)
    tabs['meta'] = _tables_meta(model, W, mp)
    return tabs


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


def run_physics_batch(mp, model: ReadoutPhysics, seed: int, shots: int,
                      init_states=None, init_regs=None,
                      cfg: InterpreterConfig = None, tables: dict = None,
                      device=None, **kw) -> dict:
    """Execute ``shots`` shots with the measurement loop closed by DSP.

    ``seed``: integer run seed (initial states and ADC noise derive from
    it).  ``init_states``: optional ``[shots, n_cores]`` 0/1 initial qubit
    states (default: thermal at ``model.p1_init``).  ``init_regs``:
    optional ``[n_cores, 16]`` or ``[shots, n_cores, 16]`` register
    file.  ``tables``: optional :func:`prepare_physics_tables` output.
    ``device``: the torch device (default CUDA; raises without it).

    Returns the interpreter's final state plus ``meas_bits`` /
    ``meas_bits_valid`` ``[shots, n_cores, max_meas]``, ``qturns`` and
    ``epochs``, as tensors on ``device``."""
    device = torch_device(device)
    cfg = physics_config(cfg, model, **kw)
    cfg, strict = _fault_policy(cfg)
    eng = check_supported(mp, cfg, device)
    if eng == 'fused':
        _fused_blockers(model, _static_meas_env_addrs(mp))
    _check_model(model, eng)
    soa, spc, interp, sync_part = _program_constants(mp, device)
    _env, freq_stack, spc_m, interp_m, w_auto = \
        _physics_tables(mp, model.meas_elem)
    W = int(model.window_samples or w_auto)
    C, M = mp.n_cores, cfg.max_meas
    if tables is None:
        tables = prepare_physics_tables(mp, model, device)
    elif tables.get('meta') != _tables_meta(model, W, mp):
        raise ValueError(
            f"prebuilt tables were built for {tables.get('meta')}, but "
            f'this program/model needs {_tables_meta(model, W, mp)} — '
            f'rebuild with prepare_physics_tables(mp, model)')
    Lp = tables['env'].shape[2]
    ck = fused_chunk(model.resolve_chunk, W)

    if init_states is None:
        p1 = torch.as_tensor(np.broadcast_to(
            np.asarray(model.p1_init, np.float32), (C,)).copy(),
            device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(derive_seed(seed, 1) >> 1)
        init_states = (torch.rand((shots, C), generator=gen, device=device)
                       < p1[None, :]).to(torch.int32)
    init_states = torch.as_tensor(init_states, dtype=torch.int32,
                                  device=device)

    g0, g1 = _as_iq(model.g0, C, device), _as_iq(model.g1, C, device)
    sigma = float(np.float32(model.sigma))
    inv_ring = float(np.float32(0.0 if model.ring_tau <= 0
                                else 1.0 / model.ring_tau))
    noise_seed = derive_seed(seed, 2)
    window_tables = (torch.as_tensor(freq_stack, device=device),
                     torch.as_tensor(spc_m, device=device),
                     torch.as_tensor(interp_m, device=device))
    traits = program_traits(mp)
    soa_np = _soa_np(mp)
    fused = fused_readout(mp, model, tables) if eng == 'fused' else None
    span = _span_table(mp, cfg, device, fused=True) if eng == 'fused' \
        else None

    B = init_states.shape[0]
    st = _init_state(B, C, cfg, init_regs, device)
    st['qturns'] = 2 * init_states
    bits = torch.zeros((B, C, M), dtype=torch.int32, device=device)
    valid = torch.zeros((B, C, M), dtype=torch.bool, device=device)
    paused = torch.zeros((B,), dtype=torch.bool, device=device)
    slots = torch.arange(M, device=device)[None, None, :]
    # epoch bound: each epoch resolves at least one measurement and a
    # cross-core dependency chain can serialize them
    max_epochs, steps, ep = C * M + 1, 0, 0
    while ep < max_epochs:
        more = ((slots < st['n_meas'][..., None]) & ~valid).any()
        # the straight-line engines end by structure (one visit per
        # index), so only the generic and block engines spend the step
        # budget
        if eng in ('straightline', 'fused') or steps < cfg.max_steps:
            more = more | ~st['done'].all()
        if not bool(more):
            break
        if eng == 'fused':
            # the K3 kernel: exec and resolve in one pass, every bit
            # landing in its slot at its trigger
            st, bits, valid = exec_span_fused(st, span, bits, valid, cfg,
                                              fused)
            steps += soa_np.shape[1]
            ep += 1
            continue
        if eng == 'straightline':
            st = _exec_straightline(st, soa_np, spc, interp, bits, valid,
                                    cfg)
            steps += soa_np.shape[1]
        elif eng == 'block':
            # a fproc read pauses only in the boundary step, as in the
            # generic engine
            st, steps, paused = _exec_blocks(st, steps, paused, soa, spc,
                                             interp, sync_part, bits, valid,
                                             cfg, traits)
        else:
            st, steps, paused = _exec_loop(st, steps, paused, soa, spc,
                                           interp, sync_part, bits, valid,
                                           cfg, traits)
        sc, state_sel, slot, has_pending = \
            _compact_pending_slot(st, valid, window_tables)
        gs = torch.where(state_sel == 1, g1[None], g0[None])   # [B, C, 2]
        acc_i, acc_q, energy = resolve_windows_fused(
            sc, tables, gs[..., 0].contiguous(), gs[..., 1].contiguous(),
            sigma, inv_ring, noise_seed, W, Lp,
            ring=model.ring_tau > 0, epoch=ep, ck=ck)
        new_bit = _discriminate_acc(acc_i, acc_q, energy, g0, g1)
        bits, valid = _scatter_slot_bit(bits, valid, new_bit, slot,
                                        has_pending)
        paused = torch.zeros_like(paused)
        ep += 1
    out = _finalize(st, steps, cfg)
    out['meas_bits'] = bits
    out['meas_bits_valid'] = valid
    out['epochs'] = torch.tensor(ep, dtype=torch.int32, device=device)
    return _check_strict(out, strict)
