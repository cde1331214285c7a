"""Signal-generator elements: DAC waveform synthesis from pulse records.

Counterpart of the JAX package's ``ops/waveform.py`` and
``ops/waveform_pallas.py``: given the interpreter's pulse records and the
assembler's envelope tables, the baseband output of each element.

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

Two entries launch one kernel, ``csrc/waveform.cu``:

* :func:`render_shot` renders every (core, element) trace of one shot of
  a run in one launch, reading the run's record tensors where they lie;
  the shot-independent half (envelope memories, geometry, the NCO word
  of every frequency-buffer address) is a :class:`RenderTable`, built
  once per program content (:func:`render_table`).
  ``Simulator.waveforms`` makes one such call.
* :func:`synthesize_element`, the JAX package's public function, renders
  one element from 1-D records as a one-trace call of the same kernel.

On the CPU both take plain torch versions of the same arithmetic
(:func:`_render_plain`, :func:`synthesize_element_reference`).  The pulse
descriptors (valid-pulse filter, CW ends from the sorted starts, NCO
words) are what the kernel derives inside each block;
:func:`element_descriptors` (numpy) is their reference and
:func:`descriptors_from_records` their torch counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..elements import ENV_CW_SENTINEL, IQ_SCALE
from . import _cuda

PHASE_BITS = 17
AMP_SCALE = float(2 ** 16 - 1)
# float32(2 * pi / 2^32): NCO phase units to radians
_TWO_PI_OVER_2_32 = float(np.float32(2 * np.pi / 2 ** 32))
# rows of the pulse-descriptor table [7, P] (int32)
_DESC_FIELDS = ('start', 'end', 'env_addr', 'inc', 'phase0', 'amp', 'is_cw')
# columns of a render table's rows [T, 10] (int32; csrc/waveform.cu reads
# them in this order): a trace's record core and element, its geometry
# (``shift``: log2(interp), or -1 for a ratio that is no power of two),
# where its envelope memory and its NCO words lie (``n_inc``: the
# frequency-buffer addresses served; the word at ``n_inc`` is the
# past-the-table 0) and where its samples begin in a render's output, in
# units of ``n_clks`` (the spc prefix)
_TRACE_FIELDS = ('core', 'elem', 'spc', 'interp', 'shift', 'env_off',
                 'env_len', 'inc_off', 'n_inc', 'out_spc')
_T = {name: i for i, name in enumerate(_TRACE_FIELDS)}
# the record fields a render reads, in the kernel's argument order
_REC_FIELDS = ('gtime', 'env', 'phase', 'amp', 'elem', 'freq')
# threads per block of the render kernel and samples per block
# (csrc/waveform.cu THREADS, TILE)
RENDER_THREADS, RENDER_TILE = 256, 1024


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
# element synthesis: the pulse descriptors, the plain version, the render
# table and the kernel wrappers


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


def _nco_words(freq_rel) -> np.ndarray:
    """NCO increments ``round(freq_rel * 2^32) mod 2^32``, taken in
    float64, as int32 bit patterns."""
    words = np.round(np.asarray(freq_rel, np.float64) * 2 ** 32)
    return (words.astype(np.int64) % (1 << 32)).astype(np.uint32) \
        .view(np.int32)


def element_descriptors(rec: dict, spc: int, interp: int, n_clks: int,
                        elem: int = 0) -> np.ndarray:
    """The element's valid pulses as the int32 table ``[7, P]`` the plain
    version reads (rows: ``_DESC_FIELDS``), in numpy: the reference for
    the descriptors the kernel derives in each block and
    :func:`descriptors_from_records` derives in torch.  ``inc`` and
    ``phase0`` hold uint32 bit patterns."""
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


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2^32 as int32 (numpy's ``astype(np.uint32)
    .view(np.int32)``)."""
    return (((x + (1 << 31)) & 0xffffffff) - (1 << 31)).to(torch.int32)


def descriptors_from_records(rec: dict, inc_words: torch.Tensor, spc: int,
                             interp: int, n_clks: int,
                             elem: int = 0) -> torch.Tensor:
    """:func:`element_descriptors` in torch on the records' device, from
    frequency-buffer addresses: what the render kernel derives inside
    each block.  ``rec``: 1-D int ``gtime, env, phase, amp, elem, freq``
    tensors of one core and ``n_pulses``; ``inc_words``: the element's NCO
    words per address (:func:`_nco_words`), the past-the-table 0 last.
    Returns int32 ``[7, P]``, equal to the numpy reference bit for bit."""
    n_samples = int(n_clks) * int(spc)
    P = min(int(rec['n_pulses']), rec['gtime'].shape[0])
    idx = torch.nonzero(rec['elem'][:P] == elem).flatten()
    starts = rec['gtime'][idx].long() * spc
    env_words = rec['env'][idx].long()
    env_nw = (env_words >> 12) & 0xfff
    is_cw = env_nw == ENV_CW_SENTINEL
    # a CW pulse ends at the next pulse start on the element
    order = torch.argsort(starts, stable=True)
    nxt = torch.full_like(starts, n_samples)
    nxt[order[:-1]] = starts[order[1:]]
    ends = torch.where(is_cw, nxt.clamp(max=n_samples),
                       starts + env_nw * 4 * interp)
    words = inc_words.long()
    inc = words[rec['freq'][idx].long().clamp(0, len(words) - 1)]
    return _wrap32(torch.stack([
        starts, ends, (env_words & 0xfff) * 4, inc,
        rec['phase'][idx].long() * (1 << 15), rec['amp'][idx].long(),
        is_cw.long()]))


def _synthesize_plain(desc, env: torch.Tensor, interp: int,
                      n_samples: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, pulse by pulse over each
    pulse's own window.  ``desc``: ``[7, P]`` int32, numpy or a tensor;
    ``env``: ``[L, 2]`` float32 on the device the trace is made on."""
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


class RenderTable(NamedTuple):
    """The shot-independent half of a render on one device
    (:func:`make_table`): for every trace (a core's element), its row of
    ``_TRACE_FIELDS``, its envelope memory and its NCO word per
    frequency-buffer address.  Trace ``t``'s ``n_clks * spc`` samples
    begin ``n_clks * out_spc`` rows into a render's output."""
    rows: np.ndarray          # [T, len(_TRACE_FIELDS)] int32, on the host
    traces: torch.Tensor      # rows on the device
    env: torch.Tensor         # [sum of env_len, 2] float32
    inc: torch.Tensor         # [sum of n_inc + 1] int32 NCO words
    spc_total: int            # samples per clock of all traces together
    spc_max: int              # of the widest trace: the grid's tiles
    n_cores: int              # the records must hold this many cores


def make_table(rows: np.ndarray, env, inc, device) -> RenderTable:
    """A :class:`RenderTable` on ``device`` from its rows
    (:func:`_table_rows`), the envelope memories end to end (float32
    ``[*, 2]``) and the NCO words (int32), each numpy or a tensor."""
    env = torch.as_tensor(env, device=device)
    inc = torch.as_tensor(inc, device=device)
    if env.dtype != torch.float32 or env.dim() != 2 or env.shape[1] != 2 \
            or inc.dtype != torch.int32 or inc.dim() != 1:
        raise ValueError(f'waveform kernel: the envelope memory must be '
                         f'float32 [L, 2] and the NCO words int32 [n]; got '
                         f'{env.dtype} {tuple(env.shape)} and {inc.dtype} '
                         f'{tuple(inc.shape)}')
    ends = rows[:, [_T['env_off'], _T['inc_off']]] \
        + rows[:, [_T['env_len'], _T['n_inc']]] + [0, 1]
    if len(rows) and (int(ends[:, 0].max()) > env.shape[0]
                      or int(ends[:, 1].max()) > inc.shape[0]
                      or int(rows[:, _T['env_len']].min()) < 1):
        raise ValueError('waveform kernel: the table rows reach past its '
                         'envelope memory or NCO words')
    spc = rows[:, _T['spc']]
    return RenderTable(rows, torch.as_tensor(rows, device=device), env, inc,
                       int(spc.sum()), int(spc.max(initial=0)),
                       int(rows[:, _T['core']].max(initial=-1)) + 1)


def _table_rows(geometry) -> np.ndarray:
    """Render-table rows from ``(core, elem, spc, interp, env_len,
    n_words)`` per trace, envelopes and NCO words laid end to end."""
    rows, env_off, inc_off, out_spc = [], 0, 0, 0
    for core, elem, spc, interp, env_len, n_words in geometry:
        if spc < 1 or interp < 1:
            raise ValueError(f'waveform kernel: element {elem} of core '
                             f'{core} has spc={spc}, interp={interp}; '
                             f'both must be >= 1')
        shift = interp.bit_length() - 1 if interp & (interp - 1) == 0 else -1
        rows.append((core, elem, spc, interp, shift, env_off, env_len,
                     inc_off, n_words - 1, out_spc))
        env_off, inc_off, out_spc = (env_off + env_len, inc_off + n_words,
                                     out_spc + spc)
    return np.asarray(rows, np.int32).reshape(-1, len(_TRACE_FIELDS))


def _program_table(mp, cores: tuple, device) -> RenderTable:
    envs, words, geometry = [], [], []
    for c in cores:
        tables = mp.tables[c]
        for e, ecfg in enumerate(tables.elem_cfgs):
            freq = np.asarray(tables.freqs[e]['freq'], np.float64) \
                if e < len(tables.freqs) else np.zeros(0)
            env = np.asarray(tables.envs[e]) / IQ_SCALE \
                if e < len(tables.envs) and len(tables.envs[e]) \
                else np.zeros(1, complex)
            envs.append(_env_table_iq(env))
            words.append(_nco_words(np.concatenate(
                [freq / ecfg.sample_freq, [0.0]])))
            geometry.append((c, e, ecfg.samples_per_clk, ecfg.interp_ratio,
                             len(envs[-1]), len(words[-1])))
    return make_table(
        _table_rows(geometry),
        np.concatenate(envs) if envs else np.zeros((1, 2), np.float32),
        np.concatenate(words) if words else np.zeros(1, np.int32), device)


# a run renders from one table; the cache keeps the few programs a caller
# alternates between
_TABLES: OrderedDict = OrderedDict()
_TABLES_LOCK = threading.Lock()
_TABLES_MAX = 8


def _device(device) -> torch.device:
    """The entry points' device (CUDA unless named), a CUDA device with
    its index: 'cuda' and 'cuda:<current>' are one device."""
    from ..sim.interpreter import torch_device
    device = torch_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def render_table(mp, cores=None, device=None) -> RenderTable:
    """Every element of the cores ``cores`` (default: all, in order) of
    the machine program ``mp`` as a :class:`RenderTable` on ``device``:
    the envelope memories scaled by ``IQ_SCALE`` (an empty one reads one
    zero sample), the geometry, and the NCO words of each element's
    frequency buffer computed once on the host in float64, with the
    past-the-table address reading 0.  Nothing in it depends on the shot
    or on ``n_clks``.  Cached on the program's content, the cores and the
    device, under a lock, so that a render copies none of it."""
    device = _device(device)
    cores = tuple(range(mp.n_cores)) if cores is None \
        else tuple(int(c) for c in cores)
    key = [str(device), cores]
    for c in cores:
        tables = mp.tables[c]
        for e, ecfg in enumerate(tables.elem_cfgs):
            key.append((ecfg.samples_per_clk, ecfg.interp_ratio,
                        float(ecfg.sample_freq),
                        np.asarray(tables.freqs[e]['freq'] if e < len(
                            tables.freqs) else (), np.float64).tobytes(),
                        np.asarray(tables.envs[e] if e < len(tables.envs)
                                   else (), np.complex128).tobytes()))
    key = tuple(key)
    with _TABLES_LOCK:
        table = _TABLES.get(key)
        if table is None:
            table = _TABLES[key] = _program_table(mp, cores, device)
            if len(_TABLES) > _TABLES_MAX:
                _TABLES.popitem(last=False)
        else:
            _TABLES.move_to_end(key)
    return table


def shot_records(out: dict, shot=None, device=None) -> dict:
    """One shot of a run's pulse records as a render reads them on
    ``device``: int32 ``[C, P]`` per field of ``_REC_FIELDS`` and
    ``n_pulses`` int32 ``[C]``.  Tensors already there are views (no
    copy); numpy records (a JAX run carried across) or tensors elsewhere
    go there in one copy."""
    device = _device(device)
    names = ['rec_' + k for k in _REC_FIELDS] + ['n_pulses']
    sel = [out[n] if shot is None else out[n][shot] for n in names]
    keys = _REC_FIELDS + ('n_pulses',)
    if all(isinstance(x, torch.Tensor) and x.device == device for x in sel):
        return {k: x.to(torch.int32).contiguous() for k, x in zip(keys, sel)}
    host = [np.asarray(_to_numpy(x), np.int32) for x in sel]
    flat = torch.as_tensor(np.concatenate([h.reshape(-1) for h in host])) \
        .to(device)
    recs, at = {}, 0
    for k, h in zip(keys, host):
        recs[k] = flat[at:at + h.size].view(h.shape)
        at += h.size
    return recs


def default_n_clks(out: dict, shot=None) -> int:
    """The JAX facade's trace length: the end of the shot's last pulse
    record (``gtime + dur``, over every row) plus 8 clocks — one scalar
    read for records on the card."""
    gtime, dur = out['rec_gtime'], out['rec_dur']
    if shot is not None:
        gtime, dur = gtime[shot], dur[shot]
    return int((gtime + dur).max()) + 8


def split_traces(flat, table: RenderTable, n_clks: int) -> dict:
    """``{core: [trace per element]}``: views of a render's output
    ``flat`` (numpy or a tensor) in the table's trace order."""
    result = {}
    for row in table.rows.tolist():
        t = dict(zip(_TRACE_FIELDS, row))
        off = n_clks * t['out_spc']
        result.setdefault(t['core'], []).append(
            flat[off:off + n_clks * t['spc']])
    return result


def _render_plain(rec: dict, table: RenderTable, n_clks: int) \
        -> torch.Tensor:
    """:func:`render_shot` in plain torch on the table's device: each
    trace's descriptors from the records (:func:`descriptors_from_records`)
    through :func:`_synthesize_plain`.  What the CPU path runs and what
    the kernel is held against on the card."""
    n_clks = int(n_clks)
    out = torch.zeros((n_clks * table.spc_total, 2), dtype=torch.float32,
                      device=table.env.device)
    for row in table.rows.tolist():
        t = dict(zip(_TRACE_FIELDS, row))
        c = t['core']
        r = {k: rec[k][c] for k in _REC_FIELDS + ('n_pulses',)}
        words = table.inc[t['inc_off']:t['inc_off'] + t['n_inc'] + 1]
        desc = descriptors_from_records(r, words, t['spc'], t['interp'],
                                        n_clks, t['elem'])
        env = table.env[t['env_off']:t['env_off'] + t['env_len']]
        n, off = n_clks * t['spc'], n_clks * t['out_spc']
        out[off:off + n] = _synthesize_plain(desc, env, t['interp'], n)
    return out


def tile_pulse_ranges(desc, lo_tile: int, n_samples: int) -> tuple:
    """The render kernel's visiting plan for its block at sample
    ``lo_tile`` of a trace of ``n_samples``, on the host: the columns of
    ``desc`` (:func:`element_descriptors`) it stages — the pulses that
    reach the tile, a CW pulse by its start alone — in (start, column)
    order, and for each pass of ``RENDER_THREADS`` samples the range
    ``[lo, hi)`` of them that the pass visits: ``hi`` counts the starts
    before the pass's end, ``lo`` skips the pulses whose running maximum
    end lies at or before its start."""
    desc = np.asarray(desc)
    start, end = desc[0].astype(np.int64), desc[1].astype(np.int64)
    hi_tile = min(lo_tile + RENDER_TILE, n_samples)
    take = np.where(desc[6] != 0, start < hi_tile,
                    (start < hi_tile) & (end > lo_tile) & (start < end))
    cols = np.nonzero(take)[0]
    cols = cols[np.lexsort((cols, start[cols]))]
    pmax = np.maximum.accumulate(end[cols]) if len(cols) else end[:0]
    ranges, lo, hi, k = [], 0, 0, len(cols)
    for a in range(lo_tile, lo_tile + RENDER_TILE, RENDER_THREADS):
        while lo < k and pmax[lo] <= a:
            lo += 1
        while hi < k and start[cols[hi]] < a + RENDER_THREADS:
            hi += 1
        ranges.append((lo, hi))
    return cols, ranges


@functools.lru_cache(maxsize=None)
def _render_fn():
    """The render kernel's C entry point, built, loaded and typed once."""
    fn = _cuda.load('waveform').dp_render_shot
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, p, i, p, p, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def render_shot(rec: dict, table: RenderTable, n_clks: int) -> torch.Tensor:
    """Render every trace of ``table`` from one shot's records ``rec``
    (:func:`shot_records`: int32 ``[C, P]`` fields and ``n_pulses``
    ``[C]``) over ``n_clks`` clocks.  Returns float32 ``[n_clks *
    spc_total, 2]``, the traces end to end (:func:`split_traces`).

    Records on a CUDA device make one launch of ``csrc/waveform.cu`` for
    every trace, counted in ``render_shot.launches``; records on the CPU
    take the plain version (:func:`_render_plain`)."""
    gtime = rec['gtime']
    device = gtime.device
    n_clks = int(n_clks)
    for name, t in (('traces', table.traces), ('env', table.env),
                    ('inc', table.inc)):
        if t.device != device:
            raise ValueError(f'waveform kernel: the render table\'s {name} '
                             f'lies on {t.device}, the records on {device}')
    if device.type == 'cpu':
        return _render_plain(rec, table, n_clks)
    if device.type != 'cuda':
        raise ValueError(f'waveform kernel: unsupported device {device}')
    shape = gtime.shape
    for name in _REC_FIELDS + ('n_pulses',):
        t = rec[name]
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous() \
                or t.shape != (shape[:1] if name == 'n_pulses' else shape):
            raise ValueError(
                f'waveform kernel: {name} must be a contiguous int32 tensor '
                f'of the shape of gtime ([C, P]; n_pulses [C]) on {device}; '
                f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    if len(shape) != 2 or shape[0] < table.n_cores:
        raise ValueError(f'waveform kernel: the table renders '
                         f'{table.n_cores} cores from records of shape '
                         f'{tuple(shape)}')
    n_total = n_clks * table.spc_total
    if n_clks < 0 or n_total + RENDER_TILE >= 1 << 31:
        raise ValueError(f'waveform kernel: n_clks={n_clks} gives '
                         f'{n_total} samples; the render serves [0, '
                         f'2^31 - {RENDER_TILE})')
    out = torch.empty((n_total, 2), dtype=torch.float32, device=device)
    if n_total == 0:
        return out
    rc = _render_fn()(
        *(rec[k].data_ptr() for k in _REC_FIELDS),
        rec['n_pulses'].data_ptr(), shape[1], table.traces.data_ptr(),
        len(table.rows), table.env.data_ptr(), table.inc.data_ptr(), n_clks,
        table.spc_max, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'waveform kernel launch failed: cudaError {rc}')
    render_shot.launches += 1
    return out


render_shot.launches = 0


def element_inputs(rec: dict, env_table, spc: int, interp: int,
                   elem: int = 0, device=None) -> tuple:
    """One element's 1-D records and envelope memory as a one-trace
    render on ``device`` (default: the record tensors' device; CUDA for
    numpy records): ``(records, table)`` for :func:`render_shot`.  Each
    record row addresses its own NCO word, computed from its ``freq_rel``
    in float64 as :func:`element_descriptors` does.  Records already there
    stay there; numpy records go in one copy."""
    if device is None and isinstance(rec['gtime'], torch.Tensor):
        device = rec['gtime'].device
    device = _device(device)
    n = rec['gtime'].shape[0]
    ints = ('gtime', 'env', 'phase', 'amp', 'elem')
    if all(isinstance(rec[k], torch.Tensor) and rec[k].device == device
           for k in ints + ('freq_rel', 'n_pulses')):
        recs = {k: rec[k].to(torch.int32).reshape(1, n) for k in ints}
        recs['n_pulses'] = rec['n_pulses'].to(torch.int32).reshape(1)
        words = _wrap32(torch.round(rec['freq_rel'].double() * 2 ** 32)
                        .long() % (1 << 32))
        words = torch.cat([words, words.new_zeros(1)])
    else:
        host = [np.asarray(_to_numpy(rec[k]), np.int32).reshape(n)
                for k in ints] + [
            np.asarray(_to_numpy(rec['n_pulses']), np.int32).reshape(1),
            _nco_words(_to_numpy(rec['freq_rel'])).reshape(n),
            np.zeros(1, np.int32)]
        flat = torch.as_tensor(np.concatenate(host)).to(device)
        recs = {k: flat[i * n:(i + 1) * n].view(1, n)
                for i, k in enumerate(ints)}
        recs['n_pulses'] = flat[5 * n:5 * n + 1]
        words = flat[5 * n + 1:]
    recs['freq'] = torch.arange(n, dtype=torch.int32,
                                device=device).view(1, n)
    env = _env_table_iq(env_table)
    rows = _table_rows([(0, elem, int(spc), int(interp), len(env), n + 1)])
    return recs, make_table(rows, env, words, device)


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

    A one-trace render (:func:`element_inputs`, :func:`render_shot`): on
    a CUDA device one launch of the render kernel, counted in
    ``render_shot.launches``; on the CPU the plain version.  Returns
    ``float32 [n_clks * spc, 2]`` on that device."""
    return render_shot(*element_inputs(rec, env_table, spc, interp, elem,
                                       device), n_clks)
