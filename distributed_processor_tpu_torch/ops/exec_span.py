"""The megastep kernels K1 (span and block mode) and K3: the CUDA
wrappers.

Counterpart of the JAX package's ``ops/exec_pallas.py`` ``span_call``
with its three bodies, all in ``csrc/exec_span.cu``:

* :func:`exec_span` — K1 span mode (``interpreter._exec_span_pallas``):
  a whole forward-jump-only program over every (shot, core) lane in one
  launch, injected measurement bits, every bit valid.
* :func:`exec_span_fused` — K3 (``interpreter._exec_span_pallas_fused``):
  the same in physics mode on the parity device; each measurement
  trigger resolves its window's sigma = 0 bit in the kernel, so one
  launch replaces the epoch loop's exec -> resolve round trips.
* :func:`exec_blocks` — K1 block mode
  (``interpreter._exec_block_body_pallas``): one launch per iteration of
  the block engine retires, for every lane at a block start, that
  block's deduplicated straight-line body, over the program's block
  table checked and moved to the device once per run
  (:func:`block_table`).

The plain versions are the port's straight-line engine
(``sim.interpreter._exec_straightline``) and the block engine's bodies
(``sim.interpreter._apply_blocks``).  CUDA tensors launch the kernel and
count one in the wrapper's ``launches``; CPU tensors take the plain
version; any other device raises.  On CUDA there is no path to the
plain version: a failed build or launch raises.

The state is the interpreter's carry dict (``interpreter._init_state``
keys, :data:`LEAVES`).  The span kernels read each input leaf once and
write a new output leaf once; the inputs are left as they were.  The
block kernel updates the carry in place (a body reads and writes only
its own lane, and most lanes of an iteration run no body).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import isa
from . import _cuda

# state leaves in the order of csrc/exec_span.cu `enum Leaf`
LEAVES = ('pc', 'regs', 'time', 'offset', 'done', 'err', 'fault', 'pp',
          'n_pulses', 'n_resets', 'rst_time', 'n_meas', 'meas_avail', 'rec',
          'op_hist', 'meas_state', 'meas_amp', 'meas_phase', 'meas_freq',
          'meas_env', 'meas_gtime', 'qturns', 'meas_bits', 'meas_valid',
          'phys_wait')
_BOOL_LEAVES = frozenset(('done', 'meas_valid', 'phys_wait'))
# scalar parameters in the order of csrc/exec_span.cu `enum Param`
PARAMS = ('B', 'C', 'N', 'M', 'R', 'P', 'E', 'meas_elem', 'meas_latency',
          'alu_clks', 'jcond_clks', 'jfproc_clks', 'regwrite_clks',
          'load_clks', 'x90_amp', 'drive_elem', 'n_addrs', 'W', 'Wp')

N_REGS, N_PP, N_REC, N_KINDS = 16, 5, 9, 12
# the largest envelope length word a pulse can latch (0xfff is CW)
_MAX_ENV_LEN = 0xffe


def exec_span(st: dict, soa_np, spc, interp, meas_bits, cfg) -> dict:
    """K1: one pass of the forward-jump-only program ``soa_np [C, N, 18]``
    over the carry ``st`` with injected ``meas_bits [B, C, M]`` int32.
    ``spc``/``interp``: ``[C, E]`` int32 element geometry.  Returns the
    new carry."""
    device = st['pc'].device
    if device.type == 'cpu':
        from ..sim.interpreter import _exec_straightline
        valid = torch.ones(meas_bits.shape, dtype=torch.bool)
        return _exec_straightline(st, soa_np, spc, interp, meas_bits, valid,
                                  cfg)
    if cfg.physics:
        raise ValueError('exec_span runs injected-bits programs; a physics '
                         'run takes exec_span_fused')
    out = _launch(st, soa_np, spc, interp, cfg, bits_in=meas_bits)
    exec_span.launches += 1
    return out


exec_span.launches = 0


def exec_span_fused(st: dict, soa_np, spc, interp, bits, valid, cfg,
                    fused: dict):
    """K3: one pass of the program over the physics carry ``st`` with the
    measurement bits ``bits`` int32 / ``valid`` bool ``[B, C, M]`` as
    state, each measurement window resolved at its trigger against
    ``fused``: ``e2 [C, R, Wp]`` float32 energy rows of the static
    envelope addresses ``addrs`` (R ints) and their prefix sums ``e2p
    [C, R, Wp + 1]`` (the kernel reads ``e2p``, the plain version
    ``e2``), ``g0``/``g1 [C, 2]`` float32 responses, the window ``w`` and
    ``amp_scale``.  Returns ``(st, bits, valid)``."""
    device = st['pc'].device
    carry = dict(st, meas_bits=bits, meas_valid=valid)
    if device.type == 'cpu':
        from ..sim.interpreter import _exec_straightline
        out = _exec_straightline(carry, soa_np, spc, interp, None, None, cfg,
                                 fused=fused)
    else:
        if not cfg.physics or cfg.device != 'parity' or cfg.cw_horizon:
            raise ValueError('exec_span_fused runs physics mode on the '
                             'parity device without CW windows')
        out = _launch(carry, soa_np, spc, interp, cfg, fused=fused)
        exec_span_fused.launches += 1
    return out, out.pop('meas_bits'), out.pop('meas_valid')


exec_span_fused.launches = 0


class BlockTable(NamedTuple):
    """A program's block table as one block engine run uses it, checked
    and moved to the run's device once (:func:`block_table`)."""
    soa_np: np.ndarray        # [C, N, 18] packed program rows
    bodies: tuple             # (start, length) of each deduplicated body
    bid: torch.Tensor         # [N] int32 block id per index, -1: none
    body_tab: torch.Tensor    # [n_bodies, 2] int32 (start, length)
    prog: torch.Tensor        # soa_np on the device
    spc: torch.Tensor         # [C, E] int32 samples per clock
    interp: torch.Tensor      # [C, E] int32 interpolation


def block_table(soa_np, bid_at, bodies, spc, interp, cfg) -> BlockTable:
    """The block table ``(bid_at [N], bodies)`` of the program ``soa_np
    [C, N, 18]`` on ``spc``'s device, for :func:`exec_blocks`.  Every
    body must lie inside the program and hold no terminator
    (:data:`isa.BLOCK_TERMINATORS`); on CUDA the element geometry is
    held to the kernel's integer range as well."""
    C, N, F = soa_np.shape
    bid_at = np.asarray(bid_at, np.int32)
    body_np = np.asarray(bodies, np.int32).reshape(-1, 2)
    kind = soa_np[..., 0]                     # the 'kind' column
    ok = F == 18 and bid_at.shape == (N,) \
        and int(bid_at.max(initial=-1)) < len(body_np)
    for s, L in body_np:
        ok = ok and 0 <= s and L >= 0 and s + L <= N and not np.isin(
            kind[:, s:s + L], list(isa.BLOCK_TERMINATORS)).any()
    if not ok:
        raise ValueError('exec_blocks kernel: the block table does not fit '
                         f'the program of {N} instructions')
    device = spc.device
    if device.type == 'cuda':
        E = spc.shape[1]
        _check('spc', spc, torch.int32, (C, E), device)
        _check('interp', interp, torch.int32, (C, E), device)
        _check_operands(spc, interp, cfg, False)
    return BlockTable(
        soa_np, tuple(map(tuple, body_np.tolist())),
        torch.as_tensor(bid_at, device=device),
        torch.as_tensor(body_np, device=device),
        torch.as_tensor(np.ascontiguousarray(soa_np, np.int32),
                        device=device), spc, interp)


def exec_blocks(st: dict, table: BlockTable, cfg) -> dict:
    """K1 block: every live lane whose ``pc`` starts a block
    (``table.bid[pc] >= 0``) retires that block's deduplicated body, rows
    ``[start, start + length)`` of ``table.soa_np``.  Injected-bits runs
    only (a body holds no fproc read).  On CUDA the carry ``st`` is
    updated in place and returned; on the CPU the plain version returns
    a new carry."""
    device = st['pc'].device
    if device.type == 'cpu':
        from ..sim.interpreter import _apply_blocks
        return _apply_blocks(st, table, cfg)
    if device.type != 'cuda':
        raise ValueError(f'exec_blocks kernel: unsupported device {device}')
    if cfg.physics:
        raise ValueError('exec_blocks runs injected-bits programs (the '
                         "block engine's physics mode is plain torch)")
    if table.prog.device != device:
        raise ValueError(f'exec_blocks kernel: the block table lies on '
                         f'{table.prog.device}, the carry on {device}')
    B, C = _check_leaves(st, cfg)
    C_p, N, _ = table.soa_np.shape
    if C_p != C:
        raise ValueError(f'exec_blocks kernel: a program of {C_p} cores '
                         f'for a carry of {C}')
    ptrs = [0] * len(LEAVES)
    for k, v in st.items():
        ptrs[LEAVES.index(k)] = v.data_ptr()
    rc = _blocks_fn()(
        (ctypes.c_uint64 * len(LEAVES))(*ptrs), len(LEAVES),
        _param_values(B, C, N, table.spc.shape[1], cfg), len(PARAMS),
        table.prog.data_ptr(), table.spc.data_ptr(),
        table.interp.data_ptr(), table.bid.data_ptr(),
        table.body_tab.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'exec_blocks kernel launch failed: cudaError {rc}')
    exec_blocks.launches += 1
    return st


exec_blocks.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernels' C entry point, built, loaded and typed once."""
    fn = _cuda.load('exec_span').dp_exec_span
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _blocks_fn():
    """The block-mode C entry point, typed once."""
    fn = _cuda.load('exec_span').dp_exec_blocks
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'exec_span kernel: {name} must be a contiguous {dtype} tensor '
            f'of shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} '
            f'on {t.device} (contiguous={t.is_contiguous()})')


def _leaf_shapes(B: int, C: int, cfg) -> dict:
    M, R, P = cfg.max_meas, cfg.max_resets, cfg.max_pulses
    shapes = {k: (B, C) for k in LEAVES}
    shapes.update(regs=(B, C, N_REGS), pp=(B, C, N_PP), rst_time=(B, C, R),
                  meas_avail=(B, C, M), rec=(B, C, N_REC, P),
                  op_hist=(B, C, N_KINDS))
    for k in ('meas_state', 'meas_amp', 'meas_phase', 'meas_freq',
              'meas_env', 'meas_gtime', 'meas_bits', 'meas_valid'):
        shapes[k] = (B, C, M)
    return shapes


def _check_operands(spc, interp, cfg, fused: bool) -> None:
    """The kernel divides with C's truncating ``/`` where the plain
    version floors: the pulse duration ``(nsamp + spc - 1) / spc`` and
    the parity step ``(2 amp + x90) / (2 x90)``.  Both agree exactly when
    the operands are non-negative and nothing overflows int32 — hold
    that here rather than assume it."""
    spc_min, interp_min = int(spc.min()), int(interp.min())
    interp_max, spc_max = int(interp.max()), int(spc.max())
    if spc_min < 1 or interp_min < 0 \
            or _MAX_ENV_LEN * 4 * interp_max + spc_max > 2**31 - 1:
        raise ValueError(
            f'exec_span kernel: element geometry out of range (samples per '
            f'clock {spc_min}..{spc_max} must be >= 1, interpolation '
            f'{interp_min}..{interp_max} >= 0 and small enough for int32 '
            f'pulse lengths)')
    if fused and not 0 <= cfg.x90_amp < 2**30:
        raise ValueError(f'exec_span kernel: x90_amp={cfg.x90_amp} must lie '
                         f'in [0, 2**30)')
    if min(cfg.max_meas, cfg.max_resets, cfg.max_pulses) < 1:
        raise ValueError('exec_span kernel: max_meas, max_resets and '
                         'max_pulses must be >= 1')


def _check_leaves(st: dict, cfg) -> tuple:
    """Hold every leaf of the carry ``st`` to its kernel dtype, shape and
    layout on a CUDA device; returns ``(B, C)``."""
    device = st['pc'].device
    if device.type != 'cuda':
        raise ValueError(f'exec_span kernel: unsupported device {device}')
    unknown = sorted(set(st) - set(LEAVES))
    if unknown:
        raise ValueError(f'exec_span kernel: unknown state leaves {unknown}')
    B, C = st['pc'].shape
    shapes = _leaf_shapes(B, C, cfg)
    for k, v in st.items():
        _check(k, v, torch.bool if k in _BOOL_LEAVES else torch.int32,
               shapes[k], device)
    return B, C


def _launch(st: dict, soa_np, spc, interp, cfg, bits_in=None,
            fused: dict = None) -> dict:
    """Check the operands, allocate the output carry and launch a span
    kernel on the current stream; returns the output carry."""
    device = st['pc'].device
    if fused is not None and 'phys_wait' not in st:
        st = dict(st, phys_wait=torch.zeros(st['pc'].shape, dtype=torch.bool,
                                            device=device))
    B, C = _check_leaves(st, cfg)
    C_p, N, F = soa_np.shape
    if C_p != C or F != 18:
        raise ValueError(f'exec_span kernel: program shape {soa_np.shape} '
                         f'does not fit {C} cores')
    E = spc.shape[1]
    _check('spc', spc, torch.int32, (C, E), device)
    _check('interp', interp, torch.int32, (C, E), device)
    _check_operands(spc, interp, cfg, fused is not None)
    shapes = _leaf_shapes(B, C, cfg)
    ins, outs, out = [0] * len(LEAVES), [0] * len(LEAVES), {}
    for k, v in st.items():
        out[k] = torch.empty_like(v)
        ins[LEAVES.index(k)] = v.data_ptr()
        outs[LEAVES.index(k)] = out[k].data_ptr()
    prog = torch.as_tensor(np.ascontiguousarray(soa_np, np.int32),
                           device=device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    n_addrs = W = Wp = 0
    e2p = g0 = g1 = addrs = None
    amp_scale = 1.0
    if fused is None:
        _check('meas_bits', bits_in, torch.int32, shapes['meas_bits'], device)
    else:
        for k in ('qturns', 'meas_bits', 'meas_valid', 'meas_state'):
            if k not in st:
                raise ValueError(f'exec_span kernel: physics carry lacks {k}')
        e2p = fused['e2p']
        n_addrs, Wp = len(fused['addrs']), e2p.shape[2]
        W = int(fused['w'])
        _check('e2p', e2p, torch.float32, (C, n_addrs, Wp), device)
        if not 0 <= W < Wp:
            raise ValueError(f'exec_span kernel: window {W} exceeds the '
                             f'energy prefix rows ({Wp - 1} samples)')
        g0, g1 = fused['g0'], fused['g1']
        _check('g0', g0, torch.float32, (C, 2), device)
        _check('g1', g1, torch.float32, (C, 2), device)
        addrs = torch.as_tensor(list(fused['addrs']), dtype=torch.int32,
                                device=device)
        amp_scale = float(fused['amp_scale'])
    pvals = _param_values(B, C, N, E, cfg, n_addrs=n_addrs, W=W, Wp=Wp)
    rc = _kernel_fn()(
        (ctypes.c_uint64 * len(LEAVES))(*ins),
        (ctypes.c_uint64 * len(LEAVES))(*outs), len(LEAVES), pvals,
        len(PARAMS), ptr(prog), ptr(spc), ptr(interp), ptr(bits_in),
        ptr(e2p), ptr(g0), ptr(g1), ptr(addrs), amp_scale,
        int(fused is not None), stream)
    if rc != 0:
        raise RuntimeError(f'exec_span kernel launch failed: cudaError {rc}')
    return out


def _param_values(B, C, N, E, cfg, n_addrs=0, W=0, Wp=0):
    """The kernel's scalar parameters, in :data:`PARAMS` order."""
    params = dict(B=B, C=C, N=N, M=cfg.max_meas, R=cfg.max_resets,
                  P=cfg.max_pulses, E=E, meas_elem=cfg.meas_elem,
                  meas_latency=cfg.meas_latency, alu_clks=cfg.alu_instr_clks,
                  jcond_clks=cfg.jump_cond_clks,
                  jfproc_clks=cfg.jump_fproc_clks,
                  regwrite_clks=cfg.pulse_regwrite_clks,
                  load_clks=cfg.pulse_load_clks, x90_amp=cfg.x90_amp,
                  drive_elem=cfg.drive_elem, n_addrs=n_addrs, W=W, Wp=Wp)
    return (ctypes.c_int * len(PARAMS))(*[int(params[k]) for k in PARAMS])
