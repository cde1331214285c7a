"""The megastep kernels K1 (span and block mode) and K3: the CUDA
wrappers.

Counterpart of the JAX package's ``ops/exec_pallas.py`` ``span_call``
with its three bodies, all in ``csrc/exec_span.cu``:

* :func:`exec_span` — K1 span mode (``interpreter._exec_span_pallas``):
  a whole forward-jump-only program over every (shot, core) lane in one
  launch, injected measurement bits, every bit valid, over the program's
  span table checked and moved to the device once per program
  (:func:`span_table`).
* :func:`exec_span_fused` — K3 (``interpreter._exec_span_pallas_fused``):
  the same in physics mode on the parity device; each measurement
  trigger resolves its window's sigma = 0 bit in the kernel, so one
  launch replaces the epoch loop's exec -> resolve round trips.
* :func:`exec_span_physics` — K3 with its readout left to the epoch
  resolver K2: the physics loop's straight-line pass on the parity
  device, one launch an epoch; a measurement trigger latches its window
  and writes no bit, an fproc read whose bit is not valid stalls the
  lane (``phys_wait``) and the next epoch's launch resumes it there.
  It replaces no TPU kernel (the JAX package runs this pass on its XLA
  engines).
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

K1 runs on tiles of consecutive shots x every core, a warp per core's 32
shots, the tile's carry staged in shared memory (:func:`tile_geometry`;
``csrc/exec_span.cu`` "Design"); a tile too wide for shared memory runs
one thread per lane, K3's kernel.

Under the ``'lut'`` fabric the span table carries the syndrome LUT and
the first read index, and the span kernels (K1, K3) split their pass
there, so that every LUT read sees final measurement planes of its
shot's masked cores (``csrc/exec_span.cu`` "The 'lut' fabric"); the
carry holds the ``meas_time`` plane, which the block kernel writes too.
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
          'n_pulses', 'n_resets', 'rst_time', 'n_meas', 'meas_avail',
          'meas_time', 'rec', 'op_hist', 'meas_state', 'meas_amp', 'meas_phase', 'meas_freq',
          'meas_env', 'meas_gtime', 'qturns', 'meas_bits', 'meas_valid',
          'phys_wait')
_BOOL_LEAVES = frozenset(('done', 'meas_valid', 'phys_wait'))
_LEAF_INDEX = {k: i for i, k in enumerate(LEAVES)}
# scalar parameters in the order of csrc/exec_span.cu `enum Param`
PARAMS = ('B', 'C', 'N', 'M', 'R', 'P', 'E', 'meas_elem', 'meas_latency',
          'alu_clks', 'jcond_clks', 'jfproc_clks', 'regwrite_clks',
          'load_clks', 'x90_amp', 'drive_elem', 'n_addrs', 'W', 'Wp',
          'min_read', 'lut_n')

N_REGS, N_PP, N_REC, N_KINDS = 16, 5, 9, 12
# the largest envelope length word a pulse can latch (0xfff is CW)
_MAX_ENV_LEN = 0xffe
# the tile kernel (csrc/exec_span.cu exec_tile_kernel): 32 shots per warp,
# blocks of (at most) 16 warps, the staged scalar columns (pc, time,
# offset, err, fault, n_pulses, n_resets, n_meas, done), the shared memory
# a block may take on the card
TILE_SHOTS, TILE_WARPS = 32, 16
# the one-thread-per-lane kernels' block size (csrc/exec_span.cu THREADS)
_LANE_THREADS = 256
N_SCALARS = 9
SMEM_BUDGET = 227 * 1024


class TileGeometry(NamedTuple):
    """How the tile kernel cuts a ``[B, C]`` carry (:func:`tile_geometry`)."""
    sub: int          # rows of 32 shots per tile
    warps: int        # warps per thread block
    kst: int          # words between the staged columns in shared memory
    pitch: int        # words between the items of a column
    lanes: int        # lanes per tile, sub * 32 * C
    n_tiles: int
    smem: int         # shared memory per block, bytes


def tile_geometry(B: int, C: int, blocks: bool):
    """The tile of the K1 kernels for ``B`` shots x ``C`` cores: ``sub``
    rows of 32 consecutive shots x every core (contiguous in every
    leaf), one (row, core) item per warp, :data:`TILE_WARPS` warps per
    block where the cores fill them (items beyond them looped).  Lane ``t *
    C + c`` of a tile (``t`` its shot there) sits at word ``item * pitch
    + t % 32`` of each staged column, item ``t // 32 * C + c``; the
    columns are ``kst`` words apart.  The pitch, 32 + 32 / C, puts both
    the warp serving an item (32 consecutive words) and the 32
    consecutive lanes that stage them (32 / C shots x C cores) on 32
    distinct banks.  ``None`` when the tile would not fit in
    :data:`SMEM_BUDGET` (the kernel then runs one thread per lane)."""
    sub = max(1, TILE_WARPS // C)
    items = sub * C
    lanes = items * TILE_SHOTS
    pitch = TILE_SHOTS + (TILE_SHOTS // C if 1 < C <= TILE_SHOTS
                          else int(C > TILE_SHOTS))
    kst = items * pitch
    # the lane -> slot map (and block ids), the columns, the duration
    # table (4 words for each of 4 elements per core)
    words = lanes * (2 if blocks else 1) \
        + kst * (N_REGS + N_PP + N_SCALARS) + 16 * C
    if 4 * words > SMEM_BUDGET:
        return None
    return TileGeometry(sub, min(items, TILE_WARPS), kst, pitch, lanes,
                        -(-B // (sub * TILE_SHOTS)), 4 * words)


def exec_span(st: dict, table, meas_bits, cfg) -> dict:
    """K1: one pass of the forward-jump-only program of ``table``
    (:func:`span_table`) over the carry ``st`` with injected
    ``meas_bits [B, C, M]`` int32.  Returns the new carry."""
    device = st['pc'].device
    if device.type == 'cpu':
        from ..sim.interpreter import _exec_straightline
        valid = torch.ones(meas_bits.shape, dtype=torch.bool)
        return _exec_straightline(st, table.soa_np, table.spc, table.interp,
                                  meas_bits, valid, cfg)
    if cfg.physics:
        raise ValueError('exec_span runs injected-bits programs; a physics '
                         'run takes exec_span_fused')
    out = _launch(st, table, cfg, bits_in=meas_bits)
    _cuda.count_launch(exec_span)
    return out


exec_span.launches = 0


def _exec_span_per_lane(st: dict, table, meas_bits, cfg) -> dict:
    """K1 span on the one-thread-per-lane kernel (K3's, and K1's past
    the shared-memory budget) whatever the tile: its comparison with the
    tile kernel on the card.  Counts no launch."""
    return _launch(st, table, cfg, bits_in=meas_bits, per_lane=True)


def exec_span_fused(st: dict, table, bits, valid, cfg, fused: dict):
    """K3: one pass of the program of ``table`` (:func:`span_table`, built
    with ``fused=True``) over the physics carry ``st`` with the
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
        out = _exec_straightline(carry, table.soa_np, table.spc,
                                 table.interp, None, None, cfg, fused=fused)
    else:
        if not cfg.physics or cfg.device != 'parity' or cfg.cw_horizon:
            raise ValueError('exec_span_fused runs physics mode on the '
                             'parity device without CW windows')
        out = _launch(carry, table, cfg, fused=fused)
        _cuda.count_launch(exec_span_fused)
    return out, out.pop('meas_bits'), out.pop('meas_valid')


exec_span_fused.launches = 0


def exec_span_physics(st: dict, table, bits, valid, cfg) -> dict:
    """K3 with its readout left to K2: one straight-line pass of the
    program of ``table`` (:func:`span_table`, built with ``fused=True``)
    over the physics carry ``st`` of the parity device, reading the bits
    ``bits`` int32 / ``valid`` bool ``[B, C, M]`` that the epoch resolver
    wrote, and writing neither.  A measurement trigger latches its window
    (``meas_state``, ``meas_amp``, ``meas_phase``, ``meas_freq``,
    ``meas_env``, ``meas_gtime``), ``meas_avail`` and ``n_meas``; an fproc
    read whose bit is not valid stalls the lane.  Returns the new carry
    with ``phys_wait``, as the plain version
    (:func:`..sim.interpreter._exec_straightline`, taken for a CPU
    carry) does."""
    if not cfg.physics or cfg.device != 'parity' or cfg.cw_horizon:
        raise ValueError('exec_span_physics runs physics mode on the '
                         'parity device without CW windows')
    if st['pc'].device.type == 'cpu':
        from ..sim.interpreter import _exec_straightline
        return _exec_straightline(st, table.soa_np, table.spc, table.interp,
                                  bits, valid, cfg)
    out = _launch(dict(st, meas_bits=bits, meas_valid=valid), table, cfg,
                  physics=True)
    _cuda.count_launch(exec_span_physics)
    del out['meas_bits'], out['meas_valid']
    return out


exec_span_physics.launches = 0


class SpanTable(NamedTuple):
    """A program as the span kernels read it, checked and moved to the
    run's device once per program content (:func:`span_table`)."""
    soa_np: np.ndarray        # [C, N, 18] packed program rows
    prog: torch.Tensor        # soa_np on the device
    spc: torch.Tensor         # [C, E] int32 samples per clock
    interp: torch.Tensor      # [C, E] int32 interpolation
    # the 'lut' fabric (None under the sticky fabric): int32 [C + T], each
    # core's address shift (-1: not in the mask), then the T-entry table
    lut: torch.Tensor = None
    min_read: int = 0         # the first fproc read index (N: none)


def span_table(soa_np, spc, interp, cfg, device, fused: bool = False) \
        -> SpanTable:
    """The program ``soa_np [C, N, 18]`` with its element geometry
    ``spc``/``interp`` (``[C, E]`` int32 numpy arrays) on ``device``, for
    :func:`exec_span` (and, ``fused``, :func:`exec_span_fused`).  The
    operands are held to the kernels' integer range here, on the host
    (:func:`_check_operands`), and the table is cached on the program's
    content, its geometry, the device and the bounds the checks read: a
    launch then copies nothing to the device and reads nothing back."""
    soa_np = np.ascontiguousarray(soa_np, np.int32)
    spc = np.ascontiguousarray(spc, np.int32)
    interp = np.ascontiguousarray(interp, np.int32)
    lut = (tuple(bool(b) for b in cfg.lut_mask),
           tuple(int(e) for e in cfg.lut_table)) \
        if cfg.fabric == 'lut' else None
    bounds = (cfg.max_meas, cfg.max_resets, cfg.max_pulses,
              cfg.x90_amp if fused else None, lut)
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        # 'cuda' and 'cuda:<current>' are one table
        device = torch.device('cuda', torch.cuda.current_device())
    return _span_table_of(soa_np.shape, soa_np.tobytes(), spc.shape,
                          spc.tobytes(), interp.tobytes(), str(device),
                          bounds)


# a run holds its table; the cache keeps the few programs a caller
# alternates between
@functools.lru_cache(maxsize=8)
def _span_table_of(shape, content, geo_shape, spc_bytes, interp_bytes,
                   device, bounds) -> SpanTable:
    soa_np = np.frombuffer(content, np.int32).reshape(shape).copy()
    spc = np.frombuffer(spc_bytes, np.int32).reshape(geo_shape).copy()
    interp = np.frombuffer(interp_bytes, np.int32).reshape(geo_shape).copy()
    C, N, F = shape
    if F != 18 or geo_shape[0] != C:
        raise ValueError(f'exec_span kernel: program shape {shape} and '
                         f'element geometry {geo_shape} do not fit')
    max_meas, max_resets, max_pulses, x90_amp, lut = bounds
    _check_operands(spc, interp, max_meas, max_resets, max_pulses, x90_amp)
    lut_t, min_read = None, N
    if lut is not None:
        lut_t, min_read = _lut_operand(soa_np, *lut)
        lut_t = torch.as_tensor(lut_t, device=device)
    return SpanTable(soa_np, torch.as_tensor(soa_np, device=device),
                     torch.as_tensor(spc, device=device),
                     torch.as_tensor(interp, device=device), lut_t, min_read)


def _lut_operand(soa_np, mask, table) -> tuple:
    """The kernels' LUT operand of a ``'lut'``-fabric program: int32 ``[C
    + T]`` (each core's address shift, -1 where the core is not in the
    mask, then the ``T`` table entries as int32 bit patterns) and the
    first fproc read index of ``soa_np [C, N, 18]`` (``N``: none)."""
    C = soa_np.shape[0]
    mask = np.asarray(mask, bool)
    if mask.shape != (C,) or len(table) != 1 << int(mask.sum()):
        raise ValueError(f'exec_span kernel: a LUT of {len(table)} entries '
                         f'over a mask of {mask.shape} does not fit {C} '
                         f'cores (2^k entries for k masked cores)')
    shifts = np.full(C, -1, np.int64)
    shifts[mask] = np.arange(int(mask.sum()))
    entries = np.asarray(table, np.int64).astype(np.uint32).view(np.int32)
    kind = soa_np[..., 0]
    fmask = (kind == isa.K_ALU_FPROC) | (kind == isa.K_JUMP_FPROC)
    return np.concatenate([shifts.astype(np.int32), entries]), \
        lut_min_read(fmask)


def lut_min_read(fmask) -> int:
    """The first program index holding an fproc read on any core
    (``fmask [C, N]`` bool), or ``N`` when none does: under the ``'lut'``
    fabric the span kernels retire every index below it on every core
    before any LUT read."""
    cols = np.nonzero(np.any(fmask, axis=0))[0]
    return int(cols[0]) if len(cols) else int(fmask.shape[1])


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
        _check_operands(spc.cpu().numpy(), interp.cpu().numpy(),
                        cfg.max_meas, cfg.max_resets, cfg.max_pulses)
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
    updated in place and returned; on the CPU the plain version returns a
    new carry."""
    device = st['pc'].device
    if device.type == 'cpu':
        from ..sim.interpreter import _apply_blocks
        return _apply_blocks(st, table, cfg)
    _launch_blocks(st, table, cfg)
    _cuda.count_launch(exec_blocks)
    return st


exec_blocks.launches = 0


def _exec_blocks_per_lane(st: dict, table: BlockTable, cfg) -> dict:
    """K1 block on the one-thread-per-lane kernel whatever the tile, as
    :func:`_exec_span_per_lane`.  Counts no launch."""
    _launch_blocks(st, table, cfg, per_lane=True)
    return st


def _launch_blocks(st: dict, table: BlockTable, cfg,
                   per_lane: bool = False) -> None:
    """Check the carry and launch the block kernel on the current
    stream, in place."""
    device = st['pc'].device
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
        ptrs[_LEAF_INDEX[k]] = v.data_ptr()
    rc = _blocks_fn()(
        (ctypes.c_uint64 * len(LEAVES))(*ptrs), len(LEAVES),
        _param_values(B, C, N, table.spc.shape[1], cfg, min_read=N),
        len(PARAMS),
        table.prog.data_ptr(), table.spc.data_ptr(),
        table.interp.data_ptr(), table.bid.data_ptr(),
        table.body_tab.data_ptr(), _tile_arg(B, C, True, per_lane),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'exec_blocks kernel launch failed: cudaError {rc}')


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernels' C entry point, built, loaded and typed once."""
    fn = _cuda.load('exec_span').dp_exec_span
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _blocks_fn():
    """The block-mode C entry point, typed once."""
    fn = _cuda.load('exec_span').dp_exec_blocks
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 7)
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
    return _shapes_of(B, C, cfg.max_meas, cfg.max_resets, cfg.max_pulses)


@functools.lru_cache(maxsize=64)
def _shapes_of(B: int, C: int, M: int, R: int, P: int) -> dict:
    shapes = {k: (B, C) for k in LEAVES}
    shapes.update(regs=(B, C, N_REGS), pp=(B, C, N_PP), rst_time=(B, C, R),
                  meas_avail=(B, C, M), meas_time=(B, C, M),
                  rec=(B, C, N_REC, P),
                  op_hist=(B, C, N_KINDS))
    for k in ('meas_state', 'meas_amp', 'meas_phase', 'meas_freq',
              'meas_env', 'meas_gtime', 'meas_bits', 'meas_valid'):
        shapes[k] = (B, C, M)
    return shapes


def _check_operands(spc, interp, max_meas, max_resets, max_pulses,
                    x90_amp=None) -> None:
    """The kernel divides with C's truncating ``/`` where the plain
    version floors: the pulse duration ``(nsamp + spc - 1) / spc`` and
    the parity step ``(2 amp + x90) / (2 x90)``.  Both agree exactly when
    the operands are non-negative and nothing overflows int32 — hold
    that here rather than assume it.  ``spc``/``interp``: numpy arrays;
    ``x90_amp``: K3's (None for K1)."""
    spc_min, interp_min = int(spc.min()), int(interp.min())
    interp_max, spc_max = int(interp.max()), int(spc.max())
    if spc_min < 1 or interp_min < 0 \
            or _MAX_ENV_LEN * 4 * interp_max + spc_max > 2**31 - 1:
        raise ValueError(
            f'exec_span kernel: element geometry out of range (samples per '
            f'clock {spc_min}..{spc_max} must be >= 1, interpolation '
            f'{interp_min}..{interp_max} >= 0 and small enough for int32 '
            f'pulse lengths)')
    if x90_amp is not None and not 0 <= x90_amp < 2**30:
        raise ValueError(f'exec_span kernel: x90_amp={x90_amp} must lie '
                         f'in [0, 2**30)')
    if min(max_meas, max_resets, max_pulses) < 1:
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
    index = st['pc'].get_device()
    for k, v in st.items():
        dtype = torch.bool if k in _BOOL_LEAVES else torch.int32
        # the cheap tests first: this runs once per launch
        if v.dtype is not dtype or v.shape != shapes[k] \
                or v.get_device() != index or not v.is_contiguous():
            _check(k, v, dtype, shapes[k], device)
    return B, C


@functools.lru_cache(maxsize=64)
def _tile_arg(B: int, C: int, blocks: bool, per_lane: bool = False):
    """The kernels' tile argument: the tile's ``(sub, warps, kst,
    pitch)``, or zeros for one thread per lane (``per_lane``, or a tile
    that would not fit in shared memory).  Cached: a launch takes it from
    the cache."""
    geom = None if per_lane else tile_geometry(B, C, blocks)
    return (ctypes.c_int * 4)(*(geom[:4] if geom else (0, 0, 0, 0)))


def _launch(st: dict, table: SpanTable, cfg, bits_in=None,
            fused: dict = None, physics: bool = False,
            per_lane: bool = False) -> dict:
    """Check the carry, allocate the output carry and launch a span
    kernel on the current stream; returns the output carry.  ``fused``:
    K3's readout; ``physics``: K3 with its readout left to K2, whose
    output carry holds the input's ``meas_bits`` and ``meas_valid``
    tensors (read in place).  Host work only: the table's checks ran when
    it was built."""
    device = st['pc'].device
    phys = fused is not None or physics
    if phys and 'phys_wait' not in st:
        st = dict(st, phys_wait=torch.zeros(st['pc'].shape, dtype=torch.bool,
                                            device=device))
    B, C = _check_leaves(st, cfg)
    C_p, N, _ = table.soa_np.shape
    if C_p != C:
        raise ValueError(f'exec_span kernel: program shape '
                         f'{table.soa_np.shape} does not fit {C} cores')
    if table.prog.device != device:
        raise ValueError(f'exec_span kernel: the span table lies on '
                         f'{table.prog.device}, the carry on {device}')
    E = table.spc.shape[1]
    shapes = _leaf_shapes(B, C, cfg)
    ins, outs, out = [0] * len(LEAVES), [0] * len(LEAVES), {}
    for k, v in st.items():
        out[k] = v if physics and k in ('meas_bits', 'meas_valid') \
            else torch.empty_like(v)
        ins[_LEAF_INDEX[k]] = v.data_ptr()
        outs[_LEAF_INDEX[k]] = out[k].data_ptr()
    ptr = lambda t: t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    n_addrs = W = Wp = 0
    e2p = g0 = g1 = addrs = None
    amp_scale = 1.0
    if not phys:
        _check('meas_bits', bits_in, torch.int32, shapes['meas_bits'], device)
    else:
        for k in ('qturns', 'meas_bits', 'meas_valid', 'meas_state'):
            if k not in st:
                raise ValueError(f'exec_span kernel: physics carry lacks {k}')
    if fused is not None:
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
    if (table.lut is not None) != (cfg.fabric == 'lut') \
            or (table.lut is not None and 'meas_time' not in st):
        raise ValueError(f"exec_span kernel: a run of fabric "
                         f"{cfg.fabric!r} needs a span table built for it "
                         f"and, under 'lut', the meas_time plane")
    if table.lut is not None and table.min_read < N and C > _LANE_THREADS \
            and (per_lane or phys or tile_geometry(B, C, False) is None):
        raise ValueError(f'exec_span kernel: a LUT read over {C} cores '
                         f'needs whole shots in one block of at most '
                         f'{_LANE_THREADS} threads')
    tile = _tile_arg(B, C, False, per_lane or phys)
    pvals = _param_values(B, C, N, E, cfg, n_addrs=n_addrs, W=W, Wp=Wp,
                          min_read=table.min_read,
                          lut_n=len(cfg.lut_table) if table.lut is not None
                          else 0)
    rc = _kernel_fn()(
        (ctypes.c_uint64 * len(LEAVES))(*ins),
        (ctypes.c_uint64 * len(LEAVES))(*outs), len(LEAVES), pvals,
        len(PARAMS), ptr(table.prog), ptr(table.spc), ptr(table.interp),
        ptr(bits_in), ptr(e2p), ptr(g0), ptr(g1), ptr(addrs), ptr(table.lut),
        amp_scale, 1 if fused is not None else 2 if physics else 0, tile,
        stream)
    if rc != 0:
        raise RuntimeError(f'exec_span kernel launch failed: cudaError {rc}')
    # the cached table may have been made on another stream (the serving
    # tier gives each executor its own): keep its memory from being
    # reused before this stream's launch has read it
    cur = torch.cuda.current_stream(device)
    for t in (table.prog, table.spc, table.interp, table.lut):
        if t is not None:
            t.record_stream(cur)
    return out


def _param_values(B, C, N, E, cfg, n_addrs=0, W=0, Wp=0, min_read=0,
                  lut_n=0):
    """The kernel's scalar parameters, in :data:`PARAMS` order."""
    return _params_of((B, C, N, cfg.max_meas, cfg.max_resets,
                       cfg.max_pulses, E, cfg.meas_elem, cfg.meas_latency,
                       cfg.alu_instr_clks, cfg.jump_cond_clks,
                       cfg.jump_fproc_clks, cfg.pulse_regwrite_clks,
                       cfg.pulse_load_clks, cfg.x90_amp, cfg.drive_elem,
                       n_addrs, W, Wp, min_read, lut_n))


@functools.lru_cache(maxsize=64)
def _params_of(values: tuple):
    """The parameter array of ``values`` (read only by the kernels)."""
    return (ctypes.c_int * len(PARAMS))(*map(int, values))
