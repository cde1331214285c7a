"""The statevec device's step as one CUDA launch: the wrapper of
``csrc/statevec.cu``.

:func:`statevec_pulse` runs one generic-engine step's statevec block (the
channel order (1)-(5) of ``sim.interpreter._statevec_pulse``, the co-fire
check and the ``meas_p1`` / ``phys_t`` / ``leaked`` updates) over every
shot of a CUDA state in one launch, counted in
``statevec_pulse.launches`` and in the host counter
``statevec.kernel_steps``.  The engine's ``_step`` picks the path by
:func:`takes_kernel` on the state's device: the kernel on CUDA, the
eager block on any other.  The wrapper raises on a state it does not
take and on any operand the kernel does not take: nothing falls back
from a CUDA state to the eager block.

The caller draws the step's trajectory uniforms once
(``sim.interpreter._statevec_traj_u``) and hands the same tensor to
either path, so on one card the kernel and the eager block read the same
numbers.  The kernel writes a new state and leaves its inputs as they
were.  It replaces no TPU kernel: the JAX package runs this block in
XLA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import counter_inc
from . import _cuda
from .waveform import PHASE_BITS

# sim/device.py STATEVEC_MAX_CORES (not imported: ops stays independent
# of sim)
MAX_CORES = 12

# operands, in the order of csrc/statevec.cu `enum Ptr`, `enum Int` and
# `enum Real`
PTRS = ('psi', 'leaked', 'phys_t', 'meas_p1', 'fire', 'elem', 'pp', 'trig',
        'slot', 'is_meas', 'meas_u', 'traj_u', 'det', 'inv_t1', 'inv_t2',
        'couplings', 'psi_out', 'leaked_out', 'phys_t_out', 'meas_p1_out',
        'state_bit', 'cofire')
INTS = ('B', 'C', 'M', 'Mu', 'NU', 'K', 'drive_elem', 'flags', 'leak_bit')
REALS = ('theta', 'phi', 'depol', 'depol2', 'zx90', 'zz90', 'leak', 'leak2',
         'seep')

# the channel flags of csrc/statevec.cu `enum Flag`, in the order of the
# device model's static facts (DeviceModel.statevec_static, then IQ-level
# leakage readout)
F_DET, F_DECAY, F_DP1, F_DP2, F_LEAK, F_LEAK1, F_LEAK2, F_SEEP, F_LEAK_IQ = \
    (1 << i for i in range(9))

KINDS = {'zx': 0, 'zz': 1}


def statevec_pulse(st: dict, cfg, dm, traj_u, fire, elem, pp, trig, slot,
                   is_meas):
    """The statevec block of one instruction step on a CUDA state, as
    ``sim.interpreter._statevec_pulse`` takes and returns it:
    ``(updates, state_bit, cofire_err)`` with ``updates`` the new ``psi``,
    ``leaked``, ``phys_t`` and ``meas_p1``.  ``st``: the carry; ``dm``:
    the run's device-model parameters; ``traj_u``: the step's trajectory
    uniforms ``[shots, cores, n]``, None where no stochastic channel is
    on; ``fire``, ``elem``, ``pp``, ``trig``, ``slot``, ``is_meas``: the
    step's pulse words per (shot, core)."""
    dev = st['psi'].device
    if not takes_kernel(dev):
        raise ValueError(f'statevec kernel: the state is on {dev}; the '
                         f'kernel takes a CUDA state (any other runs the '
                         f'eager block, sim.interpreter._statevec_pulse)')
    ops = _operands(st, cfg, dm, traj_u, fire, elem, pp, trig, slot,
                    is_meas)
    upd, state_bit, cofire = _launch(ops)
    _cuda.count_launch(statevec_pulse)
    counter_inc('statevec.kernel_steps')
    return upd, state_bit, cofire if ops['K'] else 0


statevec_pulse.launches = 0


def takes_kernel(device) -> bool:
    """The dispatch rule, on the state's device alone: True for a CUDA
    state (one kernel launch a step), False for any other (the eager
    block)."""
    return torch.device(device).type == 'cuda'


def channel_flags(static: tuple) -> tuple:
    """``(flags, leak_bit)`` of ``dm['static']``: the kernel's channel
    flags and the leaked readout bit."""
    (_cps, has_det, has_decay, has_dp1, has_dp2, has_leak, leak_bit,
     has_leak1, has_leak2, has_seep, leak_iq) = static
    flags = sum(f for f, on in ((F_DET, has_det), (F_DECAY, has_decay),
                                (F_DP1, has_dp1), (F_DP2, has_dp2),
                                (F_LEAK, has_leak), (F_LEAK1, has_leak1),
                                (F_LEAK2, has_leak2), (F_SEEP, has_seep),
                                (F_LEAK_IQ, leak_iq)) if on)
    return flags, int(leak_bit)


def coupling_table(couplings: tuple, n_cores: int) -> np.ndarray:
    """The kernel's coupling table from the device model's coupling list
    ``((ctrl_core, freq_word, target_core, 'zx' | 'zz'), ...)``: int32
    ``[K, 4]`` rows ``(ctrl, freq word, target, kind)``, kind 0 for zx
    and 1 for zz.  Raises on an entry that does not fit ``n_cores``."""
    rows = []
    for cp in couplings:
        if len(cp) != 4 or cp[3] not in KINDS:
            raise ValueError(f'statevec kernel: coupling entries are '
                             f'(ctrl, freq_word, target, "zx"|"zz"); got '
                             f'{cp!r}')
        cc, fi, tt, kd = cp
        if not (0 <= int(cc) < n_cores and 0 <= int(tt) < n_cores) \
                or int(cc) == int(tt):
            raise ValueError(f'statevec kernel: coupling {cp!r} does not '
                             f'pair two of the run\'s {n_cores} cores')
        if not -2**31 <= int(fi) < 2**31:
            raise ValueError(f'statevec kernel: coupling {cp!r} has a '
                             f'frequency word outside int32')
        rows.append((int(cc), int(fi), int(tt), KINDS[kd]))
    return np.asarray(rows, np.int32).reshape(len(rows), 4)


@functools.lru_cache(maxsize=64)
def _coupling_tensor(couplings: tuple, n_cores: int, device: str):
    """:func:`coupling_table` on ``device``, moved once per coupling map
    (None for an empty map)."""
    table = coupling_table(couplings, n_cores)
    return torch.as_tensor(table, device=device) if len(table) else None


def _check(name: str, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        got = (f'{t.dtype} {tuple(t.shape)} on {t.device} '
               f'(contiguous={t.is_contiguous()})'
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f'statevec kernel: {name} must be a contiguous '
                         f'{dtype} tensor of shape {tuple(shape)} on '
                         f'{device}; got {got}')


def _operands(st: dict, cfg, dm, traj_u, fire, elem, pp, trig, slot,
              is_meas) -> dict:
    """Check every operand of one launch against what the kernel takes
    and gather them (no device work): raises ValueError on a device,
    dtype, shape, layout, core count or coupling table it does not
    take.  The kernel itself refuses uniforms too few for the model's
    channels."""
    psi = st['psi']
    if not isinstance(fire, torch.Tensor) or fire.ndim != 2:
        raise ValueError('statevec kernel: fire must be a [shots, cores] '
                         'tensor')
    B, C = fire.shape
    if not 1 <= C <= MAX_CORES:
        raise ValueError(f'statevec kernel: n_cores={C} is outside 1..'
                         f'{MAX_CORES} (the [shots, 2^n_cores] state cap)')
    dev = psi.device
    _check('psi', psi, torch.complex64, (B, 1 << C), dev)
    if psi.data_ptr() % 16:
        raise ValueError('statevec kernel: psi must be 16-byte aligned')
    M = cfg.max_meas
    for name, t, dtype, shape in (
            ('leaked', st['leaked'], torch.bool, (B, C)),
            ('phys_t', st['phys_t'], torch.int32, (B, C)),
            ('meas_p1', st['meas_p1'], torch.float32, (B, C, M)),
            ('fire', fire, torch.bool, (B, C)),
            ('elem', elem, torch.int32, (B, C)),
            ('pp', pp, torch.int32, (B, C, 5)),
            ('trig', trig, torch.int32, (B, C)),
            ('slot', slot, torch.int32, (B, C)),
            ('is_meas', is_meas, torch.bool, (B, C)),
            ('det', dm['det'], torch.float32, (C,)),
            ('inv_t1', dm['inv_t1'], torch.float32, (C,)),
            ('inv_t2', dm['inv_t2'], torch.float32, (C,))):
        _check(name, t, dtype, shape, dev)
    meas_u = dm['meas_u']
    if meas_u.ndim != 3 or meas_u.shape[2] < 1:
        raise ValueError(f'statevec kernel: meas_u must be [shots, cores, '
                         f'slots]; got {tuple(meas_u.shape)}')
    _check('meas_u', meas_u, torch.float32, (B, C, meas_u.shape[2]), dev)
    nu = 0
    if traj_u is not None:
        nu = traj_u.shape[-1] if isinstance(traj_u, torch.Tensor) else 0
        _check('traj_u', traj_u, torch.float32, (B, C, nu), dev)
    static = dm['static']
    flags, leak_bit = channel_flags(static)
    cps = _coupling_tensor(tuple(static[0]), C, str(dev))
    return dict(
        psi=psi, leaked=st['leaked'], phys_t=st['phys_t'],
        meas_p1=st['meas_p1'], fire=fire, elem=elem, pp=pp, trig=trig,
        slot=slot, is_meas=is_meas, meas_u=meas_u, traj_u=traj_u,
        det=dm['det'], inv_t1=dm['inv_t1'], inv_t2=dm['inv_t2'],
        couplings=cps, B=B, C=C, M=M, Mu=meas_u.shape[2], NU=nu,
        K=0 if cps is None else cps.shape[0],
        drive_elem=int(cfg.drive_elem), flags=flags, leak_bit=leak_bit,
        theta=(np.pi / 2) / cfg.x90_amp if cfg.x90_amp > 0 else 0.0,
        phi=2 * np.pi / (1 << PHASE_BITS), depol=dm['depol'],
        depol2=dm['depol2'], zx90=dm['zx90'], zz90=dm['zz90'],
        leak=dm['leak'], leak2=dm['leak2'], seep=dm['seep'])


def _launch(ops: dict) -> tuple:
    """Allocate the outputs and launch the kernel on the current stream:
    ``(updates, state_bit, cofire)``."""
    psi = ops['psi']
    dev = psi.device
    B, C = ops['B'], ops['C']
    out = dict(psi_out=torch.empty_like(psi),
               leaked_out=torch.empty_like(ops['leaked']),
               phys_t_out=torch.empty_like(ops['phys_t']),
               meas_p1_out=torch.empty_like(ops['meas_p1']),
               state_bit=torch.empty((B, C), dtype=torch.int32, device=dev),
               cofire=torch.empty((B, C), dtype=torch.int32, device=dev)
               if ops['K'] else None)
    tensors = dict(ops, **out)
    ptrs = [tensors[k].data_ptr() if tensors[k] is not None else 0
            for k in PTRS]
    rc = _kernel_fn()(
        (ctypes.c_uint64 * len(PTRS))(*ptrs), len(PTRS),
        (ctypes.c_int * len(INTS))(*(int(ops[k]) for k in INTS)), len(INTS),
        (ctypes.c_float * len(REALS))(*(float(ops[k]) for k in REALS)),
        len(REALS), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'statevec kernel launch failed: '
                           f'{"cudaError " if rc > 0 else "code "}{rc}')
    # the cached coupling table may have been made on another stream
    if ops['couplings'] is not None:
        ops['couplings'].record_stream(torch.cuda.current_stream(dev))
    return (dict(psi=out['psi_out'], leaked=out['leaked_out'],
                 phys_t=out['phys_t_out'], meas_p1=out['meas_p1_out']),
            out['state_bit'], out['cofire'])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built, loaded and typed once."""
    fn = _cuda.load('statevec').dp_statevec_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
