"""Kernel parity self-test, shared by ``chip_smoke.py`` and the
``cuda``-marked tests so that both run the same assertions.

The counterpart of the JAX package's ``ops/selftest.py``
(``pallas_parity_check(interpret)``), on the JAX package's own inputs
and tolerances.  On ``'cuda'`` each check holds a hand kernel against
its plain torch version on the same card: K5 (``csrc/demod.cu``,
:func:`.demod.demod_iq`) against :func:`.demod.demod_iq_reference`, K4
(``csrc/waveform.cu``, :func:`.waveform.synthesize_element`) against
:func:`.waveform.synthesize_element_reference`, and K1 span, K1 block
and K3 (``csrc/exec_span.cu``: ``engine='pallas'`` and
``engine='fused'``) against the generic engine, K3's physics pass
with its readout left to K2 (:func:`.exec_span.exec_span_physics`)
against its plain version, the straight-line engine's eager pass, pass
by pass on the same card, and the statevec step (``csrc/statevec.cu``,
:func:`.statevec.statevec_pulse`) against the eager statevec block on
one step with every channel on.  On ``'cpu'`` both sides are plain, so
tier-1 runs the checks themselves.  The device is the caller's: with
none named it is the card, and the check raises when there is no card
rather than running on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..elements import ENV_CW_SENTINEL
from .demod import demod_iq, demod_iq_reference
from .exec_span import exec_span_physics
from .statevec import statevec_pulse
from .waveform import synthesize_element, synthesize_element_reference


def _device(device) -> torch.device:
    # deferred import: ops stays import-time independent of sim
    # (sim.physics imports ops)
    from ..sim.interpreter import torch_device
    return torch_device(device)


def check_demod_parity(device=None) -> None:
    """K5 against the plain product on ``device``; raises on
    mismatch."""
    d = _device(device)
    rng = np.random.default_rng(0)
    adc = torch.as_tensor(rng.standard_normal((1000, 1024))
                          .astype(np.float32), device=d)
    w = torch.as_tensor(rng.standard_normal((1024, 8)).astype(np.float32),
                        device=d)
    got = demod_iq(adc, w).cpu().numpy()
    want = demod_iq_reference(adc, w).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def waveform_inputs() -> tuple:
    """The JAX check's pulse table (four records, one CW, one unused)
    and its complex envelope memory: ``(rec, env)``."""
    rng = np.random.default_rng(1)
    env = (rng.standard_normal(256) + 1j * rng.standard_normal(256)) * 0.5
    rec = {
        'gtime': np.asarray([4, 40, 90, 0], np.int32),
        'env': np.asarray([(32 << 12) | 0, (48 << 12) | 16,
                           (ENV_CW_SENTINEL << 12) | 8, 0], np.int32),
        'phase': np.asarray([0, 1 << 15, 1 << 14, 0], np.int32),
        'freq_rel': np.asarray([0.1, 0.23, 0.05, 0], np.float32),
        'amp': np.asarray([0xffff, 0x8000, 0x4000, 0], np.int32),
        'elem': np.asarray([0, 0, 0, 0], np.int32),
        'n_pulses': np.int32(3),
    }
    return rec, env


WAVEFORM_GEOMETRY = dict(spc=4, interp=1, n_clks=128)


def check_waveform_parity(device=None) -> None:
    """K4 against the plain render on ``device``; raises on
    mismatch."""
    d = _device(device)
    rec, env = waveform_inputs()
    got = synthesize_element(rec, env, device=d, **WAVEFORM_GEOMETRY)
    want = synthesize_element_reference(rec, env, device=d,
                                        **WAVEFORM_GEOMETRY)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


def exec_programs() -> tuple:
    """The JAX check's two injected-bits programs, as per-core command
    lists: a forward-only span (K1 span) and a counted loop (K1
    block)."""
    from .. import isa
    span = [[isa.pulse_cmd(amp_word=1000, cfg_word=0,
                           env_word=(8 << 12) | 3, cmd_time=10),
             isa.alu_cmd('reg_alu', 'i', 5, 'add', alu_in1=1,
                         write_reg_addr=1),
             isa.pulse_cmd(amp_word=2000, cfg_word=2,
                           env_word=(4 << 12) | 1, cmd_time=40),
             isa.done_cmd()]]
    loop = [[isa.alu_cmd('reg_alu', 'i', 0, 'add', write_reg_addr=2),
             isa.pulse_cmd(amp_word=500, cfg_word=1,
                           env_word=(4 << 12) | 2, cmd_time=12),
             isa.alu_cmd('reg_alu', 'i', 1, 'add', alu_in1=2,
                         write_reg_addr=2),
             isa.alu_cmd('jump_cond', 'i', 3, 'ge', alu_in1=2,
                         jump_cmd_ptr=1),
             isa.done_cmd()]]
    return span, loop


def _assert_equal(got: dict, want: dict, skip: tuple) -> None:
    for k in want:
        if k in skip:
            continue
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(), err_msg=k)


def check_exec_parity(device=None) -> None:
    """K1 span, K1 block and K3 against the generic engine on
    ``device``; raises on mismatch.

    Exact int32 equality on every output but ``steps`` for the span
    program and the counted loop under ``engine='pallas'``; then the
    fused measurement path: ``active_reset`` on 2 qubits at sigma = 0
    under ``engine='fused'``, exact on every output but ``steps`` and
    ``epochs`` (the loop-structure counters the fusion exists to
    change), with ``epochs == 1``."""
    from ..decoder import machine_program_from_cmds
    from ..models.experiments import active_reset
    from ..sim.interpreter import InterpreterConfig, simulate_batch
    from ..sim.physics import ReadoutPhysics, run_physics_batch
    from ..simulator import Simulator
    d = _device(device)
    rng = np.random.default_rng(2)
    for cmds in exec_programs():
        mp = machine_program_from_cmds(cmds)
        kw = dict(max_steps=2 * mp.n_instr + 64, max_pulses=8,
                  max_meas=2, max_resets=2)
        bits = rng.integers(0, 2, size=(4, mp.n_cores, 2))
        want = simulate_batch(mp, bits, device=d, cfg=InterpreterConfig(
            engine='generic', **kw))
        got = simulate_batch(mp, bits, device=d, cfg=InterpreterConfig(
            engine='pallas', **kw))
        _assert_equal(got, want, ('steps',))
    mpf = Simulator(n_qubits=2, device=d).compile(active_reset(['Q0', 'Q1']))
    init = rng.integers(0, 2, (4, mpf.n_cores)).astype(np.int32)
    kwf = dict(init_states=init, max_steps=mpf.n_instr * 4 + 64,
               max_pulses=16, max_meas=4, device=d)
    want = run_physics_batch(mpf, ReadoutPhysics(sigma=0.0), 3, 4,
                             engine='generic', **kwf)
    got = run_physics_batch(mpf, ReadoutPhysics(sigma=0.0), 3, 4,
                            engine='fused', **kwf)
    _assert_equal(got, want, ('steps', 'epochs'))
    assert int(got['epochs']) == 1, \
        'fused engine did not collapse the epoch loop'
    check_physics_pass_parity(d)


def check_physics_pass_parity(device=None) -> None:
    """K3's physics pass with its readout left to K2 against the
    straight-line engine's eager pass on ``device``: ``active_reset`` on 2
    qubits, a first pass from the initial carry that stalls every lane at
    its reset read (``phys_wait``), then, with every fired window's bit
    set and valid, the resumed pass that retires the program.  Exact on
    every leaf of both passes; raises on mismatch."""
    from ..models.experiments import active_reset
    from ..sim.interpreter import (InterpreterConfig, _exec_straightline,
                                   _init_state, _span_table)
    from ..simulator import Simulator
    d = _device(device)
    rng = np.random.default_rng(3)
    mp = Simulator(n_qubits=2, device=d).compile(active_reset(['Q0', 'Q1']))
    cfg = InterpreterConfig(physics=True, max_steps=mp.n_instr * 4 + 64,
                            max_pulses=16, max_meas=4, x90_amp=31457)
    B, C, M = 5, mp.n_cores, cfg.max_meas
    st = _init_state(B, C, cfg, None, d)
    st['qturns'] = 2 * torch.as_tensor(rng.integers(0, 2, (B, C)),
                                       dtype=torch.int32, device=d)
    table = _span_table(mp, cfg, d, fused=True)
    bits = torch.zeros((B, C, M), dtype=torch.int32, device=d)
    valid = torch.zeros((B, C, M), dtype=torch.bool, device=d)
    want = st
    for n in range(2):
        got = exec_span_physics(want, table, bits, valid, cfg)
        want = _exec_straightline(want, table.soa_np, table.spc,
                                  table.interp, bits, valid, cfg)
        _assert_equal(got, want, ())
        assert set(got) == set(want)
        stalled = bool(want['phys_wait'].any())
        assert stalled == (n == 0), 'the reset read did not stall, then ' \
            'resume'
        fired = torch.arange(M, device=d)[None, None] \
            < want['n_meas'][..., None]
        bits = torch.where(fired & ~valid, torch.as_tensor(
            rng.integers(0, 2, (B, C, M)), dtype=torch.int32, device=d),
            bits)
        valid = valid | fired
    assert bool(want['done'].all()), 'the resumed pass did not retire'


# the statevec device's channels, as statevec_step_inputs names them
STATEVEC_CHANNELS = ('det', 'decay', 'dp1', 'dp2', 'zx', 'zz', 'leak1',
                     'leak2', 'seep', 'iq')


def statevec_step_inputs(B: int, C: int, device, seed: int = 0,
                         channels=STATEVEC_CHANNELS, fire_p: float = 0.6,
                         M: int = 2) -> tuple:
    """One statevec step's operands, drawn from ``seed``: ``(st, cfg, dm,
    args)``, ``args`` the step's ``(fire, elem, pp, trig, slot,
    is_meas)``, as ``sim.interpreter._step`` hands them to the statevec
    block.  A random normalised ``[B, 2^C]`` state; each core fires with
    probability ``fire_p``, a drive (element 0), a readout (element 2) or
    another element; triggers two clocks apart at most, so equal-time
    pulses co-fire; a chain of couplings over the cores plus one from the
    last core back to core 0, zx and zz in turn among those of
    ``channels``, whose frequency words the drives hit at random; rates
    large enough that every channel of ``channels`` acts in a good share
    of the shots.  ``'seep'`` and ``'iq'`` bring ``'leak1'`` with them
    (nothing leaks without it)."""
    from ..sim.device import DeviceModel
    from ..sim.interpreter import InterpreterConfig
    from ..sim.physics import X90_AMP_DEFAULT
    d = _device(device)
    rng = np.random.default_rng(seed)
    on = set(channels)
    if on & {'seep', 'iq'}:
        on.add('leak1')
    kinds = [k for k in ('zx', 'zz') if k in on]
    pairs = [(c, c + 1) for c in range(C - 1)] + \
        ([(C - 1, 0)] if C > 2 else [])
    cps = tuple((c, 1 + i % 3, t, kinds[i % len(kinds)])
                for i, (c, t) in enumerate(pairs)) if kinds else ()
    leaks = bool(on & {'leak1', 'leak2'})
    model = DeviceModel(
        'statevec', couplings=cps,
        detuning_hz=1e6 if 'det' in on else 0.0,
        t1_s=20e-6 if 'decay' in on else math.inf,
        t2_s=15e-6 if 'decay' in on else math.inf,
        depol_per_pulse=0.3 if 'dp1' in on else 0.0,
        depol2_per_pulse=0.3 if 'dp2' in on else 0.0,
        leak_per_pulse=0.2 if 'leak1' in on else 0.0,
        leak2_per_pulse=0.2 if 'leak2' in on else 0.0,
        seep_per_pulse=0.5 if 'seep' in on else 0.0)
    f32 = np.float32
    det, it1, it2 = model.per_clock_rates(C)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=d)

    dm = dict(det=t(det), inv_t1=t(it1), inv_t2=t(it2),
              depol=float(f32(model.depol_per_pulse)),
              keep=float(f32(1.0) - f32(model.depol_per_pulse)),
              meas_u=t(rng.random((B, C, M)), torch.float32),
              depol2=float(f32(model.depol2_per_pulse)),
              zx90=float(f32(model.zx90_amp)),
              zz90=float(f32(model.zz90_amp)),
              leak=float(f32(model.leak_per_pulse)),
              leak2=float(f32(model.leak2_per_pulse)),
              seep=float(f32(model.seep_per_pulse)), traj_seed=seed,
              static=model.statevec_static() + ('iq' in on,))
    psi = rng.standard_normal((B, 1 << C)) \
        + 1j * rng.standard_normal((B, 1 << C))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    st = dict(psi=t(psi, torch.complex64),
              leaked=t(rng.random((B, C)) < (0.25 if leaks else 0.0)),
              phys_t=t(rng.integers(0, 4000, (B, C)), torch.int32),
              meas_p1=t(rng.random((B, C, M)), torch.float32))
    fire = rng.random((B, C)) < fire_p
    elem = rng.choice([0, 0, 0, 2, 1], (B, C))
    words = [cp[1] for cp in cps] + [0, 7]
    pp = np.stack([rng.integers(0, 1 << 20, (B, C)),
                   rng.choice([0, 1 << 15, 1 << 16, 3 << 15, 12345, 70001],
                              (B, C)),
                   rng.choice(words, (B, C)),
                   np.where(rng.random((B, C)) < 0.1, 0,
                            rng.integers(1, 40000, (B, C))),
                   elem], -1)
    args = (t(fire), t(elem, torch.int32), t(pp, torch.int32),
            t(4000 + rng.integers(0, 2, (B, C)), torch.int32),
            t(rng.integers(0, M, (B, C)), torch.int32),
            t(fire & (elem == 2)))
    cfg = InterpreterConfig(physics=True, device='statevec', max_meas=M,
                            x90_amp=X90_AMP_DEFAULT, drive_elem=0,
                            meas_elem=2)
    return st, cfg, dm, args


def statevec_step_diff(got: tuple, want: tuple, atol: float = 2e-5):
    """Two results ``(updates, state_bit, cofire)`` of one statevec step
    held to each other: ``phys_t`` and the co-fire word (no uniform
    decides them) equal everywhere; on every shot whose state bits and
    leaked flags agree, the amplitudes and ``meas_p1`` within ``atol``
    (float32 sums taken in another order).  Returns the shots whose bits
    or leaked flags differ (a decision can flip only where a uniform lies
    within rounding of its threshold), as a list of ints; raises on any
    other mismatch."""
    (gu, gb, gc), (wu, wb, wc) = got, want
    assert torch.equal(gu['phys_t'].cpu(), wu['phys_t'].cpu()), 'phys_t'
    if isinstance(wc, torch.Tensor) or isinstance(gc, torch.Tensor):
        assert torch.equal(gc.cpu(), wc.cpu()), 'co-fire word'
    else:
        assert gc == wc == 0, 'co-fire word'
    differ = ((gb.cpu() != wb.cpu())
              | (gu['leaked'].cpu() != wu['leaked'].cpu())).any(1)
    for k in ('psi', 'meas_p1'):
        err = (gu[k].cpu()[~differ] - wu[k].cpu()[~differ]).abs()
        worst = float(err.max()) if err.numel() else 0.0
        assert worst <= atol, f'{k}: max |kernel - eager| {worst}'
    return [int(i) for i in torch.nonzero(differ).flatten()]


def check_statevec_parity(device=None) -> None:
    """The statevec step (``csrc/statevec.cu``,
    :func:`.statevec.statevec_pulse`) against its plain version, the
    eager statevec block (``sim.interpreter._statevec_pulse``), on
    ``device``: one step of 64 shots on 4 cores with every channel on and
    both coupling kinds, from the same state and the same uniforms (one
    draw of the step's trajectory uniforms, handed to both).  Every
    output as :func:`statevec_step_diff` holds it, and no shot's
    decision may differ (at 64 shots a threshold within float32 rounding
    of its uniform has a chance near 1e-4); raises on mismatch.  On
    ``'cpu'`` the eager block runs on both sides."""
    from ..sim.interpreter import _statevec_pulse, _statevec_traj_u
    d = _device(device)
    st, cfg, dm, args = statevec_step_inputs(64, 4, d, seed=5)
    traj_u = _statevec_traj_u(dm, 3, 64, 4, d)
    assert tuple(traj_u.shape) == (64, 4, 8)
    pulse = statevec_pulse if d.type == 'cuda' else _statevec_pulse
    got = pulse(st, cfg, dm, traj_u, *args)
    want = _statevec_pulse(st, cfg, dm, traj_u, *args)
    differ = statevec_step_diff(got, want)
    assert not differ, f'statevec step: shots {differ} decided otherwise'
    assert bool(want[0]['leaked'].any()) and bool((want[1] == 2).any()), \
        'the step did not exercise leakage and its IQ-level readout'


def kernel_parity_check(device=None) -> None:
    """Run every kernel parity check on ``device`` (default: the card,
    raising without one); raises AssertionError on mismatch.  The
    counterpart of the JAX package's ``pallas_parity_check``."""
    check_demod_parity(device)
    check_waveform_parity(device)
    check_exec_parity(device)
    check_statevec_parity(device)
