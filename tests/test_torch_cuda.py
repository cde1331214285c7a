"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with the CUDA toolkit, and skip elsewhere; run
them on the card with::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py configures JAX, which the card's
host does not have.)  The kernel ``csrc/resolve.cu`` is held against
its plain torch version on the same inputs (rtol 1e-5, atol 1e-5 *
max|energy|: the kernel reads float64 prefix sums of the deterministic
chain and sums the noise projection in its own order, the plain version
sums chunk by chunk), on the program's tables and on seeded ones with
four static rows and two or four frequencies; with AR(1) noise on the
same streamed whites (rtol 1e-4, atol 1e-3 * max|energy|: the kernel's
warp scan against the plain version's triangular product) and, on its
own draws, the noise projection's variance against the closed form; and
the physics loop on the card against the same loop on the CPU (identical
bits at sigma = 0) for the parity, Bloch and statevec devices.  The
megastep kernels of ``csrc/exec_span.cu`` are held exactly: K1 against the straight-line
engine on the card, K3 against its plain version and against the
generic engine, K1 block (``engine='pallas'`` on a looping program)
against the block engine's plain bodies, and under the ``'lut'`` fabric
K1 span (tile and one thread per lane, on random LUT programs at 3, 5
and 9 cores and batches that cut tiles and blocks raggedly), K1 block
(multi-round QEC) and K3 (the compiled repetition round at 3 and 9
qubits) against theirs; ``simulate_rounds`` (one K1 span launch for all
R x B lanes, and one K1 block launch per iteration on a looping
program) and ``simulate_multi_batch`` against the same calls on the
CPU; the port's kernel self-test (``ops/selftest.py``,
``kernel_parity_check('cuda')``) and the fault-injection harness with
K1 as a fourth engine and K3 in its fused check.  The waveform kernel
``csrc/waveform.cu`` (one launch renders every trace of a shot) is held
against its plain version to atol 1e-5 (the same arithmetic;
``sincosf`` against ``sin`` and ``cos``), the
demod kernel ``csrc/demod.cu`` to rtol 2e-5 / atol 2e-4 (float32 sums
of 1024 products of magnitude ~1 taken in another order than
``torch.matmul``).  This file imports nothing of JAX; its
straight-line and branchy fuzz generators serve
tests/test_torch_straightline.py and tests/test_torch_blocks.py too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    make_default_qchip, active_reset, rb_program)
from distributed_processor_tpu_torch.ops.resolve import (
    resolve_windows_fused, resolve_windows_reference)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, prepare_physics_tables, run_physics_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the card)')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def program():
    qubits = ['Q0', 'Q1', 'Q2']
    return compile_to_machine(active_reset(qubits)
                              + rb_program(qubits, 3, seed=7),
                              make_default_qchip(3), n_qubits=3)


def sl_feedback_program(rng, isa, from_cmds, n_cores=3, n_instr=24):
    """Random straight-line programs that exercise everything the span
    engines serve: measurement pulses (element 2), own-core fproc reads
    and forward fproc branches on them, forward conditional and
    unconditional jumps (sometimes past the end), qclk loads, resets,
    idles, register-sourced pulse parameters and rare out-of-ISA kinds.
    ``isa``/``from_cmds``: the encoder module and
    ``machine_program_from_cmds`` of either package."""
    kinds = ['alu'] * 2 + ['pulse'] * 4 + ['reg_pulse', 'read', 'branch',
                                           'jump', 'qclk', 'idle']
    progs = []
    for core in range(n_cores):
        cmds, t = [], 40
        for _ in range(n_instr):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == 'alu':
                cmds.append(isa.alu_cmd(
                    'reg_alu', 'i', int(rng.integers(-1000, 1000)),
                    list(isa.ALU_OPS)[int(rng.integers(8))],
                    int(rng.integers(4)),
                    write_reg_addr=int(rng.integers(4))))
            elif kind == 'pulse':
                t += int(rng.integers(10, 80))
                cmds.append(isa.pulse_cmd(
                    freq_word=int(rng.integers(1 << 9)),
                    phase_word=int(rng.integers(1 << 17)),
                    amp_word=int(rng.integers(1 << 16)),
                    env_word=(int(rng.integers(1, 8)) << 12),
                    cfg_word=int(rng.integers(3)), cmd_time=t))
            elif kind == 'reg_pulse':
                cmds.append(isa.pulse_cmd(amp_regaddr=int(rng.integers(4))))
            elif kind == 'read':
                cmds.append(isa.alu_cmd(
                    'alu_fproc', 'i', int(rng.integers(-2, 3)),
                    list(isa.ALU_OPS)[int(rng.integers(8))], func_id=core,
                    write_reg_addr=int(rng.integers(4))))
            elif kind == 'branch':
                target = len(cmds) + 1 + int(rng.integers(1, 3))
                cmds.append(isa.alu_cmd(
                    'jump_fproc', 'i', int(rng.integers(0, 2)),
                    rng.choice(['eq', 'le', 'ge']), func_id=core,
                    jump_cmd_ptr=min(target, n_instr)))
            elif kind == 'jump':
                # forward, now and then past the program's end
                target = len(cmds) + 1 + int(rng.integers(1, 4))
                if rng.random() > 0.2:
                    target = min(target, n_instr)
                cmds.append(isa.jump_i(target) if rng.random() < 0.25
                            else isa.alu_cmd(
                                'jump_cond', 'i', int(rng.integers(-2, 2)),
                                rng.choice(['eq', 'le', 'ge']),
                                int(rng.integers(4)), jump_cmd_ptr=target))
            elif kind == 'qclk':
                cmds.append(isa.alu_cmd('inc_qclk', 'i',
                                        int(rng.integers(-50, 50))))
            else:
                t += int(rng.integers(150))
                cmds.append(isa.idle(t) if rng.integers(2)
                            else isa.pulse_reset())
            t += 60
        cmds.append(isa.done_cmd())
        progs.append(cmds)
    mp = from_cmds(progs)
    # now and then an out-of-ISA opcode (the engines trap it)
    kind = np.asarray(mp.soa.kind).copy()
    for c, cmds in enumerate(progs):
        for i in range(len(cmds) - 1):
            if rng.random() < 0.03:
                kind[c, i] = isa.N_KINDS + 1
    return dataclasses.replace(mp, soa=dataclasses.replace(mp.soa,
                                                           kind=kind))


def lut_feedback_program(rng, isa, from_cmds, n_cores=4, n_pre=8,
                         n_post=10):
    """Random programs on the ``'lut'`` fabric that the span engines
    serve: ``(mp, lut_mask, lut_table)``.  Every core holds ``n_pre``
    rows of measurements, drive pulses, ALU rows, qclk loads, idles and
    forward conditional jumps on the (random) registers — some past the
    ``n_pre`` split (on some masked cores, a first row that skips the
    whole prefix, so a lane can skip every measurement of a masked core
    and starve the readers of its shot) — then ``n_post`` rows of LUT
    reads
    (``func_id`` >= 1, into a register or as a forward branch), drive
    pulses, ALU rows and, on unmasked cores only, measurements.  Every
    trigger names its element (a drive is element 0), so that the span
    rule's analysis proves each masked core's measurements lie before the
    first read.  ``isa``/``from_cmds``: the encoder module and
    ``machine_program_from_cmds`` of either package."""
    C, N = n_cores, n_pre + n_post
    mask = rng.random(C) < 0.6
    mask[int(rng.integers(C))] = True
    table = tuple(int(x) for x in
                  rng.integers(0, 1 << C, 1 << int(mask.sum())))
    progs = []
    for core in range(C):
        cmds, t = [], 40

        def pulse(meas):
            return isa.pulse_cmd(
                freq_word=int(rng.integers(1 << 9)),
                amp_word=int(rng.integers(1 << 16)),
                env_word=(int(rng.integers(1, 8)) << 12),
                cfg_word=2 if meas else 0, cmd_time=t)
        skip = mask[core] and rng.random() < 0.5
        for i in range(N):
            post = i >= n_pre
            roll = rng.random()
            if skip and i == 0:
                # on some lanes, skip every measurement of a masked core
                cmds.append(isa.alu_cmd(
                    'jump_cond', 'i', int(rng.integers(-2, 2)),
                    rng.choice(['eq', 'le', 'ge']), int(rng.integers(4)),
                    jump_cmd_ptr=n_pre))
            elif post and roll < 0.35:
                fid = int(rng.integers(1, C + 2))
                if rng.random() < 0.5:
                    cmds.append(isa.alu_cmd(
                        'alu_fproc', 'i', int(rng.integers(-2, 3)),
                        list(isa.ALU_OPS)[int(rng.integers(8))],
                        func_id=fid, write_reg_addr=int(rng.integers(4))))
                else:
                    cmds.append(isa.alu_cmd(
                        'jump_fproc', 'i', int(rng.integers(0, 2)),
                        rng.choice(['eq', 'le', 'ge']), func_id=fid,
                        jump_cmd_ptr=min(i + 1 + int(rng.integers(1, 3)),
                                         N)))
            elif roll < 0.65:
                t += int(rng.integers(10, 80))
                meas = rng.random() < (0.3 if post else 0.5) \
                    and not (post and mask[core])
                cmds.append(pulse(meas))
            elif roll < 0.8:
                cmds.append(isa.alu_cmd(
                    'reg_alu', 'i', int(rng.integers(-1000, 1000)),
                    list(isa.ALU_OPS)[int(rng.integers(8))],
                    int(rng.integers(4)),
                    write_reg_addr=int(rng.integers(4))))
            elif roll < 0.9:
                cmds.append(isa.alu_cmd(
                    'jump_cond', 'i', int(rng.integers(-2, 2)),
                    rng.choice(['eq', 'le', 'ge']), int(rng.integers(4)),
                    jump_cmd_ptr=min(i + 1 + int(rng.integers(1, 8)), N)))
            elif roll < 0.95:
                cmds.append(isa.alu_cmd('inc_qclk', 'i',
                                        int(rng.integers(-50, 50))))
            else:
                t += int(rng.integers(150))
                cmds.append(isa.idle(t))
            t += 60
        cmds.append(isa.done_cmd())
        progs.append(cmds)
    return from_cmds(progs), tuple(bool(b) for b in mask), table



def _inputs(tables, B, seed):
    rng = np.random.default_rng(seed)
    C, F, W = (tables['bas'].shape[i] for i in (0, 2, 3))
    rows = tables['rows'].tolist() or [0]
    angle = rng.uniform(0, 2 * np.pi, (B, C, 1))
    dev = tables['env'].device
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    sc = dict(amp=t(rng.uniform(0.2, 1, (B, C, 1)), torch.float32),
              cosA=t(np.cos(angle), torch.float32),
              sinA=t(np.sin(angle), torch.float32),
              f_idx=t(rng.integers(0, F, (B, C, 1)), torch.int32),
              addr=t(np.asarray(rows)[rng.integers(len(rows),
                                                   size=(B, C, 1))],
                     torch.int32),
              n_samp=t(rng.integers(0, W + 8, (B, C, 1)), torch.int32))
    gs = t(rng.uniform(-1, 1, (2, B, C)), torch.float32)
    return sc, gs[0].contiguous(), gs[1].contiguous()


# static rows (the last two past the envelope's end), carrier
# frequencies and mixed interpolation: the prefix tables' row and
# frequency select, which the program's one row and one frequency skip.
# 'wide' has z rows (R * F * W * 8 bytes) too large for the kernel's
# shared memory, so it reads them from global memory.
MULTI_ROWS, MULTI_INTERPS = (0, 8, 28, 40), (4, 2, 1)
MULTI_F = {'multirow': 2, 'wide': 4}


def _tables(card, program, kind, mode):
    """The program's resolve tables, or seeded multi-row ones."""
    if kind == 'program':
        tables = prepare_physics_tables(program, ReadoutPhysics(
            resolve_mode=mode, resolve_chunk=256), card)
        # 'persample' reads the static rows too; without them the kernel
        # runs its full-table mode
        return tables if mode == 'fused' \
            else dict(tables, rows=tables['rows'][:0])
    from distributed_processor_tpu_torch.ops.resolve import \
        build_fused_tables
    from distributed_processor_tpu_torch.sim.physics import (
        _aligned_chunk, _carrier_basis, _pad_env_planes)
    rng = np.random.default_rng(12)
    W, C = 1024, len(MULTI_INTERPS)
    env = torch.as_tensor(rng.uniform(-1, 1, (C, 64, 2)), dtype=torch.float32,
                          device=card)
    freq = torch.as_tensor(rng.uniform(-0.2, 0.2, (C, MULTI_F[kind])),
                           dtype=torch.float32, device=card)
    env_pads = _pad_env_planes(env, _aligned_chunk(256, W, MULTI_INTERPS))
    return build_fused_tables(env_pads, _carrier_basis(freq, W), W,
                              MULTI_INTERPS,
                              MULTI_ROWS if mode == 'fused' else None)


def _against_plain(tables, sigma, ring, noise, B):
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    sc, gs_i, gs_q = _inputs(tables, B, 1)
    args = (sc, tables, gs_i, gs_q, sigma, 1 / 30, 3, W, Lp)
    before = resolve_windows_fused.launches
    got = resolve_windows_fused(*args, ring=ring, noise=noise)
    assert resolve_windows_fused.launches == before + 1
    want = resolve_windows_reference(*args, ring=ring, noise=noise)
    torch.cuda.synchronize()
    scale = float(want[2].abs().max())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize('kind', ['program', 'multirow', 'wide'])
@pytest.mark.parametrize('mode', ['fused', 'persample'])
@pytest.mark.parametrize('ring', [False, True])
@pytest.mark.parametrize('streamed', [False, True])
def test_kernel_matches_plain_version(card, program, kind, mode, ring,
                                      streamed):
    tables = _tables(card, program, kind, mode)
    C, W = tables['env'].shape[0], tables['bas'].shape[3]
    B = 1000
    noise = None
    if streamed:
        gen = torch.Generator(device=card)
        gen.manual_seed(2)
        noise = 0.1 * torch.randn((2, C, B, W), generator=gen, device=card)
    _against_plain(tables, 0.0, ring, noise, B)


@pytest.mark.parametrize('kind', ['program', 'multirow', 'wide'])
@pytest.mark.parametrize('ring', [False, True])
def test_kernel_sigma0_is_deterministic_part(card, program, kind, ring):
    """sigma = 0 without streamed noise: the rows-mode kernel reads only
    the prefix tables (one thread per window), at a batch that fills the
    card's grid; its sums are the plain chain's."""
    tables = _tables(card, program, kind, 'fused')
    assert tables['rows'].numel() > 0
    _against_plain(tables, 0.0, ring, None, 20000)
    # the prefix tables are built once per ring and kept with the tables
    cached = dict(tables['prefix'])
    _against_plain(tables, 0.0, ring, None, 64)
    assert all(tables['prefix'][k] is v for k, v in cached.items())


def test_kernel_rejects_bad_inputs(card, program):
    tables = prepare_physics_tables(program, ReadoutPhysics(), card)
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    sc, gs_i, gs_q = _inputs(tables, 16, 1)
    with pytest.raises(ValueError, match='lane input'):
        resolve_windows_fused(sc, tables, gs_i[:8], gs_q, 0.0, 0.0, 0, W,
                              Lp)
    with pytest.raises(ValueError, match='noise'):
        resolve_windows_fused(sc, tables, gs_i, gs_q, 0.0, 0.0, 0, W, Lp,
                              noise=torch.zeros((2, C, 16, W - 1),
                                                device=card))


def test_physics_on_card_matches_cpu(card, program):
    B = 128
    init = np.random.default_rng(4).integers(0, 2, (B, program.n_cores))
    cfg = InterpreterConfig(max_steps=2 * program.n_instr + 64,
                            max_pulses=program.max_pulses_per_core(1) + 4,
                            max_meas=2, max_resets=2, record_pulses=False)
    model = ReadoutPhysics(sigma=0.0, resolve_mode='fused',
                           resolve_chunk=256)
    before = resolve_windows_fused.launches
    on_card = run_physics_batch(program, model, 1, B, init_states=init,
                                cfg=cfg, device=card)
    on_cpu = run_physics_batch(program, model, 1, B, init_states=init,
                               cfg=cfg, device='cpu')
    assert resolve_windows_fused.launches - before \
        == int(on_card['epochs'])
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err',
                'fault', 'qturns', 'epochs', 'steps'):
        assert torch.equal(on_card[key].cpu(), on_cpu[key]), key


def _ar1_against_plain(tables, B, rho, seed=5):
    """K2 with AR(1) on streamed whites and initial states against the
    plain version's triangular coloring of the same numbers: rtol 1e-4,
    atol 1e-3 * max|energy| (a warp scan of affine maps, or the
    sequential recursion, against a float32 triangular product per
    chunk)."""
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    sc, gs_i, gs_q = _inputs(tables, B, seed)
    gen = torch.Generator(device=tables['env'].device)
    gen.manual_seed(seed)
    dev = tables['env'].device
    white = 0.1 * torch.randn((2, C, B, W), generator=gen, device=dev)
    init = 0.1 * torch.randn((2, C, B), generator=gen, device=dev)
    args = (sc, tables, gs_i, gs_q, 0.1, 0.0, 3, W, Lp)
    before = resolve_windows_fused.launches
    got = resolve_windows_fused(*args, noise=white, noise0=init, rho=rho)
    assert resolve_windows_fused.launches == before + 1
    want = resolve_windows_reference(*args, noise=white, noise0=init,
                                     rho=rho)
    torch.cuda.synchronize()
    scale = float(want[2].abs().max())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3 * scale)


@pytest.mark.parametrize('kind', ['program', 'wide', 'full'])
@pytest.mark.parametrize('rho', [0.1, 0.9])
@pytest.mark.parametrize('B', [1, 33, 1001])
def test_k2_ar1_matches_plain_version(card, program, kind, rho, B):
    """Ragged sample counts (0 to past W), rows mode from shared or
    global memory, and the full-table kernel."""
    if kind == 'full':
        tables = _tables(card, program, 'multirow', 'persample')
        assert tables['rows'].numel() == 0
    else:
        tables = _tables(card, program, kind, 'fused')
    _ar1_against_plain(tables, B, rho)


@pytest.mark.parametrize('kind', ['program', 'full'])
def test_k2_ar1_philox_variance(card, program, kind):
    """The kernel's own AR(1) draws: the variance of the noise
    projection of one window, repeated over 20000 lanes, against
    ``sigma^2 a^2 sum_{s,t} rho^|s-t| Re(z_s conj(z_t))`` within 5
    standard errors."""
    if kind == 'full':
        tables = _tables(card, program, 'multirow', 'persample')
    else:
        tables = _tables(card, program, 'program', 'fused')
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    B, rho, sigma = 20000, 0.7, 0.5
    sc, gs_i, gs_q = _inputs(tables, 1, 2)
    sc['n_samp'].fill_(min(W, 300))
    sc = {k: v.expand(B, C, 1).contiguous() for k, v in sc.items()}
    gs_i, gs_q = gs_i.expand(B, C).contiguous(), gs_q.expand(B, C).contiguous()
    args = (sc, tables, gs_i, gs_q)
    clean = resolve_windows_fused(*args, 0.0, 0.0, 0, W, Lp)
    noisy = resolve_windows_fused(*args, sigma, 0.0, 11, W, Lp, rho=rho)
    # the window's z from the plain chain at sigma = 0: one lane, unit
    # response, each sample alone
    from distributed_processor_tpu_torch.ops.resolve import \
        _window_base
    a = sc['amp'][0, :, 0].double().cpu()
    n = int(sc['n_samp'][0, 0, 0])
    s = torch.arange(n, device=card)
    interp = tables['interps'].long()[:, None]
    base = _window_base(sc['addr'][0, :, 0], tables['rows'], Lp).long()
    k = (base[:, None] + s[None] // interp).clamp(max=Lp - 1)
    env = tables['env'].double()
    e = env[:, 0].gather(1, k) + 1j * env[:, 1].gather(1, k)
    f = sc['f_idx'][0, :, 0].long()
    bas = tables['bas'].double()[torch.arange(C, device=card), :, f, :n]
    z = (e * (bas[:, 0] + 1j * bas[:, 1])).cpu().numpy()
    lag = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    torch.cuda.synchronize()
    for c in range(C):
        var = sigma ** 2 * float(a[c]) ** 2 * np.real(
            (rho ** lag * z[c][:, None] * np.conj(z[c][None, :])).sum())
        for comp in (0, 1):
            d = (noisy[comp] - clean[comp])[:, c].double().cpu().numpy()
            assert abs(d.var(ddof=1) - var) \
                < 5 * var * np.sqrt(2.0 / (B - 1)), (c, comp, d.var(), var)


def _tie_lanes(out, u) -> int:
    fired = np.arange(u.shape[-1])[None, None, :] \
        < out['n_meas'].cpu().numpy()[..., None]
    return int((fired & (np.abs(u - out['meas_p1'].cpu().numpy())
                         < 1e-6)).sum())


@pytest.fixture
def shared_uniforms(monkeypatch):
    """Every device's run reads the CPU generator's measurement uniforms,
    moved to its device: the card draws its own from another generator,
    so card = CPU needs one draw for both.  Returns the draw."""
    from distributed_processor_tpu_torch.sim import physics as tphysics
    draw = tphysics._meas_uniforms
    monkeypatch.setattr(
        tphysics, '_meas_uniforms', lambda seed, shots, C, M, device:
        draw(seed, shots, C, M, 'cpu').to(device))
    return draw


def test_bloch_physics_on_card_matches_cpu(card, program, shared_uniforms):
    """The straight-line engine with the Bloch device and K2, card = CPU
    at sigma = 0 with the same initial states and measurement
    uniforms."""
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    B = 256
    init = np.random.default_rng(4).integers(0, 2, (B, program.n_cores))
    cfg = InterpreterConfig(max_steps=2 * program.n_instr + 64,
                            max_pulses=program.max_pulses_per_core(1) + 4,
                            max_meas=2, max_resets=2, record_pulses=False,
                            straightline=None)
    model = ReadoutPhysics(sigma=0.0, resolve_mode='fused',
                           resolve_chunk=256, device=DeviceModel(
                               'bloch', detuning_hz=50e3, t1_s=80e-6,
                               t2_s=60e-6, depol_per_pulse=1e-3))
    before = resolve_windows_fused.launches
    on_card = run_physics_batch(program, model, 1, B, init_states=init,
                                cfg=cfg, device=card)
    assert resolve_windows_fused.launches - before \
        == int(on_card['epochs'])
    on_cpu = run_physics_batch(program, model, 1, B, init_states=init,
                               cfg=cfg, device='cpu')
    u = shared_uniforms(1, B, program.n_cores, 2, 'cpu').numpy()
    assert _tie_lanes(on_cpu, u) == 0
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err',
                'fault', 'epochs', 'steps'):
        assert torch.equal(on_card[key].cpu(), on_cpu[key]), key
    for key in ('bloch', 'meas_p1'):
        torch.testing.assert_close(on_card[key].cpu(), on_cpu[key],
                                   rtol=0, atol=1e-5)


def test_statevec_physics_on_card_matches_cpu(card, shared_uniforms):
    """GHZ-3 on the generic engine with the statevec device and K2,
    card = CPU at sigma = 0 with the same measurement uniforms."""
    from distributed_processor_tpu_torch.models import (
        couplings_from_qchip, ghz_program)
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    B = 128
    mp = compile_to_machine(ghz_program(['Q0', 'Q1', 'Q2']),
                            make_default_qchip(3), n_qubits=3)
    model = ReadoutPhysics(sigma=0.0, device=DeviceModel(
        'statevec', couplings=couplings_from_qchip(mp,
                                                   make_default_qchip(3))))
    kw = dict(init_states=np.zeros((B, 3), np.int32), max_steps=4000,
              max_pulses=64, max_meas=4)
    on_card = run_physics_batch(mp, model, 2, B, device=card, **kw)
    on_cpu = run_physics_batch(mp, model, 2, B, device='cpu', **kw)
    for key in ('meas_bits', 'n_pulses', 'err', 'fault', 'leaked',
                'epochs', 'steps'):
        assert torch.equal(on_card[key].cpu(), on_cpu[key]), key
    torch.testing.assert_close(on_card['psi'].abs().cpu() ** 2,
                               on_cpu['psi'].abs() ** 2, rtol=0, atol=1e-5)
    bits = on_card['meas_bits'][:, :, 0]
    assert bool((bits == bits[:, :1]).all())


# ---------------------------------------------------------------------------
# the span kernels K1 and K3 (csrc/exec_span.cu)


def _span_cfg(mp, **kw):
    return InterpreterConfig(max_steps=2 * mp.n_instr + 64,
                             max_pulses=mp.max_pulses_per_core(1) + 4,
                             max_meas=2, max_resets=2, **kw)


def _assert_same(a, b):
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key].cpu(), b[key].cpu()), key


def _k1_programs(program):
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    fuzz = [sl_feedback_program(np.random.default_rng(s), isa,
                                machine_program_from_cmds)
            for s in range(3)]
    return [program] + fuzz


@pytest.mark.parametrize('record', [False, True])
def test_k1_matches_plain_version(card, program, record):
    """``engine='pallas'`` (K1) against the straight-line engine on the
    card (its plain version) on the active-reset + RB program and on a
    straight-line feedback fuzz: every output key identical."""
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    for k, mp in enumerate(_k1_programs(program)):
        rng = np.random.default_rng(10 + k)
        B = 3000
        bits = torch.as_tensor(rng.integers(0, 2, (B, mp.n_cores, 2)),
                               dtype=torch.int32, device=card)
        init = torch.as_tensor(rng.integers(-5, 5, (B, mp.n_cores, 16)),
                               dtype=torch.int32, device=card)
        kw = dict(record_pulses=record, opcode_histogram=True)
        before = exec_span.launches
        got = simulate_batch(mp, bits, init, cfg=_span_cfg(
            mp, engine='pallas', **kw), device=card)
        assert exec_span.launches == before + 1
        want = simulate_batch(mp, bits, init, cfg=_span_cfg(
            mp, engine='straightline', **kw), device=card)
        torch.cuda.synchronize()
        _assert_same(got, want)


def test_k1_serves_auto_on_the_card(card, program):
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    bits = torch.zeros((64, program.n_cores, 2), dtype=torch.int32,
                       device=card)
    before = exec_span.launches
    out = simulate_batch(program, bits, cfg=_span_cfg(program, engine='auto'),
                         device=card)
    assert exec_span.launches == before + 1
    assert bool(out['done'].all())


def test_k3_matches_plain_version_and_generic(card, program):
    """``engine='fused'`` (K3) at sigma = 0 against its plain version (the
    same path on the CPU) and against the generic engine on the card:
    bits and integer outputs identical, in one epoch."""
    from distributed_processor_tpu_torch.ops.exec_span import exec_span_fused
    B = 2048
    init = np.random.default_rng(6).integers(0, 2, (B, program.n_cores))
    model = ReadoutPhysics(sigma=0.0, resolve_mode='fused',
                           resolve_chunk=256)
    cfg = _span_cfg(program, record_pulses=False)
    before = exec_span_fused.launches
    fused = run_physics_batch(program, model, 1, B, init_states=init,
                              cfg=dataclasses.replace(cfg, engine='fused'),
                              device=card)
    assert exec_span_fused.launches == before + 1
    plain = run_physics_batch(program, model, 1, B, init_states=init,
                              cfg=dataclasses.replace(cfg, engine='fused'),
                              device='cpu')
    _assert_same(fused, plain)
    generic = run_physics_batch(program, model, 1, B, init_states=init,
                                cfg=dataclasses.replace(cfg,
                                                        engine='generic'),
                                device=card)
    for key in generic:
        if key not in ('epochs', 'steps'):
            assert torch.equal(fused[key], generic[key]), key
    assert int(fused['epochs']) == 1 and int(generic['epochs']) == 2


def test_k1_rejects_bad_inputs(card, program):
    from distributed_processor_tpu_torch.ops.exec_span import (exec_span,
                                                               span_table)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _element_geometry, _init_state, _soa_np, _span_table)
    cfg = _span_cfg(program)
    table = _span_table(program, cfg, card)
    st = _init_state(8, program.n_cores, cfg, None, card)
    bits = torch.zeros((8, program.n_cores, 2), dtype=torch.int32,
                       device=card)
    with pytest.raises(ValueError, match='meas_bits'):
        exec_span(st, table, bits[:, :, :1], cfg)
    with pytest.raises(ValueError, match='time'):
        exec_span(dict(st, time=st['time'].long()), table, bits, cfg)
    spc, interp = _element_geometry(program)
    with pytest.raises(ValueError, match='geometry'):
        span_table(_soa_np(program), 0 * spc, interp, cfg, card)
    with pytest.raises(ValueError, match='span table lies on'):
        exec_span(st, _span_table(program, cfg, 'cpu'), bits, cfg)


# the tile kernel's edges (csrc/exec_span.cu exec_tile_kernel): ragged
# tiles of 32 shots, core counts that do not fill a block, a program too
# large for the one-thread-per-lane kernel's shared memory; each held,
# with that kernel (K3's, and K1's past the tile's budget), to the plain
# versions

def _reg_addrs_outside(mp, rng, share=0.1):
    """``mp`` with a share of its register addresses (ALU inputs and
    output, the pulse register) moved outside the 16-word file: reads
    give 0, writes are dropped."""
    soa = mp.soa
    fields = {}
    for name in ('in0_reg', 'in1_reg', 'out_reg', 'p_reg'):
        a = np.asarray(getattr(soa, name)).copy()
        hit = rng.random(a.shape) < share
        a[hit] = rng.choice([-1, 16, 31, 1 << 20], int(hit.sum()))
        fields[name] = a
    return dataclasses.replace(mp, soa=dataclasses.replace(soa, **fields))


def _body_program(rng, n_cores, lengths):
    """Loop-free programs of plain rows (pulses, ALU, resets, idles,
    qclk) and now and then a jump to the next row, which ends a block, of
    a random length per core in ``lengths``: the shorter cores' DONE
    padding lands inside the block bodies of the longer ones."""
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    progs = []
    for core in range(n_cores):
        cmds, t = [], 40
        for _ in range(int(rng.integers(*lengths))):
            r = rng.random()
            if r < 0.4:
                t += int(rng.integers(-5, 80))
                cmds.append(isa.pulse_cmd(
                    freq_word=int(rng.integers(1 << 9)),
                    phase_word=int(rng.integers(1 << 17)),
                    amp_word=int(rng.integers(1 << 16)),
                    env_word=int(rng.integers(0, 1 << 14)),
                    cfg_word=int(rng.integers(3)), cmd_time=max(t, 0)))
            elif r < 0.5:
                cmds.append(isa.pulse_cmd(amp_regaddr=int(rng.integers(4))))
            elif r < 0.75:
                cmds.append(isa.alu_cmd(
                    'reg_alu', 'i', int(rng.integers(-1000, 1000)),
                    list(isa.ALU_OPS)[int(rng.integers(8))],
                    int(rng.integers(4)),
                    write_reg_addr=int(rng.integers(4))))
            elif r < 0.85:
                t += int(rng.integers(150))
                cmds.append(isa.idle(t) if rng.integers(2)
                            else isa.pulse_reset())
            elif r < 0.93:
                cmds.append(isa.alu_cmd('inc_qclk', 'i',
                                        int(rng.integers(-50, 50))))
            else:
                # a jump to the next row ends a block: several bodies
                cmds.append(isa.jump_i(len(cmds) + 1))
        cmds.append(isa.done_cmd())
        progs.append(cmds)
    return machine_program_from_cmds(progs)


def _random_carry(rng, B, C, N, cfg, card):
    """A seeded carry at random points of a program of ``N`` rows: pcs
    inside and outside it, a fifth of the lanes done, random registers,
    pulse registers, clocks and counters (some past their bounds)."""
    from distributed_processor_tpu_torch.sim.interpreter import _init_state
    st = _init_state(B, C, cfg, None, card)
    M, R, P = cfg.max_meas, cfg.max_resets, cfg.max_pulses
    i = lambda lo, hi, *s: torch.as_tensor(
        rng.integers(lo, hi, s), dtype=torch.int32, device=card)
    st.update(pc=i(-2, N + 2, B, C), regs=i(-2**31, 2**31, B, C, 16),
              pp=i(0, 1 << 24, B, C, 5), time=i(-1000, 1 << 20, B, C),
              offset=i(-500, 500, B, C), err=i(0, 4, B, C),
              fault=i(0, 2, B, C), n_pulses=i(0, P + 2, B, C),
              n_resets=i(0, R + 2, B, C), n_meas=i(0, M + 2, B, C),
              rst_time=i(0, 1 << 20, B, C, R),
              meas_avail=i(0, 1 << 20, B, C, M),
              done=torch.as_tensor(rng.random((B, C)) < 0.2, device=card))
    if 'rec' in st:
        st['rec'] = i(0, 1 << 16, *st['rec'].shape)
    if 'op_hist' in st:
        st['op_hist'] = i(0, 100, *st['op_hist'].shape)
    return st


@pytest.mark.parametrize('C', [1, 3, 8])
@pytest.mark.parametrize('B', [1, 31, 33, 4097])
def test_k1_tile_edges_match_plain_version(card, B, C):
    """K1 span (the tile kernel and one thread per lane) against the
    straight-line engine on the
    card at ragged batches and core counts: fproc branches on random
    bits send the lanes of a warp to different pcs, a tenth of the
    register addresses lie outside the file, records and histogram on,
    random initial registers — every key identical."""
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_span_per_lane, exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, _init_state, _span_table)
    rng = np.random.default_rng(1000 * C + B)
    mp = _reg_addrs_outside(sl_feedback_program(
        rng, isa, machine_program_from_cmds, n_cores=C, n_instr=40), rng)
    cfg = _span_cfg(mp, record_pulses=True, opcode_histogram=True)
    table = _span_table(mp, cfg, card)
    init = torch.as_tensor(rng.integers(-3, 3, (B, C, 16)),
                           dtype=torch.int32, device=card)
    st = _init_state(B, C, cfg, init, card)
    bits = torch.as_tensor(rng.integers(0, 2, (B, C, 2)), dtype=torch.int32,
                           device=card)
    want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                              bits, torch.ones_like(bits, dtype=torch.bool),
                              cfg)
    for run in (exec_span, _exec_span_per_lane):
        got = run(st, table, bits, cfg)
        torch.cuda.synchronize()
        _assert_same(got, want)


def test_k1_odd_element_geometry_matches_plain_version(card):
    """The tile kernel divides a pulse's sample count by the samples per
    clock with a multiply and a shift: element geometry far from the
    programs' own (samples per clock 1, 3, 7, 1000, 2**20 + 1;
    interpolation 0 to 9; envelope lengths to 4094) in K1 span and K1
    block, tile and one-thread-per-lane kernels, against the plain
    versions: every key identical."""
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_blocks_per_lane, _exec_span_per_lane, block_table,
        exec_blocks, exec_span, span_table)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _apply_blocks, _block_plan, _element_geometry, _exec_straightline,
        _init_state, _soa_np)
    rng = np.random.default_rng(79)
    mp = sl_feedback_program(rng, isa, machine_program_from_cmds,
                             n_cores=3, n_instr=40)
    soa = _soa_np(mp).copy()
    # envelope words with lengths up to 4094 (4095 is CW)
    env = soa[..., 10]
    soa[..., 10] = np.where(env != 0, env | (int(rng.integers(1, 4095)) << 12),
                            env)
    spc, interp = _element_geometry(mp)
    spc = np.asarray([1, 3, 7, 1000, 2**20 + 1], np.int32)[
        rng.integers(0, 5, spc.shape)]
    interp = rng.integers(0, 10, interp.shape).astype(np.int32)
    cfg = _span_cfg(mp, record_pulses=True, opcode_histogram=True)
    table = span_table(soa, spc, interp, cfg, card)
    B = 333
    st = _init_state(B, 3, cfg, None, card)
    bits = torch.as_tensor(rng.integers(0, 2, (B, 3, 2)), dtype=torch.int32,
                           device=card)
    want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                              bits, torch.ones_like(bits, dtype=torch.bool),
                              cfg)
    for run in (exec_span, _exec_span_per_lane):
        _assert_same(run(st, table, bits, cfg), want)
    body = _body_program(rng, 3, (20, 40))
    bsoa = _soa_np(body)
    bid_at, bodies = _block_plan(bsoa)
    btab = block_table(bsoa, bid_at, bodies, table.spc, table.interp, cfg)
    st = _random_carry(rng, B, 3, body.n_instr, cfg, card)
    st['pc'] = torch.zeros_like(st['pc'])
    want = _apply_blocks(st, btab, cfg)
    for run in (exec_blocks, _exec_blocks_per_lane):
        _assert_same(run({k: v.clone() for k, v in st.items()}, btab, cfg),
                     want)


def test_k1_large_program_matches_plain_version(card):
    """A program of 8 cores x 401 rows (231 KB, past the 200 KB the
    one-thread-per-lane kernel stages in shared memory; the tile kernel
    reads it through L1) on both kernels: every key identical."""
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_span_per_lane, exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, _init_state, _span_table)
    rng = np.random.default_rng(77)
    mp = sl_feedback_program(rng, isa, machine_program_from_cmds,
                             n_cores=8, n_instr=400)
    assert mp.n_cores * mp.n_instr * 18 * 4 > 200 * 1024
    cfg = _span_cfg(mp, record_pulses=True, opcode_histogram=True)
    table = _span_table(mp, cfg, card)
    B = 1000
    st = _init_state(B, 8, cfg, None, card)
    bits = torch.as_tensor(rng.integers(0, 2, (B, 8, 2)), dtype=torch.int32,
                           device=card)
    want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                              bits, torch.ones_like(bits, dtype=torch.bool),
                              cfg)
    for run in (exec_span, _exec_span_per_lane):
        _assert_same(run(st, table, bits, cfg), want)


@pytest.mark.parametrize('C', [1, 3, 8])
@pytest.mark.parametrize('B', [1, 31, 33, 4097])
def test_k1_block_tile_edges_match_plain_version(card, B, C):
    """One K1 block launch (the tile kernel and one thread per lane)
    against the plain bodies on
    a random carry: lanes of one warp at different block starts (one
    body at a time), done lanes and pcs outside the program, DONE rows
    inside bodies (cores of different lengths), register addresses
    outside the file, counters past their bounds, records and histogram
    on — every key identical."""
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_blocks_per_lane, block_table, exec_blocks)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _apply_blocks, _block_plan, _program_constants, _soa_np)
    rng = np.random.default_rng(2000 * C + B)
    mp = _reg_addrs_outside(_body_program(rng, C, (8, 40)), rng)
    cfg = InterpreterConfig(max_meas=4, max_resets=3, max_pulses=24,
                            record_pulses=True, opcode_histogram=True)
    soa_np = _soa_np(mp)
    bid_at, bodies = _block_plan(soa_np)
    assert bodies
    _soa, spc, interp, _sync = _program_constants(mp, card)
    table = block_table(soa_np, bid_at, bodies, spc, interp, cfg)
    st = _random_carry(rng, B, C, mp.n_instr, cfg, card)
    # a third of the lanes at block starts
    starts = torch.as_tensor(np.nonzero(bid_at >= 0)[0], device=card)
    pick = torch.as_tensor(rng.random((B, C)) < 0.35, device=card)
    st['pc'] = torch.where(pick, starts[torch.as_tensor(
        rng.integers(0, len(starts), (B, C)), device=card)].int(), st['pc'])
    want = _apply_blocks(st, table, cfg)
    for run in (exec_blocks, _exec_blocks_per_lane):
        got = run({k: v.clone() for k, v in st.items()}, table, cfg)
        torch.cuda.synchronize()
        _assert_same(got, want)


def test_k1_block_large_program_matches_plain_version(card):
    """K1 block on a program of 8 cores x ~420 rows (past the 200 KB the
    one-thread-per-lane kernel stages) on both kernels."""
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_blocks_per_lane, block_table, exec_blocks)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _apply_blocks, _block_plan, _program_constants, _soa_np)
    rng = np.random.default_rng(78)
    mp = _body_program(rng, 8, (380, 420))
    assert mp.n_cores * mp.n_instr * 18 * 4 > 200 * 1024
    cfg = InterpreterConfig(max_meas=4, max_resets=3, max_pulses=400,
                            record_pulses=True, opcode_histogram=True)
    soa_np = _soa_np(mp)
    bid_at, bodies = _block_plan(soa_np)
    _soa, spc, interp, _sync = _program_constants(mp, card)
    table = block_table(soa_np, bid_at, bodies, spc, interp, cfg)
    st = _random_carry(rng, 1000, 8, mp.n_instr, cfg, card)
    st['pc'] = torch.where(torch.rand(st['pc'].shape, device=card) < 0.5,
                           0, st['pc'])
    want = _apply_blocks(st, table, cfg)
    for run in (exec_blocks, _exec_blocks_per_lane):
        _assert_same(run({k: v.clone() for k, v in st.items()}, table, cfg),
                     want)


def test_k1_launches_from_two_threads_match_plain_version(card):
    """K1 span launched from two host threads at once on programs of
    different core counts and sizes (each tile past 48 KB of shared
    memory, each its own amount): every launch identical to the plain
    version — the launches share the cache of what the card holds and
    the kernel's shared-memory limit."""
    import threading
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, _init_state, _span_table)
    rng = np.random.default_rng(88)
    cases = []
    for n_cores, n_instr in ((8, 60), (3, 30)):
        mp = sl_feedback_program(rng, isa, machine_program_from_cmds,
                                 n_cores=n_cores, n_instr=n_instr)
        cfg = _span_cfg(mp)
        table = _span_table(mp, cfg, card)
        st = _init_state(777, n_cores, cfg, None, card)
        bits = torch.as_tensor(rng.integers(0, 2, (777, n_cores, 2)),
                               dtype=torch.int32, device=card)
        want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                                  bits, torch.ones_like(bits,
                                                        dtype=torch.bool),
                                  cfg)
        cases.append((st, table, bits, cfg, want))
    errors = []

    def run(st, table, bits, cfg, want):
        try:
            for _ in range(20):
                got = exec_span(st, table, bits, cfg)
                torch.cuda.synchronize()
                _assert_same(got, want)
        except Exception as e:     # handed to the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=case) for case in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


# ---------------------------------------------------------------------------
# the block mode of the megastep kernel, K1 block (csrc/exec_span.cu)


def branchy_program(rng, isa, from_cmds):
    """Random 2-core program with backward counted loops (terminating by
    construction: counter regs 4..7 count loops and random ALU writes
    only regs 0..3), forward jumps, own-core sticky fproc reads and, half
    the time, a global SYNC barrier — the generator of the JAX package's
    tests/test_blocks.py ``_random_branchy_program``, over the encoder
    ``isa`` and ``machine_program_from_cmds`` of either package, drawing
    the same numbers in the same order."""
    C = 2
    use_sync = bool(rng.integers(0, 2))
    cores = []
    for c in range(C):
        cmds = []
        t = 20

        def plain(n):
            nonlocal t
            for _ in range(n):
                kind = rng.choice(['pt', 'pw', 'alu', 'idle', 'rst',
                                   'incq'], p=[.3, .15, .25, .15, .05, .1])
                if kind == 'pt':
                    t += int(rng.integers(-5, 60))
                    cmds.append(isa.pulse_cmd(
                        cmd_time=max(t, 0),
                        cfg_word=int(rng.integers(0, 3)),
                        env_word=int(rng.integers(0, 1 << 14)),
                        amp_word=int(rng.integers(0, 1 << 16)),
                        phase_word=int(rng.integers(0, 1 << 17)),
                        freq_word=int(rng.integers(0, 4))))
                elif kind == 'pw':
                    cmds.append(isa.pulse_cmd(
                        amp_word=int(rng.integers(0, 1 << 16)),
                        phase_word=int(rng.integers(0, 1 << 17))))
                elif kind == 'alu':
                    cmds.append(isa.alu_cmd(
                        'reg_alu', rng.choice(['i', 'r']),
                        int(rng.integers(-50, 50)),
                        rng.choice(['add', 'sub', 'eq', 'le', 'ge']),
                        alu_in1=int(rng.integers(0, 4)),
                        write_reg_addr=int(rng.integers(0, 4))))
                elif kind == 'idle':
                    t += int(rng.integers(0, 80))
                    cmds.append(isa.idle(t))
                elif kind == 'rst':
                    cmds.append(isa.pulse_reset())
                else:
                    cmds.append(isa.alu_cmd('inc_qclk', 'i',
                                            int(rng.integers(-30, 30)),
                                            'add'))

        def branchy(n):
            for _ in range(n):
                r = rng.random()
                if r < 0.25:
                    cmds.append(('jc', int(rng.integers(-20, 20)),
                                 rng.choice(['eq', 'le', 'ge'])))
                elif r < 0.35:
                    cmds.append(('ji',))
                elif r < 0.55:
                    cmds.append(('fproc', int(rng.integers(0, 2))))
                else:
                    plain(1)

        def loop(counter_reg):
            start = len(cmds)
            plain(int(rng.integers(1, 4)))
            cmds.append(isa.alu_cmd('reg_alu', 'i', 1, 'add',
                                    alu_in1=counter_reg,
                                    write_reg_addr=counter_reg))
            cmds.append(isa.alu_cmd('jump_cond', 'i',
                                    int(rng.integers(2, 5)), 'ge',
                                    alu_in1=counter_reg,
                                    jump_cmd_ptr=start))

        branchy(int(rng.integers(3, 7)))
        loop(4)
        if use_sync:
            cmds.append(isa.sync(0))
        branchy(int(rng.integers(2, 6)))
        if rng.integers(0, 2):
            loop(5)
        # forward targets, landing inside the body or on DONE
        n = len(cmds) + 1
        out = []
        for i, cmd in enumerate(cmds):
            if isinstance(cmd, tuple) and cmd[0] == 'jc':
                out.append(isa.alu_cmd(
                    'jump_cond', 'i', cmd[1], cmd[2],
                    alu_in1=int(rng.integers(0, 4)),
                    jump_cmd_ptr=int(rng.integers(i + 1, n))))
            elif isinstance(cmd, tuple) and cmd[0] == 'ji':
                out.append(isa.jump_i(int(rng.integers(i + 1, n))))
            elif isinstance(cmd, tuple) and cmd[0] == 'fproc':
                op = 'jump_fproc' if cmd[1] else 'alu_fproc'
                out.append(isa.alu_cmd(
                    op, 'i', int(rng.integers(0, 2)), 'eq',
                    write_reg_addr=int(rng.integers(0, 4)),
                    jump_cmd_ptr=int(rng.integers(i + 1, n)), func_id=c))
            else:
                out.append(cmd)
        out.append(isa.done_cmd())
        cores.append(out)
    return from_cmds(cores)


def looped_program(n_qubits=3, depth=3, loops=3):
    """Active reset + RB inside the on-device shot loop (``loops`` + 1
    iterations: the loop is a do-while on ``ge``)."""
    from distributed_processor_tpu_torch.models.experiments import \
        loop_shots_program
    qubits = [f'Q{i}' for i in range(n_qubits)]
    body = active_reset(qubits) + rb_program(qubits, depth, seed=1234)
    return compile_to_machine(loop_shots_program(body, loops, scope=qubits),
                              make_default_qchip(max(n_qubits, 2)),
                              n_qubits=n_qubits)


def _block_programs():
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    return [looped_program()] + [
        branchy_program(np.random.default_rng(300 + s), isa,
                        machine_program_from_cmds) for s in range(3)]


@pytest.mark.parametrize('record', [False, True])
def test_k1_block_matches_plain_version(card, record):
    """``engine='pallas'`` on looping programs (the block engine with K1
    block as its bodies) against ``engine='block'`` (the plain bodies) on
    the card: every output key identical, ``steps`` included, and one
    launch per block-engine iteration."""
    from distributed_processor_tpu_torch.ops.exec_span import (exec_blocks,
                                                               exec_span)
    for k, mp in enumerate(_block_programs()):
        rng = np.random.default_rng(20 + k)
        B = 3000
        bits = torch.as_tensor(rng.integers(0, 2, (B, mp.n_cores, 8)),
                               dtype=torch.int32, device=card)
        kw = dict(mp.static_bounds(), max_meas=8, max_resets=128,
                  record_pulses=record, opcode_histogram=True)
        before, span_before = exec_blocks.launches, exec_span.launches
        got = simulate_batch(mp, bits, cfg=InterpreterConfig(
            engine='pallas', **kw), device=card)
        assert exec_blocks.launches - before == int(got['steps'])
        assert exec_span.launches == span_before
        want = simulate_batch(mp, bits, cfg=InterpreterConfig(
            engine='block', **kw), device=card)
        torch.cuda.synchronize()
        _assert_same(got, want)
        assert not bool(got['incomplete'])


def test_k1_block_serves_auto_on_the_card(card):
    from distributed_processor_tpu_torch.ops.exec_span import exec_blocks
    mp = looped_program()
    bits = torch.zeros((64, mp.n_cores, 8), dtype=torch.int32, device=card)
    before = exec_blocks.launches
    out = simulate_batch(mp, bits, cfg=InterpreterConfig(
        engine='auto', **mp.static_bounds(), max_meas=8), device=card)
    assert exec_blocks.launches - before == int(out['steps']) > 0
    assert bool(out['done'].all())


def test_block_physics_on_card_matches_cpu(card):
    """The block engine's physics mode (plain bodies, K2 per epoch) on
    the card against the CPU at sigma = 0: bits and integer outputs
    identical."""
    mp = looped_program()
    B = 256
    init = np.random.default_rng(8).integers(0, 2, (B, mp.n_cores))
    cfg = InterpreterConfig(**mp.static_bounds(), max_meas=8, max_resets=2,
                            record_pulses=False, engine='auto')
    model = ReadoutPhysics(sigma=0.0, resolve_mode='fused',
                           resolve_chunk=256)
    before = resolve_windows_fused.launches
    outs = {d: run_physics_batch(mp, model, 1, B, init_states=init, cfg=cfg,
                                 device=d) for d in (card, 'cpu')}
    assert resolve_windows_fused.launches - before \
        == int(outs[card]['epochs'])
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'n_meas', 'err',
                'fault', 'qturns', 'epochs', 'steps'):
        assert torch.equal(outs[card][key].cpu(), outs['cpu'][key]), key
    assert bool(outs['cpu']['meas_bits_valid'].all())


def test_k1_block_rejects_bad_inputs(card):
    from distributed_processor_tpu_torch.ops.exec_span import (block_table,
                                                               exec_blocks)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _block_plan, _init_state, _program_constants, _soa_np)
    mp = looped_program()
    cfg = InterpreterConfig(max_meas=8)
    _soa, spc, interp, _sync = _program_constants(mp, card)
    st = _init_state(8, mp.n_cores, cfg, None, card)
    soa_np = _soa_np(mp)
    bid_at, bodies = _block_plan(soa_np)
    with pytest.raises(ValueError, match='block table'):
        block_table(soa_np, bid_at[:-1], bodies, spc, interp, cfg)
    with pytest.raises(ValueError, match='block table'):
        block_table(soa_np, bid_at, [(0, mp.n_instr)], spc, interp, cfg)
    table = block_table(soa_np, bid_at, bodies, spc, interp, cfg)
    with pytest.raises(ValueError, match='physics'):
        exec_blocks(st, table, dataclasses.replace(cfg, physics=True))
    cpu_table = block_table(soa_np, bid_at, bodies, spc.cpu(), interp.cpu(),
                            cfg)
    with pytest.raises(ValueError, match='block table lies on'):
        exec_blocks(st, cpu_table, cfg)


# ---------------------------------------------------------------------------
# the waveform kernel K4 (csrc/waveform.cu) and the demod kernel K5
# (csrc/demod.cu)


def _capture_records(seed, interp, n_clks=65536, spc=16, P=64, L=1024):
    """A long capture: P seeded non-overlapping pulses, one of them CW
    and one running past the end of its envelope table."""
    rng = np.random.default_rng(seed)
    slot = n_clks // P
    gtime = np.arange(P) * slot + rng.integers(0, slot // 8, P)
    nw = rng.integers(1, min(max(2, slot * spc // (8 * interp)), L // 8), P)
    nw[40] = max(nw[40], 8)
    addr = rng.integers(0, (L - 4 * nw) // 4)
    addr[40] = (L - 2 * nw[40]) // 4                    # overruns the table
    nw[20], addr[20] = 0xfff, rng.integers(0, L // 4)   # CW
    rec = dict(gtime=gtime.astype(np.int32),
               env=((nw << 12) | addr).astype(np.int32),
               phase=rng.integers(0, 1 << 17, P).astype(np.int32),
               freq_rel=rng.uniform(0, 0.5, P).astype(np.float32),
               amp=rng.integers(1 << 12, 1 << 16, P).astype(np.int32),
               elem=np.zeros(P, np.int32), n_pulses=np.int32(P))
    env = (rng.uniform(-1, 1, L) + 1j * rng.uniform(-1, 1, L)) * 0.7
    return rec, env


@pytest.mark.parametrize('interp', [1, 16])
@pytest.mark.parametrize('n_clks', [65536, 4099])
def test_k4_long_capture_matches_plain_version(card, interp, n_clks):
    """``synthesize_element`` on the card: a one-trace call of the render
    kernel (one launch), from numpy records and from records on the
    card."""
    from distributed_processor_tpu_torch.ops.waveform import (
        render_shot, synthesize_element, synthesize_element_reference)
    rec, env = _capture_records(3 + interp, interp, n_clks=n_clks)
    before = render_shot.launches
    got = synthesize_element(rec, env, 16, interp, n_clks, device=card)
    assert render_shot.launches == before + 1
    want = synthesize_element_reference(rec, env, 16, interp, n_clks,
                                        device=card)
    torch.cuda.synchronize()
    assert got.shape == (16 * n_clks, 2) and got.dtype == torch.float32
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # tensors on the card as records take the kernel too, with no device=
    trec = {k: torch.as_tensor(v, device=card) for k, v in rec.items()}
    again = synthesize_element(trec, env, 16, interp, n_clks)
    assert render_shot.launches == before + 2
    assert torch.equal(again, got)


def test_k4_headline_render_matches_cpu(card, program):
    """``Simulator.waveforms`` on the card (one K4 launch per call, every
    trace of the shot) against the CPU's plain render of the same
    records, atol 1e-5, for a batched and an unbatched run."""
    from distributed_processor_tpu_torch import Simulator
    from distributed_processor_tpu_torch.ops.waveform import render_shot
    sim = Simulator(n_qubits=3, device=card)
    cpu = Simulator(n_qubits=3, device='cpu')
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (16, program.n_cores, 16))
    batched = sim.run(program, shots=16, meas_bits=bits)
    single = sim.run(program, meas_bits=bits[5])
    assert single['n_pulses'].dim() == 1
    for out, shot in ((batched, 0), (batched, 5), (single, None)):
        before = render_shot.launches
        wf = sim.waveforms(out, shot=shot)
        assert render_shot.launches == before + 1
        ref = cpu.waveforms(out, shot=shot)
        assert render_shot.launches == before + 1
        assert sorted(wf) == sorted(ref) == [0, 1, 2]
        for c in ref:
            assert len(wf[c]) == len(ref[c]) == 3
            for got, want in zip(wf[c], ref[c]):
                assert got.shape == want.shape and np.abs(want).max() > 0
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for c in range(3):
        for a, b in zip(sim.waveforms(batched, shot=5)[c],
                        sim.waveforms(single)[c]):
            np.testing.assert_array_equal(a, b)


def _synthetic_render(seed, n_clks, rows=48, dense=False):
    """Seeded records of 3 cores x 3 elements and a render table of three
    geometries (spc 16 / 4 / 3, interp 1 / 16 / 3): CW pulses (two that
    tie in start), windows past their table, an element with no pulses
    (core 2, element 1), ``n_pulses`` below the row count, frequency
    addresses past the table; ``dense``: 700 short pulses of one element
    in the first 1024 samples, overlapping, more than one block stages at
    once.  Returns ``(out dict of numpy records, table on the card)``."""
    from distributed_processor_tpu_torch.ops import waveform as wv
    rng = np.random.default_rng(seed)
    C, geometry = 3, ((16, 1), (4, 16), (3, 3))
    if dense:
        rows = 700
    rec = {k: np.zeros((C, rows), np.int32) for k in
           ('gtime', 'env', 'phase', 'amp', 'elem', 'freq', 'dur')}
    for c in range(C):
        if dense:
            gtime = rng.integers(0, 1024 // 16, rows)
            nw = rng.integers(1, 4, rows)
            elem = np.zeros(rows, np.int64)
        else:
            gtime = np.sort(rng.integers(0, n_clks, rows))
            nw = rng.integers(1, 40, rows)
            elem = rng.integers(0, 3, rows)
            if c == 2:
                elem[elem == 1] = 0              # no pulse on element 1
        nw[rng.random(rows) < 0.1] = 0xfff       # CW
        if not dense:
            gtime[7] = gtime[6]                  # a tie in start ...
            nw[6] = 0xfff                        # ... after a CW pulse
            elem[7] = elem[6]
        addr = rng.integers(0, 60, rows)         # some run past the table
        rec['gtime'][c], rec['elem'][c] = gtime, elem
        rec['env'][c] = (nw << 12) | addr
        rec['phase'][c] = rng.integers(0, 1 << 17, rows)
        rec['amp'][c] = rng.integers(1 << 12, 1 << 16, rows)
        rec['freq'][c] = rng.integers(0, 6, rows)  # 5: past a 4-word table
    out = {'rec_' + k: v for k, v in rec.items()}
    out['n_pulses'] = np.asarray([rows, rows - 5, rows // 2], np.int32)
    envs, words, geo = [], [], []
    for c in range(C):
        for e, (spc, interp) in enumerate(geometry):
            L = int(rng.integers(1, 200))
            envs.append(rng.uniform(-0.9, 0.9, (L, 2)).astype(np.float32))
            words.append(wv._nco_words(np.append(
                rng.uniform(-0.45, 0.45, 4), 0.0)))
            geo.append((c, e, spc, interp, L, len(words[-1])))
    table = wv.make_table(wv._table_rows(geo), np.concatenate(envs),
                          np.concatenate(words), 'cuda')
    return out, table


@pytest.mark.parametrize('n_clks,dense', [(777, False), (64, False),
                                          (100, True)],
                         ids=['ragged', 'short', 'dense'])
def test_k4_render_matches_plain_version(card, n_clks, dense):
    """The render kernel against its plain version on the card, atol
    1e-5: three geometries, an n_clks no multiple of the tile, CW ties,
    overrun windows, an empty element, records on the card and as numpy,
    and more pulses in one tile than a block stages at once."""
    from distributed_processor_tpu_torch.ops import waveform as wv
    out, table = _synthetic_render(11 + n_clks, n_clks, dense=dense)
    rec_np = wv.shot_records(out, None, card)          # numpy: one copy
    on_card = {k: torch.as_tensor(v, device=card) for k, v in out.items()}
    rec_dev = wv.shot_records(on_card, None, card)     # views, no copy
    assert all(rec_dev[k].data_ptr() == on_card['rec_' + k].data_ptr()
               for k in wv._REC_FIELDS)
    before = wv.render_shot.launches
    got = wv.render_shot(rec_np, table, n_clks)
    again = wv.render_shot(rec_dev, table, n_clks)
    assert wv.render_shot.launches == before + 2
    want = wv._render_plain(rec_dev, table, n_clks)
    torch.cuda.synchronize()
    assert got.shape == (n_clks * table.spc_total, 2)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(again, got)
    traces = wv.split_traces(got, table, n_clks)
    assert not traces[2][1].any()                      # no pulses there
    assert all(traces[c][e].shape[0] == n_clks * spc for c in range(3)
               for e, spc in enumerate((16, 4, 3)))


def test_k4_renders_from_two_threads(card, program):
    """Two host threads render at once, the table cache cleared first:
    one table, and each thread's traces equal the CPU's."""
    import threading
    from distributed_processor_tpu_torch import Simulator
    from distributed_processor_tpu_torch.ops import waveform as wv
    sim = Simulator(n_qubits=3, device=card)
    bits = np.random.default_rng(9).integers(0, 2, (8, program.n_cores, 16))
    out = sim.run(program, shots=8, meas_bits=bits)
    ref = {s: Simulator(n_qubits=3, device='cpu').waveforms(out, shot=s)
           for s in (1, 6)}
    with wv._TABLES_LOCK:
        wv._TABLES.clear()
    got, errors, barrier = {}, [], threading.Barrier(2)

    def render(shot):
        try:
            barrier.wait()
            for _ in range(5):
                got[shot] = sim.waveforms(out, shot=shot)
        except Exception as exc:                   # reported below
            errors.append(exc)

    threads = [threading.Thread(target=render, args=(s,)) for s in (1, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(wv._TABLES) == 1
    for s in (1, 6):
        for c in ref[s]:
            for a, b in zip(got[s][c], ref[s][c]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_k4_rejects_bad_inputs(card):
    from distributed_processor_tpu_torch.ops import waveform as wv
    out, table = _synthetic_render(5, 64)
    rec = wv.shot_records(out, None, card)
    with pytest.raises(ValueError, match='amp must'):
        wv.render_shot(dict(rec, amp=rec['amp'][:, :-1]), table, 64)
    with pytest.raises(ValueError, match='env must'):
        wv.render_shot(dict(rec, env=rec['env'].long()), table, 64)
    with pytest.raises(ValueError, match='phase must'):
        wv.render_shot(dict(rec, phase=rec['phase'].cpu()), table, 64)
    with pytest.raises(ValueError, match='lies on cuda'):
        wv.render_shot({k: v.cpu() for k, v in rec.items()}, table, 64)
    with pytest.raises(ValueError, match='n_pulses'):
        wv.render_shot(dict(rec, n_pulses=rec['n_pulses'][:2]), table, 64)
    strided = rec['phase'].t().contiguous().t()
    with pytest.raises(ValueError, match='phase must'):
        wv.render_shot(dict(rec, phase=strided), table, 64)
    cpu_table = table._replace(traces=table.traces.cpu())
    with pytest.raises(ValueError, match='traces'):
        wv.render_shot(rec, cpu_table, 64)
    with pytest.raises(ValueError, match='n_clks'):
        wv.render_shot(rec, table, -1)
    with pytest.raises(ValueError, match='n_clks'):
        wv.render_shot(rec, table, 1 << 28)
    two = {k: v[:2] for k, v in rec.items()}
    with pytest.raises(ValueError, match='renders 3 cores'):
        wv.render_shot(two, table, 64)
    with pytest.raises(ValueError, match='spc'):
        wv._table_rows([(0, 0, 0, 1, 4, 2)])
    with pytest.raises(ValueError, match='reach past'):
        wv.make_table(table.rows, table.env[:5], table.inc, card)
    with pytest.raises(ValueError, match='float32'):
        wv.make_table(table.rows, table.env.double(), table.inc, card)
    # a zero-length render makes no launch
    before = wv.render_shot.launches
    assert wv.render_shot(rec, table, 0).shape == (0, 2)
    assert wv.render_shot.launches == before


@pytest.mark.parametrize('S,N,J', [
    (262144, 1024, 8), (262144 - 37, 1024, 8), (262144, 1024, 2),
    (4099, 2501, 12), (1, 3, 2), (1000, 64, 6)],
    ids=['full', 'ragged', '2M=2', 'tiled-unaligned-wide', 'tiny', 'N=64'])
def test_k5_matches_plain_version(card, S, N, J):
    from distributed_processor_tpu_torch.ops.demod import (
        demod_iq, demod_iq_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card)
    gen.manual_seed(S + N + J)
    adc = torch.randn((S, N), generator=gen, device=card)
    w = torch.randn((N, J), generator=gen, device=card)
    before = demod_iq.launches
    got = demod_iq(adc, w)
    assert demod_iq.launches == before + 1
    want = demod_iq_reference(adc, w)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (S, J // 2, 2) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
    # a strided view is made contiguous, a numpy weight matrix is moved
    got2 = demod_iq(adc.t().contiguous().t(), w.cpu().numpy())
    torch.testing.assert_close(got2, want, rtol=2e-5, atol=2e-4)


def test_k5_readout_chain_on_card(card):
    """ADC traces -> demod -> discriminate on the card: bits equal to the
    CPU chain's away from the threshold, fidelity high."""
    from distributed_processor_tpu_torch.ops import (
        demod_and_discriminate, demod_iq, pulse_window_weights,
        stack_window_weights)
    rng = np.random.default_rng(1)
    fsamp, fr, spc, n_clks, shots = 2e9, 0.05, 4, 64, 5000
    N = n_clks * spc
    n = np.arange(N)
    states = rng.integers(0, 2, shots)
    phase = np.where(states, np.pi / 2, 0.0)
    adc = np.real(np.exp(2j * np.pi * fr * n[None, :] + 1j * phase[:, None]))
    adc = (adc + 0.5 * rng.standard_normal((shots, N))).astype(np.float32)
    w = stack_window_weights([pulse_window_weights(0, n_clks, spc,
                                                   fr * fsamp, fsamp)], N)
    c0 = np.array([N / 2 + 0j])
    c1 = np.array([(N / 2) * np.exp(1j * np.pi / 2)])
    before = demod_iq.launches
    bits, iq = demod_and_discriminate(torch.as_tensor(adc, device=card), w,
                                      c0, c1)
    assert demod_iq.launches == before + 1 and bits.device.type == 'cuda'
    bits_cpu, iq_cpu = demod_and_discriminate(adc, w, c0, c1)
    torch.testing.assert_close(iq.cpu(), iq_cpu, rtol=2e-5, atol=2e-4)
    assert np.mean(bits.cpu().numpy()[:, 0] == states) > 0.99
    assert int((bits.cpu() != bits_cpu).sum()) <= 2


def test_k5_rejects_bad_inputs(card):
    from distributed_processor_tpu_torch.ops.demod import demod_iq
    adc = torch.zeros((8, 16), device=card)
    with pytest.raises(ValueError, match='2M'):
        demod_iq(adc, torch.zeros((16, 3), device=card))
    with pytest.raises(ValueError, match='2M'):
        demod_iq(adc, torch.zeros((15, 2), device=card))
    before = demod_iq.launches
    assert tuple(demod_iq(adc[:0], torch.zeros((16, 4), device=card)).shape) \
        == (0, 2, 2)
    assert demod_iq.launches == before        # nothing to launch


# ---------------------------------------------------------------------------
# the 'lut' fabric: K1 span (tile and one thread per lane), K1 block and K3
# with the time-indexed LUT read, against their plain versions


def _lut_fuzz(C, seed):
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    mp, mask, table = lut_feedback_program(
        np.random.default_rng(seed), isa, machine_program_from_cmds,
        n_cores=C)
    return mp, InterpreterConfig(fabric='lut', lut_mask=mask,
                                 lut_table=table, max_meas=8, max_pulses=24,
                                 record_pulses=True, opcode_histogram=True)


@pytest.mark.parametrize('C', [3, 5, 9])
@pytest.mark.parametrize('B', [1, 33, 1001])
def test_lut_k1_span_matches_plain_version(card, B, C):
    """K1 span under the 'lut' fabric, the tile kernel and one thread per
    lane, against the straight-line engine on the card: random LUT
    programs (reads into registers and branches, jumps past the split,
    starved lanes) at batches that cut tiles (32 shots) and shot-aligned
    blocks (256 // C shots) raggedly — every key identical."""
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_span_per_lane, exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, _init_state, _span_table)
    mp, cfg = _lut_fuzz(C, 70 * C + B)
    rng = np.random.default_rng(B)
    table = _span_table(mp, cfg, card)
    assert table.lut is not None and table.min_read < mp.n_instr
    init = torch.as_tensor(rng.integers(-3, 3, (B, C, 16)),
                           dtype=torch.int32, device=card)
    st = _init_state(B, C, cfg, init, card)
    bits = torch.as_tensor(rng.integers(0, 2, (B, C, 8)), dtype=torch.int32,
                           device=card)
    want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                              bits, torch.ones_like(bits, dtype=torch.bool),
                              cfg)
    for run in (exec_span, _exec_span_per_lane):
        got = run(st, table, bits, cfg)
        torch.cuda.synchronize()
        _assert_same(got, want)


@pytest.mark.parametrize('workload', ['repetition8', 'surface5'])
def test_lut_workloads_take_k1_on_the_card(card, workload):
    """The repetition round (8 cores) and the surface cycle (9 cores) on
    ``engine='pallas'`` and ``'auto'`` (one K1 launch each) against the
    straight-line and generic engines on the card."""
    from distributed_processor_tpu_torch.models import qec, repetition
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    mp, cfg = (repetition.repetition_round_machine_program(8),
               repetition.repetition_config(8)) \
        if workload == 'repetition8' else \
        (qec.surface_cycle_machine_program(5), qec.surface_cycle_config(5))
    B = 2001
    bits = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, (B, mp.n_cores, 2)), dtype=torch.int32, device=card)
    outs = {}
    for eng in ('pallas', 'auto', 'straightline', 'generic'):
        before = exec_span.launches
        outs[eng] = simulate_batch(mp, bits, cfg=dataclasses.replace(
            cfg, engine=eng), device=card)
        assert exec_span.launches - before == (eng in ('pallas', 'auto'))
    torch.cuda.synchronize()
    for eng in ('auto', 'straightline'):
        _assert_same(outs['pallas'], outs[eng])
    for key in outs['generic']:
        if key != 'steps':
            assert torch.equal(outs['pallas'][key], outs['generic'][key]), key


def test_lut_k1_block_matches_plain_version(card):
    """The multi-round QEC program (every round's measurement after the
    previous round's read: block mode) on ``engine='pallas'`` (K1 block,
    one launch per iteration) against the plain block engine."""
    from distributed_processor_tpu_torch.models import qec
    from distributed_processor_tpu_torch.ops.exec_span import exec_blocks
    mp, cfg = qec.qec_multiround_machine_program(8, 4), qec.qec_config(8, 4)
    B = 3001
    bits = torch.as_tensor(np.random.default_rng(4).integers(
        0, 2, (B, 8, 4)), dtype=torch.int32, device=card)
    before = exec_blocks.launches
    got = simulate_batch(mp, bits, cfg=dataclasses.replace(
        cfg, engine='pallas', opcode_histogram=True), device=card)
    assert exec_blocks.launches - before == int(got['steps']) > 0
    want = simulate_batch(mp, bits, cfg=dataclasses.replace(
        cfg, engine='block', opcode_histogram=True), device=card)
    torch.cuda.synchronize()
    _assert_same(got, want)
    assert not bool(got['incomplete'])


@pytest.mark.parametrize('n', [3, 9])
def test_lut_k3_matches_plain_version_and_generic(card, n):
    """The compiled repetition round closed at sigma = 0 on
    ``engine='fused'`` (K3 with the LUT read; at 9 cores a block of 252
    lanes holds 28 shots) against its plain version on the CPU and the
    generic engine on the card: every key identical, one epoch, every
    core corrected to its pattern's majority."""
    from distributed_processor_tpu_torch.models import repetition
    from distributed_processor_tpu_torch.ops.exec_span import exec_span_fused
    from distributed_processor_tpu_torch.simulator import Simulator
    mp = Simulator(n_qubits=n, device=card).compile(
        repetition.repetition_round_program(n))
    B = 1001
    init = np.array([[(s >> i) & 1 for i in range(n)]
                     for s in range(B)])
    cfg = InterpreterConfig(max_steps=mp.n_instr * 6 + 64,
                            **repetition.repetition_physics_kwargs(n))
    model = ReadoutPhysics(sigma=0.0)
    before = exec_span_fused.launches
    fused = run_physics_batch(mp, model, 1, B, init_states=init,
                              cfg=dataclasses.replace(cfg, engine='fused'),
                              device=card)
    assert exec_span_fused.launches == before + 1
    plain = run_physics_batch(mp, model, 1, B, init_states=init,
                              cfg=dataclasses.replace(cfg, engine='fused'),
                              device='cpu')
    _assert_same(fused, plain)
    generic = run_physics_batch(mp, model, 1, B, init_states=init,
                                cfg=dataclasses.replace(cfg,
                                                        engine='generic'),
                                device=card)
    for key in generic:
        if key not in ('epochs', 'steps'):
            assert torch.equal(fused[key], generic[key]), key
    assert int(fused['epochs']) == 1
    maj = (init.sum(1) * 2 > n).astype(np.int32)
    np.testing.assert_array_equal(fused['qturns'].cpu().numpy() % 4 // 2,
                                  np.broadcast_to(maj[:, None], (B, n)))


def test_lut_rejects_mismatched_tables(card):
    """A LUT run needs a span table built for its fabric, and a sticky
    run one without the LUT: the wrapper raises rather than launch."""
    from distributed_processor_tpu_torch.models import repetition
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        _init_state, _span_table)
    mp, cfg = repetition.repetition_round_machine_program(3), \
        repetition.repetition_config(3)
    sticky = dataclasses.replace(cfg, fabric='sticky')
    bits = torch.zeros((8, 3, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match='fabric'):
        exec_span(_init_state(8, 3, cfg, None, card),
                  _span_table(mp, sticky, card), bits, cfg)
    with pytest.raises(ValueError, match='fabric'):
        exec_span(_init_state(8, 3, sticky, None, card),
                  _span_table(mp, cfg, card), bits, sticky)


# ---------------------------------------------------------------------------
# streaming rounds (K1 span / K1 block over R x B lanes) and ensembles


def test_rounds_span_matches_cpu(card):
    """``simulate_rounds(engine='pallas')`` on the 4-core repetition round
    with the decode: one K1 span launch for all R x B lanes, every key
    identical to the same call on the CPU (the plain version)."""
    from distributed_processor_tpu_torch.models import qec
    from distributed_processor_tpu_torch.ops.exec_span import (exec_blocks,
                                                               exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_rounds
    mp = qec.qec_round_machine_program(4)
    cfg = dataclasses.replace(qec.qec_config(4, opcode_histogram=True),
                              engine='pallas')
    mb = np.random.default_rng(40).integers(0, 2, (6, 1001, 4, cfg.max_meas))
    spec = qec.repetition_decode_spec(4)
    before, blocks = exec_span.launches, exec_blocks.launches
    got = simulate_rounds(mp, mb, cfg=cfg, decode=spec, device=card)
    assert exec_span.launches == before + 1
    assert exec_blocks.launches == blocks
    want = simulate_rounds(mp, mb, cfg=cfg, decode=spec, device='cpu')
    torch.cuda.synchronize()
    _assert_same(got, want)


def test_rounds_blocks_match_cpu(card):
    """``simulate_rounds(engine='pallas')`` on a looping program: one K1
    block launch per block-engine iteration (the slowest round's
    ``steps``), every key identical to the CPU's."""
    from distributed_processor_tpu_torch.ops.exec_span import (exec_blocks,
                                                               exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_rounds
    mp = looped_program()
    kw = dict(mp.static_bounds(), max_meas=8, max_resets=2,
              opcode_histogram=True, engine='pallas')
    mb = np.random.default_rng(41).integers(0, 2, (3, 700, mp.n_cores, 8))
    before, span = exec_blocks.launches, exec_span.launches
    got = simulate_rounds(mp, mb, cfg=InterpreterConfig(**kw), device=card)
    assert exec_blocks.launches - before == int(got['steps'].max()) > 0
    assert exec_span.launches == span
    want = simulate_rounds(mp, mb, cfg=InterpreterConfig(**kw),
                           device='cpu')
    torch.cuda.synchronize()
    _assert_same(got, want)


def test_multi_batch_matches_cpu(card):
    """``simulate_multi_batch`` of four RB programs (two depths, so one is
    DONE-padded): the card's generic pass equal to the CPU's on every
    key, no kernel launched."""
    from distributed_processor_tpu_torch.models import rb_ensemble
    from distributed_processor_tpu_torch.ops.exec_span import (exec_blocks,
                                                               exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_multi_batch
    qubits = ['Q0', 'Q1', 'Q2']
    qchip = make_default_qchip(3)
    mps = [compile_to_machine(active_reset(qubits) + p, qchip, n_qubits=3)
           for depth in (2, 5)
           for p in rb_ensemble(qubits, depth, 2, seed=depth)]
    bits = np.random.default_rng(42).integers(0, 2, (4, 513, 3, 2))
    kw = dict(max_meas=2, max_resets=2, opcode_histogram=True)
    launches = (exec_span.launches, exec_blocks.launches)
    got = simulate_multi_batch(mps, bits, device=card, **kw)
    assert (exec_span.launches, exec_blocks.launches) == launches
    want = simulate_multi_batch(mps, bits, device='cpu', **kw)
    torch.cuda.synchronize()
    _assert_same(got, want)
    assert not bool(got['incomplete'].any())


# ---------------------------------------------------------------------------
# The mesh paths at world size 1 on the card (a one-rank NCCL group):
# each equal to the same work on the CPU, every key.


def _card_mesh(card, cores: bool = False):
    from distributed_processor_tpu_torch.parallel import (make_cores_mesh,
                                                          make_mesh)
    return make_cores_mesh(device=card) if cores else make_mesh(device=card)


def test_mesh_stat_sums_pallas_match_cpu(card, program):
    """``sweep_stat_sums`` with ``engine='pallas'`` on a one-rank mesh:
    one K1 span launch, the sums equal the CPU's single-device run."""
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.parallel import sweep_stat_sums
    cfg = _span_cfg(program, record_pulses=False)
    bits = np.random.default_rng(50).integers(
        0, 2, (4099, program.n_cores, cfg.max_meas)).astype(np.int32)
    before = exec_span.launches
    got = sweep_stat_sums(program, bits, _card_mesh(card),
                          cfg=dataclasses.replace(cfg, engine='pallas'),
                          device=card)
    assert exec_span.launches == before + 1
    out = simulate_batch(program, bits, cfg=cfg, device='cpu')
    assert got['pulse_sum'].tolist() == out['n_pulses'].sum(0).tolist()
    assert got['qclk_sum'].tolist() == out['qclk'].sum(0).tolist()
    assert int(got['err_shots']) == int((out['err'] != 0).any(1).sum())


def test_mesh_cores_block_matches_cpu(card):
    """``sharded_cores_simulate(engine='block')`` on a one-rank cores
    mesh: one K1 block launch per block-engine iteration, every key
    equal to the CPU's generic engine."""
    from distributed_processor_tpu_torch.ops.exec_span import exec_blocks
    from distributed_processor_tpu_torch.parallel import \
        sharded_cores_simulate
    mp = looped_program()
    kw = dict(mp.static_bounds(), max_meas=8, max_resets=2)
    bits = np.random.default_rng(51).integers(0, 2, (777, mp.n_cores, 8))
    before = exec_blocks.launches
    got = sharded_cores_simulate(mp, bits, _card_mesh(card, cores=True),
                                 cfg=InterpreterConfig(engine='block', **kw),
                                 device=card)
    assert exec_blocks.launches > before
    want = simulate_batch(mp, bits, cfg=InterpreterConfig(engine='generic',
                                                          **kw),
                          device='cpu')
    for k in ('steps', 'incomplete'):
        want.pop(k)
    _assert_same(got, want)


def test_mesh_physics_and_demod_match_cpu(card, program):
    """The one-rank dp mesh's physics sweep at sigma = 0 and p1_init = 1
    (deterministic: card = CPU), K3's sharded sums at sigma = 0, and
    ``sharded_demod`` (K5) against the plain product on the CPU."""
    from distributed_processor_tpu_torch.ops.demod import (
        demod_iq, demod_iq_reference)
    from distributed_processor_tpu_torch.parallel import (
        run_physics_sweep, sharded_demod, sharded_physics_stat_sums)
    model = ReadoutPhysics(sigma=0.0, p1_init=1.0)
    kw = dict(max_steps=4 * program.n_instr + 64, max_pulses=32, max_meas=4)
    mesh = _card_mesh(card)
    got = run_physics_sweep(program, model, 3 * 1024, 1024, seed=1,
                            mesh=mesh, span=2, device=card, **kw)
    want = run_physics_sweep(program, model, 3 * 1024, 1024, seed=1,
                             device='cpu', **kw)
    for k in ('mean_pulses', 'meas1_rate', 'clean_shots', 'err_shots',
              'fault_shots', 'survival00_rate'):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    quiet = ReadoutPhysics(sigma=0.0, p1_init=0.0)
    fused = sharded_physics_stat_sums(program, quiet, 2, 1024, mesh,
                                      engine='fused', device=card, **kw)
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import derive_seed
    plain = physics_batch_stats(run_physics_batch(
        program, quiet, derive_seed(2, 0), 1024, engine='fused',
        device='cpu', **kw))
    for k in plain:
        assert fused[k].tolist() == plain[k].tolist(), k
    adc = torch.randn((4096, 1024), generator=torch.Generator().manual_seed(
        3)).to(card)
    w = torch.randn((1024, 8), generator=torch.Generator().manual_seed(4))
    before = demod_iq.launches
    acc = sharded_demod(adc, w, mesh, device=card)
    assert demod_iq.launches == before + 1
    torch.testing.assert_close(acc.cpu(), demod_iq_reference(adc.cpu(), w),
                               rtol=2e-5, atol=2e-4)



def test_service_on_card_matches_direct_calls(card, program):
    """The execution service on the card (``devices=None``: one executor
    on CUDA with its own stream): coalesced requests, a K1 span singleton
    and a stream chunk, each equal on every key to the direct call on
    the card; the kernels' launches counted exactly."""
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.serve import ExecutionService
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_rounds
    rng = np.random.default_rng(61)
    cfg = InterpreterConfig(max_meas=4, max_resets=4)
    bits = [rng.integers(0, 2, (64 + 16 * i, program.n_cores, 4))
            .astype(np.int32) for i in range(4)]
    with ExecutionService(cfg, max_batch_programs=4,
                          max_wait_ms=20.0) as svc:
        hs = [svc.submit(program, b) for b in bits]
        got = [h.result(timeout=120) for h in hs]
    for b, g in zip(bits, got):
        want = simulate_batch(program, b, cfg=cfg, device=card)
        for k, v in want.items():
            np.testing.assert_array_equal(g[k], v.cpu().numpy(), err_msg=k)
    before = exec_span.launches
    with ExecutionService(cfg, singleton_engine='pallas',
                          max_batch_programs=1, max_wait_ms=1.0) as svc:
        g = svc.submit(program, bits[0]).result(timeout=120)
        rb = rng.integers(0, 2, (4, 32, program.n_cores, 4)).astype(np.int32)
        rcfg = dataclasses.replace(cfg, engine='pallas')
        gr = svc.submit_rounds(program, rb, cfg=rcfg).result(timeout=120)
    assert exec_span.launches - before == 2
    want = simulate_batch(program, bits[0], cfg=rcfg, device=card)
    for k, v in want.items():
        np.testing.assert_array_equal(g[k], v.cpu().numpy(), err_msg=k)
    # a stream chunk's dispatch cfg drops the pulse records
    want = simulate_rounds(program, rb, cfg=dataclasses.replace(
        rcfg, record_pulses=False), device=card)
    assert set(gr) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(gr[k], v.cpu().numpy(), err_msg=k)


def test_fleet_on_card_matches_direct_calls(card, program):
    """Two replica processes on the card (one CUDA context and one
    executor each) behind the fleet router: a coalesced RB request and
    an 8-qubit headline request on K1 span (``singleton_engine=
    'pallas'``), each equal on every key to the direct call on the card;
    the replicas count the K1 span dispatch, and no replica process
    outlives the fleet."""
    from distributed_processor_tpu_torch.models import active_reset
    from distributed_processor_tpu_torch.serve import Fleet
    rng = np.random.default_rng(62)
    cfg = InterpreterConfig(max_meas=4, max_resets=4)
    rb_bits = rng.integers(0, 2, (256, program.n_cores, 4)).astype(np.int32)
    qubits = [f'Q{i}' for i in range(8)]
    head = compile_to_machine(active_reset(qubits)
                              + rb_program(qubits, 12, seed=1234),
                              make_default_qchip(8), n_qubits=8)
    hcfg = InterpreterConfig(max_steps=2 * head.n_instr + 64,
                             max_pulses=int(head.max_pulses_per_core(1)) + 4,
                             max_meas=2, max_resets=2, record_pulses=False)
    h_bits = rng.integers(0, 2, (8192, head.n_cores, 2)).astype(np.int32)
    with Fleet(2, service={'max_batch_programs': 4, 'max_wait_ms': 5.0},
               ready_timeout_s=300.0) as rb_fleet:
        g = rb_fleet.submit(program, rb_bits, cfg=cfg).result(timeout=300)
        eng = [rb_fleet.replica_stats(i)['engine_dispatches']
               for i in range(2)]
        procs = [s.proc for s in rb_fleet._replicas]
    assert all(p.poll() is not None for p in procs)
    assert sum(e.get('generic', 0) for e in eng) == 1
    want = simulate_batch(program, rb_bits, cfg=cfg, device=card)
    for k, v in want.items():
        np.testing.assert_array_equal(g[k], v.cpu().numpy(), err_msg=k)
    with Fleet(2, service={'singleton_engine': 'pallas',
                           'max_batch_programs': 1, 'max_wait_ms': 1.0},
               ready_timeout_s=300.0) as k1_fleet:
        g = k1_fleet.submit(head, h_bits, cfg=hcfg).result(timeout=300)
        eng = [k1_fleet.replica_stats(i)['engine_dispatches']
               for i in range(2)]
    assert sum(e.get('pallas', 0) for e in eng) == 1
    want = simulate_batch(head, h_bits, cfg=dataclasses.replace(
        hcfg, engine='pallas'), device=card)
    for k, v in want.items():
        np.testing.assert_array_equal(g[k], v.cpu().numpy(), err_msg=k)


def _kernel_wrappers() -> dict:
    from distributed_processor_tpu_torch.ops.demod import demod_iq
    from distributed_processor_tpu_torch.ops.exec_span import (
        exec_blocks, exec_span, exec_span_fused)
    from distributed_processor_tpu_torch.ops.waveform import render_shot
    return {w.__name__: w for w in (exec_span, exec_blocks,
                                    exec_span_fused, render_shot,
                                    demod_iq)}


def _launches_of(fn) -> dict:
    wrappers = _kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    fn()
    return {k: w.launches - before[k] for k, w in wrappers.items()}


def test_kernel_parity_check_on_card(card):
    """The self-test on the card: K5, K4, K1 span, K1 block and K3 held
    against their plain versions, each launched."""
    from distributed_processor_tpu_torch.ops.selftest import \
        kernel_parity_check
    launched = _launches_of(lambda: kernel_parity_check('cuda'))
    assert all(n > 0 for n in launched.values()), launched
    launched = _launches_of(kernel_parity_check)       # the default: the card
    assert all(n > 0 for n in launched.values()), launched


def test_fault_injection_on_card(card):
    """The fault-injection harness on the card: K1 span and K1 block as
    a fourth engine on every mutant, the feedback check on K1 and the
    fused check on K3, with no failure."""
    from distributed_processor_tpu_torch.sim import faultinject as fi
    rep = None

    def fuzz():
        nonlocal rep
        rep = fi.run_fuzz(seed=0, n=35, engines=fi.ENGINES + ('pallas',),
                          device=card)
    launched = _launches_of(fuzz)
    assert rep.ok, rep.failures
    assert launched['exec_span'] > 0 and launched['exec_blocks'] > 0
    res = {}
    launched = _launches_of(lambda: res.update(
        feedback=fi.check_feedback_consistency(device=card),
        fused=fi.check_fused_consistency(device=card)))
    for name, r in res.items():
        assert r['failures'] == [] and r['checked'] > 0, (name, r)
    assert launched['exec_span'] > 0 and launched['exec_span_fused'] > 0
    assert fi.check_vmap_consistency(device=card) == 0
    assert fi.check_audit_consistency(device=card)['false_positives'] == 0
