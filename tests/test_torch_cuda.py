"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with the CUDA toolkit, and skip elsewhere; run
them on the card with::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py configures JAX, which the card's
host does not have.)  The kernel ``csrc/resolve.cu`` is held against
its plain torch version on the same inputs (rtol 1e-5, atol 1e-5 *
max|energy|: the kernel sums sample by sample, the plain version chunk
by chunk), and the physics loop on the card against the same loop on
the CPU (identical bits at sigma = 0).  The span kernels of
``csrc/exec_span.cu`` are held exactly: K1 against the straight-line
engine on the card, K3 against its plain version and against the
generic engine.  This file imports nothing of JAX; its straight-line
fuzz generator serves tests/test_torch_straightline.py too.
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


@pytest.mark.parametrize('mode', ['fused', 'persample'])
@pytest.mark.parametrize('ring', [False, True])
@pytest.mark.parametrize('streamed', [False, True])
def test_kernel_matches_plain_version(card, program, mode, ring, streamed):
    model = ReadoutPhysics(resolve_mode=mode, resolve_chunk=256)
    tables = prepare_physics_tables(program, model, card)
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    B = 1000
    sc, gs_i, gs_q = _inputs(tables, B, 1)
    noise = None
    if streamed:
        gen = torch.Generator(device=card)
        gen.manual_seed(2)
        noise = 0.1 * torch.randn((2, C, B, W), generator=gen, device=card)
    args = (sc, tables, gs_i, gs_q, 0.0, 1 / 30, 3, W, Lp)
    before = resolve_windows_fused.launches
    got = resolve_windows_fused(*args, ring=ring, noise=noise)
    assert resolve_windows_fused.launches == before + 1
    want = resolve_windows_reference(*args, ring=ring, noise=noise)
    torch.cuda.synchronize()
    scale = float(want[2].abs().max())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)


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
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        _init_state, _program_constants, _soa_np)
    cfg = _span_cfg(program)
    _soa, spc, interp, _sync = _program_constants(program, card)
    st = _init_state(8, program.n_cores, cfg, None, card)
    bits = torch.zeros((8, program.n_cores, 2), dtype=torch.int32,
                       device=card)
    with pytest.raises(ValueError, match='meas_bits'):
        exec_span(st, _soa_np(program), spc, interp, bits[:, :, :1], cfg)
    with pytest.raises(ValueError, match='time'):
        exec_span(dict(st, time=st['time'].long()), _soa_np(program), spc,
                  interp, bits, cfg)
    with pytest.raises(ValueError, match='geometry'):
        exec_span(st, _soa_np(program), torch.zeros_like(spc), interp, bits,
                  cfg)
