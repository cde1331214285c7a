"""K3 with its readout left to K2: the physics loop's straight-line pass
as one launch an epoch (``ops.exec_span.exec_span_physics``,
``csrc/exec_span.cu`` ``exec_span_physics_kernel``).

On the CPU (tier-1): the dispatch rule of ``sim.physics.exec_path`` (a
CPU run takes the plain pass and counts no launch; on a CUDA device the
straight-line engine takes the kernel where K3 takes the program and the
configuration, and Bloch, statevec, CW windows, trace mode, a program
past the measurement bound and the other engines keep their eager pass),
the ``exec`` argument of the ``physics.batch`` host span, and the
wrapper's refusals and plain version.

On the card (marker ``cuda``; they skip elsewhere)::

    python -m pytest --noconftest tests/test_torch_physics_span.py -m cuda -q

the kernel against the eager pass on the same card, pass by pass on
every leaf of the campaign's reset-RB program at 8 cores (a first pass
that stalls at the reset read, then the resumed one), and whole
``run_physics_batch`` results, kernel against eager with the same seed
and initial states, exactly on every output at sigma = 0.05 and 0, with
pulse records and the opcode histogram, and under the ``'lut'`` fabric.
This file imports nothing of JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    active_reset, couplings_from_qchip, ghz_program, make_default_qchip,
    rb_program)
from distributed_processor_tpu_torch.obs import HOST_SPANS
from distributed_processor_tpu_torch.ops.exec_span import exec_span_physics
from distributed_processor_tpu_torch.sim import physics
from distributed_processor_tpu_torch.sim.device import DeviceModel
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, _exec_straightline, _init_state, _span_table,
    check_supported)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, exec_path, physics_config, run_physics_batch)

X90 = physics.X90_AMP_DEFAULT


def _reset_rb(n: int, depth: int, seed: int = 1234):
    qubits = [f'Q{i}' for i in range(n)]
    return compile_to_machine(active_reset(qubits)
                              + rb_program(qubits, depth, seed=seed),
                              make_default_qchip(n), n_qubits=n)


@pytest.fixture(scope='module')
def rb3():
    return _reset_rb(3, 3, seed=7)


@pytest.fixture(scope='module')
def rb8():
    """The campaign's program: active reset then depth-12 RB on 8
    cores."""
    return _reset_rb(8, 12)


def _cfg(mp, **kw):
    """The campaign's interpreter fields and budgets for ``mp``."""
    base = dict(max_steps=2 * mp.n_instr + 64,
                max_pulses=int(mp.max_pulses_per_core(1)) + 4, max_meas=2,
                max_resets=2, record_pulses=False, straightline=None)
    base.update(kw)
    return InterpreterConfig(**base)


def _model(**kw):
    return ReadoutPhysics(**dict(dict(sigma=0.05, p1_init=0.15,
                                      resolve_chunk=256,
                                      resolve_mode='fused'), **kw))


def _path(mp, model, device, cfg=None, **kw):
    """The run's engine and exec path as ``run_physics_batch`` resolves
    them on ``device`` (``cfg``: the run's interpreter config, else the
    campaign's with ``kw``)."""
    cfg = physics_config(cfg or _cfg(mp, **kw), model)
    eng = check_supported(mp, cfg, device)
    return eng, exec_path(mp, cfg, eng, device)


def _ghz3():
    mp = compile_to_machine(ghz_program(['Q0', 'Q1', 'Q2']),
                            make_default_qchip(3), n_qubits=3)
    dev = DeviceModel('statevec',
                      couplings=couplings_from_qchip(mp,
                                                     make_default_qchip(3)))
    return mp, dev


# ---------------------------------------------------------------------------
# the dispatch rule (CPU)


@pytest.mark.parametrize('device', ['cuda', 'cuda:0', 'cpu'])
def test_parity_straightline_takes_the_kernel_on_cuda_only(rb8, device):
    eng, path = _path(rb8, _model(), device)
    assert eng == 'straightline'
    assert path == ('plain' if device == 'cpu' else 'kernel')


@pytest.mark.parametrize('case', [
    'bloch', 'cw_horizon', 'trace', 'past_meas_bound', 'generic', 'block'])
def test_other_runs_keep_the_eager_pass_on_cuda(rb3, case):
    """On a CUDA-typed request every run K3 does not take resolves to
    the eager pass: Bloch, CW windows, trace mode, a program whose static
    measurement bound exceeds ``max_meas``, and the generic and block
    engines."""
    model, kw = _model(), {}
    if case == 'bloch':
        model = _model(device=DeviceModel('bloch', t1_s=80e-6))
    elif case == 'cw_horizon':
        model = _model(cw_horizon=64)
    elif case == 'trace':
        kw = dict(trace=True)
    elif case == 'past_meas_bound':
        kw = dict(max_meas=1)
    else:
        kw = dict(engine=case)
    eng, path = _path(rb3, model, 'cuda', **kw)
    assert path == 'plain', (case, eng)
    assert eng == ('straightline' if case in ('bloch', 'cw_horizon',
                                              'past_meas_bound')
                   else 'generic' if case == 'trace' else case)


def test_statevec_keeps_the_eager_pass_on_cuda():
    mp, dev = _ghz3()
    eng, path = _path(mp, _model(sigma=0.0, device=dev), 'cuda',
                      max_meas=4, max_pulses=64)
    assert (eng, path) == ('generic', 'plain')


def test_fused_engine_is_a_kernel_on_cuda(rb3):
    model = _model(sigma=0.0)
    assert _path(rb3, model, 'cuda', engine='fused') == ('fused', 'kernel')
    assert _path(rb3, model, 'cpu', engine='fused') == ('fused', 'plain')


def test_dispatch_is_asked_once_per_program_and_config(rb3, monkeypatch):
    """The eligibility analysis runs once per program object and
    configuration, not every batch."""
    calls = []
    real = physics.fused_ineligible
    monkeypatch.setattr(physics, 'fused_ineligible',
                        lambda mp, cfg: calls.append(cfg) or real(mp, cfg))
    mp = _reset_rb(3, 2, seed=11)
    cfg = physics_config(_cfg(mp), _model())
    for _ in range(3):
        assert exec_path(mp, cfg, 'straightline', 'cuda') == 'kernel'
    other = dataclasses.replace(cfg, max_meas=1)
    assert exec_path(mp, other, 'straightline', 'cuda') == 'plain'
    assert calls == [cfg, other]


# ---------------------------------------------------------------------------
# the physics.batch span and the launch counter (CPU)


@pytest.fixture
def _empty_ring():
    HOST_SPANS.clear()
    yield
    HOST_SPANS.clear()


@pytest.mark.parametrize('case', ['parity', 'bloch', 'cw_horizon', 'trace',
                                  'statevec'])
def test_cpu_run_takes_the_plain_pass(rb3, _empty_ring, case):
    """A CPU run takes the plain pass whatever its configuration: the
    ``physics.batch`` span says ``exec='plain'`` beside the engine, and
    no kernel launch is counted."""
    mp, model, kw = rb3, _model(), {}
    if case == 'bloch':
        model = _model(device=DeviceModel('bloch', t1_s=80e-6))
    elif case == 'cw_horizon':
        model = _model(cw_horizon=64)
    elif case == 'trace':
        kw = dict(trace=True)
    elif case == 'statevec':
        mp, dev = _ghz3()
        model = _model(sigma=0.0, device=dev)
        kw = dict(max_meas=4, max_pulses=64, max_steps=4000)
    before = exec_span_physics.launches
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_physics_batch(mp, model, 5, 8, cfg=_cfg(mp, **kw),
                                device='cpu')
    assert exec_span_physics.launches == before
    batch, = [s for s in HOST_SPANS.spans() if s['name'] == 'physics.batch']
    eng = 'straightline' if case in ('parity', 'bloch', 'cw_horizon') \
        else 'generic'
    assert batch['args'] == {'shots': 8, 'engine': eng, 'exec': 'plain'}
    assert bool(out['done'].all())


# ---------------------------------------------------------------------------
# the wrapper (CPU)


def _carry(mp, cfg, B, device, seed=0):
    rng = np.random.default_rng(seed)
    st = _init_state(B, mp.n_cores, cfg, None, device)
    st['qturns'] = 2 * torch.as_tensor(rng.integers(0, 2, (B, mp.n_cores)),
                                       dtype=torch.int32, device=device)
    M = cfg.max_meas
    bits = torch.zeros((B, mp.n_cores, M), dtype=torch.int32, device=device)
    valid = torch.zeros((B, mp.n_cores, M), dtype=torch.bool, device=device)
    return st, bits, valid


@pytest.mark.parametrize('case', ['injected', 'bloch', 'cw'])
def test_wrapper_refuses_what_the_kernel_does_not_take(rb3, case):
    cfg = dataclasses.replace(_cfg(rb3), physics=True, x90_amp=X90)
    if case == 'injected':
        cfg = dataclasses.replace(cfg, physics=False)
    elif case == 'bloch':
        cfg = dataclasses.replace(cfg, device='bloch')
    else:
        cfg = dataclasses.replace(cfg, cw_horizon=64)
    st, bits, valid = _carry(rb3, dataclasses.replace(cfg, physics=True,
                                                      device='parity'),
                             4, 'cpu')
    table = _span_table(rb3, cfg, 'cpu', fused=True)
    with pytest.raises(ValueError, match='parity device without CW'):
        exec_span_physics(st, table, bits, valid, cfg)


def test_wrapper_on_cpu_is_the_plain_pass(rb3):
    """On a CPU carry the wrapper is the straight-line engine's pass and
    counts no launch: a first pass stalls at the reset read, the resumed
    one retires every lane."""
    cfg = dataclasses.replace(_cfg(rb3), physics=True, x90_amp=X90)
    st, bits, valid = _carry(rb3, cfg, 6, 'cpu')
    table = _span_table(rb3, cfg, 'cpu', fused=True)
    before = exec_span_physics.launches
    for n in range(2):
        got = exec_span_physics(st, table, bits, valid, cfg)
        want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                                  bits, valid, cfg)
        assert set(got) == set(want) == set(st)
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)
        assert bool(got['phys_wait'].any()) == (n == 0)
        st = got
        valid = torch.arange(cfg.max_meas)[None, None] \
            < st['n_meas'][..., None]
    assert bool(st['done'].all())
    assert exec_span_physics.launches == before


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the card)')
    return torch.device('cuda')


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize('B', [4099, 64])
def test_kernel_matches_eager_pass_by_pass(card, rb8, B):
    """The campaign's program at 8 cores: the kernel against the eager
    pass on the card, every leaf, on a first pass from the initial carry
    (every lane stalls at its reset read) and on the resumed pass after
    the fired windows' bits are set and valid."""
    cfg = physics_config(_cfg(rb8), _model())
    st, bits, valid = _carry(rb8, cfg, B, card, seed=B)
    table = _span_table(rb8, cfg, card, fused=True)
    rng = np.random.default_rng(B + 1)
    for n in range(2):
        before = exec_span_physics.launches
        got = exec_span_physics(st, table, bits, valid, cfg)
        assert exec_span_physics.launches == before + 1
        want = _exec_straightline(st, table.soa_np, table.spc, table.interp,
                                  bits, valid, cfg)
        torch.cuda.synchronize()
        _assert_same(got, want)
        if n == 0:
            assert bool(want['phys_wait'].all())
        else:
            assert not bool(want['phys_wait'].any())
        fired = torch.arange(cfg.max_meas, device=card)[None, None] \
            < want['n_meas'][..., None]
        new = torch.as_tensor(rng.integers(0, 2, bits.shape),
                              dtype=torch.int32, device=card)
        bits = torch.where(fired & ~valid, new, bits)
        valid = valid | fired
        st = want
    assert bool(st['done'].all())


def _batch_pair(mp, model, seed, init, cfg, device, monkeypatch):
    """``run_physics_batch`` through the kernel, then through the eager
    pass (the dispatch forced to it), with the same seed and initial
    states; returns both and the kernel's launches."""
    before = exec_span_physics.launches
    kernel = run_physics_batch(mp, model, seed, init.shape[0],
                               init_states=init, cfg=cfg, device=device)
    launches = exec_span_physics.launches - before
    with monkeypatch.context() as m:
        m.setattr(physics, 'exec_path', lambda *a: 'plain')
        eager = run_physics_batch(mp, model, seed, init.shape[0],
                                  init_states=init, cfg=cfg, device=device)
    assert exec_span_physics.launches == before + launches
    torch.cuda.synchronize()
    return kernel, eager, launches


@pytest.mark.cuda
@pytest.mark.parametrize('sigma', [0.05, 0.0])
def test_batch_kernel_matches_eager(card, rb8, sigma, monkeypatch):
    """Whole ``run_physics_batch`` results on the campaign's program, the
    kernel against the eager pass: every output identical, bit for bit,
    at sigma = 0.05 as at 0, in two epochs and two launches."""
    B = 20000
    init = torch.as_tensor(np.random.default_rng(5).random((B, 8)) < 0.15,
                           dtype=torch.int32, device=card)
    cfg = _cfg(rb8)
    kernel, eager, launches = _batch_pair(rb8, _model(sigma=sigma), 987654,
                                          init, cfg, card, monkeypatch)
    _assert_same(kernel, eager)
    assert int(kernel['epochs']) == 2 and launches == 2
    assert not bool(kernel['incomplete'])
    assert int(kernel['fault'].ne(0).sum()) == 0


@pytest.mark.cuda
def test_batch_kernel_matches_eager_with_records(card, rb8, monkeypatch):
    """Pulse records and the opcode histogram ride the kernel too."""
    B = 3001
    init = torch.as_tensor(np.random.default_rng(6).integers(0, 2, (B, 8)),
                           dtype=torch.int32, device=card)
    cfg = _cfg(rb8, record_pulses=True, opcode_histogram=True)
    kernel, eager, launches = _batch_pair(rb8, _model(), 31, init, cfg,
                                          card, monkeypatch)
    _assert_same(kernel, eager)
    assert launches == int(kernel['epochs'])
    assert 'rec_gtime' in kernel and 'op_hist' in kernel


@pytest.mark.cuda
@pytest.mark.parametrize('n', [3, 9])
def test_lut_batch_kernel_matches_eager(card, n, monkeypatch):
    """The compiled repetition round under the ``'lut'`` fabric on the
    straight-line engine: the kernel against the eager pass, every
    output identical at sigma = 0.05, every core corrected to its
    pattern's majority."""
    from distributed_processor_tpu_torch.models import repetition
    from distributed_processor_tpu_torch.simulator import Simulator
    mp = Simulator(n_qubits=n, device=card).compile(
        repetition.repetition_round_program(n))
    B = 1001
    init = torch.as_tensor([[(s >> i) & 1 for i in range(n)]
                            for s in range(B)], dtype=torch.int32,
                           device=card)
    cfg = InterpreterConfig(max_steps=mp.n_instr * 6 + 64,
                            engine='straightline',
                            **repetition.repetition_physics_kwargs(n))
    model = ReadoutPhysics(sigma=0.05)
    assert _path(mp, model, card, cfg) == ('straightline', 'kernel')
    kernel, eager, launches = _batch_pair(mp, model, 3, init, cfg, card,
                                          monkeypatch)
    _assert_same(kernel, eager)
    assert launches == int(kernel['epochs'])
    maj = (init.sum(1) * 2 > n).to(torch.int32)
    assert torch.equal(kernel['qturns'] % 4 // 2,
                       maj[:, None].expand(B, n))
