"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with the CUDA toolkit, and skip elsewhere; run
them on the card with::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py configures JAX, which the card's
host does not have.)  The kernel ``csrc/resolve.cu`` is held against
its plain torch version on the same inputs (rtol 1e-5, atol 1e-5 *
max|energy|: the kernel sums sample by sample, the plain version chunk
by chunk), and the physics loop on the card against the same loop on
the CPU (identical bits at sigma = 0).  This file imports nothing of
JAX.
"""

import numpy as np
import pytest
import torch

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    make_default_qchip, active_reset, rb_program)
from distributed_processor_tpu_torch.ops.resolve import (
    resolve_windows_fused, resolve_windows_reference)
from distributed_processor_tpu_torch.sim.interpreter import InterpreterConfig
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
