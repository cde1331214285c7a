"""The port's kernel parity self-test (``ops/selftest.py``) on the CPU.

``kernel_parity_check('cpu')`` runs every check with both sides plain;
each check fails (AssertionError) when its kernel side is perturbed, so
it can fail; on each check's inputs the port's outputs equal the JAX
package's (``demod_iq``, ``synthesize_element``, the generic engine,
``run_physics_batch`` at sigma = 0) to the self-test's tolerances; and
with no device named and no card, the check raises instead of running
on the CPU.  On the card, ``tests/test_torch_cuda.py`` runs
``kernel_parity_check('cuda')``: the hand kernels against their plain
versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.models.experiments import \
    active_reset as j_active_reset
from distributed_processor_tpu.ops.demod import demod_iq as j_demod_iq
from distributed_processor_tpu.ops.selftest import check_exec_parity as \
    j_check_exec_parity
from distributed_processor_tpu.ops.waveform import \
    synthesize_element as j_synthesize_element
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as j_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as j_run_physics)
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch.ops import selftest
from distributed_processor_tpu_torch.ops.demod import demod_iq
from distributed_processor_tpu_torch.ops.waveform import synthesize_element
from distributed_processor_tpu_torch.sim import interpreter, physics
from distributed_processor_tpu_torch.decoder import \
    machine_program_from_cmds
from distributed_processor_tpu_torch.models.experiments import active_reset
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (ReadoutPhysics,
                                                         run_physics_batch)
from distributed_processor_tpu_torch.simulator import Simulator


def test_kernel_parity_check_cpu():
    selftest.kernel_parity_check('cpu')


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    for fn in (selftest.kernel_parity_check, selftest.check_demod_parity,
               selftest.check_waveform_parity, selftest.check_exec_parity,
               selftest.check_physics_pass_parity):
        with pytest.raises(RuntimeError, match='CUDA'):
            fn()
        with pytest.raises(RuntimeError, match='CUDA'):
            fn('cuda')


def _shift_time(st: dict) -> dict:
    return dict(st, time=st['time'] + 1)


def _perturbed(monkeypatch, which: str) -> None:
    """Make one kernel wrapper's output wrong: the kernel side of its
    check (on the CPU, the kernel's plain version behind the same
    wrapper)."""
    if which == 'demod':
        monkeypatch.setattr(selftest, 'demod_iq',
                            lambda adc, w: demod_iq(adc, w) + 0.01)
    elif which == 'waveform':
        monkeypatch.setattr(selftest, 'synthesize_element',
                            lambda *a, **kw: synthesize_element(*a, **kw)
                            + 0.01)
    elif which == 'span':
        span = interpreter.exec_span
        monkeypatch.setattr(interpreter, 'exec_span',
                            lambda *a: _shift_time(span(*a)))
    elif which == 'block':
        blocks = interpreter.exec_blocks
        monkeypatch.setattr(interpreter, 'exec_blocks',
                            lambda *a: _shift_time(blocks(*a)))
    elif which == 'physics':
        pass_ = selftest.exec_span_physics
        monkeypatch.setattr(selftest, 'exec_span_physics',
                            lambda *a: _shift_time(pass_(*a)))
    else:
        fused = physics.exec_span_fused
        monkeypatch.setattr(
            physics, 'exec_span_fused',
            lambda *a: (_shift_time(fused(*a)[0]),) + fused(*a)[1:])


@pytest.mark.parametrize('which,check', [
    ('demod', 'check_demod_parity'), ('waveform', 'check_waveform_parity'),
    ('span', 'check_exec_parity'), ('block', 'check_exec_parity'),
    ('fused', 'check_exec_parity'), ('physics', 'check_exec_parity'),
    ('physics', 'check_physics_pass_parity')])
def test_check_fails_on_a_perturbed_kernel(monkeypatch, which, check):
    getattr(selftest, check)('cpu')
    _perturbed(monkeypatch, which)
    with pytest.raises(AssertionError):
        getattr(selftest, check)('cpu')


def test_demod_inputs_equal_jax():
    rng = np.random.default_rng(0)
    adc = rng.standard_normal((1000, 1024)).astype(np.float32)
    w = rng.standard_normal((1024, 8)).astype(np.float32)
    got = demod_iq(torch.as_tensor(adc), torch.as_tensor(w)).numpy()
    want = np.asarray(j_demod_iq(adc, w))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_waveform_inputs_equal_jax():
    rec, env = selftest.waveform_inputs()
    got = synthesize_element(rec, env, device='cpu',
                             **selftest.WAVEFORM_GEOMETRY).numpy()
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    want = np.asarray(j_synthesize_element(jrec, env,
                                           **selftest.WAVEFORM_GEOMETRY))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(got).max() > 0.1


def test_exec_inputs_equal_jax():
    """The port's programs are JAX's, word for word, and the port's
    generic and pallas engines equal JAX's generic engine on the check's
    bits (every key; ``steps`` on the generic engine too)."""
    span, loop = selftest.exec_programs()
    jspan = [[jisa.pulse_cmd(amp_word=1000, cfg_word=0,
                             env_word=(8 << 12) | 3, cmd_time=10),
              jisa.alu_cmd('reg_alu', 'i', 5, 'add', alu_in1=1,
                           write_reg_addr=1),
              jisa.pulse_cmd(amp_word=2000, cfg_word=2,
                             env_word=(4 << 12) | 1, cmd_time=40),
              jisa.done_cmd()]]
    jloop = [[jisa.alu_cmd('reg_alu', 'i', 0, 'add', write_reg_addr=2),
              jisa.pulse_cmd(amp_word=500, cfg_word=1,
                             env_word=(4 << 12) | 2, cmd_time=12),
              jisa.alu_cmd('reg_alu', 'i', 1, 'add', alu_in1=2,
                           write_reg_addr=2),
              jisa.alu_cmd('jump_cond', 'i', 3, 'ge', alu_in1=2,
                           jump_cmd_ptr=1),
              jisa.done_cmd()]]
    assert (span, loop) == (jspan, jloop)
    rng = np.random.default_rng(2)
    for cmds in (span, loop):
        mp, jmp = machine_program_from_cmds(cmds), j_from_cmds(cmds)
        kw = dict(max_steps=2 * mp.n_instr + 64, max_pulses=8,
                  max_meas=2, max_resets=2)
        bits = rng.integers(0, 2, size=(4, mp.n_cores, 2))
        want = j_simulate_batch(jmp, bits, cfg=JCfg(engine='generic', **kw))
        for eng in ('generic', 'pallas'):
            got = simulate_batch(mp, bits, device='cpu',
                                 cfg=InterpreterConfig(engine=eng, **kw))
            assert set(got) == set(want)
            for k in want:
                if eng == 'pallas' and k == 'steps':
                    continue
                np.testing.assert_array_equal(
                    got[k].numpy(), np.asarray(want[k]), err_msg=(eng, k))


def test_fused_inputs_equal_jax():
    """``active_reset`` at sigma = 0: the port's generic and fused
    engines equal JAX's generic engine on every key but the
    loop-structure counters the fusion changes, and JAX's own check
    passes on the same inputs."""
    mp = Simulator(n_qubits=2, device='cpu').compile(
        active_reset(['Q0', 'Q1']))
    jmp = JSimulator(n_qubits=2).compile(j_active_reset(['Q0', 'Q1']))
    # the check's generator: the two programs' bits come first
    rng = np.random.default_rng(2)
    rng.integers(0, 2, size=(4, 1, 2))
    rng.integers(0, 2, size=(4, 1, 2))
    init = rng.integers(0, 2, (4, mp.n_cores)).astype(np.int32)
    kw = dict(init_states=init, max_steps=mp.n_instr * 4 + 64,
              max_pulses=16, max_meas=4)
    want = j_run_physics(jmp, JPhysics(sigma=0.0), 3, 4, engine='generic',
                         **kw)
    for eng in ('generic', 'fused'):
        got = run_physics_batch(mp, ReadoutPhysics(sigma=0.0), 3, 4,
                                engine=eng, device='cpu', **kw)
        assert set(got) == set(want)
        for k in want:
            if eng == 'fused' and k in ('steps', 'epochs'):
                continue
            np.testing.assert_array_equal(
                got[k].numpy(), np.asarray(want[k]), err_msg=(eng, k))
    assert int(got['epochs']) == 1
    j_check_exec_parity(interpret=True)
