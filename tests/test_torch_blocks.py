"""The port's block engine and the block mode of its megastep engine
against the JAX package's block engine.

Same program, same injected measurement bits, same config: every output
key of ``simulate_batch(engine='block')`` — pulse records, registers,
clocks, ``err``, ``fault``, the opcode histogram and ``steps`` (block
iterations) — must be identical, value and dtype, to JAX
``engine='block'``.  Programs: the looped headline (active reset + RB
inside the on-device shot loop) at a small size, the terminating golden
programs, the random branchy programs of tests/test_blocks.py (counted
loops, forward jumps, own-core fproc reads, sync barriers), a run cut by
``max_steps`` inside the loop, and a sync deadlock and an fproc
starvation.  ``engine='pallas'`` on a looping program runs the same
engine with the K1 block kernel's plain version on the CPU, so its
outputs equal ``engine='block'``'s.  The physics epoch loop on the block
engine is held against JAX at sigma = 0 with explicit initial states,
every output exact.  The port receives each JAX-compiled program through
``machine_program_from_arrays``.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import machine_program_from_cmds
from distributed_processor_tpu.models import (active_reset, make_default_qchip,
                                              rb_program)
from distributed_processor_tpu.models.experiments import loop_shots_program
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.pipeline import compile_to_machine
from distributed_processor_tpu.sim import interpreter as jax_interp
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run_physics)
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch import Simulator
from distributed_processor_tpu_torch.sim import interpreter as torch_interp
from distributed_processor_tpu_torch.sim.interpreter import (
    FAULT_BUDGET_EXHAUSTED, FAULT_FPROC_STARVED, FAULT_SYNC_DEADLOCK,
    InterpreterConfig as TCfg, simulate_batch as torch_simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    physics_from_dict, run_physics_batch)

from test_blocks import _NONTERMINATING_GOLDENS, _random_branchy_program
from test_torch_cuda import branchy_program
from test_torch_interpreter import _to_port

B = 16


def _looped(n_qubits=2, depth=2, loops=2):
    """The looped headline at a small size: ``loops + 1`` iterations of
    active reset + depth-``depth`` RB (the loop is a do-while on ``ge``)."""
    qubits = [f'Q{i}' for i in range(n_qubits)]
    body = active_reset(qubits) + rb_program(qubits, depth, seed=1234)
    with warnings.catch_warnings():
        # the reference compiler's own notice for virtual z in loops
        warnings.simplefilter('ignore')
        return compile_to_machine(
            loop_shots_program(body, loops, scope=qubits),
            make_default_qchip(max(n_qubits, 2)), n_qubits=n_qubits)


@pytest.fixture(scope='module')
def looped():
    return _looped()


def _bits(rng, mp, m, batch=B):
    return rng.integers(0, 2, (batch, mp.n_cores, m)).astype(np.int32)


def assert_same_as_jax(mp, meas_bits, engine='block', jax_engine='block',
                       **kw):
    """Run the port on ``engine`` and JAX on ``jax_engine``; every output
    key equal in value and dtype, ``steps`` included."""
    out_j = jax_simulate_batch(mp, meas_bits, cfg=JCfg(engine=jax_engine,
                                                       **kw))
    out_t = torch_simulate_batch(_to_port(mp), meas_bits,
                                 cfg=TCfg(engine=engine, **kw), device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)
    return out_t


@pytest.mark.parametrize('engine', ['block', 'pallas'])
def test_looped_headline_matches_jax(looped, engine):
    """The looped headline (2 qubits, depth 2, 3 loop iterations), with
    pulse records and the opcode histogram: the port's block engine and
    its megastep block mode (plain bodies on the CPU) both equal JAX
    ``engine='block'`` on every key."""
    mp = looped
    assert torch_interp._pallas_mode(_to_port(mp), TCfg()) == 'block'
    kw = dict(mp.static_bounds(), max_meas=6, max_resets=2,
              record_pulses=True, opcode_histogram=True)
    out = assert_same_as_jax(mp, _bits(np.random.default_rng(1), mp, 6),
                             engine=engine, **kw)
    assert not bool(out['incomplete'])
    assert bool((out['err'] == 0).all()) and bool((out['fault'] == 0).all())
    assert bool((out['n_meas'] == 6).all())
    # a block iteration retires whole superinstructions: fewer steps than
    # the generic engine's one instruction per step
    gen = torch_simulate_batch(_to_port(mp), _bits(np.random.default_rng(1),
                                                   mp, 6),
                               cfg=TCfg(engine='generic', **kw),
                               device='cpu')
    assert int(out['steps']) < int(gen['steps'])
    for key in gen:
        if key != 'steps':
            assert torch.equal(out[key], gen[key]), key


@pytest.mark.parametrize('name', sorted(set(GOLDEN_PROGRAMS)
                                        - _NONTERMINATING_GOLDENS))
def test_terminating_goldens_match_jax(name):
    n_qubits, thunk = J_GOLDEN_PROGRAMS[name]   # the JAX compile
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        mp = compile_to_machine(thunk(), make_default_qchip(max(n_qubits, 2)),
                                n_qubits=n_qubits)
    out = assert_same_as_jax(mp, _bits(np.random.default_rng(17), mp, 16, 8),
                             **mp.static_bounds(), max_meas=16, max_resets=64)
    assert not bool(out['incomplete'])


@pytest.mark.parametrize('seed', range(4))
def test_branchy_fuzz_matches_jax(seed):
    """Random branchy programs (counted backward loops, forward jumps,
    own-core fproc reads, sometimes a sync barrier) under both fabrics;
    the copy of the generator the card's tests use builds the same
    program."""
    rng = np.random.default_rng(300 + seed)
    mp = _random_branchy_program(rng)
    copy = branchy_program(np.random.default_rng(300 + seed), jisa,
                           machine_program_from_cmds)
    for f in ('kind', 'imm', 'jump_addr', 'cmd_time', 'p_env', 'p_amp'):
        np.testing.assert_array_equal(getattr(copy.soa, f),
                                      getattr(mp.soa, f), err_msg=f)
    bits = rng.integers(0, 2, size=(B, mp.n_cores, 8)).astype(np.int32)
    for fabric in ('sticky', 'fresh'):
        out = assert_same_as_jax(mp, bits, fabric=fabric,
                                 **mp.static_bounds(), max_meas=8,
                                 max_resets=128, opcode_histogram=True)
        if fabric == 'sticky':
            assert not bool(out['incomplete'])


def test_max_steps_cut_inside_the_loop(looped):
    """A step budget that ends the run inside the loop: the exactness
    select stops every lane at the same iteration as JAX, and the live
    lanes trap ``FAULT_BUDGET_EXHAUSTED``."""
    mp = looped
    full = assert_same_as_jax(mp, _bits(np.random.default_rng(2), mp, 6),
                              max_steps=1000, max_pulses=64, max_meas=6)
    cut = int(full['steps']) // 2
    out = assert_same_as_jax(mp, _bits(np.random.default_rng(2), mp, 6),
                             max_steps=cut, max_pulses=64, max_meas=6)
    assert int(out['steps']) == cut and bool(out['incomplete'])
    assert bool(((out['fault'] & FAULT_BUDGET_EXHAUSTED) != 0).all())


def _plain(n, t0=100):
    return [jisa.pulse_cmd(cmd_time=t0 + 20 * k, cfg_word=0, env_word=4096,
                           amp_word=100 + k) for k in range(n)]


def _read(func_id):
    return jisa.alu_cmd('alu_fproc', 'i', 0, 'eq', write_reg_addr=0,
                        func_id=func_id)


def test_sync_deadlock_matches_jax():
    """Core 0 waits at a sync barrier for core 1, which waits on a fresh
    read of core 0 that never comes: the block engine halts both at the
    same iteration as JAX, core 0 with ``FAULT_SYNC_DEADLOCK`` and core 1
    with ``FAULT_FPROC_STARVED``."""
    mp = machine_program_from_cmds([
        _plain(3) + [jisa.sync(0)] + _plain(2, 400) + [jisa.done_cmd()],
        _plain(2) + [_read(0), jisa.sync(0)] + _plain(2, 400)
        + [jisa.done_cmd()]])
    out = assert_same_as_jax(mp, np.zeros((4, 2, 4), np.int32),
                             fabric='fresh', max_meas=4, max_steps=64)
    assert out['fault'][:, 0].tolist() == [FAULT_SYNC_DEADLOCK] * 4
    assert out['fault'][:, 1].tolist() == [FAULT_FPROC_STARVED] * 4


def test_fproc_starved_matches_jax():
    """Each core waits on a fresh read of the other: both starve."""
    mp = machine_program_from_cmds([
        _plain(3) + [_read(1)] + _plain(2, 400) + [jisa.done_cmd()],
        _plain(2) + [_read(0)] + _plain(2, 400) + [jisa.done_cmd()]])
    out = assert_same_as_jax(mp, np.zeros((4, 2, 4), np.int32),
                             fabric='fresh', max_meas=4, max_steps=64)
    assert bool((out['fault'] == FAULT_FPROC_STARVED).all())


def test_physics_block_matches_jax(looped):
    """``run_physics_batch(engine='block')`` at sigma = 0 with explicit
    initial states: every output identical to JAX (bits, integer
    statistics, ``steps`` and ``epochs``; no output is a float
    accumulator)."""
    mp = looped
    init = np.random.default_rng(3).integers(0, 2, (B, mp.n_cores)) \
        .astype(np.int32)
    jm = JPhysics(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                  resolve_mode='fused')
    tm = physics_from_dict(dataclasses.asdict(jm))
    kw = dict(engine='block', **mp.static_bounds(), max_meas=6,
              max_resets=2, record_pulses=False)
    out_j = jax_run_physics(mp, jm, 0, B, init_states=init, cfg=JCfg(**kw))
    out_t = run_physics_batch(_to_port(mp), tm, 0, B, init_states=init,
                              cfg=TCfg(**kw), device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        assert want.dtype.kind in 'biu', key
        np.testing.assert_array_equal(out_t[key].numpy(), want, err_msg=key)
    assert bool(out_t['meas_bits_valid'].all())
    assert int(out_t['epochs']) > 1


def test_engine_ladder_on_a_loop(looped, monkeypatch):
    """``'auto'`` on a looping program: the block engine on the CPU, the
    megastep kernel in block mode for a CUDA device — what JAX picks on
    the CPU, and with its CPU backend allowed the Pallas rung."""
    mp, mp_t = looped, _to_port(looped)
    for cfg_kw in (dict(engine='auto'), dict(engine='auto', physics=True)):
        assert torch_interp.resolve_engine(mp_t, TCfg(**cfg_kw), 'cpu') \
            == jax_interp.resolve_engine(mp, JCfg(**cfg_kw)) == 'block'
    monkeypatch.setattr(jax_interp, '_PALLAS_AUTO_BACKENDS', ('cpu',))
    assert torch_interp.resolve_engine(mp_t, TCfg(engine='auto'),
                                       torch.device('cuda')) \
        == jax_interp.resolve_engine(mp, JCfg(engine='auto')) == 'pallas'
    assert torch_interp._pallas_mode(mp_t, TCfg()) \
        == jax_interp._pallas_mode(jax_interp._soa_static(mp), JCfg()) \
        == 'block'
    # physics mode: the megastep kernel is ineligible, the block engine
    # serves it on the card too
    assert torch_interp.resolve_engine(
        mp_t, TCfg(engine='auto', physics=True), torch.device('cuda')) \
        == 'block'


def test_unported_features_still_raise(looped):
    mp_t = _to_port(looped)
    bits = np.zeros((2, mp_t.n_cores, 6), np.int32)
    # a streaming round count is refused by the single-round entry, as
    # in the JAX package (rounds run via simulate_rounds)
    with pytest.raises(ValueError, match='single-round'):
        torch_simulate_batch(mp_t, bits, device='cpu', engine='block',
                             rounds=2)
    # a set cores_axis is refused by the single-device entry with the
    # JAX package's ValueError (the cores mesh runs it:
    # tests/test_torch_cores_mesh.py)
    with pytest.raises(ValueError, match='sharded_cores_simulate'):
        torch_simulate_batch(mp_t, bits, device='cpu', engine='auto',
                             cores_axis='cores')
    # trace mode: the block engine refuses it with the JAX package's
    # error, and 'auto' takes the generic engine in both packages
    with pytest.raises(ValueError, match='trace') as e_t:
        torch_simulate_batch(mp_t, bits, device='cpu', engine='block',
                             trace=True)
    with pytest.raises(ValueError) as e_j:
        jax_simulate_batch(looped, bits, engine='block', trace=True)
    assert str(e_t.value) == str(e_j.value)
    kw = dict(looped.static_bounds(), max_meas=6, max_resets=2, trace=True)
    traced = assert_same_as_jax(looped, bits, engine='auto',
                                jax_engine='auto', **kw)
    assert int(traced['steps']) \
        == int(torch_simulate_batch(mp_t, bits, device='cpu',
                                    engine='generic', **kw)['steps'])


def test_simulator_runs_a_loop_on_auto():
    """``Simulator.run(engine='auto')`` on a looping program takes the
    block engine on the CPU, as the JAX facade does: every output equal."""
    qubits = ['Q0', 'Q1']
    body = active_reset(qubits) + rb_program(qubits, 2, seed=1234)
    prog = loop_shots_program(body, 2, scope=qubits)
    bits = _bits(np.random.default_rng(5), _looped(), 16, 8)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = Simulator(n_qubits=2, device='cpu').run(
            prog, shots=8, meas_bits=bits, engine='auto')
        out_j = JSimulator(n_qubits=2).run(prog, shots=8, meas_bits=bits,
                                           engine='auto')
    keys = {k for k in out_j if not k.startswith('_')}
    assert keys == {k for k in out if not k.startswith('_')}
    for key in sorted(keys):
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    assert int(out['steps']) < out['_cfg'].max_steps
    assert bool((out['n_meas'] == 6).all())


def test_block_table_holds_the_table_to_the_program(looped):
    """``block_table`` refuses a table that does not fit its program (a
    short ``bid_at``, a body past the end or holding a terminator); on
    the CPU ``exec_blocks`` is the plain launch ``_apply_blocks``, every
    key identical."""
    from distributed_processor_tpu_torch.ops.exec_span import (block_table,
                                                               exec_blocks)
    mp = _to_port(looped)
    cfg = TCfg(max_meas=6, opcode_histogram=True)
    soa_np = torch_interp._soa_np(mp)
    bid_at, bodies = torch_interp._block_plan(soa_np)
    _soa, spc, interp, _sync = torch_interp._program_constants(mp, 'cpu')
    for bad in ((bid_at[:-1], bodies), (bid_at, [(0, mp.n_instr)]),
                (bid_at, [(0, mp.n_instr + 1)])):
        with pytest.raises(ValueError, match='block table'):
            block_table(soa_np, *bad, spc, interp, cfg)
    table = block_table(soa_np, bid_at, bodies, spc, interp, cfg)
    assert table.bodies == tuple(bodies) and table.bid.dtype == torch.int32
    st = torch_interp._init_state(4, mp.n_cores, cfg, None, 'cpu')
    st['pc'][:] = int(np.nonzero(bid_at >= 0)[0][0])   # a block start
    got = exec_blocks(st, table, cfg)
    want = torch_interp._apply_blocks(st, table, cfg)
    assert bool((got['pc'] != st['pc']).all())
    for key in want:
        assert torch.equal(got[key], want[key]), key
