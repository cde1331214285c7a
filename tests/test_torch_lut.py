"""The ``'lut'`` measurement fabric in the port against the JAX package's.

The syndrome LUT (reference: hdl/fproc_lut.sv + meas_lut.sv): the bits
of a masked set of cores form a table address, and each core reads its
own correction bit from that entry, served time-indexed from the
``meas_time`` plane of production clocks.  Every integer is held
exactly: ``MeasLUT`` (``address``, ``__call__``, ``timed_call``) on drawn
planes; the engine ladder's reasons and picks (``straightline_ineligible``,
``fused_ineligible``, ``_pallas_mode``, ``resolve_engine``) on the
repetition round, the multi-round QEC program, the 9-core-shaped surface
cycle (here at distance 3), the bench's feedback shape, an own-fresh read,
a missing ``lut_mask`` and the golden programs re-wired onto the fabric;
every output key of every engine (generic, straight-line, block, and on
the CPU the plain versions behind ``'pallas'``, standing for K1 with the
JAX Pallas kernel in interpret mode, and ``'fused'``, K3), ``steps`` and
``meas_time`` included; a masked core that never measures (the starved
terminal); the physics-closed repetition round at sigma = 0 (identical to
JAX on every key) and at sigma = 0.01 (the JAX test's assertions); and
the ``Simulator`` facade with a LUT-carrying ``FPGAConfig``.
"""

import dataclasses

import numpy as np
import pytest

import jax

import bench
from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import machine_program_from_cmds
from distributed_processor_tpu.hwconfig import FPGAConfig as JFPGA
from distributed_processor_tpu.models import make_default_qchip
from distributed_processor_tpu.models import qec as jqec
from distributed_processor_tpu.models import repetition as jrep
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.ops.fabric import MeasLUT as JLUT
from distributed_processor_tpu.pipeline import compile_to_machine
from distributed_processor_tpu.sim import interpreter as jax_interp
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run_physics)
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch import Simulator as TSimulator
from distributed_processor_tpu_torch.hwconfig import FPGAConfig as TFPGA
from distributed_processor_tpu_torch.ops.fabric import MeasLUT as TLUT
from distributed_processor_tpu_torch.parallel import make_cores_mesh
from distributed_processor_tpu_torch.sim import interpreter as torch_interp
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate_batch as torch_simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics as TPhysics, run_physics_batch as torch_run_physics)

from test_torch_cuda import lut_feedback_program
from test_torch_interpreter import _to_port

B = 96     # no multiple of 32 shots


def _cfg_kw(cfg) -> dict:
    """A config's fields but the engine choice, which the tests set."""
    kw = dataclasses.asdict(cfg)
    for k in ('engine', 'pallas_interpret'):
        kw.pop(k)
    return kw


def _assert_same(out_j, out_t, what=''):
    """Every output key of both packages equal in value and dtype."""
    keys = {k for k in out_j if not k.startswith('_')}
    assert {k for k in out_t if not k.startswith('_')} == keys, what
    for key in sorted(keys):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (what, key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f'{what} {key}')


def _run_both(mp, bits, engine, init_regs=None, **kw):
    """Both packages on ``engine``; JAX's Pallas kernel in interpret mode
    stands for K1.  Returns the port's output, or the exception type both
    packages raised."""
    try:
        out_j = jax_simulate_batch(mp, bits, init_regs=init_regs, cfg=JCfg(
            engine=engine, pallas_interpret=True, **kw))
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            torch_simulate_batch(_to_port(mp), bits, init_regs=init_regs,
                                 device='cpu', cfg=TCfg(engine=engine, **kw))
        return type(e)
    out_t = torch_simulate_batch(_to_port(mp), bits, init_regs=init_regs,
                                 device='cpu', cfg=TCfg(engine=engine, **kw))
    _assert_same(out_j, out_t, engine)
    return out_t


# ---------------------------------------------------------------------------
# MeasLUT


@pytest.mark.parametrize('seed', range(3))
def test_meas_lut_matches_jax(seed):
    rng = np.random.default_rng(400 + seed)
    C, M = 5, 3
    mask = rng.integers(0, 2, C).astype(bool)
    mask[rng.integers(C)] = True
    k = int(mask.sum())
    table = tuple(int(x) for x in rng.integers(0, 1 << C, 1 << k))
    lj, lt = JLUT(mask, table), TLUT(mask, table, device='cpu')
    bits = rng.integers(0, 2, (64, C)).astype(np.int32)
    np.testing.assert_array_equal(lt.address(bits).numpy(),
                                  np.asarray(lj.address(bits)))
    np.testing.assert_array_equal(lt(bits).numpy(), np.asarray(lj(bits)))
    # drawn planes: production clocks with unwritten slots, counts 0..M
    planes = rng.integers(0, 2, (64, C, M)).astype(np.int32)
    n_meas = rng.integers(0, M + 1, (64, C)).astype(np.int32)
    times = np.sort(rng.integers(0, 200, (64, C, M)), -1).astype(np.int32)
    times = np.where(np.arange(M) < n_meas[..., None], times,
                     np.iinfo(np.int32).max).astype(np.int32)
    req = rng.integers(0, 220, 64).astype(np.int32)
    got = lt.timed_call(planes, times, n_meas, req)
    want = lj.timed_call(planes, times, n_meas, req)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_meas_lut_from_fpga_config_matches_jax():
    mask = (True, False, True, True)
    table = tuple(int(x) for x in np.random.default_rng(3).integers(0, 16, 8))
    lt = TLUT.from_fpga_config(TFPGA(n_cores=4, meas_lut_mask=mask,
                                     meas_lut_table=table), device='cpu')
    lj = JLUT.from_fpga_config(JFPGA(n_cores=4, meas_lut_mask=mask,
                                     meas_lut_table=table))
    pats = np.array([[(p >> i) & 1 for i in range(4)] for p in range(16)])
    np.testing.assert_array_equal(lt(pats).numpy(), np.asarray(lj(pats)))
    with pytest.raises(ValueError, match='no meas LUT'):
        TLUT.from_fpga_config(TFPGA(), device='cpu')
    # sharded_call over a one-rank cores axis: the gather is the identity
    # and the output is the replicated table gather's, as in the JAX
    # package (tests/test_torch_cores_mesh.py shards it over 2 and 4)
    mesh = make_cores_mesh(device='cpu')
    np.testing.assert_array_equal(
        lt.sharded_call(pats, mesh.get_group('cores')).numpy(),
        np.asarray(lj(pats)))


def test_interpreter_config_threads_hwconfig_lut():
    kw = dict(n_cores=2, meas_lut_mask=(True, True),
              meas_lut_table=(0, 1, 2, 3))
    for extra in ({}, dict(lut_mask=(True, False), lut_table=(0, 1)),
                  dict(fabric='lut', max_meas=3)):
        assert dataclasses.asdict(TCfg.from_fpga_config(TFPGA(**kw),
                                                        **extra)) \
            == dataclasses.asdict(JCfg.from_fpga_config(JFPGA(**kw),
                                                        **extra))
    assert TCfg.from_fpga_config(TFPGA()).lut_mask == ()


# ---------------------------------------------------------------------------
# programs


def _own_fresh_program():
    """Core 0 measures, then reads its own fresh bit (func_id 0) and
    branches; core 1 measures and reads the LUT."""
    meas = jisa.pulse_cmd(freq_word=1, cfg_word=2, env_word=(2 << 12) | 0,
                          cmd_time=10)
    drive = jisa.pulse_cmd(freq_word=2, cfg_word=0, env_word=(2 << 12) | 0,
                           cmd_time=400)
    return machine_program_from_cmds([
        [meas, jisa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                            func_id=0), drive, jisa.done_cmd()],
        [meas, jisa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                            func_id=1), drive, jisa.done_cmd()]])


def _starved_program():
    """The 3-core repetition round with core 2 never measuring: its LUT
    input is empty, so every read starves."""
    cores = []
    for c in range(3):
        cmds = [jisa.pulse_cmd(freq_word=1, cfg_word=2 if c < 2 else 0,
                               env_word=(2 << 12) | 0, cmd_time=10),
                jisa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                             func_id=1),
                jisa.jump_i(5),
                jisa.pulse_cmd(freq_word=2, cfg_word=0,
                               env_word=(2 << 12) | 0, cmd_time=400),
                jisa.pulse_cmd(cmd_time=420),
                jisa.done_cmd()]
        cores.append(cmds if c < 2 else [cmds[0], cmds[-1]])
    return machine_program_from_cmds(cores)


def _lut_programs():
    """(name, mp, config kwargs, bits per core) of the fabric's
    workloads at small sizes."""
    fb = bench.feedback_round_machine_program(3, 2, 3)
    return [
        ('repetition3', jrep.repetition_round_machine_program(3),
         _cfg_kw(jrep.repetition_config(3)), 2),
        # 4 cores: ties go to 0 (JAX's straight-line engine at 5 cores
        # trips an LLVM instruction-selection fault on some x86 CPUs)
        ('repetition4', jrep.repetition_round_machine_program(4),
         _cfg_kw(jrep.repetition_config(4)), 2),
        ('qec_multiround', jqec.qec_multiround_machine_program(3, 3),
         _cfg_kw(jqec.qec_config(3, 3)), 3),
        ('surface_cycle', jqec.surface_cycle_machine_program(3),
         _cfg_kw(jqec.surface_cycle_config(3)), 2),
        ('feedback', fb,
         dict(fb.static_bounds(), max_meas=2, max_resets=2,
              record_pulses=False, **jrep._lut_fabric_kwargs(3)), 2),
        ('own_fresh', _own_fresh_program(),
         dict(max_meas=2, fabric='lut', lut_mask=(True, True),
              lut_table=(0, 3, 1, 2)), 2),
        ('starved', _starved_program(), _cfg_kw(jrep.repetition_config(3)),
         2),
    ]


PROGRAMS = {name: (mp, kw, m) for name, mp, kw, m in _lut_programs()}


def _bits(mp, m, seed, batch=B):
    return np.random.default_rng(seed).integers(
        0, 2, (batch, mp.n_cores, m)).astype(np.int32)


# ---------------------------------------------------------------------------
# the engine ladder


def _reason_pair(fn_j, fn_t, mp, kw):
    return (fn_t(_to_port(mp), TCfg(**kw)), fn_j(mp, JCfg(**kw)))


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_eligibility_reasons_match_jax(name):
    mp, kw, _m = PROGRAMS[name]
    got, want = _reason_pair(jax_interp.straightline_ineligible,
                             torch_interp.straightline_ineligible, mp, kw)
    assert got == want
    phys = dict(kw, physics=True, device='parity')
    got, want = _reason_pair(jax_interp.fused_ineligible,
                             torch_interp.fused_ineligible, mp, phys)
    assert got == want
    want_mode = jax_interp._pallas_mode(jax_interp._soa_static(mp),
                                        JCfg(**kw))
    assert torch_interp._pallas_mode(_to_port(mp), TCfg(**kw)) == want_mode


def test_missing_lut_mask_matches_jax():
    mp = jrep.repetition_round_machine_program(3)
    kw = dict(fabric='lut', max_meas=2)
    got, want = _reason_pair(jax_interp.straightline_ineligible,
                             torch_interp.straightline_ineligible, mp, kw)
    assert got == want and 'lut_mask' in got
    bits = _bits(mp, 2, 1, 4)
    for engine in (None, 'generic', 'block'):
        assert _run_both(mp, bits, engine, **kw) is ValueError


def _engine_or_error(resolve, *args):
    try:
        return resolve(*args)
    except (ValueError, NotImplementedError) as e:
        return type(e)


_ENGINE_CFGS = [dict(engine=e) for e in (None, 'auto', 'generic', 'block',
                                         'straightline', 'pallas', 'fused')]


def test_ladder_matches_jax(monkeypatch):
    """The port's pick on the CPU is JAX's on its CPU backend; for a
    CUDA device it is JAX's on a backend that considers its Pallas
    kernel (K1, span or block mode), physics runs included."""
    table = {}
    for name, (mp, kw, _m) in PROGRAMS.items():
        for extra in _ENGINE_CFGS:
            for phys in ({}, dict(physics=True, device='parity')):
                c = dict(kw, **extra, **phys)
                table[name, str(extra), str(phys)] = (
                    mp, c, _engine_or_error(jax_interp.resolve_engine, mp,
                                            JCfg(**c)))
    for (name, *_), (mp, c, want) in table.items():
        got = _engine_or_error(torch_interp.resolve_engine, _to_port(mp),
                               TCfg(**c), 'cpu')
        assert got == want, (name, c, got, want)
    monkeypatch.setattr(jax_interp, '_PALLAS_AUTO_BACKENDS',
                        jax_interp._PALLAS_AUTO_BACKENDS
                        + (jax.default_backend(),))
    picks = {}
    for (name, *_), (mp, c, _) in table.items():
        want = _engine_or_error(jax_interp.resolve_engine, mp, JCfg(**c))
        got = _engine_or_error(torch_interp.resolve_engine, _to_port(mp),
                               TCfg(**c), 'cuda')
        assert got == want, (name, c, got, want)
        if c['engine'] == 'auto' and not c.get('physics'):
            picks[name] = got
    # the Motivation's table: 'auto' takes K1 for every workload on a card
    assert picks['repetition3'] == picks['qec_multiround'] \
        == picks['surface_cycle'] == 'pallas'


# ---------------------------------------------------------------------------
# every engine against JAX's


_ENGINES = ('generic', 'straightline', 'block', 'pallas', 'auto')


@pytest.mark.parametrize('engine', _ENGINES)
@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_engines_match_jax(name, engine):
    mp, kw, m = PROGRAMS[name]
    out = _run_both(mp, _bits(mp, m, sum(map(ord, name))), engine, **kw)
    if name == 'starved' and not isinstance(out, type):
        # the readers halt at the read with the deadlock/starved pair
        err = out['err'][:, :2].numpy()
        fault = out['fault'][:, :2].numpy()
        assert np.all(err & torch_interp.ERR_FPROC_DEADLOCK)
        assert np.all(fault & torch_interp.FAULT_FPROC_STARVED)
    if name in ('repetition3', 'surface_cycle') and engine != 'generic':
        assert not isinstance(out, type), (name, engine)


@pytest.mark.parametrize('seed', range(3))
def test_lut_fuzz_matches_jax(seed):
    """Random span-eligible LUT programs (:func:`lut_feedback_program`):
    reads into registers and branches, jumps from below the first read
    index past it on random registers, lanes that skip a masked core's
    measurement and starve their shot's readers."""
    rng = np.random.default_rng(900 + seed)
    mp, mask, table = lut_feedback_program(
        rng, jisa, machine_program_from_cmds, n_cores=3 + seed % 3)
    kw = dict(fabric='lut', lut_mask=mask, lut_table=table, max_meas=8,
              max_pulses=24, opcode_histogram=True)
    assert jax_interp.straightline_ineligible(mp, JCfg(**kw)) is None
    bits = _bits(mp, 8, seed)
    init = rng.integers(-3, 3, (B, mp.n_cores, 16)).astype(np.int32)
    outs = [_run_both(mp, bits, e, init_regs=init, **kw)
            for e in ('generic', 'straightline', 'block')]
    # the draw reaches the starved terminal on some lanes, not all
    starved = (outs[0]['fault'] & torch_interp.FAULT_FPROC_STARVED) != 0
    assert 0 < int(starved.sum()) < starved.numel()


def test_time_indexed_slot_in_multiround():
    """Round r's read serves round r's bits: the production clocks of
    earlier rounds lie below the read, later ones above it."""
    mp, kw, m = PROGRAMS['qec_multiround']
    bits = _bits(mp, m, 5)
    out = torch_simulate_batch(_to_port(mp), bits, device='cpu',
                               cfg=TCfg(engine='block', **kw))
    mt = out['meas_time'].numpy()
    assert np.all(mt == np.array([10, 1010, 2010], np.int32))
    maj = [(bits[:, :, r].sum(1) * 2 > 3).astype(int) for r in range(3)]
    flips = sum((bits[:, :, r] != maj[r][:, None]).astype(int)
                for r in range(3))
    np.testing.assert_array_equal(out['n_pulses'].numpy(), 3 + 2 * flips)


def _golden_lut_setup(name):
    """A golden program re-wired onto the fabric: a parity table over up
    to 4 masked cores, every core's output bit driven."""
    n_qubits, thunk = J_GOLDEN_PROGRAMS[name]   # the JAX compile
    mp = compile_to_machine(thunk(), make_default_qchip(max(n_qubits, 2)),
                            n_qubits=n_qubits)
    C = mp.n_cores
    k = min(C, 4)
    table = tuple(((1 << C) - 1) if bin(a).count('1') & 1 else 0
                  for a in range(1 << k))
    kw = dict(mp.static_bounds(), max_meas=16, max_resets=64, fabric='lut',
              lut_mask=(True,) * k + (False,) * (C - k), lut_table=table)
    # the re-wiring can make a feedback-conditioned loop unbounded: cap
    # the budget (both packages truncate at the same step or iteration)
    kw['max_steps'] = min(kw['max_steps'], 400)
    return mp, kw, _bits(mp, 16, 17, 4)


@pytest.mark.parametrize('name', sorted(GOLDEN_PROGRAMS))
def test_golden_programs_under_lut(name):
    mp, kw, bits = _golden_lut_setup(name)
    assert torch_interp.straightline_ineligible(_to_port(mp), TCfg(**kw)) \
        == jax_interp.straightline_ineligible(mp, JCfg(**kw))
    for engine in ('generic', 'block'):
        _run_both(mp, bits, engine, **kw)


# ---------------------------------------------------------------------------
# physics: the compiled repetition round, closed by the readout chain


@pytest.fixture(scope='module')
def round3():
    n = 3
    mp = JSimulator(n_qubits=n).compile(jrep.repetition_round_program(n))
    init = np.array([[(s >> i) & 1 for i in range(n)] for s in range(8)],
                    np.int32)
    kw = dict(max_steps=mp.n_instr * 6 + 64,
              **jrep.repetition_physics_kwargs(n))
    return mp, init, kw


@pytest.mark.parametrize('engine', ['generic', 'straightline', 'fused'])
def test_physics_round_matches_jax_at_sigma0(round3, engine):
    mp, init, kw = round3
    out_j = jax_run_physics(mp, JPhysics(sigma=0.0), 11, 8, init_states=init,
                            engine=engine, pallas_interpret=True, **kw)
    out_t = torch_run_physics(_to_port(mp), TPhysics(sigma=0.0), 11, 8,
                              init_states=init, engine=engine, device='cpu',
                              **kw)
    _assert_same(out_j, out_t, engine)
    assert int(out_t['epochs']) == (1 if engine == 'fused' else 2)


def test_physics_round_majority_correction(round3):
    """The port's run of the JAX test at sigma = 0.01: the syndrome is the
    initial pattern and every core ends at its pattern's majority."""
    mp, init, kw = round3
    n = init.shape[1]
    out = torch_run_physics(_to_port(mp), TPhysics(sigma=0.01), 11, 8,
                            init_states=init, device='cpu', **kw)
    assert not bool(out['incomplete'])
    assert not np.any(out['err'].numpy())
    np.testing.assert_array_equal(out['meas_bits'][:, :, 0].numpy(), init)
    maj = (init.sum(axis=1) * 2 > n).astype(np.int32)
    np.testing.assert_array_equal(out['qturns'].numpy() % 4 // 2,
                                  np.broadcast_to(maj[:, None], (8, n)))
    np.testing.assert_array_equal(
        out['n_pulses'].numpy(),
        2 + 2 * (init != maj[:, None]).astype(np.int32))


# ---------------------------------------------------------------------------
# the facade


def test_simulator_with_lut_fpga_config_matches_jax():
    n = 3
    table = jrep.majority_lut(n)
    mask = (True,) * n
    mp = jrep.repetition_round_machine_program(n)
    bits = _bits(mp, 2, 23, 16)
    sim_t = TSimulator(n_qubits=n, device='cpu', fpga_config=TFPGA(
        n_cores=n, meas_lut_mask=mask, meas_lut_table=table))
    sim_j = JSimulator(n_qubits=n, fpga_config=JFPGA(
        n_cores=n, meas_lut_mask=mask, meas_lut_table=table))
    kw = dict(fabric='lut', max_meas=2, max_pulses=8)
    out_t = sim_t.run(_to_port(mp), shots=16, meas_bits=bits, **kw)
    out_j = sim_j.run(mp, shots=16, meas_bits=bits, **kw)
    assert out_t['_cfg'].lut_table == table
    _assert_same(out_j, out_t, 'Simulator.run')
    assert sorted(np.unique(out_t['n_pulses'].numpy())) == [1, 3]
