"""The port's straight-line engine and engine ladder against the JAX
package's.

Same program, same injected measurement bits, same config: every output
key of ``simulate_batch(engine='straightline')`` — pulse records,
registers, clocks, ``err``, ``fault``, the opcode histogram and ``steps``
— must be identical, value and dtype, to JAX ``engine='straightline'``.
Programs: the golden programs, the RTL-derived timing vectors, the
oracle fuzz programs and a straight-line feedback fuzz (own-core fproc
reads and forward branches on them, measurement pulses, qclk loads,
resets, idles, register-sourced pulse parameters, taken jumps past the
end).  The engine ladder (``resolve_engine``) must pick what JAX picks,
on the CPU and, for a CUDA device, what JAX picks with the CPU backend
allowed its Pallas rung; forced engines raise the JAX exception types.
The physics epoch loop on the straight-line engine is held against JAX
at sigma = 0 with explicit initial states.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import jax

import bench
from distributed_processor_tpu import isa, models, pipeline
from distributed_processor_tpu.decoder import machine_program_from_cmds
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.sim import interpreter as jax_interp
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_batch as jax_simulate_batch)
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run_physics)

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch.sim import interpreter as torch_interp
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate_batch as torch_simulate_batch)
from distributed_processor_tpu_torch.sim.physics import (
    physics_from_dict, run_physics_batch)

from test_interpreter import _random_program
from test_torch_cuda import sl_feedback_program
from test_torch_interpreter import RTL_CASES, _rtl_program, _to_port

B = 8


def assert_same_as_jax(mp, meas_bits, engine='straightline', init_regs=None,
                       jax_kw=None, **kw):
    """Run both packages on ``engine``; every output key equal in value
    and dtype, ``steps`` included."""
    out_j = jax_simulate_batch(mp, meas_bits, init_regs=init_regs,
                               cfg=JCfg(engine=engine, **kw, **(jax_kw or {})))
    out_t = torch_simulate_batch(_to_port(mp), meas_bits,
                                 init_regs=init_regs,
                                 cfg=TCfg(engine=engine, **kw), device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)
    return out_t


def assert_same_error(mp, meas_bits, **kw):
    """Both packages refuse the config with the same exception type."""
    with pytest.raises(Exception) as exc_j:
        jax_simulate_batch(mp, meas_bits, cfg=JCfg(**kw))
    with pytest.raises(exc_j.type):
        torch_simulate_batch(_to_port(mp), meas_bits, cfg=TCfg(**kw),
                             device='cpu')


def _bits(rng, mp, m=4):
    return rng.integers(0, 2, (B, mp.n_cores, m)).astype(np.int32)


def _golden(name):
    n, thunk = J_GOLDEN_PROGRAMS[name]      # the JAX compile
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        return pipeline.compile_to_machine(
            thunk(), models.make_default_qchip(max(n, 2)), n_qubits=n)


def _golden_cases():
    cases = []
    for name in sorted(GOLDEN_PROGRAMS):
        fabrics = ('sticky', 'fresh') if name in (
            'active_reset_2q', 'fproc_hold') else ('sticky',)
        cases += [(name, fab) for fab in fabrics]
    return cases


@pytest.mark.parametrize('name,fabric', _golden_cases())
def test_golden_programs(name, fabric):
    mp = _golden(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    kw = dict(fabric=fabric, max_meas=4, max_steps=300,
              opcode_histogram=True)
    if jax_interp.straightline_ineligible(mp, JCfg(**kw)):
        # loops, cross-core or fresh-fabric reads: both packages refuse
        assert_same_error(mp, _bits(rng, mp), engine='straightline', **kw)
        return
    assert_same_as_jax(mp, _bits(rng, mp), **kw)


@pytest.mark.parametrize('case', RTL_CASES, ids=[c['name'] for c in RTL_CASES])
def test_rtl_timing_vectors(case):
    mp = _rtl_program(case)
    rng = np.random.default_rng(7)
    meas = _bits(rng, mp)
    if case.get('meas_bits') is not None:
        fixed = np.asarray(case['meas_bits'], np.int32)
        meas[:, :, :fixed.shape[-1]] = fixed[None, :, :4]
    fabric = case.get('fabric', 'sticky')
    kw = dict(fabric=fabric, max_meas=4)
    if fabric == 'lut':
        kw.update(lut_mask=tuple(case['lut_mask']),
                  lut_table=tuple(case['lut_table']))
    if jax_interp.straightline_ineligible(mp, JCfg(**kw)):
        assert_same_error(mp, meas, engine='straightline', **kw)
        return
    out = assert_same_as_jax(mp, meas, **kw)
    exp = case['expected']
    for key in ('time', 'qclk'):
        for c, want in enumerate(exp.get(key, [])):
            assert int(out[key][0, c]) == want, (key, c)


@pytest.mark.parametrize('fabric', ['sticky', 'fresh'])
@pytest.mark.parametrize('seed', range(4))
def test_oracle_fuzz_programs(seed, fabric):
    rng = np.random.default_rng(100 + seed)
    mp = _random_program(rng)
    init = rng.integers(-5, 5, (B, mp.n_cores, isa.N_REGS)).astype(np.int32)
    assert_same_as_jax(mp, _bits(rng, mp, 8), init_regs=init, fabric=fabric,
                       max_pulses=64, max_meas=8, opcode_histogram=True)


def _sl_feedback_program(rng):
    return sl_feedback_program(rng, isa, machine_program_from_cmds)


@pytest.mark.parametrize('seed', range(6))
def test_feedback_fuzz_programs(seed):
    rng = np.random.default_rng(700 + seed)
    mp = _sl_feedback_program(rng)
    assert jax_interp.straightline_ineligible(mp, JCfg()) is None
    init = rng.integers(-5, 5, (B, mp.n_cores, isa.N_REGS)).astype(np.int32)
    out = assert_same_as_jax(mp, _bits(rng, mp), init_regs=init, max_meas=4,
                             max_pulses=12, max_resets=2,
                             opcode_histogram=True)
    assert int(out['steps']) == mp.n_instr


def test_physics_mode_injected_bits():
    """``physics=True`` through the injected-bits entry: the parity
    co-state and the measurement planes agree with JAX."""
    rng = np.random.default_rng(11)
    mp = _sl_feedback_program(rng)
    assert_same_as_jax(mp, _bits(rng, mp), max_meas=4, max_pulses=12,
                       physics=True, device='parity', x90_amp=3000)


# ---------------------------------------------------------------------------
# the engine ladder


def _ladder_programs():
    mps = [_golden(name) for name in sorted(GOLDEN_PROGRAMS)]
    mps += [_random_program(np.random.default_rng(s)) for s in range(2)]
    mps += [_sl_feedback_program(np.random.default_rng(s)) for s in range(2)]
    mps.append(bench.build_machine_program(2, 2))
    return mps


_LADDER_CFGS = [dict(engine=e, straightline=s)
                for e in (None, 'auto', 'generic')
                for s in (None, False, True)] + [
    dict(engine='auto', fabric='fresh'),
    dict(engine='auto', physics=True, device='parity'),
    dict(engine=None, straightline=None, physics=True, device='parity'),
    dict(engine='auto', trace=True),
    dict(engine=None, straightline=None, trace=True),
]


def _engine_or_error(resolve, mp, cfg, *args):
    try:
        return resolve(mp, cfg, *args)
    except ValueError as e:
        return type(e)


def test_ladder_matches_jax_on_cpu():
    """Every program x config: the port's pick on the CPU is JAX's on its
    CPU backend, raising ValueError where JAX does."""
    assert jax.default_backend() not in jax_interp._PALLAS_AUTO_BACKENDS
    for mp in _ladder_programs():
        mpt = _to_port(mp)
        for kw in _LADDER_CFGS:
            want = _engine_or_error(jax_interp.resolve_engine, mp,
                                    JCfg(max_meas=4, **kw))
            got = _engine_or_error(torch_interp.resolve_engine, mpt,
                                   TCfg(max_meas=4, **kw), 'cpu')
            assert got == want, (kw, got, want)


def test_ladder_on_cuda_matches_jax_on_its_kernel_backend(monkeypatch):
    """For a CUDA device the port picks what JAX picks on a backend where
    it considers its Pallas kernel — K1 — under the same size caps."""
    monkeypatch.setattr(jax_interp, '_PALLAS_AUTO_BACKENDS',
                        jax_interp._PALLAS_AUTO_BACKENDS
                        + (jax.default_backend(),))
    seen = set()
    for mp in _ladder_programs():
        mpt = _to_port(mp)
        for kw in _LADDER_CFGS:
            want = _engine_or_error(jax_interp.resolve_engine, mp,
                                    JCfg(max_meas=4, **kw))
            got = _engine_or_error(torch_interp.resolve_engine, mpt,
                                   TCfg(max_meas=4, **kw), 'cuda')
            assert got == want, (kw, got, want)
            seen.add(got)
    assert {'pallas', 'straightline', 'generic'} <= seen
    # the size cap: past it 'auto' leaves the kernel in both packages
    mp = bench.build_machine_program(2, 2)
    monkeypatch.setattr(jax_interp, 'SL_AUTO_MAX_INSTR', 2)
    monkeypatch.setattr(torch_interp, 'SL_AUTO_MAX_INSTR', 2)
    cfg = dict(engine='auto', max_meas=4)
    assert torch_interp.resolve_engine(_to_port(mp), TCfg(**cfg), 'cuda') \
        == jax_interp.resolve_engine(mp, JCfg(**cfg)) != 'pallas'


def test_default_config_takes_the_straightline_engine():
    """``straightline=None`` (the bench's config) and ``engine='auto'``
    resolve to the straight-line engine on the CPU, as in JAX, and count
    ``steps`` as JAX does (one pass of ``n_instr``)."""
    mp = bench.build_machine_program(2, 2)
    rng = np.random.default_rng(3)
    for kw in (dict(straightline=None), dict(engine='auto')):
        assert torch_interp.resolve_engine(_to_port(mp), TCfg(**kw),
                                           'cpu') == 'straightline'
        out = assert_same_as_jax(mp, _bits(rng, mp, 2), engine=kw.get(
            'engine'), max_meas=2, **{k: v for k, v in kw.items()
                                      if k != 'engine'})
        assert int(out['steps']) == mp.n_instr


def test_forced_engine_errors_match_jax():
    loop = _golden('simple_loop')
    span = _golden('active_reset_2q')
    bits_l = _bits(np.random.default_rng(1), loop)
    bits_s = _bits(np.random.default_rng(2), span)
    # ineligible forced rungs: ValueError in both packages
    assert_same_error(loop, bits_l, engine='straightline', max_steps=100)
    assert_same_error(loop, bits_l, straightline=True, max_steps=100)
    assert_same_error(span, bits_s, engine='straightline', trace=True)
    assert_same_error(span, bits_s, engine='pallas', trace=True)
    assert_same_error(span, bits_s, engine='pallas', physics=True,
                      device='parity')
    assert_same_error(span, bits_s, engine='fused')
    assert_same_error(span, bits_s, engine='nope')
    # trace mode: the rungs that refuse it give JAX's message word for
    # word, and the picks that take the generic engine for it run with
    # every key, the per-step traces included, equal to JAX's
    for eng in ('straightline', 'pallas'):
        with pytest.raises(ValueError) as e_j:
            jax_simulate_batch(span, bits_s, engine=eng, trace=True)
        with pytest.raises(ValueError) as e_t:
            torch_simulate_batch(_to_port(span), bits_s, device='cpu',
                                 engine=eng, trace=True)
        assert str(e_t.value) == str(e_j.value)
    for eng in (None, 'auto'):
        out = assert_same_as_jax(span, bits_s, engine=eng, trace=True)
        assert 'trace_pc' in out
    # the engines a loop may take run it as JAX does: 'pallas' on a loop
    # is the block engine with K1 block's bodies (plain on the CPU), so
    # it is held against JAX 'block'; 'auto' against JAX 'auto'
    for eng, jax_eng in (('block', 'block'), ('pallas', 'block'),
                         ('auto', 'auto')):
        out_j = jax_simulate_batch(loop, bits_l, cfg=JCfg(
            engine=jax_eng, max_steps=100))
        out_t = torch_simulate_batch(_to_port(loop), bits_l, device='cpu',
                                     engine=eng, max_steps=100)
        assert set(out_t) == set(out_j)
        for key in out_j:
            np.testing.assert_array_equal(out_t[key].numpy(),
                                          np.asarray(out_j[key]),
                                          err_msg=f'{eng}: {key}')


# ---------------------------------------------------------------------------
# the physics epoch loop on the straight-line engine


@pytest.fixture(scope='module')
def headline():
    mp_j = bench.build_machine_program(2, 2)
    cfg = dict(max_steps=2 * mp_j.n_instr + 64,
               max_pulses=int(mp_j.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2, record_pulses=False)
    init = np.random.default_rng(3).integers(0, 2, (16, 2)).astype(np.int32)
    return mp_j, _to_port(mp_j), cfg, init


@pytest.mark.parametrize('engine', ['straightline', None])
def test_physics_straightline_matches_jax(headline, engine):
    mp_j, mp_t, cfg, init = headline
    jm = JPhysics(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                  resolve_mode='fused')
    tm = physics_from_dict(dataclasses.asdict(jm))
    kw = dict(engine=engine, straightline=None, **cfg)
    out_j = jax_run_physics(mp_j, jm, 0, len(init), init_states=init,
                            cfg=JCfg(**kw))
    out_t = run_physics_batch(mp_t, tm, 0, len(init), init_states=init,
                              cfg=TCfg(**kw), device='cpu')
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    assert int(out_t['epochs']) == 2
    assert int(out_t['steps']) == 2 * mp_t.n_instr
