"""The cores mesh in the port against the JAX package's, on 2, 3 and 4 ranks.

ONE program's core axis sharded over the ranks of a ``('dp', 'cores')``
mesh: each rank runs its own cores' lanes, and the fproc fabric and the
sync barrier read the other cores' words through one all-gather per step
(``sim/interpreter.py`` ``_step``, the JAX ``_gat`` layer), with the
settle test and quiescence taken over every rank so all ranks take the
same steps.  Ranks are gloo processes on the CPU
(``tests/test_torch_spmd_worker.py``: one launch per world size for every
case of this file, under a deadline that kills every rank on a failure
or a hang).  Pinned, as ``tests/test_ici_fabric.py`` pins the JAX
package:

* every key of ``sharded_cores_simulate`` — the shards concatenated in
  mesh order, the fault word included — equals the JAX package's
  single-device generic engine (which that file pins equal to JAX's
  sharded run) and the port's, on the multi-core golden programs, the
  ``lut`` repetition round (3 and 4 cores; also against JAX's sharded
  run) and an 8-core swept-pulse program with per-shot registers, on the
  generic engine and ``engine='block'`` (its bodies on the rank's own
  cores); ``sharded_cores_rounds`` equals JAX's on both engines;
* ``sharded_cores_stat_sums`` equals host folds of the full outputs,
  ``run_cores_sweep`` the port's single-device batches on its bits;
* ``MeasLUT.sharded_call`` returns the replicated call's full width;
* the blockers: a mesh without ``'cores'``, a core count that does not
  divide, physics sweeps over a cores mesh, and the engine ladder's
  ``cores_ineligible`` reasons, with the JAX package's messages.
"""

import numpy as np
import pytest
import torch

from distributed_processor_tpu.models.default_qchip import \
    make_default_qchip as j_qchip
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.models.repetition import (
    _lut_fabric_kwargs, repetition_round_machine_program as j_rep)
from distributed_processor_tpu.parallel import (
    make_cores_mesh as j_cores_mesh, sharded_cores_rounds as j_rounds,
    sharded_cores_simulate as j_sharded)
from distributed_processor_tpu.parallel.param_sweep import \
    swept_pulse_machine_program as j_swept
from distributed_processor_tpu.pipeline import compile_to_machine as j_comp
from distributed_processor_tpu.sim import interpreter as jint
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg

from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch.sim import interpreter as tint
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg)
from distributed_processor_tpu_torch.sim.physics import (ReadoutPhysics,
                                                         derive_seed)

from test_torch_interpreter import _to_port
from test_torch_spmd_worker import run_spmd

WORLDS = (2, 3, 4)
S = 12                       # shots: divisible by every dp extent here


def _golden(name):
    n_qubits, thunk = J_GOLDEN_PROGRAMS[name]   # the JAX compile
    return j_comp(thunk(), j_qchip(max(n_qubits, 2)), n_qubits=n_qubits)


GOLDEN = sorted(n for n in GOLDEN_PROGRAMS if _golden(n).n_cores > 1)


def _mesh_spec(n_cores: int, world: int) -> tuple:
    """The widest cores axis dividing both the program and the world."""
    shards = max(s for s in range(1, world + 1)
                 if n_cores % s == 0 and world % s == 0)
    return ('cores', shards, world // shards)


@pytest.fixture(scope='module')
def programs():
    """name -> (jax program, port program, config kwargs, bits, regs)."""
    out = {}
    for name in GOLDEN:
        mp = _golden(name)
        kw = dict(mp.static_bounds(), max_meas=16, max_resets=64)
        bits = np.random.default_rng(17).integers(
            0, 2, (S, mp.n_cores, 16)).astype(np.int32)
        out[name] = (mp, _to_port(mp), kw, bits, None)
    for n_data in (3, 4):
        mp = j_rep(n_data=n_data)
        kw = dict(mp.static_bounds(), max_meas=4, max_resets=4,
                  **_lut_fabric_kwargs(n_data))
        bits = np.random.default_rng(9 + n_data).integers(
            0, 2, (S, mp.n_cores, 4)).astype(np.int32)
        out[f'lut_rep{n_data}'] = (mp, _to_port(mp), kw, bits, None)
    mp = j_swept(8)
    rng = np.random.default_rng(41)
    regs = np.zeros((S, 8, 16), np.int32)
    regs[..., 0] = rng.integers(0, 1 << 16, (S, 8))
    out['swept8'] = (mp, _to_port(mp),
                     dict(mp.static_bounds(), max_meas=2, max_resets=2),
                     rng.integers(0, 2, (S, 8, 2)).astype(np.int32), regs)
    return out


def _rounds_bits(n_cores):
    return np.random.default_rng(17).integers(
        0, 2, (3, S, n_cores, 4), dtype=np.int32)


def _lut_case(world):
    mask = (True,) * (2 * world)
    size = 1 << (2 * world)
    table = tuple((a * 5) % size for a in range(size))
    bits = np.random.default_rng(7).integers(
        0, 2, (8, 2 * world)).astype(np.int32)
    return mask, table, bits


def _cases(progs: dict, world: int) -> dict:
    call = lambda fn, mesh, args, **k: ('call', dict(
        fn=fn, mesh=mesh, args=args, kwargs=k))
    cases = {}
    for name, (mp, mp_t, kw, bits, regs) in progs.items():
        spec = _mesh_spec(mp.n_cores, world)
        for eng in ('generic', 'block'):
            cases[f'sim/{name}/{eng}'] = call(
                'sharded_cores_simulate', spec, (mp_t, bits), init_regs=regs,
                cfg=TCfg(**dict(kw, engine=None if eng == 'generic'
                                else eng)))
    _, rep_t, kw, bits, _ = progs['lut_rep4']
    spec = _mesh_spec(4, world)
    for eng in ('generic', 'block'):
        cases[f'rounds/{eng}'] = call(
            'sharded_cores_rounds', spec, (rep_t, _rounds_bits(4)),
            cfg=TCfg(**dict(kw, engine=eng)))
    cases['stat_sums'] = call('sharded_cores_stat_sums', spec, (rep_t, bits),
                              cfg=TCfg(**kw))
    cases['stats'] = call('sharded_cores_stats', spec, (rep_t, bits),
                          cfg=TCfg(**kw))
    cases['sweep'] = call('run_cores_sweep', spec, (rep_t, 2 * S, S),
                          seed=3, cfg=TCfg(**kw))
    mask, table, lbits = _lut_case(world)
    cases['lut'] = ('lut_sharded_call', dict(mask=mask, table=table,
                                            bits=lbits, n_shards=world))
    # the blockers, raised on every rank before any collective
    cases['no_cores_axis'] = call('sharded_cores_simulate',
                                  ('dp', world, 1), (rep_t, bits),
                                  cfg=TCfg(**kw))
    _, rep3_t, kw3, bits3, _ = progs['lut_rep3']
    cases['indivisible'] = call('sharded_cores_simulate', ('cores', 2,
                                                           world // 2),
                                (rep3_t, bits3), cfg=TCfg(**kw3)) \
        if world % 2 == 0 else call('sharded_cores_simulate',
                                    ('cores', 3, 1), (rep_t, bits),
                                    cfg=TCfg(**kw))
    cases['physics_sweep'] = call(
        'run_physics_sweep', ('cores', world, 1),
        (rep_t, ReadoutPhysics(sigma=0.05), 4, 4), max_steps=256,
        max_pulses=8, max_meas=4, max_resets=4)
    cases['strict'] = call('sharded_cores_simulate', spec, (rep_t, bits),
                           cfg=TCfg(**dict(kw, fault_mode='strict',
                                           max_steps=3)))
    return cases


@pytest.fixture(scope='module')
def runs(programs, tmp_path_factory):
    out = {}
    for world in WORLDS:
        cases = _cases(programs, world)
        res = run_spmd(list(cases.values()), world,
                       tmp_path_factory.mktemp(f'cores{world}'))
        out[world] = {name: [r[i] for r in res]
                      for i, name in enumerate(cases)}
    return out


def _gather(shards: list, spec: tuple, lead: int = 0) -> dict:
    """Rank shards of a ``(dp, cores)`` layout (rank ``r * cores + c``)
    -> the global arrays: cores blocks concatenated along the core axis
    within a dp row, dp rows along the shot axis; ``lead`` leading axes
    (the rounds) come first."""
    _, n_cores, n_dp = spec
    return {k: np.concatenate(
        [np.concatenate([shards[r * n_cores + c][k] for c in range(n_cores)],
                        lead + 1) for r in range(n_dp)], lead)
        for k in shards[0]}


@pytest.fixture(scope='module')
def refs(programs):
    """name -> (JAX single-device generic, port single-device generic)."""
    out = {}
    for name, (mp, mp_t, kw, bits, regs) in programs.items():
        j = jint.simulate_batch(mp, bits, init_regs=regs,
                                cfg=JCfg(engine='generic', **kw))
        t = tint.simulate_batch(mp_t, bits, init_regs=regs,
                                cfg=TCfg(engine='generic', **kw),
                                device='cpu')
        out[name] = ({k: np.asarray(v) for k, v in j.items()},
                     {k: v.numpy() for k, v in t.items()})
    return out


def _assert_identical(single: dict, sharded: dict, msg: str):
    """Every key of the sharded run equals the single-device run's;
    only the scalar diagnostics are dropped."""
    missing = set(single) - set(sharded) - {'steps', 'incomplete', 'op_hist'}
    assert not missing, f'{msg}: sharded run dropped {missing}'
    for k in sorted(set(single) & set(sharded)):
        np.testing.assert_array_equal(sharded[k], single[k],
                                      err_msg=f'{msg}: {k}')
        assert sharded[k].dtype == single[k].dtype, (msg, k)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('engine', ['generic', 'block'])
@pytest.mark.parametrize('name', GOLDEN + ['lut_rep3', 'lut_rep4',
                                           'swept8'])
def test_sharded_cores_simulate_identical(programs, refs, runs, world, name,
                                          engine):
    mp = programs[name][0]
    spec = _mesh_spec(mp.n_cores, world)
    got = _gather(runs[world][f'sim/{name}/{engine}'], spec)
    j_ref, t_ref = refs[name]
    _assert_identical(j_ref, got, f'{name} on {spec} vs JAX')
    _assert_identical(t_ref, got, f'{name} on {spec} vs the port')


def test_some_program_really_sharded(programs):
    """Every world shards at least one program over >= 2 ranks of
    'cores', and the lut round fires syndrome-dependent corrections."""
    for world in WORLDS:
        assert any(_mesh_spec(p[0].n_cores, world)[1] >= 2
                   for p in programs.values()), world
    mp, _, kw, bits, _ = programs['lut_rep3']
    out = jint.simulate_batch(mp, bits, cfg=JCfg(engine='generic', **kw))
    assert len(np.unique(np.asarray(out['n_pulses']))) > 1


@pytest.mark.parametrize('world', WORLDS)
def test_lut_repetition_matches_jax_sharded(programs, runs, world):
    """The 3-core repetition round against the JAX package's own sharded
    run (one core per device, dp = 2)."""
    mp, _, kw, bits, _ = programs['lut_rep3']
    want = j_sharded(mp, bits, j_cores_mesh(n_cores=3, n_dp=2),
                     cfg=JCfg(**kw))
    got = _gather(runs[world]['sim/lut_rep3/generic'],
                  _mesh_spec(3, world))
    _assert_identical({k: np.asarray(v) for k, v in want.items()}, got,
                      'lut_rep3 vs JAX sharded')


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('engine', ['generic', 'block'])
def test_sharded_cores_rounds_match_jax(programs, runs, world, engine):
    mp, _, kw, _, _ = programs['lut_rep4']
    mesh = j_cores_mesh(n_cores=4, n_dp=2)
    want = j_rounds(mp, _rounds_bits(4), mesh,
                    cfg=JCfg(**dict(kw, engine=engine)))
    got = _gather(runs[world][f'rounds/{engine}'], _mesh_spec(4, world),
                  lead=1)
    _assert_identical({k: np.asarray(v) for k, v in want.items()}, got,
                      f'rounds[{engine}]')


@pytest.mark.parametrize('world', WORLDS)
def test_stat_sums_match_host_folds(refs, runs, world):
    full = refs['lut_rep4'][1]
    for res in runs[world]['stat_sums']:
        np.testing.assert_array_equal(res['pulse_sum'],
                                      full['n_pulses'].sum(0))
        np.testing.assert_array_equal(res['qclk_sum'], full['qclk'].sum(0))
        assert int(res['err_shots']) == int(
            (full['err'] != 0).any(1).sum())
        assert not res['fault_shots'].any()
    for res in runs[world]['stats']:
        np.testing.assert_array_equal(
            res['mean_pulses'],
            (torch.as_tensor(full['n_pulses']).sum(0) / S).numpy())


@pytest.mark.parametrize('world', WORLDS)
def test_run_cores_sweep_driver(programs, runs, world):
    """Batch ``i``'s bits come from ``derive_seed(seed, i)`` on every
    rank; the folded sums equal single-device batches on those bits."""
    _, mp_t, kw, _, _ = programs['lut_rep4']
    pulses = qclk = 0
    for i in range(2):
        gen = torch.Generator()
        gen.manual_seed(derive_seed(3, i) >> 1)
        bits = (torch.rand((S, 4, kw['max_meas']), generator=gen)
                < 0.5).to(torch.int32)
        out = tint.simulate_batch(mp_t, bits, cfg=TCfg(engine='generic',
                                                       **kw), device='cpu')
        pulses = pulses + out['n_pulses'].sum(0).numpy()
        qclk = qclk + out['qclk'].sum(0).numpy()
    for res in runs[world]['sweep']:
        assert res['shots'] == 2 * S and res['engine'] == 'generic'
        np.testing.assert_array_equal(res['mean_pulses'] * 2 * S, pulses)
        np.testing.assert_array_equal(res['mean_qclk'] * 2 * S, qclk)
        assert set(res['fault_shots'].values()) == {0}


@pytest.mark.parametrize('world', WORLDS)
def test_meas_lut_sharded_call_identity(runs, world):
    from distributed_processor_tpu.ops.fabric import MeasLUT as JLUT
    mask, table, bits = _lut_case(world)
    want = np.asarray(JLUT(mask, table)(bits))
    for res in runs[world]['lut']:
        np.testing.assert_array_equal(res, want)


@pytest.mark.parametrize('world', WORLDS)
def test_blockers_raise_on_every_rank(runs, world):
    for case, needle in (('no_cores_axis', "('dp', 'cores') mesh"),
                         ('indivisible', 'not divisible'),
                         ('physics_sweep', 'epoch resolver')):
        for res in runs[world][case]:
            assert res[0] == 'raised' and res[1] == 'ValueError', (case, res)
            assert needle in res[2], (case, res[2])


@pytest.mark.parametrize('world', WORLDS)
def test_strict_faults_raise_on_every_rank(runs, world):
    """``fault_mode='strict'`` counts trapped shots over the whole mesh
    and raises the same FaultError on every rank."""
    msgs = {res[2] for res in runs[world]['strict']}
    assert len(msgs) == 1 and f'budget_exhausted={S}' in msgs.pop()
    for res in runs[world]['strict']:
        assert res[:2] == ('raised', 'FaultError')


def _rep3():
    mp = j_rep(n_data=3)
    return mp, _to_port(mp), dict(mp.static_bounds(), max_meas=4,
                                  max_resets=4, **_lut_fabric_kwargs(3))


@pytest.mark.parametrize('bad,needle', [
    (dict(engine='pallas'), 'ineligible'),
    (dict(engine='fused'), 'ineligible'),
    (dict(straightline=True), 'ineligible'),
    (dict(trace=True), 'ineligible'),
    (dict(physics=True), 'epoch resolver'),
    (dict(engine='block', trace=True), 'block-ineligible')],
    ids=['pallas', 'fused', 'straightline', 'trace', 'physics',
         'block_trace'])
def test_cores_axis_blockers_named(bad, needle):
    """The engine ladder's cores blockers: the JAX package's reasons and
    messages, word for word."""
    mp, mp_t, kw = _rep3()
    jcfg = JCfg(cores_axis='cores', **dict(kw, **bad))
    tcfg = TCfg(cores_axis='cores', **dict(kw, **bad))
    assert tint.cores_ineligible(mp_t, tcfg) == jint.cores_ineligible(mp,
                                                                       jcfg)
    with pytest.raises(ValueError, match=needle) as e_t:
        tint.resolve_engine(mp_t, tcfg, 'cpu')
    with pytest.raises(ValueError) as e_j:
        jint.resolve_engine(mp, jcfg)
    assert str(e_t.value) == str(e_j.value)


def test_cores_axis_ladder_picks():
    mp, mp_t, kw = _rep3()
    for eng, want in ((None, 'generic'), ('generic', 'generic'),
                      ('auto', 'generic'), ('block', 'block')):
        cfg = TCfg(cores_axis='cores', **dict(kw, engine=eng))
        assert tint.cores_ineligible(mp_t, cfg) is None
        assert tint.resolve_engine(mp_t, cfg, 'cpu') == want == \
            jint.resolve_engine(mp, JCfg(cores_axis='cores',
                                         **dict(kw, engine=eng)))


def test_single_device_entry_points_reject_cores_axis():
    mp, mp_t, kw = _rep3()
    cfg = TCfg(cores_axis='cores', **kw)
    bits = np.zeros((2, mp.n_cores, 4), np.int32)
    for run in (lambda: tint.simulate_batch(mp_t, bits, cfg=cfg,
                                            device='cpu'),
                lambda: tint.simulate(mp_t, bits[0], cfg=cfg, device='cpu'),
                lambda: tint.simulate_multi_batch([mp_t], bits, cfg=cfg,
                                                  device='cpu')):
        with pytest.raises(ValueError, match='sharded_cores_simulate'):
            run()
