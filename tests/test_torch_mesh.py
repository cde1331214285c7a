"""The dp mesh in the port against the JAX package's, on 1, 2 and 4 ranks.

The port's mesh is a ``torch.distributed`` DeviceMesh with one process
per device (``parallel/mesh.py``): here 1, 2 and 4 gloo processes on the
CPU (``tests/test_torch_spmd_worker.py``, one launch per world size for
every case of this file, each under a deadline that kills every rank on
a failure or a hang).  Against the JAX package's ``shard_map`` on the
8-device CPU mesh of ``tests/conftest.py``:

* ``sweep_stat_sums`` (generic engine, and ``engine='pallas'``: K1 span,
  its plain version on the CPU), ``sharded_multi_stats`` and
  ``sharded_simulate`` (the shards concatenated in mesh order) are equal
  integer for integer;
* ``sharded_physics_stat_sums`` equals JAX's exactly at ``sigma = 0,
  p1_init = 0`` (and under ``engine='fused'``, K3's plain version); with
  noise it equals the port's own single-process batches at the shard
  seeds ``derive_seed(seed, row)``, as do ``run_physics_sweep`` and
  ``run_multi_sweep`` with ``mesh=`` (batch ``i``, row ``r``:
  ``derive_seed(seed, i, r)``), spanned or not;
* ``sharded_demod`` over ``('dp', 'mp')`` meshes is within float32 rtol
  1e-5 (atol 1e-5 for entries near zero, of sums of 64 unit normals) of
  JAX's.
"""

import numpy as np
import pytest
import torch

import bench
from distributed_processor_tpu.models import (active_reset as j_reset,
                                              make_default_qchip as j_qchip,
                                              rb_ensemble as j_rb)
from distributed_processor_tpu.parallel import make_mesh as j_make_mesh
from distributed_processor_tpu.parallel import sweep as jsweep
from distributed_processor_tpu.pipeline import compile_to_machine as j_comp
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg
from distributed_processor_tpu.sim.physics import ReadoutPhysics as JPhysics

from distributed_processor_tpu_torch.decoder import stack_machine_programs
from distributed_processor_tpu_torch.parallel import (multi_batch_stats,
                                                      physics_batch_stats)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig as TCfg, simulate_multi_batch)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics as TPhysics, derive_seed, run_physics_batch)

from test_torch_interpreter import _to_port
from test_torch_spmd_worker import run_spmd

WORLDS = (1, 2, 4)
S = 32                      # shots: divisible by 8 (the JAX mesh) and 4
SEED = 11


@pytest.fixture(scope='module')
def setup():
    mp_j = bench.build_machine_program(2, 2)
    mp_t = _to_port(mp_j)
    kw = dict(max_steps=2 * mp_j.n_instr + 64,
              max_pulses=int(mp_j.max_pulses_per_core(1)) + 4, max_meas=2,
              max_resets=2)
    bits = np.random.default_rng(3).integers(
        0, 2, (S, mp_j.n_cores, 2)).astype(np.int32)
    qchip = j_qchip(2)
    ens_j = [j_comp(j_reset(['Q0', 'Q1']) + p, qchip, n_qubits=2)
             for p in j_rb(['Q0', 'Q1'], 1, 3, seed=5)]
    ens_t = [_to_port(m) for m in ens_j]
    mmp = stack_machine_programs(ens_t)
    mkw = dict(max_steps=2 * mmp.n_instr + 64, max_pulses=mmp.n_instr + 2,
               max_meas=2, max_resets=2)
    mbits = np.random.default_rng(4).integers(
        0, 2, (3, S, mmp.n_cores, 2)).astype(np.int32)
    adc = np.random.default_rng(5).standard_normal((S, 64)).astype(np.float32)
    wts = np.random.default_rng(6).standard_normal((64, 6)).astype(np.float32)
    return dict(mp_j=mp_j, mp_t=mp_t, kw=kw, bits=bits, ens_j=ens_j,
                ens_t=ens_t, mkw=mkw, mbits=mbits, adc=adc, wts=wts)


def _cases(s: dict, world: int) -> dict:
    """name -> case of the worker, for a world of ``world`` ranks."""
    dp = ('dp', world, 1)
    mp_t, kw = s['mp_t'], s['kw']
    quiet = TPhysics(sigma=0.0, p1_init=0.0)
    noisy = TPhysics(sigma=0.05, p1_init=0.3)
    call = lambda fn, args, mesh=dp, **k: ('call', dict(
        fn=fn, mesh=mesh, args=args, kwargs=k))
    cases = {
        'stat_sums': call('sweep_stat_sums', (mp_t, s['bits']),
                          cfg=TCfg(**kw)),
        'stat_sums_pallas': call('sweep_stat_sums', (mp_t, s['bits']),
                                 cfg=TCfg(engine='pallas', **kw)),
        'stats': call('sweep_stats', (mp_t, s['bits']), cfg=TCfg(**kw)),
        'simulate': call('sharded_simulate', (mp_t, s['bits']),
                         cfg=TCfg(**kw)),
        'multi': call('sharded_multi_stats', (s['ens_t'], s['mbits']),
                      **s['mkw']),
        'phys_quiet': call('sharded_physics_stat_sums',
                           (mp_t, quiet, SEED, S), cfg=TCfg(**kw)),
        'phys_fused': call('sharded_physics_stat_sums',
                           (mp_t, quiet, SEED, S),
                           cfg=TCfg(engine='fused', **kw)),
        'phys_noisy': call('sharded_physics_stat_sums',
                           (mp_t, noisy, SEED, S), cfg=TCfg(**kw)),
        'sweep': call('run_physics_sweep', (mp_t, noisy, 3 * S, S),
                      seed=SEED, cfg=TCfg(**kw)),
        'sweep_span': call('run_physics_sweep', (mp_t, noisy, 3 * S, S),
                           seed=SEED, cfg=TCfg(**kw), span=2),
        'multi_sweep': call('run_multi_sweep', (s['ens_t'], 2 * S, S),
                            seed=SEED, **s['mkw']),
        'demod': call('sharded_demod', (s['adc'], s['wts'])),
    }
    if world > 1:
        cases['demod_mp'] = call('sharded_demod', (s['adc'], s['wts']),
                                 mesh=('dp', world // 2, 2))
    return cases


@pytest.fixture(scope='module')
def runs(setup, tmp_path_factory):
    """world -> (case names, per-rank results)."""
    out = {}
    for world in WORLDS:
        cases = _cases(setup, world)
        res = run_spmd(list(cases.values()), world,
                       tmp_path_factory.mktemp(f'mesh{world}'))
        out[world] = {name: [r[i] for r in res]
                      for i, name in enumerate(cases)}
        out[world]['__info__'] = [r[-1] for r in res]
    return out


def _int_equal(got: dict, want: dict, what: str):
    assert set(got) >= set(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f'{what} {k}')


def _replicated(res: list, what: str) -> dict:
    """Reduced results are whole and identical on every rank."""
    for r in res[1:]:
        _int_equal(r, res[0], f'{what}: rank result differs')
    return res[0]


@pytest.fixture(scope='module')
def jax_refs(setup):
    mesh = j_make_mesh(n_dp=8)
    jkw = dict(cfg=JCfg(**setup['kw']))
    quiet = JPhysics(sigma=0.0, p1_init=0.0)
    return dict(
        stat_sums=jsweep.sweep_stat_sums(setup['mp_j'], setup['bits'], mesh,
                                         **jkw),
        stats=jsweep.sweep_stats(setup['mp_j'], setup['bits'], mesh, **jkw),
        simulate=jsweep.sharded_simulate(setup['mp_j'], setup['bits'], mesh,
                                         **jkw),
        multi=jsweep.sharded_multi_stats(setup['ens_j'], setup['mbits'],
                                         mesh, **setup['mkw']),
        phys_quiet=jsweep.sharded_physics_stat_sums(
            setup['mp_j'], quiet, SEED, S, mesh, **jkw),
        demod=jsweep.sharded_demod(setup['adc'], setup['wts'],
                                   j_make_mesh(n_dp=4, n_mp=2)))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', ['stat_sums', 'stat_sums_pallas'])
def test_sweep_stat_sums_match_jax(runs, jax_refs, world, case):
    got = _replicated(runs[world][case], case)
    _int_equal(got, {k: np.asarray(v)
                     for k, v in jax_refs['stat_sums'].items()}, case)


@pytest.mark.parametrize('world', WORLDS)
def test_sweep_stats_match_jax(runs, jax_refs, world):
    got = _replicated(runs[world]['stats'], 'stats')
    for k, v in jax_refs['stats'].items():
        # the same integer sums over the same count, rounded once
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize('world', WORLDS)
def test_sharded_simulate_matches_jax(runs, jax_refs, world):
    shards = runs[world]['simulate']
    want = jax_refs['simulate']
    assert set(shards[0]) == set(want)
    for k in want:
        got = np.concatenate([sh[k] for sh in shards], 0)
        np.testing.assert_array_equal(got, np.asarray(want[k]), err_msg=k)
        assert got.dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize('world', WORLDS)
def test_sharded_multi_stats_match_jax(runs, jax_refs, world):
    got = _replicated(runs[world]['multi'], 'multi')
    want = jax_refs['multi']
    np.testing.assert_array_equal(got['fault_shots'],
                                  np.asarray(want['fault_shots']))
    for k in ('mean_pulses', 'err_rate', 'mean_qclk'):
        # the same integer sums over the same shot count
        np.testing.assert_array_equal(np.asarray(got[k]) * S,
                                      np.asarray(want[k]) * S, err_msg=k)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', ['phys_quiet', 'phys_fused'])
def test_physics_stat_sums_sigma0_match_jax(runs, jax_refs, world, case):
    got = _replicated(runs[world][case], case)
    _int_equal(got, {k: np.asarray(v)
                     for k, v in jax_refs['phys_quiet'].items()}, case)


def _rows(setup, model, shots, seeds) -> dict:
    """The port's own single-process batches at ``seeds``, summed."""
    acc = None
    for seed in seeds:
        out = run_physics_batch(setup['mp_t'], model, seed, shots,
                                cfg=TCfg(**setup['kw']), device='cpu')
        st = {k: v.numpy() for k, v in physics_batch_stats(out).items()}
        acc = st if acc is None else {k: acc[k] + v for k, v in st.items()}
    return acc


@pytest.mark.parametrize('world', WORLDS)
def test_noisy_physics_stat_sums_match_own_seeds(setup, runs, world):
    got = _replicated(runs[world]['phys_noisy'], 'phys_noisy')
    want = _rows(setup, TPhysics(sigma=0.05, p1_init=0.3), S // world,
                 [derive_seed(SEED, r) for r in range(world)])
    _int_equal(got, want, 'noisy physics')


@pytest.mark.parametrize('world', WORLDS)
def test_physics_sweep_mesh_matches_own_seeds(setup, runs, world):
    """``run_physics_sweep(mesh=)``: batch ``i`` of dp row ``r`` runs at
    ``derive_seed(seed, i, r)``; spanned or not, every rank returns the
    sums of those batches."""
    want = _rows(setup, TPhysics(sigma=0.05, p1_init=0.3), S // world,
                 [derive_seed(SEED, i, r) for i in range(3)
                  for r in range(world)])
    for case in ('sweep', 'sweep_span'):
        for res in runs[world][case]:
            assert res['shots'] == 3 * S and res['incomplete_batches'] == 0
            np.testing.assert_array_equal(res['mean_pulses'] * 3 * S,
                                          want['pulse_sum'])
            np.testing.assert_array_equal(res['meas1_rate'] * 3 * S,
                                          want['meas1_sum'])
            assert res['clean_shots'] == want['clean_shots']
            assert res['err_shots'] == want['err_shots']
            assert res['survival00_rate'] == float(
                want['allzero_sum'] / want['clean_shots'])


@pytest.mark.parametrize('world', WORLDS)
def test_multi_sweep_mesh_matches_own_seeds(setup, runs, world):
    mmp = stack_machine_programs(setup['ens_t'])
    cfg = TCfg(**dict(setup['mkw'], record_pulses=False))
    acc = None
    for i in range(2):
        for r in range(world):
            gen = torch.Generator()
            gen.manual_seed(derive_seed(SEED, i, r) >> 1)
            bits = (torch.rand((3, S // world, mmp.n_cores, 2),
                               generator=gen) < 0.5).to(torch.int32)
            st = multi_batch_stats(simulate_multi_batch(
                mmp, bits, cfg=cfg, device='cpu'))
            acc = st if acc is None else {k: acc[k] + v
                                          for k, v in st.items()}
    for res in runs[world]['multi_sweep']:
        np.testing.assert_array_equal(res['err_shots'],
                                      acc['err_shots'].numpy())
        np.testing.assert_array_equal(res['mean_pulses'] * 2 * S,
                                      acc['pulse_sum'].numpy())
        np.testing.assert_array_equal(res['mean_qclk'] * 2 * S,
                                      acc['qclk_sum'].numpy())


@pytest.mark.parametrize('world,n_mp', [(1, 1), (2, 1), (4, 1), (2, 2),
                                        (4, 2)])
def test_sharded_demod_matches_jax(runs, jax_refs, world, n_mp):
    """The dp rows in mesh order equal JAX's global demod within float32
    rtol 1e-5; the ``'mp'`` partial products are summed on every rank of
    a row."""
    shards = runs[world]['demod_mp' if n_mp > 1 else 'demod']
    for row in range(world // n_mp):
        for j in range(1, n_mp):
            np.testing.assert_array_equal(shards[row * n_mp + j],
                                          shards[row * n_mp])
    got = np.concatenate(shards[::n_mp], 0)
    np.testing.assert_allclose(got, np.asarray(jax_refs['demod']),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('world', WORLDS)
def test_topology(runs, world):
    """initialize_multihost's topology on every rank: the JAX keys."""
    infos = runs[world]['__info__']
    assert [i['process_index'] for i in infos] == list(range(world))
    assert {i['process_count'] for i in infos} == {world}
    assert {i['global_devices'] for i in infos} == {world}


def test_mesh_constructors_validate():
    """The JAX package's validation messages, on a one-rank group: a
    mesh must cover the group's ranks exactly."""
    from distributed_processor_tpu_torch.parallel import (make_cores_mesh,
                                                          make_mesh,
                                                          shot_sharding)
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh(device='cpu')
    assert mesh.mesh_dim_names == ('dp', 'mp') and mesh.shape == (1, 1)
    assert make_mesh(device='cpu') is mesh          # one mesh per shape
    cmesh = make_cores_mesh(device='cpu')
    assert cmesh.mesh_dim_names == ('dp', 'cores')
    assert shot_sharding(mesh) == (Shard(0), Replicate())
    with pytest.raises(ValueError, match='needs 2 ranks'):
        make_mesh(n_dp=2, device='cpu')
    with pytest.raises(ValueError, match='positive cores axis'):
        make_cores_mesh(n_cores=0, device='cpu')
    with pytest.raises(ValueError, match=r'dp=0 x cores=2 needs 0 devices'):
        make_cores_mesh(n_cores=2, device='cpu')
    with pytest.raises(ValueError, match=r'dp=1 x cores=2 needs 2 devices'):
        make_cores_mesh(n_cores=2, n_dp=1, device='cpu')


def test_serving_devices():
    from distributed_processor_tpu_torch.parallel import serving_devices
    devs = [torch.device('cuda', i) for i in range(3)]
    assert serving_devices(devices=devs) == devs
    assert serving_devices(2, devices=devs) == devs[:2]
    for n in (0, 4):
        with pytest.raises(ValueError, match='serving devices'):
            serving_devices(n, devices=devs)
