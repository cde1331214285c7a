"""Multi-host execution in the port: two processes against one.

The port's counterpart of the JAX package's ``tests/test_multihost.py``:
two gloo processes (``tests/test_torch_spmd_worker.py``, under a deadline
that kills both on a failure or a hang) join through
``initialize_multihost``; each reduces its own shots over a
``host_local_mesh``, places its shard seeds on the global dp grid with
``dp_row_offset``, and sums across processes with ``cross_host_sum``
(the process group's key-value store, in rank order).  Both processes
get identical totals, equal to a single-process run of the same global
batch and to the global mesh's own all-reduce, and the injected-bits
statistics equal the JAX package's ``sweep_stats``.
"""

import numpy as np
import pytest
import torch

from distributed_processor_tpu.models import (active_reset as j_reset,
                                              make_default_qchip as j_qchip)
from distributed_processor_tpu.parallel import make_mesh as j_make_mesh
from distributed_processor_tpu.parallel import sweep_stats as j_sweep_stats
from distributed_processor_tpu.pipeline import compile_to_machine as j_comp
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg

from distributed_processor_tpu_torch.parallel import (
    cross_host_sum, dp_row_offset, global_shot_array, host_local_batch,
    host_local_mesh, initialize_multihost, make_global_mesh, make_mesh,
    sharded_physics_stat_sums, sweep_stat_sums)
from distributed_processor_tpu_torch.sim.interpreter import \
    InterpreterConfig as TCfg
from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics

from test_torch_interpreter import _to_port
from test_torch_spmd_worker import run_spmd


@pytest.fixture(scope='module')
def setup():
    mp_j = j_comp(j_reset(['Q0']), j_qchip(2), n_qubits=1)
    kw = dict(max_steps=mp_j.n_instr + 8, max_pulses=8, max_meas=2,
              max_resets=1)
    bits = np.random.default_rng(7).integers(
        0, 2, (16, mp_j.n_cores, 2)).astype(np.int32)
    phys_kw = dict(max_steps=mp_j.n_instr * 4 + 64, max_pulses=8, max_meas=2)
    return dict(mp_j=mp_j, mp_t=_to_port(mp_j), kw=kw, bits=bits,
                model=ReadoutPhysics(sigma=0.01, p1_init=1.0), seed=3,
                phys_kw=phys_kw)


@pytest.fixture(scope='module')
def two(setup, tmp_path_factory):
    case = ('multihost_stats', dict(
        mp=setup['mp_t'], cfg=TCfg(**setup['kw']), bits=setup['bits'],
        model=setup['model'], seed=setup['seed'],
        phys_kw=setup['phys_kw']))
    res = run_spmd([case], 2, tmp_path_factory.mktemp('multihost'))
    return [r[0] for r in res], [r[1] for r in res]


def test_topology(two):
    outs, infos = two
    for rank, info in enumerate(infos):
        assert info == {'process_index': rank, 'process_count': 2,
                        'local_devices': 1, 'global_devices': 2}
    assert [o['local_shots'] for o in outs] == [8, 8]
    assert [o['offset'] for o in outs] == [0, 8]
    assert [o['row'] for o in outs] == [0, 1]


def _same(a: dict, b: dict, what: str):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f'{what} {k}')


def test_cross_host_sums_identical_and_equal_global_mesh(two):
    """Both processes fold identical totals, equal to what the global
    mesh's own all-reduce gives on the same rows and seeds."""
    outs, _ = two
    for key in ('inj', 'phys', 'g_inj', 'g_phys'):
        _same(outs[0][key], outs[1][key], key)
    _same(outs[0]['inj'], outs[0]['g_inj'], 'injected: store vs all-reduce')
    _same(outs[0]['phys'], outs[0]['g_phys'], 'physics: store vs all-reduce')


def test_equal_single_process_run(setup, two):
    """One process running both dp rows of the same global batch — its
    own one-rank mesh, each row at its global offset — gets the sums the
    two processes reduced; the injected-bits statistics equal the JAX
    package's on its 8-device mesh."""
    outs, _ = two
    mesh = make_mesh(device='cpu')
    inj = sweep_stat_sums(setup['mp_t'], setup['bits'], mesh,
                          cfg=TCfg(**setup['kw']), device='cpu')
    _same(outs[0]['inj'], {k: v.numpy() for k, v in inj.items()},
          'injected vs single process')
    phys = None
    for row in range(2):
        part = sharded_physics_stat_sums(
            setup['mp_t'], setup['model'], setup['seed'], 8, mesh,
            dp_offset=row, device='cpu', **setup['phys_kw'])
        phys = part if phys is None else {k: phys[k] + v
                                          for k, v in part.items()}
    _same(outs[0]['phys'], {k: v.numpy() for k, v in phys.items()},
          'physics vs single process')
    # p1_init = 1, sigma = 0.01: every shot measured 1 and took the reset
    # branch (4 pulses) — the physics loop really closed in both processes
    assert int(outs[0]['phys']['meas1_sum'][0]) == 16
    assert int(outs[0]['phys']['pulse_sum'][0]) == 4 * 16
    want = j_sweep_stats(setup['mp_j'], setup['bits'], j_make_mesh(n_dp=8),
                         cfg=JCfg(**setup['kw']))
    np.testing.assert_array_equal(outs[0]['inj']['pulse_sum'] / 16,
                                  np.asarray(want['mean_pulses']))
    np.testing.assert_array_equal(outs[0]['inj']['qclk_sum'] / 16,
                                  np.asarray(want['mean_qclk']))
    assert float(want['err_rate']) == 0.0 == outs[0]['inj']['err_shots']


def test_single_process_fallbacks():
    """Without a multi-rank group everything runs on one rank: the
    topology of one process, meshes of one rank, the sum unchanged."""
    info = initialize_multihost()
    assert info['process_count'] == 1 and info['global_devices'] == 1
    gmesh = make_global_mesh(device='cpu')
    assert dp_row_offset(gmesh) == 0
    assert host_local_batch(gmesh, 16) == (16, 0)
    assert host_local_mesh(device='cpu').mesh_dim_names == ('dp', 'mp')
    tree = {'a': np.arange(3), 'b': [np.int64(2), (np.ones(2),)]}
    got = cross_host_sum('solo', tree)
    np.testing.assert_array_equal(got['a'], tree['a'])
    assert int(got['b'][0]) == 2 and isinstance(got['b'][1], tuple)
    arr = global_shot_array(gmesh, np.zeros((4, 2), np.int32), (4, 2))
    assert isinstance(arr, torch.Tensor) and tuple(arr.shape) == (4, 2)
    with pytest.raises(ValueError, match='not divisible'):
        make_global_mesh(n_mp=2, device='cpu')
    with pytest.raises(ValueError, match='not divisible'):
        host_local_mesh(n_mp=2, device='cpu')
