"""Sweep checkpoints in the port against the JAX package's.

``utils/results.py`` is a copy of the JAX package's numpy module: its
files load in both packages, the accumulator's ``add_span`` writes when
the batch count crosses a ``checkpoint_every`` multiple (the JAX pin of
``tests/test_sweep_span.py``), an unreadable file is quarantined (or
refused under ``strict``), and an unfingerprinted one is accepted with a
warning (or refused under ``strict``).  The drivers' fingerprints reject
a resume with any other sweep identity field by field — the program,
model, config, registers, batch, seed or dp extent — and a JAX
checkpoint and a port checkpoint reject each other: the port's random
stream (Philox through ``derive_seed``) is not the JAX package's
threefry ``key``, so mixing them would mix two sweeps.  A resumed sweep
equals the uninterrupted one bit for bit.
"""

import os

import numpy as np
import pytest

from distributed_processor_tpu.models import active_reset as j_active_reset
from distributed_processor_tpu.models import \
    make_default_qchip as j_make_qchip
from distributed_processor_tpu.parallel import \
    run_physics_sweep as jax_run_physics_sweep
from distributed_processor_tpu.pipeline import \
    compile_to_machine as j_compile
from distributed_processor_tpu.sim.physics import ReadoutPhysics as JPhysics
from distributed_processor_tpu.utils import results as jres

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_ensemble)
from distributed_processor_tpu_torch.parallel import (make_mesh,
                                                      run_multi_sweep,
                                                      run_physics_sweep)
from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
from distributed_processor_tpu_torch.utils import results as tres

KW = dict(max_pulses=8, max_meas=2)


@pytest.fixture(scope='module')
def physics():
    mp = compile_to_machine(active_reset(['Q0', 'Q1']),
                            make_default_qchip(2), n_qubits=2)
    return mp, ReadoutPhysics(sigma=0.01, p1_init=0.5), \
        dict(KW, max_steps=mp.n_instr * 4 + 64)


def _sweep(physics, total=112, batch=16, **kw):
    mp, model, cfg = physics
    return run_physics_sweep(mp, model, total, batch, device='cpu',
                             **dict(dict(seed=7, **cfg), **kw))


def _assert_same(a: dict, b: dict, ctx=''):
    assert set(a) == set(b), ctx
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k], f'{ctx}{k}.')
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f'{ctx}{k}')


@pytest.mark.parametrize('writer,reader', [(tres, jres), (jres, tres)],
                         ids=['port_writes', 'jax_writes'])
def test_results_files_load_in_both_packages(tmp_path, writer, reader):
    path = str(tmp_path / 'r.npz')
    arrays = {'pulse_sum': np.arange(4, dtype=np.int64),
              'err': np.int32(3), '_private': np.ones(2)}
    writer.save_results(path, arrays, meta={'n_batches': 5, 'seed': 1})
    assert not os.path.exists(path + '.tmp')           # written atomically
    got, meta = reader.load_results(path)
    assert set(got) == {'pulse_sum', 'err'} and meta == {'n_batches': 5,
                                                         'seed': 1}
    np.testing.assert_array_equal(got['pulse_sum'], arrays['pulse_sum'])
    assert int(got['err']) == 3


@pytest.mark.parametrize('pkg', [tres, jres], ids=['port', 'jax'])
def test_add_span_checkpoint_crossing(tmp_path, pkg):
    """add_span writes when the batch count CROSSES a checkpoint_every
    multiple (snap to span edges), and equals add for n=1 — the JAX pin,
    on both packages' accumulators."""
    path = str(tmp_path / 'acc.npz')
    acc = pkg.SweepAccumulator(path, checkpoint_every=4)
    acc.add_span({'x': np.int32(1)}, 3)
    assert not (tmp_path / 'acc.npz').exists()    # 3 < 4: no write yet
    acc.add_span({'x': np.int32(1)}, 3)           # 6 crosses 4
    assert int(tres.load_results(path)[1]['n_batches']) == 6
    acc.add_span({'x': np.int32(1)}, 3)           # 9 crosses 8
    arrays, meta = jres.load_results(path)
    assert int(meta['n_batches']) == 9 and int(arrays['x']) == 3
    acc.add({'x': np.int32(1)})                   # 10: no crossing
    assert int(tres.load_results(path)[1]['n_batches']) == 9
    with pytest.raises(ValueError, match='span'):
        acc.add_span({'x': np.int32(1)}, 0)


def test_quarantine_and_strict(tmp_path):
    """An unreadable checkpoint is moved aside as ``.corrupt-<n>`` and
    the sweep restarts; ``strict`` refuses it and renames nothing; an
    unfingerprinted one is accepted with a warning, refused under
    ``strict`` — as in the JAX package."""
    path = str(tmp_path / 'c.npz')
    for n in range(2):
        with open(path, 'wb') as f:
            f.write(b'not a zip file')
        with pytest.raises(ValueError, match='unreadable'):
            tres.SweepAccumulator.resume(path, meta={'a': 1}, strict=True)
        assert os.path.exists(path)
        with pytest.warns(UserWarning, match='quarantined'):
            acc = tres.SweepAccumulator.resume(path, meta={'a': 1})
        assert acc.n_batches == 0 and not os.path.exists(path)
        assert os.path.exists(f'{path}.corrupt-{n}')
    tres.save_results(path, {'x': np.int64(2)}, meta={'n_batches': 3})
    with pytest.raises(ValueError, match='strict'):
        tres.SweepAccumulator.resume(path, meta={'fingerprint_version': 5},
                                     strict=True)
    with pytest.raises(ValueError, match='requires meta'):
        tres.SweepAccumulator.resume(path, strict=True)


def test_resume_equals_uninterrupted(physics, tmp_path):
    """7 batches: stopped after 3 and resumed, written every batch or
    every 2, the sums equal the uninterrupted sweep's exactly; a
    checkpoint holding more batches than asked for raises."""
    full = _sweep(physics)
    for every in (1, 2):
        ck = str(tmp_path / f'p{every}.npz')
        _sweep(physics, total=48, checkpoint=ck, checkpoint_every=every)
        assert int(tres.load_results(ck)[1]['n_batches']) == 3
        _assert_same(full, _sweep(physics, checkpoint=ck,
                                  checkpoint_every=every), f'every={every}: ')
        assert int(tres.load_results(ck)[1]['n_batches']) == 7
    with pytest.raises(ValueError, match='already holds'):
        _sweep(physics, total=32, checkpoint=ck)


def test_multi_resume_equals_uninterrupted(tmp_path):
    qchip = make_default_qchip(2)
    mps = [compile_to_machine(active_reset(['Q0', 'Q1']) + p, qchip,
                              n_qubits=2)
           for p in rb_ensemble(['Q0', 'Q1'], 1, 2, seed=41)]
    kw = dict(p1=0.5, seed=3, max_meas=2, max_resets=2, device='cpu')
    full = run_multi_sweep(mps, 28, 4, **kw)
    ck = str(tmp_path / 'm.npz')
    run_multi_sweep(mps, 12, 4, checkpoint=ck, **kw)
    _assert_same(full, run_multi_sweep(mps, 28, 4, checkpoint=ck, **kw))
    # the whole ensemble is the identity: a reordered one is refused
    with pytest.raises(ValueError, match='program_crc'):
        run_multi_sweep(mps[::-1], 28, 4, checkpoint=ck, **kw)


def _other_program():
    return compile_to_machine(active_reset(['Q0']), make_default_qchip(2),
                              n_qubits=2)


@pytest.mark.parametrize('field', ['batch', 'seed', 'model', 'cfg',
                                   'init_regs_crc', 'program_crc', 'n_dp'])
def test_fingerprint_rejects_field_by_field(physics, tmp_path, field):
    """A resume by a sweep that differs in one identity field raises,
    naming that field (and only it)."""
    mp, model, cfg = physics
    ck = str(tmp_path / 'f.npz')
    _sweep(physics, total=32, checkpoint=ck)
    other = {
        'batch': dict(batch=8),
        'seed': dict(seed=8),
        'model': dict(mp=mp, model=ReadoutPhysics(sigma=0.02, p1_init=0.5)),
        'cfg': dict(max_steps=cfg['max_steps'] + 1),
        'init_regs_crc': dict(init_regs=np.ones((2, 16), np.int32)),
        'program_crc': dict(mp=_other_program()),
        'n_dp': dict(mesh=make_mesh(device='cpu')),
    }[field]
    mp2, model2 = other.pop('mp', mp), other.pop('model', model)
    kw = dict(dict(seed=7, **cfg), **other)
    batch = kw.pop('batch', 16)
    with pytest.raises(ValueError, match='different sweep') as e:
        run_physics_sweep(mp2, model2, 64, batch, checkpoint=ck,
                          device='cpu', **kw)
    detail = str(e.value).split('(stored, requested): ')[1]
    assert detail.startswith(f"{{'{field}'") and detail.count("': (") == 1


def test_span_not_in_identity(physics, tmp_path):
    """A checkpoint written with one span resumes under another."""
    full = _sweep(physics)
    ck = str(tmp_path / 's.npz')
    _sweep(physics, total=80, span=4, checkpoint=ck)
    _assert_same(full, _sweep(physics, span=3, checkpoint=ck))


@pytest.fixture(scope='module')
def jax_physics():
    mp = j_compile(j_active_reset(['Q0', 'Q1']), j_make_qchip(2), n_qubits=2)
    return mp, JPhysics(sigma=0.01, p1_init=0.5), \
        dict(KW, max_steps=mp.n_instr * 4 + 64)


def test_jax_checkpoint_rejected_by_port(physics, jax_physics, tmp_path):
    mp_j, model_j, cfg = jax_physics
    ck = str(tmp_path / 'j.npz')
    jax_run_physics_sweep(mp_j, model_j, 16, 16, key=7, checkpoint=ck, **cfg)
    with pytest.raises(ValueError, match='different sweep') as e:
        _sweep(physics, checkpoint=ck)
    for name in ('key', 'seed', 'stream'):
        assert f"'{name}'" in str(e.value)


def test_port_checkpoint_rejected_by_jax(physics, jax_physics, tmp_path):
    mp_j, model_j, cfg = jax_physics
    ck = str(tmp_path / 't.npz')
    _sweep(physics, total=16, checkpoint=ck)
    with pytest.raises(ValueError, match='different sweep') as e:
        jax_run_physics_sweep(mp_j, model_j, 112, 16, key=7, checkpoint=ck,
                              **cfg)
    for name in ('key', 'seed', 'stream'):
        assert f"'{name}'" in str(e.value)
