"""The port's physics-closed epoch loop against the JAX package's.

``run_physics_batch(device='cpu')`` of the port against JAX
``run_physics_batch`` on the headline program cut to 2 qubits and depth 2
(active reset + RB), at sigma = 0 with explicit initial states: bits,
valid flags, pulse counts, ``err``, ``fault``, the parity co-state,
``epochs`` and the per-batch statistics are identical, in both resolve
modes, with the bench's config (the straight-line engine in both
packages) and with the generic engine: every output key.  At sigma > 0
the two draw different noise streams, so the assignment-error rate is
held statistically
(within 5 binomial sigma + 0.01, as tests/test_tpu_kernels.py holds the
JAX kernel's two generators).  A 1M-shot-shaped sweep runs at a small
size through ``run_physics_sweep``.
"""

import numpy as np
import pytest
import torch

import bench
import distributed_processor_tpu.pipeline as jpipe
import distributed_processor_tpu.models as jmodels
from distributed_processor_tpu.sim.interpreter import InterpreterConfig as JCfg
from distributed_processor_tpu.sim.physics import (
    ReadoutPhysics as JPhysics, run_physics_batch as jax_run,
    prepare_physics_tables as jax_prepare,
    validate_physics_tables as jax_validate)
from distributed_processor_tpu.parallel.sweep import \
    physics_batch_stats as jax_stats

from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.sim.interpreter import \
    InterpreterConfig as TCfg
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics as TPhysics, physics_from_dict, prepare_physics_tables,
    run_physics_batch, validate_physics_tables)
from distributed_processor_tpu_torch.parallel import (
    physics_batch_stats, run_physics_sweep)

B = 32


@pytest.fixture(scope='module')
def headline():
    mp_j = bench.build_machine_program(2, 2)
    mp_t = machine_program_from_arrays(machine_program_to_arrays(mp_j))
    cfg = dict(max_steps=2 * mp_j.n_instr + 64,
               max_pulses=int(mp_j.max_pulses_per_core(1)) + 4,
               max_meas=2, max_resets=2, record_pulses=False)
    init = np.random.default_rng(3).integers(0, 2, (B, 2)).astype(np.int32)
    return mp_j, mp_t, cfg, init


def _model_pair(**kw):
    jm = JPhysics(**kw)
    import dataclasses
    return jm, physics_from_dict(dataclasses.asdict(jm))


@pytest.mark.parametrize('straightline', [None, False],
                         ids=['bench_config', 'generic'])
@pytest.mark.parametrize('mode', ['fused', 'persample'])
def test_sigma0_matches_jax(headline, mode, straightline):
    mp_j, mp_t, cfg, init = headline
    jm, tm = _model_pair(sigma=0.0, p1_init=0.15, resolve_chunk=256,
                         resolve_mode=mode)
    out_j = jax_run(mp_j, jm, 0, B, init_states=init,
                    cfg=JCfg(**cfg, straightline=straightline))
    out_t = run_physics_batch(mp_t, tm, 0, B, init_states=init,
                              cfg=TCfg(**cfg, straightline=straightline),
                              device='cpu')
    # both configs pick the same engine in both packages (straight-line
    # for the bench's, generic otherwise): every key matches
    assert set(out_t) == set(out_j)
    for key in sorted(out_j):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    st_t, st_j = physics_batch_stats(out_t), jax_stats(out_j)
    assert set(st_t) == set(st_j)
    for key in st_j:
        np.testing.assert_array_equal(st_t[key].numpy(),
                                      np.asarray(st_j[key]), err_msg=key)
    # the program measured every qubit twice and resolved every window
    assert bool(out_t['meas_bits_valid'].all())
    assert int(out_t['epochs']) == 2


def test_sigma0_init_bits_read_back(headline):
    """Active reset reads the initial state: with sigma = 0 the first
    slot's bit is the initial qubit state exactly."""
    _mp_j, mp_t, cfg, init = headline
    out = run_physics_batch(mp_t, TPhysics(sigma=0.0, resolve_chunk=256,
                                           resolve_mode='fused'),
                            1, B, init_states=init, cfg=TCfg(**cfg),
                            device='cpu')
    np.testing.assert_array_equal(out['meas_bits'][:, :, 0].numpy(), init)


def _read_program(pipe, models):
    return pipe.compile_to_machine([{'name': 'read', 'qubit': ['Q0']}],
                                   models.make_default_qchip(1),
                                   n_qubits=1)


def test_assignment_error_rate_matches_jax():
    """At sigma = 12 (about 10 % assignment error) the port's error rate
    agrees with the JAX package's within 5 binomial sigma + 0.01."""
    n = 4096
    init = (np.arange(n) % 2).astype(np.int32).reshape(n, 1)
    kw = dict(max_steps=200, max_pulses=16, max_meas=4)
    jm, tm = _model_pair(sigma=12.0, resolve_chunk=256, window_samples=256,
                         resolve_mode='persample')
    mp_j = _read_program(jpipe, jmodels)
    mp_t = machine_program_from_arrays(machine_program_to_arrays(mp_j))
    bits_j = np.asarray(jax_run(mp_j, jm, 7, n, init_states=init,
                                **kw)['meas_bits'])[:, 0, 0]
    bits_t = run_physics_batch(mp_t, tm, 7, n, init_states=init,
                               device='cpu', **kw)['meas_bits'][:, 0, 0]
    err_j = float(np.mean(bits_j != init[:, 0]))
    err_t = float(np.mean(bits_t.numpy() != init[:, 0]))
    assert 0.05 < err_j < 0.2, err_j
    spread = 5 * np.sqrt(err_j * (1 - err_j) / n)
    assert abs(err_t - err_j) < spread + 0.01, (err_t, err_j)


def test_seeded_runs_repeat(headline):
    _mp_j, mp_t, cfg, _init = headline
    model = TPhysics(sigma=0.05, p1_init=0.15, resolve_chunk=256,
                     resolve_mode='fused')
    a = run_physics_batch(mp_t, model, 5, B, cfg=TCfg(**cfg), device='cpu')
    b = run_physics_batch(mp_t, model, 5, B, cfg=TCfg(**cfg), device='cpu')
    c = run_physics_batch(mp_t, model, 6, B, cfg=TCfg(**cfg), device='cpu')
    assert torch.equal(a['meas_bits'], b['meas_bits'])
    assert torch.equal(a['qturns'], b['qturns'])
    assert not torch.equal(a['qturns'], c['qturns'])


def test_sweep_sums_its_batches(headline):
    _mp_j, mp_t, cfg, _init = headline
    model = TPhysics(sigma=0.05, p1_init=0.15, resolve_chunk=256,
                     resolve_mode='fused')
    res = run_physics_sweep(mp_t, model, 4 * B, B, seed=9,
                            cfg=TCfg(**cfg), device='cpu')
    assert res['shots'] == 4 * B and res['engine'] == 'generic'
    assert res['incomplete_batches'] == 0 and res['err_shots'] == 0
    assert not any(res['fault_shots'].values())
    assert res['mean_pulses'].shape == (2,)
    assert 0.0 < float(res['meas1_rate'][0]) < 0.5
    assert 0.0 <= res['survival00_rate'] <= 1.0


def test_unported_models_raise(headline, tmp_path):
    """The readout models and devices of queue 1 items 3 and 4 run now
    (tests/test_torch_readout_models.py, test_torch_bloch.py and
    test_torch_statevec.py hold them against the JAX package); a |2>
    response without a leakage channel raises the JAX package's error.
    The sweep's checkpoint, span and mesh options run as the JAX
    package's: a resumed and a spanned sweep equal the per-batch sweep,
    and a one-rank dp mesh runs batch ``i`` at ``derive_seed(seed, i,
    0)``."""
    _mp_j, mp_t, cfg, _init = headline
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    for kw in ({'resolve_mode': 'analytic'}, {'noise_ar1': 0.5},
               {'cw_horizon': 16}, {'device': DeviceModel('bloch')}):
        out = run_physics_batch(mp_t, TPhysics(**kw), 0, 4, cfg=TCfg(**cfg),
                                device='cpu')
        assert bool(out['meas_bits_valid'].all()), kw
    with pytest.raises(ValueError, match='g2'):
        run_physics_batch(mp_t, TPhysics(g2=0.5 + 0.5j), 0, 4,
                          cfg=TCfg(**cfg), device='cpu')
    from distributed_processor_tpu_torch.parallel import make_mesh
    from distributed_processor_tpu_torch.sim.physics import derive_seed
    model = TPhysics(sigma=0.05, p1_init=0.3)
    run = lambda **kw: run_physics_sweep(mp_t, model, 12, 4, seed=4,
                                         cfg=TCfg(**cfg), device='cpu', **kw)
    base = run()
    ck = str(tmp_path / 'x.npz')
    run_physics_sweep(mp_t, model, 4, 4, seed=4, cfg=TCfg(**cfg),
                      device='cpu', checkpoint=ck)
    meshed = run(mesh=make_mesh(device='cpu'))
    acc = None
    for i in range(3):
        out = run_physics_batch(mp_t, model, derive_seed(4, i, 0), 4,
                                cfg=TCfg(**cfg), device='cpu')
        st = physics_batch_stats(out)
        acc = st if acc is None else {k: acc[k] + v for k, v in st.items()}
    for res in (run(checkpoint=ck), run(span=2), meshed):
        for k in ('mean_pulses', 'meas1_rate', 'survival00_rate',
                  'clean_shots', 'err_shots', 'fault_shots'):
            want = base[k] if res is not meshed else {
                'mean_pulses': acc['pulse_sum'].numpy() / 12,
                'meas1_rate': acc['meas1_sum'].numpy() / 12,
                'survival00_rate': float(acc['allzero_sum']
                                         / acc['clean_shots']),
                'clean_shots': int(acc['clean_shots']),
                'err_shots': int(acc['err_shots']),
                'fault_shots': dict(zip(res['fault_shots'],
                                        acc['fault_shots'].tolist()))}[k]
            np.testing.assert_array_equal(np.asarray(res[k]),
                                          np.asarray(want), err_msg=k)


@pytest.fixture(scope='module')
def stale_rows_pair():
    """Program A reads Q0 and Q1 (envelope rows ``(0,)``); program B is
    X90 on Q0 and Q1, CNOT(Q0, Q1), then the two reads (rows ``(0,
    192)``), on the two-qubit default qchip."""
    qchip = jmodels.make_default_qchip(2)
    reads = [{'name': 'read', 'qubit': ['Q0']},
             {'name': 'read', 'qubit': ['Q1']}]
    gates = [{'name': 'X90', 'qubit': ['Q0']}, {'name': 'X90', 'qubit': ['Q1']},
             {'name': 'CNOT', 'qubit': ['Q0', 'Q1']}]
    a_j = jpipe.compile_to_machine(reads, qchip, n_qubits=2)
    b_j = jpipe.compile_to_machine(gates + reads, qchip, n_qubits=2)
    port = lambda mp: machine_program_from_arrays(
        machine_program_to_arrays(mp))
    return a_j, b_j, port(a_j), port(b_j)


@pytest.mark.parametrize('mode', ['fused', 'persample'])
def test_stale_rows_tables_raise(stale_rows_pair, mode):
    """Tables built for program A and handed to program B: the envelope
    rows differ, so the run and ``validate_physics_tables`` raise the JAX
    package's ``ValueError`` (the port's ``'persample'`` reads the rows
    too, so it checks them where the JAX package's reads the full table
    and runs); tables built for B itself pass."""
    a_j, b_j, a_t, b_t = stale_rows_pair
    kw = dict(sigma=0, resolve_chunk=256, resolve_mode=mode)
    jm, tm = JPhysics(**kw), TPhysics(**kw)
    msg = r'built for envelope addresses \[0\], but this program/model ' \
        r'needs \[0, 192\]'
    tables_j = jax_prepare(a_j, jm)
    if mode == 'fused':
        with pytest.raises(ValueError, match=msg):
            jax_run(b_j, jm, 0, 4, tables=tables_j)
        with pytest.raises(ValueError, match=msg):
            jax_validate(b_j, jm, tables_j)
    tables_t = prepare_physics_tables(a_t, tm, device='cpu')
    with pytest.raises(ValueError, match=msg):
        run_physics_batch(b_t, tm, 0, 4, tables=tables_t, device='cpu')
    with pytest.raises(ValueError, match=msg):
        validate_physics_tables(b_t, tm, tables_t)
    validate_physics_tables(a_t, tm, tables_t)
    own = prepare_physics_tables(b_t, tm, device='cpu')
    validate_physics_tables(b_t, tm, own)
    out = run_physics_batch(b_t, tm, 0, 4, tables=own, device='cpu')
    assert bool(out['meas_bits_valid'][:, :, 0].all())     # one read a core
