"""Program ensembles in the port against the JAX package's.

``simulate_multi_batch`` stacks P compiled programs into one ``[P, C, N]``
table (DONE-padded into a shape bucket) and runs them as one generic-
engine pass over ``P x B`` lanes, each lane fetching from its own
program's rows; the JAX package vmaps its generic engine over the
program axis.  On the same seeded bits every output key is identical,
value and dtype: pulse records, registers, clocks, ``err``, ``fault``,
and the per-program ``steps``, ``incomplete`` and ``op_hist`` (each
program's own count, as under ``jax.vmap`` of the while loop — a ragged
ensemble pins it).  Also: the shape bucket and stack validation, every
``meas_bits`` and ``init_regs`` form, the engine refusals with the JAX
package's message, ``demux_multi_batch``, and ``run_multi_sweep`` (its
per-program reduction exact on the same bits as the JAX package's
``local_stats``; its statistics within CLT bounds of the JAX sweep's,
whose threefry bits differ from the port's generator).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_processor_tpu import isa as jisa
from distributed_processor_tpu.decoder import \
    stack_machine_programs as jax_stack
from distributed_processor_tpu.models import (active_reset,
                                              make_default_qchip,
                                              rb_ensemble)
from distributed_processor_tpu.parallel import \
    run_multi_sweep as jax_run_multi_sweep
from distributed_processor_tpu.pipeline import compile_to_machine
from distributed_processor_tpu.sim.interpreter import (
    FaultError as JFaultError, InterpreterConfig as JCfg,
    demux_multi_batch as jax_demux, fault_shot_counts as jax_fault_counts,
    simulate_multi_batch as jax_multi)

from distributed_processor_tpu_torch import isa as tisa
from distributed_processor_tpu_torch.decoder import (
    MultiMachineProgram, stack_machine_programs)
from distributed_processor_tpu_torch.parallel import (multi_batch_stats,
                                                      run_multi_sweep)
from distributed_processor_tpu_torch.sim.interpreter import (
    FaultError, InterpreterConfig as TCfg, demux_multi_batch,
    simulate_batch, simulate_multi_batch)

from test_torch_interpreter import _to_port


def _ensemble(n_qubits, depth, n_seqs, seed):
    """Active reset + random RB sequences, compiled by the JAX package:
    ``(jax programs, port programs)``."""
    qubits = [f'Q{i}' for i in range(n_qubits)]
    qchip = make_default_qchip(n_qubits)
    mps = [compile_to_machine(active_reset(qubits) + prog, qchip,
                              n_qubits=n_qubits)
           for prog in rb_ensemble(qubits, depth, n_seqs, seed=seed)]
    return mps, [_to_port(mp) for mp in mps]


def _bucket_kw(mmp, **kw):
    return dict(max_steps=2 * mmp.n_instr + 64, max_pulses=mmp.n_instr + 2,
                max_meas=2, max_resets=2, **kw)


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.int32)


def assert_same(out_t: dict, out_j: dict, label: str = ''):
    """Every key equal in value and dtype."""
    assert set(out_t) == set(out_j), (label, set(out_t) ^ set(out_j))
    for key in sorted(out_j):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (label, key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f'{label}: {key}')


@pytest.fixture(scope='module')
def mixed():
    """Three programs of two depths: the shorter one is DONE-padded."""
    mj_a, mt_a = _ensemble(2, 2, 2, seed=5)
    mj_b, mt_b = _ensemble(2, 1, 1, seed=6)
    return mj_a + mj_b, mt_a + mt_b


@pytest.mark.parametrize('n', [1, 8, 9, 64, 65, 300])
def test_shape_bucket_matches_jax(n):
    assert tisa.shape_bucket(n) == jisa.shape_bucket(n)


def test_shape_bucket_rejects_zero():
    with pytest.raises(ValueError):
        tisa.shape_bucket(0)


def test_stack_validates_core_count():
    _, mt2 = _ensemble(2, 1, 1, seed=0)
    _, mt3 = _ensemble(3, 1, 1, seed=0)
    with pytest.raises(ValueError, match='core-count'):
        stack_machine_programs(mt2 + mt3)


def test_stacked_ensemble_matches_jax(mixed):
    """The port's stack equals the JAX package's, field for field."""
    mps_j, mps_t = mixed
    mmp_j, mmp_t = jax_stack(mps_j), stack_machine_programs(mps_t)
    assert isinstance(mmp_t, MultiMachineProgram)
    assert (mmp_t.n_progs, mmp_t.n_cores, mmp_t.n_instr) == \
        (mmp_j.n_progs, mmp_j.n_cores, mmp_j.n_instr) == \
        (3, mps_j[0].n_cores, jisa.shape_bucket(max(m.n_instr
                                                    for m in mps_j)))
    for f in (f.name for f in dataclasses.fields(mmp_j.soa)):
        np.testing.assert_array_equal(np.asarray(getattr(mmp_t.soa, f)),
                                      np.asarray(getattr(mmp_j.soa, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(mmp_t.sync_participants,
                                  np.asarray(mmp_j.sync_participants))


@pytest.mark.parametrize('extra', [{}, dict(opcode_histogram=True),
                                   dict(record_pulses=False)],
                         ids=['records', 'op_hist', 'no_records'])
def test_multi_matches_jax(mixed, extra):
    """Every key of the ensemble run equal to JAX's, ``steps``,
    ``incomplete`` and ``op_hist`` per program included."""
    mps_j, mps_t = mixed
    mmp_j = jax_stack(mps_j)
    kw = _bucket_kw(mmp_j, **extra)
    bits = _bits(np.random.default_rng(7), (3, 16, mmp_j.n_cores, 2))
    out_j = jax_multi(mmp_j, bits, cfg=JCfg(**kw))
    out_t = simulate_multi_batch(mps_t, bits, cfg=TCfg(**kw), device='cpu')
    assert_same(out_t, out_j, f'multi {extra}')
    assert out_t['steps'].shape == (3,)


def test_multi_equals_per_program(mixed):
    """Each program's view equals the program alone on the generic engine
    (every key, ``steps`` included; the padding is invisible) and on the
    straight-line engine (every key but ``steps``, its pass length)."""
    _, mps_t = mixed
    mmp = stack_machine_programs(mps_t)
    cfg = TCfg(**_bucket_kw(mmp, opcode_histogram=True))
    bits = _bits(np.random.default_rng(8), (3, 16, mmp.n_cores, 2))
    multi = simulate_multi_batch(mmp, bits, cfg=cfg, device='cpu')
    for i, mp in enumerate(mps_t):
        view = demux_multi_batch(multi, i)
        gen = simulate_batch(mp, bits[i], cfg=dataclasses.replace(
            cfg, engine='generic'), device='cpu')
        sl = simulate_batch(mp, bits[i], cfg=dataclasses.replace(
            cfg, engine='straightline'), device='cpu')
        assert set(view) == set(gen) == set(sl)
        for k in gen:
            assert torch.equal(view[k], gen[k]), (i, k)
            if k != 'steps':
                assert torch.equal(view[k], sl[k]), (i, k)
        assert not bool(view['incomplete'])


def test_ragged_ensemble_per_program_steps_and_incomplete():
    """Programs of different depths settle at different steps; a budget
    between them leaves the deeper ones incomplete.  ``steps`` and
    ``incomplete`` are each program's own, equal to JAX's, and the faults
    of the cut lanes (budget exhausted) equal too."""
    mj_s, mt_s = _ensemble(2, 1, 1, seed=11)
    mj_d, mt_d = _ensemble(2, 6, 2, seed=12)
    mps_j, mps_t = mj_d[:1] + mj_s + mj_d[1:], mt_d[:1] + mt_s + mt_d[1:]
    mmp_j = jax_stack(mps_j)
    bits = _bits(np.random.default_rng(13), (3, 12, mmp_j.n_cores, 2))
    full = simulate_multi_batch(mps_t, bits, device='cpu',
                                **_bucket_kw(mmp_j))
    own = full['steps'].tolist()
    assert own[1] < min(own[0], own[2]), own
    budget = own[1] + 3
    kw = dict(_bucket_kw(mmp_j), max_steps=budget, opcode_histogram=True)
    out_j = jax_multi(mmp_j, bits, cfg=JCfg(**kw))
    out_t = simulate_multi_batch(mps_t, bits, cfg=TCfg(**kw), device='cpu')
    assert_same(out_t, out_j, 'ragged')
    assert out_t['steps'].tolist() == [budget, own[1], budget]
    assert out_t['incomplete'].tolist() == [True, False, True]


def test_meas_bits_broadcast_and_init_regs_forms(mixed):
    """``meas_bits [B, C, M]`` broadcast to every program, and each
    ``init_regs`` form (``None``, ``[C, 16]``, ``[P, C, 16]``, ``[P, B,
    C, 16]``), every key equal to JAX's; a wrong program count raises
    the JAX package's message."""
    mps_j, mps_t = mixed
    mmp_j, mmp_t = jax_stack(mps_j), stack_machine_programs(mps_t)
    P, C, B = 3, mmp_j.n_cores, 8
    kw = _bucket_kw(mmp_j)
    rng = np.random.default_rng(9)
    shared = _bits(rng, (B, C, 2))
    regs_forms = {
        'none': None,
        'shared': rng.integers(-5, 5, (C, jisa.N_REGS)).astype(np.int32),
        'per_prog': rng.integers(-5, 5, (P, C, jisa.N_REGS))
        .astype(np.int32),
        'full': rng.integers(-5, 5, (P, B, C, jisa.N_REGS)).astype(np.int32),
    }
    for name, regs in regs_forms.items():
        out_j = jax_multi(mmp_j, shared, init_regs=regs, cfg=JCfg(**kw))
        out_t = simulate_multi_batch(mmp_t, shared, init_regs=regs,
                                     cfg=TCfg(**kw), device='cpu')
        assert_same(out_t, out_j, f'init_regs {name}')
    per = simulate_multi_batch(
        mmp_t, np.broadcast_to(shared[None], (P,) + shared.shape),
        cfg=TCfg(**kw), device='cpu')
    for k, v in simulate_multi_batch(mmp_t, shared, cfg=TCfg(**kw),
                                     device='cpu').items():
        assert torch.equal(v, per[k]), k
    bad_bits = _bits(rng, (2, B, C, 2))
    with pytest.raises(ValueError, match='n_progs') as e_j:
        jax_multi(mmp_j, bad_bits, cfg=JCfg(**kw))
    with pytest.raises(ValueError, match='n_progs') as e_t:
        simulate_multi_batch(mmp_t, bad_bits, cfg=TCfg(**kw), device='cpu')
    assert str(e_t.value) == str(e_j.value)
    bad_regs = np.zeros((2, C, jisa.N_REGS), np.int32)
    with pytest.raises(ValueError, match='3-D init_regs') as e_j:
        jax_multi(mmp_j, shared, init_regs=bad_regs, cfg=JCfg(**kw))
    with pytest.raises(ValueError, match='3-D init_regs') as e_t:
        simulate_multi_batch(mmp_t, shared, init_regs=bad_regs,
                             cfg=TCfg(**kw), device='cpu')
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize('kw', [dict(straightline=True),
                                dict(engine='straightline'),
                                dict(engine='block'), dict(engine='pallas'),
                                dict(engine='fused'), dict(rounds=2)],
                         ids=lambda kw: '-'.join(f'{k}={v}'
                                                 for k, v in kw.items()))
def test_refusals_match_jax(mixed, kw):
    """The generic engine only, and one round: the same ``ValueError``
    and message as the JAX package."""
    mps_j, mps_t = mixed
    mmp_j = jax_stack(mps_j)
    bits = np.zeros((3, 4, mmp_j.n_cores, 2), np.int32)
    with pytest.raises(ValueError) as e_j:
        jax_multi(mmp_j, bits, cfg=JCfg(**_bucket_kw(mmp_j, **kw)))
    with pytest.raises(ValueError) as e_t:
        simulate_multi_batch(mps_t, bits, cfg=TCfg(**_bucket_kw(mmp_j, **kw)),
                             device='cpu')
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize('engine', ['auto', 'generic', None])
def test_generic_engine_names_accepted(mixed, engine):
    _, mps_t = mixed
    mmp = stack_machine_programs(mps_t)
    bits = _bits(np.random.default_rng(4), (3, 4, mmp.n_cores, 2))
    out = simulate_multi_batch(mmp, bits, device='cpu', engine=engine,
                               max_meas=2, max_resets=2)
    base = simulate_multi_batch(mmp, bits, device='cpu', max_meas=2,
                                max_resets=2)
    for k in base:
        assert torch.equal(out[k], base[k]), k


@pytest.mark.parametrize('n_shots', [None, 5])
def test_demux_matches_jax(mixed, n_shots):
    mps_j, mps_t = mixed
    mmp_j = jax_stack(mps_j)
    kw = _bucket_kw(mmp_j, opcode_histogram=True)
    bits = _bits(np.random.default_rng(10), (3, 8, mmp_j.n_cores, 2))
    out_j = jax_multi(mmp_j, bits, cfg=JCfg(**kw))
    out_t = simulate_multi_batch(mps_t, bits, cfg=TCfg(**kw), device='cpu')
    for p in range(3):
        assert_same(demux_multi_batch(out_t, p, n_shots=n_shots),
                    jax_demux(out_j, p, n_shots=n_shots), f'prog {p}')


def test_strict_faults_raise_like_jax(mixed):
    """``fault_mode='strict'`` raises ``FaultError`` with the same
    per-code counts when a budget cuts the ensemble."""
    mps_j, mps_t = mixed
    mmp_j = jax_stack(mps_j)
    kw = dict(_bucket_kw(mmp_j), max_steps=10, fault_mode='strict')
    bits = _bits(np.random.default_rng(14), (3, 6, mmp_j.n_cores, 2))
    with pytest.raises(JFaultError) as e_j:
        jax_multi(mmp_j, bits, cfg=JCfg(**kw))
    with pytest.raises(FaultError) as e_t:
        simulate_multi_batch(mps_t, bits, cfg=TCfg(**kw), device='cpu')
    np.testing.assert_array_equal(e_t.value.counts, e_j.value.counts)


def _jax_local_stats(out_j):
    """The JAX package's ``run_multi_sweep`` reduction (``local_stats``)
    of one batch, per program, on a JAX ensemble result."""
    out = {k: np.asarray(v) for k, v in out_j.items()}
    return dict(
        pulse_sum=out['n_pulses'].sum(axis=1),
        err_shots=(out['err'] != 0).any(axis=2).sum(axis=1),
        qclk_sum=out['qclk'].sum(axis=1),
        fault_shots=np.stack([np.asarray(jax_fault_counts(out_j['fault'][p]))
                              for p in range(out['fault'].shape[0])]),
        incomplete=out['incomplete'].astype(np.int32))


def test_multi_batch_stats_exact_against_jax(mixed):
    """The sweep's per-program reduction on the same bits: exact against
    the JAX package's, budget-cut lanes (faults, incomplete) included."""
    mps_j, mps_t = mixed
    mmp_j = jax_stack(mps_j)
    rng = np.random.default_rng(15)
    bits = _bits(rng, (3, 32, mmp_j.n_cores, 2))
    for kw in (_bucket_kw(mmp_j, record_pulses=False),
               dict(_bucket_kw(mmp_j, record_pulses=False), max_steps=25)):
        got = multi_batch_stats(simulate_multi_batch(
            mps_t, bits, cfg=TCfg(**kw), device='cpu'))
        want = _jax_local_stats(jax_multi(mmp_j, bits, cfg=JCfg(**kw)))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)


def test_run_multi_sweep_within_clt_of_jax(mixed):
    """The port's sweep and the JAX package's at the same ``p1`` draw
    different bit streams; each program's rates agree within 5 standard
    errors of their difference (each per-shot quantity's variance bounded
    by a quarter of its observed range squared)."""
    mps_j, mps_t = mixed
    total, batch = 256, 64
    res_t = run_multi_sweep(mps_t, total, batch, p1=0.3, seed=3,
                            max_meas=2, max_resets=2, device='cpu')
    res_j = jax_run_multi_sweep(mps_j, total, batch, p1=0.3, key=3,
                                max_meas=2, max_resets=2)
    assert set(res_t) == set(res_j)
    for k in ('shots', 'n_progs', 'engine', 'incomplete_batches'):
        assert res_t[k] == res_j[k], k
    for name, n in res_t['fault_shots'].items():
        np.testing.assert_array_equal(n, res_j['fault_shots'][name])
    mmp = stack_machine_programs(mps_t)
    probe = simulate_multi_batch(
        mmp, _bits(np.random.default_rng(16), (3, 256, mmp.n_cores, 2)),
        device='cpu', max_meas=2, max_resets=2, record_pulses=False)
    for key, per_shot in (('mean_pulses', probe['n_pulses']),
                          ('mean_qclk', probe['qclk']),
                          ('err_rate', (probe['err'] != 0).any(-1))):
        per_shot = per_shot.double()
        span = (per_shot.amax(1) - per_shot.amin(1)).numpy()
        tol = 5 * np.sqrt(2 * (span / 2) ** 2 / total) + 1e-9
        diff = np.abs(np.asarray(res_t[key]) - np.asarray(res_j[key]))
        assert np.all(diff <= tol), (key, diff, tol)
    assert res_t['mean_pulses'].shape == (3, mmp.n_cores)
    assert res_t['err_shots'].shape == (3,)


def test_run_multi_sweep_sums_its_batches(mixed):
    """Two batches' sweep equals the sum of the two batches' ensemble
    runs on the generator's bits."""
    from distributed_processor_tpu_torch.sim.physics import derive_seed
    _, mps_t = mixed
    mmp = stack_machine_programs(mps_t)
    res = run_multi_sweep(mmp, 32, 16, p1=0.5, seed=21, max_meas=2,
                          max_resets=2, device='cpu')
    cfg = TCfg(**_bucket_kw(mmp, record_pulses=False))
    acc = None
    for i in range(2):
        gen = torch.Generator()
        gen.manual_seed(derive_seed(21, i) >> 1)
        bits = (torch.rand((3, 16, mmp.n_cores, 2), generator=gen)
                < 0.5).to(torch.int32)
        st = multi_batch_stats(simulate_multi_batch(mmp, bits, cfg=cfg,
                                                    device='cpu'))
        acc = st if acc is None else {k: acc[k] + v for k, v in st.items()}
    np.testing.assert_array_equal(res['err_shots'], acc['err_shots'].numpy())
    np.testing.assert_allclose(res['mean_pulses'],
                               acc['pulse_sum'].numpy() / 32)
    np.testing.assert_allclose(res['mean_qclk'], acc['qclk_sum'].numpy() / 32)


@pytest.mark.parametrize('option', ['checkpoint', 'span', 'mesh'])
def test_run_multi_sweep_unported_options_raise(mixed, option, tmp_path):
    """The sweep options behave as the JAX package's: a sweep resumed
    from a 2-batch checkpoint, and a spanned sweep, equal the
    uninterrupted per-batch sweep exactly; on a one-rank dp mesh, batch
    ``i`` draws its bits from ``derive_seed(seed, i, 0)`` (dp row 0)."""
    from distributed_processor_tpu_torch.parallel import make_mesh
    from distributed_processor_tpu_torch.sim.physics import derive_seed
    _, mps_t = mixed
    kw = dict(max_meas=2, max_resets=2)
    base = run_multi_sweep(mps_t, 16, 4, seed=21, device='cpu', **kw)
    if option == 'checkpoint':
        ck = str(tmp_path / 'x.npz')
        run_multi_sweep(mps_t, 8, 4, seed=21, checkpoint=ck, device='cpu',
                        **kw)
        res = run_multi_sweep(mps_t, 16, 4, seed=21, checkpoint=ck,
                              device='cpu', **kw)
    elif option == 'span':
        res = run_multi_sweep(mps_t, 16, 4, seed=21, span=3, device='cpu',
                              **kw)
    else:
        res = run_multi_sweep(mps_t, 16, 4, seed=21, device='cpu',
                              mesh=make_mesh(device='cpu'), **kw)
        mmp = stack_machine_programs(mps_t)
        cfg = TCfg(**_bucket_kw(mmp, record_pulses=False))
        acc = None
        for i in range(4):
            gen = torch.Generator()
            gen.manual_seed(derive_seed(21, i, 0) >> 1)
            bits = (torch.rand((3, 4, mmp.n_cores, 2), generator=gen)
                    < 0.5).to(torch.int32)
            st = multi_batch_stats(simulate_multi_batch(
                mmp, bits, cfg=cfg, device='cpu'))
            acc = st if acc is None else {k: acc[k] + v
                                          for k, v in st.items()}
        base = dict(base, err_shots=acc['err_shots'].numpy(),
                    mean_pulses=acc['pulse_sum'].numpy() / 16,
                    err_rate=acc['err_shots'].numpy() / 16,
                    mean_qclk=acc['qclk_sum'].numpy() / 16,
                    fault_shots={name: v for name, v in zip(
                        res['fault_shots'], acc['fault_shots'].numpy().T)})
    assert set(res) == set(base)
    for k in base:
        if k == 'fault_shots':
            for name in base[k]:
                np.testing.assert_array_equal(res[k][name], base[k][name])
        else:
            np.testing.assert_array_equal(res[k], base[k], err_msg=k)
