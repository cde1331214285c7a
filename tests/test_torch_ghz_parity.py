"""The GHZ parity scan on the statevec device, on the CPU: the port
against its density-matrix reference (``sim/density_reference.py``),
the reduce's joint histogram (``parallel.sweep.physics_batch_stats``
with ``outcome_slot``), and the statevec block's span and counters.

The program is the benchmark's GHZ deployment at a small width: active
reset, H on Q0 and a barrier-fenced CNOT chain, then a Z-basis readout
or ``virtual_z(phi)`` and ``X90`` on every qubit before the reads.  The
histogram check is the benchmark cell's: every bin within
``5.5 sqrt(B p (1 - p)) + 3`` of ``B p``, and a chi-square over the bins
with ``B p >= 5`` (the rest pooled) below its 1e-6 critical value.
This file imports nothing of JAX.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    active_reset, couplings_from_qchip, ghz_program, make_default_qchip,
    rb_program)
from distributed_processor_tpu_torch.obs import HOST_SPANS
from distributed_processor_tpu_torch.parallel import (physics_batch_stats,
                                                      run_physics_sweep)
from distributed_processor_tpu_torch.sim import density_reference as dr
from distributed_processor_tpu_torch.sim.device import DeviceModel
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, fault_shot_counts)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, run_physics_batch, statevec_step_budget)
from distributed_processor_tpu_torch.utils import profiling

torch.set_num_threads(1)

NOISE = dict(t1_s=80e-6, t2_s=60e-6, depol_per_pulse=1e-3,
             depol2_per_pulse=0.01)


def _ghz_parity(C: int, phi=None, final_read: bool = True):
    """The compiled program and its coupling map: reset, GHZ-C, then the
    analysis turn by ``phi`` (None: Z basis) and the reads."""
    qs = [f'Q{i}' for i in range(C)]
    src = active_reset(qs) + [e for e in ghz_program(qs)
                              if e['name'] != 'read']
    if phi is not None:
        for q in qs:
            src += [{'name': 'virtual_z', 'qubit': [q], 'phase': phi},
                    {'name': 'X90', 'qubit': [q]}]
    if final_read:
        src += [{'name': 'read', 'qubit': [q]} for q in qs]
    qchip = make_default_qchip(C)
    mp = compile_to_machine(src, qchip, n_qubits=C)
    return mp, couplings_from_qchip(mp, qchip)


def _model(cps, noise: bool):
    kw = NOISE if noise else {}
    return ReadoutPhysics(sigma=0.05 if noise else 0.0,
                          p1_init=0.15 if noise else 0.0,
                          resolve_chunk=256, resolve_mode='fused',
                          device=DeviceModel('statevec', couplings=cps,
                                             **kw))


def _cfg(mp, model):
    cfg = InterpreterConfig(max_meas=2, max_resets=2, record_pulses=False,
                            max_steps=2 * mp.n_instr + 64,
                            max_pulses=int(mp.max_pulses_per_core(1)) + 4)
    return statevec_step_budget(cfg, model, mp.n_cores)


def _critical(dof: int, alarm: float = 1e-6) -> float:
    lo, hi = 0.0, dof + 40.0 * math.sqrt(2.0 * dof) + 100.0
    a = torch.tensor(dof / 2.0, dtype=torch.float64)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        q = float(torch.special.gammaincc(
            a, torch.tensor(mid / 2.0, dtype=torch.float64)))
        lo, hi = (mid, hi) if q > alarm else (lo, mid)
    return hi


def _within_bound(counts, p) -> bool:
    n = np.asarray(counts, np.float64)
    N = n.sum()
    e = N * p
    if np.any(np.abs(n - e) > 5.5 * np.sqrt(N * p * (1 - p)) + 3.0):
        return False
    big = e >= 5.0
    obs = np.append(n[big], n[~big].sum())
    exp = np.append(e[big], e[~big].sum())
    keep = exp > 0
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    return chi2 <= _critical(int(keep.sum()) - 1)


# ---- (a) the noiseless state ----------------------------------------------

@pytest.mark.parametrize('C', [3, 4])
def test_state_before_the_final_read_is_the_references(C):
    """Noise off, ``p1_init`` 0, sigma 0: after the reset, the GHZ chain
    and a parity turn, every shot's ``psi`` is the reference's pure state
    up to a global phase, to 1e-5 (a bf16 or fp16 state misses this)."""
    mp, cps = _ghz_parity(C, phi=math.pi / 7, final_read=False)
    model = _model(cps, noise=False)
    rho = dr.density_matrix(mp, model)
    w, v = torch.linalg.eigh(rho)
    assert abs(float(w[-1]) - 1.0) < 1e-9            # pure
    ref = v[:, -1]
    out = run_physics_batch(mp, model, 3, 16, cfg=_cfg(mp, model),
                            device='cpu')
    assert not bool(out['err'].any())
    psi = out['psi'].to(torch.complex128)
    for shot in psi:
        ov = torch.vdot(ref, shot)
        np.testing.assert_allclose(shot.numpy(),
                                   (ov / abs(ov) * ref).numpy(), atol=1e-5)


# ---- (b) the noisy ensemble ------------------------------------------------

# shots per program: the three programs take 12288 in all, and about as
# many seconds on one CPU thread as the file may spend
SHOTS = 4096


@pytest.mark.parametrize('phi', [None, 0.0, math.pi / 16])
def test_noisy_histogram_within_the_cells_bound(phi):
    """Every channel on, active reset from ``p1_init`` 0.15, C = 4: the
    joint histogram of the final read lies within the cell's bound of the
    reference, and the reference without the feed-forward (the control)
    does not, for the Z-basis program and two analysis phases."""
    mp, cps = _ghz_parity(4, phi=phi)
    model = _model(cps, noise=True)
    out = run_physics_batch(mp, model, 11, SHOTS, cfg=_cfg(mp, model),
                            device='cpu')
    counts = physics_batch_stats(out, outcome_slot=-1)['outcome_counts']
    assert int(counts.sum()) == SHOTS
    assert _within_bound(counts.numpy(), dr.outcome_distribution(mp, model))
    assert not _within_bound(counts.numpy(), dr.outcome_distribution(
        mp, model, feedback=False))


def test_a_coupling_target_decays_at_its_own_pulse():
    """The trajectory lumps a core's damping and dephasing at its own
    pulses, so the cross-resonance pulses that reach a target before its
    next pulse act before the target's gap decays.  After an active reset
    whose feed-forward ends the target's gap later in some outcomes than
    in others, the reference keeps each gap open until the target's pulse
    (merging it early would decohere the target before the CNOT's first
    CR pulse).  Dephasing alone, T2 = 5 us on the target: the shots'
    average state against the reference's, each population within 5
    standard deviations."""
    qs = ['Q0', 'Q1']
    src = active_reset(qs) + [e for e in ghz_program(qs)
                              if e['name'] != 'read']
    qchip = make_default_qchip(2)
    mp = compile_to_machine(src, qchip, n_qubits=2)
    model = ReadoutPhysics(sigma=0.0, p1_init=0.0, device=DeviceModel(
        'statevec', couplings=couplings_from_qchip(mp, qchip),
        t2_s=(math.inf, 5e-6)))
    ref = torch.diagonal(dr.density_matrix(mp, model)).real.numpy()
    out = run_physics_batch(mp, model, 5, 4096, cfg=_cfg(mp, model),
                            device='cpu')
    got = (out['psi'].abs() ** 2).mean(0).numpy()
    sd = np.sqrt(ref * (1 - ref) / 4096)
    assert np.all(np.abs(got - ref) <= 5 * sd + 1e-6), (got, ref)
    assert ref[1] > 0.02          # the target's dephasing shows


def test_reference_reads_a_consumed_slot():
    """Slot 0 is the reset's read, a branch of the walk: its joint
    distribution is the thermal start's, each core excited with
    ``p1_init`` (less the damping of the read's first 6 clocks)."""
    mp, cps = _ghz_parity(3, phi=0.0)
    model = _model(cps, noise=True)
    p = np.array([0.85, 0.15])
    bits = (np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1
    thermal = p[bits].prod(1)
    np.testing.assert_allclose(dr.outcome_distribution(mp, model, slot=0),
                               thermal, rtol=0, atol=1e-4)


def test_product_prefix_equals_the_full_walk():
    """The walk's shortcut to the first coupling (each core's reset in its
    own small matrix) gives the distribution of the walk over every
    reset outcome's full matrix."""
    mp, cps = _ghz_parity(4, phi=0.3)
    model = _model(cps, noise=True)
    fast = dr.outcome_distribution(mp, model)
    real = dr._product_prefix
    try:
        dr._product_prefix = lambda *a: None
        full = dr.outcome_distribution(mp, model)
    finally:
        dr._product_prefix = real
    np.testing.assert_allclose(fast, full, rtol=0, atol=1e-13)


# ---- (c) the histogram in the reduce and the sweep -------------------------

@pytest.fixture(scope='module')
def rb2():
    qs = ['Q0', 'Q1']
    mp = compile_to_machine(active_reset(qs) + rb_program(qs, 3, seed=5),
                            make_default_qchip(2), n_qubits=2)
    cfg = InterpreterConfig(max_steps=2 * mp.n_instr + 64,
                            max_pulses=int(mp.max_pulses_per_core(1)) + 4,
                            max_meas=2, max_resets=2, record_pulses=False,
                            straightline=True)
    return mp, cfg, ReadoutPhysics(sigma=0.05, p1_init=0.3,
                                   resolve_chunk=256, resolve_mode='fused')


@pytest.mark.parametrize('slot', [0, 1, -1, -2])
def test_outcome_counts_is_a_bincount_of_the_slot(rb2, slot):
    mp, cfg, model = rb2
    out = run_physics_batch(mp, model, 9, 256, cfg=cfg, device='cpu')
    got = physics_batch_stats(out, outcome_slot=slot)['outcome_counts']
    bits = out['meas_bits'].numpy()
    valid = out['meas_bits_valid'].numpy()
    n_valid = valid.sum(-1)
    at = np.full(n_valid.shape, slot) if slot >= 0 \
        else n_valid + slot                                      # [B, C]
    b = np.take_along_axis(bits, np.clip(at, 0, 1)[..., None], 2)[..., 0]
    ok = (at >= 0) & np.take_along_axis(
        valid, np.clip(at, 0, 1)[..., None], 2)[..., 0]
    clean = ~(out['err'].numpy() != 0).any(1) & valid[:, :, 0].all(1)
    take = clean & ok.all(1)
    code = (b << np.arange(2)[None, :]).sum(1)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(code[take], minlength=4))
    assert int(got.sum()) == int(take.sum()) > 0


def test_outcome_counts_over_spans_and_a_resume(rb2, tmp_path):
    mp, cfg, model = rb2
    kw = dict(seed=4, cfg=cfg, device='cpu', outcome_slot=-1)
    one = run_physics_sweep(mp, model, 5 * 32, 32, span=1, **kw)
    two = run_physics_sweep(mp, model, 5 * 32, 32, span=2, **kw)
    np.testing.assert_array_equal(one['outcome_counts'],
                                  two['outcome_counts'])
    assert int(one['outcome_counts'].sum()) == one['clean_shots']
    ck = str(tmp_path / 'ck.npz')
    run_physics_sweep(mp, model, 2 * 32, 32, checkpoint=ck, **kw)
    resumed = run_physics_sweep(mp, model, 5 * 32, 32, checkpoint=ck, **kw)
    np.testing.assert_array_equal(resumed['outcome_counts'],
                                  one['outcome_counts'])
    # the slot is part of the checkpoint's identity
    with pytest.raises(ValueError, match='outcome_slot'):
        run_physics_sweep(mp, model, 5 * 32, 32, checkpoint=ck,
                          **dict(kw, outcome_slot=0))
    plain = run_physics_sweep(mp, model, 5 * 32, 32, seed=4, cfg=cfg,
                              device='cpu')
    assert 'outcome_counts' not in plain
    assert plain['clean_shots'] == one['clean_shots']


# ---- (d) the campaign's reduce is unchanged --------------------------------

def _stats_as_before(out: dict) -> dict:
    """The reduce as it stood before ``outcome_slot``."""
    first = out['meas_bits'][:, :, 0]
    errored = (out['err'] != 0).any(dim=1)
    clean = ~errored & out['meas_bits_valid'][:, :, 0].all(dim=1)
    return dict(
        pulse_sum=out['n_pulses'].sum(0),
        meas1_sum=first.sum(0),
        allzero_sum=((first == 0).all(dim=1) & clean).sum(),
        clean_shots=clean.sum(),
        err_shots=errored.sum(),
        fault_shots=fault_shot_counts(out['fault']),
    )


def _aten_ops(fn) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith('aten::')]


def test_campaign_reduce_without_a_slot_is_unchanged():
    """On the campaign's program (reset then depth-12 RB on 8 qubits):
    the same keys, values and aten ops as before, and with a slot the
    same values beside the histogram."""
    qs = [f'Q{i}' for i in range(8)]
    mp = compile_to_machine(active_reset(qs) + rb_program(qs, 12, seed=1234),
                            make_default_qchip(8), n_qubits=8)
    cfg = InterpreterConfig(max_steps=2 * mp.n_instr + 64,
                            max_pulses=int(mp.max_pulses_per_core(1)) + 4,
                            max_meas=2, max_resets=2, record_pulses=False,
                            straightline=None)
    model = ReadoutPhysics(sigma=0.05, p1_init=0.15, resolve_chunk=256,
                           resolve_mode='fused')
    out = run_physics_batch(mp, model, 7, 64, cfg=cfg, device='cpu')
    got, want = physics_batch_stats(out), _stats_as_before(out)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert _aten_ops(lambda: physics_batch_stats(out)) == \
        _aten_ops(lambda: _stats_as_before(out))
    with_slot = physics_batch_stats(out, outcome_slot=-1)
    assert list(with_slot) == list(want) + ['outcome_counts']
    for k in want:
        assert torch.equal(with_slot[k], want[k]), k


# ---- (e) the statevec block's span and counters ----------------------------

def test_statevec_span_and_counters_record():
    """``statevec.apply`` (one a step, under the generic engine's
    ``physics.exec``), the ``statevec.steps`` counter, the event gate's
    device counters in the output, and the
    ``physics.batch`` span naming the device."""
    mp, cps = _ghz_parity(3, phi=0.0)
    model = _model(cps, noise=True)
    before = profiling.counters()
    HOST_SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_physics_batch(mp, model, 5, 32, cfg=_cfg(mp, model),
                                device='cpu')
    spans = HOST_SPANS.spans()
    HOST_SPANS.clear()
    after = profiling.counters()
    steps = int(out['steps'])
    assert after.get('statevec.steps', 0) \
        - before.get('statevec.steps', 0) == steps
    by_id = {s['id']: s for s in spans}
    applies = [s for s in spans if s['name'] == 'statevec.apply']
    assert len(applies) == steps
    for s in applies:
        assert by_id[s['parent']]['name'] == 'physics.exec'
    batch, = [s for s in spans if s['name'] == 'physics.batch']
    assert batch['args']['device'] == 'statevec'
    assert batch['args']['engine'] == 'generic'
    stall, live = int(out['gate_stall_steps']), int(out['live_core_steps'])
    assert out['gate_stall_steps'].dtype == torch.int64
    assert 0 < stall < live <= 32 * 3 * steps
