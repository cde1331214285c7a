"""The statevec step as one CUDA launch (``ops.statevec.statevec_pulse``,
``csrc/statevec.cu``).

On the CPU (tier-1): the dispatch rule (``_step`` hands a CUDA state to
the wrapper and any other to the eager block, with no launch and no
``statevec.kernel_steps`` counted), the wrapper's refusals, the coupling
table and channel flags it packs from ``dm['static']``, the uniforms the
step draws once for either path, the self-test's plain run, and the
identity the kernel relies on when it skips a core that neither fires
nor measures.

On the card (marker ``cuda``; they skip elsewhere)::

    python -m pytest --noconftest tests/test_torch_statevec_kernel.py -m cuda -q

one step, kernel against the eager block from the same state and the
same uniforms, for every channel alone and all together at C in {1, 3,
5, 8, 10, 11, 12}, and co-fire cases for each pair of coupling kinds; a
whole GHZ-8 parity batch, kernel against the eager block seeded alike;
GHZ-4 on the card against the density-matrix reference within the
parity-scan cell's limits; and the kernel self-test.
This file imports nothing of JAX.
"""

import math

import numpy as np
import pytest
import torch

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    active_reset, couplings_from_qchip, ghz_program, make_default_qchip)
from distributed_processor_tpu_torch.ops import selftest
from distributed_processor_tpu_torch.ops import statevec as sv
from distributed_processor_tpu_torch.ops.selftest import (
    STATEVEC_CHANNELS, statevec_step_diff, statevec_step_inputs)
from distributed_processor_tpu_torch.parallel import physics_batch_stats
from distributed_processor_tpu_torch.sim import density_reference as dr
from distributed_processor_tpu_torch.sim import interpreter
from distributed_processor_tpu_torch.sim.device import (
    STATEVEC_MAX_CORES, DeviceModel)
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, _statevec_pulse, _statevec_traj_u)
from distributed_processor_tpu_torch.sim.physics import (
    ReadoutPhysics, run_physics_batch, statevec_step_budget)
from distributed_processor_tpu_torch.utils import profiling

NOISE = dict(t1_s=80e-6, t2_s=60e-6, depol_per_pulse=1e-3,
             depol2_per_pulse=0.01)


def _ghz_parity(C: int, phi=None):
    """The parity scan's program at width C (reset, GHZ-C, the analysis
    turn by ``phi`` or none, the reads) and its coupling map."""
    qs = [f'Q{i}' for i in range(C)]
    src = active_reset(qs) + [e for e in ghz_program(qs)
                              if e['name'] != 'read']
    if phi is not None:
        for q in qs:
            src += [{'name': 'virtual_z', 'qubit': [q], 'phase': phi},
                    {'name': 'X90', 'qubit': [q]}]
    src += [{'name': 'read', 'qubit': [q]} for q in qs]
    qchip = make_default_qchip(C)
    mp = compile_to_machine(src, qchip, n_qubits=C)
    return mp, couplings_from_qchip(mp, qchip)


def _model(cps, **noise):
    return ReadoutPhysics(sigma=0.05, p1_init=0.15, resolve_chunk=256,
                          resolve_mode='fused',
                          device=DeviceModel('statevec', couplings=cps,
                                             **noise))


def _cfg(mp, model):
    cfg = InterpreterConfig(max_meas=2, max_resets=2, record_pulses=False,
                            max_steps=2 * mp.n_instr + 64,
                            max_pulses=int(mp.max_pulses_per_core(1)) + 4)
    return statevec_step_budget(cfg, model, mp.n_cores)


def _counts() -> tuple:
    c = profiling.counters()
    return (c.get('statevec.steps', 0), c.get('statevec.kernel_steps', 0),
            sv.statevec_pulse.launches)


# ---- the dispatch rule ------------------------------------------------------

@pytest.mark.parametrize('device,kernel', [('cuda', True), ('cuda:1', True),
                                           ('cpu', False), ('meta', False)])
def test_dispatch_rule_reads_the_states_device(device, kernel):
    assert sv.takes_kernel(torch.device(device)) is kernel


def _spy(monkeypatch, name: str, calls: list, real):
    """Route ``interpreter.<name>`` through ``real``, recording each
    call's state device and uniforms."""
    def spy(st, cfg, dm, traj_u, *args):
        calls.append((st['psi'].device.type, traj_u))
        return real(st, cfg, dm, traj_u, *args)
    monkeypatch.setattr(interpreter, name, spy)


def _ghz3_cpu_run():
    mp, cps = _ghz_parity(3, phi=0.0)
    model = _model(cps, **NOISE)
    steps0, kernel0, launches0 = _counts()
    out = run_physics_batch(mp, model, 4, 64, cfg=_cfg(mp, model),
                            device='cpu')
    steps1, kernel1, launches1 = _counts()
    assert not bool(out['err'].any())
    return steps1 - steps0, kernel1 - kernel0, launches1 - launches0


def test_cpu_run_takes_the_eager_block(monkeypatch):
    """A CPU statevec run steps the eager block: no launch, no
    ``statevec.kernel_steps``, one ``statevec.steps`` a step, and every
    step hands the eager block this step's uniforms (T1, Paulis: six a
    core)."""
    def no_kernel(*a, **kw):
        raise AssertionError('a CPU state reached the kernel')
    monkeypatch.setattr(interpreter, 'statevec_pulse', no_kernel)
    calls = []
    _spy(monkeypatch, '_statevec_pulse', calls, _statevec_pulse)
    steps, kernel_steps, launches = _ghz3_cpu_run()
    assert steps == len(calls) > 0
    assert {dev for dev, _u in calls} == {'cpu'}
    assert {tuple(u.shape) for _d, u in calls} == {(64, 3, 6)}
    assert kernel_steps == launches == 0


def test_cuda_typed_state_routes_to_the_wrapper(monkeypatch):
    """With the rule reading the state's device as the card's, ``_step``
    hands every statevec step to the wrapper (here a stand-in that runs
    the eager block) and never to the eager block directly."""
    monkeypatch.setattr(interpreter, 'takes_kernel', lambda device: True)
    calls, direct = [], []
    _spy(monkeypatch, 'statevec_pulse', calls, _statevec_pulse)
    _spy(monkeypatch, '_statevec_pulse', direct, _statevec_pulse)
    steps, _k, _l = _ghz3_cpu_run()
    assert steps == len(calls) > 0 and not direct


def test_wrapper_refuses_a_state_off_the_card():
    """The wrapper itself takes only a CUDA state: nothing reaches the
    kernel from the CPU."""
    st, cfg, dm, args = statevec_step_inputs(4, 3, 'cpu', seed=1)
    traj_u = _statevec_traj_u(dm, 0, 4, 3, 'cpu')
    launches = sv.statevec_pulse.launches
    with pytest.raises(ValueError, match='the kernel takes a CUDA state'):
        sv.statevec_pulse(st, cfg, dm, traj_u, *args)
    assert sv.statevec_pulse.launches == launches


def _meta_step(C: int = 3, B: int = 4, channels=STATEVEC_CHANNELS):
    """A step's operands as a CUDA state has them, on the meta device (no
    data): the CPU inputs and the step's uniforms moved to ``meta``;
    ``(st, cfg, dm, traj_u, args)``."""
    st, cfg, dm, args = statevec_step_inputs(B, C, 'cpu', seed=1,
                                             channels=channels)
    traj_u = _statevec_traj_u(dm, 7, B, C, 'cpu')
    meta = lambda x: x.to('meta') if isinstance(x, torch.Tensor) else x
    return ({k: meta(v) for k, v in st.items()}, cfg,
            {k: meta(v) for k, v in dm.items()}, meta(traj_u),
            tuple(map(meta, args)))


@pytest.fixture
def kernel_path(monkeypatch):
    """The wrapper's kernel path on this host: the meta device routed to
    the kernel, the launch stubbed (it records the operands and returns
    empty outputs)."""
    launched = []

    def stub(ops):
        launched.append(ops)
        B, C = ops['B'], ops['C']
        e = lambda t: torch.empty_like(t)
        return (dict(psi=e(ops['psi']), leaked=e(ops['leaked']),
                     phys_t=e(ops['phys_t']), meas_p1=e(ops['meas_p1'])),
                torch.empty((B, C), dtype=torch.int32, device='meta'),
                torch.empty((B, C), dtype=torch.int32, device='meta')
                if ops['K'] else None)
    monkeypatch.setattr(sv, 'takes_kernel', lambda device: True)
    monkeypatch.setattr(sv, '_launch', stub)
    return launched


@pytest.mark.parametrize('channels', [STATEVEC_CHANNELS, ('dp1',)])
def test_cuda_state_launches_the_kernel(kernel_path, channels):
    """On the kernel path one step is one launch, counted in ``launches``
    and ``statevec.kernel_steps`` (``_step`` counts ``statevec.steps``
    for either path); the co-fire word is the kernel's with couplings and
    0 without (as the eager block gives it); the operands carry the
    model's flags and the caller's uniforms."""
    st, cfg, dm, traj_u, args = _meta_step(channels=channels)
    steps0, kernel0, launches0 = _counts()
    upd, bit, cofire = sv.statevec_pulse(st, cfg, dm, traj_u, *args)
    steps1, kernel1, launches1 = _counts()
    assert (steps1 - steps0, kernel1 - kernel0, launches1 - launches0) \
        == (0, 1, 1)
    ops, = kernel_path
    flags, leak_bit = sv.channel_flags(dm['static'])
    assert (ops['flags'], ops['leak_bit']) == (flags, leak_bit)
    assert ops['traj_u'] is traj_u
    assert ops['NU'] == (8 if channels == STATEVEC_CHANNELS else 6)
    assert set(upd) == {'psi', 'leaked', 'phys_t', 'meas_p1'}
    assert bit.dtype == torch.int32
    if channels == ('dp1',):
        assert ops['K'] == 0 and cofire == 0
    else:
        assert ops['K'] == 3 and cofire.shape == (4, 3)


def _bad(case):
    st, cfg, dm, traj_u, args = _meta_step()
    args = list(args)
    if case == 'dtype':
        st['psi'] = st['psi'].to(torch.complex128)
    elif case == 'layout':
        st['psi'] = torch.empty((8, 4), dtype=torch.complex64,
                                device='meta').t()
    elif case == 'cores':
        st, cfg, dm, traj_u, args = _meta_step(C=13, B=2,
                                               channels=('dp1',))
        args = list(args)
    elif case == 'couplings':
        dm['static'] = ((((0, 1, 5, 'zx'),),) + tuple(dm['static'][1:]))
    elif case == 'kind':
        dm['static'] = ((((0, 1, 2, 'xy'),),) + tuple(dm['static'][1:]))
    elif case == 'shape':
        args[2] = args[2][..., :4]
    elif case == 'device':
        st['phys_t'] = torch.zeros(st['phys_t'].shape, dtype=torch.int32)
    elif case == 'uniforms':
        traj_u = torch.empty((4, 2, 8), device='meta')
    return st, cfg, dm, traj_u, tuple(args)


@pytest.mark.parametrize('case,match', [
    ('dtype', 'psi must be a contiguous torch.complex64'),
    ('layout', 'contiguous=False'),
    ('cores', 'n_cores=13 is outside'),
    ('couplings', 'does not pair two of'),
    ('kind', 'coupling entries are'),
    ('shape', 'pp must be'),
    ('device', 'phys_t must be'),
    ('uniforms', 'traj_u must be'),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(kernel_path, case,
                                                       match):
    st, cfg, dm, traj_u, args = _bad(case)
    with pytest.raises(ValueError, match=match):
        sv.statevec_pulse(st, cfg, dm, traj_u, *args)
    assert not kernel_path


def test_coupling_table_packs_the_models_couplings():
    """Rows ``(ctrl, freq word, target, kind)``, zx 0 and zz 1, in the
    model's order; flags in ``enum Flag`` order; and the uniforms a
    (shot, core) that the step draws for either path: six with a
    stochastic channel, one more for leakage and one for seepage, none
    without."""
    model = DeviceModel('statevec', couplings=((0, 3, 1, 'zx'),
                                               (2, 5, 1, 'zz')),
                        t1_s=50e-6, depol2_per_pulse=0.01,
                        leak2_per_pulse=0.01, seep_per_pulse=0.1)
    static = model.statevec_static() + (True,)
    table = sv.coupling_table(static[0], 3)
    assert table.dtype == np.int32
    assert table.tolist() == [[0, 3, 1, 0], [2, 5, 1, 1]]
    flags, leak_bit = sv.channel_flags(static)
    assert flags == (sv.F_DECAY | sv.F_DP2 | sv.F_LEAK | sv.F_LEAK2
                     | sv.F_SEEP | sv.F_LEAK_IQ)
    assert leak_bit == 1
    assert sv.coupling_table((), 4).shape == (0, 4)
    assert sv.MAX_CORES == STATEVEC_MAX_CORES
    coherent = DeviceModel('statevec').statevec_static() + (False,)
    dp1 = DeviceModel('statevec', depol_per_pulse=0.1).statevec_static() \
        + (False,)
    assert sv.channel_flags(coherent) == (0, 1)
    assert sv.channel_flags(dp1) == (sv.F_DP1, 1)

    def uniforms(static):
        u = _statevec_traj_u(dict(static=static, traj_seed=5), 2, 2, 3,
                             'cpu')
        return None if u is None else tuple(u.shape)
    assert uniforms(static) == (2, 3, 8)
    assert uniforms(coherent) is None
    assert uniforms(dp1) == (2, 3, 6)


def test_statevec_self_test_runs_plain_on_the_cpu():
    selftest.check_statevec_parity('cpu')


# ---- the identity behind skipping an untouched core ------------------------

def _untouched_step(core: int, factor: str, touch: bool):
    """A step on C = 4 with decay, dp1, dp2, zx couplings (none on
    ``core``) and leakage off: every other core fires a pulse (a drive, a
    readout or another element) in every shot; ``core`` neither fires nor
    measures, unless ``touch``, when it takes a 1q drive.  The state is a
    product of ``core``'s factor (``'one'``: |1>; ``'plus'``: equal
    amplitudes) with a random state of the rest."""
    B, C = 256, 4
    st, cfg, dm, args = statevec_step_inputs(
        B, C, 'cpu', seed=3, channels=('decay', 'dp1', 'dp2', 'zx'),
        fire_p=1.0)
    fire, elem, pp, trig, slot, is_meas = args
    cps = tuple(cp for cp in dm['static'][0] if core not in (cp[0], cp[2]))
    dm['static'] = (cps,) + tuple(dm['static'][1:])
    fire = fire.clone()
    fire[:, core] = touch
    pp = pp.clone()
    pp[:, core, 4] = 0
    pp[:, core, 2] = 0                # a 1q drive when touched
    elem = pp[..., 4] & 3
    is_meas = fire & (elem == 2)
    rest = st['psi'].reshape(B, 2, 2, 2, 2).movedim(1 + core, 1)[:, 0]
    rest = rest / torch.linalg.vector_norm(rest.reshape(B, -1), dim=1
                                           ).reshape(B, 1, 1, 1)
    f = torch.tensor([0.0, 1.0] if factor == 'one'
                     else [math.sqrt(0.5)] * 2, dtype=torch.complex64)
    psi = (f.reshape(1, 2, 1, 1, 1) * rest[:, None]).movedim(1, 1 + core)
    st['psi'] = psi.reshape(B, -1).contiguous()
    return st, cfg, dm, (fire, elem, pp, trig, slot, is_meas)


def _halves(psi, core: int):
    p = psi.reshape((psi.shape[0],) + (2,) * 4).movedim(1 + core, 1)
    return p[:, 0], p[:, 1]


@pytest.mark.parametrize('core', [0, 2])
def test_untouched_core_keeps_its_factor_bit_for_bit(core):
    """With decay, dp1 and dp2 on, the eager block's stages on a core
    that neither fires nor measures are exact identities (dt = 0: p_dec
    = 0, damping 1, norm 1, no jump; theta = 0; no Pauli), so the kernel
    may skip them: a |1> factor keeps its |0> half exactly 0, and an
    equal-amplitude factor keeps its two halves equal bit for bit, while
    the other cores' channels act.  The same step with the core driven
    breaks both in some shots (the check can see a stage that acts)."""
    for factor in ('one', 'plus'):
        for touch in (False, True):
            st, cfg, dm, args = _untouched_step(core, factor, touch)
            traj_u = _statevec_traj_u(dm, 2, 256, 4, 'cpu')
            upd, _bit, _cf = _statevec_pulse(st, cfg, dm, traj_u, *args)
            lo, hi = _halves(upd['psi'], core)
            if factor == 'one':
                kept = (lo == 0).reshape(lo.shape[0], -1).all(1)
            else:
                kept = (lo == hi).reshape(lo.shape[0], -1).all(1)
            assert bool(kept.all()) != touch, (factor, touch)
            # the other cores' channels acted
            assert not torch.equal(upd['psi'], st['psi'])


def test_untouched_shot_keeps_its_state_bit_for_bit():
    """A shot that touches no core keeps its state bit for bit through
    the eager block with every channel on (the kernel copies it)."""
    st, cfg, dm, args = statevec_step_inputs(128, 5, 'cpu', seed=9)
    fire, elem, pp, trig, slot, is_meas = args
    idle = torch.arange(128) % 2 == 0
    fire = fire & ~idle[:, None]
    is_meas = is_meas & ~idle[:, None]
    upd, bit, _cf = _statevec_pulse(st, cfg, dm,
                                    _statevec_traj_u(dm, 0, 128, 5, 'cpu'),
                                    fire, elem, pp, trig, slot, is_meas)
    assert torch.equal(upd['psi'][idle], st['psi'][idle])
    assert torch.equal(upd['leaked'][idle], st['leaked'][idle])
    assert torch.equal(upd['meas_p1'][idle], st['meas_p1'][idle])
    assert not bool(bit[idle].any())
    assert not torch.equal(upd['psi'][~idle], st['psi'][~idle])


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the card)')
    return torch.device('cuda')


def _step_both(st, cfg, dm, args, traj_u):
    """The kernel and the eager block on one step, both reading
    ``traj_u`` as the step's trajectory uniforms."""
    got = sv.statevec_pulse(st, cfg, dm, traj_u, *args)
    want = _statevec_pulse(st, cfg, dm, traj_u, *args)
    torch.cuda.synchronize()
    return got, want


# A decision of the trajectory (a jump, a Pauli, a leak, a seep, a
# measured bit) compares a uniform with a threshold that the kernel and
# the eager block compute in float32 with sums in another order, so the
# two thresholds differ by a few units in the last place (~1e-7).  A shot
# may then decide otherwise only where one of its uniforms lies that close
# to its threshold; 1e-5 is a hundred times that margin.  Such a shot is
# checked by moving each of its uniforms by 1e-5 either way in the eager
# block alone: one move must change the eager block's own decisions.
NEAR = 1e-5


def _decisions(upd, bit):
    return torch.cat([bit.cpu().flatten(),
                      upd['leaked'].cpu().to(torch.int32).flatten()])


def _near_threshold(st, cfg, dm, args, traj_u, s: int) -> bool:
    """Whether shot ``s`` has a uniform within NEAR of its threshold: the
    eager block on that shot alone decides otherwise once one uniform
    moves by NEAR."""
    one = lambda x: x[s:s + 1].contiguous()
    st1 = {k: one(v) for k, v in st.items()}
    args1 = tuple(one(a) for a in args)
    dm1 = dict(dm, meas_u=one(dm['meas_u']))
    u1 = one(traj_u) if traj_u is not None else None

    def decide(u, mu):
        upd, bit, _ = _statevec_pulse(st1, cfg, dict(dm1, meas_u=mu), u,
                                      *args1)
        return _decisions(upd, bit)

    base = decide(u1, dm1['meas_u'])
    cands = [('traj', i) for i in range(u1.numel() if u1 is not None
                                         else 0)]
    cands += [('meas', i) for i in range(dm1['meas_u'].numel())]
    for which, i in cands:
        for delta in (-NEAR, NEAR):
            u, mu = u1, dm1['meas_u']
            if which == 'traj':
                u = u1.clone()
                u.view(-1)[i] += delta
            else:
                mu = mu.clone()
                mu.view(-1)[i] += delta
            if not torch.equal(decide(u, mu), base):
                return True
    return False


def _check_step(st, cfg, dm, args):
    B, C = args[0].shape
    traj_u = _statevec_traj_u(dm, 0, B, C, args[0].device)
    got, want = _step_both(st, cfg, dm, args, traj_u)
    differ = statevec_step_diff(got, want)
    assert len(differ) <= max(2, B // 1000), differ
    for s in differ:
        assert _near_threshold(st, cfg, dm, args, traj_u, s), \
            f'shot {s} decided otherwise with no uniform near a threshold'
    return got, want


CORES = [1, 3, 5, 8, 10, 11, 12]
CASES = [(ch,) for ch in STATEVEC_CHANNELS] + [(), STATEVEC_CHANNELS]


@pytest.mark.cuda
@pytest.mark.parametrize('C', CORES)
@pytest.mark.parametrize('channels', CASES,
                         ids=lambda c: '+'.join(c) if c else 'coherent')
def test_one_step_matches_the_eager_block(card, C, channels):
    """One step, kernel against the eager block from the same state and
    the same uniforms: every channel alone, none (rotations and
    collapses only) and all together, at every width the kernel takes.
    Amplitudes and P(1) within 2e-5 absolute, ``phys_t`` and the co-fire
    word equal, bits and leaked flags equal except on shots with a
    uniform within 1e-5 of its threshold (see ``NEAR``)."""
    B = 2048 if C <= 8 else 512
    seed = 100 * C + len(channels)
    st, cfg, dm, args = statevec_step_inputs(B, C, card, seed=seed,
                                             channels=channels)
    before = sv.statevec_pulse.launches
    got, want = _check_step(st, cfg, dm, args)
    assert sv.statevec_pulse.launches == before + 1
    # the input state is left as it was
    assert got[0]['psi'].data_ptr() != st['psi'].data_ptr()


# co-fire: two couplings on 4 cores per pair of kinds, every core firing
# at one of two triggers; the cores of each case's pair overlap as the
# check's hard and soft clashes need
COFIRE_CASES = {
    'zx-zx-hard': ((0, 1, 1, 'zx'), (1, 2, 2, 'zx')),
    'zx-zx-soft': ((0, 1, 2, 'zx'), (1, 2, 2, 'zx')),
    'zx-zz': ((0, 1, 1, 'zx'), (2, 2, 1, 'zz')),
    'zz-zx': ((0, 1, 1, 'zz'), (1, 2, 3, 'zx')),
    'zz-zz': ((0, 1, 1, 'zz'), (1, 2, 2, 'zz')),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(COFIRE_CASES))
def test_cofire_word_matches_the_eager_block(card, case):
    """The co-fire word, kernel against the eager block, for each pair of
    coupling kinds with leakage on (a leaked core's coupling is not
    checked): equal everywhere, and the eager block flags some shots in
    every case but zz-zz, whose target legs commute with each other and
    clash only with 1q drives."""
    st, cfg, dm, args = statevec_step_inputs(
        4096, 4, card, seed=17, channels=('zx', 'zz', 'leak1'), fire_p=0.9)
    dm['static'] = (COFIRE_CASES[case],) + tuple(dm['static'][1:])
    fire, elem, pp, trig, slot, is_meas = args
    pp = pp.clone()
    # frequency words that hit both couplings often
    words = torch.tensor([1, 2, 0], dtype=torch.int32, device=card)
    pp[..., 2] = words[torch.randint(0, 3, fire.shape, device=card)]
    got, want = _check_step(st, cfg, dm,
                            (fire, elem, pp, trig, slot, is_meas))
    flagged = int((want[2] != 0).sum())
    assert flagged > 0, case


def _ghz_run(mp, model, seed, B, eager: bool, monkeypatch):
    """A batch on the card, the statevec block on the kernel or (``eager``)
    on the eager block; with the counts of its steps, kernel steps and
    launches."""
    monkeypatch.setattr(interpreter, 'takes_kernel',
                        (lambda device: False) if eager else sv.takes_kernel)
    steps0, kernel0, launches0 = _counts()
    out = run_physics_batch(mp, model, seed, B, cfg=_cfg(mp, model),
                            device='cuda')
    torch.cuda.synchronize()
    steps1, kernel1, launches1 = _counts()
    return out, (steps1 - steps0, kernel1 - kernel0, launches1 - launches0)


@pytest.mark.cuda
def test_ghz8_batch_matches_the_eager_block(card, monkeypatch):
    """A whole GHZ-8 parity-scan batch of 16384 shots (every channel of
    the cell), kernel against the eager block with the same seed: the
    same uniforms and readout noise, so the shots follow the same
    trajectories but where a uniform lies within rounding of a
    threshold.  At most 0.1 % of shots differ in any measured bit, and the
    two joint histograms agree within the cell's bin bound
    (``5.5 sqrt(B p (1 - p)) + 3``).  Every step of the kernel run
    launched the kernel once."""
    mp, cps = _ghz_parity(8, phi=math.pi / 16)
    model = _model(cps, **NOISE)
    B = 16384
    got, n_got = _ghz_run(mp, model, 21, B, False, monkeypatch)
    want, n_want = _ghz_run(mp, model, 21, B, True, monkeypatch)
    steps, kernel_steps, launches = n_got
    assert steps == kernel_steps == launches > 0
    assert n_want[1:] == (0, 0)
    assert not bool(got['err'].any()) and not bool(want['err'].any())
    differ = (got['meas_bits'] != want['meas_bits']).any(-1).any(-1)
    assert int(differ.sum()) <= B // 1000, int(differ.sum())
    # the event gate reads only the control flow: its counts move only
    # with the shots that branched otherwise
    for key in ('gate_stall_steps', 'live_core_steps'):
        g, w = int(got[key]), int(want[key])
        assert abs(g - w) <= 1e-3 * w, (key, g, w)
    hg = physics_batch_stats(got, outcome_slot=-1)['outcome_counts']
    hw = physics_batch_stats(want, outcome_slot=-1)['outcome_counts']
    n_g = hg.cpu().numpy().astype(np.float64)
    n_w = hw.cpu().numpy().astype(np.float64)
    p = n_w / B
    assert np.all(np.abs(n_g - n_w) <= 5.5 * np.sqrt(B * p * (1 - p)) + 3)


def _critical(dof: int, alarm: float = 1e-6) -> float:
    lo, hi = 0.0, dof + 40.0 * math.sqrt(2.0 * dof) + 100.0
    a = torch.tensor(dof / 2.0, dtype=torch.float64)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        q = float(torch.special.gammaincc(
            a, torch.tensor(mid / 2.0, dtype=torch.float64)))
        lo, hi = (mid, hi) if q > alarm else (lo, mid)
    return hi


@pytest.mark.cuda
@pytest.mark.parametrize('phi', [None, math.pi / 16])
def test_ghz4_on_the_card_within_the_cells_limits(card, monkeypatch, phi):
    """GHZ-4 on the kernel path against the density-matrix reference:
    every bin within the parity scan's ``5.5 sd + 3``, the chi-square
    over the bins with ``B p >= 5`` (the rest pooled) below its 1e-6
    critical value, and the median ``| |psi|^2 - 1 |`` below 1e-5."""
    mp, cps = _ghz_parity(4, phi=phi)
    model = _model(cps, **NOISE)
    B = 131072
    out, (steps, kernel_steps, _l) = _ghz_run(mp, model, 31, B, False,
                                              monkeypatch)
    assert steps == kernel_steps > 0
    assert not bool(out['err'].any())
    n = physics_batch_stats(out, outcome_slot=-1)['outcome_counts'] \
        .cpu().numpy().astype(np.float64)
    p = dr.outcome_distribution(mp, model)
    e = B * p
    assert np.all(np.abs(n - e) <= 5.5 * np.sqrt(B * p * (1 - p)) + 3.0)
    big = e >= 5.0
    obs = np.append(n[big], n[~big].sum())
    exp = np.append(e[big], e[~big].sum())
    keep = exp > 0
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    assert chi2 <= _critical(int(keep.sum()) - 1)
    drift = (torch.view_as_real(out['psi']).square().sum((-1, -2)) - 1.0
             ).abs().median()
    assert float(drift) <= 1e-5


@pytest.mark.cuda
def test_kernel_self_test_on_the_card(card):
    before = sv.statevec_pulse.launches
    selftest.check_statevec_parity(card)
    assert sv.statevec_pulse.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('cut', ['none', 'short'])
def test_kernel_refuses_too_few_uniforms(card, cut):
    """The kernel reads each channel's uniform by its index: handed none,
    or fewer than leakage and seepage need, it refuses before it
    launches."""
    st, cfg, dm, args = statevec_step_inputs(64, 4, card, seed=5)
    traj_u = _statevec_traj_u(dm, 0, 64, 4, card)
    traj_u = None if cut == 'none' else traj_u[..., :6].contiguous()
    launches = sv.statevec_pulse.launches
    with pytest.raises(RuntimeError, match='code -2'):
        sv.statevec_pulse(st, cfg, dm, traj_u, *args)
    assert sv.statevec_pulse.launches == launches
