"""Streaming QEC rounds and the in-loop decoders in the port against the
JAX package's.

``simulate_rounds`` runs R rounds, each from a fresh initial state with
its own injected bits, as ``R x B`` lanes of one engine call; the JAX
package scans the engine body over the round axis.  On the same seeded
planes every output key is identical, value and dtype, on every engine
the scan composes with: generic, straight-line, block and ``'pallas'``
(on the CPU the port's plain versions of K1 span and K1 block; the JAX
package's Pallas kernel in interpret mode) — ``steps`` (``[R]``, each
round's own count), ``incomplete`` and ``op_hist`` (``[R, K]``)
included, and with the decode, ``syndrome_hist`` and ``decoded``.  Also:
rounds against sequential ``simulate_batch`` calls, decode invariance
across engines, the surface cycle's chain-LUT decode, the multi-round
emitter on the generic and block engines, a looping program's rounds,
every rejection with the JAX package's message, and the decoders
(``majority_vote``, ``bit_majority_correction``, ``chain_matching``,
``decode_history``) fuzzed on 240 seeded histories against the JAX
decoders and the numpy oracles.  Programs use 3 or 4 cores, and 5 only
on the JAX generic engine (its straight-line engine aborts on a 5-core
program on some CPU hosts).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_processor_tpu.models import qec as jqec
from distributed_processor_tpu.ops import decode as jdec
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, simulate_rounds as jax_rounds)

from distributed_processor_tpu_torch.models import qec as tqec
from distributed_processor_tpu_torch.ops import decode as tdec
from distributed_processor_tpu_torch.sim.interpreter import (
    FaultError, InterpreterConfig as TCfg, simulate_batch, simulate_rounds)

from test_torch_blocks import _looped
from test_torch_interpreter import _to_port


def _rep(n_data=3, **cfg_kw):
    """The repetition round (``n_data`` cores), its config as keyword
    arguments and its decode spec, in both packages."""
    mp_j = jqec.qec_round_machine_program(n_data)
    kw = dataclasses.asdict(jqec.qec_config(
        n_data, **dict(dict(record_pulses=False), **cfg_kw)))
    return mp_j, _to_port(mp_j), kw, tqec.repetition_decode_spec(n_data)


def _planes(rng, rounds, shots, n_cores, max_meas):
    return rng.integers(0, 2, (rounds, shots, n_cores, max_meas),
                        dtype=np.int32)


def assert_same(out_t: dict, out_j: dict, label: str = '', ignore=()):
    """Every key (but ``ignore``) equal in value and dtype."""
    assert set(out_t) - set(ignore) == set(out_j) - set(ignore), \
        (label, set(out_t) ^ set(out_j))
    for key in sorted(set(out_j) - set(ignore)):
        want = np.asarray(out_j[key])
        got = out_t[key].cpu().numpy()
        assert got.dtype == want.dtype, (label, key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f'{label}: {key}')


def _jax_decode_spec(spec):
    return jdec.DecodeSpec(spec.scheme, spec.cores, spec.slot)


# ---------------------------------------------------------------------------
# decoders: fuzz against the JAX decoders and the numpy oracles (240 cases)


def test_majority_decoder_fuzz():
    """120 seeded histories, K in 1..5, R in 1..6: the round majority
    (strict, ties -> 0), the pattern correction and ``decode_history``
    equal the JAX decoders and the literal ``majority_lut`` walk."""
    rng = np.random.default_rng(0xC0DE)
    for case in range(120):
        k, r = int(rng.integers(1, 6)), int(rng.integers(1, 7))
        hist = rng.integers(0, 2, (r, k), dtype=np.int32)
        voted = tdec.majority_vote(hist).numpy()
        np.testing.assert_array_equal(
            voted, (2 * hist.sum(axis=0) > r).astype(np.int32))
        np.testing.assert_array_equal(voted,
                                      np.asarray(jdec.majority_vote(hist)))
        got = tdec.decode_history(hist, 'majority').numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.asarray(jdec.decode_history(hist, 'majority')))
        np.testing.assert_array_equal(
            got, tdec.bit_majority_correction(voted).numpy())
        np.testing.assert_array_equal(
            got, tdec.majority_correction_np(voted),
            err_msg=f'case {case}: hist={hist.tolist()}')


def test_matching_decoder_fuzz():
    """120 seeded syndrome histories, A in 1..5, R in 1..6: the closed
    form chain matching equals the JAX decoder and the exhaustive
    min-weight search (syndrome-consistent, minimum weight, qubit 0 clear
    on a tie)."""
    rng = np.random.default_rng(0xDEC0DE)
    for case in range(120):
        a, r = int(rng.integers(1, 6)), int(rng.integers(1, 7))
        hist = rng.integers(0, 2, (r, a), dtype=np.int32)
        synd = (2 * hist.sum(axis=0) > r).astype(np.int32)
        got = tdec.decode_history(hist, 'matching').numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jdec.decode_history(hist, 'matching')))
        np.testing.assert_array_equal(got, tdec.chain_matching(synd).numpy())
        np.testing.assert_array_equal(got[:-1] ^ got[1:], synd)
        np.testing.assert_array_equal(
            got, tdec.chain_matching_np(synd),
            err_msg=f'case {case}: synd={synd.tolist()}')


@pytest.mark.parametrize('scheme', tdec.DECODE_SCHEMES)
def test_decode_history_batched(scheme):
    """A stacked ``[B, R, K]`` decode equals B single decodes and the JAX
    package's batched decode."""
    hists = np.random.default_rng(11).integers(0, 2, (16, 5, 3),
                                               dtype=np.int32)
    batched = tdec.decode_history(hists, scheme).numpy()
    np.testing.assert_array_equal(
        batched, np.asarray(jdec.decode_history(hists, scheme)))
    for b in range(hists.shape[0]):
        np.testing.assert_array_equal(
            batched[b], tdec.decode_history(hists[b], scheme).numpy())


def test_decode_spec_validation():
    """The same refusals and coercions as the JAX package's DecodeSpec."""
    for args in (('bogus', (0,)), ('majority', ())):
        with pytest.raises(ValueError) as e_j:
            jdec.DecodeSpec(*args)
        with pytest.raises(ValueError) as e_t:
            tdec.DecodeSpec(*args)
        assert str(e_t.value) == str(e_j.value)
    with pytest.raises(ValueError, match='None'):
        tdec.as_decode_spec(None)
    with pytest.raises(ValueError, match='scheme'):
        tdec.decode_history(np.zeros((2, 3), np.int32), 'bogus')
    spec = tdec.DecodeSpec('matching', (3, 4), 0)
    assert tdec.as_decode_spec(spec) is spec
    assert tdec.as_decode_spec(('matching', (3, 4), 0)) == spec
    assert tdec.as_decode_spec({'scheme': 'matching', 'cores': (3, 4)}) \
        == spec
    assert tdec.DecodeSpec('majority', [np.int64(2), 0]).cores == (2, 0)
    for n in (3, 8):
        assert tqec.repetition_decode_spec(n) == \
            tdec.DecodeSpec(*dataclasses.astuple(
                jqec.repetition_decode_spec(n)))
    for d in (2, 3, 5):
        assert tqec.surface_decode_spec(d, slot=1) == \
            tdec.DecodeSpec(*dataclasses.astuple(
                jqec.surface_decode_spec(d, slot=1)))


# ---------------------------------------------------------------------------
# simulate_rounds against the JAX package's, per engine


@pytest.mark.parametrize('decode', [False, True], ids=['plain', 'decode'])
@pytest.mark.parametrize('engine', ['generic', 'straightline', 'block',
                                    'pallas'])
def test_rounds_match_jax(engine, decode):
    """4 rounds x 5 shots of the 3-core repetition round, the opcode
    histogram on: every key equal to JAX ``simulate_rounds`` on the same
    engine (JAX's ``'pallas'`` in interpret mode)."""
    mp_j, mp_t, kw, spec = _rep(3, opcode_histogram=True)
    mb = _planes(np.random.default_rng(5), 4, 5, 3, kw['max_meas'])
    jkw = dict(kw, engine=engine,
               pallas_interpret=True if engine == 'pallas' else None)
    dec = spec if decode else None
    out_j = jax_rounds(mp_j, mb, cfg=JCfg(**jkw),
                       decode=_jax_decode_spec(spec) if decode else None)
    out_t = simulate_rounds(mp_t, mb, cfg=TCfg(**dict(kw, engine=engine)),
                            decode=dec, device='cpu')
    assert_same(out_t, out_j, f'engine={engine}')
    assert out_t['steps'].shape == (4,) and out_t['op_hist'].shape[0] == 4
    if decode:
        assert out_t['syndrome_hist'].shape == (5, 4, 3)


@pytest.mark.parametrize('engine', ['generic', 'straightline', 'block',
                                    'pallas', 'auto', None])
def test_rounds_equal_sequential_batches(engine):
    """R rounds in one call equal R ``simulate_batch`` calls on the same
    engine, stacked: every key, ``steps`` included."""
    _mp_j, mp_t, kw, _spec = _rep(3, opcode_histogram=True,
                                  record_pulses=True)
    cfg = TCfg(**dict(kw, engine=engine))
    mb = _planes(np.random.default_rng(6), 5, 7, 3, kw['max_meas'])
    scan = simulate_rounds(mp_t, mb, cfg=cfg, device='cpu')
    seq = [simulate_batch(mp_t, mb[r], cfg=cfg, device='cpu')
           for r in range(mb.shape[0])]
    assert set(scan) == set(seq[0])
    for k in seq[0]:
        assert torch.equal(scan[k], torch.stack([s[k] for s in seq])), k


@pytest.mark.parametrize('regs_shape', ['shared', 'per_shot'])
def test_rounds_init_regs_forms_match_jax(regs_shape):
    """``init_regs`` ``[C, 16]`` and ``[B, C, 16]``, shared across rounds:
    every key equal to JAX's."""
    mp_j, mp_t, kw, _spec = _rep(3)
    rng = np.random.default_rng(7)
    mb = _planes(rng, 3, 4, 3, kw['max_meas'])
    shape = (3, 16) if regs_shape == 'shared' else (4, 3, 16)
    regs = rng.integers(-9, 9, shape).astype(np.int32)
    for engine in ('generic', 'straightline'):
        out_j = jax_rounds(mp_j, mb, init_regs=regs,
                           cfg=JCfg(**dict(kw, engine=engine)))
        out_t = simulate_rounds(mp_t, mb, init_regs=regs,
                                cfg=TCfg(**dict(kw, engine=engine)),
                                device='cpu')
        assert_same(out_t, out_j, f'{regs_shape} {engine}')


def test_rounds_decode_engine_invariant():
    """The decode rides every engine: all keys equal across engines but
    ``steps``; the history is the injected planes at the decode cores and
    slot, and ``decoded`` its host-side decode."""
    _mp_j, mp_t, kw, spec = _rep(3)
    mb = _planes(np.random.default_rng(8), 5, 4, 3, kw['max_meas'])
    outs = {eng: simulate_rounds(mp_t, mb, cfg=TCfg(**dict(kw, engine=eng)),
                                 decode=spec, device='cpu')
            for eng in ('generic', 'straightline', 'block', 'pallas')}
    for eng, out in outs.items():
        for k in outs['generic']:
            if k != 'steps':
                assert torch.equal(out[k], outs['generic'][k]), (eng, k)
    hist = outs['generic']['syndrome_hist'].numpy()
    np.testing.assert_array_equal(
        hist, np.transpose(mb[:, :, list(spec.cores), spec.slot], (1, 0, 2)))
    np.testing.assert_array_equal(
        outs['generic']['decoded'].numpy(),
        np.asarray(jdec.decode_history(hist, spec.scheme)))


@pytest.mark.parametrize('distance', [2, 3])
def test_surface_cycle_chain_lut_decode(distance):
    """The surface-code-cycle-shaped rounds (``2d - 1`` cores): the
    syndrome history reads the ancilla cores, and the ``'matching'``
    decode equals the chain-LUT entry at the round-majority syndrome
    address; every key equal to JAX's generic engine."""
    d = distance
    mp_j = jqec.surface_cycle_machine_program(d)
    mp_t = _to_port(mp_j)
    kw = dataclasses.asdict(jqec.surface_cycle_config(d,
                                                      record_pulses=False))
    spec = tqec.surface_decode_spec(d)
    rounds, shots = 4, 6
    mb = _planes(np.random.default_rng(8), rounds, shots, mp_t.n_cores,
                 kw['max_meas'])
    out_j = jax_rounds(mp_j, mb, cfg=JCfg(**dict(kw, engine='generic')),
                       decode=_jax_decode_spec(spec))
    lut = tqec.chain_lut(d)
    for engine in ('generic', 'straightline', 'block', 'pallas'):
        out = simulate_rounds(mp_t, mb, cfg=TCfg(**dict(kw, engine=engine)),
                              decode=spec, device='cpu')
        assert_same(out, out_j, f'surface d={d} {engine}',
                    ignore=() if engine == 'generic' else ('steps',))
        assert out['syndrome_hist'].shape == (shots, rounds, d - 1)
        assert out['decoded'].shape == (shots, d)
        assert not bool(out['fault'].any())
        voted = tdec.majority_vote(out['syndrome_hist']).numpy()
        for b in range(shots):
            addr = int(sum(int(v) << i for i, v in enumerate(voted[b])))
            want = np.array([(lut[addr] >> i) & 1 for i in range(d)],
                            np.int32)
            np.testing.assert_array_equal(out['decoded'][b].numpy(), want,
                                          err_msg=f'{engine} shot {b}')


def test_multiround_emitter_generic_equals_block_and_jax():
    """The R-round unrolled emitter (one instruction stream) runs clean
    on the generic and block engines, every key but ``steps`` equal, and
    each equal to JAX's on its engine."""
    rounds, n_data = 3, 3
    mp_j = jqec.qec_multiround_machine_program(n_data, rounds=rounds)
    mp_t = _to_port(mp_j)
    kw = dataclasses.asdict(jqec.qec_config(n_data, rounds=rounds,
                                            record_pulses=False))
    bits = np.random.default_rng(7).integers(
        0, 2, (6, n_data, kw['max_meas']), dtype=np.int32)
    from distributed_processor_tpu.sim.interpreter import \
        simulate_batch as jax_batch
    outs = {}
    for eng in ('generic', 'block'):
        outs[eng] = simulate_batch(mp_t, bits, cfg=TCfg(**dict(kw,
                                                               engine=eng)),
                                   device='cpu')
        assert_same(outs[eng], jax_batch(mp_j, bits,
                                         cfg=JCfg(**dict(kw, engine=eng))),
                    eng)
    for k in outs['generic']:
        if k != 'steps':
            assert torch.equal(outs['block'][k], outs['generic'][k]), k
    assert not bool(outs['generic']['fault'].any())
    assert not bool(outs['generic']['incomplete'])


@pytest.mark.parametrize('engine', ['block', 'pallas'])
def test_looping_program_rounds_match_jax_block(engine):
    """The looped headline (active reset + RB inside the on-device shot
    loop) over 3 rounds: the port's block engine and its ``'pallas'``
    block mode (plain K1 block bodies on the CPU) equal JAX's block
    engine on every key, ``steps`` (block iterations per round) and the
    opcode histogram included, and R sequential batches."""
    mp_j = _looped()
    mp_t = _to_port(mp_j)
    kw = dict(mp_j.static_bounds(), max_meas=6, max_resets=2,
              record_pulses=True, opcode_histogram=True)
    mb = _planes(np.random.default_rng(9), 3, 6, mp_t.n_cores, 6)
    out_j = jax_rounds(mp_j, mb, cfg=JCfg(**dict(kw, engine='block')))
    cfg = TCfg(**dict(kw, engine=engine))
    out_t = simulate_rounds(mp_t, mb, cfg=cfg, device='cpu')
    assert_same(out_t, out_j, f'looped {engine}')
    seq = [simulate_batch(mp_t, mb[r], cfg=cfg, device='cpu')
           for r in range(3)]
    for k in seq[0]:
        assert torch.equal(out_t[k], torch.stack([s[k] for s in seq])), k
    assert not bool(out_t['incomplete'].any())


def test_ragged_rounds_per_round_steps_and_incomplete():
    """Rounds whose bits take different branches settle at different
    steps; a budget between them leaves some rounds incomplete.  ``steps``
    and ``incomplete`` per round equal JAX's, and the strict fault mode
    raises the same counts."""
    mp_j = _looped()
    mp_t = _to_port(mp_j)
    kw = dict(mp_j.static_bounds(), max_meas=6, max_resets=2,
              record_pulses=False, engine='generic')
    rng = np.random.default_rng(10)
    mb = np.concatenate([np.zeros((1, 4, mp_t.n_cores, 6), np.int32),
                         np.ones((1, 4, mp_t.n_cores, 6), np.int32),
                         _planes(rng, 2, 4, mp_t.n_cores, 6)])
    full = simulate_rounds(mp_t, mb, cfg=TCfg(**kw), device='cpu')
    own = full['steps'].tolist()
    assert len(set(own)) > 1, own
    kw['max_steps'] = sorted(own)[1]
    out_j = jax_rounds(mp_j, mb, cfg=JCfg(**kw))
    out_t = simulate_rounds(mp_t, mb, cfg=TCfg(**kw), device='cpu')
    assert_same(out_t, out_j, 'ragged rounds')
    assert bool(out_t['incomplete'].any()) and \
        not bool(out_t['incomplete'].all())
    with pytest.raises(FaultError) as e_t:
        simulate_rounds(mp_t, mb, cfg=TCfg(**dict(kw, fault_mode='strict')),
                        device='cpu')
    from distributed_processor_tpu.sim.interpreter import \
        FaultError as JFaultError
    with pytest.raises(JFaultError) as e_j:
        jax_rounds(mp_j, mb, cfg=JCfg(**dict(kw, fault_mode='strict')))
    np.testing.assert_array_equal(e_t.value.counts, e_j.value.counts)


# ---------------------------------------------------------------------------
# rejections


@pytest.mark.parametrize('case', ['single_round', 'planes', 'contradicts',
                                  'fused', 'decode_cores', 'decode_slot'])
def test_rejections_match_jax(case):
    """Each refusal raises ``ValueError`` with the JAX package's
    message: a streaming round count at the single-round entry, planes
    without a round axis, a contradicting ``cfg.rounds``, the fused
    engine, and decode cores or a slot out of range."""
    from distributed_processor_tpu.sim.interpreter import \
        simulate_batch as jax_batch
    mp_j, mp_t, kw, _spec = _rep(3)
    mb = _planes(np.random.default_rng(9), 2, 3, 3, kw['max_meas'])
    bits, cfg_kw, decode = {
        'single_round': (mb[0], dict(rounds=4), None),
        'planes': (mb[0], {}, None),
        'contradicts': (mb, dict(rounds=3), None),
        'fused': (mb, dict(engine='fused'), None),
        'decode_cores': (mb, {}, ('majority', (0, 99))),
        'decode_slot': (mb, {}, ('majority', (0,), kw['max_meas'])),
    }[case]
    jcfg, tcfg = JCfg(**dict(kw, **cfg_kw)), TCfg(**dict(kw, **cfg_kw))
    if case == 'single_round':
        calls = (lambda: jax_batch(mp_j, bits, cfg=jcfg),
                 lambda: simulate_batch(mp_t, bits, cfg=tcfg, device='cpu'))
    else:
        jd = None if decode is None else jdec.as_decode_spec(decode)
        calls = (lambda: jax_rounds(mp_j, bits, cfg=jcfg, decode=jd),
                 lambda: simulate_rounds(mp_t, bits, cfg=tcfg, decode=decode,
                                         device='cpu'))
    with pytest.raises(ValueError) as e_j:
        calls[0]()
    with pytest.raises(ValueError) as e_t:
        calls[1]()
    assert str(e_t.value) == str(e_j.value)


def test_rounds_cores_axis_not_ported():
    """A set ``cores_axis`` is refused by the single-device rounds entry
    with the JAX package's ValueError (the cores mesh runs rounds through
    ``parallel.sharded_cores_rounds``, tests/test_torch_cores_mesh.py)."""
    mp_j, mp_t, kw, _spec = _rep(3)
    mb = np.zeros((2, 3, 3, kw['max_meas']), np.int32)
    with pytest.raises(ValueError, match='sharded_cores_simulate') as e_t:
        simulate_rounds(mp_t, mb, cfg=TCfg(**kw), cores_axis='cores',
                        device='cpu')
    with pytest.raises(ValueError) as e_j:
        jax_rounds(mp_j, mb, cfg=JCfg(**kw), cores_axis='cores')
    assert str(e_t.value) == str(e_j.value)
