"""The carry probes and retrace probes of the port's interpreter.

* ``carry_packspec``: the JAX package's static carry analysis, its
  nested tuples equal to JAX's on every golden program (``trim_regs``
  True and False, ``fused`` where the program is span-shaped, and a
  second config with fewer slots, the opcode histogram and no records);
* ``carry_stream_bytes``: the bytes one K1 span launch (and one K3
  launch) reads and writes per shot, equal to the summed ``nbytes`` of
  the tensors the wrapper is actually passed in a one-shot run;
* ``use_packed_carry``: AUTO resolves False, an explicit value stands;
* the six ``*_trace_count`` probes: a second call of a key moves none,
  a new key moves its own probe by one.
"""

import warnings

import numpy as np
import pytest

from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS
from distributed_processor_tpu.pipeline import \
    compile_to_machine as j_compile
from distributed_processor_tpu.models import \
    make_default_qchip as j_qchip
from distributed_processor_tpu.sim.interpreter import (
    InterpreterConfig as JCfg, carry_packspec as j_carry_packspec)

from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_ensemble)
from distributed_processor_tpu_torch.models.experiments import \
    loop_shots_program
from distributed_processor_tpu_torch.models.golden_suite import \
    GOLDEN_PROGRAMS
from distributed_processor_tpu_torch.pipeline import compile_to_machine
from distributed_processor_tpu_torch.sim import interpreter, physics
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, carry_packspec, carry_stream_bytes,
    use_packed_carry)
from distributed_processor_tpu_torch.sim.physics import (ReadoutPhysics,
                                                         run_physics_batch)

CONFIGS = (dict(), dict(max_meas=4, max_resets=2, record_pulses=False,
                        opcode_histogram=True))


def _compile(compile_fn, qchip, table, name):
    n, thunk = table[name]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        return compile_fn(thunk(), qchip(max(n, 2)), n_qubits=n)


def _spec(fn, mp, cfg, **kw):
    try:
        return fn(mp, cfg, **kw)
    except ValueError as e:
        return ('raised', str(e))


@pytest.mark.parametrize('name', sorted(GOLDEN_PROGRAMS))
def test_carry_packspec_equals_jax(name):
    mp = _compile(compile_to_machine, make_default_qchip, GOLDEN_PROGRAMS,
                  name)
    jmp = _compile(j_compile, j_qchip, J_GOLDEN_PROGRAMS, name)
    span = interpreter._pallas_mode(mp, InterpreterConfig()) == 'span'
    for kw in CONFIGS:
        for trim in (True, False):
            for fused in (False, True):
                got = _spec(carry_packspec, mp, InterpreterConfig(**kw),
                            trim_regs=trim, fused=fused)
                want = _spec(j_carry_packspec, jmp, JCfg(**kw),
                             trim_regs=trim, fused=fused)
                assert got == want, (kw, trim, fused)
                if fused and not span:
                    assert got[0] == 'raised'
                else:
                    assert isinstance(got, tuple) and len(got) == 2
                    hash(got)


def test_use_packed_carry():
    assert use_packed_carry(InterpreterConfig()) is False
    assert use_packed_carry(InterpreterConfig(packed_carry=True)) is True
    assert use_packed_carry(InterpreterConfig(packed_carry=False)) is False


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize('cfg_kw', CONFIGS)
def test_carry_stream_bytes_k1_span(monkeypatch, cfg_kw):
    """The carry K1 span reads and writes, plus the injected bits it
    reads, in a one-shot ``simulate_batch(engine='pallas')``."""
    mp = compile_to_machine(active_reset(['Q0', 'Q1']),
                            make_default_qchip(2), n_qubits=2)
    seen = []
    real = interpreter.exec_span

    def spy(st, table, meas_bits, cfg):
        out = real(st, table, meas_bits, cfg)
        seen.append(_nbytes(st.values()) + _nbytes(out.values())
                    + _nbytes([meas_bits]))
        return out
    monkeypatch.setattr(interpreter, 'exec_span', spy)
    cfg = InterpreterConfig(engine='pallas', **{'max_meas': 4, **cfg_kw})
    interpreter.simulate_batch(mp, np.zeros((1, 2, 4), np.int32), cfg=cfg,
                               device='cpu')
    assert len(seen) == 1
    assert carry_stream_bytes(mp, cfg) == (seen[0], seen[0])


@pytest.mark.parametrize('cfg_kw', CONFIGS)
def test_carry_stream_bytes_k3(monkeypatch, cfg_kw):
    """The physics carry K3 reads and writes, its bits and valid planes
    riding it as state, in a one-shot ``run_physics_batch(engine=
    'fused')`` at sigma = 0."""
    mp = compile_to_machine(active_reset(['Q0', 'Q1']),
                            make_default_qchip(2), n_qubits=2)
    seen = []
    real = physics.exec_span_fused

    def spy(st, table, bits, valid, cfg, fused):
        out, bits2, valid2 = real(st, table, bits, valid, cfg, fused)
        seen.append((_nbytes(list(st.values()) + [bits, valid])
                     + _nbytes(list(out.values()) + [bits2, valid2]), cfg))
        return out, bits2, valid2
    monkeypatch.setattr(physics, 'exec_span_fused', spy)
    run_physics_batch(mp, ReadoutPhysics(sigma=0.0), 0, 1,
                      init_states=np.zeros((1, 2), np.int32),
                      cfg=InterpreterConfig(engine='fused', **{
                          'max_meas': 4, 'max_steps': 200, **cfg_kw}),
                      device='cpu')
    assert len(seen) == 1
    nbytes, cfg = seen[0]
    assert carry_stream_bytes(mp, cfg, fused=True) == (nbytes, nbytes)


# ---------------------------------------------------------------------------
# the retrace probes

PROBES = ('pallas', 'block', 'cores', 'multi', 'span', 'rounds')


def _counts() -> dict:
    return {p: getattr(interpreter, f'{p}_trace_count')() for p in PROBES}


def _moved(fn) -> dict:
    before = _counts()
    fn()
    after = _counts()
    return {p: after[p] - before[p] for p in PROBES
            if after[p] != before[p]}


@pytest.fixture(scope='module')
def programs():
    qs = ['Q0', 'Q1']
    qchip = make_default_qchip(2)
    span = compile_to_machine(active_reset(qs), qchip, n_qubits=2)
    loop = compile_to_machine(loop_shots_program(active_reset(qs), 2,
                                                 scope=qs), qchip,
                              n_qubits=2)
    ens = [[compile_to_machine(active_reset(qs) + p, qchip, n_qubits=2)
            for p in rb_ensemble(qs, 2, 2, seed=s)] for s in (1, 2)]
    return span, loop, ens


def _bits(B, C=2, M=4, R=None):
    shape = (B, C, M) if R is None else (R, B, C, M)
    return np.zeros(shape, np.int32)


def test_pallas_and_block_trace_counts(programs):
    span, loop, _ens = programs
    sim = interpreter.simulate_batch
    for mp, eng in ((span, 'pallas'), (loop, 'pallas'), (loop, 'block')):
        cfg = InterpreterConfig(engine=eng, max_meas=4, max_steps=400)
        run = lambda B: sim(mp, _bits(B), cfg=cfg, device='cpu')
        # a key another test of this process ran has counted already
        assert _moved(lambda: run(17)) in ({}, {eng: 1})
        assert _moved(lambda: run(17)) == {}
        assert _moved(lambda: run(19)) == {eng: 1}
    cfg = InterpreterConfig(engine='fused', max_meas=4, max_steps=400)
    fused = lambda B: run_physics_batch(
        span, ReadoutPhysics(sigma=0.0), 0, B,
        init_states=np.zeros((B, 2), np.int32), cfg=cfg, device='cpu')
    assert _moved(lambda: fused(7)) in ({}, {'pallas': 1})
    assert _moved(lambda: fused(7)) == {}
    assert _moved(lambda: fused(9)) == {'pallas': 1}


def test_multi_trace_count(programs):
    _span, _loop, (ens1, ens2) = programs
    run = lambda mps, B: interpreter.simulate_multi_batch(
        mps, _bits(B), max_meas=4, device='cpu')
    assert _moved(lambda: run(ens1, 23)) in ({}, {'multi': 1})
    # fresh sequences of the same bucket share the executor
    assert _moved(lambda: run(ens2, 23)) == {}
    assert _moved(lambda: run(ens1, 29)) == {'multi': 1}


def test_rounds_trace_count(programs):
    span, _loop, _ens = programs
    cfg = InterpreterConfig(engine='pallas', max_meas=4)
    run = lambda R: interpreter.simulate_rounds(span, _bits(7, R=R), cfg=cfg,
                                                device='cpu')
    assert _moved(lambda: run(3)) in ({}, {'rounds': 1})
    assert _moved(lambda: run(3)) == {}
    assert _moved(lambda: run(5)) == {'rounds': 1}


def test_span_trace_count():
    runner = interpreter.make_span_runner(lambda i: {'n': i})
    assert _moved(lambda: runner(0, 2)) == {'span': 1}
    assert _moved(lambda: runner(2, 2)) == {}
    assert _moved(lambda: runner(4, 1)) == {'span': 1}


def test_cores_trace_count(programs):
    from distributed_processor_tpu_torch.parallel import (
        make_cores_mesh, sharded_cores_simulate)
    span, _loop, _ens = programs
    mesh = make_cores_mesh(n_cores=1, device='cpu')
    run = lambda B: sharded_cores_simulate(span, _bits(B), mesh,
                                           max_meas=4, device='cpu')
    moved = _moved(lambda: run(11))
    assert moved in ({}, {'cores': 1}), moved
    assert _moved(lambda: run(11)) == {}
    assert _moved(lambda: run(13)) == {'cores': 1}
