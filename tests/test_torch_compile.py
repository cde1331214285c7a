"""The port's compile stack against the JAX package's: same program in,
same assembled bytes and the same ``MachineProgram`` out.

The port carries a copy of the numpy compile stack (it may not import
the JAX package), so this pins the copy: per-core ``cmd_buf`` bytes,
env/freq buffers, the compiled asm, and every SoA field and table of the
decoded program, on the headline program (8-qubit active reset + RB),
its 2-qubit cut, the active-reset program and the golden programs.  The
copies of the ``'lut'`` fabric's workloads are pinned too: the machine
programs, LUT tables and configs of ``models/repetition.py`` and
``models/qec.py``, the compiled repetition round, and the numpy decoder
oracles of ``ops/decode.py``.
"""

import numpy as np
import pytest

import distributed_processor_tpu.pipeline as jpipe
import distributed_processor_tpu.models as jmodels
from distributed_processor_tpu.assembler import GlobalAssembler as JAsm
from distributed_processor_tpu.elements import TPUElementConfig as JElem
from distributed_processor_tpu.hwconfig import FPGAConfig as JFPGA
from distributed_processor_tpu.models.golden_suite import \
    GOLDEN_PROGRAMS as J_GOLDEN_PROGRAMS

import distributed_processor_tpu_torch.pipeline as tpipe
import distributed_processor_tpu_torch.models as tmodels
from distributed_processor_tpu_torch.models.golden_suite import GOLDEN_PROGRAMS
from distributed_processor_tpu_torch.assembler import GlobalAssembler as TAsm
from distributed_processor_tpu_torch.decoder import (
    decode_assembled_program, machine_program_from_arrays,
    machine_program_to_arrays)
from distributed_processor_tpu_torch.elements import TPUElementConfig as TElem
from distributed_processor_tpu_torch.hwconfig import FPGAConfig as TFPGA


def _headline(models, n, depth):
    qubits = [f'Q{i}' for i in range(n)]
    return models.active_reset(qubits) + models.rb_program(qubits, depth,
                                                           seed=1234)


# (name, n_qubits, thunk taking the package's models module)
PROGRAMS = [
    (f'headline_{n}q_depth{d}', n,
     lambda m, n=n, d=d: _headline(m, n, d))
    for n in (2, 8) for d in (2, 12)
] + [
    ('active_reset_3q', 3, lambda m: m.active_reset(['Q0', 'Q1', 'Q2'])),
]
GOLDEN_THUNKS = {name: thunk for name, (_n, thunk) in GOLDEN_PROGRAMS.items()}


def _compile(pipe, models, asm_cls, elem_cls, fpga_cls, program, n):
    qchip = models.make_default_qchip(max(n, 2))
    prog = pipe.compile_program(program, qchip, fpga_cls(n_cores=max(n, 2)))
    chans = models.make_channel_configs(n)
    asm = asm_cls(prog, chans, elem_cls)
    return prog, asm.get_assembled_program(), chans, asm


def _assert_arrays_equal(a, b, path=''):
    """Deep equality of the nested numpy/list structure of
    ``machine_program_to_arrays``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_arrays_equal(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_arrays_equal(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _check_same(program_j, program_t, n):
    pj, aj, cj, asm_j = _compile(jpipe, jmodels, JAsm, JElem, JFPGA,
                                 program_j, n)
    pt, at, ct, asm_t = _compile(tpipe, tmodels, TAsm, TElem, TFPGA,
                                 program_t, n)
    assert pt.to_dict() == pj.to_dict()
    assert sorted(at) == sorted(aj)
    for core in aj:
        assert at[core]['cmd_buf'] == aj[core]['cmd_buf'], core
        assert at[core]['env_buffers'] == aj[core]['env_buffers'], core
        assert at[core]['freq_buffers'] == aj[core]['freq_buffers'], core
    from distributed_processor_tpu.decoder import \
        decode_assembled_program as jdecode
    mj = jdecode(aj, cj, reg_maps=asm_j.register_maps)
    mt = decode_assembled_program(at, ct, reg_maps=asm_t.register_maps)
    _assert_arrays_equal(machine_program_to_arrays(mt),
                         machine_program_to_arrays(mj))
    return mj, mt


@pytest.mark.parametrize('name,n,thunk', PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_compile_matches_jax(name, n, thunk):
    assert repr(thunk(tmodels)) == repr(thunk(jmodels))
    _check_same(thunk(jmodels), thunk(tmodels), n)


@pytest.mark.parametrize('name', sorted(GOLDEN_PROGRAMS))
def test_golden_programs_match_jax(name):
    n, thunk = GOLDEN_PROGRAMS[name]
    _check_same(J_GOLDEN_PROGRAMS[name][1](), thunk(), n)


def test_compile_to_machine_matches_jax():
    n = 2
    mj = jpipe.compile_to_machine(_headline(jmodels, n, 2),
                                  jmodels.make_default_qchip(n), n_qubits=n)
    mt = tpipe.compile_to_machine(_headline(tmodels, n, 2),
                                  tmodels.make_default_qchip(n), n_qubits=n)
    _assert_arrays_equal(machine_program_to_arrays(mt),
                         machine_program_to_arrays(mj))
    assert mt.max_pulses_per_core(1) == mj.max_pulses_per_core(1)
    assert mt.n_instr == mj.n_instr and mt.n_cores == mj.n_cores


def test_machine_program_round_trip():
    n = 2
    mj = jpipe.compile_to_machine(_headline(jmodels, n, 2),
                                  jmodels.make_default_qchip(n), n_qubits=n)
    arrays = machine_program_to_arrays(mj)      # reads the JAX program
    mt = machine_program_from_arrays(arrays)
    _assert_arrays_equal(machine_program_to_arrays(mt), arrays)
    again = machine_program_from_arrays(machine_program_to_arrays(mt))
    _assert_arrays_equal(machine_program_to_arrays(again), arrays)
    assert mt.reg_maps == mj.reg_maps
    for tj, tt in zip(mj.tables, mt.tables):
        for ej, et in zip(tj.elem_cfgs, tt.elem_cfgs):
            assert (et.samples_per_clk, et.interp_ratio, et.sample_freq) \
                == (ej.samples_per_clk, ej.interp_ratio, ej.sample_freq)


# the 'lut' fabric's workloads: the copied models/repetition.py,
# models/qec.py and the numpy decoders of ops/decode.py
from distributed_processor_tpu.models import qec as jqec  # noqa: E402
from distributed_processor_tpu.models import repetition as jrep  # noqa: E402
from distributed_processor_tpu.ops import decode as jdecode  # noqa: E402
from distributed_processor_tpu_torch.models import qec as tqec  # noqa: E402
from distributed_processor_tpu_torch.models import (  # noqa: E402
    repetition as trep)
from distributed_processor_tpu_torch.ops import decode as tdecode  # noqa: E402

LUT_MACHINE_PROGRAMS = [
    ('repetition_round_3', lambda rep, qec: rep.repetition_round_machine_program(3)),
    ('repetition_round_8', lambda rep, qec: rep.repetition_round_machine_program(8)),
    ('qec_multiround_3x4', lambda rep, qec: qec.qec_multiround_machine_program(3, 4)),
    ('qec_multiround_8x8', lambda rep, qec: qec.qec_multiround_machine_program(8, 8)),
    ('surface_cycle_3', lambda rep, qec: qec.surface_cycle_machine_program(3)),
    ('surface_cycle_5', lambda rep, qec: qec.surface_cycle_machine_program(5)),
]


@pytest.mark.parametrize('name,thunk', LUT_MACHINE_PROGRAMS,
                         ids=[p[0] for p in LUT_MACHINE_PROGRAMS])
def test_lut_machine_programs_match_jax(name, thunk):
    _assert_arrays_equal(machine_program_to_arrays(thunk(trep, tqec)),
                         machine_program_to_arrays(thunk(jrep, jqec)))


@pytest.mark.parametrize('n', [3, 4, 8])
def test_lut_tables_and_configs_match_jax(n):
    import dataclasses
    assert trep.majority_lut(n) == jrep.majority_lut(n)
    assert tqec.chain_lut(n) == jqec.chain_lut(n)
    for t_cfg, j_cfg in ((trep.repetition_config(n), jrep.repetition_config(n)),
                         (tqec.qec_config(n, 4), jqec.qec_config(n, 4)),
                         (tqec.surface_cycle_config(n),
                          jqec.surface_cycle_config(n))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert trep.repetition_physics_kwargs(n) \
        == jrep.repetition_physics_kwargs(n)
    assert repr(trep.repetition_round_program(n)) \
        == repr(jrep.repetition_round_program(n))
    _check_same(jrep.repetition_round_program(n),
                trep.repetition_round_program(n), n)


def test_decode_oracles_match_jax():
    for A in (1, 2, 4):
        for s in range(1 << A):
            synd = np.array([(s >> i) & 1 for i in range(A)], np.int32)
            np.testing.assert_array_equal(tdecode.chain_matching_np(synd),
                                          jdecode.chain_matching_np(synd))
    for k in (3, 5):
        for p in range(1 << k):
            bits = np.array([(p >> i) & 1 for i in range(k)], np.int32)
            np.testing.assert_array_equal(
                tdecode.majority_correction_np(bits),
                jdecode.majority_correction_np(bits))
