"""QEC workloads on the LUT measurement fabric: repetition rounds and
surface-code-cycle-shaped programs.

Counterpart of the JAX package's ``models/qec.py`` (numpy only):

* :func:`qec_round_machine_program` — ONE syndrome round (the
  repetition round re-exported);
* :func:`qec_multiround_machine_program` — R measure -> fproc-LUT-correct
  rounds unrolled into one instruction stream (the block engine hosts
  it: every round's trigger sits after the previous round's read);
* :func:`surface_cycle_machine_program` — the distance-d
  surface-code-cycle-shaped variant: d data cores + d-1 ancilla cores,
  ancillas measure the syndrome, data cores read their own correction
  from a chain-matching LUT (:func:`chain_lut`);
* :func:`repetition_decode_spec`, :func:`surface_decode_spec` — the
  :class:`..ops.decode.DecodeSpec` of each layout, for the in-loop
  decode of :func:`..sim.interpreter.simulate_rounds`.
"""

from __future__ import annotations

import numpy as np

from .. import isa
from ..decoder import machine_program_from_cmds
from ..ops.decode import DecodeSpec, chain_matching_np
from ..sim.interpreter import InterpreterConfig
from .repetition import (majority_lut, _lut_fabric_kwargs,  # noqa: F401
                         repetition_config,
                         repetition_round_machine_program)

# the single-round unit program the rounds scan executes R times
qec_round_machine_program = repetition_round_machine_program


def qec_config(n_data: int, rounds: int = 1, **kw) -> InterpreterConfig:
    """Interpreter config for the repetition-code QEC programs:
    majority-LUT fabric over the ``n_data`` cores, budgets sized for
    ``rounds`` unrolled rounds (``rounds=1`` covers the scanned
    single-round program — pass the scan's round count via
    ``simulate_rounds`` / ``cfg.rounds``, not here)."""
    defaults = dict(max_steps=16 * rounds + 48, max_pulses=3 * rounds + 2,
                    max_meas=max(rounds, 2), max_resets=1,
                    **_lut_fabric_kwargs(n_data))
    defaults.update(kw)
    return InterpreterConfig(**defaults)


def qec_multiround_machine_program(n_data: int = 3, rounds: int = 4,
                                   meas_time: int = 10,
                                   correct_time: int = 400,
                                   round_period: int = 1000):
    """R rounds of measure -> majority-LUT correction unrolled into
    one machine program, one core per data qubit.  Round r occupies
    absolute clocks ``[r*round_period, (r+1)*round_period)``: measure
    at ``+meas_time``, read the own-core correction bit from the LUT
    (``func_id=1``), conditionally flip (two X90 = X) at
    ``+correct_time``.  Branch targets are intra-round skips, so the
    CFG is a chain of R identical diamonds — block-engine eligible,
    and the timestamped fabric keeps every LUT read
    dispatch-granularity-invariant (round r's read serves round r's
    bits: earlier rounds' production clocks are below the read time,
    later rounds' above it).  Run with ``qec_config(n_data, rounds)``.
    """
    if rounds < 1:
        raise ValueError(f'rounds must be >= 1; got {rounds}')
    cores = []
    for _ in range(n_data):
        cmds = []
        for r in range(rounds):
            t0 = round_period * r
            base = len(cmds)
            cmds += [
                isa.pulse_cmd(freq_word=1, cfg_word=2,
                              env_word=(2 << 12) | 0,
                              cmd_time=t0 + meas_time),
                isa.alu_cmd('jump_fproc', 'i', 1, 'eq',
                            jump_cmd_ptr=base + 3, func_id=1),
                isa.jump_i(base + 5),
                isa.pulse_cmd(freq_word=2, cfg_word=0,
                              env_word=(2 << 12) | 0,
                              cmd_time=t0 + correct_time),
                isa.pulse_cmd(cmd_time=t0 + correct_time + 20),
            ]
        cmds.append(isa.done_cmd())
        cores.append(cmds)
    return machine_program_from_cmds(cores)


def chain_lut(distance: int) -> tuple:
    """Chain-matching LUT for the distance-``distance`` repetition
    chain: entry ``addr`` (ancilla syndrome bits, LSB = ancilla 0 =
    the check between data qubits 0 and 1) has bit i set iff data
    qubit i takes an X correction under exact min-weight matching
    (:func:`~..ops.decode.chain_matching_np` — the brute-force oracle
    builds the table, the closed-form decoder is what gets fuzzed
    against it)."""
    if distance < 2:
        raise ValueError(f'distance must be >= 2; got {distance}')
    table = []
    for addr in range(1 << (distance - 1)):
        synd = [(addr >> i) & 1 for i in range(distance - 1)]
        corr = chain_matching_np(np.array(synd, np.int32))
        table.append(int(sum(1 << i for i, b in enumerate(corr) if b)))
    return tuple(table)


def surface_cycle_machine_program(distance: int = 3,
                                  meas_time: int = 10,
                                  correct_time: int = 400):
    """Distance-d surface-code-cycle-shaped round: cores ``0..d-1``
    are data, cores ``d..2d-2`` are ancillas.  Every core measures at
    ``meas_time`` (ancillas produce the syndrome the LUT address is
    formed from; the data readout doubles as the logical verification
    measurement), then each DATA core reads its own chain-matching
    correction bit from the fabric (``func_id=1``) and conditionally
    flips.  Ancilla LUT outputs are zero by construction
    (:func:`chain_lut` sets bits only at data positions), so ancilla
    cores halt after measuring.  Run with
    ``surface_cycle_config(distance)``."""
    if distance < 2:
        raise ValueError(f'distance must be >= 2; got {distance}')
    data = [
        isa.pulse_cmd(freq_word=1, cfg_word=2, env_word=(2 << 12) | 0,
                      cmd_time=meas_time),
        isa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                    func_id=1),
        isa.jump_i(5),
        isa.pulse_cmd(freq_word=2, cfg_word=0, env_word=(2 << 12) | 0,
                      cmd_time=correct_time),
        isa.pulse_cmd(cmd_time=correct_time + 20),
        isa.done_cmd(),
    ]
    ancilla = [
        isa.pulse_cmd(freq_word=1, cfg_word=2, env_word=(2 << 12) | 0,
                      cmd_time=meas_time),
        isa.done_cmd(),
    ]
    cores = [list(data) for _ in range(distance)] \
        + [list(ancilla) for _ in range(distance - 1)]
    return machine_program_from_cmds(cores)


def surface_cycle_config(distance: int, **kw) -> InterpreterConfig:
    """Config for :func:`surface_cycle_machine_program`: only the
    ancilla cores feed the LUT address; the table is the exact
    min-weight chain matching."""
    mask = (False,) * distance + (True,) * (distance - 1)
    defaults = dict(max_steps=64, max_pulses=8, max_meas=2,
                    max_resets=1, fabric='lut', lut_mask=mask,
                    lut_table=chain_lut(distance))
    defaults.update(kw)
    return InterpreterConfig(**defaults)


def repetition_decode_spec(n_data: int, slot: int = 0) -> DecodeSpec:
    """Decode spec for the repetition-round programs: every data
    core's per-round readout, majority-decoded."""
    return DecodeSpec('majority', tuple(range(n_data)), slot)


def surface_decode_spec(distance: int, slot: int = 0) -> DecodeSpec:
    """Decode spec for :func:`surface_cycle_machine_program`: the
    ancilla cores' syndrome stream, chain-matching-decoded into a
    data-qubit correction."""
    return DecodeSpec('matching',
                      tuple(range(distance, 2 * distance - 1)), slot)
