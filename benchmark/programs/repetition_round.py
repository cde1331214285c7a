"""One repetition-code syndrome round on the LUT feedback fabric.

The reference's LUT fabric (``hdl/fproc_lut.sv``, ``meas_lut.sv``): one
core per data qubit measures, the fabric forms the syndrome address from
every masked core's bit, and each core reads its own correction bit from
a majority-vote table and flips (two X90) when it is set.  The command
words are hand-assembled, as the port's
``models/repetition.repetition_round_machine_program`` assembles them
(a frozen copy here, on the reference's ISA encoder).  ``program`` keys:
``n_data``, ``meas_time``, ``correct_time``.
"""

from __future__ import annotations

from ..reference.stack import isa


def majority_lut(n_data: int) -> tuple:
    """Entry ``addr`` has bit i set iff data bit i disagrees with the
    majority (strict, ties to 0) of the pattern ``addr``."""
    table = []
    for addr in range(1 << n_data):
        bits = [(addr >> i) & 1 for i in range(n_data)]
        maj = 1 if sum(bits) * 2 > n_data else 0
        table.append(sum((1 << i) for i, b in enumerate(bits) if b != maj))
    return tuple(table)


def sources(program: dict, n_programs: int = None, seed: int = 0) -> list:
    """The round's command words, one list of 128-bit words per core."""
    t_meas, t_fix = program['meas_time'], program['correct_time']
    core = [
        isa.pulse_cmd(freq_word=1, cfg_word=2, env_word=(2 << 12) | 0,
                      cmd_time=t_meas),
        isa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3, func_id=1),
        isa.jump_i(5),
        isa.pulse_cmd(freq_word=2, cfg_word=0, env_word=(2 << 12) | 0,
                      cmd_time=t_fix),
        isa.pulse_cmd(cmd_time=t_fix + 20),
        isa.done_cmd(),
    ]
    return [[list(core) for _ in range(program['n_data'])]]


def fabric(program: dict) -> dict:
    """The fabric's wiring, handed to both sides: every data core masked
    into the address, the majority table loaded."""
    n = program['n_data']
    return dict(fabric='lut', lut_mask=(True,) * n, lut_table=majority_lut(n))


def qchip_source(program: dict):
    return None


def port_program(program: dict, source, qchip):
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    return machine_program_from_cmds(source)


def reference_program(program: dict, source, qchip):
    from ..reference.stack.decoder import machine_program_from_cmds
    return machine_program_from_cmds(source)
