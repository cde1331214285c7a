"""End-to-end convenience pipeline: dict program -> MachineProgram.

Chains the same stages as the reference's main entry path (reference:
Compiler -> GlobalAssembler, python/distproc/compiler.py:177 /
assembler.py:542) and continues where the reference stops at the FPGA
BRAM boundary: the assembled buffers are decoded into the tensorised
machine program the interpreter executes.
"""

from __future__ import annotations

from .hwconfig import FPGAConfig
from .compiler import Compiler, get_passes, CompilerFlags
from .assembler import GlobalAssembler
from .elements import TPUElementConfig
from .decoder import decode_assembled_program, MachineProgram
from .models.channels import make_channel_configs


def compile_program(program, qchip, fpga_config: FPGAConfig = None,
                    compiler_flags: CompilerFlags = None,
                    proc_grouping=None):
    """Dict program -> CompiledProgram (per-core asm)."""
    fpga_config = fpga_config or FPGAConfig()
    kw = {}
    if proc_grouping is not None:
        kw['proc_grouping'] = proc_grouping
    compiler = Compiler(program, **kw)
    compiler.run_ir_passes(get_passes(fpga_config, qchip,
                                      compiler_flags=compiler_flags))
    return compiler.compile()


def compile_to_machine(program, qchip, channel_configs=None,
                       fpga_config: FPGAConfig = None,
                       compiler_flags: CompilerFlags = None,
                       n_qubits: int = 8, pad_to: int = None,
                       element_cls=TPUElementConfig) -> MachineProgram:
    """Full pipeline: compile, assemble, and decode for the simulator."""
    if channel_configs is None:
        channel_configs = make_channel_configs(n_qubits)
    if fpga_config is None:
        # size the auto-generated 'Qn.meas' fproc channels to the system
        # (the Simulator facade does the same)
        fpga_config = FPGAConfig(n_cores=n_qubits)
    prog = compile_program(program, qchip, fpga_config, compiler_flags)
    asm = GlobalAssembler(prog, channel_configs, element_cls)
    assembled = asm.get_assembled_program()
    return decode_assembled_program(assembled, channel_configs, pad_to=pad_to,
                                    reg_maps=asm.register_maps)
