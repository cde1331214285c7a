"""Register-parameterized sweeps: hardware-style parameter scans as data.

The reference sweeps parameters by recompiling per point host-side (or
by register-writing between runs); here a sweep axis is *data*: the
program reads pulse parameters from processor registers, and the
initial register file varies per sweep point / shot
(``init_regs[point, core, reg]``).  One compiled program serves the
whole grid — the 2D amplitude x frequency grid is a single batch.
A copy of the JAX package's ``parallel/param_sweep.py`` (numpy only).

Reference mechanism: register-sourced pulse parameters
(hdl/pulse_reg.sv:73-82; assembler reg params assembler.py:319-335).
"""

from __future__ import annotations

import numpy as np

from .. import isa
from ..decoder import machine_program_from_cmds
from ..sim.interpreter import InterpreterConfig
from ..sim.oracle import START_NCLKS


AMP_REG = 0    # register holding the swept amplitude word
FREQ_REG = 1   # register holding the swept frequency-buffer address
RDLO_ELEM = 2


def swept_pulse_machine_program(n_cores: int, env_word: int = (3 << 12),
                                n_pulses: int = 1, spacing: int = 40,
                                readout: bool = True, elem_cfgs=None):
    """Build a machine program whose drive amplitude and frequency come
    from registers AMP_REG / FREQ_REG (per-core), repeated ``n_pulses``
    times, optionally followed by a readout pulse.

    Pulse parameters that sweep are *not* in the program text — only the
    register indices are, so a full 2D grid runs from one compilation.
    """
    cores = []
    for _ in range(n_cores):
        cmds = []
        t = START_NCLKS
        for _ in range(n_pulses):
            # two-instruction reg-parameterized pulse (one reg per instr,
            # reference: assembler.py:319-335 multi-reg split)
            cmds.append(isa.pulse_cmd(amp_regaddr=AMP_REG))
            cmds.append(isa.pulse_cmd(freq_regaddr=FREQ_REG, phase_word=0,
                                      env_word=env_word, cfg_word=0,
                                      cmd_time=t))
            t += spacing
        if readout:
            cmds.append(isa.pulse_cmd(freq_word=0, phase_word=0,
                                      amp_word=0xffff, env_word=env_word,
                                      cfg_word=RDLO_ELEM, cmd_time=t))
        cmds.append(isa.done_cmd())
        cores.append(cmds)
    return machine_program_from_cmds(cores, elem_cfgs=elem_cfgs)


def grid_init_regs(amp_words, freq_addrs, n_cores: int) -> np.ndarray:
    """Build ``init_regs`` for the full 2D grid: returns
    ``[n_amp * n_freq, n_cores, 16]``, amp-major (frequency varies
    fastest: point k = (amp[k // n_freq], freq[k % n_freq]))."""
    amp_words = np.asarray(amp_words, dtype=np.int64)
    freq_addrs = np.asarray(freq_addrs, dtype=np.int64)
    aa, ff = np.meshgrid(amp_words, freq_addrs, indexing='ij')
    n_points = aa.size
    regs = np.zeros((n_points, n_cores, isa.N_REGS), dtype=np.int32)
    regs[:, :, AMP_REG] = aa.reshape(-1, 1)
    regs[:, :, FREQ_REG] = ff.reshape(-1, 1)
    return regs


def sweep_cfg(mp, n_pulses_per_core: int, **kw) -> InterpreterConfig:
    defaults = dict(max_steps=mp.n_instr + 8,
                    max_pulses=n_pulses_per_core + 2,
                    max_meas=2, max_resets=1)
    defaults.update(kw)
    return InterpreterConfig(**defaults)
