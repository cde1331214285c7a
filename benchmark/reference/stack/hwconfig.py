"""Hardware parameterisation shared by the compiler, assembler and simulator.

Mirrors the reference's configuration surface (reference:
python/distproc/hwconfig.py) with plain dataclasses:

* :class:`FPGAConfig` — the processor timing model.  These constants are the
  cycle-exactness contract between the scheduler, the schedule linter and
  the interpreter.
* :class:`FPROCChannel` — named measurement-feedback channels.
* :class:`ChannelConfig` / :func:`load_channel_configs` — wiring of pulse
  destination channels to (core, element) indices, loaded from JSON.
* :class:`ElementConfig` — abstract per-element word-encoding interface
  (phase/amp/env/freq/cfg words, env + freq buffers); the TPU signal
  element lives in :mod:`distributed_processor_tpu_torch.elements`.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

FPROC_MEAS_CLKS = 64   # clks after rdlo pulse end until the meas bit is valid
N_CORES = 8


@dataclass
class FPROCChannel:
    """A named measurement-feedback (fproc) channel.

    ``id``: either the numeric fproc function id, or a ``(channel_name,
    attribute)`` tuple resolved at assembly time against the channel
    configs — e.g. ``('Q0.rdlo', 'core_ind')``.

    ``hold_after_chans`` / ``hold_nclks``: fproc reads on this channel must
    execute at least ``hold_nclks`` after the end of the most recent pulse
    on any of the listed channels (the compiler inserts a Hold).
    """
    id: int | tuple
    hold_after_chans: list = field(default_factory=list)
    hold_nclks: int = 0


@dataclass
class FPGAConfig:
    """Distributed-processor timing model (units: FPGA clocks, 2 ns)."""
    fpga_clk_period: float = 2.e-9
    alu_instr_clks: int = 5
    jump_cond_clks: int = 5
    jump_fproc_clks: int = 8   # conservative; covers the fproc_meas handshake
    pulse_regwrite_clks: int = 3
    pulse_load_clks: int = 3   # min clks between pulses on the same core
    fproc_channels: dict = None
    # how many 'Qn.meas' channels to auto-generate (the reference
    # hard-codes N_CORES=8, hwconfig.py:112-115; here it follows the
    # system size — Simulator passes its n_qubits)
    n_cores: int = N_CORES
    # syndrome-LUT fabric contents (ops/fabric.py MeasLUT and the
    # interpreter's fabric='lut' path).  The gateware hard-codes these
    # (reference: hdl/meas_lut.sv:16-20, TODO "make these writable");
    # here they are hardware configuration like every timing constant
    # above.  ``meas_lut_mask``: bool per core — which cores' bits form
    # the table address (LSB = lowest masked core).  ``meas_lut_table``:
    # 2^popcount(mask) entries, bit c of an entry = output bit for core
    # c.  Empty (the default) = no LUT configured.
    meas_lut_mask: tuple = ()
    meas_lut_table: tuple = ()

    def __post_init__(self):
        # normalize JSON-borne lists to the hashable tuples the
        # interpreter config requires, and validate the pair early —
        # a mis-sized table should fail at configuration time, not at
        # first simulated fproc read
        self.meas_lut_mask = tuple(bool(b) for b in self.meas_lut_mask)
        self.meas_lut_table = tuple(int(e) for e in self.meas_lut_table)
        if self.meas_lut_mask or self.meas_lut_table:
            k = sum(self.meas_lut_mask)
            if len(self.meas_lut_table) != 1 << k:
                raise ValueError(
                    f'meas_lut_table must have 2^{k} entries for a '
                    f'{k}-input mask, got {len(self.meas_lut_table)}')
        if self.fproc_channels is None:
            # default: one 'Qn.meas' channel per qubit, served by the rdlo
            # demod chain on that qubit's core
            self.fproc_channels = {
                f'Q{i}.meas': FPROCChannel(
                    id=(f'Q{i}.rdlo', 'core_ind'),
                    hold_after_chans=[f'Q{i}.rdlo'],
                    hold_nclks=FPROC_MEAS_CLKS)
                for i in range(self.n_cores)}

    @property
    def fpga_clk_freq(self) -> float:
        return 1 / self.fpga_clk_period

    def to_dict(self) -> dict:
        d = {'fpga_clk_period': self.fpga_clk_period,
             'alu_instr_clks': self.alu_instr_clks,
             'jump_cond_clks': self.jump_cond_clks,
             'jump_fproc_clks': self.jump_fproc_clks,
             'pulse_regwrite_clks': self.pulse_regwrite_clks,
             'pulse_load_clks': self.pulse_load_clks,
             'n_cores': self.n_cores}
        if self.meas_lut_mask:
            # only when configured: serialized CompiledPrograms (and the
            # golden files pinning them) predate these fields
            d['meas_lut_mask'] = list(self.meas_lut_mask)
            d['meas_lut_table'] = list(self.meas_lut_table)
        return d


@dataclass
class ChannelConfig:
    """Wiring of one pulse destination channel (e.g. ``Q0.qdrv``)."""
    core_ind: int
    elem_ind: int
    elem_params: dict
    env_mem_name: str = ''
    freq_mem_name: str = ''
    acc_mem_name: str = ''

    def _fmt(self, name):
        return name.format(core_ind=self.core_ind)

    @property
    def env_mem(self) -> str:
        return self._fmt(self.env_mem_name)

    @property
    def freq_mem(self) -> str:
        return self._fmt(self.freq_mem_name)

    @property
    def acc_mem(self) -> str:
        return self._fmt(self.acc_mem_name)


def load_channel_configs(config: dict | str) -> dict:
    """Load a channel-config dict (or JSON file path).

    Returns a dict mapping channel name -> :class:`ChannelConfig`, with
    scalar entries (e.g. ``fpga_clk_freq``) passed through.
    """
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if 'fpga_clk_freq' not in config:
        raise ValueError("channel config must define 'fpga_clk_freq'")
    out = {}
    for key, value in config.items():
        if isinstance(value, dict):
            out[key] = ChannelConfig(**value)
        else:
            out[key] = value
    return out


class ElementConfig(ABC):
    """Per-element word encodings: how pulse parameters map to machine words.

    One instance per signal-generator element (qdrv/rdrv/rdlo).  The
    assembler uses it to encode pulse commands and build envelope/frequency
    buffers; the simulator uses the same instance to decode them, which
    keeps encode/decode bit-consistent by construction.
    """

    def __init__(self, fpga_clk_period: float, samples_per_clk: int):
        self.fpga_clk_period = fpga_clk_period
        self.samples_per_clk = samples_per_clk

    @property
    def sample_period(self) -> float:
        return self.fpga_clk_period / self.samples_per_clk

    @property
    def sample_freq(self) -> float:
        return 1 / self.sample_period

    @property
    def fpga_clk_freq(self) -> float:
        return 1 / self.fpga_clk_period

    @abstractmethod
    def get_phase_word(self, phase: float) -> int: ...

    @abstractmethod
    def get_amp_word(self, amplitude: float) -> int: ...

    @abstractmethod
    def get_env_word(self, env_start_ind: int, env_length: int) -> int: ...

    @abstractmethod
    def get_cw_env_word(self, env_start_ind: int) -> int: ...

    @abstractmethod
    def get_env_buffer(self, env) -> 'np.ndarray': ...

    @abstractmethod
    def get_freq_buffer(self, freqs) -> 'np.ndarray': ...

    @abstractmethod
    def get_freq_addr(self, freq_ind: int) -> int: ...

    @abstractmethod
    def get_cfg_word(self, elem_ind: int, mode_bits: int | None) -> int: ...

    @abstractmethod
    def length_nclks(self, tlength: float) -> int: ...
