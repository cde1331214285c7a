"""TPU signal-generator element: concrete word encodings + buffer layouts.

The reference keeps its signal element out-of-repo (separate gateware repo);
this module defines the numeric contract our simulator executes.  Layouts
follow the bit-field sizes fixed by the processor ISA (hdl/pulse_iface.sv:1-6)
and the freq/env buffer shapes observable in the reference's disassembler
(python/distproc/asmparse.py:46-86):

* phase word: 17-bit, phase/(2 pi) * 2^17, wrapped
* amp word: 16-bit, amp * (2^16 - 1) for amp in [0, 1]
* env word: 24-bit = {12-bit length, 12-bit start address}; addresses and
  lengths count groups of 4 envelope samples (four parallel memory banks);
  length 0xfff is the continuous-wave sentinel
* env buffer: one uint32 per sample = signed 16-bit Q (LSB) | I << 16
  (the reference disassembler's convention: real = high half,
  reference python/distproc/asmparse.py:60-63)
* freq buffer: 16 uint32 words per frequency — word 0 is the 32-bit phase
  increment freq/fsamp * 2^32, words 1..15 are the IQ unit phasors
  exp(2 pi i k freq / fsamp) for the element's parallel sample lanes,
  packed signed-15-bit I<<16 | Q
* cfg word: 4-bit = {2-bit mode, 2-bit element index}
"""

from __future__ import annotations

import numpy as np

from .hwconfig import ElementConfig
from .envelopes import sample_env

PHASE_BITS = 17
AMP_BITS = 16
FREQ_ADDR_BITS = 9
ENV_ADDR_BITS = 12
ENV_LEN_BITS = 12
ENV_CW_SENTINEL = (1 << ENV_LEN_BITS) - 1
ENV_BANKS = 4          # envelope samples per address step
FREQ_BUF_WORDS = 16    # uint32 words per frequency entry
IQ_SCALE = 2 ** 15 - 1


def pack_iq(i, q) -> np.ndarray:
    """Pack signed 16-bit I (high half) and Q (low half) into uint32
    (reference: python/distproc/asmparse.py:60-63 reads real = high)."""
    iw = np.asarray(np.round(i), dtype=np.int64) & 0xffff
    qw = np.asarray(np.round(q), dtype=np.int64) & 0xffff
    return ((iw << 16) | qw).astype(np.uint32)


def unpack_iq(words) -> np.ndarray:
    """Inverse of :func:`pack_iq`; returns complex I + 1j*Q."""
    w = np.asarray(words, dtype=np.uint32).astype(np.int64)
    q = w & 0xffff
    i = (w >> 16) & 0xffff
    i = np.where(i >= 1 << 15, i - (1 << 16), i)
    q = np.where(q >= 1 << 15, q - (1 << 16), q)
    return i + 1j * q


class TPUElementConfig(ElementConfig):
    """Concrete element for the TPU execution backend.

    ``samples_per_clk``: DAC samples per FPGA clock (16 for qdrv/rdrv at
    8 GS/s, 4 for rdlo at 2 GS/s with a 500 MHz clock).
    ``interp_ratio``: envelope interpolation — the envelope memory holds
    one sample per ``interp_ratio`` DAC samples.
    """

    def __init__(self, samples_per_clk: int = 16, interp_ratio: int = 1,
                 fpga_clk_period: float = 2.e-9):
        super().__init__(fpga_clk_period, samples_per_clk)
        self.interp_ratio = interp_ratio

    @property
    def env_sample_freq(self) -> float:
        return self.sample_freq / self.interp_ratio

    # -- scalar word encodings -------------------------------------------

    def get_phase_word(self, phase: float) -> int:
        frac = (phase / (2 * np.pi)) % 1.0
        return int(np.round(frac * (1 << PHASE_BITS))) % (1 << PHASE_BITS)

    def phase_from_word(self, word: int) -> float:
        return 2 * np.pi * (int(word) % (1 << PHASE_BITS)) / (1 << PHASE_BITS)

    def get_amp_word(self, amplitude: float) -> int:
        if not 0 <= amplitude <= 1:
            raise ValueError(f'amplitude {amplitude} must be in [0, 1]')
        return int(np.round(amplitude * ((1 << AMP_BITS) - 1)))

    def amp_from_word(self, word: int) -> float:
        return int(word) / ((1 << AMP_BITS) - 1)

    def get_cfg_word(self, elem_ind: int, mode_bits: int | None) -> int:
        if mode_bits is None:
            mode_bits = 0
        return ((mode_bits & 0b11) << 2) | (elem_ind & 0b11)

    def length_nclks(self, tlength: float) -> int:
        return int(np.ceil(tlength / self.fpga_clk_period))

    # -- envelope buffer --------------------------------------------------

    def get_env_word(self, env_start_ind: int, env_length: int) -> int:
        addr = env_start_ind // ENV_BANKS
        length = int(np.ceil(env_length / ENV_BANKS))
        if addr >= 1 << ENV_ADDR_BITS:
            raise ValueError('envelope memory overflow')
        if length >= ENV_CW_SENTINEL:
            raise ValueError('envelope too long')
        return (length << ENV_ADDR_BITS) | addr

    def get_cw_env_word(self, env_start_ind: int) -> int:
        return (ENV_CW_SENTINEL << ENV_ADDR_BITS) | (env_start_ind // ENV_BANKS)

    def env_word_fields(self, env_word: int) -> tuple[int, int, bool]:
        """Return (start_sample, n_samples, is_cw) from a 24-bit env word."""
        addr = env_word & ((1 << ENV_ADDR_BITS) - 1)
        length = (env_word >> ENV_ADDR_BITS) & ((1 << ENV_LEN_BITS) - 1)
        return addr * ENV_BANKS, length * ENV_BANKS, length == ENV_CW_SENTINEL

    def get_env_buffer(self, env) -> np.ndarray:
        """Quantise an envelope (array or paradict) to the packed IQ buffer."""
        if isinstance(env, str) and env == 'cw':
            return np.zeros(0, dtype=np.uint32)
        if isinstance(env, dict):
            env = sample_env(env, self.env_sample_freq)
        env = np.asarray(env)
        if np.any(np.abs(np.real(env)) > 1) or np.any(np.abs(np.imag(env)) > 1):
            raise ValueError('envelope samples must lie within the unit square')
        # pad to a whole number of bank groups
        pad = (-len(env)) % ENV_BANKS
        if pad:
            env = np.concatenate([env, np.zeros(pad, env.dtype)])
        return pack_iq(np.real(env) * IQ_SCALE, np.imag(env) * IQ_SCALE)

    # -- frequency buffer -------------------------------------------------

    def get_freq_buffer(self, freqs) -> np.ndarray:
        """Build the NCO frequency buffer: 16 uint32 words per frequency."""
        words = np.zeros(FREQ_BUF_WORDS * len(freqs), dtype=np.uint32)
        for n, freq in enumerate(freqs):
            if freq is None:
                continue
            base = n * FREQ_BUF_WORDS
            words[base] = np.uint32(int(np.round(
                (freq / self.sample_freq) * 2 ** 32)) % (1 << 32))
            k = np.arange(1, FREQ_BUF_WORDS)
            ph = 2 * np.pi * freq * k / self.sample_freq
            words[base + 1:base + FREQ_BUF_WORDS] = pack_iq(
                np.cos(ph) * IQ_SCALE, np.sin(ph) * IQ_SCALE)
        return words

    def get_freq_addr(self, freq_ind: int) -> int:
        if freq_ind >= 1 << FREQ_ADDR_BITS:
            raise ValueError('frequency buffer overflow')
        return freq_ind

    def freq_from_buffer(self, freq_buffer: np.ndarray, freq_addr: int) -> float:
        entry = np.asarray(freq_buffer, dtype=np.uint32)[
            freq_addr * FREQ_BUF_WORDS]
        return float(entry) / 2 ** 32 * self.sample_freq


def parse_env_buffer(buf) -> np.ndarray:
    """Decode a packed env buffer (bytes or uint32 array) to complex IQ."""
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, dtype=np.dtype(np.uint32).newbyteorder('<'))
    return unpack_iq(buf)


def parse_freq_buffer(buf, fsamp: float) -> dict:
    """Decode a freq buffer: returns {'freq': array, 'iq15': array[n, 15]}."""
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, dtype=np.dtype(np.uint32).newbyteorder('<'))
    entries = np.asarray(buf, dtype=np.uint32).reshape(-1, FREQ_BUF_WORDS)
    freq = entries[:, 0].astype(np.float64) / 2 ** 32 * fsamp
    return {'freq': freq, 'iq15': unpack_iq(entries[:, 1:])}
