"""Measurement-distribution fabric: the syndrome LUT.

Counterpart of the JAX package's ``ops/fabric.py``, and of the
reference's ``meas_lut`` gateware (reference: hdl/meas_lut.sv,
hdl/fproc_lut.sv): the measurement bits of a masked set of input cores
form a table address, and the table returns one output bit per core.
Where the gateware hard-codes the mask and table (reference:
hdl/meas_lut.sv:16-20), this takes them as arrays and gathers over the
shot axis.  The interpreter engines serve the same time-indexed read
inline (sim/interpreter.py, csrc/exec_span.cu); this class is its
stand-alone form.
"""

from __future__ import annotations

import numpy as np
import torch


class MeasLUT:
    """Configurable syndrome LUT over ``n_cores`` measurement bits.

    ``input_mask``: bool ``[n_cores]`` — which cores' bits form the
    address (bit i of the address is the i-th set core, LSB first).
    ``table``: int ``[2^k]`` — each entry is an n_cores-wide bitmask of
    output bits (one per core), the gateware's ``lut_mem``.  Both may be
    numpy arrays or tuples (an ``InterpreterConfig``'s ``lut_mask`` /
    ``lut_table``).  ``device``: where the table lives (default CUDA, as
    for the entry points; the inputs of a call must lie there too)."""

    def __init__(self, input_mask, table, device=None):
        from ..sim.interpreter import torch_device
        self.input_mask = np.asarray(input_mask, bool)
        table = np.asarray(table, np.int64)
        k = int(self.input_mask.sum())
        if len(table) != 1 << k:
            raise ValueError(f'table must have 2^{k} entries, got {len(table)}')
        self.device = torch_device(device)
        # the table as int32 bit patterns (an entry of 32 cores wraps)
        self.table = torch.as_tensor(table.astype(np.uint32).view(np.int32),
                                     device=self.device)
        # address bit position per core (0 for unmasked cores); one weight
        # per core folds mask and shift: sum(bits * weight)
        self._addr_shift = np.zeros(len(self.input_mask), dtype=np.int32)
        self._addr_shift[self.input_mask] = np.arange(k)
        weights = self.input_mask.astype(np.int64) << self._addr_shift
        self._addr_weights = torch.as_tensor(
            weights.astype(np.uint32).view(np.int32), device=self.device)
        self._bit_shifts = torch.arange(len(self.input_mask),
                                        dtype=torch.int32,
                                        device=self.device).clamp(max=31)

    @classmethod
    def from_fpga_config(cls, fpga_config, device=None) -> 'MeasLUT':
        """The LUT of :class:`~..hwconfig.FPGAConfig`'s ``meas_lut_mask``
        / ``meas_lut_table`` fields (the writable analog of the
        gateware's contents, reference: hdl/meas_lut.sv:16-20).  Raises
        when the config carries no LUT."""
        if not fpga_config.meas_lut_mask:
            raise ValueError(
                'FPGAConfig has no meas LUT configured (meas_lut_mask is '
                'empty); set meas_lut_mask + meas_lut_table')
        return cls(fpga_config.meas_lut_mask, fpga_config.meas_lut_table,
                   device=device)

    def _int(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def address(self, bits) -> torch.Tensor:
        """bits ``[..., n_cores]`` -> table address ``[...]`` int32."""
        prod = self._int(bits).long() * self._addr_weights.long()
        s = prod.sum(-1)
        return (((s + 2**31) & 0xffffffff) - 2**31).to(torch.int32)

    def __call__(self, bits) -> torch.Tensor:
        """bits ``[..., n_cores]`` -> per-core LUT output bits, same
        shape."""
        addr = self.address(bits).clamp(0, len(self.table) - 1)
        entry = self.table[addr.long()]
        return (entry[..., None] >> self._bit_shifts) & 1

    def sharded_call(self, bits, group, axis: int = -1):
        """``__call__`` for bits sharded over the ranks of a mesh axis
        (``group``: ``mesh.get_group('cores')``): all-gathers every
        rank's slice of the core axis ``axis`` (in rank order, the
        mesh-axis order, so the concatenation is the replicated layout),
        then runs the ordinary table gather.  Returns the FULL-width
        output on every rank — callers slice out their own cores."""
        from ..parallel.mesh import gather_cat
        return self(gather_cat(self._int(bits), group, axis))

    def timed_call(self, bit_planes, time_planes, n_meas, read_time):
        """Time-indexed LUT read — the semantics the engines serve.

        Per masked producer, select the newest bit PRODUCED strictly
        before the read's service time: with ``bit_planes`` ``[...,
        n_cores, n_slots]`` (per-slot bits), ``time_planes`` the same
        shape (per-slot production clocks, ``INT32_MAX`` where
        unwritten), ``n_meas`` ``[..., n_cores]`` (slots recorded) and
        ``read_time`` ``[...]``, the served slot of producer ``p`` is
        ``max(#{m < n_meas_p : t_pm < read_time}, 1) - 1`` — a count of 0
        falls back to slot 0, the first recorded bit (the gateware's
        arm-then-accumulate ``LUT_WAIT``).  Strict ``<``: a producer
        whose clock sits exactly at ``read_time`` can still fire there.

        Returns ``(out_bits, slot)``: per-core LUT output bits ``[...,
        n_cores]`` and the selected slot per producer ``[...,
        n_cores]``."""
        bit_planes = self._int(bit_planes)
        time_planes = self._int(time_planes)
        n_meas = self._int(n_meas)
        M = bit_planes.shape[-1]
        m = torch.arange(M, dtype=torch.int32, device=self.device)
        rec = m < n_meas[..., None]
        early = rec & (time_planes < self._int(read_time)[..., None, None])
        cnt = early.sum(-1, dtype=torch.int32)
        slot = (cnt - 1).clamp(min=0)
        bits = bit_planes.gather(-1, slot.long()[..., None])[..., 0]
        return self(bits), slot
