"""User-facing facade: compile, execute, and render programs.

Counterpart of the JAX package's ``simulator.py``:

    dict program / OpenQASM 3
        -> Compiler (IR passes) -> GlobalAssembler -> decoder
        -> the torch ISA interpreter (shots batched on the device)
        -> element waveform synthesis / readout demod (ops/)

Example::

    sim = Simulator(n_qubits=2, device='cpu')
    out = sim.run([{'name': 'X90', 'qubit': ['Q0']},
                   {'name': 'read', 'qubit': ['Q0']}])
    wf = sim.waveforms(out)          # per-core per-element I/Q traces

The facade runs on CUDA unless given ``device=``.  There,
:meth:`Simulator.waveforms` renders every element of a shot in one launch
of the waveform kernel and :meth:`Simulator.demod_readout` demodulates
with the demod kernel; on the CPU both take the kernels' plain versions.
"""

from __future__ import annotations

import warnings
from dataclasses import replace

import numpy as np
import torch

from .hwconfig import FPGAConfig
from .decoder import MachineProgram
from .pipeline import compile_to_machine
from .models.channels import make_channel_configs
from .models.coupling import couplings_from_qchip
from .models.default_qchip import make_default_qchip
from .models.readout import make_generator, sample_meas_bits
from .sim.interpreter import (ERR_PULSE_OVERFLOW, InterpreterConfig,
                              simulate, simulate_batch,
                              torch_device)
from .ops.waveform import (default_n_clks, render_shot, render_table,
                           shot_records, split_traces)
from .ops.demod import demod_iq


def _ndim(x) -> int:
    return x.ndim if hasattr(x, 'ndim') else np.ndim(x)


class Simulator:
    """Compile-and-execute facade for N-qubit programs."""

    def __init__(self, qchip=None, n_qubits: int = 8, channel_configs=None,
                 fpga_config: FPGAConfig = None, device=None):
        self.device = torch_device(device)
        self.n_qubits = n_qubits
        self.qchip = qchip or make_default_qchip(n_qubits)
        self.channel_configs = channel_configs or make_channel_configs(n_qubits)
        self.fpga_config = fpga_config or FPGAConfig(n_cores=n_qubits)

    # -- compilation -----------------------------------------------------

    def compile(self, program) -> MachineProgram:
        """Compile a dict program or OpenQASM 3 source string."""
        if isinstance(program, str):
            from .frontend import qasm_to_program
            program = qasm_to_program(program)
        return compile_to_machine(program, self.qchip,
                                  channel_configs=self.channel_configs,
                                  fpga_config=self.fpga_config)

    def interpreter_config(self, mp: MachineProgram,
                           **kw) -> InterpreterConfig:
        """Sized-to-the-program interpreter config.

        Budgets come from static loop analysis
        (:meth:`~.decoder.MachineProgram.static_bounds`): counter loops
        the compiler emits are sized exactly; unanalyzable back-edges
        get a bounded fallback.  Pass ``max_steps``/``max_pulses``
        explicitly for programs whose iteration counts are data-driven.
        """
        kw.pop('has_loops', None)       # superseded by static analysis
        defaults = dict(max_meas=16, max_resets=4)
        if 'max_steps' not in kw or 'max_pulses' not in kw:
            bounds = mp.static_bounds()
            defaults.update(
                max_steps=bounds['max_steps'],
                max_pulses=min(bounds['max_pulses'], 4096))
        defaults.update(kw)
        return InterpreterConfig.from_fpga_config(self.fpga_config,
                                                  **defaults)

    # -- execution -------------------------------------------------------

    def run(self, program, shots: int = 1, meas_bits=None, p1=None,
            key=None, init_regs=None, physics=None, **cfg_kw) -> dict:
        """Compile (if needed) and execute ``shots`` shots on the
        facade's device.

        Measurement bits come from (in priority order) ``physics`` (a
        :class:`~.sim.physics.ReadoutPhysics` — bits emerge in-sim from
        synthesized + demodulated readout windows, nothing injected),
        ``meas_bits`` (``[shots, n_cores, n_meas]``), Bernoulli sampling
        with per-qubit probabilities ``p1``, or zeros.  ``key`` seeds the
        sampling and the physics: an int (default 0) or, for ``p1``, a
        ``torch.Generator`` on the facade's device.  The result dict
        holds tensors on the device and carries the machine program under
        ``'_mp'`` and the effective config under ``'_cfg'``.
        """
        mp = program if isinstance(program, MachineProgram) \
            else self.compile(program)
        cfg = self.interpreter_config(mp, **cfg_kw)
        if physics is not None:
            if meas_bits is not None or p1 is not None:
                raise ValueError(
                    'physics= resolves measurement bits in-sim; '
                    'meas_bits=/p1= cannot also be given')
            from .sim.physics import (physics_config, run_physics_batch,
                                      statevec_step_budget)
            if physics.device.kind == 'statevec':
                if not physics.device.couplings:
                    # derive the (core, freq-word) -> (target, kind)
                    # coupling map from this program + gate library, so
                    # CNOT/CZ calibrations entangle without manual wiring
                    physics = replace(physics, device=replace(
                        physics.device,
                        couplings=couplings_from_qchip(mp, self.qchip)))
                if 'max_steps' not in cfg_kw:
                    cfg = statevec_step_budget(cfg, physics, mp.n_cores)
            if isinstance(key, torch.Generator):
                raise ValueError('physics= takes an int seed as key=')
            out = dict(run_physics_batch(
                mp, physics, 0 if key is None else int(key), shots,
                init_regs=init_regs, cfg=cfg, device=self.device))
            self._warn_truncation(out, cfg)
            out['_mp'] = mp
            out['_cfg'] = physics_config(cfg, physics)  # effective config
            return out
        if meas_bits is None and p1 is not None:
            gen = make_generator(0 if key is None else key, self.device)
            meas_bits = sample_meas_bits(
                gen, np.broadcast_to(np.asarray(p1, np.float32),
                                     (mp.n_cores,)),
                shots, cfg.max_meas)
        if shots == 1 and (meas_bits is None or _ndim(meas_bits) == 2):
            out = dict(simulate(mp, meas_bits=meas_bits,
                                init_regs=init_regs, cfg=cfg,
                                device=self.device))
        else:
            if meas_bits is None:
                meas_bits = np.zeros((shots, mp.n_cores, cfg.max_meas),
                                     np.int32)
            out = dict(simulate_batch(mp, meas_bits, init_regs=init_regs,
                                      cfg=cfg, device=self.device))
        self._warn_truncation(out, cfg)
        out['_mp'] = mp
        out['_cfg'] = cfg
        return out

    @staticmethod
    def _warn_truncation(out: dict, cfg) -> None:
        """A run that exhausted its step or pulse budget is truncated,
        not merely erroneous — say so loudly instead of leaving a quiet
        error bit."""
        if bool(out.get('incomplete', False)):
            warnings.warn(
                f'run truncated: not all shots finished within max_steps='
                f'{cfg.max_steps}; results are partial — raise max_steps '
                f'(data-driven loops cannot be sized statically)',
                RuntimeWarning, stacklevel=3)
        if bool((out['err'] & ERR_PULSE_OVERFLOW).any()):
            warnings.warn(
                f'pulse records truncated: a core emitted more than '
                f'max_pulses={cfg.max_pulses} pulses; raise max_pulses',
                RuntimeWarning, stacklevel=3)

    # -- rendering -------------------------------------------------------

    def waveforms(self, out: dict, shot: int = None, n_clks: int = None,
                  cores=None) -> dict:
        """Render element output traces from a run's pulse records.

        ``out``: a run's result — this package's (tensors) or one whose
        records are numpy arrays, such as a JAX-package run carried
        across; only ``'_mp'`` must be this package's ``MachineProgram``.
        Returns ``{core_ind: [trace_elem0, trace_elem1, ...]}`` where each
        trace is a numpy ``float32 [n_samples, 2]`` I/Q array, rendered on
        the facade's device: on CUDA one waveform-kernel launch for every
        trace of the shot, from the records where they lie, and one copy
        of the traces to the host.  For batched runs pass ``shot`` to
        select one shot.
        """
        mp: MachineProgram = out['_mp']
        if 'rec_gtime' not in out:
            raise ValueError(
                'run has no pulse records (record_pulses=False was set); '
                'rendering needs a run with record_pulses=True')
        if shot is None and _ndim(out['n_pulses']) == 2:
            raise ValueError(
                'batched run: pass shot= to select which shot to render '
                '(n_pulses has a leading shot axis)')
        if n_clks is None:
            n_clks = default_n_clks(out, shot)
        table = render_table(mp, cores, self.device)
        flat = render_shot(shot_records(out, shot, table.traces.device),
                           table, n_clks)
        return split_traces(flat.cpu().numpy(), table, n_clks)

    def demod_readout(self, out: dict, adc_traces, windows) -> torch.Tensor:
        """Demodulate external ADC traces ``[S, N]`` against
        per-measurement windows (``[N, 2M]`` weight matrix) on the
        facade's device — see :mod:`.ops.demod`.  Returns ``[S, M, 2]``."""
        adc = torch.as_tensor(adc_traces).to(self.device)
        return demod_iq(adc, windows)
