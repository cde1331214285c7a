"""distributed_processor_tpu_torch: the PyTorch + CUDA port of
``distributed_processor_tpu``.

The JAX package beside it is the reference; this package imports
neither JAX nor anything of it, and keeps its own copy of the numpy
compile stack.  Layers, named as in the JAX package:

* :mod:`.isa`, :mod:`.hwconfig`, :mod:`.elements`, :mod:`.envelopes`,
  :mod:`.qchip`, :mod:`.ir`, :mod:`.compiler`, :mod:`.assembler`,
  :mod:`.decoder`, :mod:`.pipeline`, :mod:`.models` — the compile stack
  (copied numpy code): dict program -> ``MachineProgram``
* :mod:`.sim.interpreter` — the engine ladder, the batched generic ISA
  engine and the straight-line engine in torch
* :mod:`.sim.physics` — the physics-closed epoch loop (parity device)
* :mod:`.ops.exec_span` — the span kernels K1 and K3 (hand-written CUDA,
  ``csrc/exec_span.cu``), whose plain version is the straight-line engine
* :mod:`.ops.resolve` — the readout resolver: a hand-written CUDA kernel
  (``csrc/resolve.cu``) and its plain torch version
* :mod:`.ops.waveform` — element waveform synthesis: the kernel K4
  (``csrc/waveform.cu``: one launch renders every trace of a shot from
  the run's records) and its plain torch version
* :mod:`.ops.demod` — readout demodulation, the kernel K5
  (``csrc/demod.cu``) and its plain version, and state discrimination
* :mod:`.ops.fabric` — the syndrome LUT of the ``'lut'`` measurement
  fabric (``MeasLUT``), which every engine serves time-indexed
* :mod:`.models.readout` — sampled measurement bits and IQ clouds;
  :mod:`.models.repetition`, :mod:`.models.qec` — the QEC workloads on
  the ``'lut'`` fabric
* :mod:`.frontend` — the OpenQASM 3 front end (text -> dict program);
  :mod:`.compilecache` — the content-addressed compile cache behind
  :func:`~.pipeline.cached_compile_to_machine`; :mod:`.integrity` — the
  content digests the cache's store checks
* :mod:`.simulator` — the ``Simulator`` facade: compile (dict program or
  OpenQASM 3 text), run, render waveforms, demodulate
* :mod:`.sim.grad` — differentiable calibration losses on torch autograd
* :mod:`.obs`, :mod:`.utils.profiling` — the metrics registry and its
  counters, the profiler wrappers; :mod:`.utils.vcd` — a ``trace=True``
  run as a VCD file
* :mod:`.parallel` — per-batch statistics, sweeps and the device meshes
* :mod:`.serve` — the in-process ``ExecutionService`` and, one ring out,
  the ``Fleet`` of replica processes behind the ``FleetRouter`` on the
  fleet wire; :mod:`.calib` — the closed calibration loop
* :mod:`.cli` — the command line, ``python -m
  distributed_processor_tpu_torch`` (``--torch-device cpu`` off the card)

Entry points (``Simulator``, ``simulate``, ``simulate_batch``,
``run_physics_batch``, ``run_physics_sweep``) run on CUDA unless given
``device=``.
"""

__version__ = '0.1.0'

from . import isa
from . import compilecache
from .hwconfig import FPGAConfig, load_channel_configs
from .elements import TPUElementConfig
from .qchip import QChip
from .compiler import Compiler, CompilerFlags, get_passes
from .assembler import GlobalAssembler
from .decoder import (MachineProgram, decode_assembled_program,
                      machine_program_from_arrays, machine_program_to_arrays)
from .pipeline import compile_program, compile_to_machine
from .simulator import Simulator
