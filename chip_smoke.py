"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. environment: the card's name and power limit, and the build of every
   CUDA kernel of the port from ``distributed_processor_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together, beside the ``g++``
   build of the native command codec ``native/soa_codec.cpp``);
2. first the port's kernel self-test (``ops.selftest``, the JAX
   package's ``pallas_parity_check`` on its own inputs and tolerances):
   K5 and K4 against their plain versions, K1 span, K1 block and K3
   against the generic engine, each check timed with its launches, then
   ``kernel_parity_check('cuda')`` whole; then
   each kernel against its plain torch version on the card, at the
   shapes its path gives it, with its time beside the plain version's and
   its bound: the resolver K2 (sigma = 0, identical streamed noise, and
   the kernel's own Philox noise held to CLT bounds), and K2 with AR(1)
   noise (on the same streamed whites, and its own draws against the
   projection's closed-form variance; one epoch timed beside the white
   kernel); the span kernel K1
   (``engine='pallas'``) against the straight-line engine on seeded
   injected bits, then its tile kernel and its one-thread-per-lane
   kernel (K3's, the design before the tile) held to each other and
   timed on the same inputs, CUDA events around the wrapper and device
   time under the profiler; the span kernel K3
   (``engine='fused'``) against its plain version and against the
   generic engine at sigma = 0, with both times; K3's physics pass with
   its readout left to K2 (the main path's exec hop) against the
   straight-line engine's eager pass, both passes of a headline batch,
   with both times; the statevec step (``ops.statevec.statevec_pulse``,
   ``csrc/statevec.cu``: one launch a step of the generic engine's
   statevec block) against the eager block on one step of 131072 shots
   on 8 cores with the parity scan's channels, both timed beside the
   kernel's bound; the
   waveform kernel K4 rendering every (core, element) trace of a headline
   shot in one launch, and a 1,048,576-sample capture (64 seeded pulses,
   one CW, one overrunning its table, interp 1 and 16) as a one-trace
   call; the demod kernel K5 at
   [262144, 1024] @ [1024, 8], at a ragged shot count and at 2M = 2, with
   ``torch.matmul`` timed beside it as the library's call; K1 block
   (``engine='pallas'`` on the looped headline, the headline inside the
   on-device shot loop) against the plain block engine at 32768 lanes x
   8 iterations and, with records and the opcode histogram, at 4096
   lanes, then each launch of a batch replayed against the plain bodies
   and the one-thread-per-lane kernel against the tile kernel, each
   kernel's batch timed both ways;
3. the paths at full width, each driven with every launch count set to 0
   just before it and read just after: the main path (the headline
   program, 8-qubit active reset + depth-12 RB, compiled by the port and
   run physics-closed by ``run_physics_batch`` at 262144 shots; its
   config resolves to the straight-line engine, whose pass is one launch
   of K3's physics pass an epoch, and the generic engine's batch is timed
   beside it), the K1 path (``simulate_batch`` with
   ``engine='pallas'``, then ``'auto'``) and the K3 path
   (``run_physics_batch`` with ``engine='fused'``, sigma = 0), and the
   render-and-readout path (``Simulator``: compile, run 4096 shots with
   pulse records, ``waveforms`` of a measured-1 and a measured-0 shot —
   one K4 launch each for all 24 traces, held against the CPU's plain
   render, and 20 more renders timed — then
   262144 noisy ADC traces of the rendered readout window through
   ``demod_readout`` — one K5 launch — and ``discriminate``), and the
   loop path (the looped headline through ``simulate_batch`` with
   ``engine='pallas'``, then ``'auto'``: one K1 block launch per
   block-engine iteration, outputs equal to the block and generic
   engines; the three engines' steady batches profiled; the physics batch
   at sigma = 0.05 on the block engine with K2 per epoch; and the loop at
   sigma = 0 on the card against the CPU); then the three paths of the
   ``'lut'`` measurement fabric (the syndrome LUT), each at 262144 shots:
   the span path (the 8-core repetition round and the 9-core surface
   cycle on seeded injected bits through ``engine='pallas'`` and
   ``'auto'``, one K1 launch each, every key equal to the straight-line
   engine's and each core's corrections the table's; the tile kernel,
   the one-thread-per-lane kernel and the plain version timed on one
   carry beside the bound restated for the LUT reads), the block path
   (8 unrolled QEC rounds on 8 cores through ``engine='pallas'``: one K1
   block launch per block-engine iteration, equal to the plain block
   engine) and the physics path (the compiled 8-qubit repetition round
   over all 256 initial patterns on ``engine='fused'``, K3 with the LUT
   read in one launch, every core corrected to its majority and equal to
   the generic engine; then sigma = 0.05 on the straight-line engine with
   K2 per epoch);
   then the physics models at the headline's width: the readout models
   (the analytic closed form, AR(1) ADC noise on K2's AR(1) mode, the
   resonator ring-up, CW readout at the finite window's horizon with
   bits identical to the finite program's), the bloch path (the headline
   with the Bloch device on the straight-line engine + K2, then card =
   CPU at 4096 shots) and the statevec path (GHZ-8 on the generic engine
   + K2, one statevec kernel launch a step, shot-exact parity; 2-qubit
   interleaved RB with leakage and IQ-level 3-class readout at 262144
   shots), each with its steady
   batch's wall, epochs, K2 launches and device ms and the device's idle
   share; then the program-ensemble path (16 distinct random RB
   sequences, 8 qubits, depth 12, as one ``simulate_multi_batch`` over
   16 x 16384 = 262144 lanes of the generic engine, each program's view
   equal to the program alone, the wall beside 16 sequential calls', and
   ``run_multi_sweep`` over 2 batches equal to the sum of its batches);
   the streaming-rounds path (``simulate_rounds`` at 32 rounds x 8192
   shots on the repetition round and the surface cycle with their
   decodes, one K1 span launch each under ``'pallas'`` and ``'auto'``,
   equal to 32 sequential straight-line batches, the decode held to the
   LUT oracles; the looped headline at 4 x 8192, one K1 block launch per
   block-engine iteration, equal to 4 sequential block-engine batches;
   each call's wall beside its sequential calls'); and the analysis
   fits (T1, RB and Ramsey on the card = on the CPU, and
   ``calibrate_readout`` at 262144 shots with fidelity > 0.99); then
   the OpenQASM 3 front door (the headline as QASM text through
   ``Simulator.compile`` and ``cached_compile_to_machine`` — a cold miss,
   a warm hit, a disk hit — with their host milliseconds, then
   ``run_physics_batch`` at 262144 shots: sigma = 0.05 with K2 once per
   epoch, sigma = 0 on ``engine='fused'`` in one K3 launch; card = CPU at
   sigma = 0, every key equal to the dict headline's run where the bytes
   are equal), differentiable physics (``grad_loss`` of each knob card =
   CPU to rtol 1e-5, one ``grad_loss_batch`` of 4096 candidates per knob
   timed beside sequential calls) and trace mode (the headline with
   ``trace=True`` at 4096 shots on the generic engine, every key card =
   CPU, one shot through ``write_vcd``); then the serving tier
   (``ExecutionService`` on the card: 64 RB requests of 16384 shots from
   4 submitter threads coalesced into batches of up to 16 programs, each
   result equal to a direct ``simulate_batch``, beside the same requests
   as sequential calls; headline requests on K1 span and the looped
   headline on K1 block through ``singleton_engine``; a rounds chunk on
   the span rung and a streaming session; the QASM headline through
   ``submit_source``; a service warmed from the learned catalog; a chaos
   soak; no service thread left) and the closed calibration loop
   (``calibrate`` on the amplitude through a service on the card, equal
   in steps to the same loop on the CPU); then the multi-process serving
   tier (``Fleet`` of two replica processes on the card, each with its
   own CUDA context, behind the router of this process: the serve
   phase's RB requests routed again, each equal to its in-process
   result; a soak through a SIGKILL of the loaded replica, every
   completion equal to its solo run, goodput inside the kill window,
   the respawned replica warm after its catalog replay; a SIGSTOP caught
   by gossip staleness and a SIGCONT re-admitted, at the router's
   default 250 ms liveness window (gossip has a connection of its own
   to each replica, apart from the result frames); headline requests on
   K1 span and the looped headline on K1 block through a second fleet,
   each equal to its direct call; no thread or replica process left) and
   the command line (``cli.main``: ``run`` of the QASM headline with K2
   per epoch and on K1 span, of the looped headline on K1 block,
   ``sweep`` of 1M shots, ``warmup``, ``serve-bench``, ``fleet-status``
   against a live fleet, each with its launches; ``python -m
   distributed_processor_tpu_torch run`` in a process of its own equal
   to the in-process call); then the tooling (the native codec on the
   headline's command buffers equal to the Python codec; the eleven
   goldens equal to ``tests/goldens/*.json``; the fault-injection fuzz
   over 35 mutants with K1 span and K1 block as a fourth engine, and the
   feedback (K1), fused (K3), vmap and audit consistency checks, none
   failing; K1 span, K1 block and K3 each launched; the headline's
   ``carry_stream_bytes`` beside the bytes K1's bound counts);
4. the headline on CUDA and on the CPU in the port, at sigma = 0 with
   explicit initial states: bits and statistics identical, and the
   three ``'lut'`` paths, ``simulate_rounds`` with the decode and
   ``simulate_multi_batch`` at a small batch;
5. a 1M-shot sweep (``run_physics_sweep``, 4 x 262144 shots) at span 1
   and span 4 (identical sums), and resumed from a 2-batch checkpoint
   (identical to the uninterrupted sweep);
6. the mesh paths at world size 1 (a one-rank NCCL group), each with
   its launches: ``run_physics_sweep(mesh=)`` (K2), ``sweep_stat_sums``
   with ``engine='pallas'`` (K1 span), ``sharded_demod`` (K5) and
   ``sharded_cores_simulate(engine='block')`` at cores = 1 (K1 block),
   each equal to its single-device run;
7. two ranks sharing the card over gloo, each this script run again in
   its rank mode (``--rank R --world 2 --init URL --out DIR``): the
   8-core ``lut`` repetition round at 262144 shots on a cores mesh of 2
   (its first call, then a steady one), and the headline sweep at
   dp = 2, both equal to the single-process runs, and the
   fault-injection harness's ``check_mesh_consistency`` at dp = 2 (no
   mismatched fault code).

``python3 chip_smoke.py --ranks N`` builds the kernels and runs only
phase 7 on N ranks: a card per rank over NCCL on a host with N cards,
else gloo on shared cards.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX.  Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def check(cond, msg: str):
    if not cond:
        fail(msg)


# peak rates of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# issue rates of one H100 SXM per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0): 128
# 32-bit instructions (float32 add/multiply/FMA, logic, shifts), 64
# 32-bit integer multiplies, 16 special-function operations (log2, rsqrt,
# sqrt, sin, cos); 132 SMs at the 1.98 GHz boost clock (NVIDIA H100 data
# sheet)
H100_SMS, H100_CLOCK_HZ = 132, 1.98e9
ISSUE_PER_CLK, IMUL_PER_CLK, SFU_PER_CLK = 128, 64, 16
# K2's work per noisy sample, whatever implements it (csrc/resolve.cu):
# half a Philox4x32-10 call (10 32x32->64-bit multiplies and 10
# three-way xors), Box-Muller (2 uniforms from random bits, 3 shifts and
# ors each; log, sqrt, sin and cos on the special-function unit; the log's
# scale, the angle and 2 radius products) and the 4-FMA projection onto
# the window's carrier: 38 instructions, 4 of them special-function
# operations, 10 multiplies; per window: its scalars, the row select, the
# prefix reads, the deterministic products and the warp's reduce, ~32
K2_SAMPLE_INSTR, K2_SAMPLE_SFU, K2_SAMPLE_IMUL = 38, 4, 10
K2_WINDOW_INSTR = 32
# what AR(1) noise adds to the function, per noisy sample: the
# recursion n_t = rho n_(t-1) + c w_t, one FMA per stream (the scale c
# folds into Box-Muller's radius product): 2 instructions; the bound
# counts these only
K2_AR1_SAMPLE_INSTR = 2
# what K2's warp scan spends on it (csrc/resolve.cu ar1_window), per lane
# iteration of 2 samples and both streams: 5 compose steps of 2 shuffles,
# 2 FMAs and a select (25), the pair's map (4), the even sample's 2
# shuffles and 4 operations (6) and the carry broadcast (2 shuffles): 37
# instructions, 14 of them shuffles, per 2 samples; warp shuffles issue
# at 32 per clock per SM (CUDA C++ Programming Guide, compute capability
# 9.0).  Printed as the design's own cost, not part of the bound
K2_AR1_SCAN_INSTR, K2_AR1_SCAN_SHFL = 19, 7
SHFL_PER_CLK = 32
# K1's work is 32-bit integer add, compare and logic, which compute
# capability 9.0 issues at 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 132 x 64 x 1.98e9 = 1.67e13
# per second; every instruction, integer or float32, at 128 per clock
# per SM
INT_PER_CLK = 64
PEAK_INT32_OPS = H100_SMS * INT_PER_CLK * H100_CLOCK_HZ
PEAK_ISSUE = H100_SMS * ISSUE_PER_CLK * H100_CLOCK_HZ
# 32-bit integer operations per retired row of the megastep kernels
# (csrc/exec_span.cu: decode and dispatch, ALU, pulse latch and trigger,
# next pc/time); per K3 measurement, the discriminator's 21 float32
# operations and one read of the window's energy prefix
SPAN_OPS_PER_INSTR, DISCRIMINATE_OPS = 40, 21

# float32 operations per in-window sample of the waveform kernel
# (csrc/waveform.cu): the NCO multiply-add and convert, a sincos (~30),
# the amplitude divide and the complex product
WAVE_OPS = 40

HEADLINE = dict(n_qubits=8, depth=12, batch=262144, sweep_batches=4,
                sigma=0.05, p1_init=0.15, resolve_chunk=256,
                render_shots=4096, adc_sigma=0.5)
# the looped headline: the headline's body inside the on-device shot loop
# (8 iterations: the loop is a do-while on `ge`), at the headline's batch
# of shots, 32768 lanes x 8 iterations; records and the CUDA-vs-CPU check
# at smaller batches
LOOP = dict(n_shots=7, batch=32768, record_batch=4096, cpu_batch=1024,
            max_meas=16, max_resets=2, sigma=0.05)
# K2's synthetic tables: four static rows (the last two run past the
# 64-sample envelope into its held last sample), two carrier frequencies
# and mixed interpolation per core
SYNTH = dict(rows=(0, 8, 28, 40), n_freqs=2, env_len=64,
             interps=(4, 2, 1, 4, 2, 1, 4, 2))
# K4's long capture: a trace the render never reaches
CAPTURE = dict(n_clks=65536, spc=16, n_pulses=64, env_len=1024)
# the 'lut' fabric's paths (the syndrome LUT, hdl/fproc_lut.sv +
# meas_lut.sv): the repetition round on 8 cores (a 256-entry majority
# LUT), the distance-5 surface cycle (9 cores, 4 ancillas masked, a
# 16-entry chain-matching LUT), 8 unrolled QEC rounds on 8 cores (block
# mode), all at 262144 shots; the CUDA-vs-CPU check at a small batch
LUT = dict(batch=262144, n_data=8, distance=5, rounds=8, cpu_batch=256)
# program ensembles (bench.py's multi_sequence_rb at the headline's width):
# 16 distinct random RB sequences x 16384 shots = 262144 lanes, a sweep of
# 2 batches; the CUDA-vs-CPU check at a small batch
MULTI = dict(n_seqs=16, shots=16384, sweep_batches=2, cpu_shots=64)
# streaming rounds: 32 rounds x 8192 shots = 262144 lanes on the 'lut'
# span workloads, the looped headline at 4 x 8192 (the loop path's 32768
# lanes); the majority decode checked against the LUT walk on a seeded
# sample of shots; the CUDA-vs-CPU check at a small batch
ROUNDS = dict(rounds=32, shots=8192, loop_rounds=4, oracle_shots=1024,
              cpu_shots=64)
# readout calibration at the headline's channel responses g0, g1 with IQ
# clouds of this sigma (a fidelity of Phi(|g1 - g0| / (2 sigma)) = 0.9986)
CALIB = dict(shots=262144, sigma=0.3)
# the integer operations of a LUT read beyond a row's SPAN_OPS_PER_INSTR
# (csrc/exec_span.cu lut_read): per masked producer and slot, two
# compares, an and and an add (the time-indexed count); per masked
# producer its count read and test, the slot select, three loads, the
# unwritten-availability test and select, a max, a shift and an add; per
# read the table bounds test and load, a shift, an and and the max with
# the request
LUT_SLOT_OPS, LUT_PRODUCER_OPS, LUT_READ_OPS = 4, 12, 8
# the physics models at the headline's width: K2's AR(1) pole; the
# readout-model configurations (the analytic closed form, AR(1) noise,
# the resonator ring-up, CW readout at the finite window's horizon); the
# Bloch device of the bloch path with its card = CPU batch; the statevec
# path's GHZ-8 batch (sized so that the phase stays within a minute) and
# the 2-qubit interleaved RB with leakage and IQ-level 3-class readout
AR1 = dict(rho=0.5, rtol=1e-4, atol=1e-3, ck=128)
READOUT = dict(analytic_sigma=0.05, ar1=0.5, ring_tau=20.0)
BLOCH = dict(device=dict(detuning_hz=50e3, t1_s=80e-6, t2_s=60e-6,
                         depol_per_pulse=1e-3), cpu_batch=4096)
STATEVEC = dict(ghz_qubits=8, ghz_batch=131072, rb_batch=262144, rb_depth=4,
                rb_seed=31, sigma=0.05, g2=-0.9 - 0.4j, leak2=0.02,
                depol2=0.01)
# stated tolerances of the two new kernels against their plain versions
K4_ATOL = 1e-5
K5_RTOL, K5_ATOL = 2e-5, 2e-4
# the multi-rank phase: two processes sharing the card (gloo), the
# repetition round's seed, and the deadline of both ranks together
MESH = dict(ranks=2, seed=71, timeout=400)
# the torch device the phases run on (a CPU rehearsal sets 'cpu')
DEV = 'cuda'


def sync():
    import torch
    if DEV == 'cuda':
        torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / reps


def headline_source() -> list:
    """The headline as a dict program: active reset + depth-12 RB."""
    from distributed_processor_tpu_torch.models import (active_reset,
                                                        rb_program)
    qubits = [f'Q{i}' for i in range(HEADLINE['n_qubits'])]
    return active_reset(qubits) + rb_program(qubits, HEADLINE['depth'],
                                             seed=1234)


def qasm_headline_source(n_qubits: int, depth: int, seed: int) -> str:
    """The headline as OpenQASM 3 text: ``reset q[i];`` for the active
    reset, then ``rb_program(qubits, depth, seed=seed)`` with its X90s
    as ``sx`` and its virtual Zs as ``rz``, its delay and barrier over
    the register, and the reads as ``c[i] = measure q[i];``.  The delay
    is written in microseconds, in which its duration is exact (500 ns
    gives ``500 * 1e-9``, one ulp off the dict program's ``5e-07``, and
    another clock count)."""
    from distributed_processor_tpu_torch.models import rb_program
    qubits = [f'Q{i}' for i in range(n_qubits)]
    lines = ['OPENQASM 3;', f'qubit[{n_qubits}] q;', f'bit[{n_qubits}] c;']
    lines += [f'reset q[{i}];' for i in range(n_qubits)]
    for ins in rb_program(qubits, depth, seed=seed):
        name = ins['name']
        i = int(ins['qubit'][0][1:]) if len(ins.get('qubit', ())) == 1 \
            else None
        if name == 'delay':
            us = ins['t'] * 1e6
            check(us * 1e-6 == ins['t'], f'delay {ins["t"]} is not exact in us')
            lines.append(f'delay[{us!r}us] q;')
        elif name == 'barrier':
            lines.append('barrier q;')
        elif name == 'X90':
            lines.append(f'sx q[{i}];')
        elif name == 'virtual_z':
            lines.append(f'rz({ins["phase"]!r}) q[{i}];')
        elif name == 'read':
            lines.append(f'c[{i}] = measure q[{i}];')
        else:
            fail(f'the RB program has an instruction {name!r} the QASM '
                 f'headline does not write')
    return '\n'.join(lines) + '\n'


def headline_program():
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.models import make_default_qchip
    n = HEADLINE['n_qubits']
    return compile_to_machine(headline_source(), make_default_qchip(n),
                              n_qubits=n)


def loop_program():
    """The looped headline: the headline inside ``loop_shots_program``."""
    import warnings
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.models import make_default_qchip
    from distributed_processor_tpu_torch.models.experiments import \
        loop_shots_program
    n = HEADLINE['n_qubits']
    qubits = [f'Q{i}' for i in range(n)]
    with warnings.catch_warnings():
        # the reference compiler's own notice for virtual z in loops
        warnings.simplefilter('ignore')
        return compile_to_machine(
            loop_shots_program(headline_source(), LOOP['n_shots'],
                               scope=qubits),
            make_default_qchip(n), n_qubits=n)


def loop_config(mp, **kw):
    """The looped headline's config: the program's static bounds, room
    for its 16 measurements per core, no pulse records."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    args = dict(mp.static_bounds(), max_meas=LOOP['max_meas'],
                max_resets=LOOP['max_resets'], record_pulses=False)
    args.update(kw)
    return InterpreterConfig(**args)


def loop_bits(mp, B: int, seed: int):
    """Seeded injected bits ``[B, C, max_meas]`` on the card."""
    import torch
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return torch.randint(0, 2, (B, mp.n_cores, LOOP['max_meas']),
                         generator=gen, device=DEV, dtype=torch.int32)


def headline_config(mp, **kw):
    """The bench's config (``straightline=None``), with overrides."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    args = dict(max_steps=2 * mp.n_instr + 64,
                max_pulses=int(mp.max_pulses_per_core(1)) + 4,
                max_meas=2, max_resets=2, record_pulses=False,
                straightline=None)
    args.update(kw)
    return InterpreterConfig(**args)


def headline_model(**kw):
    from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
    args = dict(sigma=HEADLINE['sigma'], p1_init=HEADLINE['p1_init'],
                resolve_chunk=HEADLINE['resolve_chunk'],
                resolve_mode='fused')
    args.update(kw)
    return ReadoutPhysics(**args)


def resolve_inputs(tables, B: int, seed: int, full_windows: bool = False):
    """Per-window scalars and channel responses for one resolve epoch of
    the headline program's tables, made from ``seed`` on the card."""
    import torch
    C, F, W = tables['bas'].shape[0], tables['bas'].shape[2], \
        tables['bas'].shape[3]
    dev = tables['env'].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    angle = 2 * math.pi * u(B, C, 1)
    nsamp = torch.full((B, C, 1), W, dtype=torch.int32, device=dev)
    if not full_windows:
        # a quarter of the windows end early, to hold the window mask
        short = u(B, C, 1) < 0.25
        nsamp = torch.where(short, (u(B, C, 1) * W).to(torch.int32), nsamp)
    rows = tables['rows'].tolist() or [0]
    pick = (u(B, C, 1) * len(rows)).to(torch.int64).clamp(max=len(rows) - 1)
    sc = dict(amp=0.3 + 0.7 * u(B, C, 1), cosA=torch.cos(angle),
              sinA=torch.sin(angle),
              f_idx=(u(B, C, 1) * F).to(torch.int32).clamp(max=F - 1),
              addr=torch.as_tensor(rows, dtype=torch.int32,
                                   device=dev)[pick],
              n_samp=nsamp)
    state = u(B, C) < 0.5
    gs_i = torch.where(state, -0.6, 1.0).to(torch.float32).contiguous()
    gs_q = torch.where(state, 0.8, 0.0).to(torch.float32).contiguous()
    return sc, gs_i, gs_q


def phase_environment() -> dict:
    import torch
    from distributed_processor_tpu_torch.ops import _cuda
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} count {torch.cuda.device_count()}')
    from distributed_processor_tpu_torch import native
    t0 = time.perf_counter()
    sources = _cuda.sources()
    # one nvcc per source and the host codec's g++, all started together
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        codec = pool.submit(native.build)
        for src in pool.map(lambda name: _cuda.build(name, verbose=True),
                            sources):
            print(f'built {src}')
        print(f'built {codec.result()}')
    print(f'kernel build: {time.perf_counter() - t0:.3f} s '
          f'({", ".join(s + ".cu" for s in sources)}, and the native '
          f'codec native/soa_codec.cpp with g++)')
    return dict(smi=smi, name=name)


def phase_selftest(env) -> None:
    """Phase 2's first check: the port's kernel self-test
    (``ops.selftest``) on the card, on the JAX package's own inputs and
    tolerances: K5 and K4 against their plain versions, K1 span, K1 block
    and K3 against the generic engine, K3's physics pass with its readout
    left to K2 against the straight-line engine's eager pass, the statevec
    step against the eager statevec block.  Each check runs alone, with
    its wall time and the launches it made, then
    ``kernel_parity_check('cuda')`` runs them all again and must launch
    all seven kernels."""
    from distributed_processor_tpu_torch.ops import selftest
    names = (('exec_span', 'K1 span'), ('exec_blocks', 'K1 block'),
             ('exec_span_fused', 'K3'),
             ('exec_span_physics', 'K3 physics pass'),
             ('render_shot', 'K4'), ('demod_iq', 'K5'),
             ('statevec_pulse', 'SV'))

    def run(fn) -> tuple:
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        fn(DEV)
        sync()
        wall = time.perf_counter() - t0
        counts = _launches()
        return wall, counts, ', '.join(f'{label} {counts[k]}'
                                       for k, label in names)

    for label, fn in (('K5 demod', selftest.check_demod_parity),
                      ('K4 render', selftest.check_waveform_parity),
                      ('K1 span, K1 block, K3, K3 physics pass',
                       selftest.check_exec_parity),
                      ('SV statevec step', selftest.check_statevec_parity)):
        wall, _counts, text = run(fn)
        print(f'self-test {label} ({fn.__name__}): {wall * 1e3:.1f} ms '
              f'wall, launches {text}, on {env["smi"]}')
    wall, counts, text = run(selftest.kernel_parity_check)
    check(all(counts[k] > 0 for k, _ in names),
          f'kernel_parity_check launched {counts}')
    print(f'self-test kernel_parity_check({DEV!r}), all four again: '
          f'{wall * 1e3:.1f} ms wall, launches {text}: every kernel held '
          f'to its plain version on {env["smi"]}')
    _reset_launches()


def synthetic_tables(C: int, W: int, seed: int) -> dict:
    """Resolver tables with :data:`SYNTH`'s static rows and carrier
    frequencies over a seeded random envelope, on the card: the row and
    frequency select of the prefix tables, which the headline (one row,
    one frequency) never exercises."""
    import torch
    from distributed_processor_tpu_torch.ops.resolve import \
        build_fused_tables
    from distributed_processor_tpu_torch.sim.physics import (
        _aligned_chunk, _carrier_basis, _pad_env_planes)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    interps = SYNTH['interps'][:C]
    env = 2 * torch.rand((C, SYNTH['env_len'], 2), generator=gen,
                         device=DEV) - 1
    freq = 0.4 * torch.rand((C, SYNTH['n_freqs']), generator=gen,
                            device=DEV) - 0.2
    env_pads = _pad_env_planes(env, _aligned_chunk(256, W, interps))
    return build_fused_tables(env_pads, _carrier_basis(freq, W), W, interps,
                              SYNTH['rows'])


def _nbytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors``."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
    return sum(seen.values())


def phase_kernels(mp) -> dict:
    """The resolve kernel against its plain version on the card, in rows
    mode (prefix tables) and full-table mode (the per-sample chain), on
    the headline's tables and on synthetic ones with several rows and
    frequencies; the two modes timed in turns on the same inputs."""
    import torch
    from distributed_processor_tpu_torch.ops.resolve import (
        build_prefix_tables, resolve_windows_fused,
        resolve_windows_reference)
    from distributed_processor_tpu_torch.sim.physics import \
        prepare_physics_tables
    model = headline_model()
    tables = prepare_physics_tables(mp, model, DEV)
    # full-table mode: the same tables without their static row list
    full_tables = dict(tables, rows=tables['rows'][:0])
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    ck = 256
    # the main path's batch: every comparison launches the kernel on the
    # lanes [B, C] and grid the main path gives it
    B = HEADLINE['batch']
    sigma = float(HEADLINE['sigma'])
    max_err = 0.0

    def agree(got, want, what):
        """Hold the kernel's sums to the plain version's; print this
        check's worst error and share of the tolerance."""
        nonlocal max_err
        scale = float(want[2].abs().max())
        worst, ratio = 0.0, 0.0
        for name, g, w in zip(('acc_i', 'acc_q', 'energy'), got, want):
            err = (g - w).abs()
            tol = 1e-5 * w.abs() + 1e-5 * scale
            worst = max(worst, float(err.max()))
            ratio = max(ratio, float((err / tol).max()))
            bad = err > tol
            check(not bool(bad.any()),
                  f'{what}: {name} differs from the plain version at '
                  f'{int(bad.sum())} windows (max |err| '
                  f'{float(err.max()):.3e}, scale {scale:.3e})')
        max_err = max(max_err, worst)
        print(f'kernel vs plain ({what}, B={B} C={C} W={W}): agree, max '
              f'|err| {worst:.3e}, max |err|/tol {ratio:.3f}')

    def streamed(tabs, seed, label):
        """Identical streamed noise into both ([2, C, B, W] float32, 17
        GB at the main path's batch)."""
        sc, gs_i, gs_q = resolve_inputs(tabs, B, seed=seed)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(seed + 1)
        noise = torch.randn((2, C, B, W), generator=gen,
                            device=DEV).mul_(sigma)
        args = (sc, tabs, gs_i, gs_q, sigma, 0.0, 7, W,
                tabs['env'].shape[2])
        got = resolve_windows_fused(*args, noise=noise)
        want = resolve_windows_reference(*args, noise=noise, ck=ck)
        sync()
        agree(got, want, label)
        del noise, got, want
        if DEV == 'cuda':
            torch.cuda.empty_cache()
        return args

    synth = synthetic_tables(C, W, seed=5)
    R, F = synth['rows'].numel(), synth['bas'].shape[2]
    for label, tabs, ring in (
            ('rows, sigma=0', tables, False),
            ('full table, sigma=0', full_tables, False),
            ('rows, ring, sigma=0', tables, True),
            (f'R={R} F={F} rows, sigma=0', synth, False),
            (f'R={R} F={F} rows, ring, sigma=0', synth, True)):
        sc, gs_i, gs_q = resolve_inputs(tabs, B, seed=1)
        args = (sc, tabs, gs_i, gs_q, 0.0, 1.0 / 40.0, 7, W,
                tabs['env'].shape[2])
        got = resolve_windows_fused(*args, ring=ring)
        want = resolve_windows_reference(*args, ring=ring, ck=ck)
        sync()
        agree(got, want, label)
    streamed(synth, 8, f'R={R} F={F} rows, streamed noise')
    args = streamed(tables, 2, 'streamed noise')

    # the kernel's own Philox noise against the plain version's torch
    # noise: the deviation from the sigma = 0 sums, normalised by
    # sigma * sqrt(energy), is N(0, 1) per window for both
    clean = resolve_windows_reference(*args[:4], 0.0, *args[5:], ck=ck)
    norm = sigma * clean[2].clamp(min=1e-12).sqrt()
    live = clean[2] > 0
    stats = {}
    for label, out in (
            ('kernel', resolve_windows_fused(*args, epoch=1)),
            ('plain', resolve_windows_reference(*args, epoch=1, ck=ck))):
        d = torch.stack([(out[0] - clean[0]) / norm,
                         (out[1] - clean[1]) / norm])         # [2, B, C]
        mean = torch.stack([d[:, :, c][:, live[:, c]].mean()
                            for c in range(C)])
        var = torch.stack([d[:, :, c][:, live[:, c]].var()
                           for c in range(C)])
        stats[label] = (mean, var)
    n = 2 * int(live.sum(0).min())
    tol_mean, tol_var = 5 * math.sqrt(2 / n), 5 * math.sqrt(4 / n)
    dm = (stats['kernel'][0] - stats['plain'][0]).abs().max()
    dv = (stats['kernel'][1] - stats['plain'][1]).abs().max()
    check(float(dm) < tol_mean and float(dv) < tol_var,
          f'Philox noise statistics off: mean diff {float(dm):.4f} '
          f'(tol {tol_mean:.4f}), var diff {float(dv):.4f} '
          f'(tol {tol_var:.4f}); kernel var {stats["kernel"][1].tolist()}')
    kvar = [round(v, 4) for v in stats['kernel'][1].tolist()]
    print(f'kernel Philox noise vs plain torch noise: per-core mean diff '
          f'{float(dm):.4f} < {tol_mean:.4f}, var diff {float(dv):.4f} < '
          f'{tol_var:.4f}; kernel var {kvar}')

    # time per epoch at bench shape (all windows full length, as the
    # headline program's are): rows mode (prefix tables) and full-table
    # mode (the per-sample chain) on the same inputs, in turns
    sc, gs_i, gs_q = resolve_inputs(tables, B, seed=4, full_windows=True)
    run = {'rows': (sc, tables, gs_i, gs_q, sigma, 0.0, 7, W, Lp),
           'full table': (sc, dict(tables, rows=tables['rows'][:0]), gs_i,
                          gs_q, sigma, 0.0, 7, W, Lp)}
    turns = {'rows': [], 'full table': []}
    for mode in ('rows', 'full table', 'full table', 'rows'):
        turns[mode].append(cuda_time_ms(
            lambda: resolve_windows_fused(*run[mode]), reps=10))
    ms = sum(turns['rows']) / 2
    clean_args = run['rows'][:4] + (0.0,) + run['rows'][5:]
    clean_ms = cuda_time_ms(lambda: resolve_windows_fused(*clean_args),
                            reps=20)
    plain_ms = cuda_time_ms(
        lambda: resolve_windows_reference(*run['rows'], ck=ck), reps=2)
    # the least time for this work: bytes (window scalars in, sums out,
    # the prefix tables once) or, with noise, the issue of its
    # instructions, its multiplies or its special-function operations
    windows = B * C
    noisy = float(sc['n_samp'].clamp(0, W).sum())
    pre = build_prefix_tables(tables)
    nbytes = windows * (8 * 4 + 3 * 4) + _nbytes(
        pre['p1'], pre['pw'], pre['z'], tables['rows'])
    per_s = H100_SMS * H100_CLOCK_HZ / 1e3                   # per ms
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_issue = (noisy * K2_SAMPLE_INSTR + windows * K2_WINDOW_INSTR) \
        / (ISSUE_PER_CLK * per_s)
    t_sfu = noisy * K2_SAMPLE_SFU / (SFU_PER_CLK * per_s)
    t_mul = noisy * K2_SAMPLE_IMUL / (IMUL_PER_CLK * per_s)
    bound_ms = max(t_bytes, t_issue, t_sfu, t_mul)
    clean_bound = max(t_bytes, windows * K2_WINDOW_INSTR
                      / (ISSUE_PER_CLK * per_s))
    print(f'resolve epoch at B={B} C={C} W={W}, sigma={sigma}, in turns '
          f"(rows, full table, full table, rows): rows mode "
          f"{turns['rows'][0]:.4f}, {turns['rows'][1]:.4f} ms; full-table "
          f"mode {turns['full table'][0]:.4f}, {turns['full table'][1]:.4f}"
          f' ms; rows mode at sigma=0 {clean_ms:.4f} ms (bound '
          f'{clean_bound:.4f} ms, bytes); plain {plain_ms:.4f} ms; bound '
          f'{bound_ms:.4f} ms (issue {t_issue:.4f} ms, special-function '
          f'{t_sfu:.4f} ms, multiplies {t_mul:.4f} ms, bytes {t_bytes:.4f} '
          f'ms; {noisy:.0f} noisy samples)')
    return dict(name='resolve_windows', route='cuda',
                source='distributed_processor_tpu_torch/csrc/resolve.cu',
                replaces='distributed_processor_tpu/ops/resolve_pallas.py:196',
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if bound_ms > t_bytes else 'bytes',
                library_ms=None)


def phase_k2_ar1(mp) -> dict:
    """K2 with AR(1) ADC noise at the main path's windows (262144 x 8):
    against its plain version on the same streamed whites and initial
    states (the kernel colors them by its warp scan, the plain version by
    a triangular product per chunk), stated tolerance rtol 1e-4 / atol
    1e-3; on its own Philox draws, the variance of each window's noise
    projection against the closed form ``sigma^2 a^2 sum_{s,t} rho^|s-t|
    Re(z_s conj(z_t))`` within 5 standard errors; and one epoch timed
    beside the white kernel in turns, events and device time."""
    import torch
    from distributed_processor_tpu_torch.ops.resolve import (
        build_prefix_tables, resolve_windows_fused,
        resolve_windows_reference)
    from distributed_processor_tpu_torch.sim.physics import \
        prepare_physics_tables
    rho, ck = AR1['rho'], AR1['ck']
    tables = prepare_physics_tables(mp, headline_model(), DEV)
    C, W, Lp = tables['env'].shape[0], tables['bas'].shape[3], \
        tables['env'].shape[2]
    B, sigma = HEADLINE['batch'], float(HEADLINE['sigma'])

    # (1) the same whites and initial states into both
    sc, gs_i, gs_q = resolve_inputs(tables, B, seed=21)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    white = torch.randn((2, C, B, W), generator=gen, device=DEV).mul_(sigma)
    init = torch.randn((2, C, B), generator=gen, device=DEV).mul_(sigma)
    args = (sc, tables, gs_i, gs_q, sigma, 0.0, 7, W, Lp)
    got = resolve_windows_fused(*args, noise=white, noise0=init, rho=rho)
    want = resolve_windows_reference(*args, noise=white, noise0=init,
                                     rho=rho, ck=ck)
    sync()
    worst, ratio = 0.0, 0.0
    for name, g, w in zip(('acc_i', 'acc_q', 'energy'), got, want):
        err = (g - w).abs()
        tol = AR1['rtol'] * w.abs() + AR1['atol']
        bad = err > tol
        check(not bool(bad.any()),
              f'K2 AR(1): {name} differs from the plain version at '
              f'{int(bad.sum())} windows (max |err| {float(err.max()):.3e})')
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / tol).max()))
    print(f'K2 AR(1) rho={rho} vs plain on streamed whites (B={B} C={C} '
          f'W={W}, a quarter of the windows short): agree within rtol '
          f"{AR1['rtol']} / atol {AR1['atol']}, max |err| {worst:.3e}, "
          f'max |err|/tol {ratio:.3f}')
    del white, init, got, want
    torch.cuda.empty_cache()

    # (2) the kernel's own draws against the closed form, full windows
    sc, gs_i, gs_q = resolve_inputs(tables, B, seed=23, full_windows=True)
    args = (sc, tables, gs_i, gs_q)
    clean = resolve_windows_fused(*args, 0.0, 0.0, 7, W, Lp)
    noisy = resolve_windows_fused(*args, sigma, 0.0, 7, W, Lp, rho=rho,
                                  epoch=1)
    pre = build_prefix_tables(tables)
    z = pre['z'].double()
    z = torch.complex(z[..., 0], z[..., 1])                  # [C, R, F, W]
    idx = torch.arange(W, device=DEV, dtype=torch.float64)
    K = rho ** (idx[:, None] - idx[None, :]).abs()
    q = torch.einsum('crfs,st,crft->crf', z, K.to(z.dtype), z.conj()).real
    rows = tables['rows']
    r_idx = (sc['addr'][..., 0, None] == rows).int().argmax(-1)   # [B, C]
    c_idx = torch.arange(C, device=DEV)[None, :].expand(B, C)
    lane_q = q[c_idx, r_idx, sc['f_idx'][..., 0].long()]
    norm = sigma * sc['amp'][..., 0].double() * lane_q.sqrt()
    n = B * C
    for comp in (0, 1):
        d = ((noisy[comp] - clean[comp]).double() / norm).flatten()
        var, mean = float(d.var()), float(d.mean())
        check(abs(var - 1.0) < 5 * math.sqrt(2.0 / n)
              and abs(mean) < 5 * math.sqrt(1.0 / n),
              f'K2 AR(1) Philox noise: normalised projection mean {mean:.5f}'
              f' var {var:.5f} (closed form: 0 and 1, tolerances '
              f'{5 * math.sqrt(1.0 / n):.5f} / {5 * math.sqrt(2.0 / n):.5f})')
        print(f"K2 AR(1) Philox draws, {'IQ'[comp]}: the projection over "
              f'its closed-form sd has mean {mean:.5f} and variance '
              f'{var:.5f} over {n} windows (5 SE: {5 * math.sqrt(1 / n):.5f}'
              f' / {5 * math.sqrt(2 / n):.5f}); white noise would give '
              f'{float((pre["p1"][..., -1].double() / q).mean()):.4f}')

    # (3) one epoch, white and AR(1), in turns
    white_args = args + (sigma, 0.0, 7, W, Lp)
    run = {'white': lambda: resolve_windows_fused(*white_args),
           'ar1': lambda: resolve_windows_fused(*white_args, rho=rho)}
    turns = {'white': [], 'ar1': []}
    for mode in ('white', 'ar1', 'ar1', 'white'):
        turns[mode].append(cuda_time_ms(run[mode], reps=10))
    dev = {mode: _kernel_ms(run[mode], 10, match='resolve_rows')
           for mode in ('white', 'ar1')}
    ms = sum(turns['ar1']) / 2
    white_ms = sum(turns['white']) / 2
    plain_ms = cuda_time_ms(lambda: resolve_windows_reference(
        *white_args, rho=rho, ck=ck), reps=2)
    windows = B * C
    noisy_n = float(sc['n_samp'].clamp(0, W).sum())
    nbytes = windows * (8 * 4 + 3 * 4) + _nbytes(
        pre['p1'], pre['pw'], pre['z'], tables['rows'])
    per_s = H100_SMS * H100_CLOCK_HZ / 1e3                   # per ms
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_issue = (noisy_n * (K2_SAMPLE_INSTR + K2_AR1_SAMPLE_INSTR)
               + windows * K2_WINDOW_INSTR) / (ISSUE_PER_CLK * per_s)
    t_sfu = noisy_n * K2_SAMPLE_SFU / (SFU_PER_CLK * per_s)
    t_mul = noisy_n * K2_SAMPLE_IMUL / (IMUL_PER_CLK * per_s)
    bound_ms = max(t_bytes, t_issue, t_sfu, t_mul)
    # the warp scan's own cost, beside the bound
    scan_issue = noisy_n * K2_AR1_SCAN_INSTR / (ISSUE_PER_CLK * per_s)
    scan_shfl = noisy_n * K2_AR1_SCAN_SHFL / (SHFL_PER_CLK * per_s)
    print(f'K2 epoch at B={B} C={C} W={W}, sigma={sigma}, in turns (white, '
          f"AR(1), AR(1), white): white {turns['white'][0]:.4f}, "
          f"{turns['white'][1]:.4f} ms; AR(1) {turns['ar1'][0]:.4f}, "
          f"{turns['ar1'][1]:.4f} ms (x{ms / white_ms:.3f}); device white "
          f"{_device_note(dev['white'])}, AR(1) {_device_note(dev['ar1'])} "
          f'ms; plain {plain_ms:.3f} ms; AR(1) bound {bound_ms:.4f} ms '
          f'(issue {t_issue:.4f}, special-function {t_sfu:.4f}, multiplies '
          f'{t_mul:.4f}, bytes {t_bytes:.4f} ms); the warp scan alone '
          f'issues {K2_AR1_SCAN_INSTR} instructions per sample '
          f'({scan_issue:.4f} ms) of which {K2_AR1_SCAN_SHFL} shuffles '
          f'({scan_shfl:.4f} ms on the shuffle pipe)')
    return dict(name='resolve_windows_ar1', route='cuda',
                source='distributed_processor_tpu_torch/csrc/resolve.cu',
                replaces='distributed_processor_tpu/ops/resolve_pallas.py:196',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if bound_ms > t_bytes else 'bytes',
                library_ms=None)


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its count goes by."""
    from distributed_processor_tpu_torch.ops.demod import demod_iq
    from distributed_processor_tpu_torch.ops.exec_span import (
        exec_blocks, exec_span, exec_span_fused, exec_span_physics)
    from distributed_processor_tpu_torch.ops.resolve import \
        resolve_windows_fused
    from distributed_processor_tpu_torch.ops.statevec import statevec_pulse
    from distributed_processor_tpu_torch.ops.waveform import render_shot
    return {'resolve_windows': resolve_windows_fused,
            'exec_span': exec_span, 'exec_span_fused': exec_span_fused,
            'exec_span_physics': exec_span_physics,
            'render_shot': render_shot, 'demod_iq': demod_iq,
            'exec_blocks': exec_blocks, 'statevec_pulse': statevec_pulse}


def _reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _only_launched(counts: dict, *names) -> bool:
    """No kernel outside ``names`` was launched."""
    return not any(n for name, n in counts.items() if name not in names)


def _k2_launches(kernels: dict) -> tuple:
    """K2's launches among a profiled run's kernels (``{name: [us,
    count]}``): all of them, and those of its AR(1) instantiations,
    whose last template argument is ``AR1`` (``resolve_rows_noisy<STREAM,
    SMEM_Z, AR1>``, ``resolve_full_table<AR1>``): ``true`` in a
    demangled name, ``Lb1E`` last in a mangled one."""
    import re
    total = ar1 = 0
    for name, (_us, n) in kernels.items():
        if not re.search(r'resolve_(rows_|full_table)', name):
            continue
        total += n
        m = re.search(r'resolve_(?:rows_noisy|full_table)<([^<>]*)>', name)
        if (m and m.group(1).split(',')[-1].strip() in ('true', '1')) or \
                re.search(r'resolve_(?:rows_noisy|full_table)I(?:Lb[01]E)*'
                          r'Lb1EE', name):
            ar1 += n
    return total, ar1


def _max_abs_diff(a: dict, b: dict, what: str) -> float:
    """Every key of two output dicts identical; returns max |a - b| (0)."""
    import torch
    check(set(a) == set(b), f'{what}: keys differ: {sorted(set(a) ^ set(b))}')
    worst = 0.0
    for key in sorted(a):
        x, y = a[key], b[key]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f'{what}: {key} is {x.dtype} {tuple(x.shape)} vs '
              f'{y.dtype} {tuple(y.shape)}')
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs()
            fail(f'{what}: {key} differs at {int((diff > 0).sum())} '
                 f'elements (max |diff| {float(diff.max())})')
        if x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def _carry_bytes(st: dict) -> int:
    return sum(t.numel() * t.element_size() for t in st.values())


def _span_inputs(mp, cfg, B: int, seed: int, physics: bool = False):
    """The span kernels' inputs at batch ``B`` on the card: the initial
    carry, the program's span table and seeded injected bits (or, for
    ``physics``, seeded initial qubit states)."""
    import torch
    from distributed_processor_tpu_torch.sim.interpreter import (
        _init_state, _span_table)
    table = _span_table(mp, cfg, DEV, fused=physics)
    st = _init_state(B, mp.n_cores, cfg, None, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2, (B, mp.n_cores, cfg.max_meas), generator=gen,
                         device=DEV, dtype=torch.int32)
    if physics:
        st['qturns'] = 2 * bits[..., 0]
    return st, table, bits


def _kernel_ms(fn, reps: int, match: str = 'exec_') -> float:
    """Device ms per call of ``fn`` under the profiler: the own time of
    the kernels whose name holds ``match`` (the megastep kernels by
    default), without the wrapper's host work (0.0 when the profiler saw
    no such kernel)."""
    _wall, kernels = device_kernel_times(lambda: [fn() for _ in range(reps)])
    return sum(us for name, (us, _n) in kernels.items()
               if match in name) / 1e3 / reps


def _device_note(dev_ms: float) -> str:
    return f'{dev_ms:.5f}' if dev_ms > 0 else 'not measured'


def _time_kernels(make, names, reps: int) -> dict:
    """``{name: (event ms, device ms)}`` per call of ``make(name,
    calls)``, a function good for ``calls`` calls: CUDA events around the
    wrapper and the profiler's device time, each kernel timed twice in
    turns (forward, then backward), means of the two."""
    got = {d: [] for d in names}
    for d in list(names) + list(reversed(names)):
        got[d].append((cuda_time_ms(make(d, reps + 1), reps),
                       _kernel_ms(make(d, reps), reps)))
    return {d: tuple(sum(v) / len(v) for v in zip(*t))
            for d, t in got.items()}


def phase_k1(mp, env) -> dict:
    """K1 (engine='pallas') against the straight-line engine on the card,
    on seeded injected bits at the main path's batch; then the tile
    kernel and the one-thread-per-lane kernel (``lane``) timed on the
    same inputs, CUDA events around the wrapper and device time under the
    profiler, beside the plain version's time and the bound."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_span_per_lane, exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, simulate_batch)
    B = HEADLINE['batch']
    worst = 0.0
    for record in (False, True):
        cfg = headline_config(mp, record_pulses=record,
                              opcode_histogram=True)
        _st, _table, bits = _span_inputs(mp, cfg, B, seed=21)
        outs = {eng: simulate_batch(mp, bits, cfg=headline_config(
            mp, engine=eng, record_pulses=record, opcode_histogram=True),
            device=DEV) for eng in ('pallas', 'straightline')}
        sync()
        worst = max(worst, _max_abs_diff(outs['pallas'],
                                         outs['straightline'],
                                         f'K1 vs plain (records {record})'))
        retired = int(outs['pallas']['op_hist'].sum())
        print(f'K1 vs plain (B={B}, records {record}): every key identical, '
              f'{retired} instructions retired')
        del outs
    # time at the main path's config (no records, no histogram) on the
    # same bits, which retire the instructions counted above
    cfg = headline_config(mp)
    st, table, bits = _span_inputs(mp, cfg, B, seed=21)
    valid = torch.ones(bits.shape, dtype=torch.bool, device=DEV)
    kernels = {'lane': _exec_span_per_lane, 'tile': exec_span}
    want = exec_span(st, table, bits, cfg)
    _max_abs_diff(_exec_span_per_lane(st, table, bits, cfg), want,
                  'K1 one thread per lane vs tile')
    times = _time_kernels(lambda d, _calls: lambda: kernels[d](
        st, table, bits, cfg), tuple(kernels), reps=20)
    ms = times['tile'][0]
    plain_ms = cuda_time_ms(lambda: _exec_straightline(
        st, table.soa_np, table.spc, table.interp, bits, valid, cfg), reps=3)
    nbytes = _carry_bytes(st) + _carry_bytes(want) + sum(
        t.numel() * t.element_size() for t in (bits, table.spc,
                                               table.interp)) \
        + table.soa_np.nbytes
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = retired * SPAN_OPS_PER_INSTR / PEAK_INT32_OPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K1 at B={B} C={mp.n_cores} N={mp.n_instr}: '
          + ', '.join(f'kernel {d} {e:.4f} ms events / {_device_note(v)} ms '
                      f'device' for d, (e, v) in times.items())
          + f'; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes '
          f'{nbytes / 1e9:.3f} GB = {t_bytes:.4f} ms, operations {retired} '
          f'rows x {SPAN_OPS_PER_INSTR} = {t_ops:.4f} ms at '
          f'{PEAK_INT32_OPS:.3e}/s) on {env["smi"]}')
    return dict(name='exec_span', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='distributed_processor_tpu/ops/exec_pallas.py:349',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None, bound_bytes=nbytes, batch=B,
                table_bytes=table.soa_np.nbytes + _nbytes(table.spc,
                                                          table.interp))


def phase_k3(mp, env) -> dict:
    """K3 (engine='fused') against its plain version (the fused
    straight-line pass) and against the generic engine, at sigma = 0 and
    the main path's batch; its time beside the plain version's and its
    bound."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import \
        exec_span_fused
    from distributed_processor_tpu_torch.sim.interpreter import \
        _exec_straightline
    from distributed_processor_tpu_torch.sim.physics import (
        fused_readout, physics_config, prepare_physics_tables,
        run_physics_batch)
    B, C = HEADLINE['batch'], mp.n_cores
    model = headline_model(sigma=0.0)
    fused = fused_readout(mp, model, prepare_physics_tables(mp, model, DEV))
    bits0 = torch.zeros((B, C, 2), dtype=torch.int32, device=DEV)
    valid0 = torch.zeros(bits0.shape, dtype=torch.bool, device=DEV)

    def inputs(**kw):
        cfg = physics_config(headline_config(mp, **kw), model)
        st, table, init = _span_inputs(mp, cfg, B, seed=31, physics=True)
        return cfg, st, table, init

    def kernel():
        return exec_span_fused(st, table, bits0, valid0, cfg, fused)

    def plain():
        out = _exec_straightline(dict(st, meas_bits=bits0,
                                      meas_valid=valid0),
                                 table.soa_np, table.spc, table.interp,
                                 None, None, cfg, fused=fused)
        return out, out.pop('meas_bits'), out.pop('meas_valid')

    # compare with the opcode histogram on, to count retired instructions
    cfg, st, table, init = inputs(opcode_histogram=True)
    got, want = kernel(), plain()
    sync()
    retired = int(got[0]['op_hist'].sum())
    worst = _max_abs_diff(dict(got[0], meas_bits=got[1], meas_valid=got[2]),
                          dict(want[0], meas_bits=want[1],
                               meas_valid=want[2]), 'K3 vs plain')
    check(bool(got[2].all()), 'K3 left measurement slots unresolved')
    print(f'K3 vs plain (B={B}, sigma=0): every key identical')
    del want
    # the whole fused batch against the generic engine's two epochs
    init_states = init[..., 0]
    runs = {eng: run_physics_batch(
        mp, model, 7, B, init_states=init_states,
        cfg=headline_config(mp, engine=eng), device=DEV)
        for eng in ('fused', 'generic')}
    for key in runs['generic']:
        if key not in ('epochs', 'steps'):
            check(torch.equal(runs['fused'][key], runs['generic'][key]),
                  f'K3 vs generic: {key} differs')
    check(int(runs['fused']['epochs']) == 1
          and int(runs['generic']['epochs']) == 2,
          f"K3 epochs {int(runs['fused']['epochs'])}, generic "
          f"{int(runs['generic']['epochs'])}")
    print(f'K3 vs generic engine (B={B}, sigma=0): bits and integer '
          f'outputs identical, epochs 1 vs 2')
    del runs, got
    # time at the path's config (no histogram) on the same inputs
    cfg, st, table, init = inputs()
    ms = cuda_time_ms(kernel, reps=20)
    dev_ms = _kernel_ms(kernel, reps=20)
    plain_ms = cuda_time_ms(plain, reps=1)
    out, bits, valid = kernel()
    # operations these inputs need: the integer work per retired
    # instruction and, per measurement, one read of its window's energy
    # prefix (the table is an input: no per-sample work is left) and the
    # discriminator
    fired = torch.arange(cfg.max_meas, device=DEV)[None, None, :] \
        < out['n_meas'][..., None]
    n_meas = int(fired.sum())
    # (integer work at the integer rate; all of it at the issue rate)
    int_ops = retired * SPAN_OPS_PER_INSTR
    ops = int_ops + n_meas * (1 + DISCRIMINATE_OPS)
    nbytes = _carry_bytes(st) + _carry_bytes(out) + 2 * sum(
        t.numel() * t.element_size() for t in (bits, valid)) + sum(
        t.numel() * t.element_size() for t in
        (table.spc, table.interp, fused['e2p'], fused['g0'], fused['g1'])) \
        + table.soa_np.nbytes
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(int_ops / PEAK_INT32_OPS, ops / PEAK_ISSUE) * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K3 at B={B} C={C}: kernel {ms:.4f} ms events / '
          f'{_device_note(dev_ms)} ms device, plain {plain_ms:.4f} ms, '
          f'bound {bound_ms:.4f} ms (bytes {nbytes / 1e9:.3f} GB = '
          f'{t_bytes:.4f} ms, operations {ops:.3e} = {t_ops:.4f} ms; '
          f'{n_meas} windows, one energy prefix read each) on {env["smi"]}')
    return dict(name='exec_span_fused', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='distributed_processor_tpu/sim/interpreter.py:3206',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def phase_k3_physics(mp, env) -> dict:
    """K3's physics pass with its readout left to K2 (the main path's exec
    hop, one launch an epoch) against the straight-line engine's eager
    pass on the card at the main path's batch and readout, every leaf,
    pass by pass: the first pass from the initial carry (every lane
    stalls at its reset read), then the resumed pass once the fired
    windows' bits are set and valid.  Each pass timed at the path's
    config, CUDA events around the wrapper and device time under the
    profiler, beside the eager pass's time and the bound."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import \
        exec_span_physics
    from distributed_processor_tpu_torch.sim.interpreter import \
        _exec_straightline
    from distributed_processor_tpu_torch.sim.physics import physics_config
    B, C = HEADLINE['batch'], mp.n_cores
    model = headline_model()

    def passes(**kw) -> list:
        """The two passes' inputs ``(carry, bits, valid)``, the second
        from the plain version's first pass, and the plain outputs."""
        cfg = physics_config(headline_config(mp, **kw), model)
        st, table, init = _span_inputs(mp, cfg, B, seed=41, physics=True)
        bits = torch.zeros(init.shape, dtype=torch.int32, device=DEV)
        valid = torch.zeros(init.shape, dtype=torch.bool, device=DEV)
        out = []
        for _ in range(2):
            want = _exec_straightline(st, table.soa_np, table.spc,
                                      table.interp, bits, valid, cfg)
            out.append((st, bits, valid, want))
            fired = torch.arange(cfg.max_meas, device=DEV)[None, None, :] \
                < want['n_meas'][..., None]
            bits = torch.where(fired & ~valid, init, bits)
            valid = valid | fired
            st = want
        return cfg, table, out

    cfg, table, runs = passes(opcode_histogram=True)
    worst, retired = 0.0, []
    for n, (st, bits, valid, want) in enumerate(runs):
        got = exec_span_physics(st, table, bits, valid, cfg)
        sync()
        worst = max(worst, _max_abs_diff(got, want,
                                         f'K3 physics pass {n} vs plain'))
        retired.append(int(got['op_hist'].sum()))
        stalled = int(got['phys_wait'].sum())
        check(stalled == (B * C if n == 0 else 0),
              f'K3 physics pass {n}: {stalled} lanes stalled')
    check(bool(runs[1][3]['done'].all()),
          'K3 physics passes left lanes undone')
    print(f'K3 physics pass vs plain (B={B}, two passes): every leaf '
          f'identical; {retired} instructions retired; every lane stalls at '
          f'its reset read in the first pass, none in the second')
    del runs
    # time at the path's config (no histogram) on the same inputs
    cfg, table, runs = passes()
    per = []
    for n, (st, bits, valid, want) in enumerate(runs):
        def kernel():
            return exec_span_physics(st, table, bits, valid, cfg)
        ms = cuda_time_ms(kernel, reps=20)
        dev_ms = _kernel_ms(kernel, reps=20, match='exec_span_physics')
        plain_ms = cuda_time_ms(lambda: _exec_straightline(
            st, table.soa_np, table.spc, table.interp, bits, valid, cfg),
            reps=1)
        nbytes = _carry_bytes(st) + _carry_bytes(want) + sum(
            t.numel() * t.element_size() for t in
            (bits, valid, table.spc, table.interp)) + table.soa_np.nbytes
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = retired[n] * SPAN_OPS_PER_INSTR / PEAK_INT32_OPS * 1e3
        per.append((ms, dev_ms, plain_ms, max(t_bytes, t_ops), t_ops,
                    t_bytes))
        print(f'K3 physics pass {n} at B={B} C={C}: kernel {ms:.4f} ms '
              f'events / {_device_note(dev_ms)} ms device, plain '
              f'{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms '
              f'(bytes {nbytes / 1e9:.3f} GB = {t_bytes:.4f} ms, operations '
              f'{retired[n]} rows x {SPAN_OPS_PER_INSTR} = {t_ops:.4f} ms) '
              f'on {env["smi"]}')
    mean = [sum(p[k] for p in per) / len(per) for k in range(6)]
    return dict(name='exec_span_physics', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='none: the JAX package runs this pass on its XLA '
                'engines (distributed_processor_tpu/sim/interpreter.py:1864)',
                max_abs_err=worst, ms=mean[0], dev_ms=mean[1],
                plain_ms=mean[2], bound_ms=mean[3],
                bound_by='operations' if mean[4] >= mean[5] else 'bytes',
                library_ms=None)


def phase_statevec_kernel(env) -> dict:
    """The statevec step (``ops.statevec.statevec_pulse``,
    ``csrc/statevec.cu``) against the eager statevec block
    (``sim.interpreter._statevec_pulse``) on one step of the parity
    scan's size: 131072 shots on 8 cores with its channels (T1 and T2,
    1q and 2q Paulis, zx couplings), each core firing with probability
    1/4, from the same state and the same uniforms.  Shots whose
    decisions differ (a uniform within rounding of its threshold, which
    float32 rounding makes rare: well under one of the step's millions
    of decisions) are counted and may be at most 8; every other output
    as ``ops.selftest.statevec_step_diff`` holds it.  Timed as the parity
    scan runs it, CUDA events around the wrapper (the uniforms' draw
    included) and the kernel's device time under the profiler, beside
    the plain block's time and the bound: every operand byte read once
    and every output byte written once at the card's HBM rate, of which
    psi's 0.537 GB, read and written, is 0.160 ms."""
    import torch
    from distributed_processor_tpu_torch.ops.selftest import (
        statevec_step_diff, statevec_step_inputs)
    from distributed_processor_tpu_torch.ops.statevec import statevec_pulse
    from distributed_processor_tpu_torch.sim.interpreter import (
        _statevec_pulse, _statevec_traj_u)
    B, C = STATEVEC['ghz_batch'], STATEVEC['ghz_qubits']
    st, cfg, dm, args = statevec_step_inputs(
        B, C, DEV, seed=61, channels=('decay', 'dp1', 'dp2', 'zx'),
        fire_p=0.25)
    traj_u = _statevec_traj_u(dm, 0, B, C, DEV)
    before = statevec_pulse.launches
    got = statevec_pulse(st, cfg, dm, traj_u, *args)
    want = _statevec_pulse(st, cfg, dm, traj_u, *args)
    sync()
    check(statevec_pulse.launches == before + 1,
          'statevec step: the wrapper did not launch once')
    differ = statevec_step_diff(got, want)
    check(len(differ) <= 8,
          f'statevec step: {len(differ)} shots decided otherwise')
    same = torch.ones(B, dtype=torch.bool, device=DEV)
    same[differ] = False
    worst = float((got[0]['psi'][same] - want[0]['psi'][same]).abs().max())
    del got, want

    def step(pulse):
        # as the engine's step runs either path: the uniforms' draw, then
        # the block
        return lambda: pulse(st, cfg, dm, _statevec_traj_u(dm, 0, B, C, DEV),
                             *args)
    ms = cuda_time_ms(step(statevec_pulse), reps=20)
    dev_ms = _kernel_ms(step(statevec_pulse), reps=20, match='statevec_step')
    plain_ms = cuda_time_ms(step(_statevec_pulse), reps=2)
    nu = traj_u.shape[2]
    outs = B * C * (1 + 4 + 4 + 4) + B * C * cfg.max_meas * 4 \
        + st['psi'].numel() * 8
    nbytes = _nbytes(*st.values(), *args, dm['meas_u'], dm['det'],
                     dm['inv_t1'], dm['inv_t2']) + B * C * nu * 4 + outs
    psi_bytes = 2 * st['psi'].numel() * 8
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f'statevec step at B={B} C={C} ({len(differ)} shots decided '
          f'otherwise, max |psi err| {worst:.3g} elsewhere): kernel '
          f'{ms:.4f} ms events / {_device_note(dev_ms)} ms device, plain '
          f'{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes '
          f'{nbytes / 1e9:.3f} GB; psi alone {psi_bytes / 1e9:.3f} GB = '
          f'{psi_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms) on {env["smi"]}')
    return dict(name='statevec_pulse', route='cuda',
                source='distributed_processor_tpu_torch/csrc/statevec.cu',
                replaces='none: the JAX package runs the statevec block in '
                'XLA (distributed_processor_tpu/sim/interpreter.py _step)',
                max_abs_err=worst, ms=ms, dev_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by='bytes', library_ms=None)


def _block_launch_inputs(mp, bits, cfg) -> list:
    """The carries K1 block is launched on in one ``engine='pallas'``
    batch of the looped headline, each cloned as the launch received
    it."""
    from distributed_processor_tpu_torch.sim import interpreter
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    captured, kernel = [], interpreter.exec_blocks

    def capture(st, *args):
        captured.append({k: v.clone() for k, v in st.items()})
        return kernel(st, *args)
    interpreter.exec_blocks = capture
    try:
        simulate_batch(mp, bits, cfg=cfg, device=DEV)
    finally:
        interpreter.exec_blocks = kernel
    return captured


# the carry leaves a block body reads and writes for each lane it runs
# (csrc/exec_span.cu load_lane/store_lane); the slot rows rst_time and
# meas_avail are written one 4-byte slot per reset or measurement
BODY_LEAVES = ('pc', 'regs', 'time', 'offset', 'done', 'err', 'fault', 'pp',
               'n_pulses', 'n_resets', 'n_meas')


def _block_bound_bytes(st: dict, out: dict, act) -> int:
    """The bytes one K1 block launch must move from ``st`` to ``out``:
    ``pc`` and ``done`` read for every lane; the rest of
    :data:`BODY_LEAVES` read, and all of them written, for each lane
    ``act`` that runs a body; one 4-byte slot written per reset or
    measurement it retires, and a 9-word record per pulse when records
    are on."""
    per_lane = sum(st[k][0, 0].numel() * st[k].element_size()
                   for k in BODY_LEAVES)
    every = st['pc'].element_size() + st['done'].element_size()
    n_act = int(act.sum())
    grew = {k: int((out[k] - st[k]).sum()) for k in
            ('n_meas', 'n_resets', 'n_pulses')}
    rec = 9 * 4 * grew['n_pulses'] if 'rec' in st else 0
    return st['pc'].numel() * every + n_act * (2 * per_lane - every) \
        + 4 * (grew['n_meas'] + grew['n_resets']) + rec


def phase_k1_block(mp, env) -> dict:
    """K1 block (``engine='pallas'`` on the looped headline) against the
    plain block engine (``engine='block'``) on the card, on seeded
    injected bits: every key identical at 32768 lanes with records off
    and at 4096 lanes with records and the opcode histogram on; then each
    launch of one batch replayed, the kernel against its plain version,
    with their times per launch and per batch and the bound."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_blocks_per_lane, block_table, exec_blocks)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _apply_blocks, _block_ids, _block_plan, _program_constants, _soa_np,
        simulate_batch)
    from distributed_processor_tpu_torch import isa
    C = mp.n_cores
    for B, record in ((LOOP['batch'], False), (LOOP['record_batch'], True)):
        bits = loop_bits(mp, B, seed=81)
        kw = dict(record_pulses=record, opcode_histogram=record)
        outs = {eng: simulate_batch(mp, bits, cfg=loop_config(
            mp, engine=eng, **kw), device=DEV) for eng in ('pallas', 'block')}
        sync()
        _max_abs_diff(outs['pallas'], outs['block'],
                      f'K1 block vs plain (B={B}, records {record})')
        print(f'K1 block vs plain block engine (B={B}, records {record}, '
              f'histogram {record}): every key identical, steps '
              f"{int(outs['pallas']['steps'])}")
        del outs
    # one batch's launches, replayed: the kernel on a clone of each input
    # (it updates in place), the plain bodies on the input itself
    cfg = loop_config(mp, engine='pallas')
    B = LOOP['batch']
    inputs = _block_launch_inputs(mp, loop_bits(mp, B, seed=82), cfg)
    soa_np = _soa_np(mp)
    _soa, spc, interp, _sync = _program_constants(mp, DEV)
    table = block_table(soa_np, *_block_plan(soa_np), spc, interp, cfg)
    worst, nbytes, retired, active = 0.0, 0, 0, 0
    # the rows each body retires on each core (up to a DONE row)
    kind = soa_np[..., 0]
    eff = np.zeros((len(table.bodies), C), np.int64)
    for k, (s0, L) in enumerate(table.bodies):
        for c in range(C):
            dn = np.nonzero(kind[c, s0:s0 + L] == isa.K_DONE)[0]
            eff[k, c] = dn[0] + 1 if len(dn) else L
    eff_t = torch.as_tensor(eff, device=DEV)
    for st in inputs:
        got = exec_blocks({k: v.clone() for k, v in st.items()}, table, cfg)
        want = _apply_blocks(st, table, cfg)
        sync()
        worst = max(worst, _max_abs_diff(got, want, 'K1 block launch vs '
                                                    'plain bodies'))
        # this launch's bound: its active lanes, their rows and slots
        bid = _block_ids(st['pc'], table.bid)
        act = (bid >= 0) & ~st['done']
        rows = eff_t[bid.clamp(min=0).long(),
                     torch.arange(C, device=DEV)[None, :]]
        retired += int((rows * act).sum())
        active += int(act.sum())
        nbytes += _block_bound_bytes(st, got, act) + soa_np.nbytes \
            + table.bid.numel() * 4 + table.body_tab.numel() * 4 \
            + 2 * spc.numel() * 4
    n = len(inputs)
    # both kernels on fresh clones of the batch's inputs (they work in
    # place): CUDA events around the 27 wrapper calls, and the kernels'
    # device time under the profiler; one thread per lane agrees with the
    # tile kernel launch by launch
    kernels = {'lane': _exec_blocks_per_lane, 'tile': exec_blocks}
    for st in inputs:
        _max_abs_diff(_exec_blocks_per_lane(
            {k: v.clone() for k, v in st.items()}, table, cfg),
            exec_blocks({k: v.clone() for k, v in st.items()}, table, cfg),
            'K1 block one thread per lane vs tile')

    def batch(d, calls):
        sets = iter([[{k: v.clone() for k, v in st.items()} for st in inputs]
                     for _ in range(calls)])
        sync()
        return lambda: [kernels[d](st, table, cfg) for st in next(sets)]

    times = _time_kernels(batch, tuple(kernels), reps=2)
    batch_ms = times['tile'][0]
    # the plain bodies ran on these inputs above: no warm-up
    plain_batch_ms = cuda_time_ms(lambda: [_apply_blocks(st, table, cfg)
                                           for st in inputs], reps=1,
                                  warmup=0)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = retired * SPAN_OPS_PER_INSTR / PEAK_INT32_OPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K1 block at B={B} C={C} N={mp.n_instr}, {len(table.bodies)} '
          f'bodies ({sum(L for _, L in table.bodies)} rows), {n} launches '
          f'per batch, per launch (per batch): '
          + ', '.join(f'kernel {d} {e / n:.5f} ({e:.4f}) ms events / '
                      f'{_device_note(v / n)} ({_device_note(v)}) ms device'
                      for d, (e, v) in times.items())
          + f'; plain {plain_batch_ms / n:.4f} ms per launch, '
          f'{plain_batch_ms:.4f} ms per batch; bound {bound_ms / n:.6f} ms '
          f'per launch, {bound_ms:.5f} ms per batch (bytes '
          f'{nbytes / 1e9:.4f} GB = {t_bytes:.5f} ms, operations {retired} '
          f'rows retired = {t_ops:.5f} ms; {active} lane-bodies) on '
          f'{env["smi"]}')
    del inputs
    return dict(name='exec_blocks', route='cuda',
                source='distributed_processor_tpu_torch/csrc/exec_span.cu',
                replaces='distributed_processor_tpu/sim/interpreter.py:3274',
                max_abs_err=worst, ms=batch_ms / n,
                plain_ms=plain_batch_ms / n,
                bound_ms=bound_ms / n,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def render_run(sim, mp, shots: int, seed: int) -> dict:
    """A headline run with pulse records on seeded injected bits, through
    the facade on the card."""
    import torch
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2, (shots, mp.n_cores, 16), generator=gen,
                         device=DEV, dtype=torch.int32)
    out = sim.run(mp, shots=shots, meas_bits=bits, record_pulses=True)
    check(not bool(out['incomplete']) and not bool(out['err'].any())
          and not bool(out['fault'].any()),
          'the render run left shots incomplete, errored or faulted')
    out['_bits'] = bits
    return out


def measured_shots(out: dict, core: int = 0) -> tuple:
    """The first shot whose first measurement on ``core`` read 1, and the
    first that read 0."""
    first = out['_bits'][:, core, 0]
    return int(first.nonzero()[0]), int((first == 0).nonzero()[0])


def capture_records(seed: int, interp: int) -> tuple:
    """Records and envelope table of a long capture: ``n_pulses`` seeded
    non-overlapping pulses over ``n_clks`` clocks, one of them CW and one
    running past the end of its table."""
    import numpy as np
    rng = np.random.default_rng(seed)
    P, n_clks, L = CAPTURE['n_pulses'], CAPTURE['n_clks'], CAPTURE['env_len']
    slot = n_clks // P
    gtime = np.arange(P) * slot + rng.integers(0, slot // 8, P)
    # lengths in 4-sample words: at most half a slot of clocks
    max_nw = max(2, slot * CAPTURE['spc'] // (8 * interp))
    nw = rng.integers(1, min(max_nw, L // 8), P)
    nw[40] = max(nw[40], 8)
    addr = rng.integers(0, (L - 4 * nw) // 4)           # fits the table
    addr[40] = (L - 2 * nw[40]) // 4                    # overruns it
    nw[20], addr[20] = 0xfff, rng.integers(0, L // 4)   # CW
    rec = dict(gtime=gtime.astype(np.int32),
               env=((nw << 12) | addr).astype(np.int32),
               phase=rng.integers(0, 1 << 17, P).astype(np.int32),
               freq_rel=rng.uniform(0, 0.5, P).astype(np.float32),
               amp=rng.integers(1 << 12, 1 << 16, P).astype(np.int32),
               elem=np.zeros(P, np.int32), n_pulses=np.int32(P))
    env = (rng.uniform(-1, 1, L) + 1j * rng.uniform(-1, 1, L)) * 0.7
    return rec, env


def _render_bound_ms(rec: dict, table, n_clks: int) -> tuple:
    """K4's bound for one render, from its inputs: the valid record rows
    read once (six int32 fields a row) with ``n_pulses`` and the render
    table, every sample written once; one NCO evaluation per in-window
    sample (pulses of one element do not overlap).  Returns (bytes ms,
    operations ms, samples)."""
    import numpy as np
    from distributed_processor_tpu_torch.ops.waveform import (
        _REC_FIELDS, _TRACE_FIELDS, descriptors_from_records)
    rows = rec['gtime'].shape[1]
    n_valid = rec['n_pulses'].clamp(0, rows).sum().item()
    inside, samples = 0, 0
    for row in table.rows.tolist():
        t = dict(zip(_TRACE_FIELDS, row))
        r = {k: rec[k][t['core']] for k in _REC_FIELDS + ('n_pulses',)}
        words = table.inc[t['inc_off']:t['inc_off'] + t['n_inc'] + 1]
        d = descriptors_from_records(r, words, t['spc'], t['interp'], n_clks,
                                     t['elem']).cpu().numpy()
        n = n_clks * t['spc']
        inside += int(np.clip(np.minimum(d[1].astype(np.int64), n)
                              - np.maximum(d[0], 0), 0, None).sum())
        samples += n
    nbytes = n_valid * len(_REC_FIELDS) * 4 + samples * 8 + _nbytes(
        rec['n_pulses'], table.traces, table.env, table.inc)
    return (nbytes / PEAK_HBM_BYTES * 1e3,
            inside * WAVE_OPS / PEAK_F32_FLOPS * 1e3, samples)


def phase_k4(sim, out, env) -> dict:
    """K4 against its plain version on the card: every (core, element)
    trace of two shots of a headline run's records in one launch each,
    and the long capture at interp 1 and 16 as one-trace calls; its time
    per render and at the capture (CUDA events around the wrapper, device
    time under the profiler) beside the plain version's and the bound."""
    import torch
    from distributed_processor_tpu_torch.ops.waveform import (
        _render_plain, default_n_clks, element_inputs, render_shot,
        render_table, shot_records, synthesize_element,
        synthesize_element_reference)
    worst = 0.0

    def agree(got, want, what):
        nonlocal worst
        sync()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f'{what}: shape {tuple(got.shape)} or non-finite values')
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(err <= K4_ATOL, f'{what}: max |err| {err:.3e} > {K4_ATOL}')
        worst = max(worst, err)
        return float(want.abs().max())

    def timed_render(rec, table, n_clks):
        """(events ms, device ms, plain ms, bytes bound ms, operations
        bound ms, samples) of one render on these inputs."""
        fn = lambda: render_shot(rec, table, n_clks)     # noqa: E731
        return (cuda_time_ms(fn, reps=20),
                _kernel_ms(fn, 20, 'render_kernel'),
                cuda_time_ms(lambda: _render_plain(rec, table, n_clks),
                             reps=3),
                *_render_bound_ms(rec, table, n_clks))

    mp = out['_mp']
    table = render_table(mp, device=DEV)
    s1, s0 = measured_shots(out)
    for shot in (s1, s0):
        rec = shot_records(out, shot, table.traces.device)
        n_clks = default_n_clks(out, shot)
        peak = agree(render_shot(rec, table, n_clks),
                     _render_plain(rec, table, n_clks),
                     f'K4 render of shot {shot}')
        print(f'K4 vs plain (headline records, shot {shot}, '
              f'{len(table.rows)} traces in one launch, n_clks {n_clks}): '
              f'agree to atol {K4_ATOL}, max |err| so far {worst:.3e}, '
              f'peak |trace| {peak:.3f}')
    n_samples = CAPTURE['n_clks'] * CAPTURE['spc']
    for interp in (1, 16):
        rec_np, env_table = capture_records(seed=51 + interp, interp=interp)
        args = (rec_np, env_table, CAPTURE['spc'], interp, CAPTURE['n_clks'])
        peak = agree(synthesize_element(*args, device=DEV),
                     synthesize_element_reference(*args, device=DEV),
                     f'K4 long capture interp {interp}')
        rec, tab = element_inputs(rec_np, env_table, CAPTURE['spc'], interp,
                                  0, DEV)
        ms, dev_ms, plain_ms, t_bytes, t_ops, _ = timed_render(
            rec, tab, CAPTURE['n_clks'])
        print(f'K4 long capture ({n_samples} samples, {CAPTURE["n_pulses"]} '
              f'pulses, interp {interp}, one-trace call): agree, max |err| so '
              f'far {worst:.3e}, peak |trace| {peak:.3f}; kernel {ms:.5f} ms '
              f'events, {dev_ms:.5f} ms device; plain {plain_ms:.4f} ms; '
              f'bound {max(t_bytes, t_ops):.5f} ms (bytes {t_bytes:.5f}, '
              f'operations {t_ops:.5f}) on {env["smi"]}')
    # one headline render (the measured-1 shot)
    rec = shot_records(out, s1, table.traces.device)
    n_clks = default_n_clks(out, s1)
    ms, dev_ms, plain_ms, t_bytes, t_ops, samples = timed_render(
        rec, table, n_clks)
    bound_ms = max(t_bytes, t_ops)
    print(f'K4 headline render ({len(table.rows)} traces, {samples} samples, '
          f'n_clks {n_clks}, one launch): kernel {ms:.5f} ms events, '
          f'{dev_ms:.5f} ms device; plain {plain_ms:.4f} ms; bound '
          f'{bound_ms:.6f} ms (bytes {t_bytes:.6f}, operations {t_ops:.6f}) '
          f'on {env["smi"]}')
    return dict(name='render_shot', route='cuda',
                source='distributed_processor_tpu_torch/csrc/waveform.cu',
                replaces='distributed_processor_tpu/ops/waveform_pallas.py:84',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def phase_k5(env) -> dict:
    """K5 against its plain version (``adc @ weights``, float32 with TF32
    off) on the card at the path's shape, at a ragged shot count, at
    2M = 2 and at a window that is tiled and unaligned; its time beside
    the plain version's, the library's call and its bound."""
    import torch
    from distributed_processor_tpu_torch.ops.demod import (
        demod_iq, demod_iq_reference)
    # the plain version and the library's call are full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    S, N, J = HEADLINE['batch'], 1024, 8
    gen = torch.Generator(device=DEV)
    gen.manual_seed(61)
    adc = torch.randn((S, N), generator=gen, device=DEV)
    worst, worst_ratio = 0.0, 0.0

    def agree(a, w, what):
        nonlocal worst, worst_ratio
        got, want = demod_iq(a, w), demod_iq_reference(a, w)
        sync()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f'{what}: shape {tuple(got.shape)} or non-finite values')
        err = (got - want).abs()
        tol = K5_ATOL + K5_RTOL * want.abs()
        worst = max(worst, float(err.max()))
        worst_ratio = max(worst_ratio, float((err / tol).max()))
        check(not bool((err > tol).any()),
              f'{what}: {int((err > tol).sum())} sums differ from the plain '
              f'version (max |err| {float(err.max()):.3e})')
        print(f'K5 vs plain ({what}): agree to rtol {K5_RTOL} / atol '
              f'{K5_ATOL}, max |err| {float(err.max()):.3e}, max |err|/tol '
              f'{float((err / tol).max()):.3f}')

    weights = torch.randn((N, J), generator=gen, device=DEV)
    agree(adc, weights, f'S={S} N={N} 2M={J}')
    agree(adc[:S - 37], weights, f'ragged S={S - 37} N={N} 2M={J}')
    agree(adc, weights[:, :2].contiguous(), f'S={S} N={N} 2M=2')
    # a window past one staged tile, no multiple of 4 (scalar loads), and
    # more columns than one pass holds
    a2 = torch.randn((4099, 2500 + 1), generator=gen, device=DEV)
    w2 = torch.randn((2501, 12), generator=gen, device=DEV)
    agree(a2, w2, 'S=4099 N=2501 2M=12')
    del a2, w2
    ms = cuda_time_ms(lambda: demod_iq(adc, weights), reps=20)
    plain_ms = cuda_time_ms(lambda: demod_iq_reference(adc, weights), reps=20)
    library_ms = cuda_time_ms(lambda: torch.matmul(adc, weights), reps=20)
    nbytes = (S * N + N * J + S * J) * 4
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2 * S * N * J / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'K5 at S={S} N={N} 2M={J}: kernel {ms:.4f} ms '
          f'({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, '
          f'torch.matmul (float32, TF32 off) {library_ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms (bytes {nbytes / 1e9:.3f} GB = {t_bytes:.4f} '
          f'ms, operations {t_ops:.4f} ms); kernel / library '
          f'{ms / library_ms:.3f} on {env["smi"]}')
    return dict(name='demod_iq', route='cuda',
                source='distributed_processor_tpu_torch/csrc/demod.cu',
                replaces='distributed_processor_tpu/ops/demod.py:93',
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=library_ms)


def phase_render_path(env) -> dict:
    """The render-and-readout path through the facade on the card: compile
    the headline, run it with pulse records, render a measured-1 and a
    measured-0 shot (one K4 launch each for all 24 traces), then
    demodulate 262144 noisy ADC traces of the rendered readout window (one
    K5 launch) and discriminate.  Returns the launches of K4 and K5 in
    this run."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch import Simulator
    from distributed_processor_tpu_torch.ops import (
        demod_iq_reference, discriminate, iq_to_complex,
        pulse_window_weights, stack_window_weights)
    S = HEADLINE['batch']
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    sim = Simulator(n_qubits=HEADLINE['n_qubits'], device=DEV)
    mp = sim.compile(headline_source())
    out = render_run(sim, mp, HEADLINE['render_shots'], seed=71)
    sync()
    t_run = time.perf_counter() - t0
    s1, s0 = measured_shots(out)
    n_elems = sum(len(t.elem_cfgs) for t in mp.tables)
    traces, t_render = {}, {}
    for shot in (s1, s0):
        before = _launches()['render_shot']
        t0 = time.perf_counter()
        traces[shot] = sim.waveforms(out, shot=shot)
        t_render[shot] = time.perf_counter() - t0
        n_launch = _launches()['render_shot'] - before
        check(n_launch == 1 and n_elems == 24
              and sum(map(len, traces[shot].values())) == n_elems,
              f'render of shot {shot} launched K4 {n_launch} times for '
              f'{n_elems} traces')
        check(all(np.isfinite(t).all() for c in traces[shot].values()
                  for t in c), f'render of shot {shot} is not finite')
    e1, e0 = (float(np.abs(iq_to_complex(traces[s][0][0])).sum())
              for s in (s1, s0))
    check(e1 > e0, f'qdrv of the measured-1 shot carries {e1:.2f}, no more '
                   f'than the measured-0 shot ({e0:.2f})')
    # the card's traces against the CPU's plain render of the same records
    cpu = Simulator(n_qubits=HEADLINE['n_qubits'], device='cpu')
    worst = 0.0
    for shot in (s1, s0):
        ref = cpu.waveforms(out, shot=shot)
        for c in ref:
            for e, want in enumerate(ref[c]):
                got = traces[shot][c][e]
                check(got.shape == want.shape, f'trace shape {got.shape} vs '
                                               f'{want.shape}')
                worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= K4_ATOL, f'card render differs from the CPU plain render '
                            f'by {worst:.3e} > {K4_ATOL}')
    print(f'render path: compile + run {HEADLINE["render_shots"]} shots with '
          f'records {t_run:.3f} s; waveforms(shot={s1}) {t_render[s1]:.4f} s '
          f'(the first call builds the render table) and (shot={s0}) '
          f'{t_render[s0]:.4f} s, one K4 launch each for {n_elems} traces; '
          f'qdrv energy {e1:.2f} (measured 1) > {e0:.2f} (measured 0); card '
          f'vs CPU plain render max |diff| {worst:.3e} on {env["smi"]}')

    # readout at full shot width: the rendered rdlo window of core 0 as
    # the tone, a state-dependent phase of 0 or pi/2, Gaussian ADC noise
    tables = mp.tables[0]
    ecfg = tables.elem_cfgs[2]
    spc = ecfg.samples_per_clk
    n_p = int(out['n_pulses'][s1, 0])
    elems = out['rec_elem'][s1, 0, :n_p].cpu().numpy()
    i = int(np.nonzero(elems == 2)[0][0])
    gtime = int(out['rec_gtime'][s1, 0, i])
    dur = int(out['rec_dur'][s1, 0, i])
    f_idx = int(out['rec_freq'][s1, 0, i])
    N = dur * spc
    check(N == 1024, f'the readout window is {N} samples, not 1024')
    tone = torch.as_tensor(traces[s1][0][2][gtime * spc:gtime * spc + N],
                           device=DEV)                        # [N, 2]
    # a multiplexed line: core 0's matched window beside the windows of
    # three more readout frequencies
    freqs = [tables.freqs[2]['freq'][f_idx]] + [
        mp.tables[c].freqs[2]['freq'][0] for c in (1, 2, 3)]
    W = stack_window_weights(
        [pulse_window_weights(gtime, dur, spc, f, ecfg.sample_freq)
         for f in freqs], N)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(72)
    states = torch.randint(0, 2, (S,), generator=gen, device=DEV)
    # Re(tone * e^{i phase}): phase 0 reads I, phase pi/2 reads -Q
    adc = torch.where(states[:, None] == 1, -tone[None, :, 1],
                      tone[None, :, 0])
    adc = adc + HEADLINE['adc_sigma'] * torch.randn(
        (S, N), generator=gen, device=DEV)
    # calibrated centroids: the noiseless tone in either state
    cal = demod_iq_reference(torch.stack([tone[:, 0], -tone[:, 1]]), W)
    c0, c1 = cal[0].cpu().numpy(), cal[1].cpu().numpy()       # [M, 2]
    before = _launches()['demod_iq']
    sync()
    t0 = time.perf_counter()
    iq = sim.demod_readout(out, adc, W)
    bits = discriminate(iq, c0, c1)
    sync()
    t_demod = time.perf_counter() - t0
    check(_launches()['demod_iq'] - before == 1,
          'demod_readout did not launch K5 exactly once')
    check(tuple(iq.shape) == (S, 4, 2) and bool(torch.isfinite(iq).all()),
          f'demod output {tuple(iq.shape)} or non-finite')
    fidelity = float((bits[:, 0] == states).float().mean())
    check(fidelity > 0.99, f'readout fidelity {fidelity:.5f} <= 0.99')
    # bits against the plain path's, except within the demod tolerance of
    # the threshold
    iq_p = demod_iq_reference(adc, W)
    bits_p = discriminate(iq_p, c0, c1)
    axis = torch.as_tensor(c1 - c0, device=DEV)
    mid = torch.as_tensor((c0 + c1) / 2, device=DEV)
    proj = ((iq_p - mid[None]) * axis[None]).sum(-1)
    near = proj.abs() <= (K5_ATOL + K5_RTOL * iq_p.abs().amax(-1)) \
        * axis.abs().sum(-1)[None]
    differ = bits != bits_p
    check(not bool((differ & ~near).any()),
          f'{int((differ & ~near).sum())} bits differ from the plain path '
          f'away from the threshold')
    counts = _launches()
    check(_only_launched(counts, 'render_shot', 'demod_iq'),
          f'render path launched other kernels: {counts}')
    print(f'readout path: {S} ADC traces x {N} samples, 4 windows: '
          f'demod_readout + discriminate {t_demod:.4f} s, K5 launches 1, '
          f'fidelity {fidelity:.5f}, max |iq - plain| '
          f'{float((iq - iq_p).abs().max()):.3e} on sums up to '
          f'{float(iq_p.abs().max()):.1f}, bits differing from the '
          f'plain path {int(differ.sum())} (all within tolerance of the '
          f'threshold; {int(near.sum())} decisions are that close) on '
          f'{env["smi"]}')
    # the wall time of a render, 20 more calls in this run, after the
    # path's launches are read: the median, with the spread
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        sim.waveforms(out, shot=s1)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    print(f'render wall: waveforms(shot={s1}) x 20: median '
          f'{(walls[9] + walls[10]) / 2 * 1e3:.4f} ms, min '
          f'{walls[0] * 1e3:.4f} ms, max {walls[-1] * 1e3:.4f} ms (one K4 '
          f'launch, one scalar read, one copy to the host each) on '
          f'{env["smi"]}')
    return counts


def phase_main_path(mp, env) -> tuple:
    """The headline physics-closed batch on the card: the bench's config
    resolves to the straight-line engine, whose pass is one launch of
    K3's physics pass an epoch, with K2 resolving each epoch; the generic
    engine's batch is timed beside it.  Returns K2's and the physics
    pass's launches in the main path's run."""
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import \
        resolve_engine
    from distributed_processor_tpu_torch.sim.physics import (
        physics_config, run_physics_batch)
    B = HEADLINE['batch']
    model, cfg = headline_model(), headline_config(mp)
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'straightline',
          f'the headline config resolves to {eng!r}, not the straight-line '
          f'engine of the JAX package')
    print(f'main path: engine=None, straightline=None resolves to {eng!r}')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2026, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['resolve_windows']
    epochs = int(out['epochs'])
    check(not bool(out['incomplete']), 'main path left shots incomplete')
    check(sum(stats['fault_shots']) == 0,
          f'main path faulted shots: {stats["fault_shots"]}')
    check(launches == epochs and epochs > 0,
          f'resolve kernel launched {launches} times in {epochs} epochs')
    check(counts['exec_span_physics'] == epochs,
          f"K3's physics pass launched {counts['exec_span_physics']} times "
          f'in {epochs} epochs')
    check(_only_launched(counts, 'resolve_windows', 'exec_span_physics'),
          f'main path launched other kernels: {counts}')
    check(int(out['steps']) == epochs * mp.n_instr,
          f"straight-line steps {int(out['steps'])}, want {epochs} x "
          f'{mp.n_instr}')
    C = mp.n_cores
    check(tuple(out['meas_bits'].shape) == (B, C, 2)
          and bool(out['meas_bits_valid'].all()),
          'main path left measurement slots unresolved')
    check(stats['err_shots'] == 0, f'{stats["err_shots"]} errored shots')
    meas1 = out['meas_bits'].float().mean(0)                 # [C, 2]
    print(f'main path: {B} shots, epochs {epochs}, resolve launches '
          f"{launches}, K3 physics pass launches "
          f"{counts['exec_span_physics']}, {dt:.3f} s ({B / dt:.1f} "
          f'shots/s, first call)')
    print('main path stats: ' + json.dumps(stats))
    print('main path P(1) per core and slot: '
          + json.dumps([[round(x, 5) for x in r] for r in meas1.tolist()]))
    # steady state: a batch with another seed on each engine, after an
    # untimed one on that engine
    for label, run_cfg in (('engine=None', cfg),
                           ("engine='generic'",
                            headline_config(mp, engine='generic'))):
        int(run_physics_batch(mp, model, 2031, B, cfg=run_cfg,
                              device=DEV)['epochs'])
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        out = run_physics_batch(mp, model, 2027, B, cfg=run_cfg, device=DEV)
        epochs = int(out['epochs'])
        sync()
        dt = time.perf_counter() - t0
        print(f'main path steady batch, {label}: {dt:.3f} s, '
              f'{B / dt:.1f} shots/s, epochs {epochs}, steps '
              f"{int(out['steps'])}, kernel launches {_launches()} "
              f'on {env["smi"]}')
        profile_batch(lambda: int(run_physics_batch(
            mp, model, 2028, B, cfg=run_cfg, device=DEV)['epochs']), label)
    return launches, counts['exec_span_physics']


def phase_k1_path(mp, env) -> int:
    """The K1 path: ``simulate_batch`` with ``engine='pallas'`` on seeded
    injected bits at 262144 shots, then ``engine='auto'``, which takes
    the kernel on the card.  Returns K1's launches in the pallas run."""
    import torch
    from distributed_processor_tpu_torch.ops.exec_span import exec_span
    from distributed_processor_tpu_torch.sim.interpreter import (
        FAULT_CODES, fault_shot_counts, simulate_batch)
    B, C = HEADLINE['batch'], mp.n_cores
    gen = torch.Generator(device=DEV)
    gen.manual_seed(41)
    bits = torch.randint(0, 2, (B, C, 2), generator=gen, device=DEV,
                         dtype=torch.int32)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = simulate_batch(mp, bits, cfg=headline_config(mp, engine='pallas'),
                         device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['exec_span']
    check(launches == 1 and _only_launched(counts, 'exec_span'),
          f'K1 path launches: {counts}')
    faults = fault_shot_counts(out['fault']).tolist()
    check(bool(out['done'].all()) and not any(faults),
          f'K1 path left lanes undone or faulted: '
          f'{dict(zip([n for n, _ in FAULT_CODES], faults))}')
    check(int(out['steps']) == mp.n_instr and tuple(out['regs'].shape)
          == (B, C, 16), 'K1 path output has the wrong shape or steps')
    print(f"K1 path: simulate_batch(engine='pallas') {B} shots in "
          f'{dt:.4f} s (first call), K1 launches {launches}')
    sync()
    t0 = time.perf_counter()
    simulate_batch(mp, bits, cfg=headline_config(mp, engine='pallas'),
                   device=DEV)
    sync()
    print(f"K1 path steady batch: {time.perf_counter() - t0:.4f} s on "
          f'{env["smi"]}')
    before = exec_span.launches
    auto = simulate_batch(mp, bits, cfg=headline_config(mp, engine='auto'),
                          device=DEV)
    check(exec_span.launches == before + 1,
          f"engine='auto' on the card launched K1 "
          f'{exec_span.launches - before} times')
    _max_abs_diff(auto, out, "engine='auto' vs engine='pallas'")
    print("K1 path: engine='auto' on the card took K1 (one launch), "
          'outputs identical')
    return launches


def phase_k3_path(mp, env) -> int:
    """The K3 path: ``run_physics_batch`` with ``engine='fused'`` at
    sigma = 0 and 262144 shots.  Returns K3's launches in that run."""
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B, C = HEADLINE['batch'], mp.n_cores
    model = headline_model(sigma=0.0)
    cfg = headline_config(mp, engine='fused')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2029, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    launches = counts['exec_span_fused']
    check(launches == 1 and _only_launched(counts, 'exec_span_fused'),
          f'K3 path launches: {counts}')
    check(int(out['epochs']) == 1, f"K3 path took {int(out['epochs'])} "
          f'epochs')
    check(not bool(out['incomplete']) and sum(stats['fault_shots']) == 0
          and stats['err_shots'] == 0, f'K3 path faults or errors: {stats}')
    check(tuple(out['meas_bits'].shape) == (B, C, 2)
          and bool(out['meas_bits_valid'].all()),
          'K3 path left measurement slots unresolved')
    print(f"K3 path: run_physics_batch(engine='fused', sigma=0) {B} shots "
          f'in {dt:.4f} s (first call), epochs 1, K3 launches {launches}; '
          f'stats {json.dumps(stats)}')
    sync()
    t0 = time.perf_counter()
    int(run_physics_batch(mp, model, 2030, B, cfg=cfg, device=DEV)['epochs'])
    sync()
    print(f'K3 path steady batch: {time.perf_counter() - t0:.4f} s on '
          f'{env["smi"]}')
    return launches


def phase_loop_path(mp, env) -> int:
    """The loop path: the looped headline through ``simulate_batch`` with
    ``engine='pallas'``, then ``'auto'``, at 32768 lanes on seeded
    injected bits (K1 block, one launch per block-engine iteration),
    equal to the plain block engine and to the generic engine, with the
    three engines' steady batches timed and profiled; then the physics
    batch at sigma = 0.05 under ``'auto'`` (the block engine, K2 per
    epoch); then sigma = 0 on the card against the CPU.  Returns K1
    block's launches in the pallas run."""
    import numpy as np
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import (
        FAULT_CODES, fault_shot_counts, resolve_engine, simulate_batch)
    from distributed_processor_tpu_torch.sim.physics import (
        physics_config, run_physics_batch)
    B, C = LOOP['batch'], mp.n_cores
    bits = loop_bits(mp, B, seed=91)
    outs, launches = {}, {}
    for eng in ('pallas', 'auto'):
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        out = simulate_batch(mp, bits, cfg=loop_config(mp, engine=eng),
                             device=DEV)
        sync()
        dt = time.perf_counter() - t0
        counts = _launches()
        steps = int(out['steps'])
        check(counts['exec_blocks'] == steps > 0
              and _only_launched(counts, 'exec_blocks'),
              f'loop path ({eng}) launches: {counts}, {steps} iterations')
        faults = dict(zip([name for name, _ in FAULT_CODES],
                          fault_shot_counts(out['fault']).tolist()))
        check(not bool(out['incomplete']) and not any(faults.values())
              and not bool(out['err'].any()),
              f'loop path ({eng}) faults {faults} or errors '
              f"{int((out['err'] != 0).sum())}")
        check(bool((out['n_meas'] == LOOP['max_meas']).all()),
              f'loop path ({eng}): n_meas is not {LOOP["max_meas"]} on '
              f'every core')
        outs[eng], launches[eng] = out, counts['exec_blocks']
        print(f"loop path: simulate_batch(engine='{eng}') {B} lanes x "
              f'{LOOP["n_shots"] + 1} iterations in {dt:.4f} s (first call '
              f'of this engine), {steps} block iterations, K1 block '
              f'launches {counts["exec_blocks"]}, no other kernel')
    _max_abs_diff(outs['auto'], outs['pallas'],
                  "loop path: engine='auto' vs engine='pallas'")
    # the plain block and generic engines on the same bits (each ran
    # before this phase, so these are steady batches), then one profiled
    # batch of each of the three engines
    for eng in ('block', 'generic'):
        sync()
        t0 = time.perf_counter()
        outs[eng] = simulate_batch(mp, bits, cfg=loop_config(mp, engine=eng),
                                   device=DEV)
        sync()
        dt = time.perf_counter() - t0
        print(f"loop path steady batch, engine='{eng}': {dt:.4f} s, "
              f'{B * (LOOP["n_shots"] + 1) / dt:.1f} shots/s, steps '
              f"{int(outs[eng]['steps'])} on {env['smi']}")
    _max_abs_diff(outs['block'], outs['pallas'],
                  "loop path: engine='block' vs engine='pallas'")
    ref = {k: v for k, v in outs['generic'].items() if k != 'steps'}
    _max_abs_diff({k: v for k, v in outs['pallas'].items() if k != 'steps'},
                  ref, "loop path: engine='pallas' vs engine='generic'")
    print(f"loop path: outputs identical to engine='block' (steps "
          f"{int(outs['block']['steps'])}) and engine='generic' (every key "
          f"but steps: {int(outs['generic']['steps'])} steps); no fault, err "
          f'0, n_meas {LOOP["max_meas"]} on every core')
    del outs, ref
    steady = loop_bits(mp, B, seed=92)
    for eng in ('generic', 'block', 'pallas'):
        cfg = loop_config(mp, engine=eng)
        if eng == 'pallas':
            _reset_launches()
            sync()
            t0 = time.perf_counter()
            simulate_batch(mp, steady, cfg=cfg, device=DEV)
            sync()
            dt = time.perf_counter() - t0
            print(f"loop path steady batch, engine='pallas': {dt:.4f} s, "
                  f'{B * (LOOP["n_shots"] + 1) / dt:.1f} shots/s, kernel '
                  f'launches {_launches()} on {env["smi"]}')
        profile_batch(lambda: int(simulate_batch(
            mp, steady, cfg=cfg, device=DEV)['steps']),
            f"loop path engine='{eng}'")

    # physics at sigma = 0.05: 'auto' resolves to the block engine
    model = headline_model(sigma=LOOP['sigma'])
    cfg = loop_config(mp, engine='auto')
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'block', f"the loop's physics run resolves to {eng!r}")
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 2032, B, cfg=cfg, device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    epochs = int(out['epochs'])
    check(counts['resolve_windows'] == epochs > 0
          and _only_launched(counts, 'resolve_windows'),
          f'loop physics launches {counts} in {epochs} epochs')
    check(not bool(out['incomplete']) and sum(stats['fault_shots']) == 0,
          f'loop physics faults: {stats["fault_shots"]}')
    check(bool((out['n_meas'] == LOOP['max_meas']).all())
          and bool(out['meas_bits_valid'].all()),
          'loop physics left measurement windows unresolved')
    print(f"loop path physics (sigma={LOOP['sigma']}, engine='auto' -> "
          f"'{eng}'): {B} lanes in {dt:.3f} s, epochs {epochs}, K2 launches "
          f"{counts['resolve_windows']}, block iterations "
          f"{int(out['steps'])}; stats {json.dumps(stats)} on {env['smi']}")

    # sigma = 0 on the card and on the CPU (the plain versions there)
    Bc = LOOP['cpu_batch']
    init = np.random.default_rng(93).integers(0, 2, (Bc, C))
    model = headline_model(sigma=0.0)
    t = {}
    res = {}
    for d in (DEV, 'cpu'):
        t0 = time.perf_counter()
        res[d] = run_physics_batch(mp, model, 11, Bc, init_states=init,
                                   cfg=cfg, device=d)
        sync()
        t[d] = time.perf_counter() - t0
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'n_meas', 'err',
                'fault', 'qturns', 'epochs', 'steps', 'time', 'regs'):
        a, b = (res[d][key].cpu().numpy() for d in (DEV, 'cpu'))
        check(np.array_equal(a, b), f'loop physics: CUDA and CPU differ in '
                                    f'{key}')
    sa, sb = (physics_batch_stats(res[d]) for d in (DEV, 'cpu'))
    for key in sa:
        check(np.array_equal(sa[key].cpu().numpy(), sb[key].cpu().numpy()),
              f'loop physics: CUDA and CPU differ in stats {key}')
    print(f'loop path CUDA vs CPU at sigma=0, B={Bc}: bits and stats '
          f"identical (epochs {int(res['cpu']['epochs'])}; card "
          f"{t[DEV]:.3f} s, CPU {t['cpu']:.3f} s)")
    return launches['pallas']


def lut_workloads() -> list:
    """The 'lut' fabric's span workloads at full width: ``(label, mp,
    cfg)`` of the repetition round (8 cores) and the surface cycle (9
    cores)."""
    from distributed_processor_tpu_torch.models import qec, repetition
    n, d = LUT['n_data'], LUT['distance']
    return [(f'repetition round ({n} cores)',
             repetition.repetition_round_machine_program(n),
             repetition.repetition_config(n)),
            (f'surface cycle d={d} ({2 * d - 1} cores)',
             qec.surface_cycle_machine_program(d),
             qec.surface_cycle_config(d))]


def lut_physics_program():
    """The compiled repetition round (8 qubits) and its config."""
    from distributed_processor_tpu_torch.models import repetition
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    from distributed_processor_tpu_torch.simulator import Simulator
    n = LUT['n_data']
    mp = Simulator(n_qubits=n, device=DEV).compile(
        repetition.repetition_round_program(n))
    return mp, InterpreterConfig(max_steps=mp.n_instr * 6 + 64,
                                 **repetition.repetition_physics_kwargs(n))


def _lut_ops(cfg, reads: int) -> int:
    """The integer operations of ``reads`` LUT reads beyond their rows."""
    k = sum(bool(b) for b in cfg.lut_mask)
    return reads * (k * (cfg.max_meas * LUT_SLOT_OPS + LUT_PRODUCER_OPS)
                    + LUT_READ_OPS)


def _lut_expected_pulses(bits, cfg):
    """Each core's pulse count the LUT's corrections give on injected
    ``bits [B, C, M]`` (slot 0 is each core's measurement): the readout,
    plus an X (two pulses) on each core whose table bit is set."""
    import numpy as np
    b0 = bits[:, :, 0].cpu().numpy().astype(np.int64)
    mask = np.asarray(cfg.lut_mask, bool)
    shifts = np.cumsum(mask) - 1
    addr = (b0[:, mask] << shifts[mask]).sum(1)
    entry = np.asarray(cfg.lut_table, np.int64)[addr]
    # (the surface cycle's ancillas halt after measuring: their table
    # bits are 0)
    corr = (entry[:, None] >> np.arange(b0.shape[1])) & 1
    return 1 + 2 * corr


def phase_lut_span(env) -> dict:
    """The 'lut' fabric on K1 span at full width: the repetition round
    (8 cores) and the surface cycle (9 cores) on seeded injected bits,
    ``engine='pallas'`` (the tile kernel) and ``'auto'`` against the
    straight-line engine on the card, every key (``meas_time`` included)
    identical and each core's corrections the table's; then the tile
    kernel, the one-thread-per-lane kernel and the plain version on the
    same carry, timed, beside the bound restated for the LUT reads.
    Returns ``{label: numbers}``."""
    import dataclasses
    import numpy as np
    import torch
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.ops.exec_span import (
        _exec_span_per_lane, exec_span)
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, resolve_engine, simulate_batch)
    B, res = LUT['batch'], {}
    for label, mp, cfg in lut_workloads():
        C = mp.n_cores
        eng = resolve_engine(mp, dataclasses.replace(cfg, engine='auto'), DEV)
        check(eng == 'pallas', f"lut span {label}: 'auto' on the card "
                               f"resolves to {eng!r}, not K1")
        gen = torch.Generator(device=DEV)
        gen.manual_seed(61 + C)
        bits = torch.randint(0, 2, (B, C, cfg.max_meas), generator=gen,
                             device=DEV, dtype=torch.int32)
        outs = {}
        for e in ('pallas', 'auto', 'straightline'):
            _reset_launches()
            outs[e] = simulate_batch(mp, bits, cfg=dataclasses.replace(
                cfg, engine=e, opcode_histogram=True), device=DEV)
            sync()
            counts = _launches()
            want = 0 if e == 'straightline' else 1
            check(counts['exec_span'] == want
                  and _only_launched(counts, 'exec_span'),
                  f'lut span {label} ({e}) launches: {counts}')
        for e in ('auto', 'straightline'):
            _max_abs_diff(outs['pallas'], outs[e],
                          f"lut span {label}: 'pallas' vs {e!r}")
        out = outs.pop('pallas')
        del outs
        check(bool(out['done'].all()) and not bool(out['fault'].any())
              and not bool(out['err'].any()),
              f'lut span {label}: lanes undone, faulted or errored')
        want_pulses = _lut_expected_pulses(bits, cfg)
        check(np.array_equal(out['n_pulses'].cpu().numpy(), want_pulses),
              f"lut span {label}: corrections differ from the table's")
        hist = out['op_hist']
        retired = int(hist.sum())
        reads = int(hist[isa.K_ALU_FPROC] + hist[isa.K_JUMP_FPROC])
        print(f"lut span {label}: simulate_batch(engine='pallas') and "
              f"'auto' (one K1 launch each) equal to the straight-line "
              f'engine on every key at B={B}; {reads} LUT reads, '
              f'{int((want_pulses > 1).sum())} corrections as the table '
              f'gives')
        del out
        # the kernels on one carry at the path's config
        st, table, _ = _span_inputs(mp, cfg, B, seed=0)
        valid = torch.ones(bits.shape, dtype=torch.bool, device=DEV)
        kernels = {'lane': _exec_span_per_lane, 'tile': exec_span}
        want = exec_span(st, table, bits, cfg)
        _max_abs_diff(_exec_span_per_lane(st, table, bits, cfg), want,
                      f'lut span {label}: one thread per lane vs tile')

        def plain():
            return _exec_straightline(st, table.soa_np, table.spc,
                                      table.interp, bits, valid, cfg)
        worst = _max_abs_diff(want, plain(),
                              f'lut span {label}: kernel vs plain')
        times = _time_kernels(lambda d, _calls: lambda: kernels[d](
            st, table, bits, cfg), tuple(kernels), reps=20)
        plain_ms = cuda_time_ms(plain, reps=2)
        nbytes = _carry_bytes(st) + _carry_bytes(want) + sum(
            t.numel() * t.element_size() for t in
            (bits, table.spc, table.interp, table.lut)) + table.soa_np.nbytes
        ops = retired * SPAN_OPS_PER_INSTR + _lut_ops(cfg, reads)
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = ops / PEAK_INT32_OPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f'lut span {label} K1 at B={B} C={C} N={mp.n_instr} '
              f'(split at index {table.min_read}, LUT of '
              f'{len(cfg.lut_table)} entries): '
              + ', '.join(f'kernel {d} {e:.4f} ms events / '
                          f'{_device_note(v)} ms device'
                          for d, (e, v) in times.items())
              + f'; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms '
              f'(bytes {nbytes / 1e9:.3f} GB = {t_bytes:.4f} ms, operations '
              f'{retired} rows x {SPAN_OPS_PER_INSTR} + {reads} LUT reads = '
              f'{ops:.3e} = {t_ops:.4f} ms) on {env["smi"]}')
        res[label] = dict(ms=times['tile'][0], dev_ms=times['tile'][1],
                          lane_ms=times['lane'][0],
                          lane_dev_ms=times['lane'][1], plain_ms=plain_ms,
                          bound_ms=bound_ms, max_abs_err=worst, launches=1,
                          bound_by='operations' if t_ops >= t_bytes
                          else 'bytes')
        del st, want
        # the same pass without pulse records: what the records cost
        ncfg = dataclasses.replace(cfg, record_pulses=False)
        st, table, _ = _span_inputs(mp, ncfg, B, seed=0)
        got = exec_span(st, table, bits, ncfg)
        n_bytes = _carry_bytes(st) + _carry_bytes(got) + sum(
            t.numel() * t.element_size() for t in
            (bits, table.spc, table.interp, table.lut)) + table.soa_np.nbytes
        del got
        n_dev = _kernel_ms(lambda: exec_span(st, table, bits, ncfg), reps=20)
        print(f'lut span {label} K1 tile without pulse records: '
              f'{_device_note(n_dev)} ms device against '
              f'{n_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms of bytes')
        del st
    return res


def _block_batch_bound(mp, bits, cfg) -> tuple:
    """``(bytes, rows, launches)`` that the K1 block launches of one
    ``engine='pallas'`` batch must move and retire, counted at each launch
    (as :func:`_block_bound_bytes`, plus one ``meas_time`` slot per
    measurement) without keeping its carry."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.sim import interpreter
    from distributed_processor_tpu_torch.sim.interpreter import (
        _block_ids, _soa_np, simulate_batch)
    soa_np, C = _soa_np(mp), mp.n_cores
    kind = soa_np[..., 0]
    tot = dict(nbytes=0, rows=0, n=0)
    kernel = interpreter.exec_blocks

    def count(st, table, cfg):
        eff = np.zeros((len(table.bodies), C), np.int64)
        for k, (s0, L) in enumerate(table.bodies):
            for c in range(C):
                dn = np.nonzero(kind[c, s0:s0 + L] == isa.K_DONE)[0]
                eff[k, c] = dn[0] + 1 if len(dn) else L
        bid = _block_ids(st['pc'], table.bid)
        act = (bid >= 0) & ~st['done']
        rows = torch.as_tensor(eff, device=DEV)[
            bid.clamp(min=0).long(), torch.arange(C, device=DEV)[None, :]]
        before = {k: int(st[k].sum()) for k in
                  ('n_meas', 'n_resets', 'n_pulses')}
        per_lane = sum(st[k][0, 0].numel() * st[k].element_size()
                       for k in BODY_LEAVES)
        every = st['pc'].element_size() + st['done'].element_size()
        n_act = int(act.sum())
        out = kernel(st, table, cfg)
        grew = {k: int(out[k].sum()) - v for k, v in before.items()}
        slots = 4 * (grew['n_meas'] * (2 if 'meas_time' in out else 1)
                     + grew['n_resets'])
        rec = 9 * 4 * grew['n_pulses'] if 'rec' in out else 0
        tot['nbytes'] += st['pc'].numel() * every \
            + n_act * (2 * per_lane - every) + slots + rec + soa_np.nbytes \
            + 4 * (table.bid.numel() + table.body_tab.numel()) \
            + 8 * table.spc.numel()
        tot['rows'] += int((rows * act).sum())
        tot['n'] += 1
        return out
    interpreter.exec_blocks = count
    try:
        simulate_batch(mp, bits, cfg=cfg, device=DEV)
    finally:
        interpreter.exec_blocks = kernel
    return tot['nbytes'], tot['rows'], tot['n']


def phase_lut_block(env) -> dict:
    """The 'lut' fabric on K1 block at full width: 8 unrolled QEC rounds
    on 8 cores (every round's measurement after the previous round's
    read: block mode), seeded injected bits, ``engine='pallas'`` against
    the plain block engine on the card, every key identical and each
    round's corrections the majority table's; the iterations, the
    launches, and K1 block's time per launch beside its bound."""
    import dataclasses
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.models import qec
    from distributed_processor_tpu_torch.sim.interpreter import (
        FAULT_CODES, fault_shot_counts, resolve_engine, simulate_batch)
    B, n, R = LUT['batch'], LUT['n_data'], LUT['rounds']
    mp, cfg = qec.qec_multiround_machine_program(n, R), qec.qec_config(n, R)
    check(resolve_engine(mp, dataclasses.replace(cfg, engine='auto'), DEV)
          == 'pallas', "lut block: 'auto' on the card does not take K1")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(71)
    bits = torch.randint(0, 2, (B, n, R), generator=gen, device=DEV,
                         dtype=torch.int32)
    pcfg = dataclasses.replace(cfg, engine='pallas')
    simulate_batch(mp, bits[:64], cfg=pcfg, device=DEV)     # warm
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = simulate_batch(mp, bits, cfg=pcfg, device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    steps = int(out['steps'])
    check(counts['exec_blocks'] == steps > 0
          and _only_launched(counts, 'exec_blocks'),
          f'lut block launches: {counts}, {steps} iterations')
    sync()
    t0 = time.perf_counter()
    plain = simulate_batch(mp, bits, cfg=dataclasses.replace(
        cfg, engine='block'), device=DEV)
    sync()
    plain_dt = time.perf_counter() - t0
    worst = _max_abs_diff(out, plain, 'lut block: K1 block vs plain block')
    del plain
    faults = dict(zip([name for name, _ in FAULT_CODES],
                      fault_shot_counts(out['fault']).tolist()))
    check(not bool(out['incomplete']) and not any(faults.values())
          and not bool(out['err'].any()),
          f'lut block: faults {faults} or errors')
    b = bits.cpu().numpy()
    maj = (b.sum(1) * 2 > n)                                 # [B, R]
    flips = (b != maj[:, None, :]).sum(2)                    # [B, C]
    check(np.array_equal(out['n_pulses'].cpu().numpy(), R + 2 * flips),
          "lut block: corrections differ from the majority table's")
    check(bool((out['meas_time'] == torch.arange(
        R, device=DEV, dtype=torch.int32) * 1000 + 10).all()),
        'lut block: production clocks are not the rounds\' triggers')
    del out
    wall, kernels = device_kernel_times(lambda: simulate_batch(
        mp, bits, cfg=pcfg, device=DEV))
    dev_ms = sum(us for name, (us, _n) in kernels.items()
                 if 'exec_tile_kernel' in name or 'exec_blocks' in name) / 1e3
    nbytes, rows, n_launch = _block_batch_bound(mp, bits, pcfg)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = rows * SPAN_OPS_PER_INSTR / PEAK_INT32_OPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    # the same batch without pulse records: what the records cost
    ncfg = dataclasses.replace(pcfg, record_pulses=False)
    _wall, nk = device_kernel_times(lambda: simulate_batch(
        mp, bits, cfg=ncfg, device=DEV))
    n_dev = sum(us for name, (us, _n) in nk.items()
                if 'exec_tile_kernel' in name or 'exec_blocks' in name) / 1e3
    n_bytes, _rows, _n = _block_batch_bound(mp, bits, ncfg)
    print(f'lut block without pulse records: K1 block device '
          f'{n_dev / n_launch:.5f} ms per launch against '
          f'{n_bytes / PEAK_HBM_BYTES * 1e3 / n_launch:.6f} ms of bytes')
    print(f"lut block: simulate_batch(engine='pallas') {B} shots x {n} "
          f'cores x {R} rounds in {dt:.4f} s, {steps} block iterations, '
          f'{counts["exec_blocks"]} K1 block launches, no other kernel; '
          f'plain block engine {plain_dt:.4f} s; every key identical; '
          f'K1 block device {dev_ms / n_launch:.5f} ms per launch '
          f'({dev_ms:.4f} ms per batch, profiled wall {wall:.4f} s); '
          f'bound {bound_ms / n_launch:.6f} ms per launch (bytes '
          f'{nbytes / 1e9:.4f} GB = {t_bytes:.5f} ms, {rows} rows = '
          f'{t_ops:.5f} ms per batch) on {env["smi"]}')
    return dict(launches=steps, batch_s=dt, plain_s=plain_dt,
                dev_ms=dev_ms / n_launch, bound_ms=bound_ms / n_launch,
                max_abs_err=worst)


def phase_lut_physics(env) -> dict:
    """The compiled repetition round (8 qubits) closed by the readout
    chain at full width.  At sigma = 0, ``engine='fused'`` (K3 with the
    LUT read, one launch, one epoch) with the initial states cycling all
    256 patterns: every core ends at its pattern's majority, the
    minority cores fired a correction, and every key equals the generic
    engine's but epochs and steps; K3 against its plain version on one
    carry, timed, beside the restated bound.  At sigma = 0.05 (the
    headline's readout model) the straight-line engine with K2 per
    epoch: no fault, every window resolved."""
    import dataclasses
    import numpy as np
    import torch
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.ops.exec_span import \
        exec_span_fused
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import (
        _exec_straightline, _init_state, _span_table, resolve_engine)
    from distributed_processor_tpu_torch.sim.physics import (
        fused_readout, physics_config, prepare_physics_tables,
        run_physics_batch)
    B, n = LUT['batch'], LUT['n_data']
    mp, cfg = lut_physics_program()
    init = ((torch.arange(B, device=DEV)[:, None] % 256)
            >> torch.arange(n, device=DEV)) & 1
    init = init.to(torch.int32)
    model0 = headline_model(sigma=0.0)
    fcfg = dataclasses.replace(cfg, engine='fused')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model0, 5, B, init_states=init, cfg=fcfg,
                            device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    check(counts['exec_span_fused'] == 1
          and _only_launched(counts, 'exec_span_fused'),
          f'lut physics (fused) launches: {counts}')
    check(int(out['epochs']) == 1, f"lut physics: K3 took "
                                   f"{int(out['epochs'])} epochs")
    maj = (init.sum(1) * 2 > n).to(torch.int32)
    check(bool(((out['qturns'] % 4) // 2 == maj[:, None]).all()),
          'lut physics: a core did not end at its pattern\'s majority')
    check(bool((out['n_pulses'] == 2 + 2 * (init != maj[:, None]).to(
        torch.int32)).all()), 'lut physics: corrections fired on the '
                              'wrong cores')
    check(not bool(out['err'].any()) and not bool(out['fault'].any())
          and bool(out['meas_bits_valid'][:, :, 0].all()),
          'lut physics: errors, faults or unresolved windows')
    generic = run_physics_batch(mp, model0, 5, B, init_states=init,
                                cfg=dataclasses.replace(cfg,
                                                        engine='generic'),
                                device=DEV)
    for key in generic:
        if key not in ('epochs', 'steps'):
            check(torch.equal(out[key], generic[key]),
                  f'lut physics: K3 and the generic engine differ in {key}')
    print(f"lut physics: run_physics_batch(engine='fused', sigma=0) {B} "
          f'shots (all 256 patterns) in {dt:.4f} s, one K3 launch, one '
          f'epoch (generic: {int(generic["epochs"])}); every core at its '
          f"pattern's majority, corrections on the minority cores; every "
          f'key but epochs and steps equal to the generic engine\'s')
    del out, generic
    # K3 against its plain version on one carry
    pcfg = physics_config(fcfg, model0)
    fused = fused_readout(mp, model0, prepare_physics_tables(mp, model0,
                                                             DEV))
    table = _span_table(mp, pcfg, DEV, fused=True)
    st = _init_state(B, n, pcfg, None, DEV)
    st['qturns'] = 2 * init
    bits0 = torch.zeros((B, n, pcfg.max_meas), dtype=torch.int32, device=DEV)
    valid0 = torch.zeros(bits0.shape, dtype=torch.bool, device=DEV)

    def kernel():
        return exec_span_fused(st, table, bits0, valid0, pcfg, fused)

    def plain():
        o = _exec_straightline(dict(st, meas_bits=bits0, meas_valid=valid0),
                               table.soa_np, table.spc, table.interp, None,
                               None, pcfg, fused=fused)
        return o, o.pop('meas_bits'), o.pop('meas_valid')
    got, want = kernel(), plain()
    sync()
    worst = _max_abs_diff(dict(got[0], meas_bits=got[1], meas_valid=got[2]),
                          dict(want[0], meas_bits=want[1],
                               meas_valid=want[2]), 'lut physics: K3 vs plain')
    del want
    hcfg = dataclasses.replace(pcfg, opcode_histogram=True)
    hst = _init_state(B, n, hcfg, None, DEV)
    hst['qturns'] = 2 * init
    hist = exec_span_fused(hst, _span_table(mp, hcfg, DEV, fused=True),
                           bits0, valid0, hcfg, fused)[0]['op_hist'].sum(
        (0, 1))
    retired = int(hist.sum())
    reads = int(hist[isa.K_ALU_FPROC] + hist[isa.K_JUMP_FPROC])
    del hst
    ms = cuda_time_ms(kernel, reps=20)
    dev_ms = _kernel_ms(kernel, reps=20)
    plain_ms = cuda_time_ms(plain, reps=1)
    n_meas = int(got[2].sum())
    int_ops = retired * SPAN_OPS_PER_INSTR + _lut_ops(pcfg, reads)
    ops = int_ops + n_meas * (1 + DISCRIMINATE_OPS)
    nbytes = _carry_bytes(st) + _carry_bytes(got[0]) + 2 * sum(
        t.numel() * t.element_size() for t in (bits0, valid0)) + sum(
        t.numel() * t.element_size() for t in
        (table.spc, table.interp, table.lut, fused['e2p'], fused['g0'],
         fused['g1'])) + table.soa_np.nbytes
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(int_ops / PEAK_INT32_OPS, ops / PEAK_ISSUE) * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f'lut physics K3 at B={B} C={n} N={mp.n_instr} (split at index '
          f'{table.min_read}): kernel {ms:.4f} ms events / '
          f'{_device_note(dev_ms)} ms device, plain {plain_ms:.3f} ms, '
          f'bound {bound_ms:.4f} ms (bytes {nbytes / 1e9:.3f} GB = '
          f'{t_bytes:.4f} ms, operations {ops:.3e} = {t_ops:.4f} ms; '
          f'{retired} rows, {reads} LUT reads, {n_meas} windows) on '
          f'{env["smi"]}')
    del got
    # the same pass without pulse records: what the records cost
    ncfg = dataclasses.replace(pcfg, record_pulses=False)
    nst = {k: v for k, v in st.items() if k != 'rec'}
    ntable = _span_table(mp, ncfg, DEV, fused=True)
    # (the record leaf read once and written once fewer)
    n_bytes = nbytes - 2 * _carry_bytes({'rec': st['rec']})
    n_dev = _kernel_ms(lambda: exec_span_fused(nst, ntable, bits0, valid0,
                                               ncfg, fused), reps=20)
    print(f'lut physics K3 without pulse records: {_device_note(n_dev)} ms '
          f'device against {n_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms of bytes')
    del nst
    # sigma = 0.05: 'auto' takes the straight-line engine (K1 has no
    # physics mode), K2 per epoch
    model = headline_model()
    cfg = dataclasses.replace(cfg, engine='auto')
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'straightline', f'lut physics at sigma={model.sigma} '
                                 f'resolves to {eng!r}')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run_physics_batch(mp, model, 6, B, init_states=init, cfg=cfg,
                            device=DEV)
    stats = {k: v.cpu().numpy().tolist()
             for k, v in physics_batch_stats(out).items()}
    sync()
    noisy_dt = time.perf_counter() - t0
    counts = _launches()
    epochs = int(out['epochs'])
    check(counts['resolve_windows'] == epochs > 0
          and _only_launched(counts, 'resolve_windows', 'exec_span_physics'),
          f'lut physics (sigma={model.sigma}) launches {counts} in {epochs} '
          f'epochs')
    check(not bool(out['incomplete']) and sum(stats['fault_shots']) == 0,
          f'lut physics (sigma={model.sigma}) faults: '
          f'{stats["fault_shots"]}')
    fired = torch.arange(cfg.max_meas, device=DEV)[None, None, :] \
        < out['n_meas'][..., None]
    check(bool((out['meas_bits_valid'] | ~fired).all()),
          f'lut physics (sigma={model.sigma}) left windows unresolved')
    agree = float((out['meas_bits'][:, :, 0] == init).float().mean())
    print(f"lut physics (sigma={model.sigma}, engine='auto' -> '{eng}'): {B} "
          f'shots in {noisy_dt:.3f} s, epochs {epochs}, K2 launches '
          f"{counts['resolve_windows']}, no fault, every window resolved; "
          f'first readout equal to the initial state on {agree:.5f} of the '
          f'bits; stats {json.dumps(stats)} on {env["smi"]}')
    return dict(ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                max_abs_err=worst, launches=1, batch_s=dt,
                noisy_s=noisy_dt, noisy_epochs=epochs)


def _physics_batch(mp, model, seed: int, B: int, cfg, device=None,
                   **kw) -> dict:
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    return run_physics_batch(mp, model, seed, B, cfg=cfg,
                             device=device or DEV, **kw)


def _steady(label: str, run, env, k2_expected: bool = True,
            others: tuple = ('exec_span_physics',)) -> dict:
    """One warm batch, then one timed batch with every launch count set
    to 0 just before it, then one under the profiler: the wall, epochs,
    steps and launches of the timed batch, K2's device ms and the
    device's busy share; no wrapper but K2 and ``others`` may launch.
    Returns the timed batch's outputs and numbers."""
    int(run(0)['epochs'])
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = run(1)
    epochs = int(out['epochs'])
    sync()
    wall = time.perf_counter() - t0
    counts = _launches()
    check(not bool(out['incomplete']), f'{label}: shots left incomplete')
    check(not bool(out['fault'].any()), f'{label}: faulted shots')
    check(bool(out['meas_bits_valid'][
        torch_arange(out['meas_bits'].shape[-1])
        < out['n_meas'][..., None]].all()),
        f'{label}: fired measurement slots left unresolved')
    k2 = counts['resolve_windows']
    if k2_expected:
        check(k2 == epochs and epochs > 0,
              f'{label}: K2 launched {k2} times in {epochs} epochs')
    else:
        check(k2 == 0, f'{label}: K2 launched {k2} times')
    check(_only_launched(counts, 'resolve_windows', *others),
          f'{label}: other kernels launched: {counts}')
    pwall, kernels = device_kernel_times(lambda: int(run(2)['epochs']))
    busy = sum(us for us, _n in kernels.values()) / 1e6
    k2_ms = sum(us for name, (us, _n) in kernels.items()
                if 'resolve_' in name) / 1e3
    k2_prof, k2_ar1 = _k2_launches(kernels)
    n_launch = sum(n for _us, n in kernels.values())
    fired = torch_arange(out['meas_bits'].shape[-1]) \
        < out['n_meas'][..., None]
    fid = float((out['meas_bits'] == out['meas_state'])[fired]
                .float().mean())
    print(f'{label}: steady batch {wall:.3f} s ({out["meas_bits"].shape[0]}'
          f' shots, {out["meas_bits"].shape[0] / wall:.1f} shots/s), epochs '
          f"{epochs}, steps {int(out['steps'])}, K2 launches {k2} (profiled "
          f'batch: {k2_prof}, {k2_ar1} of them AR(1)), K2 device '
          f'{k2_ms:.3f} ms per batch; profiled batch wall {pwall:.4f} s, device busy '
          f'{busy:.4f} s ({100 * busy / pwall:.1f}%, idle '
          f'{100 - 100 * busy / pwall:.1f}%), {n_launch} kernel launches; '
          f'readout fidelity (bit = sampled state) {fid:.5f} on '
          f'{env["smi"]}')
    return dict(out=out, wall=wall, epochs=epochs, counts=counts,
                k2_ms=k2_ms, k2_prof=k2_prof, k2_ar1=k2_ar1, busy=busy,
                pwall=pwall, fidelity=fid)


def torch_arange(n: int):
    import torch
    return torch.arange(n, device=DEV)


def cw_headline(mp):
    """The headline with every readout's env word patched to the CW
    sentinel (its table address kept), and the finite window's samples:
    a CW readout at that horizon reads exactly the finite window."""
    import copy
    import numpy as np
    from distributed_processor_tpu_torch.elements import ENV_CW_SENTINEL
    meas = (np.asarray(mp.soa.p_cfg) & 0b11) == 2
    check(bool(meas.any()), 'the headline has no readout rows')
    envw = np.asarray(mp.soa.p_env)[meas]
    n_words = (envw >> 12) & 0xfff
    check(len(set(n_words.tolist())) == 1,
          f'the headline readouts have several lengths: {set(n_words)}')
    interp = {int(t.elem_cfgs[2].interp_ratio) for t in mp.tables}
    check(len(interp) == 1, f'readout interpolation differs: {interp}')
    n_samp = int(n_words[0]) * 4 * interp.pop()
    cw_mp = copy.deepcopy(mp)
    cw_mp.soa.p_env[meas] = (ENV_CW_SENTINEL << 12) | (envw & 0xfff)
    return cw_mp, n_samp


def phase_readout_models(mp, env) -> int:
    """The headline at 262144 shots under each readout model of the port:
    the analytic closed form (no K2 launch), AR(1) ADC noise (K2's AR(1)
    mode), the resonator ring-up, and CW readout (the readout env words
    patched to the CW sentinel, at a horizon of the finite window: its
    bits identical to the finite run of the same seed).  The profiler
    shows which K2 instantiation ran: the AR(1) one in every K2 launch of
    the AR(1) run, in none of the others.  Returns K2's launches in the
    AR(1) run."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        resolve_engine
    from distributed_processor_tpu_torch.sim.physics import physics_config
    B = HEADLINE['batch']
    cfg = headline_config(mp)
    cw_mp, n_samp = cw_headline(mp)
    runs = (
        ('analytic', mp, headline_model(resolve_mode='analytic',
                                        sigma=READOUT['analytic_sigma'])),
        (f"AR(1) rho={READOUT['ar1']}", mp,
         headline_model(resolve_mode='persample',
                        noise_ar1=READOUT['ar1'])),
        (f"ring_tau={READOUT['ring_tau']}", mp,
         headline_model(ring_tau=READOUT['ring_tau'])),
        (f'CW horizon {n_samp}', cw_mp, headline_model(cw_horizon=n_samp)))
    ar1_launches = 0
    for label, prog, model in runs:
        eng = resolve_engine(prog, physics_config(cfg, model), DEV)
        check(eng == 'straightline', f'{label} resolves to {eng!r}')
        res = _steady(f'readout model {label}', lambda k, p=prog, m=model:
                      _physics_batch(p, m, 3000 + k, B, cfg), env,
                      k2_expected=model.resolve_mode != 'analytic')
        for seed in (3003, 3004):
            if res['k2_prof'] or model.resolve_mode == 'analytic':
                break
            # the profiler can lose a batch's events; profile another
            _wall, kernels = device_kernel_times(
                lambda p=prog, m=model, k=seed: int(_physics_batch(
                    p, m, k, B, cfg)['epochs']))
            res['k2_prof'], res['k2_ar1'] = _k2_launches(kernels)
        want_ar1 = res['k2_prof'] if model.noise_ar1 > 0 else 0
        check(res['k2_ar1'] == want_ar1,
              f"{label}: {res['k2_ar1']} of {res['k2_prof']} profiled K2 "
              f'launches ran the AR(1) instantiation, not {want_ar1}')
        if model.noise_ar1 > 0:
            check(res['k2_prof'] > 0, f'{label}: no K2 launch profiled')
            ar1_launches = res['counts']['resolve_windows']
        if model.cw_horizon:
            fin = _physics_batch(mp, headline_model(), 3001, B, cfg)
            check(bool((fin['meas_bits'] == res['out']['meas_bits']).all()),
                  'CW readout at the finite horizon changed bits')
            print(f'CW readout at horizon {n_samp}: all {B} x {mp.n_cores}'
                  f' x 2 bits identical to the finite program of the same '
                  f'seed')
        del res
    return ar1_launches


@contextlib.contextmanager
def _shared_meas_uniforms():
    """Within the block, every device's run reads the CPU generator's
    measurement uniforms (moved to the device): the card draws its own
    on the card, from another generator, so a card = CPU hold needs one
    draw for both."""
    from distributed_processor_tpu_torch.sim import physics
    draw = physics._meas_uniforms
    physics._meas_uniforms = lambda seed, shots, C, M, device: draw(
        seed, shots, C, M, 'cpu').to(device)
    try:
        yield
    finally:
        physics._meas_uniforms = draw


def phase_bloch_path(mp, env) -> int:
    """The headline with ``DeviceModel('bloch', ...)`` at 262144 shots:
    the straight-line engine plus K2 per epoch; then card = CPU at
    sigma = 0 on 4096 shots with the same initial states and the same
    measurement uniforms (:func:`_shared_meas_uniforms`): bits
    identical but for tie lanes (a uniform within 1e-6 of its P(1),
    counted, their shots set aside), ``bloch`` to atol 1e-5.  Returns
    K2's launches."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    from distributed_processor_tpu_torch.sim.interpreter import \
        resolve_engine
    from distributed_processor_tpu_torch.sim.physics import (
        _meas_uniforms, physics_config)
    B = HEADLINE['batch']
    dev_model = DeviceModel('bloch', **BLOCH['device'])
    model = headline_model(device=dev_model)
    cfg = headline_config(mp)
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'straightline', f'the bloch headline resolves to {eng!r}')
    res = _steady('bloch path', lambda k: _physics_batch(
        mp, model, 4000 + k, B, cfg), env)
    out = res['out']
    check(not bool(out['err'].any()), 'bloch path: errored shots')
    p1 = out['meas_p1']
    check(bool(torch.isfinite(out['bloch']).all())
          and bool(((p1 >= 0) & (p1 <= 1)).all()),
          'bloch path: a Bloch vector or P(1) out of range')
    launches = res['epochs']
    del res, out
    # card = CPU
    Bc, C = BLOCH['cpu_batch'], mp.n_cores
    init = np.random.default_rng(41).integers(0, 2, (Bc, C))
    model0 = headline_model(sigma=0.0, device=dev_model)
    with _shared_meas_uniforms():
        outs = {d: _physics_batch(mp, model0, 42, Bc, cfg, device=d,
                                  init_states=init) for d in (DEV, 'cpu')}
    u = _meas_uniforms(42, Bc, C, cfg.max_meas, 'cpu')
    cpu = outs['cpu']
    fired = torch.arange(cfg.max_meas)[None, None, :] \
        < cpu['n_meas'][..., None]
    tie = (fired & ((u - cpu['meas_p1']).abs() < 1e-6)).any(-1).any(-1)
    keep = ~tie
    card = {k: v.cpu() for k, v in outs[DEV].items()}
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err', 'fault'):
        check(torch.equal(card[key][keep], cpu[key][keep]),
              f'bloch card vs CPU: {key} differs off the tie lanes')
    dmax = float((card['bloch'][keep] - cpu['bloch'][keep]).abs().max())
    check(dmax <= 1e-5, f'bloch card vs CPU: bloch differs by {dmax:.3e}')
    print(f'bloch path card vs CPU (B={Bc}, sigma=0): bits identical on '
          f'{int(keep.sum())} shots, {int(tie.sum())} shots with a tie lane '
          f'set aside; max |bloch diff| {dmax:.3e} (atol 1e-5)')
    return launches


def phase_statevec_path(env) -> tuple:
    """The statevec device on the generic engine plus K2: GHZ-8 through
    the compiled CNOT chain (the event gate, 7 couplings) at sigma = 0,
    every shot's 8 bits equal; then 2-qubit interleaved RB with
    coupling-induced leakage, 2q depolarization and IQ-level 3-class
    readout at 262144 shots.  Each engine step's statevec block is one
    launch of the statevec kernel (its launches = the steps =
    ``statevec.kernel_steps``).  Returns K2's launches in the RB run and
    the statevec kernel's in the GHZ-8 batch."""
    import numpy as np
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.models import (
        couplings_from_qchip, ghz_program, make_default_qchip,
        rb2q_interleaved_program)
    from distributed_processor_tpu_torch.sim.device import DeviceModel
    from distributed_processor_tpu_torch.sim.interpreter import (
        InterpreterConfig, resolve_engine)
    from distributed_processor_tpu_torch.sim.physics import physics_config
    n = STATEVEC['ghz_qubits']
    qchip = make_default_qchip(n)
    mp = compile_to_machine(ghz_program([f'Q{i}' for i in range(n)]), qchip,
                            n_qubits=n)
    cps = couplings_from_qchip(mp, qchip)
    check(len(cps) == n - 1, f'GHZ-{n} couples {len(cps)} pairs')
    model = headline_model(sigma=0.0, p1_init=0.0, device=DeviceModel(
        'statevec', couplings=cps))
    cfg = InterpreterConfig(max_steps=4000, max_pulses=64, max_meas=2,
                            max_resets=2, record_pulses=False)
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'generic', f'GHZ-{n} resolves to {eng!r}')
    B = STATEVEC['ghz_batch']
    init = np.zeros((B, n), np.int32)
    res = _steady(f'statevec GHZ-{n}', lambda k: _physics_batch(
        mp, model, 5000 + k, B, cfg, init_states=init), env,
        others=('statevec_pulse',))
    out = res['out']
    sv_launches = _statevec_launches(f'GHZ-{n}', res)
    bits = out['meas_bits'][:, :, 0]
    check(not bool(out['err'].any()), f'GHZ-{n}: errored shots')
    check(bool((bits == bits[:, :1]).all()),
          f'GHZ-{n}: bits disagree across the chain')
    mean = float(bits[:, 0].float().mean())
    check(abs(mean - 0.5) < 5 * 0.5 / math.sqrt(B),
          f'GHZ-{n}: P(1) {mean:.5f} is not 1/2')
    print(f'statevec GHZ-{n}: {B} shots, every shot\'s {n} bits equal, '
          f'P(1) {mean:.5f}')
    del res, out, bits
    # 2-qubit interleaved RB with leakage and IQ-level readout
    q2 = make_default_qchip(2)
    prog, info = rb2q_interleaved_program('Q0', 'Q1', STATEVEC['rb_depth'],
                                          seed=STATEVEC['rb_seed'])
    mp2 = compile_to_machine(prog, q2, n_qubits=2)
    model2 = headline_model(
        sigma=STATEVEC['sigma'], p1_init=0.0, g2=STATEVEC['g2'],
        classify3=True, device=DeviceModel(
            'statevec', couplings=couplings_from_qchip(mp2, q2),
            leak2_per_pulse=STATEVEC['leak2'],
            depol2_per_pulse=STATEVEC['depol2']))
    cfg2 = InterpreterConfig(max_steps=8000, max_pulses=192, max_meas=4,
                             max_resets=2, record_pulses=False)
    B2 = STATEVEC['rb_batch']
    res = _steady(f"statevec 2q interleaved RB depth {STATEVEC['rb_depth']}"
                  f" ({info['n_cz']} CZ), leakage + IQ 3-class",
                  lambda k: _physics_batch(mp2, model2, 5100 + k, B2, cfg2),
                  env, others=('statevec_pulse',))
    out = res['out']
    _statevec_launches('2q RB', res)
    check(not bool(out['err'].any()), '2q RB: errored shots')
    leaked = float(out['leaked'].float().mean())
    fired = torch_arange(cfg2.max_meas) < out['n_meas'][..., None]
    cls2 = float((out['meas_class'] == 2)[fired].float().mean())
    surv = float((out['meas_bits'][:, :, 0] == 0).all(-1).float().mean())
    check(leaked > 0 and cls2 > 0, f'2q RB: no leakage seen ({leaked})')
    print(f"statevec 2q RB: {B2} shots, leaked {leaked:.5f} per core, class "
          f'2 {cls2:.5f} of readouts, survival {surv:.5f}')
    return res['epochs'], sv_launches


def _statevec_launches(label: str, res: dict) -> int:
    """The statevec kernel's launches in a steady batch of ``_steady``:
    one an engine step, and as many ``statevec.kernel_steps``."""
    n = res['counts']['statevec_pulse']
    steps = int(res['out']['steps'])
    check(n == steps > 0, f'statevec {label}: {n} kernel launches in '
          f'{steps} steps')
    print(f'statevec {label}: {n} statevec kernel launches, one a step')
    return n


def _wall_median(fn, reps: int = 3) -> float:
    """The median wall time in s of ``reps`` calls of ``fn``, each ended
    by a device sync."""
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[len(walls) // 2]


def _busy(fn) -> tuple:
    """``(wall s, device busy s, launches, megastep kernels' device s)``
    of one profiled call of ``fn``: every CUDA kernel the profiler saw,
    eager torch kernels included; the last counts K1's (names holding
    ``exec_``)."""
    wall, kernels = device_kernel_times(fn)
    return (wall, sum(us for us, _n in kernels.values()) / 1e6,
            sum(n for _us, n in kernels.values()),
            sum(us for name, (us, _n) in kernels.items()
                if 'exec_' in name) / 1e6)


def _busy_note(b: tuple) -> str:
    wall, dev, n, k1 = b
    if n == 0:
        return 'device time not measured (the profiler saw no kernel)'
    return (f'{n} kernel launches, device busy {dev:.4f} s of a profiled '
            f'{wall:.4f} s ({100 * dev / wall:.1f}%)'
            + (f', K1 device {1e3 * k1:.4f} ms' if k1 else ''))


@functools.lru_cache(maxsize=None)
def multi_ensemble(seed: int):
    """The headline ensemble: ``MULTI['n_seqs']`` distinct random RB
    sequences over 8 qubits at depth 12, each after active reset,
    compiled by the port; returns ``(programs, stacked)``, compiled once
    per seed (the serve phase reuses the multi path's)."""
    from distributed_processor_tpu_torch import compile_to_machine
    from distributed_processor_tpu_torch.decoder import \
        stack_machine_programs
    from distributed_processor_tpu_torch.models import (
        active_reset, make_default_qchip, rb_ensemble)
    n = HEADLINE['n_qubits']
    qubits = [f'Q{i}' for i in range(n)]
    qchip = make_default_qchip(n)
    mps = [compile_to_machine(active_reset(qubits) + prog, qchip,
                              n_qubits=n)
           for prog in rb_ensemble(qubits, HEADLINE['depth'],
                                   MULTI['n_seqs'], seed=seed)]
    return mps, stack_machine_programs(mps)


def multi_config(mmp):
    """bench.py's ``cfg_multi``: the bucket's budget, no pulse records."""
    from distributed_processor_tpu_torch.sim.interpreter import \
        InterpreterConfig
    return InterpreterConfig(max_steps=2 * mmp.n_instr + 64,
                             max_pulses=mmp.n_instr + 2, max_meas=2,
                             max_resets=2, record_pulses=False)


def phase_multi_path(env) -> None:
    """The headline ensemble at full width: 16 distinct random RB
    sequences (8 qubits, depth 12, after active reset) as one
    ``simulate_multi_batch`` over 16 x 16384 = 262144 lanes on seeded
    Bernoulli(0.5) bits, every program's view equal on every key to that
    program alone through ``simulate_batch(engine='generic')``; its
    steady wall beside the 16 sequential calls'; then ``run_multi_sweep``
    over 2 batches, its integer statistics equal to the sum of the two
    batches' ensemble runs on the same bits."""
    import dataclasses
    import torch
    from distributed_processor_tpu_torch.parallel import (multi_batch_stats,
                                                          run_multi_sweep)
    from distributed_processor_tpu_torch.sim.interpreter import (
        demux_multi_batch, simulate_batch, simulate_multi_batch)
    from distributed_processor_tpu_torch.sim.physics import derive_seed
    mps, mmp = multi_ensemble(seed=2026)
    P, B, C = mmp.n_progs, MULTI['shots'], mmp.n_cores
    cfg = multi_config(mmp)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(81)
    bits = (torch.rand((P, B, C, 2), generator=gen, device=DEV) < 0.5) \
        .to(torch.int32)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = simulate_multi_batch(mmp, bits, cfg=cfg, device=DEV)
    sync()
    t_first = time.perf_counter() - t0
    counts = _launches()
    check(_only_launched(counts), f'multi path launched hand kernels: '
                                  f'{counts} (the generic engine has none)')
    check(not bool(out['incomplete'].any()) and not bool(out['fault'].any())
          and not bool(out['err'].any()),
          'multi path: incomplete, faulted or errored lanes')
    check(tuple(out['steps'].shape) == (P,) and tuple(out['n_pulses'].shape)
          == (P, B, C), 'multi path outputs have the wrong shape')
    for p, mp in enumerate(mps):
        alone = simulate_batch(mp, bits[p], cfg=dataclasses.replace(
            cfg, engine='generic'), device=DEV)
        _max_abs_diff(demux_multi_batch(out, p), alone,
                      f'multi path: program {p} vs alone')
    print(f'multi path: {P} RB sequences (8 qubits, depth 12, bucket '
          f'{mmp.n_instr} instructions) x {B} shots = {P * B} lanes in one '
          f'simulate_multi_batch ({t_first:.3f} s first call), steps per '
          f"program {out['steps'].tolist()}; every program's view equal on "
          f'every key to the program alone on the generic engine; no err, '
          f'fault or incomplete')
    del out

    def multi():
        simulate_multi_batch(mmp, bits, cfg=cfg, device=DEV)

    def sequential():
        for p, mp in enumerate(mps):
            simulate_batch(mp, bits[p], cfg=dataclasses.replace(
                cfg, engine='generic'), device=DEV)
    walls = {'one ensemble call': _wall_median(multi),
             f'{P} sequential calls': _wall_median(sequential, reps=1)}
    busy = {'one ensemble call': _busy(multi),
            f'{P} sequential calls': _busy(sequential)}
    print('multi path steady (the ensemble call: median of 3; the '
          'sequential calls: one run; one profiled call each): '
          + '; '.join(f'{k}: {w:.4f} s, {P * B / w:.1f} shots/s, '
                      f'{_busy_note(busy[k])}' for k, w in walls.items())
          + f' on {env["smi"]}')

    # run_multi_sweep: 2 batches per program, against the sum of the two
    # batches' ensemble runs on the sweep's own bits
    n_b, seed = MULTI['sweep_batches'], 2027
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    res = run_multi_sweep(mmp, n_b * B, B, p1=0.5, seed=seed, cfg=cfg,
                          device=DEV)
    t_sweep = time.perf_counter() - t0
    check(_only_launched(_launches()), 'multi sweep launched hand kernels')
    acc = None
    for i in range(n_b):
        g = torch.Generator(device=DEV)
        g.manual_seed(derive_seed(seed, i) >> 1)
        b = (torch.rand((P, B, C, 2), generator=g, device=DEV) < 0.5) \
            .to(torch.int32)
        st = {k: v.cpu() for k, v in multi_batch_stats(
            simulate_multi_batch(mmp, b, cfg=cfg, device=DEV)).items()}
        acc = st if acc is None else {k: acc[k] + v for k, v in st.items()}
    shots = n_b * B
    check(res['shots'] == shots and res['incomplete_batches'] == 0
          and res['engine'] == 'generic', f'multi sweep: {res}')
    check(all(not v.any() for v in res['fault_shots'].values()),
          'multi sweep faulted shots')
    for key, num in (('mean_pulses', 'pulse_sum'), ('mean_qclk', 'qclk_sum'),
                     ('err_rate', 'err_shots')):
        check((res[key] == acc[num].numpy() / shots).all(),
              f'multi sweep {key} differs from its batches')
    check((res['err_shots'] == acc['err_shots'].numpy()).all(),
          'multi sweep err_shots differs from its batches')
    print(f'multi path sweep: run_multi_sweep {P} programs x {shots} shots '
          f'in {n_b} batches, {t_sweep:.3f} s; integer statistics equal to '
          f'the sum of the two batches; mean pulses per core (program 0) '
          + json.dumps([round(float(x), 5) for x in res['mean_pulses'][0]])
          + f' on {env["smi"]}')


def _seq_rounds(mp, bits, cfg) -> dict:
    """``R`` sequential ``simulate_batch`` calls on ``bits [R, B, C, M]``,
    their outputs stacked on a leading round axis."""
    import torch
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    outs = [simulate_batch(mp, bits[r], cfg=cfg, device=DEV)
            for r in range(bits.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def phase_rounds_path(env) -> dict:
    """Streaming rounds at full width, R x B = 32 x 8192 = 262144 lanes:
    the 8-core repetition round with the majority decode and the
    distance-5 surface cycle (9 cores) with the chain-matching decode,
    each through ``simulate_rounds`` with ``engine='pallas'`` and
    ``'auto'`` (one K1 span launch for all lanes), equal on every key to
    32 sequential straight-line batches; the decode against the injected
    planes and the table oracles; then the looped headline at 4 x 8192
    on ``engine='pallas'`` (one K1 block launch per block-engine
    iteration), equal to 4 sequential block-engine batches.  Each call's
    wall beside the R sequential K1 calls'.  Returns the launches of the
    repetition round's pallas call (K1 span) and of the looped call (K1
    block)."""
    import dataclasses
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.models import qec
    from distributed_processor_tpu_torch.ops.decode import (
        majority_correction_np, majority_vote)
    from distributed_processor_tpu_torch.sim.interpreter import (
        simulate_batch, simulate_rounds)
    R, B = ROUNDS['rounds'], ROUNDS['shots']
    (rep_label, rep_mp, rep_cfg), (sc_label, sc_mp, sc_cfg) = lut_workloads()
    d = LUT['distance']
    workloads = ((rep_label, rep_mp, rep_cfg,
                  qec.repetition_decode_spec(LUT['n_data'])),
                 (sc_label, sc_mp, sc_cfg, qec.surface_decode_spec(d)))
    res = {}
    for label, mp, cfg, spec in workloads:
        C = mp.n_cores
        gen = torch.Generator(device=DEV)
        gen.manual_seed(101 + C)
        bits = torch.randint(0, 2, (R, B, C, cfg.max_meas), generator=gen,
                             device=DEV, dtype=torch.int32)
        outs = {}
        for e in ('pallas', 'auto'):
            run_cfg = dataclasses.replace(cfg, engine=e,
                                          opcode_histogram=True)
            _reset_launches()
            sync()
            t0 = time.perf_counter()
            outs[e] = simulate_rounds(mp, bits, cfg=run_cfg, decode=spec,
                                      device=DEV)
            sync()
            dt = time.perf_counter() - t0
            counts = _launches()
            check(counts['exec_span'] == 1
                  and _only_launched(counts, 'exec_span'),
                  f'rounds path {label} ({e}): launches {counts}')
            print(f"rounds path {label}: simulate_rounds(engine='{e}') "
                  f'{R} rounds x {B} shots = {R * B} lanes, K1 span '
                  f"launches {counts['exec_span']}, {dt:.4f} s (first call "
                  f'of this engine)')
            if e == 'pallas':
                res[label] = counts['exec_span']
        _max_abs_diff(outs['auto'], outs['pallas'],
                      f"rounds path {label}: 'auto' vs 'pallas'")
        out = outs.pop('pallas')
        del outs
        check(not bool(out['fault'].any()) and not bool(out['err'].any())
              and not bool(out['incomplete'].any()),
              f'rounds path {label}: faulted, errored or incomplete')
        seq = _seq_rounds(mp, bits, dataclasses.replace(
            cfg, engine='straightline', opcode_histogram=True))
        _max_abs_diff({k: v for k, v in out.items()
                       if k not in ('syndrome_hist', 'decoded')}, seq,
                      f'rounds path {label}: rounds vs {R} sequential '
                      f'straight-line batches')
        del seq
        hist = bits[:, :, list(spec.cores), spec.slot].permute(1, 0, 2)
        check(torch.equal(out['syndrome_hist'], hist),
              f'rounds path {label}: syndrome_hist is not the injected '
              f'planes at the decode cores and slot')
        voted = majority_vote(out['syndrome_hist']).cpu().numpy()
        decoded = out['decoded'].cpu().numpy()
        if spec.scheme == 'majority':
            sample = np.random.default_rng(7).choice(B, ROUNDS['oracle_shots'],
                                                     replace=False)
            for b in sample:
                check(np.array_equal(decoded[b],
                                     majority_correction_np(voted[b])),
                      f'rounds path {label}: shot {b} decoded differs from '
                      f'the majority LUT')
            what = (f"decoded = majority_correction_np of the round "
                    f"majority on {len(sample)} sampled shots")
        else:
            lut = np.asarray(qec.chain_lut(d), np.int64)
            addr = (voted.astype(np.int64) << np.arange(d - 1)).sum(1)
            want = (lut[addr][:, None] >> np.arange(d)) & 1
            check(np.array_equal(decoded, want),
                  f'rounds path {label}: decoded differs from chain_lut')
            what = f'decoded = the chain_lut({d}) entry on all {B} shots'
        print(f'rounds path {label}: every key equal to {R} sequential '
              f'straight-line batches; syndrome_hist = the injected planes; '
              f'{what}')
        del out

        # the rounds call against R sequential K1 calls, steady
        pal = dataclasses.replace(cfg, engine='pallas')

        def rounds():
            simulate_rounds(mp, bits, cfg=pal, decode=spec, device=DEV)

        def sequential():
            for r in range(R):
                simulate_batch(mp, bits[r], cfg=pal, device=DEV)
        _reset_launches()
        sequential()
        sync()
        seq_launches = _launches()['exec_span']
        w_rounds, w_seq = _wall_median(rounds), _wall_median(sequential)
        print(f'rounds path {label} steady (median of 3): one '
              f'simulate_rounds {w_rounds:.4f} s, 1 K1 launch, '
              f'{_busy_note(_busy(rounds))}; {R} sequential '
              f"simulate_batch(engine='pallas') {w_seq:.4f} s, "
              f'{seq_launches} K1 launches, {_busy_note(_busy(sequential))}'
              f' on {env["smi"]}')
        del bits

    # the looped headline: a looping program, K1 block per iteration
    mp = loop_program()
    R_l = ROUNDS['loop_rounds']
    gen = torch.Generator(device=DEV)
    gen.manual_seed(111)
    bits = torch.randint(0, 2, (R_l, B, mp.n_cores, LOOP['max_meas']),
                         generator=gen, device=DEV, dtype=torch.int32)
    cfg = loop_config(mp, engine='pallas', opcode_histogram=True)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    out = simulate_rounds(mp, bits, cfg=cfg, device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    iters = int(out['steps'].max())
    check(counts['exec_blocks'] == iters > 0
          and _only_launched(counts, 'exec_blocks'),
          f'rounds path (looped): launches {counts}, {iters} iterations')
    check(not bool(out['fault'].any()) and not bool(out['incomplete'].any())
          and bool((out['n_meas'] == LOOP['max_meas']).all()),
          'rounds path (looped): faulted or incomplete lanes')
    seq = _seq_rounds(mp, bits, dataclasses.replace(cfg, engine='block'))
    _max_abs_diff(out, seq, f'rounds path (looped): rounds vs {R_l} '
                            f'sequential block-engine batches')
    res['looped'] = counts['exec_blocks']
    print(f"rounds path looped headline: simulate_rounds(engine='pallas') "
          f'{R_l} rounds x {B} shots = {R_l * B} lanes in {dt:.4f} s (first '
          f'call), {iters} block iterations, K1 block launches '
          f"{counts['exec_blocks']}, no other kernel; steps per round "
          f"{out['steps'].tolist()}; every key equal to {R_l} sequential "
          f'block-engine batches')
    del out, seq
    pal = dataclasses.replace(cfg, opcode_histogram=False)

    def rounds():
        simulate_rounds(mp, bits, cfg=pal, device=DEV)

    def sequential():
        for r in range(R_l):
            simulate_batch(mp, bits[r], cfg=pal, device=DEV)
    _reset_launches()
    sequential()
    sync()
    seq_launches = _launches()['exec_blocks']
    w_rounds, w_seq = _wall_median(rounds), _wall_median(sequential)
    print(f'rounds path looped steady (median of 3): one simulate_rounds '
          f'{w_rounds:.4f} s, {iters} K1 block launches, '
          f'{_busy_note(_busy(rounds))}; {R_l} sequential '
          f"simulate_batch(engine='pallas') {w_seq:.4f} s, {seq_launches} K1 "
          f'block launches, {_busy_note(_busy(sequential))} on '
          f'{env["smi"]}')
    return res


def phase_analysis(env) -> None:
    """The calibration user's fits on the card and on the CPU (T1, RB and
    Ramsey on seeded synthetic curves): the parameters within the CPU
    tests' tolerance of each other (rtol 1e-4, and 1e-4 of the amplitude
    for a parameter near 0) and near the truth; then ``calibrate_readout``
    at 262144 shots on the headline's readout responses, its fidelity
    > 0.99 and within 5 standard errors of the closed form."""
    import numpy as np
    from distributed_processor_tpu_torch import analysis
    from distributed_processor_tpu_torch.models.calibration import \
        calibrate_readout
    from distributed_processor_tpu_torch.models.readout import \
        IQReadoutModel
    rng = np.random.default_rng(0)
    x = np.linspace(0, 200e-6, 30)
    t1_y = 0.9 * np.exp(-x / 42e-6) + 0.05 + rng.normal(0, 0.01, x.shape)
    depths = np.array([1, 2, 4, 8, 16, 32, 64, 128])
    rb_y = 0.48 * 0.985 ** depths + 0.5 + rng.normal(0, 0.004, depths.shape)
    t = np.linspace(0, 20e-6, 200)
    ram_y = 0.45 * np.exp(-t / 8e-6) * np.cos(2 * np.pi * 350e3 * t) + 0.5 \
        + rng.normal(0, 0.01, t.shape)
    fits = (('T1', lambda dev: analysis.fit_t1(x, t1_y, device=dev)[1],
             (0.9, 42e-6, 0.05)),
            ('RB', lambda dev: analysis.fit_rb(depths, rb_y, device=dev)[2],
             (0.48, 0.985, 0.5)),
            ('Ramsey', lambda dev: analysis.fit_ramsey(t, ram_y,
                                                       device=dev)[2],
             (0.45, 8e-6, 350e3, 0.0, 0.5)))
    notes = []
    for label, fit, truth in fits:
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        card = np.asarray(fit(DEV))
        sync()
        dt = time.perf_counter() - t0
        check(_only_launched(_launches()), f'{label} fit launched hand kernels')
        cpu = np.asarray(fit('cpu'))
        tol = 1e-4 * np.abs(cpu) + 1e-4 * abs(cpu[0])
        check(np.all(np.abs(card - cpu) <= tol),
              f'{label} fit: card {card.tolist()} vs CPU {cpu.tolist()}')
        truth = np.asarray(truth)
        check(np.all(np.abs(card - truth) <= 0.1 * np.abs(truth) + 0.05
                     * abs(truth[0])),
              f'{label} fit {card.tolist()} far from the truth '
              f'{truth.tolist()}')
        notes.append(f'{label} {dt:.3f} s, max |card - CPU| / |CPU| '
                     f'{float(np.max(np.abs(card - cpu) / (np.abs(cpu) + abs(cpu[0])))):.2e}')
    print('analysis fits on the card (first call each; 100 LM iterations): '
          + '; '.join(notes) + ' — card = CPU within 1e-4')

    from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
    from math import erf, sqrt
    phys = ReadoutPhysics()
    C, S, sigma = HEADLINE['n_qubits'], CALIB['shots'], CALIB['sigma']
    model = IQReadoutModel([phys.g0] * C, [phys.g1] * C, sigma)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    c0, c1, fid = calibrate_readout(model, 2026, S, device=DEV)
    sync()
    dt = time.perf_counter() - t0
    check(_only_launched(_launches()),
          'calibrate_readout launched hand kernels')
    half = abs(complex(phys.g1) - complex(phys.g0)) / 2
    want = 0.5 * (1 + erf(half / sigma / sqrt(2)))
    se = sqrt(want * (1 - want) / (2 * S))
    check(bool(np.all(fid > 0.99)), f'readout fidelity {fid.tolist()}')
    check(bool(np.all(np.abs(fid - want) <= 5 * se)),
          f'readout fidelity {fid.tolist()} vs the closed form {want:.5f}')
    print(f'calibrate_readout: {S} shots x {C} channels on the card in '
          f'{dt:.3f} s, centroids {c0[0].tolist()} / {c1[0].tolist()} '
          f'(channel 0), fidelity {[round(float(f), 5) for f in fid]} '
          f'(closed form {want:.5f}; g0 {phys.g0}, g1 {phys.g1}, sigma '
          f'{sigma}) on {env["smi"]}')


def device_kernel_times(fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only);
    returns its wall time in s and ``{kernel name: [device us, count]}``,
    read from the profiler's raw events rather than ``key_averages()``,
    whose per-event Python tables take tens of seconds on a batch of
    ~10^5 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA if DEV == 'cuda'
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels = {}
    results = getattr(prof.profiler, 'kineto_results', None)
    for evt in results.events() if results is not None else ():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name(), [0.0, 0])
            k[0] += evt.duration_ns() / 1e3
            k[1] += 1
    return wall, kernels


def profile_batch(fn, label: str):
    """Where one batch's time goes: ``torch.profiler`` device time by
    kernel over the batch's wall time (the profiler's own overhead
    lengthens the wall time; the un-profiled batch time is above)."""
    t0 = time.perf_counter()
    wall, kernels = device_kernel_times(fn)
    dev_us = sum(us for us, _n in kernels.values())
    n_kernels = sum(n for _us, n in kernels.values())
    ours = {'resolve_rows': 0.0, 'resolve_full_table': 0.0,
            'exec_span_kernel': 0.0, 'exec_blocks_kernel': 0.0,
            'exec_tile_kernel': 0.0}
    for name, (us, _n) in kernels.items():
        for k in ours:
            if k in name:
                ours[k] += us
    if dev_us == 0.0:
        print(f'{label} breakdown: device time not measured (the '
              f'profiler saw no CUDA kernels)')
        return
    top = sorted(((us, n, name[:60]) for name, (us, n) in kernels.items()),
                 reverse=True)
    print(f'{label} breakdown (torch.profiler, one batch): wall '
          f'{wall:.4f} s, device busy {dev_us / 1e6:.4f} s '
          f'({100 * dev_us / 1e6 / wall:.1f}%), {n_kernels} kernel '
          f'launches; ' + ', '.join(
              f'{name} {us / 1e6:.4f} s ({100 * us / dev_us:.1f}% of device '
              f'time)' for name, us in ours.items())
          + f'; profiling took {time.perf_counter() - t0:.2f} s in all')
    for us, count, name in top[:8]:
        print(f'  {us / 1e3:10.3f} ms  {count:6d}x  {name}')


def _host_ms(fn) -> tuple:
    """``(fn(), host milliseconds)``."""
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _same_every_key(a: dict, b: dict, what: str) -> None:
    """Two result dicts on any devices: every tensor key equal (the
    facade's ``_mp``/``_cfg`` entries aside)."""
    _max_abs_diff({k: v.cpu() for k, v in a.items() if not k.startswith('_')},
                  {k: v.cpu() for k, v in b.items() if not k.startswith('_')},
                  what)


def phase_qasm_path(mp, env) -> None:
    """The OpenQASM 3 front door on the card: the headline as QASM text
    (:func:`qasm_headline_source`) through ``Simulator.compile`` and
    through ``cached_compile_to_machine`` (a cold miss, a warm hit, a disk
    hit from a fresh cache over the same directory), then
    ``run_physics_batch`` at the headline's batch: sigma = 0.05 on the
    straight-line engine with K2 once per epoch, sigma = 0 on
    ``engine='fused'`` in one K3 launch; then card = CPU at sigma = 0
    with explicit initial states, and, where the QASM program's bytes are
    the dict headline's (``mp``), every key equal to the dict headline's
    run."""
    import tempfile
    import numpy as np
    from distributed_processor_tpu_torch import Simulator
    from distributed_processor_tpu_torch.compilecache import (
        CompileCache, machine_program_bytes)
    from distributed_processor_tpu_torch.models import make_default_qchip
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.pipeline import \
        cached_compile_to_machine
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    n, B = HEADLINE['n_qubits'], HEADLINE['batch']
    src = qasm_headline_source(n, HEADLINE['depth'], 1234)
    mp_q, compile_ms = _host_ms(
        lambda: Simulator(n_qubits=n, device=DEV).compile(src))
    same_bytes = machine_program_bytes(mp_q) == machine_program_bytes(mp)
    print(f'qasm path: {len(src)} characters of OpenQASM 3 ({n} qubits, '
          f'depth {HEADLINE["depth"]}), Simulator.compile {compile_ms:.2f} '
          f'ms on the host, {mp_q.n_instr} instructions per core; bytes '
          f'{"equal to" if same_bytes else "differ from"} the dict '
          f'headline\'s')
    qchip = make_default_qchip(n)
    want = machine_program_bytes(mp_q)
    with tempfile.TemporaryDirectory() as tmp:
        cache = CompileCache(cache_dir=tmp)
        times = {}
        for label, c, stat in (('cold miss', cache, 'misses'),
                               ('warm hit', cache, 'hits'),
                               ('disk hit', CompileCache(cache_dir=tmp),
                                'disk_hits')):
            before = c.stats()[stat]
            got, times[label] = _host_ms(lambda: cached_compile_to_machine(
                src, qchip, n_qubits=n, cache=c))
            check(c.stats()[stat] == before + 1,
                  f'cached compile, {label}: {c.stats()}')
            check(machine_program_bytes(got) == want,
                  f'cached compile, {label}: bytes differ from '
                  f'Simulator.compile')
    print('qasm path: cached_compile_to_machine host ms: '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items()))
    for label, model, cfg, kernel in (
            ('sigma=0.05, engine=None', headline_model(),
             headline_config(mp_q), 'resolve_windows'),
            ("sigma=0, engine='fused'", headline_model(sigma=0.0),
             headline_config(mp_q, engine='fused'), 'exec_span_fused')):
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        res = run_physics_batch(mp_q, model, 2040, B, cfg=cfg, device=DEV)
        stats = {k: v.cpu().numpy().tolist()
                 for k, v in physics_batch_stats(res).items()}
        sync()
        dt = time.perf_counter() - t0
        counts = _launches()
        epochs = int(res['epochs'])
        want_launches = epochs if kernel == 'resolve_windows' else 1
        check(counts[kernel] == want_launches
              and _only_launched(counts, kernel, 'exec_span_physics'),
              f'qasm path {label}: launches {counts} in {epochs} epochs')
        check(not bool(res['incomplete']) and sum(stats['fault_shots']) == 0
              and stats['err_shots'] == 0
              and bool(res['meas_bits_valid'].all()),
              f'qasm path {label}: faults, errors or unresolved slots: '
              f'{stats}')
        print(f'qasm path: run_physics_batch({label}) {B} shots in '
              f'{dt:.4f} s (wall, sync included), epochs {epochs}, '
              f'{kernel} launches {counts[kernel]} on {env["smi"]}')
    Bc = 256
    init = np.random.default_rng(12).integers(0, 2, (Bc, mp_q.n_cores))
    model, cfg = headline_model(sigma=0.0), headline_config(mp_q)
    card = run_physics_batch(mp_q, model, 13, Bc, init_states=init, cfg=cfg,
                             device=DEV)
    _same_every_key(card, run_physics_batch(mp_q, model, 13, Bc,
                                            init_states=init, cfg=cfg,
                                            device='cpu'),
                    'qasm path, card vs CPU at sigma=0')
    if same_bytes:
        _same_every_key(card, run_physics_batch(mp, model, 13, Bc,
                                                init_states=init, cfg=cfg,
                                                device=DEV),
                        'qasm path vs the dict headline at sigma=0')
    print(f'qasm path: card = CPU at sigma=0, B={Bc}: every key identical'
          + ('; every key equal to the dict headline\'s run'
             if same_bytes else ''))


# the grad phase's losses: tests/test_calib.py's specs, a probe point and
# the range of the candidate population of one batched call, per knob
GRAD = dict(specs=(('amplitude', dict(knob='amplitude', x90_amp=0.48), 0.45,
                    (0.2, 0.8)),
                   ('drag', dict(knob='drag', drag_delta=-30e6), 0.6,
                    (0.1, 1.9)),
                   ('readout_window', dict(knob='readout_window',
                                           window_edge=8.0), 160.0,
                    (16.0, 400.0))),
            candidates=4096, seq_calls=64, rtol=1e-5)


def phase_grad(env) -> None:
    """Differentiable physics on the card: ``grad_loss`` of each knob
    equal to the CPU's to rtol 1e-5; one ``grad_loss_batch`` of 4096
    candidates per knob in one call, timed beside sequential
    ``grad_loss`` calls and held to the CPU's per-candidate values."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.sim.grad import (
        LossSpec, PARAM_NAME, grad_loss, grad_loss_batch)
    rtol = GRAD['rtol']

    def close(a, b, what):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(np.allclose(a, b, rtol=rtol, atol=0.0),
              f'grad: {what}: card {a} vs CPU {b}')

    for knob, kw, x, (lo, hi) in GRAD['specs']:
        spec, name = LossSpec(**kw), PARAM_NAME[kw['knob']]
        loss, grads = grad_loss({name: x}, spec, device=DEV)
        loss_c, grads_c = grad_loss({name: x}, spec, device='cpu')
        check(loss.device.type == DEV and grads[name].device.type == DEV,
              'grad_loss did not run on the card')
        close(float(loss), float(loss_c), f'{knob} loss')
        close(float(grads[name]), float(grads_c[name]), f'{knob} gradient')
        vals = np.linspace(lo, hi, GRAD['candidates'], dtype=np.float32)
        grad_loss_batch({name: vals}, spec, device=DEV)      # warm-up
        sync()
        t0 = time.perf_counter()
        b_loss, b_grads = grad_loss_batch({name: vals}, spec, device=DEV)
        sync()
        batch_s = time.perf_counter() - t0
        check(tuple(b_loss.shape) == (len(vals),)
              and bool(torch.isfinite(b_loss).all())
              and bool(torch.isfinite(b_grads[name]).all()),
              f'grad_loss_batch {knob}: shape or non-finite values')
        idx = np.linspace(0, len(vals) - 1, 8).astype(int)
        for i in idx:
            lc, gc = grad_loss({name: vals[i]}, spec, device='cpu')
            close(float(b_loss[i]), float(lc), f'{knob} batch loss [{i}]')
            close(float(b_grads[name][i]), float(gc[name]),
                  f'{knob} batch gradient [{i}]')
        sync()
        t0 = time.perf_counter()
        for v in vals[:GRAD['seq_calls']]:
            grad_loss({name: v}, spec, device=DEV)
        sync()
        seq_ms = 1e3 * (time.perf_counter() - t0) / GRAD['seq_calls']
        busy = _busy(lambda: grad_loss_batch({name: vals}, spec, device=DEV))
        print(f'grad {knob}: grad_loss card = CPU (rtol {rtol}); '
              f'grad_loss_batch of {len(vals)} candidates in one call '
              f'{1e3 * batch_s:.3f} ms, sequential grad_loss {seq_ms:.3f} '
              f'ms per call ({GRAD["seq_calls"]} calls), {_busy_note(busy)} '
              f'on {env["smi"]}')


# trace mode's run: the headline physics-closed at sigma = 0 with explicit
# initial states, on the generic engine (which trace mode forces), with
# the pulse records the VCD export reads; [B, 8, max_steps] traces grow
# with B, so a debugging batch
TRACE = dict(batch=4096, vcd_shot=3)


def phase_trace(mp, env) -> None:
    """``trace=True`` on the card: the headline at sigma = 0 with
    explicit initial states, every key (the per-step ``trace_pc``,
    ``trace_time``, ``trace_off`` included) equal to the CPU's run, and
    one shot written by ``write_vcd`` (the same bytes from the card's
    result as from the CPU's)."""
    import os
    import tempfile
    import numpy as np
    from distributed_processor_tpu_torch.sim.interpreter import \
        resolve_engine
    from distributed_processor_tpu_torch.sim.physics import (
        physics_config, run_physics_batch)
    from distributed_processor_tpu_torch.utils.vcd import write_vcd
    B = TRACE['batch']
    init = np.random.default_rng(14).integers(0, 2, (B, mp.n_cores))
    model = headline_model(sigma=0.0)
    cfg = headline_config(mp, trace=True, record_pulses=True)
    eng = resolve_engine(mp, physics_config(cfg, model), DEV)
    check(eng == 'generic', f'trace mode resolved to {eng!r}')
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    card = run_physics_batch(mp, model, 15, B, init_states=init, cfg=cfg,
                             device=DEV)
    sync()
    dt = time.perf_counter() - t0
    counts = _launches()
    check(_only_launched(counts, 'resolve_windows'),
          f'trace path launched a megastep kernel: {counts}')
    steps = int(card['steps'])
    check(tuple(card['trace_pc'].shape) == (B, mp.n_cores, cfg.max_steps)
          and not bool(card['incomplete']),
          f"trace path: traces {tuple(card['trace_pc'].shape)}, "
          f"incomplete {bool(card['incomplete'])}")
    t0 = time.perf_counter()
    cpu = run_physics_batch(mp, model, 15, B, init_states=init, cfg=cfg,
                            device='cpu')
    cpu_s = time.perf_counter() - t0
    _same_every_key(card, cpu, 'trace path, card vs CPU')
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f'{d}.vcd') for d in ('card', 'cpu')]
        events = [write_vcd(p, res, shot=TRACE['vcd_shot'],
                            core_labels=list(mp.core_inds))
                  for p, res in zip(paths, (card, cpu))]
        blobs = []
        for p in paths:
            with open(p, 'rb') as f:
                blobs.append(f.read())
    check(events[0] == events[1] > 0 and blobs[0] == blobs[1],
          f'trace path: VCD of the card run differs from the CPU run\'s '
          f'({events})')
    print(f'trace path: run_physics_batch(trace=True, sigma=0) {B} shots '
          f'on the generic engine in {dt:.3f} s (first call; CPU {cpu_s:.3f} '
          f's), {steps} steps over {int(card["epochs"])} epochs, K2 '
          f'launches {counts["resolve_windows"]}, traces '
          f'{tuple(card["trace_pc"].shape)}; every key card = CPU; '
          f'write_vcd(shot={TRACE["vcd_shot"]}): {events[0]} events, '
          f'{len(blobs[0])} bytes, identical from both devices, on '
          f'{env["smi"]}')


# the serving tier at the headline's width: (a) coalesced RB traffic, four
# ensembles of 16 distinct sequences (8 qubits, depth 12, after active
# reset) from one submitter thread each, 16384 shots a request, batches of
# up to 16 programs = 262144 lanes; (b) headline requests on K1 span at
# 262144 shots; (c) the looped headline at 32768 lanes on K1 block; (d)
# the repetition round's 32 x 8192 chunk and a session of 4 chunks of 8
# rounds; (e) the QASM headline through the compile front door; (g) a
# chaos soak of 64 requests; the calibration loop of tests/test_calib.py
SERVE = dict(threads=4, shots=16384, max_batch=16, max_wait_ms=5.0,
             k1_requests=4, loop_requests=2, stream_rounds=32,
             stream_shots=8192, session_chunks=4, session_rounds=8,
             qasm_shots=4096, qasm_submits=3, soak_requests=64,
             soak_programs=8, soak_shots=1024, timeout=300.0)
# the calibration loop on the card against the same loop on the CPU: the
# amplitudes may differ by one DAC amplitude word (1 / 65535), where a
# float32 gradient's last bits round a candidate to the next word
CALIB_LOOP = dict(x90_amp=0.52, shots=4, atol_truth=5e-3,
                  atol_cpu=1.6e-5)


def _service(*args, **kw):
    """An ``ExecutionService`` on the card (``devices=None``), or on
    :data:`DEV` where a rehearsal sets another device."""
    from distributed_processor_tpu_torch.serve import ExecutionService
    return ExecutionService(*args, devices=None if DEV == 'cuda' else [DEV],
                            **kw)


def _part(label: str, t0: float, phase: str = 'serve') -> float:
    """Print the seconds a part of a phase took; returns now."""
    now = time.perf_counter()
    print(f'[{phase} {label}: {now - t0:.1f} s]')
    return now


def _alloc_state() -> tuple:
    """``(cudaMalloc retries, reserved GB)`` of the caching allocator: a
    retry is a failed cudaMalloc that freed the cached blocks and tried
    again (cached blocks belong to the stream they were made on)."""
    import torch
    if DEV != 'cuda':
        return 0, 0.0
    st = torch.cuda.memory_stats()
    return st.get('num_alloc_retries', 0), \
        torch.cuda.memory_reserved() / 1e9


def _served_equal(got: dict, want: dict, what: str) -> None:
    """A served result (host arrays) equal on every key to a direct call's
    (tensors on any device)."""
    import torch
    _max_abs_diff({k: torch.as_tensor(v) for k, v in got.items()},
                  {k: v.cpu() for k, v in want.items()}, what)


def _serve_threads(svc, jobs) -> tuple:
    """Submit ``jobs`` (one list of ``(mp, bits)`` per submitter thread)
    and wait every handle out; returns ``(results in job order, wall s,
    handle latencies in s)``."""
    import threading
    n = sum(len(j) for j in jobs)
    results, lat, errors = [None] * n, [0.0] * n, []
    offsets = [sum(len(j) for j in jobs[:t]) for t in range(len(jobs))]

    def worker(t):
        try:
            hs = [(offsets[t] + j, time.perf_counter(), svc.submit(mp, b))
                  for j, (mp, b) in enumerate(jobs[t])]
            for i, t_sub, h in hs:
                results[i] = h.result(timeout=SERVE['timeout'])
                lat[i] = time.perf_counter() - t_sub
        except Exception as exc:     # noqa: BLE001 - reported below
            errors.append(exc)
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE['timeout'])
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and not errors,
          f'serve: submitter threads failed: {errors}')
    return results, wall, lat


def phase_serve(env) -> dict:
    """The in-process serving tier on the card (``ExecutionService`` with
    ``devices=None``: one executor on the card with its own stream): (a)
    coalesced RB traffic from 4 submitter threads, every result equal to
    a direct ``simulate_batch(engine='generic')``, beside the same
    requests as direct sequential calls; (b) headline requests on K1 span
    (``singleton_engine='pallas'``), (c) the looped headline on K1 block
    (``'pallas'`` on a looping program; ``'block'``, the plain block
    engine, beside it), (d) a rounds chunk on the span rung and a
    session of chunks, each equal to its direct call; (e) the QASM
    headline through ``submit_source``; (f) a service warmed from (a)'s
    learned catalog, its first dispatch labelled ``aot``; (g) a chaos
    soak; (h) no service thread left.  Returns the launches of K1 span
    and K1 block on the serve paths, and (a)'s programs, bits, config and
    results (which phase_fleet routes again)."""
    import dataclasses
    import tempfile
    import threading
    import numpy as np
    import torch
    from distributed_processor_tpu_torch import isa
    from distributed_processor_tpu_torch.compilecache import \
        machine_program_bytes
    from distributed_processor_tpu_torch.models import (make_default_qchip,
                                                        qec)
    from distributed_processor_tpu_torch.serve import (
        BucketCatalog, ChaosMonkey, ChaosPlan, RetryPolicy, soak)
    from distributed_processor_tpu_torch.sim.interpreter import (
        InterpreterConfig, simulate_batch, simulate_rounds)
    smi, T = env['smi'], SERVE['timeout']
    rng = np.random.default_rng(4401)
    launches = {}

    # (a) coalesced RB traffic
    t_part = time.perf_counter()
    mps = [mp for i in range(SERVE['threads'])
           for mp in multi_ensemble(seed=2026 + i)[0]]
    bucket = max(isa.shape_bucket(mp.n_instr) for mp in mps)
    cfg = InterpreterConfig(max_steps=2 * bucket + 64, max_pulses=bucket + 2,
                            max_meas=2, max_resets=2, record_pulses=False)
    B, C = SERVE['shots'], mps[0].n_cores
    bits = [rng.integers(0, 2, (B, C, 2), dtype=np.int32) for _ in mps]
    per = len(mps) // SERVE['threads']
    jobs = [[(mps[t * per + j], bits[t * per + j]) for j in range(per)]
            for t in range(SERVE['threads'])]
    tmp = tempfile.mkdtemp(prefix='serve-')
    catalog = f'{tmp}/buckets.json'
    with _service(cfg, max_batch_programs=SERVE['max_batch'],
                  max_wait_ms=SERVE['max_wait_ms'],
                  warmup_catalog=catalog) as svc:
        _reset_launches()
        results, wall, lat = _serve_threads(svc, jobs)
        counts = _launches()
        st = svc.stats()
        busy = _busy(lambda: _serve_threads(svc, jobs))
    check(_only_launched(counts), f'serve (a) launched hand kernels: '
                                  f'{counts} (the multi path has none)')
    check(st['completed'] == len(mps) and st['failed'] == 0,
          f'serve (a): {st["completed"]} of {len(mps)} completed')
    gcfg = dataclasses.replace(cfg, engine='generic')
    sync()
    t0 = time.perf_counter()
    for i, (mp, b) in enumerate(zip(mps, bits)):
        want = simulate_batch(mp, b, cfg=gcfg, device=DEV)
        _served_equal(results[i], want, f'serve (a) request {i}')
    sync()
    seq_wall = time.perf_counter() - t0
    shots = len(mps) * B
    lat_ms = np.sort(np.asarray(lat) * 1e3)
    print(f'serve (a): {len(mps)} requests x {B} shots from '
          f'{SERVE["threads"]} threads in {wall:.3f} s: '
          f'{len(mps) / wall:.1f} requests/s, {shots / wall:.1f} shots/s; '
          f'handle latency p50 {np.percentile(lat_ms, 50):.1f} / p99 '
          f'{np.percentile(lat_ms, 99):.1f} ms (service p50 '
          f'{st["latency_p50_ms"]:.1f} / p99 {st["latency_p99_ms"]:.1f} '
          f'ms); {st["dispatches"]} batches, '
          f'{st["coalesce_efficiency"]:.2f} programs per batch '
          f'(occupancy {st["batch_occupancy"]}); hand-kernel launches 0; '
          f'a second run profiled: {_busy_note(busy)}; every result equal '
          f'on every key to a direct simulate_batch(engine=\'generic\'); '
          f'the same {len(mps)} requests as direct sequential calls '
          f'{seq_wall:.3f} s ({shots / seq_wall:.1f} shots/s) on {smi}')
    cold_ms = [v['cold_ms_mean'] for v in st['compile']['per_bucket']
               .values() if v['cold_ms_mean'] is not None]
    t_part = _part('(a)', t_part)

    # (b) headline requests on K1 span
    mp = headline_program()
    hcfg = headline_config(mp)
    Bh = HEADLINE['batch']
    hbits = [rng.integers(0, 2, (Bh, mp.n_cores, 2), dtype=np.int32)
             for _ in range(SERVE['k1_requests'])]
    retries0, reserved0 = _alloc_state()
    with _service(hcfg, singleton_engine='pallas',
                  max_batch_programs=1, max_wait_ms=1.0) as svc:
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        hs = [svc.submit(mp, b) for b in hbits]
        got, done_s = [], []
        for h in hs:
            got.append(h.result(timeout=T))
            done_s.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        counts = _launches()
        st = svc.stats()
    retries1, reserved1 = _alloc_state()
    check(counts['exec_span'] == SERVE['k1_requests']
          and _only_launched(counts, 'exec_span'),
          f'serve (b): K1 span launches {counts}')
    check(st['engine_dispatches'] == {'pallas': SERVE['k1_requests']},
          f'serve (b): engines {st["engine_dispatches"]}')
    launches['exec_span'] = counts['exec_span']
    pcfg = headline_config(mp, engine='pallas')
    for i, (b, g) in enumerate(zip(hbits, got)):
        _served_equal(g, simulate_batch(mp, b, cfg=pcfg, device=DEV),
                      f'serve (b) request {i}')
    del got
    print(f"serve (b): {SERVE['k1_requests']} headline requests x {Bh} "
          f"shots, singleton_engine='pallas', in {wall:.3f} s "
          f'({SERVE["k1_requests"] * Bh / wall:.1f} shots/s, service p50 '
          f'{st["latency_p50_ms"]:.1f} ms; done at '
          + ', '.join(f'{x:.3f}' for x in done_s)
          + f' s; allocator retries {retries1 - retries0}, reserved '
          f'{reserved0:.1f} -> {reserved1:.1f} GB), K1 span launches '
          f'{counts["exec_span"]}, each equal on every key to a direct '
          f"simulate_batch(engine='pallas') on {smi}")
    t_part = _part('(b)', t_part)

    # (c) the looped headline on K1 block
    lmp = loop_program()
    lcfg = loop_config(lmp)
    Bl = LOOP['batch']
    lbits = [rng.integers(0, 2, (Bl, lmp.n_cores, LOOP['max_meas']),
                          dtype=np.int32)
             for _ in range(SERVE['loop_requests'])]
    per_request = []
    with _service(lcfg, singleton_engine='pallas',
                  max_batch_programs=1, max_wait_ms=1.0) as svc:
        for b in lbits:
            _reset_launches()
            g = svc.submit(lmp, b).result(timeout=T)
            counts = _launches()
            check(_only_launched(counts, 'exec_blocks'),
                  f'serve (c): launches {counts}')
            per_request.append(counts['exec_blocks'])
            _reset_launches()
            want = simulate_batch(lmp, b, cfg=dataclasses.replace(
                lcfg, engine='pallas'), device=DEV)
            direct = _launches()['exec_blocks']
            check(per_request[-1] == direct and direct > 0,
                  f'serve (c): K1 block {per_request[-1]} launches served, '
                  f'{direct} direct')
            _served_equal(g, want, 'serve (c) pallas')
    with _service(lcfg, singleton_engine='block',
                  max_batch_programs=1, max_wait_ms=1.0) as svc:
        _reset_launches()
        g = svc.submit(lmp, lbits[0]).result(timeout=T)
        check(_only_launched(_launches()),
              'serve (c): the plain block engine launched a hand kernel')
    _served_equal(g, simulate_batch(lmp, lbits[0], cfg=dataclasses.replace(
        lcfg, engine='block'), device=DEV), 'serve (c) block')
    launches['exec_blocks'] = per_request[0]
    print(f"serve (c): the looped headline x {Bl} lanes, "
          f"singleton_engine='pallas': K1 block launches per request "
          f'{per_request}, each equal on every key to the direct call; '
          f"singleton_engine='block' (the plain block engine) equal, no "
          f'hand kernel, on {smi}')
    t_part = _part('(c)', t_part)

    # (d) streams on the span rung
    label, rmp, rcfg = lut_workloads()[0]
    rcfg = dataclasses.replace(rcfg, engine='pallas', record_pulses=False)
    spec = qec.repetition_decode_spec(LUT['n_data'])
    R, Bs = SERVE['stream_rounds'], SERVE['stream_shots']
    rbits = rng.integers(0, 2, (R, Bs, rmp.n_cores, rcfg.max_meas),
                         dtype=np.int32)
    chunks = [rng.integers(0, 2, (SERVE['session_rounds'], Bs, rmp.n_cores,
                                  rcfg.max_meas), dtype=np.int32)
              for _ in range(SERVE['session_chunks'])]
    with _service(max_wait_ms=1.0) as svc:
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        g = svc.submit_rounds(rmp, rbits, cfg=rcfg,
                              decode=spec).result(timeout=T)
        chunk_s = time.perf_counter() - t0
        counts = _launches()
        check(counts['exec_span'] == 1 and _only_launched(counts,
                                                          'exec_span'),
              f'serve (d) chunk: launches {counts}')
        _served_equal(g, simulate_rounds(rmp, rbits, cfg=rcfg, decode=spec,
                                         device=DEV), 'serve (d) chunk')
        _reset_launches()
        t0 = time.perf_counter()
        with svc.open_stream(rmp, cfg=rcfg, decode=spec) as sess:
            for mb in chunks:
                sess.submit_rounds(mb)
            frames = list(sess.results(timeout=T))
        session_s = time.perf_counter() - t0
        n_sess = _launches()['exec_span']
        st = svc.stats()['streaming']
    check(n_sess == len(chunks), f'serve (d) session: K1 span {n_sess}')
    for i, (mb, f) in enumerate(zip(chunks, frames)):
        _served_equal(f, simulate_rounds(rmp, mb, cfg=rcfg, decode=spec,
                                         device=DEV), f'serve (d) chunk {i}')
    check(st['rounds_served'] == R + len(chunks) * SERVE['session_rounds'],
          f'serve (d): streaming stats {st}')
    print(f'serve (d): {label}, submit_rounds of {R} x {Bs} with the '
          f'majority decode in {chunk_s:.4f} s, K1 span launches 1; a '
          f'session of {len(chunks)} chunks x {SERVE["session_rounds"]} '
          f'rounds in {session_s:.4f} s, K1 span launches {n_sess}; every '
          f'chunk equal on every key to its direct simulate_rounds on {smi}')
    t_part = _part('(d)', t_part)

    # (e) the compile front door
    n = HEADLINE['n_qubits']
    src = qasm_headline_source(n, HEADLINE['depth'], 1234)
    qchip = make_default_qchip(n)
    Bq = SERVE['qasm_shots']
    qbits = rng.integers(0, 2, (Bq, mp.n_cores, 2), dtype=np.int32)
    host_ms, statuses = [], []
    with _service(hcfg, max_batch_programs=1,
                  max_wait_ms=1.0) as svc:
        cache = svc.compile_cache
        for _ in range(SERVE['qasm_submits']):
            before = cache.stats()
            t0 = time.perf_counter()
            g = svc.submit_source(src, qchip, meas_bits=qbits,
                                  n_qubits=n).result(timeout=T)
            host_ms.append(1e3 * (time.perf_counter() - t0))
            after = cache.stats()
            statuses.append('miss' if after['misses'] > before['misses']
                            else 'hit' if after['hits'] > before['hits']
                            else '?')
        mp_q, status, _key = cache.get_or_compile(src, qchip, n_qubits=n)
    check(statuses == ['miss'] + ['hit'] * (SERVE['qasm_submits'] - 1)
          and status == 'hit', f'serve (e): cache statuses {statuses}')
    check(machine_program_bytes(mp_q) == machine_program_bytes(mp),
          "serve (e): the QASM headline's bytes differ from the dict "
          "headline's")
    _served_equal(g, simulate_batch(mp, qbits, cfg=dataclasses.replace(
        hcfg, straightline=False), device=DEV), 'serve (e)')
    print(f'serve (e): submit_source of the QASM headline ({len(src)} '
          f'characters) x {Bq} shots: cache {statuses}, host ms per '
          f'request ' + ' / '.join(f'{x:.1f}' for x in host_ms)
          + f"; compiled bytes equal to the dict headline's; result equal "
          f'to a direct simulate_batch on {smi}')
    t_part = _part('(e)', t_part)

    # (f) warm-up from (a)'s learned catalog
    specs = BucketCatalog(catalog).load()
    check(len(specs) >= 1, 'serve (f): (a) recorded no bucket spec')
    # one batch at the catalog's largest occupancy, ripened by count
    P = max(s.n_programs for s in specs)
    first = [job for t_jobs in jobs for job in t_jobs][:P]
    # the requests of (a), whose results equal their direct calls
    with _service(cfg, max_batch_programs=P, max_wait_ms=60_000.0,
                  trace_sample=1.0) as svc:
        t0 = time.perf_counter()
        report = svc.warmup(specs)
        warm_s = time.perf_counter() - t0
        hs = [svc.submit(m, b) for m, b in first]
        got = [h.result(timeout=T) for h in hs]
        klass = [s['args']['classification'] for s in hs[0].trace()
                 if s['name'] == 'dispatch']
        st = svc.stats()
    check(klass[:1] == ['aot'], f'serve (f): first dispatch labelled '
                                f'{klass}, not aot')
    check(st['compile']['cold'] == len(specs) and st['dispatches'] >= 1,
          f'serve (f): compile stats {st["compile"]}')
    for i, g in enumerate(got):
        _served_equal(g, {k: torch.as_tensor(v) for k, v in
                          results[i].items()}, 'serve (f) vs (a)')
    warm_ms = [v['warm_ms_mean'] for v in st['compile']['per_bucket']
               .values() if v['warm_ms_mean'] is not None]
    print(f'serve (f): warmup() of {len(specs)} catalog specs ('
          + ', '.join(s.label() for s in specs) + f') in {warm_s:.3f} s '
          f'(' + ', '.join(f'{r["compile_ms"]:.1f}' for r in report)
          + f' ms each); the first dispatch labelled aot; first-dispatch '
          f'wall warm {", ".join(f"{x:.1f}" for x in warm_ms)} ms against '
          f'cold {", ".join(f"{x:.1f}" for x in cold_ms)} ms in (a) on '
          f'{smi}')
    t_part = _part('(f)', t_part)

    # (g) chaos soak
    plan = ChaosPlan(seed=11, script=('crash',) * 3, p_crash=0.1,
                     p_slow=0.05, slow_s=0.005)
    soak_mps = mps[:SERVE['soak_programs']]
    with _service(cfg, max_batch_programs=SERVE['max_batch'],
                  max_wait_ms=SERVE['max_wait_ms'],
                  retry_policy=RetryPolicy(max_attempts=6,
                                           backoff_s=0.005),
                  breaker_threshold=2, breaker_cooldown_ms=60.0,
                  supervise_interval_ms=10.0) as svc:
        with ChaosMonkey(svc, plan) as monkey:
            t0 = time.perf_counter()
            rep = soak(svc, soak_mps, cfg,
                       n_requests=SERVE['soak_requests'],
                       shots=SERVE['soak_shots'], seed=12,
                       result_timeout_s=T, device=DEV)
            soak_s = time.perf_counter() - t0
        st = svc.stats()
    typed = {'ChaosError', 'ExecutorLostError', 'OverloadError',
             'QueueFullError'}
    check(rep.hung == 0 and rep.bit_mismatches == 0
          and rep.terminated() == rep.submitted
          and set(rep.errors) <= typed and monkey.script_exhausted(),
          f'serve (g): soak {rep}')
    check(st['retries'] >= rep.retries >= 1,
          f'serve (g): retries {st["retries"]} / {rep.retries}')
    print(f'serve (g): chaos soak of {rep.submitted} requests x '
          f'{SERVE["soak_shots"]} shots in {soak_s:.3f} s, injected '
          f'{dict(monkey.injected)}: {rep.completed} completed equal to '
          f'their solo runs, typed failures {dict(rep.errors)}, retries '
          f'{st["retries"]}, breaker trips {st["breaker_trips"]}, '
          f'readmissions {st["readmissions"]} on {smi}')
    _part('(g)', t_part)

    # (h) no service thread outlives its service
    left = [t.name for t in threading.enumerate()
            if t.name.startswith('dproc-serve') and t.is_alive()]
    check(not left, f'serve (h): threads left after shutdown: {left}')
    print('serve (h): after shutdown(drain=True) no dproc-serve thread is '
          'left')
    return launches, dict(mps=mps, bits=bits, cfg=cfg, results=results)


def phase_calib(env) -> None:
    """The closed calibration loop on the card: ``calibrate`` for the
    amplitude (the truth at x90 = 0.52, the qchip at 0.48) through a
    service on the card, converged within 5e-3 of the truth and written
    back to the live qchip; the same loop through a CPU service takes the
    same steps and reaches the amplitude within one DAC word."""
    from distributed_processor_tpu_torch.calib import calibrate
    from distributed_processor_tpu_torch.models import make_default_qchip
    from distributed_processor_tpu_torch.serve import ExecutionService
    from distributed_processor_tpu_torch.sim.grad import LossSpec
    spec = LossSpec(knob='amplitude', x90_amp=CALIB_LOOP['x90_amp'])
    runs = {}
    for dev in (DEV, 'cpu'):
        qchip = make_default_qchip(2)
        with (_service() if dev == DEV
              else ExecutionService(devices=['cpu'])) as svc:
            t0 = time.perf_counter()
            res = calibrate(svc, qchip, knob='amplitude', qubit='Q0',
                            spec=spec, shots=CALIB_LOOP['shots'],
                            n_qubits=2, result_timeout=SERVE['timeout'],
                            device=dev)
            runs[dev] = (res, qchip, time.perf_counter() - t0,
                         svc.stats()['calibration'])
    res, qchip, wall, cal = runs[DEV]
    amp = res.params['amp']
    check(res.converged and abs(amp - CALIB_LOOP['x90_amp'])
          <= CALIB_LOOP['atol_truth'], f'calib: {res.to_dict()}')
    check(qchip.gates['Q0X90'].contents[0].amp == amp
          and res.fp_before != res.fp_after == qchip.fingerprint(),
          'calib: the converged amplitude was not written back')
    check(cal['converged'] == 1 and cal['steps'] == res.steps,
          f'calib: session counters {cal}')
    cpu = runs['cpu'][0]
    check(cpu.steps == res.steps and abs(cpu.params['amp'] - amp)
          <= CALIB_LOOP['atol_cpu'],
          f'calib: card {res.steps} steps amp {amp}, CPU {cpu.steps} steps '
          f'amp {cpu.params["amp"]}')
    print(f'calib: calibrate(amplitude) through a service on the card: '
          f'converged in {res.steps} steps to amp {amp:.6f} (truth '
          f'{CALIB_LOOP["x90_amp"]}), written back (qchip fingerprint '
          f'moved, {res.flushed} stale cache entries flushed) in '
          f'{wall:.3f} s; the CPU loop {cpu.steps} steps to '
          f'{cpu.params["amp"]:.6f} in {runs["cpu"][2]:.3f} s on '
          f'{env["smi"]}')


# the multi-process serving tier on the card: two replica processes
# (one CUDA context and one executor each) behind the router of this
# process; (a) replays phase_serve (a)'s requests, the kill and wedge
# parts a soak of RB requests of 1024 shots (a third of the way in, the
# loaded replica is killed), the headline requests of (b) run on K1
# span through a second fleet with singleton_engine='pallas'.  The
# routers keep the default liveness window (250 ms): gossip travels on a
# connection of its own, beside the one carrying the result frames (a
# batch of (a) is 16 results of ~4.5 MB, a headline result ~300 MB)
FLEET = dict(replicas=2, soak_requests=48, soak_programs=8,
             soak_shots=1024, soak_rate_hz=40.0, kill_window_s=2.0,
             wedge_requests=8, timeout=300.0, gossip_ms=100.0)
# the command line on the card: the QASM headline at the headline's
# batch, the looped headline at the loop path's lanes, the 1M-shot sweep
CLI = dict(shots=262144, p1=0.15, loop_shots=32768, sweep_shots=1048576,
           sweep_batch=262144, catalog_shots=1024, timeout=300.0)


def _fleet(name: str, trace: bool = False, **service):
    """A ``Fleet`` of :data:`FLEET` replicas on the card (each replica's
    service on its default device, the card), or on :data:`DEV` where a
    rehearsal sets another device; the router retries a lost replica's
    requests up to 10 times and, with ``trace``, samples every request
    (the replica's spans come back on the reply, and each request's
    ``wire.await`` span carries its wire time)."""
    from distributed_processor_tpu_torch.serve import Fleet, RetryPolicy
    if DEV != 'cuda':
        service['devices'] = [DEV]
    router_kwargs = {'retry_policy': RetryPolicy(
        max_attempts=10, backoff_s=0.05, max_backoff_s=1.0),
        'gossip_interval_ms': FLEET['gossip_ms']}
    if trace:
        router_kwargs['trace_sample'] = 1.0
    if 'default_cfg' in service:
        router_kwargs['default_cfg'] = service.pop('default_cfg')
    return Fleet(FLEET['replicas'], service=service, name=name,
                 router_kwargs=router_kwargs,
                 ready_timeout_s=FLEET['timeout'])


def _fleets(*specs) -> list:
    """Fleets booted side by side, one ``_fleet(**spec)`` each; if one
    fails to boot, the others are shut down before the error surfaces."""
    with ThreadPoolExecutor(len(specs)) as pool:
        futs = [pool.submit(lambda kw: _fleet(**kw), spec) for spec in specs]
    made, err = [], None
    for f in futs:
        try:
            made.append(f.result())
        except BaseException as exc:     # noqa: BLE001 - re-raised below
            err = exc
    if err is not None:
        for fleet in made:
            fleet.shutdown()
        raise err
    return made


def _wire_bytes(fleet) -> int:
    """Bytes on the wire so far, both ways, summed over the replicas'
    meters (every request here is the default tenant's)."""
    return sum(fleet.replica_stats(rid)['tenants'].get('default', {})
               .get('bytes_wire', 0) for rid in fleet.replica_ids())


def _wait(cond, what: str, timeout: float):
    """Poll ``cond()`` until it returns a true value, and return that;
    fails after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    fail(f'fleet: {what} within {timeout} s')


def _engines(fleet) -> dict:
    return {rid: dict(fleet.replica_stats(rid)['engine_dispatches'])
            for rid in fleet.replica_ids()}


def phase_fleet(env, served: dict) -> dict:
    """The multi-process serving tier on the card: ``Fleet`` of two
    replica processes, each an ``ExecutionService`` with one executor on
    the card in a CUDA context of its own, behind the ``FleetRouter`` of
    this process.  (a) phase_serve (a)'s 64 RB requests from 4 threads
    through the router, each result equal on every key to (a)'s
    in-process result, which phase_serve held equal to its direct
    ``simulate_batch``; (c) a soak with the loaded replica SIGKILLed a
    third of the way in: every completion equal to its solo run,
    goodput inside the kill window, the respawned replica routable again
    and its first request after the catalog replay counted warm; (d) the
    loaded replica SIGSTOPped under traffic: gossip staleness takes it
    out, the requests complete on the other, SIGCONT re-admits it; (b)
    through a second fleet with ``singleton_engine='pallas'``: 4
    headline requests at 262144 shots on K1 span (~200 MB result frames)
    and the looped headline at 32768 lanes on K1 block, each equal to
    the direct call, the replicas' dispatches counted; (e) after both
    shut down, no ``dproc-serve`` thread and no replica process is
    left.  The two fleets boot side by side.  Returns the replicas' K1
    span and K1 block dispatches."""
    import dataclasses
    import os
    import threading
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.serve import fleet_soak
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    smi, T = env['smi'], FLEET['timeout']
    mps, bits, cfg = served['mps'], served['bits'], served['cfg']
    out = {}
    t_part = time.perf_counter()
    fleet, k1_fleet = _fleets(
        dict(name='fleet-rb', default_cfg=cfg,
             max_batch_programs=SERVE['max_batch'],
             max_wait_ms=SERVE['max_wait_ms'], max_queue=256),
        dict(name='fleet-k1', trace=True, singleton_engine='pallas',
             max_batch_programs=1, max_wait_ms=1.0))
    boot_s = time.perf_counter() - t_part
    procs = [s.proc for f in (fleet, k1_fleet) for s in f._replicas]
    soak_mps = mps[:FLEET['soak_programs']]
    rng = np.random.default_rng(4411)
    soak_bits = [rng.integers(0, 2, (FLEET['soak_shots'], mp.n_cores, 2),
                              dtype=np.int32) for mp in soak_mps]
    probe = dict(mp=soak_mps[0], meas_bits=soak_bits[0], cfg=cfg)
    try:
        # every replica serves the soak's shape once, which the shared
        # catalog records for a respawn to replay
        for rid in fleet.replica_ids():
            fleet.router.call_replica(rid, 'submit', dict(probe),
                                      timeout_s=T)
        print(f'fleet: two fleets of {FLEET["replicas"]} replicas each '
              f'ready in {boot_s:.2f} s, booted side by side (pids '
              f'{[p.pid for p in procs]})')
        t_part = _part('boot', t_part, 'fleet')

        # (a) routed RB traffic
        per = len(mps) // SERVE['threads']
        jobs = [[(mps[t * per + j], bits[t * per + j]) for j in range(per)]
                for t in range(SERVE['threads'])]
        wire0 = _wire_bytes(fleet)
        stale0 = fleet.router.stats()['gossip_stale']
        results, wall, lat = _serve_threads(fleet, jobs)
        wire_a = _wire_bytes(fleet) - wire0
        for i, got in enumerate(results):
            _served_equal(got, {k: torch.as_tensor(v) for k, v in
                                served['results'][i].items()},
                          f'fleet (a) request {i}')
        del results
        st = fleet.stats()
        rs = fleet.router.stats()
        window_ms = fleet.router._liveness_window_s * 1e3
        eng_a = _engines(fleet)
        check(sum(e.get('generic', 0) for e in eng_a.values()) >= 1,
              f'fleet (a): replica engines {eng_a}')
        B = bits[0].shape[0]
        lat_ms = np.sort(np.asarray(lat) * 1e3)
        print(f'fleet (a): {len(mps)} RB requests x {B} shots from '
              f'{SERVE["threads"]} threads through the router in '
              f'{wall:.3f} s: {len(mps) / wall:.1f} requests/s, '
              f'{len(mps) * B / wall:.1f} shots/s; handle latency p50 '
              f'{np.percentile(lat_ms, 50):.1f} / p99 '
              f'{np.percentile(lat_ms, 99):.1f} ms (router p50 '
              f'{st["latency_p50_ms"]:.1f} / p99 {st["latency_p99_ms"]:.1f} '
              f'ms); {wire_a / 1e6:.1f} MB on the wire; replica engine '
              f'dispatches {eng_a}; liveness window {window_ms:.0f} ms: '
              f'{rs["gossip_stale"] - stale0} stale heartbeats, failovers '
              f'{rs["failovers"]}, retries {rs["retries"]}; every result '
              f'equal on every key to phase_serve (a)\'s in-process result '
              f'on {smi}')
        out['a'] = dict(rps=len(mps) / wall, wall=wall)
        t_part = _part('(a)', t_part, 'fleet')

        # (c) SIGKILL the loaded replica mid-stream
        before = fleet.router.stats()
        n = FLEET['soak_requests']
        t_soak = time.monotonic()
        rep = fleet_soak(fleet, soak_mps, cfg, n_requests=n,
                         shots=FLEET['soak_shots'], seed=21,
                         rate_hz=FLEET['soak_rate_hz'],
                         actions=[(n // 3, 'kill', -1)],
                         result_timeout_s=T, device=DEV)
        kill_t = next(t for t, m, _ in rep.actions if m == 'kill')
        victim = fleet.replica_ids()[next(i for _, m, i in rep.actions
                                          if m == 'kill')]
        ok_kill = rep.ok_in_window(kill_t, kill_t + FLEET['kill_window_s'])
        check(rep.hung == 0 and rep.bit_mismatches == 0
              and rep.terminated() == rep.submitted and ok_kill > 0,
              f'fleet (c): soak {rep}, {ok_kill} completions in the kill '
              f'window')
        after = fleet.router.stats()
        check(after['replica_down'] >= before['replica_down'] + 1,
              f'fleet (c): no replica_down after the kill: {after}')
        _wait(lambda: fleet.stats()['replicas'].get(victim, {})
              .get('routable') and fleet.stats()['processes'][victim]
              ['respawns'] >= 1, 'the killed replica was not respawned', T)
        slot = fleet._replicas[fleet.replica_ids().index(victim)]
        # the respawn is routable once its ready line is read and the
        # router has connected (spawned_t); the kill fired kill_t into
        # the soak
        routable_s = slot.spawned_t - (t_soak + kill_t)
        procs.append(slot.proc)

        def replayed():
            r = fleet.replica_stats(victim)
            return r if r['warmup']['in_progress'] == 0 else None
        rs = _wait(replayed, 'the respawned replica\'s warm-up did not '
                             'settle', T)
        cold0 = rs['compile']['cold']
        got = fleet.router.call_replica(victim, 'submit', dict(probe),
                                        timeout_s=T)
        cold1 = fleet.replica_stats(victim)['compile']['cold']
        check(cold1 == cold0 and rs['warmup']['replayed'] >= 1,
              f'fleet (c): the respawned replica counted {cold1 - cold0} '
              f'cold dispatches after replaying {rs["warmup"]["replayed"]} '
              f'catalog specs')
        _served_equal(got, simulate_batch(soak_mps[0], soak_bits[0],
                                          cfg=dataclasses.replace(
                                              cfg, engine='generic'),
                                          device=DEV),
                      'fleet (c) respawned replica')
        print(f'fleet (c): soak of {rep.submitted} requests x '
              f'{FLEET["soak_shots"]} shots at {FLEET["soak_rate_hz"]} Hz, '
              f'replica {victim} SIGKILLed at {kill_t:.3f} s: '
              f'{rep.completed} completed equal to their solo runs, '
              f'{ok_kill} inside the {FLEET["kill_window_s"]} s kill window, '
              f'typed failures {dict(rep.errors)}; failovers '
              f'{after["failovers"] - before["failovers"]}, retries '
              f'{after["retries"] - before["retries"]}; respawned and '
              f'routable {routable_s:.2f} s after the kill, its '
              f'first request after replaying {rs["warmup"]["replayed"]} '
              f'catalog specs counted warm on {smi}')
        out['routable_s'] = routable_s
        t_part = _part('(c)', t_part, 'fleet')

        # (d) SIGSTOP the loaded replica under traffic, then SIGCONT
        _wait(lambda: fleet.router.stats()['n_routable']
              == FLEET['replicas'], 'both replicas routable', T)
        before = fleet.router.stats()
        victim = fleet.router.primary_replica()
        vidx = fleet.replica_ids().index(victim)
        k = FLEET['wedge_requests']
        reqs = [(soak_mps[i % len(soak_mps)], soak_bits[i % len(soak_mps)])
                for i in range(k)]
        hs = [fleet.submit(m, b) for m, b in reqs]
        t0 = time.monotonic()
        fleet.wedge(vidx)
        try:
            got = [h.result(timeout=T) for h in hs]

            def caught():
                s = fleet.router.stats()
                return s['gossip_stale'] > before['gossip_stale'] \
                    and not s['replicas'][victim]['alive']
            _wait(caught, 'gossip staleness did not catch the wedge', T)
            stale_s = time.monotonic() - t0
        finally:
            fleet.unwedge(vidx)
        t0 = time.monotonic()
        _wait(lambda: fleet.router.stats()['replicas'][victim]['routable'],
              'the unwedged replica was not re-admitted', T)
        readmit_s = time.monotonic() - t0
        gcfg = dataclasses.replace(cfg, engine='generic')
        for i, ((m, b), g) in enumerate(zip(reqs, got)):
            _served_equal(g, simulate_batch(m, b, cfg=gcfg, device=DEV),
                          f'fleet (d) request {i}')
        st = fleet.router.stats()
        check(st['replica_up'] >= before['replica_up'] + 1,
              f'fleet (d): no re-admission: {st}')
        print(f'fleet (d): replica {victim} SIGSTOPped under {k} requests: '
              f'gossip staleness marked it down within {stale_s:.3f} s '
              f'(liveness window {window_ms:.0f} ms), all {k} '
              f'completed equal to their '
              f'direct calls (failovers '
              f'{st["failovers"] - before["failovers"]}); SIGCONT '
              f're-admitted it in {readmit_s:.3f} s on {smi}')
        eng = _engines(fleet)
        metrics = fleet.router.fleet_metrics()
        served_n = {rid: {k: v for k, v in m['counters'].items()
                          if k.startswith('serve.engine.')}
                    for rid, m in metrics.items()}
        print(f'fleet: router totals: submitted {st["submitted"]}, '
              f'completed {st["completed"]}, failed {st["failed"]}, '
              f'failovers {st["failovers"]}, retries {st["retries"]}, '
              f'replica_down {st["replica_down"]}, replica_up '
              f'{st["replica_up"]}, gossip_stale {st["gossip_stale"]}; '
              f'replica engine dispatches {eng}; fleet-metrics '
              f'serve.engine counters {served_n}')
        t_part = _part('(d)', t_part, 'fleet')
    except BaseException:
        k1_fleet.shutdown()
        raise
    finally:
        fleet.shutdown()

    # (b) headline requests on K1 span, the looped headline on K1 block
    fleet = k1_fleet
    mp = headline_program()
    hcfg = headline_config(mp)
    Bh = HEADLINE['batch']
    hbits = [rng.integers(0, 2, (Bh, mp.n_cores, 2), dtype=np.int32)
             for _ in range(SERVE['k1_requests'])]
    lmp = loop_program()
    lcfg = loop_config(lmp)
    lbits = rng.integers(0, 2, (LOOP['batch'], lmp.n_cores,
                                LOOP['max_meas']), dtype=np.int32)
    try:
        wire0 = _wire_bytes(fleet)
        rs0 = fleet.router.stats()
        t0 = time.perf_counter()
        hs = [fleet.submit(mp, b, cfg=hcfg) for b in hbits]
        got, done_s = [], []
        for h in hs:
            got.append(h.result(timeout=T))
            done_s.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        wire_b = _wire_bytes(fleet) - wire0
        # per request: the round trip less the replica's own window
        wire_ms = [s['args']['wire_ms'] for c in fleet.router.trace_contexts()
                   for s in c.spans if s['name'] == 'wire.await'
                   and 'wire_ms' in s['args']]
        eng_b = _engines(fleet)
        t0 = time.perf_counter()
        lgot = fleet.submit(lmp, lbits, cfg=lcfg).result(timeout=T)
        loop_s = time.perf_counter() - t0
        eng_l = _engines(fleet)
        rs = fleet.router.stats()
    finally:
        fleet.shutdown()
    n_span = sum(e.get('pallas', 0) for e in eng_b.values())
    n_loop = sum(e.get('pallas', 0) for e in eng_l.values()) - n_span
    check(n_span == SERVE['k1_requests'] and n_loop == 1,
          f'fleet (b): replica engines {eng_b} then {eng_l}')
    pcfg = headline_config(mp, engine='pallas')
    for i, (b, g) in enumerate(zip(hbits, got)):
        _served_equal(g, simulate_batch(mp, b, cfg=pcfg, device=DEV),
                      f'fleet (b) request {i}')
    del got
    _reset_launches()
    want = simulate_batch(lmp, lbits, cfg=dataclasses.replace(
        lcfg, engine='pallas'), device=DEV)
    blocks = _launches()['exec_blocks']
    _served_equal(lgot, want, 'fleet (b) looped headline')
    del want, lgot
    print(f"fleet (b): the second fleet (singleton_engine='pallas'): "
          f'{SERVE["k1_requests"]} headline requests x '
          f'{Bh} shots in {wall:.3f} s (done at '
          + ', '.join(f'{x:.3f}' for x in done_s)
          + f' s; {wire_b / 1e6:.1f} MB on the wire, '
          f'{wire_b / len(hbits) / 1e6:.1f} MB a request, wire ms per '
          f'request (round trip less the replica\'s window) '
          + ', '.join(f'{x:.1f}' for x in wire_ms)
          + f'), replica K1 span dispatches {n_span}; the looped headline x {LOOP["batch"]} '
          f'lanes in {loop_s:.3f} s, replica K1 block dispatches {n_loop} '
          f'({blocks} K1 block launches in the same direct call here); '
          f'liveness window {fleet.router._liveness_window_s * 1e3:.0f} ms: '
          f'{rs["gossip_stale"] - rs0["gossip_stale"]} stale heartbeats, '
          f'failovers {rs["failovers"] - rs0["failovers"]}; '
          f'each equal on every key to the direct simulate_batch('
          f"engine='pallas') on {smi}")
    check(len(wire_ms) == len(hbits), f'fleet (b): wire spans {wire_ms}')
    out['span_dispatches'], out['block_dispatches'] = n_span, n_loop
    out['block_launches'] = blocks
    t_part = _part('(b)', t_part, 'fleet')

    # (e) nothing left behind
    _wait(lambda: not any(t.name.startswith('dproc-serve')
                          for t in threading.enumerate()),
          'dproc-serve threads outlived the fleets', 10.0)
    alive = []
    for p in procs:
        if p.poll() is None:
            alive.append(p.pid)
            continue
        try:
            os.kill(p.pid, 0)
            alive.append(p.pid)
        except ProcessLookupError:
            pass
    check(not alive, f'fleet (e): replica processes left: {alive}')
    print(f'fleet (e): after shutdown no dproc-serve thread and none of the '
          f'{len(procs)} replica processes is left')
    return out


def _cli(argv: list, expect: dict, label: str) -> tuple:
    """``cli.main(['--torch-device', DEV] + argv)`` with every launch
    count set to 0 just before; returns ``(stdout, launches, wall s)``
    and prints them.  ``expect``: kernel name -> a predicate on its
    count; no other kernel may launch."""
    import contextlib
    import io
    from distributed_processor_tpu_torch import cli
    buf = io.StringIO()
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(['--torch-device', DEV] + argv)
    sync()
    wall = time.perf_counter() - t0
    counts = _launches()
    shown = {k: v for k, v in counts.items() if v}
    check(_only_launched(counts, *expect)
          and all(ok(counts[k]) for k, ok in expect.items()),
          f'cli {label}: launches {shown}')
    print(f'cli {label}: {wall:.3f} s, launches {shown}')
    return buf.getvalue(), counts, wall


def phase_cli(env) -> dict:
    """The command line on the card, each command through ``cli.main`` in
    this process with its launch counts set to 0 just before it: ``run``
    of the QASM headline physics-closed at 262144 shots (K2 once per
    epoch), on ``--engine pallas`` with ``--p1 0.15`` (one K1 span
    launch), and of the looped headline (a dict program with a hardware
    loop) on ``--engine pallas`` (K1 block, one launch per block-engine
    iteration); ``sweep`` of 1M shots in batches of 262144 (K2 per
    epoch); ``warmup`` of a learned catalog; ``serve-bench`` at its
    defaults; ``fleet-status`` against a live fleet; then ``python -m
    distributed_processor_tpu_torch run`` in a process of its own, equal
    on the integer fields to the in-process call.  Returns the launches
    of K2, K1 span and K1 block."""
    import os
    import tempfile
    import numpy as np
    from distributed_processor_tpu_torch import Simulator, compile_to_machine
    from distributed_processor_tpu_torch.models import (active_reset,
                                                        make_default_qchip,
                                                        rb_ensemble)
    from distributed_processor_tpu_torch.models.experiments import \
        loop_shots_program
    from distributed_processor_tpu_torch.serve import Fleet
    smi, T = env['smi'], CLI['timeout']
    out = {}
    tmp = tempfile.mkdtemp(prefix='cli-')
    n = HEADLINE['n_qubits']
    qubits = [f'Q{i}' for i in range(n)]
    qasm = os.path.join(tmp, 'headline.qasm')
    with open(qasm, 'w') as f:
        f.write(qasm_headline_source(n, HEADLINE['depth'], 1234))
    loop = os.path.join(tmp, 'loop.json')
    with open(loop, 'w') as f:
        json.dump(loop_shots_program(headline_source(), LOOP['n_shots'],
                                     scope=qubits), f)
    pos = (lambda c: c > 0)
    t_part = time.perf_counter()

    text, counts, _ = _cli(['run', qasm, '--physics', '--shots',
                            str(CLI['shots']), '--p1-init', str(CLI['p1'])],
                           {'resolve_windows': pos,
                            'exec_span_physics': lambda c: c >= 0},
                           'run --physics')
    r = json.loads(text)
    check(r['error_shots'] == 0 and not any(r['fault_shots'].values())
          and counts['resolve_windows'] == r['epochs'],
          f'cli run --physics: {r}, K2 {counts["resolve_windows"]}')
    out['resolve_windows'] = counts['resolve_windows']
    print(f'cli run --physics: {r["shots"]} shots on {r["engine"]}, '
          f'{r["epochs"]} epochs, K2 launches {counts["resolve_windows"]}, '
          f'meas1 rate per core '
          + ', '.join(f'{x:.4f}' for x in r['meas1_rate_per_core']))

    argv = ['run', qasm, '--engine', 'pallas', '--p1', str(CLI['p1']),
            '--shots', str(CLI['shots'])]
    text, counts, cli_s = _cli(argv, {'exec_span': lambda c: c == 1},
                               'run --engine pallas')
    span_run = json.loads(text)
    check(span_run['engine'] == 'pallas' and span_run['error_shots'] == 0,
          f'cli run --engine pallas: {span_run}')
    out['exec_span'] = counts['exec_span']
    # the same run through the facade the command wraps
    sim = Simulator(n_qubits=n, device=DEV)
    with open(qasm) as f:
        src = f.read()
    sync()
    t0 = time.perf_counter()
    r = sim.run(src, shots=CLI['shots'], p1=CLI['p1'], engine='pallas')
    int(r['steps'])
    sync()
    sim_s = time.perf_counter() - t0
    del r
    print(f'cli run --engine pallas: {cli_s:.3f} s against Simulator.run '
          f'of the same QASM text and arguments {sim_s:.3f} s on {smi}')

    text, counts, _ = _cli(['run', loop, '--engine', 'pallas', '--shots',
                            str(CLI['loop_shots'])],
                           {'exec_blocks': pos}, 'run loop --engine pallas')
    r = json.loads(text)
    check(r['engine'] == 'pallas' and r['error_shots'] == 0
          and not any(r['fault_shots'].values()),
          f'cli run loop: {r}')
    out['exec_blocks'] = counts['exec_blocks']

    text, counts, _ = _cli(['sweep', qasm, '--shots',
                            str(CLI['sweep_shots']), '--batch',
                            str(CLI['sweep_batch'])],
                           {'resolve_windows': pos,
                            'exec_span_physics': lambda c: c >= 0}, 'sweep')
    r = json.loads(text)
    check(r['shots'] == CLI['sweep_shots'] and r['err_shots'] == 0
          and not any(r['fault_shots'].values()), f'cli sweep: {r}')
    out['sweep_resolve_windows'] = counts['resolve_windows']
    t_part = _part('run, sweep', t_part, 'cli')

    # a learned catalog for warmup: one service run of two RB requests
    cat = os.path.join(tmp, 'catalog.json')
    mps = [compile_to_machine(active_reset(qubits) + p,
                              make_default_qchip(n), n_qubits=n)
           for p in rb_ensemble(qubits, HEADLINE['depth'], 2, seed=77)]
    cfg = multi_config(mps[0])
    rng = np.random.default_rng(4421)
    with _service(cfg, warmup_catalog=cat, max_wait_ms=1.0) as svc:
        for mp in mps:
            svc.submit(mp, rng.integers(0, 2, (CLI['catalog_shots'],
                                               mp.n_cores, 2),
                                        dtype=np.int32)).result(timeout=T)
    text, _, _ = _cli(['warmup', cat], {}, 'warmup')
    lines = [json.loads(x) for x in text.splitlines()]
    check(len(lines) >= 2 and lines[-1]['specs'] >= 1,
          f'cli warmup: {lines}')

    text, _, _ = _cli(['serve-bench'], {}, 'serve-bench')
    r = json.loads(text)
    check(r['bit_identical'] and r['warm_retraces'] == 0,
          f'cli serve-bench: {r}')
    print(f'cli serve-bench (defaults): {r["n_reqs"]} requests, sequential '
          f'{r["sequential_warm_s"]} s, service {r["service_warm_s"]} s, '
          f'ratio {r["throughput_ratio"]}, {r["dispatches"]} dispatches, '
          f'warm_retraces {r["warm_retraces"]}')
    t_part = _part('warmup, serve-bench', t_part, 'cli')

    # the module entry point in a process of its own, started beside the
    # fleet's boot (both are mostly interpreter and CUDA start-up)
    root = os.path.dirname(os.path.abspath(__file__))
    t_sub = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'distributed_processor_tpu_torch',
         '--torch-device', DEV] + argv, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        service = {} if DEV == 'cuda' else {'devices': [DEV]}
        with Fleet(1, service=service, name='fleet-cli',
                   ready_timeout_s=T) as fleet:
            fleet.submit(mps[0], rng.integers(
                0, 2, (CLI['catalog_shots'], mps[0].n_cores, 2),
                dtype=np.int32), cfg=cfg).result(timeout=T)
            host, port = fleet._replicas[0].address
            text, _, _ = _cli(['fleet-status', f'{host}:{port}', '--json'],
                              {}, 'fleet-status')
        rows = json.loads(text)
        check(len(rows) == 1 and rows[0]['completed'] == 1
              and 'error' not in rows[0], f'cli fleet-status: {rows}')
        t_part = _part('fleet-status', t_part, 'cli')
        stdout, stderr = proc.communicate(timeout=T)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    sub_s = time.perf_counter() - t_sub
    check(proc.returncode == 0, f'cli subprocess exited {proc.returncode}: '
                                f'{stderr[-2000:]}')
    sub = json.loads(stdout)
    ints = ('shots', 'error_shots', 'fault_shots', 'steps', 'engine')
    check({k: sub[k] for k in ints} == {k: span_run[k] for k in ints},
          f'cli subprocess {sub} differs from the in-process call '
          f'{span_run}')
    print(f'cli: python -m distributed_processor_tpu_torch run (K1 span) '
          f'in a process of its own, beside the fleet\'s boot: {sub_s:.2f} s '
          f'with start-up, equal on the integer fields to the in-process '
          f'call on {smi}')
    _part('subprocess', t_part, 'cli')
    return out


# the tooling on the card: the fault-injection corpus (35 mutants, about
# one cycle of its 5 base programs x 7 mutators) with K1 as a fourth engine
TOOLING = dict(fuzz_seed=0, fuzz_n=35)


def phase_tooling(env, k1: dict) -> dict:
    """The port's tooling on the card, with every launch count set to 0
    just before: the native codec (built in phase 1) decoding the
    headline's command buffers equal to the Python codec; the eleven
    goldens compiled here equal to ``tests/goldens/*.json`` byte for
    byte; the fault-injection fuzz with K1 span and K1 block as a fourth
    engine on every mutant, and the feedback (K1), fused (K3), vmap and
    audit consistency checks at the JAX package's defaults, each with no
    failure; K1 span, K1 block and K3 each launched.  Then
    ``carry_stream_bytes`` of the headline beside the bytes phase 2's K1
    bound counts (``k1``).  Returns the launches."""
    import os
    import numpy as np
    from distributed_processor_tpu_torch import isa, native
    from distributed_processor_tpu_torch.assembler import GlobalAssembler
    from distributed_processor_tpu_torch.elements import TPUElementConfig
    from distributed_processor_tpu_torch.hwconfig import FPGAConfig
    from distributed_processor_tpu_torch.models import (make_channel_configs,
                                                        make_default_qchip)
    from distributed_processor_tpu_torch.models.golden_suite import (
        GOLDEN_PROGRAMS, canonical_json, compile_golden)
    from distributed_processor_tpu_torch.pipeline import compile_program
    from distributed_processor_tpu_torch.sim import faultinject as fi
    from distributed_processor_tpu_torch.sim.interpreter import \
        carry_stream_bytes
    smi = env['smi']
    _reset_launches()
    t_start = t_part = time.perf_counter()

    # the native codec on the headline's command buffers
    check(native.available(), 'the native codec did not build or load')
    n = HEADLINE['n_qubits']
    prog = compile_program(headline_source(), make_default_qchip(n),
                           FPGAConfig(n_cores=n))
    bufs = [b['cmd_buf'] for b in GlobalAssembler(
        prog, make_channel_configs(n), TPUElementConfig)
        .get_assembled_program().values()]
    ms, soas = {}, {}
    for use_native in (True, False):
        t0 = time.perf_counter()
        soas[use_native] = [isa.decode_soa(b, use_native=use_native)
                            for b in bufs]
        ms[use_native] = (time.perf_counter() - t0) * 1e3
    for a, b in zip(soas[True], soas[False]):
        for f in isa.SOA_FIELDS:
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f'native decode of the headline differs on {f}')
    words = sum(len(b) for b in bufs) // 16
    print(f'tooling: native codec ({native.library_path()}) decodes the '
          f'headline\'s {len(bufs)} command buffers ({words} words) equal to '
          f'the Python codec on every field: {ms[True]:.3f} ms against '
          f'{ms[False]:.3f} ms (host ms, beside {smi})')
    t_part = _part('native', t_part, 'tooling')

    # the goldens
    root = os.path.dirname(os.path.abspath(__file__))
    for name in GOLDEN_PROGRAMS:
        with open(os.path.join(root, 'tests', 'goldens',
                               name + '.json')) as f:
            check(canonical_json(compile_golden(name)) + '\n' == f.read(),
                  f'golden {name} differs from tests/goldens/{name}.json')
    print(f'tooling: the {len(GOLDEN_PROGRAMS)} golden programs compile '
          f'equal to tests/goldens/*.json byte for byte (host, beside '
          f'{smi})')
    t_part = _part('goldens', t_part, 'tooling')

    # the fuzz, K1 beside the other engines
    engines = fi.ENGINES + ('pallas',)
    rep = fi.run_fuzz(seed=TOOLING['fuzz_seed'], n=TOOLING['fuzz_n'],
                      engines=engines, device=DEV)
    check(rep.ok and rep.n == TOOLING['fuzz_n'],
          f'fault-injection fuzz: {rep.verdicts}, failures '
          f'{rep.failures[:5]}')
    fuzz = _launches()
    print(f'tooling: run_fuzz(seed={TOOLING["fuzz_seed"]}, '
          f'n={TOOLING["fuzz_n"]}, engines={engines}): verdicts '
          f'{rep.verdicts}, no failure; K1 span {fuzz["exec_span"]}, K1 '
          f'block {fuzz["exec_blocks"]} launches on {smi}')
    t_part = _part('fuzz', t_part, 'tooling')

    # the consistency checks at the JAX package's defaults
    res = {}
    for name, fn in (('feedback', fi.check_feedback_consistency),
                     ('fused', fi.check_fused_consistency)):
        r = fn(device=DEV)
        check(not r['failures'] and r['checked'] > 0,
              f'check_{name}_consistency: {r}')
        res[name] = f'{r["checked"]} checked, {r["skipped"]} skipped'
    bad = fi.check_vmap_consistency(device=DEV)
    check(bad == 0, f'check_vmap_consistency: {bad} mismatched programs')
    aud = fi.check_audit_consistency(device=DEV)
    check(aud['false_positives'] == 0 and aud['checked'] > 0,
          f'check_audit_consistency: {aud}')
    counts = _launches()
    for k, label in (('exec_span', 'K1 span'), ('exec_blocks', 'K1 block'),
                     ('exec_span_fused', 'K3')):
        check(counts[k] > 0, f'tooling: {label} was not launched: {counts}')
    wall = time.perf_counter() - t_start
    print(f'tooling: consistency checks: feedback (generic, block, K1) '
          f'{res["feedback"]}, fused (generic, K3) {res["fused"]}, vmap 0 '
          f'mismatched, audit {aud["checked"]} checked, {aud["audits"]} '
          f'audits, 0 false positives; the phase launched K1 span '
          f'{counts["exec_span"]}, K1 block {counts["exec_blocks"]}, K3 '
          f'{counts["exec_span_fused"]} in {wall:.1f} s on {smi}')
    _part('consistency', t_part, 'tooling')

    # the carry stream beside K1's bound
    mp = headline_program()
    per_shot, packed = carry_stream_bytes(mp, headline_config(mp))
    B = k1['batch']
    check(packed == per_shot and k1['bound_bytes'] - k1['table_bytes']
          == B * per_shot,
          f'carry_stream_bytes {per_shot} x {B} shots + the table '
          f'{k1["table_bytes"]} != the K1 bound\'s {k1["bound_bytes"]} bytes')
    print(f'tooling: carry_stream_bytes(headline) = {per_shot} bytes a shot '
          f'(the carry read and written once, the injected bits read once; '
          f'packed = unpacked, one layout); phase 2\'s K1 bound counts '
          f'{k1["bound_bytes"]} bytes at B={B}: that stream for every shot '
          f'plus the program table and element geometry once '
          f'({k1["table_bytes"]} bytes), on {smi}')
    return counts


def phase_cuda_vs_cpu(mp):
    """Each path on the card against the same path on the CPU (the plain
    versions there), at sigma = 0 with explicit initial states."""
    import numpy as np
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    from distributed_processor_tpu_torch.sim.physics import run_physics_batch
    B = 256
    init = np.random.default_rng(5).integers(0, 2, (B, mp.n_cores))
    model = headline_model(sigma=0.0)
    for engine in (None, 'fused'):
        cfg = headline_config(mp, engine=engine)
        outs = {d: run_physics_batch(mp, model, 11, B, init_states=init,
                                     cfg=cfg, device=d)
                for d in (DEV, 'cpu')}
        for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err',
                    'fault', 'qturns', 'epochs', 'steps'):
            a, b = (outs[d][key].cpu().numpy() for d in (DEV, 'cpu'))
            check(np.array_equal(a, b),
                  f'CUDA and CPU differ in {key} (engine={engine!r})')
        sa, sb = (physics_batch_stats(outs[d]) for d in (DEV, 'cpu'))
        for key in sa:
            check(np.array_equal(sa[key].cpu().numpy(),
                                 sb[key].cpu().numpy()),
                  f'CUDA and CPU differ in stats {key} (engine={engine!r})')
        print(f'CUDA vs CPU at sigma=0, B={B}, engine={engine!r}: bits and '
              f'stats identical')
    bits = np.random.default_rng(6).integers(0, 2, (B, mp.n_cores, 2))
    cfg = headline_config(mp, engine='pallas', record_pulses=True)
    outs = {d: simulate_batch(mp, bits, cfg=cfg, device=d)
            for d in (DEV, 'cpu')}
    _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()}, outs['cpu'],
                  "CUDA vs CPU, engine='pallas'")
    print(f"CUDA vs CPU, simulate_batch(engine='pallas'), B={B}: every key "
          f'identical')
    # the 'lut' fabric's three paths at a small batch
    import dataclasses
    from distributed_processor_tpu_torch.models import qec
    Bl = LUT['cpu_batch']
    rng = np.random.default_rng(8)
    n, R = LUT['n_data'], LUT['rounds']
    for label, mp_l, cfg_l in lut_workloads() + [
            (f'QEC {R} rounds ({n} cores)',
             qec.qec_multiround_machine_program(n, R), qec.qec_config(n, R))]:
        bits = rng.integers(0, 2, (Bl, mp_l.n_cores, cfg_l.max_meas))
        cfg = dataclasses.replace(cfg_l, engine='pallas',
                                  opcode_histogram=True)
        outs = {d: simulate_batch(mp_l, bits, cfg=cfg, device=d)
                for d in (DEV, 'cpu')}
        _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()},
                      outs['cpu'], f"CUDA vs CPU, lut {label}")
        print(f"CUDA vs CPU, lut {label}, simulate_batch(engine='pallas'), "
              f'B={Bl}: every key identical')
    mp_p, cfg_p = lut_physics_program()
    init = (np.arange(Bl)[:, None] >> np.arange(n)) & 1
    outs = {d: run_physics_batch(mp_p, model, 3, Bl, init_states=init,
                                 cfg=dataclasses.replace(cfg_p,
                                                         engine='fused'),
                                 device=d) for d in (DEV, 'cpu')}
    _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()}, outs['cpu'],
                  "CUDA vs CPU, lut physics engine='fused'")
    print(f"CUDA vs CPU, lut physics (repetition round, engine='fused', "
          f'sigma=0), B={Bl}: every key identical')
    # streaming rounds with the decode, and a program ensemble
    from distributed_processor_tpu_torch.sim.interpreter import (
        simulate_multi_batch, simulate_rounds)
    Br, R = ROUNDS['cpu_shots'], 4
    for label, mp_l, cfg_l in lut_workloads():
        spec = qec.repetition_decode_spec(n) if mp_l.n_cores == n \
            else qec.surface_decode_spec(LUT['distance'])
        mb = rng.integers(0, 2, (R, Br, mp_l.n_cores, cfg_l.max_meas))
        cfg = dataclasses.replace(cfg_l, engine='pallas',
                                  opcode_histogram=True)
        outs = {d: simulate_rounds(mp_l, mb, cfg=cfg, decode=spec, device=d)
                for d in (DEV, 'cpu')}
        _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()},
                      outs['cpu'], f'CUDA vs CPU, rounds {label}')
        print(f"CUDA vs CPU, simulate_rounds(engine='pallas', decode) "
              f'{label}, {R} x {Br}: every key identical')
    mps, mmp = multi_ensemble(seed=7)
    Bm = MULTI['cpu_shots']
    mb = rng.integers(0, 2, (mmp.n_progs, Bm, mmp.n_cores, 2))
    cfg = dataclasses.replace(multi_config(mmp), opcode_histogram=True)
    outs = {d: simulate_multi_batch(mmp, mb, cfg=cfg, device=d)
            for d in (DEV, 'cpu')}
    _max_abs_diff({k: v.cpu() for k, v in outs[DEV].items()}, outs['cpu'],
                  'CUDA vs CPU, simulate_multi_batch')
    print(f'CUDA vs CPU, simulate_multi_batch {mmp.n_progs} programs x '
          f'{Bm}: every key identical')


def _sweep_keys(a: dict, b: dict, what: str) -> None:
    """Two sweep results equal on every key, arrays bit for bit."""
    import numpy as np
    check(set(a) == set(b), f'{what}: keys {sorted(set(a) ^ set(b))}')
    for k in a:
        same = a[k] == b[k] if isinstance(a[k], (dict, str, int, float)) \
            else np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        check(bool(same), f'{what}: {k} differs: {a[k]} vs {b[k]}')


def phase_sweep(mp, env):
    """The 1M-shot sweep (``run_physics_sweep``, 4 x 262144 shots) at
    ``span=1`` and ``span=4`` (identical sums, both walls), then stopped
    by a checkpoint after 2 batches and resumed to 4: equal to the
    uninterrupted sweep on every key."""
    import tempfile
    from distributed_processor_tpu_torch.parallel import run_physics_sweep
    n, B = HEADLINE['sweep_batches'], HEADLINE['batch']

    def sweep(total, **kw):
        return run_physics_sweep(mp, headline_model(), total, B, seed=2026,
                                 cfg=headline_config(mp), device=DEV, **kw)

    walls, res = {}, {}
    for span in (1, 4):
        sync()
        t0 = time.perf_counter()
        res[span] = sweep(n * B, span=span)
        sync()
        walls[span] = time.perf_counter() - t0
    r = res[1]
    check(r['incomplete_batches'] == 0 and r['shots'] == n * B,
          f'sweep incomplete: {r}')
    check(not any(r['fault_shots'].values()), f'sweep faults: {r}')
    _sweep_keys(res[1], res[4], 'sweep span 4 vs span 1')
    with tempfile.TemporaryDirectory() as tmp:
        ck = f'{tmp}/sweep.npz'
        sweep(2 * B, checkpoint=ck)
        sync()
        t0 = time.perf_counter()
        resumed = sweep(n * B, checkpoint=ck)
        sync()
        t_resume = time.perf_counter() - t0
    _sweep_keys(res[1], resumed, 'sweep resumed after 2 batches')
    print(f'sweep: {n * B} shots in {walls[1]:.3f} s at span 1 = '
          f'{n * B / walls[1]:.1f} shots/s, {walls[4]:.3f} s at span 4 '
          f'(identical sums), resumed from a 2-batch checkpoint in '
          f'{t_resume:.3f} s (identical to the uninterrupted sweep) on '
          f'{env["smi"]}; meas1_rate '
          + json.dumps([round(float(x), 5) for x in r['meas1_rate']])
          + f', survival00 {r["survival00_rate"]:.5f}')


def phase_mesh_path(mp, loop_mp, env) -> dict:
    """The mesh paths at world size 1 (a one-rank NCCL group), each
    driven with every launch count set to 0 just before it and read just
    after: ``run_physics_sweep(mesh=)`` on the headline at 4 x 262144
    (K2 per epoch; equal to the single-device batches at the shard seeds
    ``derive_seed(seed, i, 0)``), ``sweep_stat_sums`` with
    ``engine='pallas'`` (one K1 span launch; equal to the straight-line
    engine), ``sharded_demod`` on ``[262144, 1024] @ [1024, 8]`` (one K5
    launch; within K5's tolerance of the plain product) and
    ``sharded_cores_simulate(engine='block')`` on the looped headline at
    cores = 1 (K1 block bodies; every key equal to the block engine's
    plain bodies).  Returns the launches of each."""
    import numpy as np
    import torch
    from distributed_processor_tpu_torch.ops.demod import demod_iq_reference
    from distributed_processor_tpu_torch.parallel import (
        make_cores_mesh, make_mesh, physics_batch_stats, run_physics_sweep,
        sharded_cores_simulate, sharded_demod, sweep_stat_sums)
    from distributed_processor_tpu_torch.sim.interpreter import simulate_batch
    from distributed_processor_tpu_torch.sim.physics import (
        derive_seed, run_physics_batch)
    n, B, seed = HEADLINE['sweep_batches'], HEADLINE['batch'], 2026
    mesh = make_mesh(device=DEV)
    model, cfg = headline_model(), headline_config(mp)
    launches = {}

    _reset_launches()
    sync()
    t0 = time.perf_counter()
    res = run_physics_sweep(mp, model, n * B, B, seed=seed, cfg=cfg,
                            mesh=mesh, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = _launches()
    launches['K2'] = counts['resolve_windows']
    check(launches['K2'] > 0
          and _only_launched(counts, 'resolve_windows', 'exec_span_physics'),
          f'mesh sweep launches: {counts}')
    acc = None
    for i in range(n):
        st = physics_batch_stats(run_physics_batch(
            mp, model, derive_seed(seed, i, 0), B, cfg=cfg, device=DEV))
        st = {k: v.cpu().numpy() for k, v in st.items()}
        acc = st if acc is None else {k: acc[k] + v for k, v in st.items()}
    check(np.array_equal(res['mean_pulses'], acc['pulse_sum'] / (n * B))
          and np.array_equal(res['meas1_rate'], acc['meas1_sum'] / (n * B))
          and res['clean_shots'] == int(acc['clean_shots'])
          and res['err_shots'] == int(acc['err_shots'])
          and list(res['fault_shots'].values())
          == acc['fault_shots'].tolist(),
          'mesh sweep differs from the single-device batches at its seeds')
    print(f'mesh path, run_physics_sweep(mesh=make_mesh()) at {n} x {B}: '
          f'{wall:.3f} s, K2 launches {launches["K2"]}, equal to the '
          f'single-device batches at derive_seed(seed, i, 0) on '
          f'{env["smi"]}')

    gen = torch.Generator(device=DEV)
    gen.manual_seed(81)
    bits = torch.randint(0, 2, (B, mp.n_cores, cfg.max_meas), generator=gen,
                         device=DEV, dtype=torch.int32)
    _reset_launches()
    got = sweep_stat_sums(mp, bits, mesh, cfg=headline_config(
        mp, engine='pallas'), device=DEV)
    sync()
    counts = _launches()
    launches['K1 span'] = counts['exec_span']
    check(counts['exec_span'] == 1 and _only_launched(counts, 'exec_span'),
          f'mesh sweep_stat_sums (pallas) launches: {counts}')
    out = simulate_batch(mp, bits, cfg=headline_config(
        mp, engine='straightline'), device=DEV)
    check(got['pulse_sum'].tolist() == out['n_pulses'].sum(0).tolist()
          and got['qclk_sum'].tolist() == out['qclk'].sum(0).tolist()
          and int(got['err_shots']) == int((out['err'] != 0).any(1).sum()),
          'mesh sweep_stat_sums (K1 span) differs from the straight-line '
          'engine')

    gen.manual_seed(82)
    adc = torch.randn((B, 1024), generator=gen, device=DEV)
    w = torch.randn((1024, 8), generator=gen, device=DEV)
    _reset_launches()
    iq = sharded_demod(adc, w, mesh, device=DEV)
    sync()
    counts = _launches()
    launches['K5'] = counts['demod_iq']
    check(counts['demod_iq'] == 1 and _only_launched(counts, 'demod_iq'),
          f'mesh sharded_demod launches: {counts}')
    plain = demod_iq_reference(adc, w)
    err = float((iq - plain).abs().max())
    check(bool(torch.allclose(iq, plain, rtol=K5_RTOL, atol=K5_ATOL)),
          f'mesh sharded_demod differs from the plain product by {err}')

    cmesh = make_cores_mesh(device=DEV)
    lcfg = loop_config(loop_mp, engine='block')
    lbits = loop_bits(loop_mp, LOOP['batch'], seed=83)
    _reset_launches()
    got = sharded_cores_simulate(loop_mp, lbits, cmesh, cfg=lcfg, device=DEV)
    sync()
    counts = _launches()
    launches['K1 block'] = counts['exec_blocks']
    check(counts['exec_blocks'] > 0 and _only_launched(counts, 'exec_blocks'),
          f'mesh sharded_cores_simulate (block) launches: {counts}')
    want = simulate_batch(loop_mp, lbits, cfg=lcfg, device=DEV)
    check(set(want) - set(got) == {'steps', 'incomplete'}
          and all(torch.equal(got[k], want[k]) for k in got),
          'mesh sharded_cores_simulate (block) differs from the block '
          'engine')
    print(f'mesh path launches at world size 1: run_physics_sweep K2 '
          f'{launches["K2"]}; sweep_stat_sums(engine=\'pallas\') K1 span '
          f'{launches["K1 span"]}; sharded_demod K5 {launches["K5"]} '
          f'(max |err| {err:.3e} against the plain product); '
          f"sharded_cores_simulate(engine='block') at cores=1, "
          f'{LOOP["batch"]} lanes, K1 block {launches["K1 block"]} (every '
          f'key equal to the block engine) on {env["smi"]}')
    return launches


def phase_multi_rank(mp, env, world: int = None) -> None:
    """``world`` ranks (default ``MESH['ranks']``), each this script in
    its rank mode (:func:`rank_main`): a card per rank over NCCL where
    the host has enough cards, else ranks sharing the card over gloo
    (NCCL refuses two ranks on one device).  They run the 8-core ``lut``
    repetition round at 262144 shots on a cores mesh of ``world`` (8 /
    ``world`` cores per rank) and the headline ``run_physics_sweep`` at
    dp = ``world``.  The round's shard of each rank must equal the
    single-process generic engine on every key, the sweep the
    single-process batches at its shard seeds ``derive_seed(seed, i,
    r)``; a rank that fails or passes its deadline fails the phase and
    kills its peers."""
    import os
    import tempfile
    from distributed_processor_tpu_torch.parallel import physics_batch_stats
    from distributed_processor_tpu_torch.sim.physics import (
        derive_seed, run_physics_batch)
    world = world or MESH['ranks']
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--rank', str(r),
             '--world', str(world), '--init', f'file://{tmp}/pg',
             '--out', tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        errs = [''] * world
        try:
            for r, p in enumerate(procs):
                try:
                    _, errs[r] = p.communicate(timeout=max(
                        1.0, MESH['timeout'] - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    fail(f'multi-rank: rank {r} passed its '
                         f'{MESH["timeout"]} s deadline')
                check(p.returncode == 0, f'multi-rank: rank {r} exited '
                                         f'{p.returncode}:\n{errs[r][-3000:]}')
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        outs = []
        for r in range(world):
            with open(f'{tmp}/rank{r}.json') as f:
                outs.append(json.load(f))
    n, B, seed = HEADLINE['sweep_batches'], HEADLINE['batch'], 2026
    model, cfg = headline_model(), headline_config(mp)
    acc = None
    for i in range(n):
        for r in range(world):
            st = physics_batch_stats(run_physics_batch(
                mp, model, derive_seed(seed, i, r), B // world, cfg=cfg,
                device=DEV))
            st = {k: v.cpu().numpy() for k, v in st.items()}
            acc = st if acc is None else {k: acc[k] + v
                                          for k, v in st.items()}
    want = dict(mean_pulses=(acc['pulse_sum'] / (n * B)).tolist(),
                meas1_rate=(acc['meas1_sum'] / (n * B)).tolist(),
                clean_shots=int(acc['clean_shots']),
                err_shots=int(acc['err_shots']),
                fault_shots=acc['fault_shots'].tolist(),
                survival00_rate=float(acc['allzero_sum']
                                      / acc['clean_shots']))
    for r, o in enumerate(outs):
        c = o['cores']
        check(not c['mismatched'], f'multi-rank: rank {r} cores shard '
                                   f'differs on {c["mismatched"]}')
        got = {k: o['sweep'][k] for k in want}
        check(got == want, f'multi-rank: rank {r} dp=2 sweep {got} differs '
                           f'from the single-process batches {want}')
        check(o['mesh_check']['bad'] == 0,
              f'multi-rank: rank {r} check_mesh_consistency counted '
              f'{o["mesh_check"]["bad"]} mismatched fault codes')
    c = outs[0]['cores']
    cards = len({o['card'] for o in outs})
    print(f'multi-rank, {world} {outs[0]["backend"]} ranks on {cards} '
          f'card(s), {env["smi"]} (all ranks: {wall:.1f} s with '
          f'start-up): lut repetition round ({c["n_cores"]} cores, '
          f'{c["n_cores"] // world} per rank) at {c["shots"]} shots on '
          f'cores={world}: steady '
          + ' / '.join(f'{o["cores"]["wall"]:.3f}' for o in outs)
          + ' s per rank (first call, with the communicators\' set-up: '
          + ' / '.join(f'{o["cores"]["first"]:.3f}' for o in outs)
          + f' s), {c["gathers"]} gathers in the batch '
          f'({c["steps"]} steps), {c["bytes"] / 1e6:.1f} MB gathered per '
          f'rank, every key of each shard equal to the single-process '
          f'generic engine; headline run_physics_sweep at dp={world} '
          f'({n} x {B}): '
          + ' / '.join(f'{o["sweep"]["wall"]:.3f}' for o in outs)
          + f' s per rank, every key equal to the single-process batches at '
          f'derive_seed(seed, i, r); check_mesh_consistency at dp={world}: '
          f'0 mismatched fault codes on every rank ('
          + ' / '.join(f'{o["mesh_check"]["wall"]:.3f}' for o in outs)
          + ' s per rank)')


def rank_main(rank: int, world: int, init: str, out: str) -> int:
    """One rank of :func:`phase_multi_rank`: joins the group (NCCL with
    a card of its own when the host has a card per rank, else gloo on a
    shared card), runs the cores-sharded round and the dp-sharded sweep,
    checks its round shard against the single-process generic engine,
    and writes its numbers to ``out/rank<rank>.json``."""
    import dataclasses
    import torch
    from distributed_processor_tpu_torch.parallel import (
        initialize_multihost, make_cores_mesh, make_mesh, run_physics_sweep,
        sharded_cores_simulate, shutdown_multihost)
    from distributed_processor_tpu_torch.parallel.mesh import gather_cat
    from distributed_processor_tpu_torch.sim.interpreter import simulate_batch
    n_cards = torch.cuda.device_count()
    torch.cuda.set_device(rank % n_cards)
    backend = 'nccl' if world <= n_cards else 'gloo'
    initialize_multihost(init, num_processes=world, process_id=rank,
                         backend=backend)
    _label, mp, cfg = lut_workloads()[0]
    cfg = dataclasses.replace(cfg, engine=None)
    C, B = mp.n_cores, LUT['batch']
    gen = torch.Generator(device=DEV)
    gen.manual_seed(MESH['seed'])
    bits = torch.randint(0, 2, (B, C, cfg.max_meas), generator=gen,
                         device=DEV, dtype=torch.int32)
    mesh = make_cores_mesh(n_cores=world, device=DEV)
    walls = []
    for _ in range(2):
        # the first call pays the communicators' set-up; the second is
        # the steady one
        calls, nbytes = gather_cat.calls, gather_cat.bytes
        sync()
        t0 = time.perf_counter()
        shard = sharded_cores_simulate(mp, bits, mesh, cfg=cfg, device=DEV)
        sync()
        walls.append(time.perf_counter() - t0)
    gathers, gbytes = gather_cat.calls - calls, gather_cat.bytes - nbytes
    ref = simulate_batch(mp, bits, cfg=dataclasses.replace(
        cfg, engine='generic'), device=DEV)
    own = slice(rank * C // world, (rank + 1) * C // world)
    mismatched = sorted(k for k in shard
                        if not torch.equal(shard[k], ref[k][:, own]))
    res = {'backend': backend, 'card': torch.cuda.current_device(),
           'cores': dict(first=walls[0], wall=walls[1], gathers=gathers,
                         bytes=gbytes,
                         mismatched=mismatched, n_cores=C, shots=B,
                         steps=int(ref['steps']))}
    del shard, ref, bits
    mp_h = headline_program()
    n, Bh = HEADLINE['sweep_batches'], HEADLINE['batch']
    sync()
    t0 = time.perf_counter()
    r = run_physics_sweep(mp_h, headline_model(), n * Bh, Bh, seed=2026,
                          cfg=headline_config(mp_h),
                          mesh=make_mesh(n_dp=world, device=DEV), device=DEV)
    sync()
    res['sweep'] = dict(
        wall=time.perf_counter() - t0, mean_pulses=r['mean_pulses'].tolist(),
        meas1_rate=r['meas1_rate'].tolist(), clean_shots=r['clean_shots'],
        err_shots=r['err_shots'],
        fault_shots=list(r['fault_shots'].values()),
        survival00_rate=r['survival00_rate'])
    # the fault-injection harness's mesh check: a starved mutant ensemble
    # through run_multi_sweep with and without the dp mesh
    from distributed_processor_tpu_torch.sim.faultinject import \
        check_mesh_consistency
    sync()
    t0 = time.perf_counter()
    res['mesh_check'] = dict(bad=check_mesh_consistency(device=DEV),
                             wall=time.perf_counter() - t0)
    with open(f'{out}/rank{rank}.json', 'w') as f:
        json.dump(res, f)
    shutdown_multihost()
    return 0


def timed(fn, *args):
    """``fn(*args)``, with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f'[{fn.__name__}: {time.perf_counter() - t0:.1f} s]')
    return out


def main(argv: list) -> int:
    import argparse
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    # the port must be importable from here (a bare copy of this script
    # fails at this import)
    import distributed_processor_tpu_torch  # noqa: F401
    if argv:
        # --ranks N: only the multi-rank phase, on N ranks (a card each
        # where the host has N cards); --rank ...: one rank of it,
        # started by this script itself
        ap = argparse.ArgumentParser()
        for arg in ('--ranks', '--rank', '--world'):
            ap.add_argument(arg, type=int)
        for arg in ('--init', '--out'):
            ap.add_argument(arg)
        a = ap.parse_args(argv)
        if a.ranks is None:
            return rank_main(a.rank, a.world, a.init, a.out)
        env = timed(phase_environment)
        timed(phase_multi_rank, headline_program(), env, a.ranks)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0
    t_start = time.perf_counter()
    env = timed(phase_environment)
    mp = headline_program()
    timed(phase_selftest, env)
    resolve = timed(phase_kernels, mp)
    torch.cuda.empty_cache()
    resolve_ar1 = timed(phase_k2_ar1, mp)
    torch.cuda.empty_cache()
    k1 = timed(phase_k1, mp, env)
    k3 = timed(phase_k3, mp, env)
    torch.cuda.empty_cache()
    k3_phys = timed(phase_k3_physics, mp, env)
    torch.cuda.empty_cache()
    sv = timed(phase_statevec_kernel, env)
    torch.cuda.empty_cache()
    from distributed_processor_tpu_torch import Simulator
    sim = Simulator(n_qubits=HEADLINE['n_qubits'], device=DEV)
    k4 = timed(phase_k4, sim, render_run(sim, mp, 256, seed=50), env)
    k5 = timed(phase_k5, env)
    loop_mp = loop_program()
    k1_block = timed(phase_k1_block, loop_mp, env)
    torch.cuda.empty_cache()
    resolve['launches'], k3_phys['launches'] = timed(phase_main_path, mp,
                                                     env)
    k1['launches'] = timed(phase_k1_path, mp, env)
    k3['launches'] = timed(phase_k3_path, mp, env)
    k1_block['launches'] = timed(phase_loop_path, loop_mp, env)
    torch.cuda.empty_cache()
    lut_span = timed(phase_lut_span, env)
    lut_block = timed(phase_lut_block, env)
    lut_phys = timed(phase_lut_physics, env)
    torch.cuda.empty_cache()
    resolve_ar1['launches'] = timed(phase_readout_models, mp, env)
    timed(phase_bloch_path, mp, env)
    torch.cuda.empty_cache()
    _rb_k2, sv['launches'] = timed(phase_statevec_path, env)
    torch.cuda.empty_cache()
    timed(phase_multi_path, env)
    torch.cuda.empty_cache()
    rounds = timed(phase_rounds_path, env)
    torch.cuda.empty_cache()
    timed(phase_analysis, env)
    torch.cuda.empty_cache()
    counts = timed(phase_render_path, env)
    k4['launches'] = counts['render_shot']
    k5['launches'] = counts['demod_iq']
    torch.cuda.empty_cache()
    timed(phase_qasm_path, mp, env)
    torch.cuda.empty_cache()
    timed(phase_grad, env)
    timed(phase_trace, mp, env)
    torch.cuda.empty_cache()
    serve, served = timed(phase_serve, env)
    torch.cuda.empty_cache()
    timed(phase_calib, env)
    # the parent's caching allocator still holds what earlier phases
    # grew; the replicas of the fleet phase need the card's memory
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f'card memory before the fleet: {free / 1e9:.1f} GB free of '
          f'{total / 1e9:.1f} GB (reserved here '
          f'{torch.cuda.memory_reserved() / 1e9:.1f} GB)')
    fleet = timed(phase_fleet, env, served)
    del served
    torch.cuda.empty_cache()
    cli = timed(phase_cli, env)
    torch.cuda.empty_cache()
    tooling = timed(phase_tooling, env, k1)
    torch.cuda.empty_cache()
    timed(phase_cuda_vs_cpu, mp)
    timed(phase_sweep, mp, env)
    torch.cuda.empty_cache()
    timed(phase_mesh_path, mp, loop_mp, env)
    torch.cuda.empty_cache()
    timed(phase_multi_rank, mp, env)
    # the one-rank group of phase_mesh_path, with its cached meshes
    from distributed_processor_tpu_torch.parallel import shutdown_multihost
    shutdown_multihost()
    print(f'[all phases: {time.perf_counter() - t_start:.1f} s]')
    print('lut paths (ms; events / device; launches on the path): '
          + '; '.join(f'K1 span, {label}: {r["ms"]:.4f} / '
                      f'{_device_note(r["dev_ms"])}, one thread per lane '
                      f'{r["lane_ms"]:.4f} / {_device_note(r["lane_dev_ms"])}'
                      f', plain {r["plain_ms"]:.3f}, bound '
                      f'{r["bound_ms"]:.4f} ({r["bound_by"]}), launches '
                      f'{r["launches"]}' for label, r in lut_span.items())
          + f'; K1 block: device {lut_block["dev_ms"]:.5f} per launch, '
          f'bound {lut_block["bound_ms"]:.6f}, launches '
          f'{lut_block["launches"]}; K3: {lut_phys["ms"]:.4f} / '
          f'{_device_note(lut_phys["dev_ms"])}, plain '
          f'{lut_phys["plain_ms"]:.3f}, bound {lut_phys["bound_ms"]:.4f}, '
          f'launches {lut_phys["launches"]} on {env["smi"]}')
    print(f"serve paths (launches): K1 span {serve['exec_span']} for "
          f"{SERVE['k1_requests']} singleton requests, K1 block "
          f"{serve['exec_blocks']} per looped request")
    print(f"fleet paths (replica dispatches): K1 span "
          f"{fleet['span_dispatches']} for {SERVE['k1_requests']} headline "
          f"requests, K1 block {fleet['block_dispatches']} looped request "
          f"({fleet['block_launches']} K1 block launches in its direct "
          f"call); cli paths (launches): K2 {cli['resolve_windows']} "
          f"(run --physics), {cli['sweep_resolve_windows']} (sweep), K1 span "
          f"{cli['exec_span']} (run --engine pallas), K1 block "
          f"{cli['exec_blocks']} (run of the looped headline)")
    print(f"tooling paths (launches): K1 span {tooling['exec_span']}, K1 "
          f"block {tooling['exec_blocks']}, K3 {tooling['exec_span_fused']}")
    print('rounds paths (launches in one simulate_rounds call): '
          + '; '.join(f'{label}: {n}' for label, n in rounds.items())
          + ' (K1 span on the loop-free rounds, K1 block on the looped '
          'headline, one per block-engine iteration)')
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'library_ms')
    print(json.dumps({'kernels': [{k: kernel[k] for k in order}
                                  for kernel in (resolve, resolve_ar1, k1,
                                                 k3, k3_phys, k4, k5,
                                                 k1_block, sv)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
