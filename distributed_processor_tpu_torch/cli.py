"""Command-line interface: compile, disassemble, and run programs.

Usage::

    python -m distributed_processor_tpu_torch compile prog.json -o out.json
    python -m distributed_processor_tpu_torch disasm out.json --core 0
    python -m distributed_processor_tpu_torch run prog.qasm --shots 1024
    python -m distributed_processor_tpu_torch sweep prog.json \\
        --shots 65536 --batch 4096 --span 8 --checkpoint sweep.npz
    python -m distributed_processor_tpu_torch trace prog.json
    python -m distributed_processor_tpu_torch --torch-device cpu run ...

Programs are JSON instruction lists (the compiler input format) or
OpenQASM 3 source (by ``.qasm`` extension or ``--qasm``).  Every command
runs on the card; ``--torch-device`` (before the command) names another
torch device.  ``--device`` of ``run`` and ``sweep`` is the physics
device model (parity, bloch or statevec), as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.results import host_array


def _load_program(path: str, force_qasm: bool = False):
    with open(path) as f:
        text = f.read()
    if force_qasm or path.endswith('.qasm'):
        return text
    return json.loads(text)


def _make_sim(args):
    from .simulator import Simulator
    from .qchip import QChip
    qchip = QChip(args.qchip) if args.qchip else None
    return Simulator(qchip=qchip, n_qubits=args.qubits,
                     device=args.torch_device)


def cmd_compile(args):
    if args.cache_dir:
        cmd_compile_cached(args)
        return
    prog, _ = _compile_asm(args)
    if args.output:
        prog.save(args.output)
        print(f'wrote {args.output}')
    else:
        for grp, instrs in prog.program.items():
            print(f'# core group {grp}')
            for i in instrs:
                print(f'  {i}')


def cmd_compile_cached(args):
    """``compile --cache-dir DIR``: source -> MachineProgram through
    the persistent content-addressed compile cache; prints one JSON
    line with hit/miss status, the content key and cache counters (a
    second identical invocation reports a disk hit)."""
    if args.output:
        raise SystemExit('--cache-dir prints a cache summary; '
                         '-o/--output applies to assembly output only')
    import time
    from .compilecache import CompileCache
    sim = _make_sim(args)
    program = _load_program(args.program, args.qasm)
    cache = CompileCache(cache_dir=args.cache_dir)
    t0 = time.perf_counter()
    mp, status, key = cache.get_or_compile(
        program, sim.qchip, channel_configs=sim.channel_configs,
        fpga_config=sim.fpga_config, n_qubits=args.qubits)
    dt = time.perf_counter() - t0
    stats = cache.stats()
    print(json.dumps({
        'status': status,                 # miss | disk (warm across runs)
        'hit': status != 'miss',
        'key': key,
        'qchip_fingerprint': sim.qchip.fingerprint(),
        'n_cores': mp.n_cores,
        'n_instr': mp.n_instr,
        'elapsed_ms': round(dt * 1e3, 3),
        'cache_dir': args.cache_dir,
        'cache': {k: stats[k] for k in
                  ('hits', 'misses', 'disk_hits', 'size')},
    }, indent=2))


def _compile_asm(args):
    """Load + compile to a CompiledProgram (shared by compile/disasm/
    dump commands); returns (CompiledProgram, Simulator)."""
    sim = _make_sim(args)
    program = _load_program(args.program, args.qasm)
    if isinstance(program, str):
        from .frontend import qasm_to_program
        program = qasm_to_program(program)
    from .pipeline import compile_program
    prog = compile_program(program, sim.qchip, fpga_config=sim.fpga_config)
    return prog, sim


def _assemble(args):
    """Compile + assemble; returns (assembled bufs, channel_configs)."""
    from .assembler import GlobalAssembler
    from .elements import TPUElementConfig
    prog, sim = _compile_asm(args)
    asm = GlobalAssembler(prog, sim.channel_configs, TPUElementConfig)
    return asm.get_assembled_program(), sim.channel_configs


def _select_cores(assembled, core) -> list:
    """Numerically ordered core keys, or the validated --core choice."""
    if core is None:
        return sorted(assembled, key=int)
    key = str(core)
    if key not in assembled:
        raise SystemExit(
            f'no core {key} in this program (has: '
            f'{", ".join(sorted(assembled, key=int))})')
    return [key]


def _fmt_operands(d: dict) -> str:
    parts = []
    for k, v in d.items():
        if k == 'op':
            continue
        if isinstance(v, tuple) or (isinstance(v, list) and len(v) == 2
                                    and v[0] == 'reg'):
            v = f'r{v[1]}'
        parts.append(f'{k}={v}')
    return ' '.join(parts)


def cmd_disasm(args):
    """Full-operand disassembly of the assembled command buffers — the
    analog of the reference's ``asmparse.cmdparse`` field dump
    (reference: python/distproc/asmparse.py:12-44)."""
    assembled, _ = _assemble(args)
    from . import isa
    for core in _select_cores(assembled, args.core):
        print(f'# core {core}')
        for i, d in enumerate(isa.disassemble(assembled[core]['cmd_buf'])):
            print(f'  {i:4d}: {d["op"]:<17s} {_fmt_operands(d)}'.rstrip())


def cmd_envdump(args):
    """Decode env buffers to complex I/Q samples (reference:
    asmparse.envparse, asmparse.py:46-63)."""
    assembled, _ = _assemble(args)
    from .elements import parse_env_buffer
    for core in _select_cores(assembled, args.core):
        for e, buf in enumerate(assembled[core]['env_buffers']):
            iq = parse_env_buffer(buf)
            print(f'# core {core} elem {e}: {len(iq)} samples')
            for k in range(0, len(iq), 1 if args.full else max(len(iq)//8, 1)):
                print(f'  [{k:5d}] {iq[k].real:+.6f} {iq[k].imag:+.6f}j')


def cmd_freqdump(args):
    """Decode freq buffers: word 0 = freq/fsamp*2^32, words 1-15 = IQ
    phase offsets of the 16-sample parallel NCO (reference:
    asmparse.freqparse, asmparse.py:64-86)."""
    assembled, ccfgs = _assemble(args)
    from .elements import parse_freq_buffer
    # fsamp per element from any qubit's channel configs on that core
    for core in _select_cores(assembled, args.core):
        elems = {}
        for name, cc in ccfgs.items():
            if not hasattr(cc, 'core_ind') or str(cc.core_ind) != core:
                continue
            elems[cc.elem_ind] = \
                cc.elem_params['samples_per_clk'] * ccfgs['fpga_clk_freq']
        for e, buf in enumerate(assembled[core]['freq_buffers']):
            if not len(buf):
                continue
            fsamp = elems.get(e, 1.0)
            parsed = parse_freq_buffer(buf, fsamp)
            print(f'# core {core} elem {e} (fsamp {fsamp:.3e})')
            for k, f in enumerate(parsed['freq']):
                iq0 = parsed['iq15'][k, 0]
                print(f'  [{k:3d}] freq {f:.6e} Hz  '
                      f'iq[1] {iq0.real:+.5f}{iq0.imag:+.5f}j')


def _fault_table(fault_shots: dict) -> None:
    """Print the nonzero trapped-shot counts to stderr (the JSON result
    on stdout stays machine-parseable)."""
    nz = {k: int(v) for k, v in fault_shots.items() if v}
    if not nz:
        return
    w = max(len(k) for k in nz)
    print('fault summary (trapped shots, docs/ROBUSTNESS.md):',
          file=sys.stderr)
    for k, v in nz.items():
        print(f'  {k:<{w}}  {v}', file=sys.stderr)


def _fault_shot_dict(fault) -> dict:
    from .sim.interpreter import FAULT_CODES, fault_shot_counts
    counts = host_array(fault_shot_counts(fault))
    return {name: int(c) for (name, _), c in zip(FAULT_CODES, counts)}


def cmd_run(args):
    sim = _make_sim(args)
    kw = {}
    if args.physics:
        if args.p1 is not None:
            raise SystemExit(
                '--p1 injects bits; --physics resolves them in-sim — '
                'use --p1-init for the thermal initial state instead')
        from .sim.device import DeviceModel
        from .sim.physics import ReadoutPhysics
        if args.device != 'statevec' and args.depol2:
            raise SystemExit('--depol2 (two-qubit Pauli channel on '
                             'coupling pulses) needs --device statevec')
        if args.device != 'statevec' and args.leak:
            raise SystemExit('--leak (computational-subspace leakage) '
                             'needs --device statevec')
        if args.device == 'parity' and (args.detuning_hz or args.t1_us
                                        or args.t2_us or args.depol):
            raise SystemExit(
                '--detuning-hz/--t1-us/--t2-us/--depol need '
                '--device bloch or statevec (the parity counter has no '
                'such physics)')
        any_leak = args.leak or args.leak2
        if args.leak_bit != 1 and not (args.device == 'statevec'
                                       and any_leak):
            raise SystemExit('--leak-bit has no effect without '
                             '--device statevec and a leakage channel '
                             '(--leak or --leak2)')
        if args.device != 'statevec' and (args.leak2 or args.seep):
            raise SystemExit('--leak2/--seep need --device statevec')
        if args.seep and not any_leak:
            raise SystemExit('--seep needs a leakage channel '
                             '(--leak or --leak2)')
        if args.leak_iq is not None and not (args.device == 'statevec'
                                             and any_leak):
            raise SystemExit('--leak-iq needs --device statevec with '
                             '--leak or --leak2 > 0')
        if args.classify3 and args.leak_iq is None:
            raise SystemExit('--classify3 needs --leak-iq')
        dev = DeviceModel(args.device,
                          detuning_hz=args.detuning_hz,
                          t1_s=args.t1_us * 1e-6 if args.t1_us else
                          float('inf'),
                          t2_s=args.t2_us * 1e-6 if args.t2_us else
                          float('inf'),
                          depol_per_pulse=args.depol,
                          depol2_per_pulse=args.depol2,
                          leak_per_pulse=args.leak,
                          leak_readout_bit=args.leak_bit,
                          leak2_per_pulse=args.leak2,
                          seep_per_pulse=args.seep)
        kw['physics'] = ReadoutPhysics(
            sigma=args.sigma, p1_init=args.p1_init, device=dev,
            g2=(complex(args.leak_iq[0], args.leak_iq[1])
                if args.leak_iq is not None else None),
            classify3=args.classify3)
    else:
        kw['p1'] = args.p1
    if args.engine:
        kw['engine'] = args.engine
    if args.max_steps is not None:
        kw['max_steps'] = args.max_steps
    from .decoder import validate_program, ProgramValidationError
    mp = sim.compile(_load_program(args.program, args.qasm))
    try:
        # pre-flight: reject always-wrong programs with instruction
        # coordinates before any compile/dispatch cost
        validate_program(mp, sim.interpreter_config(mp, **{
            k: v for k, v in kw.items() if k == 'engine'}))
    except ProgramValidationError as e:
        raise SystemExit(str(e))
    out = sim.run(mp, shots=args.shots, **kw)
    from .sim.interpreter import resolve_engine
    n_pulses = host_array(out['n_pulses'])
    err = host_array(out['err'])
    faults = _fault_shot_dict(out['fault'])
    result = {
        'shots': args.shots,
        'engine': resolve_engine(out['_mp'], out['_cfg'], sim.device),
        'mean_pulses_per_core': np.atleast_2d(n_pulses).mean(0).tolist(),
        'error_shots': int(np.any(np.atleast_2d(err) != 0, -1).sum()),
        'fault_shots': faults,
        'steps': int(out['steps']),
    }
    if args.physics:
        bits = host_array(out['meas_bits'])
        result['meas1_rate_per_core'] = \
            np.atleast_3d(bits)[..., 0].mean(0).tolist()
        result['epochs'] = int(out['epochs'])
        if 'leaked' in out:
            # the leak rate itself, separable from meas1 (which folds
            # leaked shots in at --leak-bit)
            result['leaked_rate_per_core'] = \
                np.atleast_2d(host_array(out['leaked'])).mean(0).tolist()
        if 'meas_class' in out:
            # 3-class discrimination: first-slot class-2 rate per core
            cls = np.atleast_3d(host_array(out['meas_class']))
            result['class2_rate_per_core'] = \
                (cls[..., 0] == 2).mean(0).tolist()
    print(json.dumps(result, indent=2))
    _fault_table(faults)
    if args.strict_faults and any(faults.values()):
        raise SystemExit(2)


def cmd_sweep(args):
    """Physics-closed statistics sweep: ``--shots`` total in
    ``--batch``-sized runs through ``parallel.run_physics_sweep`` —
    resumable via ``--checkpoint``, with ``--span`` batches folded on the
    device before each host fetch (bit-identical statistics, fewer host
    round-trips).  ``--key`` is the sweep's seed."""
    if args.span < 1:
        raise SystemExit('--span must be >= 1')
    if args.span > 1 and args.checkpoint_every and \
            args.checkpoint_every % args.span:
        raise SystemExit(
            f'--checkpoint-every counts BATCHES but writes snap to span '
            f'edges: {args.checkpoint_every} is not a multiple of '
            f'--span {args.span}, so checkpoints would land later than '
            f'asked — pick a multiple, or drop --span')
    if args.device == 'parity' and (args.detuning_hz or args.t1_us
                                    or args.t2_us or args.depol):
        raise SystemExit(
            '--detuning-hz/--t1-us/--t2-us/--depol need '
            '--device bloch or statevec (the parity counter has no '
            'such physics)')
    sim = _make_sim(args)
    mp = sim.compile(_load_program(args.program, args.qasm))
    from .decoder import validate_program, ProgramValidationError
    from .sim.device import DeviceModel
    from .sim.physics import ReadoutPhysics
    from .sim.interpreter import FaultError
    from .parallel import run_physics_sweep
    dev = DeviceModel(args.device,
                      detuning_hz=args.detuning_hz,
                      t1_s=args.t1_us * 1e-6 if args.t1_us else
                      float('inf'),
                      t2_s=args.t2_us * 1e-6 if args.t2_us else
                      float('inf'),
                      depol_per_pulse=args.depol)
    model = ReadoutPhysics(sigma=args.sigma, p1_init=args.p1_init,
                           device=dev)
    cfg_kw = {'engine': args.engine} if args.engine else {}
    if args.max_steps is not None:
        cfg_kw['max_steps'] = args.max_steps
    if args.strict_faults:
        cfg_kw['fault_mode'] = 'strict'
    cfg = sim.interpreter_config(mp, **cfg_kw)
    try:
        validate_program(mp, cfg)
    except ProgramValidationError as e:
        raise SystemExit(str(e))
    try:
        out = run_physics_sweep(mp, model, args.shots, args.batch,
                                seed=args.key, cfg=cfg,
                                checkpoint=args.checkpoint,
                                checkpoint_every=args.checkpoint_every,
                                span=args.span,
                                strict_resume=args.strict_resume,
                                device=sim.device)
    except FaultError as e:
        # the sweep completed (and checkpointed); the counts failed the
        # strict gate — report the per-code table and exit nonzero
        from .sim.interpreter import FAULT_CODES
        _fault_table({name: int(n) for (name, _), n
                      in zip(FAULT_CODES, e.counts)})
        raise SystemExit(2)
    print(json.dumps({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                      for k, v in out.items()}, indent=2))
    _fault_table(out.get('fault_shots', {}))


def cmd_trace(args):
    sim = _make_sim(args)
    mp = sim.compile(_load_program(args.program, args.qasm))
    from .sim import simulate
    out = simulate(mp, cfg=sim.interpreter_config(mp, trace=True),
                   device=sim.device)
    if args.vcd:
        from .utils.vcd import write_vcd
        n = write_vcd(args.vcd, out, core_labels=mp.core_inds)
        print(f'wrote {args.vcd}: {n} value changes '
              f'({mp.n_cores} cores, {int(out["steps"])} steps)')
        return
    steps = int(out['steps'])
    trace_pc = host_array(out['trace_pc'])
    trace_time = host_array(out['trace_time'])
    for c in range(mp.n_cores):
        print(f'# core {mp.core_inds[c]}')
        for s in range(steps):
            pc = int(trace_pc[c, s])
            t = int(trace_time[c, s])
            print(f'  step {s:4d}  t={t:8d}  pc={pc}')


def cmd_serve_bench(args):
    from .serve.benchmark import (availability_under_chaos,
                                  compile_front_door,
                                  continuous_batching_comparison,
                                  fleet_failover,
                                  multi_device_scaling,
                                  open_loop_latency)
    if args.fleet:
        # fleet-federation mode: N replica PROCESSES behind the
        # FleetRouter; SIGKILL the loaded replica mid-stream and require
        # goodput to stay positive inside the kill window with every
        # completion bit-identical (docs/FLEET.md)
        row = fleet_failover(
            n_replicas=args.fleet, n_reqs=args.requests,
            rate_hz=args.rate_hz, n_qubits=args.qubits,
            depth=args.depth, shots=args.shots, seed=args.seed,
            device=args.torch_device)
    elif args.source_mode:
        # the compile front door: tenants submit SOURCE programs via
        # submit_source; content-addressed dedup + singleflight +
        # bit-identity vs compile+submit asserted inside the row
        row = compile_front_door(
            n_tenants=args.tenants, n_programs=args.programs,
            n_qubits=args.qubits, depth=args.depth, shots=args.shots,
            seed=args.seed, device=args.torch_device)
    elif args.chaos:
        # availability under injected faults: crash/hang/slowdown under
        # _run_batch, goodput + tails with the supervision stack
        # (retries, breaker quarantine, canary re-admission) healing
        row = availability_under_chaos(
            n_reqs=args.requests, rate_hz=args.rate_hz,
            n_qubits=args.qubits, depth=args.depth, shots=args.shots,
            seed=args.seed, devices=args.devices,
            p_crash=args.p_crash, p_hang=args.p_hang,
            p_slow=args.p_slow, device=args.torch_device)
    elif args.dp:
        # multi-device closed-loop scaling: needs that many visible
        # cards in THIS process (on the CPU the executors repeat the
        # one CPU device)
        row = multi_device_scaling(
            dp_list=[int(x) for x in args.dp.split(',') if x],
            n_reqs=args.requests, n_qubits=args.qubits,
            depth=args.depth, shots=args.shots, seed=args.seed,
            device=args.torch_device)
    elif args.open_loop or args.slo:
        # --trace-out with the sample left at 0 means "trace them all"
        sample = args.trace_sample or (1.0 if args.trace_out else 0.0)
        row = open_loop_latency(
            n_reqs=args.requests, rate_hz=args.rate_hz,
            n_qubits=args.qubits, shots=args.shots, seed=args.seed,
            devices=args.devices, slo=args.slo,
            warmup_catalog=args.warmup_catalog,
            trace_sample=sample, trace_out=args.trace_out,
            device=args.torch_device)
    else:
        sample = args.trace_sample or (1.0 if args.trace_out else 0.0)
        row = continuous_batching_comparison(
            n_reqs=args.requests, n_qubits=args.qubits,
            depth=args.depth, shots=args.shots, seed=args.seed,
            max_wait_ms=args.max_wait_ms,
            trace_sample=sample, trace_out=args.trace_out,
            device=args.torch_device)
    print(json.dumps(row, indent=2))


def cmd_trace_view(args):
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'tools'))
    from traceview import format_table, summarize
    try:
        summary = summarize(args.trace)
    except (OSError, ValueError) as e:
        # empty/invalid trace files exit nonzero with the reason, not
        # a traceback (tools/traceview.py raises ValueError for both)
        raise SystemExit(f'trace-view: {e}')
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(format_table(summary))


_TENANT_VIEW_COLS = ('tenant', 'weight', 'queued', 'submitted',
                     'completed', 'failed', 'shed', 'quota_rejected',
                     'shots', 'device_ms', 'compile_ms', 'bytes_wire')


def _print_tenant_view(tenant_rows: dict, as_json: bool) -> None:
    """``fleet-status --tenants``: fold each replica's
    ``stats()['tenants']`` block into one fleet-level row per tenant
    (meters summed — they are monotone billing counters, so summation
    is exact; ``weight`` is shared config, reported once).  Table by
    default, the full per-replica breakdown with ``--json``."""
    agg = {}
    for per_tenant in tenant_rows.values():
        for tenant, row in per_tenant.items():
            a = agg.setdefault(tenant, {c: 0 for c in
                                        _TENANT_VIEW_COLS[2:]})
            a['weight'] = row.get('weight', 1.0)
            for c in _TENANT_VIEW_COLS[2:]:
                a[c] += row.get(c, 0)
    if as_json:
        print(json.dumps({'tenants': agg, 'replicas': tenant_rows},
                         indent=2))
        return
    if not agg:
        print('no tenant traffic recorded yet')
        return
    out = []
    for tenant in sorted(agg):
        r = {'tenant': tenant}
        for c in _TENANT_VIEW_COLS[1:]:
            v = agg[tenant].get(c, 0)
            r[c] = round(v, 1) if isinstance(v, float) else v
        out.append(r)
    widths = {c: max(len(c), *(len(str(r[c])) for r in out))
              for c in _TENANT_VIEW_COLS}
    print('  '.join(c.ljust(widths[c]) for c in _TENANT_VIEW_COLS))
    for r in out:
        print('  '.join(str(r[c]).ljust(widths[c])
                        for c in _TENANT_VIEW_COLS))


def cmd_fleet_status(args):
    """Live fleet flight deck: poll each replica DIRECTLY over the
    fleet wire (the same ``gossip`` / ``fleet-metrics`` ops the router
    uses) and print one status row per replica — no router process
    required, so this works against any fleet you can reach.  With
    ``--prometheus``, re-expose every replica's metrics with a
    ``replica`` label plus fleet rollups (docs/OBSERVABILITY.md
    "Fleet observability")."""
    from .serve.transport import ReplicaClient
    rows, snaps, errors = [], {}, []
    tenant_rows = {}        # addr -> stats()['tenants'] block
    for addr in args.replica:
        host, _, port = addr.rpartition(':')
        host = host or '127.0.0.1'
        try:
            client = ReplicaClient((host, int(port)))
        except (OSError, ValueError) as e:
            errors.append((addr, f'{type(e).__name__}: {e}'))
            rows.append({'replica': addr, 'error': str(e)})
            continue
        try:
            g = client.call('gossip', {}, timeout_s=args.timeout)
            if args.prometheus:
                m = client.call('fleet-metrics', {},
                                timeout_s=args.timeout)
                snaps[addr] = m['metrics']
        except Exception as e:          # noqa: BLE001 - keep polling
            errors.append((addr, f'{type(e).__name__}: {e}'))
            rows.append({'replica': addr, 'error': str(e)})
            continue
        finally:
            client.close()
        st = g.get('stats', {})
        fl = g.get('flight', {})
        tenant_rows[addr] = st.get('tenants') or {}
        # mismatches/audits (plus any scrubber quarantines): a nonzero
        # numerator is a silent-data-corruption alarm, not noise
        ig = st.get('integrity') or {}
        rows.append({
            'replica': addr,
            'health': st.get('health'),
            'queue_depth': st.get('queue_depth'),
            'est_wait_ms': st.get('est_wait_ms'),
            'completed': st.get('completed'),
            'integrity': (f"{ig.get('mismatches', 0)}"
                          f"/{ig.get('audits', 0)}" if ig else ''),
            'flight_recorded': fl.get('recorded'),
            'flight_dropped': fl.get('dropped'),
            'flight_counts': fl.get('counts'),
        })
    if not any('error' not in r for r in rows):
        for addr, err in errors:
            print(f'fleet-status: {addr}: {err}', file=sys.stderr)
        raise SystemExit('fleet-status: no replica reachable')
    if args.tenants:
        _print_tenant_view(tenant_rows, as_json=args.json)
        return
    if args.prometheus:
        from .obs import merged_prometheus_text
        lines = merged_prometheus_text(snaps, label='replica')
        print('\n'.join(lines))
        return
    if args.json:
        print(json.dumps(rows, indent=2))
        return
    cols = ('replica', 'health', 'queue_depth', 'est_wait_ms',
            'completed', 'integrity', 'flight_recorded',
            'flight_dropped')
    widths = {c: max(len(c), *(len(str(r.get(c, ''))) for r in rows))
              for c in cols}
    print('  '.join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        if 'error' in r:
            print(f"{r['replica'].ljust(widths['replica'])}  "
                  f"UNREACHABLE: {r['error']}")
            continue
        print('  '.join(str(r.get(c, '')).ljust(widths[c])
                        for c in cols))
        if r.get('flight_counts'):
            counts = ' '.join(f'{k}={v}' for k, v in
                              sorted(r['flight_counts'].items()))
            print(f'  flight: {counts}')


def cmd_warmup(args):
    """Warm a learned bucket catalog offline: one run of every entry's
    bound shape on zero bits (``aot_compile_batch``) on each of the
    first ``--devices`` cards, with per-spec timings — validating that
    every entry still runs.  Eager torch compiles no executable, so
    there is no compile cache to pre-bake: the summary names the
    kernel build directory (built CUDA kernels, shared by every process
    of the checkout) where the JAX package names its XLA cache."""
    import torch
    from .ops import _cuda
    from .serve.catalog import BucketCatalog
    from .sim.interpreter import aot_compile_batch
    specs = BucketCatalog(args.catalog).load()
    dev = torch.device(args.torch_device)
    if dev.type == 'cuda':
        from .parallel.mesh import serving_devices
        devs = serving_devices()[:max(1, args.devices)]
    else:
        devs = [dev]
    compiled, total_ms = 0, 0.0
    for spec in specs:
        for d in devs:
            dt_ms = aot_compile_batch(spec, d) * 1e3
            compiled += 1 if dt_ms > 0 else 0
            total_ms += dt_ms
            print(json.dumps({'spec': spec.label(),
                              'device': str(d),
                              'compile_ms': round(dt_ms, 1),
                              'cached': dt_ms == 0.0}))
    print(json.dumps({'catalog': args.catalog, 'specs': len(specs),
                      'devices': len(devs), 'compiled': compiled,
                      'total_compile_ms': round(total_ms, 1),
                      'build_dir': _cuda.BUILD}))


def cmd_qec_stream(args):
    """Streaming-QEC command (docs/SERVING.md "Streaming sessions"):
    run R rounds of the repetition (or surface-cycle-shaped) QEC
    workload either as round chunks through a ``StreamSession`` — each
    chunk ONE ``simulate_rounds`` dispatch with the decoder in the
    loop (``--stream``, the default) — or as R sequential single-round
    dispatches with a host-side decode (``--per-round``), printing the
    decoded corrections summary and wall time as JSON so the two modes
    are directly comparable."""
    import time
    from dataclasses import replace
    from .models.qec import (qec_config, qec_multiround_machine_program,
                             repetition_decode_spec,
                             surface_cycle_config,
                             surface_cycle_machine_program,
                             surface_decode_spec)
    from .ops.decode import decode_history
    from .sim.interpreter import simulate_batch
    if args.surface:
        mp = surface_cycle_machine_program(args.distance)
        cfg = surface_cycle_config(args.distance)
        dec = surface_decode_spec(args.distance)
    else:
        mp = qec_multiround_machine_program(n_data=args.distance,
                                            rounds=1)
        cfg = qec_config(args.distance)
        dec = repetition_decode_spec(args.distance)
    cfg = replace(cfg, record_pulses=False,
                  **({'engine': args.engine} if args.engine else {}))
    rng = np.random.default_rng(args.key)
    mb = rng.integers(0, 2, (args.rounds, args.shots, mp.n_cores,
                             cfg.max_meas)).astype(np.int32)
    t0 = time.perf_counter()
    if args.per_round:
        for r in range(args.rounds):
            host_array(simulate_batch(mp, mb[r], cfg=cfg,
                                      device=args.torch_device)['err'])
        hist = np.transpose(mb[:, :, list(dec.cores), dec.slot],
                            (1, 0, 2))
        decoded = host_array(decode_history(hist, dec.scheme))
        mode = (f'{args.rounds} per-round dispatches + host decode '
                f'(--per-round)')
        chunks = args.rounds
    else:
        from .serve import ExecutionService
        from .serve.benchmark import _service_devices
        svc = ExecutionService(devices=_service_devices(args.torch_device))
        try:
            with svc.open_stream(mp, cfg=cfg, decode=dec) as sess:
                for i in range(0, args.rounds, args.chunk):
                    sess.submit_rounds(mb[i:i + args.chunk])
                summary = sess.close(timeout=600)
        finally:
            svc.shutdown()
        decoded = summary['decoded']
        chunks = summary['chunks']
        mode = (f'streaming session: {chunks} chunk dispatches of '
                f'<= {args.chunk} rounds, decoder in the loop '
                f'(--stream)')
    dt = time.perf_counter() - t0
    print(json.dumps({
        'mode': mode,
        'scheme': dec.scheme,
        'distance': args.distance,
        'rounds': args.rounds,
        'shots': args.shots,
        'dispatches': chunks,
        'engine': cfg.engine,
        'wall_s': round(dt, 3),
        'rounds_per_s': round(args.rounds / dt, 1),
        'corrected_shots': int((decoded.sum(axis=-1) > 0).sum()),
        'mean_correction_weight':
            round(float(decoded.sum(axis=-1).mean()), 4),
    }, indent=2))


def cmd_calibrate(args):
    """Closed-loop calibration command (docs/CALIBRATION.md): run one
    knob's gradient-descent loop through an in-process
    ``ExecutionService`` — candidate programs through the compile
    front door, gradient steps from the differentiable physics model,
    convergence written back to the live qchip (flushing exactly the
    stale compile-cache epoch).  Prints the step count, loss
    trajectory and final parameters as JSON; exits nonzero on a
    diverged loop."""
    from .calib import calibrate
    from .models import make_default_qchip
    from .serve import ExecutionService
    from .serve.benchmark import _service_devices
    from .sim.grad import LossSpec
    spec = None
    if args.knob == 'amplitude':
        # the device-truth X90 amplitude the loop estimates: defaults
        # drifted from the nominal 0.48 so the writeback is a real
        # retune, not a no-op
        spec = LossSpec(knob='amplitude', x90_amp=args.true_x90)
    qchip = make_default_qchip(args.qubits)
    svc = ExecutionService(devices=_service_devices(args.torch_device))
    try:
        result = calibrate(svc, qchip, knob=args.knob,
                           qubit=f'Q{args.qubit}', spec=spec,
                           start=args.start, lr=args.lr,
                           max_steps=args.steps, shots=args.shots,
                           tenant=args.tenant, n_qubits=args.qubits,
                           device=args.torch_device)
        snap = svc.stats()['calibration']
    finally:
        svc.shutdown()
    out = result.to_dict()
    out['losses'] = [round(v, 8) for v in out['losses']]
    out['service'] = snap
    print(json.dumps(out, indent=2))
    if result.diverged:
        raise SystemExit(
            f"calibrate: {args.knob} loop diverged after "
            f"{result.steps} steps: {result.detail.get('reason')}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m distributed_processor_tpu_torch',
        description=__doc__.split('\n')[0])
    ap.add_argument('--torch-device', default='cuda', metavar='DEVICE',
                    help="torch device every command runs on (default: "
                         "cuda, the card; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument('--qchip', help='calibration JSON (default: built-in)')
    ap.add_argument('--qubits', type=int, default=8)
    ap.add_argument('--qasm', action='store_true',
                    help='treat the program file as OpenQASM 3')
    sub = ap.add_subparsers(dest='command', required=True)

    p = sub.add_parser('compile', help='compile to per-core assembly')
    p.add_argument('program')
    p.add_argument('-o', '--output')
    p.add_argument('--cache-dir', metavar='DIR',
                   help='compile source -> MachineProgram through the '
                        'persistent content-addressed compile cache '
                        'rooted here; prints hit/miss JSON (rerun the '
                        'same command to see the warm disk hit)')
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser('disasm', help='full-operand disassembly of the '
                                      'assembled command buffers')
    p.add_argument('program')
    p.add_argument('--core', type=int)
    p.set_defaults(fn=cmd_disasm)

    p = sub.add_parser('envdump', help='decode envelope BRAM buffers to I/Q')
    p.add_argument('program')
    p.add_argument('--core', type=int)
    p.add_argument('--full', action='store_true',
                   help='print every sample (default: 8 per buffer)')
    p.set_defaults(fn=cmd_envdump)

    p = sub.add_parser('freqdump', help='decode frequency BRAM buffers '
                                        '(16-word parallel-NCO entries)')
    p.add_argument('program')
    p.add_argument('--core', type=int)
    p.set_defaults(fn=cmd_freqdump)

    p = sub.add_parser('run', help='simulate shots')
    p.add_argument('program')
    p.add_argument('--shots', type=int, default=1)
    p.add_argument('--p1', type=float, default=None,
                   help='Bernoulli P(measure 1) per qubit (injected bits)')
    p.add_argument('--physics', action='store_true',
                   help='close the measurement loop with the DSP chain '
                        '(synthesis -> demod -> discriminate) instead of '
                        'injecting bits')
    p.add_argument('--sigma', type=float, default=0.05,
                   help='physics: per-sample ADC noise std dev')
    p.add_argument('--p1-init', type=float, default=0.1,
                   help='physics: thermal excited-state probability')
    p.add_argument('--device', choices=('parity', 'bloch', 'statevec'),
                   default='parity',
                   help='physics: qubit co-state model — parity counter, '
                        'SU(2) Bloch vector, or entangling statevec '
                        '(full per-shot state vector; CNOT/CZ coupling '
                        'map auto-derived from the program + gate '
                        'library) — sim/device.py')
    p.add_argument('--detuning-hz', type=float, default=0.0,
                   help='bloch/statevec: qubit-drive detuning '
                        '(Ramsey fringes)')
    p.add_argument('--t1-us', type=float, default=0.0,
                   help='bloch/statevec: T1 in microseconds (0 = off)')
    p.add_argument('--t2-us', type=float, default=0.0,
                   help='bloch/statevec: T2 in microseconds (0 = off)')
    p.add_argument('--depol', type=float, default=0.0,
                   help='bloch/statevec: 1q depolarization per drive pulse')
    p.add_argument('--depol2', type=float, default=0.0,
                   help='statevec: 2q Pauli channel per coupling pulse')
    p.add_argument('--leak', type=float, default=0.0,
                   help='statevec: leakage probability per 1q drive '
                        'pulse (x P(|1>); CPTP trajectory unraveling)')
    p.add_argument('--leak-bit', type=int, default=1, choices=(0, 1),
                   help='statevec: bit a leaked core reads out as '
                        '(the fast path; see --leak-iq for the IQ-level '
                        'alternative)')
    p.add_argument('--leak2', type=float, default=0.0,
                   help='statevec: coupling-pulse-induced control '
                        'leakage probability (x P(|1>) per coupling '
                        'pulse — the dominant 2q-gate mechanism)')
    p.add_argument('--seep', type=float, default=0.0,
                   help='statevec: |2>->|1> seepage probability per '
                        'drive pulse on a leaked core (0 = absorbing)')
    p.add_argument('--leak-iq', type=float, nargs=2, default=None,
                   metavar=('RE', 'IM'),
                   help='statevec: |2> IQ channel response g2 — leaked '
                        'cores traverse the real demod chain instead of '
                        'the forced --leak-bit (docs/PHYSICS.md '
                        '"Leakage readout")')
    p.add_argument('--classify3', action='store_true',
                   help='statevec + --leak-iq: 3-class nearest-centroid '
                        'discrimination; reports per-core class-2 rates')
    p.add_argument('--engine',
                   choices=('auto', 'generic', 'block', 'straightline',
                            'pallas'),
                   default=None,
                   help='interpreter engine ladder: auto picks the '
                        'megastep kernel (K1 span, or K1 block inside '
                        'the block engine) on the card when eligible, '
                        'else straightline for small branch-free '
                        'programs, else block (CFG-superinstruction) '
                        'when eligible, else generic fetch-dispatch; '
                        'pallas/block/straightline raise with the '
                        'reason when ineligible (default: generic)')
    p.add_argument('--strict-faults', action='store_true',
                   help='exit nonzero (status 2) if any shot trapped a '
                        'runtime fault (budget exhaustion, record '
                        'overflow, deadlock/starvation — see '
                        'docs/ROBUSTNESS.md); default: report '
                        'fault_shots counts and a summary table on '
                        'stderr, exit 0')
    p.add_argument('--max-steps', type=int, default=None,
                   help='interpreter step budget override (default: '
                        'sized by static loop analysis); shots still '
                        'running at the budget trap budget_exhausted')
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser('sweep', help='physics-closed statistics sweep '
                                     '(resumable, span-batched)')
    p.add_argument('program')
    p.add_argument('--shots', type=int, default=4096,
                   help='total shots (a multiple of --batch)')
    p.add_argument('--batch', type=int, default=256,
                   help='shots per batch (one engine run)')
    p.add_argument('--span', type=int, default=1,
                   help='batches whose sums fold on the device before '
                        'one host fetch (the fetch latency paid once '
                        'per span); default 1 fetches per batch. Statistics are bit-identical for '
                        'any span, and checkpoints are interchangeable '
                        'across spans. --checkpoint-every stays counted '
                        'in BATCHES with writes at span edges, so it '
                        'must be a multiple of --span')
    p.add_argument('--key', type=int, default=0,
                   help="base seed (the sweep's seed=)")
    p.add_argument('--checkpoint', metavar='FILE',
                   help='resumable accumulator checkpoint (atomic npz); '
                        'an interrupted sweep rerun with the same '
                        'arguments continues where it stopped')
    p.add_argument('--checkpoint-every', type=int, default=0,
                   help='batches between checkpoint writes (default '
                        'with --checkpoint: every batch)')
    p.add_argument('--strict-resume', action='store_true',
                   help='reject unfingerprinted or version-skewed '
                        'checkpoints instead of warning')
    p.add_argument('--sigma', type=float, default=0.05,
                   help='per-sample ADC noise std dev')
    p.add_argument('--p1-init', type=float, default=0.1,
                   help='thermal excited-state probability')
    p.add_argument('--device', choices=('parity', 'bloch', 'statevec'),
                   default='parity',
                   help='qubit co-state model (see `run --help`)')
    p.add_argument('--detuning-hz', type=float, default=0.0,
                   help='bloch/statevec: qubit-drive detuning')
    p.add_argument('--t1-us', type=float, default=0.0,
                   help='bloch/statevec: T1 in microseconds (0 = off)')
    p.add_argument('--t2-us', type=float, default=0.0,
                   help='bloch/statevec: T2 in microseconds (0 = off)')
    p.add_argument('--depol', type=float, default=0.0,
                   help='bloch/statevec: 1q depolarization per pulse')
    p.add_argument('--engine',
                   choices=('auto', 'generic', 'block', 'straightline',
                            'pallas'),
                   default=None,
                   help='interpreter engine ladder (see `run --help`); '
                        'the chosen engine is reported in the result '
                        'metadata')
    p.add_argument('--strict-faults', action='store_true',
                   help='run with fault_mode=strict: after the sweep '
                        'completes (and checkpoints), exit nonzero '
                        '(status 2) with a per-code table if any shot '
                        'trapped a runtime fault (docs/ROBUSTNESS.md); '
                        'default: fault_shots counts in the JSON result '
                        'plus a stderr summary when nonzero')
    p.add_argument('--max-steps', type=int, default=None,
                   help='interpreter step budget override (see '
                        '`run --help`)')
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser('serve-bench',
                       help='continuous-batching service benchmark: N '
                            'concurrent submissions vs N sequential '
                            'dispatches, warm, bit-identity checked')
    p.add_argument('--requests', type=int, default=32,
                   help='concurrent single-program requests')
    p.add_argument('--shots', type=int, default=32,
                   help='shots per request')
    p.add_argument('--depth', type=int, default=2,
                   help='RB depth of each random program')
    p.add_argument('--seed', type=int, default=0,
                   help='ensemble seed')
    p.add_argument('--max-wait-ms', type=float, default=100.0,
                   help='coalescing deadline passed to the service')
    p.add_argument('--dp', metavar='N,N,...',
                   help="multi-device scaling mode: run the closed-"
                        "loop workload at each executor count (e.g. "
                        "'1,2'); needs that many visible cards")
    p.add_argument('--open-loop', action='store_true',
                   help='open-loop latency mode: p50/p99 under '
                        'Poisson-ish mixed-bucket arrivals')
    p.add_argument('--rate-hz', type=float, default=40.0,
                   help='open-loop offered arrival rate')
    p.add_argument('--devices', type=int, default=None,
                   help='open-loop: shard the service across this '
                        'many devices (default: classic single-device '
                        'path)')
    p.add_argument('--chaos', action='store_true',
                   help='availability under seeded fault injection: '
                        'open-loop stream with crashes/hangs/slowdowns '
                        'injected under the executors; reports goodput '
                        'fraction, retries, breaker trips, '
                        're-admissions (bit-identity asserted)')
    p.add_argument('--p-crash', type=float, default=0.08,
                   help='chaos: per-dispatch injected crash probability')
    p.add_argument('--p-hang', type=float, default=0.02,
                   help='chaos: per-dispatch injected hang probability '
                        '(past the watchdog)')
    p.add_argument('--p-slow', type=float, default=0.10,
                   help='chaos: per-dispatch injected slowdown '
                        'probability (below the watchdog)')
    p.add_argument('--source-mode', action='store_true',
                   help='compile front-door mode: tenants submit '
                        'SOURCE programs via submit_source through '
                        'the content-addressed compile cache; reports '
                        'cold compiles, warm hit rate, singleflight '
                        'dedup and speedup vs uncached '
                        'compile-per-request (bit-identity asserted)')
    p.add_argument('--tenants', type=int, default=4,
                   help='source-mode: tenants submitting the same '
                        'program set')
    p.add_argument('--programs', type=int, default=4,
                   help='source-mode: distinct programs per tenant')
    p.add_argument('--slo', action='store_true',
                   help='open-loop latency-SLO mode: the same seeded '
                        'arrival trace runs cold (empty catalog, '
                        'compiles in-window) then warm (catalog '
                        'replay); asserts warmed p99 < unwarmed p99 '
                        'with zero cold hits (implies --open-loop)')
    p.add_argument('--warmup-catalog', metavar='PATH',
                   help='open-loop: learned bucket catalog to replay '
                        'at service startup and record new buckets '
                        'into (serve/catalog.py)')
    p.add_argument('--trace-sample', type=float, default=0.0,
                   help='fraction of requests carrying a lifecycle '
                        'trace (docs/OBSERVABILITY.md); default 0=off')
    p.add_argument('--trace-out', metavar='PATH',
                   help='export the measured round as Chrome Trace '
                        'Event JSON (Perfetto / chrome://tracing '
                        'loadable; implies --trace-sample 1.0 unless '
                        'set); summarize with `trace-view`')
    p.add_argument('--fleet', type=int, default=0, metavar='N',
                   help='fleet-federation mode: route the open-loop '
                        'stream across N replica processes behind the '
                        'FleetRouter, SIGKILL the loaded replica '
                        'mid-stream, and report kill-window goodput, '
                        'failovers and respawns (bit-identity '
                        'asserted; docs/FLEET.md)')
    p.set_defaults(fn=cmd_serve_bench)

    p = sub.add_parser('trace-view',
                       help='per-stage p50/p99 waterfall of an '
                            'exported request trace (serve-bench '
                            '--trace-out, ExecutionService.dump_trace)')
    p.add_argument('trace', help='Chrome Trace Event JSON file')
    p.add_argument('--json', action='store_true',
                   help='emit the summary as JSON instead of a table')
    p.set_defaults(fn=cmd_trace_view)

    p = sub.add_parser('fleet-status',
                       help='poll live replicas over the fleet wire '
                            '(gossip + fleet-metrics ops): one status '
                            'row per replica, or --prometheus for the '
                            'replica-labeled merged exposition')
    p.add_argument('replica', nargs='+', metavar='HOST:PORT',
                   help='replica wire addresses (ReplicaServer); bare '
                        'ports default the host to 127.0.0.1')
    p.add_argument('--prometheus', action='store_true',
                   help='print the merged Prometheus exposition '
                        '(every metric with a replica label + fleet '
                        'rollups) instead of the table')
    p.add_argument('--tenants', action='store_true',
                   help='per-tenant flight deck instead of the replica '
                        'table: queued/served/shed/quota-rejected plus '
                        'the billing meters (shots, device-ms, '
                        'compile-ms, bytes-on-wire) summed across '
                        'replicas; combine with --json for the '
                        'per-replica breakdown (docs/SERVING.md '
                        '"Tenants")')
    p.add_argument('--json', action='store_true',
                   help='emit the status rows as JSON')
    p.add_argument('--timeout', type=float, default=5.0,
                   help='per-replica wire timeout in seconds')
    p.set_defaults(fn=cmd_fleet_status)

    p = sub.add_parser('warmup',
                       help="warm a learned bucket catalog offline: "
                            "one run of every entry's bound shape, "
                            "with per-spec timings")
    p.add_argument('catalog',
                   help='bucket catalog JSON written by '
                        'ExecutionService(warmup_catalog=...) or '
                        'serve-bench --warmup-catalog')
    p.add_argument('--devices', type=int, default=1,
                   help='warm on the first N cards')
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser('qec-stream',
                       help='R-round QEC with the decoder in the loop: '
                            'one streaming rounds dispatch per chunk vs '
                            'R per-round dispatches')
    p.add_argument('--rounds', type=int, default=32)
    p.add_argument('--distance', type=int, default=3,
                   help='code distance (data qubits for the repetition '
                        'workload)')
    p.add_argument('--engine', choices=['generic', 'block',
                                        'straightline', 'pallas'],
                   help='pin the interpreter engine (default: auto)')
    p.add_argument('--shots', type=int, default=256)
    p.add_argument('--chunk', type=int, default=8,
                   help='rounds per streaming chunk (one dispatch each)')
    p.add_argument('--per-round', action='store_true',
                   help='dispatch every round separately and decode on '
                        'the host (the baseline --stream amortizes)')
    p.add_argument('--surface', action='store_true',
                   help='surface-code-cycle-shaped workload (ancilla '
                        'syndrome cores + chain matching) instead of '
                        'the repetition rounds')
    p.add_argument('--key', type=int, default=7,
                   help='seed for the injected measurement planes')
    p.set_defaults(fn=cmd_qec_stream)

    p = sub.add_parser('calibrate',
                       help='gradient-descent knob tuning through the '
                            'serve tier: candidate programs via the '
                            'compile front door, writeback to the live '
                            'qchip on convergence')
    p.add_argument('--knob', choices=['amplitude', 'drag',
                                      'readout_window'],
                   default='amplitude')
    p.add_argument('--qubit', type=int, default=0,
                   help='qubit index to tune')
    p.add_argument('--qubits', type=int, default=argparse.SUPPRESS,
                   help='qchip size override, placeable after the '
                        'subcommand (default: the global --qubits)')
    p.add_argument('--start', type=float, default=None,
                   help='initial parameter guess (default: per-knob)')
    p.add_argument('--lr', type=float, default=None,
                   help='gradient-descent step size (default: '
                        'per-knob; a too-large value demonstrates the '
                        'diverged path and the nonzero exit)')
    p.add_argument('--steps', type=int, default=None,
                   help='step budget before the loop counts as '
                        'diverged')
    p.add_argument('--shots', type=int, default=8)
    p.add_argument('--true-x90', type=float, default=0.52,
                   help='device-truth X90 amplitude of the amplitude '
                        "knob's forward model (drifted from the "
                        'nominal 0.48 so the writeback is a retune)')
    p.add_argument('--tenant', help='tenant identity for the session')
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser('trace', help='instruction trace (1 shot)')
    p.add_argument('program')
    p.add_argument('--vcd', metavar='FILE',
                   help='write a VCD waveform (GTKWave-compatible) '
                        'instead of printing — the analog of the '
                        "reference's Verilator --trace output")
    p.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
