"""VCD (Value Change Dump) export of an instruction-traced run.

The reference's debug artifact is an RTL waveform: every cocotb
testbench compiles with ``--trace --trace-structs`` and inspection
happens in GTKWave (reference: cocotb/proc/Makefile EXTRA_ARGS,
hdl/proc.sv:159-165 commented $dumpvars block).  The interpreter records
the equivalent state trace per step (``trace=True`` →
``trace_pc``/``trace_time``/``trace_off``) plus the pulse records; this
module turns one shot of that into a standard VCD file so the same
waveform tooling works on simulated runs.  The result's tensors may lie
on any device: each is copied to the host once.  The file is byte for
byte what the JAX package writes for the same run.

Per core the dump carries:

- ``pc[15:0]``   — program counter at each retired step
- ``qclk[31:0]`` — the qclk value (time - offset), exact at every step
  via the per-step offset trace (``trace_off``); a legacy trace without
  it dumps the final-offset approximation under the name ``qclk_approx``
- ``done``       — end-of-program flag
- per element (one sub-scope per element that fired, mirroring the
  reference's per-element ``pulse_iface``): ``cstrobe`` — one-cycle
  pulse at every trigger time — and ``amp[15:0]``, ``phase[16:0]``,
  ``freq[8:0]``, ``env[23:0]`` latched at each cstrobe
  (reference: hdl/pulse_iface.sv widths)

Timestamps are picoseconds (``$timescale 1 ps`` — the spec only allows
1/10/100 multipliers), one FPGA clock = ``clk_period_ns`` (2 ns
default — reference: hwconfig.py fpga_clk_period).
"""

from __future__ import annotations

from .results import host_array

_PULSE_VARS = (('amp', 16, 'rec_amp'), ('phase', 17, 'rec_phase'),
               ('freq', 9, 'rec_freq'), ('env', 24, 'rec_env'))


def _ident(i: int) -> str:
    """Short VCD identifier (printable ASCII 33..126)."""
    chars = []
    i += 1
    while i:
        i, r = divmod(i, 94)
        chars.append(chr(33 + r))
    return ''.join(chars)


def _bits(value: int, width: int) -> str:
    return format(int(value) & ((1 << width) - 1), f'0{width}b')


def write_vcd(path: str, out: dict, clk_period_ns: float = 2.0,
              shot: int = None, cores=None, core_labels=None) -> int:
    """Write one shot of a traced run (``trace=True``) as a VCD file.

    ``out``: the result dict of ``simulate``/``Simulator.run`` — must
    carry ``trace_pc``/``trace_time`` and the ``rec_*`` pulse records.
    ``shot`` selects a shot from a batched run.  ``cores``: positional
    core indices to dump (default all); ``core_labels``: display name
    per positional core (e.g. the compiled program's ``core_inds`` —
    defaults to the position).  Returns the number of value-change
    events written.
    """
    if 'trace_pc' not in out:
        raise ValueError('run has no instruction trace: execute with '
                         'trace=True')
    if 'rec_gtime' not in out:
        raise ValueError('run has no pulse records: execute with '
                         'record_pulses=True')
    batched = host_array(out['n_pulses']).ndim == 2
    if batched and shot is None:
        raise ValueError('batched run: pass shot= to select one shot')
    sel = (lambda a: host_array(a)[shot]) if batched \
        else (lambda a: host_array(a))

    # one host conversion per array, not per extracted scalar
    trace_pc = sel(out['trace_pc'])
    trace_t = sel(out['trace_time'])
    trace_off = sel(out['trace_off']) if 'trace_off' in out else None
    n_pulses = sel(out['n_pulses'])
    gtime = sel(out['rec_gtime'])
    elem_rec = sel(out['rec_elem'])
    pulse_rec = {name: sel(out[key]) for name, _, key in _PULSE_VARS}
    qclk_fin = sel(out['qclk'])
    time_fin = sel(out['time']) if 'time' in out else None
    done_fin = sel(out['done'])

    n_cores = trace_pc.shape[0]
    steps = int(host_array(out['steps']))
    cores = list(range(n_cores)) if cores is None else list(cores)
    if core_labels is None:
        core_labels = cores
    tick = int(round(clk_period_ns * 1000))       # ps per FPGA clock

    events = []          # (time_ps, order, ident, width, value)
    k = 0

    def new_ident():
        nonlocal k
        s = _ident(k)
        k += 1
        return s

    # with the per-step offset trace the dumped qclk is exact at every
    # timestamp; a legacy trace (no trace_off) falls back to the final
    # offset and is honestly named qclk_approx (sync/inc_qclk offset
    # changes appear as retroactive ramps there)
    qclk_name = 'qclk' if trace_off is not None else 'qclk_approx'
    header = []          # (label, [(name, width, ident)], {elem: [...]})
    for c, label in zip(cores, core_labels):
        v_pc, v_qclk, v_done = new_ident(), new_ident(), new_ident()
        core_vars = [('pc', 16, v_pc), (qclk_name, 32, v_qclk),
                     ('done', 1, v_done)]

        # pc at each retired step (dedupe repeats after done)
        prev = None
        for s in range(steps):
            t = int(trace_t[c, s])
            pc = int(trace_pc[c, s])
            if prev is not None and (t, pc) == prev:
                continue
            prev = (t, pc)
            events.append((t * tick, 0, v_pc, 16, pc))
        if trace_off is not None:
            # exact: qclk = time - offset with the offset AS OF the step
            last = None
            for s in range(steps):
                t = int(trace_t[c, s])
                q = t - int(trace_off[c, s])
                if (t, q) == last:
                    continue
                last = (t, q)
                events.append((t * tick, 1, v_qclk, 32, q))
        elif time_fin is not None:
            off = int(time_fin[c]) - int(qclk_fin[c])
            seen = set()
            for s in range(steps):
                t = int(trace_t[c, s])
                if t in seen:
                    continue
                seen.add(t)
                events.append((t * tick, 1, v_qclk, 32, t - off))

        # pulse events at their trigger times, one sub-scope per element
        # (two elements triggering at the same time stay distinct, as on
        # the hardware's per-element pulse_iface)
        n = int(n_pulses[c])
        elems = sorted({int(elem_rec[c, p]) for p in range(n)})
        elem_vars = {}
        for e in elems:
            ids = {name: new_ident() for name, _, _ in _PULSE_VARS}
            ids['cstrobe'] = new_ident()
            elem_vars[e] = ids
        for p in range(n):
            t = int(gtime[c, p])
            ids = elem_vars[int(elem_rec[c, p])]
            for name, width, _ in _PULSE_VARS:
                events.append((t * tick, 2, ids[name], width,
                               int(pulse_rec[name][c, p])))
            events.append((t * tick, 3, ids['cstrobe'], 1, 1))
            events.append(((t + 1) * tick, 0, ids['cstrobe'], 1, 0))

        if bool(done_fin[c]):
            t_done = int(trace_t[c, steps - 1]) if steps else 0
            events.append((t_done * tick, 4, v_done, 1, 1))
        header.append((label, core_vars, elem_vars))

    events.sort(key=lambda e: (e[0], e[1]))

    # ---- emit ----------------------------------------------------------
    def var_line(name, width, ident):
        rng = f' [{width - 1}:0]' if width > 1 else ''
        return f'$var wire {width} {ident} {name}{rng} $end'

    # the JAX package's header, so that both packages write one file
    lines = ['$date generated by distributed_processor_tpu $end',
             '$timescale 1 ps $end',
             '$scope module dproc $end']
    init = []
    for label, core_vars, elem_vars in header:
        lines.append(f'$scope module core{label} $end')
        for name, width, ident in core_vars:
            lines.append(var_line(name, width, ident))
            init.append((width, ident))
        for e, ids in sorted(elem_vars.items()):
            lines.append(f'$scope module elem{e} $end')
            for name, width, _ in _PULSE_VARS:
                lines.append(var_line(name, width, ids[name]))
                init.append((width, ids[name]))
            lines.append(var_line('cstrobe', 1, ids['cstrobe']))
            init.append((1, ids['cstrobe']))
            lines.append('$upscope $end')
        lines.append('$upscope $end')
    lines.append('$upscope $end')
    lines.append('$enddefinitions $end')

    lines.append('$dumpvars')
    for width, ident in init:
        lines.append(f'b{_bits(0, width)} {ident}' if width > 1
                     else f'0{ident}')
    lines.append('$end')

    cur_t = None
    n_changes = 0
    for t, _, ident, width, value in events:
        if t != cur_t:
            lines.append(f'#{max(t, 0)}')
            cur_t = t
        lines.append(f'b{_bits(value, width)} {ident}' if width > 1
                     else f'{int(bool(value))}{ident}')
        n_changes += 1

    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return n_changes
