"""A closed loop of streaming syndrome calls: QEC rounds with the decode.

Each call is the port's ``sim.interpreter.simulate_rounds`` over
``rounds`` x ``shots`` lanes of the configuration's program and engine,
with the configuration's decode.  Its bits come from a pinned host pool
of ``pool`` call-inputs made in set-up from the seed (per shot a random
codeword, each bit flipped with ``p_flip`` per round, in slot 0), copied
to the card per call (call ``i`` takes entry ``i % pool``); the
``decoded`` corrections are fetched per call.

Traffic keys: ``rounds``, ``shots``, ``p_flip``, ``pool``, ``keep_calls``
(calls of the window, drawn from the seed, that keep every output for
the comparison), ``trace_seconds``.

The comparison: every call's fetched corrections against the
reference's decode of the same pool entry; every lane of the kept calls
(each round of each shot) against the oracle, run once per pattern of
the bits its LUT reads consume; and the kept calls' syndrome history
against the pool's bits.
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from ..harness.common import Reservoir, derive_seed
from ..reference import lanes, qec
from ..roofline import exec_rows

KEYS = ('n_pulses', 'n_meas', 'n_resets', 'time', 'qclk', 'offset', 'pc',
        'done', 'err', 'fault', 'regs', 'rst_time', 'meas_avail',
        'meas_time')


def make_pool(seed: int, n: int, R: int, B: int, C: int, M: int,
              p_flip: float) -> list:
    """``n`` call-inputs ``[R, B, C, M]`` int32 (numpy): per shot a random
    codeword, each data bit flipped with ``p_flip`` per round, in slot 0."""
    out = []
    for j in range(n):
        rng = np.random.default_rng(derive_seed(seed, 0x706f6f6c, j))
        word = rng.integers(0, 2, (1, B, 1), dtype=np.int32)
        flips = (rng.random((R, B, C)) < p_flip).astype(np.int32)
        bits = np.zeros((R, B, C, M), np.int32)
        bits[..., 0] = word ^ flips
        out.append(bits)
    return out


def setup(ctx) -> dict:
    import torch
    from distributed_processor_tpu_torch.sim.interpreter import (
        InterpreterConfig, simulate_rounds)
    conf, tr = ctx.cell.config, ctx.traffic
    prog = importlib.import_module(
        f'benchmark.programs.{conf["program"]["kind"]}')
    source = prog.sources(conf['program'])[0]
    mp = prog.port_program(conf['program'], source, None)
    fabric = prog.fabric(conf['program'])
    cfg = InterpreterConfig(**conf['interpreter'], **fabric)
    decode = dict(conf['decode'], cores=tuple(conf['decode']['cores']))
    R, B, C = int(tr['rounds']), int(tr['shots']), mp.n_cores
    M = int(conf['interpreter']['max_meas'])
    pool = make_pool(ctx.seed, int(tr['pool']), R, B, C, M,
                     float(tr['p_flip']))
    host = [torch.from_numpy(b) for b in pool]
    if ctx.device == 'cuda':
        host = [h.pin_memory() for h in host]
    dev = ctx.device
    st = dict(prog=prog, source=source, fabric=fabric, pool=pool, R=R, B=B,
              C=C, M=M)

    def call(i: int):
        with ctx.span('h2d'):
            bits = host[i % len(host)].to(dev, non_blocking=True)
        with ctx.span('rounds'):
            out = simulate_rounds(mp, bits, cfg=cfg, decode=decode,
                                  device=dev)
        with ctx.span('fetch'):
            decoded = out['decoded'].cpu().numpy()
        return out, decoded

    st['call'] = call
    held = [st['call'](j) for j in range(int(tr['keep_calls']) + 1)]
    del held
    ctx.sync()
    return st


def window(ctx, st) -> dict:
    keep = Reservoir(int(ctx.traffic['keep_calls']),
                     derive_seed(ctx.seed, 0x6b656570))
    decoded = []
    trace_s = float(ctx.traffic['trace_seconds'])
    ctx.tracer.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        out, dec = st['call'](i)
        decoded.append(dec)
        keep.offer((i, out))
        i += 1
        now = time.perf_counter() - t0
        if ctx.tracer.active and now >= trace_s:
            ctx.tracer.stop(ctx.sync)
            st['traced_calls'] = i
        if now >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    if ctx.tracer.active:
        ctx.tracer.stop(ctx.sync)
        st['traced_calls'] = i
    st.update(decoded=decoded, kept=keep.items, n_calls=i, wall=wall)
    lanes_done = i * st['R'] * st['B']
    failed = sum(int((o['fault'] != 0).any(-1).sum())
                 for _i, o in keep.items)
    return dict(attempted=lanes_done, failed=failed,
                metrics={'qec_rounds_per_s': lanes_done / wall},
                note=f'{i} calls of {st["R"]} rounds x {st["B"]} shots in '
                     f'{wall:.4f} s')


def _table(ctx, st, feedback: bool = True):
    rmp = st['prog'].reference_program(ctx.cell.config['program'],
                                       st['source'], None)
    conf = ctx.cell.config['interpreter']
    return lanes.InjectedTable(rmp, dict(st['fabric']), conf['max_meas'],
                               conf['max_resets'], feedback=feedback)


def _pool_codes(ctx, st, table) -> list:
    import torch
    return [table.codes(torch.as_tensor(b, device=ctx.device))
            for b in st['pool']]


def judge(ctx, st, table, codes: list, decoded: list, kept: list) -> list:
    """The numbers compared: calls whose corrections differ from the
    reference decode, lanes of the kept calls that differ on any compared
    output, and kept calls' syndrome entries that differ from the bits."""
    import torch
    dc = ctx.cell.config['decode']
    P = len(st['pool'])
    want = [qec.majority_decode(b[:, :, dc['cores'], dc['slot']]
                                .transpose(1, 0, 2)) for b in st['pool']]
    bad_calls = sum(not np.array_equal(d, want[i % P])
                    for i, d in enumerate(decoded))
    bad_lanes, bad_synd, per_key = 0, 0, {}
    for i, out in kept:
        idx = codes[i % P]
        uniq, inv = torch.unique(idx, return_inverse=True)
        tab = table.table(uniq.cpu().numpy())
        c = lanes.compare(out, tab, inv, KEYS)
        bad_lanes += c.pop('any')
        for k, v in c.items():
            per_key[k] = per_key.get(k, 0) + v
        synd = torch.as_tensor(st['pool'][i % P][:, :, dc['cores'],
                                                 dc['slot']]
                               .transpose(1, 0, 2), device=idx.device)
        bad_synd += int((out['syndrome_hist'].to(idx.device) != synd).sum())
    ctx.log(f'compared {len(decoded)} calls\' corrections and every lane of '
            f'{len(kept)} kept calls; lane mismatches by output: {per_key}')
    return [('calls_decoded_differing', bad_calls, 0),
            ('kept_lanes_differing', bad_lanes, 0),
            ('kept_syndromes_differing', bad_synd, 0)]


def check(ctx, st) -> list:
    import torch
    table = _table(ctx, st)
    codes = _pool_codes(ctx, st, table)
    # the exec hop's work in the traced calls: every retired row, the
    # bits read and the result written
    n = st.get('traced_calls', st['n_calls'])
    conf = ctx.cell.config['interpreter']
    rows = 0
    for i in range(n):
        uniq, counts = torch.unique(codes[i % len(codes)],
                                    return_counts=True)
        tab = table.table(uniq.cpu().numpy())
        rows += int(counts.cpu().numpy() @ tab['retired'].sum(1))
    lanes_n = st['R'] * st['B']
    nbytes = n * (lanes_n * st['C'] * st['M'] * 4 + exec_rows.result_bytes(
        lanes_n, st['C'], conf['max_meas'], conf['max_resets']))
    st['work'] = dict(calls=n, rows=rows, bytes=nbytes,
                      exec_least_s=exec_rows.least_seconds(rows, nbytes))
    return judge(ctx, st, table, codes, st['decoded'], st['kept'])


def control(ctx, st, n_calls: int) -> list:
    """The control at the cell's size: the reference with its LUT
    feedback broken (every read serves 0) put in the port's place for
    ``n_calls`` calls, judged as a window's calls are."""
    import torch
    broken = _table(ctx, st, feedback=False)
    codes = _pool_codes(ctx, st, broken)
    dc = ctx.cell.config['decode']
    P = len(st['pool'])
    decoded, kept = [], []
    for i in range(n_calls):
        bits = st['pool'][i % P]
        decoded.append(qec.majority_decode(
            bits[:, :, dc['cores'], dc['slot']].transpose(1, 0, 2)))
        if i < int(ctx.traffic['keep_calls']):
            uniq, inv = torch.unique(codes[i % P], return_inverse=True)
            tab = broken.table(uniq.cpu().numpy())
            out = {k: torch.as_tensor(v, device=ctx.device)[inv]
                   for k, v in tab.items()}
            out['syndrome_hist'] = torch.as_tensor(
                bits[:, :, dc['cores'], dc['slot']].transpose(1, 0, 2),
                device=ctx.device)
            kept.append((i, out))
    table = _table(ctx, st)
    return judge(ctx, st, table, _pool_codes(ctx, st, table), decoded, kept)


def release(st) -> None:
    """Free the port's state before the comparison runs."""
    st.pop('call', None)
