"""One run of one cell: set-up, the measured window, the comparison and
the metrics, driven by the cell's files."""

from __future__ import annotations

import gc
import glob
import importlib
import os
import sys

from . import trace as tr
from .common import BENCH, Cell, guard, load_json, load_module, \
    process_age_s


class Context:
    """What a driver sees of the run: the cell, its seed and window, the
    device and the tracer.  ``sizes`` overrides traffic keys (the CPU
    tests run the cells small)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, sizes: dict = None):
        self.cell = cell
        self.traffic = dict(cell.traffic, **(sizes or {}))
        self.seed, self.seconds, self.device = int(seed), seconds, device
        self.tracer = tr.Tracer(trace, device)

    def span(self, name: str):
        return self.tracer.span(name)

    def sync(self) -> None:
        if self.device == 'cuda':
            import torch
            torch.cuda.synchronize()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def layer_patterns(layer: str) -> list:
    """The kernel-name patterns that ``benchmark/layers/*.json`` assign
    to ``layer``."""
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH, 'layers', '*.json'))):
        spec = load_json(path)
        if spec['layer'] == layer:
            out += spec['patterns']
    return out


def read_metric(name: str, rec: dict):
    mod = load_module(os.path.join(BENCH, 'metrics', name + '.py'),
                      'benchmark_metric_' + name.replace('.', '_'))
    return mod.read(rec)


def _device_info(device: str, chips: int) -> dict:
    if device != 'cuda':
        return dict(platform='cpu', kind='cpu', count=1)
    import torch
    return dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=chips)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', sizes: dict = None) -> tuple:
    """Run one cell; returns ``(result, checks)``: the result line's
    fields and the numbers compared as ``(name, value, limit)``."""
    import torch
    cell = Cell(workload)
    driver = importlib.import_module(
        f'benchmark.drivers.{cell.traffic["driver"]}')
    ctx = Context(cell, seed, seconds, trace, device, sizes)
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    st = driver.setup(ctx)
    guard('after set-up')
    # what set-up built lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()
    win = driver.window(ctx, st)
    ctx.sync()
    mem = torch.cuda.max_memory_allocated() if device == 'cuda' else 0
    driver.release(st)
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    checks = driver.check(ctx, st)
    work = dict(st.get('work', {}))
    st.clear()
    gc.collect()
    correct = all(value <= limit for _n, value, limit in checks)
    dev = dict(_device_info(device, cell.chips), memory_peak_bytes=int(mem))
    result = dict(correct=bool(correct), attempted=int(win['attempted']),
                  failed=int(win['failed']), metrics={}, device=dev)
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m['name'] == 'setup_s' \
                else win['metrics'][m['name']]
            result['metrics'][m['name']] = dict(value=float(value),
                                                unit=m['unit'])
    else:
        events = ctx.tracer.events
        rec = dict(events=events, work=work, window=win,
                   layers=layer_patterns)
        for m in cell.per_layer:
            value = read_metric(m['name'], rec)
            if value is not None:
                result['metrics'][m['name']] = dict(value=float(value),
                                                    unit=m['unit'])
        dev.update(busy_s=tr.busy_s(events), window_s=tr.window_s(events))
        ctx.log(f'traced window {dev["window_s"]:.4f} s: '
                f'{len(events["device"])} device activities inside it, '
                f'{events["outside"]} outside')
        result['breakdown'] = dict(device_ops=tr.top_device_ops(events),
                                   idle_gaps=tr.idle_gaps(events))
    ctx.log(f'{workload} seed {seed}: {win.get("note", "")}; set-up '
            f'{setup_s:.3f} s; peak device memory {mem} bytes')
    guard('at exit')
    return result, checks
