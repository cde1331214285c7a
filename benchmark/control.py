"""Run each cell's control on the card at the cell's own size.

    python3 benchmark/control.py --seeds 11,12,13 [--cells ...] \\
        [--batches 60 --calls 400]

The control is the plain reference with the guarantee its configuration
states broken (every fproc or LUT read serves 0: no feed-forward), put in
the port's place and judged by the cell's own comparison.  It has to
fail one of the cell's numbers on every seed; each number is printed
with its limit.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    from benchmark.harness.cell import Context
    from benchmark.harness.common import Cell
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seeds', required=True)
    p.add_argument('--cells', nargs='*', default=None)
    p.add_argument('--units', type=int, default=None,
                   help='batches, calls or requests judged per seed '
                        '(default: what a 20 s window runs)')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    default_units = {'physics_batches': 100, 'rounds_stream': 600,
                     'service_open_loop': 4}
    cells = args.cells or ['rb8_reset.campaign', 'rb8_reset.tenants',
                           'rep8_lut.stream']
    failed_every_seed = True
    for name in cells:
        cell = Cell(name)
        driver = importlib.import_module(
            f'benchmark.drivers.{cell.traffic["driver"]}')
        for seed in (int(s) for s in args.seeds.split(',')):
            ctx = Context(cell, seed, 20.0, False, args.device)
            st = driver.setup(ctx)
            driver.release(st)
            units = args.units or default_units[cell.traffic['driver']]
            checks = driver.control(ctx, st, units)
            failed = any(v > lim for _n, v, lim in checks)
            failed_every_seed &= failed
            print(f'control {name} seed {seed} ({units} units): '
                  + ', '.join(f'{n} = {v} (limit {lim})'
                              for n, v, lim in checks)
                  + f' -> {"fails" if failed else "PASSES"}', flush=True)
            st.clear()
    return 0 if failed_every_seed else 1


if __name__ == '__main__':
    sys.path[:] = [REPO] + [d for d in sys.path
                            if os.path.abspath(d or '.') != HERE]
    os.chdir(REPO)
    sys.exit(main())
