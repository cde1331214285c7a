"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload rb8_reset.campaign --seed 7 \\
        --seconds 10 --trace 0

``BENCHMARK.json`` at the root of the checkout names the cells; each
cell's configuration, traffic mix, per-layer metrics and layers are
files under ``benchmark/`` (README.md).  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: every number compared with its limit); the same numbers are
the last lines of standard error.  Without CUDA, or with fewer cards
than the cell asks for, or with JAX or the JAX package loaded, it exits
with a nonzero code and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark.harness.common import Cell, emit
    cell = Cell(args.workload)
    # one process, few threads: the port's work on the host is dispatch
    # from one thread (the service adds its own), so the host's intra-op
    # pool would only contend with it
    os.environ['OMP_NUM_THREADS'] = '1'
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    from benchmark.harness.cell import run_cell
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    emit(result, checks)
    return 0


if __name__ == '__main__':
    # the package `benchmark` and the port are imported from the root of
    # the checkout, never from this script's own folder
    sys.path[:] = [REPO] + [d for d in sys.path
                            if os.path.abspath(d or '.') != HERE]
    os.chdir(REPO)
    sys.exit(main())
