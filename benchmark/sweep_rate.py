"""Sweep the open-loop rate of a tenants cell, to find the highest rate
the port sustains without a growing backlog.

    python3 benchmark/sweep_rate.py --cell rb8_reset.tenants \\
        --rates 16,20,24,28,32 --seconds 20 --seed 5

Each rate runs as its own process (``--rate`` runs one), with the
cell's traffic file but for ``rate_hz``; it prints the due-to-result
latencies and the backlog trend (the median latency of the last quarter
of the arrivals over that of the first: near 1 when the queue holds
steady, growing with the window when it does not).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--cell', default='rb8_reset.tenants')
    p.add_argument('--rates', default=None)
    p.add_argument('--rate', type=float, default=None)
    p.add_argument('--seconds', type=float, default=20.0)
    p.add_argument('--seed', type=int, default=5)
    args = p.parse_args(argv)
    if args.rate is not None:
        from benchmark.harness.cell import run_cell
        result, checks = run_cell(args.cell, args.seed, args.seconds, False,
                                  sizes={'rate_hz': args.rate})
        print(json.dumps(dict(rate_hz=args.rate, correct=result['correct'],
                              metrics=result['metrics'],
                              failed=result['failed'])), flush=True)
        return 0
    for rate in args.rates.split(','):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--cell', args.cell,
             '--rate', rate, '--seconds', str(args.seconds), '--seed',
             str(args.seed)], capture_output=True, text=True, cwd=REPO)
        notes = [ln for ln in r.stderr.splitlines()
                 if 'lateness' in ln or 'requests at' in ln
                 or 'Error' in ln]
        print(f'rate {rate} Hz: rc {r.returncode}', flush=True)
        for ln in notes + r.stdout.strip().splitlines()[-1:]:
            print('  ' + ln, flush=True)
    return 0


if __name__ == '__main__':
    sys.path[:] = [REPO] + [d for d in sys.path
                            if os.path.abspath(d or '.') != HERE]
    os.chdir(REPO)
    sys.exit(main())
