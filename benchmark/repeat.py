"""Run cells of the benchmark several times, each run its own process, as
the check runs them, and summarise the spread of each metric.

    python3 benchmark/repeat.py --runs rb8_reset.campaign:101,102,103 \\
        --seconds 20 [--trace 0] [--out chiprun_out/repeat.jsonl]

``--runs`` takes ``cell:seed,seed,...`` groups (several groups run in
the given order).  Each run's result line and the end of its standard
error go to ``--out``; the summary gives per cell and metric the median
and the spread (the distance between the first and third quartile of
``statistics.quantiles(values, n=4)`` over the median), and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return 'unknown'


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--runs', nargs='+', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, default=0)
    p.add_argument('--out', default=os.path.join('chiprun_out',
                                                 'repeat.jsonl'))
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    print(f'card: {card()}', flush=True)
    values, correct = {}, {}
    with open(args.out, 'a') as log:
        for group in args.runs:
            cell, seeds = group.split(':')
            for seed in seeds.split(','):
                cmd = [sys.executable, os.path.join(HERE, 'run.py'),
                       '--workload', cell, '--seed', seed, '--seconds',
                       str(args.seconds), '--trace', str(args.trace)]
                t0 = time.perf_counter()
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   cwd=REPO)
                wall = time.perf_counter() - t0
                lines = r.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1])
                except (IndexError, json.JSONDecodeError):
                    res = None
                err = [ln for ln in r.stderr.splitlines()
                       if not ln.startswith('USDT')]
                log.write(json.dumps(dict(cell=cell, seed=seed, rc=r.returncode,
                                          wall=wall, result=res,
                                          stderr=err[-40:])) + '\n')
                log.flush()
                if res is None:
                    print(f'{cell} seed {seed}: rc {r.returncode}, no '
                          f'result; stderr tail:\n' + '\n'.join(err[-25:]),
                          flush=True)
                    continue
                correct.setdefault(cell, []).append(res['correct'])
                ms = {k: v['value'] for k, v in res['metrics'].items()}
                for k, v in ms.items():
                    values.setdefault((cell, k), []).append(v)
                print(f'{cell} seed {seed}: rc {r.returncode} correct '
                      f'{res["correct"]} wall {wall:.1f} s '
                      f'{json.dumps(ms)} checks '
                      f'{json.dumps(res.get("checks"))} mem '
                      f'{res["device"].get("memory_peak_bytes")}'
                      + (f' busy {res["device"].get("busy_s")} window '
                         f'{res["device"].get("window_s")}'
                         if args.trace else ''), flush=True)
                if args.trace:
                    print('  breakdown ' + json.dumps(res.get('breakdown')),
                          flush=True)
                for ln in err[-12:-len(res.get('checks', {})) or None]:
                    print('  | ' + ln, flush=True)
    for (cell, k), v in values.items():
        line = (f'{cell} {k}: n {len(v)} median {statistics.median(v)!r}'
                f' min {min(v)!r} max {max(v)!r}')
        if len(v) >= 2:
            line += f' spread {spread(v):.5f}'
        print(line, flush=True)
    for cell, c in correct.items():
        print(f'{cell}: correct {sum(c)} of {len(c)}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
