"""What every run shares: the cell's files, seeds, the import guard,
the process clock, percentiles and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

# top-level module names no run may hold: JAX and the JAX package (whole
# names, so the port `distributed_processor_tpu_torch` is not one of them)
BANNED = ('jax', 'jaxlib', 'flax', 'distributed_processor_tpu')

_MASK64 = (1 << 64) - 1


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so that set-up
    counts the interpreter's and torch's start-up too."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file ``path`` as module ``name`` (names of metrics and
    drivers hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, its traffic mix
    and the per-layer metrics that name it."""

    def __init__(self, workload: str):
        bench = load_json(os.path.join(REPO, 'BENCHMARK.json'))
        cells = {w['name']: w for w in bench['workloads']}
        if workload not in cells:
            raise SystemExit(f'unknown workload {workload!r}; the cells are '
                             f'{sorted(cells)}')
        self.name = workload
        self.entry = cells[workload]
        self.chips = int(self.entry['chips'])
        cfg_entry = {c['name']: c for c in bench['configs']}[
            self.entry['config']]
        self.config = load_json(os.path.join(REPO, cfg_entry['file']))
        self.traffic = load_json(os.path.join(
            BENCH, 'traffic', self.entry['traffic'] + '.json'))
        self.end_to_end = [m for m in bench['end_to_end']
                           if workload in m.get('workloads', [workload])]
        self.per_layer = [m for m in bench['per_layer']
                          if workload in m.get('workloads', [workload])]


def derive_seed(seed: int, *words: int) -> int:
    """A 64-bit seed from ``seed`` and ``words`` (splitmix64 folds), the
    benchmark's own: batch ``i`` of a run takes ``derive_seed(seed, i)``."""
    x = int(seed) & _MASK64
    for w in (0,) + words:
        x = ((x ^ (int(w) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x


def torch_seed(seed: int, *words: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` (63 bits)."""
    return derive_seed(seed, *words) >> 1


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m for m in sys.modules if m.split('.')[0] in BANNED})


def guard(where: str) -> None:
    """Exit without a result if JAX or the JAX package is loaded."""
    found = banned_modules()
    if found:
        print(f'import guard ({where}): loaded {found}; the benchmark runs '
              f'the port alone', file=sys.stderr)
        sys.exit(4)


def p95(values) -> float:
    """The 95th percentile by nearest rank over all ``values``."""
    v = sorted(values)
    if not v:
        raise ValueError('no values')
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream of unknown
    length, drawn from ``seed``: what a run keeps for the comparison."""

    def __init__(self, k: int, seed: int):
        import random
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1


def emit(result: dict, checks: list) -> None:
    """Print the numbers compared (name, value, limit) as the last lines
    on standard error, and the result as the last line of standard
    output, with the same numbers under ``checks`` as its last key."""
    for name, value, limit in checks:
        print(f'check {name} = {value} (limit {limit})', file=sys.stderr)
    result = dict(result)
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
