"""The cells at sizes a CPU test run holds, and how to run one."""

from __future__ import annotations

SIZES = {
    'rb8_reset.campaign': dict(shots=64, keep_batches=1, trace_seconds=0.2),
    'rb8_reset.tenants': dict(shots=32, n_programs=4, rate_hz=6.0,
                              bit_pool=3, check_requests=3, grace_s=30.0,
                              trace_seconds=1.2),
    'rep8_lut.stream': dict(shots=24, rounds=5, pool=2, keep_calls=1,
                            trace_seconds=0.2),
}
SECONDS = {'rb8_reset.campaign': 0.3, 'rb8_reset.tenants': 1.6,
           'rep8_lut.stream': 0.3}


def run_small(cell: str, seed: int, trace: bool = False) -> tuple:
    from benchmark.harness.cell import run_cell
    return run_cell(cell, seed, SECONDS[cell], trace, device='cpu',
                    sizes=SIZES[cell])
