"""The port's serve benchmarks (``serve/benchmark.py``) against the JAX
package's.

``_workload`` gives the JAX package's program bytes, bits and budget, so
every benchmark starts from the same requests.  Each benchmark function
runs at a tiny size on the CPU (``device='cpu'``: services and replicas
on the CPU) and returns the JAX function's row keys, with its own gates
(bit-identity against the solo runs, typed failures, positive goodput
through the kill window, exact billing, cache dedup) holding.  The JAX
rows come from the JAX functions at the same sizes, but for two:
``fleet_failover``'s keys are read from the dict its source returns (a
JAX fleet of replica processes compiling XLA would load the test host
for nothing but a row's keys), and so are ``compile_front_door``'s (its
own gate times a warm pass against an uncached one, which a loaded host
jitters, and the JAX package's margin over the gate is the narrower);
``fleet_observability_overhead`` runs one JAX replica.
"""

import ast
import inspect

import dataclasses

import numpy as np
import pytest

from distributed_processor_tpu.compilecache import \
    machine_program_bytes as j_bytes
from distributed_processor_tpu.serve import benchmark as jbench

from distributed_processor_tpu_torch.compilecache import \
    machine_program_bytes
from distributed_processor_tpu_torch.serve import benchmark as bench
from distributed_processor_tpu_torch.utils import profiling as t_profiling

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


@pytest.mark.parametrize('n,q,depth,shots,seed',
                         [(3, 2, 2, 4, 1), (2, 3, 4, 8, 9), (4, 2, 12, 2, 0)])
def test_workload_is_jax(n, q, depth, shots, seed):
    mps, bits, cfg = bench._workload(n, q, depth, shots, seed)
    jmps, jbits, jcfg = jbench._workload(n, q, depth, shots, seed)
    assert [machine_program_bytes(m) for m in mps] == \
        [j_bytes(m) for m in jmps]
    for a, b in zip(bits, jbits):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def _returned_keys(fn) -> set:
    """The keys of the dict literal that ``fn``'s source returns."""
    tree = ast.parse(inspect.getsource(fn))
    rets = [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(rets) == 1
    return {k.value for k in rets[0].keys}


def _same_keys(row, jrow, nested=()):
    """The row's keys are the JAX row's, and so are those of each
    ``nested`` sub-row."""
    assert set(row) == set(jrow), set(row) ^ set(jrow)
    for k in nested:
        assert set(row[k]) == set(jrow[k]), (k, set(row[k]) ^ set(jrow[k]))


def test_continuous_batching_comparison():
    kw = dict(n_reqs=4, n_qubits=2, depth=2, shots=4, max_wait_ms=20.0)
    row = bench.continuous_batching_comparison(device='cpu', **kw)
    _same_keys(row, jbench.continuous_batching_comparison(**kw))
    assert row['bit_identical'] is True
    # the timed round runs on a warmed service: no dispatch classified
    # cold after the warm-up
    assert row['warm_retraces'] == 0
    assert row['dispatches'] >= 1


def test_multi_device_scaling():
    kw = dict(dp_list=(1, 2), n_reqs=4, shots=4, max_wait_ms=20.0)
    row = bench.multi_device_scaling(device='cpu', **kw)
    _same_keys(row, jbench.multi_device_scaling(**kw), nested=('dp1', 'dp2'))
    assert row['dp2']['devices_active'] == 2


def test_multi_device_scaling_counts_cards():
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    with pytest.raises(ValueError, match='CUDA device'):
        bench.multi_device_scaling(dp_list=(1,), n_reqs=2, shots=2)


def test_open_loop_latency():
    kw = dict(n_reqs=4, rate_hz=400.0, depths=(2,), shots=4,
              max_batch_programs=2)
    row = bench.open_loop_latency(device='cpu', **kw)
    _same_keys(row, jbench.open_loop_latency(**kw))
    assert row['cold_compiles_timed'] == 0
    assert row['n_devices'] == 1


def test_availability_under_chaos():
    kw = dict(n_reqs=12, rate_hz=400.0, shots=2, p_crash=0.2, p_hang=0.0,
              p_slow=0.1)
    row = bench.availability_under_chaos(device='cpu', **kw)
    _same_keys(row, jbench.availability_under_chaos(**kw))
    assert row['hung'] == 0 and row['completed'] >= 1


def test_tenant_isolation():
    kw = dict(n_victim=2, greedy_factor=2, shots=2)
    row = bench.tenant_isolation(device='cpu', **kw)
    _same_keys(row, jbench.tenant_isolation(**kw),
               nested=('fair_on', 'fair_off'))
    assert row['fair_on']['victim']['shots'] == 2 * 2


@pytest.fixture
def patient_routers(monkeypatch):
    """Both packages' routers with a 5 s liveness window for the fleet
    rows (their functions take no router options): on a loaded test host
    a replica busy compiling can miss 250 ms of heartbeats, and a
    replica marked stale that way fails requests over until the retry
    budget is spent, which is not what these rows measure.  A killed
    replica is still caught at once, by its connection."""
    from distributed_processor_tpu.serve.router import FleetRouter as JR
    from distributed_processor_tpu_torch.serve.router import FleetRouter
    for cls in (JR, FleetRouter):
        monkeypatch.setitem(cls.__init__.__kwdefaults__,
                            'liveness_window_ms', 5000.0)


def test_fleet_failover(patient_routers):
    kw = dict(n_replicas=2, n_reqs=8, rate_hz=200.0, shots=2,
              kill_window_s=5.0)
    row = bench.fleet_failover(device='cpu', **kw)
    assert set(row) == _returned_keys(jbench.fleet_failover) \
        == _returned_keys(bench.fleet_failover)
    assert row['hung'] == 0 and row['ok_in_kill_window'] > 0
    assert row['replica_down'] >= 1


def test_fleet_observability_overhead(patient_routers):
    kw = dict(n_replicas=2, n_reqs=4, shots=2)
    row = bench.fleet_observability_overhead(device='cpu', **kw)
    _same_keys(row, jbench.fleet_observability_overhead(
        **dict(kw, n_replicas=1)), nested=('off', 'sampled', 'full'))
    assert row['full']['stitched_spans'] > 0
    assert row['off']['stitched_spans'] == 0


def test_compile_front_door():
    # the default traffic: 16 requests a pass, where the port's warm
    # pass beats its uncached pass well past the row's 10x gate
    kw = dict(n_tenants=4, n_programs=4, depth=4, shots=2,
              stampede_threads=4)
    row = bench.compile_front_door(device='cpu', **kw)
    assert set(row) == _returned_keys(jbench.compile_front_door) \
        == _returned_keys(bench.compile_front_door)
    assert row['cold_compiles'] == 4 and row['stampede_compiles'] == 1


def test_calibration_loop():
    kw = dict(shots=2)
    row = bench.calibration_loop(device='cpu', **kw)
    jrow = jbench.calibration_loop(**kw)
    _same_keys(row, jrow, nested=('sessions',))
    assert row['steps_to_converge'] == jrow['steps_to_converge']
    assert row['warm_hit_fraction'] == 1.0


def test_main_prints_one_row(capsys):
    import json
    bench._main(['--device', 'cpu', 'scaling', '--dp', '1', '--reqs', '2',
                 '--shots', '2'])
    row = json.loads(capsys.readouterr().out)
    assert row['dp1']['devices_active'] == 1 and row['bit_identical']
