"""The torch port stands alone: no JAX, nothing of the JAX package.

A static scan of the imports of every module of
``distributed_processor_tpu_torch`` and of ``chip_smoke.py``: the test
process has JAX loaded already, so ``sys.modules`` proves nothing.  Also
pins that the entry points default to CUDA and raise without it.
"""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'distributed_processor_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'distributed_processor_tpu')


def _sources():
    # the multi-rank tests' worker runs in processes of its own, which
    # must not load JAX either
    paths = [os.path.join(ROOT, 'chip_smoke.py'),
             os.path.join(ROOT, 'tests', 'test_torch_spmd_worker.py')]
    for dirpath, _dirs, files in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith('.py')]
    return sorted(paths)


def _imported_modules(path):
    """Absolute module names a file imports (relative imports resolve
    inside the port and are skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split('.')[0]
    return top in FORBIDDEN


def test_port_has_sources():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for want in ('chip_smoke.py',
                 'distributed_processor_tpu_torch/sim/interpreter.py',
                 'distributed_processor_tpu_torch/sim/physics.py',
                 'distributed_processor_tpu_torch/ops/resolve.py',
                 'distributed_processor_tpu_torch/ops/exec_span.py',
                 'distributed_processor_tpu_torch/ops/waveform.py',
                 'distributed_processor_tpu_torch/ops/demod.py',
                 'distributed_processor_tpu_torch/simulator.py',
                 'distributed_processor_tpu_torch/parallel/driver.py',
                 'distributed_processor_tpu_torch/ops/fabric.py',
                 'distributed_processor_tpu_torch/ops/decode.py',
                 'distributed_processor_tpu_torch/models/repetition.py',
                 'distributed_processor_tpu_torch/models/qec.py',
                 'distributed_processor_tpu_torch/analysis.py',
                 'distributed_processor_tpu_torch/models/calibration.py',
                 'distributed_processor_tpu_torch/parallel/param_sweep.py',
                 'distributed_processor_tpu_torch/sim/oracle.py',
                 'distributed_processor_tpu_torch/parallel/sweep.py',
                 'distributed_processor_tpu_torch/parallel/mesh.py',
                 'distributed_processor_tpu_torch/parallel/multihost.py',
                 'distributed_processor_tpu_torch/utils/results.py',
                 'distributed_processor_tpu_torch/frontend/qasm_parser.py',
                 'distributed_processor_tpu_torch/frontend/visitor.py',
                 'distributed_processor_tpu_torch/frontend/gate_map.py',
                 'distributed_processor_tpu_torch/compilecache/cache.py',
                 'distributed_processor_tpu_torch/compilecache/key.py',
                 'distributed_processor_tpu_torch/compilecache/store.py',
                 'distributed_processor_tpu_torch/integrity.py',
                 'distributed_processor_tpu_torch/obs/metrics.py',
                 'distributed_processor_tpu_torch/obs/trace.py',
                 'distributed_processor_tpu_torch/obs/recorder.py',
                 'distributed_processor_tpu_torch/obs/clock.py',
                 'distributed_processor_tpu_torch/utils/profiling.py',
                 'distributed_processor_tpu_torch/utils/vcd.py',
                 'distributed_processor_tpu_torch/sim/grad.py',
                 'distributed_processor_tpu_torch/serve/__init__.py',
                 'distributed_processor_tpu_torch/serve/request.py',
                 'distributed_processor_tpu_torch/serve/bucketspec.py',
                 'distributed_processor_tpu_torch/serve/batcher.py',
                 'distributed_processor_tpu_torch/serve/supervise.py',
                 'distributed_processor_tpu_torch/serve/stream.py',
                 'distributed_processor_tpu_torch/serve/catalog.py',
                 'distributed_processor_tpu_torch/serve/service.py',
                 'distributed_processor_tpu_torch/serve/chaos.py',
                 'distributed_processor_tpu_torch/calib/__init__.py',
                 'distributed_processor_tpu_torch/calib/session.py',
                 'distributed_processor_tpu_torch/calib/loops.py',
                 'distributed_processor_tpu_torch/serve/transport.py',
                 'distributed_processor_tpu_torch/serve/router.py',
                 'distributed_processor_tpu_torch/serve/fleet.py',
                 'distributed_processor_tpu_torch/serve/replica_main.py',
                 'distributed_processor_tpu_torch/serve/benchmark.py',
                 'distributed_processor_tpu_torch/cli.py',
                 'distributed_processor_tpu_torch/__main__.py',
                 'distributed_processor_tpu_torch/models/golden_suite.py',
                 'distributed_processor_tpu_torch/native/__init__.py',
                 'distributed_processor_tpu_torch/ops/selftest.py',
                 'distributed_processor_tpu_torch/sim/faultinject.py',
                 'tests/test_torch_spmd_worker.py'):
        assert want in names
    for kernel in ('resolve.cu', 'exec_span.cu', 'waveform.cu', 'demod.cu'):
        assert os.path.exists(os.path.join(PORT, 'csrc', kernel))


# the JAX package's Pallas files: K1-K5 (csrc/*.cu) stand in for them
PALLAS_FILES = ('ops/_pallas_common.py', 'ops/exec_pallas.py',
                'ops/resolve_pallas.py', 'ops/waveform_pallas.py')


def _package_files(root, exts):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _dirs, files in os.walk(root) for f in files
            if f.endswith(exts) and '__pycache__' not in d
            and '_build' not in d}


def test_every_jax_module_has_a_counterpart():
    """A file-by-file comparison of the two packages: every module and
    source of the JAX package has a counterpart in the port, apart from
    the Pallas files the hand kernels replace."""
    jax_pkg = os.path.join(ROOT, 'distributed_processor_tpu')
    exts = ('.py', '.cpp')
    missing = sorted(_package_files(jax_pkg, exts)
                     - _package_files(PORT, exts) - set(PALLAS_FILES))
    assert not missing, missing
    assert os.path.exists(os.path.join(PORT, 'native', 'soa_codec.cpp'))


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f'{os.path.relpath(path, ROOT)} imports {bad}'


def test_forbidden_name_rule():
    assert _forbidden('jax.numpy') and _forbidden('jaxlib')
    assert _forbidden('distributed_processor_tpu.isa')
    assert not _forbidden('distributed_processor_tpu_torch.isa')
    assert not _forbidden('torch')


def _tiny_program():
    from distributed_processor_tpu_torch.decoder import \
        machine_program_from_cmds
    from distributed_processor_tpu_torch import isa
    return machine_program_from_cmds([[isa.done_cmd()]])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    from distributed_processor_tpu_torch.sim.interpreter import \
        simulate_batch
    from distributed_processor_tpu_torch.sim.physics import (
        ReadoutPhysics, run_physics_batch)
    from distributed_processor_tpu_torch.parallel import run_physics_sweep
    from distributed_processor_tpu_torch.sim.interpreter import simulate
    from distributed_processor_tpu_torch.simulator import Simulator
    mp = _tiny_program()
    with pytest.raises(RuntimeError, match='CUDA'):
        Simulator(n_qubits=2)
    with pytest.raises(RuntimeError, match='CUDA'):
        simulate(mp)
    with pytest.raises(RuntimeError, match='CUDA'):
        run_physics_batch(mp, ReadoutPhysics(), 0, 4)
    with pytest.raises(RuntimeError, match='CUDA'):
        simulate_batch(mp, np.zeros((4, 1, 1), np.int32))
    with pytest.raises(RuntimeError, match='CUDA'):
        run_physics_sweep(mp, ReadoutPhysics(), 8, 4)
    from distributed_processor_tpu_torch.parallel import run_multi_sweep
    from distributed_processor_tpu_torch.sim.interpreter import (
        simulate_multi_batch, simulate_rounds)
    with pytest.raises(RuntimeError, match='CUDA'):
        simulate_multi_batch([mp], np.zeros((4, 1, 1), np.int32))
    with pytest.raises(RuntimeError, match='CUDA'):
        simulate_rounds(mp, np.zeros((2, 4, 1, 1), np.int32))
    with pytest.raises(RuntimeError, match='CUDA'):
        run_multi_sweep([mp], 8, 4)
    from distributed_processor_tpu_torch.ops.fabric import MeasLUT
    with pytest.raises(RuntimeError, match='CUDA'):
        MeasLUT((True,), (0, 1))
    # the mesh constructors and the sharded entry points
    from distributed_processor_tpu_torch import parallel
    for make in (parallel.make_mesh, parallel.make_cores_mesh,
                 parallel.make_global_mesh, parallel.host_local_mesh):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
    bits = np.zeros((4, 1, 1), np.int32)
    for fn, args in (('sharded_simulate', (mp, bits)),
                     ('sweep_stat_sums', (mp, bits)),
                     ('sweep_stats', (mp, bits)),
                     ('sharded_multi_stats', ([mp], bits[None])),
                     ('sharded_physics_stat_sums', (mp, ReadoutPhysics(), 0,
                                                    4)),
                     ('sharded_physics_stats', (mp, ReadoutPhysics(), 0, 4)),
                     ('sharded_demod', (np.zeros((4, 2)), np.zeros((2, 2)))),
                     ('sharded_cores_simulate', (mp, bits)),
                     ('sharded_cores_stat_sums', (mp, bits)),
                     ('sharded_cores_stats', (mp, bits)),
                     ('sharded_cores_rounds', (mp, bits[None])),
                     ('run_cores_sweep', (mp, 8, 4))):
        with pytest.raises(RuntimeError, match='CUDA'):
            getattr(parallel, fn)(*args, mesh=None)
    # the explicit CPU device runs
    out = simulate_batch(mp, np.zeros((4, 1, 1), np.int32), device='cpu')
    assert bool(out['done'].all())
    assert bool(Simulator(n_qubits=2, device='cpu').run(mp)['done'].all())


def test_tooling_entry_points_default_to_cuda():
    """The self-test and the fault-injection harness run on the card
    unless the caller names the CPU, and raise without CUDA."""
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    from distributed_processor_tpu_torch.ops import selftest
    from distributed_processor_tpu_torch.sim import faultinject as fi
    m = fi.gen_mutants(0, 1)[0]
    for fn, args in ((selftest.kernel_parity_check, ()),
                     (fi.run_fuzz, (0, 1)), (fi.check_mutant, (m,)),
                     (fi.check_vmap_consistency, (0, 1)),
                     (fi.check_fused_consistency, (0, 1)),
                     (fi.check_feedback_consistency, (0, 1)),
                     (fi.check_audit_consistency, (0, 1)),
                     (fi.check_mesh_consistency, (0, 1))):
        with pytest.raises(RuntimeError, match='CUDA'):
            fn(*args)
