"""The SPMD worker of the port's multi-rank tests (no test functions).

    python tests/test_torch_spmd_worker.py JOB RANK WORLD INIT

Rank ``RANK`` of ``WORLD`` joins a gloo process group through
:func:`distributed_processor_tpu_torch.parallel.initialize_multihost`
(``INIT``: a ``file://`` URL, so parallel test files need no ports),
runs every case of the pickled job ``JOB`` in order — every rank runs
every case, as SPMD code must — and pickles its results to
``JOB.RANK.out``.  A case is ``(name, kwargs)``: a function of this
module (:data:`CASES`) or of ``distributed_processor_tpu_torch.parallel``
called on the CPU over the mesh named by ``mesh``.  Results come back as
numpy (tensors converted), a raised ``Exception`` as ``('raised', type
name, message)``.

The parent side is :func:`run_spmd`: it starts the ranks, waits for them
with a deadline, and kills every rank when one fails or the deadline
passes, so a hang fails its test instead of the suite.

Imports torch, numpy and the port only: no JAX, nothing of the JAX
package (``tests/test_torch_imports.py`` checks).
"""

import os
import pickle
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_spmd(cases: list, world: int, tmp_path, timeout: float = 240.0
             ) -> list:
    """Run ``cases`` on ``world`` ranks; returns each rank's list of case
    results, rank order.  A rank that exits non-zero, or a run past
    ``timeout`` seconds, kills every rank and fails with the ranks'
    stderr."""
    job = os.path.join(str(tmp_path), f'spmd-{world}-{time.monotonic_ns()}')
    with open(job, 'wb') as f:
        pickle.dump(cases, f)
    init = f'file://{job}.pg'
    # one thread per rank: the ranks share the test host's cores with
    # the rest of the suite
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         init], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    errs = [''] * world
    try:
        for r, p in enumerate(procs):
            try:
                _, errs[r] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f'rank {r} of {world} passed the {timeout} s deadline')
            if p.returncode != 0:
                raise AssertionError(
                    f'rank {r} of {world} exited {p.returncode}:\n'
                    f'{errs[r][-4000:]}')
    finally:
        # a failed or hung rank must not leave its peers blocked in a
        # collective
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for r in range(world):
        with open(f'{job}.{r}.out', 'rb') as f:
            out.append(pickle.load(f))
    return out


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return x


def _mesh(spec):
    """``('dp', n_dp, n_mp)`` or ``('cores', n_cores, n_dp)``."""
    from distributed_processor_tpu_torch.parallel import (make_cores_mesh,
                                                          make_mesh)
    kind, a, b = spec
    if kind == 'dp':
        return make_mesh(n_dp=a, n_mp=b, device='cpu')
    return make_cores_mesh(n_cores=a, n_dp=b, device='cpu')


def call(fn: str, mesh, args=(), kwargs=None):
    """``distributed_processor_tpu_torch.parallel.<fn>(*args, mesh=...,
    device='cpu', **kwargs)`` with the mesh of spec ``mesh``."""
    from distributed_processor_tpu_torch import parallel
    return getattr(parallel, fn)(*args, mesh=_mesh(mesh), device='cpu',
                                 **(kwargs or {}))


def lut_sharded_call(mask, table, bits, n_shards: int):
    """``MeasLUT.sharded_call`` on this rank's slice of the cores."""
    from distributed_processor_tpu_torch.ops.fabric import MeasLUT
    from distributed_processor_tpu_torch.parallel.mesh import axis
    mesh = _mesh(('cores', n_shards, None))
    _, index, group = axis(mesh, 'cores')
    width = bits.shape[-1] // n_shards
    own = bits[..., index * width:(index + 1) * width]
    return MeasLUT(mask, table, device='cpu').sharded_call(own, group)


def multihost_stats(mp, cfg, bits, model, seed: int, phys_kw: dict):
    """The JAX package's multihost worker on the port: a host-local mesh,
    its place on the global dp grid and the store reduction, beside the
    global mesh's own collectives."""
    from distributed_processor_tpu_torch.parallel import (
        cross_host_sum, dp_row_offset, global_shot_array, host_local_batch,
        host_local_mesh, make_global_mesh, sharded_physics_stat_sums,
        sweep_stat_sums)
    gmesh = make_global_mesh(device='cpu')
    local_shots, offset = host_local_batch(gmesh, bits.shape[0])
    lmesh = host_local_mesh(device='cpu')
    own = bits[offset:offset + local_shots]
    local = sweep_stat_sums(mp, own, lmesh, cfg=cfg, device='cpu')
    total = cross_host_sum('inj', {k: v for k, v in local.items()})
    row = dp_row_offset(gmesh)
    phys = sharded_physics_stat_sums(mp, model, seed, local_shots, lmesh,
                                     dp_offset=row, device='cpu', **phys_kw)
    phys_total = cross_host_sum('phys', phys)
    # the global mesh's own collectives, on the same rows and seeds
    g_inj = sweep_stat_sums(mp, global_shot_array(gmesh, own, bits.shape),
                            gmesh, cfg=cfg, device='cpu')
    g_phys = sharded_physics_stat_sums(mp, model, seed, bits.shape[0], gmesh,
                                       device='cpu', **phys_kw)
    return dict(local_shots=local_shots, offset=offset, row=row,
                inj=total, phys=phys_total, g_inj=g_inj, g_phys=g_phys)


def mesh_consistency(seed: int = 0, n: int = 4):
    """The fault-injection harness's mesh check over every rank."""
    from distributed_processor_tpu_torch.sim.faultinject import \
        check_mesh_consistency
    return check_mesh_consistency(seed, n, device='cpu')


CASES = {'call': call, 'lut_sharded_call': lut_sharded_call,
         'multihost_stats': multihost_stats,
         'mesh_consistency': mesh_consistency}


def _main(job: str, rank: int, world: int, init: str) -> None:
    from distributed_processor_tpu_torch.parallel import (
        initialize_multihost, shutdown_multihost)
    info = initialize_multihost(init, num_processes=world, process_id=rank,
                                backend='gloo')
    with open(job, 'rb') as f:
        cases = pickle.load(f)
    results = []
    for name, kwargs in cases:
        try:
            results.append(_numpy(CASES[name](**kwargs)))
        except Exception as e:       # reported to the parent, per case
            results.append(('raised', type(e).__name__, str(e)))
    results.append(info)
    with open(f'{job}.{rank}.out', 'wb') as f:
        pickle.dump(results, f)
    shutdown_multihost()


if __name__ == '__main__':
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
