"""Multi-host execution on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``.  JAX runs one
controller per host over that host's devices; the port runs one process
per device everywhere (:mod:`.mesh`), so a host is a set of ranks and
the same two reduction strategies carry over:

* **Global-mesh collectives** (:func:`make_global_mesh` + the sweep
  functions): one mesh over every rank of every host, whose ``'dp'``
  all-reduce crosses hosts inside the collective library.
* **Host-local compute + store reduction** (:func:`host_local_mesh` +
  :func:`dp_row_offset` + :func:`cross_host_sum`): each process reduces
  over its OWN mesh only, placing its shard seeds on the global dp grid
  (``sweep.sharded_physics_stat_sums(dp_offset=)``), and the final
  integer sum rides the process group's key-value store in process
  order — identical on every process and to a single-process run of the
  same global batch.

A process that never initialises a group runs single-process:
everything here falls back to the one-rank case.
"""

from __future__ import annotations

import datetime
import gc
import json

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..sim.interpreter import torch_device
from .mesh import _device_mesh, axis, make_mesh, shot_sharding


def initialize_multihost(coordinator_address: str = None,
                         num_processes: int = None,
                         process_id: int = None, auto: bool = False,
                         backend: str = None) -> dict:
    """Initialise the default process group; returns the topology.

    ``auto=True`` reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); explicit
    ``coordinator_address`` (``host:port``, or any ``tcp://`` /
    ``file://`` init method), ``num_processes`` and ``process_id`` work
    everywhere else.  With neither, nothing is initialised (single
    process).  ``backend``: default NCCL where CUDA is available, else
    gloo.  Returns the JAX package's keys: ``process_index``,
    ``process_count``, ``local_devices`` (one per process) and
    ``global_devices``."""
    backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
    if auto:
        dist.init_process_group(backend, init_method='env://')
    elif num_processes is not None and num_processes > 1:
        url = coordinator_address if '://' in coordinator_address \
            else f'tcp://{coordinator_address}'
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {'process_index': dist.get_rank() if dist.is_initialized() else 0,
            'process_count': world,
            'local_devices': 1,
            'global_devices': world}


def shutdown_multihost() -> None:
    """Destroy the default process group (if any) after dropping the
    meshes cached for it.  A cached mesh holds its process groups; one
    left alive past ``destroy_process_group`` is torn down in the
    interpreter's finalization instead, where gloo can abort the
    process (``terminate called without an active exception``)."""
    _device_mesh.cache_clear()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def make_global_mesh(n_mp: int = 1, device=None) -> DeviceMesh:
    """A ``('dp', 'mp')`` mesh over every rank of every process, ranks
    in order, so consecutive dp rows are a host's own ranks."""
    device = torch_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_mp < 1 or world % n_mp:
        raise ValueError(f'{world} devices not divisible by n_mp={n_mp}')
    return make_mesh(n_dp=world // n_mp, n_mp=n_mp, device=device)


def host_local_batch(mesh: DeviceMesh, global_shots: int) -> tuple:
    """``(local_shots, local_offset)``: this process's share of a global
    shot count sharded equally over the mesh's dp axis."""
    n_dp, row, _ = axis(mesh, 'dp')
    if global_shots % n_dp:
        raise ValueError(f'{global_shots} shots not divisible by dp={n_dp}')
    per_dev = global_shots // n_dp
    return per_dev, per_dev * row


def host_local_mesh(n_mp: int = 1, device=None) -> DeviceMesh:
    """A ``('dp', 'mp')`` mesh over THIS process's device only: its
    collectives never leave the process.  Pair with
    :func:`dp_row_offset` and :func:`cross_host_sum` to reproduce a
    global-mesh reduction exactly.  Every process must call it (its
    one-rank groups are made by all ranks together)."""
    device = torch_device(device)
    if n_mp != 1:
        raise ValueError(f'1 local device not divisible by n_mp={n_mp}')
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(n_dp=1, n_mp=1, device=device)
    own, _ = dist.new_subgroups(group_size=1)
    rank = dist.get_rank()
    return DeviceMesh.from_group([own, own], device.type,
                                 mesh=torch.tensor([[rank]]),
                                 mesh_dim_names=('dp', 'mp'))


def dp_row_offset(global_mesh: DeviceMesh) -> int:
    """This process's dp row on the global mesh: the offset that places
    a host-local mesh's shards on the global dp grid (the ``dp_offset``
    of :func:`.sweep.sharded_physics_stat_sums`)."""
    return axis(global_mesh, 'dp')[1]


def _flatten(tree):
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, rebuild = [], []
        for k in keys:
            sub, fn = _flatten(tree[k])
            leaves += sub
            rebuild.append((k, len(sub), fn))

        def unflatten(vals, rebuild=rebuild):
            out, at = {}, 0
            for k, n, fn in rebuild:
                out[k] = fn(vals[at:at + n])
                at += n
            return out
        return leaves, unflatten
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]

        def unflatten(vals, parts=parts, kind=type(tree)):
            out, at = [], 0
            for sub, fn in parts:
                out.append(fn(vals[at:at + len(sub)]))
                at += len(sub)
            return kind(out)
        return [leaf for sub, _ in parts for leaf in sub], unflatten
    return [tree], lambda vals: vals[0]


def cross_host_sum(tag: str, tree, timeout_s: float = 120.0):
    """Sum a tree (dicts, lists, tuples) of integer arrays over every
    process through the process group's key-value store — no collective
    library: each process publishes its partial sums under ``tag`` and
    its rank, then folds every peer's IN RANK ORDER, so all processes
    compute identical totals.  ``tag`` must be unique per reduction
    (keys are never deleted).  Single process: the tree as host numpy."""
    leaves, unflatten = _flatten(tree)
    local = [np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor)
                        else leaf) for leaf in leaves]
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return unflatten(local)
    store = dist.distributed_c10d._get_default_store()
    payload = json.dumps([{'shape': list(x.shape), 'dtype': str(x.dtype),
                           'data': x.ravel().tolist()} for x in local])
    store.set(f'dproc/sum/{tag}/{dist.get_rank()}', payload)
    keys = [f'dproc/sum/{tag}/{pid}' for pid in range(dist.get_world_size())]
    store.wait(keys, datetime.timedelta(seconds=timeout_s))
    total = None
    for key in keys:
        peer = [np.asarray(d['data'], dtype=d['dtype']).reshape(d['shape'])
                for d in json.loads(store.get(key))]
        total = peer if total is None \
            else [a + b for a, b in zip(total, peer)]
    return unflatten(total)


def global_shot_array(mesh: DeviceMesh, local_data, global_shape):
    """This process's ``local_data`` as its shard of a dp-sharded global
    array: a ``DTensor`` of ``global_shape`` (the sharded entry points
    take it as the rank's shard as it stands).  Single rank: the data as
    a plain tensor."""
    from torch.distributed.tensor import DTensor
    local = torch.as_tensor(local_data)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    stride = tuple(int(s) for s in
                   np.cumprod((list(global_shape[1:]) + [1])[::-1])[::-1])
    return DTensor.from_local(local, mesh, shot_sharding(mesh),
                              run_check=False, shape=torch.Size(global_shape),
                              stride=stride)
