"""Device meshes for sharded sweeps, on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  The torch idiom
for several devices is SPMD, one process (rank) per device, where JAX
has one controller over a ``Mesh`` of devices.  So a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with the dimension names ``('dp', 'mp')``
(:func:`make_mesh`: shots, and the demod contraction) or ``('dp',
'cores')`` (:func:`make_cores_mesh`: shots, and one program's cores —
the distributed processor itself).  Ranks lie on the mesh in row-major
order, so a rank's place on an axis is JAX's mesh-axis index.

What ``shard_map`` bodies do with collectives maps one for one:

* ``lax.psum`` over an axis is :func:`psum`, an ``all_reduce`` on
  ``mesh.get_group(name)``;
* a tiled ``lax.all_gather`` is :func:`gather_cat`, an all-gather on
  that group concatenated in rank order (the mesh-axis order).

The collectives use the group's backend: NCCL on CUDA and gloo on the
CPU (and gloo between ranks that share one card, which NCCL refuses;
gloo takes CUDA tensors for both calls).  A process that has no process
group when it builds a mesh gets a one-rank group over a ``file://``
store in a temporary directory, so ``make_mesh()`` works in a plain
single-device run as ``jax.devices()`` does.  A multi-rank run starts
its ranks first (torchrun, or :func:`.multihost.initialize_multihost`).

Sharded entry points (:mod:`.sweep`) take the global arrays on every
rank and return THIS rank's shard of each per-shot leaf; reduced
statistics come back whole on every rank.
"""

from __future__ import annotations

import functools
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..sim.interpreter import torch_device


def _world(device: torch.device) -> int:
    """The default process group's size, after making a one-rank group
    when the process has none (NCCL for a CUDA device, else gloo)."""
    if device.type == 'cuda' and device.index is not None:
        # the rank's card, before any communicator is made
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix='dproc-pg-'), 'store')
        dist.init_process_group(
            'nccl' if device.type == 'cuda' else 'gloo',
            init_method=f'file://{store}', rank=0, world_size=1)
    return dist.get_world_size()


@functools.lru_cache(maxsize=16)
def _device_mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    # one mesh (and one set of process groups) per shape for the life of
    # the process group: building one is a collective over every rank
    # (``multihost.shutdown_multihost`` drops them with the group)
    return DeviceMesh(device_type,
                      torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_dp: int = None, n_mp: int = 1, device=None) -> DeviceMesh:
    """A ``('dp', 'mp')`` mesh over every rank of the process group
    (``n_dp`` defaults to the ranks over ``n_mp``).  ``device``: the
    ranks' device type (default CUDA, as for the entry points)."""
    device = torch_device(device)
    world = _world(device)
    if n_dp is None:
        n_dp = world // max(n_mp, 1)
    if n_dp < 1 or n_mp < 1 or n_dp * n_mp != world:
        raise ValueError(
            f'mesh dp={n_dp} x mp={n_mp} needs {n_dp * n_mp} ranks; the '
            f'process group has {world} (start one process per device: '
            f'torchrun --nproc-per-node=N)')
    return _device_mesh(device.type, (n_dp, n_mp), ('dp', 'mp'))


def make_cores_mesh(n_cores: int = None, n_dp: int = None,
                    device=None) -> DeviceMesh:
    """A ``('dp', 'cores')`` mesh: the ``'cores'`` axis shards ONE
    program's core axis over ranks — the per-core interpreter lanes run
    on different devices and the fproc/sync fabric rides all-gathers
    over the axis — while ``'dp'`` still shards shots.

    ``n_cores`` is the number of SHARDS of the core axis (ranks one
    program spans), not the program's core count, which must divide
    evenly over it (:func:`.sweep.sharded_cores_simulate` checks).
    Defaults: every rank on the cores axis (``n_dp=1``)."""
    device = torch_device(device)
    world = _world(device)
    if n_cores is None:
        n_cores = world // (n_dp or 1)
    if n_cores < 1:
        raise ValueError(f'need a positive cores axis; got {n_cores}')
    if n_dp is None:
        n_dp = world // n_cores
    if n_dp < 1 or n_dp * n_cores != world:
        raise ValueError(
            f'mesh dp={n_dp} x cores={n_cores} needs {n_dp * n_cores} '
            f'devices; the process group has {world} ranks (start one '
            f'process per device: torchrun --nproc-per-node=N)')
    return _device_mesh(device.type, (n_dp, n_cores), ('dp', 'cores'))


def shot_sharding(mesh: DeviceMesh) -> tuple:
    """The placements of ``[shots, ...]`` arrays on ``mesh``: shots
    sharded over ``'dp'``, replicated over the other axis."""
    return (Shard(0), Replicate())


def serving_devices(n: int = None, devices=None) -> list:
    """The devices the serve tier shards its per-device executors over:
    this process's CUDA devices (or ``devices``), the first ``n`` of
    them; asking for more than there are raises."""
    devs = list(devices) if devices is not None else [
        torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    if n is not None:
        if not 1 <= n <= len(devs):
            raise ValueError(
                f'requested {n} serving devices; this process sees '
                f'{len(devs)}')
        devs = devs[:n]
    return devs


def axis(mesh: DeviceMesh, name: str) -> tuple:
    """``(size, index, group)`` of this rank on mesh axis ``name``."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(name), mesh.get_group(name)


def gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tiled all-gather: every rank's ``x`` of ``group``
    concatenated along ``dim`` in rank order.  Counts its calls and the
    bytes it returns in ``gather_cat.calls`` / ``gather_cat.bytes``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    gather_cat.calls += 1
    gather_cat.bytes += n * x.numel() * x.element_size()
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


gather_cat.calls = 0
gather_cat.bytes = 0


def psum(tree: dict, group) -> dict:
    """Sum every tensor of ``tree`` over the ranks of ``group`` (in
    place; integer sums are exact)."""
    if dist.get_world_size(group) > 1:
        for v in tree.values():
            dist.all_reduce(v, group=group)
    return tree


def all_ranks(mask: torch.Tensor, group) -> torch.Tensor:
    """Elementwise ``all()`` of a bool tensor over the ranks of
    ``group``."""
    if dist.get_world_size(group) == 1:
        return mask
    m = mask.to(torch.uint8)
    dist.all_reduce(m, op=dist.ReduceOp.MIN, group=group)
    return m.bool()
