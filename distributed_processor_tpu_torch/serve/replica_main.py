"""Replica entry point: one ExecutionService process on the fleet wire.

``python -m distributed_processor_tpu_torch.serve.replica_main '<json>'``
boots one replica of the fleet (docs/FLEET.md): it applies the
environment knobs from the config before torch touches them, builds an
:class:`~.service.ExecutionService` from the ``service`` kwargs, wraps
it in a :class:`~.transport.ReplicaServer`, and prints one JSON ready
line (``{"ready": true, "port": ..., "pid": ...}``) on stdout so the
spawning :class:`~.fleet.Fleet` learns the bound port without a port
race.  It then blocks until a ``shutdown`` wire op or SIGTERM arrives.

Config schema (all keys optional)::

    {
      "env":          {"CUDA_VISIBLE_DEVICES": "0",
                       "OMP_NUM_THREADS": "1"},
      "interp_cfg":   {"max_steps": 192, ...},   # InterpreterConfig
      "service":      {"devices": ["cpu"], "compile_cache_dir": ...,
                       "warmup_catalog": ..., ...},
      "host": "127.0.0.1", "port": 0, "rid": "r0"
    }

``compile_cache_dir`` / ``warmup_catalog`` are the shared warm tiers:
pointing every replica of a fleet at the same directories means a
freshly respawned replica replays its warm-up from what its PEERS
served and persisted — the zero-cold-restart property the fleet tests
assert.  The JAX package's ``jax_cache_dir`` key has no counterpart
here: the built CUDA kernels live in the checkout's build directory
(``ops/_cuda.py``), keyed on each source's hash and shared by every
process of the checkout, so a replica whose parent built them runs no
``nvcc``.  Without ``devices`` the service is one executor on the card.

The environment: a :class:`~.fleet.Fleet` puts ``env`` into the child's
environment before the interpreter starts, so torch imports under it.
A replica booted by hand imports torch with the package before
:func:`main` runs; :func:`main` then applies ``env`` before CUDA
initialises (``CUDA_VISIBLE_DEVICES`` is read then) and sets torch's
thread count from ``OMP_NUM_THREADS``.

Observability env knobs (config keys win when both are set):
``DPROC_TRACE_SAMPLE`` sets the service's local ``trace_sample`` and
``DPROC_FLIGHT_DIR`` its ``flight_dump_dir`` — note the fleet router's
sampling decision arrives ON THE WIRE per request regardless of the
local rate (docs/OBSERVABILITY.md "Fleet observability").
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    cfg = json.loads(argv[1]) if len(argv) > 1 and argv[1] else {}

    # environment first: the visible cards are read when CUDA
    # initialises, which nothing has done yet; torch read the thread
    # count at import, so it is set again here
    env = {k: str(v) for k, v in (cfg.get('env') or {}).items()}
    os.environ.update(env)
    import torch
    if 'CUDA_VISIBLE_DEVICES' in env and torch.cuda.is_initialized():
        raise RuntimeError('CUDA initialised before the replica applied '
                           'CUDA_VISIBLE_DEVICES')
    if env.get('OMP_NUM_THREADS'):
        torch.set_num_threads(int(env['OMP_NUM_THREADS']))

    from ..sim.interpreter import InterpreterConfig
    from .service import ExecutionService
    from .transport import ReplicaServer

    icfg = None
    if cfg.get('interp_cfg'):
        icfg = InterpreterConfig(**cfg['interp_cfg'])
    skw = dict(cfg.get('service') or {})
    # observability env knobs (config wins; env covers replicas booted
    # outside Fleet, e.g. by hand against a remote router)
    if os.environ.get('DPROC_TRACE_SAMPLE'):
        skw.setdefault('trace_sample',
                       float(os.environ['DPROC_TRACE_SAMPLE']))
    if os.environ.get('DPROC_FLIGHT_DIR'):
        skw.setdefault('flight_dump_dir',
                       os.environ['DPROC_FLIGHT_DIR'])
    svc = ExecutionService(icfg, name=cfg.get('rid'), **skw)

    stop = threading.Event()
    server = ReplicaServer(svc, host=cfg.get('host', '127.0.0.1'),
                           port=int(cfg.get('port', 0)),
                           on_shutdown=stop.set)
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())

    print(json.dumps({'ready': True, 'rid': cfg.get('rid'),
                      'host': server.address[0],
                      'port': server.address[1],
                      'pid': os.getpid()}), flush=True)
    stop.wait()
    server.close()
    svc.shutdown(drain=False)
    return 0


if __name__ == '__main__':
    sys.exit(main())
