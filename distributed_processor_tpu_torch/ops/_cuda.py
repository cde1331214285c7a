"""Build and load this package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``distributed_processor_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, and loaded with ``ctypes``; a changed source
builds anew.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(_PKG, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')


def _nvcc() -> str:
    path = shutil.which('nvcc')
    if path is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build on a '
                           'host with the CUDA toolkit')
    return path


def sources() -> list:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu'))


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed on its content."""
    with open(os.path.join(CSRC, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f'{name}-{digest}.so')


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    library path.  The output is renamed into place only when complete,
    so a concurrent or interrupted build never leaves a torn library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
           '-o', tmp, os.path.join(CSRC, name + '.cu')]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}.cu:\n{res.stderr}')
        if verbose:
            print(res.stderr, end='')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(build(name))
