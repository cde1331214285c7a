"""Multi-tenant compile front door: a content-addressed cache from
program source (dict-instruction list or OpenQASM 3 text) to compiled
:class:`~..decoder.MachineProgram`.

See docs/COMPILE_CACHE.md for the key anatomy, epoch invalidation
rules, singleflight semantics and the persistence format.
"""

from .cache import CompileCache, default_cache, DISK, HIT, MISS, WAIT
from .key import (KEY_VERSION, canonical_json, canonical_program,
                  content_key, machine_program_bytes)
from .store import PersistentStore, STORE_VERSION

__all__ = [
    'CompileCache', 'default_cache', 'HIT', 'DISK', 'MISS', 'WAIT',
    'KEY_VERSION', 'canonical_json', 'canonical_program', 'content_key',
    'machine_program_bytes', 'PersistentStore', 'STORE_VERSION',
]
