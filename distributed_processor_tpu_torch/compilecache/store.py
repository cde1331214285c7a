"""On-disk persistent tier of the compile cache.

One zlib-compressed pickle per entry, version-stamped like the sweep
checkpoint format (``parallel/driver.py`` fingerprints, the
``utils/results.py`` corrupt-tolerant load): a payload dict carries a
magic string, a format version, the content key, the qchip calibration
fingerprint and the :class:`~..decoder.MachineProgram` itself.  Writes
are atomic (tmp + ``os.replace``, the ``save_results`` discipline), so
a killed process can never leave a half-written entry that a later
process trusts.  Any load failure — corrupt zlib stream, truncated
pickle, version skew, key mismatch — is a MISS, never an exception:
the cache recompiles and overwrites.

Format v2 adds an integrity digest (docs/ROBUSTNESS.md "Integrity"):
the MachineProgram is pickled separately and stored alongside a CRC32
of those exact bytes, verified before unpickling on load.  The outer
zlib stream has its own adler32, but that only covers the compressed
blob on THIS read — the digest pins the program content across the
store's whole shared-warm-tier lifetime (an entry written by one
replica and mmap'd, copied, or rsync'd to another still proves out).
A digest mismatch counts ``integrity.store_digest_fail`` and is the
usual remove+miss.  v1 entries fail the version check and recompile —
the standard skew path, no migration needed.

The filename encodes ``<content-key>-<qchip-fp[:16]>.mpc`` so epoch
invalidation can unlink exactly one calibration epoch's entries
without deserializing anything.
"""

from __future__ import annotations

import glob
import os
import pickle
import zlib

from ..integrity import content_crc32
from ..utils import profiling

STORE_MAGIC = 'dproc-compilecache'
STORE_VERSION = 2
_SUFFIX = '.mpc'


class PersistentStore:
    """Directory-backed entry store; every method is process-safe in
    the crash sense (atomic writes, tolerant reads) — cross-process
    LOCKING is not attempted: two processes racing the same key both
    write valid identical entries and one ``os.replace`` wins."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _fname(self, key: str, qchip_fp: str) -> str:
        return os.path.join(self.path, f'{key}-{qchip_fp[:16]}{_SUFFIX}')

    def load(self, key: str, qchip_fp: str):
        """The MachineProgram for ``key``, or None (miss/corrupt/skew)."""
        fname = self._fname(key, qchip_fp)
        try:
            with open(fname, 'rb') as f:
                payload = pickle.loads(zlib.decompress(f.read()))
            if (payload.get('magic') != STORE_MAGIC
                    or payload.get('version') != STORE_VERSION
                    or payload.get('key') != key):
                raise ValueError('version/key skew')
            blob = payload['mp_pickle']
            if content_crc32((blob,)) != payload['crc']:
                profiling.counter_inc('integrity.store_digest_fail')
                raise ValueError('store entry digest mismatch')
            return pickle.loads(blob)
        except FileNotFoundError:
            return None
        except (OSError, zlib.error, pickle.UnpicklingError, EOFError,
                ValueError, KeyError, AttributeError, ImportError,
                IndexError):
            # corrupt or stale-format entry: drop it so the rewrite
            # after recompile starts clean
            try:
                os.remove(fname)
            except OSError:
                pass
            return None

    def save(self, key: str, qchip_fp: str, mp) -> None:
        mp_pickle = pickle.dumps(mp, protocol=pickle.HIGHEST_PROTOCOL)
        payload = {'magic': STORE_MAGIC, 'version': STORE_VERSION,
                   'key': key, 'qchip_fp': qchip_fp,
                   'mp_pickle': mp_pickle,
                   'crc': content_crc32((mp_pickle,))}
        blob = zlib.compress(pickle.dumps(payload))
        fname = self._fname(key, qchip_fp)
        tmp = fname + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(blob)
        os.replace(tmp, fname)

    def invalidate_epoch(self, qchip_fp: str) -> int:
        """Unlink every entry written under this calibration epoch;
        returns how many files were removed."""
        n = 0
        pattern = os.path.join(self.path, f'*-{qchip_fp[:16]}{_SUFFIX}')
        for fname in glob.glob(pattern):
            try:
                os.remove(fname)
                n += 1
            except OSError:
                pass
        return n

    def clear(self) -> int:
        n = 0
        for fname in glob.glob(os.path.join(self.path, f'*{_SUFFIX}')):
            try:
                os.remove(fname)
                n += 1
            except OSError:
                pass
        return n
