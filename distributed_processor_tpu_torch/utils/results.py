"""Sweep-result checkpointing.

The reference has no result persistence (CompiledProgram.save is
stubbed upstream; results live on the host); long sharded sweeps here
need resumable accumulation.  Results are stored as compressed npz
archives with a manifest, written atomically so an interrupted sweep
never leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch


def host_array(value) -> np.ndarray:
    """``value`` as a host numpy array: a tensor on any device is copied
    to the host first (``np.asarray`` refuses a CUDA tensor), anything
    else goes through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_results(path: str, results: dict, meta: dict = None) -> None:
    """Atomically save a dict of arrays (+ JSON-able metadata)."""
    arrays = {}
    for k, v in results.items():
        if k.startswith('_'):
            continue
        arrays[k] = np.asarray(v)
    if meta is not None:
        arrays['__meta__'] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_results(path: str) -> tuple[dict, dict]:
    """Load a checkpoint -> (arrays dict, metadata dict)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != '__meta__'}
        meta = {}
        if '__meta__' in z.files:
            meta = json.loads(bytes(z['__meta__']).decode())
    return arrays, meta


def quarantine_checkpoint(path: str) -> str:
    """Move an unreadable checkpoint aside as ``<path>.corrupt-<n>``.

    The rename keeps the evidence (for post-mortem CRC inspection)
    while freeing ``path`` for a clean restart; ``<n>`` counts up so
    repeated corruption never overwrites an earlier specimen.
    """
    n = 0
    while os.path.exists(f'{path}.corrupt-{n}'):
        n += 1
    dest = f'{path}.corrupt-{n}'
    os.replace(path, dest)
    return dest


class SweepAccumulator:
    """Accumulate per-batch sweep statistics with periodic checkpoints.

    ``add`` sums array leaves across batches (counts, histograms);
    ``checkpoint_every`` batches a checkpoint is written; ``resume``
    picks up the accumulated state + next batch index.
    """

    def __init__(self, path: str = None, checkpoint_every: int = 0,
                 meta: dict = None):
        self.path = path
        self.checkpoint_every = checkpoint_every
        self.state: dict = {}
        self.n_batches = 0
        # caller-defined identity (batch size, keys, program fingerprint
        # ...) persisted with the checkpoint so a resume can validate it
        self.meta = dict(meta or {})

    def add(self, batch_stats: dict) -> None:
        self.add_span(batch_stats, 1)

    def add_span(self, span_stats: dict, n_batches: int) -> None:
        """Fold an already-summed span of ``n_batches`` batches.

        ``checkpoint_every`` stays in BATCH units; with spans the write
        happens when the accumulated batch count CROSSES a multiple of
        it (checkpoints snap to span edges).  For ``n_batches == 1``
        this is exactly ``add``'s write-on-multiple behavior.
        """
        if n_batches < 1:
            raise ValueError(f'span must cover >= 1 batches, '
                             f'got {n_batches}')
        for k, v in span_stats.items():
            v = np.asarray(v)
            self.state[k] = self.state.get(k, 0) + v
        prev = self.n_batches
        self.n_batches += n_batches
        if self.path and self.checkpoint_every and \
                self.n_batches // self.checkpoint_every \
                > prev // self.checkpoint_every:
            self.save()

    def save(self) -> None:
        save_results(self.path, self.state,
                     meta={'n_batches': self.n_batches, **self.meta})

    @classmethod
    def resume(cls, path: str, checkpoint_every: int = 0,
               meta: dict = None, strict: bool = False) -> 'SweepAccumulator':
        """Load the checkpoint at ``path`` (fresh accumulator if absent).

        With ``meta`` given, a checkpoint whose stored identity differs
        raises — field by field, naming exactly what diverged — instead
        of silently mixing incompatible accumulations.  A checkpoint
        with *no* stored identity (written before fingerprinting, or by
        an older fingerprint version) is treated as legacy: accepted
        with a warning rather than rejected, since there is nothing to
        compare against.  ``strict=True`` upgrades both legacy paths to
        hard errors — no identity and no version skew are tolerated, so
        fields whose representation changed between fingerprint versions
        (and would otherwise be skipped with a warning) can never smuggle
        a different sweep past validation.

        A checkpoint that cannot be PARSED at all (truncated zip,
        bit-flipped npz member, mangled manifest) is quarantined: the
        file is renamed to ``<path>.corrupt-<n>`` and a fresh
        accumulator is returned with a warning, so a long campaign
        restarts cleanly instead of crashing on unreadable state.
        ``strict=True`` raises instead (nothing is renamed).
        """
        if strict and meta is None:
            raise ValueError(
                'strict=True requires meta (the identity to validate '
                'against) — without it strict resume would be a silent '
                'no-op')
        acc = cls(path, checkpoint_every, meta=meta)
        if os.path.exists(path):
            try:
                arrays, stored = load_results(path)
            except (zipfile.BadZipFile, zlib.error, ValueError, KeyError,
                    OSError, EOFError, json.JSONDecodeError) as e:
                # torn/bit-flipped checkpoint (atomic writes make this
                # rare — disk corruption, not interruption): losing the
                # accumulated batches is recoverable, crashing a
                # million-shot campaign on an unreadable file is not
                if strict:
                    raise ValueError(
                        f'strict resume: checkpoint {path} is unreadable '
                        f'({type(e).__name__}: {e})') from e
                import warnings
                dest = quarantine_checkpoint(path)
                warnings.warn(
                    f'checkpoint {path} is unreadable '
                    f'({type(e).__name__}: {e}); quarantined to {dest} '
                    f'and restarting the sweep from batch 0',
                    stacklevel=2)
                return acc
            acc.state = dict(arrays)
            acc.n_batches = int(stored.pop('n_batches', 0))
            if meta is not None:
                import warnings
                want_ver = acc.meta.get('fingerprint_version')
                have_ver = stored.get('fingerprint_version')
                if strict and (not stored or have_ver != want_ver):
                    raise ValueError(
                        f'strict resume: checkpoint {path} has '
                        f'fingerprint version {have_ver if stored else None}'
                        f' but this sweep requires {want_ver} — '
                        f'version-skewed/unfingerprinted checkpoints are '
                        f'rejected under strict=True')
                if not stored:
                    warnings.warn(
                        f'checkpoint {path} carries no identity — '
                        f'resuming without validation', stacklevel=2)
                    diff = []
                elif have_ver != want_ver:
                    # version skew: still validate the overlap whose
                    # representation is format-stable (same JSON type in
                    # both versions — batch/key/crcs survive any version;
                    # a field whose format changed, e.g. repr-string ->
                    # dict, is skipped with a warning, not failed)
                    shared = (set(stored) & set(acc.meta)) \
                        - {'fingerprint_version'}
                    comparable = {k for k in shared
                                  if type(stored[k]) is type(acc.meta[k])}
                    skipped = sorted((set(stored) ^ set(acc.meta)
                                      | (shared - comparable))
                                     - {'fingerprint_version'})
                    warnings.warn(
                        f'checkpoint {path} has fingerprint version '
                        f'{have_ver} (current {want_ver}); fields '
                        f'{skipped or "(none)"} not validated',
                        stacklevel=2)
                    diff = [k for k in sorted(comparable)
                            if stored[k] != acc.meta[k]]
                else:
                    diff = sorted(set(stored) ^ set(acc.meta)) + \
                        [k for k in sorted(set(stored) & set(acc.meta))
                         if stored[k] != acc.meta[k]]
                if diff:
                    detail = {k: (stored.get(k, '<absent>'),
                                  acc.meta.get(k, '<absent>'))
                              for k in diff}
                    raise ValueError(
                        f'checkpoint {path} was written by a '
                        f'different sweep; differing fields '
                        f'(stored, requested): {detail}')
        return acc
