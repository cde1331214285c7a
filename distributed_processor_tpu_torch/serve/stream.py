"""Streaming traffic class: long-lived QEC round sessions.

The serving counterpart of :func:`~..sim.interpreter.simulate_rounds`
(docs/SERVING.md "Streaming sessions"): a :class:`StreamSession` is a
long-lived handle over one program whose round chunks dispatch as one
``simulate_rounds`` call each — R rounds as ``R x B`` lanes of one
engine call plus the in-loop decode — instead of R one-shot submissions
each paying the per-call floor.

Round chunks ride the ORDINARY request lifecycle: each
``submit_rounds`` is one :class:`~.request.Request` with ``rounds``
set, so deadlines (honored at scan-chunk boundaries), retry/steal
under the attempt-token machinery, priority lanes, and overload
control all apply unchanged — a chaos kill of the home executor
retries the chunk elsewhere with a fresh token and the stale dispatch
cannot double-complete it (no lost or duplicated round results).
Stickiness comes from the routing key: every chunk of a session
shares one :class:`StreamKey`, so the bucket-affinity router pins the
whole session to a home executor.

``StreamSession`` is generic over its target: anything exposing
``submit_rounds`` / ``close_stream`` (the in-process
:class:`~.service.ExecutionService` here) serves it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StreamKey:
    """Routing/coalescing key for one stream session's chunks.

    Unlike the shape-keyed :class:`~.bucketspec.BucketSpec`, a stream
    key is SESSION-keyed: every chunk of session ``sid`` hashes to the
    same key regardless of its round count, so the affinity router
    pins the whole session to one home executor (chunks of different
    round counts still share the home; each dispatch binds its own
    ``cfg.rounds``).  Carries the same
    attribute surface the service's bucket bookkeeping touches
    (``n_cores`` / ``n_instr_bucket`` / ``cfg`` / ``label()``)."""
    sid: int
    n_cores: int
    n_instr_bucket: int
    cfg: object

    def label(self) -> str:
        return f'stream{self.sid}c{self.n_cores}i{self.n_instr_bucket}'


class StreamSession:
    """One open stream: submit round chunks, read incremental results.

    Not thread-safe for concurrent ``submit_rounds`` calls (one
    producer per session — the hardware analogue is one readout
    stream); results may be consumed from another thread.

    ``submit_rounds(meas_bits)`` takes ``[rounds, n_shots, n_cores,
    n_meas]`` and returns the chunk's
    :class:`~.request.RequestHandle` immediately; :meth:`results`
    yields completed chunk results in submission order (each the
    :func:`~..sim.interpreter.simulate_rounds` pytree — leading round
    axis per leaf, plus ``syndrome_hist``/``decoded`` when the session
    decodes).  :meth:`close` drains outstanding chunks, deregisters
    the session, and returns a summary — including the full-history
    decode over every chunk's syndrome when a decode spec is bound.
    """

    def __init__(self, target, mp, sid: int, *, cfg=None, decode=None,
                 round_deadline_ms: float = None, priority: int = 0,
                 fault_mode: str = None, tenant: str = None):
        self._target = target
        self.mp = mp
        self.sid = sid
        self.cfg = cfg
        self.decode = decode
        self.round_deadline_ms = round_deadline_ms
        self.priority = priority
        self.fault_mode = fault_mode
        # tenant identity is a SESSION property: every chunk inherits
        # it (docs/SERVING.md "Tenants"), so a stream's rounds are
        # metered and fair-queued under the tenant that opened it
        self.tenant = tenant
        self._chunks = []          # (rounds, handle) in submit order
        self._yielded = 0
        self._closed = False

    # -- producer side ---------------------------------------------------

    def submit_rounds(self, meas_bits, init_regs=None):
        """Queue one R-round chunk; returns its handle immediately.
        The chunk deadline (when the session has a per-round deadline)
        is ``rounds * round_deadline_ms`` — deadlines are honored at
        scan-chunk boundaries, the scan itself is uninterruptible."""
        if self._closed:
            raise RuntimeError(f'stream {self.sid} is closed')
        meas_bits = np.asarray(meas_bits, np.int32)
        handle = self._target.submit_rounds(
            self.mp, meas_bits, init_regs=init_regs, cfg=self.cfg,
            decode=self.decode, priority=self.priority,
            round_deadline_ms=self.round_deadline_ms,
            fault_mode=self.fault_mode, stream=self.sid,
            tenant=self.tenant)
        self._chunks.append((int(meas_bits.shape[0]), handle))
        return handle

    # -- consumer side ---------------------------------------------------

    @property
    def rounds_submitted(self) -> int:
        return sum(r for r, _ in self._chunks)

    def results(self, timeout: float = None):
        """Yield chunk results not yet consumed, in submission order
        (the incremental round-result frames).  Blocks up to
        ``timeout`` seconds PER CHUNK; a failed chunk re-raises its
        typed error here, exactly like ``handle.result()``."""
        while self._yielded < len(self._chunks):
            _, handle = self._chunks[self._yielded]
            res = handle.result(timeout)
            self._yielded += 1
            yield res

    def close(self, timeout: float = None) -> dict:
        """Drain every outstanding chunk, deregister the session with
        the target, and return the session summary: chunk/round
        counts, per-chunk fault words... and, when the session binds a
        decode spec, the FULL-history decode — every chunk's syndrome
        history concatenated along the round axis and decoded once
        (the streaming equivalent of one giant ``simulate_rounds``
        decode)."""
        if self._closed:
            raise RuntimeError(f'stream {self.sid} is already closed')
        errors = []
        results = []
        for _, handle in self._chunks:
            try:
                results.append(handle.result(timeout))
            except Exception as exc:   # noqa: BLE001 - summarize, re-raise typed
                errors.append(exc)
        self._closed = True
        self._target.close_stream(self.sid)
        summary = {
            'sid': self.sid,
            'chunks': len(self._chunks),
            'rounds': self.rounds_submitted,
            'failed_chunks': len(errors),
            'errors': errors,
        }
        hists = [np.asarray(r['syndrome_hist']) for r in results
                 if 'syndrome_hist' in r]
        if hists and self.decode is not None:
            from ..ops.decode import as_decode_spec, decode_history
            hist = np.concatenate(hists, axis=1)   # [B, R_total, K]
            summary['syndrome_hist'] = hist
            summary['decoded'] = np.asarray(decode_history(
                hist, as_decode_spec(self.decode).scheme))
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        if not self._closed:
            self.close()
