"""What every lane of a run should hold, worked out by the scalar oracle.

A lane is one shot (or one round of one shot) of one program.  Its
outcome is a function of its inputs alone: the initial qubit states of
a physics-closed shot, or the injected bits its fproc and LUT reads
consume.  So the oracle runs once per distinct input pattern that a run
used, and its per-core results are gathered to every lane of that
pattern.  The tables are numpy; the gather and the comparison run in
plain torch wherever the program's outputs are.
"""

from __future__ import annotations

import numpy as np

from .oracle import run_oracle

# leaves compared as "nonzero": the port's error and fault words against
# the oracle's error list (no fault code exists in the oracle: none is due)
FLAG_KEYS = ('err', 'fault')


# an unfired measurement slot's time: never available
NEVER = 2 ** 31 - 1


def _pad(rows, width: int, fill: int = 0) -> np.ndarray:
    out = np.full((len(rows), width), fill, np.int64)
    for i, r in enumerate(rows):
        r = list(r)[:width]
        out[i, :len(r)] = r
    return out


def _window_samples(mp, core: int, pulse: dict) -> int:
    """DAC samples of a readout window: the envelope's samples times the
    element's interpolation (the envelope word's length field counts
    groups of 4 samples)."""
    length = (pulse['env'] >> 12) & 0xfff
    ecfg = mp.tables[core].elem_cfgs[pulse['elem']]
    return length * 4 * int(ecfg.interp_ratio)


def lane_record(mp, o: dict, max_meas: int, max_resets: int,
                meas_elem: int = 2) -> dict:
    """One oracle run as per-core arrays under the port's output names."""
    C = mp.n_cores
    n_meas = np.array([len(m) for m in o['meas_avail']])
    rec = dict(
        n_pulses=np.array([len(p) for p in o['pulses']]),
        n_meas=n_meas,
        n_resets=np.array([len(r) for r in o['resets']]),
        time=o['time'], qclk=o['qclk'], offset=o['offset'], pc=o['pc'],
        done=o['done'].astype(np.int64),
        err=np.array([int(len(e) > 0) for e in o['err']]),
        fault=np.zeros(C, np.int64),
        regs=o['regs'],
        rst_time=_pad(o['resets'], max_resets),
        meas_avail=_pad(o['meas_avail'], max_meas, NEVER),
        meas_gtime=_pad(o['meas_time'], max_meas),
        meas_time=_pad(o['meas_time'], max_meas, NEVER),
        meas_state=_pad(o['meas_state'], max_meas),
        meas_bits=_pad(o['meas_state'], max_meas),
        meas_bits_valid=(np.arange(max_meas)[None, :]
                         < n_meas[:, None]).astype(np.int64),
        qturns=o['qturns'],
        retired=o['retired'],
        window_samples=np.array([sum(
            _window_samples(mp, c, p) for p in o['pulses'][c]
            if p['elem'] == meas_elem) for c in range(C)]),
    )
    return {k: np.asarray(v, np.int64) for k, v in rec.items()}


def _stack(recs: list) -> dict:
    return {k: np.stack([r[k] for r in recs]) for k in recs[0]}


def physics_table(mp, patterns: np.ndarray, max_meas: int, max_resets: int,
                  x90_amp: int, feedback: bool = True) -> dict:
    """Per-core outcomes ``[P, C, ...]`` of physics-closed shots from the
    initial-state ``patterns [P, C]`` (0/1)."""
    recs = [lane_record(mp, run_oracle(mp, init_states=p, x90_amp=x90_amp,
                                       feedback=feedback),
                        max_meas, max_resets)
            for p in np.asarray(patterns)]
    return _stack(recs)


def state_codes(states) -> 'torch.Tensor':
    """``[N, C]`` 0/1 states -> ``[N]`` integer codes (core c is bit c)."""
    import torch
    w = (1 << torch.arange(states.shape[-1], device=states.device))
    return (states.to(torch.int64) * w).sum(-1)


def code_patterns(codes, C: int) -> np.ndarray:
    """Integer codes -> ``[P, C]`` 0/1 patterns (core c is bit c)."""
    codes = np.asarray(codes, np.int64)
    return ((codes[:, None] >> np.arange(C)[None, :]) & 1).astype(np.int64)


class InjectedTable:
    """Per-core outcomes of injected-bits lanes of one program, memoized
    by the bits the lane's reads consume.

    The read set is found by a run on zero bits and checked on every
    pattern: a pattern whose run reads another set raises, since its
    lanes would then depend on bits the key leaves out."""

    def __init__(self, mp, oracle_kw: dict, max_meas: int, max_resets: int,
                 feedback: bool = True):
        self.mp, self.kw = mp, dict(oracle_kw, feedback=True)
        self.max_meas, self.max_resets = max_meas, max_resets
        self.feedback = feedback
        zero = np.zeros((mp.n_cores, max_meas), np.int64)
        self.reads = run_oracle(mp, meas_bits=zero, **self.kw)['consumed']
        self.recs = {}

    def codes(self, bits) -> 'torch.Tensor':
        """``bits [..., C, M]`` (torch) -> integer codes ``[...]`` of the
        consumed positions."""
        import torch
        code = torch.zeros(bits.shape[:-2], dtype=torch.int64,
                           device=bits.device)
        for j, (c, m) in enumerate(self.reads):
            code |= bits[..., c, m].to(torch.int64) << j
        return code

    def table(self, codes) -> dict:
        """The stacked records ``[P, C, ...]`` of ``codes`` (numpy ints)."""
        recs = []
        for code in np.asarray(codes, np.int64):
            code = int(code)
            if code not in self.recs:
                bits = np.zeros((self.mp.n_cores, self.max_meas), np.int64)
                for j, (c, m) in enumerate(self.reads):
                    bits[c, m] = (code >> j) & 1
                o = run_oracle(self.mp, meas_bits=bits,
                               **dict(self.kw, feedback=self.feedback))
                if self.feedback and o['consumed'] != self.reads:
                    raise RuntimeError(
                        f'the read set depends on the bits: {o["consumed"]} '
                        f'against {self.reads}')
                self.recs[code] = lane_record(self.mp, o, self.max_meas,
                                              self.max_resets)
            recs.append(self.recs[code])
        return _stack(recs)


def compare(got: dict, table: dict, idx, keys) -> dict:
    """Lanes of ``got`` (torch, leading lane axes like ``idx``) that differ
    from ``table[k][idx]`` on each key: ``{key: mismatching lanes}`` and,
    under ``'any'``, the lanes that differ on any key."""
    import torch
    dev = idx.device
    any_bad = torch.zeros(idx.shape, dtype=torch.bool, device=dev)
    counts = {}
    for k in keys:
        want = torch.as_tensor(table[k], device=dev)[idx]
        g = got[k].to(dev)
        if k in FLAG_KEYS:
            g = g != 0
        bad = (g.to(torch.int64) != want)
        bad = bad.reshape(idx.shape + (-1,)).any(-1)
        counts[k] = int(bad.sum())
        any_bad |= bad
    counts['any'] = int(any_bad.sum())
    return counts
