"""The exact ensemble the port's statevec trajectories are held to: the
density matrix of a program's pulse schedule.

A frozen copy of the port's ``sim/density_reference.py`` that reads the
schedule from :mod:`.oracle` (the benchmark's own frozen oracle) and
imports nothing of the port; the channel parameters come from the
configuration's file (:func:`channels_from_config`).

The port's ``statevec`` device (docs/PHYSICS.md "Entangling model")
evolves one state vector per shot as a quantum trajectory: its
noise channels are sampled jumps and its measurements sampled
collapses.  The average over shots of such a trajectory is the channel
each sampling unravels, applied to the density matrix.  This module
applies those channels directly, in plain torch (float64 and
complex128), so that a batch's histogram of outcomes can be held
against an exact distribution.  The schedule comes from the scalar
oracle (:func:`.oracle.run_oracle`), pulse by pulse, with its trigger
times, frequency, phase and amplitude words.

The channels, in the trajectory's order at each trigger time (stage
order for pulses with equal triggers: 1q drives, couplings, reads):

* over the gap since a core's previous pulse (from ``INIT_TIME``), at
  each of its own drive or readout pulses: detuning precession about z,
  amplitude damping ``gamma = 1 - exp(-dt / T1)`` and pure dephasing
  (a Z with probability ``(1 - exp(-dt (1/T2 - 1/(2 T1)))) / 2``);
* a 1q drive: ``exp(-i theta/2 (cos phi X + sin phi Y))`` with
  ``theta = (pi/2) amp / x90_amp`` and ``phi`` the phase word, then the
  depolarizing channel ``(1 - p) rho + p/3 (X rho X + Y rho Y + Z rho Z)``;
* a drive whose (core, frequency word) matches a coupling: ZX
  ``exp(-i theta/2 Z_c (cos phi X_t + sin phi Y_t))`` (``theta = (pi/2)
  amp / zx90_amp``) or ZZ ``exp(-i theta/2 Z_c Z_t)``, then the 2q
  Pauli channel ``(1 - p2) rho + p2/15 sum_{P != II} P rho P``;
* a read: the projective measurement in Z.  A read whose bit the
  program consumes (an fproc read; the active reset's feed-forward) is a
  branch: each outcome continues with its projected, unnormalized
  matrix along the schedule the oracle gives for that outcome.
  Branches whose remaining schedules are equal, which hold no consumed
  read ahead and whose open gaps start at the same times, are summed
  into one.  Any other read dephases the core in Z.

Each local operator acts on the matrix reshaped to ``(2,) * 2C`` axes,
never as a dense ``2^C x 2^C`` product.  Basis: core ``c`` is bit
``C - 1 - c`` of the matrix index, as in the trajectory's ``psi``;
distributions are indexed by packed bits, core ``c`` bit ``c``, as the
reduce's ``outcome_counts`` bins them.

What this reference leaves out, and how it stands to the trajectories:

* Readout assignment: the reference returns the projective outcome.
  The port discriminates each window through the readout chain; at the
  benchmark's ``sigma = 0.05`` with the default ``g0 = 1``,
  ``g1 = -0.6 + 0.8i`` and a 1024-sample readout window the decision
  margin is ``|g1 - g0| sqrt(E) / (2 sigma) = 1.79 x 32 / 0.1 ~ 570``
  standard deviations, so a misassignment has probability below
  ``Q(570) < 1e-10000``: none in any number of shots a run can take.
* Leakage, seepage and IQ-level leakage readout are not modelled (the
  reference raises where the configuration enables them).
* Decay is lumped at a core's own pulses, as the trajectory lumps it:
  a coupling pulse acts on its target without first bringing the
  target's gap to the pulse's trigger.  That is the trajectory model's
  convention, and the reference keeps it so that it computes the same
  ensemble; continuous-time damping of the target would differ in the
  order of the damping and the interaction.
* Pulses with equal triggers apply in stage order.  The trajectory
  applies them in the order of its engine steps, which is the stage
  order when they co-fire in one step; non-commuting co-fires are the
  ``ERR_COFIRE_ORDER`` the interpreter flags.
* A requested read must be its core's last event, and no later
  coupling may target it (else the Z populations read at the end would
  not be the ones measured); the reference raises otherwise.

The benchmark's precision control (beside the port's copy, which has
none): channels with a ``held`` dtype (:func:`held_in`) round the
matrix's real and imaginary parts to it after every channel, the
reference computed at that precision.  Its probabilities then need not
sum to 1: what rounding lost of the trace is the reading.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .oracle import INIT_TIME, run_oracle

# width of the pulse phase word (the 17-bit phase field of the ISA)
PHASE_BITS = 17
_F64, _C128 = torch.float64, torch.complex128


def channels_from_config(config: dict, couplings: tuple,
                         n_cores: int) -> dict:
    """The channel parameters of a configuration's ``device`` and
    ``readout`` sections (a statevec device) with its coupling map:
    per-core per-clock rates in float64 and the scalars the trajectory
    reads."""
    d, r = config['device'], config['readout']
    if d['kind'] != 'statevec':
        raise ValueError(f'the density reference models the statevec '
                         f'device; got {d["kind"]!r}')
    if any(float(d.get(k, 0.0)) for k in
           ('leak_per_pulse', 'leak2_per_pulse', 'seep_per_pulse')):
        raise NotImplementedError('the density reference has no leakage '
                                  'levels')
    clk = float(d.get('clk_period_s', 2e-9))

    def per_core(v):
        return np.broadcast_to(np.asarray(v, np.float64),
                               (n_cores,)).astype(np.float64)

    def inv(t):
        t = per_core(math.inf if t is None else t)
        with np.errstate(divide='ignore'):
            return np.where(np.isinf(t), 0.0, clk / t)
    return dict(p1_init=per_core(r['p1_init']), x90_amp=int(r['x90_amp']),
                drive_elem=int(r['drive_elem']),
                meas_elem=int(r['meas_elem']),
                couplings=tuple(tuple(cp) for cp in couplings),
                zx90_amp=float(d['zx90_amp']), zz90_amp=float(d['zz90_amp']),
                det=per_core(d.get('detuning_hz', 0.0)) * clk,
                inv_t1=inv(d.get('t1_s')), inv_t2=inv(d.get('t2_s')),
                depol=float(d.get('depol_per_pulse', 0.0)),
                depol2=float(d.get('depol2_per_pulse', 0.0)))


def held_in(ch: dict, dtype) -> dict:
    """The channels ``ch`` with the matrix held at the real ``dtype``
    (``torch.float16`` for a complex32 state) after every channel."""
    return dict(ch, held=dtype)


def _held(rho, ch: dict):
    """``rho`` rounded in place to ``ch['held']`` (none: unrounded)."""
    h = ch.get('held')
    if h is not None:
        r = torch.view_as_real(rho)
        r.copy_(r.to(h))
    return rho


# ---- the schedule ---------------------------------------------------------

def _oracle_schedule(mp, ch: dict, record: dict, n_slots: int) -> tuple:
    """``(events, consumed)`` of the oracle's run with the injected bits
    ``record`` (``{(core, slot): bit}``, every other bit 0): the pulses
    as sorted ``(time, stage, key, op)`` tuples and the reads the run's
    control flow consumed."""
    bits = np.zeros((mp.n_cores, n_slots), np.int64)
    for (c, m), b in record.items():
        bits[c, m] = b
    o = run_oracle(mp, meas_bits=bits, meas_elem=ch['meas_elem'])
    consumed = o['consumed']
    bad = [(c, e) for c, e in enumerate(o['err']) if e] \
        + [(c, 'not done') for c, d in enumerate(o['done']) if not d]
    if bad:
        raise ValueError(f'the oracle does not run the program clean: {bad}')
    return schedule_events(o['pulses'], ch), frozenset(consumed)


def schedule_events(pulses: list, ch: dict) -> tuple:
    """The oracle's per-core pulse records as sorted ``(time, stage, key,
    op)`` events: stage 0 a 1q drive ``('1q', core, theta, phi)``, stage
    1 a coupling ``('cp', index, theta, phi)``, stage 2 a read
    ``('read', core, slot)``; other elements touch nothing."""
    to_phi = 2 * math.pi / (1 << PHASE_BITS)
    events = []
    for c, ps in enumerate(pulses):
        slot = 0
        for p in ps:
            t = int(p['gtime'])
            if p['elem'] == ch['meas_elem']:
                events.append((t, 2, c, ('read', c, slot)))
                slot += 1
            elif p['elem'] == ch['drive_elem']:
                phi = to_phi * int(p['phase'])
                hits = [j for j, (cc, fi, _t, _k) in enumerate(ch['couplings'])
                        if cc == c and fi == int(p['freq'])]
                for j in hits:
                    ref = ch['zz90_amp'] if ch['couplings'][j][3] == 'zz' \
                        else ch['zx90_amp']
                    events.append((t, 1, j, ('cp', j, (math.pi / 2)
                                             * int(p['amp']) / ref, phi)))
                if not hits:
                    theta = (math.pi / 2) * int(p['amp']) / ch['x90_amp'] \
                        if ch['x90_amp'] > 0 else 0.0
                    events.append((t, 0, c, ('1q', c, theta, phi)))
    return tuple(sorted(events))


def _touched(ev, ch: dict) -> int:
    """The core whose gap an event closes (a coupling's control)."""
    op = ev[3]
    return ch['couplings'][op[1]][0] if op[0] == 'cp' else op[1]


# ---- local channels on rho, in place on its (2,) * 2C view -----------------

def _block(rho, C: int, sel: dict):
    """The view of ``rho`` with row bit ``r`` and column bit ``s`` of each
    core of ``sel`` (``{core: (r, s)}``) fixed."""
    idx = [slice(None)] * (2 * C)
    for c, (r, s) in sel.items():
        idx[c], idx[C + c] = r, s
    return rho.view((2,) * (2 * C))[tuple(idx)]


def _decay(rho, c: int, C: int, dt: float, ch: dict, core: int = None) \
        -> None:
    """Detuning, amplitude damping and dephasing over ``dt`` clocks of
    axis ``c``, at the rates of ``core`` (default ``c``), in place."""
    if dt <= 0:
        return
    k = c if core is None else core
    inv_t1, inv_t2 = ch['inv_t1'][k], ch['inv_t2'][k]
    gamma = -math.expm1(-dt * inv_t1)
    inv_phi = max(inv_t2 - 0.5 * inv_t1, 0.0)
    alpha = 2 * math.pi * ch['det'][k] * dt
    off = math.sqrt(1.0 - gamma) * math.exp(-dt * inv_phi) \
        * complex(math.cos(alpha), -math.sin(alpha))
    _block(rho, C, {c: (0, 0)}).add_(_block(rho, C, {c: (1, 1)}),
                                     alpha=gamma)
    _block(rho, C, {c: (1, 1)}).mul_(1.0 - gamma)
    _block(rho, C, {c: (0, 1)}).mul_(off)
    _block(rho, C, {c: (1, 0)}).mul_(off.conjugate())


def _depolarize(rho, cores: tuple, C: int, p: float) -> None:
    """``(1 - p) rho + p / (4^k - 1) sum_{P != I} P rho P`` on ``k``
    cores, in place: the Pauli twirl's sum is ``2^k Tr_k(rho) (x) I -
    rho``."""
    if p == 0.0:
        return
    d = 1 << len(cores)
    n = d * d - 1
    diag = [_block(rho, C, {c: (bit, bit) for c, bit in zip(cores, bits)})
            for bits in itertools.product((0, 1), repeat=len(cores))]
    trace = sum(v.clone() for v in diag)
    rho.mul_(1.0 - p - p / n)
    for v in diag:
        v.add_(trace, alpha=d * p / n)


def _project(rho, c: int, C: int, bit) -> None:
    """Keep the ``bit`` block of core ``c`` in place (``None``: both
    diagonal blocks, the dephasing of an unrecorded read)."""
    _block(rho, C, {c: (0, 1)}).zero_()
    _block(rho, C, {c: (1, 0)}).zero_()
    if bit is not None:
        _block(rho, C, {c: (1 - bit, 1 - bit)}).zero_()


def _mix(x, U) -> torch.Tensor:
    """``U`` (2 x 2, Python complex numbers) on the middle axis of
    ``x [A, 2, K]``: two sums of scaled blocks."""
    a, b = x[:, 0], x[:, 1]
    return torch.stack((U[0][0] * a + U[0][1] * b,
                        U[1][0] * a + U[1][1] * b), 1)


def _unitary_1q(rho, U, c: int, C: int):
    """``U rho U^dagger`` on core ``c``: ``U`` on the row bit of ``c``
    (a ``[2^c, 2, rest]`` view), then its conjugate on the column bit."""
    D = rho.shape[0]
    hi = 1 << c
    lo = D // (2 * hi)
    x = _mix(rho.view(hi, 2, lo * D), U)
    Uc = [[complex(u).conjugate() for u in row] for row in U]
    return _mix(x.view(D * hi, 2, lo), Uc).view(D, D)


def _unitary_2q(rho, U4, a: int, b: int, C: int):
    """``U4 rho U4^dagger`` on cores ``(a, b)`` (``U4``'s index is
    ``bit_a * 2 + bit_b``)."""
    D = rho.shape[0]
    u = U4.view(2, 2, 2, 2)
    x = torch.tensordot(u, rho.view((2,) * C + (D,)), dims=([2, 3], [a, b]))
    x = x.movedim((0, 1), (a, b)).reshape((D,) + (2,) * C)
    y = torch.tensordot(u.conj(), x, dims=([2, 3], [1 + a, 1 + b]))
    return y.movedim((0, 1), (1 + a, 1 + b)).contiguous().view(D, D)


def _rot_1q(theta: float, phi: float) -> list:
    """``exp(-i theta/2 (cos phi X + sin phi Y))`` as nested lists."""
    ch, sh = math.cos(theta / 2), math.sin(theta / 2)
    return [[ch, -1j * sh * complex(math.cos(phi), -math.sin(phi))],
            [-1j * sh * complex(math.cos(phi), math.sin(phi)), ch]]


def _pair_unitary(kind: str, theta: float, phi: float):
    if kind == 'zz':
        z = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=_F64)
        return torch.diag(torch.polar(torch.ones(4, dtype=_F64),
                                      -0.5 * theta * z))
    U = torch.zeros((4, 4), dtype=_C128)
    U[:2, :2] = torch.tensor(_rot_1q(theta, phi), dtype=_C128)
    U[2:, 2:] = torch.tensor(_rot_1q(-theta, phi), dtype=_C128)
    return U


def initial_rho(ch: dict, C: int):
    """The thermal product state: each core excited with ``p1_init``."""
    diag = torch.ones(1, dtype=_F64)
    for c in range(C):
        p = float(ch['p1_init'][c])
        diag = torch.kron(diag, torch.tensor([1.0 - p, p], dtype=_F64))
    return _held(torch.diag(diag).to(_C128), ch)


# ---- the branch walk --------------------------------------------------------

class _Sched:
    """One outcome record's schedule: its events, the reads its control
    flow consumes, a hash of each suffix of the events, the index just
    past its last consumed read, and its reads per core."""

    def __init__(self, events: tuple, consumed: frozenset, C: int):
        self.events, self.consumed = events, consumed
        self.suffix = [0] * (len(events) + 1)
        for i in range(len(events) - 1, -1, -1):
            self.suffix[i] = hash((events[i], self.suffix[i + 1]))
        self.last_consumed = max(
            (i + 1 for i, e in enumerate(events)
             if e[3][0] == 'read' and (e[3][1], e[3][2]) in consumed),
            default=0)
        self.reads = [sum(1 for e in events
                          if e[3][0] == 'read' and e[3][1] == c)
                      for c in range(C)]


class _Branch:
    """One outcome record's unnormalized matrix on that record's
    schedule: ``pos`` is its next event, ``seen`` the reads it has
    passed, ``out_bits`` the requested bits it recorded.  ``pending``
    holds the cores not yet in ``rho`` (there ``|0><0|``): each one's
    ``[(2 x 2 matrix, start of its open gap)]`` parts, summed over the
    outcome records they came from (:func:`_product_prefix`)."""
    __slots__ = ('record', 'rho', 'phys_t', 'sched', 'pos', 'seen',
                 'out_bits', 'pending')

    def __init__(self, record, rho, phys_t, sched, pos, seen, out_bits,
                 pending=None):
        self.record, self.rho, self.phys_t = record, rho, phys_t
        self.sched, self.pos, self.seen = sched, pos, seen
        self.out_bits, self.pending = out_bits, pending or {}

    def next_time(self):
        ev = self.sched.events
        return ev[self.pos][0] if self.pos < len(ev) else None


def evolve(schedule, ch: dict, C: int, slot: int = None,
           feedback: bool = True) -> list:
    """Walk the branches of ``schedule(record) -> (events, consumed)``
    from the thermal state; returns ``[(rho, out_bits)]``, each branch's
    unnormalized final matrix and the bits it recorded at a consumed
    requested read (``slot``: the read whose joint outcome is asked for,
    negative from each core's last)."""
    cache = {}

    def sched(record):
        key = tuple(sorted(record.items())) if feedback else ()
        if key not in cache:
            events, consumed = schedule(record if feedback else {})
            cache[key] = _Sched(events, consumed if feedback
                                else frozenset(), C)
        return cache[key]

    start = _product_prefix(sched, ch, C, slot) if feedback else None
    live = [start or _Branch({}, initial_rho(ch, C), [INIT_TIME] * C,
                             sched({}), 0, frozenset(), {})]
    while True:
        times = [t for t in (b.next_time() for b in live) if t is not None]
        if not times:
            break
        T = min(times)
        nxt = []
        for b in live:
            if b.next_time() == T:
                for x in _enter(b, T, ch, C):
                    nxt += _step_time(x, T, ch, C, slot, sched)
            else:
                nxt.append(b)
        live = _merge([b for b in nxt
                       if float(torch.diagonal(b.rho).real.sum()) > 0.0],
                      ch, C)
    for b in live:
        # a core with no pulse after the prefix never decays again
        for c, parts in b.pending.items():
            b.rho = _held(_insert(b.rho, c, C, sum(r for r, _t in parts)),
                          ch)
    return [(b.rho, b.out_bits) for b in live]


def _insert(rho, c: int, C: int, local):
    """``rho`` with core ``c``'s placeholder ``|0><0|`` replaced by the
    2 x 2 ``local``: every block of ``c`` is ``local[r, s]`` times the
    rest."""
    rest = _block(rho, C, {c: (0, 0)}).clone()
    out = torch.empty_like(rho)
    for r in (0, 1):
        for s in (0, 1):
            _block(out, C, {c: (r, s)}).copy_(local[r, s] * rest)
    return out


def _enter(b: _Branch, T: int, ch: dict, C: int) -> list:
    """Bring into ``b.rho`` each pending core that an event at ``T``
    involves.  A core with a pulse of its own at ``T`` closes each
    part's gap there, so its parts sum into one; a core only targeted by
    a coupling keeps its parts' gaps open, and ``b`` splits into one
    branch a start of the gap (they merge once the core's next pulse
    closes them)."""
    if not b.pending:
        return [b]
    events = b.sched.events
    j = b.pos
    while j < len(events) and events[j][0] == T:
        j += 1
    evs = events[b.pos:j]
    touched = {_touched(e, ch) for e in evs}
    targets = {ch['couplings'][e[3][1]][2] for e in evs if e[3][0] == 'cp'}
    out = [b]
    for c in sorted((touched | targets) & set(b.pending)):
        parts = b.pending[c]
        if c in touched:
            local = 0
            for r, t in parts:
                r = r.clone()
                _decay(r, 0, 1, T - t, ch, core=c)
                local = _held(local + _held(r, ch), ch)
            groups = [(local, T)]
        else:
            starts = {}
            for r, t in parts:
                starts[t] = starts.get(t, 0) + r
            groups = [(r, t) for t, r in sorted(starts.items(),
                                                key=lambda kv: kv[0])]
        split = []
        for x in out:
            rest = {k: v for k, v in x.pending.items() if k != c}
            for local, t in groups:
                phys_t = list(x.phys_t)
                phys_t[c] = t
                split.append(_Branch(x.record,
                                     _held(_insert(x.rho, c, C, local), ch),
                                     phys_t, x.sched, x.pos, x.seen,
                                     x.out_bits, rest))
        out = split
    return out


def _is_requested(s: _Sched, c: int, m: int, slot) -> bool:
    if slot is None:
        return False
    return m == (slot if slot >= 0 else s.reads[c] + slot)


def _product_prefix(sched, ch: dict, C: int, slot):
    """The walk up to the first coupling pulse, one core at a time.

    Before any coupling every branch is a product state (the thermal
    start, local channels, reads of single cores), so where each core's
    schedule before the coupling depends on its own recorded bits alone
    and every record's schedule from the coupling on is the same, the
    sum over records of the product states is the product of each
    core's own sum over its bits: ``2 C`` small matrices in place of
    ``2^k`` full ones for ``k`` consumed reads.  Each core's parts keep
    the start of their open gap (the feed-forward's pulses end it
    later than the read does) and wait in the branch's ``pending``
    until an event involves the core (:func:`_enter`).  Returns that
    one branch at the coupling's trigger, or None where the program
    does not factorize so (the full walk then runs from the start)."""
    zero = sched({})
    ev = zero.events
    cut = next((i for i, e in enumerate(ev) if e[3][0] == 'cp'), None)
    if cut is None:
        return None
    t_end = ev[cut][0]
    cut = next(i for i, e in enumerate(ev) if e[0] >= t_end)
    tail = ev[cut:]
    reads = [(e[3][1], e[3][2]) for e in ev[:cut] if e[3][0] == 'read']
    keys = [r for r in reads if r in zero.consumed]
    # the check below runs the oracle once a record: at most 2^12 of them
    if len(keys) > 12 or any(_is_requested(zero, c, m, slot)
                             for c, m in reads):
        return None
    local = {}
    for bits in itertools.product((0, 1), repeat=len(keys)):
        rec = dict(zip(keys, bits))
        s = sched(rec)
        n = next((i for i, e in enumerate(s.events) if e[0] >= t_end),
                 len(s.events))
        pre_reads = {(e[3][1], e[3][2]) for e in s.events[:n]
                     if e[3][0] == 'read'}
        if s.events[n:] != tail or s.last_consumed > n \
                or s.consumed & pre_reads != set(keys):
            return None
        for c in range(C):
            mine = tuple(e for e in s.events[:n] if _touched(e, ch) == c)
            own = (c, tuple(b for k, b in rec.items() if k[0] == c))
            if local.setdefault(own, mine) != mine:
                return None
    pending = {}
    for c in range(C):
        mine_keys = [k for k in keys if k[0] == c]
        parts = []
        for bits in itertools.product((0, 1), repeat=len(mine_keys)):
            rec = dict(zip(mine_keys, bits))
            p = float(ch['p1_init'][c])
            rho = _held(torch.tensor([[1.0 - p, 0.0], [0.0, p]],
                                     dtype=_C128), ch)
            t = INIT_TIME
            for e in local[(c, bits)]:
                _decay(rho, 0, 1, e[0] - t, ch, core=c)
                _held(rho, ch)
                t = e[0]
                op = e[3]
                if op[0] == '1q':
                    rho = _held(_unitary_1q(rho, _rot_1q(op[2], op[3]), 0,
                                            1), ch)
                    _depolarize(rho, (0,), 1, ch['depol'])
                    _held(rho, ch)
                else:
                    _project(rho, 0, 1, rec.get((c, op[2])))
            parts.append((rho, t))
        pending[c] = parts
    rho = torch.zeros((1 << C, 1 << C), dtype=_C128)
    rho[0, 0] = 1.0
    return _Branch(None, rho, [INIT_TIME] * C, zero, cut, frozenset(reads),
                   {}, pending)


def _step_time(b: _Branch, T: int, ch, C, slot, sched) -> list:
    """Every event of ``b`` at ``T``, in stage order; returns the
    branches it splits into, each on its own record's schedule."""
    events = b.sched.events
    j = b.pos
    while j < len(events) and events[j][0] == T:
        j += 1
    evs = events[b.pos:j]
    for c in sorted({_touched(e, ch) for e in evs}):
        _decay(b.rho, c, C, T - b.phys_t[c], ch)
        _held(b.rho, ch)
        b.phys_t[c] = T
    for e in evs:
        op = e[3]
        if op[0] == '1q':
            b.rho = _held(_unitary_1q(b.rho, _rot_1q(op[2], op[3]), op[1],
                                      C), ch)
            _depolarize(b.rho, (op[1],), C, ch['depol'])
            _held(b.rho, ch)
        elif op[0] == 'cp':
            cc, _fi, tt, kind = ch['couplings'][op[1]]
            b.rho = _held(_unitary_2q(b.rho, _pair_unitary(kind, op[2],
                                                           op[3]),
                                      cc, tt, C), ch)
            _depolarize(b.rho, (cc, tt), C, ch['depol2'])
            _held(b.rho, ch)
    b.pos = j
    out = [b]
    for e in evs:
        op = e[3]
        if op[0] != 'read':
            continue
        c, m = op[1], op[2]
        split = []
        for x in out:
            req = _is_requested(x.sched, c, m, slot)
            x.seen = x.seen | {(c, m)}
            if (c, m) not in x.sched.consumed:
                if req:
                    _check_last(x, c, ch)
                _project(x.rho, c, C, None)
                split.append(x)
                continue
            # a branch point: both outcomes, each projected; their
            # schedules are looked up once every read at T is split
            for bit, rho in ((0, x.rho.clone()), (1, x.rho)):
                _project(rho, c, C, bit)
                ob = {**x.out_bits, c: bit} if req else x.out_bits
                split.append(_Branch({**x.record, (c, m): bit}, rho,
                                     list(x.phys_t), x.sched, x.pos,
                                     x.seen, ob, x.pending))
        out = split
    for x in out:
        if x is b:
            continue
        new = sched(x.record)
        if new.events[:x.pos] != x.sched.events[:x.pos]:
            raise NotImplementedError(
                f'the schedule before {T} depends on the outcome '
                f'{x.record}')
        late = (new.consumed & x.seen) - set(x.record)
        if late:
            raise NotImplementedError(
                f'outcome {x.record} makes the program consume reads the '
                f'walk passed unrecorded: {sorted(late)}')
        x.sched = new
    return out


def _check_last(b: _Branch, c: int, ch: dict) -> None:
    for e in b.sched.events[b.pos:]:
        op = e[3]
        tgt = ch['couplings'][op[1]][2] if op[0] == 'cp' else None
        if _touched(e, ch) == c or tgt == c:
            raise NotImplementedError(
                f'core {c} has pulses after its requested read: its '
                f'outcome is not the final Z population')


def _merge(live: list, ch: dict, C: int) -> list:
    """Sum the branches whose futures are equal, hold no consumed read
    and open the same gaps: every core with a pulse ahead has its gap
    start at the same time in each (a gap's damping lands at the core's
    next pulse, after whatever couplings act on it before, so it cannot
    be moved)."""
    keep, groups = [], {}
    for b in live:
        if b.pos < b.sched.last_consumed:
            keep.append(b)
            continue
        ahead = sorted({_touched(e, ch) for e in b.sched.events[b.pos:]})
        groups.setdefault((b.sched.suffix[b.pos],
                           tuple(sorted(b.out_bits.items())),
                           tuple(b.phys_t[c] for c in ahead),
                           tuple(sorted(b.pending))), []).append(b)
    for members in groups.values():
        first = members[0]
        rest = first.sched.events[first.pos:]
        same = [b for b in members if b.sched.events[b.pos:] == rest]
        keep += [b for b in members if b.sched.events[b.pos:] != rest]
        if len(same) == 1:
            keep.append(first)
            continue
        keep.append(_Branch(None, _held(sum(b.rho for b in same), ch),
                            list(first.phys_t), first.sched, first.pos,
                            first.seen, first.out_bits, first.pending))
    return keep


def _packed_distribution(branches: list, C: int) -> np.ndarray:
    """``[2^C]`` outcome probabilities, core ``c`` bit ``c``, from the
    final branches: each core's Z population, or its recorded bit."""
    d = np.arange(1 << C)
    basis_bits = (d[:, None] >> (C - 1 - np.arange(C))[None, :]) & 1
    dist = np.zeros(1 << C)
    for rho, out_bits in branches:
        p = torch.diagonal(rho).real.numpy()
        bits = basis_bits.copy()
        for c, bit in out_bits.items():
            bits[:, c] = bit
        np.add.at(dist, (bits << np.arange(C)[None, :]).sum(1), p)
    return dist


def _schedule_fn(mp, ch: dict, n_slots: int = 256):
    return lambda record: _oracle_schedule(mp, ch, record, n_slots)


def density_matrix(mp, ch: dict, feedback: bool = True) -> torch.Tensor:
    """The program's final density matrix, summed over every branch
    (complex128 ``[2^C, 2^C]``, core 0 the most significant bit), under
    the channels ``ch`` (:func:`channels_from_config`)."""
    C = mp.n_cores
    branches = evolve(_schedule_fn(mp, ch), ch, C, feedback=feedback)
    return sum(rho for rho, _ in branches)


def outcome_distribution(mp, ch: dict, slot: int = -1,
                         feedback: bool = True) -> np.ndarray:
    """The exact joint distribution ``[2^C]`` (float64, core ``c`` bit
    ``c``) of read ``slot`` of every core (negative: from each core's
    last read) under the channels ``ch`` (:func:`channels_from_config`).
    ``feedback=False`` serves every fproc read 0: the control with the
    feed-forward removed.  Under a ``held`` precision (:func:`held_in`)
    the probabilities sum to the trace rounding left."""
    C = mp.n_cores
    schedule = _schedule_fn(mp, ch)
    reads = _Sched(*schedule({}), C).reads
    if any(not -n <= slot < n for n in reads):
        raise ValueError(f'slot {slot} is not a read of every core '
                         f'(reads per core: {reads})')
    dist = _packed_distribution(
        evolve(schedule, ch, C, slot=slot, feedback=feedback), C)
    if ch.get('held') is None and abs(dist.sum() - 1.0) > 1e-9:
        raise RuntimeError(f'the branches hold probability {dist.sum()}')
    return dist
