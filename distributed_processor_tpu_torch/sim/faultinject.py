"""Fault-injection harness: mutate valid machine programs, assert no
injected defect is ever SILENT.

The trap-and-report contract has two layers — the static validator
(:func:`~..decoder.validate_program`) rejects
programs that are wrong on every input before they run, and the
runtime fault word traps data-dependent failures per lane — and this
module is the adversarial check that the layers compose with no gap:
every mutant is either rejected at decode, rejected by the validator,
trapped with a nonzero ``fault_shots`` code by EVERY engine that runs
it, or provably benign (a bit flip in a pulse parameter is a different
valid program, not a fault).  A mutant that hangs, crashes an engine,
or runs cleanly where its mutator guarantees breakage is a harness
failure.

Deterministic: every mutant derives from ``np.random.default_rng`` on
the (seed, case index) pair, so a failing case name reproduces exactly.
``run_fuzz`` is the library entry.

The port's copy of the JAX package's ``sim/faultinject.py``: the same
mutators, corpus, verdicts and defaults, run on the port's engines.
Every entry point takes ``device=`` (the card unless the caller names
the CPU, raising without CUDA).  On the card ``engine='pallas'`` is K1
span or K1 block and ``engine='fused'`` is K3; on the CPU they run the
kernels' plain versions (the JAX package runs its Pallas kernel in
interpret mode there).  ``run_fuzz(engines=ENGINES + ('pallas',))``
holds K1 to the other engines on every mutant.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import isa
from ..decoder import (machine_program_from_cmds, stack_machine_programs,
                       validate_program, ProgramValidationError)
from .interpreter import (InterpreterConfig, FAULT_CODES,
                          fault_shot_counts, simulate_batch,
                          simulate_multi_batch, torch_device)

ENGINES = ('generic', 'block', 'straightline')


def _pulse(t: int = 10) -> int:
    return isa.pulse_cmd(amp_word=1000, cfg_word=0, env_word=3, cmd_time=t)


# ---------------------------------------------------------------------------
# base programs — small, valid, covering the control-flow idioms the
# mutators target (straight-line, counted loop, sync barrier, fproc)
# ---------------------------------------------------------------------------

def base_linear(rng) -> tuple:
    n = int(rng.integers(2, 6))
    core = [_pulse(10 + 20 * i) for i in range(n)] + [isa.done_cmd()]
    return [list(core), list(core)], InterpreterConfig(max_steps=256)


def base_loop(rng) -> tuple:
    iters = int(rng.integers(2, 5))
    core = [isa.alu_cmd('reg_alu', 'i', iters, 'id0', write_reg_addr=0),
            _pulse(),
            isa.alu_cmd('reg_alu', 'i', -1, 'add', 0, write_reg_addr=0),
            isa.alu_cmd('jump_cond', 'i', 0, 'le', 0, jump_cmd_ptr=1),
            isa.done_cmd()]
    return [core], InterpreterConfig(max_steps=256)


def base_sync(rng) -> tuple:
    nb = int(rng.integers(1, 3))
    cores = []
    for c in range(2):
        core = []
        for b in range(nb):
            core.append(_pulse(10 + 30 * b + 10 * c))
            core.append(isa.sync(b))
        core.append(isa.done_cmd())
        cores.append(core)
    return cores, InterpreterConfig(max_steps=256)


def base_fproc(rng) -> tuple:
    # core 0 produces a measurement (meas_elem=0: every pulse is a
    # readout); core 1 blocks on core 0's FRESH result — the fabric
    # where a producer finishing without measuring starves the reader
    prod = [_pulse(10), isa.done_cmd()]
    cons = [isa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                        func_id=0),
            _pulse(200), isa.done_cmd(), isa.done_cmd()]
    return [prod, cons], InterpreterConfig(max_steps=256, fabric='fresh',
                                           meas_elem=0)


def base_lut(rng) -> tuple:
    # data cores measure (meas_elem=0: every pulse is a readout); the
    # last core branches on the parity LUT over them — the timestamped
    # feedback fabric the fast engines serve (docs/PERF.md "Feedback
    # on the fast engines")
    n_prod = int(rng.integers(2, 4))
    prods = [[_pulse(10 + 5 * c), isa.done_cmd()] for c in range(n_prod)]
    reader = [isa.idle(100),
              isa.alu_cmd('jump_fproc', 'i', 1, 'eq', jump_cmd_ptr=3,
                          func_id=1),
              isa.jump_i(4),
              _pulse(400),
              isa.done_cmd()]
    C = n_prod + 1
    table = tuple(((1 << C) - 1) if bin(a).count('1') & 1 else 0
                  for a in range(1 << n_prod))
    cfg = InterpreterConfig(max_steps=256, meas_elem=0, fabric='lut',
                            lut_mask=(True,) * n_prod + (False,),
                            lut_table=table)
    return prods + [reader], cfg


BASE_BUILDERS = (('linear', base_linear), ('loop', base_loop),
                 ('sync', base_sync), ('fproc', base_fproc),
                 ('lut', base_lut))


# ---------------------------------------------------------------------------
# mutants
# ---------------------------------------------------------------------------

_ALL_OUTCOMES = frozenset(
    ('rejected_decode', 'illegal_op', 'jump_oob', 'no_done',
     'infinite_loop', 'fproc_unreachable', 'sync_mismatch')
    + tuple(name for name, _ in FAULT_CODES))


@dataclass
class Mutant:
    """One mutated program plus the oracle for judging its outcome."""
    name: str                 # '<base>+<mutator>#<index>'
    cmds: list                # per-core 128-bit word lists
    cfg: InterpreterConfig
    expected: frozenset       # acceptable non-clean outcome labels
    allow_clean: bool = False  # may the mutant legitimately run clean?


def mut_bit_flip(rng, cmds, cfg):
    """Flip one bit of one encoded word — anything can happen EXCEPT a
    silent hang or an engine disagreement."""
    c = int(rng.integers(len(cmds)))
    i = int(rng.integers(len(cmds[c])))
    out = [list(x) for x in cmds]
    out[c][i] = int(out[c][i]) ^ (1 << int(rng.integers(128)))
    return Mutant('', out, cfg, _ALL_OUTCOMES, allow_clean=True)


def mut_truncate_done(rng, cmds, cfg):
    """Overwrite a core's DONE terminators in place — on a MAX-LENGTH
    core, so the stacker's DONE padding cannot quietly re-terminate it:
    execution runs off the end of the buffer."""
    n = max(len(core) for core in cmds)
    longest = [c for c, core in enumerate(cmds) if len(core) == n]
    c = longest[int(rng.integers(len(longest)))]
    done = isa.done_cmd()
    out = [list(x) for x in cmds]
    out[c] = [_pulse(500) if w == done else w for w in out[c]]
    return Mutant('', out, cfg,
                  frozenset({'no_done', 'jump_oob', 'budget_exhausted'}))


def mut_drop_sync_partner(rng, cmds, cfg):
    """Remove one SYNC from one participant.

    If the core keeps other SYNCs it stays a participant with a short
    barrier sequence — statically inconsistent (validator) or a runtime
    deadlock.  Removing a core's ONLY sync shrinks the participant set
    instead (the interpreter derives participation from program
    content), leaving a smaller barrier that is trivially satisfiable —
    a semantic change, not a fault, so ``allow_clean``.  Half the time
    a no-op forward branch is prepended to the mutated core, putting
    the barrier sequence beyond static analysis and forcing the RUNTIME
    deadlock trap to catch it.
    """
    syncs = [(c, i) for c, core in enumerate(cmds)
             for i, w in enumerate(core)
             if isa.decode_soa(isa.cmds_to_bytes([w])).kind[0]
             == isa.K_SYNC]
    if not syncs:
        return None
    c, i = syncs[int(rng.integers(len(syncs)))]
    last_sync = sum(1 for cc, _ in syncs if cc == c) == 1
    out = [list(x) for x in cmds]
    del out[c][i]
    if rng.integers(2):
        # defeat the static check: a branch-free participant set is the
        # validator's precondition (base programs have no other jumps,
        # so no targets need re-aiming after the insert)
        out[c] = [isa.alu_cmd('jump_cond', 'i', 0, 'ge', 0,
                              jump_cmd_ptr=1)] + out[c]
    return Mutant('', out, cfg,
                  frozenset({'sync_mismatch', 'sync_deadlock',
                             'budget_exhausted'}),
                  allow_clean=last_sync)


def mut_starve_fproc(rng, cmds, cfg):
    """Drop the producer's measurement: a fresh-fabric reader starves —
    and on the LUT fabric a masked producer that finishes without ever
    measuring starves every table read the same way (the per-slot
    timestamp planes stay INT32_MAX, so no slot is ever selectable)."""
    if cfg.fabric not in ('fresh', 'lut'):
        return None
    out = [list(x) for x in cmds]
    done = isa.done_cmd()
    starved = [0] if cfg.fabric == 'fresh' \
        else [c for c, m in enumerate(cfg.lut_mask) if m]
    for c in starved:
        out[c] = [w for w in out[c] if w == done] or [done]
    return Mutant('', out, cfg,
                  frozenset({'fproc_starved', 'budget_exhausted'}))


def mut_retarget_jump(rng, cmds, cfg):
    """Point a jump outside the program: static jump_oob."""
    soas = [isa.decode_soa(isa.cmds_to_bytes(core)) for core in cmds]
    jumps = [(c, i) for c, s in enumerate(soas)
             for i in np.nonzero(np.isin(
                 s.kind, (isa.K_JUMP_I, isa.K_JUMP_COND,
                          isa.K_JUMP_FPROC)))[0]]
    if not jumps:
        return None
    c, i = jumps[int(rng.integers(len(jumps)))]
    n = max(len(core) for core in cmds)
    bad = n + int(rng.integers(1, 100))
    out = [list(x) for x in cmds]
    mask = ((1 << 8) - 1) << isa.JUMP_ADDR_POS
    out[c][i] = (int(out[c][i]) & ~mask) \
        + ((bad & 0xff) << isa.JUMP_ADDR_POS)
    if not 0 <= (bad & 0xff) < n:   # 8-bit field may wrap in range
        return Mutant('', out, cfg,
                      frozenset({'jump_oob', 'budget_exhausted'}))
    return Mutant('', out, cfg, _ALL_OUTCOMES, allow_clean=True)


def mut_shrink_budget(rng, cmds, cfg):
    """Valid program, starved step budget: BUDGET_EXHAUSTED — or clean
    on an engine whose coarser step accounting (a block engine
    iteration retires a whole superinstruction) finishes in budget;
    completing a VALID program is always correct."""
    return Mutant('', [list(x) for x in cmds],
                  replace(cfg, max_steps=int(rng.integers(1, 3))),
                  frozenset({'budget_exhausted'}), allow_clean=True)


def mut_overflow_records(rng, cmds, cfg):
    """Valid program, one-slot record budgets: overflow traps iff the
    program emits more than one pulse/measurement."""
    n_pulse = max(
        int(np.sum(isa.decode_soa(isa.cmds_to_bytes(core)).kind
                   == isa.K_PULSE_TRIG))
        for core in cmds)
    if n_pulse <= 1:
        return None
    exp = {'pulse_overflow'}
    if cfg.meas_elem == 0:
        exp.add('meas_overflow')
    return Mutant('', [list(x) for x in cmds],
                  replace(cfg, max_pulses=1, max_meas=1),
                  frozenset(exp))


MUTATORS = (('bit_flip', mut_bit_flip),
            ('truncate_done', mut_truncate_done),
            ('drop_sync', mut_drop_sync_partner),
            ('starve_fproc', mut_starve_fproc),
            ('retarget_jump', mut_retarget_jump),
            ('shrink_budget', mut_shrink_budget),
            ('overflow_records', mut_overflow_records))


def gen_mutants(seed: int, n: int) -> list:
    """``n`` deterministic mutants cycling (base × mutator) pairs."""
    pairs = [(bn, bf, mn, mf) for bn, bf in BASE_BUILDERS
             for mn, mf in MUTATORS]
    out = []
    k = 0
    while len(out) < n:
        bn, bf, mn, mf = pairs[k % len(pairs)]
        rng = np.random.default_rng((seed, k))
        cmds, cfg = bf(rng)
        m = mf(rng, cmds, cfg)
        k += 1
        if m is None:
            continue
        m.name = f'{bn}+{mn}#{k - 1}'
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

_TIMING_INDEPENDENT = frozenset({'pulse_overflow', 'meas_overflow',
                                 'reset_overflow', 'illegal_op',
                                 'jump_oob'})


def _fault_names(fault) -> frozenset:
    counts = fault_shot_counts(torch.as_tensor(fault)).cpu().numpy()
    return frozenset(name for (name, _), c
                     in zip(FAULT_CODES, counts) if c)


def check_mutant(m: Mutant, engines=ENGINES, shots: int = 4,
                 device=None) -> dict:
    """Judge one mutant on ``device``.  Returns ``{'verdict', 'detail'}`` where
    verdict is ``rejected_decode | rejected_validator | trapped |
    benign | SILENT | MISTRAPPED | INCONSISTENT``; the capitalized
    verdicts are harness FAILURES."""
    try:
        mp = machine_program_from_cmds(m.cmds)
    except (ValueError, OverflowError) as e:
        ok = 'rejected_decode' in m.expected
        return {'verdict': 'rejected_decode' if ok else 'MISTRAPPED',
                'detail': str(e)}
    try:
        validate_program(mp, m.cfg)
    except ProgramValidationError as e:
        if e.codes & m.expected:
            return {'verdict': 'rejected_validator',
                    'detail': sorted(e.codes)}
        return {'verdict': 'MISTRAPPED',
                'detail': f'validator codes {sorted(e.codes)} not in '
                          f'expected {sorted(m.expected)}'}
    device = torch_device(device)
    mb = np.zeros((shots, mp.n_cores, m.cfg.max_meas), np.int32)
    per_engine = {}
    for eng in engines:
        cfg = replace(m.cfg, engine=eng)
        try:
            out = simulate_batch(mp, mb, cfg=cfg, device=device)
        except ValueError as e:
            if 'ineligible' in str(e):
                continue            # engine doesn't apply to this shape
            return {'verdict': 'MISTRAPPED',
                    'detail': f'{eng} raised {e}'}
        per_engine[eng] = _fault_names(out['fault'])
    if not per_engine:
        return {'verdict': 'MISTRAPPED', 'detail': 'no engine ran'}
    # cross-engine agreement is required on the timing-INDEPENDENT
    # codes; budget/deadlock/starvation depend on engine step
    # accounting (a block iteration retires many instructions) and are
    # judged per engine against the oracle instead
    strict = {names & _TIMING_INDEPENDENT
              for names in per_engine.values()}
    if len(strict) > 1:
        return {'verdict': 'INCONSISTENT', 'detail': {
            k: sorted(v) for k, v in per_engine.items()}}
    for eng, names in per_engine.items():
        if not names:
            if not m.allow_clean:
                return {'verdict': 'SILENT',
                        'detail': f'{eng}: expected '
                                  f'{sorted(m.expected)}, no fault '
                                  f'fired'}
        elif not names & m.expected:
            return {'verdict': 'MISTRAPPED',
                    'detail': f'{eng} trapped {sorted(names)}, '
                              f'expected {sorted(m.expected)}'}
    fired = frozenset().union(*per_engine.values())
    if fired:
        return {'verdict': 'trapped', 'detail': sorted(fired)}
    return {'verdict': 'benign', 'detail': sorted(per_engine)}


def check_vmap_consistency(seed: int = 0, n: int = 8,
                           shots: int = 4, device=None) -> int:
    """Stack valid-after-mutation single-core programs and assert the
    multi-program run (:func:`.interpreter.simulate_multi_batch`, the
    JAX package's vmapped executable) reports the SAME per-program fault
    sets as per-program ``simulate_batch`` runs; returns the count of
    programs whose sets differ."""
    device = torch_device(device)
    mps, cfgs, singles = [], [], []
    base_cfg = InterpreterConfig(max_steps=64)
    k = 0
    while len(mps) < n:
        r = np.random.default_rng((seed, 7000 + k))
        k += 1
        cmds, _ = base_loop(r)
        m = mut_shrink_budget(r, cmds, base_cfg) if k % 2 \
            else Mutant('', cmds, base_cfg, frozenset(), allow_clean=True)
        try:
            mp = machine_program_from_cmds(m.cmds)
            validate_program(mp, m.cfg)
        except (ValueError, ProgramValidationError):
            continue
        mps.append(mp)
        cfgs.append(m.cfg)
    # one shared cfg: the TIGHTEST budget, so trapping programs trap in
    # both the single and the stacked run
    cfg = replace(base_cfg,
                  max_steps=min(c.max_steps for c in cfgs))
    for mp in mps:
        mb = np.zeros((shots, mp.n_cores, cfg.max_meas), np.int32)
        singles.append(_fault_names(
            simulate_batch(mp, mb, cfg=cfg, device=device)['fault']))
    mmp = stack_machine_programs(mps)
    mb = np.zeros((mmp.n_progs, shots, mmp.n_cores, cfg.max_meas),
                  np.int32)
    out = simulate_multi_batch(mmp, mb, cfg=cfg, device=device)
    bad = 0
    for p in range(mmp.n_progs):
        stacked = _fault_names(out['fault'][p])
        if stacked != singles[p]:
            bad += 1
    return bad


def check_mesh_consistency(seed: int = 0, n: int = 4,
                           shots_per_prog: int = 8, device=None) -> int:
    """Run a mutant ensemble through ``run_multi_sweep`` with and
    without a dp mesh over every rank of the process group and count
    fault-stat mismatches (0 = the sharded reduction reports exactly the
    per-device faults).  Every rank calls it (the mesh run is
    collective).  Returns -1 if the process group has fewer than 2
    ranks (check skipped)."""
    import torch.distributed as dist
    device = torch_device(device)
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return -1
    from ..parallel.driver import run_multi_sweep
    from ..parallel.mesh import make_mesh
    mps = []
    k = 0
    while len(mps) < n:
        r = np.random.default_rng((seed, 9000 + k))
        k += 1
        cmds, _ = base_loop(r)
        try:
            mp = machine_program_from_cmds(cmds)
            validate_program(mp)
        except (ValueError, ProgramValidationError):
            continue
        mps.append(mp)
    kw = dict(total_shots=shots_per_prog, batch=shots_per_prog,
              seed=seed, max_steps=6,   # starved: every program traps
              device=device)
    ref = run_multi_sweep(mps, **kw)
    got = run_multi_sweep(mps, mesh=make_mesh(device=device), **kw)
    bad = 0
    for name, _ in FAULT_CODES:
        if ref['fault_shots'][name].tolist() \
                != got['fault_shots'][name].tolist():
            bad += 1
    return bad


def check_fused_consistency(seed: int = 0, n: int = 40,
                            shots: int = 4, device=None) -> dict:
    """Cross-check ``generic`` vs the fused measure-in-megastep engine
    (``engine='fused'``, in-kernel demodulation) on the
    timing-INDEPENDENT fault codes.

    :func:`run_fuzz` cannot put the fused engine in its ladder: it
    injects measurement bits, and the fused engine's whole point is
    that there is no injection — so this cross-check closes the physics
    loop instead (sigma=0: deterministic bits, identical on both
    engines) and compares fault-name sets on the codes that do not
    depend on engine step accounting.  Mutants the fused engine is
    ineligible for (loops, overflow re-resolution, decode/validator
    rejections) are skipped, not failed.  Returns ``{'checked',
    'skipped', 'failures'}``; a nonempty ``failures`` list is a harness
    failure.  On the card ``fused`` is K3.
    """
    from .physics import ReadoutPhysics, run_physics_batch
    device = torch_device(device)
    checked = skipped = 0
    failures = []
    for m in gen_mutants(seed, n):
        try:
            mp = machine_program_from_cmds(m.cmds)
            validate_program(mp, m.cfg)
        except (ValueError, OverflowError, ProgramValidationError):
            skipped += 1
            continue
        # the model's readout element must match the mutant cfg's (the
        # fproc base programs pin meas_elem=0)
        model = ReadoutPhysics(sigma=0.0, meas_elem=m.cfg.meas_elem)
        names = {}
        try:
            for eng in ('generic', 'fused'):
                out = run_physics_batch(mp, model, seed, shots,
                                        cfg=replace(m.cfg, engine=eng),
                                        device=device)
                names[eng] = _fault_names(out['fault'])
        except ValueError as e:
            if 'ineligible' in str(e):
                skipped += 1
                continue
            failures.append((m.name, f'raised: {e}'))
            continue
        checked += 1
        a = names['generic'] & _TIMING_INDEPENDENT
        b = names['fused'] & _TIMING_INDEPENDENT
        if a != b:
            failures.append((m.name, {'generic': sorted(a),
                                      'fused': sorted(b)}))
    return {'checked': checked, 'skipped': skipped, 'failures': failures}


def check_feedback_consistency(seed: int = 0, n: int = 24,
                               shots: int = 4, device=None) -> dict:
    """Cross-check ``generic`` vs ``block`` vs ``pallas`` (K1 span or
    K1 block on the card, their plain versions on the CPU) on lut+fproc
    FEEDBACK mutants, timing-independent fault codes only.

    The timestamped fabric makes LUT reads a pure function of the
    measurement/timestamp planes and the read service time, which is
    what admitted feedback programs to the fast engines (docs/PERF.md
    "Feedback on the fast engines") — so on every valid mutant of the
    lut base the engines must agree on the codes that do not depend on
    engine step accounting (``_TIMING_INDEPENDENT``; budget/deadlock/
    starvation are judged per engine by :func:`check_mutant` instead).
    Measurement bits are (seed, case)-deterministic random draws so
    the syndrome actually varies.  Mutants an engine is ineligible for
    and decode/validator rejections are skipped, not failed.  Returns
    ``{'checked', 'skipped', 'failures'}``; nonempty ``failures`` is a
    harness failure.
    """
    device = torch_device(device)
    checked = skipped = 0
    failures = []
    k = made = 0
    while made < n:
        mn, mf = MUTATORS[k % len(MUTATORS)]
        rng = np.random.default_rng((seed, 5000 + k))
        cmds, cfg = base_lut(rng)
        m = mf(rng, cmds, cfg)
        k += 1
        if m is None:
            continue
        made += 1
        m.name = f'lut+{mn}#{k - 1}'
        try:
            mp = machine_program_from_cmds(m.cmds)
            validate_program(mp, m.cfg)
        except (ValueError, OverflowError, ProgramValidationError):
            skipped += 1
            continue
        mb = np.random.default_rng((seed, 6000 + k)).integers(
            0, 2, (shots, mp.n_cores, m.cfg.max_meas)).astype(np.int32)
        names = {}
        try:
            for eng in ('generic', 'block', 'pallas'):
                out = simulate_batch(mp, mb, cfg=replace(m.cfg, engine=eng),
                                     device=device)
                names[eng] = _fault_names(out['fault'])
        except ValueError as e:
            if 'ineligible' in str(e):
                skipped += 1
                continue
            failures.append((m.name, f'raised: {e}'))
            continue
        checked += 1
        strict = {eng: nm & _TIMING_INDEPENDENT
                  for eng, nm in names.items()}
        if len(set(strict.values())) > 1:
            failures.append((m.name,
                             {e: sorted(s) for e, s in strict.items()}))
    return {'checked': checked, 'skipped': skipped, 'failures': failures}


def check_audit_consistency(seed: int = 0, n: int = 24,
                            shots: int = 4, device=None) -> dict:
    """Serve the mutant corpus with ``audit_sample=1`` and count
    false-positive integrity violations (docs/ROBUSTNESS.md
    "Integrity": the auditor must never cry wolf on legitimately
    identical engines).

    Every valid mutant — including ones that trap, where
    timing-dependent fault codes legitimately differ across engines —
    goes through an :class:`~..serve.ExecutionService` whose audit
    sampler re-executes each completed batch on a different engine and
    escalates cross-engine disagreement to a served-configuration
    confirm run.  With no corruption injected, ``false_positives``
    (the service's confirmed-mismatch count) must be 0.  Mutants the
    decoder/validator reject are skipped (they never reach dispatch).
    Returns ``{'checked', 'skipped', 'audits', 'false_positives'}``.
    """
    from ..serve import ExecutionService
    device = torch_device(device)
    checked = skipped = 0
    with ExecutionService(None, devices=[device], max_batch_programs=4,
                          audit_sample=1.0, audit_mode='flag') as svc:
        handles = []
        for m in gen_mutants(seed, n):
            try:
                mp = machine_program_from_cmds(m.cmds)
                validate_program(mp, m.cfg)
            except (ValueError, OverflowError, ProgramValidationError):
                skipped += 1
                continue
            cfg = replace(m.cfg, engine=None, straightline=False,
                          fault_mode='count', opcode_histogram=False)
            mb = np.zeros((shots, mp.n_cores, cfg.max_meas), np.int32)
            try:
                handles.append(svc.submit(mp, mb, cfg=cfg))
            except ValueError:
                skipped += 1     # cfg the serve path refuses typed
                continue
            checked += 1
        for h in handles:
            h.result(timeout=300)
        st = svc.stats()['integrity']
    return {'checked': checked, 'skipped': skipped,
            'audits': st['audits'],
            'false_positives': st['mismatches']}


@dataclass
class FuzzReport:
    n: int = 0
    verdicts: dict = field(default_factory=dict)
    failures: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def run_fuzz(seed: int = 0, n: int = 200, engines=ENGINES,
             shots: int = 4, progress=None, device=None) -> FuzzReport:
    """Fuzz ``n`` mutants on ``device``; any SILENT/MISTRAPPED/
    INCONSISTENT verdict is recorded as a failure (``report.ok``)."""
    device = torch_device(device)
    rep = FuzzReport()
    for m in gen_mutants(seed, n):
        res = check_mutant(m, engines=engines, shots=shots, device=device)
        rep.n += 1
        v = res['verdict']
        rep.verdicts[v] = rep.verdicts.get(v, 0) + 1
        if v not in ('rejected_decode', 'rejected_validator',
                     'trapped', 'benign'):
            rep.failures.append((m.name, v, res['detail']))
        if progress and rep.n % 25 == 0:
            progress(rep)
    return rep
