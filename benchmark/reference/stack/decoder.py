"""Decode assembled binaries into the tensorised machine program consumed
by the interpreter.

The assembler's output (per-core ``cmd_buf`` bytes + env/freq buffers) is
the same artifact the reference writes to FPGA BRAM.  Here it is decoded
once, on the host, into:

* a stacked :class:`~distributed_processor_tpu_torch.isa.SoAProgram`
  (``[n_cores, n_instr]`` int32 field arrays) with two derived fields the
  simulator needs — ``p_elem`` (element index from the cfg word) and
  ``p_dur`` (pulse duration in FPGA clocks, derived from the env word and
  the element's sample geometry);
* dense element tables (envelope IQ samples, NCO frequency entries) for
  the DSP pipeline.

Nothing here runs on the device; the interpreter gathers from these arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import isa
from .elements import (TPUElementConfig, parse_env_buffer, parse_freq_buffer,
                       ENV_BANKS, FREQ_BUF_WORDS)


@dataclass
class CoreTables:
    """Per-core decoded element tables (one entry per element)."""
    envs: list        # list of complex arrays (envelope samples per element)
    freqs: list       # list of {'freq': array, 'iq15': array}
    elem_cfgs: list   # list of TPUElementConfig


@dataclass
class MachineProgram:
    """A decoded multi-core machine program, ready for the interpreter."""
    soa: isa.SoAProgram          # [n_cores, n_instr]
    p_elem: np.ndarray           # [n_cores, n_instr] element index of pulses
    p_dur: np.ndarray            # [n_cores, n_instr] pulse duration (clks)
    tables: list                 # CoreTables per core
    core_inds: list              # original core indices (sorted)
    # declared program variables per core (positional order):
    # {name: {'index': reg index, 'dtype': ('int',) | ('amp', e) | ...}}
    # — the handle for preloading register-parameterized programs
    reg_maps: list = None

    @property
    def n_cores(self) -> int:
        return self.soa.kind.shape[0]

    @property
    def n_instr(self) -> int:
        return self.soa.kind.shape[1]

    @property
    def has_fproc(self) -> bool:
        return bool(np.any((self.soa.kind == isa.K_ALU_FPROC)
                           | (self.soa.kind == isa.K_JUMP_FPROC)))

    @property
    def has_sync(self) -> bool:
        return bool(np.any(self.soa.kind == isa.K_SYNC))

    @property
    def sync_participants(self) -> np.ndarray:
        """Bool[n_cores]: cores whose program contains a SYNC instruction."""
        return np.any(self.soa.kind == isa.K_SYNC, axis=1)

    def max_pulses_per_core(self, loop_bound: int = 1024) -> int:
        """Static upper bound on emitted pulses per core (loops bounded)."""
        n_pulse_instr = int(np.max(np.sum(self.soa.kind == isa.K_PULSE_TRIG, axis=1)))
        has_backjump = bool(np.any(
            (self.soa.kind == isa.K_JUMP_COND) | (self.soa.kind == isa.K_JUMP_I)
            | (self.soa.kind == isa.K_JUMP_FPROC)))
        return n_pulse_instr * (loop_bound if has_backjump else 1)

    def loop_bounds(self, core: int) -> list:
        """Statically analyzable loops on one core: ``[(start, end,
        iterations | None)]`` per backward ``jump_cond``.

        Recognizes the compiler's counter idiom (loop_shots_program /
        the reference's loop lowering, reference: compiler.py:322-324):
        counter register initialized by an immediate ``id0`` write,
        stepped by an immediate ``add`` inside the body, tested by a
        ``ge``/``le`` jump against an immediate bound.  Anything else
        (register-register compares, fproc-driven back-edges, missing
        or non-constant step) yields ``None`` — not statically bounded.
        """
        soa = self.soa
        kind = np.asarray(soa.kind[core])
        loops = []
        op_ge, op_le = isa.ALU_OPS['ge'], isa.ALU_OPS['le']
        op_add, op_id0 = isa.ALU_OPS['add'], isa.ALU_OPS['id0']
        for j in range(len(kind)):
            if kind[j] != isa.K_JUMP_COND:
                continue
            t = int(soa.jump_addr[core, j])
            if t > j:
                continue
            bound = None
            alu_op = int(soa.alu_op[core, j])
            reg_writes = (isa.K_REG_ALU, isa.K_ALU_FPROC)
            if not soa.in0_is_reg[core, j] and alu_op in (op_ge, op_le):
                lim = int(soa.imm[core, j])
                r = int(soa.in1_reg[core, j])
                step = None
                for i in range(t, j):
                    if kind[i] in reg_writes \
                            and int(soa.out_reg[core, i]) == r:
                        if kind[i] == isa.K_REG_ALU \
                                and not soa.in0_is_reg[core, i] \
                                and int(soa.alu_op[core, i]) == op_add \
                                and int(soa.in1_reg[core, i]) == r \
                                and step is None:
                            step = int(soa.imm[core, i])
                        else:
                            # fproc-driven or non-constant counter write
                            step = 0
                            break
                # init must come from a recognized immediate write: a
                # counter seeded only via init_regs (register-
                # parameterized sweeps) is data-driven, not bounded
                init = None
                for i in range(t):
                    if kind[i] in reg_writes \
                            and int(soa.out_reg[core, i]) == r:
                        init = int(soa.imm[core, i]) \
                            if (kind[i] == isa.K_REG_ALU
                                and not soa.in0_is_reg[core, i]
                                and int(soa.alu_op[core, i]) == op_id0) \
                            else None
                if init is not None and step:
                    if alu_op == op_ge and step > 0:
                        # continue while lim >= ctr (ge = signed >=);
                        # a bound already past the limit still runs the
                        # do-while body once before the back-edge test
                        bound = (lim - init) // step + 1 \
                            if lim >= init else 1
                    elif alu_op == op_le and step < 0:
                        # continue while lim < ctr (le is STRICT signed
                        # <, alu.v:25-27): ctr = init, init+step, ...
                        # stops once ctr <= lim
                        bound = (init - lim - 1) // (-step) + 1 \
                            if lim < init else 1
                    # the formulas assume the int32 counter never wraps:
                    # if the final value leaves the register range, the
                    # wrapped comparison re-enters the loop and the trip
                    # count is NOT the closed form — fall back rather
                    # than under-size the execution budget
                    if bound is not None and not (
                            -2**31 <= init + bound * step < 2**31):
                        bound = None
            loops.append((t, j, bound))
        return loops

    def static_bounds(self, loop_fallback: int = 64,
                      slack: int = 16) -> dict:
        """Execution-budget sizing from static loop analysis.

        Returns ``{'max_steps', 'max_pulses'}``: each instruction's step
        and pulse cost is multiplied by the product of iteration counts
        of the analyzable loops enclosing it (``loop_fallback`` where a
        back-edge defeats analysis) — replacing the old one-size
        ``64 * n_instr`` heuristic that silently truncated deep loops
        (round-1 review item).
        """
        kind = np.asarray(self.soa.kind)
        C, N = kind.shape
        worst_steps, worst_pulses = 0, 0
        for c in range(C):
            mult = np.ones(N, dtype=np.int64)
            for (t, j, bound) in self.loop_bounds(c):
                mult[t:j + 1] *= bound if bound else loop_fallback
            # fproc/unconditional back-edges (e.g. measurement retry,
            # poll loops exiting via a forward jump) aren't loops the
            # analysis bounds; apply the fallback over their span
            for j in range(N):
                if kind[c, j] in (isa.K_JUMP_FPROC, isa.K_JUMP_I) \
                        and int(self.soa.jump_addr[c, j]) <= j:
                    t = int(self.soa.jump_addr[c, j])
                    mult[t:j + 1] *= loop_fallback
            live = kind[c] != isa.K_DONE
            worst_steps = max(worst_steps, int(np.sum(mult[live])))
            worst_pulses = max(worst_pulses, int(np.sum(
                mult[kind[c] == isa.K_PULSE_TRIG])))
        return {'max_steps': worst_steps + slack,
                'max_pulses': max(worst_pulses, 1) + 2}


class ProgramValidationError(ValueError):
    """A machine program failed static validation.

    ``errors`` is a list of ``(code, core, instr, message)`` tuples —
    one per defect, with instruction coordinates — so callers (CLI
    pre-flight, the fault-injection harness) can match on the failure
    kind instead of parsing the message.  ``core``/``instr`` may be
    ``None`` for program-wide defects (e.g. inconsistent sync sets).
    """

    def __init__(self, errors):
        self.errors = list(errors)
        lines = [f'[{code}] core={core} instr={instr}: {msg}'
                 for code, core, instr, msg in self.errors]
        super().__init__('program validation failed:\n  '
                         + '\n  '.join(lines))

    def __reduce__(self):
        # rebuild from the structured error list, not the rendered
        # message — default exception pickling would replay __init__
        # with the message string and corrupt ``errors`` on the far
        # side of the fleet wire (serve/transport.py)
        return (ProgramValidationError, (self.errors,))

    @property
    def codes(self) -> set:
        return {e[0] for e in self.errors}


def _core_validation_errors(soa, core: int, cfg=None) -> list:
    """Static defects of one core's ``[n_instr]`` instruction stream."""
    kind = np.asarray(soa.kind[core])
    jump_addr = np.asarray(soa.jump_addr[core])
    N = len(kind)
    errs = []
    jump_kinds = (isa.K_JUMP_I, isa.K_JUMP_COND, isa.K_JUMP_FPROC)
    exit_kinds = {isa.K_JUMP_COND, isa.K_JUMP_FPROC, isa.K_DONE}

    bad_kind = (kind < 0) | (kind >= isa.N_KINDS)
    for j in np.nonzero(bad_kind)[0]:
        errs.append(('illegal_op', core, int(j),
                     f'kind {int(kind[j])} outside [0, {isa.N_KINDS})'))

    for j in np.nonzero(np.isin(kind, jump_kinds))[0]:
        t = int(jump_addr[j])
        if not 0 <= t < N:
            errs.append(('jump_oob', core, int(j),
                         f'jump target {t} outside [0, {N})'))

    if not np.any(kind == isa.K_DONE):
        errs.append(('no_done', core, None,
                     'no DONE instruction — execution runs off the end '
                     'of the command buffer'))

    # provably infinite loop: a backward jump_i whose body [t, j] has no
    # possible exit — no conditional/fproc branch, no DONE, and every
    # other unconditional jump stays inside the body.  (Backward
    # jump_fproc loops — the active-reset retry idiom — always have a
    # data-dependent exit and are NOT flagged.)
    for j in np.nonzero(kind == isa.K_JUMP_I)[0]:
        t = int(jump_addr[j])
        if not 0 <= t <= j:
            continue
        body = range(t, int(j) + 1)
        if any(int(kind[i]) in exit_kinds for i in body):
            continue
        if any(int(kind[i]) == isa.K_JUMP_I
               and not t <= int(jump_addr[i]) <= j for i in body):
            continue
        errs.append(('infinite_loop', core, int(j),
                     f'unconditional backward jump to {t} encloses no '
                     f'exit — provably infinite'))

    if cfg is not None:
        n_cores = np.asarray(soa.kind).shape[0] if soa.kind.ndim > 1 \
            else 1
        fmask = np.isin(kind, (isa.K_ALU_FPROC, isa.K_JUMP_FPROC))
        fids = np.asarray(soa.func_id[core])
        fabric = getattr(cfg, 'fabric', 'sticky')
        for j in np.nonzero(fmask)[0]:
            fid = int(fids[j])
            if fabric == 'lut':
                # lut fabric: func_id 0 = own fresh result, nonzero =
                # the LUT output — which must actually be configured
                if fid != 0 and (len(getattr(cfg, 'lut_mask', ()))
                                 != n_cores
                                 or not getattr(cfg, 'lut_table', ())):
                    errs.append(('fproc_unreachable', core, int(j),
                                 f'func_id {fid} reads the LUT but '
                                 f'lut_mask/lut_table are not '
                                 f'configured'))
            elif not 0 <= fid < n_cores:
                errs.append(('fproc_unreachable', core, int(j),
                             f'func_id {fid} outside [0, {n_cores}) — '
                             f'no core produces this result'))
    return errs


def validate_program(mp, cfg=None) -> None:
    """Pre-flight static validation — defects caught here never reach a
    jit, never burn a dispatch, and carry instruction coordinates the
    runtime fault word cannot.

    Checks, per core: instruction kinds decodable (``illegal_op``),
    jump targets inside ``[0, n_instr)`` (``jump_oob``), a DONE
    instruction present (``no_done``), no provably infinite
    unconditional loop (``infinite_loop``); with ``cfg`` given, fproc
    reads must name a producing core — or a configured LUT under
    ``fabric='lut'`` (``fproc_unreachable``).  Across cores: if every
    SYNC participant is branch-free, their barrier sequences must agree
    (``sync_mismatch``) — a shorter partner parks the others at a
    barrier that can never fill (runtime ``FAULT_SYNC_DEADLOCK``).
    Data-dependent behavior (fproc-driven back-edges, register-bounded
    loops) is deliberately NOT flagged: the validator only rejects
    programs that are wrong on EVERY input; everything else is the
    runtime fault word's job.

    Accepts a :class:`MachineProgram` or a stacked
    :class:`MultiMachineProgram` (every ensemble member is validated).
    Raises :class:`ProgramValidationError` listing ALL defects.
    """
    kind_all = np.asarray(mp.soa.kind)
    multi = kind_all.ndim == 3
    errors = []
    for p in range(kind_all.shape[0] if multi else 1):
        soa = isa.SoAProgram(**{k: v[p] for k, v in
                                mp.soa.asdict().items()}) \
            if multi else mp.soa
        kind = np.asarray(soa.kind)
        C, N = kind.shape
        errs = []
        for c in range(C):
            errs.extend(_core_validation_errors(soa, c, cfg=cfg))
        # sync consistency: statically decidable only when every
        # participant is branch-free (its barrier sequence is the
        # textual one); any branch makes the sequence data-dependent
        part = np.nonzero(np.any(kind == isa.K_SYNC, axis=1))[0]
        if len(part) > 1:
            jump_kinds = (isa.K_JUMP_I, isa.K_JUMP_COND,
                          isa.K_JUMP_FPROC)
            if not any(np.any(np.isin(kind[c], jump_kinds))
                       for c in part):
                seqs = {c: tuple(
                    int(b) for b in np.asarray(soa.barrier[c])[
                        kind[c] == isa.K_SYNC]) for c in part}
                ref_c = int(part[0])
                for c in part[1:]:
                    if seqs[int(c)] != seqs[ref_c]:
                        errs.append((
                            'sync_mismatch', int(c), None,
                            f'barrier sequence {seqs[int(c)]} != core '
                            f'{ref_c}\'s {seqs[ref_c]} — the longer '
                            f'sequence waits at a barrier that never '
                            f'fills'))
        if multi:
            errs = [(code, (p, core) if core is not None else p,
                     instr, msg) for code, core, instr, msg in errs]
        errors.extend(errs)
    if errors:
        raise ProgramValidationError(errors)


def extract_blocks(mp: 'MachineProgram') -> list:
    """Per-core CFG extraction: partition each core's instruction range
    into maximal straight-line blocks.

    A block ends at a control-transfer / cross-core instruction
    (:data:`~distributed_processor_tpu_torch.isa.BLOCK_TERMINATORS` plus
    DONE — the per-core analog of the reference cores retiring at a
    branch, `hdl/proc.sv` instruction loop) or just before a jump
    TARGET (every branch destination starts a block).  Returns one
    int32 ``[n_blocks, 3]`` array per core, rows ``(start, length,
    kind)`` where ``kind`` is the terminating instruction's kind or
    ``-1`` for a fall-through block (split only by an incoming edge).

    Invariants (fuzz-pinned in tests/test_blocks.py): the blocks of a
    core partition ``[0, n_instr)`` exactly, in order, and every jump
    target within range is a block start.

    This is the analysis view; the interpreter's runtime layout —
    union-refined across cores and content-deduplicated — is
    :func:`~distributed_processor_tpu_torch.isa.build_block_table`.
    """
    kind = np.asarray(mp.soa.kind)
    jump_addr = np.asarray(mp.soa.jump_addr)
    C, N = kind.shape
    enders = set(isa.BLOCK_TERMINATORS) | {isa.K_DONE}
    out = []
    for c in range(C):
        kc = kind[c]
        term = np.isin(kc, list(enders))
        jmask = (kc == isa.K_JUMP_I) | (kc == isa.K_JUMP_COND) \
            | (kc == isa.K_JUMP_FPROC)
        leaders = {0}
        leaders.update(int(t) for t in jump_addr[c][jmask]
                       if 0 <= int(t) < N)
        leaders.update(int(i) + 1 for i in np.nonzero(term)[0]
                       if int(i) + 1 < N)
        bounds = sorted(leaders) + [N]
        rows = []
        for s, e in zip(bounds, bounds[1:]):
            k = int(kc[e - 1]) if term[e - 1] else -1
            rows.append((s, e - s, k))
        out.append(np.asarray(rows, dtype=np.int32).reshape(-1, 3))
    return out


@dataclass
class MultiMachineProgram:
    """A stacked ensemble of decoded machine programs — program-as-data.

    ``soa`` carries ``[n_progs, n_cores, n_instr]`` field arrays
    (DONE-padded into a shared shape bucket, see
    :func:`~distributed_processor_tpu_torch.isa.shape_bucket`); element tables
    are validated identical across the ensemble so the interpreter's
    per-core constants stay unbatched.  The attribute surface mirrors
    :class:`MachineProgram` (``soa``/``tables``/``n_cores``/
    ``sync_participants``) so the interpreter's constant/traits helpers
    work on either.
    """
    soa: isa.SoAProgram          # [n_progs, n_cores, n_instr]
    p_elem: np.ndarray           # [n_progs, n_cores, n_instr]
    p_dur: np.ndarray            # [n_progs, n_cores, n_instr]
    tables: list                 # CoreTables per core (ensemble-shared)
    core_inds: list

    @property
    def n_progs(self) -> int:
        return self.soa.kind.shape[0]

    @property
    def n_cores(self) -> int:
        return self.soa.kind.shape[1]

    @property
    def n_instr(self) -> int:
        return self.soa.kind.shape[2]

    @property
    def sync_participants(self) -> np.ndarray:
        """Bool[n_progs, n_cores]: cores with a SYNC instruction."""
        return np.any(self.soa.kind == isa.K_SYNC, axis=2)


def stack_machine_programs(mps: list, pad_to: int = None,
                           bucket: bool = True) -> MultiMachineProgram:
    """Stack decoded :class:`MachineProgram`\\ s into one
    :class:`MultiMachineProgram`.

    ``bucket=True`` (default) pads ``n_instr`` up to the next power of
    two — the shape-bucket policy that lets every same-band ensemble
    share one compiled executable (``pad_to`` raises the floor further).
    Programs must agree on core count and element geometry: the
    ensemble shares one set of per-core sample-rate constants, and a
    mismatch would silently mistime pulses.  A mismatch raises
    ``ValueError`` naming the offending program INDEX, so batching
    callers (the serving runtime's coalescer) can reject the one bad
    submission instead of surfacing a shape error from deep inside a
    jit.
    """
    if not mps:
        raise ValueError('need at least one MachineProgram to stack')
    first = mps[0]
    geom = [(ec.samples_per_clk, ec.interp_ratio)
            for t in first.tables for ec in t.elem_cfgs]
    for i, mp in enumerate(mps[1:], start=1):
        if mp.n_cores != first.n_cores:
            raise ValueError(
                f'core-count mismatch in ensemble: program {i} has '
                f'{mp.n_cores} cores != program 0\'s {first.n_cores}')
        g = [(ec.samples_per_clk, ec.interp_ratio)
             for t in mp.tables for ec in t.elem_cfgs]
        if g != geom:
            raise ValueError(
                f'element geometry of program {i} differs from program '
                f'0\'s — stacked programs share per-core sample-rate '
                f'constants')
    n = max(mp.n_instr for mp in mps)
    if pad_to is not None:
        n = max(n, pad_to)
    if bucket:
        n = isa.shape_bucket(n)
    soa = isa.stack_soa_multi([mp.soa for mp in mps], pad_to=n)
    P, C, N = soa.kind.shape
    p_elem = np.zeros((P, C, N), np.int32)
    p_dur = np.zeros((P, C, N), np.int32)
    for i, mp in enumerate(mps):
        p_elem[i, :, :mp.n_instr] = mp.p_elem
        p_dur[i, :, :mp.n_instr] = mp.p_dur
    return MultiMachineProgram(soa=soa, p_elem=p_elem, p_dur=p_dur,
                               tables=first.tables,
                               core_inds=list(first.core_inds))


def machine_program_from_cmds(cmds_per_core, elem_cfgs=None,
                              pad_to: int = None) -> MachineProgram:
    """Build a MachineProgram directly from per-core 128-bit command lists.

    The raw-command analog of the reference's cocotb `load_commands` path
    (reference: cocotb/proc/test_proc.py:29-38): tests hand-assemble
    commands and run them without the compiler.  ``elem_cfgs``: element
    configs shared by every core; defaults to the standard qdrv/rdrv/rdlo
    geometry (16/16/4 samples per clock).
    """
    if elem_cfgs is None:
        elem_cfgs = [TPUElementConfig(samples_per_clk=16),
                     TPUElementConfig(samples_per_clk=16),
                     TPUElementConfig(samples_per_clk=4)]
    soas = []
    for cmds in cmds_per_core:
        if isinstance(cmds, (bytes, bytearray)):
            soas.append(isa.decode_soa(cmds))
        else:
            soas.append(isa.decode_soa(isa.cmds_to_bytes(cmds)))
    soa = isa.stack_soa(soas, pad_to=pad_to)
    n_cores, n_instr = soa.kind.shape
    tables = [CoreTables(envs=[np.zeros(0, complex)] * len(elem_cfgs),
                         freqs=[{'freq': np.zeros(0), 'iq15': np.zeros((0, 15))}] * len(elem_cfgs),
                         elem_cfgs=list(elem_cfgs))
              for _ in range(n_cores)]
    return MachineProgram(soa=soa,
                          p_elem=np.zeros((n_cores, n_instr), dtype=np.int32),
                          p_dur=np.zeros((n_cores, n_instr), dtype=np.int32),
                          tables=tables, core_inds=list(range(n_cores)))


def _pulse_duration_clks(env_word: int, cfg: TPUElementConfig) -> int:
    """Pulse duration in FPGA clocks from the env word length field."""
    _, n_samples, is_cw = cfg.env_word_fields(env_word)
    if is_cw:
        return 0
    # env samples are consumed at sample_freq / interp_ratio; one clock
    # covers samples_per_clk / interp_ratio of them
    return int(np.ceil(n_samples * cfg.interp_ratio / cfg.samples_per_clk))


def decode_assembled_program(assembled: dict, channel_configs: dict = None,
                             elem_cfgs_by_core: dict = None,
                             pad_to: int = None,
                             reg_maps: dict = None) -> MachineProgram:
    """Decode a ``GlobalAssembler.get_assembled_program()`` result.

    Element configs are needed to derive pulse durations and decode the
    env/freq buffers; provide them either via ``channel_configs`` (the same
    dict handed to GlobalAssembler, TPUElementConfig is assumed) or as an
    explicit ``{core_ind: [ElementConfig, ...]}`` mapping.
    ``reg_maps``: ``GlobalAssembler.register_maps`` — attach it so
    :func:`make_init_regs` can target declared variables by name.
    """
    core_inds = sorted(assembled, key=lambda k: int(k))
    if elem_cfgs_by_core is None:
        elem_cfgs_by_core = {}
        if channel_configs is not None:
            for chan, cfg in channel_configs.items():
                if not hasattr(cfg, 'elem_ind'):
                    continue
                per_core = elem_cfgs_by_core.setdefault(str(cfg.core_ind), {})
                per_core[cfg.elem_ind] = TPUElementConfig(**cfg.elem_params)
            elem_cfgs_by_core = {
                core: [cfgs[i] for i in sorted(cfgs)]
                for core, cfgs in elem_cfgs_by_core.items()}

    soas, tables = [], []
    for core in core_inds:
        entry = assembled[core]
        soas.append(isa.decode_soa(entry['cmd_buf']))
        cfgs = elem_cfgs_by_core.get(str(core), [])
        envs, freqs = [], []
        for e, cfg in enumerate(cfgs):
            env_buf = entry['env_buffers'][e] if e < len(entry['env_buffers']) else b''
            freq_buf = entry['freq_buffers'][e] if e < len(entry['freq_buffers']) else b''
            envs.append(parse_env_buffer(env_buf))
            freqs.append(parse_freq_buffer(freq_buf, cfg.sample_freq)
                         if len(freq_buf) >= 4 * FREQ_BUF_WORDS
                         else {'freq': np.zeros(0), 'iq15': np.zeros((0, 15))})
        tables.append(CoreTables(envs=envs, freqs=freqs, elem_cfgs=cfgs))

    soa = isa.stack_soa(soas, pad_to=pad_to)
    n_cores, n_instr = soa.kind.shape
    p_elem = np.zeros((n_cores, n_instr), dtype=np.int32)
    p_dur = np.zeros((n_cores, n_instr), dtype=np.int32)
    for c, core in enumerate(core_inds):
        cfgs = tables[c].elem_cfgs
        is_pulse = (soa.kind[c] == isa.K_PULSE_TRIG) | (soa.kind[c] == isa.K_PULSE_WRITE)
        for i in np.nonzero(is_pulse)[0]:
            elem = int(soa.p_cfg[c, i]) & 0b11   # cfg word low bits = element
            p_elem[c, i] = elem
            if elem < len(cfgs) and (soa.p_wen[c, i] >> 0) & 1:  # env written
                p_dur[c, i] = _pulse_duration_clks(int(soa.p_env[c, i]), cfgs[elem])
    return MachineProgram(soa=soa, p_elem=p_elem, p_dur=p_dur,
                          tables=tables,
                          core_inds=[int(c) for c in core_inds],
                          reg_maps=[dict((reg_maps or {}).get(c, {}))
                                    for c in core_inds])


def make_init_regs(mp: MachineProgram, assignments: dict,
                   n_shots: int = None) -> np.ndarray:
    """Register file preloading named program variables.

    ``assignments``: ``{var_name: value}`` where a value is a scalar or
    a ``[n_shots]`` array (sweep axis).  Physical values are converted
    to words by the variable's declared dtype and the core's element
    config: ``('amp', e)`` floats in [0, 1] -> 16-bit amp words,
    ``('phase', e)`` radians -> 17-bit phase words, ``('int',)``
    passthrough.  Each variable is written on every core that declared
    it.  Returns ``[n_cores, N_REGS]`` int32, or
    ``[n_shots, n_cores, N_REGS]`` when ``n_shots`` is given — feed to
    ``simulate``/``simulate_batch``/``run_physics_batch`` ``init_regs``.

    This is the simulator-side analog of the reference host writing
    parameter registers over the FPGA bus before triggering a run.
    """
    from . import isa as _isa
    if not mp.reg_maps or not any(mp.reg_maps):
        raise ValueError(
            'program declares no variables (reg_maps empty) — either it '
            'declares none, or decode_assembled_program was called '
            'without reg_maps=GlobalAssembler.register_maps '
            '(pipeline.compile_to_machine threads it automatically)')
    shape = ((n_shots, mp.n_cores, _isa.N_REGS) if n_shots is not None
             else (mp.n_cores, _isa.N_REGS))
    regs = np.zeros(shape, np.int32)

    def to_word(val, dtype, cfgs):
        # array-wise mirrors of ElementConfig.get_amp_word /
        # get_phase_word (elements.py) — the scalar methods would cost a
        # Python call per shot on million-shot sweep axes
        kind = dtype[0]
        if kind == 'int':
            return np.asarray(val).astype(np.int64)
        elem = int(dtype[1])
        if elem >= len(cfgs):
            raise ValueError(f'dtype {dtype}: core has no element {elem}')
        from .elements import AMP_BITS, PHASE_BITS
        v = np.asarray(val, float)
        if kind == 'amp':
            if np.any((v < 0) | (v > 1)):
                raise ValueError(f'amplitudes must be in [0, 1]: {v}')
            return np.round(v * ((1 << AMP_BITS) - 1)).astype(np.int64)
        frac = (v / (2 * np.pi)) % 1.0
        return np.round(frac * (1 << PHASE_BITS)).astype(np.int64) \
            % (1 << PHASE_BITS)

    for name, val in assignments.items():
        val_arr = np.asarray(val)
        if val_arr.ndim > 1 or (val_arr.ndim == 1 and n_shots is None):
            raise ValueError(
                f'{name!r}: array values need n_shots= (got shape '
                f'{val_arr.shape}, n_shots={n_shots})')
        if val_arr.ndim == 1 and n_shots is not None \
                and val_arr.shape[0] != n_shots:
            raise ValueError(
                f'{name!r}: value length {val_arr.shape[0]} != '
                f'n_shots {n_shots}')
        hit = False
        for c, rm in enumerate(mp.reg_maps):
            if name not in rm:
                continue
            hit = True
            word = to_word(val, tuple(rm[name]['dtype']),
                           mp.tables[c].elem_cfgs)
            word = (word.astype(np.int64) & 0xffffffff).astype(np.int64)
            word = word.astype(np.uint32).view(np.int32)
            regs[..., c, rm[name]['index']] = word
        if not hit:
            raise KeyError(f'variable {name!r} not declared by any core; '
                           f'declared: '
                           f'{sorted(set().union(*map(set, mp.reg_maps)))}')
    return regs


def machine_program_to_arrays(mp) -> dict:
    """A :class:`MachineProgram` as plain numpy arrays and lists — the
    inverse of :func:`machine_program_from_arrays`.

    Reads attributes only, so it accepts any object with the
    ``MachineProgram`` layout (``soa`` fields, ``p_elem``, ``p_dur``,
    per-core ``tables``, ``core_inds``, ``reg_maps``)."""
    return {
        'soa': {f: np.array(getattr(mp.soa, f), np.int32)
                for f in isa.SOA_FIELDS},
        'p_elem': np.array(mp.p_elem, np.int32),
        'p_dur': np.array(mp.p_dur, np.int32),
        'tables': [{
            'envs': [np.array(e) for e in t.envs],
            'freqs': [{'freq': np.array(f['freq']),
                       'iq15': np.array(f['iq15'])} for f in t.freqs],
            'elem_cfgs': [{'samples_per_clk': int(ec.samples_per_clk),
                           'interp_ratio': int(ec.interp_ratio),
                           'fpga_clk_period': float(ec.fpga_clk_period)}
                          for ec in t.elem_cfgs],
        } for t in mp.tables],
        'core_inds': [int(c) for c in mp.core_inds],
        'reg_maps': None if mp.reg_maps is None
        else [dict(rm) for rm in mp.reg_maps],
    }


def machine_program_from_arrays(d: dict) -> MachineProgram:
    """Build a :class:`MachineProgram` from the numpy fields of
    :func:`machine_program_to_arrays` — the way a program compiled
    elsewhere (the JAX package, a file) enters this package."""
    soa = isa.SoAProgram(**{f: np.ascontiguousarray(d['soa'][f], np.int32)
                            for f in isa.SOA_FIELDS})
    tables = [CoreTables(
        envs=[np.asarray(e) for e in t['envs']],
        freqs=[{'freq': np.asarray(f['freq']), 'iq15': np.asarray(f['iq15'])}
               for f in t['freqs']],
        elem_cfgs=[TPUElementConfig(**ec) for ec in t['elem_cfgs']])
        for t in d['tables']]
    return MachineProgram(
        soa=soa, p_elem=np.asarray(d['p_elem'], np.int32),
        p_dur=np.asarray(d['p_dur'], np.int32), tables=tables,
        core_inds=[int(c) for c in d['core_inds']],
        reg_maps=None if d.get('reg_maps') is None
        else [dict(rm) for rm in d['reg_maps']])
