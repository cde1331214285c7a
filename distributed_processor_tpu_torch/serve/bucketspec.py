"""BucketSpec: the serving tier's executable identity, as a value.

The coalescer, warmup, the benches, and the catalog all need to talk
about "which compiled executable would this request dispatch into?".
Before this module that identity was an ad-hoc tuple only
``batcher.bucket_key`` produced and only the Coalescer consumed; AOT
precompilation (docs/SERVING.md "cold start & warmup") needs the same
identity to be

* **hashable/comparable** — it is the coalescing dict key and the AOT
  cache key;
* **serializable** — the learned bucket catalog (`serve/catalog.py`)
  persists it as JSON and replays it in a different process;
* **bindable** — the coalescing key deliberately excludes batch
  occupancy and shot count (short requests pad up), but a dispatch's
  working set is shape-exact, so warmup *binds* the template to
  concrete ``(n_programs, n_shots)`` before warming it.

A spec is a frozen dataclass in two states: the **unbound template**
(``n_programs``/``n_shots`` are None) is what ``bucket_key`` returns
and what buckets coalesce under; :meth:`bind` produces the **bound**
spec that names one exact executable, which is what
``sim.interpreter.aot_compile_batch`` compiles and the catalog stores.

``traits`` (:func:`~..sim.interpreter.program_traits`, the instruction
kinds the engine's step branches on) rides along for AOT exactness but is deliberately excluded
from equality/hash (``compare=False``): the coalescing contract lets
programs with different instruction mixes share a batch (the stacked
dispatch uses the trait UNION over members, the ensemble semantics
of ``simulate_multi_batch``), and keying coalescing on traits would
silently split such batches.  The AOT cache and the catalog key
on ``traits`` explicitly where the exact executable matters.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace

from .. import isa
from ..sim.interpreter import InterpreterConfig, program_traits

# bump when the JSON layout changes; loaders reject other versions
SPEC_VERSION = 1

# InterpreterConfig fields that arrive from JSON as lists but must be
# tuples to restore hashability
_CFG_TUPLE_FIELDS = ('lut_mask', 'lut_table')


@dataclass(frozen=True)
class BucketSpec:
    """One serving bucket's executable identity.

    ``geometry`` is per-core nested — ``((samples_per_clk,
    interp_ratio), ...)`` per element table — so the stacked
    ``[n_cores, max_elems]`` constant shapes are reconstructible from
    the spec alone (the old flat tuple lost the per-core grouping).
    """
    n_cores: int
    n_instr_bucket: int
    geometry: tuple                    # per core: ((spc, interp), ...)
    cfg: InterpreterConfig             # normalized dispatch cfg
    # program_traits(): (kinds, b, b) — informational for coalescing
    # (compare=False, see module docstring), exact for AOT/catalog
    traits: tuple = field(default=None, compare=False)
    # binding: None = unbound coalescing template
    n_programs: int = None             # padded program-axis occupancy
    n_shots: int = None                # padded shot count
    has_init_regs: bool = False

    # -- construction --------------------------------------------------

    @classmethod
    def from_program(cls, mp, cfg: InterpreterConfig) -> 'BucketSpec':
        """Unbound template for one machine program under ``cfg``
        (``cfg`` must already be normalized — the service's
        ``_normalize_cfg`` output)."""
        geom = tuple(tuple((int(ec.samples_per_clk), int(ec.interp_ratio))
                           for ec in t.elem_cfgs) for t in mp.tables)
        return cls(int(mp.n_cores), int(isa.shape_bucket(mp.n_instr)),
                   geom, cfg, program_traits(mp))

    def bind(self, *, n_programs: int, n_shots: int,
             has_init_regs: bool = False) -> 'BucketSpec':
        """The bound spec naming one exact executable."""
        return replace(self, n_programs=int(n_programs),
                       n_shots=int(n_shots),
                       has_init_regs=bool(has_init_regs))

    def template(self) -> 'BucketSpec':
        """Back to the unbound coalescing key."""
        if self.n_programs is None and self.n_shots is None \
                and not self.has_init_regs:
            return self
        return replace(self, n_programs=None, n_shots=None,
                       has_init_regs=False)

    # -- derived views -------------------------------------------------

    @property
    def bound(self) -> bool:
        return self.n_programs is not None and self.n_shots is not None

    @property
    def max_elems(self) -> int:
        """Element axis of the stacked per-core constant tables."""
        return max((len(g) for g in self.geometry), default=0) or 1

    def label(self) -> str:
        """Human/stats label; bound specs carry their occupancy."""
        s = f'c{self.n_cores}i{self.n_instr_bucket}'
        if self.bound:
            s += f'p{self.n_programs}s{self.n_shots}'
        return s

    def identity(self) -> tuple:
        """Exact executable identity: spec equality PLUS traits (which
        ``__eq__`` deliberately ignores) — the dedup key wherever the
        precise compiled artifact matters (catalog entries, the
        service's recorded-spec set)."""
        return (self, self.traits)

    def shape_sig(self) -> tuple:
        """The dispatch-shape signature the service's cold/warm
        classifier records — must mirror ``_run_batch``'s
        ``('multi', P, B, init is None)``."""
        return ('multi', self.n_programs, self.n_shots,
                not self.has_init_regs)

    # -- JSON ----------------------------------------------------------

    def to_json(self) -> dict:
        kinds, in0_reg, p_regsel = (self.traits if self.traits is not None
                                    else (None, None, None))
        return {
            'version': SPEC_VERSION,
            'n_cores': self.n_cores,
            'n_instr_bucket': self.n_instr_bucket,
            'geometry': [[list(pair) for pair in core]
                         for core in self.geometry],
            'cfg': asdict(self.cfg),
            'traits': None if self.traits is None else
                [sorted(int(k) for k in kinds), bool(in0_reg),
                 bool(p_regsel)],
            'n_programs': self.n_programs,
            'n_shots': self.n_shots,
            'has_init_regs': self.has_init_regs,
        }

    @classmethod
    def from_json(cls, d: dict) -> 'BucketSpec':
        if d.get('version') != SPEC_VERSION:
            raise ValueError(f'BucketSpec version {d.get("version")!r} '
                             f'!= {SPEC_VERSION}')
        cfg_d = dict(d['cfg'])
        for k in _CFG_TUPLE_FIELDS:
            if k in cfg_d and cfg_d[k] is not None:
                cfg_d[k] = tuple(cfg_d[k])
        cfg = InterpreterConfig(**cfg_d)
        traits = d.get('traits')
        if traits is not None:
            traits = (frozenset(int(k) for k in traits[0]),
                      bool(traits[1]), bool(traits[2]))
        geom = tuple(tuple(tuple(int(x) for x in pair) for pair in core)
                     for core in d['geometry'])
        np_, ns = d.get('n_programs'), d.get('n_shots')
        return cls(int(d['n_cores']), int(d['n_instr_bucket']), geom,
                   cfg, traits,
                   None if np_ is None else int(np_),
                   None if ns is None else int(ns),
                   bool(d.get('has_init_regs', False)))
