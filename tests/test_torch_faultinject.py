"""The port's fault-injection harness (``sim/faultinject.py``) against
the JAX package's.

The mutant corpus is JAX's word for word (names, 128-bit words, every
config field, the oracle); on one mutant of each mutator the port's
verdict and each engine's fault-name set equal JAX's; the port's fuzz
reproduces JAX's verdict counts; and the consistency checks (vmap,
fused, feedback, audit, mesh) report no failure.  On the CPU the
``pallas`` and ``fused`` engines run K1's and K3's plain versions (JAX
runs its Pallas kernel in interpret mode).
"""

import dataclasses

import numpy as np
import pytest

from distributed_processor_tpu.decoder import \
    machine_program_from_cmds as j_from_cmds
from distributed_processor_tpu.sim import faultinject as jfi
from distributed_processor_tpu.sim.interpreter import \
    simulate_batch as j_simulate_batch

from distributed_processor_tpu_torch.decoder import \
    machine_program_from_cmds
from distributed_processor_tpu_torch.sim import faultinject as fi
from distributed_processor_tpu_torch.sim.interpreter import simulate_batch

from test_torch_spmd_worker import run_spmd

pytestmark = pytest.mark.faults


def test_tables_equal_jax():
    assert fi.ENGINES == jfi.ENGINES
    assert fi._TIMING_INDEPENDENT == jfi._TIMING_INDEPENDENT
    assert fi._ALL_OUTCOMES == jfi._ALL_OUTCOMES
    assert [n for n, _ in fi.MUTATORS] == [n for n, _ in jfi.MUTATORS]
    assert [n for n, _ in fi.BASE_BUILDERS] \
        == [n for n, _ in jfi.BASE_BUILDERS]


def test_corpus_equals_jax():
    got, want = fi.gen_mutants(0, 35), jfi.gen_mutants(0, 35)
    assert len(got) == len(want) == 35
    assert any(m.name.startswith('lut+') for m in got)
    for m, j in zip(got, want):
        assert m.name == j.name
        assert [[int(w) for w in core] for core in m.cmds] \
            == [[int(w) for w in core] for core in j.cmds], m.name
        assert dataclasses.asdict(m.cfg) == dataclasses.asdict(j.cfg), m.name
        assert m.expected == j.expected and m.allow_clean == j.allow_clean


def _first_of_each_mutator():
    out = {}
    for m in fi.gen_mutants(0, 35):
        out.setdefault(m.name.split('+')[1].split('#')[0], m.name)
    return [out[n] for n, _ in fi.MUTATORS]


def _engine_faults(mod, from_cmds, simulate, m, **kw) -> dict:
    """Each engine's fault-name set on the mutant, as ``check_mutant``
    computes it (None where the engine is ineligible or the program is
    rejected before it runs)."""
    try:
        mp = from_cmds(m.cmds)
        mod.validate_program(mp, m.cfg)
    except (ValueError, OverflowError):
        return None
    mb = np.zeros((4, mp.n_cores, m.cfg.max_meas), np.int32)
    names = {}
    for eng in fi.ENGINES:
        try:
            out = simulate(mp, mb, cfg=dataclasses.replace(m.cfg, engine=eng),
                           **kw)
        except ValueError as e:
            assert 'ineligible' in str(e), (eng, e)
            continue
        names[eng] = mod._fault_names(out['fault'])
    return names


@pytest.mark.parametrize('name', _first_of_each_mutator())
def test_mutant_verdict_equals_jax(name):
    m = next(x for x in fi.gen_mutants(0, 35) if x.name == name)
    j = next(x for x in jfi.gen_mutants(0, 35) if x.name == name)
    got = fi.check_mutant(m, device='cpu')
    want = jfi.check_mutant(j)
    assert got == want
    assert got['verdict'] in ('rejected_decode', 'rejected_validator',
                              'trapped', 'benign')
    assert _engine_faults(fi, machine_program_from_cmds, simulate_batch, m,
                          device='cpu') \
        == _engine_faults(jfi, j_from_cmds, j_simulate_batch, j)


def test_fuzz_counts_equal_jax():
    """JAX's ``run_fuzz(seed=0, n=28)`` gives 8 benign, 9
    rejected_validator and 11 trapped on this corpus."""
    rep = fi.run_fuzz(seed=0, n=28, device='cpu')
    assert rep.ok, rep.failures
    assert rep.n == 28
    assert rep.verdicts == {'benign': 8, 'rejected_validator': 9,
                            'trapped': 11}


def test_fuzz_with_the_span_kernels():
    """K1's engine beside the other three on every mutant (its plain
    versions here; the kernels on the card)."""
    rep = fi.run_fuzz(seed=0, n=35, engines=fi.ENGINES + ('pallas',),
                      device='cpu')
    assert rep.ok, rep.failures
    assert sum(rep.verdicts.values()) == 35


def test_fuzz_reports_a_silent_mutant(monkeypatch):
    """The harness can fail: an engine that runs a record-starved
    mutant clean where the oracle demands a trap is SILENT."""
    m = next(x for x in fi.gen_mutants(0, 35)
             if x.name == 'linear+overflow_records#6')
    assert fi.check_mutant(m, device='cpu')['verdict'] == 'trapped'
    real = fi.simulate_batch

    def clean(mp, mb, cfg=None, device=None):
        out = real(mp, mb, cfg=cfg, device=device)
        out['fault'] = out['fault'] * 0
        return out
    monkeypatch.setattr(fi, 'simulate_batch', clean)
    assert fi.check_mutant(m, device='cpu')['verdict'] == 'SILENT'


def test_consistency_checks():
    assert fi.check_vmap_consistency(0, 4, device='cpu') == 0
    for check, n in ((fi.check_fused_consistency, 12),
                     (fi.check_feedback_consistency, 8)):
        res = check(0, n, device='cpu')
        assert res['failures'] == [], (check.__name__, res)
        assert res['checked'] > 0 and res['checked'] + res['skipped'] == n
    aud = fi.check_audit_consistency(0, 8, device='cpu')
    assert aud['false_positives'] == 0 and aud['checked'] > 0
    assert aud['audits'] >= 1


def test_consistency_checks_equal_jax_counts():
    """The fused and feedback checks skip and check the same mutants as
    JAX's: ``check_fused_consistency(0, 12)`` checks 3 and skips 9,
    ``check_feedback_consistency(0, 8)`` checks 5 and skips 3 in the JAX
    package (measured on this corpus; its Pallas interpret mode takes
    about a minute, so the JAX side is not rerun here)."""
    for check, n, want in ((fi.check_fused_consistency, 12, (3, 9)),
                           (fi.check_feedback_consistency, 8, (5, 3))):
        got = check(0, n, device='cpu')
        assert (got['checked'], got['skipped']) == want, check.__name__


def test_mesh_consistency_one_rank():
    assert fi.check_mesh_consistency(device='cpu') == -1


def test_mesh_consistency_two_ranks(tmp_path):
    outs = run_spmd([('mesh_consistency', {})], 2, tmp_path)
    assert [o[0] for o in outs] == [0, 0]
