"""The port's warm-up path against the JAX package's.

Mirrors tests/test_aot_warmup.py.  ``aot_compile_batch`` is the port's
warm-up of a bound :class:`BucketSpec`: one run of its shape on zero bits
through the generic multi engine (eager torch has no executable to
compile ahead), kept in JAX's bounded LRU with JAX's counters.  Held
here: the spec's JSON round trip and identity (equal to the JAX spec's
document), a warmed dispatch equal to a cold one and to JAX's solo runs
per stat (fault word included) and counted as an ``aot_hit``, the
learned catalog replayed in a fresh process, its tolerance of damage,
aging, cap and concurrent writers, replay that never blocks admission,
the cold/warm split in ``stats()`` and the LRU bound.  CPU only.
"""

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import replace

import numpy as np
import pytest

from distributed_processor_tpu.serve import bucket_key as j_bucket_key
from distributed_processor_tpu.serve.service import \
    _normalize_cfg as j_normalize_cfg
from distributed_processor_tpu.sim.interpreter import InterpreterConfig \
    as JCfg

from distributed_processor_tpu_torch import isa
from distributed_processor_tpu_torch.serve import (BucketCatalog,
                                                   BucketSpec,
                                                   ExecutionService,
                                                   bucket_key)
from distributed_processor_tpu_torch.serve import service as service_mod
from distributed_processor_tpu_torch.serve.service import _normalize_cfg
from distributed_processor_tpu_torch.sim.interpreter import (
    InterpreterConfig, aot_cache_size, aot_compile_batch,
    aot_eviction_count, clear_aot_cache, program_traits, set_aot_cache_cap)
from distributed_processor_tpu_torch.utils import profiling

from test_torch_serve import T, assert_same, ensemble, jax_solo

CPU = ['cpu']


@pytest.fixture(autouse=True)
def _isolation():
    """The port's registry and warm-shape cache, restored around every
    test."""
    snap = profiling.registry_snapshot()
    clear_aot_cache()
    yield
    clear_aot_cache()
    profiling.registry_restore(snap)


def _kw(mps, **kw):
    bucket = max(isa.shape_bucket(mp.n_instr) for mp in mps)
    base = dict(max_steps=2 * bucket + 64, max_pulses=bucket + 2,
                max_meas=2, max_resets=2, record_pulses=False)
    base.update(kw)
    return base


def _tmpl(mp, kw):
    ncfg, _ = _normalize_cfg(InterpreterConfig(**kw),
                             isa.shape_bucket(mp.n_instr))
    return bucket_key(mp, ncfg)


def test_bucketspec_roundtrip_and_identity():
    mps_j, mps = ensemble(2, 2, 1, seed=3)
    kw = _kw(mps)
    tmpl = _tmpl(mps[0], kw)
    assert isinstance(tmpl, BucketSpec) and not tmpl.bound
    assert tmpl.traits == program_traits(mps[0])
    spec = tmpl.bind(n_programs=4, n_shots=8)
    assert spec.bound and spec.template() == tmpl
    assert spec.label() == f'{tmpl.label()}p4s8'
    assert spec.shape_sig() == ('multi', 4, 8, True)
    # the document equals the JAX package's spec of the same program
    jn, _ = j_normalize_cfg(JCfg(**kw), isa.shape_bucket(mps[0].n_instr))
    assert spec.to_json() \
        == j_bucket_key(mps_j[0], jn).bind(n_programs=4,
                                           n_shots=8).to_json()
    back = BucketSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert back == spec and hash(back) == hash(spec)
    assert back.identity() == spec.identity()
    assert back.cfg == spec.cfg and back.traits == spec.traits
    stripped = replace(spec, traits=None)
    assert stripped == spec and hash(stripped) == hash(spec)
    assert stripped.identity() != spec.identity()
    doc = spec.to_json()
    doc['version'] = 999
    with pytest.raises(ValueError):
        BucketSpec.from_json(doc)


def test_bucket_spec_matches_dispatch_padding():
    _, mps = ensemble(2, 2, 1, seed=4)
    kw = _kw(mps)
    with ExecutionService(InterpreterConfig(**kw), max_batch_programs=8,
                          max_wait_ms=1.0, devices=CPU) as svc:
        spec = svc.bucket_spec(mps[0], shots=16, n_programs=3)
        assert spec.n_programs == 4 and spec.n_shots == 16
        assert spec.template() == _tmpl(mps[0], kw)
        with pytest.raises(ValueError):
            svc.warmup(spec.template())
    with pytest.raises(ValueError, match='BOUND'):
        aot_compile_batch(spec.template(), 'cpu')
    with pytest.raises(ValueError, match='generic'):
        aot_compile_batch(replace(spec, cfg=replace(spec.cfg,
                                                    engine='block')),
                          'cpu')


def test_aot_dispatch_bit_identical_to_lazy():
    """The same coalesced batch served cold and after warm-up agrees per
    stat with JAX's solo runs, fault word included, and the warmed
    dispatch counts as an aot hit."""
    mps_j, mps = ensemble(2, 2, 2, seed=7)
    kw = _kw(mps)
    rng = np.random.default_rng(9)
    bits = [rng.integers(0, 2, (8, mps[0].n_cores, 2)).astype(np.int32)
            for _ in mps]
    refs = [jax_solo(mj, b, kw) for mj, b in zip(mps_j, bits)]

    def serve_once(warm):
        with ExecutionService(InterpreterConfig(**kw), max_batch_programs=2,
                              max_wait_ms=50.0, devices=CPU,
                              trace_sample=1.0) as svc:
            if warm:
                report = svc.warmup(svc.bucket_spec(mps[0], shots=8,
                                                    n_programs=2))
                assert report and report[0]['compile_ms'] > 0.0
            handles = [svc.submit(mp, b) for mp, b in zip(mps, bits)]
            res = [h.result(timeout=T) for h in handles]
            klass = [s['args']['classification']
                     for s in handles[0].trace() if s['name'] == 'dispatch']
            return res, svc.stats(), klass

    lazy, _, k_lazy = serve_once(warm=False)
    assert aot_cache_size() == 0 and k_lazy == ['cold']
    hits0 = profiling.counter_get('aot_hit')
    warm, st, k_warm = serve_once(warm=True)
    assert aot_cache_size() == 1 and k_warm == ['aot']
    assert profiling.counter_get('aot_hit') - hits0 == 1
    assert st['warmup']['aot_compiled'] == 1
    for i, want in enumerate(refs):
        assert 'fault' in want
        assert_same(lazy[i], want, f'lazy{i}')
        assert_same(warm[i], want, f'warm{i}')


_REPLAY_CHILD = r'''
import json, sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
from distributed_processor_tpu_torch.serve import (BucketCatalog,
                                                   ExecutionService)
from distributed_processor_tpu_torch.sim.interpreter import \
    InterpreterConfig
from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (
    active_reset, make_default_qchip, rb_ensemble)
prog = rb_ensemble(['Q0'], 2, 1, seed=7)[0]
mp = compile_to_machine(active_reset(['Q0']) + prog, make_default_qchip(1),
                        n_qubits=1)
bits = np.load({bits!r})
specs = BucketCatalog({path!r}).load()
cfg = InterpreterConfig(**json.loads({kw!r}))
svc = ExecutionService(cfg, max_batch_programs=2, max_wait_ms=5.0,
                       warmup_catalog={path!r}, devices=['cpu'])
try:
    deadline = time.monotonic() + 120.0
    while svc.stats()['warmup']['in_progress'] > 0:
        assert time.monotonic() < deadline, 'replay never finished'
        time.sleep(0.01)
    pre = svc.stats()
    res = svc.submit(mp, bits).result(timeout=120)
    st = svc.stats()
finally:
    svc.shutdown(timeout=120)
print(json.dumps({{
    'n_specs': len(specs),
    'aot_compiled': st['warmup']['aot_compiled'],
    'replayed': st['warmup']['replayed'],
    'cold_after_replay': st['compile']['cold'] - pre['compile']['cold'],
    'regs_sum': int(np.asarray(res['regs']).sum()),
}}))
'''


def test_catalog_replay_across_restart(tmp_path):
    """A service with ``warmup_catalog`` learns its dispatched buckets; a
    fresh process replaying the catalog warms them at start and serves
    its first request (the same program, compiled there by the port)
    warm, with the same result."""
    mps_j, mps = ensemble(1, 2, 1, seed=7)
    kw = _kw(mps)
    bits = np.random.default_rng(7).integers(
        0, 2, (4, mps[0].n_cores, 2)).astype(np.int32)
    path = str(tmp_path / 'buckets.json')
    with ExecutionService(InterpreterConfig(**kw), max_batch_programs=2,
                          max_wait_ms=5.0, warmup_catalog=path,
                          devices=CPU) as svc:
        ref = svc.submit(mps[0], bits).result(timeout=T)
    assert_same(ref, jax_solo(mps_j[0], bits, kw))
    specs = BucketCatalog(path).load()
    assert len(specs) >= 1 and all(s.bound for s in specs)
    bits_f = str(tmp_path / 'bits.npy')
    np.save(bits_f, bits)
    tests = os.path.dirname(os.path.abspath(__file__))
    child = _REPLAY_CHILD.format(repo=os.path.dirname(tests), tests=tests,
                                 path=path, bits=bits_f,
                                 kw=json.dumps(kw))
    proc = subprocess.run([sys.executable, '-c', child],
                          capture_output=True, text=True, timeout=170)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row['n_specs'] == row['replayed'] == len(specs)
    assert row['aot_compiled'] >= len(specs)
    assert row['cold_after_replay'] == 0
    assert row['regs_sum'] == int(np.asarray(ref['regs']).sum())


def test_catalog_tolerates_corruption(tmp_path):
    path = tmp_path / 'buckets.json'
    path.write_text('{definitely not json')
    assert BucketCatalog(str(path)).load() == []
    path.write_text(json.dumps({'magic': 'other', 'version': 1,
                                'specs': []}))
    assert len(BucketCatalog(str(path))) == 0


def test_catalog_aging_and_cap(tmp_path):
    _, mps = ensemble(2, 2, 1, seed=9)
    tmpl = _tmpl(mps[0], _kw(mps))

    def spec(p):
        return tmpl.bind(n_programs=p, n_shots=4)

    path = str(tmp_path / 'cat.json')

    def reopen():
        return BucketCatalog(path, max_specs=8, max_age_runs=2)

    cat = reopen()
    cat.begin_run()
    assert cat.record(spec(1)) and cat.record(spec(2))
    assert not cat.record(spec(1))
    assert len(cat) == 2
    for _ in range(3):
        cat = reopen()
        cat.begin_run()
        cat.record(spec(1))
    live = reopen().begin_run()
    idents = {s.identity() for s in live}
    assert spec(1).identity() in idents
    assert spec(2).identity() not in idents
    capped = BucketCatalog(str(tmp_path / 'cap.json'), max_specs=2)
    capped.begin_run()
    for p in (1, 2, 4):
        capped.record(spec(p))
    kept = {s.identity() for s in capped.load()}
    assert len(kept) == 2 and spec(4).identity() in kept
    with open(path) as f:
        doc = json.load(f)
    assert doc['version'] == 1 and 'runs' in doc and 'last_seen' in doc
    doc.pop('runs'), doc.pop('last_seen')
    old = str(tmp_path / 'old.json')
    with open(old, 'w') as f:
        json.dump(doc, f)
    assert {s.identity() for s in BucketCatalog(old).load()} == idents


def test_warmup_replay_never_blocks_admission(tmp_path, monkeypatch):
    _, mps = ensemble(2, 2, 1, seed=11)
    kw = _kw(mps)
    path = str(tmp_path / 'buckets.json')
    BucketCatalog(path).record(
        _tmpl(mps[0], kw).bind(n_programs=1, n_shots=4))
    gate, stalled = threading.Event(), threading.Event()

    def wedged_compile(spec, device=None):
        stalled.set()
        gate.wait(60.0)
        return 0.0

    monkeypatch.setattr(service_mod, 'aot_compile_batch', wedged_compile)
    bits = np.random.default_rng(0).integers(
        0, 2, (4, mps[0].n_cores, 2)).astype(np.int32)
    svc = ExecutionService(InterpreterConfig(**kw), max_batch_programs=2,
                           max_wait_ms=1.0, warmup_catalog=path,
                           devices=CPU)
    try:
        assert stalled.wait(30.0)
        assert svc.stats()['warmup']['in_progress'] > 0
        res = svc.submit(mps[0], bits).result(timeout=T)
        assert np.asarray(res['regs']).shape[0] == 4
        assert svc.stats()['warmup']['in_progress'] > 0
        gate.set()
        deadline = time.monotonic() + 60.0
        while svc.stats()['warmup']['in_progress'] > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        gate.set()
        svc.shutdown(timeout=T)


def test_warmup_stats_cold_warm_split():
    _, mps = ensemble(2, 2, 1, seed=13)
    kw = _kw(mps)
    bits = np.random.default_rng(1).integers(
        0, 2, (4, mps[0].n_cores, 2)).astype(np.int32)
    with ExecutionService(InterpreterConfig(**kw), max_batch_programs=2,
                          max_wait_ms=1.0, devices=CPU) as svc:
        spec = svc.bucket_spec(mps[0], shots=4, n_programs=1)
        report = svc.warmup(spec)
        assert [r['cold'] for r in report] == [True]
        assert report[0]['compile_ms'] > 0.0 and report[0]['device'] == 'cpu'
        assert svc.warmup(spec)[0]['compile_ms'] == 0.0     # already warm
        st = svc.stats()
        assert st['warmup'] == {'aot_compiled': 1, 'replayed': 0,
                                'in_progress': 0}
        per = st['compile']['per_bucket'][spec.template().label()]
        assert per['cold'] == 1 and per['warm'] == 1
        assert per['cold_ms_mean'] is None and per['compile_ms_est'] is None
        svc.submit(mps[0], bits).result(timeout=T)
        per = svc.stats()['compile']['per_bucket'][spec.template().label()]
        assert per['warm'] == 2 and per['warm_ms_mean'] > 0.0


def test_aot_cache_lru_bound():
    _, mps = ensemble(2, 2, 1, seed=17)
    tmpl = _tmpl(mps[0], _kw(mps))
    specs = [tmpl.bind(n_programs=p, n_shots=2) for p in (1, 2, 4)]
    old = set_aot_cache_cap(2)
    try:
        ev0 = aot_eviction_count()
        assert aot_compile_batch(specs[0], 'cpu') > 0
        assert aot_compile_batch(specs[1], 'cpu') > 0
        assert aot_cache_size() == 2
        assert aot_compile_batch(specs[0], 'cpu') == 0.0
        assert aot_compile_batch(specs[2], 'cpu') > 0
        assert aot_cache_size() == 2
        assert aot_eviction_count() == ev0 + 1
        assert aot_compile_batch(specs[0], 'cpu') == 0.0
        assert aot_compile_batch(specs[1], 'cpu') > 0
        assert aot_eviction_count() == ev0 + 2
        set_aot_cache_cap(1)
        assert aot_cache_size() == 1
        assert aot_eviction_count() == ev0 + 3
        assert aot_compile_batch(specs[1], 'cpu') == 0.0
        with pytest.raises(ValueError):
            set_aot_cache_cap(0)
    finally:
        set_aot_cache_cap(old)


def test_catalog_concurrent_writers_merge_not_clobber(tmp_path):
    _, mps = ensemble(2, 2, 1, seed=21)
    tmpl = _tmpl(mps[0], _kw(mps))
    path = str(tmp_path / 'shared.json')
    a, b = BucketCatalog(path), BucketCatalog(path)
    a.begin_run()
    b.begin_run()
    assert a.record(tmpl.bind(n_programs=1, n_shots=4))
    assert b.record(tmpl.bind(n_programs=2, n_shots=4))
    idents = {s.identity() for s in BucketCatalog(path).load()}
    assert tmpl.bind(n_programs=1, n_shots=4).identity() in idents
    assert tmpl.bind(n_programs=2, n_shots=4).identity() in idents
    handles = [BucketCatalog(path) for _ in range(4)]
    for h in handles:
        h.begin_run()

    def write(k):
        for p in range(1, 9):
            handles[k].record(tmpl.bind(n_programs=p, n_shots=4 + k))

    threads = [threading.Thread(target=write, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)
    final = {s.identity() for s in BucketCatalog(path).load()}
    want = {tmpl.bind(n_programs=p, n_shots=4 + k).identity()
            for k in range(4) for p in range(1, 9)}
    assert want <= final
