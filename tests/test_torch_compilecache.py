"""The port's compile cache against the JAX package's, on the CPU.

Each scenario of tests/test_compilecache.py runs once per package, on
that package's own classes, and the two logs — the status of every
``get_or_compile`` call (``miss``, ``hit``, ``disk``, ``wait``), the
errors, ``stats()`` without its timings and paths, and the profiling
counters each package's registry gained — must be equal.  Beside them,
the pins of the cache key across the packages: the canonical forms,
``machine_program_bytes`` and ``QChip.fingerprint`` agree; the port's key
differs from the JAX package's (it names the port's element class) and
is the same in a fresh process; and a store directory holding a JAX
entry for the same source gives the port a miss, never a load.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
import types
import zlib

import pytest
import torch

import distributed_processor_tpu.compilecache as j_cc
from distributed_processor_tpu import isa as j_isa
from distributed_processor_tpu.decoder import (
    ProgramValidationError as JValidationError,
    machine_program_from_cmds as j_from_cmds)
from distributed_processor_tpu.models import (
    active_reset as j_active_reset, make_default_qchip as j_qchip,
    rb_ensemble as j_rb_ensemble)
from distributed_processor_tpu.pipeline import (
    cached_compile_to_machine as j_cached,
    compile_to_machine as j_compile)
from distributed_processor_tpu.utils import profiling as j_profiling

import chip_smoke
import distributed_processor_tpu_torch.compilecache as t_cc
from distributed_processor_tpu_torch import isa as t_isa
from distributed_processor_tpu_torch.decoder import (
    ProgramValidationError as TValidationError,
    machine_program_from_cmds as t_from_cmds)
from distributed_processor_tpu_torch.models import (
    active_reset as t_active_reset, make_default_qchip as t_qchip,
    rb_ensemble as t_rb_ensemble)
from distributed_processor_tpu_torch.pipeline import (
    cached_compile_to_machine as t_cached,
    compile_to_machine as t_compile)
from distributed_processor_tpu_torch.utils import profiling as t_profiling

torch.set_num_threads(1)

N_QUBITS = 2
QUBITS = ['Q0', 'Q1']

JAX = types.SimpleNamespace(
    cc=j_cc, isa=j_isa, from_cmds=j_from_cmds, qchip=j_qchip,
    active_reset=j_active_reset, rb_ensemble=j_rb_ensemble,
    compile=j_compile, cached=j_cached, profiling=j_profiling,
    ValidationError=JValidationError)
PORT = types.SimpleNamespace(
    cc=t_cc, isa=t_isa, from_cmds=t_from_cmds, qchip=t_qchip,
    active_reset=t_active_reset, rb_ensemble=t_rb_ensemble,
    compile=t_compile, cached=t_cached, profiling=t_profiling,
    ValidationError=TValidationError)


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    """The port's registry, restored around every test as
    tests/conftest.py restores the JAX package's."""
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def _programs(pkg, n, seed=0, depth=2):
    return [pkg.active_reset(QUBITS) + p
            for p in pkg.rb_ensemble(QUBITS, depth, n, seed=seed)]


def _reorder(prog):
    return [dict(reversed(list(d.items()))) for d in prog]


_TIMING_KEYS = ('compile_ms_p50', 'compile_ms_p99', 'persistent')


def _stats(cache) -> dict:
    """``stats()`` without what differs between two runs of one
    scenario: compile timings and the store's directory."""
    return {k: v for k, v in cache.stats().items() if k not in _TIMING_KEYS}


def _counter_delta(pkg, before: dict) -> dict:
    after = pkg.profiling.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith(('compilecache.', 'integrity.'))
            and v != before.get(k, 0)}


def _run(scenario, pkg, tmp_path):
    """The scenario's log on ``pkg``, with the counters it moved and the
    compile-time histogram's count it added."""
    d = tmp_path / ('jax' if pkg is JAX else 'port')
    d.mkdir()
    before = pkg.profiling.counters()
    hist = pkg.profiling.registry().histogram('compilecache.compile_ms')
    n0 = hist.count
    log = scenario(pkg, str(d))
    return {'log': log, 'counters': _counter_delta(pkg, before),
            'compile_ms_count': hist.count - n0}


def _status(res):
    return res[1]


# ---------------------------------------------------------------------------
# scenarios of tests/test_compilecache.py, one package at a time
# ---------------------------------------------------------------------------

def sc_hit_miss_lru_evict(pkg, _dir):
    qchip = pkg.qchip(N_QUBITS)
    progs = _programs(pkg, 3)
    cache = pkg.cc.CompileCache(capacity=2)
    log = [_status(cache.get_or_compile(progs[0], qchip, n_qubits=N_QUBITS)),
           _status(cache.get_or_compile(_reorder(progs[0]), qchip,
                                        n_qubits=N_QUBITS))]
    for p in progs[1:] + progs[:1]:
        log.append(_status(cache.get_or_compile(p, qchip,
                                                n_qubits=N_QUBITS)))
    return log + [_stats(cache)]


def sc_disk_tier(pkg, cache_dir):
    """An evicted entry comes back from disk; a fresh cache over the same
    directory starts warm."""
    qchip = pkg.qchip(N_QUBITS)
    progs = _programs(pkg, 2)
    cache = pkg.cc.CompileCache(capacity=1, cache_dir=cache_dir)
    log = [_status(cache.get_or_compile(p, qchip, n_qubits=N_QUBITS))
           for p in progs + progs[:1]]
    fresh = pkg.cc.CompileCache(cache_dir=cache_dir)
    log += [_status(fresh.get_or_compile(p, qchip, n_qubits=N_QUBITS))
            for p in progs + progs]
    mp = fresh.get_or_compile(progs[0], qchip, n_qubits=N_QUBITS)[0]
    log.append(pkg.cc.machine_program_bytes(mp)
               == pkg.cc.machine_program_bytes(
                   pkg.compile(progs[0], qchip, n_qubits=N_QUBITS)))
    return log + [_stats(cache), _stats(fresh)]


def sc_corrupt_and_skewed_entries(pkg, cache_dir):
    """A corrupt entry and a version-skewed one are each a miss, dropped
    and rewritten, never an error."""
    qchip = pkg.qchip(N_QUBITS)
    prog = _programs(pkg, 1)[0]
    log = [_status(pkg.cc.CompileCache(cache_dir=cache_dir).get_or_compile(
        prog, qchip, n_qubits=N_QUBITS))]
    (entry,) = [f for f in os.listdir(cache_dir) if f.endswith('.mpc')]
    fname = os.path.join(cache_dir, entry)
    with open(fname, 'wb') as f:
        f.write(b'garbage not zlib')
    for _ in range(2):
        log.append(_status(pkg.cc.CompileCache(
            cache_dir=cache_dir).get_or_compile(prog, qchip,
                                                n_qubits=N_QUBITS)))
    with open(fname, 'rb') as f:
        payload = pickle.loads(zlib.decompress(f.read()))
    payload['version'] += 1
    with open(fname, 'wb') as f:
        f.write(zlib.compress(pickle.dumps(payload)))
    for _ in range(2):
        log.append(_status(pkg.cc.CompileCache(
            cache_dir=cache_dir).get_or_compile(prog, qchip,
                                                n_qubits=N_QUBITS)))
    return log


def sc_singleflight_stampede(pkg, _dir):
    """7 threads racing one never-seen program: one compile, released
    only once the other 6 wait on its flight, so the statuses are one
    ``miss`` and six ``wait``s in both packages."""
    qchip = pkg.qchip(N_QUBITS)
    prog = _programs(pkg, 1, seed=42)[0]
    calls, release = [], threading.Event()

    def slow_compile(program, qc, **kw):
        calls.append(threading.get_ident())
        release.wait(timeout=30)
        return pkg.compile(program, qc, **kw)

    cache = pkg.cc.CompileCache(compile_fn=slow_compile)
    results = [None] * 7

    def worker(i):
        results[i] = cache.get_or_compile(prog, qchip, n_qubits=N_QUBITS)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(7)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while cache.stats()['singleflight_waits'] < 6:
        assert time.monotonic() < deadline, 'the stampede never piled up'
        time.sleep(0.005)
    release.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return [len(calls), sorted(r[1] for r in results),
            len({id(r[0]) for r in results}), _stats(cache)]


def sc_singleflight_failure(pkg, _dir):
    """Every waiter of a failing compile sees its error; the failure is
    not cached."""
    qchip = pkg.qchip(N_QUBITS)
    prog = _programs(pkg, 1, seed=43)[0]
    gate = threading.Event()

    def broken_compile(program, qc, **kw):
        gate.wait(timeout=30)
        raise RuntimeError('compiler exploded')

    cache = pkg.cc.CompileCache(compile_fn=broken_compile)
    errors = []

    def worker():
        try:
            cache.get_or_compile(prog, qchip, n_qubits=N_QUBITS)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while cache.stats()['singleflight_waits'] < 3:
        assert time.monotonic() < deadline, 'the waiters never piled up'
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    try:
        cache.get_or_compile(prog, qchip, n_qubits=N_QUBITS)
        again = 'compiled'
    except RuntimeError as e:
        again = str(e)
    return [sorted(errors), again, _stats(cache)]


def sc_epoch_invalidation(pkg, cache_dir):
    """Retuning one qchip flushes its entries (memory and disk); the other
    qchip's stay warm; an explicit flush counts its entries."""
    qa, qb = pkg.qchip(N_QUBITS), pkg.qchip(N_QUBITS)
    qb.gates['Q1X90'].contents[0].amp = 0.3
    progs = _programs(pkg, 2)
    cache = pkg.cc.CompileCache(cache_dir=cache_dir)
    log = []
    for p in progs:
        log += [_status(cache.get_or_compile(p, q, n_qubits=N_QUBITS))
                for q in (qa, qb)]
    qa.gates['Q0X90'].contents[0].amp = 0.6
    log.append(_status(cache.get_or_compile(progs[0], qa,
                                            n_qubits=N_QUBITS)))
    log.append(_stats(cache))
    log += [_status(cache.get_or_compile(p, qb, n_qubits=N_QUBITS))
            for p in progs]
    log.append(_status(cache.get_or_compile(progs[1], qa,
                                            n_qubits=N_QUBITS)))
    log.append(cache.invalidate_epoch(qb.fingerprint()))
    log.append(_status(cache.get_or_compile(progs[0], qb,
                                            n_qubits=N_QUBITS)))
    return log + [_stats(cache)]


def sc_validation_reject(pkg, _dir):
    """A program failing admission validation raises with coordinates and
    is never cached; with validation off it is admitted."""
    qchip = pkg.qchip(N_QUBITS)
    prog = _programs(pkg, 1, seed=44)[0]

    def malformed(*_a, **_kw):
        return pkg.from_cmds([[pkg.isa.pulse_cmd(
            amp_word=100, cfg_word=0, env_word=3, cmd_time=10),
            pkg.isa.jump_i(99), pkg.isa.done_cmd()]])

    cache = pkg.cc.CompileCache(compile_fn=malformed)
    try:
        cache.get_or_compile(prog, qchip, n_qubits=N_QUBITS)
        log = ['admitted']
    except pkg.ValidationError as e:
        log = [type(e).__name__, str(e), e.codes, e.errors]
    off = pkg.cc.CompileCache(compile_fn=malformed, validate=False)
    mp, s, _ = off.get_or_compile(prog, qchip, n_qubits=N_QUBITS)
    return log + [_stats(cache), s, mp.n_cores, _stats(off)]


def sc_qasm_and_cached_compile(pkg, _dir):
    """QASM text keys byte for byte (a hit never parses): the QASM
    headline misses, hits, then hits ``cached_compile_to_machine``."""
    qchip = pkg.qchip(8)
    src = chip_smoke.qasm_headline_source(8, 2, 7)
    cache = pkg.cc.CompileCache()
    log = [_status(cache.get_or_compile(s, qchip, n_qubits=8))
           for s in (src, src, src + ' ')]
    mp = pkg.cached(src, qchip, n_qubits=8, cache=cache)
    log.append(pkg.cc.machine_program_bytes(mp)
               == pkg.cc.machine_program_bytes(
                   cache.get_or_compile(src, qchip, n_qubits=8)[0]))
    return log + [_stats(cache)]


SCENARIOS = [sc_hit_miss_lru_evict, sc_disk_tier,
             sc_corrupt_and_skewed_entries, sc_singleflight_stampede,
             sc_singleflight_failure, sc_epoch_invalidation,
             sc_validation_reject, sc_qasm_and_cached_compile]


@pytest.mark.parametrize('scenario', SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_scenario_matches_jax(scenario, tmp_path):
    want = _run(scenario, JAX, tmp_path)
    got = _run(scenario, PORT, tmp_path)
    assert got == want
    assert want['counters'], 'the scenario moved no counter'


def test_expected_statuses():
    """The logs the scenarios are compared on say what the JAX tests
    pin: hit after miss, evict to miss, disk after eviction and after a
    restart, wait under the stampede."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        assert sc_hit_miss_lru_evict(PORT, d)[:5] == [
            'miss', 'hit', 'miss', 'miss', 'miss']
        log = sc_disk_tier(PORT, d)
        assert log[:7] == ['miss', 'miss', 'disk', 'disk', 'disk', 'hit',
                           'hit'] and log[7] is True
    with tempfile.TemporaryDirectory() as d:
        assert sc_corrupt_and_skewed_entries(PORT, d) == [
            'miss', 'miss', 'disk', 'miss', 'disk']
    calls, statuses, n_objs, _ = sc_singleflight_stampede(PORT, None)
    assert (calls, statuses, n_objs) == (1, ['miss'] + ['wait'] * 6, 1)


# ---------------------------------------------------------------------------
# the key and the store across the packages
# ---------------------------------------------------------------------------

def test_canonical_forms_and_bytes_agree():
    for jp, tp in zip(_programs(JAX, 3, seed=5), _programs(PORT, 3, seed=5)):
        assert t_cc.canonical_json(tp) == j_cc.canonical_json(jp)
        assert t_cc.canonical_program(tp) == j_cc.canonical_program(jp)
        assert t_cc.canonical_program(_reorder(tp)) \
            == j_cc.canonical_program(jp)
        assert t_cc.machine_program_bytes(t_compile(
            tp, t_qchip(N_QUBITS), n_qubits=N_QUBITS)) \
            == j_cc.machine_program_bytes(j_compile(
                jp, j_qchip(N_QUBITS), n_qubits=N_QUBITS))
    src = chip_smoke.qasm_headline_source(8, 2, 7)
    assert t_cc.canonical_program(src) == j_cc.canonical_program(src)


def test_qchip_fingerprint_agrees():
    for n in (1, 2, 8):
        a, b = t_qchip(n), j_qchip(n)
        assert a.fingerprint() == b.fingerprint()
        a.gates['Q0X90'].contents[0].amp = 0.123
        b.gates['Q0X90'].contents[0].amp = 0.123
        assert a.fingerprint() == b.fingerprint() != t_qchip(n).fingerprint()


def test_port_key_names_its_element_class():
    """Same inputs, another key: the key hashes the element class's
    module, the port's own."""
    prog = _programs(PORT, 1)[0]
    tk = t_cc.content_key(prog, t_qchip(N_QUBITS), n_qubits=N_QUBITS)
    jk = j_cc.content_key(prog, j_qchip(N_QUBITS), n_qubits=N_QUBITS)
    assert tk != jk
    from distributed_processor_tpu.elements import TPUElementConfig as JEl
    # with the JAX package's element class named, the port's key is
    # JAX's: the key differs in that component only
    assert t_cc.content_key(prog, t_qchip(N_QUBITS), n_qubits=N_QUBITS,
                            element_cls=JEl) == jk


_KEY_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from distributed_processor_tpu_torch.compilecache import content_key
from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_ensemble)
prog = active_reset(['Q0', 'Q1']) + rb_ensemble(['Q0', 'Q1'], 2, 1,
                                                 seed=7)[0]
print(json.dumps([content_key(prog, make_default_qchip(2), n_qubits=2),
                  content_key(chip_smoke.qasm_headline_source(8, 2, 7),
                              make_default_qchip(8), n_qubits=8)]))
'''


def test_port_key_stable_across_processes():
    """A fresh process (its own hash seed) computes the same keys."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONHASHSEED='12345')
    r = subprocess.run([sys.executable, '-c', _KEY_CHILD, root],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    prog = t_active_reset(QUBITS) + t_rb_ensemble(QUBITS, 2, 1, seed=7)[0]
    want = [t_cc.content_key(prog, t_qchip(2), n_qubits=2),
            t_cc.content_key(chip_smoke.qasm_headline_source(8, 2, 7),
                             t_qchip(8), n_qubits=8)]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want


def test_jax_entry_is_a_port_miss(tmp_path):
    """A directory holding the JAX package's entry for a source gives the
    port a miss (its key names another file), and the JAX entry stays
    a JAX disk hit beside the port's own."""
    src = chip_smoke.qasm_headline_source(8, 2, 7)
    _, s, jkey = j_cc.CompileCache(cache_dir=str(tmp_path)).get_or_compile(
        src, j_qchip(8), n_qubits=8)
    assert s == 'miss'
    mp, s, tkey = t_cc.CompileCache(cache_dir=str(tmp_path)).get_or_compile(
        src, t_qchip(8), n_qubits=8)
    assert s == 'miss' and tkey != jkey
    assert type(mp).__module__.startswith('distributed_processor_tpu_torch.')
    files = sorted(f.split('-')[0] for f in os.listdir(tmp_path))
    assert files == sorted([jkey, tkey])
    assert j_cc.CompileCache(cache_dir=str(tmp_path)).get_or_compile(
        src, j_qchip(8), n_qubits=8)[1] == 'disk'
    mp, s, _ = t_cc.CompileCache(cache_dir=str(tmp_path)).get_or_compile(
        src, t_qchip(8), n_qubits=8)
    assert s == 'disk'
    assert type(mp).__module__.startswith('distributed_processor_tpu_torch.')


def test_default_cache_is_process_wide():
    a = t_cc.default_cache()
    assert a is t_cc.default_cache()
    prog = _programs(PORT, 1, seed=9)[0]
    mp = t_cached(prog, t_qchip(N_QUBITS), n_qubits=N_QUBITS)
    assert t_cached(prog, t_qchip(N_QUBITS), n_qubits=N_QUBITS) is mp
    assert t_cc.machine_program_bytes(mp) == j_cc.machine_program_bytes(
        j_cached(_programs(JAX, 1, seed=9)[0], j_qchip(N_QUBITS),
                 n_qubits=N_QUBITS))
