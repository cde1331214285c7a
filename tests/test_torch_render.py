"""The one-launch render of a shot (``ops/waveform.py`` ``render_shot``)
against the numpy reference and the JAX package, on the CPU.

* ``descriptors_from_records`` (the torch counterpart of the descriptors
  the kernel ``csrc/waveform.cu`` derives in each block) equals the numpy
  ``element_descriptors`` exactly: on the headline's records at 2 qubits
  and on hypothesis-drawn records (CW pulses, ties in start, ``n_pulses``
  below the row count, frequency addresses past the table, an element
  with no pulses, starts past 2^31 samples);
* the kernel's visiting plan (``tile_pulse_ranges``: the pulses a block
  stages and the range each pass of samples visits) holds every pulse
  that reaches a pass, and no other when the pulses do not overlap;
* the plan, with the kernel's 32-bit index arithmetic, renders what the
  plain version renders (atol 1e-5, the tolerance the kernel is held to
  on the card), with empty envelope tables and windows past their table;
* the plain render of a whole shot equals, per (core, element), the JAX
  package's ``synthesize_element_pallas`` in interpret mode to atol 1e-4
  (the same 32-bit NCO) and JAX ``Simulator.waveforms`` to atol 2e-3 (its
  split-precision carrier), also from a JAX run's numpy records;
* the render table is built once per program content, also from two
  threads at once.
"""

import threading

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from distributed_processor_tpu.elements import IQ_SCALE as J_IQ_SCALE
from distributed_processor_tpu.models import rb as j_rb
from distributed_processor_tpu.models.experiments import \
    active_reset as j_active_reset
from distributed_processor_tpu.ops.waveform_pallas import \
    synthesize_element_pallas
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch import Simulator
from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.models import (active_reset,
                                                    rb_program)
from distributed_processor_tpu_torch.ops import waveform as wv

torch.set_num_threads(1)

QUBITS = ['Q0', 'Q1']
# the headline (active reset + depth-12 RB) at 2 qubits
DEPTH, SEED = 12, 1234
# a trace length the JAX Pallas entry serves: 512 clocks are 8192 / 8192
# / 2048 samples of the three elements, multiples of its 512-sample block
N_CLKS = 512
SHOTS = 4


@pytest.fixture(scope='module')
def sim():
    return Simulator(n_qubits=2, device='cpu')


@pytest.fixture(scope='module')
def jsim():
    return JSimulator(n_qubits=2)


@pytest.fixture(scope='module')
def bits():
    return np.random.default_rng(3).integers(0, 2, (SHOTS, 2, 16))


@pytest.fixture(scope='module')
def run(sim, bits):
    prog = active_reset(QUBITS) + rb_program(QUBITS, DEPTH, seed=SEED)
    return sim.run(prog, shots=SHOTS, meas_bits=bits)


@pytest.fixture(scope='module')
def jrun(jsim, bits):
    prog = j_active_reset(QUBITS) + j_rb.rb_program(QUBITS, DEPTH, seed=SEED)
    return jsim.run(prog, shots=SHOTS, meas_bits=bits)


def _element_rec(out, mp, shot, core, elem):
    """One element's records as the JAX facade cuts them: ``freq_rel``
    from the element's frequency buffer, the past-the-table address 0."""
    sel = (lambda a: np.asarray(a)) if shot is None \
        else (lambda a: np.asarray(a)[shot])
    tables = mp.tables[core]
    ecfg = tables.elem_cfgs[elem]
    freq_rel = np.concatenate(
        [np.asarray(tables.freqs[elem]['freq']) / ecfg.sample_freq, [0.0]])
    rec = {k: sel(out['rec_' + k])[core]
           for k in ('gtime', 'env', 'phase', 'amp', 'elem')}
    rec['freq_rel'] = freq_rel[np.clip(sel(out['rec_freq'])[core], 0,
                                       len(freq_rel) - 1)]
    rec['n_pulses'] = sel(out['n_pulses'])[core]
    return rec


def _trace_rows(table):
    return [dict(zip(wv._TRACE_FIELDS, row)) for row in table.rows.tolist()]


def test_descriptors_match_numpy_on_the_headline(sim, run):
    mp = run['_mp']
    table = wv.render_table(mp, device='cpu')
    assert len(table.rows) == 6 and table.spc_total == 2 * (16 + 16 + 4)
    n_clks = wv.default_n_clks(run, 1)
    n_desc = 0
    for shot in range(SHOTS):
        rec = wv.shot_records(run, shot, torch.device('cpu'))
        for t in _trace_rows(table):
            c, e = t['core'], t['elem']
            r = {k: rec[k][c] for k in wv._REC_FIELDS + ('n_pulses',)}
            words = table.inc[t['inc_off']:t['inc_off'] + t['n_inc'] + 1]
            got = wv.descriptors_from_records(r, words, t['spc'],
                                              t['interp'], n_clks, e)
            want = wv.element_descriptors(
                _element_rec(run, mp, shot, c, e), t['spc'], t['interp'],
                n_clks, e)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            n_desc += want.shape[1]
    assert n_desc > 50


@st.composite
def records(draw):
    """Pulse records of one core with frequency-buffer addresses, their
    element's frequency table and geometry, and an envelope table."""
    rows = draw(st.integers(0, 12))
    n_pulses = draw(st.integers(0, rows))
    # few distinct start clocks, so that starts tie; some past 2^31 samples
    clocks = draw(st.lists(st.sampled_from(
        [0, 1, 3, 7, 8, 20, 40, 2 ** 27 + 5, 2 ** 31 - 1]),
        min_size=rows, max_size=rows))
    nw = draw(st.lists(st.sampled_from([0, 1, 2, 5, 16, 0xfff]),
                       min_size=rows, max_size=rows))
    addr = draw(st.lists(st.integers(0, 40), min_size=rows, max_size=rows))
    n_freq = draw(st.integers(0, 4))
    rec = dict(
        gtime=np.asarray(clocks, np.int64).astype(np.int32),
        env=(np.asarray(nw, np.int64) << 12
             | np.asarray(addr, np.int64)).astype(np.int32),
        phase=np.asarray(draw(st.lists(st.integers(0, 2 ** 17 - 1),
                                       min_size=rows, max_size=rows)),
                         np.int32),
        amp=np.asarray(draw(st.lists(st.integers(0, 2 ** 16 - 1),
                                     min_size=rows, max_size=rows)),
                       np.int32),
        elem=np.asarray(draw(st.lists(st.integers(0, 2), min_size=rows,
                                      max_size=rows)), np.int32),
        freq=np.asarray(draw(st.lists(st.integers(0, n_freq + 2),
                                      min_size=rows, max_size=rows)),
                        np.int32),
        n_pulses=np.int32(n_pulses))
    freq_table = np.asarray(draw(st.lists(
        st.floats(-0.49, 0.49, allow_nan=False), min_size=n_freq,
        max_size=n_freq)), np.float64)
    spc = draw(st.sampled_from([1, 4, 16, 3]))
    interp = draw(st.sampled_from([1, 2, 4, 16, 3]))
    n_clks = draw(st.integers(1, 60))
    elem = draw(st.integers(0, 3))           # 3: an element with no pulses
    env_len = draw(st.sampled_from([0, 1, 9, 64]))   # 0: an empty table
    env = np.random.default_rng(env_len).uniform(-1, 1, (env_len, 2))
    return rec, freq_table, spc, interp, n_clks, elem, env


def _numpy_rec(rec, freq_table):
    freq_rel = np.concatenate([freq_table, [0.0]])
    out = {k: rec[k] for k in ('gtime', 'env', 'phase', 'amp', 'elem',
                               'n_pulses')}
    out['freq_rel'] = freq_rel[np.clip(rec['freq'], 0, len(freq_rel) - 1)]
    return out


def _torch_desc(rec, freq_table, spc, interp, n_clks, elem):
    words = torch.as_tensor(wv._nco_words(np.concatenate([freq_table,
                                                          [0.0]])))
    trec = {k: torch.as_tensor(v) for k, v in rec.items()}
    return wv.descriptors_from_records(trec, words, spc, interp, n_clks,
                                       elem)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(records())
def test_descriptors_match_numpy_on_drawn_records(case):
    rec, freq_table, spc, interp, n_clks, elem, _env = case
    got = _torch_desc(rec, freq_table, spc, interp, n_clks, elem)
    want = wv.element_descriptors(_numpy_rec(rec, freq_table), spc, interp,
                                  n_clks, elem)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _brute_force(desc, a, b):
    """Columns of the pulses with a sample in ``[a, b)``."""
    lo = np.maximum(desc[0].astype(np.int64), a)
    hi = np.minimum(desc[1].astype(np.int64), b)
    return set(np.nonzero(lo < hi)[0].tolist())


@st.composite
def descriptor_tables(draw):
    """Descriptor tables [7, P]: overlapping or not, CW or not, and
    starting before, inside or after the trace."""
    n_samples = draw(st.integers(1, 3 * wv.RENDER_TILE))
    P = draw(st.integers(0, 24))
    disjoint = draw(st.booleans())
    if disjoint:
        cuts = sorted(draw(st.lists(st.integers(-50, n_samples + 50),
                                    min_size=2 * P, max_size=2 * P,
                                    unique=True)))
        start, end = np.asarray(cuts[0::2]), np.asarray(cuts[1::2])
        perm = np.asarray(draw(st.permutations(range(P))), np.int64)
        start, end = start[perm], end[perm]
        cw = np.zeros(P, np.int64)
    else:
        start = np.asarray(draw(st.lists(st.integers(-50, n_samples + 50),
                                         min_size=P, max_size=P)))
        length = np.asarray(draw(st.lists(st.integers(-3, 900),
                                          min_size=P, max_size=P)))
        end = start + length
        cw = np.asarray(draw(st.lists(st.booleans(), min_size=P,
                                      max_size=P)), np.int64)
    desc = np.zeros((7, P), np.int64)
    desc[0], desc[1], desc[6] = start, end, cw
    return desc.astype(np.int32), n_samples, disjoint


@settings(max_examples=150, deadline=None)
@given(descriptor_tables())
def test_tile_ranges_match_brute_force(case):
    desc, n_samples, disjoint = case
    T = wv.RENDER_THREADS
    for lo_tile in range(0, n_samples, wv.RENDER_TILE):
        cols, ranges = wv.tile_pulse_ranges(desc, lo_tile, n_samples)
        assert len(ranges) == wv.RENDER_TILE // T
        for j, (lo, hi) in enumerate(ranges):
            a = lo_tile + j * T
            if a >= n_samples:           # a pass past the trace stores nothing
                break
            hit = _brute_force(desc, a, min(a + T, n_samples))
            visited = set(cols[lo:hi].tolist())
            assert hit <= visited, (a, hit, visited)
            if disjoint:
                assert hit == visited, (a, hit, visited)


def _emulate_kernel(desc, env, interp, n_samples):
    """A trace as csrc/waveform.cu computes it, in numpy: each block's
    staged pulses and per-pass ranges (``tile_pulse_ranges``) and the
    32-bit envelope index ``min(addr + (n - start) / interp, L - 1)``."""
    out = np.zeros((n_samples, 2), np.float64)
    d = desc.astype(np.int64)
    L = len(env)
    for lo_tile in range(0, n_samples, wv.RENDER_TILE):
        cols, ranges = wv.tile_pulse_ranges(desc, lo_tile, n_samples)
        for j, (lo, hi) in enumerate(ranges):
            n = lo_tile + j * wv.RENDER_THREADS \
                + np.arange(wv.RENDER_THREADS)
            n = n[n < n_samples]
            for c in cols[lo:hi]:
                start, end, addr, inc, ph0, ampw, cw = d[:, c]
                m = n[(n >= start) & (n < end)]
                off = ((m - start) & 0xffffffff) // interp * (1 - cw)
                idx = np.minimum(addr + off, L - 1)
                pa = ((inc & 0xffffffff) * m + (ph0 & 0xffffffff)) \
                    & 0xffffffff
                pa = np.where(pa >= 1 << 31, pa - (1 << 32), pa)
                theta = pa.astype(np.float32) * np.float32(
                    wv._TWO_PI_OVER_2_32)
                z = (env[idx, 0] + 1j * env[idx, 1]) * np.exp(1j * theta)
                amp = np.float32(ampw) / np.float32(wv.AMP_SCALE)
                out[m, 0] += amp * z.real
                out[m, 1] += amp * z.imag
    return out


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(records())
def test_kernel_plan_renders_the_plain_trace(case):
    rec, freq_table, spc, interp, n_clks, elem, env = case
    n_samples = n_clks * spc
    desc = wv.element_descriptors(_numpy_rec(rec, freq_table), spc, interp,
                                  n_clks, elem)
    env = wv._env_table_iq(env[:, 0] + 1j * env[:, 1])
    want = wv._synthesize_plain(desc, torch.as_tensor(env), interp,
                                n_samples).numpy()
    got = _emulate_kernel(desc, env, interp, n_samples)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_plain_of_a_shot_matches_jax(sim, run, jrun, jsim):
    """Every (core, element) trace of two shots, rendered in one call of
    the plain render, against the JAX Pallas kernel in interpret mode and
    JAX ``Simulator.waveforms``."""
    mp = run['_mp']
    for k in ('rec_gtime', 'rec_env', 'rec_amp', 'rec_freq', 'n_pulses'):
        np.testing.assert_array_equal(run[k].numpy(), np.asarray(jrun[k]))
    table = wv.render_table(mp, device='cpu')
    for shot in (0, 3):
        flat = wv.render_shot(wv.shot_records(run, shot,
                                              torch.device('cpu')),
                              table, N_CLKS)
        assert tuple(flat.shape) == (N_CLKS * table.spc_total, 2)
        wf = wv.split_traces(flat.numpy(), table, N_CLKS)
        assert wf == {} or sorted(wf) == [0, 1]
        np.testing.assert_array_equal(
            np.concatenate([t for c in wf for t in wf[c]]), flat.numpy())
        _assert_matches_jax(wf, jrun, jsim, shot)
        # the facade's CPU path is this render
        facade = sim.waveforms(run, shot=shot, n_clks=N_CLKS)
        for c in wf:
            for got, want in zip(facade[c], wf[c]):
                np.testing.assert_array_equal(got, want)


def _assert_matches_jax(wf, jrun, jsim, shot):
    jmp = jrun['_mp']
    wf_j = jsim.waveforms(jrun, shot=shot, n_clks=N_CLKS)
    peak = 0.0
    for c in (0, 1):
        tables = jmp.tables[c]
        for e, trace in enumerate(wf[c]):
            ecfg = tables.elem_cfgs[e]
            rec = _element_rec(jrun, jmp, shot, c, e)
            pallas = np.asarray(synthesize_element_pallas(
                rec, np.asarray(tables.envs[e]) / J_IQ_SCALE,
                spc=ecfg.samples_per_clk, interp=ecfg.interp_ratio,
                n_clks=N_CLKS, elem=e, interpret=True))
            assert trace.shape == pallas.shape and trace.dtype == np.float32
            np.testing.assert_allclose(trace, pallas, rtol=0, atol=1e-4,
                                       err_msg=f'core {c} elem {e}')
            np.testing.assert_allclose(trace, np.asarray(wf_j[c][e]),
                                       rtol=0, atol=2e-3,
                                       err_msg=f'core {c} elem {e}')
            peak = max(peak, float(np.abs(trace).max()))
    assert peak > 0.5                  # the shot renders its pulses


def test_render_of_a_jax_runs_numpy_records(sim, jrun, jsim):
    """A JAX run's records, as numpy, through the port's render (one copy
    to the render's device), next to the program carried as arrays."""
    carried = {k: np.asarray(v) for k, v in jrun.items()
               if not k.startswith('_')}
    carried['_mp'] = machine_program_from_arrays(
        machine_program_to_arrays(jrun['_mp']))
    rec = wv.shot_records(carried, 2, torch.device('cpu'))
    assert {k: v.dtype for k, v in rec.items()} == dict.fromkeys(
        wv._REC_FIELDS + ('n_pulses',), torch.int32)
    # one buffer holds every field
    assert len({v.untyped_storage().data_ptr() for v in rec.values()}) == 1
    _assert_matches_jax(sim.waveforms(carried, shot=2, n_clks=N_CLKS),
                        jrun, jsim, 2)


def test_default_length_is_the_jax_facades(sim, run, jrun):
    for shot in range(SHOTS):
        end = int((np.asarray(jrun['rec_gtime'])[shot]
                   + np.asarray(jrun['rec_dur'])[shot]).max()) + 8
        assert wv.default_n_clks(run, shot) == end
        assert wv.default_n_clks({k: np.asarray(jrun[k]) for k in
                                  ('rec_gtime', 'rec_dur')}, shot) == end
        assert sim.waveforms(run, shot=shot)[1][2].shape == (end * 4, 2)


def test_render_table_is_cached_on_content(run):
    mp = run['_mp']
    table = wv.render_table(mp, device='cpu')
    assert wv.render_table(mp, device='cpu') is table
    # the same content in another object: the same table
    copy = machine_program_from_arrays(machine_program_to_arrays(mp))
    assert wv.render_table(copy, device='cpu') is table
    sub = wv.render_table(mp, cores=[1], device='cpu')
    assert sub is not table and _trace_rows(sub)[0]['core'] == 1
    assert [t['out_spc'] for t in _trace_rows(sub)] == [0, 16, 32]
    # the NCO word of every frequency-buffer address, past-the-table 0
    t = _trace_rows(table)[0]
    freqs = np.asarray(mp.tables[0].freqs[0]['freq'])
    words = table.inc[t['inc_off']:t['inc_off'] + t['n_inc'] + 1].numpy()
    assert t['n_inc'] == len(freqs) and words[-1] == 0
    np.testing.assert_array_equal(words[:-1], wv._nco_words(
        freqs / mp.tables[0].elem_cfgs[0].sample_freq))


def test_render_table_from_two_threads(run):
    """Two threads asking for a table not yet built get one table."""
    mp = run['_mp']
    with wv._TABLES_LOCK:
        wv._TABLES.clear()
    got, barrier = [], threading.Barrier(2)

    def ask():
        barrier.wait()
        got.append(wv.render_table(mp, device='cpu'))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 2 and got[0] is got[1]


def test_render_shot_rejects_other_devices(run):
    table = wv.render_table(run['_mp'], device='cpu')
    rec = {k: v.to('meta') for k, v in
           wv.shot_records(run, 0, torch.device('cpu')).items()}
    with pytest.raises(ValueError, match='lies on cpu'):
        wv.render_shot(rec, table, 64)
    meta = wv.make_table(table.rows, table.env.to('meta'),
                         table.inc.to('meta'), 'meta')
    with pytest.raises(ValueError, match='unsupported device'):
        wv.render_shot(rec, meta, 64)
