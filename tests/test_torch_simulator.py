"""The port's ``Simulator`` facade against the JAX package's, on the CPU.

The counterparts of tests/test_simulator.py's facade cases (dict programs
throughout: the port has no QASM front end), each also compared with the
JAX ``Simulator`` on the same program: integer outputs exactly; rendered
traces to atol 1e-4 of the JAX waveform kernel in Pallas interpret mode
(the same 32-bit NCO) and atol 2e-3 of JAX ``Simulator.waveforms`` (its
XLA renderer's split-precision carrier, JAX's own tolerance).  One case
carries a JAX run's records, as numpy, into the port's renderer.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_processor_tpu.elements import IQ_SCALE
from distributed_processor_tpu.models.experiments import (
    active_reset as j_active_reset, loop_shots_program as j_loop_shots)
from distributed_processor_tpu.ops.waveform_pallas import \
    synthesize_element_pallas
from distributed_processor_tpu.simulator import Simulator as JSimulator

from distributed_processor_tpu_torch import Simulator, ops as tops
from distributed_processor_tpu_torch.decoder import (
    machine_program_from_arrays, machine_program_to_arrays)
from distributed_processor_tpu_torch.models.experiments import (
    active_reset, loop_shots_program)
from distributed_processor_tpu_torch.sim.device import DeviceModel
from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics

torch.set_num_threads(1)

X90_READ = [{'name': 'X90', 'qubit': ['Q0']}, {'name': 'read', 'qubit': ['Q0']}]
# a trace length both renderers of the JAX package serve: 512 clocks are
# 8192 / 8192 / 2048 samples of the three elements, multiples of 512
N_CLKS = 512


@pytest.fixture(scope='module')
def sim2():
    return Simulator(n_qubits=2, device='cpu')


@pytest.fixture(scope='module')
def jsim2():
    return JSimulator(n_qubits=2)


def _assert_ints_equal(out_t, out_j):
    """Every array output of the two runs equal in value and dtype."""
    keys = {k for k in out_j if not k.startswith('_')}
    assert keys == {k for k in out_t if not k.startswith('_')}
    for key in sorted(keys):
        want, got = np.asarray(out_j[key]), out_t[key].numpy()
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)


def _jax_pallas_render(out_j, core, elem, n_clks, shot=None):
    """One element of a JAX run rendered by the JAX waveform kernel in
    interpret mode, from the records as ``Simulator.waveforms`` cuts
    them."""
    mp = out_j['_mp']
    sel = (lambda a: np.asarray(a)) if shot is None \
        else (lambda a: np.asarray(a)[shot])
    tables = mp.tables[core]
    ecfg = tables.elem_cfgs[elem]
    freq_rel_table = np.concatenate(
        [np.asarray(tables.freqs[elem]['freq']) / ecfg.sample_freq, [0.0]])
    rec = {k: jnp.asarray(sel(out_j['rec_' + k])[core])
           for k in ('gtime', 'env', 'phase', 'amp', 'elem')}
    rec['freq_rel'] = freq_rel_table[np.clip(
        sel(out_j['rec_freq'])[core], 0, len(freq_rel_table) - 1)]
    rec['n_pulses'] = sel(out_j['n_pulses'])[core]
    return np.asarray(synthesize_element_pallas(
        rec, np.asarray(tables.envs[elem]) / IQ_SCALE,
        spc=ecfg.samples_per_clk, interp=ecfg.interp_ratio, n_clks=n_clks,
        elem=elem, interpret=True))


def _assert_traces_match_jax(wf, jsim, out_j, n_clks, shot=None, cores=(0,)):
    wf_j = jsim.waveforms(out_j, shot=shot, n_clks=n_clks)
    for c in cores:
        assert len(wf[c]) == len(wf_j[c]) == 3
        for e, trace in enumerate(wf[c]):
            assert trace.dtype == np.float32
            assert trace.shape == np.asarray(wf_j[c][e]).shape
            np.testing.assert_allclose(
                trace, _jax_pallas_render(out_j, c, e, n_clks, shot),
                atol=1e-4, err_msg=f'core {c} elem {e} vs the JAX kernel')
            np.testing.assert_allclose(
                trace, np.asarray(wf_j[c][e]), atol=2e-3,
                err_msg=f'core {c} elem {e} vs JAX Simulator.waveforms')


def test_run_dict_program(sim2, jsim2):
    out = sim2.run(X90_READ)
    assert int(out['err'][0]) == 0
    assert int(out['n_pulses'][0]) == 3
    assert out['rec_gtime'].ndim == 2        # one shot: no shot axis
    _assert_ints_equal(out, jsim2.run(X90_READ))
    assert out['_cfg'].max_meas == 16 and out['_mp'].n_cores == 1


def test_run_batch_sampled_bits(sim2, jsim2):
    """The counterpart of the JAX ``test_run_qasm_batch``: a batched run
    on bits sampled from ``p1`` (the port's generator is not threefry, so
    the port's sampled bits go through both packages)."""
    prog = active_reset(['Q0'])
    out = sim2.run(prog, shots=8, p1=0.5, key=4)
    assert tuple(out['n_pulses'].shape) == (8, 1)
    assert bool((out['err'] == 0).all())
    assert torch.equal(out['n_pulses'],
                       sim2.run(prog, shots=8, p1=0.5, key=4)['n_pulses'])
    from distributed_processor_tpu_torch.models.readout import (
        make_generator, sample_meas_bits)
    bits = sample_meas_bits(make_generator(4), np.full(1, 0.5, np.float32),
                            8, 16).numpy()
    assert len(np.unique(bits[:, 0, 0])) == 2    # both branches are taken
    _assert_ints_equal(out, jsim2.run(j_active_reset(['Q0']), shots=8,
                                      meas_bits=bits))


def test_waveform_x90_matches_env(sim2, jsim2):
    """The rendered qdrv trace is the calibrated DRAG envelope times the
    carrier — checked against an independent reconstruction and against
    both JAX renderers."""
    prog = [{'name': 'X90', 'qubit': ['Q0']}]
    out = sim2.run(prog)
    mp = out['_mp']
    wf = sim2.waveforms(out)
    trace = tops.iq_to_complex(wf[0][0])          # core 0, qdrv
    assert int(out['n_pulses'][0]) == 1
    gtime = int(out['rec_gtime'][0, 0])
    amp_word = int(out['rec_amp'][0, 0])
    spc = mp.tables[0].elem_cfgs[0].samples_per_clk
    env = np.asarray(mp.tables[0].envs[0]) / (2**15 - 1)
    freq_hz = mp.tables[0].freqs[0]['freq'][int(out['rec_freq'][0, 0])]
    fs = mp.tables[0].elem_cfgs[0].sample_freq
    start = gtime * spc
    n_env = ((int(out['rec_env'][0, 0]) >> 12) & 0xfff) * 4
    k = np.arange(n_env)
    expected = (amp_word / (2**16 - 1)) * env[:n_env] \
        * np.exp(2j * np.pi * (freq_hz / fs) * (start + k))
    np.testing.assert_allclose(trace[start:start + n_env], expected,
                               atol=1e-4)
    assert np.allclose(trace[:start], 0)         # nothing before the pulse
    # the default trace length is the JAX facade's (end of last pulse + 8)
    out_j = jsim2.run(prog)
    _assert_ints_equal(out, out_j)
    end = int((out_j['rec_gtime'] + out_j['rec_dur']).max()) + 8
    assert wf[0][0].shape == (end * spc, 2)
    _assert_traces_match_jax(sim2.waveforms(out, n_clks=N_CLKS), jsim2,
                             out_j, N_CLKS)


def test_readout_physics_loop(sim2, jsim2):
    """Run read, synthesize the rdlo tone, demod with a matched window,
    discriminate against calibrated centroids — beside the JAX chain."""
    prog = [{'name': 'read', 'qubit': ['Q0']}]
    out = sim2.run(prog)
    mp = out['_mp']
    wf = sim2.waveforms(out)
    rdlo = wf[0][2]                          # core 0, elem 2 trace [N, 2]
    ecfg = mp.tables[0].elem_cfgs[2]
    spc = ecfg.samples_per_clk
    elems = out['rec_elem'][0, :int(out['n_pulses'][0])].numpy()
    i = int(np.nonzero(elems == 2)[0][0])
    gtime = int(out['rec_gtime'][0, i])
    dur = int(out['rec_dur'][0, i])
    freq_hz = mp.tables[0].freqs[2]['freq'][int(out['rec_freq'][0, i])]
    w = tops.pulse_window_weights(gtime, dur, spc, freq_hz, ecfg.sample_freq)
    W = tops.stack_window_weights([w], rdlo.shape[0], starts=[gtime * spc])
    acc = sim2.demod_readout(out, rdlo[None, :, 0], W)
    assert isinstance(acc, torch.Tensor) and tuple(acc.shape) == (1, 1, 2)
    iq = tops.iq_to_complex(acc)[0, 0]
    n_win = dur * spc
    # matched filter on a unit tone: |IQ| ~ n_win/2 (amp=1.0 rdlo pulse)
    assert abs(iq) > 0.4 * n_win / 2
    bits = tops.discriminate(np.array([[[iq.real, iq.imag]]]),
                             centers0=np.array([0j]), centers1=np.array([iq]))
    assert int(bits[0, 0]) == 1
    # the JAX chain on the same program: same records, same trace, same IQ
    out_j = jsim2.run(prog)
    _assert_ints_equal(out, out_j)
    rdlo_j = np.asarray(jsim2.waveforms(out_j)[0][2])
    np.testing.assert_allclose(rdlo, rdlo_j, atol=2e-3)
    iq_j = tops.iq_to_complex(np.asarray(
        jsim2.demod_readout(out_j, rdlo_j[None, :, 0], W)))[0, 0]
    # 1024-sample sums of traces that agree to 2e-3: well inside 1e-3 of
    # the window's full-scale sum
    assert abs(iq - iq_j) < 1e-3 * n_win


def test_waveform_batched_shot_selection(sim2, jsim2):
    bits = np.concatenate([np.zeros((2, 1, 16), int), np.ones((2, 1, 16), int)])
    out = sim2.run(active_reset(['Q0']), shots=4, meas_bits=bits)
    with pytest.raises(ValueError, match='shot='):
        sim2.waveforms(out)
    wf0 = sim2.waveforms(out, shot=0)
    wf3 = sim2.waveforms(out, shot=3, n_clks=600)
    assert wf3[0][0].shape == (600 * 16, 2)
    # measured-1 shot plays the two extra X90s on qdrv
    e0 = np.abs(tops.iq_to_complex(wf0[0][0])).sum()
    e3 = np.abs(tops.iq_to_complex(wf3[0][0])).sum()
    assert e3 > e0
    out_j = jsim2.run(j_active_reset(['Q0']), shots=4, meas_bits=bits)
    _assert_ints_equal(out, out_j)
    for shot in (0, 3):
        _assert_traces_match_jax(
            sim2.waveforms(out, shot=shot, n_clks=N_CLKS, cores=[0]),
            jsim2, out_j, N_CLKS, shot=shot)
    assert sorted(sim2.waveforms(out, shot=1, cores=[0])) == [0]


def test_waveforms_of_a_jax_run(sim2, jsim2):
    """A JAX run's records, as numpy, through the port's renderer, next
    to the JAX-compiled program carried across as arrays."""
    bits = np.ones((2, 2, 16), int)
    out_j = jsim2.run(j_active_reset(['Q0', 'Q1']), shots=2, meas_bits=bits)
    carried = {k: np.asarray(v) for k, v in out_j.items()
               if not k.startswith('_')}
    carried['_mp'] = machine_program_from_arrays(
        machine_program_to_arrays(out_j['_mp']))
    wf = sim2.waveforms(carried, shot=1, n_clks=N_CLKS)
    assert sorted(wf) == [0, 1]
    _assert_traces_match_jax(wf, jsim2, out_j, N_CLKS, shot=1, cores=(1,))
    assert np.abs(wf[1][0]).max() > 0.1      # the conditional X90s render


def test_waveforms_need_records(sim2):
    out = sim2.run(X90_READ, record_pulses=False)
    with pytest.raises(ValueError, match='record_pulses'):
        sim2.waveforms(out)


def test_run_physics(sim2, jsim2):
    """``physics=`` closes the measurement loop in-sim; at sigma = 0 the
    bits equal the JAX facade's."""
    prog = active_reset(['Q0', 'Q1'])
    model = ReadoutPhysics(sigma=0.0, p1_init=1.0)
    out = sim2.run(prog, shots=4, physics=model, key=5)
    assert out['_cfg'].physics and int(out['epochs']) >= 1
    assert bool(out['meas_bits'][:, :, 0].all())     # every qubit starts in 1
    from distributed_processor_tpu.sim.physics import \
        ReadoutPhysics as JReadoutPhysics
    out_j = jsim2.run(j_active_reset(['Q0', 'Q1']), shots=4,
                      physics=JReadoutPhysics(sigma=0.0, p1_init=1.0))
    for key in ('meas_bits', 'meas_bits_valid', 'n_pulses', 'err', 'fault',
                'rec_gtime', 'rec_amp'):
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    with pytest.raises(ValueError, match='cannot also'):
        sim2.run(prog, shots=4, physics=model, p1=0.5)


def test_truncation_warns_loudly():
    """Exhausting max_steps raises a RuntimeWarning naming the budget, in
    both packages, with identical truncated state."""
    sim = Simulator(n_qubits=1, device='cpu')
    body = [{'name': 'X90', 'qubit': ['Q0']}]
    mp = sim.compile(loop_shots_program(body, 200, scope=['Q0']))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        out = sim.run(mp, shots=2, max_steps=32, max_meas=1)
    assert bool(out['incomplete'])
    assert any('max_steps' in str(w.message) for w in caught)
    jsim = JSimulator(n_qubits=1)
    with warnings.catch_warnings(record=True) as jcaught:
        warnings.simplefilter('always')
        out_j = jsim.run(jsim.compile(j_loop_shots(body, 200, scope=['Q0'])),
                         shots=2, max_steps=32, max_meas=1)
    assert any('max_steps' in str(w.message) for w in jcaught)
    _assert_ints_equal(out, out_j)
    # the pulse budget warns too
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        sim.run(mp, shots=2, max_pulses=4, max_meas=1)
    assert any('max_pulses' in str(w.message) for w in caught)


def test_interpreter_config_sizes_budgets(sim2, jsim2):
    import dataclasses
    mp = sim2.compile(X90_READ)
    jmp = jsim2.compile(X90_READ)
    for kw in (dict(), dict(max_steps=77, max_pulses=9), dict(max_meas=2)):
        assert dataclasses.asdict(sim2.interpreter_config(mp, **kw)) \
            == dataclasses.asdict(jsim2.interpreter_config(jmp, **kw))


def test_unported_entries_name_the_roadmap(sim2, jsim2):
    """Once unported (the QASM front door), now held against the JAX
    facade: OpenQASM text compiles to JAX's bytes and runs with every
    integer output equal to JAX's run on the same bits."""
    from distributed_processor_tpu.compilecache import \
        machine_program_bytes as j_bytes
    from distributed_processor_tpu_torch.compilecache import \
        machine_program_bytes
    # a source with no instruction: both compile stacks refuse it alike
    with pytest.raises(ValueError) as e_t:
        sim2.compile('qubit[1] q;')
    with pytest.raises(ValueError) as e_j:
        jsim2.compile('qubit[1] q;')
    assert str(e_t.value) == str(e_j.value)
    src = 'qubit[1] q; reset q[0];'
    assert machine_program_bytes(sim2.compile(src)) \
        == j_bytes(jsim2.compile(src))
    bits = np.random.default_rng(8).integers(0, 2, (8, 1, 2)) \
        .astype(np.int32)           # the program's one core
    _assert_ints_equal(sim2.run(src, shots=8, meas_bits=bits),
                       jsim2.run(src, shots=8, meas_bits=bits))
    # sampled bits (p1) are drawn by each package's own generator: the
    # run is whole, with one measurement on core 0 per shot
    out = sim2.run(src, shots=8, p1=0.5)
    assert not bool(out['incomplete']) and not out['err'].any()
    assert out['n_meas'][:, 0].tolist() == [1] * 8
    # the statevec device runs now (item 4), its coupling map derived
    # from the program and the gate library
    out = sim2.run(X90_READ, shots=2, physics=ReadoutPhysics(
        sigma=0.0, device=DeviceModel('statevec')))
    assert tuple(out['psi'].shape) == (2, 1 << out['_mp'].n_cores)
    assert not bool(out['incomplete'])


def test_simulator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA'):
        Simulator(n_qubits=2)
