"""Sweep spans (``span=`` on both sweep drivers) in the port.

The contract of the JAX package's ``tests/test_sweep_span.py``: folding
``span`` batches into one device-side carry before the host fetches them
(``sim.interpreter.make_span_runner``, driven one span behind by
``parallel.sweep.run_spanned``) gives the per-batch loop's result bit
for bit — the same ``derive_seed(seed, i)`` stream folds into the same
integer sums — for spans that divide or straddle the batch count, on
both engines, across checkpoint resumes landing mid-span or on a span
edge, and under a dp mesh.  Spans start on the absolute batch grid.
The JAX span runner's trace counter has no counterpart: torch does not
trace.
"""

import numpy as np
import pytest
import torch

from distributed_processor_tpu_torch import compile_to_machine
from distributed_processor_tpu_torch.models import (active_reset,
                                                    make_default_qchip,
                                                    rb_ensemble)
from distributed_processor_tpu_torch.parallel import (make_mesh,
                                                      run_multi_sweep,
                                                      run_physics_sweep,
                                                      run_spanned)
from distributed_processor_tpu_torch.sim.interpreter import make_span_runner
from distributed_processor_tpu_torch.sim.physics import ReadoutPhysics
from distributed_processor_tpu_torch.utils.results import (SweepAccumulator,
                                                           load_results)

N_BATCHES, BATCH = 7, 16


@pytest.fixture(scope='module')
def physics():
    mp = compile_to_machine(active_reset(['Q0', 'Q1']),
                            make_default_qchip(2), n_qubits=2)
    model = ReadoutPhysics(sigma=0.01, p1_init=0.5)
    kw = dict(max_steps=mp.n_instr * 4 + 64, max_pulses=8, max_meas=2)
    return mp, model, kw


def _sweep(physics, n=N_BATCHES, **kw):
    mp, model, cfg = physics
    return run_physics_sweep(mp, model, n * BATCH, BATCH, seed=5,
                             device='cpu', **dict(cfg, **kw))


def _assert_same(a: dict, b: dict, ctx=''):
    assert set(a) == set(b), ctx
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k], f'{ctx}{k}.')
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f'{ctx}{k}')


@pytest.fixture(scope='module')
def loops(physics):
    """The per-batch sweep on each engine: the reference of every span."""
    return {sl: _sweep(physics, straightline=sl) for sl in (False, True)}


@pytest.mark.parametrize('straightline', [False, True],
                         ids=['generic', 'straightline'])
@pytest.mark.parametrize('span', [1, 2, 3, 4])
def test_physics_span_parity(physics, loops, span, straightline):
    """7 batches at spans 1-4 (dividing, straddling, and a trailing
    partial span) equal the per-batch loop exactly on both engines."""
    sp = _sweep(physics, span=span, straightline=straightline)
    _assert_same(loops[straightline], sp, f'span={span}: ')


@pytest.mark.parametrize('span', [2, 3, 4])
def test_multi_span_parity_and_err_shots(span):
    """The ensemble driver: spanned == loop exactly, and the result
    carries the per-program integer err_shots behind err_rate."""
    qchip = make_default_qchip(2)
    mps = [compile_to_machine(active_reset(['Q0', 'Q1']) + p, qchip,
                              n_qubits=2)
           for p in rb_ensemble(['Q0', 'Q1'], 1, 2, seed=41)]
    kw = dict(p1=0.5, seed=3, max_meas=2, max_resets=2, device='cpu')
    loop = run_multi_sweep(mps, N_BATCHES * 4, 4, **kw)
    assert loop['err_shots'].shape == (2,)
    assert np.issubdtype(loop['err_shots'].dtype, np.integer)
    np.testing.assert_array_equal(loop['err_shots'],
                                  loop['err_rate'] * loop['shots'])
    _assert_same(loop, run_multi_sweep(mps, N_BATCHES * 4, 4, span=span,
                                       **kw), f'span={span}: ')


@pytest.mark.parametrize('span,stop,every', [(3, 5, 1), (3, 6, 3), (4, 2, 1),
                                             (2, 3, 2)],
                         ids=['mid_span', 'span_edge', 'cross_span',
                              'odd_stop'])
def test_span_checkpoint_resume(physics, loops, tmp_path, span, stop,
                                every):
    """A sweep stopped after ``stop`` batches and resumed — mid-span or
    on a span edge, under the same span or another (span is no part of
    the checkpoint's identity) — equals the uninterrupted loop."""
    ck = str(tmp_path / 'ck.npz')
    _sweep(physics, n=stop, span=span, checkpoint=ck,
           checkpoint_every=every)
    assert int(load_results(ck)[1]['n_batches']) == stop
    resume_span = span if span != 4 else 1
    resumed = _sweep(physics, span=resume_span, checkpoint=ck,
                     checkpoint_every=every)
    _assert_same(loops[False], resumed, f'span={span} stop={stop}: ')


def test_span_mesh_parity(physics):
    """A one-rank dp mesh: the spanned sharded sweep equals its per-batch
    loop (tests/test_torch_mesh.py runs 2 and 4 ranks)."""
    mesh = make_mesh(device='cpu')
    loop = _sweep(physics, mesh=mesh)
    for span in (3, 4):
        _assert_same(loop, _sweep(physics, mesh=mesh, span=span),
                     f'mesh span={span}: ')


class _Recorder:
    """A step of int64 sums and an accumulator that log what ran when."""

    def __init__(self, start=0):
        self.log, self.n_batches, self.state = [], start, {}

    def step(self, i):
        self.log.append(('run', i))
        return {'x': torch.tensor(i, dtype=torch.int64),
                'one': torch.ones(2, dtype=torch.int64)}

    def add_span(self, stats, n):
        self.log.append(('fold', self.n_batches, n))
        for k, v in stats.items():
            self.state[k] = self.state.get(k, 0) + v
        self.n_batches += n


@pytest.mark.parametrize('start,span', [(0, 3), (5, 3), (4, 4), (0, 1)])
def test_run_spanned_grid_and_lag(start, span):
    """Spans start on the absolute grid (a resume at 5 under span 3 runs
    5, then 6; the tail is partial), and the host folds each span only
    after the next one ran: one fetch per span, one span behind."""
    rec = _Recorder(start)
    run_spanned(rec.step, rec, N_BATCHES, span)
    runs = [e[1] for e in rec.log if e[0] == 'run']
    assert runs == list(range(start, N_BATCHES))
    folds = [e[1:] for e in rec.log if e[0] == 'fold']
    cells, i = [], start
    while i < N_BATCHES:
        size = min(span - i % span, N_BATCHES - i)
        cells.append((i, size))
        i += size
    assert folds == cells
    for j, (first, size) in enumerate(cells[:-1]):
        # span j is folded after span j+1's last batch ran
        fold_at = rec.log.index(('fold', first, size))
        nxt = cells[j + 1]
        assert rec.log.index(('run', nxt[0] + nxt[1] - 1)) < fold_at
    assert int(rec.state['x']) == sum(range(start, N_BATCHES))
    np.testing.assert_array_equal(rec.state['one'],
                                  [N_BATCHES - start] * 2)


def test_span_runner_folds_on_device():
    """``make_span_runner`` returns the sum of a span's batches as device
    tensors (int64, no host copy), equal to the per-batch sum."""
    runner = make_span_runner(
        lambda i: {'x': torch.full((3,), i, dtype=torch.int64)})
    out = runner(2, 4)
    assert out['x'].dtype == torch.int64 and isinstance(out['x'],
                                                        torch.Tensor)
    np.testing.assert_array_equal(out['x'].numpy(), [2 + 3 + 4 + 5] * 3)


def test_span_validation(physics):
    with pytest.raises(ValueError, match='span'):
        _sweep(physics, span=0)
    acc = SweepAccumulator()
    with pytest.raises(ValueError, match='span'):
        acc.add_span({'x': np.int32(1)}, 0)
