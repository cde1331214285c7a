"""The port's golden suite (``models/golden_suite.py``) against the
committed goldens and the JAX package's suite.

Each of the eleven programs, compiled by the port, renders the committed
``tests/goldens/<name>.json`` byte for byte and equals the JAX package's
``compile_golden``; the two tables carry the same names, qubit counts
and programs.
"""

import os
import warnings

import pytest

from distributed_processor_tpu.models import golden_suite as jgolden

from distributed_processor_tpu_torch.models import golden_suite

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'goldens')


def _compile(module, name):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # loop z-phase notices
        return module.compile_golden(name)


def test_tables_equal_jax():
    assert list(golden_suite.GOLDEN_PROGRAMS) \
        == list(jgolden.GOLDEN_PROGRAMS)
    assert len(golden_suite.GOLDEN_PROGRAMS) == 11
    for name, (n, thunk) in golden_suite.GOLDEN_PROGRAMS.items():
        jn, jthunk = jgolden.GOLDEN_PROGRAMS[name]
        assert n == jn, name
        assert repr(thunk()) == repr(jthunk()), name


@pytest.mark.parametrize('name', list(golden_suite.GOLDEN_PROGRAMS))
def test_golden_bytes(name):
    got = golden_suite.canonical_json(_compile(golden_suite, name)) + '\n'
    with open(os.path.join(GOLDENS, name + '.json')) as f:
        assert got == f.read()
    assert got == jgolden.canonical_json(_compile(jgolden, name)) + '\n'


def test_main_writes_the_committed_goldens(tmp_path, monkeypatch):
    """``main`` regenerates every golden; pointed at a scratch tree it
    writes the committed bytes."""
    pkg = tmp_path / 'distributed_processor_tpu_torch' / 'models'
    pkg.mkdir(parents=True)
    monkeypatch.setattr(golden_suite, '__file__',
                        str(pkg / 'golden_suite.py'))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        golden_suite.main()
    for name in golden_suite.GOLDEN_PROGRAMS:
        with open(os.path.join(GOLDENS, name + '.json')) as f:
            assert (tmp_path / 'tests' / 'goldens' / (name + '.json')) \
                .read_text() == f.read(), name
