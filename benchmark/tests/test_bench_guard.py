"""The import guard compares whole top-level names, and nothing the
benchmark runs imports JAX or the JAX package; nothing in the reference
imports the port."""

from __future__ import annotations

import ast
import os
import sys
import types

import pytest

from benchmark.harness import common

BENCH = common.BENCH


def _imports(path: str) -> list:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def _files(folder: str) -> list:
    return [os.path.join(d, f) for d, _s, fs in os.walk(folder)
            for f in fs if f.endswith('.py')]


def test_guard_matches_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'distributed_processor_tpu_torch_x',
                        types.ModuleType('x'))
    assert common.banned_modules() == []
    monkeypatch.setitem(sys.modules, 'distributed_processor_tpu.sim',
                        types.ModuleType('x'))
    assert common.banned_modules() == ['distributed_processor_tpu.sim']
    with pytest.raises(SystemExit):
        common.guard('test')


@pytest.mark.parametrize('name', ['jax', 'jaxlib', 'flax'])
def test_guard_finds_jax(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert common.banned_modules() == [name]


def test_no_file_imports_jax_or_the_jax_package():
    for path in _files(BENCH):
        for mod in _imports(path):
            assert mod.split('.')[0] not in common.BANNED, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in _files(os.path.join(BENCH, 'reference')):
        for mod in _imports(path):
            top = mod.split('.')[0]
            assert not top.startswith('distributed_processor_tpu'), \
                (path, mod)
            assert top != 'benchmark', (path, mod)
