"""The port's command line (``cli.py``, ``python -m
distributed_processor_tpu_torch``) against the JAX package's.

Every subcommand of the JAX package's ``main`` runs here with
``--torch-device cpu``.  The deterministic outputs are the JAX
package's: ``compile`` (printed and saved), ``disasm``, ``envdump
--full`` and ``freqdump`` print the same text; ``run`` on injected bits
prints the same JSON, and ``run --physics --sigma 0`` the same integer
fields; ``trace`` prints the same steps and writes the same VCD bytes.
``sweep``, ``warmup``, ``qec-stream``, ``calibrate``, ``serve-bench``,
``trace-view`` and ``fleet-status`` run at tiny sizes and print the JAX
package's keys.  The module entry point in a process of its own prints
what the in-process call prints.
"""

import json
import os
import subprocess
import sys

import pytest

from distributed_processor_tpu.cli import main as jmain

from distributed_processor_tpu_torch.cli import main as tmain
from distributed_processor_tpu_torch.utils import profiling as t_profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ['--torch-device', 'cpu']
T = 120


@pytest.fixture(autouse=True)
def _port_registry_isolation():
    snap = t_profiling.registry_snapshot()
    yield
    t_profiling.registry_restore(snap)


def _both(capsys, argv):
    """``(JAX stdout, port stdout)`` of one command line."""
    capsys.readouterr()
    jmain(list(argv))
    j = capsys.readouterr().out
    tmain(PORT + list(argv))
    return j, capsys.readouterr().out


@pytest.fixture
def prog(tmp_path):
    """A 2-qubit program with a measurement-conditioned branch."""
    p = tmp_path / 'prog.json'
    p.write_text(json.dumps(
        [{'name': 'X90', 'qubit': ['Q0']},
         {'name': 'X90', 'qubit': ['Q1']},
         {'name': 'read', 'qubit': ['Q0']},
         {'name': 'branch_fproc', 'alu_cond': 'eq', 'cond_lhs': 1,
          'func_id': 'Q0.meas', 'scope': ['Q0'],
          'true': [{'name': 'X90', 'qubit': ['Q0']}], 'false': []},
         {'name': 'read', 'qubit': ['Q1']}]))
    return str(p)


@pytest.fixture
def qasm(tmp_path):
    p = tmp_path / 'p.qasm'
    p.write_text('OPENQASM 3; qubit[2] q; bit[2] c; reset q[0]; sx q[0]; '
                 'cx q[0], q[1]; c[0] = measure q[0]; '
                 'c[1] = measure q[1];')
    return str(p)


@pytest.mark.parametrize('cmd', [
    ['compile'], ['disasm'], ['disasm', '--core', '1'],
    ['envdump', '--full'], ['envdump', '--core', '0'], ['freqdump']])
def test_text_commands_equal_jax(capsys, prog, cmd):
    j, t = _both(capsys, ['--qubits', '2', cmd[0], prog] + cmd[1:])
    assert t == j and len(t.splitlines()) > 3


def test_text_commands_qasm(capsys, qasm):
    for cmd in ('compile', 'disasm', 'freqdump'):
        j, t = _both(capsys, ['--qubits', '2', cmd, qasm])
        assert t == j


def test_compile_output_file_equal_jax(capsys, prog, tmp_path):
    jo, to = tmp_path / 'j.json', tmp_path / 't.json'
    jmain(['--qubits', '2', 'compile', prog, '-o', str(jo)])
    tmain(PORT + ['--qubits', '2', 'compile', prog, '-o', str(to)])
    assert jo.read_text() == to.read_text()
    out = capsys.readouterr().out
    assert f'wrote {jo}' in out and f'wrote {to}' in out


def test_compile_cache_dir(capsys, prog, tmp_path):
    """``compile --cache-dir``: a miss, then a disk hit in a fresh
    cache; the JAX package's keys (the content keys differ by design)."""
    rows = []
    for _ in range(2):
        jmain(['--qubits', '2', 'compile', prog, '--cache-dir',
               str(tmp_path / 'jc')])
        j = json.loads(capsys.readouterr().out)
        tmain(PORT + ['--qubits', '2', 'compile', prog, '--cache-dir',
                      str(tmp_path / 'tc')])
        t = json.loads(capsys.readouterr().out)
        rows.append((j['status'], t['status']))
        assert set(t) == set(j) and set(t['cache']) == set(j['cache'])
        assert (t['n_cores'], t['n_instr']) == (j['n_cores'], j['n_instr'])
        assert t['qchip_fingerprint'] == j['qchip_fingerprint']
    assert rows == [('miss', 'miss'), ('disk', 'disk')]


@pytest.mark.parametrize('extra', [[], ['--p1', '1.0'], ['--p1', '0'],
                                   ['--engine', 'generic'],
                                   ['--engine', 'block'],
                                   ['--max-steps', '5']],
                         ids=['zeros', 'p1-one', 'p1-zero', 'generic',
                              'block', 'truncated'])
def test_run_injected_equals_jax(capsys, prog, extra):
    j, t = _both(capsys, ['--qubits', '2', 'run', prog, '--shots', '8']
                 + extra)
    assert json.loads(t) == json.loads(j)


def test_run_qasm_equals_jax(capsys, qasm):
    j, t = _both(capsys, ['--qubits', '2', 'run', qasm, '--shots', '4'])
    assert json.loads(t) == json.loads(j)


INT_FIELDS = ('shots', 'error_shots', 'fault_shots', 'steps', 'epochs')


@pytest.mark.parametrize('device', ['parity', 'bloch'])
def test_run_physics_sigma0_integer_fields(capsys, prog, device):
    j, t = (json.loads(x) for x in _both(
        capsys, ['--qubits', '2', 'run', prog, '--shots', '16', '--physics',
                 '--sigma', '0', '--p1-init', '0', '--device', device]))
    assert set(t) == set(j)
    assert {k: t[k] for k in INT_FIELDS} == {k: j[k] for k in INT_FIELDS}
    assert t['engine'] == j['engine']


def test_run_flag_validation(capsys, prog):
    for argv in (['run', prog, '--physics', '--p1', '0.5'],
                 ['run', prog, '--physics', '--device', 'bloch',
                  '--depol2', '0.1'],
                 ['run', prog, '--physics', '--classify3']):
        with pytest.raises(SystemExit) as je:
            jmain(['--qubits', '2'] + argv)
        with pytest.raises(SystemExit) as te:
            tmain(PORT + ['--qubits', '2'] + argv)
        assert str(te.value) == str(je.value)


def test_run_strict_faults_exit_code(capsys, prog):
    argv = ['--qubits', '2', 'run', prog, '--shots', '4', '--max-steps',
            '3', '--strict-faults']
    with pytest.raises(SystemExit) as je:
        jmain(argv)
    j = capsys.readouterr()
    with pytest.raises(SystemExit) as te:
        tmain(PORT + argv)
    t = capsys.readouterr()
    assert te.value.code == je.value.code == 2
    assert json.loads(t.out) == json.loads(j.out)
    assert t.err == j.err and 'fault summary' in t.err


def test_trace_equals_jax(capsys, prog, tmp_path):
    j, t = _both(capsys, ['--qubits', '2', 'trace', prog])
    assert t == j and 'pc=' in t
    jv, tv = tmp_path / 'j.vcd', tmp_path / 't.vcd'
    jmain(['--qubits', '2', 'trace', prog, '--vcd', str(jv)])
    tmain(PORT + ['--qubits', '2', 'trace', prog, '--vcd', str(tv)])
    assert tv.read_bytes() == jv.read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(jv), '') == out[1].replace(str(tv), '')


def test_sweep_keys_and_counts(capsys, prog, tmp_path):
    argv = ['--qubits', '2', 'sweep', prog, '--shots', '16', '--batch',
            '8', '--sigma', '0', '--p1-init', '0']
    j, t = (json.loads(x) for x in _both(capsys, argv))
    assert set(t) == set(j)
    for k in ('shots', 'clean_shots', 'err_shots', 'fault_shots',
              'engine', 'incomplete_batches'):
        assert t[k] == j[k], k
    # span and checkpoint: the same statistics, resumable
    ck = str(tmp_path / 'sweep.npz')
    tmain(PORT + argv + ['--span', '2', '--checkpoint', ck])
    t2 = json.loads(capsys.readouterr().out)
    assert t2 == t
    with pytest.raises(SystemExit, match='multiple'):
        tmain(PORT + argv + ['--span', '2', '--checkpoint-every', '3'])


def _catalog(tmp_path):
    """A bucket catalog with one spec, written by the JAX service."""
    from distributed_processor_tpu.serve import ExecutionService as JSvc
    from distributed_processor_tpu.serve.benchmark import _workload
    path = str(tmp_path / 'catalog.json')
    mps, bits, cfg = _workload(1, 2, 2, 4, 0)
    with JSvc(cfg, warmup_catalog=path, max_wait_ms=1.0) as svc:
        svc.submit(mps[0], bits[0]).result(timeout=T)
    return path


def test_warmup_keys(capsys, tmp_path):
    path = _catalog(tmp_path)
    j, t = _both(capsys, ['warmup', path])
    jl = [json.loads(x) for x in j.splitlines()]
    tl = [json.loads(x) for x in t.splitlines()]
    assert len(tl) == len(jl) == 2
    assert set(tl[0]) == set(jl[0])
    assert tl[0]['spec'] == jl[0]['spec']
    assert tl[0]['device'] == 'cpu'
    # the JAX summary names its XLA cache; the port's its kernel build
    # directory
    assert set(tl[1]) == set(jl[1]) - {'jax_cache'} | {'build_dir'}
    assert (tl[1]['specs'], tl[1]['devices']) == (jl[1]['specs'], 1)


@pytest.mark.parametrize('mode', [[], ['--per-round'], ['--surface']],
                         ids=['stream', 'per-round', 'surface'])
def test_qec_stream_equals_jax(capsys, mode):
    argv = ['qec-stream', '--rounds', '4', '--shots', '8', '--chunk', '2',
            '--distance', '3'] + mode
    j, t = (json.loads(x) for x in _both(capsys, argv))
    assert set(t) == set(j)
    for k in set(j) - {'wall_s', 'rounds_per_s'}:
        assert t[k] == j[k], k


def test_calibrate_equals_jax(capsys):
    j, t = (json.loads(x) for x in _both(
        capsys, ['calibrate', '--qubits', '2', '--shots', '2']))
    assert set(t) == set(j)
    assert set(t['service']) == set(j['service'])
    assert t['steps'] == j['steps'] and t['converged'] == j['converged']
    assert abs(t['params']['amp'] - j['params']['amp']) <= 1.6e-5


def test_serve_bench_keys(capsys, tmp_path):
    argv = ['serve-bench', '--requests', '4', '--shots', '4',
            '--max-wait-ms', '20']
    j, t = (json.loads(x) for x in _both(capsys, argv))
    assert set(t) == set(j) and t['bit_identical'] is True
    # the compile front door: the port's command only (the row's own
    # warm-speedup gate is timed; JAX's keys are those its source returns)
    from test_torch_serve_bench import _returned_keys
    from distributed_processor_tpu.serve.benchmark import compile_front_door
    tmain(PORT + ['serve-bench', '--source-mode', '--tenants', '4',
                  '--programs', '4', '--depth', '4', '--shots', '2'])
    t = json.loads(capsys.readouterr().out)
    assert set(t) == _returned_keys(compile_front_door)
    assert t['cold_compiles'] == 4


def test_trace_view_equals_jax(capsys, tmp_path):
    """``serve-bench --trace-out`` exports a Chrome trace that
    ``trace-view`` summarises as the JAX CLI does."""
    out = tmp_path / 'trace.json'
    tmain(PORT + ['serve-bench', '--requests', '2', '--shots', '2',
                  '--max-wait-ms', '5', '--trace-out', str(out)])
    row = json.loads(capsys.readouterr().out)
    assert row['trace_events'] > 0
    for flag in ([], ['--json']):
        j, t = _both(capsys, ['trace-view', str(out)] + flag)
        assert t == j and t
    bad = tmp_path / 'empty.json'
    bad.write_text('{"traceEvents": []}')
    with pytest.raises(SystemExit, match='trace-view'):
        tmain(PORT + ['trace-view', str(bad)])


def test_fleet_status_keys(capsys):
    """``fleet-status`` against a live port fleet prints the JAX CLI's
    rows (the JAX CLI reads the same replicas over the same wire)."""
    from distributed_processor_tpu_torch.serve import Fleet
    from distributed_processor_tpu_torch.serve.benchmark import _workload
    mps, bits, cfg = _workload(2, 2, 2, 2, 0)
    with Fleet(1, service={'devices': ['cpu']}, name='status',
               env={'OMP_NUM_THREADS': '1'}, ready_timeout_s=T) as f:
        for mp, b in zip(mps, bits):
            f.submit(mp, b, cfg=cfg, tenant='alice').result(timeout=T)
        host, port = f._replicas[0].address
        addr = f'{host}:{port}'
        j, t = (json.loads(x) for x in _both(
            capsys, ['fleet-status', addr, '--json']))
        assert [set(r) for r in t] == [set(r) for r in j]
        assert t[0]['completed'] == j[0]['completed'] == 2
        j, t = (json.loads(x) for x in _both(
            capsys, ['fleet-status', addr, '--tenants', '--json']))
        assert set(t) == set(j) and set(t['tenants']) == {'alice'}
        assert t['tenants']['alice']['shots'] == 4
        j, t = _both(capsys, ['fleet-status', addr, '--prometheus'])
        names = {ln.split()[2] for ln in t.splitlines()
                 if ln.startswith('# TYPE')}
        assert names == {ln.split()[2] for ln in j.splitlines()
                         if ln.startswith('# TYPE')}
        assert 'serve_submitted' in names
        j, t = _both(capsys, ['fleet-status', str(port)])
        assert t.splitlines()[0] == j.splitlines()[0]
    with pytest.raises(SystemExit, match='no replica reachable'):
        tmain(PORT + ['fleet-status', addr, '--timeout', '1'])


def test_module_entry_point_matches_in_process(capsys, prog):
    tmain(PORT + ['--qubits', '2', 'run', prog, '--shots', '8', '--p1',
                  '1.0'])
    want = json.loads(capsys.readouterr().out)
    res = subprocess.run(
        [sys.executable, '-m', 'distributed_processor_tpu_torch'] + PORT
        + ['--qubits', '2', 'run', prog, '--shots', '8', '--p1', '1.0'],
        cwd=ROOT, capture_output=True, text=True, timeout=T)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == want


def test_default_torch_device_is_the_card(prog):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    with pytest.raises(RuntimeError, match='CUDA'):
        tmain(['--qubits', '2', 'run', prog])
