"""``BENCHMARK.json`` keeps to its contract, every file it names loads by
name, and a new cell and metric come as new files alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess

import pytest

from portbench import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = spec.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(BENCH['command']) <= 32
    assert all(_line(w) for w in BENCH['command'])
    assert 1 <= BENCH['paths'].__len__() <= 16
    for p in BENCH['paths']:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', p)
        assert not p.startswith('/') and '..' not in p.split('/')
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = [c['name'] for c in BENCH['configs']] + CELLS + \
        [m['name'] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(c['name'] for c in BENCH['configs'])) == \
        len(BENCH['configs'])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m['name'] for m in METRICS)) == len(METRICS)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert _line(c['source']) and _line(c['why'])
        assert c['file'].startswith(tuple(p + '/' for p in BENCH['paths']))
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
    pairs = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert NAME.match(w['traffic'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for m in METRICS:
        keys = {'name', 'unit', 'better', 'source'}
        if m in BENCH['end_to_end']:
            keys |= {'bound'}
            assert m['source'] in ('host_clock', 'device_trace')
            assert 0.01 <= m['bound'] <= 0.25
        else:
            keys |= {'layer', 'moves'}
            assert m['moves'] in e2e and _line(m['layer'])
            assert m['source'] in ('device_trace', 'program_span',
                                   'program_counter', 'host_clock')
        assert set(m) - {'workloads'} == keys
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', CELLS)) <= set(CELLS)
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_loads_and_reports(cell):
    c = spec.load_cell(cell)
    names = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # the end-to-end metric it moves is reported in this cell
        assert m['moves'] in names
    assert hasattr(spec.load_driver(c.traffic['driver']), 'Driver')
    assert os.path.exists(os.path.join(spec.ROOT, c.config['reference']))
    from portbench.compare import NUMBERS
    assert c.traffic['limits'] and set(c.traffic['limits']) <= set(NUMBERS)


@pytest.mark.parametrize('metric', [m['name'] for m in METRICS])
def test_metric_file_loads(metric):
    assert callable(spec.load_metric(metric).read)


def test_paths_hold_only_named_files():
    for p in BENCH['paths']:
        for d, _, files in os.walk(os.path.join(spec.ROOT, p)):
            if '__pycache__' in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), spec.ROOT)
                assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, 'portbench')):
        if '__pycache__' in d:
            continue
        for f in files:
            path = os.path.join(d, f)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_new_files(tmp_path):
    """A dummy cell and a dummy metric, added as files and entries to a
    copy, load and run without an edit to any file that was there."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, 'portbench'),
                    os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digest(root)
    bench = json.loads(json.dumps(BENCH))
    with open(os.path.join(root, 'portbench', 'workloads',
                           'zinc_pna.train_tiny.json'), 'w') as f:
        json.dump(dict(spec.load_cell('zinc_pna.train_b128').traffic,
                       n_graphs=300), f)
    with open(os.path.join(root, 'portbench', 'metrics',
                           'epochs_seen.py'), 'w') as f:
        f.write("def read(ctx):\n    return float(ctx.window['steps'])\n")
    bench['workloads'].append(dict(name='zinc_pna.train_tiny',
                                   config='zinc_pna', traffic='train_tiny',
                                   chips=1, why='a test'))
    bench['per_layer'].append(dict(
        name='epochs_seen', unit='steps', better='higher',
        source='host_clock', layer='trainer', moves='train_edges_per_s',
        workloads=['zinc_pna.train_tiny']))
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = spec.load_cell('zinc_pna.train_tiny', root)
    assert cell.traffic['n_graphs'] == 300
    assert [m['name'] for m in cell.per_layer] == ['epochs_seen']
    assert spec.load_metric('epochs_seen', root).read(
        type('Ctx', (), {'window': {'steps': 7}})()) == 7.0


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    root = str(tmp_path)
    for p in BENCH['paths']:
        shutil.copytree(os.path.join(spec.ROOT, p), os.path.join(root, p),
                        ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), root)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run(BENCH['command'] + ['--workload', CELLS[0], '--seed',
                                           '1', '--seconds', '1',
                                           '--trace', '0'],
                       cwd=root, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
