"""Each driver, run on the CPU at a small size against the plain reference,
and the measuring path's refusals."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import FORBIDDEN, run_cell
from portbench.tests.pb_small import SMALL, small_cell


@pytest.mark.parametrize('name', sorted(SMALL))
def test_small_run_is_correct(name):
    r, _ = run_cell(small_cell(name), 2 ** 31 + 17, 0.2, True, 'cpu', 0.0)
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0
    assert list(r)[-1] == 'checks'
    assert r['device']['platform'] == 'cpu'
    # a CPU run reads no device metric and no host number of the card
    for m in r['metrics']:
        assert m.startswith(('collate_ms', 'loss_wait_ms')), m
    assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}


@pytest.mark.parametrize('name', sorted(SMALL))
def test_same_seed_same_readings(name):
    import torch
    a = spec.load_driver(small_cell(name).traffic['driver']).Driver(
        small_cell(name), 'cpu')
    b = spec.load_driver(small_cell(name).traffic['driver']).Driver(
        small_cell(name), 'cpu')
    a.setup(99)
    b.setup(99)
    assert a.program_readings == b.program_readings
    for k, v in a.weights.items():
        assert torch.equal(v, b.weights[k])


def test_end_to_end_metrics_from_a_window():
    r, _ = run_cell(small_cell('largegraph_pna.powerlaw_6m'), 5, 0.3, False,
                 'cpu', 0.0)
    m = r['metrics']
    assert m['train_edges_per_s.full_graph']['value'] > 0
    assert m['step_ms_p90']['unit'] == 'ms'
    assert 'peak_mem_gib' not in m          # no card, no allocator reading
    assert m['setup_s']['value'] > 0


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run([sys.executable, '-m'] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    """The measuring path refuses to run without a card: no CPU
    fallback, no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(['portbench.run', '--workload', 'zinc_pna.train_b128',
              '--seed', '1', '--seconds', '1', '--trace', '0'], spec.ROOT)
    assert p.returncode == 2
    assert p.stdout.strip() == ''
    assert 'CUDA' in p.stderr


def test_no_jax_after_a_run():
    """A run's process holds no module whose top-level name is one of
    FORBIDDEN (``pna_tpu_torch`` is not ``pna_tpu``)."""
    code = (
        "import json, sys\n"
        "from portbench.run import run_cell, forbidden_modules\n"
        "from portbench.tests.pb_small import small_cell\n"
        "for name in ('zinc_pna.train_b128', 'largegraph_pna.powerlaw_6m'):\n"
        "    run_cell(small_cell(name), 3, 0.1, True, 'cpu', 0.0)\n"
        "print(json.dumps([forbidden_modules(),\n"
        "    sorted({m.split('.')[0] for m in sys.modules})]))\n")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    p = subprocess.run([sys.executable, '-c', code], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    found, tops = json.loads(p.stdout.strip().splitlines()[-1])
    assert found == []
    assert 'pna_tpu_torch' in tops and not set(tops) & FORBIDDEN


def test_molecules_are_zinc_shaped():
    """The bulk draw gives what ``synthetic_zinc``'s loop gave: both
    directions of each bond, ordered by sender then receiver, no self-loop
    or repeated bond, a spanning tree, atoms and the label as defined."""
    import numpy as np

    from portbench.generators import NUM_ATOM_TYPE, zinc_like_molecules
    records = zinc_like_molecules(400, seed=2 ** 31 + 3, n_min=9, n_max=37)
    sizes = [r['node_feats'].shape[0] for r in records]
    assert min(sizes) >= 9 and max(sizes) <= 37
    assert 21 < np.mean(sizes) < 25
    for r in records:
        n = r['node_feats'].shape[0]
        s, d = r['senders'].astype(np.int64), r['receivers'].astype(np.int64)
        key = s * n + d
        assert np.all(np.diff(key) > 0) and np.all(s != d)
        assert set(zip(s.tolist(), d.tolist())) == set(zip(d.tolist(),
                                                          s.tolist()))
        assert len(s) >= 2 * (n - 1)
        reach, todo = {0}, [0]
        while todo:
            for v in d[s == todo.pop()].tolist():
                if v not in reach:
                    reach.add(v)
                    todo.append(v)
        assert len(reach) == n
        atoms = r['node_feats'][:, 0]
        assert atoms.min() >= 0 and atoms.max() < NUM_ATOM_TYPE
        assert np.all((r['edge_feats'] >= 1) & (r['edge_feats'] < 4))
        assert r['label'] == atoms.mean() / NUM_ATOM_TYPE + 0.1 * len(s) / (
            2.0 * n)
