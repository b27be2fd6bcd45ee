"""The checks of ``correct`` fail what they must: the control (the
reference with TF32 products in the program's place) and the faults a
training cell can have, planted under a run."""

import pytest
import torch

from portbench import calibrate, compare, spec
from portbench.run import run_cell
from portbench.tests.pb_small import SMALL, small_cell


@pytest.mark.parametrize('name', sorted(SMALL))
def test_control_and_half_batch_fail_the_limits(name):
    cell = small_cell(name)
    r = calibrate.readings(cell, 4242, 'cpu', control=True)
    limits = cell.traffic['limits']
    assert compare.judge(r['program'], limits), r
    assert not compare.judge(r['control'], limits), r
    assert not compare.judge(r['half_batch'], limits), r


def _unchanged_step(monkeypatch):
    """Adam's step runs, then every weight is put back: a step that
    returns its state unchanged."""
    step = torch.optim.Adam.step

    def broken(self, closure=None):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g['params']]
        step(self, closure)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g['params']), before):
                p.copy_(b)

    monkeypatch.setattr(torch.optim.Adam, 'step', broken)


def _half_batch(monkeypatch, name):
    """The loss over half of the batch (graphs or training nodes), the
    mean taken over the rest."""
    if name.startswith('zinc'):
        from pna_tpu_torch.nn.nets import PNANetMolecules
        loss = PNANetMolecules.loss

        def half(scores, targets, graph_mask=None):
            m = graph_mask.clone()
            real = torch.nonzero(m).flatten()
            m[real[len(real) // 2:]] = False
            return loss(scores, targets, m)

        monkeypatch.setattr(PNANetMolecules, 'loss', staticmethod(half))
    else:
        from pna_tpu_torch.train import largegraph
        make = largegraph.make_node_train_step

        def make_half(*a, **k):
            step, evaluate, tables = make(*a, **k)

            def half(feats, targets, mask):
                keep = torch.zeros_like(mask)
                keep[::2] = True
                return step(feats, targets, mask & keep)

            return half, evaluate, tables

        monkeypatch.setattr(largegraph, 'make_node_train_step', make_half)


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch'])
@pytest.mark.parametrize('name', sorted(SMALL))
def test_a_broken_step_reads_incorrect(monkeypatch, name, fault):
    if fault == 'unchanged':
        _unchanged_step(monkeypatch)
    else:
        _half_batch(monkeypatch, name)
    r, _ = run_cell(small_cell(name), 31337, 0.1, False, 'cpu', 0.0)
    assert not r['correct'], r['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(SMALL))
def test_control_fails_at_the_cells_size(card, name):
    """On the card, at the cell's own size: the program within every
    limit, the control and the half-batch fault outside one."""
    cell = spec.load_cell(name)
    r = calibrate.readings(cell, 777, card, control=True)
    limits = cell.traffic['limits']
    assert compare.judge(r['program'], limits), r
    assert not compare.judge(r['control'], limits), r
    assert not compare.judge(r['half_batch'], limits), r
