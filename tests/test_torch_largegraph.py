"""The port's large-graph trainer (``train/largegraph.py``) and its CLI.

* On one rank, the JAX tests' configuration (``tests/test_largegraph_trainer.py``:
  2k nodes, 10k power-law edges, hidden 16, 2 towers, 2 layers, lr 3e-3) at
  ``d_graph`` 1: 60 steps with the train loss below 0.6 of its first and a
  falling validation loss; a run of 3 steps, checkpointed and resumed to 6,
  equal to 6 straight steps; the JSONL curve; the CLI on a small graph.
* Two spawned gloo ranks (``d_graph`` 2) from the JAX trainer's initial
  weights against the JAX trainer on one device (``d_graph`` 1), both on the
  generic backend: the first loss within 1e-5, the next four within 1e-3
  (Adam, the trainer's optimiser).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from pna_tpu.parallel.distributed_net import DistributedPNANet as JNet
from pna_tpu.parallel.distributed_net import init_net as jinit_net
from pna_tpu.train import largegraph as jlg
from pna_tpu_torch.cli import train_largegraph as cli
from pna_tpu_torch.train.largegraph import LargeGraphConfig, train_largegraph
from pna_tpu_torch.weights import from_jax

from tests import _torch_dist_ranks as ranks


def _kw(**kw):
    base = dict(num_nodes=2000, num_edges=10000, d_graph=1, hidden_dim=16,
                out_dim=16, towers=2, n_layers=2, steps=60, eval_every=10,
                lr=3e-3, seed=0)
    base.update(kw)
    return base


def _run(**kw):
    return train_largegraph(LargeGraphConfig(**_kw(**kw)), device='cpu')


def test_trainer_converges_50_steps():
    _, hist = _run()
    assert len(hist) == 60
    first, last = hist[0]['train_loss'], hist[-1]['train_loss']
    assert last < 0.6 * first, (first, last)
    vals = [h['val_loss'] for h in hist if 'val_loss' in h]
    assert len(vals) == 6 and vals[-1] < vals[0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The trainer's ops run on one thread: beside other test workers,
    torch's thread pool waits on threads the system has put to sleep (the
    50-step test took minutes in the full suite on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_trainer_resume_exact(tmp_path):
    """3 steps, a checkpoint, 3 resumed steps: the losses and weights of 6
    straight steps, bit for bit."""
    kw = dict(steps=6, eval_every=100, ckpt_every=3, kernel='csr')
    net_c, hist_c = _run(**kw)
    d = str(tmp_path / 'ck')
    _, h1 = _run(**dict(kw, steps=3, ckpt_dir=d))
    assert os.path.exists(os.path.join(d, 'latest.ckpt'))
    net_r, h2 = _run(**dict(kw, ckpt_dir=d, resume=True))
    assert [h['step'] for h in h2] == [4, 5, 6]
    assert [h['train_loss'] for h in h1 + h2] == [
        h['train_loss'] for h in hist_c]
    for k, v in net_c.state_dict().items():
        assert torch.equal(net_r.state_dict()[k], v), k


def test_trainer_jsonl_curve(tmp_path):
    log = str(tmp_path / 'curve.jsonl')
    _run(num_nodes=400, num_edges=2000, steps=5, eval_every=5,
         log_path=log)
    recs = [json.loads(line) for line in open(log)]
    assert [r['step'] for r in recs] == [1, 2, 3, 4, 5]
    assert 'val_loss' in recs[-1]
    assert all(0 < r['step_s'] <= r['wall_s'] + 1e-3 for r in recs)


def test_node_step_without_mesh_is_the_plain_step():
    """``make_node_train_step`` without a mesh (no process group) is the
    masked-MSE step written out: the same loss, gradients and SGD update."""
    from pna_tpu_torch.parallel.distributed_net import (DistributedPNANet,
                                                        part_tables)
    from pna_tpu_torch.train.largegraph import (build_problem,
                                                make_node_train_step)
    cfg = LargeGraphConfig(**_kw(num_nodes=300, num_edges=1500,
                                 kernel='csr', edge_feat_dim=3))
    part, x, y, tmask, _, efeats, avg_d, kernel = build_problem(cfg, 'cpu')
    kw = dict(hidden_dim=16, out_dim=16, n_layers=2, towers=2, avg_d=avg_d,
              kernel=kernel, edge_features=True, edge_dim=3,
              node_level=True, device='cpu', seed=0)
    nets = [DistributedPNANet(cfg.feat_dim, **kw) for _ in range(2)]
    xs, ys, ms = (torch.from_numpy(a[0]) for a in (x, y, tmask))
    step, _, _ = make_node_train_step(
        part, None, nets[0], torch.optim.SGD(nets[0].parameters(), lr=0.1),
        efeats=efeats)
    loss = step(xs, ys, ms)
    net = nets[1]
    tab = part_tables(part, net, 0, 'cpu', efeats)
    net.train()
    pred = net(tab.graph, xs, **tab.net_kwargs(distributed=False))
    m = ms.float()
    want = (((pred - ys) ** 2) * m).sum() / m.sum()
    want.backward()
    torch.optim.SGD(net.parameters(), lr=0.1).step()
    assert loss == pytest.approx(float(want.detach()), rel=1e-6)
    for (k, a), b in zip(nets[0].named_parameters(), net.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7,
                                   msg=k)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)


def test_cli_smoke(capsys):
    net, hist = cli.main(['--nodes', '300', '--edges', '1500', '--d_graph',
                          '1', '--steps', '3', '--eval_every', '3',
                          '--hidden_dim', '8', '--out_dim', '8',
                          '--towers', '2', '--n_layers', '2', '--kernel',
                          'csr_fused', '--edge_feat_dim', '3'],
                         device='cpu')
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['steps_run'] == 3 and np.isfinite(out['final']['val_loss'])
    assert net.layers[0].kernel == 'csr_fused'


def test_two_ranks_match_jax_trainer(tmp_path):
    kw = _kw(steps=5, eval_every=100, kernel='generic')
    jcfg = jlg.LargeGraphConfig(**dict(kw, d_graph=1))
    # the JAX trainer's initial weights, drawn as it draws them
    part, _, _, _, _, efeats, avg_d, kernel = jlg.build_problem(jcfg)
    jnet = JNet(hidden_dim=16, out_dim=16, n_layers=2, towers=2,
                avg_d=avg_d, batch_norm=True, residual=True,
                bn_axes=('data', 'graph'), kernel=kernel, node_level=True)
    params, stats = jinit_net(jnet, part, jcfg.feat_dim, seed=0)
    state = from_jax(jax.tree_util.tree_map(np.asarray, params),
                     jax.tree_util.tree_map(np.asarray, stats))
    _, _, jhist = jlg.train_largegraph(jcfg, devices=jax.devices()[:1])
    hists = ranks.run_world('largegraph_ranks', 2, tmp_path,
                            dict(kw, d_graph=2), state)
    want = [h['train_loss'] for h in jhist]
    for hist in hists:
        got = [h['train_loss'] for h in hist]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
