"""The superpixel slice of the port against pna_tpu on the CPU: the records
(one seed, the same numpy and scipy calls), the pickle loader on fixtures in
the reference's format, PNANetSuperpixels (forward, masked cross-entropy
and every gradient) on 'csr' against the JAX net on 'pallas' in interpret
mode with the weights carried by weights.from_jax, and the superpixel CLI.

Tolerances: records equal; logits and loss rtol 1e-4 (atol 1e-5 on the
logits); gradients rtol 2e-4, atol 2e-5, as tests/test_torch_net.py holds
the ZINC net (float32 sums in other orders)."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.data import molecules as jmol
from pna_tpu.data import superpixels as jsp
from pna_tpu.nn.nets import PNANetSuperpixels as JNet
from pna_tpu_torch.cli import main_superpixels
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.data import superpixels as tsp
from pna_tpu_torch.nn.nets import PNANetSuperpixels
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The trainer's many small ops run on one thread: beside other test
    workers, torch's thread pool would wait on threads the system has put
    to sleep (the CLI tests took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_records_match_jax():
    a = tsp.SuperpixelsDataset.synthetic(n_train=6, n_val=2, n_test=2,
                                         seed=4, n_sp=30)
    b = jsp.SuperpixelsDataset.synthetic(n_train=6, n_val=2, n_test=2,
                                         seed=4, n_sp=30)
    for split in ('train', 'val', 'test'):
        for r, s in zip(getattr(a, split), getattr(b, split)):
            assert r.keys() == s.keys()
            for k in r:
                np.testing.assert_array_equal(r[k], s[k])
    assert a.avg_d() == b.avg_d()
    rec = a.train[0]
    assert rec['node_feats'].shape == (30, 3)
    assert len(rec['senders']) == 30 * 8        # k = 8 neighbours
    # a small graph (<= 9 nodes) becomes fully connected
    small = tsp.synthetic_superpixels(1, n_sp=6, seed=1)[0]
    assert len(small['senders']) == 6 * 5


def test_from_dir_matches_jax(tmp_path):
    """mnist_75sp_{split}.pkl = pickle of (labels as a list, sp_data) whose
    entries carry (mean_px [N], coord [N, 2] in pixels, extra); the last
    ``val_fraction`` train graphs become val."""
    rng = np.random.RandomState(1)

    def make_split(n):
        labels = [int(x) for x in rng.randint(0, 10, n)]
        data = []
        for _ in range(n):
            sp = rng.randint(8, 14)
            data.append((rng.rand(sp).astype(np.float32),
                         (rng.rand(sp, 2) * 28).astype(np.float32),
                         np.zeros(3)))
        return labels, data

    for split, n in (('train', 8), ('test', 4)):
        with open(tmp_path / f'mnist_75sp_{split}.pkl', 'wb') as f:
            pickle.dump(make_split(n), f)
    got = tsp.SuperpixelsDataset.from_dir(str(tmp_path), 'MNIST',
                                          val_fraction=3)
    want = jsp.SuperpixelsDataset.from_dir(str(tmp_path), 'MNIST',
                                           val_fraction=3)
    assert [len(got.train), len(got.val), len(got.test)] == [5, 3, 4]
    for split in ('train', 'val', 'test'):
        for r, s in zip(getattr(got, split), getattr(want, split)):
            for k in r:
                np.testing.assert_array_equal(r[k], s[k])


NET = dict(hidden_dim=10, out_dim=10, n_classes=10, n_layers=2,
           aggregators=AGGS, scalers=SCAL, readout_type='sum', towers=2,
           divide_input_first=True, divide_input_last=False,
           graph_norm=True, batch_norm=True, residual=True)


@pytest.mark.parametrize("edge_feat", [True, False])
def test_net_forward_loss_grads_match_jax(edge_feat):
    ds = tsp.SuperpixelsDataset.synthetic(n_train=6, n_val=1, n_test=1,
                                          seed=2, n_sp=14)
    kw = dict(NET, in_dim=3, in_dim_edge=1, avg_d=ds.avg_d(),
              edge_feat=edge_feat, edge_dim=4 if edge_feat else 0)
    tg, tl = tmol.collate_records(ds.train)
    jg, jl = jmol.collate_records(ds.train)
    jnet = JNet(**kw, kernel='pallas', pallas_interpret=True)
    je = jg.edge_feats if edge_feat else None
    var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, jg,
                        jg.node_feats, je, train=False))

    def loss_fn(p):
        out, _ = jnet.apply({'params': p, 'batch_stats': var['batch_stats']},
                            jg, jg.node_feats, je, train=True,
                            mutable=['batch_stats'])
        return JNet.loss(out, jnp.asarray(jl), jg.graph_mask), out

    (l_j, out_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        var['params'])
    tnet = PNANetSuperpixels(**kw, device='cpu')
    tnet.load_state_dict(from_jax(var['params'], var['batch_stats']))
    tnet.train()
    out_t = tnet(tg, tg.node_feats, tg.edge_feats if edge_feat else None)
    l_t = PNANetSuperpixels.loss(out_t, tl, tg.graph_mask)
    l_t.backward()
    assert out_t.shape == (tg.n_graph_pad, 10)
    np.testing.assert_allclose(out_t.detach().numpy()[:-1],
                               np.asarray(out_j)[:-1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-4)
    want = from_jax(_np(g_j))
    got = dict(tnet.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_loss_masks_fillers():
    logits = torch.randn(5, 10, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 2, 3, 4, 0])
    mask = torch.tensor([True, True, True, False, False])
    want = torch.nn.functional.cross_entropy(logits[:3], labels[:3])
    torch.testing.assert_close(PNANetSuperpixels.loss(logits, labels, mask),
                               want)


def test_main_superpixels_cpu(capsys):
    best = main_superpixels.main([
        '--synthetic', '--epochs', '2', '--batch_size', '64',
        '--hidden_dim', '16', '--out_dim', '16', '--L', '2', '--towers', '2',
        '--dropout', '0.1'], device='cpu')
    out = capsys.readouterr().out
    assert '[data] using synthetic superpixel dataset' in out
    assert 'Best val acc' in out
    assert 0.0 <= best['test_metric'] <= 1.0
