"""The MolHIV slice of the port against pna_tpu on the CPU: the synthetic
records and the OGB reader, PNANetHIV and PNANetPyGExample (loss and every
gradient, on a batch with an isolated atom), the HIV trainer's history
against the JAX trainer's, the HIV and PyG example CLIs end to end, the
three real-world CLIs' --seed, and the CIFAR10 superpixel config's first
training steps against the JAX trainer's.

Tolerances: records equal; loss rtol 1e-5; gradients within 1e-4 of the
model's largest gradient entry (float32 sums in other orders: the JAX
batches take the ELL path, the port's the CSR bank); trainer histories and
the CIFAR10 steps within rtol 2e-4, as tests/test_torch_pipeline.py holds
the ZINC trainer (other summation orders through Adam steps)."""

import csv
import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.data import hiv as jhiv
from pna_tpu.data import molecules as jmol
from pna_tpu.data import superpixels as jsp
from pna_tpu.nn.nets import PNANetHIV as JHIV
from pna_tpu.nn.nets import PNANetSuperpixels as JSuperpixels
from pna_tpu.nn.pyg import PNANetPyGExample as JPyG
from pna_tpu.train import realworld as jrw
from pna_tpu_torch.cli import (main_HIV, main_molecules, main_superpixels,
                               pyg_example)
from pna_tpu_torch.data import hiv as thiv
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.data import superpixels as tsp
from pna_tpu_torch.nn.nets import PNANetHIV
from pna_tpu_torch.nn.pyg import PNANetPyGExample
from pna_tpu_torch.train import realworld as trw
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The trainer's many small ops run on one thread: beside other test
    workers, torch's thread pool would wait on threads the system has put
    to sleep."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_synthetic_records_match_jax():
    a = thiv.HIVDataset.synthetic(n_train=20, n_val=5, n_test=5, seed=3)
    b = jhiv.HIVDataset.synthetic(n_train=20, n_val=5, n_test=5, seed=3)
    for split in ('train', 'val', 'test'):
        ra, rb = getattr(a, split), getattr(b, split)
        assert len(ra) == len(rb) > 0
        for r, s in zip(ra, rb):
            assert r.keys() == s.keys() and r['label'] == s['label']
            for k in ('node_feats', 'senders', 'receivers'):
                np.testing.assert_array_equal(r[k], s[k])
                assert r[k].dtype == s[k].dtype
    assert a.avg_d() == b.avg_d()
    assert a.train[0]['node_feats'].shape[1] == 9


def _write_csv_gz(path, rows):
    with gzip.open(path, 'wt', newline='') as f:
        csv.writer(f).writerows(rows)


def test_ogb_reader_matches_jax(tmp_path):
    """An ogbg-molhiv directory written here: five molecules (one of 4
    atoms, which the dataset drops), scaffold splits of indices."""
    rng = np.random.RandomState(0)
    sizes = [7, 4, 9, 6, 8]
    edges, feats, n_edges = [], [], []
    for n in sizes:
        e = []
        for v in range(1, n):
            u = rng.randint(0, v)
            e += [(u, v), (v, u)]
        edges += e
        n_edges.append(len(e))
        feats += [[rng.randint(0, d) for d in (119, 4, 12, 12, 10, 6, 6, 2,
                                               2)] for _ in range(n)]
    raw = tmp_path / 'raw'
    split = tmp_path / 'split' / 'scaffold'
    raw.mkdir()
    split.mkdir(parents=True)
    _write_csv_gz(raw / 'edge.csv.gz', edges)
    _write_csv_gz(raw / 'node-feat.csv.gz', feats)
    _write_csv_gz(raw / 'num-node-list.csv.gz', [[n] for n in sizes])
    _write_csv_gz(raw / 'num-edge-list.csv.gz', [[e] for e in n_edges])
    _write_csv_gz(raw / 'graph-label.csv.gz', [[0], [1], [1], [0], [1]])
    for name, idx in (('train', [2, 1, 0]), ('valid', [3]), ('test', [4])):
        _write_csv_gz(split / f'{name}.csv.gz', [[i] for i in idx])
    got = thiv.HIVDataset.from_ogb_dir(str(tmp_path))
    want = jhiv.HIVDataset.from_ogb_dir(str(tmp_path))
    assert [len(got.train), len(got.val), len(got.test)] == [2, 1, 1]
    for name in ('train', 'val', 'test'):
        for r, s in zip(getattr(got, name), getattr(want, name)):
            assert r['label'] == s['label']
            for k in ('node_feats', 'senders', 'receivers'):
                np.testing.assert_array_equal(r[k], s[k])
    assert got.train[0]['node_feats'].shape == (9, 9)
    assert got.avg_d() == want.avg_d()


def _hiv_batch(n=24, seed=0):
    """Synthetic MolHIV records, the first with an isolated atom (a salt),
    collated by both packages."""
    recs = thiv.synthetic_molhiv(n, seed=seed)
    r = dict(recs[0])
    r['node_feats'] = np.concatenate([r['node_feats'], r['node_feats'][:1]])
    recs[0] = r
    tg, tl = tmol.collate_records(recs)
    jg, jl = jmol.collate_records(recs)
    assert int(tg.in_degrees()[tg.node_mask].min()) == 0
    return recs, tg, tl, jg, jl


def _grad_close(net, grads_jax):
    want = {k: v.numpy() for k, v in from_jax(_np(grads_jax)).items()}
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-4 * scale, f"{k}: {err} of {scale}"


def _compare_net(jnet, tnet_fn, jg, jl, tg, tl, jloss, tloss):
    args = (jg, jg.node_feats)
    var = _np(jax.jit(lambda a: jnet.init({'params': jax.random.PRNGKey(0)},
                                          *a, train=False))(args))

    def lf(p):
        out, _ = jnet.apply(dict(var, params=p), *args, train=True,
                            mutable=['batch_stats'])
        return jloss(out, jnp.asarray(jl), jg.graph_mask), out

    (l_j, out_j), g_j = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        var['params'])
    net = tnet_fn()
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    net.train()
    out = net(tg, tg.node_feats)
    loss = tloss(out, tl, tg.graph_mask)
    loss.backward()
    assert out.shape == (tg.n_graph_pad, 1)
    np.testing.assert_allclose(out.detach().numpy()[:-1],
                               np.asarray(out_j)[:-1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    _grad_close(net, g_j)
    return net


def test_hiv_net_matches_jax():
    """PNANetHIV (L 2, hidden 16, mean readout, batch-norm, residual,
    dropout 0): logits, masked BCE and every gradient."""
    recs, tg, tl, jg, jl = _hiv_batch()
    avg_d = thiv.HIVDataset(recs, [], []).avg_d()
    kw = dict(hidden_dim=16, out_dim=16, n_layers=2, aggregators=AGGS,
              scalers=SCAL, avg_d=avg_d)
    _compare_net(JHIV(**kw), lambda: PNANetHIV(**kw, device='cpu'),
                 jg, jl, tg, tl, JHIV.loss, PNANetHIV.loss)


def test_pyg_example_net_matches_jax():
    """PNANetPyGExample (hidden 16, 2 layers, dropout 0) on the degree
    histogram's avg_deg: logits, loss and every gradient; the loss against
    optax's sigmoid cross-entropy, as the JAX example computes it."""
    import optax
    recs, tg, tl, jg, jl = _hiv_batch(seed=1)
    avg_deg = pyg_example.avg_d_from_degree_hist(
        pyg_example.degree_histogram(recs))
    kw = dict(avg_deg=avg_deg, hidden=16, n_layers=2, dropout=0.0)

    def jloss(out, y, m):
        bce = optax.sigmoid_binary_cross_entropy(out[:, 0],
                                                 y.astype(jnp.float32))
        m = m.astype(jnp.float32)
        return jnp.sum(bce * m) / jnp.maximum(jnp.sum(m), 1.0)

    _compare_net(JPyG(**kw), lambda: PNANetPyGExample(**kw, device='cpu'),
                 jg, jl, tg, tl, jloss, PNANetPyGExample.loss)


def test_roc_auc_matches_jax_with_ties():
    """The port's numpy ROC-AUC against the JAX package's (sklearn's) on
    scores of five levels, so that many tie; one class alone raises."""
    from pna_tpu.train import metrics as jmetrics
    from pna_tpu_torch.train import metrics as tmetrics
    rng = np.random.RandomState(0)
    for _ in range(20):
        scores = rng.randint(0, 5, 50).astype(np.float32)
        labels = rng.randint(0, 2, 50)
        mask = rng.rand(50) < 0.8
        np.testing.assert_allclose(tmetrics.roc_auc(scores, labels, mask),
                                   jmetrics.roc_auc(scores, labels, mask),
                                   rtol=1e-12)
    with pytest.raises(ValueError):
        tmetrics.roc_auc(scores, np.ones(50))


def test_bce_loss_masks_fillers():
    logits = torch.randn(5, 1, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 0, 1, 1, 0])
    mask = torch.tensor([True, True, True, False, False])
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        logits[:3, 0], labels[:3].float())
    torch.testing.assert_close(PNANetHIV.loss(logits, labels, mask), want)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_trainer_history_matches_jax(batch_norm):
    """RealworldTrainer.fit on PNANetHIV against the JAX trainer on the same
    weights (its per-batch layout, bucket_by_degree=False): 3 epochs of 2
    Adam steps on 64 synthetic graphs, L 2, hidden 16, ROC-AUC, best epoch
    by the largest validation ROC-AUC; every history value within rtol
    2e-4.

    With batch-norm the posttrans bias feeds the norm, so its gradient is 0
    in exact arithmetic and float noise in both packages; Adam turns that
    noise into steps of the full learning rate with either sign, so the two
    biases part, and with them the running means that evaluation reads.
    The training pass normalises by each batch's own statistics, in which
    the bias cancels: there train_loss and lr are held."""
    ds = thiv.HIVDataset.synthetic(n_train=64, n_val=24, n_test=24, seed=2)
    kw = dict(hidden_dim=16, out_dim=16, n_layers=2, aggregators=AGGS,
              scalers=SCAL, avg_d=ds.avg_d(), batch_norm=batch_norm)
    keys = (('train_loss', 'lr') if batch_norm else
            ('train_loss', 'val_loss', 'val_metric', 'test_metric', 'lr'))
    cfg_kw = dict(epochs=3, batch_size=32, init_lr=5e-3,
                  lr_schedule_patience=0, metric='roc_auc')

    def fwd(g):
        return g, g.node_feats

    jtrainer = jrw.RealworldTrainer(
        JHIV(**kw), JHIV.loss, jrw.PipelineConfig(**cfg_kw,
                                                 bucket_by_degree=False),
        forward_args=fwd, metric='roc_auc')
    g0, l0 = next(jmol.batch_iterator(ds.train, 32, 0, shuffle=False))
    start = jtrainer.init_state(g0, jnp.asarray(l0))
    _, _, jhist = jtrainer.fit(ds, log_fn=lambda s: None, select_best='max')

    model = PNANetHIV(**kw, device='cpu')
    model.load_state_dict(from_jax(_np(start['params']),
                                   _np(start['batch_stats'])))
    trainer = trw.RealworldTrainer(model, PNANetHIV.loss,
                                   trw.PipelineConfig(**cfg_kw),
                                   forward_args=fwd, device='cpu')
    _, best, hist = trainer.fit(ds, log_fn=lambda s: None, select_best='max')
    assert len(hist) == len(jhist) == 3
    for h, j in zip(hist, jhist):
        for key in keys:
            np.testing.assert_allclose(h[key], j[key], rtol=2e-4,
                                       err_msg=f"epoch {h['epoch']} {key}")
        assert h['train_steps'] == 2
    assert hist[-1]['train_loss'] < hist[0]['train_loss']
    assert best['val_metric'] == max(h['val_metric'] for h in hist)


def test_main_hiv_cpu(tmp_path, capsys):
    best = main_HIV.main([
        '--synthetic', '--epochs', '2', '--L', '2', '--hidden_dim', '16',
        '--out_dim', '16', '--metrics_path', str(tmp_path / 'm.jsonl')],
        device='cpu')
    out = capsys.readouterr().out
    assert '[data] using synthetic MolHIV-like dataset' in out
    assert 'Best val ROC-AUC' in out
    assert 0.0 <= best['test_metric'] <= 1.0
    lines = [json.loads(x) for x in open(tmp_path / 'm.jsonl')]
    assert [x['train_steps'] for x in lines] == [1000 // 128 + 1] * 2


def test_pyg_example_cpu(tmp_path, capsys):
    """The example's own loop: short last batch (no fillers), AdamW, the
    plateau schedule on 1 - val ROC-AUC, a JSONL record per epoch."""
    val, test, epoch = pyg_example.main([
        '--synthetic', '--epochs', '2', '--batch_size', '256',
        '--metrics_path', str(tmp_path / 'm.jsonl')], device='cpu')
    out = capsys.readouterr().out
    assert 'Epoch: 02' in out and 'Best epoch val' in out
    assert 0.0 <= val <= 1.0 and epoch in (1, 2)
    lines = [json.loads(x) for x in open(tmp_path / 'm.jsonl')]
    assert [x['train_steps'] for x in lines] == [4, 4]
    assert all(0 <= x['collate_s'] <= x['train_s'] for x in lines)
    batches = list(pyg_example.batches(
        thiv.synthetic_molhiv(300, seed=0), 128))
    assert [int(g.graph_mask.sum()) for g, _ in batches] == [128, 128, 44]
    assert all(g.n_graph_pad == int(g.graph_mask.sum()) + 1
               for g, _ in batches)


class _Built(Exception):
    pass


@pytest.mark.parametrize("cli,argv", [
    (main_molecules, ['--L', '2', '--hidden_dim', '10', '--out_dim', '10']),
    (main_superpixels, ['--L', '2', '--hidden_dim', '10', '--out_dim', '10']),
    (main_HIV, ['--L', '2', '--hidden_dim', '8', '--out_dim', '8']),
])
def test_cli_seed_reaches_the_net(cli, argv, monkeypatch):
    """--seed seeds the net's weights and its dropout generator: two seeds
    give different initial weights, one seed twice the same."""
    built = []

    def capture(model, *args, **kwargs):
        built.append(model)
        raise _Built

    monkeypatch.setattr(cli, 'RealworldTrainer', capture)
    for seed in (3, 4, 3):
        with pytest.raises(_Built):
            cli.main(['--synthetic', '--seed', str(seed)] + argv,
                     device='cpu')
    a, b, c = (m.state_dict() for m in built)
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert any(not torch.equal(a[k], b[k]) for k in a)
    assert [m.generator.initial_seed() for m in built] == [3, 4, 3]


def test_cifar10_config_first_steps_match_jax():
    """The CIFAR10 superpixel config (hidden 75, out 70, towers 5, sum
    readout) through main_superpixels.make_model and the trainer against the
    JAX CLI's net and trainer on the same weights: one training pass of two
    Adam steps on 2 x 8 synthetic graphs, then an evaluation.  The two
    steps' mean loss and the evaluation loss within rtol 2e-4."""
    with open(os.path.join(main_superpixels.CONFIG_DIR,
                           'superpixels_graph_classification_pna_'
                           'CIFAR10.json')) as f:
        config = json.load(f)
    params, net = config['params'], config['net_params']
    assert (net['hidden_dim'], net['out_dim'], net['towers'],
            net['readout']) == (75, 70, 5, 'sum')
    ds = tsp.SuperpixelsDataset.synthetic(n_train=16, n_val=1, n_test=1,
                                          seed=params['seed'])
    jds = jsp.SuperpixelsDataset.synthetic(n_train=16, n_val=1, n_test=1,
                                           seed=params['seed'])
    model, fwd = main_superpixels.make_model(net, ds, 'cpu',
                                             seed=params['seed'])
    jnet = JSuperpixels(
        in_dim=3, in_dim_edge=1, hidden_dim=net['hidden_dim'],
        out_dim=net['out_dim'], n_classes=jds.n_classes, n_layers=net['L'],
        aggregators=tuple(net['aggregators'].split()),
        scalers=tuple(net['scalers'].split()), avg_d=jds.avg_d(),
        readout_type=net['readout'], dropout=net['dropout'],
        graph_norm=net['graph_norm'], batch_norm=net['batch_norm'],
        residual=net['residual'], towers=net['towers'],
        divide_input_first=net['divide_input_first'],
        divide_input_last=net['divide_input_last'],
        edge_feat=net['edge_feat'], edge_dim=net['edge_dim'])
    cfg = dict(params, batch_size=8)
    jtrainer = jrw.RealworldTrainer(
        jnet, JSuperpixels.loss,
        jrw.PipelineConfig(seed=cfg['seed'], batch_size=8,
                           init_lr=cfg['init_lr'],
                           weight_decay=cfg['weight_decay'],
                           metric='accuracy', bucket_by_degree=False),
        forward_args=fwd, metric='accuracy')
    g0, l0 = next(jmol.batch_iterator(ds.train, 8, 0, shuffle=False))
    state = jtrainer.init_state(g0, jnp.asarray(l0))
    model.load_state_dict(from_jax(_np(state['params']),
                                   _np(state['batch_stats'])))
    trainer = trw.RealworldTrainer(model, type(model).loss,
                                   main_superpixels.make_config(cfg),
                                   forward_args=fwd, device='cpu')
    got = [trainer.run_epoch(ds.train, True, 5)[0],
           trainer.run_epoch(ds.train, False, 0)[0]]
    want = [jtrainer.run_epoch(state, jds.train, True, 5)[0],
            jtrainer.run_epoch(state, jds.train, False, 0)[0]]
    assert trainer.last_pass['steps'] == 2
    np.testing.assert_allclose(got, want, rtol=2e-4)
