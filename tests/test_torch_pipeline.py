"""The port's real-world training pipeline against pna_tpu on the CPU: the
plateau schedule, the metrics, ZINC records and the loaders, batch_iterator,
the checkpoint manager, the metrics logger, the trainer's per-epoch history
against the JAX trainer's, kill-and-resume, and the ZINC CLI.

Tolerances: the schedule's rates and the metrics are equal (the same
float64 numpy or Python arithmetic on both sides; F1 and ROC-AUC to 1e-12);
the records and batches are equal; the trainer's history within rtol 2e-4
(float32 sums in other orders on both sides, through six Adam steps: see
``test_trainer_history_matches_jax``); a resumed run on the CPU repeats the
uninterrupted one exactly."""

import csv
import glob
import json
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.data import molecules as jmol
from pna_tpu.nn.nets import PNANetMolecules as JNet
from pna_tpu.train import metrics as jmetrics
from pna_tpu.train import realworld as jrw
from pna_tpu_torch.cli import main_molecules
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train import metrics as tmetrics
from pna_tpu_torch.train import realworld as trw
from pna_tpu_torch.utils.checkpoint import CheckpointManager
from pna_tpu_torch.utils.logging import MetricsLogger, param_count
from pna_tpu_torch.utils.tb_writer import _masked_crc
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


def test_plateau_schedule_matches_jax():
    """torch's ReduceLROnPlateau as the trainer builds it against the JAX
    class on a scripted validation loss: improvements, a change inside the
    relative threshold (not an improvement), patience running out, and the
    min_lr clamp."""
    cfg = trw.PipelineConfig(init_lr=1e-3, lr_reduce_factor=0.5,
                             lr_schedule_patience=2, min_lr=1e-4)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=cfg.init_lr)
    sched = trw.make_scheduler(opt, cfg)
    ref = jrw.ReduceLROnPlateau(cfg.init_lr, cfg.lr_reduce_factor,
                                cfg.lr_schedule_patience, cfg.min_lr)
    metrics = [1.0, 0.9, 0.8, 0.79995, 0.8, 0.85, 0.7, 0.7, 0.7, 0.7,
               0.69999, 0.7] + [0.75] * 12
    got, want = [], []
    for m in metrics:
        sched.step(m)
        got.append(opt.param_groups[0]['lr'])
        want.append(ref.step(m))
    assert got == want
    assert len(set(got)) >= 4 and got[-1] == cfg.min_lr


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    scores = rng.randn(40, 4)
    labels = rng.randint(0, 4, 40)
    mask = rng.rand(40) < 0.8
    reg = rng.randn(40)
    assert tmetrics.MAE(reg, labels, mask) == jmetrics.MAE(reg, labels, mask)
    for name in ('accuracy', 'accuracy_SBM'):
        assert (getattr(tmetrics, name)(scores, labels, mask)
                == getattr(jmetrics, name)(scores, labels, mask))
    two = rng.randn(40, 2)
    binary = rng.randint(0, 2, 40)
    for name, s, y in (('binary_f1_score', two, binary),
                       ('weighted_f1_score', scores, labels),
                       ('roc_auc', reg, binary)):
        np.testing.assert_allclose(getattr(tmetrics, name)(s, y, mask),
                                   getattr(jmetrics, name)(s, y, mask),
                                   rtol=1e-12)


@pytest.mark.parametrize("case", ["missing_class", "one_label", "masked"])
def test_f1_scores_match_jax_edge_cases(case):
    """The port's numpy F1 scores against the JAX package's (sklearn's
    f1_score): a label never predicted, one label only (F1 of label 1 is
    0 with no positive), a mask that keeps a few rows."""
    rng = np.random.RandomState(1)
    scores = rng.randn(30, 3)
    labels = rng.randint(0, 3, 30)
    mask = np.ones(30, bool)
    if case == "missing_class":
        scores[:, 2] = -10.0
    elif case == "one_label":
        labels[:] = 0
        scores = np.stack([np.ones(30), np.zeros(30)], axis=1)
    else:
        mask[5:] = False
    two = np.stack([scores[:, 0], scores[:, 1]], axis=1)
    binary = labels % 2 if case != "one_label" else labels
    np.testing.assert_allclose(tmetrics.weighted_f1_score(scores, labels,
                                                          mask),
                               jmetrics.weighted_f1_score(scores, labels,
                                                          mask), rtol=1e-12)
    np.testing.assert_allclose(tmetrics.binary_f1_score(two, binary, mask),
                               jmetrics.binary_f1_score(two, binary, mask),
                               rtol=1e-12)


def test_zinc_records_match_jax():
    a = tmol.ZincDataset.synthetic(n_train=20, n_val=5, n_test=5, seed=3)
    b = jmol.ZincDataset.synthetic(n_train=20, n_val=5, n_test=5, seed=3)
    for ta, jb in ((a.train, b.train), (a.val, b.val), (a.test, b.test)):
        for r, s in zip(ta, jb):
            assert r.keys() == s.keys()
            for k in r:
                np.testing.assert_array_equal(r[k], s[k])
    assert a.avg_d() == b.avg_d()


def test_zinc_from_dir_matches_jax(tmp_path):
    """Split pickles of molecule dicts (torch tensors, an int32 atom type,
    labels as floats and 0-d tensors) and index files whose first row
    reorders and subsets: the port reads what the JAX loader reads."""
    rng = np.random.RandomState(0)
    mols = []
    for i in range(6):
        n = rng.randint(6, 12)
        bond = np.zeros((n, n), np.int64)
        for v in range(1, n):
            u = rng.randint(0, v)
            bond[u, v] = bond[v, u] = rng.randint(1, 4)
        label = rng.randn()
        mols.append({'num_atom': n,
                     'atom_type': torch.tensor(rng.randint(0, 28, n),
                                               dtype=torch.int32),
                     'bond_type': torch.tensor(bond),
                     'logP_SA_cycle_normalized':
                         torch.tensor(label) if i % 2 else float(label)})
    for split, take in (('train', [2, 0, 1]), ('val', [3, 4]), ('test', [5])):
        with open(tmp_path / f'{split}.pickle', 'wb') as f:
            pickle.dump(mols, f)
        with open(tmp_path / f'{split}.index', 'w') as f:
            w = csv.writer(f)
            w.writerow(take)
            w.writerow([0])          # only the first row is read
    got = tmol.ZincDataset.from_dir(str(tmp_path))
    want = jmol.ZincDataset.from_dir(str(tmp_path))
    assert [len(got.train), len(got.val), len(got.test)] == [3, 2, 1]
    for split in ('train', 'val', 'test'):
        for r, s in zip(getattr(got, split), getattr(want, split)):
            for k in r:
                np.testing.assert_array_equal(r[k], s[k])
    assert got.train[0]['node_feats'].shape[0] == mols[2]['num_atom']
    with pytest.raises(ValueError, match="expected 4"):
        tmol.load_zinc_split(str(tmp_path), 'train', num_graphs=4)


def _edge_multisets(senders, receivers, feats, edge_mask):
    out = {}
    for s, r, f, m in zip(senders, receivers, feats, edge_mask):
        if m:
            out.setdefault(int(r), []).append((int(s), int(f)))
    return {r: sorted(v) for r, v in out.items()}


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_matches_jax(shuffle):
    """The same order, padded sizes, labels, graph_mask (fillers False) and
    edge multiset per receiver; the port's batches are CSR-sorted."""
    recs = tmol.synthetic_zinc(45, seed=5)
    got = list(tmol.batch_iterator(recs, 16, seed=7, shuffle=shuffle))
    want = list(jmol.batch_iterator(recs, 16, seed=7, shuffle=shuffle))
    assert len(got) == len(want) == 3
    for (tg, tl), (jg, jl) in zip(got, want):
        assert tg.n_node_pad == jg.node_feats.shape[0]
        assert tg.n_node_pad % 64 == 0 and tg.n_edge_pad % 256 == 0
        assert tg.n_edge_pad == jg.senders.shape[0]
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(tg.graph_mask.numpy(),
                                      np.asarray(jg.graph_mask))
        np.testing.assert_array_equal(tg.node_feats.numpy(),
                                      np.asarray(jg.node_feats))
        np.testing.assert_array_equal(tg.node_mask.numpy(),
                                      np.asarray(jg.node_mask))
        np.testing.assert_array_equal(tg.snorm_n.numpy(),
                                      np.asarray(jg.snorm_n))
        assert _edge_multisets(tg.senders.numpy(), tg.receivers.numpy(),
                               tg.edge_feats.numpy()[:, 0],
                               tg.edge_mask.numpy()) == _edge_multisets(
            np.asarray(jg.senders), np.asarray(jg.receivers),
            np.asarray(jg.edge_feats)[:, 0], np.asarray(jg.edge_mask))
        r = tg.receivers.numpy()
        assert np.all(np.diff(r) >= 0)
    assert int(got[-1][0].graph_mask.sum()) == 45 - 32


def test_checkpoint_manager_rotation(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_best=2, mode='min')
    for epoch, metric in enumerate([0.5, 0.3, 0.4, 0.6, 0.1]):
        m.save_best({'w': torch.full((2,), float(epoch))}, metric=metric,
                    epoch=epoch)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / 'best_*.ckpt')))
    assert names == ['best_1.ckpt', 'best_4.ckpt']
    state, meta = m.restore_best()
    assert meta['epoch'] == 4 and float(state['w'][0]) == 4.0
    m.save_latest({'w': torch.ones(1)}, epoch=4, best_val=0.1)
    # a new manager on the same directory (a resume) seeds from the files
    # and rotates them: best_12 is better than best_5 by its metric, though
    # it sorts first by name
    m2 = CheckpointManager(str(tmp_path), keep_best=2, mode='min')
    assert sorted(x[0] for x in m2.best) == [0.1, 0.3]
    m2.save_best({'w': torch.zeros(1)}, metric=0.05, epoch=12)
    assert not os.path.exists(tmp_path / 'best_1.ckpt')
    assert m2.restore_best()[1]['epoch'] == 12
    assert m2.restore_latest()[1] == dict(epoch=4, best_val=0.1)
    hi = CheckpointManager(str(tmp_path / 'max'), mode='max')
    for epoch, metric in ((5, 0.9), (12, 0.7)):
        hi.save_best({'w': torch.zeros(1)}, metric=metric, epoch=epoch)
    assert CheckpointManager(str(tmp_path / 'max'),
                             mode='max').restore_best()[1]['epoch'] == 5
    assert not os.path.exists(tmp_path / 'max' / 'best_12.ckpt')


def _read_events(path):
    """(step, tag, value) of every scalar of a TensorBoard event file, read
    with a minimal TFRecord and protobuf decoder (not the writer's code)."""
    def varint(buf, off):
        v = shift = 0
        while True:
            b = buf[off]
            off += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v, off

    def fields(buf):
        off, out = 0, []
        while off < len(buf):
            key, off = varint(buf, off)
            wire = key & 7
            if wire == 0:
                v, off = varint(buf, off)
            elif wire == 1:
                v = struct.unpack_from('<d', buf, off)[0]
                off += 8
            elif wire == 5:
                v = struct.unpack_from('<f', buf, off)[0]
                off += 4
            else:
                n, off = varint(buf, off)
                v, off = buf[off:off + n], off + n
            out.append((key >> 3, v))
        return out

    data, off, out = open(path, 'rb').read(), 0, []
    while off < len(data):
        (n,) = struct.unpack_from('<Q', data, off)
        assert struct.unpack_from('<I', data, off + 8)[0] == _masked_crc(
            data[off:off + 8])
        payload = data[off + 12:off + 12 + n]
        assert struct.unpack_from('<I', data, off + 12 + n)[0] == \
            _masked_crc(payload)
        off += n + 16
        ev = dict(fields(payload))
        if 5 in ev:
            for _, value in fields(ev[5]):
                v = dict(fields(value))
                out.append((ev[2], v[1].decode(), v[2]))
    return out


def test_metrics_logger_jsonl_and_tensorboard(tmp_path):
    log = MetricsLogger(str(tmp_path / 'm.jsonl'),
                        tensorboard_dir=str(tmp_path / 'tb'))
    log.log(0, train_loss=0.5, lr=1e-3, note='text')
    log.log(1, train_loss=0.25, lr=5e-4)
    log.close()
    lines = [json.loads(x) for x in open(tmp_path / 'm.jsonl')]
    assert [(x['step'], x['train_loss']) for x in lines] == [(0, 0.5),
                                                             (1, 0.25)]
    assert lines[0]['note'] == 'text'
    (path,) = glob.glob(str(tmp_path / 'tb' / 'events.out.tfevents.*'))
    got = _read_events(path)
    assert [(s, t) for s, t, _ in got] == [(0, 'train_loss'), (0, 'lr'),
                                           (1, 'train_loss'), (1, 'lr')]
    np.testing.assert_allclose([v for _, _, v in got],
                               [0.5, 1e-3, 0.25, 5e-4], rtol=1e-7)


NET = dict(hidden_dim=16, out_dim=16, n_layers=2, aggregators=AGGS,
           scalers=SCAL, readout_type='sum', towers=2,
           divide_input_first=False, divide_input_last=True, graph_norm=True,
           batch_norm=True, residual=True, edge_feat=True, edge_dim=8)


def _zinc():
    return tmol.ZincDataset.synthetic(n_train=64, n_val=16, n_test=16,
                                      seed=0)


def _fwd(g):
    return g, g.node_feats.squeeze(-1), g.edge_feats.squeeze(-1)


def test_trainer_history_matches_jax():
    """RealworldTrainer.fit against the JAX trainer on the same weights:
    3 epochs of 2 Adam steps (lr 5e-3, weight decay 3e-6) on 64 synthetic
    ZINC graphs, L 2, hidden 16, edge features.  The JAX trainer runs its
    default degree-bucketed layout (one compiled shape; its loss and metric
    are over real graphs only), the port its CSR batches.  Every epoch's
    train_loss, val_metric, test_metric and lr agree within rtol 2e-4: both
    sides sum in float32 in other orders (bucketed reductions against the
    CSR bank, two batch layouts), and Adam turns a tiny gradient of either
    sign into a step of up to lr."""
    ds = _zinc()
    avg_d = ds.avg_d()
    cfg_kw = dict(epochs=3, batch_size=32, init_lr=5e-3,
                  lr_schedule_patience=0, metric='mae')
    jcfg = jrw.PipelineConfig(**cfg_kw)
    jnet = JNet(num_atom_type=28, num_bond_type=4, avg_d=avg_d, **NET)
    jtrainer = jrw.RealworldTrainer(jnet, JNet.loss, jcfg,
                                    forward_args=_fwd, metric='mae')
    # the weights fit() starts from: init_state on the first bucketed batch
    caps = jmol.derive_bucket_caps(ds.train + ds.val + ds.test, 32)
    g0, l0 = next(jmol.batch_iterator(ds.train, 32, 0, shuffle=False,
                                      bucket_caps=caps))
    start = jtrainer.init_state(g0, jnp.asarray(l0))
    _, _, jhist = jtrainer.fit(ds, log_fn=lambda s: None)

    model = PNANetMolecules(num_atom_type=28, num_bond_type=4, avg_d=avg_d,
                            device='cpu', **NET)
    model.load_state_dict(from_jax(_np(start['params']),
                                   _np(start['batch_stats'])))
    trainer = trw.RealworldTrainer(model, PNANetMolecules.loss,
                                   trw.PipelineConfig(**cfg_kw),
                                   forward_args=_fwd, device='cpu')
    _, best, hist = trainer.fit(ds, log_fn=lambda s: None)
    assert len(hist) == len(jhist) == 3
    for h, j in zip(hist, jhist):
        for key in ('train_loss', 'val_metric', 'test_metric', 'lr'):
            np.testing.assert_allclose(h[key], j[key], rtol=2e-4,
                                       err_msg=f"epoch {h['epoch']} {key}")
        assert h['train_steps'] == 2 and 0 <= h['collate_s'] <= h['train_s']
    assert hist[-1]['train_loss'] < hist[0]['train_loss']
    assert best['val_metric'] == min(h['val_metric'] for h in hist)


def _trainer(ck_dir, resume, epochs, dropout=0.1):
    ds = _zinc()
    model = PNANetMolecules(num_atom_type=28, num_bond_type=4,
                            avg_d=ds.avg_d(), dropout=dropout,
                            in_feat_dropout=dropout, device='cpu', seed=1,
                            **NET)
    # lr 5e-2: the validation loss rises in epoch 2, so the schedule (its
    # best loss restored from the checkpoint) cuts the rate after it
    cfg = trw.PipelineConfig(epochs=epochs, batch_size=32, init_lr=5e-2,
                             lr_schedule_patience=0, metric='mae',
                             checkpoint_dir=str(ck_dir), resume=resume)
    return trw.RealworldTrainer(model, PNANetMolecules.loss, cfg,
                                forward_args=_fwd, device='cpu'), ds


def test_kill_and_resume_is_exact(tmp_path):
    """Two epochs, then a fresh trainer resumes from latest.ckpt to four:
    the same history as four straight epochs, bit for bit (the dropout
    generator's state, the optimizer's moments and the schedule are in the
    checkpoint); the best epoch's record survives the resume."""
    full, ds = _trainer(tmp_path / 'full', False, 4)
    _, best_full, hist_full = full.fit(ds, log_fn=lambda s: None)
    first, ds = _trainer(tmp_path / 'ab', False, 2)
    first.fit(ds, log_fn=lambda s: None)
    logs = []
    resumed, ds = _trainer(tmp_path / 'ab', True, 4)
    model, best, hist = resumed.fit(ds, log_fn=logs.append)
    assert logs[0].startswith("Resumed from epoch 1")
    assert [h['epoch'] for h in hist] == [2, 3]
    keys = ('train_loss', 'val_loss', 'val_metric', 'test_metric', 'lr')
    for h in hist:
        ref = hist_full[h['epoch']]
        assert [h[k] for k in keys] == [ref[k] for k in keys], h['epoch']
    assert best['epoch'] == best_full['epoch']
    assert best['val_metric'] == best_full['val_metric']
    for k, v in full.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert [h['lr'] for h in hist] == [5e-2, 2.5e-2]


def test_trainer_needs_its_device_and_no_bucketing():
    ds = _zinc()
    model = PNANetMolecules(num_atom_type=28, num_bond_type=4,
                            avg_d=ds.avg_d(), device='cpu', **NET)
    assert param_count(model) == sum(p.numel() for p in model.parameters())
    # the JAX trainer's degree-bucketed batches are not ported
    with pytest.raises(TypeError, match="bucket_by_degree"):
        trw.PipelineConfig(bucket_by_degree=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trw.RealworldTrainer(model, PNANetMolecules.loss,
                                 trw.PipelineConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            main_molecules.main(['--synthetic', '--epochs', '1'])


def test_main_molecules_cpu(tmp_path, capsys):
    """The ZINC CLI end to end on the CPU at a small width, with its
    checkpoint, JSONL and TensorBoard outputs."""
    best = main_molecules.main([
        '--synthetic', '--epochs', '2', '--batch_size', '64',
        '--hidden_dim', '20', '--out_dim', '20', '--L', '2', '--towers', '2',
        '--gru', 'True', '--edge_feat', 'true', '--edge_dim', '4',
        '--checkpoint_dir', str(tmp_path / 'ck'),
        '--metrics_path', str(tmp_path / 'm.jsonl'),
        '--tensorboard_dir', str(tmp_path / 'tb')], device='cpu')
    out = capsys.readouterr().out
    assert '[data] using synthetic ZINC-like dataset' in out
    assert 'Best val MAE' in out and np.isfinite(best['test_metric'])
    lines = [json.loads(x) for x in open(tmp_path / 'm.jsonl')]
    assert [x['epoch'] for x in lines] == [0, 1]
    assert lines[0]['train_steps'] == 1000 // 64 + 1
    assert os.path.exists(tmp_path / 'ck' / 'latest.ckpt')
    assert glob.glob(str(tmp_path / 'tb' / 'events.out.tfevents.*'))
