"""The port's trainer on its CSR batches against the JAX trainer on its
default degree-bucketed ones: RealworldTrainer.fit on the same weights, 2
epochs of 2 Adam steps on tests/test_torch_pipeline.py's ZINC
configuration, the nets on ``kernel='auto'`` (the bucketed backend in the
JAX package; on the CPU the generic backend in the port, which has no
bucketed layout).  Every batch of the port's training and evaluation
carries ``edge_ptr``, and every epoch's train_loss, val_metric, test_metric
and lr agree within rtol 2e-4, as the CSR trainer's do (float32 sums in
other orders through Adam steps)."""

import numpy as np

import jax.numpy as jnp

from pna_tpu.data import molecules as jmol
from pna_tpu.nn.nets import PNANetMolecules as JNet
from pna_tpu.train import realworld as jrw
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train import realworld as trw
from pna_tpu_torch.weights import from_jax
from tests.test_torch_pipeline import NET, _fwd, _np, _zinc


def test_bucketed_trainer_history_matches_jax(monkeypatch):
    ds = _zinc()
    avg_d = ds.avg_d()
    cfg_kw = dict(epochs=2, batch_size=32, init_lr=5e-3,
                  lr_schedule_patience=0, metric='mae')
    jtrainer = jrw.RealworldTrainer(
        JNet(num_atom_type=28, num_bond_type=4, avg_d=avg_d, **NET),
        JNet.loss, jrw.PipelineConfig(**cfg_kw), forward_args=_fwd,
        metric='mae')
    caps = jmol.derive_bucket_caps(ds.train + ds.val + ds.test, 32)
    g0, l0 = next(jmol.batch_iterator(ds.train, 32, 0, shuffle=False,
                                      bucket_caps=caps))
    start = jtrainer.init_state(g0, jnp.asarray(l0))
    _, _, jhist = jtrainer.fit(ds, log_fn=lambda s: None)

    model = PNANetMolecules(num_atom_type=28, num_bond_type=4, avg_d=avg_d,
                            kernel='auto', device='cpu', **NET)
    model.load_state_dict(from_jax(_np(start['params']),
                                   _np(start['batch_stats'])))
    trainer = trw.RealworldTrainer(
        model, PNANetMolecules.loss, trw.PipelineConfig(**cfg_kw),
        forward_args=_fwd, device='cpu')
    batches = []
    iterate = tmol.batch_iterator

    def recording(*args, **kw):
        for g, y in iterate(*args, **kw):
            assert g.edge_ptr is not None
            batches.append(g.n_node_pad)
            yield g, y
    monkeypatch.setattr(trw, 'batch_iterator', recording)
    _, best, hist = trainer.fit(ds, log_fn=lambda s: None)
    assert len(batches) == 2 * (2 + 1 + 1)    # train, val, test a epoch
    assert len(hist) == len(jhist) == 2
    for h, j in zip(hist, jhist):
        for key in ('train_loss', 'val_metric', 'test_metric', 'lr'):
            np.testing.assert_allclose(h[key], j[key], rtol=2e-4,
                                       err_msg=f"epoch {h['epoch']} {key}")
        assert h['train_steps'] == 2
    assert hist[-1]['train_loss'] < hist[0]['train_loss']
