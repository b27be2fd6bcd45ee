"""The PyG MolHIV example trainer.

Counterpart of ``pna_tpu/cli/pyg_example.py`` (the reference's self-contained
OGB script), with its own loop: a 10-bin in-degree histogram of the train
split gives ``avg_deg``; ``PNANetPyGExample`` (hidden 80, 4 layers, dropout
0.3); batches of ``collate_records(..., with_snorm=False)``, the last one
short, with no filler graphs; ``torch.optim.AdamW`` with weight decay 3e-6
(decoupled, the JAX ``optax.adamw``, unlike the HIV CLI's L2 Adam); the
plateau schedule (factor 0.5, patience 20, min_lr 1e-4) stepped on
1 - validation ROC-AUC; per-epoch validation and test ROC-AUC, and the best
epoch by validation ROC-AUC.  Every epoch runs (no early stop).  The JSONL
log adds to the JAX keys the host seconds of the epoch (``epoch_s``), of its
training pass (``train_s``), of batch collation and of the per-step loss
read inside that pass (``collate_s``, ``sync_s``: the sums of the spans
``pna.collate`` and ``pna.loss_read``, ``utils/profiling.py::span``), and
its steps (``train_steps``).

    python -m pna_tpu_torch.cli.pyg_example --synthetic

runs on the card; ``main(argv, device='cpu')`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pna_tpu_torch.data.hiv import HIVDataset
from pna_tpu_torch.data.molecules import collate_records
from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.nn.pyg import PNANetPyGExample
from pna_tpu_torch.ops.scalers import avg_d_from_degree_hist
from pna_tpu_torch.train.metrics import roc_auc
from pna_tpu_torch.utils.logging import MetricsLogger
from pna_tpu_torch.utils.profiling import span, span_seconds

# split sizes of the synthetic dataset (--synthetic, or no OGB directory)
SYNTHETIC = dict(n_train=1000, n_val=200, n_test=200)
WEIGHT_DECAY = 3e-6


def degree_histogram(records, bins: int = 10) -> np.ndarray:
    """In-degree histogram over the records' nodes, degrees >= ``bins``
    dropped."""
    hist = np.zeros(bins, np.int64)
    for rec in records:
        n = rec['node_feats'].shape[0]
        h = np.bincount(np.bincount(rec['receivers'], minlength=n),
                        minlength=bins)
        hist += h[:bins]
    return hist


def batches(records, batch_size: int, shuffle_rng=None):
    """(graph, float labels) on the CPU, in the order of ``shuffle_rng``
    when given; the last batch is short."""
    idx = np.arange(len(records))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(idx)
    for i in range(0, len(idx), batch_size):
        graph, labels = collate_records(
            [records[j] for j in idx[i:i + batch_size]], with_snorm=False)
        yield graph, labels.to(torch.float32)


def main(argv=None, *, device: DeviceLike = None):
    """Train as the flags say; returns (best val ROC-AUC, its test ROC-AUC,
    its epoch).  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', default='data/ogbg_molhiv')
    p.add_argument('--synthetic', action='store_true', default=False)
    p.add_argument('--epochs', type=int, default=200)
    p.add_argument('--batch_size', type=int, default=128)
    p.add_argument('--lr', type=float, default=0.01)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--metrics_path', default=None)
    args = p.parse_args(argv)

    if args.synthetic or not os.path.isdir(args.data_dir):
        print('[data] using synthetic MolHIV-like dataset')
        ds = HIVDataset.synthetic(**SYNTHETIC, seed=args.seed)
    else:
        ds = HIVDataset.from_ogb_dir(args.data_dir)

    model = PNANetPyGExample(
        avg_deg=avg_d_from_degree_hist(degree_histogram(ds.train)),
        device=device, seed=args.seed)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode='min', factor=0.5, patience=20, min_lr=1e-4,
        threshold=1e-4, threshold_mode='rel', cooldown=0)

    def evaluate(records):
        model.eval()
        preds, labels = [], []
        with torch.no_grad():
            for graph, y in batches(records, args.batch_size):
                g = graph.to(device)
                out = model(g, g.node_feats)
                preds.append(out[:, 0].cpu()[graph.graph_mask])
                labels.append(y[graph.graph_mask])
        return float(roc_auc(torch.cat(preds).numpy(),
                             torch.cat(labels).numpy()))

    logger = MetricsLogger(args.metrics_path) if args.metrics_path else None
    shuffle_rng = np.random.RandomState(args.seed)
    best = (0.0, 0.0, 0)
    for epoch in range(1, args.epochs + 1):
        model.train()
        losses = []
        t_epoch, since = time.perf_counter(), span_seconds()
        it = batches(ds.train, args.batch_size, shuffle_rng)
        while True:
            with span('pna.collate'):
                item = next(it, None)
            if item is None:
                break
            graph, y = item
            g = graph.to(device)
            opt.zero_grad(set_to_none=True)
            loss = PNANetPyGExample.loss(model(g, g.node_feats),
                                         y.to(device), g.graph_mask)
            loss.backward()
            opt.step()
            with span('pna.loss_read'):
                losses.append(float(loss.detach()))     # waits for the device
        train_s = time.perf_counter() - t_epoch
        spent = span_seconds(since)
        val_roc = evaluate(ds.val)
        test_roc = evaluate(ds.test)
        sched.step(1.0 - val_roc)
        train_loss = float(np.mean(losses))
        print(f'Epoch: {epoch:02d}, Loss: {train_loss:.4f}, '
              f'Val: {val_roc:.4f}, Test: {test_roc:.4f}')
        if logger:
            logger.log(epoch, train_loss=train_loss, val_roc=val_roc,
                       test_roc=test_roc,
                       lr=float(opt.param_groups[0]['lr']),
                       epoch_s=time.perf_counter() - t_epoch,
                       train_s=train_s,
                       collate_s=spent.get('pna.collate', 0.0),
                       sync_s=spent.get('pna.loss_read', 0.0),
                       train_steps=len(losses))
        if val_roc > best[0]:
            best = (val_roc, test_roc, epoch)
    print(f'Best epoch val: {best[0]:.4f}, test: {best[1]:.4f}')
    if logger:
        logger.close()
    return best


if __name__ == '__main__':
    main()
