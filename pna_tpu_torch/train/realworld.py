"""The real-world training pipeline: per-epoch batching, Adam with weight
decay, a plateau learning-rate schedule, min-LR and max-time stops, best-epoch
selection, checkpoint and resume, JSONL and TensorBoard logs.

Counterpart of ``pna_tpu/train/realworld.py``, in the JAX order of events:

* ``make_optimizer``: ``torch.optim.Adam(weight_decay=wd)`` adds ``wd * p``
  to the gradient before the moments, which is the JAX package's
  ``optax.chain(add_decayed_weights(wd), adam(lr))`` (L2, not AdamW);
* the schedule is ``torch.optim.lr_scheduler.ReduceLROnPlateau`` in mode
  'min' with torch's defaults (relative threshold 1e-4, no cooldown), of
  which the JAX package's own class is a copy; it writes the new rate into
  every parameter group;
* ``RealworldTrainer.run_epoch`` trains in ``model.train()`` and evaluates
  under ``model.eval()`` and ``torch.no_grad()`` (so the CSR bank's forward
  kernel runs without tie counts); ``float(loss)`` after each step reads the
  loss to the host, as the JAX trainer does;
* ``fit`` resumes from ``latest.ckpt`` (model, optimizer, scheduler, dropout
  generator, epoch, best validation metric), keeps the best epoch, and stops
  at the minimum rate or after ``max_time`` hours.

The trainer uses the model's weights as it is given them and initialises
nothing.  It runs on the device its model lives on, which must be
``device`` (default ``cuda``; the CPU only when the caller passes
``device='cpu'``).  Batches are collated on the CPU and moved to the device
once each; each epoch's history record adds, to the JAX keys, host seconds:
of the whole epoch with its evaluation (``epoch_s``), of its training pass
(``train_s``), and inside that pass the sums of the program's spans
(``utils/profiling.py::span``) of batch collation (``collate_s``), the
host-to-device copy (``h2d_s``), the forward with the loss (``forward_s``),
the backward (``backward_s``), Adam's step (``optimizer_s``) and the wait
for each step's loss (``sync_s``), and the pass's number of steps
(``train_steps``).

Every batch is receiver-sorted CSR (``data/molecules.py::batch_iterator``).
The JAX trainer's degree-bucketed batches, its default from measurements on
a TPU, are not ported: on the H100 the bucketed step took longer than the
``csr`` one (PERF.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from pna_tpu_torch.data.molecules import batch_iterator
from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.train import metrics as M
from pna_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint
from pna_tpu_torch.utils.logging import MetricsLogger, param_count
from pna_tpu_torch.utils.profiling import span, span_seconds

# ``last_pass`` and history keys: the host seconds of these spans in a pass
PASS_SPANS = dict(collate_s='pna.collate', h2d_s='pna.h2d',
                  forward_s='pna.forward', backward_s='pna.backward',
                  optimizer_s='pna.optimizer', sync_s='pna.loss_read')


@dataclass
class PipelineConfig:
    """The params section of the reference JSON configs."""
    seed: int = 41
    epochs: int = 1000
    batch_size: int = 128
    init_lr: float = 1e-3
    lr_reduce_factor: float = 0.5
    lr_schedule_patience: int = 10
    min_lr: float = 1e-5
    weight_decay: float = 3e-6
    max_time: float = 48.0  # hours
    in_feat_dropout: float = 0.0
    checkpoint_path: Optional[str] = None   # the best epoch's model, saved
    metric: str = 'mae'  # 'mae' | 'accuracy' | 'roc_auc'
    metrics_path: Optional[str] = None      # JSONL per-epoch metrics
    tensorboard_dir: Optional[str] = None   # TensorBoard scalar events
    # a CheckpointManager directory: 'latest' every epoch and the best one;
    # resume=True restores 'latest' and continues the run
    checkpoint_dir: Optional[str] = None
    resume: bool = False


def make_optimizer(model: torch.nn.Module,
                   cfg: PipelineConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.init_lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def make_scheduler(optimizer: torch.optim.Optimizer, cfg: PipelineConfig
                   ) -> torch.optim.lr_scheduler.ReduceLROnPlateau:
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, mode='min', factor=cfg.lr_reduce_factor,
        patience=cfg.lr_schedule_patience, min_lr=cfg.min_lr,
        threshold=1e-4, threshold_mode='rel', cooldown=0)


def _lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]['lr'])


class RealworldTrainer:
    """Trainer of the PNANet* models on batched CSR graphs.

    ``forward_args(graph)`` adapts the model's call to the benchmark:
    molecules pass (graph, atom types, bond types or None), superpixels
    (graph, node features, edge features or None).  ``loss_fn(out, labels,
    graph_mask)`` is the net's masked loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 cfg: PipelineConfig,
                 forward_args: Optional[Callable[[Any], tuple]] = None,
                 metric: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"model on {where}, trainer on {self.device}")
        self.model = model
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.metric = metric or cfg.metric
        self.forward_args = forward_args or (
            lambda graph: (graph, graph.node_feats.squeeze(-1)))
        self.optimizer = make_optimizer(model, cfg)
        self.scheduler = make_scheduler(self.optimizer, cfg)
        # host seconds (PASS_SPANS) and steps of the last run_epoch
        self.last_pass: dict = {}

    # -- epochs -----------------------------------------------------------
    def _epoch_metric(self, outs, labels, masks) -> float:
        o = torch.cat([x.reshape(len(m), -1) for x, m in zip(outs, masks)]
                      ).cpu().numpy()
        lab = np.concatenate([x.numpy().reshape(-1) for x in labels])
        mask = np.concatenate([m.numpy().reshape(-1) for m in masks])
        if self.metric == 'accuracy':
            return M.accuracy(o, lab, mask) / max(mask.sum(), 1)
        if self.metric == 'mae':
            return M.MAE(o[:, 0], lab, mask)
        if self.metric == 'roc_auc':
            return M.roc_auc(o[:, 0], lab, mask)
        raise ValueError(self.metric)

    def run_epoch(self, records: List[dict], train: bool, seed: int,
                  batch_size: Optional[int] = None):
        """One pass over ``records`` (shuffled by ``seed`` when training);
        returns (mean batch loss, epoch metric)."""
        batch_size = batch_size or self.cfg.batch_size
        model, opt, dev = self.model, self.optimizer, self.device
        model.train(train)
        losses, outs, labels_all, masks = [], [], [], []
        t_start, since = time.perf_counter(), span_seconds()
        batches = batch_iterator(records, batch_size, seed, shuffle=train)
        while True:
            with span('pna.collate'):
                item = next(batches, None)
            if item is None:
                break
            graph, labels = item
            with span('pna.h2d'):
                g, y = graph.to(dev), labels.to(dev)
            if train:
                opt.zero_grad(set_to_none=True)
                with span('pna.forward', dev):
                    out = model(*self.forward_args(g))
                    loss = self.loss_fn(out, y, g.graph_mask)
                with span('pna.backward', dev):
                    loss.backward()
                with span('pna.optimizer', dev):
                    opt.step()
            else:
                with torch.no_grad(), span('pna.forward', dev):
                    out = model(*self.forward_args(g))
                    loss = self.loss_fn(out, y, g.graph_mask)
            with span('pna.loss_read'):
                losses.append(float(loss.detach()))     # waits for the device
            outs.append(out.detach())
            labels_all.append(labels)
            masks.append(graph.graph_mask)
        spent = span_seconds(since)
        self.last_pass = dict(seconds=time.perf_counter() - t_start,
                              steps=len(losses), **{
                                  key: spent.get(name, 0.0)
                                  for key, name in PASS_SPANS.items()})
        with span('pna.epoch_metric'):
            metric = self._epoch_metric(outs, labels_all, masks)
        return float(np.mean(losses)), metric

    # -- checkpoints ------------------------------------------------------
    def _model_state(self):
        return {k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()}

    def _generator(self) -> Optional[torch.Generator]:
        return getattr(self.model, 'generator', None)

    def _latest_state(self):
        state = dict(model=self.model.state_dict(),
                     optimizer=self.optimizer.state_dict())
        if self._generator() is not None:
            state['generator'] = self._generator().get_state()
        return state

    def _restore(self, ck, meta):
        self.model.load_state_dict(ck['model'])
        self.optimizer.load_state_dict(ck['optimizer'])
        self.scheduler.load_state_dict(meta['scheduler'])
        if 'generator' in ck:
            self._generator().set_state(ck['generator'])

    # -- full pipeline ----------------------------------------------------
    def fit(self, dataset, log_fn: Callable[[str], None] = print,
            epochs: Optional[int] = None, select_best: str = 'min'):
        """Epoch loop with the plateau schedule, min-LR and max-time stops;
        tracks the epoch with the best validation metric and reports its
        test metric.  Returns (model, best, history)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        print("MODEL/Total parameters:", param_count(self.model))
        logger = None
        if cfg.metrics_path or cfg.tensorboard_dir:
            logger = MetricsLogger(cfg.metrics_path,
                                   tensorboard_dir=cfg.tensorboard_dir)
        history = []
        best_val = float('inf') if select_best == 'min' else -float('inf')
        best = None
        start_epoch = 0
        manager = None
        if cfg.checkpoint_dir:
            manager = CheckpointManager(cfg.checkpoint_dir, mode=select_best)
            if cfg.resume:
                ck, meta = manager.restore_latest()
                if ck is not None:
                    self._restore(ck, meta)
                    best_val = meta['best_val']
                    start_epoch = meta['epoch'] + 1
                    b, bmeta = manager.restore_best()
                    if b is not None:
                        best = dict(epoch=bmeta['epoch'],
                                    val_metric=bmeta['metric'],
                                    test_metric=bmeta.get('test_metric'),
                                    model=b['model'])
                    log_fn(f"Resumed from epoch {meta['epoch']} "
                           f"(lr {_lr(self.optimizer):.2e}, best_val "
                           f"{best_val:.4f})")
        t0 = time.time()
        for epoch in range(start_epoch, epochs):
            lr, t_epoch = _lr(self.optimizer), time.perf_counter()
            tl, tm = self.run_epoch(dataset.train, True, cfg.seed + epoch)
            timing = self.last_pass
            vl, vm = self.run_epoch(dataset.val, False, 0)
            _, test_m = self.run_epoch(dataset.test, False, 0)
            history.append(dict(epoch=epoch, train_loss=tl, train_metric=tm,
                                val_loss=vl, val_metric=vm, test_metric=test_m,
                                lr=lr, epoch_s=time.perf_counter() - t_epoch,
                                train_s=timing['seconds'],
                                train_steps=timing['steps'],
                                **{k: timing[k] for k in PASS_SPANS}))
            if logger:
                logger.log(epoch, **history[-1])
            improved = (vm < best_val) if select_best == 'min' \
                else (vm > best_val)
            if improved:
                best_val = vm
                best = dict(epoch=epoch, val_metric=vm, test_metric=test_m,
                            model=self._model_state())
                if cfg.checkpoint_path:
                    save_checkpoint(cfg.checkpoint_path,
                                    dict(model=best['model']),
                                    dict(epoch=epoch, metric=vm,
                                         test_metric=test_m))
                if manager:
                    manager.save_best(dict(model=best['model']), metric=vm,
                                      epoch=epoch, test_metric=test_m)
            log_fn(f"epoch {epoch}: train_loss {tl:.4f} val_metric {vm:.4f} "
                   f"test_metric {test_m:.4f} lr {lr:.2e}")
            self.scheduler.step(vl)
            new_lr = _lr(self.optimizer)
            if manager:
                manager.save_latest(self._latest_state(), epoch=epoch,
                                    scheduler=self.scheduler.state_dict(),
                                    best_val=best_val)
            if new_lr <= cfg.min_lr:
                log_fn("LR below min_lr, stopping")
                break
            if (time.time() - t0) / 3600.0 > cfg.max_time:
                log_fn("max_time reached, stopping")
                break
        if logger:
            logger.close()
        return self.model, best, history
