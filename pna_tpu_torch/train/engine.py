"""The multitask training engine.

Counterpart of ``pna_tpu/train/engine.py`` (the reference's
``multitask_benchmark/util/train.py:67-232``), in the JAX order of events:

* one Adam step per size bucket of the train split, in bucket order, with
  coupled L2 decay: ``torch.optim.Adam(weight_decay=wd)`` adds ``wd * p``
  to the gradient before the moments, which is the JAX package's
  ``optax.chain(add_decayed_weights(wd), adam(lr))``; the epoch's training
  loss is the last bucket's;
* validation loss after every epoch, the buckets weighted alike; the best
  epoch's weights are kept (and written to ``checkpoint_path``) and put
  back into the model when the run ends; ``patience`` epochs without a
  better validation loss, or ``max_time_s`` seconds, stop the run;
* ``checkpoint_dir``: a ``CheckpointManager`` with the best epoch and a
  ``latest.ckpt`` (model, optimizer, the net's dropout generator, epoch,
  best loss and epoch, the patience count) every ``checkpoint_every``
  epochs and at the last; ``resume=True`` restores it and continues;
* ``test`` reports every split's loss and per-task losses.

The trainer uses the model's weights as it is given them and initialises
nothing.  It runs on the device its model lives on, which must be
``device`` (default ``cuda``; the CPU only when the caller passes
``device='cpu'``); each bucket is moved there once.  Each epoch's history
record (and ``metrics_path`` JSONL line) holds, beside the JAX keys
``loss_train`` and ``loss_val``, host seconds of the epoch with its
validation (``epoch_s``) and of its training pass (``train_s``, ending in
the read of the last loss), and the pass's number of steps
(``train_steps``).

``data_parallel``: each training step's bucket is split over the ranks of
the process group (one process per card, ``torchrun``; the trainer joins
the group from ``torchrun``'s environment), each rank back-propagates its
shard's loss over the world size, the gradients are summed over the ranks
and every ``nn.layers.BatchNorm`` of the model sums its statistics over
them, so the step equals the single-rank step on the whole bucket (what
GSPMD gives the JAX engine).  Evaluation runs the whole split on every
rank.  In one process it does nothing, as in the JAX package on one
device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.nn.layers import BatchNorm
from pna_tpu_torch.parallel import collectives, multihost
from pna_tpu_torch.train.losses import (specific_loss_multiple_batches,
                                        total_loss,
                                        total_loss_multiple_batches)
from pna_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint
from pna_tpu_torch.utils.logging import MetricsLogger, param_count


@dataclass
class TrainConfig:
    """The flags of the reference's ``multitask_benchmark/util/train.py``
    (its seed is the net's, given where the net is built)."""
    lr: float = 0.003
    weight_decay: float = 1e-6
    epochs: int = 10000
    patience: int = 1000
    loss: str = 'mse'
    only_nodes: bool = False
    only_graph: bool = False
    print_every: int = 50
    checkpoint_path: Optional[str] = None
    data_parallel: bool = False
    metrics_path: Optional[str] = None      # JSONL per-epoch metrics
    max_time_s: Optional[float] = None      # wall-clock stop; None: none
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    checkpoint_every: int = 50


class MultitaskTrainer:
    """Trains a ``GNN`` (or any module called as ``model(x, adj) ->
    (nodes, graph)``) on the multitask dataset's dense buckets."""

    def __init__(self, model: torch.nn.Module, dataset: Dict[str, Any],
                 config: TrainConfig, device: DeviceLike = None):
        self.world = 1
        if config.data_parallel and multihost.process_count() > 1:
            multihost.initialize(device=device)
            self.world = multihost.process_count()
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.group = dist.group.WORLD
        self.device = resolve_device(device)
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"model on {where}, trainer on {self.device}")
        self.model = model
        self.data = dataset
        self.cfg = config
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)
        self._buckets: Dict[str, list] = {}

    def buckets(self, dset: str):
        """[(features, adj, node_labels, graph_labels)] of a split, float32
        tensors on the trainer's device (moved once)."""
        if dset not in self._buckets:
            d = self.data
            self._buckets[dset] = [
                tuple(torch.as_tensor(np.asarray(d[k][dset][b]),
                                      dtype=torch.float32).to(self.device)
                      for k in ('features', 'adj', 'node_labels',
                                'graph_labels'))
                for b in range(len(d['adj'][dset]))]
        return self._buckets[dset]

    def _loss(self, out, nl, gl):
        cfg = self.cfg
        return total_loss(out, (nl, gl), loss=cfg.loss,
                          only_nodes=cfg.only_nodes,
                          only_graph=cfg.only_graph)

    # -- epochs -------------------------------------------------------------
    def train_step(self, feats, adj, nl, gl) -> torch.Tensor:
        """One Adam step on one bucket in training mode; its loss (on the
        device, not read).  Under data parallelism this rank takes its
        shard of the bucket, and the loss is the whole bucket's."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.world > 1:
            feats, adj, nl, gl = (self._shard(x) for x in (feats, adj, nl,
                                                           gl))
        loss = self._loss(self.model(feats, adj), nl, gl)
        if self.world > 1:
            (loss / self.world).backward()
            collectives.all_reduce_grads(self.model.parameters())
            loss = collectives.all_reduce(loss.detach()) / self.world
        else:
            loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's equal share of a bucket's leading (graph) axis."""
        if x.shape[0] % self.world:
            raise ValueError(f"a bucket of {x.shape[0]} graphs does not "
                             f"split over {self.world} ranks")
        n = x.shape[0] // self.world
        r = multihost.process_index()
        return x[r * n:(r + 1) * n]

    def train_epoch(self) -> float:
        """One Adam step per train bucket; the last bucket's loss."""
        loss = None
        for bucket in self.buckets('train'):
            loss = self.train_step(*bucket)
        return float(loss)

    def evaluate(self, dset: str):
        """(total loss of the split, (node outputs, graph outputs) per
        bucket) in eval mode."""
        self.model.eval()
        outs_n, outs_g, nls, gls = [], [], [], []
        with torch.no_grad():
            for feats, adj, nl, gl in self.buckets(dset):
                n_out, g_out = self.model(feats, adj)
                outs_n.append(n_out)
                outs_g.append(g_out)
                nls.append(nl)
                gls.append(gl)
        cfg = self.cfg
        tl = total_loss_multiple_batches(
            (outs_n, outs_g), (nls, gls), loss=cfg.loss,
            only_nodes=cfg.only_nodes, only_graph=cfg.only_graph)
        return tl, (outs_n, outs_g)

    def specific_losses(self, dset: str, outs=None):
        """Per-task losses of a split (of ``outs`` when given)."""
        if outs is None:
            _, outs = self.evaluate(dset)
        targets = ([b[2] for b in self.buckets(dset)],
                   [b[3] for b in self.buckets(dset)])
        return specific_loss_multiple_batches(
            outs, targets, loss=self.cfg.loss,
            only_nodes=self.cfg.only_nodes, only_graph=self.cfg.only_graph)

    # -- checkpoints --------------------------------------------------------
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

    # -- the run ------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None,
            log_fn: Callable[[str], None] = print) -> dict:
        """Train, keep the best epoch by validation loss and put its weights
        back into the model: dict(best_epoch, best_val, history)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        print("Total params", param_count(self.model))
        logger = MetricsLogger(cfg.metrics_path) if cfg.metrics_path else None

        best, best_state, best_epoch, bad = float('inf'), None, -1, 0
        start_epoch = 0
        manager = None
        if cfg.checkpoint_dir:
            manager = CheckpointManager(cfg.checkpoint_dir, mode='min')
            if cfg.resume:
                ck, meta = manager.restore_latest()
                if ck is not None:
                    self.model.load_state_dict(ck['model'])
                    self.optimizer.load_state_dict(ck['optimizer'])
                    if 'generator' in ck:
                        self._generator().set_state(ck['generator'])
                    best = meta['best']
                    best_epoch = meta['best_epoch']
                    bad = meta['bad']
                    start_epoch = meta['epoch'] + 1
                    b, _ = manager.restore_best()
                    if b is not None:
                        best_state = b['model']
                    log_fn(f"Resumed from epoch {meta['epoch']} "
                           f"(best {best:.4f} @{best_epoch})")
        history = []
        t0 = time.time()
        for epoch in range(start_epoch, epochs):
            t_epoch = time.perf_counter()
            loss_train = self.train_epoch()
            train_s = time.perf_counter() - t_epoch
            loss_val, _ = self.evaluate('val')
            history.append(dict(
                epoch=epoch, loss_train=loss_train, loss_val=loss_val,
                epoch_s=time.perf_counter() - t_epoch, train_s=train_s,
                train_steps=len(self.buckets('train'))))
            if logger:
                logger.log(epoch, **{k: v for k, v in history[-1].items()
                                     if k != 'epoch'})
            if loss_val < best:
                best, best_epoch, bad = loss_val, epoch, 0
                best_state = self._model_state()
                if cfg.checkpoint_path:
                    save_checkpoint(cfg.checkpoint_path,
                                    dict(model=best_state),
                                    dict(epoch=epoch, val_loss=best))
                if manager:
                    manager.save_best(dict(model=best_state),
                                      metric=loss_val, epoch=epoch)
            else:
                bad += 1
            if manager and ((epoch + 1) % cfg.checkpoint_every == 0
                            or epoch + 1 == epochs):
                manager.save_latest(self._latest_state(), epoch=epoch,
                                    best=best, best_epoch=best_epoch, bad=bad)
            if epoch % cfg.print_every == 0:
                log_fn(f"epoch {epoch}: loss.train {loss_train:.4f} "
                       f"loss.val {loss_val:.4f} (best {best:.4f} "
                       f"@{best_epoch}, {time.time() - t0:.1f}s)")
            if bad == cfg.patience:
                log_fn(f"Early stop at epoch {epoch + 1}")
                break
            if (cfg.max_time_s is not None
                    and time.time() - t0 > cfg.max_time_s):
                log_fn(f"Max-time stop at epoch {epoch + 1} "
                       f"({time.time() - t0:.0f}s)")
                break
        if logger:
            logger.close()
        if best_state is not None:
            self.model.load_state_dict(best_state)
        return dict(best_epoch=best_epoch, best_val=best, history=history)

    def test(self, log_fn: Callable[[str], None] = print) -> dict:
        """Every split's total and per-task losses."""
        results = {}
        for dset in self.data['adj'].keys():
            tl, outs = self.evaluate(dset)
            sl = self.specific_losses(dset, outs)
            results[dset] = dict(total=tl, per_task=sl)
            log_fn(f"Test set results {dset}: loss= {tl:.4f}")
            log_fn(f"{dset}: {sl}")
        return results
