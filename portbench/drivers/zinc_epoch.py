"""Training epochs of the molecule net through the program's trainer.

The program is built as its ZINC command line builds it
(``cli/main_molecules.py::make_model`` and ``make_config``), its weights
replaced by the benchmark's, and trained by
``train/realworld.py::RealworldTrainer.run_epoch``, the call a ZINC user's
every epoch makes (collation, the host-to-device copy, the step, the loss
read).

* set-up: ``first_steps`` calls of ``run_epoch`` on ``batch_size`` records
  each (one step each, on records that all differ), whose readings the
  reference is held to, then ``warmup_steps`` batches in one call;
* the window: whole epochs over every record, each in an order drawn from
  the seed, until ``--seconds`` have passed; its time is that of all its
  epochs;
* traced: ``traced_steps`` batches of records in one ``run_epoch``.

The work of an epoch is its records' real edges times the message layers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import program, traffic, weights
from portbench.reference import pna as ref
from portbench.trace import profile


class Driver:
    head = 'molecules'

    def __init__(self, cell, device):
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.net = ref.net_of(self.config)
        self.batch = self.config['params']['batch_size']

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        from pna_tpu_torch.cli.main_molecules import make_config, make_model
        from pna_tpu_torch.data.molecules import ZincDataset
        from pna_tpu_torch.nn.nets import PNANetMolecules
        from pna_tpu_torch.train.realworld import RealworldTrainer

        cfg, tr, B = self.config, self.traffic, self.batch
        lap = program.Laps()
        self.records = traffic.make_inputs(cfg, tr, seed)['records']
        n_first = tr['first_steps']
        if n_first * B > len(self.records):
            raise ValueError("fewer records than the first steps take")
        self.first = [self.records[i * B:(i + 1) * B]
                      for i in range(n_first)]
        self.order = int(weights.sub_seeds(seed, 3)[2])
        lap('inputs')
        self.weights = weights.draw(ref.param_spec(self.net, self.head),
                                    seed, self.device)
        lap('weights')
        ds = ZincDataset(self.records, [], [], cfg['num_atom_type'],
                         cfg['num_bond_type'])
        model, fwd = make_model(cfg['net_params'], ds, self.device,
                                seed=self.order & 0x7FFFFFFF)
        model.load_state_dict(self.weights)
        kernels = {layer.kernel for layer in model.layers}
        if kernels != {cfg['run']['kernel']}:
            raise ValueError(f"the net runs {kernels}, the configuration "
                             f"states {cfg['run']['kernel']!r}")
        self.model = model
        self.trainer = RealworldTrainer(
            model, PNANetMolecules.loss, make_config(cfg['params']),
            forward_args=fwd, metric='mae', device=self.device)
        lap('program')
        losses = []
        for k, chunk in enumerate(self.first):
            loss, _ = self.trainer.run_epoch(chunk, True, self._seed(k))
            losses.append(loss)
            if k == 0:
                grad = program.grad_norms(model, self.trainer.optimizer)
                first_change = program.change_norms(model, self.weights)
        self.program_readings = dict(
            losses=losses, grad=grad, first_change=first_change,
            change=program.change_norms(model, self.weights))
        lap('first_steps')
        if tr['warmup_steps']:
            self.trainer.run_epoch(self.records[:tr['warmup_steps'] * B],
                                   True, self._seed(n_first))
        self.epoch = n_first + 1
        self.edges_per_epoch = sum(len(r['senders']) for r in self.records)
        lap('warmup')
        self.phases = lap.seconds

    def _seed(self, k: int) -> int:
        return (self.order + k) % 2 ** 32

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> dict:
        steps = failed = 0
        collate = sync = 0.0
        epoch_s = []
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            loss, _ = self.trainer.run_epoch(self.records, True,
                                             self._seed(self.epoch))
            epoch_s.append(time.perf_counter() - t0)
            self.epoch += 1
            lp = self.trainer.last_pass
            steps += lp['steps']
            collate += lp['collate_s']
            sync += lp['sync_s']
            failed += 0 if math.isfinite(loss) else lp['steps']
            if time.perf_counter() - t_start >= seconds:
                break
        elapsed = time.perf_counter() - t_start
        return dict(seconds=elapsed, steps=steps, attempted=steps,
                    failed=failed, step_s=None, epoch_s=epoch_s,
                    work_edges=(len(epoch_s) * self.edges_per_epoch
                                * self.net['L']),
                    spans=dict(collate_s=collate, sync_s=sync, steps=steps))

    def traced(self):
        chunk = self.records[:self.traffic['traced_steps'] * self.batch]

        def run():
            self.trainer.run_epoch(chunk, True, self._seed(self.epoch))
            self.epoch += 1
            return self.trainer.last_pass['steps']

        self.traced_work = dict(
            nodes=sum(r['node_feats'].shape[0] for r in chunk),
            edges=sum(len(r['senders']) for r in chunk), graphs=len(chunk))
        return profile(run)

    def release(self) -> None:
        del self.trainer, self.model
        program.free_device()

    # -- the reference ----------------------------------------------------
    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        avg_log = ref.avg_log_degree('per_graph', [
            np.bincount(r['receivers'], minlength=r['node_feats'].shape[0])
            for r in self.records])
        batches = [dict(ref.molecule_batch(c, self.device), avg_log=avg_log)
                   for c in self.first]
        p, net = self.config['params'], self.net

        def loss_fn(P, batch, stats):
            return ref.molecules_loss(P, net, batch, stats, tf32, half)

        opt = self.config['optimizer']
        return ref.train_readings(self.weights, loss_fn, batches,
                                  p['init_lr'], p['weight_decay'],
                                  tuple(opt['betas']), opt['eps'])
