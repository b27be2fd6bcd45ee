"""Full-graph training steps of the node-level net through the program's
large-graph trainer.

The problem is built by the program's own partition and layout functions,
as ``train/largegraph.py::build_problem`` builds it, but from the
benchmark's arrays: ``parallel/partition.py::partition_edges`` over the
configuration's ``d_graph`` parts (this chip holds part 0), the layout
``ops/layout.py::choose_layout`` picks under ``kernel='auto'``, then
``sort_partition_edges`` (or ``bucketize_partition``).  The net is the
trainer's ``DistributedPNANet`` with the benchmark's weights, and the step
is the one ``make_node_train_step(part, None, net, optimizer)`` returns: one
process, no process group, no halo exchange.

* set-up: ``first_steps`` steps, whose readings the reference is held to,
  then ``warmup_steps``;
* the window: one step after another until ``--seconds`` have passed, each
  timed on the host clock to its loss read;
* traced: ``traced_steps`` steps.

A step's work is the graph's real edges times the message layers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import program, traffic, weights
from portbench.reference import pna as ref
from portbench.trace import profile


def trainer_avg_d(receivers: np.ndarray, n: int) -> dict:
    """The degree statistics the large-graph trainer gives its net
    (``build_problem``'s rule)."""
    d = np.maximum(np.bincount(receivers, minlength=n).astype(np.float64),
                   1.0)
    return {'lin': float(np.mean(d)), 'log': float(np.mean(np.log(d + 1))),
            'exp': float(np.mean(np.exp(d))) if d.max() < 50 else 0.0}


class Driver:
    head = 'node'

    def __init__(self, cell, device):
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.net = ref.net_of(self.config)

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        from pna_tpu_torch.ops.layout import choose_layout, device_budget_bytes
        from pna_tpu_torch.parallel import partition
        from pna_tpu_torch.parallel.distributed_net import DistributedPNANet
        from pna_tpu_torch.train import largegraph

        cfg, tr, net, dev = self.config, self.traffic, self.net, self.device
        lap = program.Laps()
        self.inputs = inp = traffic.make_inputs(cfg, tr, seed)
        send, recv, n = inp['senders'], inp['receivers'], inp['num_nodes']
        lap('inputs')
        self.weights = weights.draw(ref.param_spec(net, self.head), seed,
                                    dev)
        lap('weights')

        part = partition.partition_edges(send, recv, n, cfg['d_graph'])
        kernel = cfg['run']['kernel']
        if kernel == 'auto':
            heavy = int(np.argmax(part.edge_mask.sum(axis=1)))
            orig = part.edge_origin[heavy][part.edge_mask[heavy]]
            kernel = choose_layout(send[orig], recv[orig], n,
                                   net['hidden_dim'], device_budget_bytes(dev),
                                   csr_kernels=dev.type == 'cuda').kernel
        if kernel == 'bucketed':
            part = partition.bucketize_partition(part)
        elif kernel in ('csr', 'csr_fused'):
            part = partition.sort_partition_edges(part)
        self.kernel = kernel

        val_p = part.scatter_features(inp['val'][:, None].astype(np.float32)
                                      )[..., 0].astype(bool)
        train_mask = part.node_mask & ~val_p

        def mine(x):
            return torch.as_tensor(np.ascontiguousarray(x[0])).to(dev)

        self.feats = mine(part.scatter_features(inp['feats']))
        self.targets = mine(part.scatter_features(
            inp['labels'][:, None])[..., 0])
        self.mask = mine(train_mask)

        model = DistributedPNANet(
            cfg['feat_dim'], hidden_dim=net['hidden_dim'],
            out_dim=net['out_dim'], n_layers=net['L'], towers=net['towers'],
            aggregators=net['aggregators'], scalers=net['scalers'],
            avg_d=trainer_avg_d(recv, n), batch_norm=net['batch_norm'],
            residual=net['residual'], kernel=kernel, node_level=True,
            device=dev, seed=int(weights.sub_seeds(seed, 3)[2]) & 0x7FFFFFFF)
        model.load_state_dict(self.weights)
        p = cfg['params']
        if p['weight_decay']:
            raise ValueError("with a weight decay the trainer takes AdamW, "
                             "whose decoupled decay the reference lacks")
        opt = torch.optim.Adam(model.parameters(), lr=p['init_lr'])
        self.model, self.optimizer = model, opt
        self.step, _, _ = largegraph.make_node_train_step(part, None, model,
                                                          opt)
        lap('program')
        losses = []
        for k in range(tr['first_steps']):
            losses.append(self._step())
            if k == 0:
                grad = program.grad_norms(model, opt)
                first_change = program.change_norms(model, self.weights)
        self.program_readings = dict(
            losses=losses, grad=grad, first_change=first_change,
            change=program.change_norms(model, self.weights))
        lap('first_steps')
        for _ in range(tr['warmup_steps']):
            self._step()
        self.edges = len(send)
        lap('warmup')
        self.phases = lap.seconds

    def _step(self) -> float:
        return self.step(self.feats, self.targets, self.mask)

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> dict:
        times, failed = [], 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t0 = time.perf_counter()
            loss = self._step()
            times.append(time.perf_counter() - t0)
            failed += 0 if math.isfinite(loss) else 1
        elapsed = time.perf_counter() - t_start
        return dict(seconds=elapsed, steps=len(times),
                    attempted=len(times), failed=failed, step_s=times,
                    work_edges=len(times) * self.edges * self.net['L'],
                    spans=None)

    def traced(self):
        steps = self.traffic['traced_steps']

        def run():
            for _ in range(steps):
                self._step()
            return steps

        n = self.inputs['num_nodes']
        self.traced_work = dict(nodes=steps * n, edges=steps * self.edges,
                                graphs=0)
        return profile(run)

    def release(self) -> None:
        del self.step, self.model, self.optimizer
        del self.feats, self.targets, self.mask
        program.free_device()

    # -- the reference ----------------------------------------------------
    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        inp, dev, net = self.inputs, self.device, self.net
        n = inp['num_nodes']
        recv = torch.as_tensor(inp['receivers']).to(dev)
        deg = ref.in_degrees(recv, n)
        graph = dict(
            senders=torch.as_tensor(inp['senders']).to(dev), receivers=recv,
            deg=deg, feats=torch.as_tensor(inp['feats']).to(dev),
            y=torch.as_tensor(inp['labels']).to(dev),
            train=torch.as_tensor(np.nonzero(~inp['val'])[0]).to(dev),
            avg_log=ref.avg_log_degree('clamped', [deg.cpu().numpy()]))

        def loss_fn(P, g, stats):
            return ref.node_loss(P, net, g, stats, tf32, half)

        p, opt = self.config['params'], self.config['optimizer']
        return ref.train_readings(self.weights, loss_fn,
                                  [graph] * len(self.program_readings['losses']),
                                  p['init_lr'], p['weight_decay'],
                                  tuple(opt['betas']), opt['eps'])

    # -- shapes the per-layer metrics read ---------------------------------
    def aggregation_shape(self) -> dict:
        """Rows, nodes and width of each layer's aggregation and of each
        gather's row sum: the graph's real edges, its nodes, the hidden
        width."""
        return dict(rows=self.edges, nodes=self.inputs['num_nodes'],
                    f=self.net['hidden_dim'])
