"""Full-graph training steps of the GAT net through the program's large-graph
trainer.

The problem is built as ``drivers/node_step.py`` builds it, by the program's
own partition and layout functions from the benchmark's arrays
(``gat_inputs.make_inputs``): ``parallel/partition.py::partition_edges``
over the configuration's ``d_graph`` parts (this chip holds part 0), then
``sort_partition_edges`` (the ``csr`` layout the GAT layers take).  The net
is the trainer's ``DistributedGATNet`` with the benchmark's weights, and the
step is the one ``make_node_train_step(part, None, net, optimizer)``
returns for it (its sigmoid cross-entropy): one process, no process group,
no halo exchange.
Set-up first checks that the program offers them, and raises before it
draws any input where it does not.

* set-up: ``first_steps`` steps, whose readings the reference
  (``reference/gat.py``, in float64) is held to, then ``warmup_steps``;
* the window: one step after another until ``--seconds`` have passed, each
  timed on the host clock to its loss read;
* traced: ``traced_steps`` steps.

A step's work is the graph's real edges (not the self terms) times the
attention layers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import gat_inputs, program, weights
from portbench.reference import gat as ref
from portbench.trace import profile


def program_gat():
    """The program's GAT net and node step, or a ``RuntimeError`` where the
    program has none (an older program: it fails at once, before any
    input is drawn)."""
    try:
        from pna_tpu_torch.parallel.distributed_net import DistributedGATNet
        from pna_tpu_torch.train.largegraph import make_node_train_step
    except ImportError as exc:
        raise RuntimeError(f"the program has no GAT net: {exc}") from exc
    return DistributedGATNet, make_node_train_step


class Driver:
    def __init__(self, cell, device):
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.net = ref.net_of(self.config)

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        gat_net, node_step = program_gat()
        from pna_tpu_torch.parallel import partition

        cfg, tr, net, dev = self.config, self.traffic, self.net, self.device
        if cfg['run']['kernel'] != 'csr':
            raise ValueError("the GAT net runs on the csr layout")
        lap = program.Laps()
        self.inputs = inp = gat_inputs.make_inputs(cfg, tr, seed)
        send, recv, n = inp['senders'], inp['receivers'], inp['num_nodes']
        lap('inputs')
        self.weights = weights.draw(ref.param_spec(net), seed, dev)
        lap('weights')

        part = partition.sort_partition_edges(
            partition.partition_edges(send, recv, n, cfg['d_graph']))
        self.part_nodes = part.nodes_per_part
        val_p = part.scatter_features(inp['val'][:, None].astype(np.float32)
                                      )[..., 0].astype(bool)
        train_mask = part.node_mask & ~val_p

        def mine(x):
            return torch.as_tensor(np.ascontiguousarray(x[0])).to(dev)

        self.feats = mine(part.scatter_features(inp['feats']))
        self.targets = mine(part.scatter_features(inp['labels']))
        self.mask = mine(train_mask)

        model = gat_net(cfg['feat_dim'], heads=net['heads'],
                        head_dim=net['head_dim'],
                        residual_layers=net['residual_layers'], device=dev,
                        seed=int(weights.sub_seeds(seed, 3)[2]) & 0x7FFFFFFF)
        model.load_state_dict(self.weights)
        p = cfg['params']
        if p['weight_decay']:
            raise ValueError("the reference takes no weight decay")
        opt = torch.optim.Adam(model.parameters(), lr=p['init_lr'])
        self.model, self.optimizer = model, opt
        self.step, _, _ = node_step(part, None, model, opt)
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
                    work_edges=len(times) * self.edges
                    * len(self.net['heads']),
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
        """The reference's readings in float64: the float32 program's
        round-off is then the whole of its gap (a float32 reference's own
        round-off in the first layers' attention gradients is 10x the
        program's).  ``tf32``, the control: float32 with TF32 products."""
        torch.backends.cuda.matmul.allow_tf32 = False
        inp, dev, net = self.inputs, self.device, self.net
        dtype = torch.float32 if tf32 else torch.float64
        g = ref.graph_of(torch.as_tensor(inp['senders']).to(dev),
                         torch.as_tensor(inp['receivers']).to(dev),
                         inp['num_nodes'])
        x = torch.as_tensor(inp['feats']).to(dev, dtype)
        y = torch.as_tensor(inp['labels']).to(dev, dtype)
        train = torch.as_tensor(np.nonzero(~inp['val'])[0]).to(dev)
        weights = {k: v.to(dtype) for k, v in self.weights.items()}

        def loss_fn(P):
            return ref.node_loss(P, net, g, x, y, train, tf32, half)

        p, opt = self.config['params'], self.config['optimizer']
        out = ref.train_readings(weights, loss_fn,
                                 len(self.program_readings['losses']),
                                 p['init_lr'], tuple(opt['betas']),
                                 opt['eps'])
        del g, x, y, train, weights
        program.free_device()
        return out

    # -- shapes the per-layer metrics read ---------------------------------
    def attention_shapes(self) -> list:
        """Per attention layer of a step, in order: the receivers the
        kernels walk (the part's rows, pad rows included), the sender
        table's rows, the real edges, heads and head width."""
        return [dict(nodes=self.part_nodes, table=self.part_nodes,
                     edges=self.edges, heads=d['heads'], f=d['f'])
                for d in ref.layer_dims(self.net)]
