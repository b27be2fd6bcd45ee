"""Edge-partitioned training on one large graph.

Counterpart of ``pna_tpu/train/largegraph.py``: full-graph steps over a
node-partitioned graph on a ('data', 'graph') mesh with a node-level
objective, a per-node regression against neighbour statistics computed on
the host, on transductive train/validation node masks; a JSONL curve,
checkpoint and resume (with the early-stop state), and an early stop on the
validation loss.  Each record of the curve carries its train step's time
(``step_s``, host clock, ending when the loss is read off the device;
evaluations are outside it).  ``model='gat'`` trains the GAT paper's PPI
model (``ppi_gat_config``) on the same partition, tables and halo
exchange, against binary labels a node (its last layer's head width)
under a sigmoid cross-entropy.

One process per rank (``parallel/multihost.py``): run it in one process for
one rank, or under ``torchrun --nproc_per_node N`` for N.  ``d_data *
d_graph`` must equal the world size.  Each rank's device is
``cuda:{local_rank}`` unless the caller asks for the CPU (the tests do);
each rank builds the whole problem on the host, as every JAX process does,
and keeps its part on its device.  The optimiser is ``torch.optim.Adam``,
or ``AdamW`` with a weight decay (optax's ``adam``/``adamw``, the same
update).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from pna_tpu_torch.ops.layout import choose_layout, device_budget_bytes
from pna_tpu_torch.parallel import collectives, multihost
from pna_tpu_torch.parallel.distributed_net import (DistributedGATNet,
                                                    DistributedPNANet,
                                                    mesh_groups, part_tables)
from pna_tpu_torch.parallel.partition import (EdgePartition,
                                              partition_edges,
                                              powerlaw_graph,
                                              sort_partition_edges)
from pna_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            load_checkpoint, save_checkpoint)
from pna_tpu_torch.utils.profiling import StepTimer, span

KERNELS = ('auto', 'generic', 'csr', 'csr_fused')
MODELS = ('pna', 'gat')


def neighbor_stats_labels(senders: np.ndarray, receivers: np.ndarray,
                          feats: np.ndarray, num_nodes: int) -> np.ndarray:
    """The message-passing ground truth, on the host:

        y_i = mean_{j->i} x_j[0] + 0.5 * max_{j->i} x_j[1]
              + 0.25 * log(1 + deg_i)

    learnable only through aggregation, so a falling curve certifies the
    distributed message passing end to end."""
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    s0 = np.zeros(num_nodes)
    np.add.at(s0, receivers, feats[senders, 0].astype(np.float64))
    mean0 = s0 / np.maximum(deg, 1.0)
    mx1 = np.full(num_nodes, -np.inf)
    np.maximum.at(mx1, receivers, feats[senders, 1].astype(np.float64))
    mx1[deg == 0] = 0.0
    y = mean0 + 0.5 * mx1 + 0.25 * np.log1p(deg)
    return y.astype(np.float32)


def neighbor_mean_labels(senders: np.ndarray, receivers: np.ndarray,
                         feats: np.ndarray, num_nodes: int, label_dim: int,
                         seed: int = 0) -> np.ndarray:
    """``label_dim`` binary labels a node, on the host: with q = x P (P
    [F, 8] standard normal from ``seed``) and its mean over each node's
    in-neighbours and itself,

        y_ic = 1[(mean_{j in N(i) + i} q_j) . r_c > 0]

    (r_c [8] standard normal): learnable by attention that spreads over a
    node's neighbourhood, and a GAT's uniform weights are that mean.
    [N, label_dim] float32."""
    rng = np.random.RandomState(seed)
    proj = rng.randn(feats.shape[1], 8)
    mix = rng.randn(8, label_dim)
    q = feats.astype(np.float64) @ proj
    s = q.copy()
    for c in range(q.shape[1]):
        s[:, c] += np.bincount(receivers, weights=q[senders, c],
                               minlength=num_nodes)
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    return ((s / (deg + 1.0)[:, None]) @ mix > 0).astype(np.float32)


def make_node_train_step(part: EdgePartition, mesh, net: DistributedPNANet,
                         optimizer: torch.optim.Optimizer,
                         efeats: Optional[np.ndarray] = None):
    """Node-level masked train and evaluation steps over the mesh, for a
    ``DistributedPNANet`` or a ``DistributedGATNet``.

    Returns ``(step, evaluate, tables)``:

    * ``step(feats, targets, mask) -> loss``: this rank's part (``feats``
      [Nl, F], ``targets``/``mask`` [Nl]); the loss is the squared error over
      the masked nodes of every part over their count, averaged over the
      data axis (a float, the same on every rank).  For a net whose
      ``loss`` is 'bce' (``targets`` [Nl, C] of 0 and 1, the net's logits
      [Nl, C]): the labels' sigmoid cross-entropy summed over the masked
      nodes of every part over C times their count;
    * ``evaluate(feats, targets, mask) -> loss``: the same objective in eval
      mode (the running batch-norm statistics), without gradients;
    * ``tables``: this rank's ``PartTables`` (its CSR layout, built once).

    ``step`` times its forward, backward, Adam step and loss read as the
    spans ``pna.forward``, ``pna.backward``, ``pna.optimizer`` and
    ``pna.loss_read`` (``utils/profiling.py::span``).

    ``mesh`` None: one process without a process group, the net built
    without groups and ``part`` of one part; the same step with every
    collective left out (the single-device semantics)."""
    if not net.node_level:
        raise ValueError("make_node_train_step needs node_level=True")
    bce = net.loss == 'bce'
    grouped = mesh is not None
    if grouped:
        data_group, graph_group, (_, gi) = mesh_groups(mesh)
        d_data, d_graph = mesh.shape
    else:
        data_group = graph_group = None
        gi, d_data, d_graph = 0, 1, 1
    dev = next(net.parameters()).device
    tables = part_tables(part, net, gi, dev, efeats)
    kw = tables.net_kwargs(distributed=grouped)
    scale = collectives.loss_scale(d_graph, d_data)

    def psum(x, group):
        return collectives.all_reduce(x, group) if grouped else x

    def objective(feats, targets, mask):
        pred = net(tables.graph, feats, **kw)
        m = mask.to(pred.dtype)
        if bce:
            err = F.binary_cross_entropy_with_logits(pred, targets,
                                                     reduction='none')
            se = psum((err.sum(1) * m).sum(), graph_group)
            cnt = psum(m.sum() * pred.shape[1], graph_group)
        else:
            se = psum((((pred - targets) ** 2) * m).sum(), graph_group)
            cnt = psum(m.sum(), graph_group)
        return se / torch.clamp(cnt, min=1.0)

    def mean_over_data(loss) -> float:
        return float(psum(loss.detach(), data_group)) / d_data

    def step(feats, targets, mask) -> float:
        net.train()
        optimizer.zero_grad(set_to_none=True)
        with span('pna.forward', dev):
            loss = objective(feats, targets, mask)
        with span('pna.backward', dev):
            (loss * scale).backward()
        if grouped:
            collectives.all_reduce_grads(net.parameters())
        with span('pna.optimizer', dev):
            optimizer.step()
        with span('pna.loss_read'):
            return mean_over_data(loss)

    def evaluate(feats, targets, mask) -> float:
        net.eval()
        with torch.no_grad():
            return mean_over_data(objective(feats, targets, mask))

    return step, evaluate, tables


@dataclass
class LargeGraphConfig:
    """The trainer's configuration (CLI: ``cli/train_largegraph.py``).
    ``model`` 'pna' (``DistributedPNANet``: hidden_dim .. max_degree) or
    'gat' (``DistributedGATNet``: heads, head_dim, residual_layers; the
    ``csr`` layout whatever ``kernel`` says; ``ppi_gat_config`` gives the
    paper's PPI model).  ``loss`` and ``label_dim`` follow from the model:
    'mse' against the neighbour statistics (1), or 'bce' against binary
    labels (``neighbor_mean_labels``) as many as the last layer's head
    width."""
    num_nodes: int = 100_000
    num_edges: int = 1_000_000
    graph_kind: str = 'powerlaw'          # 'powerlaw' | 'uniform'
    exponent: float = 1.5                 # power-law skew
    feat_dim: int = 8
    edge_feat_dim: int = 0                # > 0: per-edge features
    seed: int = 0
    d_data: int = 1
    d_graph: int = 8
    kernel: str = 'auto'                  # one of KERNELS
    hidden_dim: int = 64
    out_dim: int = 64
    n_layers: int = 4
    towers: int = 4
    aggregators: Sequence[str] = ('mean', 'max', 'min', 'std')
    scalers: Sequence[str] = ('identity', 'amplification', 'attenuation')
    batch_norm: bool = True
    steps: int = 100
    lr: float = 1e-3
    weight_decay: float = 0.0
    val_frac: float = 0.1
    eval_every: int = 10
    ckpt_every: int = 25
    patience: int = 0                     # 0: no early stop (eval rounds)
    log_path: Optional[str] = None        # JSONL curve
    ckpt_dir: Optional[str] = None
    resume: bool = False
    max_degree: int = 0
    model: str = 'pna'                    # one of MODELS
    heads: Sequence[int] = (4, 4, 6)      # GAT: heads of each layer
    head_dim: Sequence[int] = (256, 256, 121)
    residual_layers: Sequence[int] = (1,)

    @property
    def loss(self) -> str:
        return 'bce' if self.model == 'gat' else 'mse'

    @property
    def label_dim(self) -> int:
        return self.head_dim[-1] if self.model == 'gat' else 1


def ppi_gat_config(**overrides) -> LargeGraphConfig:
    """The GAT paper's inductive PPI model (arXiv:1710.10903, section 3.3)
    on the large graph: 3 layers, 4 x 256 concatenated, 4 x 256 with the
    skip connection, 6 x 121 averaged; 50 input features, 121 labels under
    a sigmoid cross-entropy; Adam at lr 0.005, no weight decay; the
    ``csr`` layout."""
    cfg = dict(model='gat', kernel='csr', feat_dim=50, heads=(4, 4, 6),
               head_dim=(256, 256, 121), residual_layers=(1,), lr=0.005,
               weight_decay=0.0)
    cfg.update(overrides)
    return LargeGraphConfig(**cfg)


def build_problem(cfg: LargeGraphConfig, device=None):
    """The graph, its partition (in the layout of the kernel), the node
    features, labels, masks and edge features, on the host: (part, feats
    [P, Nl, F], labels [P, Nl] (or [P, Nl, C]), train_mask, val_mask,
    efeats [P, El, Fe] or
    None, avg_d, kernel).  ``device`` is where the step runs (None: this
    rank's card); under ``kernel='auto'`` it gives ``choose_layout`` its
    budget and whether the CSR kernels run there."""
    if cfg.kernel not in KERNELS:
        raise ValueError(f"kernel {cfg.kernel!r} not in {KERNELS}")
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} not in {MODELS}")
    rng = np.random.RandomState(cfg.seed)
    if cfg.graph_kind == 'powerlaw':
        send, recv = powerlaw_graph(cfg.num_nodes, cfg.num_edges,
                                    seed=cfg.seed, exponent=cfg.exponent)
    elif cfg.graph_kind == 'uniform':
        send = rng.randint(0, cfg.num_nodes, cfg.num_edges).astype(np.int64)
        recv = rng.randint(0, cfg.num_nodes, cfg.num_edges).astype(np.int64)
    else:
        raise ValueError(cfg.graph_kind)

    part = partition_edges(send, recv, cfg.num_nodes, cfg.d_graph)

    kernel = 'csr' if cfg.model == 'gat' else cfg.kernel
    if kernel == 'auto':
        # fed the heaviest part's edges: under skew one part can hold far
        # more than E/P edges, and its layout must fit its own card
        counts = part.edge_mask.sum(axis=1)
        heavy = int(np.argmax(counts))
        orig = part.edge_origin[heavy][part.edge_mask[heavy]]
        dev = multihost.rank_device(device)
        choice = choose_layout(send[orig], recv[orig], cfg.num_nodes,
                               cfg.hidden_dim, device_budget_bytes(dev),
                               csr_kernels=dev.type == 'cuda')
        kernel = choice.kernel
        if multihost.is_coordinator():
            print(f"[choose_layout] {kernel} (heaviest part "
                  f"{int(counts[heavy])} of {cfg.num_edges} edges): "
                  f"{choice.reason}", flush=True)

    if kernel in ('csr', 'csr_fused'):
        part = sort_partition_edges(part)

    feats = rng.randn(cfg.num_nodes, cfg.feat_dim).astype(np.float32)
    if cfg.model == 'gat':
        labels = neighbor_mean_labels(send, recv, feats, cfg.num_nodes,
                                      cfg.label_dim, cfg.seed)
    else:
        labels = neighbor_stats_labels(send, recv, feats, cfg.num_nodes)
    deg = np.bincount(recv, minlength=cfg.num_nodes).astype(np.float64)
    d = np.maximum(deg, 1.0)
    avg_d = {'lin': float(np.mean(d)), 'log': float(np.mean(np.log(d + 1))),
             'exp': float(np.mean(np.exp(d))) if d.max() < 50 else 0.0}
    del send, recv, deg, d

    # transductive split over the real nodes
    val = rng.rand(cfg.num_nodes) < cfg.val_frac
    nm = part.node_mask
    val_p = part.scatter_features(val[:, None].astype(np.float32)
                                  )[..., 0].astype(bool)
    train_mask, val_mask = nm & ~val_p, nm & val_p
    feats_p = part.scatter_features(feats)                      # [P, Nl, F]
    if labels.ndim == 1:
        labels_p = part.scatter_features(labels[:, None])[..., 0]   # [P, Nl]
    else:
        labels_p = part.scatter_features(labels)                # [P, Nl, C]

    efeats = None
    if cfg.edge_feat_dim:
        ef = rng.randn(cfg.num_edges, cfg.edge_feat_dim).astype(np.float32)
        efeats = part.scatter_edge_features(ef)
    return (part, feats_p, labels_p, train_mask, val_mask, efeats, avg_d,
            kernel)


def train_largegraph(cfg: LargeGraphConfig, device=None,
                     init_state: Optional[dict] = None):
    """Run the trainer on this rank; returns (net, history).  Joins the
    process group if it is not joined (and leaves it again at the end):
    NCCL on the card, gloo on the CPU.  ``init_state``: a state dict to
    start from instead of the weights ``cfg.seed`` draws (the same on
    every rank)."""
    dev = multihost.rank_device(device)
    created = not dist.is_initialized()
    multihost.initialize(device=dev)
    try:
        return _train(cfg, dev, init_state)
    finally:
        if created:
            multihost.shutdown()


def _train(cfg: LargeGraphConfig, dev: torch.device,
           init_state: Optional[dict]):
    world = multihost.process_count()
    if cfg.d_data * cfg.d_graph != world:
        raise ValueError(f"d_data * d_graph = {cfg.d_data * cfg.d_graph} "
                         f"ranks, the world has {world}")
    if dev.type == 'cuda':
        dev = torch.device('cuda', multihost.local_rank())
    mesh = multihost.hybrid_mesh({'data': cfg.d_data},
                                 {'graph': cfg.d_graph},
                                 device_type=dev.type)
    _, graph_group, (_, gi) = mesh_groups(mesh)
    (part, feats_p, labels_p, train_mask, val_mask, efeats, avg_d,
     kernel) = build_problem(cfg, dev)
    if cfg.model == 'gat':
        net = DistributedGATNet(
            cfg.feat_dim, heads=tuple(cfg.heads),
            head_dim=tuple(cfg.head_dim),
            residual_layers=tuple(cfg.residual_layers),
            graph_group=graph_group, device=dev, seed=cfg.seed)
    else:
        net = DistributedPNANet(
            cfg.feat_dim, hidden_dim=cfg.hidden_dim, out_dim=cfg.out_dim,
            n_layers=cfg.n_layers, towers=cfg.towers,
            aggregators=tuple(cfg.aggregators), scalers=tuple(cfg.scalers),
            avg_d=avg_d, batch_norm=cfg.batch_norm, residual=True,
            kernel=kernel, edge_features=efeats is not None,
            edge_dim=cfg.edge_feat_dim, node_level=True,
            max_degree=cfg.max_degree, graph_group=graph_group,
            bn_group=dist.group.WORLD, device=dev, seed=cfg.seed)
    if init_state is not None:
        net.load_state_dict(init_state)
    opt = (torch.optim.AdamW(net.parameters(), lr=cfg.lr,
                             weight_decay=cfg.weight_decay)
           if cfg.weight_decay else torch.optim.Adam(net.parameters(),
                                                     lr=cfg.lr))
    step, evaluate, _ = make_node_train_step(part, mesh, net, opt,
                                             efeats=efeats)

    def mine(x):
        return torch.as_tensor(np.ascontiguousarray(x[gi])).to(dev)

    feats, targets = mine(feats_p), mine(labels_p)
    tmask, vmask = mine(train_mask), mine(val_mask)
    del feats_p, labels_p, train_mask, val_mask

    start = 0
    best_val, since_best = float('inf'), 0
    mgr = None
    coord = multihost.is_coordinator()
    if cfg.ckpt_dir:
        mgr = CheckpointManager(cfg.ckpt_dir, keep_best=1, mode='min')
        latest = os.path.join(cfg.ckpt_dir, 'latest.ckpt')
        if cfg.resume and os.path.exists(latest):
            state, meta = load_checkpoint(latest)
            net.load_state_dict(state['model'])
            opt.load_state_dict(state['optimizer'])
            start = int(meta['step'])
            # the early-stop state too, so that patience survives a resume
            best_val = float(meta.get('best_val', float('inf')))
            since_best = int(meta.get('since_best', 0))
            if coord:
                print(f"[resume] from step {start} (best_val="
                      f"{best_val:.6g}, since_best={since_best})",
                      flush=True)

    history = []
    logf = open(cfg.log_path, 'a') if (cfg.log_path and coord) else None
    timer = StepTimer()
    t0 = time.time()
    for it in range(start, cfg.steps):
        timer.start()
        loss = step(feats, targets, tmask)   # a float: read off the device
        timer.stop()
        rec = {'step': it + 1, 'train_loss': loss, 'step_s': timer.last,
               'wall_s': round(time.time() - t0, 3)}
        if (it + 1) % cfg.eval_every == 0 or it + 1 == cfg.steps:
            vl = evaluate(feats, targets, vmask)
            rec['val_loss'] = vl
            if mgr is not None and coord:
                mgr.save_best({'model': net.state_dict()}, metric=vl,
                              epoch=it + 1)
            if vl < best_val - 1e-9:
                best_val, since_best = vl, 0
            else:
                since_best += 1
        history.append(rec)
        if logf:
            logf.write(json.dumps(rec) + '\n')
            logf.flush()
        if cfg.ckpt_dir and ((it + 1) % cfg.ckpt_every == 0
                             or it + 1 == cfg.steps):
            if coord:
                save_checkpoint(os.path.join(cfg.ckpt_dir, 'latest.ckpt'),
                                {'model': net.state_dict(),
                                 'optimizer': opt.state_dict()},
                                metadata={'step': it + 1,
                                          'best_val': best_val,
                                          'since_best': since_best})
            multihost.barrier()
        if cfg.patience and since_best >= cfg.patience:
            if coord:
                print(f"[early stop] no val improvement in {cfg.patience} "
                      "evals", flush=True)
            break
    if logf:
        logf.close()
    return net, history
