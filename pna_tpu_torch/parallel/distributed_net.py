"""The PNA net on an edge-partitioned graph over a ('data', 'graph') mesh.

Counterpart of ``pna_tpu/parallel/distributed_net.py``.  One large graph is
edge-partitioned over the ``graph`` axis (a halo exchange per layer,
``parallel/partition.py``) while independent feature batches ride the
``data`` axis.  The JAX package runs the step as one SPMD program; here each
rank is a process that runs its part:

* the net is the flagship stack: a dense embedding, L x ``PNALayerFused``
  (towers, split-kernel pretrans, the aggregator x scaler bank, masked batch
  norm with statistics summed over the mesh, residual), then a masked-mean
  readout summed over the graph axis and ``MLPReadout``, or, with
  ``node_level``, ``MLPReadout`` on every node;
* before every layer the node features are exchanged
  (``partition.halo_exchange``) and the layer gathers senders from the
  ghost table, or, with ``overlap``, aggregates the local edges while the
  exchange is in flight (``partition.split_edges``);
* the step's gradient follows ``collectives``' rule: each rank
  back-propagates its replicated loss scaled by 1 / (d_graph * d_data),
  and the parameter gradients are summed over every rank before the
  optimiser's step, which every rank then takes alike.

Without groups the net runs the JAX oracle's single-device semantics (on
``full_graph``), with the same parameter names, so ``weights.from_jax``
loads the JAX net's ``embedding_h``, ``embedding_e``, ``layer_i`` and
``MLP_layer`` into either.  The JAX ``init_net`` has no counterpart: the
constructor's ``seed`` draws the weights, whatever the device, the groups
or the kernel, so every rank of a run holds the same.  The kernel names are the port's (``csr``,
``csr_fused``); each rank builds its part's CSR layout once per run
(``PartTables.layout``), and every layer of every step shares it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.fused import PNALayerFused
from pna_tpu_torch.nn.gat import GATLayerCSR
from pna_tpu_torch.nn.layers import MLPReadout, dense, lecun_normal, zeros_init
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.parallel import collectives
from pna_tpu_torch.parallel.partition import (EdgePartition, halo_exchange,
                                              split_edges)

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')


class DistributedPNANet(nn.Module):
    """The flagship PNA net for one partitioned graph.

    ``graph_group`` (the graph axis' process group) and ``bn_group`` (the
    batch-norm statistics', the whole mesh) make it distributed: ``forward``
    then takes this rank's ``send_idx``/``send_mask``.  Without them it runs
    on one device (the oracle).  Node-level, it is trained against one
    target a node under a squared error (``loss``)."""

    loss = 'mse'

    def __init__(self, feat_dim: int, hidden_dim: int = 64,
                 out_dim: int = 64, n_layers: int = 4, towers: int = 4,
                 aggregators: Sequence[str] = AGGS,
                 scalers: Sequence[str] = SCALERS,
                 avg_d: Optional[Dict[str, float]] = None,
                 batch_norm: bool = True, residual: bool = True,
                 kernel: str = 'auto', overlap: bool = False,
                 edge_features: bool = False, edge_dim: int = 0,
                 node_level: bool = False, max_degree: int = 0,
                 graph_group=None, bn_group=None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        avg_d = avg_d or {'lin': 1.0, 'log': 1.0}
        self.kernel, self.overlap = kernel, overlap
        self.edge_features, self.node_level = edge_features, node_level
        self.graph_group = graph_group
        # flax Dense: lecun-normal kernel, zero bias
        self.embedding_h = dense(feat_dim, hidden_dim, lecun_normal,
                                 zeros_init, gen)
        if edge_features:
            self.embedding_e = dense(edge_dim, hidden_dim, lecun_normal,
                                     zeros_init, gen)
        self.layers = nn.ModuleList([
            PNALayerFused(hidden_dim,
                          out_dim if i == n_layers - 1 else hidden_dim,
                          aggregators, scalers, avg_d, towers=towers,
                          divide_input=True, batch_norm=batch_norm,
                          residual=residual, kernel=kernel,
                          edge_features=edge_features, edge_dim=hidden_dim,
                          max_degree=max_degree, bn_group=bn_group,
                          device='cpu', generator=gen)
            for i in range(n_layers)])
        self.MLP_layer = MLPReadout(out_dim, 1, generator=gen)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                send_idx: Optional[torch.Tensor] = None,
                send_mask: Optional[torch.Tensor] = None,
                split=None, e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None
                ) -> torch.Tensor:
        """h [Nl, feat_dim] -> the graph's prediction (a scalar) or, with
        ``node_level``, one per node [Nl].  ``split``: this rank's split
        tables (``PartTables.split``) with ``overlap``; ``layout``: the
        part's CSR layout for the ``csr`` backends (built here when not
        given)."""
        distributed = send_idx is not None
        if distributed and self.graph_group is None:
            raise ValueError("send_idx needs a net built with graph_group")
        h = self.embedding_h(h)
        if self.edge_features:
            e = self.embedding_e(e)
        for layer in self.layers:
            table = overlap = None
            if distributed:
                if self.overlap:
                    pending = halo_exchange(h, send_idx, send_mask,
                                            self.graph_group, wait=False)
                    overlap = (pending,) + tuple(split[:6])
                    if self.edge_features:
                        # the embedded edge features follow their edges
                        overlap += (e.index_select(0, split[6]),
                                    e.index_select(0, split[7]))
                else:
                    halo = halo_exchange(h, send_idx, send_mask,
                                         self.graph_group)
                    table = torch.cat([h, halo])
            h = layer(graph, h, e, layout, sender_table=table,
                      overlap=overlap)
        if self.node_level:
            return self.MLP_layer(h)[..., 0]                   # [Nl]
        # masked mean over every real node of the one graph
        m = graph.node_mask.to(h.dtype)[:, None]
        s, c = (h * m).sum(0), m.sum()
        if distributed:
            s = collectives.all_reduce(s, self.graph_group)
            c = collectives.all_reduce(c, self.graph_group)
        return self.MLP_layer(s / torch.clamp(c, min=1.0))[0]


class DistributedGATNet(nn.Module):
    """GAT (arXiv:1710.10903) for one partitioned graph, on the layout and
    halo exchange of ``DistributedPNANet``: L ``nn/gat.py::GATLayerCSR``
    layers, ``heads[l]`` heads of ``head_dim[l]`` each, concatenated with
    ELU but the last, whose heads are averaged into the logits of
    ``head_dim[-1]`` labels; ``residual_layers`` take the skip connection.
    The defaults are the paper's PPI model (section 3.3): 4 x 256, 4 x 256
    with the skip connection, 6 x 121 averaged.

    Before every layer the node features are exchanged
    (``partition.halo_exchange``) and the layer projects its sender table
    (the part's rows, then the halo's); without ``graph_group`` it runs on
    one device.  Node-level, on the ``csr`` layout only (``part_tables``
    builds it); the constructor's ``seed`` draws the weights.  It is
    trained against ``head_dim[-1]`` binary labels a node under a sigmoid
    cross-entropy (``loss``)."""

    loss = 'bce'
    kernel = 'csr'
    overlap = False
    edge_features = False
    node_level = True

    def __init__(self, feat_dim: int = 50, heads: Sequence[int] = (4, 4, 6),
                 head_dim: Sequence[int] = (256, 256, 121),
                 residual_layers: Sequence[int] = (1,), graph_group=None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if len(heads) != len(head_dim) or not heads:
            raise ValueError(f"heads {heads} and head_dim {head_dim}")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.graph_group = graph_group
        last, width, layers = len(heads) - 1, feat_dim, []
        for i, (h, f) in enumerate(zip(heads, head_dim)):
            layers.append(GATLayerCSR(
                width, h, f, concat=i < last, residual=i in residual_layers,
                elu=i < last, device='cpu', generator=gen))
            width = h * f
        self.layers = nn.ModuleList(layers)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                send_idx: Optional[torch.Tensor] = None,
                send_mask: Optional[torch.Tensor] = None,
                split=None, e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None
                ) -> torch.Tensor:
        """h [Nl, feat_dim] -> logits [Nl, head_dim[-1]].  ``layout``: the
        part's CSR layout (built here when not given); ``split`` and ``e``
        (``PartTables.net_kwargs``) must be None."""
        if split is not None or e is not None:
            raise ValueError("DistributedGATNet takes no overlap split and "
                             "no edge features")
        distributed = send_idx is not None
        if distributed and self.graph_group is None:
            raise ValueError("send_idx needs a net built with graph_group")
        if layout is None:
            layout = csr_bank.layout_from_graph(graph)
        for layer in self.layers:
            table = None
            if distributed:
                halo = halo_exchange(h, send_idx, send_mask,
                                     self.graph_group)
                table = torch.cat([h, halo])
            h = layer(h, layout, sender_table=table)
        return h


def _local_graph(nl: int, senders_l, receivers_l, edge_mask, node_mask,
                 edge_ptr=None, max_in_degree: int = 0) -> Graph:
    """One part's graph; ``node_feats`` is a zero-width placeholder that
    gives the node count (the layers take h separately)."""
    dev = senders_l.device
    return Graph(node_feats=torch.zeros((nl, 0), device=dev),
                 senders=senders_l.long(), receivers=receivers_l.long(),
                 node_graph_ids=torch.zeros(nl, dtype=torch.int64,
                                            device=dev),
                 node_mask=node_mask, edge_mask=edge_mask,
                 graph_mask=torch.ones(1, dtype=torch.bool, device=dev),
                 edge_ptr=edge_ptr, max_in_degree=max_in_degree)


def full_graph(part: EdgePartition, senders: np.ndarray,
               receivers: np.ndarray, efeats: Optional[np.ndarray] = None,
               sort_edges: bool = False) -> Graph:
    """The single-device oracle's graph over the same padded node space
    [P*Nl], on the CPU.

    ``senders``/``receivers`` are ORIGINAL node ids, relabelled here into
    the partition's order.  ``efeats`` [E, Fe] (original edge order) become
    the graph's ``edge_feats``, zero-padded.  ``sort_edges`` sorts the edges
    by receiver (stable) and sets ``edge_ptr``, the layout of the ``csr``
    backends; the edge features follow."""
    if part.node_order is not None:
        inv = part._positions()
        senders = inv[np.asarray(senders)]
        receivers = inv[np.asarray(receivers)]
    senders, receivers = np.asarray(senders), np.asarray(receivers)
    order = (np.argsort(receivers, kind='stable') if sort_edges
             else np.arange(len(senders)))
    n_pad = part.num_parts * part.nodes_per_part
    n = len(senders)
    e_pad = max(-(-n // 8) * 8, 8)
    s = np.zeros(e_pad, np.int64)
    r = np.zeros(e_pad, np.int64)
    s[:n], r[:n] = senders[order], receivers[order]
    em = np.zeros(e_pad, bool)
    em[:n] = True
    ef = None
    if efeats is not None:
        ef = np.zeros((e_pad, efeats.shape[1]), np.float32)
        ef[:n] = efeats[order]
        ef = torch.from_numpy(ef)
    edge_ptr = max_deg = None
    if sort_edges:
        # pad edges sit at the tail with receiver 0: edge_ptr counts only
        # the real ones
        edge_ptr = torch.from_numpy(np.searchsorted(
            r[:n], np.arange(n_pad + 1), side='left').astype(np.int32))
        max_deg = int(np.bincount(r[:n], minlength=1).max())
    return Graph(node_feats=torch.zeros((n_pad, 0)),
                 senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
                 node_graph_ids=torch.zeros(n_pad, dtype=torch.int64),
                 node_mask=torch.from_numpy(part.node_mask.reshape(-1)),
                 edge_mask=torch.from_numpy(em),
                 graph_mask=torch.ones(1, dtype=torch.bool),
                 edge_ptr=edge_ptr, edge_feats=ef,
                 max_in_degree=max_deg or 0)


def _const_tables(part: EdgePartition, net: DistributedPNANet,
                  efeats: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    """The static per-part tables a step reads, each stacked over the parts
    [P, ...], by name (``efeats``: ``part.scatter_edge_features``)."""
    tables = dict(senders=part.senders_local,
                  receivers=part.receivers_local, edge_mask=part.edge_mask,
                  send_idx=part.send_idx, send_mask=part.send_mask,
                  node_mask=part.node_mask)
    if part.edge_ptr is not None:
        tables['edge_ptr'] = part.edge_ptr
    if efeats is not None:
        tables['efeats'] = efeats
    if net.overlap:
        sp = split_edges(part)
        for f in ('senders_local', 'receivers_local', 'mask_local',
                  'senders_bound', 'receivers_bound', 'mask_bound',
                  'idx_local', 'idx_bound'):
            tables['split_' + f] = getattr(sp, f)
    return tables


@dataclass
class PartTables:
    """One rank's part, on its device: its graph, exchange tables, edge
    features, split tables (``overlap``) and CSR layout (``csr`` and
    ``csr_fused``, built once and shared by every layer and step)."""
    graph: Graph
    send_idx: torch.Tensor
    send_mask: torch.Tensor
    e: Optional[torch.Tensor] = None
    split: Optional[tuple] = None
    layout: Optional[csr_bank.CSRLayout] = None

    def net_kwargs(self, distributed: bool = True) -> dict:
        """The keyword arguments of ``DistributedPNANet.forward``."""
        kw = dict(split=self.split, e=self.e, layout=self.layout)
        if distributed:
            kw.update(send_idx=self.send_idx, send_mask=self.send_mask)
        return kw


def part_tables(part: EdgePartition, net, index: int,
                device, efeats: Optional[np.ndarray] = None) -> PartTables:
    """Part ``index``'s tables on ``device`` (the counterpart of placing
    ``_const_tables`` sharded over the graph axis and reading one shard)."""
    tables = _const_tables(part, net, efeats)
    row = {k: torch.as_tensor(np.ascontiguousarray(v[index])).to(device)
           for k, v in tables.items()}
    max_deg = 0
    if part.edge_ptr is not None:
        ptr = part.edge_ptr[index]
        max_deg = int(np.diff(ptr).max(initial=0))
    g = _local_graph(part.nodes_per_part, row['senders'], row['receivers'],
                     row['edge_mask'], row['node_mask'],
                     edge_ptr=row.get('edge_ptr'), max_in_degree=max_deg)
    split = None
    if net.overlap:
        split = tuple(row['split_' + f].long() if 'mask' not in f
                      else row['split_' + f]
                      for f in ('senders_local', 'receivers_local',
                                'mask_local', 'senders_bound',
                                'receivers_bound', 'mask_bound',
                                'idx_local', 'idx_bound'))
    layout = None
    if net.kernel in ('csr', 'csr_fused'):
        if g.edge_ptr is None:
            raise ValueError(f"kernel={net.kernel!r} needs a sorted "
                             "partition (sort_partition_edges)")
        layout = csr_bank.layout_from_graph(g)
    return PartTables(graph=g, send_idx=row['send_idx'],
                      send_mask=row['send_mask'], e=row.get('efeats'),
                      split=split, layout=layout)


def mesh_groups(mesh):
    """(data group, graph group, this rank's (data, graph) coordinate) of a
    ('data', 'graph') ``DeviceMesh``."""
    return (mesh.get_group('data'), mesh.get_group('graph'),
            (mesh.get_local_rank('data'), mesh.get_local_rank('graph')))


def make_distributed_train_step(part: EdgePartition, mesh,
                                net: DistributedPNANet,
                                optimizer: torch.optim.Optimizer,
                                efeats: Optional[np.ndarray] = None):
    """Returns ``(step, tables)``.

    ``step(feats, target) -> loss``: ``feats`` [Nl, F] is this rank's part of
    its data element's node features, ``target`` its scalar target; the
    squared error of the graph prediction, averaged over the data axis, is
    the objective, and ``loss`` its value (the same on every rank).  The
    net must have been built with the mesh's groups (``graph_group`` the
    graph axis', ``bn_group`` the world's).  ``tables`` is this rank's
    ``PartTables``."""
    data_group, _, (_, gi) = mesh_groups(mesh)
    d_data, d_graph = mesh.shape
    dev = next(net.parameters()).device
    tables = part_tables(part, net, gi, dev, efeats)
    scale = collectives.loss_scale(d_graph, d_data)

    def step(feats: torch.Tensor, target) -> float:
        net.train()
        optimizer.zero_grad(set_to_none=True)
        pred = net(tables.graph, feats, **tables.net_kwargs())
        loss = (pred - target) ** 2
        (loss * scale).backward()
        collectives.all_reduce_grads(net.parameters())
        optimizer.step()
        total = collectives.all_reduce(loss.detach(), data_group)
        return float(total) / d_data

    return step, tables
