"""Sparse (edge-list) PNA, GCN, GAT and GIN layers and masked batch
normalisation.

Counterpart of ``pna_tpu/nn/sparse.py``: ``aggregate_bank``,
``PNATowerSparse``, ``PNALayerSparse``, ``PNASimpleLayerSparse``,
``MaskedBatchNorm``, ``GCNLayerSparse``, ``GATLayerSparse`` and
``GINLayerSparse``.  The GCN, GAT and GIN layers run on the plain segment
ops of ``ops/segment.py`` (``segment_sum``, ``segment_softmax_weights``), as
the JAX layers run on the JAX package's plain segment ops, on the card too:
they do not go through the CSR bank.

The bank concatenates the aggregators on the feature axis, then one block
per scaler, as the JAX bank does.  On the card the aggregators the CSR
kernels compute (``csr_bank.AGGS``: mean, sum, max, min, var, std) go
through ``csr_raw_bank`` (K1 forward, K2 backward) in one call, given the
batch's CSR layout; the others (identity, normalised_mean, softmax, softmin,
moments), every aggregator on the CPU, and every aggregator of a batch
without ``edge_ptr`` take the segment form of ``ops/aggregators.py``, which
is also the plain version the card is held against.  The scalers take the
raw in-degree of the receiver (0 on pad and isolated nodes).  The choice
follows the batch's ``edge_ptr``, the aggregator set and the device only.
``bank_layout`` gives the CSR layout a batch's bank needs, or None.

Pretrans concatenates (src, dst[, edge]), the DGL tower's order; ``identity``
aggregates the message a node sends itself (pretrans of (h, h[, 0])).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.layers import (MLP, Dropout, FCLayer, dense,
                                     torch_linear_init, xavier_uniform_gain,
                                     zeros_init)
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops import segment as seg
from pna_tpu_torch.ops.aggregators import SEGMENT_AGGREGATORS, SegmentCtx
from pna_tpu_torch.ops.scalers import SCALERS
from pna_tpu_torch.parallel import collectives


def bank_layout(graph: Graph, max_degree: int = 0
                ) -> Optional[csr_bank.CSRLayout]:
    """The CSR layout ``aggregate_bank`` takes for this batch: None when the
    batch has no ``edge_ptr``."""
    if graph.edge_ptr is None:
        return None
    return csr_bank.layout_from_graph(graph, max_degree)


def node_bank(graph: Graph, msg: torch.Tensor, aggregators: Sequence[str],
              layout: Optional[csr_bank.CSRLayout],
              self_msg: Optional[torch.Tensor] = None,
              relu_clamp: bool = True) -> torch.Tensor:
    """The aggregators over the edge messages: msg [E, ..., F] -> [N, ...,
    A*F], aggregators concatenated on the feature axis in caller order.
    ``layout`` is the batch's CSR layout (None: the segment form for every
    aggregator).  ``relu_clamp=False`` leaves 'var' unclamped (PyG's
    var)."""
    parts = {}
    kern = ([a for a in aggregators if a in csr_bank.AGGS]
            if msg.is_cuda and layout is not None else [])
    if kern:
        z = csr_bank.csr_raw_bank(msg.reshape(msg.shape[0], -1), layout,
                                  kern, relu_clamp)      # [N, K, prod(...)]
        z = z.reshape((z.shape[0], len(kern)) + msg.shape[1:])
        parts = dict(zip(kern, z.unbind(1)))
    rest = [a for a in aggregators if a not in parts]
    if rest:
        ctx = SegmentCtx.create(msg, graph.receivers, graph.n_node_pad,
                                mask=graph.edge_mask, senders=graph.senders,
                                self_msg=self_msg)
        for a in rest:
            parts[a] = (seg.segment_var(msg, ctx.receivers, ctx.num_nodes,
                                        ctx.mask, ctx.count, relu_clamp=False)
                        if a == 'var' and not relu_clamp
                        else SEGMENT_AGGREGATORS[a](ctx))
    return torch.cat([parts[a] for a in aggregators], dim=-1)


def aggregate_bank(graph: Graph, msg: torch.Tensor,
                   aggregators: Sequence[str], scalers: Sequence[str],
                   avg_d: Dict[str, float],
                   self_msg: Optional[torch.Tensor] = None,
                   layout: Optional[csr_bank.CSRLayout] = None
                   ) -> torch.Tensor:
    """Aggregator x scaler cross-product over edge messages: msg [E, F] ->
    [N, S*A*F].  ``layout`` is the batch's CSR layout (built here when not
    given and the batch has ``edge_ptr``)."""
    if layout is None:
        layout = bank_layout(graph)
    h = node_bank(graph, msg, aggregators, layout, self_msg)
    deg = layout.deg if layout is not None else graph.in_degrees(msg.dtype)
    return torch.cat([SCALERS[s](h, deg, avg_d) for s in scalers], dim=-1)


def check_bank(aggregators: Sequence[str], scalers: Sequence[str]) -> None:
    bad = [a for a in aggregators if a not in SEGMENT_AGGREGATORS]
    bad += [s for s in scalers if s not in SCALERS]
    if bad:
        raise ValueError(f"unknown aggregators or scalers: {bad}")


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the node axis that ignores padded rows.

    Training mode normalises with the masked batch statistics, computed as
    shifted moments about the running mean (no E[x^2] - E[x]^2 cancellation
    when |mean| >> std), and updates the running mean and the unbiased running
    variance with momentum 0.1; eval mode uses the running statistics.

    ``group`` (a process group; the JAX ``axis_name``): the count and the two
    moment sums are summed over its ranks before the mean and variance
    (``parallel/collectives.all_reduce``, whose backward sums too), so a
    partitioned batch normalises with the statistics of the whole.  The
    shift, the running mean, is the same on every rank.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, group=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            shift = self.running_mean.clone()   # updated in place below
            xc = x - shift
            m = mask.to(x.dtype)[:, None]
            n, s1, s2 = m.sum(), (xc * m).sum(0), (xc * xc * m).sum(0)
            if self.group is not None:
                f = s1.shape[0]
                tot = collectives.all_reduce(torch.cat([n.reshape(1), s1, s2]),
                                 self.group)
                n, s1, s2 = tot[0], tot[1:f + 1], tot[f + 1:]
            n = torch.clamp(n, min=1.0)
            dmean = s1 / n
            mean = shift + dmean
            var = torch.clamp(s2 / n - dmean * dmean, min=0.0)
            with torch.no_grad():
                # running_var takes the unbiased estimate, as torch does
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None else generator


class PNATowerSparse(nn.Module):
    """One PNA tower on the edge list: pretrans MLP on (src, dst[, e]) ->
    bank -> posttrans MLP on (h, bank) -> graph-norm -> masked batch-norm ->
    dropout."""

    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, dropout: float = 0.0,
                 graph_norm: bool = False, batch_norm: bool = False,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 edge_features: bool = False, edge_dim: int = 0,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_bank(aggregators, scalers)
        device = resolve_device(device)
        gen = _generator(generator)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d = dict(avg_d)
        self.graph_norm, self.edge_features = graph_norm, edge_features
        self.edge_dim = edge_dim if edge_features else 0
        A, S = len(self.aggregators), len(self.scalers)
        self.pretrans = MLP(2 * in_dim + self.edge_dim, in_dim, in_dim,
                            pretrans_layers, generator=gen)
        self.posttrans = MLP((A * S + 1) * in_dim, out_dim, out_dim,
                             posttrans_layers, generator=gen)
        self.batchnorm_h = MaskedBatchNorm(out_dim) if batch_norm else None
        self.dropout = Dropout(dropout, dropout_generator)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None) -> torch.Tensor:
        """h [N, in_dim], e [E, edge_dim] -> [N, out_dim]."""
        extra = [e] if self.edge_features else []
        msg = self.pretrans(torch.cat([seg.gather_rows(h, graph.senders),
                                       seg.gather_rows(h, graph.receivers,
                                                       graph.edge_ptr)]
                                      + extra, dim=-1))
        self_msg = None
        if 'identity' in self.aggregators:
            pad = ([h.new_zeros(h.shape[0], self.edge_dim)]
                   if self.edge_features else [])
            self_msg = self.pretrans(torch.cat([h, h] + pad, dim=-1))
        agg = aggregate_bank(graph, msg, self.aggregators, self.scalers,
                             self.avg_d, self_msg=self_msg, layout=layout)
        out = self.posttrans(torch.cat([h, agg], dim=-1))
        if self.graph_norm:
            out = out * graph.snorm_n
        if self.batchnorm_h is not None:
            out = self.batchnorm_h(out, graph.node_mask)
        return self.dropout(out)


class PNALayerSparse(nn.Module):
    """PNA layer: ``towers`` separate towers (``tower_{t}``), each on its
    slice of h (``divide_input``) or on all of it, concatenated -> the
    ``mixing`` FCLayer (LeakyReLU) -> the residual when in_dim == out_dim."""

    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, dropout: float = 0.0,
                 graph_norm: bool = False, batch_norm: bool = False,
                 towers: int = 1, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, divide_input: bool = True,
                 residual: bool = False, edge_features: bool = False,
                 edge_dim: int = 0, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if divide_input and in_dim % towers:
            raise ValueError(f"in_dim {in_dim} not divisible by {towers}")
        if out_dim % towers:
            raise ValueError(f"out_dim {out_dim} not divisible by {towers}")
        device = resolve_device(device)
        gen = _generator(generator)
        self.towers, self.divide_input = towers, divide_input
        self.input_tower = in_dim // towers if divide_input else in_dim
        self.residual = residual and in_dim == out_dim
        for t in range(towers):
            setattr(self, f'tower_{t}', PNATowerSparse(
                self.input_tower, out_dim // towers, aggregators, scalers,
                avg_d, dropout=dropout, graph_norm=graph_norm,
                batch_norm=batch_norm, pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers,
                edge_features=edge_features, edge_dim=edge_dim,
                device='cpu', generator=gen,
                dropout_generator=dropout_generator))
        self.mixing = FCLayer(out_dim, out_dim, activation='leakyrelu',
                              generator=gen)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None) -> torch.Tensor:
        """h [N, in_dim], e [E, edge_dim] -> [N, out_dim]; ``layout`` is
        ``bank_layout(graph)``, shared by every tower (built here when not
        given)."""
        if layout is None:
            layout = bank_layout(graph)
        w = self.input_tower
        outs = [getattr(self, f'tower_{t}')(
            graph, h[:, t * w:(t + 1) * w] if self.divide_input else h, e,
            layout) for t in range(self.towers)]
        out = self.mixing(torch.cat(outs, dim=-1))
        return h + out if self.residual else out


class PNASimpleLayerSparse(nn.Module):
    """Simplified PNA layer: the bank over the raw messages h[senders], no
    pretrans, towers or edge features; posttrans MLP on the (A*S)*in_dim
    bank -> masked batch-norm -> ReLU -> residual -> dropout."""

    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, dropout: float = 0.0,
                 batch_norm: bool = False, residual: bool = False,
                 posttrans_layers: int = 1, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_bank(aggregators, scalers)
        if 'identity' in aggregators:
            raise ValueError("the simple layer has no self message for "
                             "'identity'")
        device = resolve_device(device)
        gen = _generator(generator)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d = dict(avg_d)
        self.residual = residual
        A, S = len(self.aggregators), len(self.scalers)
        self.posttrans = MLP(A * S * in_dim, out_dim, out_dim,
                             posttrans_layers, generator=gen)
        self.batchnorm_h = MaskedBatchNorm(out_dim) if batch_norm else None
        self.dropout = Dropout(dropout, dropout_generator)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                layout: Optional[csr_bank.CSRLayout] = None) -> torch.Tensor:
        """h [N, in_dim] -> [N, out_dim]."""
        agg = aggregate_bank(graph, seg.gather_rows(h, graph.senders),
                             self.aggregators, self.scalers, self.avg_d,
                             layout=layout)
        out = self.posttrans(agg)
        if self.batchnorm_h is not None:
            out = self.batchnorm_h(out, graph.node_mask)
        out = F.relu(out)
        if self.residual:
            out = h + out
        return self.dropout(out)


class GCNLayerSparse(nn.Module):
    """GCN on the edge list: XW (``linear``, no bias, torch's Linear init)
    -> sum over in-edges weighted 1/sqrt(d_i d_j) with d the in-degree
    plus the self-loop, plus the self-loop's own term -> bias ``b`` (0 at
    the start) -> LeakyReLU."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(generator)
        self.linear = dense(in_dim, out_dim, torch_linear_init(), zeros_init,
                            gen)
        self.linear.bias = None
        self.b = nn.Parameter(torch.zeros(out_dim)) if bias else None
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor) -> torch.Tensor:
        xw = self.linear(h)
        r = torch.rsqrt(graph.in_degrees(xw.dtype) + 1.0)
        w = (seg.gather_rows(r, graph.senders)
             * seg.gather_rows(r, graph.receivers, graph.edge_ptr))
        out = seg.segment_sum(seg.gather_rows(xw, graph.senders) * w[:, None],
                              graph.receivers, graph.n_node_pad,
                              graph.edge_mask)
        out = out + xw * (r * r)[:, None]
        if self.b is not None:
            out = out + self.b
        return F.leaky_relu(out, negative_slope=0.01)


class GATLayerSparse(nn.Module):
    """GAT on the edge list, ``nheads`` heads concatenated: per head, logits
    LeakyReLU(a_dst . hW_i + a_src . hW_j) of each edge j -> i, softmax over
    the in-edges, the weighted sum of hW_j, ELU when ``activation``.
    ``W_{k}`` [in, out/nheads] and ``a_{k}`` [2 out/nheads, 1] are
    xavier-uniform (gain 1), in the flax layout."""

    def __init__(self, in_dim: int, out_dim: int, alpha: float = 0.2,
                 nheads: int = 1, activation: bool = True,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if out_dim % nheads:
            raise ValueError(f"out_dim {out_dim} not divisible by {nheads} "
                             "heads")
        device = resolve_device(device)
        gen = _generator(generator)
        self.alpha, self.nheads, self.activation = alpha, nheads, activation
        f_head = out_dim // nheads
        init = xavier_uniform_gain(1.0)
        for i in range(nheads):
            setattr(self, f'W_{i}', nn.Parameter(init((in_dim, f_head), gen)))
            setattr(self, f'a_{i}', nn.Parameter(init((2 * f_head, 1), gen)))
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(self.nheads):
            W, a = getattr(self, f'W_{i}'), getattr(self, f'a_{i}')
            f_head = W.shape[1]
            hw = h @ W
            logits = F.leaky_relu(
                seg.gather_rows(hw @ a[:f_head, 0], graph.receivers,
                                graph.edge_ptr)
                + seg.gather_rows(hw @ a[f_head:, 0], graph.senders),
                negative_slope=self.alpha)
            att = seg.segment_softmax_weights(
                logits[:, None], graph.receivers, graph.n_node_pad,
                graph.edge_mask)
            out = seg.segment_sum(seg.gather_rows(hw, graph.senders) * att,
                                  graph.receivers, graph.n_node_pad,
                                  graph.edge_mask)
            outs.append(F.elu(out) if self.activation else out)
        return torch.cat(outs, dim=-1)


class GINLayerSparse(nn.Module):
    """GIN on the edge list: (1 + eps) h + the sum over in-edges -> the
    ``post_transformation`` MLP (ReLU between and last, batch-norm over
    every node row after all but the last layer); eps starts at 0.1."""

    def __init__(self, in_dim: int, out_dim: int, fc_layers: int = 2,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(generator)
        self.epsilon = nn.Parameter(torch.full((1,), 0.1))
        self.post_transformation = MLP(
            in_dim, max(in_dim, out_dim), out_dim, fc_layers,
            mid_activation='relu', last_activation='relu', mid_b_norm=True,
            last_b_norm=False, generator=gen)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor) -> torch.Tensor:
        nbr = seg.segment_sum(seg.gather_rows(h, graph.senders),
                              graph.receivers, graph.n_node_pad,
                              graph.edge_mask)
        return self.post_transformation(nbr + (1.0 + self.epsilon[0]) * h)
