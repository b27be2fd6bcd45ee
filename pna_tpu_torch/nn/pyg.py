"""The PyG variant of the PNA layers and the PyG MolHIV example net.

Counterpart of ``pna_tpu/nn/pyg.py``: ``PNAConvPyG``, ``PNAConvSimplePyG``
and ``PNANetPyGExample``, with the PyG numerics, which differ from the DGL
tower layer's (``nn/sparse.py``):

* pretrans concatenates (x_i, x_j[, enc(e)]), receiver first;
* the bank concatenates the aggregators (sum, mean, min, max, var, std) on
  the feature axis, then one block per scaler; each tower's messages get
  their own bank, [N, T, S*A*F];
* the scalers take the raw in-degree (0 guarded for the inverse scalers) and
  ``var`` is not relu-clamped (``std`` is);
* posttrans runs on cat(x, bank) per tower, and the towers are mixed by a
  plain Linear with no activation;
* no batch-norm, residual or dropout inside the conv: the example net applies
  them outside.

Dense layers have torch's Linear init and are named as the JAX ones
(``pre_nns_{t}_lin_{i}``, ``post_nns_{t}_lin_{i}``, ``post_nn_lin_{i}``,
``edge_encoder``, ``lin``; the example's ``node_emb``, ``conv_{i}``,
``bn_{i}`` and ``mlp_lin_{k}``), so ``weights.from_jax`` carries them.  On
the card the bank runs on the CSR kernels (K1/K2), by the rule of
``nn/sparse.py``; the towered messages go to K1 as [E, T*F] and come back
reordered to [N, T, A*F].
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.layers import (Dropout, dense, torch_linear_bias_init,
                                     torch_linear_init)
from pna_tpu_torch.nn.nets import AtomEncoder, PNANetHIV, _generator
from pna_tpu_torch.nn.sparse import MaskedBatchNorm, node_bank
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops.readout import readout
from pna_tpu_torch.ops.scalers import SCALERS
from pna_tpu_torch.ops.segment import gather_rows


def _torch_dense(in_size: int, out_size: int, gen) -> nn.Linear:
    return dense(in_size, out_size, torch_linear_init(),
                 torch_linear_bias_init(in_size), gen)


def _check(aggregators, scalers):
    bad = [a for a in aggregators if a not in csr_bank.AGGS]
    bad += [s for s in scalers if s not in SCALERS]
    if bad:
        raise ValueError(f"unsupported PyG aggregators or scalers: {bad}")


def _pyg_aggregate(graph: Graph, msg: torch.Tensor,
                   layout: csr_bank.CSRLayout, aggregators: Sequence[str],
                   scalers: Sequence[str], avg_deg: Dict[str, float]
                   ) -> torch.Tensor:
    """The PyG ``aggregate``: msg [E, ..., F] -> [N, ..., S*A*F]."""
    bank = node_bank(graph, msg, aggregators, layout, relu_clamp=False)
    deg = layout.deg.reshape(layout.deg.shape + (1,) * (bank.ndim - 1))
    return torch.cat([SCALERS[s](bank, deg, avg_deg) for s in scalers],
                     dim=-1)


class PNAConvPyG(nn.Module):
    """``PNAConv``: towers over the (optionally divided) input, pretrans on
    cat(x_i, x_j[, edge_encoder(e)]), the scaler-major bank, posttrans on
    cat(x, bank), a plain Linear ``lin`` mixing the towers."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_deg: Dict[str, float], *,
                 edge_dim: Optional[int] = None, towers: int = 1,
                 pre_layers: int = 1, post_layers: int = 1,
                 divide_input: bool = False, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check(aggregators, scalers)
        if divide_input and in_channels % towers:
            raise ValueError(f"in_channels {in_channels} not divisible by "
                             f"{towers}")
        if out_channels % towers:
            raise ValueError(f"out_channels {out_channels} not divisible by "
                             f"{towers}")
        device = resolve_device(device)
        gen = (torch.Generator().manual_seed(0) if generator is None
               else generator)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_deg = dict(avg_deg)
        self.towers, self.divide_input = towers, divide_input
        self.edge_dim, self.pre_layers = edge_dim, pre_layers
        self.post_layers = post_layers
        self.f_in = in_channels // towers if divide_input else in_channels
        f_out = out_channels // towers
        A, S = len(self.aggregators), len(self.scalers)
        if edge_dim is not None:
            self.edge_encoder = _torch_dense(edge_dim, self.f_in, gen)
        for t in range(towers):
            width = (3 if edge_dim is not None else 2) * self.f_in
            for i in range(pre_layers):
                setattr(self, f'pre_nns_{t}_lin_{i}',
                        _torch_dense(width, self.f_in, gen))
                width = self.f_in
            width = (A * S + 1) * self.f_in
            for i in range(post_layers):
                setattr(self, f'post_nns_{t}_lin_{i}',
                        _torch_dense(width, f_out, gen))
                width = f_out
        self.lin = _torch_dense(out_channels, out_channels, gen)
        self.to(device)

    def _mlp(self, x, prefix, n):
        for i in range(n):
            if i > 0:
                x = F.relu(x)
            x = getattr(self, f'{prefix}_lin_{i}')(x)
        return x

    def forward(self, graph: Graph, x: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None) -> torch.Tensor:
        """x [N, in_channels], edge_attr [E, edge_dim] -> [N,
        out_channels]."""
        if layout is None:
            layout = csr_bank.layout_from_graph(graph)
        N, T, fi = x.shape[0], self.towers, self.f_in
        xt = (x.reshape(N, T, fi) if self.divide_input
              else x[:, None, :].expand(N, T, fi))
        parts = [gather_rows(xt, graph.receivers),         # receiver first
                 gather_rows(xt, graph.senders)]
        if self.edge_dim is not None:
            e = self.edge_encoder(edge_attr)
            parts.append(e[:, None, :].expand(e.shape[0], T, fi))
        h = torch.cat(parts, dim=-1)                      # [E, T, (2|3)*fi]
        msg = torch.stack([self._mlp(h[:, t], f'pre_nns_{t}', self.pre_layers)
                           for t in range(T)], dim=1)     # [E, T, fi]
        bank = _pyg_aggregate(graph, msg, layout, self.aggregators,
                              self.scalers, self.avg_deg)  # [N, T, S*A*fi]
        out = torch.cat([xt, bank], dim=-1)
        out = torch.cat([self._mlp(out[:, t], f'post_nns_{t}',
                                   self.post_layers) for t in range(T)],
                        dim=-1)                           # [N, out_channels]
        return self.lin(out)


class PNAConvSimplePyG(nn.Module):
    """``PNAConvSimple``: the scaler-major bank of the raw messages x_j
    (no self concat), then ``post_nn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_deg: Dict[str, float], *, post_layers: int = 1,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check(aggregators, scalers)
        device = resolve_device(device)
        gen = (torch.Generator().manual_seed(0) if generator is None
               else generator)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_deg = dict(avg_deg)
        self.post_layers = post_layers
        width = len(aggregators) * len(scalers) * in_channels
        for i in range(post_layers):
            setattr(self, f'post_nn_lin_{i}',
                    _torch_dense(width, out_channels, gen))
            width = out_channels
        self.to(device)

    def forward(self, graph: Graph, x: torch.Tensor,
                layout: Optional[csr_bank.CSRLayout] = None) -> torch.Tensor:
        """x [N, in_channels] -> [N, out_channels]."""
        if layout is None:
            layout = csr_bank.layout_from_graph(graph)
        o = _pyg_aggregate(graph, gather_rows(x, graph.senders), layout,
                           self.aggregators, self.scalers, self.avg_deg)
        for i in range(self.post_layers):
            if i > 0:
                o = F.relu(o)
            o = getattr(self, f'post_nn_lin_{i}')(o)
        return o


class PNANetPyGExample(nn.Module):
    """The PyG MolHIV example net: AtomEncoder(hidden) -> n_layers x
    [PNAConvSimple -> masked batch-norm -> relu -> residual -> dropout] ->
    mean readout -> MLP (hidden -> 40 -> 20 -> 1, relu between)."""

    loss = staticmethod(PNANetHIV.loss)

    def __init__(self, avg_deg: Dict[str, float], hidden: int = 80,
                 n_layers: int = 4,
                 aggregators: Sequence[str] = ('mean', 'min', 'max', 'std'),
                 scalers: Sequence[str] = ('identity', 'amplification',
                                           'attenuation'),
                 dropout: float = 0.3, *, device: DeviceLike = None,
                 seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.generator = _generator(generator, device, seed)
        gen = torch.Generator().manual_seed(seed)
        self.n_layers = n_layers
        self.node_emb = AtomEncoder(hidden, generator=gen)
        for i in range(n_layers):
            setattr(self, f'conv_{i}', PNAConvSimplePyG(
                hidden, hidden, aggregators, scalers, avg_deg, device='cpu',
                generator=gen))
            setattr(self, f'bn_{i}', MaskedBatchNorm(hidden))
        self.dropout = Dropout(dropout, self.generator)
        self.mlp_lin_0 = _torch_dense(hidden, 40, gen)
        self.mlp_lin_1 = _torch_dense(40, 20, gen)
        self.mlp_lin_2 = _torch_dense(20, 1, gen)
        self.to(device)

    def forward(self, graph: Graph, x_idx: torch.Tensor) -> torch.Tensor:
        """x_idx [N, 9] OGB atom features -> logits [G_pad, 1]."""
        x = self.node_emb(x_idx)
        layout = csr_bank.layout_from_graph(graph)
        for i in range(self.n_layers):
            h = getattr(self, f'conv_{i}')(graph, x, layout)
            h = F.relu(getattr(self, f'bn_{i}')(h, graph.node_mask))
            x = self.dropout(h + x)
        hg = readout('mean', graph, x)
        hg = F.relu(self.mlp_lin_0(hg))
        hg = F.relu(self.mlp_lin_1(hg))
        return self.mlp_lin_2(hg)
