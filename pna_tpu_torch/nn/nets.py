"""The real-world benchmark nets on the fused PNA layer.

Counterpart of ``pna_tpu/nn/nets.py``:

* ``PNANetMolecules`` (ZINC graph regression): atom-type embedding ->
  in_feat_dropout -> (L-1) x PNALayerFused(hidden -> hidden,
  divide_input_first) + a last PNALayerFused(-> out_dim, divide_input_last),
  with an optional GRU shared between layers (none after the last) -> graph
  readout -> MLPReadout(out_dim, 1), with a masked L1 loss.  Edge features,
  when on, are a bond-type embedding.
* ``PNANetSuperpixels`` (MNIST/CIFAR10 superpixel classification): the same
  stack on ``nn.Linear`` embeddings of the float node (and edge) features,
  MLPReadout(out_dim, n_classes), masked cross-entropy.

The CSR layout of a batch is built once and shared by every layer;
``kernel`` (``'csr'`` or ``'csr_fused'``) and ``compute_dtype`` (float32 or
bfloat16) reach every layer, as in the JAX nets.  Weights are drawn from a
CPU generator seeded with ``seed``; dropout masks from ``generator``, a
generator on the net's device (one seeded with ``seed`` when not given),
shared by every dropout of the net: ``net.generator``.

Not ported: the unfused tower layers (``fused_towers=False``,
``PNALayerSparse``: ROADMAP Queue 1 item 10) and ``remat`` (item 6), which
raise ``NotImplementedError``; ``PNANetHIV`` (item 10).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.fused import PNALayerFused, check_backend
from pna_tpu_torch.nn.layers import (Dropout, GRUUpdate, MLPReadout, dense,
                                     torch_linear_bias_init,
                                     torch_linear_init)
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops.readout import readout


class _PNAStack(nn.Module):
    """What both nets share: the conv stack with its optional GRU, the
    readout and the MLP readout, built on the CPU from ``gen``."""

    def _build_stack(self, hidden_dim, out_dim, n_layers, aggregators,
                     scalers, avg_d, readout_type, dropout, graph_norm,
                     batch_norm, residual, towers, divide_input_first,
                     divide_input_last, edge_feat, edge_dim,
                     pretrans_layers, posttrans_layers, gru_enable,
                     fused_towers, kernel, max_degree, compute_dtype,
                     n_out, gen):
        if not fused_towers:
            raise NotImplementedError(
                "fused_towers=False (PNALayerSparse) is not ported yet: "
                "ROADMAP Queue 1 item 10")
        check_backend(kernel, compute_dtype)
        self.edge_feat, self.readout_type = edge_feat, readout_type
        self.max_degree = max_degree
        layers = []
        for i in range(n_layers):
            last = i == n_layers - 1
            layers.append(PNALayerFused(
                hidden_dim, out_dim if last else hidden_dim,
                aggregators, scalers, avg_d, graph_norm=graph_norm,
                batch_norm=batch_norm, towers=towers,
                divide_input=(divide_input_last if last
                              else divide_input_first),
                residual=residual, edge_features=edge_feat,
                edge_dim=edge_dim, dropout=dropout,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers, kernel=kernel,
                max_degree=max_degree, compute_dtype=compute_dtype,
                device='cpu', generator=gen,
                dropout_generator=self.generator))
        self.layers = nn.ModuleList(layers)
        self.gru = GRUUpdate(hidden_dim, gen) if gru_enable else None
        self.MLP_layer = MLPReadout(out_dim, n_out, generator=gen)

    def _stack(self, graph: Graph, h: torch.Tensor,
               e: Optional[torch.Tensor]) -> torch.Tensor:
        layout = csr_bank.layout_from_graph(graph, self.max_degree)
        for i, layer in enumerate(self.layers):
            h_t = layer(graph, h, e, layout)
            if self.gru is not None and i < len(self.layers) - 1:
                h_t = self.gru(h, h_t)
            h = h_t
        return self.MLP_layer(readout(self.readout_type, graph, h))


def _generator(generator, device, seed):
    if generator is None:
        return torch.Generator(device=device).manual_seed(seed)
    if generator.device.type != device.type:
        raise ValueError(f"dropout generator on {generator.device}, net on "
                         f"{device}")
    return generator


class PNANetMolecules(_PNAStack):
    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int, out_dim: int, n_layers: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, readout_type: str = 'sum',
                 in_feat_dropout: float = 0.0, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, towers: int = 1,
                 divide_input_first: bool = True,
                 divide_input_last: bool = True, edge_feat: bool = False,
                 edge_dim: int = 0, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, gru_enable: bool = False,
                 fused_towers: bool = True, remat: bool = False,
                 kernel: str = 'csr', max_degree: int = 0,
                 compute_dtype=None, device: DeviceLike = None,
                 seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat:
            raise NotImplementedError("remat is not ported yet: ROADMAP "
                                      "Queue 1 item 6")
        device = resolve_device(device)
        self.generator = _generator(generator, device, seed)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_h = nn.Embedding(num_atom_type, hidden_dim,
                                        _weight=torch.randn(
                                            num_atom_type, hidden_dim,
                                            generator=gen))
        self.in_feat_dropout = Dropout(in_feat_dropout, self.generator)
        if edge_feat:
            self.embedding_e = nn.Embedding(num_bond_type, edge_dim,
                                            _weight=torch.randn(
                                                num_bond_type, edge_dim,
                                                generator=gen))
        self._build_stack(hidden_dim, out_dim, n_layers, aggregators,
                          scalers, avg_d, readout_type, dropout, graph_norm,
                          batch_norm, residual, towers, divide_input_first,
                          divide_input_last, edge_feat, edge_dim,
                          pretrans_layers, posttrans_layers, gru_enable,
                          fused_towers, kernel, max_degree, compute_dtype,
                          1, gen)
        self.to(device)

    def forward(self, graph: Graph, h_idx: torch.Tensor,
                e_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h_idx [N] atom types, e_idx [E] bond types -> scores [G_pad, 1].
        Batch-norm statistics and dropout follow ``self.training``."""
        h = self.in_feat_dropout(self.embedding_h(h_idx))
        e = self.embedding_e(e_idx) if self.edge_feat else None
        return self._stack(graph, h, e)

    @staticmethod
    def loss(scores: torch.Tensor, targets: torch.Tensor,
             graph_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """L1 loss, masked over real graphs."""
        err = torch.abs(scores.squeeze(-1) - targets)
        if graph_mask is not None:
            m = graph_mask.to(err.dtype)
            return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
        return torch.mean(err)


class PNANetSuperpixels(_PNAStack):
    def __init__(self, in_dim: int, in_dim_edge: int, hidden_dim: int,
                 out_dim: int, n_classes: int, n_layers: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, readout_type: str = 'sum',
                 dropout: float = 0.0, graph_norm: bool = True,
                 batch_norm: bool = True, residual: bool = True,
                 towers: int = 1, divide_input_first: bool = True,
                 divide_input_last: bool = True, edge_feat: bool = False,
                 edge_dim: int = 0, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, gru_enable: bool = False,
                 fused_towers: bool = True, kernel: str = 'csr',
                 max_degree: int = 0, compute_dtype=None,
                 device: DeviceLike = None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.generator = _generator(generator, device, seed)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_h = dense(in_dim, hidden_dim, torch_linear_init(),
                                 torch_linear_bias_init(in_dim), gen)
        if edge_feat:
            self.embedding_e = dense(in_dim_edge, edge_dim,
                                     torch_linear_init(),
                                     torch_linear_bias_init(in_dim_edge), gen)
        self._build_stack(hidden_dim, out_dim, n_layers, aggregators,
                          scalers, avg_d, readout_type, dropout, graph_norm,
                          batch_norm, residual, towers, divide_input_first,
                          divide_input_last, edge_feat, edge_dim,
                          pretrans_layers, posttrans_layers, gru_enable,
                          fused_towers, kernel, max_degree, compute_dtype,
                          n_classes, gen)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h [N, in_dim] node features, e [E, in_dim_edge] edge features ->
        logits [G_pad, n_classes]."""
        h = self.embedding_h(h)
        e = self.embedding_e(e) if self.edge_feat else None
        return self._stack(graph, h, e)

    @staticmethod
    def loss(logits: torch.Tensor, labels: torch.Tensor,
             graph_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-entropy, masked over real graphs."""
        nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                            labels.long()[:, None]).squeeze(-1)
        if graph_mask is not None:
            m = graph_mask.to(nll.dtype)
            return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
        return torch.mean(nll)
