"""The real-world benchmark nets.

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
* ``PNANetHIV`` (OGB MolHIV classification): ``AtomEncoder`` -> in-feature
  dropout -> L x PNASimpleLayerSparse -> readout -> MLPReadout(out_dim, 1),
  masked BCE-with-logits.

``fused_towers=True`` (the default) stacks ``PNALayerFused``; False stacks
``PNALayerSparse`` (separate towers, float32 only: ``kernel`` and
``max_degree`` do not reach them, as in the JAX nets).  ``kernel`` (any
backend of ``nn/fused.py``; the port's default is ``'csr'`` where the JAX
nets' is ``'auto'``) and ``compute_dtype`` (float32 or bfloat16) reach every
fused layer.  The CSR layout of a batch is built once per forward and shared
by every layer, where the batch has ``edge_ptr``.

``remat=True`` (``PNANetMolecules``, fused layers) recomputes each layer in
the backward pass (``torch.utils.checkpoint``, non-reentrant), as the JAX
net's ``nn.remat`` does: the saved residuals shrink to the layers' inputs.
The recompute repeats the forward exactly: the dropout generator is set
back to its state at the layer's forward and the batch-norm running
statistics to theirs (the shift the masked batch norm starts from), and
both are restored afterwards, so the generator advances and the statistics
move once per step, as without remat.  The recompute launches the layer's
forward kernels (K1 or K3) a second time.

Weights are drawn from a CPU generator seeded with ``seed``; dropout masks
from ``generator``, a generator on the net's device (one seeded with
``seed`` when not given), shared by every dropout of the net:
``net.generator``.  ``AtomEncoder`` and ``BondEncoder`` sum one embedding per
OGB feature column (submodules ``emb_{i}``, xavier-uniform).  Every embedding
is looked up as a row gather of its weight (``segment.gather_rows``), whose
backward on the card is the deterministic row sum.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.fused import (PNALayerFused, backend_layout,
                                   check_backend, resolve_backend)
from pna_tpu_torch.nn.layers import (Dropout, GRUUpdate, MLPReadout, dense,
                                     torch_linear_bias_init,
                                     torch_linear_init, xavier_uniform_gain)
from pna_tpu_torch.nn.sparse import (PNALayerSparse, PNASimpleLayerSparse,
                                    bank_layout)
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops.readout import readout
from pna_tpu_torch.ops.segment import gather_rows

# OGB molecular feature cardinalities (ogb.utils.features
# get_atom_feature_dims / get_bond_feature_dims)
OGB_ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
OGB_BOND_FEATURE_DIMS = (5, 6, 2)


def _lookup(emb: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
    """``emb(idx)`` as a row gather of its weight (``gather_rows``): the
    card's embedding backward adds the rows' gradients in an order that
    changes from run to run, the gather's backward in a fixed one."""
    out = gather_rows(emb.weight, idx.reshape(-1))
    return out.reshape(idx.shape + out.shape[1:])


class AtomEncoder(nn.Module):
    """OGB AtomEncoder: the sum of one embedding per feature column,
    ``emb_{i}`` [dims[i], emb_dim], xavier-uniform."""

    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = OGB_ATOM_FEATURE_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_cols = len(feature_dims)
        for i, dim in enumerate(feature_dims):
            setattr(self, f'emb_{i}', nn.Embedding(
                dim, emb_dim, _weight=xavier_uniform_gain(1.0)(
                    (dim, emb_dim), generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., n_cols] integer features -> [..., emb_dim]."""
        out = 0
        for i in range(self.n_cols):
            out = out + _lookup(getattr(self, f'emb_{i}'), x[..., i])
        return out


class BondEncoder(AtomEncoder):
    """OGB BondEncoder: AtomEncoder over the bond feature columns."""

    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = OGB_BOND_FEATURE_DIMS,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, feature_dims, generator)


class _PNAStack(nn.Module):
    """What both nets share: the conv stack with its optional GRU, the
    readout and the MLP readout, built on the CPU from ``gen``."""

    def _build_stack(self, hidden_dim, out_dim, n_layers, aggregators,
                     scalers, avg_d, readout_type, dropout, graph_norm,
                     batch_norm, residual, towers, divide_input_first,
                     divide_input_last, edge_feat, edge_dim,
                     pretrans_layers, posttrans_layers, gru_enable,
                     fused_towers, kernel, max_degree, compute_dtype,
                     n_out, gen, remat=False):
        check_backend(kernel, compute_dtype)
        if not fused_towers and compute_dtype not in (None, torch.float32):
            raise ValueError("fused_towers=False runs in float32 only")
        self.edge_feat, self.readout_type = edge_feat, readout_type
        self.max_degree, self.fused_towers = max_degree, fused_towers
        # as the JAX net, remat applies to fused layers only
        self.remat = remat and fused_towers
        layers = []
        for i in range(n_layers):
            last = i == n_layers - 1
            common = dict(
                graph_norm=graph_norm, batch_norm=batch_norm, towers=towers,
                divide_input=(divide_input_last if last
                              else divide_input_first),
                residual=residual, edge_features=edge_feat,
                edge_dim=edge_dim, dropout=dropout,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers, device='cpu',
                generator=gen, dropout_generator=self.generator)
            if not fused_towers:
                layer = PNALayerSparse(
                    hidden_dim, out_dim if last else hidden_dim,
                    aggregators, scalers, avg_d, **common)
            else:
                layer = PNALayerFused(
                    hidden_dim, out_dim if last else hidden_dim,
                    aggregators, scalers, avg_d, kernel=kernel,
                    max_degree=max_degree, compute_dtype=compute_dtype,
                    **common)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.gru = GRUUpdate(hidden_dim, gen) if gru_enable else None
        self.MLP_layer = MLPReadout(out_dim, n_out, generator=gen)

    def _layout(self, graph: Graph, device) -> Optional[csr_bank.CSRLayout]:
        """The batch's CSR layout where the layers take one, else None (the
        layers share their kernel, aggregators and scalers)."""
        if not self.fused_towers:
            return bank_layout(graph, self.max_degree)
        first = self.layers[0]
        return backend_layout(resolve_backend(
            first.kernel, graph, first.aggregators, device),
            graph, self.max_degree)

    def _stack(self, graph: Graph, h: torch.Tensor,
               e: Optional[torch.Tensor]) -> torch.Tensor:
        layout = self._layout(graph, h.device)
        for i, layer in enumerate(self.layers):
            if self.remat and self.training and torch.is_grad_enabled():
                h_t = checkpoint(layer, graph, h, e, layout,
                                 use_reentrant=False,
                                 context_fn=functools.partial(
                                     _replay_contexts, layer,
                                     self.generator))
            else:
                h_t = layer(graph, h, e, layout)
            if self.gru is not None and i < len(self.layers) - 1:
                h_t = self.gru(h, h_t)
            h = h_t
        return self.MLP_layer(readout(self.readout_type, graph, h))


def _replay_contexts(layer: nn.Module, generator: torch.Generator):
    """The two contexts of one checkpointed layer call: the first records
    the dropout generator's state and the layer's buffers (the batch-norm
    running statistics) as the forward finds them; the second, around the
    recompute in the backward pass, puts those back, so the recompute draws
    the same dropout mask and normalises with the same shift, then restores
    the state the step has reached, so the statistics move once."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        saved['rng'] = generator.get_state()
        saved['buffers'] = [b.clone() for b in layer.buffers()]
        yield

    @contextlib.contextmanager
    def recompute():
        rng_now = generator.get_state()
        buffers_now = [b.clone() for b in layer.buffers()]
        generator.set_state(saved['rng'])
        with torch.no_grad():
            for b, v in zip(layer.buffers(), saved['buffers']):
                b.copy_(v)
        try:
            yield
        finally:
            generator.set_state(rng_now)
            with torch.no_grad():
                for b, v in zip(layer.buffers(), buffers_now):
                    b.copy_(v)

    return forward(), recompute()


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
                          1, gen, remat)
        self.to(device)

    def forward(self, graph: Graph, h_idx: torch.Tensor,
                e_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h_idx [N] atom types, e_idx [E] bond types -> scores [G_pad, 1].
        Batch-norm statistics and dropout follow ``self.training``."""
        h = self.in_feat_dropout(_lookup(self.embedding_h, h_idx))
        e = _lookup(self.embedding_e, e_idx) if self.edge_feat else None
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


class PNANetHIV(nn.Module):
    """MolHIV classification net: AtomEncoder -> in-feature dropout -> L x
    PNASimpleLayerSparse (hidden_dim, the last to out_dim) -> readout ->
    MLPReadout(out_dim, 1); BCE-with-logits loss."""

    def __init__(self, hidden_dim: int, out_dim: int, n_layers: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *, readout_type: str = 'mean',
                 in_feat_dropout: float = 0.0, dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 posttrans_layers: int = 1, device: DeviceLike = None,
                 seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.generator = _generator(generator, device, seed)
        gen = torch.Generator().manual_seed(seed)
        self.readout_type = readout_type
        self.embedding_h = AtomEncoder(hidden_dim, generator=gen)
        self.in_feat_dropout = Dropout(in_feat_dropout, self.generator)
        self.layers = nn.ModuleList(
            PNASimpleLayerSparse(
                hidden_dim, out_dim if i == n_layers - 1 else hidden_dim,
                aggregators, scalers, avg_d, dropout=dropout,
                batch_norm=batch_norm, residual=residual,
                posttrans_layers=posttrans_layers, device='cpu',
                generator=gen, dropout_generator=self.generator)
            for i in range(n_layers))
        self.MLP_layer = MLPReadout(out_dim, 1, generator=gen)
        self.to(device)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """x [N, 9] OGB atom features -> logits [G_pad, 1]."""
        h = self.in_feat_dropout(self.embedding_h(x))
        layout = bank_layout(graph)
        for layer in self.layers:
            h = layer(graph, h, layout)
        return self.MLP_layer(readout(self.readout_type, graph, h))

    @staticmethod
    def loss(scores: torch.Tensor, labels: torch.Tensor,
             graph_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """BCE with logits, in the log1p(exp(-|x|)) form, masked over real
        graphs."""
        x = scores.squeeze(-1)
        y = labels.to(x.dtype)
        bce = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
        if graph_mask is not None:
            m = graph_mask.to(bce.dtype)
            return torch.sum(bce * m) / torch.clamp(torch.sum(m), min=1.0)
        return torch.mean(bce)
