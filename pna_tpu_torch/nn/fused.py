"""Fused-towers PNA layer on the CSR kernels.

Counterpart of ``pna_tpu/nn/fused.py::PNALayerFused`` on two backends, named
after the port's kernels: the JAX package's ``kernel='pallas'`` (the
receiver-sorted moment-sketch bank, ``pna_tpu/ops/pallas_bank.py``) is this
port's ``kernel='csr'`` (``pna_tpu_torch/ops/csr_bank.py``, kernels K1/K2),
and its ``kernel='pallas_fused'`` (``pna_tpu/ops/pallas_fused.py``) is
``kernel='csr_fused'`` (``pna_tpu_torch/ops/csr_fused.py``, kernels K3/K4).
The math is the JAX layer's:

* stacked tower parameters ``kernel_i [T, in_i, out_i]``, ``bias_i
  [T, out_i]`` for each of the ``pretrans_layers`` and ``posttrans_layers``
  (relu between layers: on the messages after the first pretrans layer,
  after the scaler contraction in the posttrans);
* a split-kernel pretrans: ``msg = src K_src + dst K_dst (+ e K_e) + b``, the
  concat never built; per-tower contractions are one matmul with a
  block-diagonal weight (``_ein``), or one matmul when every tower shares its
  input (``_ein_shared``, ``divide_input=False``).  On ``csr`` the message is
  formed per edge and reduced by the CSR bank; on ``csr_fused`` only the node
  halves ``u = h K_src`` and ``v = h K_dst + b`` are formed and the kernels
  build each message on chip;
* a posttrans with the scaler axis folded into the output: the aggregator
  tensor Z [N, A, T*Ft] meets a weight laid out to match it, and the S scaler
  weights apply to the narrower [N, T, O, S] result;
* graph-norm, masked batch-norm, dropout, the ``mixing`` linear,
  leaky_relu(0.01), and the residual when ``in_dim == out_dim``.

``compute_dtype=torch.bfloat16`` rounds at the JAX layer's places: the layer
input, every matmul operand (the products are then taken and summed in
float32, the JAX ``preferred_element_type=float32``: the operands are widened
to float32, which is exact, and the matmul runs in float32), the ``csr``
message before the bank, the ``csr_fused`` inputs u, v, ef and ke, and the
scaler contraction's operands.  Statistics, batch-norm, mixing and the
residual stay float32.

``csr_fused`` forms only the first pretrans layer inside its kernels, so it
takes ``pretrans_layers=1`` only and raises ``ValueError`` otherwise, as the
JAX fused backend does.  Dropout draws its mask from ``dropout_generator``
(``nn/layers.py::Dropout``).  The port's ``Graph`` always carries the
receiver-sorted ``edge_ptr`` both backends need.  The other backends and
options raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.layers import (Dropout, dense, xavier_uniform_gain,
                                     zeros_init)
from pna_tpu_torch.nn.sparse import MaskedBatchNorm
from pna_tpu_torch.ops import csr_bank, csr_fused
from pna_tpu_torch.ops.scalers import SCALERS, scaler_weights

KERNELS = ('csr', 'csr_fused')
_RENAMED = {'pallas': 'csr', 'pallas_fused': 'csr_fused'}
_NOT_PORTED = {
    'auto': "ROADMAP Queue 1 item 12 (layout choice)",
    'bucketed': "ROADMAP Queue 1 item 12 (degree-bucketed layout)",
    'ell': "ROADMAP Queue 1 item 12 (ELL layout)",
    'generic': "ROADMAP Queue 1 items 3 and 12 (segment bank)",
}


def check_backend(kernel: str, compute_dtype=None, tp_axis=None) -> None:
    """Raise for a backend or option this slice of the port does not run."""
    if kernel in _NOT_PORTED:
        raise NotImplementedError(f"kernel={kernel!r} is not ported yet: "
                                  f"{_NOT_PORTED[kernel]}")
    if kernel in _RENAMED:
        raise ValueError(f"the port names the JAX {kernel!r} backend "
                         f"{_RENAMED[kernel]!r}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype={compute_dtype} is not "
                                  "ported: float32 and bfloat16 are "
                                  "(ROADMAP Queue 1 item 6)")
    if tp_axis is not None:
        raise NotImplementedError("tower tensor parallelism is not ported "
                                  "yet: ROADMAP Queue 1 item 13")


def _round(x, cdt):
    """``x`` rounded to the compute dtype and widened back to float32: a
    matmul operand in ``cdt`` whose products are summed in float32."""
    if cdt == torch.float32:
        return x
    return x.to(cdt).to(torch.float32)


def _ein(x, k, cdt=torch.float32):
    """x [..., T, fi], k [T, fi, fo] -> [..., T, fo] float32 as one matmul
    with the block-diagonal weight, on operands rounded to ``cdt``."""
    T, fi, fo = k.shape
    kb = _round(torch.block_diag(*k.unbind(0)), cdt)     # [T*fi, T*fo]
    lead = x.shape[:-2]
    return (_round(x.reshape(lead + (T * fi,)), cdt) @ kb).reshape(
        lead + (T, fo))


def _ein_shared(x, k, cdt=torch.float32):
    """x [..., fi] shared by every tower, k [T, fi, fo] -> [..., T, fo]
    float32, on operands rounded to ``cdt``."""
    T, fi, fo = k.shape
    kb = _round(k.permute(1, 0, 2).reshape(fi, T * fo), cdt)
    return (_round(x, cdt) @ kb).reshape(x.shape[:-1] + (T, fo))


def _mlp_dims(in_size, hidden, out, layers):
    return ([in_size] + [hidden] * (layers - 1) + [out] if layers > 1
            else [in_size, out])


class StackedParams(nn.Module):
    """Per-tower dense layers, stacked: kernel_i [T, dims[i], dims[i+1]],
    bias_i [T, dims[i+1]] (xavier-uniform at gain 1/dims[i], zero bias)."""

    def __init__(self, dims, towers: int, generator: torch.Generator):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f'kernel_{i}', nn.Parameter(
                xavier_uniform_gain(1.0 / dims[i])(
                    (towers, dims[i], dims[i + 1]), generator)))
            setattr(self, f'bias_{i}', nn.Parameter(
                zeros_init((towers, dims[i + 1]), generator)))

    def layer(self, i):
        return getattr(self, f'kernel_{i}'), getattr(self, f'bias_{i}')

    def rest(self, x, cdt):
        """Layers 1.. on x [..., T, F]: relu, then the next tower dense."""
        for i in range(1, self.n):
            k, b = self.layer(i)
            x = _ein(torch.relu(x), k, cdt) + b
        return x


class PNALayerFused(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *,
                 graph_norm: bool = False, batch_norm: bool = False,
                 towers: int = 1, divide_input: bool = True,
                 residual: bool = False, edge_features: bool = False,
                 edge_dim: int = 0, dropout: float = 0.0,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 kernel: str = 'csr', max_degree: int = 0,
                 compute_dtype=None, tp_axis: Optional[str] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_backend(kernel, compute_dtype, tp_axis)
        if kernel == 'csr_fused' and pretrans_layers != 1:
            raise ValueError("kernel='csr_fused' supports pretrans_layers=1 "
                             "only: its kernels form the first pretrans "
                             "layer's message")
        if not csr_bank.supports(aggregators):
            raise ValueError(f"kernel={kernel!r} supports aggregators "
                             f"{csr_bank.AGGS} (no 'identity'), got "
                             f"{aggregators}")
        if not all(s in SCALERS for s in scalers):
            raise ValueError(f"unsupported scalers {scalers}")
        if divide_input and in_dim % towers:
            raise ValueError(f"in_dim {in_dim} not divisible by {towers}")
        if out_dim % towers:
            raise ValueError(f"out_dim {out_dim} not divisible by {towers}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_dim, self.out_dim, self.towers = in_dim, out_dim, towers
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d = dict(avg_d)
        self.graph_norm, self.batch_norm = graph_norm, batch_norm
        self.divide_input, self.edge_features = divide_input, edge_features
        self.residual = residual and in_dim == out_dim
        self.kernel, self.max_degree = kernel, max_degree
        self.compute_dtype = compute_dtype or torch.float32
        self.ft = in_dim // towers if divide_input else in_dim
        self.fo = out_dim // towers
        fe = edge_dim if edge_features else 0
        A, S = len(self.aggregators), len(self.scalers)
        self.pretrans = StackedParams(
            _mlp_dims(2 * self.ft + fe, self.ft, self.ft, pretrans_layers),
            towers, generator)
        self.posttrans = StackedParams(
            _mlp_dims((A * S + 1) * self.ft, self.fo, self.fo,
                      posttrans_layers), towers, generator)
        if batch_norm:
            self.batchnorm_h = MaskedBatchNorm(towers * self.fo)
        self.dropout = Dropout(dropout, dropout_generator)
        self.mixing = dense(towers * self.fo, out_dim,
                            xavier_uniform_gain(1.0 / out_dim), zeros_init,
                            generator)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None,
                sender_table=None, overlap=None) -> torch.Tensor:
        """h [N, in_dim], e [E, edge_dim] (edge features) -> [N, out_dim].
        ``layout`` is the batch's CSR layout, shared by every layer; built
        here when not given."""
        if sender_table is not None or overlap is not None:
            raise NotImplementedError("the distributed layer path is not "
                                      "ported yet: ROADMAP Queue 1 item 13")
        if layout is None:
            layout = csr_bank.layout_from_graph(graph, self.max_degree)
        T, Ft, Fo = self.towers, self.ft, self.fo
        A, S = len(self.aggregators), len(self.scalers)
        N, E = h.shape[0], graph.n_edge_pad
        cdt = self.compute_dtype
        hb = h.to(cdt)

        # ---- pretrans: split-kernel first layer, no concat built ----
        k0, b0 = self.pretrans.layer(0)
        k_src, k_dst = k0[:, :Ft], k0[:, Ft:2 * Ft]
        if self.kernel == 'csr_fused':
            # node halves only: the kernels form u[snd] + v[rcv] (+ e ke)
            if self.divide_input:
                u = _ein(hb.reshape(N, T, Ft), k_src, cdt)
                v = _ein(hb.reshape(N, T, Ft), k_dst, cdt)
            else:
                u = _ein_shared(hb, k_src, cdt)
                v = _ein_shared(hb, k_dst, cdt)
            u = u.reshape(N, T * Ft).to(cdt)
            v = (v + b0).reshape(N, T * Ft).to(cdt)
            ef = ke = None
            if self.edge_features:
                ef = e.to(cdt)
                ke = k0[:, 2 * Ft:].to(cdt).permute(1, 0, 2).reshape(
                    -1, T * Ft)                             # [Fe, T*Ft]
            Z = csr_fused.csr_fused_bank(u, v, ef, ke, layout,
                                         self.aggregators)  # [N, A, T*Ft]
        else:
            src, dst = hb[graph.senders], hb[graph.receivers]
            if self.divide_input:
                msg = (_ein(src.reshape(E, T, Ft), k_src, cdt)
                       + _ein(dst.reshape(E, T, Ft), k_dst, cdt))
            else:
                msg = (_ein_shared(src, k_src, cdt)
                       + _ein_shared(dst, k_dst, cdt))
            if self.edge_features:
                msg = msg + _ein_shared(e, k0[:, 2 * Ft:], cdt)
            # stored in the compute dtype; the bank widens it to float32
            msg = self.pretrans.rest(msg + b0, cdt).to(cdt)  # [E, T, Ft]
            Z = csr_bank.csr_raw_bank(msg.reshape(E, T * Ft), layout,
                                      self.aggregators)     # [N, A, T*Ft]
        w = scaler_weights(self.scalers, layout.deg, self.avg_d)   # [S, N]

        # ---- posttrans with the scaler axis folded into the output ----
        kp, bp = self.posttrans.layer(0)
        k_h = kp[:, :Ft]                                    # [T, Ft, Fo]
        # rows of kp per tower: [0:Ft] = h part; Ft + s*A*Ft + a*Ft + f
        k_agg = kp[:, Ft:].reshape(T, S, A, Ft, Fo)
        if self.divide_input:
            out = _ein(hb.reshape(N, T, Ft), k_h, cdt)
        else:
            out = _ein_shared(hb, k_h, cdt)
        eye = torch.eye(T, dtype=kp.dtype, device=kp.device)
        W = _round(torch.einsum('tsafo,tu->atfuos', k_agg, eye).reshape(
            A * T * Ft, T * Fo * S), cdt)
        y = (_round(Z.reshape(N, A * T * Ft), cdt) @ W).reshape(N, T, Fo, S)
        out = out + torch.einsum('ntos,sn->nto', _round(y, cdt),
                                 _round(w, cdt)) + bp
        out = self.posttrans.rest(out, cdt).reshape(N, T * Fo)

        if self.graph_norm:
            out = out * graph.snorm_n
        if self.batch_norm:
            out = self.batchnorm_h(out, graph.node_mask)
        out = F.leaky_relu(self.mixing(self.dropout(out)),
                           negative_slope=0.01)
        if self.residual:
            out = h + out
        return out
