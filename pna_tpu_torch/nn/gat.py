"""GAT on the CSR layout: the attention layer of the large-graph trainer.

Graph Attention Networks (Velickovic et al., arXiv:1710.10903), the layer
of the reference code's ``attn_head`` for all of a layer's heads at once
(``reference/gat.py`` states the equations).  ``GATLayerCSR`` takes the
graph's receiver-sorted layout (``ops/csr_bank.py::CSRLayout``, as the PNA
layers' ``csr`` backend does) and H heads of width F:

* ``gat.project``: hw = x W^T over the sender table (the part's own rows,
  then its halo's), the heads' scores ``s_src``, ``s_dst``
  (``ops/csr_gat.py::head_scores``) and, with ``residual``, the skip
  connection x Ws^T + bs;
* ``gat.attend``: the attention over each node's in-edges and an implicit
  self edge (``ops/csr_gat.py::gat_attend``: the kernels
  ``csr_gat_attend`` and ``csr_gat_attend_bwd`` on the card, their plain
  versions on the CPU), no [E, H*F] tensor formed;
* ``gat.update``: the heads concatenated (``concat``) or averaged, each
  head's bias, the skip connection, ELU (``elu``).

Each phase is a span (``utils/profiling.py::span``) timed on the layer's
device.  Weights: W, Ws and the attention vectors xavier-uniform (the
reference code's ``glorot`` initialiser of ``tf.layers.conv1d``), biases 0,
from the generator given.  The update works in place on the tensor it
made: the skip connection's add and the ELU (whose backward then keeps its
output, which the next layer's product keeps anyway, and not its input).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.ops import csr_gat
from pna_tpu_torch.utils.profiling import span


def _glorot(shape, fan_in, fan_out, generator):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter((u * 2.0 - 1.0) * a)


class GATLayerCSR(nn.Module):
    """H heads of width F over a receiver-sorted layout.  ``forward(h,
    layout, sender_table=None)``: h [N, in] -> [N, H*F] (``concat``) or
    [N, F]; ``sender_table`` [Nt, in] (h's rows, then the halo's) is the
    rows the senders index, h itself where it is None."""

    def __init__(self, in_dim: int, heads: int, head_dim: int,
                 concat: bool = True, residual: bool = False,
                 elu: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        hf = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.concat, self.elu = concat, elu
        self.W = _glorot((hf, in_dim), in_dim, head_dim, gen)
        self.att_src = _glorot((heads, head_dim), head_dim, 1, gen)
        self.att_dst = _glorot((heads, head_dim), head_dim, 1, gen)
        self.bias = nn.Parameter(torch.zeros(hf))
        self.skip = None
        if residual:
            self.skip = nn.Linear(in_dim, hf, device='meta')
            self.skip.weight = _glorot((hf, in_dim), in_dim, head_dim, gen)
            self.skip.bias = nn.Parameter(torch.zeros(hf))
        self.to(resolve_device(device))

    def forward(self, h: torch.Tensor, layout,
                sender_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = h.device
        n = h.shape[0]
        table = h if sender_table is None else sender_table
        lay = csr_gat.gat_layout(layout, table.shape[0])
        with span('gat.project', dev):
            hw = table @ self.W.t()
            s_src, s_dst = csr_gat.head_scores(hw, self.att_src,
                                               self.att_dst, n)
            skip = None if self.skip is None else self.skip(h)
        with span('gat.attend', dev):
            out = csr_gat.gat_attend(hw, self.att_src, self.att_dst, s_src,
                                     s_dst, lay)
        with span('gat.update', dev):
            if self.concat:
                y = out + self.bias
            else:
                y = (out.view(n, self.heads, self.head_dim)
                     + self.bias.view(self.heads, self.head_dim)).mean(1)
            if skip is not None:
                y = y.add_(skip)
            return F.elu(y, inplace=True) if self.elu else y
