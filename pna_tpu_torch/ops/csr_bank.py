"""PNA aggregation bank on the CSR kernels, as a ``torch.autograd.Function``.

Counterpart of ``pna_tpu/ops/pallas_bank.py`` (``make_pallas_raw_bank``):

* forward: K1 (``csr_moment_sketch``) gives {sum, sumsq, max, min}, with the
  max/min tie counts when a gradient is needed; mean/var/std follow
  elementwise (EPS inside the sqrt, relu clamp on the variance);
* backward: the per-aggregator node gradients fold into four node fields
  (g_lin, g_quad, g_max, g_min), and K2 (``csr_dmsg``) expands them to the
  edges; the kernel writes the pad rows as exactly 0, so no mask follows.

On the card the backward is always K2.  The JAX package switches between an
XLA gather and its kernel at an edge-count threshold calibrated on the TPU;
the gather form is the same function and serves here as K2's plain version
(``csr_kernels.csr_dmsg_plain``).

Layout: ``CSRLayout`` holds the row pointers clamped to the real-edge count
(pad messages carry the pretrans bias, not zeros, and must not enter any
node's statistics), the degrees, the clamped counts, the segment table that
is the work list of K1, K3 and K4 and holds K2's row-to-node array
(``csr_kernels.csr_segments``: ranges cut to at most ``SEG`` edges; the row
pointers themselves where collation says no node has more), built at its
first use, and, for the fused bank (``csr_fused.py``), the int32 senders.
The layout is built once per batch and shared by every layer.
``node_fields`` folds the aggregator gradients into the four node fields;
both banks call it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops.csr_kernels import (CSRSegments, csr_dmsg,
                                           csr_moment_sketch, csr_segments)

EPS = 1e-5
AGGS = ('mean', 'sum', 'max', 'min', 'var', 'std')


def supports(aggregators: Sequence[str]) -> bool:
    return all(a in AGGS for a in aggregators)


@dataclass
class CSRLayout:
    ptr: torch.Tensor        # [N+1] int32, clamped to the real-edge count
    deg: torch.Tensor        # [N] float32 in-degree
    cnt: torch.Tensor        # [N] float32 max(deg, 1)
    edge_mask: torch.Tensor  # [E] bool
    senders: Optional[torch.Tensor] = None   # [E] int32, contiguous
    max_in_degree: Optional[int] = None      # from collation; None: unknown
    _segments: Optional[CSRSegments] = field(default=None, repr=False)

    @property
    def segments(self) -> CSRSegments:
        """The segment table of ``ptr``, the work list of K1, K3 and K4 and
        the holder of K2's row-to-node array, built when a bank first asks
        for it and shared by every layer of the batch (``csr_segments``
        synchronises with the device unless ``max_in_degree`` says that no
        node is split: give it wherever collation knows it)."""
        if self._segments is None:
            self._segments = csr_segments(self.ptr, self.max_in_degree)
        return self._segments


def csr_layout(edge_ptr: torch.Tensor, edge_mask: torch.Tensor,
               max_degree: int = 0,
               max_in_degree: Optional[int] = None,
               senders: Optional[torch.Tensor] = None) -> CSRLayout:
    """Bind a receiver-sorted layout; ``senders`` (the fused bank needs them)
    are stored as contiguous int32; the segment table of the clamped
    pointers is built at a bank's first use of ``layout.segments`` (no device
    synchronisation where ``max_in_degree`` is given and at most ``SEG``).

    ``max_degree`` is the caller's in-degree bound hint (0 = none).  The
    kernels do not need it, but a hint below the true in-degree is an error,
    as in the JAX package, and raises ``ValueError``.  The check uses
    ``max_in_degree`` from collation (``Graph.max_in_degree``), so it costs no
    device synchronisation; when that is not given it is read from ``ptr``.
    """
    n_real = edge_mask.sum(dtype=torch.int32)
    ptr = torch.minimum(edge_ptr.to(torch.int32), n_real).contiguous()
    deg = (ptr[1:] - ptr[:-1]).to(torch.float32)
    if max_degree:
        if max_in_degree is None:
            max_in_degree = int(deg.max()) if deg.numel() else 0
        if max_in_degree > max_degree:
            raise ValueError(
                f"max_degree hint {max_degree} < true max in-degree "
                f"{max_in_degree}: the hint would under-reduce max/min")
    if senders is not None:
        senders = senders.to(torch.int32).contiguous()
    return CSRLayout(ptr=ptr, deg=deg, cnt=torch.clamp(deg, min=1.0),
                     edge_mask=edge_mask, senders=senders,
                     max_in_degree=max_in_degree)


def layout_from_graph(graph, max_degree: int = 0) -> CSRLayout:
    # 0 is the field's default as well as a true value: read it as unknown
    return csr_layout(graph.edge_ptr, graph.edge_mask, max_degree,
                      graph.max_in_degree or None, graph.senders)


def _assemble(aggregators, s, sq, mx, mn, cnt):
    c = cnt[:, None]
    mean = s / c
    var_raw = sq / c - mean * mean
    var = torch.relu(var_raw)
    std = torch.sqrt(var + EPS)
    table = {'mean': mean, 'sum': s, 'max': mx, 'min': mn, 'var': var,
             'std': std}
    agg = torch.stack([table[a] for a in aggregators], dim=1)   # [N, A, F]
    return agg, (mean, var_raw, std)


def node_fields(aggregators, d_agg, cnt, mean, var_raw, std, tmx, tmn):
    """Fold d_agg [N, A, F] into the node fields (g_lin, g_quad, g_max,
    g_min) that K2 and K4 expand to the edges; g_max/g_min are divided by the
    tie counts.  The JAX package's ``_pallas_raw_bwd`` and ``_node_fields``."""
    g_lin = torch.zeros_like(mean)
    g_quad = torch.zeros_like(mean)
    g_max = torch.zeros_like(mean)
    g_min = torch.zeros_like(mean)
    inv_cnt = (1.0 / cnt)[:, None]
    for i, a in enumerate(aggregators):
        d = d_agg[:, i, :]
        if a == 'sum':
            g_lin = g_lin + d
        elif a == 'mean':
            g_lin = g_lin + d * inv_cnt
        elif a == 'max':
            g_max = g_max + d
        elif a == 'min':
            g_min = g_min + d
        elif a in ('var', 'std'):
            if a == 'std':
                d = d * (0.5 / std)
            d = d * (var_raw > 0).to(d.dtype)
            g_quad = g_quad + d * inv_cnt
            g_lin = g_lin - d * 2.0 * mean * inv_cnt
        else:
            raise ValueError(a)
    return (g_lin.contiguous(), g_quad.contiguous(),
            (g_max / tmx).contiguous(), (g_min / tmn).contiguous())


class CSRBank(torch.autograd.Function):
    """msg [E, F] float32 -> Z [N, A, F] float32, aggregators in caller
    order."""

    @staticmethod
    def forward(ctx, msg, ptr, cnt, segments, aggregators):
        s, sq, mx, mn, tmx, tmn = csr_moment_sketch(msg, ptr, with_ties=True,
                                                    segments=segments)
        out, (mean, var_raw, std) = _assemble(aggregators, s, sq, mx, mn, cnt)
        ctx.aggregators = aggregators
        ctx.segments = segments
        ctx.save_for_backward(msg, ptr, cnt, mean, var_raw, std, mx, mn, tmx,
                              tmn)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_agg):
        msg, ptr, cnt, mean, var_raw, std, mx, mn, tmx, tmn = ctx.saved_tensors
        fields = node_fields(ctx.aggregators, d_agg, cnt, mean, var_raw, std,
                             tmx, tmn)
        # the pad rows past ptr[N] come back as 0 (K2 writes them)
        d_msg = csr_dmsg(msg, ptr, *fields, mx, mn, segments=ctx.segments)
        return d_msg, None, None, None, None


def csr_raw_bank(msg: torch.Tensor, layout: CSRLayout,
                 aggregators: Sequence[str]) -> torch.Tensor:
    """Aggregator bank over a receiver-sorted message tensor: msg [E, F] ->
    Z [N, A, F] float32.  Without a gradient to track, K1 runs without tie
    counts."""
    if not supports(aggregators):
        raise ValueError(f"unsupported aggregators {aggregators}")
    msg = msg.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and msg.requires_grad:
        return CSRBank.apply(msg, layout.ptr, layout.cnt, layout.segments,
                             tuple(aggregators))
    s, sq, mx, mn = csr_moment_sketch(msg, layout.ptr, with_ties=False,
                                      segments=layout.segments)
    return _assemble(tuple(aggregators), s, sq, mx, mn, layout.cnt)[0]
