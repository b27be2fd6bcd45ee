"""PNA aggregation bank with the pretrans message formed inside the kernels,
as a ``torch.autograd.Function``.

Counterpart of ``pna_tpu/ops/pallas_fused.py`` (``make_fused_pretrans_bank``):
the layer hands over its node-level pretrans halves ``u = h K_src`` and
``v = h K_dst + b0`` (and, with edge features, the raw ``ef`` and the
edge-feature weight ``ke``), and the bank maps them to Z [N, A, F] without an
[E, F] message tensor ever existing:

* forward: K3 (``csr_pretrans_sketch``) gives {sum, sumsq, max, min} of the
  messages, with the tie counts when a gradient is needed, then ``_assemble``
  as in the CSR bank; it saves u, v, ef, ke and node statistics, no message;
* backward: ``node_fields`` folds d_agg into four node fields, K4
  (``csr_pretrans_dmsg``) recomputes the messages and gives d_msg (its pad
  rows written as 0 by the kernel, so no mask follows) and ``d_v``; ``d_u``
  is d_msg's ``index_add_`` over the senders into u's rows, and
  ``d_ke = ef^T d_msg``, ``d_ef = d_msg ke^T`` are float32 matmuls (outside the kernels, as in the
  JAX package).  Each gradient is cast back to its input's type.

``u`` may have more rows than ``v`` (a ghost sender table).  The layout
(``csr_bank.CSRLayout``) supplies the clamped row pointers, the counts, the
int32 senders and the segment table the kernels walk.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops.csr_bank import (CSRLayout, _assemble, node_fields,
                                        supports)
from pna_tpu_torch.ops.csr_fused_kernels import (csr_pretrans_dmsg,
                                                 csr_pretrans_sketch)


class CSRFusedBank(torch.autograd.Function):
    """(u [Nu, F], v [N, F], ef [E, Fe] or None, ke [Fe, F] or None) ->
    Z [N, A, F] float32, aggregators in caller order."""

    @staticmethod
    def forward(ctx, u, v, ef, ke, ptr, senders, cnt, segments,
                aggregators):
        s, sq, mx, mn, tmx, tmn = csr_pretrans_sketch(
            u, v, senders, ptr, ef, ke, with_ties=True, segments=segments)
        out, (mean, var_raw, std) = _assemble(aggregators, s, sq, mx, mn, cnt)
        ctx.aggregators = aggregators
        ctx.segments = segments
        ctx.save_for_backward(u, v, ef, ke, ptr, senders, cnt, mean, var_raw,
                              std, mx, mn, tmx, tmn)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_agg):
        (u, v, ef, ke, ptr, senders, cnt, mean, var_raw, std, mx, mn, tmx,
         tmn) = ctx.saved_tensors
        fields = node_fields(ctx.aggregators, d_agg, cnt, mean, var_raw, std,
                             tmx, tmn)
        # the pad rows past ptr[N] come back as 0 (K4 writes them)
        d_msg, d_v = csr_pretrans_dmsg(u, v, senders, ptr, *fields, mx, mn,
                                       ef, ke, segments=ctx.segments)
        d_u = torch.zeros((u.shape[0], d_msg.shape[1]), dtype=torch.float32,
                          device=d_msg.device).index_add_(0, senders, d_msg)
        d_ef = d_ke = None
        if ef is not None:
            if ctx.needs_input_grad[2]:
                d_ef = (d_msg @ ke.to(torch.float32).t()).to(ef.dtype)
            if ctx.needs_input_grad[3]:
                d_ke = (ef.to(torch.float32).t() @ d_msg).to(ke.dtype)
        return (d_u.to(u.dtype), d_v.to(v.dtype), d_ef, d_ke, None, None,
                None, None, None)


def csr_fused_bank(u: torch.Tensor, v: torch.Tensor,
                   ef: Optional[torch.Tensor], ke: Optional[torch.Tensor],
                   layout: CSRLayout,
                   aggregators: Sequence[str]) -> torch.Tensor:
    """Aggregator bank over the messages ``u[senders] + v[receivers]
    (+ ef ke)`` of a receiver-sorted layout -> Z [N, A, F] float32.  Without
    a gradient to track, K3 runs without tie counts."""
    if not supports(aggregators):
        raise ValueError(f"unsupported aggregators {aggregators}")
    if layout.senders is None:
        raise ValueError("the fused bank needs a layout with senders "
                         "(csr_layout(..., senders=...))")
    u, v = u.contiguous(), v.contiguous()
    if ef is not None:
        ef, ke = ef.contiguous(), ke.contiguous()
    inputs = [x for x in (u, v, ef, ke) if x is not None]
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return CSRFusedBank.apply(u, v, ef, ke, layout.ptr, layout.senders,
                                  layout.cnt, layout.segments,
                                  tuple(aggregators))
    s, sq, mx, mn = csr_pretrans_sketch(u, v, layout.senders, layout.ptr, ef,
                                        ke, with_ties=False,
                                        segments=layout.segments)
    return _assemble(tuple(aggregators), s, sq, mx, mn, layout.cnt)[0]
