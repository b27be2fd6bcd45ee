"""Segment aggregators: edge messages -> node features.

Counterpart of the segment half of ``pna_tpu/ops/aggregators.py``
(``SegmentCtx``, ``SEGMENT_AGGREGATORS``); the dense half waits for the
multitask benchmark (ROADMAP Queue 1 item 11).  Every aggregator maps a
``SegmentCtx`` to ``[N, ...]`` and runs in plain torch; the CSR kernels take
over mean, sum, max, min, var and std on the card (``nn/sparse.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from pna_tpu_torch.ops import segment as seg


@dataclass
class SegmentCtx:
    """One edge set's messages with what every aggregator of a bank shares:
    the in-degree ``count`` is computed once."""
    msg: torch.Tensor                          # [E, ...] edge messages
    receivers: torch.Tensor                    # [E]
    num_nodes: int
    mask: Optional[torch.Tensor] = None        # [E] bool
    count: Optional[torch.Tensor] = None       # [N] in-degree
    senders: Optional[torch.Tensor] = None     # [E] (normalised_mean)
    self_msg: Optional[torch.Tensor] = None    # [N, ...] (identity)

    @classmethod
    def create(cls, msg, receivers, num_nodes, mask=None, senders=None,
               self_msg=None) -> "SegmentCtx":
        count = seg.segment_count(receivers, num_nodes, mask, dtype=msg.dtype)
        return cls(msg=msg, receivers=receivers, num_nodes=num_nodes,
                   mask=mask, count=count, senders=senders, self_msg=self_msg)


def seg_mean(ctx: SegmentCtx):
    return seg.segment_mean(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask,
                            ctx.count)


def seg_sum(ctx: SegmentCtx):
    return seg.segment_sum(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask)


def seg_max(ctx: SegmentCtx):
    return seg.segment_max(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask)


def seg_min(ctx: SegmentCtx):
    return seg.segment_min(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask)


def seg_var(ctx: SegmentCtx):
    return seg.segment_var(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask,
                           ctx.count)


def seg_std(ctx: SegmentCtx):
    return seg.segment_std(ctx.msg, ctx.receivers, ctx.num_nodes, ctx.mask,
                           ctx.count)


def seg_identity(ctx: SegmentCtx):
    """The dense bank's diagonal message m_ii: in edge-list form the message
    a node sends itself, which the layer supplies as ``self_msg``."""
    if ctx.self_msg is None:
        raise ValueError("identity aggregator requires ctx.self_msg")
    return ctx.self_msg


def seg_normalised_mean(ctx: SegmentCtx):
    """sum_j m_ij / sqrt(D_i D_j): D_i the receiver's in-degree, D_j the
    sender's out-degree."""
    if ctx.senders is None:
        raise ValueError("normalised_mean requires ctx.senders")
    out_deg = seg.segment_count(ctx.senders, ctx.num_nodes, ctx.mask,
                                dtype=ctx.msg.dtype)
    r = torch.rsqrt(torch.clamp(ctx.count, min=1e-30))
    r_out = torch.rsqrt(torch.clamp(out_deg, min=1e-30))
    w = r[ctx.receivers] * r_out[ctx.senders]
    w = w.reshape(w.shape + (1,) * (ctx.msg.ndim - 1))
    return seg.segment_sum(ctx.msg * w, ctx.receivers, ctx.num_nodes,
                           ctx.mask)


def seg_softmax(ctx: SegmentCtx):
    """sum_j m_j softmax(m)_j per node and feature."""
    w = seg.segment_softmax_weights(ctx.msg, ctx.receivers, ctx.num_nodes,
                                    ctx.mask)
    return seg.segment_sum(w * ctx.msg, ctx.receivers, ctx.num_nodes,
                           ctx.mask)


def seg_softmin(ctx: SegmentCtx):
    return -seg_softmax(dataclasses.replace(ctx, msg=-ctx.msg))


def seg_moment(ctx: SegmentCtx, n: int = 3):
    return seg.segment_moment(ctx.msg, ctx.receivers, ctx.num_nodes, n,
                              ctx.mask, ctx.count)


SEGMENT_AGGREGATORS: Dict[str, Callable] = {
    'mean': seg_mean,
    'sum': seg_sum,
    'max': seg_max,
    'min': seg_min,
    'identity': seg_identity,
    'std': seg_std,
    'var': seg_var,
    'normalised_mean': seg_normalised_mean,
    'softmax': seg_softmax,
    'softmin': seg_softmin,
    'moment3': functools.partial(seg_moment, n=3),
    'moment4': functools.partial(seg_moment, n=4),
    'moment5': functools.partial(seg_moment, n=5),
}
