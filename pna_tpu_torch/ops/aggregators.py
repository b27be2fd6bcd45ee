"""Aggregator banks: the dense aggregators of the multitask benchmark and
the segment aggregators of the edge-list layers.

Counterpart of ``pna_tpu/ops/aggregators.py``:

* ``DENSE_AGGREGATORS`` (13): ``f(X [B, N, N, D], adj [B, N, N],
  self_loop=False) -> [B, N, D]``, with the reference's quirks kept: max
  and min reduce over axis -3 (the transposed messages X[j, i]), mean,
  var, moments and normalised_mean divide by zero on an isolated node,
  softmax takes a raw ``exp`` with no max subtracted, EPS = 1e-5 inside
  std's sqrt and the moments' root;
* ``SEGMENT_AGGREGATORS``: every aggregator maps a ``SegmentCtx`` to
  ``[N, ...]`` and runs in plain torch; the CSR kernels take over mean,
  sum, max, min, var and std on the card (``nn/sparse.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from pna_tpu_torch.ops import segment as seg


EPS = seg.EPS


# ---------------------------------------------------------------------------
# Dense aggregators (B x N x N x D -> B x N x D)
# ---------------------------------------------------------------------------

def _with_self_loop(adj):
    n = adj.shape[-1]
    return adj + torch.eye(n, dtype=adj.dtype, device=adj.device)[None]


def dense_degree(adj, keepdims=True):
    return torch.sum(adj, dim=-1, keepdim=keepdims)


def aggregate_identity(X, adj, self_loop=False):
    """The diagonal X[b, i, i]."""
    n = X.shape[1]
    eye = torch.eye(n, dtype=X.dtype, device=X.device).reshape(1, n, n, 1)
    return torch.sum(X * eye, dim=2)


def aggregate_mean(X, adj, self_loop=False):
    """D^-1 A X; divides by zero on an isolated node."""
    if self_loop:
        adj = _with_self_loop(adj)
    D = dense_degree(adj)
    X_sum = torch.sum(X * adj[..., None], dim=2)
    return X_sum / D


def aggregate_max(X, adj, self_loop=False):
    """Masked max over axis -3: the transposed messages X[j, i]."""
    if self_loop:
        adj = _with_self_loop(adj)
    M = torch.where(adj[..., None] > 0.0, X,
                    torch.full_like(X, float('-inf')))
    return torch.amax(M, dim=-3)


def aggregate_min(X, adj, self_loop=False):
    """Masked min over axis -3, as max."""
    if self_loop:
        adj = _with_self_loop(adj)
    M = torch.where(adj[..., None] > 0.0, X,
                    torch.full_like(X, float('inf')))
    return torch.amin(M, dim=-3)


def aggregate_var(X, adj, self_loop=False):
    """relu(E[X^2] - E[X]^2)."""
    if self_loop:
        adj = _with_self_loop(adj)
    D = dense_degree(adj)
    X_sum_squares = torch.sum(X * X * adj[..., None], dim=2)
    X_mean_squares = X_sum_squares / D
    X_mean = aggregate_mean(X, adj)
    return torch.relu(X_mean_squares - X_mean * X_mean)


def aggregate_std(X, adj, self_loop=False):
    """sqrt(var + EPS)."""
    return torch.sqrt(aggregate_var(X, adj, self_loop) + EPS)


def aggregate_sum(X, adj, self_loop=False):
    """A X."""
    if self_loop:
        adj = _with_self_loop(adj)
    return torch.sum(X * adj[..., None], dim=2)


def aggregate_normalised_mean(X, adj, self_loop=False):
    """D^-1/2 A D^-1/2 X, D the row sums."""
    if self_loop:
        adj = _with_self_loop(adj)
    d = torch.sum(adj, dim=-1)
    r = torch.pow(d, -0.5)
    norm_adj = adj * r[:, :, None] * r[:, None, :]
    return torch.sum(X * norm_adj[..., None], dim=2)


def aggregate_softmax(X, adj, self_loop=False):
    """sum_j x_j exp(x_j) / sum_k exp(x_k) over the neighbourhood, per
    feature, with a raw exp (no max subtracted)."""
    if self_loop:
        adj = _with_self_loop(adj)
    X_exp = torch.exp(X) * adj[..., None]
    X_sum = torch.sum(X_exp, dim=2, keepdim=True)
    return torch.sum((X_exp / X_sum) * X, dim=2)


def aggregate_softmin(X, adj, self_loop=False):
    return -aggregate_softmax(-X, adj, self_loop)


def aggregate_moment(X, adj, self_loop=False, n=3):
    """sign(m_n) (|m_n| + EPS)^(1/n), m_n = E[(X - E[X])^n]."""
    if self_loop:
        adj = _with_self_loop(adj)
    D = dense_degree(adj)
    X_mean = aggregate_mean(X, adj)
    X_n = torch.sum(((X - X_mean[:, :, None, :]) ** n) * adj[..., None],
                    dim=2) / D
    return torch.sign(X_n) * torch.pow(torch.abs(X_n) + EPS, 1.0 / n)


DENSE_AGGREGATORS: Dict[str, Callable] = {
    'mean': aggregate_mean,
    'sum': aggregate_sum,
    'max': aggregate_max,
    'min': aggregate_min,
    'identity': aggregate_identity,
    'std': aggregate_std,
    'var': aggregate_var,
    'normalised_mean': aggregate_normalised_mean,
    'softmax': aggregate_softmax,
    'softmin': aggregate_softmin,
    'moment3': functools.partial(aggregate_moment, n=3),
    'moment4': functools.partial(aggregate_moment, n=4),
    'moment5': functools.partial(aggregate_moment, n=5),
}


# ---------------------------------------------------------------------------
# Segment aggregators (edge messages -> node features)
# ---------------------------------------------------------------------------

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
    w = seg.gather_rows(r, ctx.receivers) * seg.gather_rows(r_out,
                                                            ctx.senders)
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
