"""The PNA bank over the ELL layout with a hand-written backward.

Counterpart of ``pna_tpu/ops/fused_vjp.py``.  Forward: one pass over the
gathered messages [N, D, F] gives the moment sketch {sum, sum of squares,
max, min} (and, when a gradient is needed, the max/min tie counts); mean,
var and std follow elementwise.  Backward: every aggregator has a node-level
sufficient statistic, so the per-aggregator gradients fold into four node
fields (``csr_bank.node_fields``: g_lin, g_quad, g_max, g_min, the extremes'
divided by their tie counts) and one gather per edge expands them:

    d_msg[e] = g_lin[r] + 2 msg[e] g_quad[r]
               + [msg[e] == max[r]] g_max[r] + [msg[e] == min[r]] g_min[r]

with r the receiver of e; padded edges get exactly 0.  Numerics are the
segment bank's (EPS inside std's sqrt, relu-clamped variance, 0 for a node
without in-edges).  ``make_fused_bank`` returns the (scaler, aggregator,
feature) tensor, ``make_raw_bank`` the scaler-free [N, A, F] one (float32,
from messages of any float dtype; the gradient comes back in the messages'
dtype).  Each is a ``torch.autograd.Function`` in plain torch.

Covered: aggregators {mean, sum, max, min, var, std} x scalers {identity,
amplification, attenuation, linear, inverse_linear}; ``supports`` says so.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops.csr_bank import node_fields
from pna_tpu_torch.ops.scalers import scaler_weights

EPS = 1e-5

_AGGS = ('mean', 'sum', 'max', 'min', 'var', 'std')
_SCALERS = ('identity', 'amplification', 'attenuation', 'linear',
            'inverse_linear')


def supports(aggregators: Sequence[str], scalers: Sequence[str]) -> bool:
    return (all(a in _AGGS for a in aggregators)
            and all(s in _SCALERS for s in scalers))


def _forward_stats(msg, nbr_edge_ids, nbr_mask, with_ties=False):
    """(sum, sumsq, max, min [N, F], deg, cnt [N][, ties_max, ties_min])."""
    m = nbr_mask[..., None].to(msg.dtype)
    g = msg[nbr_edge_ids] * m                        # [N, D, F]
    deg = torch.sum(m, dim=1)                        # [N, 1]
    cnt = torch.clamp(deg, min=1.0)
    s = torch.sum(g, dim=1)
    sq = torch.sum(g * g, dim=1)
    zero = torch.zeros((), dtype=msg.dtype, device=msg.device)
    mx = torch.where(m > 0, g, -torch.inf).amax(dim=1)
    mx = torch.where(deg > 0, mx, zero)
    mn = torch.where(m > 0, g, torch.inf).amin(dim=1)
    mn = torch.where(deg > 0, mn, zero)
    if not with_ties:
        return s, sq, mx, mn, deg[:, 0], cnt[:, 0]
    valid = m > 0
    ties_mx = torch.clamp(((g == mx[:, None, :]) & valid).sum(
        dim=1, dtype=msg.dtype), min=1.0)
    ties_mn = torch.clamp(((g == mn[:, None, :]) & valid).sum(
        dim=1, dtype=msg.dtype), min=1.0)
    return s, sq, mx, mn, deg[:, 0], cnt[:, 0], ties_mx, ties_mn


def _assemble_raw(aggregators, s, sq, mx, mn, cnt):
    mean = s / cnt[:, None]
    var_raw = sq / cnt[:, None] - mean * mean
    var = torch.relu(var_raw)
    std = torch.sqrt(var + EPS)
    table = {'mean': mean, 'sum': s, 'max': mx, 'min': mn, 'var': var,
             'std': std}
    agg = torch.stack([table[a] for a in aggregators], dim=1)   # [N, A, F]
    return agg, (mean, var_raw, std)


def _expand(receivers, edge_mask, msg, fields, mx, mn):
    """d_msg [E, F] from the node fields: one gather of the stacked
    [N, 6F] fields, then elementwise; padded edges 0."""
    F = msg.shape[-1]
    g_lin, g_quad, g_max, g_min = fields
    fe = torch.cat([g_lin, g_quad, g_max, g_min, mx, mn], dim=-1)[receivers]
    d_msg = (fe[:, :F] + 2.0 * msg * fe[:, F:2 * F]
             + (msg == fe[:, 4 * F:5 * F]).to(msg.dtype) * fe[:, 2 * F:3 * F]
             + (msg == fe[:, 5 * F:]).to(msg.dtype) * fe[:, 3 * F:4 * F])
    if edge_mask is not None:
        d_msg = torch.where(edge_mask[:, None], d_msg,
                            torch.zeros((), dtype=d_msg.dtype,
                                        device=d_msg.device))
    return d_msg


class _RawBank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, nbr_edge_ids, nbr_mask, receivers, edge_mask,
                aggregators):
        msg32 = msg.to(torch.float32)
        s, sq, mx, mn, _, cnt, tmx, tmn = _forward_stats(
            msg32, nbr_edge_ids, nbr_mask, with_ties=True)
        out, (mean, var_raw, std) = _assemble_raw(aggregators, s, sq, mx, mn,
                                                  cnt)
        ctx.aggregators, ctx.edge_mask = aggregators, edge_mask
        ctx.save_for_backward(msg, receivers, cnt, mean, var_raw, std, mx, mn,
                              tmx, tmn)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_agg):
        (msg, receivers, cnt, mean, var_raw, std, mx, mn, tmx,
         tmn) = ctx.saved_tensors
        fields = node_fields(ctx.aggregators, d_agg.to(torch.float32), cnt,
                             mean, var_raw, std, tmx, tmn)
        d_msg = _expand(receivers, ctx.edge_mask, msg.to(torch.float32),
                        fields, mx, mn)
        return d_msg.to(msg.dtype), None, None, None, None, None


def make_raw_bank(receivers: torch.Tensor, edge_mask=None):
    """Bind the receivers (and the edge mask) the backward gathers with;
    returns ``raw(msg [E, F], nbr_edge_ids, nbr_mask, aggregators) -> Z
    [N, A, F]`` float32, aggregators in caller order.

    The degree scalers are per-node scalars, so a consumer contracts Z with
    its posttrans weights first and applies the S scaler weights to the
    narrower output, never forming the (scaler, aggregator) product."""

    def raw(msg, nbr_edge_ids, nbr_mask, aggregators):
        aggregators = tuple(aggregators)
        if torch.is_grad_enabled() and msg.requires_grad:
            return _RawBank.apply(msg, nbr_edge_ids, nbr_mask, receivers,
                                  edge_mask, aggregators)
        s, sq, mx, mn, _, cnt = _forward_stats(msg.to(torch.float32),
                                               nbr_edge_ids, nbr_mask)
        return _assemble_raw(aggregators, s, sq, mx, mn, cnt)[0]
    return raw


class _FusedBank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, nbr_edge_ids, nbr_mask, deg, receivers, edge_mask,
                aggregators, scalers, avg_d):
        s, sq, mx, mn, _, cnt, tmx, tmn = _forward_stats(
            msg, nbr_edge_ids, nbr_mask, with_ties=True)
        agg, (mean, var_raw, std) = _assemble_raw(aggregators, s, sq, mx, mn,
                                                  cnt)
        w = scaler_weights(scalers, deg, avg_d)                  # [S, N]
        ctx.aggregators, ctx.edge_mask = aggregators, edge_mask
        ctx.save_for_backward(msg, receivers, w, cnt, mean, var_raw, std, mx,
                              mn, tmx, tmn)
        return agg[:, None, :, :] * w.T[:, :, None, None]       # [N, S, A, F]

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        (msg, receivers, w, cnt, mean, var_raw, std, mx, mn, tmx,
         tmn) = ctx.saved_tensors
        d_agg = torch.einsum('nsaf,sn->naf', d_out, w)
        fields = node_fields(ctx.aggregators, d_agg, cnt, mean, var_raw, std,
                             tmx, tmn)
        d_msg = _expand(receivers, ctx.edge_mask, msg, fields, mx, mn)
        return d_msg, None, None, None, None, None, None, None, None


def make_fused_bank(receivers: torch.Tensor, edge_mask=None):
    """Bind the receivers (and the edge mask); returns ``fused(msg [E, F],
    nbr_edge_ids, nbr_mask, deg [N], aggregators, scalers, avg_d) -> [N, S,
    A, F]``: each aggregator times each scaler's weight of ``deg``."""

    def fused(msg, nbr_edge_ids, nbr_mask, deg, aggregators, scalers,
              avg_d: Dict[str, float]):
        return _FusedBank.apply(msg, nbr_edge_ids, nbr_mask, deg, receivers,
                                edge_mask, tuple(aggregators), tuple(scalers),
                                dict(avg_d))
    return fused
