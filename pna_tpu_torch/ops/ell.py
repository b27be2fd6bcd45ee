"""Aggregators over the ELL layout: a gather and a masked reduction over a
static axis.

Counterpart of ``pna_tpu/ops/ell.py``.  ``EllCtx.create`` gathers the
messages of each node's in-edges into [N, D, F] (``Graph.nbr_edge_ids``,
slots past the node's degree masked to 0) and computes what every aggregator
shares: the degree, the count clamped to 1 and the mean.  The aggregators of
``ELL_AGGREGATORS`` reduce over the D axis with the segment bank's numerics
(``ops/aggregators.py``): EPS inside the roots, a relu-clamped variance, an
empty row gives 0.  Max and min take ``torch.amax``/``torch.amin``, whose
gradient splits evenly among tied entries, as JAX's does.  Autograd runs
through the gather (``segment.gather_rows``), whose backward adds each
slot's gradient into its edge (``index_add_``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from pna_tpu_torch.ops.segment import gather_rows

EPS = 1e-5


@dataclass
class EllCtx:
    """What a bank of ELL aggregations shares."""
    g: torch.Tensor         # [N, D, F] gathered messages, masked slots 0
    m: torch.Tensor         # [N, D, 1] float mask
    cnt: torch.Tensor       # [N, 1] degree clamped to >= 1
    raw_cnt: torch.Tensor   # [N, 1] degree
    mean: torch.Tensor      # [N, F]
    self_msg: Optional[torch.Tensor] = None     # [N, F] (identity)
    senders_ell: Optional[torch.Tensor] = None  # [N, D] (normalised_mean)
    out_deg: Optional[torch.Tensor] = None      # [N] (normalised_mean)

    @classmethod
    def create(cls, msg, nbr_edge_ids, nbr_mask, self_msg=None,
               senders=None, out_deg=None) -> "EllCtx":
        m = nbr_mask[..., None].to(msg.dtype)
        # every padded slot repeats edge 0, so x[index]'s backward would add
        # those duplicates one after another (the flagship step on 'generic'
        # over the ELL table: 566.9 ms of device time on an H100 before,
        # 22.2 ms after)
        g = gather_rows(msg, nbr_edge_ids.reshape(-1)).reshape(
            nbr_edge_ids.shape + msg.shape[1:]) * m
        raw_cnt = torch.sum(m, dim=1)
        cnt = torch.clamp(raw_cnt, min=1.0)
        mean = torch.sum(g, dim=1) / cnt
        senders_ell = None if senders is None else senders[nbr_edge_ids]
        return cls(g=g, m=m, cnt=cnt, raw_cnt=raw_cnt, mean=mean,
                   self_msg=self_msg, senders_ell=senders_ell,
                   out_deg=out_deg)


def _fill(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def ell_sum(ctx: EllCtx):
    return torch.sum(ctx.g, dim=1)


def ell_mean(ctx: EllCtx):
    return ctx.mean


def ell_max(ctx: EllCtx):
    out = torch.amax(torch.where(ctx.m > 0, ctx.g, _fill(ctx.g, -torch.inf)),
                     dim=1)
    return torch.where(ctx.raw_cnt > 0, out, _fill(out, 0.0))


def ell_min(ctx: EllCtx):
    out = torch.amin(torch.where(ctx.m > 0, ctx.g, _fill(ctx.g, torch.inf)),
                     dim=1)
    return torch.where(ctx.raw_cnt > 0, out, _fill(out, 0.0))


def ell_var(ctx: EllCtx):
    mean_sq = torch.sum(ctx.g * ctx.g, dim=1) / ctx.cnt
    return torch.relu(mean_sq - ctx.mean * ctx.mean)


def ell_std(ctx: EllCtx):
    return torch.sqrt(ell_var(ctx) + EPS)


def ell_identity(ctx: EllCtx):
    if ctx.self_msg is None:
        raise ValueError("identity aggregator requires self_msg")
    return ctx.self_msg


def ell_moment(ctx: EllCtx, n: int = 3):
    centered = (ctx.g - ctx.mean[:, None, :]) * ctx.m
    m_n = torch.sum(centered ** n, dim=1) / ctx.cnt
    return torch.sign(m_n) * torch.pow(torch.abs(m_n) + EPS, 1.0 / n)


def ell_softmax(ctx: EllCtx):
    mx = torch.amax(torch.where(ctx.m > 0, ctx.g, _fill(ctx.g, -torch.inf)),
                    dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, _fill(mx, 0.0))
    w = torch.exp(ctx.g - mx) * ctx.m
    # an empty row divides by 1, not by a tiny number: the division's
    # backward squares the denominator, and a tiny one underflows to 0
    denom = torch.where(ctx.raw_cnt > 0, torch.sum(w, dim=1),
                        _fill(w, 1.0))
    return torch.sum(w * ctx.g, dim=1) / denom


def ell_softmin(ctx: EllCtx):
    return -ell_softmax(dataclasses.replace(ctx, g=-ctx.g, mean=-ctx.mean))


def ell_normalised_mean(ctx: EllCtx):
    if ctx.senders_ell is None or ctx.out_deg is None:
        raise ValueError("normalised_mean requires senders_ell/out_deg")
    r_in = torch.rsqrt(torch.clamp(ctx.raw_cnt, min=1e-30))      # [N, 1]
    r_out = torch.rsqrt(torch.clamp(ctx.out_deg, min=1e-30))     # [N]
    w = r_out[ctx.senders_ell][..., None] * ctx.m                # [N, D, 1]
    return torch.sum(ctx.g * w, dim=1) * r_in


ELL_AGGREGATORS: Dict[str, Callable] = {
    'mean': ell_mean,
    'sum': ell_sum,
    'max': ell_max,
    'min': ell_min,
    'identity': ell_identity,
    'std': ell_std,
    'var': ell_var,
    'normalised_mean': ell_normalised_mean,
    'softmax': ell_softmax,
    'softmin': ell_softmin,
    'moment3': lambda c: ell_moment(c, 3),
    'moment4': lambda c: ell_moment(c, 4),
    'moment5': lambda c: ell_moment(c, 5),
}
