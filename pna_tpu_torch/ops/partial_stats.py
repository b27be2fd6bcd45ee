"""Partial moment statistics: the aggregator bank over disjoint edge subsets.

Counterpart of ``pna_tpu/ops/partial_stats.py``.  The bank {mean, sum, max,
min, var, std} factors through the sketch (sum, sum of squares, count, max,
min), and sketches of disjoint edge subsets combine exactly.  The
distributed layer's ``overlap`` path uses it: it aggregates the edges whose
sender is local while the halo exchange is in flight, then the boundary
edges, and combines the two (``parallel/partition.py::SplitEdges``).

Plain torch, as the JAX package computes it with ``jax.ops.segment_*`` and
no kernel: ``index_add_`` for the sums and ``scatter_reduce`` ('amax',
'amin', ``include_self=False``) for the extremes, whose gradient, like
JAX's, is shared equally among tied edges.  An empty node's max is -BIG and
its min +BIG in the sketch, and 0 in the bank; EPS sits inside the std
root and the variance is clamped at 0, as in the segment bank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

EPS = 1e-5
BIG = 3.0e38

SUPPORTED = ('mean', 'sum', 'max', 'min', 'var', 'std')


def supports(aggregators: Sequence[str]) -> bool:
    return all(a in SUPPORTED for a in aggregators)


class MomentSketch(NamedTuple):
    s: torch.Tensor      # [N, F] sum
    sq: torch.Tensor     # [N, F] sum of squares
    cnt: torch.Tensor    # [N] edge count
    mx: torch.Tensor     # [N, F] max (-BIG when empty)
    mn: torch.Tensor     # [N, F] min (+BIG when empty)


def partial_sketch(msg: torch.Tensor, receivers: torch.Tensor,
                   num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> MomentSketch:
    """The sketch of one edge subset: msg [E, F] -> per-node partials."""
    msg = msg.to(torch.float32)
    n, f = num_segments, msg.shape[1]
    idx = receivers.long()
    if mask is not None:
        m = mask[:, None]
        s_in = torch.where(m, msg, 0.0)
        mx_in = torch.where(m, msg, -BIG)
        mn_in = torch.where(m, msg, BIG)
        ones = mask.to(torch.float32)
    else:
        s_in, mx_in, mn_in = msg, msg, msg
        ones = msg.new_ones(msg.shape[0])
    s = msg.new_zeros(n, f).index_add(0, idx, s_in)
    sq = msg.new_zeros(n, f).index_add(0, idx, s_in * msg)
    cnt = msg.new_zeros(n).index_add(0, idx, ones)
    wide = idx[:, None].expand(-1, f)
    mx = msg.new_full((n, f), -BIG).scatter_reduce(
        0, wide, mx_in, 'amax', include_self=False)
    mn = msg.new_full((n, f), BIG).scatter_reduce(
        0, wide, mn_in, 'amin', include_self=False)
    return MomentSketch(s, sq, cnt, torch.clamp(mx, min=-BIG),
                        torch.clamp(mn, max=BIG))


def combine(a: MomentSketch, b: MomentSketch) -> MomentSketch:
    return MomentSketch(a.s + b.s, a.sq + b.sq, a.cnt + b.cnt,
                        torch.maximum(a.mx, b.mx), torch.minimum(a.mn, b.mn))


def finalize_bank(sk: MomentSketch,
                  aggregators: Sequence[str]) -> torch.Tensor:
    """Sketch -> Z [N, A, F] with the reference bank's semantics."""
    cnt1 = torch.clamp(sk.cnt, min=1.0)[:, None]
    nonempty = (sk.cnt > 0)[:, None]
    mean = sk.s / cnt1
    table = {}

    def get(name):
        if name in table:
            return table[name]
        if name == 'sum':
            v = sk.s
        elif name == 'mean':
            v = mean
        elif name == 'max':
            v = torch.where(nonempty, sk.mx, 0.0)
        elif name == 'min':
            v = torch.where(nonempty, sk.mn, 0.0)
        elif name == 'var':
            v = torch.relu(sk.sq / cnt1 - mean * mean)
        elif name == 'std':
            v = torch.sqrt(get('var') + EPS)
        else:
            raise ValueError(name)
        table[name] = v
        return v

    return torch.stack([get(a) for a in aggregators], dim=1)
