"""Aggregation over the degree-bucketed layout: dense reductions over a
static axis, no gather and no scatter.

Counterpart of ``pna_tpu/ops/bucketed.py``.  In a batch from
``graph.batch_graphs(bucket_by_degree=True)``, class (d, c) of
``bucket_spec`` owns a contiguous range of c * d edges whose view [c, d, F]
holds in row k the d in-edge messages of node ``node_off + k``.  Every
aggregator then reduces over the d axis; the receiver-side gather
``h[receivers]`` is a broadcast (``expand_to_edges``), whose backward is a
sum over the same axis.  A node whose true degree (``in_deg``) is below its
class width has its dummy slots masked by comparing the slot index with the
degree; no mask tensor is stored.

* ``raw_bank``: every aggregator of ``SUPPORTED`` -> Z [N, A, F] float32,
  autograd through the reductions;
* ``moment_stats`` and ``derive_aggregator``: the same sums, sums of
  squares, maxima and minima, from which each aggregator of
  ``MOMENT_DERIVABLE`` is derived elementwise where it is used, so that the
  stacked Z is never formed;
* ``fused_raw_bank``: the moment sketch of each class in one pass, with a
  hand-written backward (a ``torch.autograd.Function``) that broadcasts the
  node fields of ``csr_bank.node_fields`` back over each class view.

Numerics are the segment bank's: EPS inside the roots, a relu-clamped
variance, softmax weights with the row maximum subtracted, and exactly 0
for a node of degree 0 (std included).  Masked max/min use -inf/+inf in
``raw_bank`` and ``moment_stats`` and the finite +-``BIG`` in
``fused_raw_bank``, where the JAX package uses each.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops.csr_bank import node_fields

EPS = 1e-5
BIG = 3.0e38          # finite stand-in for +-inf (reduction identities)

Spec = Tuple[Tuple[int, int], ...]

# aggregators of the fused bank and of the moment path
FUSED = ('mean', 'sum', 'max', 'min', 'var', 'std')
MOMENT_DERIVABLE = FUSED

# aggregators computable over a dense [c, d, F] class view
SUPPORTED = ('mean', 'sum', 'max', 'min', 'var', 'std',
             'moment3', 'moment4', 'moment5', 'softmax', 'softmin')


def supports(aggregators: Sequence[str]) -> bool:
    return all(a in SUPPORTED for a in aggregators)


def degrees(spec: Spec) -> np.ndarray:
    """The per-node in-degree the spec implies (each node its class
    width)."""
    return np.concatenate([np.full(c, d, np.float32) for d, c in spec])


def expand_to_edges(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Per-node rows broadcast to their in-edges: [N, ...] -> [E, ...], the
    bucketed form of ``x[graph.receivers]``."""
    parts = []
    off = 0
    for d, c in spec:
        if d > 0:
            seg = x[off:off + c]
            parts.append(seg[:, None].expand((c, d) + x.shape[1:])
                         .reshape((c * d,) + x.shape[1:]))
        off += c
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def _bucket_views(msg, spec, in_deg):
    """Yield (d, c, seg [c, d, F] float32, cnt [c, 1], mask [c, d, 1] or
    None, node_off) per class; seg, cnt and mask are None for class 0."""
    F = msg.shape[-1]
    eoff = noff = 0
    for d, c in spec:
        if d == 0:
            yield d, c, None, None, None, noff
            noff += c
            continue
        seg = msg[eoff:eoff + c * d].reshape(c, d, F).to(torch.float32)
        eoff += c * d
        if in_deg is None:
            cnt = torch.full((c, 1), float(d), dtype=torch.float32,
                             device=msg.device)
            m = None
        else:
            cnt = in_deg[noff:noff + c].to(torch.float32)[:, None]
            iota = torch.arange(d, dtype=torch.float32, device=msg.device)
            m = iota[None, :, None] < cnt[:, :, None]
        yield d, c, seg, cnt, m, noff
        noff += c


def _masked(x, m, fill=0.0):
    return x if m is None else torch.where(m, x, fill)


def raw_bank(msg: torch.Tensor, spec: Spec, aggregators: Sequence[str],
             in_deg: torch.Tensor = None) -> torch.Tensor:
    """Aggregators over bucketed edge messages -> Z [N, A, F] float32,
    aggregators in caller order; ``in_deg`` [N] masks the dummy slots of
    nodes whose degree is below their class width."""
    F = msg.shape[-1]
    out = []
    for d, c, seg, cnt, m, _ in _bucket_views(msg, spec, in_deg):
        if seg is None:
            out.append(torch.zeros((c, len(aggregators), F),
                                   dtype=torch.float32, device=msg.device))
            continue
        cnt1 = torch.clamp(cnt, min=1.0)
        nonempty = cnt > 0
        stats: Dict[str, torch.Tensor] = {}

        def get(name):
            if name in stats:
                return stats[name]
            if name == 'sum':
                v = torch.sum(_masked(seg, m), dim=1)
            elif name == 'mean':
                v = get('sum') / cnt1
            elif name == 'max':
                v = torch.amax(_masked(seg, m, -torch.inf), dim=1)
                v = torch.where(nonempty, v, 0.0)
            elif name == 'min':
                v = torch.amin(_masked(seg, m, torch.inf), dim=1)
                v = torch.where(nonempty, v, 0.0)
            elif name == 'var':
                v = torch.relu(torch.sum(_masked(seg * seg, m), dim=1) / cnt1
                               - get('mean') ** 2)
            elif name == 'std':
                v = torch.sqrt(get('var') + EPS)
            elif name.startswith('moment'):
                n = int(name[len('moment'):])
                ctr = _masked(seg - get('mean')[:, None], m)
                mom = torch.sum(ctr ** n, dim=1) / cnt1
                v = torch.sign(mom) * torch.pow(torch.abs(mom) + EPS, 1.0 / n)
            elif name in ('softmax', 'softmin'):
                z = seg if name == 'softmax' else -seg
                zmax = torch.amax(_masked(z, m, -torch.inf), dim=1,
                                  keepdim=True)
                zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
                ex = _masked(torch.exp(z - zmax), m)
                denom = torch.where(cnt > 0, torch.sum(ex, dim=1), 1.0)
                v = torch.sum(ex * seg, dim=1) / denom
            else:
                raise ValueError(name)
            stats[name] = v
            return v

        out.append(torch.stack([get(a) for a in aggregators], dim=1))
    return torch.cat(out, dim=0)


def moment_stats(msg: torch.Tensor, spec: Spec, in_deg: torch.Tensor = None):
    """The moment sketch over bucketed edge messages: ``(s, sq, mx, mn, cnt1,
    d0)``, the sum, sum of squares, max and min [N, F] float32 (0 for an
    empty row), the count clamped to 1 [N, 1], and the numpy [N] bool mask
    of the degree-0 class's slots, whose aggregators are exactly 0."""
    F = msg.shape[-1]
    ss, sqs, mxs, mns, cnts = [], [], [], [], []
    d0 = np.zeros(sum(c for _, c in spec), bool)
    for d, c, seg, cnt, m, noff in _bucket_views(msg, spec, in_deg):
        if seg is None:
            d0[noff:noff + c] = True
            z = torch.zeros((c, F), dtype=torch.float32, device=msg.device)
            ss.append(z), sqs.append(z), mxs.append(z), mns.append(z)
            cnts.append(torch.ones((c, 1), dtype=torch.float32,
                                   device=msg.device))
            continue
        nonempty = cnt > 0
        ss.append(torch.sum(_masked(seg, m), dim=1))
        sqs.append(torch.sum(_masked(seg * seg, m), dim=1))
        mxs.append(torch.where(
            nonempty, torch.amax(_masked(seg, m, -torch.inf), dim=1), 0.0))
        mns.append(torch.where(
            nonempty, torch.amin(_masked(seg, m, torch.inf), dim=1), 0.0))
        cnts.append(torch.clamp(cnt, min=1.0))

    def cat(xs):
        return torch.cat(xs, dim=0) if len(xs) > 1 else xs[0]
    return cat(ss), cat(sqs), cat(mxs), cat(mns), cat(cnts), d0


def derive_aggregator(name: str, s, sq, mx, mn, cnt1, d0) -> torch.Tensor:
    """One aggregator [N, F] from the moment sketch, with ``raw_bank``'s
    formulas (std 0, not sqrt(EPS), on the degree-0 class)."""
    if name == 'sum':
        return s
    if name == 'mean':
        return s / cnt1
    if name == 'max':
        return mx
    if name == 'min':
        return mn
    mean = s / cnt1
    var = torch.relu(sq / cnt1 - mean * mean)
    if name == 'var':
        return var
    if name == 'std':
        std = torch.sqrt(var + EPS)
        if d0.any():
            std = torch.where(torch.from_numpy(d0).to(std.device)[:, None],
                              0.0, std)
        return std
    raise ValueError(name)


def _variadic_stats(seg, m):
    """(sum, sum of squares, max, min) of one class view, masked slots
    taking the reductions' identities (0, 0, -BIG, BIG)."""
    s_in = _masked(seg, m)
    sq_in = s_in * seg
    return (torch.sum(s_in, dim=1), torch.sum(sq_in, dim=1),
            torch.amax(_masked(seg, m, -BIG), dim=1),
            torch.amin(_masked(seg, m, BIG), dim=1))


def _fwd_impl(msg, in_deg, spec, aggregators, with_ties):
    F = msg.shape[-1]
    A = len(aggregators)
    dev = msg.device
    outs = []
    res = {k: [] for k in ('mean', 'var_raw', 'std', 'mx', 'mn', 'tmx', 'tmn',
                           'cnt')}
    for d, c, seg, cnt, m, noff in _bucket_views(msg, spec, in_deg):
        if seg is None:
            outs.append(torch.zeros((c, A, F), dtype=torch.float32,
                                    device=dev))
            zero = torch.zeros((c, F), dtype=torch.float32, device=dev)
            one = torch.ones((c, F), dtype=torch.float32, device=dev)
            for k in ('mean', 'var_raw', 'mx', 'mn'):
                res[k].append(zero)
            res['std'].append(torch.full((c, F), float(np.sqrt(EPS)),
                                         dtype=torch.float32, device=dev))
            res['tmx'].append(one)
            res['tmn'].append(one)
            res['cnt'].append(torch.ones((c,), dtype=torch.float32,
                                         device=dev))
            continue
        s, sq, mx, mn = _variadic_stats(seg, m)
        nonempty = cnt > 0
        mx = torch.where(nonempty, mx, 0.0)
        mn = torch.where(nonempty, mn, 0.0)
        cnt1 = torch.clamp(cnt, min=1.0)
        mean = s / cnt1
        var_raw = sq / cnt1 - mean * mean
        var = torch.relu(var_raw)
        std = torch.sqrt(var + EPS)
        table = {'mean': mean, 'sum': s, 'max': mx, 'min': mn, 'var': var,
                 'std': std}
        outs.append(torch.stack([table[a] for a in aggregators], dim=1))
        if with_ties:
            eq_mx = _masked(seg == mx[:, None], m, False)
            eq_mn = _masked(seg == mn[:, None], m, False)
            res['tmx'].append(torch.clamp(
                eq_mx.sum(dim=1, dtype=torch.float32), min=1.0))
            res['tmn'].append(torch.clamp(
                eq_mn.sum(dim=1, dtype=torch.float32), min=1.0))
        res['mean'].append(mean)
        res['var_raw'].append(var_raw)
        res['std'].append(std)
        res['mx'].append(mx)
        res['mn'].append(mn)
        res['cnt'].append(cnt1[:, 0])
    Z = torch.cat(outs, dim=0)
    if not with_ties:
        return Z, None
    return Z, {k: torch.cat(v, dim=0) for k, v in res.items()}


class _FusedRawBank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, in_deg, spec, aggregators):
        Z, r = _fwd_impl(msg, in_deg, spec, aggregators, with_ties=True)
        ctx.spec, ctx.aggregators = spec, aggregators
        ctx.save_for_backward(msg, in_deg, r['mean'], r['var_raw'], r['std'],
                              r['mx'], r['mn'], r['tmx'], r['tmn'], r['cnt'])
        return Z

    @staticmethod
    @once_differentiable
    def backward(ctx, d_Z):
        (msg, in_deg, mean, var_raw, std, mx, mn, tmx, tmn,
         cnt1) = ctx.saved_tensors
        g_lin, g_quad, g_max, g_min = node_fields(
            ctx.aggregators, d_Z.to(torch.float32), cnt1, mean, var_raw, std,
            tmx, tmn)
        parts = []
        for d, c, seg, cnt, m, noff in _bucket_views(msg, ctx.spec, in_deg):
            if seg is None:
                continue
            sl = slice(noff, noff + c)
            dm = (g_lin[sl][:, None] + 2.0 * seg * g_quad[sl][:, None]
                  + (seg == mx[sl][:, None]).to(torch.float32)
                  * g_max[sl][:, None]
                  + (seg == mn[sl][:, None]).to(torch.float32)
                  * g_min[sl][:, None])
            parts.append(_masked(dm, m).reshape(c * d, -1))
        d_msg = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        return d_msg.to(msg.dtype), None, None, None


def fused_raw_bank(msg: torch.Tensor, in_deg: torch.Tensor, spec: Spec,
                   aggregators: Sequence[str]) -> torch.Tensor:
    """``raw_bank`` for aggregators in ``FUSED``, its backward written by
    hand: broadcasts and elementwise work over each class view, no gather
    and no scatter."""
    aggregators = tuple(aggregators)
    if torch.is_grad_enabled() and msg.requires_grad:
        return _FusedRawBank.apply(msg, in_deg, spec, aggregators)
    return _fwd_impl(msg, in_deg, spec, aggregators, with_ties=False)[0]
