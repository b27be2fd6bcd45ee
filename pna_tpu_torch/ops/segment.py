"""Segment reductions over rows of a tensor keyed by segment ids.

Counterpart of ``pna_tpu/ops/segment.py`` (sum, count, mean, max, min, var,
std, softmax weights, moments).  Sums of float32 and bfloat16 rows on the
card go through the port's deterministic row sum
(``ops/rowsum.py::sorted_row_sum``, a CUDA kernel over the index's stable
sort, one writer per row, summed in float32); on the CPU, and for other
types, they are ``index_add_`` (``segment_sum_plain``), which adds in index
order there.  Max and min are ``scatter_reduce``.  Empty segments give 0;
``mask`` drops rows; EPS sits inside the sqrt of std, which relu-clamps the
variance (``segment_var`` clamps unless told not to, as PyG's var does not).
``gather_rows`` is the port's row gather: every gather that autograd tracks
goes through it.  ``segment_sum_plain`` is what the plain versions of the
CSR kernels are built on (``pna_tpu_torch/ops/csr_kernels.py``), so that
holding a kernel to its plain version on the card launches no row sum.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops import rowsum

EPS = 1e-5
# the types the row-sum kernel takes; a float64 sum on the card (only the card
# tests' float64 reference steps run one) keeps index_add_
_ROW_SUM_DTYPES = (torch.float32, torch.bfloat16)


def _on_kernel(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and x.dtype in _ROW_SUM_DTYPES


def _row_sum(data, index, n, ptr=None):
    """out[k] = sum of data[i] over index[i] == k, [n, ...], by the kernel:
    over ``ptr`` where the caller knows ``index`` is sorted with those row
    pointers (within ``[ptr[0], ptr[n])``; the index is then its own keys),
    else over the index's kept layout."""
    if ptr is None:
        perm, ptr, keys = rowsum.index_layout(index, n)
    elif ptr.shape != (n + 1,):
        raise ValueError(f"row pointers {tuple(ptr.shape)} for {n} rows")
    else:
        perm, ptr, keys = None, ptr.to(torch.int32), index.reshape(-1)
        if keys.dtype not in (torch.int32, torch.int64):
            keys = keys.long()
        keys = keys.contiguous()
    flat = data.reshape(data.shape[0], -1).contiguous()
    return rowsum.sorted_row_sum(flat, perm, ptr, keys).reshape(
        (n,) + data.shape[1:])


class _GatherRows(torch.autograd.Function):
    """index_select forward; the backward adds the rows' gradients with the
    row-sum kernel."""

    @staticmethod
    def forward(ctx, x, index, ptr):
        ctx.n, ctx.index, ctx.ptr = x.shape[0], index, ptr
        return torch.index_select(x, 0, index.long())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _row_sum(g, ctx.index, ctx.n, ctx.ptr), None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[index]`` as ``index_select``.  Its backward adds each row's
    gradients: on the card (float32, bfloat16) with the deterministic row sum
    of ``ops/rowsum.py``, over ``ptr`` [N+1] where the caller passes the row
    pointers of a sorted index (``Graph.edge_ptr`` for the receivers of a CSR
    batch), else over the index's stable sort, kept on the index tensor; on
    the CPU with ``index_add_`` (index_select's own backward), which adds in
    index order.  Not ``x[index]``: its backward (``index_put_`` with
    accumulate) adds each row's duplicates one after another, which a
    power-law sender of 380,000 edges turns into most of a step on the card
    (and, split over threads, into sums of varying order on the CPU)."""
    if _on_kernel(x) and torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, index, ptr)
    return torch.index_select(x, 0, index.long())


def _apply_mask(data, mask, fill):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, torch.as_tensor(fill, dtype=data.dtype,
                                                device=data.device))


def segment_sum_plain(data, segment_ids, num_segments, mask=None):
    """The sum with ``index_add_``: the CPU's path, and the one the CSR
    kernels' plain versions take on any device."""
    data = _apply_mask(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


class _SegmentSum(torch.autograd.Function):
    """The row-sum kernel forward; the backward gathers the rows of the
    gradient (``index_select``)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.segment_ids = segment_ids
        return _row_sum(data, segment_ids, num_segments)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (torch.index_select(g, 0, ctx.segment_ids.long()), None,
                None)


def segment_sum(data, segment_ids, num_segments, mask=None):
    """Per-segment sums; on the card the row-sum kernel (its backward a row
    gather), elsewhere ``segment_sum_plain``."""
    if not _on_kernel(data):
        return segment_sum_plain(data, segment_ids, num_segments, mask)
    return _SegmentSum.apply(_apply_mask(data, mask, 0.0), segment_ids,
                             num_segments)


def segment_count(segment_ids, num_segments, mask=None,
                  dtype=torch.float32):
    ones = torch.ones(segment_ids.shape, dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data, segment_ids, num_segments, mask=None, count=None):
    s = segment_sum(data, segment_ids, num_segments, mask)
    if count is None:
        count = segment_count(segment_ids, num_segments, mask,
                              dtype=data.dtype)
    denom = torch.clamp(count, min=1.0)
    return s / denom.reshape(denom.shape + (1,) * (s.ndim - denom.ndim))


def _segment_extreme(data, segment_ids, num_segments, mask, reduce, fill):
    masked = _apply_mask(data, mask, fill)
    idx = segment_ids.reshape(segment_ids.shape
                              + (1,) * (data.ndim - 1)).expand_as(masked)
    out = torch.full((num_segments,) + data.shape[1:], fill,
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, idx, masked, reduce=reduce, include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_max(data, segment_ids, num_segments, mask=None):
    """Max over segments; empty segments give 0 (not -inf)."""
    return _segment_extreme(data, segment_ids, num_segments, mask, 'amax',
                            float('-inf'))


def segment_min(data, segment_ids, num_segments, mask=None):
    return _segment_extreme(data, segment_ids, num_segments, mask, 'amin',
                            float('inf'))


def segment_var(data, segment_ids, num_segments, mask=None, count=None,
                relu_clamp: bool = True):
    """relu(E[X^2] - E[X]^2) per segment; without ``relu_clamp`` the raw
    difference, which float rounding can make slightly negative."""
    if count is None:
        count = segment_count(segment_ids, num_segments, mask,
                              dtype=data.dtype)
    mean = segment_mean(data, segment_ids, num_segments, mask, count)
    mean_sq = segment_mean(data * data, segment_ids, num_segments, mask, count)
    var = mean_sq - mean * mean
    return torch.relu(var) if relu_clamp else var


def segment_std(data, segment_ids, num_segments, mask=None, count=None):
    """sqrt(relu(var) + EPS)."""
    return torch.sqrt(segment_var(data, segment_ids, num_segments, mask,
                                  count) + EPS)


def segment_softmax_weights(logits, segment_ids, num_segments, mask=None):
    """Per-segment softmax weights over the rows ([E, ...] -> [E, ...]),
    each segment's max subtracted first (the JAX ``stable=True`` form; 0 for
    an empty segment, so its masked rows stay finite); masked rows weigh
    0."""
    logits = logits - gather_rows(
        segment_max(logits, segment_ids, num_segments, mask), segment_ids)
    ex = _apply_mask(torch.exp(logits), mask, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    denom = torch.clamp(denom, min=torch.finfo(ex.dtype).tiny)
    return ex / gather_rows(denom, segment_ids)


def segment_moment(data, segment_ids, num_segments, n: int, mask=None,
                   count=None):
    """sign(m_n) * (|m_n| + EPS)^(1/n) with m_n = E[(X - E[X])^n] per
    segment."""
    if count is None:
        count = segment_count(segment_ids, num_segments, mask,
                              dtype=data.dtype)
    mean = segment_mean(data, segment_ids, num_segments, mask, count)
    centered = data - gather_rows(mean, segment_ids)
    m_n = segment_mean(centered ** n, segment_ids, num_segments, mask, count)
    return torch.sign(m_n) * torch.pow(torch.abs(m_n) + EPS, 1.0 / n)
