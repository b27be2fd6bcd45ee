"""Segment reductions over rows of a tensor keyed by segment ids.

Counterpart of ``pna_tpu/ops/segment.py`` (sum, count, mean, max, min, var,
std, softmax weights, moments), written with ``index_add_`` and
``scatter_reduce``.  Empty segments give 0; ``mask`` drops rows; EPS sits
inside the sqrt of std, which relu-clamps the variance (``segment_var``
clamps unless told not to, as PyG's var does not).  ``gather_rows`` is the
port's row gather: every gather that autograd tracks goes through it.
These functions are the plain versions the CSR kernels are held against
(``pna_tpu_torch/ops/csr_kernels.py``).
"""

from __future__ import annotations

import torch

EPS = 1e-5


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` as ``index_select``, whose backward adds the rows'
    gradients with ``index_add_``: the backward of ``x[index]``
    (``index_put_`` with accumulate) sorts the index and adds each row's
    duplicates one after another, which a power-law sender of 380,000 edges
    turns into most of a step on the card (and, split over threads, into
    sums of varying order on the CPU)."""
    return torch.index_select(x, 0, index.long())


def _apply_mask(data, mask, fill):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, torch.as_tensor(fill, dtype=data.dtype,
                                                device=data.device))


def segment_sum(data, segment_ids, num_segments, mask=None):
    data = _apply_mask(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


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
