"""The two collectives of the distributed step, differentiable, and the
gradient all-reduce.

JAX differentiates the whole SPMD step at once; the port runs one process per
rank, so each collective carries its own backward, written here over
``torch.distributed`` calls:

* ``all_reduce`` (sum): the backward is an ``all_reduce`` (sum) of the
  cotangents.  It serves the graph readout's ``psum``, the node-level loss's
  and the batch-norm statistics' (``nn/sparse.py::MaskedBatchNorm``);
* ``all_to_all``: ``all_to_all_single`` over equal chunks; the backward is the
  reverse ``all_to_all_single``, which for equal chunks is the same
  exchange.  ``all_to_all_async`` starts it with ``async_op=True`` and
  returns a handle whose ``wait()`` gives the differentiable result, so
  that work can be issued between the two (the layer's ``overlap`` path).

The gradient rule.  Every rank back-propagates its replicated loss scaled
by ``1 / (d_graph * d_data)`` (``loss_scale``), then ``all_reduce_grads``
sums the parameter gradients over every rank.  That is reverse mode of the
one objective the JAX step differentiates: the mean over the data axis of a
loss that the graph axis computes together.  Each rank's copy of the loss
sends its cotangent into the readout's ``all_reduce``, whose backward sums
the ``d_graph`` copies, hence the ``1 / d_graph``.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its gradient is the sum
    of the ranks' cotangents."""
    return _AllReduce.apply(x, group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAllDone(torch.autograd.Function):
    """The result of an exchange started by ``all_to_all_async``: waits in
    the forward; the backward sends the cotangents back."""

    @staticmethod
    def forward(ctx, x, out, work, group):
        ctx.group = group
        work.wait()
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None, None, None


class PendingExchange:
    """An ``all_to_all`` in flight; ``wait()`` gives its result."""

    def __init__(self, x, out, work, group):
        self.x, self.out, self.work, self.group = x, out, work, group

    def wait(self) -> torch.Tensor:
        return _AllToAllDone.apply(self.x, self.out, self.work, self.group)


def all_to_all_async(x: torch.Tensor, group=None) -> PendingExchange:
    """Start the exchange of ``x`` [P * H, ...]: chunk q of rank p becomes
    chunk p of rank q."""
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, group=group, async_op=True)
    return PendingExchange(x, out, work, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The exchange of ``all_to_all_async``, waited for."""
    return all_to_all_async(x, group).wait()


def loss_scale(d_graph: int, d_data: int) -> float:
    """The factor each rank multiplies its replicated loss by before
    ``backward``."""
    return 1.0 / (d_graph * d_data)


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group: Optional[object] = None) -> None:
    """Sum every parameter's gradient over the ranks of ``group`` (the whole
    world by default), one flat buffer for all of them.  A parameter
    without a gradient gets zeros, so every rank sends the same layout."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n
