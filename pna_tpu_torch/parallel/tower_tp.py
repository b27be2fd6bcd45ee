"""Tower tensor parallelism for the fused PNA layer.

Counterpart of ``pna_tpu/parallel/tower_tp.py``.  PNA towers are independent
channel groups that only the mixing layer couples, so the tower axis of
``PNALayerFused``'s stacked pretrans and posttrans weights is a natural unit
to split: with ``PNALayerFused(tp_group=group)`` each rank of ``group``
holds ``towers / tp`` towers (rank r the r-th block, the JAX
``tower_param_specs`` rule), computes them end to end (pretrans,
aggregation, posttrans) and the tower outputs are gathered once, before the
batch norm and the mixing layer, whose weights every rank holds whole.

``gather_towers`` is that all-gather.  Its backward is the adjoint, a sum of
the ranks' cotangents for this rank's block (an all-reduce, then the block),
so the collectives' gradient rule holds: each rank back-propagates its
replicated loss divided by ``tp``, the replicated parameters' gradients are
summed over the group (``collectives.all_reduce_grads``), and a tower's
gradient is whole on its rank.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

STACKED = ('pretrans', 'posttrans')


def group_shape(group):
    """(ranks, this rank's index) of a process group; (1, 0) for None."""
    if group is None:
        return 1, 0
    if isinstance(group, str):
        raise TypeError(f"tp_group takes a process group, not the mesh axis "
                        f"name {group!r} the JAX layer takes")
    return dist.get_world_size(group), dist.get_rank(group)


def is_stacked(name: str, tensor: torch.Tensor) -> bool:
    """Whether a state-dict entry is a stacked tower weight, split over the
    tower axis (its first)."""
    return tensor.ndim >= 1 and any(p in STACKED for p in name.split('.'))


def tower_param_specs(state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """For each entry of a state dict: True where its first (tower) axis is
    split over the group, False where every rank holds it whole."""
    return {k: is_stacked(k, v) for k, v in state.items()}


def shard_tower_state(state: Mapping[str, torch.Tensor], rank: int,
                      tp: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s part of a whole state dict: the ``rank``-th of ``tp``
    blocks of every stacked tower weight, the rest whole."""
    out = {}
    for k, v in state.items():
        if is_stacked(k, v):
            n = v.shape[0] // tp
            v = v[rank * n:(rank + 1) * n]
        out[k] = v.clone()
    return out


def keep_towers(stacked: nn.Module, rank: int, n_local: int) -> None:
    """Replace every parameter of a ``StackedParams`` by this rank's block of
    ``n_local`` towers."""
    for name, p in list(stacked.named_parameters(recurse=False)):
        block = p.detach()[rank * n_local:(rank + 1) * n_local].clone()
        setattr(stacked, name, nn.Parameter(block))


class _GatherTowers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), None


def gather_towers(x: torch.Tensor, group) -> torch.Tensor:
    """[..., local towers * Fo] of each rank -> [..., towers * Fo], the
    blocks in rank order (which is tower order)."""
    return _GatherTowers.apply(x, group)
