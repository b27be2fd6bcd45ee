"""Degree scalers and the avg_d statistics.

Counterpart of the degree-vector half of ``pna_tpu/ops/scalers.py``
(``SCALERS``, ``avg_d_from_degree_hist``, ``avg_d_from_degrees``) and of
``pna_tpu/ops/fused_vjp.py::_scaler_weights``.  A scaler ``f(X, deg, avg_d)``
multiplies ``X [N, ..., F]`` by a per-node weight of the in-degree ``deg``
(``[N]``, or already shaped to broadcast against ``X``); deg == 0 is guarded
to weight 1 for the inverse scalers (PyG semantics).  ``scaler_weights`` is
the same weights stacked as ``[S, N]``, for the fused layer.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch


def _col(deg: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return deg[..., None] if deg.ndim == X.ndim - 1 else deg


def scale_identity(X, deg, avg_d=None):
    return X


def scale_amplification(X, deg, avg_d):
    deg = _col(deg, X)
    return X * (torch.log(deg + 1) / avg_d['log'])


def _over(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den in IEEE division (a Python number over a tensor is
    computed as num * (1 / den) by torch, one rounding more)."""
    return torch.as_tensor(num, dtype=den.dtype, device=den.device) / den


def scale_attenuation(X, deg, avg_d):
    deg = _col(deg, X)
    scale = _over(avg_d['log'], torch.log(deg + 1))
    return X * torch.where(deg == 0, torch.ones_like(scale), scale)


def scale_linear(X, deg, avg_d):
    deg = _col(deg, X)
    return X * (deg / avg_d['lin'])


def scale_inverse_linear(X, deg, avg_d):
    deg = _col(deg, X)
    scale = _over(avg_d['lin'], deg)
    return X * torch.where(deg == 0, torch.ones_like(scale), scale)


SCALERS: Dict[str, Callable] = {
    'identity': scale_identity,
    'amplification': scale_amplification,
    'attenuation': scale_attenuation,
    'linear': scale_linear,
    'inverse_linear': scale_inverse_linear,
}


def scaler_weights(scalers: Sequence[str], deg: torch.Tensor,
                   avg_d: Dict[str, float]) -> torch.Tensor:
    """[S, N] multiplicative weights per node: each scaler applied to ones."""
    one = torch.ones_like(deg)
    for s in scalers:
        if s not in SCALERS:
            raise ValueError(s)
    return torch.stack([SCALERS[s](one, deg, avg_d) for s in scalers])


def avg_d_from_degree_hist(deg_hist) -> Dict[str, float]:
    """PyG degree-histogram formula: lin = E[d], log = E[log(d+1)],
    exp = E[exp(d)] over the histogram's bins."""
    deg = np.asarray(deg_hist, dtype=np.float64)
    total = deg.sum()
    bins = np.arange(len(deg), dtype=np.float64)
    return dict(
        lin=float((bins * deg).sum() / total),
        log=float((np.log(bins + 1) * deg).sum() / total),
        exp=float((np.exp(bins) * deg).sum() / total),
    )


def avg_d_from_degrees(per_graph_degrees) -> Dict[str, float]:
    """Mean over graphs of mean(log(in_degree + 1))."""
    logs = [float(np.mean(np.log(np.asarray(d, dtype=np.float64) + 1)))
            for d in per_graph_degrees]
    return dict(log=float(np.mean(logs)))
