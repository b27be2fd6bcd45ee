"""Readings of the program's training state, taken through PyTorch's own
interfaces (``nn.Module.state_dict``, ``named_parameters`` and a
``torch.optim`` optimiser's ``state``), never through the program's code;
and the host time of a set-up's phases."""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch


def grad_norms(model: torch.nn.Module, opt: torch.optim.Optimizer
               ) -> Dict[str, float]:
    """Each weight's first gradient as Adam took it, by its norm: the first
    moment after one step over (1 - beta1); 0 where the optimiser holds no
    moment (it took no gradient)."""
    beta1 = {id(p): g['betas'][0] for g in opt.param_groups
             for p in g['params']}
    out = {}
    for name, p in model.named_parameters():
        m = opt.state.get(p, {}).get('exp_avg')
        out[name] = 0.0 if m is None else float(
            torch.linalg.vector_norm(m) / (1 - beta1[id(p)]))
    return out


def change_norms(model: torch.nn.Module, start: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each weight's and statistic's change from ``start``, by its norm."""
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(v.float() - start[k]))
                for k, v in model.state_dict().items()}


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Laps:
    """Host-clock seconds of named phases, each from the end of the last
    (or from the ``Laps``' making) to the call that names it."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
