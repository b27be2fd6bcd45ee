"""The weights of a run, drawn from its seed on the device.

One ``torch.rand`` call on a generator seeded from ``--seed`` gives every
number; each weight takes its slice and is scaled by its kind.  The
benchmark hands the same weights to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# how each kind of weight is drawn from u ~ U(0, 1): (offset, scale rule)
# tower kernels [T, in, out] and linear weights [out, in] are U(-a, a) with
# a = sqrt(3 / fan_in) (unit-variance outputs); biases and the batch norm's
# shift U(-0.1, 0.1); its scale 1 + U(-0.1, 0.1); embeddings unit variance


def _scale(kind: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(a, b): the weight is a * (2u - 1) + b."""
    if kind == 'tower':
        return math.sqrt(3.0 / shape[-2]), 0.0
    if kind == 'linear':
        return math.sqrt(3.0 / shape[-1]), 0.0
    if kind in ('bias', 'bn_bias'):
        return 0.1, 0.0
    if kind == 'bn_weight':
        return 0.1, 1.0
    if kind == 'embedding':
        return math.sqrt(3.0), 0.0
    if kind == 'zeros':
        return 0.0, 0.0
    if kind == 'ones':
        return 0.0, 1.0
    raise ValueError(kind)


def sub_seeds(seed: int, n: int) -> np.ndarray:
    """``n`` independent 32-bit seeds from one seed of any size."""
    return np.random.SeedSequence(int(seed)).generate_state(n)


def draw(spec: Sequence[Tuple[str, tuple, str]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """Every weight of ``spec`` ((name, shape, kind), ...) from ``seed``."""
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(sub_seeds(seed, 1)[0]))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        a, b = _scale(kind, shape)
        out[name] = (u[at:at + n] * (2 * a) + (b - a)).reshape(shape)
        at += n
    return out
