"""Initialisers, dropout, the dense layers, the GRU update, Set2Set and
the readouts.

Counterpart of ``pna_tpu/nn/layers.py`` (``xavier_uniform_gain``,
``torch_linear_init``, ``torch_linear_bias_init``, ``get_activation``,
``BatchNorm``, ``FCLayer``, ``MLP``, ``GRUUpdate``, ``Set2Set``,
``S2SReadout``, ``MLPReadout``).  Each initialiser returns
``init(shape, generator) -> tensor`` and draws from the explicit
``torch.Generator`` on the CPU; kernel shapes are in the JAX layout
``[..., in, out]``, and ``dense`` turns such a kernel into an ``nn.Linear``.

``Dropout`` draws its mask from an explicit generator on the data's device
(``F.dropout`` takes none), so a seeded run repeats and a checkpoint can
carry the generator's state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.parallel import collectives


def _uniform(shape, bound, generator):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * bound


def xavier_uniform_gain(gain: float):
    """xavier-uniform with explicit gain over the last two axes [in, out]:
    U(-a, a), a = gain * sqrt(6 / (fan_in + fan_out))."""
    def init(shape, generator):
        fan_in, fan_out = shape[-2], shape[-1]
        return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                        generator)
    return init


def torch_linear_init():
    """U(-b, b), b = 1/sqrt(fan_in): torch.nn.Linear's default kernel init."""
    def init(shape, generator):
        return _uniform(shape, 1.0 / math.sqrt(shape[-2]), generator)
    return init


def torch_linear_bias_init(fan_in: int):
    def init(shape, generator):
        return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)
    return init


def zeros_init(shape, generator):
    return torch.zeros(shape, dtype=torch.float32)


def dense(in_size: int, out_size: int, kernel_init, bias_init,
          generator: torch.Generator) -> nn.Linear:
    """nn.Linear whose kernel [in, out] and bias are drawn by the given
    initialisers (weight stored transposed, as nn.Linear keeps it)."""
    lin = nn.Linear(in_size, out_size, device="meta")
    lin.weight = nn.Parameter(
        kernel_init((in_size, out_size), generator).t().contiguous())
    lin.bias = nn.Parameter(bias_init((out_size,), generator))
    return lin


def get_activation(name) -> Optional[Callable]:
    """Activation by name (the reference's SUPPORTED_ACTIVATION_MAP);
    LeakyReLU has slope 0.01; ``None`` and ``'none'`` give None."""
    if name is None or callable(name):
        return name
    table = {
        'relu': torch.relu,
        'sigmoid': torch.sigmoid,
        'tanh': torch.tanh,
        'elu': F.elu,
        'selu': F.selu,
        'glu': F.glu,
        'leakyrelu': lambda x: F.leaky_relu(x, negative_slope=0.01),
        'softplus': F.softplus,
        'none': None,
    }
    key = name.lower()
    if key not in table:
        raise ValueError(f"Unhandled activation function: {name}")
    return table[key]


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from ``generator``: in training
    mode an entry is kept where a uniform draw is >= p and scaled by
    1/(1-p); eval mode and p = 0 return the input.  ``generator`` lives on
    the device of the data (a CUDA generator for tensors on the card) and
    may be shared by several modules, which then draw in call order."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} outside [0, 1)")
        self.p, self.generator = p, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


class BatchNorm(nn.Module):
    """Batch normalisation of the last axis over every other axis ([..., F]:
    flax's ``nn.BatchNorm``, so a [B, N, F] input takes its statistics over
    B and N) with the JAX package's semantics (momentum 0.1 in torch's
    convention, eps 1e-5, the variance as E[x^2] - E[x]^2): training mode
    normalises with the biased batch variance and moves the running
    variance towards that same biased variance (torch's BatchNorm1d would
    move it towards the unbiased one); eval mode uses the running
    statistics.

    ``group`` (a process group; data parallelism, ``train/engine.py``): the
    count and the sums of x and x^2 are summed over its ranks first, so a
    batch sharded over them normalises as the whole batch would."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, group=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.ndim - 1))
            if self.group is None:
                mean, ex2 = x.mean(axes), (x * x).mean(axes)
            else:
                f = x.shape[-1]
                n = x.new_full((1,), x.numel() // f)
                tot = collectives.all_reduce(
                    torch.cat([n, x.sum(axes), (x * x).sum(axes)]),
                    self.group)
                mean, ex2 = tot[1:f + 1] / tot[0], tot[f + 1:] / tot[0]
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class FCLayer(nn.Module):
    """Linear -> activation -> dropout -> batch-norm.  The kernel is
    xavier-uniform at gain 1/in_size (``init_gain_inverse_in``, the
    reference's default) or torch's Linear init; the bias starts at 0."""

    def __init__(self, in_size: int, out_size: int,
                 activation: Optional[str] = 'relu', dropout: float = 0.0,
                 b_norm: bool = False, bias: bool = True,
                 init_gain_inverse_in: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kernel_init = (xavier_uniform_gain(1.0 / in_size)
                       if init_gain_inverse_in else torch_linear_init())
        self.linear = dense(in_size, out_size, kernel_init, zeros_init,
                            generator)
        if not bias:
            self.linear.bias = None
        self.activation = get_activation(activation)
        self.dropout = Dropout(dropout, dropout_generator)
        self.b_norm = BatchNorm(out_size) if b_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear(x)
        if self.activation is not None:
            h = self.activation(h)
        h = self.dropout(h)
        if self.b_norm is not None:
            h = self.b_norm(h)
        return h


class MLP(nn.Module):
    """A stack of FCLayers: ``layers - 1`` of width ``hidden_size`` with
    ``mid_activation``, then one of ``out_size`` with ``last_activation``."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 layers: int, mid_activation: str = 'relu',
                 last_activation: Optional[str] = 'none',
                 dropout: float = 0.0, mid_b_norm: bool = False,
                 last_b_norm: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fcs, width = [], in_size
        for _ in range(layers - 1):
            fcs.append(FCLayer(width, hidden_size, mid_activation, dropout,
                               mid_b_norm, generator=generator,
                               dropout_generator=dropout_generator))
            width = hidden_size
        fcs.append(FCLayer(width, out_size, last_activation, dropout,
                           last_b_norm, generator=generator,
                           dropout_generator=dropout_generator))
        self.fully_connected = nn.ModuleList(fcs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc in self.fully_connected:
            x = fc(x)
        return x


class GRUUpdate(nn.Module):
    """The GRU update shared between conv layers: one GRU cell per node.

    ``forward(h, y)``: ``h`` [..., D] the previous node features, ``y`` the
    conv output; both are zero-padded up to ``hidden_size``.  As in the
    reference (and in the JAX package, whose flax cell takes the carry
    first), the conv output is the hidden state and the previous features
    the input: ``GRUCell(input=h, hx=y)``.  Parameters are drawn from the
    generator, U(-1/sqrt(H), 1/sqrt(H)) as torch draws them.

    flax's cell has no hidden bias for the r and z gates; torch's would add
    to the input biases of the same gates, and train that sum at twice the
    rate.  So the r and z thirds of ``bias_hh`` start at 0 and their
    gradient is masked: the cell has exactly flax's parameters."""

    def __init__(self, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.hidden_size = hidden_size
        self.cell = nn.GRUCell(hidden_size, hidden_size, device="meta")
        bound = 1.0 / math.sqrt(hidden_size)
        for name, p in list(self.cell.named_parameters()):
            setattr(self.cell, name,
                    nn.Parameter(_uniform(p.shape, bound, generator)))
        keep = torch.ones(3 * hidden_size)
        keep[:2 * hidden_size] = 0.0
        with torch.no_grad():
            self.cell.bias_hh.mul_(keep)
        self.register_buffer("_bias_hh_mask", keep, persistent=False)
        self.cell.bias_hh.register_hook(
            lambda g: g * self._bias_hh_mask.to(g.dtype))

    def _pad(self, x):
        if x.shape[-1] > self.hidden_size:
            raise ValueError(f"GRU input width {x.shape[-1]} > hidden size "
                             f"{self.hidden_size}")
        return F.pad(x, (0, self.hidden_size - x.shape[-1]))

    def forward(self, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        lead = h.shape[:-1]
        h2 = self._pad(h.reshape(-1, h.shape[-1]))
        y2 = self._pad(y.reshape(-1, y.shape[-1]))
        return self.cell(h2, y2).reshape(lead + (self.hidden_size,))


def lecun_normal(shape, generator):
    """flax's default Dense kernel init [in, out]: a normal truncated at
    two deviations, scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / shape[-2]) / .87962566103423978
    out = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out * std


class Set2Set(nn.Module):
    """Set2Set pooling: ``steps`` (default N) LSTM-attention iterations
    over the node set, x [B, N, D] -> q* [B, 2D].  ``mask`` [B, N] keeps
    padded nodes out of the attention softmax.

    The cell is ``torch.nn.LSTMCell(2D, D)`` with flax's
    ``OptimizedLSTMCell`` parameters: input kernels without bias and hidden
    kernels with bias (torch's gate order i, f, g, o), so ``bias_ih`` is a
    zero buffer, not a parameter.  Kernels are drawn as flax draws them:
    lecun-normal input kernels, orthogonal hidden kernels, zero biases."""

    def __init__(self, in_size: int, steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.steps = steps
        D = in_size
        self.cell = nn.LSTMCell(2 * D, D, device="meta")
        w_ih = [lecun_normal((2 * D, D), generator).t() for _ in range(4)]
        w_hh = []
        for _ in range(4):
            w = torch.empty(D, D)
            nn.init.orthogonal_(w, generator=generator)
            w_hh.append(w.t())
        self.cell.weight_ih = nn.Parameter(torch.cat(w_ih).contiguous())
        self.cell.weight_hh = nn.Parameter(torch.cat(w_hh).contiguous())
        self.cell.bias_hh = nn.Parameter(torch.zeros(4 * D))
        del self.cell.bias_ih
        self.cell.register_buffer("bias_ih", torch.zeros(4 * D),
                                  persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        h = x.new_zeros(B, D)
        c = x.new_zeros(B, D)
        q_star = x.new_zeros(B, 2 * D)
        for _ in range(self.steps or N):
            h, c = self.cell(q_star, (h, c))
            e = torch.einsum('bnd,bd->bn', x, h)
            if mask is not None:
                e = torch.where(mask, e, torch.full_like(e, float('-inf')))
            a = torch.softmax(e, dim=1)
            r = torch.einsum('bn,bnd->bd', a, x)
            q_star = torch.cat([h, r], dim=-1)
        return q_star


class S2SReadout(nn.Module):
    """Set2Set -> MLP graph readout (``fc_layers`` layers, batch-norm after
    all but the last, ReLU between, ``final_activation`` last)."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 fc_layers: int = 3, final_activation: Optional[str] = 'relu',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.set2set = Set2Set(in_size, generator=generator)
        self.mlp = MLP(2 * in_size, hidden_size, out_size, fc_layers,
                       mid_activation='relu', last_activation=final_activation,
                       mid_b_norm=True, last_b_norm=False, generator=generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.mlp(self.set2set(x, mask=mask))


class MLPReadout(nn.Module):
    """Halving-width readout: L+1 Linear layers in//2^l -> in//2^(l+1)
    (last -> out), ReLU between."""

    def __init__(self, in_size: int, out_size: int, L: int = 2,
                 generator: torch.Generator = None):
        super().__init__()
        layers = []
        for l in range(L):
            fi = in_size // 2 ** l
            layers.append(dense(fi, in_size // 2 ** (l + 1),
                                torch_linear_init(),
                                torch_linear_bias_init(fi), generator))
        fi = in_size // 2 ** L
        layers.append(dense(fi, out_size, torch_linear_init(),
                            torch_linear_bias_init(fi), generator))
        self.FC_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.FC_layers[:-1]:
            x = torch.relu(lin(x))
        return self.FC_layers[-1](x)
