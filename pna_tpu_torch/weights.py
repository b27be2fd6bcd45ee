"""Carry weights from the JAX package into the port.

``from_jax(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` trees of ``PNANetMolecules`` (with fused or unfused
towers), ``PNANetSuperpixels``, ``PNANetHIV``, ``PNANetPyGExample``, one
layer (``PNALayerFused``, ``PNALayerSparse``, ``PNATowerSparse``,
``PNASimpleLayerSparse``, ``PNAConvPyG``, ``PNAConvSimplePyG``) or one of
the building blocks of ``nn/layers.py``, already turned into nested dicts of
numpy arrays, and returns the port's ``state_dict``.  Names map as follows
(flax -> port):

* ``embedding_h/embedding`` -> ``embedding_h.weight`` (same for ``_e``); a
  ``Dense`` embedding's ``embedding_h/kernel`` -> ``embedding_h.weight``,
  transposed;
* ``layer_i/pretrans/kernel_j`` -> ``layers.i.pretrans.kernel_j`` (stacked
  tower kernels and biases of every layer j keep their names and layout);
* ``layer_i/batchnorm_h/scale`` -> ``layers.i.batchnorm_h.weight``; the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* ``layer_i/mixing/kernel`` -> ``layers.i.mixing.weight``, transposed;
* ``MLP_layer/Dense_k/kernel`` -> ``MLP_layer.FC_layers.k.weight``,
  transposed;
* ``FCLayer_k/Dense_0`` -> ``fully_connected.k.linear`` and
  ``FCLayer_k/BatchNorm_0`` -> ``fully_connected.k.b_norm`` (an ``MLP``);
  the sparse layer's ``mixing/Dense_0`` (an ``FCLayer``) ->
  ``mixing.linear``;
* the sparse layers: ``layer_i/tower_t/pretrans/FCLayer_k/...`` ->
  ``layers.i.tower_t.pretrans.fully_connected.k...`` (and ``posttrans``,
  ``batchnorm_h``); ``PNANetHIV``'s ``layer_i/posttrans/...`` ->
  ``layers.i.posttrans...``;
* ``embedding_h/emb_i/embedding`` (``AtomEncoder``) ->
  ``embedding_h.emb_i.weight``;
* the PyG modules keep their names: ``conv_i/post_nn_lin_0/kernel`` ->
  ``conv_i.post_nn_lin_0.weight``, transposed; ``bn_i/scale`` ->
  ``bn_i.weight``; ``node_emb/emb_i``, ``mlp_lin_k``, ``pre_nns_t_lin_i``,
  ``post_nns_t_lin_i``, ``edge_encoder``, ``lin`` likewise;
* ``gru/GRUCell_0`` -> ``gru.cell``: flax's input denses ``ir``, ``iz``,
  ``in`` (with bias) and hidden denses ``hr``, ``hz`` (no bias) and ``hn``
  (with bias) become ``torch.nn.GRUCell``'s ``weight_ih``/``bias_ih`` and
  ``weight_hh``/``bias_hh``, gates stacked in torch's order r, z, n, with
  ``bias_hh`` zero for r and z.  The gate equations are the same:
  r = s(x W_ir + b_ir + h W_hr), z likewise, n = tanh(x W_in + b_in
  + r (h W_hn + b_hn)), h' = (1 - z) n + z h.

Flax ``Dense`` kernels are [in, out]; ``nn.Linear`` keeps [out, in].
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

_LEAF = {'embedding': 'weight', 'kernel': 'weight', 'scale': 'weight',
         'mean': 'running_mean', 'var': 'running_var'}
_IN_FC = {'Dense_0': 'linear', 'BatchNorm_0': 'b_norm'}


def _module_name(path) -> str:
    parts = []
    for i, p in enumerate(path):
        if i and re.match(r'^(FCLayer_\d+|mixing)$', path[i - 1]) \
                and p in _IN_FC:
            parts.append(_IN_FC[p])
            continue
        p = re.sub(r'^layer_(\d+)$', r'layers.\1', p)
        p = re.sub(r'^Dense_(\d+)$', r'FC_layers.\1', p)
        p = re.sub(r'^FCLayer_(\d+)$', r'fully_connected.\1', p)
        p = 'cell' if p == 'GRUCell_0' else p
        parts.append(p)
    return '.'.join(parts)


def _gru(cell: Mapping, name: str, out: dict) -> None:
    """torch GRUCell tensors of a flax GRUCell's parameter dict."""
    def k(g):
        return np.asarray(cell[g]['kernel'], np.float32).T      # [out, in]

    def b(g):
        return np.asarray(cell[g]['bias'], np.float32)

    zeros = np.zeros_like(b('hn'))
    out[f'{name}.weight_ih'] = torch.tensor(np.concatenate(
        [k('ir'), k('iz'), k('in')]))
    out[f'{name}.weight_hh'] = torch.tensor(np.concatenate(
        [k('hr'), k('hz'), k('hn')]))
    out[f'{name}.bias_ih'] = torch.tensor(np.concatenate(
        [b('ir'), b('iz'), b('in')]))
    out[f'{name}.bias_hh'] = torch.tensor(np.concatenate(
        [zeros, zeros, b('hn')]))


def _convert(tree: Mapping, prefix, out: dict) -> None:
    for key, value in tree.items():
        path = prefix + (key,)
        if key == 'GRUCell_0':
            _gru(value, _module_name(path), out)
        elif isinstance(value, Mapping):
            _convert(value, path, out)
        else:
            a = np.asarray(value, dtype=np.float32)
            if key == 'kernel':            # flax Dense [in, out]
                a = a.T
            name = _module_name(prefix)
            leaf = _LEAF.get(key, key)
            out[f'{name}.{leaf}' if name else leaf] = torch.tensor(a)


def from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
             ) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict for flax ``params`` / ``batch_stats``."""
    out = OrderedDict()
    for tree in [params] + ([batch_stats] if batch_stats else []):
        _convert(tree, (), out)
    return out
