"""Plain PyTorch PNA, the benchmark's reference for every PNA configuration.

Principal Neighbourhood Aggregation (Corso et al., arXiv:2004.05718) as its
published code computes it, with towers:

* each tower t reads its slice of the node features (``divide_input``) or
  all of them, and forms a message per edge j -> i with the pretrans MLP
  M_t(h_j, h_i, e_ji) on the concatenation [sender, receiver, edge];
* the aggregators (mean, max, min, std, sum, var) reduce each receiver's
  messages: mean = sum / max(deg, 1), var = relu(E[m^2] - E[m]^2),
  std = sqrt(var + 1e-5), max and min 0 for a node without edges;
* the scalers weigh them by the in-degree: identity 1, amplification
  log(deg + 1) / avg_log, attenuation avg_log / log(deg + 1) (1 at deg 0);
* the posttrans MLP reads [h, scaler x aggregator bank], scaler-major, then
  the tower outputs are concatenated, multiplied by the graph-norm factor
  1 / sqrt(nodes of the graph), batch-normalised, mixed by a linear layer
  with leaky ReLU (slope 0.01), and added to the input where widths agree.

Two nets share the layer: the molecule net (atom and bond embeddings, a sum
readout per graph, a three-layer MLP and the L1 loss) and the node-level net
(a linear embedding, the MLP on every node and the squared error over the
training nodes).  Training is plain Adam with L2 weight decay added to the
gradient (``torch.optim.Adam``'s rule).

Departures from the published code, none of which changes the function:
the first pretrans layer is applied to the sender and receiver halves of
each node once and gathered per edge (the same linear map, split by input
block); every sum by index is ``index_add`` and every max or min
``scatter_reduce``.  Parameters are held in a dict by name, with the names
of the benchmark's weights; the reference builds its batches, degrees and
degree statistics from the raw inputs itself.

``tf32=True`` rounds both operands of every matrix product to TF32's 10-bit
mantissa (round to nearest even) and sums the products in float32, as the
tensor cores do with TF32 on: the precision below the float32 the
configurations state, which the benchmark's control runs in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

STD_EPS = 1e-5
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.01

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# matrix products at the stated precision
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).reshape(x.shape)


class _TF32Product(torch.autograd.Function):
    """a @ b (batched or not) on operands rounded to TF32, forward and
    backward, products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _TF32Product.apply(a, b) if tf32 else a @ b


def tower_mm(x: torch.Tensor, k: torch.Tensor, tf32: bool) -> torch.Tensor:
    """x [N, T, fi], k [T, fi, fo] -> [N, T, fo]: one product per tower."""
    return mm(x.transpose(0, 1), k, tf32).transpose(0, 1)


def linear(x, w, b, tf32: bool):
    """x [..., in], w [out, in] (``nn.Linear``'s layout), b [out]."""
    return mm(x, w.t(), tf32) + b


# ---------------------------------------------------------------------------
# shapes of a configuration
# ---------------------------------------------------------------------------

def net_of(config: dict) -> dict:
    """The net of a configuration file: its ``net_params`` with the
    aggregators and scalers as tuples, and the sizes of its inputs."""
    net = dict(config['net_params'])
    net['aggregators'] = tuple(net['aggregators'].split())
    net['scalers'] = tuple(net['scalers'].split())
    for k in ('num_atom_type', 'num_bond_type', 'feat_dim'):
        if k in config:
            net[k] = config[k]
    return net


def mlp_dims(in_size: int, hidden: int, out: int, layers: int) -> List[int]:
    return [in_size] + [hidden] * (layers - 1) + [out] if layers > 1 \
        else [in_size, out]


def layer_shapes(net: dict) -> List[dict]:
    """Per message layer: in/out widths, towers, the tower input and output
    widths, edge width, and the pretrans and posttrans MLP widths."""
    T, L = net['towers'], net['L']
    A, S = len(net['aggregators']), len(net['scalers'])
    fe = net['edge_dim'] if net['edge_feat'] else 0
    out = []
    for i in range(L):
        last = i == L - 1
        d_in = net['hidden_dim']
        d_out = net['out_dim'] if last else net['hidden_dim']
        divide = net['divide_input_last'] if last \
            else net['divide_input_first']
        ft = d_in // T if divide else d_in
        fo = d_out // T
        out.append(dict(
            d_in=d_in, d_out=d_out, towers=T, ft=ft, fo=fo, fe=fe,
            divide=divide, residual=net['residual'] and d_in == d_out,
            pre=mlp_dims(2 * ft + fe, ft, ft, net['pretrans_layers']),
            post=mlp_dims((A * S + 1) * ft, fo, fo,
                          net['posttrans_layers'])))
    return out


def mlp_readout_dims(in_size: int, out_size: int, L: int = 2) -> List[int]:
    return [in_size // 2 ** l for l in range(L + 1)] + [out_size]


def check_net(net: dict) -> None:
    """Raise for a setting the reference does not compute."""
    if net.get('gru'):
        raise ValueError("the reference has no GRU")
    if net.get('dropout', 0.0) or net.get('in_feat_dropout', 0.0):
        raise ValueError("dropout draws masks the reference cannot repeat")
    for a in net['aggregators']:
        if a not in ('mean', 'max', 'min', 'std', 'sum', 'var'):
            raise ValueError(f"aggregator {a!r}")
    for s in net['scalers']:
        if s not in ('identity', 'amplification', 'attenuation'):
            raise ValueError(f"scaler {s!r}")


def param_spec(net: dict, head: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight and statistic of the net.
    ``head`` is 'molecules' (embeddings by type, graph readout) or 'node'
    (a linear embedding of ``feat_dim`` features, a prediction per node).
    Kinds: ``tower`` [T, in, out], ``linear`` [out, in], ``bias``,
    ``embedding``, ``bn_weight``, ``bn_bias``, ``zeros``, ``ones``."""
    check_net(net)
    spec = []
    if head == 'molecules':
        spec.append(('embedding_h.weight',
                     (net['num_atom_type'], net['hidden_dim']), 'embedding'))
        if net['edge_feat']:
            spec.append(('embedding_e.weight',
                         (net['num_bond_type'], net['edge_dim']),
                         'embedding'))
    elif head == 'node':
        spec += [('embedding_h.weight', (net['hidden_dim'], net['feat_dim']),
                  'linear'),
                 ('embedding_h.bias', (net['hidden_dim'],), 'bias')]
    else:
        raise ValueError(head)
    for i, s in enumerate(layer_shapes(net)):
        p, T = f'layers.{i}.', s['towers']
        for name, dims in (('pretrans', s['pre']), ('posttrans', s['post'])):
            for j in range(len(dims) - 1):
                spec.append((f'{p}{name}.kernel_{j}', (T, dims[j],
                                                       dims[j + 1]), 'tower'))
                spec.append((f'{p}{name}.bias_{j}', (T, dims[j + 1]),
                             'bias'))
        w = T * s['fo']
        if net['batch_norm']:
            spec += [(f'{p}batchnorm_h.weight', (w,), 'bn_weight'),
                     (f'{p}batchnorm_h.bias', (w,), 'bn_bias'),
                     (f'{p}batchnorm_h.running_mean', (w,), 'zeros'),
                     (f'{p}batchnorm_h.running_var', (w,), 'ones')]
        spec += [(f'{p}mixing.weight', (s['d_out'], w), 'linear'),
                 (f'{p}mixing.bias', (s['d_out'],), 'bias')]
    dims = mlp_readout_dims(net['out_dim'], 1)
    for l in range(len(dims) - 1):
        spec += [(f'MLP_layer.FC_layers.{l}.weight', (dims[l + 1], dims[l]),
                  'linear'),
                 (f'MLP_layer.FC_layers.{l}.bias', (dims[l + 1],), 'bias')]
    return spec


def is_statistic(name: str) -> bool:
    """A running statistic of the batch norm: state, not a weight."""
    return name.endswith(('running_mean', 'running_var'))


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def in_degrees(receivers: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(receivers, minlength=n).to(torch.float32)


def avg_log_degree(rule: str, degrees: Sequence[np.ndarray]) -> float:
    """The scalers' avg_log from in-degrees, by the configuration's rule:
    ``per_graph`` the mean over graphs of each graph's mean log(deg + 1);
    ``clamped`` the mean over one graph's nodes of log(max(deg, 1) + 1)."""
    if rule == 'per_graph':
        return float(np.mean([np.mean(np.log(np.asarray(d, np.float64) + 1))
                              for d in degrees]))
    if rule == 'clamped':
        (d,) = degrees
        d = np.maximum(np.asarray(d, np.float64), 1.0)
        return float(np.mean(np.log(d + 1)))
    raise ValueError(rule)


def molecule_batch(records: Sequence[dict], device) -> dict:
    """One batch of molecule records: atoms, bonds, edges offset into one
    node space, each node's graph, the graph-norm factors and the labels."""
    n = [r['node_feats'].shape[0] for r in records]
    off = np.concatenate([[0], np.cumsum(n)[:-1]])
    cat = np.concatenate

    def t(x, dtype=torch.int64):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    return dict(
        atom=t(cat([r['node_feats'][:, 0] for r in records])),
        bond=t(cat([r['edge_feats'][:, 0] for r in records])),
        senders=t(cat([r['senders'] + o for r, o in zip(records, off)])),
        receivers=t(cat([r['receivers'] + o for r, o in zip(records, off)])),
        graph=t(np.repeat(np.arange(len(records)), n)),
        n_graphs=len(records),
        snorm=t(np.repeat(1.0 / np.sqrt(np.maximum(n, 1)), n),
                torch.float32),
        y=t([r['label'] for r in records], torch.float32))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def aggregate(msg: torch.Tensor, receivers: torch.Tensor, n: int,
              deg: torch.Tensor, aggregators: Sequence[str]
              ) -> List[torch.Tensor]:
    """msg [E, F] -> one [n, F] tensor per aggregator."""
    f = msg.shape[1]
    cnt = torch.clamp(deg, min=1.0)[:, None]
    zeros = msg.new_zeros((n, f))
    s = zeros.index_add(0, receivers, msg)
    out = {}
    if any(a in ('mean', 'var', 'std') for a in aggregators):
        mean = s / cnt
        out['mean'] = mean
        if any(a in ('var', 'std') for a in aggregators):
            sq = zeros.index_add(0, receivers, msg * msg)
            var = torch.relu(sq / cnt - mean * mean)
            out['var'] = var
            out['std'] = torch.sqrt(var + STD_EPS)
    out['sum'] = s
    idx = receivers[:, None].expand(-1, f)
    if 'max' in aggregators:
        out['max'] = zeros.scatter_reduce(0, idx, msg, 'amax',
                                          include_self=False)
    if 'min' in aggregators:
        out['min'] = zeros.scatter_reduce(0, idx, msg, 'amin',
                                          include_self=False)
    return [out[a] for a in aggregators]


def scaler_weights(scalers: Sequence[str], deg: torch.Tensor,
                   avg_log: float) -> List[torch.Tensor]:
    logd = torch.log(deg + 1.0)
    w = {'identity': torch.ones_like(deg),
         'amplification': logd / avg_log,
         'attenuation': torch.where(deg == 0, torch.ones_like(deg),
                                    avg_log / logd)}
    return [w[s] for s in scalers]


def batch_norm(x, weight, bias, mean_run, var_run):
    """Training-mode batch norm over the node axis: normalised output and
    the moved running statistics (the variance's unbiased estimate)."""
    n = x.shape[0]
    mean = x.mean(0)
    var = x.var(0, unbiased=False)
    y = (x - mean) / torch.sqrt(var + BN_EPS) * weight + bias
    with torch.no_grad():
        new_mean = (1 - BN_MOMENTUM) * mean_run + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * var_run \
            + BN_MOMENTUM * var * n / max(n - 1, 1)
    return y, new_mean, new_var


def pna_layer(P: Params, pre: str, s: dict, net: dict, h, e, g: dict,
              stats: Params, tf32: bool):
    """One PNA layer on h [N, d_in] (e [E, fe] or None) -> [N, d_out];
    moves the batch-norm statistics in ``stats``."""
    N, T, ft, fo = h.shape[0], s['towers'], s['ft'], s['fo']
    snd, rcv, deg = g['senders'], g['receivers'], g['deg']
    x = h.reshape(N, T, ft) if s['divide'] \
        else h[:, None, :].expand(N, T, ft)
    k0, b0 = P[pre + 'pretrans.kernel_0'], P[pre + 'pretrans.bias_0']
    u = tower_mm(x, k0[:, :ft], tf32)
    v = tower_mm(x, k0[:, ft:2 * ft], tf32)
    msg = u.index_select(0, snd) + v.index_select(0, rcv) + b0
    E = msg.shape[0]
    if s['fe']:
        ke = k0[:, 2 * ft:].permute(1, 0, 2).reshape(s['fe'], T * ft)
        msg = msg + mm(e, ke, tf32).reshape(E, T, ft)
    for j in range(1, len(s['pre']) - 1):
        msg = tower_mm(torch.relu(msg), P[f'{pre}pretrans.kernel_{j}'],
                       tf32) + P[f'{pre}pretrans.bias_{j}']
    aggs = aggregate(msg.reshape(E, T * ft), rcv, N, deg,
                     net['aggregators'])
    weights = scaler_weights(net['scalers'], deg, g['avg_log'])
    parts = [x] + [(w[:, None] * a).reshape(N, T, ft)
                   for w in weights for a in aggs]
    out = tower_mm(torch.cat(parts, dim=2), P[pre + 'posttrans.kernel_0'],
                   tf32) + P[pre + 'posttrans.bias_0']
    for j in range(1, len(s['post']) - 1):
        out = tower_mm(torch.relu(out), P[f'{pre}posttrans.kernel_{j}'],
                       tf32) + P[f'{pre}posttrans.bias_{j}']
    out = out.reshape(N, T * fo)
    if net['graph_norm']:
        out = out * g['snorm'][:, None]
    if net['batch_norm']:
        b = pre + 'batchnorm_h.'
        out, m, v_ = batch_norm(out, P[b + 'weight'], P[b + 'bias'],
                                stats[b + 'running_mean'],
                                stats[b + 'running_var'])
        stats[b + 'running_mean'], stats[b + 'running_var'] = m, v_
    out = F.leaky_relu(linear(out, P[pre + 'mixing.weight'],
                              P[pre + 'mixing.bias'], tf32), LEAKY_SLOPE)
    return h + out if s['residual'] else out


def mlp_readout(P: Params, x, tf32: bool):
    n = len([k for k in P if k.startswith('MLP_layer.FC_layers.')
             and k.endswith('.weight')])
    for l in range(n):
        x = linear(x, P[f'MLP_layer.FC_layers.{l}.weight'],
                   P[f'MLP_layer.FC_layers.{l}.bias'], tf32)
        if l < n - 1:
            x = torch.relu(x)
    return x


def stack(P: Params, net: dict, h, e, g: dict, stats: Params, tf32: bool):
    for i, s in enumerate(layer_shapes(net)):
        h = pna_layer(P, f'layers.{i}.', s, net, h, e, g, stats, tf32)
    return h


# ---------------------------------------------------------------------------
# losses of the two nets
# ---------------------------------------------------------------------------

def molecules_loss(P: Params, net: dict, batch: dict, stats: Params,
                   tf32: bool, half: bool = False):
    """The molecule net's masked L1 loss on one batch (``half``: over the
    first half of its graphs only, a planted fault)."""
    N = batch['atom'].shape[0]
    g = dict(senders=batch['senders'], receivers=batch['receivers'],
             deg=in_degrees(batch['receivers'], N), snorm=batch['snorm'],
             avg_log=batch['avg_log'])
    h = P['embedding_h.weight'].index_select(0, batch['atom'])
    e = P['embedding_e.weight'].index_select(0, batch['bond']) \
        if net['edge_feat'] else None
    h = stack(P, net, h, e, g, stats, tf32)
    if net['readout'] != 'sum':
        raise ValueError(f"readout {net['readout']!r}")
    G = batch['n_graphs']
    pooled = h.new_zeros((G, h.shape[1])).index_add(0, batch['graph'], h)
    pred = mlp_readout(P, pooled, tf32)[:, 0]
    err = torch.abs(pred - batch['y'])
    return err[:G // 2].mean() if half else err.mean()


def node_loss(P: Params, net: dict, graph: dict, stats: Params, tf32: bool,
              half: bool = False):
    """The node-level net's squared error over the training nodes
    (``half``: over every other training node only, a planted fault)."""
    h = linear(graph['feats'], P['embedding_h.weight'],
               P['embedding_h.bias'], tf32)
    h = stack(P, net, h, None, graph, stats, tf32)
    pred = mlp_readout(P, h, tf32)[:, 0]
    train = graph['train']
    if half:
        train = train[::2]
    return ((pred.index_select(0, train) - graph['y'].index_select(0, train))
            ** 2).mean()


# ---------------------------------------------------------------------------
# training: Adam, three steps, the readings the benchmark compares
# ---------------------------------------------------------------------------

def train_readings(weights: Params, loss_fn, batches: Sequence,
                   lr: float, weight_decay: float, betas=(0.9, 0.999),
                   eps: float = 1e-8) -> dict:
    """Adam from ``weights`` over ``batches``, one step each.

    ``loss_fn(params, batch, stats) -> loss`` moves ``stats`` (the running
    statistics) in place.  Returns the readings: each step's loss, each
    weight's first gradient as Adam takes it (with the decay term) by its
    norm, and each weight's and statistic's change after the first and
    after the last step by its norm."""
    names = [k for k in weights if not is_statistic(k)]
    P = {k: weights[k].detach().clone() for k in names}
    stats = {k: v.detach().clone() for k, v in weights.items()
             if is_statistic(k)}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first, first_change = [], None, None
    b1, b2 = betas

    def change():
        out = {k: float(torch.linalg.vector_norm(P[k] - weights[k]))
               for k in names}
        out.update({k: float(torch.linalg.vector_norm(stats[k] - weights[k]))
                    for k in stats})
        return out

    for t, batch in enumerate(batches, start=1):
        leaves = {k: p.requires_grad_(True) for k, p in P.items()}
        loss = loss_fn(leaves, batch, stats)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            new = {}
            for k, gk in zip(names, grads):
                p = P[k].detach()
                gk = gk + weight_decay * p if weight_decay else gk
                m[k] = b1 * m[k] + (1 - b1) * gk
                v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
                new[k] = p - lr / bc1 * m[k] / (
                    torch.sqrt(v2[k]) / math.sqrt(bc2) + eps)
            P = new
            if first is None:
                first = {k: float(torch.linalg.vector_norm(m[k] / (1 - b1)))
                         for k in names}
                first_change = change()
        del loss, grads, leaves
    with torch.no_grad():
        return dict(losses=losses, grad=first, first_change=first_change,
                    change=change())
