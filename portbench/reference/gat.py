"""Plain PyTorch GAT, the benchmark's reference for every GAT configuration
(a copy of ``pna_tpu_torch/reference/gat.py``, kept here so that a change
to the program's copy does not move the yardstick).

Graph Attention Networks (Velickovic et al., ICLR 2018, arXiv:1710.10903)
as its reference code computes them (github.com/PetarV-/GAT,
``utils/layers.py::attn_head``, ``models/gat.py::GAT.inference``), at any
widths; the PPI model of the paper's section 3.3 is heads (4, 4, 6), head
widths (256, 256, 121), the skip connection on layer 2.  A layer with
weights W [H*F, in] (no bias), a_src, a_dst [H, F] and a bias b [H*F]:

* hW = x W^T, per head h: hW_h = hW[:, hF:(h+1)F];
* e_ij = LeakyReLU_0.2(a_dst,h . hW_h[i] + a_src,h . hW_h[j]) over j in
  N(i) and j = i (the reference code's bias matrix keeps the self-loops);
* alpha_ij = softmax over those j; out_h[i] = sum_j alpha_ij hW_h[j];
* concatenated heads: y = [out_1 .. out_H] + b; averaged heads (the output
  layer): y = mean_h (out_h + b_h);
* the skip connection (``attn_head(residual=True)``, whose input and head
  widths differ): each head adds a 1x1 convolution of the layer's input
  with a bias, together y += x Ws^T + bs with Ws [H*F, in];
* ELU after every layer but the last; the last's average is the logits of
  ``label_dim`` independent labels, each a sigmoid (``sigmoid_cross_
  entropy_with_logits``), the loss their mean over the training nodes.

Departures from the reference code, none of which changes the function
of the weights given: the graph's edges are directed (j -> i: i's in-edges;
PPI's are undirected, each edge both ways); the self edge is implicit (one
per node, not a row of the adjacency); the 1x1 convolutions that give the
two head scores carry biases in the reference code, which add one constant
to all of a node's logits and so leave the softmax as it is: they are left
out; no dropout and no L2 term (the configuration runs without them);
Adam is ``torch.optim.Adam``'s rule.  Parameters are held in a dict by the
names of the port's modules (``layers.<l>.W``, ``.att_src``, ``.att_dst``,
``.bias``, ``.skip.weight``, ``.skip.bias``).

Every number is in the dtype of the weights and inputs given: float64 in
the benchmark's comparison, float32 in its control.  Matrix products run
with TF32 off, unless ``tf32=True`` (float32 only): then both operands of
every product (the projections and the skip connection) are rounded to
TF32's 10-bit mantissa and the products summed in float32, as the tensor
cores do with TF32 on, the precision below the configuration's float32
that the benchmark's control runs in.  The
attention's weighted sums are formed in receiver blocks of at most
``block_edges`` edges, each under ``torch.utils.checkpoint``, so that no
[E, H*F] tensor outlives its block (on the card the large graph's would
not fit); every sum by index is ``index_add`` and every max
``scatter_reduce``.  The file imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

SLOPE = 0.2
BLOCK_EDGES = 1 << 19

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
    """a @ b on operands rounded to TF32, forward and backward, products
    summed in float32."""

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


# ---------------------------------------------------------------------------
# the configuration's shapes and weights
# ---------------------------------------------------------------------------

def net_of(config: dict) -> dict:
    """The net of a configuration file: its ``net_params`` (heads,
    head_dim, residual_layers) and the sizes of its inputs."""
    net = dict(config['net_params'])
    net['heads'] = tuple(net['heads'])
    net['head_dim'] = tuple(net['head_dim'])
    net['residual_layers'] = tuple(net['residual_layers'])
    for k in ('feat_dim', 'label_dim'):
        net[k] = config[k]
    if net['head_dim'][-1] != net['label_dim']:
        raise ValueError("the output layer's head width is the label count")
    return net


def layer_dims(net: dict) -> List[dict]:
    """Per layer: input width, heads, head width, concatenated or averaged,
    skip connection, ELU."""
    out, width = [], net['feat_dim']
    last = len(net['heads']) - 1
    for i, (h, f) in enumerate(zip(net['heads'], net['head_dim'])):
        out.append(dict(fin=width, heads=h, f=f, concat=i < last,
                        residual=i in net['residual_layers'], elu=i < last))
        width = h * f
    return out


def param_spec(net: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight, in the port's names; kinds as
    ``portbench/weights.py`` draws them ('linear': U(-a, a), a = sqrt(3 /
    last dim); 'bias': U(-0.1, 0.1))."""
    spec = []
    for i, d in enumerate(layer_dims(net)):
        p, hf = f'layers.{i}.', d['heads'] * d['f']
        spec += [(p + 'W', (hf, d['fin']), 'linear'),
                 (p + 'att_src', (d['heads'], d['f']), 'linear'),
                 (p + 'att_dst', (d['heads'], d['f']), 'linear'),
                 (p + 'bias', (hf,), 'bias')]
        if d['residual']:
            spec += [(p + 'skip.weight', (hf, d['fin']), 'linear'),
                     (p + 'skip.bias', (hf,), 'bias')]
    return spec


# ---------------------------------------------------------------------------
# the graph and the layer
# ---------------------------------------------------------------------------

def graph_of(senders: torch.Tensor, receivers: torch.Tensor, n: int,
             block_edges: int = BLOCK_EDGES) -> dict:
    """The reference's own graph: the edges and one self edge per node,
    sorted by receiver (stable), cut into receiver blocks of about
    ``block_edges`` edges (a node's edges stay in one block)."""
    own = torch.arange(n, device=receivers.device)
    snd = torch.cat([senders.long(), own])
    rcv = torch.cat([receivers.long(), own])
    order = torch.argsort(rcv, stable=True)
    snd, rcv = snd[order], rcv[order]
    ptr = torch.searchsorted(rcv, torch.arange(n + 1, device=rcv.device))
    # a block starts wherever a node's first edge enters a new multiple of
    # block_edges: a block holds at most block_edges plus one node's edges
    b = ptr[:-1] // block_edges
    cuts = [0] + (torch.nonzero(b[1:] != b[:-1]).squeeze(1) + 1).tolist() \
        + [n]
    return dict(senders=snd, receivers=rcv, ptr=ptr, n=n, cuts=cuts)


def _block_sum(alpha, hw, snd, rcv, r0: int, nb: int):
    """sum over the block's edges of alpha [Eb, H] x hw[snd] [Eb, H, F] into
    its receivers r0 .. r0 + nb: [nb, H, F]."""
    heads = alpha.shape[1]
    rows = hw.index_select(0, snd).reshape(snd.numel(), heads, -1)
    return rows.new_zeros((nb,) + rows.shape[1:]).index_add(
        0, rcv - r0, alpha[..., None] * rows)


def attention(hw: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
              g: dict) -> torch.Tensor:
    """The heads of one layer: hw [N, H*F] -> out [N, H, F]."""
    n, (heads, f) = g['n'], a_src.shape
    hw3 = hw.reshape(hw.shape[0], heads, f)
    s_src = (hw3 * a_src).sum(-1)
    s_dst = (hw3[:n] * a_dst).sum(-1)
    snd, rcv = g['senders'], g['receivers']
    z = F.leaky_relu(s_dst.index_select(0, rcv) + s_src.index_select(0, snd),
                     SLOPE)
    idx = rcv[:, None].expand(-1, heads)
    mx = z.new_full((n, heads), -math.inf).scatter_reduce(
        0, idx, z.detach(), 'amax')
    w = torch.exp(z - mx.index_select(0, rcv))
    den = w.new_zeros((n, heads)).index_add(0, rcv, w)
    alpha = w / den.index_select(0, rcv)
    ptr, parts = g['ptr'].tolist(), []
    for r0, r1 in zip(g['cuts'], g['cuts'][1:]):
        e0, e1 = ptr[r0], ptr[r1]
        parts.append(checkpoint(_block_sum, alpha[e0:e1], hw, snd[e0:e1],
                                rcv[e0:e1], r0, r1 - r0,
                                use_reentrant=False))
    return torch.cat(parts)


def layer(P: Params, i: int, d: dict, x: torch.Tensor, g: dict,
          tf32: bool) -> torch.Tensor:
    p = f'layers.{i}.'
    heads, f = d['heads'], d['f']
    hw = mm(x, P[p + 'W'].t(), tf32)
    out = attention(hw, P[p + 'att_src'], P[p + 'att_dst'], g)
    if d['concat']:
        y = out.reshape(x.shape[0], heads * f) + P[p + 'bias']
    else:
        y = (out + P[p + 'bias'].reshape(heads, f)).mean(1)
    if d['residual']:
        y = y + (mm(x, P[p + 'skip.weight'].t(), tf32) + P[p + 'skip.bias'])
    return F.elu(y) if d['elu'] else y


def forward(P: Params, net: dict, g: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """Node features [N, feat_dim] -> logits [N, label_dim]."""
    for i, d in enumerate(layer_dims(net)):
        x = layer(P, i, d, x, g, tf32)
    return x


def node_loss(P: Params, net: dict, g: dict, x: torch.Tensor,
              y: torch.Tensor, train: torch.Tensor, tf32: bool = False,
              half: bool = False) -> torch.Tensor:
    """The mean of the labels' sigmoid cross-entropies over the training
    nodes (``half``: every other training node only, a planted fault)."""
    logits = forward(P, net, g, x, tf32)
    if half:
        train = train[::2]
    return F.binary_cross_entropy_with_logits(
        logits.index_select(0, train), y.index_select(0, train))


# ---------------------------------------------------------------------------
# training: Adam, the readings the benchmark compares
# ---------------------------------------------------------------------------

def train_readings(weights: Params, loss_fn, steps: int, lr: float,
                   betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Adam from ``weights``, ``steps`` full-graph steps of ``loss_fn(P)``.
    Returns each step's loss, each weight's first gradient (Adam's first
    moment over 1 - beta1 after one step) by its norm, and each weight's
    change after the first and after the last step by its norm."""
    names = list(weights)
    P = {k: weights[k].detach().clone() for k in names}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first, first_change = [], None, None
    b1, b2 = betas

    def change():
        return {k: float(torch.linalg.vector_norm(P[k] - weights[k]))
                for k in names}

    for t in range(1, steps + 1):
        leaves = {k: p.requires_grad_(True) for k, p in P.items()}
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            new = {}
            for k, gk in zip(names, grads):
                m[k] = b1 * m[k] + (1 - b1) * gk
                v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
                new[k] = P[k].detach() - lr / bc1 * m[k] / (
                    torch.sqrt(v2[k]) / math.sqrt(bc2) + eps)
            P = new
            if first is None:
                first = {k: float(torch.linalg.vector_norm(m[k] / (1 - b1)))
                         for k in names}
                first_change = change()
        del loss, grads, leaves
    return dict(losses=losses, grad=first, first_change=first_change,
                change=change())
