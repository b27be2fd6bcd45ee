"""The port's segment aggregators, sparse bank and CSR bank on the
receiver-sorted batch against pna_tpu's ELL aggregators and banks on its ELL
batch of the same graphs (the same edges in the same order), on the CPU, on
the same messages and cotangents:

* every aggregator of ``pna_tpu/ops/ell.py`` against the port's segment
  aggregator (``ops/aggregators.py``), and the JAX bank's ELL path of
  ``nn/sparse.py::aggregate_bank`` against the port's;
* ``pna_tpu/ops/fused_vjp.py``'s ``make_raw_bank`` against
  ``csr_bank.csr_raw_bank`` (K1/K2's plain versions here), and its
  ``make_fused_bank`` against the port's ``aggregate_bank``.

The port has no ELL layout (nor the JAX package's degree-bucketed one).  The
messages are multiples of 1/2 drawn from a few values, so that maxima and
minima tie exactly and sums and sums of squares are exact; the batch has
nodes of degree 0.  Tolerances: outputs rtol 1e-5, atol 1e-5; gradients
rtol 2e-4, atol 2e-5 (float32 sums in other orders).

One exception, a property of the function both packages compute: at a node
of degree 2 the odd central moments are identically 0, and the root
sign(m) (|m| + EPS)^(1/n) has slope (1/n) EPS^(1/n - 1) there (718 for
n = 3, 2000 for n = 5), so the output of such a node and the gradient on its
edges are float32 rounding noise times that slope, on both sides (up to
6e-5 and 1e-3 here).  The checks of moment3 and moment5 compare the outputs
of every other node and the gradients on their edges."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu import graph as jgraph
from pna_tpu.nn.sparse import aggregate_bank as j_aggregate_bank
from pna_tpu.ops import ell as jell
from pna_tpu.ops import fused_vjp as jfv
from pna_tpu_torch import graph as tgraph
from pna_tpu_torch.nn.sparse import aggregate_bank
from pna_tpu_torch.ops import csr_bank, scalers
from pna_tpu_torch.ops.aggregators import SEGMENT_AGGREGATORS, SegmentCtx

F = 6
OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
AVG_D = {'lin': 2.3, 'log': 1.1}
FUSED_AGGS = ('mean', 'sum', 'max', 'min', 'var', 'std')
SCALERS = ('identity', 'amplification', 'attenuation', 'linear',
           'inverse_linear')


def _graphs(seed=0):
    """Random directed graphs; isolated nodes in the first two."""
    rng = np.random.RandomState(seed)
    graphs = []
    for i in range(6):
        n = rng.randint(4, 10)
        adj = (rng.rand(n, n) < 0.45) & ~np.eye(n, dtype=bool)
        if i < 2:
            adj[:, 0] = adj[0, :] = False
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=np.zeros((n, 1), np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return graphs


def _messages(n_edges, seed=1, width=F):
    rng = np.random.RandomState(seed)
    return (rng.randint(-3, 4, (n_edges, width)) / 2.0).astype(np.float32)


def _check(got, got_grad, want, want_grad, nodes=slice(None),
           edges=slice(None)):
    np.testing.assert_allclose(got.detach().numpy()[nodes],
                               np.asarray(want)[nodes], **OUT)
    np.testing.assert_allclose(got_grad.numpy()[edges],
                               np.asarray(want_grad)[edges], **GRAD)


def _grad_pair(t_fn, j_fn, msg, cot):
    """(port out, port d_msg, jax out, jax d_msg) of sum(out * cot); a
    zero d_msg where the output does not depend on the messages."""
    x = torch.from_numpy(msg).requires_grad_(True)
    out = t_fn(x)
    if out.requires_grad:
        (out * torch.from_numpy(cot)).sum().backward()
    j_out, vjp = jax.vjp(j_fn, jnp.asarray(msg))
    (j_grad,) = vjp(jnp.asarray(cot))
    grad = torch.zeros_like(x) if x.grad is None else x.grad
    return out, grad, j_out, j_grad


def _not_degree_two(tg):
    """The nodes that do not have degree 2 and the edges into them (module
    docstring), as keyword arguments of ``_check``."""
    nodes = tg.in_degrees().numpy() != 2
    return dict(nodes=nodes, edges=nodes[tg.receivers.numpy()])


def _ell_graphs():
    """The port's CSR batch and the JAX ELL batch of the same graphs."""
    graphs = _graphs()
    tg = tgraph.batch_graphs(graphs)
    jg = jgraph.batch_graphs(graphs)
    assert jg.nbr_edge_ids is not None
    np.testing.assert_array_equal(tg.receivers.numpy(), jg.receivers)
    return tg, jg


@pytest.mark.parametrize("name", sorted(jell.ELL_AGGREGATORS))
def test_ell_aggregator_matches_jax(name):
    """The JAX ELL aggregator against the port's segment aggregator."""
    tg, jg = _ell_graphs()
    rng = np.random.RandomState(2)
    msg = _messages(tg.n_edge_pad)
    msg[::3] = rng.randn(len(msg[::3]), F)        # continuous values too
    self_msg = rng.randn(tg.n_node_pad, F).astype(np.float32)
    cot = rng.randn(tg.n_node_pad, F).astype(np.float32)

    def t_fn(x):
        ctx = SegmentCtx.create(x, tg.receivers, tg.n_node_pad,
                                mask=tg.edge_mask, senders=tg.senders,
                                self_msg=torch.from_numpy(self_msg))
        return SEGMENT_AGGREGATORS[name](ctx)

    def j_fn(x):
        ctx = jell.EllCtx.create(x, jg.nbr_edge_ids, jg.nbr_mask,
                                 self_msg=jnp.asarray(self_msg),
                                 senders=jg.senders,
                                 out_deg=jg.out_degrees())
        return jell.ELL_AGGREGATORS[name](ctx)

    rows = _not_degree_two(tg) if name in ('moment3', 'moment5') else {}
    _check(*_grad_pair(t_fn, j_fn, msg, cot), **rows)


@pytest.mark.parametrize("aggs", [
    ('mean', 'max', 'min', 'std'),
    ('identity', 'sum', 'var', 'softmax', 'softmin', 'normalised_mean'),
    ('moment3', 'moment4', 'moment5')])
def test_ell_aggregate_bank_matches_jax(aggs):
    """The port's aggregate_bank on its CSR batch (the segment form on the
    CPU, the scalers on the in-degree) against the JAX bank on its ELL
    batch (every aggregator through the ELL context)."""
    tg, jg = _ell_graphs()
    rng = np.random.RandomState(3)
    msg = _messages(tg.n_edge_pad)
    msg[1::4] = rng.randn(len(msg[1::4]), F)
    self_msg = rng.randn(tg.n_node_pad, F).astype(np.float32)
    width = len(aggs) * len(SCALERS) * F
    cot = rng.randn(tg.n_node_pad, width).astype(np.float32)
    _check(*_grad_pair(
        lambda x: aggregate_bank(tg, x, aggs, SCALERS, AVG_D,
                                 self_msg=torch.from_numpy(self_msg)),
        lambda x: j_aggregate_bank(jg, x, aggs, SCALERS, AVG_D,
                                   self_msg=jnp.asarray(self_msg)),
        msg, cot), **(_not_degree_two(tg) if 'moment3' in aggs else {}))


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_ell_raw_bank_matches_jax(dtype):
    """The JAX make_raw_bank against csr_raw_bank: float32 output from
    float32 or bfloat16 messages; the gradient in the messages' dtype
    (bfloat16 compared after widening)."""
    tg, jg = _ell_graphs()
    msg = _messages(tg.n_edge_pad, seed=4)
    cot = np.random.RandomState(5).randn(
        tg.n_node_pad, len(FUSED_AGGS), F).astype(np.float32)
    layout = csr_bank.layout_from_graph(tg)
    j_raw = jfv.make_raw_bank(jg.receivers, jg.edge_mask)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(msg).to(tdt).requires_grad_(True)
    out = csr_bank.csr_raw_bank(x, layout, FUSED_AGGS)
    (out * torch.from_numpy(cot)).sum().backward()
    j_out, vjp = jax.vjp(
        lambda m: j_raw(m, jg.nbr_edge_ids, jg.nbr_mask, FUSED_AGGS),
        jnp.asarray(msg, getattr(jnp, dtype)))
    (j_grad,) = vjp(jnp.asarray(cot))
    assert out.dtype == torch.float32 and x.grad.dtype == tdt
    _check(out, x.grad.float(), j_out, np.asarray(j_grad, np.float32))
    with torch.no_grad():      # the forward without tie counts
        np.testing.assert_array_equal(
            csr_bank.csr_raw_bank(x, layout, FUSED_AGGS).numpy(),
            out.detach().numpy())


def test_ell_fused_bank_matches_jax():
    """The JAX make_fused_bank ([N, S, A, F]) against the port's
    aggregate_bank ([N, S*A*F], the same order)."""
    tg, jg = _ell_graphs()
    msg = _messages(tg.n_edge_pad, seed=6)
    deg = tg.in_degrees()
    cot = np.random.RandomState(7).randn(
        tg.n_node_pad, len(SCALERS), len(FUSED_AGGS), F).astype(np.float32)
    j_fused = jfv.make_fused_bank(jg.receivers, jg.edge_mask)
    _check(*_grad_pair(
        lambda x: aggregate_bank(tg, x, FUSED_AGGS, SCALERS, AVG_D).reshape(
            tg.n_node_pad, len(SCALERS), len(FUSED_AGGS), F),
        lambda x: j_fused(x, jg.nbr_edge_ids, jg.nbr_mask,
                          jnp.asarray(deg.numpy()), FUSED_AGGS, SCALERS,
                          AVG_D),
        msg, cot))
    assert csr_bank.supports(FUSED_AGGS)
    assert set(SCALERS) <= set(scalers.SCALERS)
    assert not csr_bank.supports(('mean', 'identity'))
