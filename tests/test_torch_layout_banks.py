"""The aggregation banks over the ELL and degree-bucketed layouts against
pna_tpu on the CPU, on the same messages and cotangents:

* every aggregator of ``ops/ell.py`` and the ELL path of
  ``nn/sparse.py::aggregate_bank``;
* ``ops/fused_vjp.py``'s ``make_raw_bank`` and ``make_fused_bank``;
* ``ops/bucketed.py``'s ``raw_bank`` over all of ``SUPPORTED``,
  ``moment_stats`` with ``derive_aggregator``, ``fused_raw_bank`` and
  ``expand_to_edges``.

The messages are multiples of 1/2 drawn from a few values, so that maxima
and minima tie exactly and sums and sums of squares are exact; the batch
has nodes of degree 0 in the degree-0 class and in wider classes (dummy
slots) and nodes below their class width.  Tolerances: outputs rtol 1e-5,
atol 1e-5; gradients rtol 2e-4, atol 2e-5 (float32 sums in other orders).

One exception, a property of the function both packages compute: at a node
of degree 2 the odd central moments are identically 0, and the root
sign(m) (|m| + EPS)^(1/n) has slope (1/n) EPS^(1/n - 1) there (718 for
n = 3, 2000 for n = 5), so the output of such a node and the gradient on its
edges are float32 rounding noise times that slope, on both sides (up to
6e-5 and 1e-3 here).  The ELL checks of moment3 and moment5 compare the
outputs of every other node and the gradients on their edges."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu import graph as jgraph
from pna_tpu.nn.sparse import aggregate_bank as j_aggregate_bank
from pna_tpu.ops import bucketed as jb
from pna_tpu.ops import ell as jell
from pna_tpu.ops import fused_vjp as jfv
from pna_tpu_torch import graph as tgraph
from pna_tpu_torch.nn.sparse import aggregate_bank
from pna_tpu_torch.ops import bucketed as tb
from pna_tpu_torch.ops import ell as tell
from pna_tpu_torch.ops import fused_vjp as tfv

F = 6
OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
AVG_D = {'lin': 2.3, 'log': 1.1}
FUSED_AGGS = ('mean', 'sum', 'max', 'min', 'var', 'std')
SCALERS = ('identity', 'amplification', 'attenuation', 'linear',
           'inverse_linear')
CAPS = {0: 8, 2: 24, 5: 16, 11: 8}


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
    graphs = _graphs()
    tg = tgraph.batch_graphs(graphs, with_ell=True)
    jg = jgraph.batch_graphs(graphs)
    return tg, jg


@pytest.mark.parametrize("name", sorted(tell.ELL_AGGREGATORS))
def test_ell_aggregator_matches_jax(name):
    tg, jg = _ell_graphs()
    rng = np.random.RandomState(2)
    msg = _messages(tg.n_edge_pad)
    msg[::3] = rng.randn(len(msg[::3]), F)        # continuous values too
    self_msg = rng.randn(tg.n_node_pad, F).astype(np.float32)
    out_deg = tg.out_degrees()
    cot = rng.randn(tg.n_node_pad, F).astype(np.float32)

    def t_fn(x):
        ctx = tell.EllCtx.create(x, tg.nbr_edge_ids, tg.nbr_mask,
                                 self_msg=torch.from_numpy(self_msg),
                                 senders=tg.senders, out_deg=out_deg)
        return tell.ELL_AGGREGATORS[name](ctx)

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
    """aggregate_bank on an ELL batch (every aggregator through the ELL
    context, the scalers on its degree) against the JAX bank."""
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
    """make_raw_bank: float32 output from float32 or bfloat16 messages; the
    gradient in the messages' dtype (bfloat16 compared after widening)."""
    tg, jg = _ell_graphs()
    msg = _messages(tg.n_edge_pad, seed=4)
    cot = np.random.RandomState(5).randn(
        tg.n_node_pad, len(FUSED_AGGS), F).astype(np.float32)
    t_raw = tfv.make_raw_bank(tg.receivers, tg.edge_mask)
    j_raw = jfv.make_raw_bank(jg.receivers, jg.edge_mask)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(msg).to(tdt).requires_grad_(True)
    out = t_raw(x, tg.nbr_edge_ids, tg.nbr_mask, FUSED_AGGS)
    (out * torch.from_numpy(cot)).sum().backward()
    j_out, vjp = jax.vjp(
        lambda m: j_raw(m, jg.nbr_edge_ids, jg.nbr_mask, FUSED_AGGS),
        jnp.asarray(msg, getattr(jnp, dtype)))
    (j_grad,) = vjp(jnp.asarray(cot))
    assert out.dtype == torch.float32 and x.grad.dtype == tdt
    _check(out, x.grad.float(), j_out, np.asarray(j_grad, np.float32))
    with torch.no_grad():      # the forward without tie counts
        np.testing.assert_array_equal(
            t_raw(x, tg.nbr_edge_ids, tg.nbr_mask, FUSED_AGGS).numpy(),
            out.detach().numpy())


def test_ell_fused_bank_matches_jax():
    tg, jg = _ell_graphs()
    msg = _messages(tg.n_edge_pad, seed=6)
    deg = tg.nbr_mask.sum(dim=1).float()
    cot = np.random.RandomState(7).randn(
        tg.n_node_pad, len(SCALERS), len(FUSED_AGGS), F).astype(np.float32)
    t_fused = tfv.make_fused_bank(tg.receivers, tg.edge_mask)
    j_fused = jfv.make_fused_bank(jg.receivers, jg.edge_mask)
    _check(*_grad_pair(
        lambda x: t_fused(x, tg.nbr_edge_ids, tg.nbr_mask, deg, FUSED_AGGS,
                          SCALERS, AVG_D),
        lambda x: j_fused(x, jg.nbr_edge_ids, jg.nbr_mask,
                          jnp.asarray(deg.numpy()), FUSED_AGGS, SCALERS,
                          AVG_D),
        msg, cot))
    assert tfv.supports(FUSED_AGGS, SCALERS)
    assert not tfv.supports(('mean', 'identity'), SCALERS)


def _bucketed_graphs(caps=CAPS):
    graphs = _graphs(seed=8)
    tg = tgraph.batch_graphs(graphs, bucket_by_degree=True, bucket_caps=caps)
    jg = jgraph.batch_graphs(graphs, bucket_by_degree=True, bucket_caps=caps,
                             with_ell=False)
    in_deg = tg.in_deg.numpy()
    off = 0
    for d, c in tg.bucket_spec:       # dummy slots: degree below the width
        if d:
            assert (in_deg[off:off + c] < d).any()
        off += c
    return tg, jg


@pytest.mark.parametrize("with_in_deg", [True, False])
def test_bucketed_raw_bank_matches_jax(with_in_deg):
    """raw_bank over every aggregator of SUPPORTED; without ``in_deg`` the
    class width is every node's degree (exact classes)."""
    caps = CAPS if with_in_deg else None
    if caps is None:
        graphs = _graphs(seed=8)
        tg = tgraph.batch_graphs(graphs, bucket_by_degree=True,
                                 bucket_max_buckets=8)
        jg = jgraph.batch_graphs(graphs, bucket_by_degree=True,
                                 bucket_max_buckets=8, with_ell=False)
    else:
        tg, jg = _bucketed_graphs()
    msg = _messages(tg.n_edge_pad, seed=9)
    msg[::5] = np.random.RandomState(10).randn(len(msg[::5]), F)
    aggs = tb.SUPPORTED
    cot = np.random.RandomState(11).randn(
        tg.n_node_pad, len(aggs), F).astype(np.float32)
    t_deg = tg.in_deg if with_in_deg else None
    j_deg = jg.in_deg if with_in_deg else None
    _check(*_grad_pair(
        lambda x: tb.raw_bank(x, tg.bucket_spec, aggs, in_deg=t_deg),
        lambda x: jb.raw_bank(x, jg.bucket_spec, aggs, in_deg=j_deg),
        msg, cot))


def test_bucketed_moments_match_jax():
    """moment_stats and derive_aggregator for each aggregator of
    MOMENT_DERIVABLE (std exactly 0 on the degree-0 class)."""
    tg, jg = _bucketed_graphs()
    msg = _messages(tg.n_edge_pad, seed=12)
    rng = np.random.RandomState(13)
    for name in tb.MOMENT_DERIVABLE:
        cot = rng.randn(tg.n_node_pad, F).astype(np.float32)
        out, grad, j_out, j_grad = _grad_pair(
            lambda x: tb.derive_aggregator(
                name, *tb.moment_stats(x, tg.bucket_spec, tg.in_deg)),
            lambda x: jb.derive_aggregator(
                name, *jb.moment_stats(x, jg.bucket_spec, jg.in_deg)),
            msg, cot)
        _check(out, grad, j_out, j_grad)
    s, sq, mx, mn, cnt1, d0 = tb.moment_stats(torch.from_numpy(msg),
                                             tg.bucket_spec, tg.in_deg)
    assert d0[:8].all() and not d0[8:].any()
    std = tb.derive_aggregator('std', s, sq, mx, mn, cnt1, d0)
    assert float(std[:8].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ['float32', 'bfloat16'])
def test_bucketed_fused_raw_bank_matches_jax(dtype):
    tg, jg = _bucketed_graphs()
    msg = _messages(tg.n_edge_pad, seed=14)
    cot = np.random.RandomState(15).randn(
        tg.n_node_pad, len(tb.FUSED), F).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(msg).to(tdt).requires_grad_(True)
    out = tb.fused_raw_bank(x, tg.in_deg, tg.bucket_spec, tb.FUSED)
    (out * torch.from_numpy(cot)).sum().backward()
    j_out, vjp = jax.vjp(
        lambda m: jb.fused_raw_bank(m, jg.in_deg, jg.bucket_spec, tb.FUSED),
        jnp.asarray(msg, getattr(jnp, dtype)))
    (j_grad,) = vjp(jnp.asarray(cot))
    assert x.grad.dtype == tdt
    _check(out, x.grad.float(), j_out, np.asarray(j_grad, np.float32))
    # the plain bank gives the same function
    np.testing.assert_allclose(
        out.detach().numpy(),
        tb.raw_bank(torch.from_numpy(msg), tg.bucket_spec, tb.FUSED,
                    in_deg=tg.in_deg).numpy(), **OUT)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tb.fused_raw_bank(x, tg.in_deg, tg.bucket_spec,
                              tb.FUSED).numpy(), out.detach().numpy())


def test_expand_to_edges_matches_receiver_gather():
    """expand_to_edges is h[receivers] on the real edges and on the dummy
    self-loops, and its backward sums over each node's slots."""
    tg, jg = _bucketed_graphs()
    rng = np.random.RandomState(16)
    h = rng.randn(tg.n_node_pad, 3).astype(np.float32)
    cot = rng.randn(tg.n_edge_pad, 3).astype(np.float32)
    out, grad, j_out, j_grad = _grad_pair(
        lambda x: tb.expand_to_edges(x, tg.bucket_spec),
        lambda x: jb.expand_to_edges(x, jg.bucket_spec), h, cot)
    _check(out, grad, j_out, j_grad)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  h[tg.receivers.numpy()])
    np.testing.assert_array_equal(tb.degrees(tg.bucket_spec),
                                  jb.degrees(jg.bucket_spec))
    assert tb.supports(tb.SUPPORTED) and not tb.supports(('identity',))
