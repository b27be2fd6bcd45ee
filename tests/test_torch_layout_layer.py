"""PNALayerFused on the receiver-sorted batch in float32 against the JAX
layer on its bucketed, ELL and CSR batches of the same graphs, on the same
weights (weights.from_jax) and inputs: output, loss = sum(out^2), every
parameter gradient, the input gradients and the new batch-norm statistics.
The port has no bucketed or ELL backend: each JAX bucketed or ELL case is
held against the port's ``csr`` backend (its plain versions on the CPU),
``generic`` where the aggregators need the segment form, or ``auto``.  A
bucketed batch orders and pads its nodes and edges otherwise: the port's
inputs reach the JAX nodes through the node features (unique rows), the
edges through their (sender, receiver) pairs, and outputs and input
gradients are compared on the real nodes and edges, with the loss summed
over them.  tests/test_torch_layout_bf16.py holds bfloat16 and
``resolve_backend`` with this file's helpers.

The JAX bucketed moment path defines std as 0 on a node without in-edges,
where its CSR, ELL and generic paths, and every port backend, give
sqrt(EPS); through the batch norm's statistics such a node moves every
output and gradient, so no subset of nodes compares alike.  The cases held
against that path (``_moment_path``) run on the same graphs with a ring edge
into every node, so that none is without in-edges, and their assertion
messages name this (``_note``); every other case keeps the isolated nodes,
and with them the port's behaviour there.

Tolerances, as tests/test_torch_fused_layer.py holds the CSR backends:
outputs rtol 1e-4, atol 1e-4, gradients rtol 2e-4, atol 2e-5, statistics
rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.graph import batch_graphs as j_batch_graphs
from pna_tpu.nn.fused import PNALayerFused as JPNALayerFused
from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn.fused import PNALayerFused
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')
AVG_D = {'lin': 3.1, 'log': 1.2}
D, FE, T = 12, 5, 3
# the JAX batcher's arguments of each layout; the port's batch is the CSR
# one
LAYOUTS = {
    'csr': dict(with_ell=False),
    'ell': dict(with_ell=True),
    'bucketed': dict(bucket_by_degree=True, with_ell=False),
}


def _graphs(rng, isolated=True):
    graphs = []
    for i in range(6):
        n = rng.randint(5, 12)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        if not isolated:               # an in-edge into every node
            adj[np.roll(np.arange(n), 1), np.arange(n)] = True
        elif i == 0:
            adj[:, 0] = False          # a node without in-edges
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return graphs


def _moment_path(kernel, layout, aggs):
    """The JAX layer takes its bucketed moment path, with std among the
    aggregators (module docstring)."""
    return (layout == 'bucketed' and kernel in ('bucketed', 'auto')
            and 'identity' not in aggs and 'std' in aggs
            and all(a in ('mean', 'sum', 'max', 'min', 'var', 'std')
                    for a in aggs))


def _note(kernel, layout, aggs):
    """The assertion message's note on the graphs of a moment-path case."""
    return (" [graphs with an in-edge into every node: the JAX bucketed "
            "moment path sets std to 0 on a node without in-edges, its "
            "other paths and the port sqrt(EPS)]"
            if _moment_path(kernel, layout, aggs) else "")


def _batches(layout, graphs):
    tg = batch_graphs(graphs, with_snorm=True)
    jg = j_batch_graphs(graphs, with_snorm=True, **LAYOUTS[layout])
    return tg, jg


def _maps(tg, jg):
    """(node, edge): the port row of each real JAX node and edge, -1 on
    padding, found through the node features and the (sender, receiver)
    pairs."""
    rows = {tuple(r): i for i, r in enumerate(tg.node_feats.numpy()[
        tg.node_mask.numpy()])}
    jm = np.asarray(jg.node_mask)
    node = np.full(jg.n_node_pad, -1)
    node[jm] = [rows[tuple(r)] for r in np.asarray(jg.node_feats)[jm]]
    em = tg.edge_mask.numpy()
    pairs = {(s, r): k for k, s, r in zip(np.nonzero(em)[0],
                                          tg.senders.numpy()[em],
                                          tg.receivers.numpy()[em])}
    jem = np.asarray(jg.edge_mask)
    edge = np.full(jg.n_edge_pad, -1)
    edge[jem] = [pairs[(node[s], node[r])] for s, r in zip(
        np.asarray(jg.senders)[jem], np.asarray(jg.receivers)[jem])]
    assert len(set(node[jm])) == jm.sum() and (edge[jem] >= 0).all()
    return node, edge


def _run_both(kernel, layout, aggs=AGGS, cdt=torch.float32,
              divide_input=True, edge_features=True, port_kernel=None):
    """The JAX layer's ``kernel`` on its ``layout`` batch and the port's
    ``port_kernel`` (default ``kernel``) on the CSR batch.  Returns the
    losses, the outputs and the (name, port, JAX) gradient and statistic
    pairs; node and edge rows in the JAX batch's order, real ones only
    when the orders differ."""
    rng = np.random.RandomState(1)
    isolated = not _moment_path(kernel, layout, aggs)
    tg, jg = _batches(layout, _graphs(rng, isolated))
    assert isolated == bool((tg.in_degrees()[tg.node_mask] == 0).any())
    h = rng.randn(tg.n_node_pad, D).astype(np.float32)
    e = rng.randn(tg.n_edge_pad, FE).astype(np.float32)
    h[3] = h[4]                          # equal messages: max/min ties
    same = layout != 'bucketed'
    if same:
        node, edge = np.arange(tg.n_node_pad), np.arange(tg.n_edge_pad)
        jh, je, nodes, edges = h, e, slice(None), slice(None)
    else:
        node, edge = _maps(tg, jg)
        nodes, edges = node >= 0, edge >= 0
        jh = np.zeros((jg.n_node_pad, D), np.float32)
        jh[nodes] = h[node[nodes]]
        je = np.zeros((jg.n_edge_pad, FE), np.float32)
        je[edges] = e[edge[edges]]
    jl = JPNALayerFused(out_dim=D, aggregators=aggs, scalers=SCALERS,
                        avg_d=AVG_D, towers=T, divide_input=divide_input,
                        graph_norm=True, batch_norm=True, residual=True,
                        edge_features=edge_features, kernel=kernel,
                        compute_dtype=(jnp.bfloat16 if cdt == torch.bfloat16
                                       else None))
    je = jnp.asarray(je) if edge_features else None
    var = jax.tree_util.tree_map(np.asarray, jl.init(
        {'params': jax.random.PRNGKey(0)}, jg, jnp.asarray(jh), je,
        train=False))
    j_real = jnp.asarray(np.asarray(jg.node_mask) if not same
                         else np.ones(jg.n_node_pad, bool))[:, None]

    def jloss(p, h, e):
        out, mut = jl.apply({'params': p,
                             'batch_stats': var['batch_stats']}, jg, h, e,
                            train=True, mutable=['batch_stats'])
        out = jnp.where(j_real, out, 0.0)
        return jnp.sum(out * out), (out, mut['batch_stats'])

    (l_j, (out_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if edge_features else (0, 1),
        has_aux=True))(var['params'], jnp.asarray(jh), je)

    tl = PNALayerFused(D, D, aggs, SCALERS, AVG_D, towers=T,
                       divide_input=divide_input, graph_norm=True,
                       batch_norm=True, residual=True,
                       edge_features=edge_features, edge_dim=FE,
                       kernel=port_kernel or kernel, compute_dtype=cdt,
                       device='cpu')
    tl.load_state_dict(from_jax(var['params'], var['batch_stats']))
    tl.train()
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True) if edge_features else None
    out_t = tl(tg, ht, et)
    if not same:
        out_t = out_t * tg.node_mask[:, None]
    l_t = torch.sum(out_t * out_t)
    l_t.backward()

    want = from_jax(jax.tree_util.tree_map(np.asarray, grads_j[0]))
    got = {k: p.grad for k, p in tl.named_parameters()}
    assert set(want) == set(got)
    pairs = [(k, got[k].numpy(), w.numpy()) for k, w in want.items()]
    pairs.append(('h', ht.grad.numpy()[node[nodes]],
                  np.asarray(grads_j[1])[nodes]))
    if edge_features:
        pairs.append(('e', et.grad.numpy()[edge[edges]],
                      np.asarray(grads_j[2])[edges]))
    stats = from_jax({}, jax.tree_util.tree_map(np.asarray, stats_j))
    stat_pairs = [(k, tl.state_dict()[k].numpy(), w.numpy())
                  for k, w in stats.items()]
    return (float(l_t.detach()), out_t.detach().numpy()[node[nodes]],
            pairs, stat_pairs, float(l_j), np.asarray(out_j)[nodes])


CASES = [
    # (JAX kernel, JAX batch layout, aggregators, port kernel): the JAX
    # bucketed moment path and raw bank, ELL, auto on each layout, generic
    # with identity
    ('bucketed', 'bucketed', AGGS, 'csr'),
    ('bucketed', 'bucketed', ('mean', 'softmax', 'softmin', 'max'),
     'generic'),
    ('auto', 'bucketed', AGGS, 'auto'),
    ('ell', 'ell', AGGS, 'csr'),
    ('auto', 'ell', AGGS, 'auto'),
    ('auto', 'csr', AGGS, 'auto'),
    ('generic', 'csr', AGGS + ('identity',), 'generic'),
    ('generic', 'ell', ('identity',) + AGGS, 'generic'),
    ('auto', 'bucketed', AGGS + ('identity',), 'auto'),
]


@pytest.mark.parametrize("kernel,layout,aggs,port_kernel", CASES,
                         ids=[f"{k}-{l}-{len(a)}" for k, l, a, _ in CASES])
def test_layer_backend_matches_jax(kernel, layout, aggs, port_kernel):
    l_t, out_t, pairs, stat_pairs, l_j, out_j = _run_both(
        kernel, layout, aggs, port_kernel=port_kernel)
    note = _note(kernel, layout, aggs)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4,
                               err_msg=note)
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                   err_msg=k + note)
    for k, g, w in stat_pairs:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=k + note)


@pytest.mark.parametrize("kernel,layout", [('bucketed', 'bucketed'),
                                           ('ell', 'ell')])
def test_layer_backend_shared_inputs_matches_jax(kernel, layout):
    """divide_input=False (every tower sees all of h) without edge
    features, the port on ``csr``."""
    l_t, out_t, pairs, _, l_j, out_j = _run_both(
        kernel, layout, divide_input=False, edge_features=False,
        port_kernel='csr')
    note = _note(kernel, layout, AGGS)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4,
                               err_msg=note)
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                   err_msg=k + note)
