"""PNALayerFused on the bucketed, ELL, generic and auto backends in float32
against the JAX layer on the same weights (weights.from_jax), batch and
inputs: output, loss = sum(out^2), every parameter gradient, the input
gradients and the new batch-norm statistics.  tests/test_torch_layout_bf16.py
holds bfloat16 and ``resolve_backend`` with this file's helpers.

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
LAYOUTS = {
    'csr': dict(),
    'ell': dict(with_ell=True),
    'bucketed': dict(bucket_by_degree=True),
}


def _graphs(rng):
    graphs = []
    for i in range(6):
        n = rng.randint(5, 12)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        if i == 0:
            adj[:, 0] = False          # a node without in-edges
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return graphs


def _batches(layout, graphs):
    kw = LAYOUTS[layout]
    tg = batch_graphs(graphs, with_snorm=True, **kw)
    jg = j_batch_graphs(graphs, with_snorm=True, **dict(dict(with_ell=False),
                                                          **kw))
    return tg, jg


def _run_both(kernel, layout, aggs=AGGS, cdt=torch.float32,
              divide_input=True, edge_features=True):
    rng = np.random.RandomState(1)
    tg, jg = _batches(layout, _graphs(rng))
    h = rng.randn(tg.n_node_pad, D).astype(np.float32)
    e = rng.randn(tg.n_edge_pad, FE).astype(np.float32)
    h[3] = h[4]                          # equal messages: max/min ties
    jl = JPNALayerFused(out_dim=D, aggregators=aggs, scalers=SCALERS,
                        avg_d=AVG_D, towers=T, divide_input=divide_input,
                        graph_norm=True, batch_norm=True, residual=True,
                        edge_features=edge_features, kernel=kernel,
                        compute_dtype=(jnp.bfloat16 if cdt == torch.bfloat16
                                       else None))
    je = jnp.asarray(e) if edge_features else None
    var = jax.tree_util.tree_map(np.asarray, jl.init(
        {'params': jax.random.PRNGKey(0)}, jg, jnp.asarray(h), je,
        train=False))

    def jloss(p, h, e):
        out, mut = jl.apply({'params': p,
                             'batch_stats': var['batch_stats']}, jg, h, e,
                            train=True, mutable=['batch_stats'])
        return jnp.sum(out * out), (out, mut['batch_stats'])

    (l_j, (out_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if edge_features else (0, 1),
        has_aux=True))(var['params'], jnp.asarray(h), je)

    tl = PNALayerFused(D, D, aggs, SCALERS, AVG_D, towers=T,
                       divide_input=divide_input, graph_norm=True,
                       batch_norm=True, residual=True,
                       edge_features=edge_features, edge_dim=FE,
                       kernel=kernel, compute_dtype=cdt, device='cpu')
    tl.load_state_dict(from_jax(var['params'], var['batch_stats']))
    tl.train()
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True) if edge_features else None
    out_t = tl(tg, ht, et)
    l_t = torch.sum(out_t * out_t)
    l_t.backward()

    want = from_jax(jax.tree_util.tree_map(np.asarray, grads_j[0]))
    got = {k: p.grad for k, p in tl.named_parameters()}
    assert set(want) == set(got)
    pairs = [(k, got[k].numpy(), w.numpy()) for k, w in want.items()]
    pairs.append(('h', ht.grad.numpy(), np.asarray(grads_j[1])))
    if edge_features:
        pairs.append(('e', et.grad.numpy(), np.asarray(grads_j[2])))
    stats = from_jax({}, jax.tree_util.tree_map(np.asarray, stats_j))
    stat_pairs = [(k, tl.state_dict()[k].numpy(), w.numpy())
                  for k, w in stats.items()]
    return (float(l_t.detach()), out_t.detach().numpy(), pairs, stat_pairs,
            float(l_j), np.asarray(out_j))


CASES = [
    # (kernel, batch layout, aggregators): the bucketed moment path, the
    # bucketed raw bank, ELL, auto on each layout, generic with identity
    ('bucketed', 'bucketed', AGGS),
    ('bucketed', 'bucketed', ('mean', 'softmax', 'softmin', 'max')),
    ('auto', 'bucketed', AGGS),
    ('ell', 'ell', AGGS),
    ('auto', 'ell', AGGS),
    ('auto', 'csr', AGGS),
    ('generic', 'csr', AGGS + ('identity',)),
    ('generic', 'ell', ('identity',) + AGGS),
    ('auto', 'bucketed', AGGS + ('identity',)),
]


@pytest.mark.parametrize("kernel,layout,aggs", CASES,
                         ids=[f"{k}-{l}-{len(a)}" for k, l, a in CASES])
def test_layer_backend_matches_jax(kernel, layout, aggs):
    l_t, out_t, pairs, stat_pairs, l_j, out_j = _run_both(kernel, layout,
                                                          aggs)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=k)
    for k, g, w in stat_pairs:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kernel,layout", [('bucketed', 'bucketed'),
                                           ('ell', 'ell')])
def test_layer_backend_shared_inputs_matches_jax(kernel, layout):
    """divide_input=False (every tower sees all of h) without edge
    features."""
    l_t, out_t, pairs, _, l_j, out_j = _run_both(
        kernel, layout, divide_input=False, edge_features=False)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=k)
