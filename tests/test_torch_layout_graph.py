"""The port's receiver-sorted batches against the JAX package's ELL batches
on the CPU, on graphs with a degree-0 node and an in-degree hub: the port
builds no ELL table (nor the JAX package's degree-bucketed layout), and
every field the two batches share is equal array for array, integers and
floats: the same host arithmetic on both sides."""

import numpy as np
import pytest

from pna_tpu import graph as jgraph
from pna_tpu_torch import graph as tgraph

FIELDS = ('node_feats', 'senders', 'receivers', 'node_graph_ids',
          'node_mask', 'edge_mask', 'graph_mask', 'edge_ptr', 'edge_feats',
          'snorm_n', 'snorm_e')
ELL_ARGS = ('with_ell', 'ell_max_degree')


def assert_same_graph(tg, jg):
    for f in FIELDS:
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert (tg.n_node_pad, tg.n_edge_pad, tg.n_graph_pad) == (
        jg.n_node_pad, jg.n_edge_pad, jg.n_graph_pad)


def _graphs(rng, n_graphs, hub=0):
    """Random directed graphs with edge features; the first has an
    isolated node (degree 0) and, with ``hub``, a node of ``hub``
    in-edges."""
    graphs = []
    for i in range(n_graphs):
        n = rng.randint(3, 10)
        adj = (rng.rand(n, n) < 0.35) & ~np.eye(n, dtype=bool)
        adj[np.arange(1, n), np.roll(np.arange(1, n), 1)] = True
        if i == 0:
            adj[:, 0] = adj[0, :] = False
        s, r = np.nonzero(adj)
        if i == 0 and hub:
            s = np.concatenate([s, rng.randint(1, n, hub)])
            r = np.concatenate([r, np.full(hub, 1)])
        graphs.append(dict(node_feats=rng.randn(n, 3).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32),
                           edge_feats=rng.randn(len(s), 2)
                           .astype(np.float32)))
    return graphs



@pytest.mark.parametrize("kw", [
    dict(with_ell=True, with_snorm=True),
    dict(with_ell=True, sort_edges=False),
    dict(with_ell=True, ell_max_degree=8),
    dict(sort_edges=False),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_batch_graphs_layouts_match_jax(kw):
    """A batch with a degree-0 node and a node of at least 12 in-edges
    (over ``ell_max_degree=8``: the JAX batch has no ELL table then); the
    port takes ``kw`` without the ELL arguments."""
    graphs = _graphs(np.random.RandomState(1), 9, hub=12)
    tg = tgraph.batch_graphs(graphs, **{k: v for k, v in kw.items()
                                        if k not in ELL_ARGS})
    jg = jgraph.batch_graphs(graphs, **dict(dict(with_ell=False), **kw))
    assert_same_graph(tg, jg)
    assert (jg.nbr_edge_ids is None) == (kw.get('ell_max_degree') == 8
                                         or not kw.get('with_ell'))
    deg = np.bincount(tg.receivers.numpy()[tg.edge_mask.numpy()],
                      minlength=tg.n_node_pad)
    assert tg.max_in_degree == deg.max() >= 12
    assert (tg.edge_ptr is None) == (kw.get('sort_edges') is False)
