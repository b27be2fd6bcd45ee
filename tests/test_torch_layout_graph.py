"""The ELL and degree-bucketed layouts of the port against pna_tpu on the
CPU: ``_choose_classes``, ``_bucketize`` (through ``batch_graphs``),
``build_ell``, ``batch_graphs(bucket_by_degree=..., with_ell=...)``,
``collate_records``, ``derive_bucket_caps`` and ``batch_iterator`` with its
caps.  Every case is equal array for array, integers and floats, the bucket
spec and the caps dicts included: the same host arithmetic on both sides."""

import numpy as np
import pytest
import torch

from pna_tpu import graph as jgraph
from pna_tpu.data import molecules as jmol
from pna_tpu_torch import graph as tgraph
from pna_tpu_torch.data import molecules as tmol

FIELDS = ('node_feats', 'senders', 'receivers', 'node_graph_ids',
          'node_mask', 'edge_mask', 'graph_mask', 'edge_ptr', 'edge_feats',
          'snorm_n', 'snorm_e', 'nbr_edge_ids', 'nbr_mask', 'in_deg')


def assert_same_graph(tg, jg, ell=True):
    """Every field equal; ``ell=False`` skips the ELL table, which the JAX
    batcher builds by default and the port's does not."""
    for f in FIELDS if ell else FIELDS[:11] + FIELDS[13:]:
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert tg.bucket_spec == jg.bucket_spec
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


def test_choose_classes_matches_jax():
    """Random degree histograms, including ties between groupings, for 1
    to 6 classes."""
    rng = np.random.RandomState(0)
    for _ in range(60):
        degs = rng.choice(np.arange(0, 20), rng.randint(1, 12),
                          replace=False)
        counts = {int(d): int(rng.randint(1, 6)) for d in degs}
        for k in range(1, 7):
            assert (tgraph._choose_classes(counts, k)
                    == jgraph._choose_classes(counts, k)), (counts, k)
    assert tgraph._choose_classes({}, 4) == {}


@pytest.mark.parametrize("kw", [
    dict(bucket_by_degree=True),
    dict(bucket_by_degree=True, bucket_max_buckets=2),
    dict(bucket_by_degree=True, bucket_max_buckets=1, with_ell=True),
    dict(bucket_by_degree=True, with_ell=True, with_snorm=True),
    dict(with_ell=True, with_snorm=True),
    dict(with_ell=True, sort_edges=False),
    dict(with_ell=True, ell_max_degree=8),
    dict(sort_edges=False),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_batch_graphs_layouts_match_jax(kw):
    """Bucketed and ELL batches with a degree-0 node and a node of at least
    12 in-edges (over ``ell_max_degree=8``: no ELL table then; every other
    node has at most 8)."""
    graphs = _graphs(np.random.RandomState(1), 9, hub=12)
    tg = tgraph.batch_graphs(graphs, **kw)
    jg = jgraph.batch_graphs(graphs, **dict(dict(with_ell=False), **kw))
    assert_same_graph(tg, jg)
    if kw.get('ell_max_degree') == 8:
        assert tg.nbr_edge_ids is None
    if kw.get('bucket_by_degree'):
        assert tg.edge_ptr is None and tg.bucket_spec[0][0] == 0
        deg = np.bincount(tg.receivers.numpy()[tg.edge_mask.numpy()],
                          minlength=tg.n_node_pad)
        np.testing.assert_array_equal(tg.in_deg.numpy(), deg)
        assert tg.max_in_degree == deg.max() >= 12


def test_bucket_caps_force_wide_classes_match_jax():
    """Explicit caps whose classes are wider than the nodes' degrees (dummy
    slots inside a row), and caps too small or without a wide enough class
    raise as in JAX."""
    graphs = _graphs(np.random.RandomState(2), 7)
    caps = {0: 16, 3: 64, 9: 16}
    tg = tgraph.batch_graphs(graphs, bucket_by_degree=True, bucket_caps=caps,
                             with_ell=True)
    jg = jgraph.batch_graphs(graphs, bucket_by_degree=True, bucket_caps=caps)
    assert_same_graph(tg, jg)
    assert tg.bucket_spec == ((0, 16), (3, 64), (9, 16))
    assert int(tg.in_deg[16:80].max()) <= 3 and int(tg.in_deg.min()) == 0
    for bad in ({0: 16, 2: 64}, {0: 16, 3: 8, 9: 16}):
        with pytest.raises(ValueError):
            tgraph.batch_graphs(graphs, bucket_by_degree=True,
                                bucket_caps=bad)
        with pytest.raises(ValueError):
            jgraph.batch_graphs(graphs, bucket_by_degree=True,
                                bucket_caps=bad)


@pytest.mark.parametrize("max_degree", [None, 8, 3])
def test_build_ell_matches_jax_native(max_degree):
    """build_ell on an unsorted edge list with masked edges: rows in edge
    order, as the JAX package's native build_ell fills them."""
    rng = np.random.RandomState(3)
    n, e = 40, 300
    recv = rng.randint(0, n, e).astype(np.int32)
    mask = rng.rand(e) < 0.8
    got = tgraph.build_ell(recv, mask, n, max_degree=max_degree)
    want = jgraph.build_ell(recv, mask, n, max_degree=max_degree)
    if max_degree == 3:
        assert got == (None, None) and want == (None, None)
        return
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_collate_records_bucketed_and_ell_match_jax():
    recs = tmol.synthetic_zinc(40, seed=5)
    jrecs = jmol.synthetic_zinc(40, seed=5)
    tg, tl = tmol.collate_records(recs, bucket_by_degree=True, with_ell=True)
    jg, jl = jmol.collate_records(jrecs, bucket_by_degree=True)
    assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tl.numpy(), jl)
    tg, _ = tmol.collate_records(recs, with_ell=True)
    jg, _ = jmol.collate_records(jrecs)
    assert_same_graph(tg, jg)


@pytest.mark.parametrize("n_records,batch_size,max_buckets", [
    (50, 16, 4), (10, 16, 4), (33, 8, 2)])
def test_derive_bucket_caps_and_batches_match_jax(n_records, batch_size,
                                                  max_buckets):
    """derive_bucket_caps (a dataset smaller than the batch takes the
    cycled filler) and every batch of batch_iterator with its caps: one
    shape for all, array-equal to the JAX batches."""
    recs = tmol.synthetic_zinc(n_records, seed=7)
    jrecs = jmol.synthetic_zinc(n_records, seed=7)
    caps = tmol.derive_bucket_caps(recs, batch_size, max_buckets)
    assert caps == jmol.derive_bucket_caps(jrecs, batch_size, max_buckets)
    shapes = set()
    for (tg, tl), (jg, jl) in zip(
            tmol.batch_iterator(recs, batch_size, 3, bucket_caps=caps),
            jmol.batch_iterator(jrecs, batch_size, 3, bucket_caps=caps)):
        assert_same_graph(tg, jg, ell=False)
        assert tg.nbr_edge_ids is None
        np.testing.assert_array_equal(tl.numpy(), jl)
        shapes.add((tg.n_node_pad, tg.n_edge_pad, tg.bucket_spec))
    assert len(shapes) == 1


def test_layout_tables_follow_the_graph():
    """Graph.to keeps the spec and moves the tables; sort_by_receiver,
    which moves edges, drops the tables that index them."""
    tg, _ = tmol.collate_records(tmol.synthetic_zinc(8, seed=0),
                                 bucket_by_degree=True, with_ell=True)
    moved = tg.to('cpu')
    assert moved.bucket_spec == tg.bucket_spec
    assert torch.equal(moved.nbr_edge_ids, tg.nbr_edge_ids)
    assert moved.in_deg.dtype == torch.float32
    s = tgraph.sort_by_receiver(tg)
    assert s.bucket_spec is None and s.nbr_edge_ids is None
    assert s.nbr_mask is None and s.edge_ptr is not None
    assert torch.equal(s.in_deg, tg.in_deg)
