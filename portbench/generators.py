"""Frozen copies of the input generators the benchmark's traffic is made by.

These are the yardstick's, not the program's: a later change to the
program's own generators does not change what a cell feeds it.  Each draws
what the function named in its docstring drew when the benchmark was
written: a copy of it, or its distribution drawn in bulk.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

NUM_ATOM_TYPE = 28
NUM_BOND_TYPE = 4


def zinc_like_molecules(n_graphs: int, seed: int = 0, n_min: int = 9,
                        n_max: int = 37) -> List[dict]:
    """Random molecule-shaped graphs, as edge-list records, with a learnable
    synthetic target: label = mean(atom_type)/NUM_ATOM_TYPE + 0.1 *
    edges/atoms.

    The distribution of ``pna_tpu_torch/data/molecules.py::synthetic_zinc``
    and its records (``molecule_to_record``), drawn in a few bulk calls in
    place of its loop over graphs: ``n`` uniform in [n_min, n_max]; a random
    tree (node v bonded to a uniform u < v); ``max(n // 6, 1)`` extra bonds
    between uniform pairs, each kept unless it is a self-loop or the pair is
    already bonded; bond types uniform in [1, NUM_BOND_TYPE); both
    directions of each bond, ordered by sender then receiver."""
    rng = np.random.RandomState(seed)
    n = rng.randint(n_min, n_max + 1, size=n_graphs).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(n)])
    total = int(off[-1])
    atom = rng.randint(0, NUM_ATOM_TYPE, size=total).astype(np.int32)
    # the tree: every node but a graph's first takes a parent before it
    g_node = np.repeat(np.arange(n_graphs), n)
    local = np.arange(total) - off[g_node]
    child = local > 0
    v = local[child]
    u = np.floor(rng.rand(v.size) * v).astype(np.int64)
    g_tree = g_node[child]
    # the extra bonds, in draw order, so the first of two equal pairs stays
    k = np.maximum(n // 6, 1)
    g_ex = np.repeat(np.arange(n_graphs), k)
    a = np.floor(rng.rand(g_ex.size) * n[g_ex]).astype(np.int64)
    b = np.floor(rng.rand(g_ex.size) * n[g_ex]).astype(np.int64)
    g = np.concatenate([g_tree, g_ex])
    lo = off[g] + np.concatenate([u, np.minimum(a, b)])
    hi = off[g] + np.concatenate([v, np.maximum(a, b)])
    btype = rng.randint(1, NUM_BOND_TYPE, size=g.size).astype(np.int32)
    keep = lo != hi
    _, first = np.unique(lo * total + hi, return_index=True)
    once = np.zeros(g.size, dtype=bool)
    once[first] = True
    keep &= once
    lo, hi, btype = lo[keep], hi[keep], btype[keep]
    send = np.concatenate([lo, hi])
    recv = np.concatenate([hi, lo])
    etype = np.concatenate([btype, btype])
    order = np.argsort(send * total + recv, kind='stable')
    send, recv, etype = send[order], recv[order], etype[order]
    edge_off = np.searchsorted(send, off)
    atom_sum = np.add.reduceat(atom.astype(np.float64), off[:-1])
    label = (atom_sum / n / NUM_ATOM_TYPE
             + 0.1 * np.diff(edge_off) / (2.0 * n))
    out = []
    for i in range(n_graphs):
        e0, e1, o = edge_off[i], edge_off[i + 1], off[i]
        out.append(dict(
            node_feats=atom[o:off[i + 1], None],
            senders=(send[e0:e1] - o).astype(np.int32),
            receivers=(recv[e0:e1] - o).astype(np.int32),
            edge_feats=etype[e0:e1, None],
            label=float(label[i])))
    return out


def powerlaw_graph(num_nodes: int, num_edges: int, seed: int = 0,
                   exponent: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """A power-law directed graph: weights ~ rank^-exponent over a permuted
    node order pick the senders, receivers are uniform (copy of
    ``pna_tpu_torch/parallel/partition.py::powerlaw_graph``)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    w = ranks ** -exponent
    w /= w.sum()
    perm = rng.permutation(num_nodes)
    senders = perm[rng.choice(num_nodes, size=num_edges, p=w)]
    receivers = rng.randint(0, num_nodes, size=num_edges)
    return senders.astype(np.int64), receivers.astype(np.int64)


def uniform_graph(num_nodes: int, num_edges: int, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform senders and receivers (the ``graph_kind='uniform'`` branch of
    ``pna_tpu_torch/train/largegraph.py::build_problem``, on a stream of its
    own)."""
    rng = np.random.RandomState(seed)
    send = rng.randint(0, num_nodes, num_edges).astype(np.int64)
    recv = rng.randint(0, num_nodes, num_edges).astype(np.int64)
    return send, recv


def neighbor_stats_labels(senders: np.ndarray, receivers: np.ndarray,
                          feats: np.ndarray, num_nodes: int) -> np.ndarray:
    """y_i = mean_{j->i} x_j[0] + 0.5 * max_{j->i} x_j[1]
    + 0.25 * log(1 + deg_i) (copy of
    ``pna_tpu_torch/train/largegraph.py::neighbor_stats_labels``)."""
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    s0 = np.zeros(num_nodes)
    np.add.at(s0, receivers, feats[senders, 0].astype(np.float64))
    mean0 = s0 / np.maximum(deg, 1.0)
    mx1 = np.full(num_nodes, -np.inf)
    np.maximum.at(mx1, receivers, feats[senders, 1].astype(np.float64))
    mx1[deg == 0] = 0.0
    y = mean0 + 0.5 * mx1 + 0.25 * np.log1p(deg)
    return y.astype(np.float32)
