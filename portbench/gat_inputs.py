"""The inputs of a GAT cell, drawn from its seed: the graph, 50 standard
normal features a node (PPI's width), ``label_dim`` binary labels a node
and the validation share, the traffic file's ``graph`` kind with a
multi-label target in place of the neighbour statistics.

The graph, the features and the validation draw take the streams
``traffic.make_inputs`` gives them (sub-seeds 0 and 1 of the run's seed);
the labels take sub-seed 2.  ``neighbor_mean_labels`` is a frozen copy of
``pna_tpu_torch/train/largegraph.py::neighbor_mean_labels``: a change to
the program's copy does not change what a cell feeds it.
"""

from __future__ import annotations

import numpy as np

from portbench import generators
from portbench.weights import sub_seeds


def neighbor_mean_labels(senders: np.ndarray, receivers: np.ndarray,
                         feats: np.ndarray, num_nodes: int, label_dim: int,
                         seed: int = 0) -> np.ndarray:
    """y_ic = 1[(mean over j in N(i) and i of x_j P) . r_c > 0], with P
    [F, 8] and r_c [8] standard normal from ``seed``: [N, label_dim]
    float32."""
    rng = np.random.RandomState(seed)
    proj = rng.randn(feats.shape[1], 8)
    mix = rng.randn(8, label_dim)
    q = feats.astype(np.float64) @ proj
    s = q.copy()
    for c in range(q.shape[1]):
        s[:, c] += np.bincount(receivers, weights=q[senders, c],
                               minlength=num_nodes)
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    return ((s / (deg + 1.0)[:, None]) @ mix > 0).astype(np.float32)


def make_inputs(config: dict, traffic: dict, seed: int) -> dict:
    s = sub_seeds(seed, 4)
    n, e = config['num_nodes'], config['num_edges']
    if traffic['graph_kind'] == 'powerlaw':
        send, recv = generators.powerlaw_graph(n, e, int(s[0]),
                                               traffic['exponent'])
    elif traffic['graph_kind'] == 'uniform':
        send, recv = generators.uniform_graph(n, e, int(s[0]))
    else:
        raise ValueError(f"graph_kind {traffic['graph_kind']!r}")
    rng = np.random.RandomState(int(s[1]))
    feats = rng.randn(n, config['feat_dim']).astype(np.float32)
    val = rng.rand(n) < traffic['val_frac']
    labels = neighbor_mean_labels(send, recv, feats, n, config['label_dim'],
                                  int(s[2]))
    return dict(senders=send, receivers=recv, feats=feats, labels=labels,
                val=val, num_nodes=n)
