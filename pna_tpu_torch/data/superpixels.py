"""MNIST/CIFAR10 superpixel graph records.

A copy of ``pna_tpu/data/superpixels.py`` (which imports no JAX), with the
same numpy and scipy calls, so one seed gives the same records in both
packages.

Graph construction (superpixels.py:23-75): Gaussian-kernel adjacency from
coordinate + feature distances with sigma from the k=8 nearest neighbours, then
a k=8 kNN edge list; node features are [mean_px, coord] and the edge feature is
the kernel value.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
from scipy.spatial.distance import cdist

from pna_tpu_torch.ops.scalers import avg_d_from_degrees


def sigma(dists: np.ndarray, kth: int = 8) -> np.ndarray:
    """Scale = mean distance to the k nearest neighbours (superpixels.py:23-34)."""
    try:
        knns = np.partition(dists, kth, axis=-1)[:, kth::-1]
        sig = knns.sum(axis=1).reshape((knns.shape[0], 1)) / kth
    except ValueError:  # graphs smaller than kth
        num_nodes = dists.shape[0]
        sig = np.array([1] * num_nodes).reshape(num_nodes, 1)
    return sig + 1e-8


def compute_adjacency_matrix_images(coord, feat, use_feat: bool = True,
                                    kth: int = 8) -> np.ndarray:
    """exp(-(d_coord/sigma)^2 - (d_feat/sigma)^2), symmetrised, zero diagonal
    (superpixels.py:37-53)."""
    coord = coord.reshape(-1, 2)
    c_dist = cdist(coord, coord)
    if use_feat:
        f_dist = cdist(feat, feat)
        A = np.exp(-(c_dist / sigma(c_dist)) ** 2 - (f_dist / sigma(f_dist)) ** 2)
    else:
        A = np.exp(-(c_dist / sigma(c_dist)) ** 2)
    A = 0.5 * (A + A.T)
    A[np.diag_indices_from(A)] = 0
    return A


def compute_edges_list(A: np.ndarray, kth: int = 8 + 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k similar neighbours per node (superpixels.py:56-75); returns
    (knn indices [N, k], kernel values [N, k]).  Graphs with <= 9 nodes become
    fully connected."""
    num_nodes = A.shape[0]
    new_kth = num_nodes - kth
    if num_nodes > 9:
        knns = np.argpartition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
        knn_values = np.partition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
    else:
        knns = np.tile(np.arange(num_nodes), num_nodes).reshape(num_nodes,
                                                                num_nodes)
        knn_values = A
        if num_nodes != 1:
            sel = knns != np.arange(num_nodes)[:, None]
            knn_values = A[sel].reshape(num_nodes, -1)
            knns = knns[sel].reshape(num_nodes, -1)
    return knns, knn_values


def superpixel_to_record(mean_px, coord, label, img_size: int,
                         use_mean_px: bool = True) -> dict:
    """Build one graph record (superpixels.py:107-149 _prepare): node feature =
    [mean_px, x, y], edge (i -> knn_j) with kernel-value edge feature."""
    coord = np.asarray(coord, dtype=np.float64) / img_size
    mean_px = np.asarray(mean_px, dtype=np.float64).reshape(len(coord), -1)
    A = compute_adjacency_matrix_images(coord, mean_px, use_feat=use_mean_px)
    knns, knn_values = compute_edges_list(A)
    n = len(coord)
    senders, receivers, efeat = [], [], []
    for i in range(n):
        for j, v in zip(knns[i], knn_values[i]):
            senders.append(i)
            receivers.append(int(j))
            efeat.append(v)
    node_feats = np.concatenate([mean_px, coord.reshape(n, 2)], axis=1)
    return dict(node_feats=node_feats.astype(np.float32),
                senders=np.asarray(senders, dtype=np.int32),
                receivers=np.asarray(receivers, dtype=np.int32),
                edge_feats=np.asarray(efeat, dtype=np.float32)[:, None],
                label=int(label))


def load_superpix_split(data_dir: str, dataset: str, split: str) -> List[dict]:
    """Load the Benchmarking-GNNs pickles (superpixels.py:91-103)."""
    img_size = 28 if dataset == 'MNIST' else 32
    fname = ('mnist_75sp_%s.pkl' if dataset == 'MNIST'
             else 'cifar10_150sp_%s.pkl') % split
    with open(os.path.join(data_dir, fname), 'rb') as f:
        labels, sp_data = pickle.load(f)
    return [superpixel_to_record(s[0], s[1], l, img_size)
            for s, l in zip(sp_data, labels)]


def synthetic_superpixels(n_graphs: int, n_sp: int = 20, n_classes: int = 10,
                          seed: int = 0, img_size: int = 28) -> List[dict]:
    """Random superpixel-shaped graphs with a learnable label: the label is a
    deterministic function of mean pixel intensity (quantized)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        coord = rng.rand(n_sp, 2) * img_size
        mean_px = rng.rand(n_sp, 1)
        label = int(min(mean_px.mean() * n_classes, n_classes - 1))
        out.append(superpixel_to_record(mean_px, coord, label, img_size))
    return out


class SuperpixelsDataset:
    def __init__(self, train, val, test, n_classes: int = 10):
        self.train, self.val, self.test = train, val, test
        self.n_classes = n_classes

    @classmethod
    def from_dir(cls, data_dir: str, dataset: str = 'MNIST',
                 val_fraction: int = 5000):
        train_full = load_superpix_split(data_dir, dataset, 'train')
        test = load_superpix_split(data_dir, dataset, 'test')
        # reference: last 5000 train graphs become the val split
        return cls(train_full[:-val_fraction], train_full[-val_fraction:], test)

    @classmethod
    def synthetic(cls, n_train=200, n_val=40, n_test=40, seed=0, n_sp=20):
        return cls(synthetic_superpixels(n_train, n_sp, seed=seed),
                   synthetic_superpixels(n_val, n_sp, seed=seed + 1),
                   synthetic_superpixels(n_test, n_sp, seed=seed + 2))

    def avg_d(self) -> Dict[str, float]:
        degs = []
        for rec in self.train:
            n = rec['node_feats'].shape[0]
            degs.append(np.bincount(rec['receivers'], minlength=n))
        return avg_d_from_degrees(degs)
