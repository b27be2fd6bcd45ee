"""OGB MolHIV records: the raw-CSV reader and the synthetic molecules.

Counterpart of ``pna_tpu/data/hiv.py``: ``load_ogb_molhiv`` reads the
ogbg-molhiv directory (``raw/*.csv.gz`` and ``split/scaffold/*.csv.gz``),
``synthetic_molhiv`` draws the same numpy random stream as the JAX function,
so one seed gives the same records in both packages, and ``HIVDataset``
drops graphs of 5 nodes or fewer, as the reference does.  Records carry the
9 OGB atom features per node (int32) and an int label; the graphs are
collated by ``data/molecules.py``.
"""

from __future__ import annotations

import csv
import gzip
import os
from typing import Dict, List

import numpy as np

from pna_tpu_torch.nn.nets import OGB_ATOM_FEATURE_DIMS
from pna_tpu_torch.ops.scalers import avg_d_from_degrees


def _read_csv_gz(path):
    with gzip.open(path, 'rt') as f:
        return list(csv.reader(f))


def load_ogb_molhiv(root: str) -> Dict[str, List[dict]]:
    """The ogbg-molhiv raw directory (edge.csv.gz, node-feat.csv.gz,
    num-node-list.csv.gz, num-edge-list.csv.gz, graph-label.csv.gz) split by
    the scaffold indices: {'train', 'valid', 'test'} -> records."""
    raw = os.path.join(root, 'raw')

    def table(name):
        return np.asarray(_read_csv_gz(os.path.join(raw, name)),
                          dtype=np.int64)

    edges = table('edge.csv.gz')
    node_feat = table('node-feat.csv.gz')
    nn_list = table('num-node-list.csv.gz').reshape(-1)
    ne_list = table('num-edge-list.csv.gz').reshape(-1)
    labels = table('graph-label.csv.gz').reshape(-1)

    records = []
    n_off = e_off = 0
    for n, e, y in zip(nn_list, ne_list, labels):
        ed = edges[e_off:e_off + e]
        records.append(dict(
            node_feats=node_feat[n_off:n_off + n].astype(np.int32),
            senders=ed[:, 0].astype(np.int32),
            receivers=ed[:, 1].astype(np.int32),
            label=int(y)))
        n_off += n
        e_off += e

    split_dir = os.path.join(root, 'split', 'scaffold')
    out = {}
    for split in ('train', 'valid', 'test'):
        idx = np.asarray(_read_csv_gz(os.path.join(split_dir,
                                                   f'{split}.csv.gz')),
                         dtype=np.int64).reshape(-1)
        out[split] = [records[i] for i in idx]
    return out


def synthetic_molhiv(n_graphs: int, seed: int = 0, n_min: int = 8,
                     n_max: int = 30) -> List[dict]:
    """Random trees with OGB atom features; the binary label depends on the
    mean atomic number, so a model can learn it."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = rng.randint(n_min, n_max + 1)
        feats = np.stack(
            [rng.randint(0, d, size=n) for d in OGB_ATOM_FEATURE_DIMS],
            axis=1).astype(np.int32)
        senders, receivers = [], []
        for v in range(1, n):
            u = rng.randint(0, v)
            senders += [u, v]
            receivers += [v, u]
        label = int(feats[:, 0].mean() > OGB_ATOM_FEATURE_DIMS[0] / 2.2)
        out.append(dict(node_feats=feats,
                        senders=np.asarray(senders, dtype=np.int32),
                        receivers=np.asarray(receivers, dtype=np.int32),
                        label=label))
    return out


class HIVDataset:
    """MolHIV train/val/test; graphs of 5 nodes or fewer are dropped."""

    def __init__(self, train, val, test):
        def keep(records):
            return [r for r in records if r['node_feats'].shape[0] > 5]
        self.train, self.val, self.test = keep(train), keep(val), keep(test)

    @classmethod
    def from_ogb_dir(cls, root: str):
        splits = load_ogb_molhiv(root)
        return cls(splits['train'], splits['valid'], splits['test'])

    @classmethod
    def synthetic(cls, n_train=200, n_val=40, n_test=40, seed=0):
        return cls(synthetic_molhiv(n_train, seed),
                   synthetic_molhiv(n_val, seed + 1),
                   synthetic_molhiv(n_test, seed + 2))

    def avg_d(self) -> Dict[str, float]:
        """Mean over train graphs of mean(log(in_degree + 1))."""
        degs = []
        for rec in self.train:
            n = rec['node_feats'].shape[0]
            degs.append(np.bincount(rec['receivers'], minlength=n))
        return avg_d_from_degrees(degs)
