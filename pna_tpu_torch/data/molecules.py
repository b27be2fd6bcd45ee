"""ZINC records, their collation into a ``Graph``, the degree-bucket
capacities, and the per-epoch batch iterator.

Counterpart of ``pna_tpu/data/molecules.py``: ``synthetic_zinc`` draws the
same numpy random stream, so one seed gives the same records in both
packages; ``ZincDataset.from_dir`` reads the real split pickles and their
``.index`` files; ``collate_records`` batches records into a receiver-sorted
CSR ``Graph``, with the ELL table (``with_ell``) or in the degree-bucketed
layout (``bucket_by_degree``); ``derive_bucket_caps`` gives the bucket
capacities under which every batch of a dataset has one shape, and
``batch_iterator(bucket_caps=...)`` collates with them.  Batches are on the
CPU; the trainer moves each to the card once.

ZINC constants: num_atom_type=28, num_bond_type=4.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pna_tpu_torch.graph import (Graph, _choose_classes, _round_up,
                                 batch_graphs)
from pna_tpu_torch.ops.scalers import avg_d_from_degrees

NUM_ATOM_TYPE = 28
NUM_BOND_TYPE = 4


def molecule_to_record(mol: dict) -> dict:
    """Convert a ZINC molecule dict into an edge-list record."""
    atom_type = np.asarray(mol['atom_type']).astype(np.int32).reshape(-1)
    bond = np.asarray(mol['bond_type'])
    send, recv = np.nonzero(bond)  # row=src, col=dst; both directions present
    edge_type = bond[send, recv].astype(np.int32)
    return dict(node_feats=atom_type[:, None],
                senders=send.astype(np.int32),
                receivers=recv.astype(np.int32),
                edge_feats=edge_type[:, None],
                label=float(mol['logP_SA_cycle_normalized']))


def load_zinc_split(data_dir: str, split: str,
                    num_graphs: Optional[int] = None) -> List[dict]:
    """Records of one ZINC split: ``{split}.pickle`` (a list of molecule
    dicts of torch tensors) reordered and subset by the first row of
    ``{split}.index`` when that file exists."""
    with open(os.path.join(data_dir, f"{split}.pickle"), 'rb') as f:
        data = pickle.load(f)
    idx_path = os.path.join(data_dir, f"{split}.index")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            data_idx = [list(map(int, idx)) for idx in csv.reader(f)]
        data = [data[i] for i in data_idx[0]]
    if num_graphs is not None and len(data) != num_graphs:
        raise ValueError(f"{split}: {len(data)} graphs, expected "
                         f"{num_graphs}")
    return [molecule_to_record(m) for m in data]


def synthetic_zinc(n_graphs: int, seed: int = 0,
                   n_min: int = 9, n_max: int = 30) -> List[dict]:
    """Random molecule-shaped graphs with a learnable synthetic target:
    label = mean(atom_type)/NUM_ATOM_TYPE + 0.1 * edges/atoms."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = rng.randint(n_min, n_max + 1)
        atom_type = rng.randint(0, NUM_ATOM_TYPE, size=n).astype(np.int32)
        # random tree + extra edges (molecule-like sparsity)
        bond = np.zeros((n, n), dtype=np.int32)
        for v in range(1, n):
            u = rng.randint(0, v)
            t = rng.randint(1, NUM_BOND_TYPE)
            bond[u, v] = bond[v, u] = t
        for _ in range(max(n // 6, 1)):
            u, v = rng.randint(0, n, 2)
            if u != v and bond[u, v] == 0:
                t = rng.randint(1, NUM_BOND_TYPE)
                bond[u, v] = bond[v, u] = t
        label = (atom_type.mean() / NUM_ATOM_TYPE
                 + 0.1 * (bond > 0).sum() / (2.0 * n))
        out.append(molecule_to_record(dict(
            num_atom=n, atom_type=atom_type, bond_type=bond,
            logP_SA_cycle_normalized=label)))
    return out


class ZincDataset:
    """ZINC train/val/test splits as edge-list records."""

    def __init__(self, train, val, test,
                 num_atom_type=NUM_ATOM_TYPE, num_bond_type=NUM_BOND_TYPE):
        self.train, self.val, self.test = train, val, test
        self.num_atom_type = num_atom_type
        self.num_bond_type = num_bond_type

    @classmethod
    def from_dir(cls, data_dir: str):
        """The real ZINC splits (train/val/test pickles and index files)."""
        return cls(load_zinc_split(data_dir, 'train'),
                   load_zinc_split(data_dir, 'val'),
                   load_zinc_split(data_dir, 'test'))

    @classmethod
    def synthetic(cls, n_train=200, n_val=40, n_test=40, seed=0):
        return cls(synthetic_zinc(n_train, seed),
                   synthetic_zinc(n_val, seed + 10_000),
                   synthetic_zinc(n_test, seed + 20_000))

    def avg_d(self) -> Dict[str, float]:
        """Mean over train graphs of mean(log(in_degree + 1))."""
        degs = []
        for rec in self.train:
            n = rec['node_feats'].shape[0]
            degs.append(np.bincount(rec['receivers'], minlength=n))
        return avg_d_from_degrees(degs)


def collate_records(records: Sequence[dict],
                    n_node_pad: Optional[int] = None,
                    n_edge_pad: Optional[int] = None,
                    with_snorm: bool = True,
                    bucket_by_degree: bool = False,
                    bucket_caps: Optional[Dict[int, int]] = None,
                    bucket_max_buckets: int = 4,
                    with_ell: bool = False
                    ) -> Tuple[Graph, torch.Tensor]:
    """Batch + pad records into a Graph; returns (graph, labels [G_pad]),
    both on the CPU.  The layout arguments go to ``graph.batch_graphs``."""
    g = batch_graphs(list(records), n_node_pad=n_node_pad,
                     n_edge_pad=n_edge_pad, with_snorm=with_snorm,
                     with_ell=with_ell, bucket_by_degree=bucket_by_degree,
                     bucket_caps=bucket_caps,
                     bucket_max_buckets=bucket_max_buckets)
    is_int = isinstance(records[0].get('label', 0.0), (int, np.integer))
    labels = np.zeros((g.n_graph_pad,), dtype=np.int64 if is_int
                      else np.float32)
    for i, rec in enumerate(records):
        labels[i] = rec.get('label', 0)
    return g, torch.from_numpy(labels)


def derive_bucket_caps(records: Sequence[dict], batch_size: int,
                       max_buckets: int = 4) -> Dict[int, int]:
    """Degree-bucket capacities under which every batch ``batch_iterator``
    can make from ``records`` has one and the same shape.

    The degree classes come from the degree histogram of all records
    (``graph._choose_classes``), so every degree is covered; each class's
    capacity is the sum of the ``batch_size`` largest per-graph counts of
    that class over ``records`` and the filler a short last batch can take
    (``cycle(records)[:batch_size]``: a dataset smaller than the batch wraps
    around).  The degree-0 class takes 8 more slots for the batcher's
    padding nodes; every capacity is rounded up to a multiple of 8."""
    per_graph = []
    counts: Dict[int, int] = {}
    for r in records:
        n = r['node_feats'].shape[0]
        deg = np.bincount(np.asarray(r['receivers']), minlength=n)
        u, c = np.unique(deg, return_counts=True)
        per_graph.append(dict(zip(u.tolist(), c.tolist())))
        for d, k in zip(u.tolist(), c.tolist()):
            counts[int(d)] = counts.get(int(d), 0) + int(k)
    cls_of = _choose_classes(counts, max_buckets)
    caps: Dict[int, List[int]] = {}
    filler = [per_graph[k % len(per_graph)] for k in range(batch_size)]
    for h in per_graph + filler:
        cls_counts: Dict[int, int] = {}
        for d, k in h.items():
            D = cls_of.get(int(d), int(d))
            cls_counts[D] = cls_counts.get(D, 0) + k
        for D, k in cls_counts.items():
            caps.setdefault(D, []).append(k)
    out = {int(D): int(sum(sorted(ks)[-batch_size:]))
           for D, ks in caps.items()}
    out[0] = out.get(0, 0) + 8
    return {d: _round_up(c, 8) for d, c in out.items()}


def batch_iterator(records: List[dict], batch_size: int, seed: int,
                   shuffle: bool = True, node_pad_multiple: int = 64,
                   edge_pad_multiple: int = 256,
                   bucket_caps: Optional[Dict[int, int]] = None
                   ) -> Iterator[Tuple[Graph, torch.Tensor]]:
    """Yield (graph, labels) minibatches on the CPU, in the order of
    ``np.random.RandomState(seed)`` when ``shuffle``.

    Every batch holds ``batch_size`` graphs: a short last batch is filled
    from the head of the record list and its fillers get ``graph_mask``
    False.  With ``bucket_caps`` (``derive_bucket_caps``) every batch is in
    the degree-bucketed layout at those capacities, one shape for all;
    otherwise nodes (with the one padding node) are padded to a multiple of
    ``node_pad_multiple`` and edges to a multiple of ``edge_pad_multiple``,
    so batches come in few shapes."""
    order = np.arange(len(records))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        chunk = [records[j] for j in order[i:i + batch_size]]
        n_valid = len(chunk)
        if n_valid < batch_size:
            need = batch_size - n_valid
            chunk = chunk + [records[k % len(records)] for k in range(need)]
        if bucket_caps is not None:
            g, labels = collate_records(chunk, bucket_by_degree=True,
                                        bucket_caps=bucket_caps)
        else:
            n_nodes = sum(r['node_feats'].shape[0] for r in chunk) + 1
            n_edges = sum(len(r['senders']) for r in chunk)
            npad = -(-n_nodes // node_pad_multiple) * node_pad_multiple
            epad = max(-(-n_edges // edge_pad_multiple) * edge_pad_multiple,
                       edge_pad_multiple)
            g, labels = collate_records(chunk, n_node_pad=npad,
                                        n_edge_pad=epad)
        g.graph_mask[n_valid:] = False
        yield g, labels
