"""ZINC records, their collation into a ``Graph``, and the per-epoch batch
iterator.

Counterpart of ``pna_tpu/data/molecules.py``: ``synthetic_zinc`` draws the
same numpy random stream, so one seed gives the same records in both
packages; ``ZincDataset.from_dir`` reads the real split pickles and their
``.index`` files; ``collate_records`` batches records into a receiver-sorted
CSR ``Graph``.  Batches are on the CPU; the trainer moves each to the card
once.

ZINC constants: num_atom_type=28, num_bond_type=4.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pna_tpu_torch.graph import Graph, batch_graphs
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
                    with_snorm: bool = True
                    ) -> Tuple[Graph, torch.Tensor]:
    """Batch + pad records into a Graph; returns (graph, labels [G_pad]),
    both on the CPU."""
    g = batch_graphs(list(records), n_node_pad=n_node_pad,
                     n_edge_pad=n_edge_pad, with_snorm=with_snorm)
    is_int = isinstance(records[0].get('label', 0.0), (int, np.integer))
    labels = np.zeros((g.n_graph_pad,), dtype=np.int64 if is_int
                      else np.float32)
    for i, rec in enumerate(records):
        labels[i] = rec.get('label', 0)
    return g, torch.from_numpy(labels)


def batch_iterator(records: List[dict], batch_size: int, seed: int,
                   shuffle: bool = True, node_pad_multiple: int = 64,
                   edge_pad_multiple: int = 256
                   ) -> Iterator[Tuple[Graph, torch.Tensor]]:
    """Yield (graph, labels) minibatches on the CPU, in the order of
    ``np.random.RandomState(seed)`` when ``shuffle``.

    Every batch holds ``batch_size`` graphs: a short last batch is filled
    from the head of the record list and its fillers get ``graph_mask``
    False.  Nodes (with the one padding node) are padded to a multiple of
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
        n_nodes = sum(r['node_feats'].shape[0] for r in chunk) + 1
        n_edges = sum(len(r['senders']) for r in chunk)
        npad = -(-n_nodes // node_pad_multiple) * node_pad_multiple
        epad = max(-(-n_edges // edge_pad_multiple) * edge_pad_multiple,
                   edge_pad_multiple)
        g, labels = collate_records(chunk, n_node_pad=npad, n_edge_pad=epad)
        g.graph_mask[n_valid:] = False
        yield g, labels
