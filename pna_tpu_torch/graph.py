"""Padded edge-list graphs of torch tensors, in the receiver-sorted CSR
layout.

Counterpart of ``pna_tpu/graph.py``.  A batch of graphs is one padded edge
list with the same conventions as the JAX package:

* an edge ``k`` carries a message from ``senders[k]`` to ``receivers[k]``;
* padded edges have ``senders == receivers == n_node_pad - 1`` and
  ``edge_mask == False``; padded nodes sit at the tail with
  ``node_mask == False`` and belong to the last (padded) graph.

Under ``sort_edges=True`` (the default) ``batch_graphs`` sorts the edges by
receiver (stable), so node ``n`` owns ``[edge_ptr[n], edge_ptr[n+1])`` and
``edge_ptr[-1] == n_edge_pad``, the layout the port's kernels walk.  The
JAX package's ELL and degree-bucketed layouts, which it builds so that a
TPU avoids scatters, are not ported: the CSR kernels beat or tie them on the
H100 (PERF.md).  ``sort_by_receiver`` restores the CSR order (and
``edge_ptr``) after a caller has permuted the edges.  Collation runs on the
host in numpy and returns CPU tensors; ``Graph.to(device)`` moves a batch to
the card once, before the steps that use it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass
class Graph:
    """A (batch of) graph(s) as one padded edge list."""

    node_feats: torch.Tensor            # [N_pad, F] (int64 or float32)
    senders: torch.Tensor               # [E_pad] int64 (message source)
    receivers: torch.Tensor             # [E_pad] int64 (message destination)
    node_graph_ids: torch.Tensor        # [N_pad] int64
    node_mask: torch.Tensor             # [N_pad] bool
    edge_mask: torch.Tensor             # [E_pad] bool
    graph_mask: torch.Tensor            # [G_pad] bool
    # CSR row pointers; None unless the edges are sorted by receiver
    edge_ptr: Optional[torch.Tensor] = None     # [N_pad + 1] int32
    edge_feats: Optional[torch.Tensor] = None   # [E_pad, Fe]
    # graph-norm factors sqrt(1/|V_g|), sqrt(1/|E_g|) per node / edge
    snorm_n: Optional[torch.Tensor] = None      # [N_pad, 1] float32
    snorm_e: Optional[torch.Tensor] = None      # [E_pad, 1] float32
    # largest real in-degree, known on the host at collation; the CSR bank
    # checks its ``max_degree`` hint against it without a device sync
    max_in_degree: int = 0

    @property
    def n_node_pad(self) -> int:
        return self.node_feats.shape[0]

    @property
    def n_edge_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def n_graph_pad(self) -> int:
        return self.graph_mask.shape[0]

    def in_degrees(self, dtype=torch.float32) -> torch.Tensor:
        """In-edges per node ([N_pad]); padded edges do not count."""
        return _count(self.receivers, self.n_node_pad, self.edge_mask, dtype)

    def out_degrees(self, dtype=torch.float32) -> torch.Tensor:
        """Out-edges per node ([N_pad]); padded edges do not count."""
        return _count(self.senders, self.n_node_pad, self.edge_mask, dtype)

    def nodes_per_graph(self, dtype=torch.float32) -> torch.Tensor:
        """Real nodes per graph ([G_pad])."""
        return _count(self.node_graph_ids, self.n_graph_pad, self.node_mask,
                      dtype)

    def to(self, device) -> "Graph":
        """A copy with every tensor on ``device``."""
        tensors = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
        return dataclasses.replace(self, **{
            k: v.to(device) for k, v in tensors.items()
            if isinstance(v, torch.Tensor)})


def _count(ids: torch.Tensor, n: int, mask: torch.Tensor,
           dtype) -> torch.Tensor:
    # index_add_ of 0/1 weights: on the card it adds with atomics in no fixed
    # order, but sums of small integers are exact in float32 (below 2^24), so
    # every order gives the same bits and no row sum is needed
    w = mask.to(dtype)
    return w.new_zeros(n).index_add_(0, ids, w)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_graphs(
    graphs: Sequence[dict],
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    n_graph_pad: Optional[int] = None,
    node_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
    with_snorm: bool = False,
    sort_edges: bool = True,
) -> Graph:
    """Static-shape batcher (``pna_tpu.graph.batch_graphs`` without its ELL
    table).

    Each element of ``graphs`` is a dict with ``node_feats`` [n, F],
    ``senders`` [e], ``receivers`` [e] and optionally ``edge_feats`` [e, Fe].
    Node indices are offset per graph; one extra padded graph owns all padded
    nodes; padded edges self-loop on the last padded node.  ``sort_edges``
    sorts the edges by receiver and builds ``edge_ptr`` (module docstring).
    """
    n_total = sum(int(g["node_feats"].shape[0]) for g in graphs)
    e_total = sum(int(len(g["senders"])) for g in graphs)
    n_graphs = len(graphs)

    if n_node_pad is None:
        n_node_pad = _round_up(n_total + 1, node_pad_multiple)
    if n_edge_pad is None:
        n_edge_pad = max(_round_up(max(e_total, 1), edge_pad_multiple),
                         edge_pad_multiple)
    if n_graph_pad is None:
        n_graph_pad = n_graphs + 1
    if n_node_pad < n_total + (1 if n_node_pad > n_total else 0):
        raise ValueError(f"n_node_pad={n_node_pad} < total nodes {n_total}")
    if n_edge_pad < e_total:
        raise ValueError(f"n_edge_pad={n_edge_pad} < total edges {e_total}")

    g0_feats = np.asarray(graphs[0]["node_feats"])
    feat_dim = g0_feats.shape[1] if g0_feats.ndim > 1 else 1
    feat_dtype = (np.int64 if np.issubdtype(g0_feats.dtype, np.integer)
                  else np.float32)
    has_ef = graphs[0].get("edge_feats") is not None
    if has_ef:
        g0_ef = np.asarray(graphs[0]["edge_feats"])
        ef_dim = g0_ef.shape[1] if g0_ef.ndim > 1 else 1
        ef_dtype = (np.int64 if np.issubdtype(g0_ef.dtype, np.integer)
                    else np.float32)

    node_feats = np.zeros((n_node_pad, feat_dim), dtype=feat_dtype)
    senders = np.full((n_edge_pad,), n_node_pad - 1, dtype=np.int64)
    receivers = np.full((n_edge_pad,), n_node_pad - 1, dtype=np.int64)
    node_graph_ids = np.full((n_node_pad,), n_graph_pad - 1, dtype=np.int64)
    node_mask = np.zeros((n_node_pad,), dtype=bool)
    edge_mask = np.zeros((n_edge_pad,), dtype=bool)
    graph_mask = np.zeros((n_graph_pad,), dtype=bool)
    edge_feats = (np.zeros((n_edge_pad, ef_dim), dtype=ef_dtype)
                  if has_ef else None)
    snorm_n = snorm_e = None
    if with_snorm:
        snorm_n = np.ones((n_node_pad, 1), dtype=np.float32)
        snorm_e = np.ones((n_edge_pad, 1), dtype=np.float32)

    n_off, e_off = 0, 0
    for gi, g in enumerate(graphs):
        n = int(g["node_feats"].shape[0])
        e = int(len(g["senders"]))
        node_feats[n_off:n_off + n] = np.asarray(
            g["node_feats"], dtype=feat_dtype).reshape(n, -1)
        senders[e_off:e_off + e] = np.asarray(g["senders"]) + n_off
        receivers[e_off:e_off + e] = np.asarray(g["receivers"]) + n_off
        node_graph_ids[n_off:n_off + n] = gi
        node_mask[n_off:n_off + n] = True
        edge_mask[e_off:e_off + e] = True
        graph_mask[gi] = True
        if has_ef:
            edge_feats[e_off:e_off + e] = np.asarray(
                g["edge_feats"], dtype=ef_dtype).reshape(e, -1)
        if with_snorm:
            snorm_n[n_off:n_off + n] = np.sqrt(1.0 / max(n, 1))
            snorm_e[e_off:e_off + e] = np.sqrt(1.0 / max(e, 1))
        n_off += n
        e_off += e

    # stable receiver sort: real edges become receiver-contiguous (CSR) and
    # padded edges (receiver n_node_pad - 1, after every real edge of that
    # node in the original order) land at the tail
    edge_ptr = None
    if sort_edges:
        order = np.argsort(receivers, kind="stable")
        senders = senders[order]
        receivers = receivers[order]
        edge_mask = edge_mask[order]
        if has_ef:
            edge_feats = edge_feats[order]
        if with_snorm:
            snorm_e = snorm_e[order]
        edge_ptr = np.zeros(n_node_pad + 1, dtype=np.int32)
        edge_ptr[1:] = np.searchsorted(receivers, np.arange(1, n_node_pad + 1),
                                       side="left")
        edge_ptr[-1] = n_edge_pad
    deg = np.bincount(receivers[edge_mask], minlength=n_node_pad)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    return Graph(
        node_feats=t(node_feats),
        senders=t(senders),
        receivers=t(receivers),
        node_graph_ids=t(node_graph_ids),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        graph_mask=t(graph_mask),
        edge_ptr=t(edge_ptr),
        edge_feats=t(edge_feats),
        snorm_n=t(snorm_n),
        snorm_e=t(snorm_e),
        max_in_degree=int(deg.max()) if len(deg) else 0,
    )


def build_graph(node_feats: np.ndarray, senders: np.ndarray,
                receivers: np.ndarray,
                edge_feats: Optional[np.ndarray] = None,
                n_node_pad: Optional[int] = None,
                n_edge_pad: Optional[int] = None) -> Graph:
    """A single-graph ``Graph`` with optional padding (as the JAX function,
    one graph slot when ``n_node_pad`` is not given)."""
    return batch_graphs(
        [dict(node_feats=node_feats, senders=senders, receivers=receivers,
              edge_feats=edge_feats)],
        n_node_pad=n_node_pad, n_edge_pad=n_edge_pad,
        n_graph_pad=1 if n_node_pad is None else None)


def from_dense(adj: np.ndarray, node_feats: np.ndarray,
               n_node_pad: Optional[int] = None,
               n_edge_pad: Optional[int] = None) -> Graph:
    """A batch of dense graphs (``adj`` [B, N, N], ``node_feats``
    [B, N, F]) as one edge-list ``Graph``: ``adj[b, i, j] != 0`` is an edge
    ``j -> i``, so that aggregating over receivers sums the rows of ``adj``
    as the dense aggregators do."""
    adj = np.asarray(adj)
    node_feats = np.asarray(node_feats)
    gs = []
    for b in range(adj.shape[0]):
        recv, send = np.nonzero(adj[b])
        gs.append(dict(node_feats=node_feats[b], senders=send,
                       receivers=recv))
    return batch_graphs(gs, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad)


def sort_by_receiver(graph: Graph) -> Graph:
    """The graph with its edges stably sorted by receiver and ``edge_ptr``
    rebuilt, on the graph's device.  Padded edges must point at the last
    node, which owns no real edge, so that they stay at the tail."""
    order = torch.argsort(graph.receivers, stable=True)
    receivers = graph.receivers[order]
    n = graph.n_node_pad
    edge_ptr = torch.empty(n + 1, dtype=torch.int32,
                           device=receivers.device)
    edge_ptr[0] = 0
    edge_ptr[1:] = torch.searchsorted(
        receivers, torch.arange(1, n + 1, device=receivers.device),
        side='left').to(torch.int32)
    edge_ptr[-1] = graph.n_edge_pad

    def take(x):
        return None if x is None else x[order]

    return dataclasses.replace(
        graph, senders=graph.senders[order], receivers=receivers,
        edge_mask=graph.edge_mask[order], edge_feats=take(graph.edge_feats),
        snorm_e=take(graph.snorm_e), edge_ptr=edge_ptr)
