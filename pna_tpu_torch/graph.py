"""Padded edge-list graphs of torch tensors, with the CSR, ELL and
degree-bucketed layouts.

Counterpart of ``pna_tpu/graph.py``.  A batch of graphs is one padded edge
list with the same conventions as the JAX package:

* an edge ``k`` carries a message from ``senders[k]`` to ``receivers[k]``;
* padded edges have ``senders == receivers == n_node_pad - 1`` and
  ``edge_mask == False``; padded nodes sit at the tail with
  ``node_mask == False`` and belong to the last (padded) graph.

Three layouts ride on the edge list, each built on the host by
``batch_graphs``:

* CSR (``sort_edges=True``, the default): edges sorted by receiver (stable),
  so node ``n`` owns ``[edge_ptr[n], edge_ptr[n+1])`` and ``edge_ptr[-1] ==
  n_edge_pad``, the layout the port's kernels walk;
* ELL (``with_ell=True``): for each node the ids of its in-edges, in edge
  order, padded to the largest in-degree rounded up to a multiple of 4
  (``nbr_edge_ids``, ``nbr_mask``); none when that degree exceeds
  ``ell_max_degree``;
* degree-bucketed (``bucket_by_degree=True``): nodes grouped by in-degree
  class and edges laid out so each class (d, c) of ``bucket_spec`` is a
  dense [c, d] block, node k's d in-edges contiguous; dummy slots carry
  masked self-loops and ``in_deg`` holds each node's true in-degree.  Such a
  batch is not sorted by receiver globally and has no ``edge_ptr``.

The port keeps ``with_ell=False`` as its default, where the JAX package
builds ELL unless told not to.  ``sort_by_receiver`` restores the CSR order
(and ``edge_ptr``) after a caller has permuted the edges.  Collation runs on
the host in numpy and returns CPU tensors; ``Graph.to(device)`` moves a
batch to the card once, before the steps that use it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
    # ELL layout: each node's in-edge ids, padded (None when not built)
    nbr_edge_ids: Optional[torch.Tensor] = None  # [N_pad, D] int64
    nbr_mask: Optional[torch.Tensor] = None      # [N_pad, D] bool
    # degree-bucketed layout: ((degree, capacity), ...), host metadata
    bucket_spec: Optional[Tuple[Tuple[int, int], ...]] = None
    # true in-degree per node of a bucketed batch (dummy slots 0)
    in_deg: Optional[torch.Tensor] = None        # [N_pad] float32

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
    w = mask.to(dtype)
    return w.new_zeros(n).index_add_(0, ids, w)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _choose_classes(counts: Dict[int, int], max_buckets: int
                    ) -> Dict[int, int]:
    """Map each distinct in-degree > 0 to a class width >= it, using at most
    ``max_buckets`` classes, minimising the dummy edge slots (sum over nodes
    of class(d) - d): a DP over contiguous groups of the sorted degrees,
    whose ties go to the first minimum, as the JAX package's."""
    degs = sorted(d for d in counts if d > 0)
    if not degs or len(degs) <= max_buckets:
        return {d: d for d in degs}
    m = len(degs)
    cnts = [counts[d] for d in degs]
    INF = float('inf')
    # cost of grouping degs[i..j] into one class of width degs[j]
    cost = [[0] * m for _ in range(m)]
    for i in range(m):
        for j in range(i, m):
            cost[i][j] = sum(cnts[k] * (degs[j] - degs[k])
                             for k in range(i, j + 1))
    best = [[INF] * (max_buckets + 1) for _ in range(m + 1)]
    arg = [[-1] * (max_buckets + 1) for _ in range(m + 1)]
    best[0][0] = 0
    for j in range(1, m + 1):
        for k in range(1, max_buckets + 1):
            for i in range(j):
                c = best[i][k - 1] + cost[i][j - 1]
                if c < best[j][k]:
                    best[j][k] = c
                    arg[j][k] = i
    k = min(range(1, max_buckets + 1), key=lambda kk: best[m][kk])
    mapping = {}
    j = m
    while j > 0:
        i = arg[j][k]
        for t in range(i, j):
            mapping[degs[t]] = degs[j - 1]
        j, k = i, k - 1
    return mapping


def _bucketize(node_feats, senders, receivers, node_graph_ids, node_mask,
               edge_mask, edge_feats, snorm_n, snorm_e, n_graph_pad,
               bucket_caps=None, max_buckets=4):
    """Reorder a padded batch into the degree-bucketed layout.

    Real nodes are grouped by in-degree class, in their original order
    within a class; class d holds ``cap_d`` node slots (a multiple of 8),
    real nodes first, and owns the edge range of ``cap_d * d`` slots in which
    node k's in-edges sit contiguous, in edge order, at ``edge_off_d + (k -
    node_off_d) * d``.  Dummy slots carry masked self-loops.  The classes
    come from ``_choose_classes`` (at most ``max_buckets``, plus class 0,
    which also takes the padding nodes) or, with ``bucket_caps``, from its
    keys: each degree goes to the narrowest class at least as wide, and a
    class holding more nodes than its cap raises ``ValueError``.  Returns the
    new arrays, the ``bucket_spec`` ((degree, capacity), ...) and the true
    in-degree per node."""
    N = len(node_mask)
    deg = np.bincount(receivers[edge_mask], minlength=N).astype(np.int64)
    deg[~node_mask] = 0
    real = np.nonzero(node_mask)[0]
    u, c = np.unique(deg[real], return_counts=True)
    counts = dict(zip(u.tolist(), c.tolist()))
    if bucket_caps is None:
        cls_of = _choose_classes(counts, max_buckets)
        cls_of[0] = 0
        caps = {}
        for d, c in counts.items():
            caps[cls_of[d]] = caps.get(cls_of[d], 0) + c
        caps[0] = caps.get(0, 0) + max(int((~node_mask).sum()), 1)
    else:
        caps = {int(d): int(c) for d, c in dict(bucket_caps).items()}
        cls_of = {}
        for d in list(counts) + [0]:
            D = min((D for D in caps if D >= d), default=None)
            if D is None:
                raise ValueError(f"no bucket class >= degree {d} in caps")
            cls_of[d] = D
        ccounts = {}
        for d, c in counts.items():
            ccounts[cls_of[d]] = ccounts.get(cls_of[d], 0) + c
        for D, c in ccounts.items():
            if caps.get(D, 0) < c:
                raise ValueError(
                    f"bucket_caps[{D}]={caps.get(D, 0)} < {c} nodes in batch")
    caps = {d: _round_up(c, 8) for d, c in caps.items()}
    spec = tuple(sorted((int(d), int(c)) for d, c in caps.items()))
    max_d = max(d for d, _ in spec)
    cls_arr = np.zeros(max(max_d, int(deg.max()) if N else 0) + 1, np.int64)
    for d, D in cls_of.items():
        cls_arr[d] = D
    node_off = np.full(max_d + 1, -1, np.int64)
    edge_off = np.full(max_d + 1, -1, np.int64)
    n_off = e_off = 0
    for d, c in spec:
        node_off[d], edge_off[d] = n_off, e_off
        n_off += c
        e_off += c * d
    N_new, E_new = n_off, max(e_off, 1)

    new_of_old = np.full(N, -1, np.int64)
    real_cls = cls_arr[deg[real]]
    for d, _ in spec:
        sel = real[real_cls == d]
        new_of_old[sel] = node_off[d] + np.arange(len(sel))

    nf = np.zeros((N_new,) + node_feats.shape[1:], node_feats.dtype)
    ngi = np.full(N_new, n_graph_pad - 1, np.int64)
    nm = np.zeros(N_new, bool)
    in_deg = np.zeros(N_new, np.float32)
    sn = np.ones((N_new, 1), np.float32) if snorm_n is not None else None
    dst = new_of_old[real]
    nf[dst] = node_feats[real]
    ngi[dst] = node_graph_ids[real]
    nm[dst] = True
    in_deg[dst] = deg[real]
    if sn is not None:
        sn[dst] = snorm_n[real]

    sends = np.zeros(E_new, np.int64)
    recvs = np.zeros(E_new, np.int64)
    em = np.zeros(E_new, bool)
    ef = (np.zeros((E_new,) + edge_feats.shape[1:], edge_feats.dtype)
          if edge_feats is not None else None)
    se = np.ones((E_new, 1), np.float32) if snorm_e is not None else None
    for d, c in spec:
        if d:
            ids = node_off[d] + np.repeat(np.arange(c), d)
            sends[edge_off[d]:edge_off[d] + c * d] = ids
            recvs[edge_off[d]:edge_off[d] + c * d] = ids

    reals_e = np.nonzero(edge_mask)[0]
    if len(reals_e):
        r_new = new_of_old[receivers[reals_e]]
        order = np.argsort(r_new, kind='stable')
        sorted_e = reals_e[order]
        sorted_r = r_new[order]
        sorted_D = cls_arr[deg[receivers[sorted_e]]]
        slot = (np.arange(len(sorted_e))
                - np.searchsorted(sorted_r, sorted_r, side='left'))
        pos = (edge_off[sorted_D] + (sorted_r - node_off[sorted_D]) * sorted_D
               + slot)
        sends[pos] = new_of_old[senders[sorted_e]]
        recvs[pos] = sorted_r
        em[pos] = True
        if ef is not None:
            ef[pos] = edge_feats[sorted_e]
        if se is not None:
            se[pos] = snorm_e[sorted_e]
    return nf, sends, recvs, ngi, nm, em, ef, sn, se, spec, in_deg


def build_ell(receivers: np.ndarray, edge_mask: np.ndarray, n_node_pad: int,
              degree_pad_multiple: int = 4,
              max_degree: Optional[int] = 256):
    """The ELL layout: (nbr_edge_ids [N, D] int64, nbr_mask [N, D] bool),
    each row the ids of the node's real in-edges in edge order, D the
    largest in-degree rounded up to ``degree_pad_multiple`` (at least that
    multiple); (None, None) when the largest in-degree exceeds
    ``max_degree``."""
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask, bool)
    deg = np.bincount(receivers[edge_mask], minlength=n_node_pad)
    dmax = int(deg.max()) if len(receivers) else 1
    if max_degree is not None and dmax > max_degree:
        return None, None
    dmax = max(_round_up(max(dmax, 1), degree_pad_multiple),
               degree_pad_multiple)
    nbr = np.zeros((n_node_pad, dmax), np.int64)
    mask = np.zeros((n_node_pad, dmax), bool)
    e = np.nonzero(edge_mask)[0]
    r = receivers[e]
    order = np.argsort(r, kind='stable')
    e, r = e[order], r[order]
    slot = np.arange(len(r)) - np.searchsorted(r, r, side='left')
    nbr[r, slot] = e
    mask[r, slot] = True
    return nbr, mask


def batch_graphs(
    graphs: Sequence[dict],
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    n_graph_pad: Optional[int] = None,
    node_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
    with_snorm: bool = False,
    with_ell: bool = False,
    ell_max_degree: Optional[int] = 256,
    sort_edges: bool = True,
    bucket_by_degree: bool = False,
    bucket_caps: Optional[dict] = None,
    bucket_max_buckets: int = 4,
) -> Graph:
    """Static-shape batcher (``pna_tpu.graph.batch_graphs``, whose
    ``with_ell`` defaults to True where this one's defaults to False).

    Each element of ``graphs`` is a dict with ``node_feats`` [n, F],
    ``senders`` [e], ``receivers`` [e] and optionally ``edge_feats`` [e, Fe].
    Node indices are offset per graph; one extra padded graph owns all padded
    nodes; padded edges self-loop on the last padded node.  The layouts are
    those of the module docstring: ``bucket_by_degree`` reorders nodes and
    edges (``bucket_caps``, ``bucket_max_buckets``: see ``_bucketize``),
    ignores the pad sizes of nodes and edges and turns ``sort_edges`` off;
    ``with_ell`` builds the ELL table of the final edge order.
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

    bucket_spec = in_deg = None
    if bucket_by_degree:
        (node_feats, senders, receivers, node_graph_ids, node_mask,
         edge_mask, edge_feats, snorm_n, snorm_e, bucket_spec,
         in_deg) = _bucketize(
            node_feats, senders, receivers, node_graph_ids, node_mask,
            edge_mask, edge_feats, snorm_n, snorm_e, n_graph_pad,
            bucket_caps=bucket_caps, max_buckets=bucket_max_buckets)
        n_node_pad, n_edge_pad = node_feats.shape[0], senders.shape[0]
        sort_edges = False       # bucket order, not global receiver order

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
    nbr_edge_ids = nbr_mask = None
    if with_ell:
        nbr_edge_ids, nbr_mask = build_ell(receivers, edge_mask, n_node_pad,
                                           max_degree=ell_max_degree)

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
        nbr_edge_ids=t(nbr_edge_ids),
        nbr_mask=t(nbr_mask),
        bucket_spec=bucket_spec,
        in_deg=t(in_deg),
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
    node, which owns no real edge, so that they stay at the tail.  The ELL
    table and the bucket spec index edge positions, which the sort moves, so
    the result carries neither."""
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
        snorm_e=take(graph.snorm_e), edge_ptr=edge_ptr, nbr_edge_ids=None,
        nbr_mask=None, bucket_spec=None)
