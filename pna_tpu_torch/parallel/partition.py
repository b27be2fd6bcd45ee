"""Graph parallelism: the edge partition and the halo exchange.

Counterpart of ``pna_tpu/parallel/partition.py``.  A large graph is cut into
contiguous node ranges, one per rank of the ``graph`` mesh axis; each rank
owns its nodes and all their in-edges.  Sender features that live on other
ranks (the halo) arrive by one ``all_to_all`` per layer, and aggregation is
then local.  All indexing is built on the host, in numpy, as static-shape
tables stacked over the parts ([P, ...]); every rank builds them all and
keeps its own row (``multihost.put_global``):

  send_buf = feats[send_idx]              # owned features for each peer
  recv_buf = all_to_all(send_buf)         # the halo exchange
  ghost    = cat([feats, recv_buf])       # local and received senders
  msg      = ghost[senders_local]         # the edge gather
  out      = aggregate(msg, receivers_local)

Every table equals the JAX package's, element for element
(``tests/test_torch_partition.py``).  The host preprocessing runs in the
C++ library of ``pna_tpu_torch/native`` where it is built, else in the
numpy twins here.

Within a part, edges whose sender is local come first; ``split_edges``
separates the two kinds, so that the local partial aggregation can run while
the exchange is in flight (the layer's ``overlap`` path).
``sort_partition_edges`` sorts each part by receiver and adds ``edge_ptr``,
the layout of the CSR kernels (K1-K4), which keep a hub's in-edges on
one part whatever its degree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pna_tpu_torch import native
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.ops.segment import gather_rows
from pna_tpu_torch.parallel import collectives, multihost


@dataclass
class EdgePartition:
    """Host-built static-shape partition of one big graph over P parts.

    Arrays are stacked with a leading part axis [P, ...]; the rank at
    position p of the ``graph`` mesh axis keeps row p.
    """
    num_parts: int
    nodes_per_part: int          # Nl (padded)
    halo_size: int               # H (max nodes any peer pair exchanges)
    edges_per_part: int          # El (padded)
    num_nodes: int               # true number of nodes (pre-padding)

    senders_local: np.ndarray    # [P, El] int32 — index into ghost table
    receivers_local: np.ndarray  # [P, El] int32 — local node index
    edge_mask: np.ndarray        # [P, El] bool
    send_idx: np.ndarray         # [P, P, H] int32 — local ids to send to peer
    send_mask: np.ndarray        # [P, P, H] bool
    node_mask: np.ndarray        # [P, Nl] bool — real (non-padding) nodes
    # locality reordering (reorder='locality'): node_order[i] = ORIGINAL node id
    # living at partitioned position i.  Feed features as feats[node_order]
    # (see scatter_features); None = identity (no reordering).
    node_order: Optional[np.ndarray] = None
    # ORIGINAL edge index living at each local slot (-1 = padding).
    # Lets per-edge data (edge features live with their edge: no exchange)
    # follow the edges through partitioning and sorting:
    # ``scatter_edge_features``.
    edge_origin: Optional[np.ndarray] = None    # [P, El] int64
    # CSR row pointers over the RECEIVER-SORTED local edge list
    # (:func:`sort_partition_edges`): part p's node n owns local edges
    # [edge_ptr[p, n], edge_ptr[p, n+1]): the layout of the CSR kernels
    # (``kernel='csr'``/``'csr_fused'``) inside the distributed step.
    edge_ptr: Optional[np.ndarray] = None       # [P, Nl + 1] int32

    def _positions(self) -> np.ndarray:
        """pos[i] = partitioned position of ORIGINAL node i."""
        n = self.num_nodes
        inv = np.empty(n, dtype=np.int64)
        if self.node_order is None:
            inv[:] = np.arange(n)
        else:
            inv[self.node_order] = np.arange(n)
        return inv

    def scatter_features(self, feats: np.ndarray) -> np.ndarray:
        """Global [num_nodes, F] features -> sharded [P, Nl, F] layout
        (applies the locality reordering and the per-part padding)."""
        n, f = feats.shape
        nl, p = self.nodes_per_part, self.num_parts
        out = np.zeros((p * nl, f), dtype=feats.dtype)
        out[self._positions()] = feats
        return out.reshape(p, nl, f)

    def gather_outputs(self, out: np.ndarray) -> np.ndarray:
        """Sharded [P, Nl, F] outputs -> global [num_nodes, F] in ORIGINAL
        node order (inverse of scatter_features)."""
        p, nl, f = out.shape
        return out.reshape(p * nl, f)[self._positions()]

    def scatter_edge_features(self, efeats: np.ndarray) -> np.ndarray:
        """Global [num_edges, Fe] per-edge data -> sharded [P, El, Fe]
        following the edges through the partition layout (zeros at
        padding slots)."""
        if self.edge_origin is None:
            raise ValueError("partition carries no edge_origin map")
        p, el = self.edge_origin.shape
        out = np.zeros((p, el, efeats.shape[1]), dtype=efeats.dtype)
        real = self.edge_origin >= 0
        out[real] = efeats[self.edge_origin[real]]
        return out


def _partition_indices_numpy(senders, receivers, nl, num_parts, n_nodes,
                             el, h):
    """Vectorized numpy twin of native/graph_ops.cpp:build_partition_indices.

    Same layout contract: edges grouped by receiver-owner part, local-sender
    edges first (original order within each group), ghost slots in
    first-encounter order, remote sender index = nl + q*h + slot."""
    P = num_parts
    owner_r = receivers // nl
    owner_s = senders // nl
    remote = owner_s != owner_r
    order = np.argsort(owner_r * 2 + remote, kind='stable')
    s_o, r_o = senders[order], receivers[order]
    p_o, q_o = owner_r[order], owner_s[order]
    rem_o = q_o != p_o
    counts = np.bincount(p_o, minlength=P)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(order)) - starts[p_o]

    senders_local = np.zeros((P, el), dtype=np.int32)
    receivers_local = np.zeros((P, el), dtype=np.int32)
    edge_mask = np.zeros((P, el), dtype=bool)
    receivers_local[p_o, pos] = (r_o - p_o * nl).astype(np.int32)
    edge_mask[p_o, pos] = True
    loc = ~rem_o
    senders_local[p_o[loc], pos[loc]] = (s_o[loc] - q_o[loc] * nl
                                         ).astype(np.int32)

    send_idx = np.zeros((P, P, h), dtype=np.int32)
    send_mask = np.zeros((P, P, h), dtype=bool)
    ridx = np.nonzero(rem_o)[0]
    if len(ridx):
        # unique (dst_part, sender) pairs in first-encounter order
        keys = p_o[ridx] * np.int64(n_nodes) + s_o[ridx]
        uniq, first, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
        up = (uniq // n_nodes).astype(np.int64)
        us = uniq % n_nodes
        uq = us // nl
        grp = uq * P + up
        o2 = np.lexsort((first, grp))
        grp_sorted = grp[o2]
        slot_sorted = (np.arange(len(o2))
                       - np.searchsorted(grp_sorted, grp_sorted, side='left'))
        slot = np.empty(len(o2), dtype=np.int64)
        slot[o2] = slot_sorted
        send_idx[uq, up, slot] = (us - uq * nl).astype(np.int32)
        send_mask[uq, up, slot] = True
        ghost = (nl + uq * h + slot).astype(np.int32)
        senders_local[p_o[ridx], pos[ridx]] = ghost[inv]
    return senders_local, receivers_local, edge_mask, send_idx, send_mask


def _edge_origin_numpy(senders, receivers, nl, num_parts, el):
    """ORIGINAL edge index per local slot — same placement rule as
    ``_partition_indices_numpy`` / the C++ builder (edges grouped by
    receiver-owner part, local-sender edges first, stable within groups)."""
    owner_r = receivers // nl
    owner_s = senders // nl
    remote = owner_s != owner_r
    order = np.argsort(owner_r * 2 + remote, kind='stable')
    p_o = owner_r[order]
    counts = np.bincount(p_o, minlength=num_parts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(order)) - starts[p_o]
    out = np.full((num_parts, el), -1, dtype=np.int64)
    out[p_o, pos] = order
    return out


def partition_edges(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int, num_parts: int,
                    edge_pad_multiple: int = 8,
                    halo_pad_multiple: int = 8,
                    reorder: Optional[str] = 'locality') -> EdgePartition:
    """Partition by contiguous node ranges; each edge lives on the part that
    owns its receiver.

    ``reorder='locality'`` (default) first relabels nodes with a
    receiver-grouping order (``native.locality_order``): each sender's
    receivers are laid out contiguously, rare senders first, so tail
    neighbourhoods land in one contiguous range and the halo shrinks.
    ``reorder=None`` keeps the raw order.  When reordering is
    active, feed features via ``part.scatter_features`` / read back via
    ``part.gather_outputs`` (or index with ``part.node_order``).

    O(E) end to end: sizes via the native ``partition_stats`` (C++), indices
    via the native ``build_partition_indices``; a vectorized numpy twin covers
    both when the toolchain is absent."""

    senders = np.ascontiguousarray(senders, dtype=np.int64)
    receivers = np.ascontiguousarray(receivers, dtype=np.int64)
    num_parts = int(num_parts)
    node_order = None
    if reorder == 'locality':
        node_order = native.locality_order(senders, receivers, num_nodes)
        inv = np.empty(num_nodes, dtype=np.int64)
        inv[node_order] = np.arange(num_nodes)
        senders = inv[senders]
        receivers = inv[receivers]
    elif reorder is not None:
        raise ValueError(f"unknown reorder mode {reorder!r}")
    nl = -(-num_nodes // num_parts)  # ceil

    edge_count, halo_count = native.partition_stats(
        senders, receivers, nl, num_parts, num_nodes)
    np.fill_diagonal(halo_count, 0)
    el = max(int(edge_count.max(initial=1)), 1)
    el = max(-(-el // edge_pad_multiple) * edge_pad_multiple, edge_pad_multiple)
    h = max(int(halo_count.max(initial=1)), 1)
    h = max(-(-h // halo_pad_multiple) * halo_pad_multiple, halo_pad_multiple)

    built = native.build_partition_indices(senders, receivers, nl, num_parts,
                                           num_nodes, el, h)
    if built is None:
        built = _partition_indices_numpy(senders, receivers, nl, num_parts,
                                         num_nodes, el, h)
    senders_local, receivers_local, edge_mask, send_idx, send_mask = built

    node_mask = np.zeros((num_parts, nl), dtype=bool)
    for p in range(num_parts):
        lo, hi = p * nl, min((p + 1) * nl, num_nodes)
        if hi > lo:
            node_mask[p, :hi - lo] = True

    edge_origin = _edge_origin_numpy(senders, receivers, nl, num_parts, el)

    return EdgePartition(
        num_parts=num_parts, nodes_per_part=nl, halo_size=h,
        edges_per_part=el, num_nodes=num_nodes,
        senders_local=senders_local, receivers_local=receivers_local,
        edge_mask=edge_mask, send_idx=send_idx, send_mask=send_mask,
        node_mask=node_mask, node_order=node_order,
        edge_origin=edge_origin)


def sort_partition_edges(part: EdgePartition) -> EdgePartition:
    """Receiver-sort each part's local edges and build per-part CSR
    ``edge_ptr``: the layout of the CSR kernels
    (``PNALayerFused(kernel='csr')`` and ``'csr_fused'``), which a hub's
    in-degree does not blow up.  Real edges come first (stable by local
    receiver), padding at the tail; ghost sender ids are preserved
    untouched.
    """
    Pn, nl, el = part.num_parts, part.nodes_per_part, part.edges_per_part
    senders_local = np.zeros_like(part.senders_local)
    receivers_local = np.zeros_like(part.receivers_local)
    edge_mask = np.zeros_like(part.edge_mask)
    edge_origin = (np.full((Pn, el), -1, np.int64)
                   if part.edge_origin is not None else None)
    edge_ptr = np.zeros((Pn, nl + 1), np.int32)
    for p in range(Pn):
        real = np.nonzero(part.edge_mask[p])[0]
        r = part.receivers_local[p][real]
        order = np.argsort(r, kind='stable')
        k = len(real)
        senders_local[p, :k] = part.senders_local[p][real[order]]
        receivers_local[p, :k] = r[order]
        edge_mask[p, :k] = True
        if edge_origin is not None:
            edge_origin[p, :k] = part.edge_origin[p][real[order]]
        edge_ptr[p] = np.searchsorted(r[order], np.arange(nl + 1),
                                      side='left').astype(np.int32)
    return EdgePartition(
        num_parts=Pn, nodes_per_part=nl, halo_size=part.halo_size,
        edges_per_part=el, num_nodes=part.num_nodes,
        senders_local=senders_local, receivers_local=receivers_local,
        edge_mask=edge_mask, send_idx=part.send_idx,
        send_mask=part.send_mask, node_mask=part.node_mask,
        node_order=part.node_order, edge_origin=edge_origin,
        edge_ptr=edge_ptr)


@dataclass
class SplitEdges:
    """Static-shape split of each part's edges into LOCAL-sender edges
    (sender owned by this part — aggregation independent of the halo
    exchange) and BOUNDARY edges (sender arrives in the halo buffer).

    With the split, the local partial aggregation does not depend on the
    ``all_to_all``, so it can run while the exchange is in flight (the
    ghost-table form cannot: its edge gather reads the received halo).
    """
    senders_local: np.ndarray     # [P, Kl] int32 — local node ids
    receivers_local: np.ndarray   # [P, Kl] int32
    mask_local: np.ndarray        # [P, Kl] bool
    senders_bound: np.ndarray     # [P, Kb] int32 — ids into the halo buffer
    receivers_bound: np.ndarray   # [P, Kb] int32
    mask_bound: np.ndarray        # [P, Kb] bool
    # original local edge SLOT per split position (0 at padding) — lets
    # per-edge data (edge features) follow its edge into the local/boundary
    # split: e_local = e[idx_local], e_bound = e[idx_bound]
    idx_local: np.ndarray = None  # [P, Kl] int32
    idx_bound: np.ndarray = None  # [P, Kb] int32


def split_edges(part: EdgePartition, pad_multiple: int = 8) -> SplitEdges:
    """Split a partition's edges by sender locality."""
    Pn, nl = part.num_parts, part.nodes_per_part
    loc_idx, bnd_idx = [], []
    for p in range(Pn):
        em = part.edge_mask[p]
        s = part.senders_local[p]
        loc_idx.append(np.nonzero(em & (s < nl))[0])
        bnd_idx.append(np.nonzero(em & (s >= nl))[0])
    kl = max(max((len(i) for i in loc_idx), default=0), 1)
    kb = max(max((len(i) for i in bnd_idx), default=0), 1)
    kl = -(-kl // pad_multiple) * pad_multiple
    kb = -(-kb // pad_multiple) * pad_multiple
    sl = np.zeros((Pn, kl), np.int32)
    rl = np.zeros((Pn, kl), np.int32)
    ml = np.zeros((Pn, kl), bool)
    sb = np.zeros((Pn, kb), np.int32)
    rb = np.zeros((Pn, kb), np.int32)
    mb = np.zeros((Pn, kb), bool)
    il = np.zeros((Pn, kl), np.int32)
    ib = np.zeros((Pn, kb), np.int32)
    for p in range(Pn):
        li, bi = loc_idx[p], bnd_idx[p]
        sl[p, :len(li)] = part.senders_local[p][li]
        rl[p, :len(li)] = part.receivers_local[p][li]
        ml[p, :len(li)] = True
        il[p, :len(li)] = li
        sb[p, :len(bi)] = part.senders_local[p][bi] - nl
        rb[p, :len(bi)] = part.receivers_local[p][bi]
        mb[p, :len(bi)] = True
        ib[p, :len(bi)] = bi
    return SplitEdges(senders_local=sl, receivers_local=rl, mask_local=ml,
                      senders_bound=sb, receivers_bound=rb, mask_bound=mb,
                      idx_local=il, idx_bound=ib)


def halo_exchange(feats_local: torch.Tensor, send_idx: torch.Tensor,
                  send_mask: torch.Tensor, group=None,
                  wait: bool = True):
    """Ship this rank's owned features to every peer and receive its halo.

    feats_local [Nl, F]; send_idx/send_mask [P, H] (this rank's row).
    Returns the received block [P*H, F] (row q*H + k is the k-th node from
    part q), or, with ``wait=False``, the exchange in flight
    (``collectives.PendingExchange``; its ``wait()`` gives the block)."""
    # a row gather: its backward is the deterministic row sum on the card
    send = gather_rows(feats_local, send_idx.reshape(-1))
    send = send * send_mask.reshape(-1, 1).to(send.dtype)
    if wait:
        return collectives.all_to_all(send, group)
    return collectives.all_to_all_async(send, group)


def make_distributed_aggregate(part: EdgePartition, rank: int, group=None,
                               aggregators: Sequence[str] = ('mean', 'max',
                                                             'min', 'std'),
                               scalers: Sequence[str] = ('identity',
                                                         'amplification',
                                                         'attenuation'),
                               avg_d: Optional[dict] = None,
                               device=None):
    """This rank's aggregation over the partition: node features [Nl, F]
    of part ``rank`` -> aggregated [Nl, S*A*F], the distributed counterpart
    of ``nn.sparse.aggregate_bank`` (``group`` is the graph axis' group),
    on ``device`` (default: this rank's card)."""
    from pna_tpu_torch.nn.sparse import aggregate_bank
    avg_d = avg_d or {'lin': 1.0, 'log': 1.0, 'exp': 1.0}
    dev = multihost.rank_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x[rank]),
                               dtype=dtype).to(dev)

    nl = part.nodes_per_part
    g = Graph(node_feats=torch.zeros((nl, 0), device=dev),
              senders=t(part.senders_local, torch.int64),
              receivers=t(part.receivers_local, torch.int64),
              node_graph_ids=torch.zeros(nl, dtype=torch.int64, device=dev),
              node_mask=t(part.node_mask), edge_mask=t(part.edge_mask),
              graph_mask=torch.ones(1, dtype=torch.bool, device=dev))
    send_idx, send_mask = t(part.send_idx), t(part.send_mask)

    def aggregate(feats: torch.Tensor) -> torch.Tensor:
        halo = halo_exchange(feats, send_idx, send_mask, group)
        msg = torch.cat([feats, halo])[g.senders]
        return aggregate_bank(g, msg, list(aggregators), list(scalers),
                              avg_d)

    return aggregate


def powerlaw_graph(num_nodes: int, num_edges: int, seed: int = 0,
                   exponent: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic power-law (Zipf-ish) directed graph for the scaling benchmark
    and the large-graph trainer: weights ~ rank^-exponent over a permuted
    node order pick the senders, receivers are uniform."""
    rng = np.random.RandomState(seed)
    # preferential weights ~ rank^-exponent over a permuted node order
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    w = ranks ** -exponent
    w /= w.sum()
    perm = rng.permutation(num_nodes)
    senders = perm[rng.choice(num_nodes, size=num_edges, p=w)]
    receivers = rng.randint(0, num_nodes, size=num_edges)
    return senders.astype(np.int64), receivers.astype(np.int64)
