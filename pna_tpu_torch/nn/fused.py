"""Fused-towers PNA layer on four aggregation backends.

Counterpart of ``pna_tpu/nn/fused.py::PNALayerFused``.  The backends
(``kernel=``):

* ``'csr'``, the JAX ``'pallas'``: the receiver-sorted moment-sketch bank
  (``ops/csr_bank.py``, kernels K1/K2) over messages built from node halves
  by one kernel (``csr_bank.csr_messages``);
* ``'csr_fused'``, the JAX ``'pallas_fused'``: pretrans and sketch in the
  kernels (``ops/csr_fused.py``, K3/K4);
* ``'generic'``: the aggregator x scaler bank of ``nn/sparse.py::
  aggregate_bank`` (the segment form, with K1/K2 for its aggregators on the
  card), the only one that takes ``identity`` and the aggregators the CSR
  bank lacks;
* ``'auto'``: ``resolve_backend`` picks ``csr`` where it runs, else
  ``generic``.

The JAX layer's ``'bucketed'`` and ``'ell'`` backends, built so that a TPU
avoids scatters, are not ported: on the H100 the ``csr`` step beat or tied
them at every size read (PERF.md), and ``kernel='bucketed'`` or ``'ell'``
raises ``ValueError``.  ``'csr'`` and ``'csr_fused'`` need ``edge_ptr`` and
raise ``ValueError`` without it.

The math is the JAX layer's:

* stacked tower parameters ``kernel_i [T, in_i, out_i]``, ``bias_i
  [T, out_i]`` for each of the ``pretrans_layers`` and ``posttrans_layers``
  (relu between layers: on the messages after the first pretrans layer,
  after the scaler contraction in the posttrans);
* a split-kernel pretrans: ``msg = src K_src + dst K_dst (+ e K_e) + b``, the
  concat never built; per-tower contractions are one matmul with a
  block-diagonal weight (``ops/posttrans.py::tower_ein``), or one matmul
  when every tower shares its input (``shared_ein``,
  ``divide_input=False``).  On ``csr`` and
  ``csr_fused`` only the node halves ``u = h K_src`` and ``v = h K_dst + b``
  are formed (the first layer is linear, so ``h[snd] K_src + h[rcv] K_dst +
  b == u[snd] + v[rcv]``), with the edge-feature term ``e K_e`` per edge: on
  ``csr`` a kernel builds the [E, F] messages from them, on ``csr_fused``
  K3/K4 build each message on chip; ``generic`` gathers the rows and
  multiplies them by edge;
* a first posttrans layer that applies the S scaler weights after the
  aggregator tensor Z [N, A, T*Ft] meets each tower's weight
  (``ops/posttrans.py::scaled_posttrans``: on the card one hand-written
  kernel a direction, which contracts the scalers in registers; elsewhere
  the plain version, one matmul with the scaler axis folded into its
  output); the generic path contracts its materialised [N, S*A*T*Ft] bank;
* graph-norm, masked batch-norm, dropout, the ``mixing`` linear,
  leaky_relu(0.01), and the residual when ``in_dim == out_dim``.

The forward is three spans (``utils/profiling.py::span``), timed on the
device while the profiler runs: ``pna.message`` (the gathers and the
pretrans, or the node halves: on ``csr`` with the message kernel and the
later pretrans layers), ``pna.aggregate`` (the bank)
and ``pna.update`` (posttrans with the scalers, norms, mixing, residual);
the overlap path enters the first two once for its local and once for its
boundary edges.

``compute_dtype=torch.bfloat16`` rounds at the JAX layer's places: the layer
input, every matmul operand (the products are then taken and summed in
float32, the JAX ``preferred_element_type=float32``: the operands are widened
to float32, which is exact, and the matmul runs in float32), the message
before the csr bank (which widens it to float32), the
``csr_fused`` inputs u, v, ef and ke, and the scaler contraction's operands.
Statistics, batch-norm, mixing and the residual stay float32.

``csr_fused`` forms only the first pretrans layer inside its kernels, so it
takes ``pretrans_layers=1`` only and raises ``ValueError`` otherwise, as the
JAX fused backend does.  Dropout draws its mask from ``dropout_generator``
(``nn/layers.py::Dropout``).

The distributed path (``parallel/distributed_net.py``):

* ``sender_table`` [Nl + P*H, F], the ghost table (local rows, then the
  halo), is what ``graph.senders`` indexes: the edge gather reads it, and on
  ``csr`` and ``csr_fused`` the sender half ``u`` is computed from it, so
  that the message kernel or K3/K4 take a ``u`` with more rows than ``v``
  and the gradient of the ghost rows travels back through the exchange;
* ``overlap`` splits the edges into local and boundary ones
  (``parallel/partition.py::split_edges``) and aggregates each into a
  moment sketch (``ops/partial_stats.py``), the local one while the halo
  exchange is in flight: its first item may be the exchange's
  ``PendingExchange``, waited for before the boundary partial;
* ``bn_group`` is the process group of the batch-norm statistics;
* ``tp_group`` (the JAX ``tp_axis``; ``parallel/tower_tp.py``): this rank
  holds and computes ``towers / tp`` of the towers, end to end, and the
  tower outputs are gathered once, before the batch norm and the mixing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph
from pna_tpu_torch.nn.layers import (Dropout, dense, xavier_uniform_gain,
                                     zeros_init)
from pna_tpu_torch.nn.sparse import (MaskedBatchNorm, aggregate_bank,
                                     bank_layout, check_bank)
from pna_tpu_torch.ops import csr_bank, csr_fused, partial_stats
from pna_tpu_torch.ops import scalers as scaler_ops
from pna_tpu_torch.ops.posttrans import (round_to, scaled_posttrans,
                                         shared_ein, tower_ein)
from pna_tpu_torch.ops.segment import gather_rows
from pna_tpu_torch.parallel import tower_tp
from pna_tpu_torch.utils.profiling import span

KERNELS = ('auto', 'csr', 'csr_fused', 'generic')
_RENAMED = {'pallas': 'csr', 'pallas_fused': 'csr_fused'}


def check_backend(kernel: str, compute_dtype=None) -> None:
    """Raise for a backend or option the port does not run."""
    if kernel in _RENAMED:
        raise ValueError(f"the port names the JAX {kernel!r} backend "
                         f"{_RENAMED[kernel]!r}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype={compute_dtype} is not "
                                  "ported: float32 and bfloat16 are, the "
                                  "two dtypes bench.py and its twin time; "
                                  "neither they nor any CLI runs another")


def resolve_backend(kernel: str, graph: Graph, aggregators: Sequence[str],
                    device) -> str:
    """The backend a layer runs on this batch: 'csr', 'csr_fused' or
    'generic'.

    * 'csr' or 'csr_fused' when forced; on a batch without ``edge_ptr``, or
      with aggregators their banks do not cover, they raise ``ValueError``;
    * under 'auto', 'csr' on a ``cuda`` device when the batch has
      ``edge_ptr`` and the CSR bank covers the aggregators (the
      JAX package takes its kernel under 'auto' only on a TPU: on the CPU
      'auto' resolves as it does there);
    * else 'generic'."""
    csr_ok = graph.edge_ptr is not None and csr_bank.supports(aggregators)
    if kernel in ('csr', 'csr_fused'):
        if graph.edge_ptr is None:
            raise ValueError(f"kernel={kernel!r} requires graph.edge_ptr "
                             "(batch_graphs(sort_edges=True))")
        if not csr_ok:
            raise ValueError(f"kernel={kernel!r} requires supported "
                             f"aggregators, got {aggregators}")
        return kernel
    if kernel == 'auto' and csr_ok and torch.device(device).type == 'cuda':
        return 'csr'
    return 'generic'


def backend_layout(backend: str, graph: Graph, max_degree: int = 0
                   ) -> Optional[csr_bank.CSRLayout]:
    """The CSR layout ``backend`` takes on this batch: the row pointers for
    'csr' and 'csr_fused', the sparse bank's (``bank_layout``) for
    'generic'."""
    if backend in ('csr', 'csr_fused'):
        return csr_bank.layout_from_graph(graph, max_degree)
    return bank_layout(graph, max_degree)


def _phase(name: str, device):
    """The span of one phase of a layer's forward (``pna.message``,
    ``pna.aggregate``, ``pna.update``); none inside the autograd engine,
    where a checkpointed layer (``remat``) replays its forward: that replay
    is the backward's time."""
    if torch._C._current_graph_task_id() != -1:
        return contextlib.nullcontext()
    return span(name, device)


def _mlp_dims(in_size, hidden, out, layers):
    return ([in_size] + [hidden] * (layers - 1) + [out] if layers > 1
            else [in_size, out])


class StackedParams(nn.Module):
    """Per-tower dense layers, stacked: kernel_i [T, dims[i], dims[i+1]],
    bias_i [T, dims[i+1]] (xavier-uniform at gain 1/dims[i], zero bias)."""

    def __init__(self, dims, towers: int, generator: torch.Generator):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f'kernel_{i}', nn.Parameter(
                xavier_uniform_gain(1.0 / dims[i])(
                    (towers, dims[i], dims[i + 1]), generator)))
            setattr(self, f'bias_{i}', nn.Parameter(
                zeros_init((towers, dims[i + 1]), generator)))

    def layer(self, i):
        return getattr(self, f'kernel_{i}'), getattr(self, f'bias_{i}')

    def rest(self, x, cdt):
        """Layers 1.. on x [..., T, F]: relu, then the next tower dense."""
        for i in range(1, self.n):
            k, b = self.layer(i)
            x = tower_ein(torch.relu(x), k, cdt) + b
        return x


class PNALayerFused(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], *,
                 graph_norm: bool = False, batch_norm: bool = False,
                 towers: int = 1, divide_input: bool = True,
                 residual: bool = False, edge_features: bool = False,
                 edge_dim: int = 0, dropout: float = 0.0,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 kernel: str = 'csr', max_degree: int = 0,
                 compute_dtype=None, bn_group=None, tp_group=None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_backend(kernel, compute_dtype)
        if kernel == 'csr_fused' and pretrans_layers != 1:
            raise ValueError("kernel='csr_fused' supports pretrans_layers=1 "
                             "only: its kernels form the first pretrans "
                             "layer's message")
        if kernel in ('csr', 'csr_fused') and not csr_bank.supports(
                aggregators):
            raise ValueError(f"kernel={kernel!r} supports aggregators "
                             f"{csr_bank.AGGS} (no 'identity'), got "
                             f"{aggregators}")
        check_bank(aggregators, scalers)
        if divide_input and in_dim % towers:
            raise ValueError(f"in_dim {in_dim} not divisible by {towers}")
        if out_dim % towers:
            raise ValueError(f"out_dim {out_dim} not divisible by {towers}")
        tp, tp_rank = tower_tp.group_shape(tp_group)
        if towers % tp:
            raise ValueError(f"{towers} towers do not split over {tp} "
                             "ranks")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_dim, self.out_dim, self.towers = in_dim, out_dim, towers
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d = dict(avg_d)
        self.graph_norm, self.batch_norm = graph_norm, batch_norm
        self.divide_input, self.edge_features = divide_input, edge_features
        self.residual = residual and in_dim == out_dim
        self.kernel, self.max_degree = kernel, max_degree
        self.compute_dtype = compute_dtype or torch.float32
        self.ft = in_dim // towers if divide_input else in_dim
        self.fo = out_dim // towers
        self.tp_group, self.tp_rank = tp_group, tp_rank
        self.local_towers = towers // tp
        fe = edge_dim if edge_features else 0
        A, S = len(self.aggregators), len(self.scalers)
        # the full stack of towers is drawn, so that every tp draws the same
        # weights; a rank keeps its own towers
        pretrans = StackedParams(
            _mlp_dims(2 * self.ft + fe, self.ft, self.ft, pretrans_layers),
            towers, generator)
        posttrans = StackedParams(
            _mlp_dims((A * S + 1) * self.ft, self.fo, self.fo,
                      posttrans_layers), towers, generator)
        if tp > 1:
            tower_tp.keep_towers(pretrans, tp_rank, self.local_towers)
            tower_tp.keep_towers(posttrans, tp_rank, self.local_towers)
        self.pretrans, self.posttrans = pretrans, posttrans
        if batch_norm:
            self.batchnorm_h = MaskedBatchNorm(towers * self.fo,
                                               group=bn_group)
        self.dropout = Dropout(dropout, dropout_generator)
        self.mixing = dense(towers * self.fo, out_dim,
                            xavier_uniform_gain(1.0 / out_dim), zeros_init,
                            generator)
        self.to(device)

    def forward(self, graph: Graph, h: torch.Tensor,
                e: Optional[torch.Tensor] = None,
                layout: Optional[csr_bank.CSRLayout] = None,
                sender_table: Optional[torch.Tensor] = None,
                overlap=None) -> torch.Tensor:
        """h [N, in_dim], e [E, edge_dim] (edge features) -> [N, out_dim].
        ``layout`` is the batch's CSR layout, shared by every layer; built
        here when not given and the backend takes it (``csr``,
        ``csr_fused``, and ``generic`` on a batch with ``edge_ptr``).

        ``sender_table`` [Nl + P*H, in_dim]: the ghost table that
        ``graph.senders`` indexes (None: ``h`` itself).  ``overlap``: the
        tuple ``(halo, senders_l, receivers_l, mask_l, senders_b,
        receivers_b, mask_b[, e_l, e_b])`` of the split edges
        (``parallel/partition.py::split_edges``; the boundary senders index
        ``halo``, which may be a ``PendingExchange``; ``e_l``/``e_b`` are the
        edge features split alike)."""
        T, Ft, Fo = self.local_towers, self.ft, self.fo
        A, S = len(self.aggregators), len(self.scalers)
        N, E = h.shape[0], graph.n_edge_pad
        cdt = self.compute_dtype
        if sender_table is not None and sender_table.shape[1] != h.shape[1]:
            raise ValueError(f"sender_table width {sender_table.shape[1]} "
                             f"!= h width {h.shape[1]}")
        if overlap is not None:
            n_want = 9 if self.edge_features else 7
            if len(overlap) != n_want:
                raise ValueError(f"overlap takes {n_want} items here (the "
                                 "split edges' tables, and with edge "
                                 "features their split features), got "
                                 f"{len(overlap)}")
            if not partial_stats.supports(self.aggregators):
                raise ValueError("the overlap path needs sketch-decomposable "
                                 f"aggregators, got {self.aggregators}")
            backend = 'overlap'
        else:
            backend = resolve_backend(self.kernel, graph, self.aggregators,
                                      h.device)
        if layout is None and backend != 'overlap':
            layout = backend_layout(backend, graph, self.max_degree)
        hb = self._tower_input(h.to(cdt))             # this rank's towers

        # ---- pretrans: split-kernel first layer, no concat built ----
        k0, b0 = self.pretrans.layer(0)
        k_src, k_dst = k0[:, :Ft], k0[:, Ft:2 * Ft]

        def pretrans_nodes(x):
            """x K_src + x K_dst + b0 (and the later layers) per node, the
            message a node sends itself ('identity')."""
            if self.divide_input:
                xs = x.reshape(N, T, Ft)
                m = tower_ein(xs, k_src, cdt) + tower_ein(xs, k_dst, cdt)
            else:
                m = shared_ein(x, k_src, cdt) + shared_ein(x, k_dst, cdt)
            return self.pretrans.rest(m + b0, cdt)

        def node_halves():
            """The first pretrans layer's node halves, float32: u = x K_src
            [Nu, T*Ft] over the rows the senders index, v = h K_dst + b0
            [N, T*Ft]; an edge's message is u[snd] + v[rcv] (+ e K_e)."""
            if self.divide_input:
                u = tower_ein(src_rows.reshape(-1, T, Ft), k_src, cdt)
                v = tower_ein(hb.reshape(N, T, Ft), k_dst, cdt)
            else:
                u = shared_ein(src_rows, k_src, cdt)
                v = shared_ein(hb, k_dst, cdt)
            return u.reshape(-1, T * Ft), (v + b0).reshape(N, T * Ft)

        def pretrans_edges(src, dst, eterm):
            """The messages src K_src + dst K_dst (+ e K_e) + b0 and the
            later layers: [K, T, Ft] float32."""
            K = src.shape[0]
            if self.divide_input:
                msg = (tower_ein(src.reshape(K, T, Ft), k_src, cdt)
                       + tower_ein(dst.reshape(K, T, Ft), k_dst, cdt))
            else:
                msg = (shared_ein(src, k_src, cdt)
                       + shared_ein(dst, k_dst, cdt))
            if eterm is not None:
                msg = msg + shared_ein(eterm, k0[:, 2 * Ft:], cdt)
            return self.pretrans.rest(msg + b0, cdt)

        src_rows = (hb if sender_table is None
                    else self._tower_input(sender_table.to(cdt)))
        dev = h.device
        Z = agg = None
        if backend == 'overlap':
            # local partial while the exchange is in flight, then boundary
            halo, s_l, r_l, m_l, s_b, r_b, m_b = overlap[:7]
            e_l, e_b = overlap[7:] if self.edge_features else (None, None)
            with _phase('pna.message', dev):
                msg_l = pretrans_edges(gather_rows(hb, s_l),
                                       gather_rows(hb, r_l), e_l)
            with _phase('pna.aggregate', dev):
                sk = partial_stats.partial_sketch(
                    msg_l.reshape(-1, T * Ft), r_l, N, m_l)
            if hasattr(halo, 'wait'):
                halo = halo.wait()
            with _phase('pna.message', dev):
                halo = self._tower_input(halo.to(cdt))
                msg_b = pretrans_edges(gather_rows(halo, s_b),
                                       gather_rows(hb, r_b), e_b)
            with _phase('pna.aggregate', dev):
                sk = partial_stats.combine(sk, partial_stats.partial_sketch(
                    msg_b.reshape(-1, T * Ft), r_b, N, m_b))
                Z = partial_stats.finalize_bank(sk, self.aggregators)
                deg = sk.cnt
        elif backend == 'csr':
            # the messages from the node halves, built by one kernel; the
            # edge-feature term is per edge by nature
            with _phase('pna.message', dev):
                u, v = node_halves()
                w = None
                if self.edge_features:
                    w = shared_ein(e, k0[:, 2 * Ft:], cdt).reshape(
                        E, T * Ft)
                msg = csr_bank.csr_messages(u, v, w, layout)
                # stored in the compute dtype; the bank widens to float32
                msg = self.pretrans.rest(msg.reshape(E, T, Ft), cdt).to(
                    cdt).reshape(E, T * Ft)
            with _phase('pna.aggregate', dev):
                Z = csr_bank.csr_raw_bank(msg, layout, self.aggregators)
                deg = layout.deg
        elif backend == 'csr_fused':
            # node halves only: the kernels form u[snd] + v[rcv] (+ e ke);
            # u has a row per sender-table row
            with _phase('pna.message', dev):
                u, v = node_halves()
                u, v = u.to(cdt), v.to(cdt)
                ef = ke = None
                if self.edge_features:
                    ef = e.to(cdt)
                    ke = k0[:, 2 * Ft:].to(cdt).permute(1, 0, 2).reshape(
                        -1, T * Ft)                         # [Fe, T*Ft]
            with _phase('pna.aggregate', dev):
                Z = csr_fused.csr_fused_bank(
                    u, v, ef, ke, layout, self.aggregators)  # [N, A, T*Ft]
                deg = layout.deg
        else:
            with _phase('pna.message', dev):
                src = gather_rows(src_rows, graph.senders)
                dst = gather_rows(hb, graph.receivers, graph.edge_ptr)
                msg = pretrans_edges(src, dst,
                                     e if self.edge_features else None)
                self_msg = None
                if 'identity' in self.aggregators:
                    self_msg = pretrans_nodes(hb).reshape(N, T * Ft)
            with _phase('pna.aggregate', dev):
                agg = aggregate_bank(graph, msg.reshape(E, T * Ft),
                                     self.aggregators, self.scalers,
                                     self.avg_d, self_msg=self_msg,
                                     layout=layout)

        # ---- posttrans: the scalers applied after the first layer ----
        with _phase('pna.update', dev):
            kp, bp = self.posttrans.layer(0)
            if backend == 'generic':
                k_h = kp[:, :Ft]                            # [T, Ft, Fo]
                # rows Ft + (s*A + a)*Ft + f of tower t <- bank column
                # ((s*A + a)*T + t)*Ft + f
                k_agg = kp[:, Ft:].reshape(T, S * A, Ft, Fo)
                if self.divide_input:
                    out = torch.einsum('ntf,tfo->nto',
                                       round_to(hb.reshape(N, T, Ft), cdt),
                                       round_to(k_h, cdt))
                else:
                    out = shared_ein(hb, k_h, cdt)
                out = out + torch.einsum(
                    'nxtf,txfo->nto',
                    round_to(agg.reshape(N, S * A, T, Ft), cdt),
                    round_to(k_agg, cdt)) + bp
            else:
                w = scaler_ops.scaler_weights(self.scalers, deg,
                                              self.avg_d)   # [S, N]
                out = scaled_posttrans(Z.reshape(N, A, T * Ft), hb, w, kp,
                                       bp, shared=not self.divide_input,
                                       cdt=cdt)
            out = self.posttrans.rest(out, cdt).reshape(N, T * Fo)
            if self.tp_group is not None:
                # [N, towers*Fo]
                out = tower_tp.gather_towers(out, self.tp_group)

            if self.graph_norm:
                out = out * graph.snorm_n
            if self.batch_norm:
                out = self.batchnorm_h(out, graph.node_mask)
            out = F.leaky_relu(self.mixing(self.dropout(out)),
                               negative_slope=0.01)
            if self.residual:
                out = h + out
            return out

    def _tower_input(self, x: torch.Tensor) -> torch.Tensor:
        """The columns of ``x`` [..., in_dim] that this rank's towers read:
        all of them without tower TP or with shared tower inputs."""
        if self.tp_group is None or not self.divide_input:
            return x
        w = self.local_towers * self.ft
        return x[..., self.tp_rank * w:(self.tp_rank + 1) * w]
