"""The aggregation layout of one large graph, chosen before any table is
built.

Counterpart of ``pna_tpu/ops/layout.py``.  The choice that decides whether a
large graph trains at all is made when its layout is built: a degree-bucket
table (edges padded to per-class capacities, which a hub's in-degree blows
up), an ELL table ([N, D_max], worse still on a hub) or the receiver-sorted
CSR layout of the CSR kernels (bounded by E, indifferent to degree).
``predict_layout_bytes`` predicts each layout's working set from the degree
histogram alone, and ``choose_layout`` picks the backend and the batcher's
arguments.

The constants are the port's own, read on one H100 (NVIDIA H100 80GB HBM3,
700.00 W; ``chip_smoke.py``'s large-graph phase, ``lg_bench``): the
trainer's step at ``d_graph`` 1 (hidden 64, 4 layers, 4 towers,
mean/max/min/std x identity/amplification/attenuation, batch norm, float32)
on the CLI's power-law graph of 100,000 nodes with 1,000,000 and with
100,000 edges, with its peak memory and the allocator's reservation.  Each
reading stands beside its value (PERF.md, PR 9).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from pna_tpu_torch.graph import _choose_classes, _round_up

# device bytes the train step keeps at its peak per byte of one padded edge
# row of the message tensor ([E_pad, F] float32), by layout.  Readings at
# 1,000,000 edges: csr 4,848.0 MiB over 1,000,000 rows of 64 float32 (19.86;
# csr_fused 11.42, under it), bucketed 7,529.3 MiB over 1,177,432 padded
# rows (26.19), generic 10,701.5 MiB (43.83).  At 100,000 edges the
# node-side tensors of the 100,000 nodes dominate (csr 86.96): the model is
# per edge and holds for graphs whose edges outnumber their nodes tenfold
WORK_FACTORS = {'csr': 19.9, 'bucketed': 26.2, 'generic': 43.9}
# the ELL layout's extra factor for its [N, D_max, F] gather: not measured
# (the trainer has no ELL layout, and the chooser never picks it); the
# widest of the readings, generic's
ELL_WORK_FACTOR = 43.9
# no edge threshold: the CSR kernels ran the step faster than the bucketed
# layout at every size read, 100,000 edges (step 37.98 ms, 17.44 ms of device
# time, against 70.11 and 23.59) and 1,000,000 (50.20 and 39.30 against
# 89.65 and 74.37), and at ZINC scale, 42,356 edges, in device time (PR 8);
# so on a card they are chosen whenever they fit
#
# the share of the card's memory a layout may take: the smallest share of
# the allocator's reservation the peak allocation reached in the readings
# (0.825, csr_fused at 1,000,000 edges; 0.899-0.963 for the others)
BUDGET_SHARE = 0.825


def device_budget_bytes(device) -> float:
    """The bytes a layout may take on ``device``: ``BUDGET_SHARE`` of the
    card's memory, or of the host's for the CPU."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        total = torch.cuda.get_device_properties(dev).total_memory
    else:
        total = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    return BUDGET_SHARE * total


@dataclass
class LayoutChoice:
    kernel: str                      # 'bucketed' | 'csr' | 'generic'
    batch_kwargs: Dict               # the layout's batch_graphs arguments
    est_bytes: Dict[str, float]      # working-set estimate per layout
    reason: str


def _simulate_bucket_caps(deg: np.ndarray, max_buckets: int = 4
                          ) -> Tuple[int, int]:
    """(padded edge count, widest class) of the bucket layout, from the
    degree histogram without building the table (the classes of
    ``graph._choose_classes``)."""
    counts: Dict[int, int] = {}
    u, c = np.unique(deg, return_counts=True)
    for d, k in zip(u.tolist(), c.tolist()):
        counts[int(d)] = counts.get(int(d), 0) + int(k)
    cls_of = _choose_classes(counts, max_buckets)
    cls_of[0] = 0        # degree-0 nodes form their own zero-width class
    caps: Dict[int, int] = {}
    for d, k in counts.items():
        D = cls_of[d]
        caps[D] = caps.get(D, 0) + k
    e_pad = sum(_round_up(cap, 8) * d for d, cap in caps.items())
    return int(e_pad), int(max(caps) if caps else 0)


def predict_layout_bytes(deg: np.ndarray, num_edges: int, feat_dim: int,
                         dtype_bytes: int = 4, max_buckets: int = 4,
                         work_factors: Dict[str, float] = WORK_FACTORS,
                         ell_work_factor: float = ELL_WORK_FACTOR
                         ) -> Dict[str, float]:
    """Predicted working-set bytes of the train step per layout (the JAX
    package's model with a factor per layout; its ``'pallas'`` entry is
    ``'csr'`` here)."""
    n = len(deg)
    d_max = int(deg.max()) if n else 0
    e_bucket, _ = _simulate_bucket_caps(deg, max_buckets)
    row = feat_dim * dtype_bytes
    return {
        'bucketed': e_bucket * row * work_factors['bucketed'],
        'ell': (num_edges * row * work_factors['csr']
                + n * max(d_max, 1) * row * ell_work_factor),
        'csr': num_edges * row * work_factors['csr'],
        'generic': num_edges * row * work_factors['generic'],
        'bucketed_edge_pad_ratio': e_bucket / max(num_edges, 1),
    }


def choose_layout(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, feat_dim: int, budget_bytes: float,
                  dtype_bytes: int = 4, max_buckets: int = 4,
                  csr_kernels: bool = True) -> LayoutChoice:
    """The backend and batcher layout for one large graph, within
    ``budget_bytes`` of device memory (``device_budget_bytes``).

    ``csr_kernels``: the CSR kernels run on the device (a card; on the CPU
    they are plain torch).  In order: the CSR kernels when they fit; then
    the bucket table when it fits and pads the edges at most 2x; then
    generic.  The ELL layout is never chosen for a large graph, but its
    estimate is reported."""
    deg = np.bincount(np.asarray(receivers), minlength=num_nodes)
    est = predict_layout_bytes(deg, len(senders), feat_dim, dtype_bytes,
                               max_buckets)
    pad_ratio = est['bucketed_edge_pad_ratio']
    gib = 2 ** 30
    if csr_kernels and est['csr'] <= budget_bytes:
        return LayoutChoice(
            'csr', dict(sort_edges=True), est,
            f"the CSR kernels fit ({est['csr'] / gib:.2f} GiB, bounded by "
            "E, indifferent to degree) and are the faster backend on the "
            "card")
    if est['bucketed'] <= budget_bytes and pad_ratio <= 2.0:
        return LayoutChoice(
            'bucketed', dict(bucket_by_degree=True,
                             bucket_max_buckets=max_buckets), est,
            f"the CSR kernels are not on this device; the bucket table fits "
            f"({est['bucketed'] / gib:.2f} GiB, edge pad {pad_ratio:.2f}x)")
    if est['generic'] <= budget_bytes:
        return LayoutChoice(
            'generic', dict(sort_edges=True), est,
            f"the CSR kernels are not on this device and the bucket table "
            f"does not fit ({est['bucketed'] / gib:.2f} GiB or edge pad "
            f"{pad_ratio:.2f}x); generic segment ops on the sorted layout")
    return LayoutChoice(
        'generic', dict(sort_edges=True), est,
        f"no layout fits the {budget_bytes / gib:.1f} GiB budget (best "
        f"estimate {min(est['csr'], est['bucketed']) / gib:.2f} GiB): one "
        "device cannot hold it; partition it over more "
        "(parallel/partition.py, cli/train_largegraph.py)")
