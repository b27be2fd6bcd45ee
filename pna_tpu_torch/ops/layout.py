"""The aggregation layout of one large graph, chosen before any table is
built.

Counterpart of ``pna_tpu/ops/layout.py``.  The choice that decides whether a
large graph trains at all is made when its layout is built: the
receiver-sorted CSR layout of the CSR kernels is bounded by E and
indifferent to degree.  ``predict_layout_bytes`` predicts the train step's
working set on the CSR kernels and on the generic backend from the edge
count, and ``choose_layout`` picks the backend and the batcher's arguments.
The JAX package's degree-bucketed and ELL tables, whose estimates read the
degree histogram, are not ported (a hub's in-degree blows both up, and the
CSR kernels beat the bucketed layout at every size read on the H100,
below).

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
from typing import Dict

import numpy as np
import torch

# device bytes the train step keeps at its peak per byte of one padded edge
# row of the message tensor ([E_pad, F] float32), by layout.  Readings at
# 1,000,000 edges: csr 3,030.2 MiB over 1,000,000 rows of 64 float32 (12.41;
# csr_fused 11.42), generic 10,701.5 MiB (43.83).  At 100,000 edges the
# node-side tensors of the 100,000 nodes dominate (csr 84.02): the model is
# per edge and holds for graphs whose edges outnumber their nodes tenfold
WORK_FACTORS = {'csr': 12.4, 'generic': 43.9}
# no edge threshold: the CSR kernels ran the step faster than the JAX
# package's degree-bucketed layout at every size read, 100,000 edges (step
# 37.98 ms, 17.44 ms of device time, against 70.11 and 23.59) and 1,000,000
# (50.20 and 39.30 against 89.65 and 74.37), and at ZINC scale, 42,356
# edges, in device time (PR 8); so on a card they are chosen whenever they
# fit
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
    kernel: str                      # 'csr' | 'generic'
    batch_kwargs: Dict               # the layout's batch_graphs arguments
    est_bytes: Dict[str, float]      # working-set estimate per layout
    reason: str


def predict_layout_bytes(num_edges: int, feat_dim: int,
                         dtype_bytes: int = 4,
                         work_factors: Dict[str, float] = WORK_FACTORS
                         ) -> Dict[str, float]:
    """Predicted working-set bytes of the train step per layout (the JAX
    package's model with a factor per layout; its ``'pallas'`` entry is
    ``'csr'`` here)."""
    row = feat_dim * dtype_bytes
    return {'csr': num_edges * row * work_factors['csr'],
            'generic': num_edges * row * work_factors['generic']}


def choose_layout(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, feat_dim: int, budget_bytes: float,
                  dtype_bytes: int = 4,
                  csr_kernels: bool = True) -> LayoutChoice:
    """The backend and batcher layout for one large graph, within
    ``budget_bytes`` of device memory (``device_budget_bytes``).

    ``csr_kernels``: the CSR kernels run on the device (a card; on the CPU
    they are plain torch).  The CSR kernels when they are on the device and
    fit; else generic, the segment ops on the same sorted layout.  The
    estimates read the edge count alone: ``receivers`` and ``num_nodes``,
    the JAX chooser's degree histogram, enter none of them."""
    est = predict_layout_bytes(len(senders), feat_dim, dtype_bytes)
    gib = 2 ** 30
    if csr_kernels and est['csr'] <= budget_bytes:
        return LayoutChoice(
            'csr', dict(sort_edges=True), est,
            f"the CSR kernels fit ({est['csr'] / gib:.2f} GiB, bounded by "
            "E, indifferent to degree) and are the faster backend on the "
            "card")
    if est['generic'] <= budget_bytes:
        return LayoutChoice(
            'generic', dict(sort_edges=True), est,
            "the CSR kernels are not on this device or do not fit "
            f"({est['csr'] / gib:.2f} GiB); generic segment ops on the "
            "sorted layout")
    return LayoutChoice(
        'generic', dict(sort_edges=True), est,
        f"no layout fits the {budget_bytes / gib:.1f} GiB budget (best "
        f"estimate {est['csr'] / gib:.2f} GiB): one device cannot hold it; "
        "partition it over more (parallel/partition.py, "
        "cli/train_largegraph.py)")
