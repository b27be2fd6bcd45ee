"""Smoke test of the PyTorch/CUDA port (``pna_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
   convolutions, so float32 means float32;
2. build the CUDA kernels from ``pna_tpu_torch/csrc`` (printing the ptxas
   report and the build time);
3. kernels, each against its plain PyTorch version on the card, at the
   flagship step's shapes and on a hub-skewed graph, timed with CUDA events
   (L2 flushed before every launch) beside its HBM byte bound:
   K1 ``csr_moment_sketch`` (with and without tie counts) and K2
   ``csr_dmsg`` (every row, pad rows 0; also on whole and split nodes with
   ties across segment boundaries at F = 1, 33, 70, 75, 128 and 300, with
   the cut table and with the row pointers as an uncut one; beside K1 the
   time of the nearest composition of ``torch.segment_reduce`` calls),
   K3 ``csr_pretrans_sketch`` (with and without ties and edge features, on
   a ghost sender table, with bfloat16 v/ef/ke, on a mixed case of whole
   and split nodes with ties across segment boundaries, with Fe = 70, and
   with the row pointers as an uncut segment table) and K4
   ``csr_pretrans_dmsg``; two runs of each kernel on the hub must give the
   same bits; then the row sum ``sorted_row_sum`` (``ops/rowsum.py``, the
   port's deterministic scatter-add: every gather's backward and every
   float segment sum on the card) against its plain version and against
   float64 ``index_add_``, two launches bit-equal, at every shape of the
   flagship step (the senders and the sorted receivers, no perm, at F = 70,
   the atom and bond lookups, the readout, F = 1), bfloat16 in and out, F =
   400, 500, an index that leaves half the rows empty, the large-graph
   senders (a 383,653-edge sender) at F = 64 and 70 and the 200,007-edge
   receiver hub; the nine shapes of
   ``ops/timing.py::row_sum_cases`` timed after a dirty and a clean L2
   flush beside the byte bound (the keys counted), the plain version,
   ``index_add_`` (the library call of the same function) and the index's
   sort; then the ``csr`` backend's edge messages ``csr_edge_message``
   against their plain version, bit for bit, at the large graph's layer
   (6,250,000 power-law edges, F = 64), the flagship and ZINC b128 batches
   (F = 70, with the edge term and pad rows), timed beside the byte bound,
   the plain version and two ``index_select`` and their sum, and on whole
   and split nodes with rows outside every range at F = 1 to 75
   (``edge_message_phase``); then the PNA layer's scaled posttrans
   (``ops/posttrans.py``: one forward and one backward kernel) at the large
   graph's layer (625,000 nodes, 4 towers of 16 in and out, 4 aggregators
   x 3 scalers) and ZINC's b128 batch's (5 towers of 14 in, 14 and 12
   out), within 1e-5 of its plain version, each direction timed after an L2
   flush beside its bound, the plain version and the library's products
   (``posttrans_phase``);
4. train, the flagship ZINC step (PNANetMolecules, L=4, hidden 70, out 60,
   edge_dim 50, towers 5, 1024 synthetic graphs) on one set of weights, in
   four configurations: float32 on ``kernel='csr'`` (K1/K2) and on
   ``kernel='csr_fused'`` (K3/K4), then bfloat16 compute on both.  Each
   takes one step on the card against the same weights on the CPU (loss,
   every gradient, batch-norm statistics), then timed Adam steps whose loss
   must be finite and fall, with exactly 4 launches per step of each kernel
   of its backend (and on ``csr`` of the edge messages that build its
   messages from node halves), none of the others and the row sum's
   (``rowsum_per_step``); then a profiler breakdown of three steps by
   kernel, with the ``index_add_`` and sort kernels per step.  The fused
   step's first loss must equal the CSR step's.  Then the four are timed
   again in alternating blocks of steps, so that host drift falls on all
   of them alike, and each of the four takes two forward-and-backward
   passes from the same weights: the loss and every parameter, gradient
   and batch-norm buffer must be bit-equal (``same_bits``);
5. entry: the ``entry()`` twin (no edge features) in eval mode, K1 without
   ties, against the same model on the CPU;
6. the pipeline's shapes (after phase 3, with its timer): K1 (with and
   without ties) and K2 against their plain versions on the first batch of
   each CLI at the message widths of its JSON config's layers: the ZINC CLI
   (128 graphs; F = 375 in layers 0-2, 75 in the last) and an MNIST-shaped
   batch (128 graphs of 75 superpixels; F = 100, then 500), with the nodes
   the segment table splits;
7. pipeline: ``main_molecules.main(['--synthetic', '--epochs', '3'])`` and
   ``main_superpixels.main(['--synthetic', '--epochs', '2'])`` on the card at
   their JSON configs' full width: the train loss falls, the "Best val"
   line prints a finite metric, exactly 4 K1 and 4 K2 launches per train
   step, 4 K1 per evaluation batch and none of K3/K4; seconds per epoch,
   steps per second, and the shares of batch collation and of the per-step
   loss read;
8. the first train step of each CLI's config through the trainer on the
   card against the CPU (the ZINC batch; the MNIST-shaped batch);
9. resume on the card: 2 epochs and a resume to 3 against 3 straight, on a
   small ZINC configuration with dropout: every value of the resumed
   epoch's history equal to the straight run's;
10. the MolHIV slice: K1 (with and without ties) and K2 against their plain
    versions on the first batch of the HIV CLI (F = 70) and of the PyG
    example (F = 80), and on the HIV batch with an isolated atom (K1's max
    and min 0 there, the bank's gradient finite on the card and equal to
    the CPU's); ``main_HIV.main(['--synthetic', '--epochs', '3'])`` and
    ``pyg_example.main(['--synthetic', '--epochs', '2'])`` at full width
    with the checks of phase 7; the HIV config's first trainer step (dropout
    0, the batch with the isolated atom) card against CPU; one synthetic
    epoch of the CIFAR10 superpixel config; the card's routing of the
    sparse bank: ``PNALayerSparse`` (edge features, 5 towers, identity and
    softmax beside the kernels' aggregators) and ``PNAConvPyG`` (2 towers,
    unclamped var) on the card, K1/K2 for the kernels' aggregators and
    plain torch for the rest, against the same layers on the CPU, where
    every aggregator takes the segment form;
11. the multitask benchmark (dense layers in plain torch, no CSR kernel):
    ``cli/generate_dataset.py`` writes a dataset cut from the JAX split
    specification (MT_BUCKETS) without networkx; ``cli.pna`` at the
    reference recipe (MT_RECIPE) for 3 epochs with falling training loss,
    ``cli.mpnn --aggregation sum``, ``cli.gcn``, ``cli.gat`` and
    ``cli.gin`` for 1 epoch each at the same structure flags, each
    printing "Test set results" for every split (seconds per epoch, train
    steps/s); the first trainer step of each of the five models on the
    card against the same weights on the CPU (gradients held in float64,
    the float32 loss held and its gradients reported, see MT_F32_TOL); the
    PNA net in eval mode on the N = 95 bucket (47 layers, 95 LSTM steps), 4
    graphs of it against the CPU's float64; a profile of the PNA recipe's
    train steps; K1 to K4 launch 0 times in the phase;
12. layouts (after the interleaved timing of phase 4): the flagship step on
    ``kernel='generic'`` with ``identity`` added to the aggregators, at full
    width on the CSR batch: one step on the card against the CPU (the
    tolerances of phase 4), its first loss against the same net's on the
    batch without ``edge_ptr`` (the segment form for every aggregator)
    within LOSS_RTOL, then LAYOUT_STEPS steps with falling loss, its
    launches (the sparse bank's K1 and K2 per layer), peak memory and a
    profile, timed interleaved with the ``csr`` float32 step; and the
    ``csr`` flagship step with dropout 0.1 and ``remat=True`` against the
    same step without remat (loss rtol 1e-5, gradients GRAD_TOL, batch-norm
    statistics rtol 1e-6, K1 twice per layer and K2 once, the peak memory
    of both, and both steps timed interleaved);
13. large graph (the distributed stack on the card, over a 1-rank NCCL
    group in this process): the host C++ library (``pna_tpu_torch/native``)
    must have built; ``halo_exchange`` over the NCCL group equals the local
    gather (in flight too, and its gradient); the dryrun's hub-skewed
    node-level configuration (``hub_problem``: a node receiving a fifth of
    the edges, edge features) at one part, its step on the card over the
    NCCL mesh against the same weights on the CPU without groups on
    ``csr`` and ``csr_fused`` (phase 4's tolerances; one K1 with ties and
    one K2 per layer on ``csr``, one K3 and one K4 on ``csr_fused``, none
    of the others), and ``dryrun_multichip(1)``; K1-K4 against their plain
    versions at the path's shapes (the CLI's graph, 100,000 nodes and
    1,000,000 power-law edges, as one sorted part; F = 64; K3's u from the
    part's ghost table; Fe = 64, the edge features as the net embeds
    them) and on the same graph with a fifth of the
    edges sent to node 0 (in-degree 200,007), the sums held against float64
    there, timed beside their byte bounds; ``cli.train_largegraph.main`` at
    its defaults with ``--d_graph 1`` for 30 steps (``--eval_every 10``) on
    ``csr``, ``csr_fused`` (``--edge_feat_dim 4``) and ``generic``: exact
    launches (4 K1 + 4 K2 per train step and 4 K1 per
    evaluation on ``csr``, K3/K4 alike on ``csr_fused``, none on the
    others; the row sum's, ``LG_ROWSUM``; the scaled posttrans 4 forward
    per train step and per evaluation and 4 backward per train step on
    ``csr`` and ``csr_fused``, none on ``generic``), finite val losses, a
    falling train loss on the CSR backends,
    train steps/s; ``--kernel auto`` prints its choice; 20 steps and a
    resume to 30 against the 30 straight ``csr`` steps (equal); and
    the trainer's step on ``csr``, ``csr_fused`` and ``generic`` at
    1,000,000 edges and on ``csr`` at 100,000 (median step, peak memory
    per padded-edge-row byte, a profile):
    the readings of ``ops/layout.py``'s constants (each profile gives K1-K4's
    and the row sum's ms and launches per step, and the ``index_add_`` and
    sort kernels); the ``csr`` step twice from the same weights, bit-equal
    (``same_bits``);
14. the sparse path on the power-law graph: the large-graph CLI's graph
    (100,000 nodes, 1,000,000 edges, exponent 1.5, its seed; a sender of
    about 380,000 edges, uniform receivers) as one receiver-sorted graph
    with ``edge_ptr``, and its twin with a fifth of the edges sent to node
    0; on it the edge-list layers at their configs' full widths:
    ``PNASimpleLayerSparse`` (the HIV config), ``PNALayerSparse`` (a middle
    layer of the ZINC config, 5 towers), ``PNAConvSimplePyG`` and
    ``PNAConvPyG`` (5 towers) at the PyG example's width, the edge-list
    GCN, GAT and GIN, and, on the twin, ``aggregate_bank`` with identity,
    normalised_mean, softmax, softmin and moment3 (the segment form).  Each
    is held card vs CPU on the same graph at 100,000 edges and its twin
    (phase 4's limits), ``hiv_simple``, ``zinc_towers`` and
    ``segment_bank`` on the full graph too, then its forward and backward
    is timed on the full graph (median of 5 steps after 2), with its peak
    memory, exact K1/K2 launches (one each per bank: 5 per step for the
    towered DGL layer, 1 for the others, 0 for GCN, GAT, GIN and the segment
    form), exact row-sum launches (``sp_cases``) and one profiled step:
    device ms, the top kernels, the ``index_add_`` and sort kernels and no
    ``index_put`` kernel or host op (``x[index]``'s backward);
    ``hiv_simple``, ``zinc_towers`` and ``segment_bank`` then take two
    passes from the same weights on the full graph, bit-equal (their input
    gradient too);
15. bench, the twin of ``bench.py`` (``pna_tpu_torch/bench.py``): (a)
    ``python -m pna_tpu_torch.bench``'s ``main([])`` in this process (csr,
    float32 and bfloat16, flat Adam, 120 timed steps each), its JSON line
    printed: 42,356 real edges and 19,784 nodes, edges/s = edges x 4 / step
    within 1e-9, finite times, an MFU, 4 K1 and 4 K2 launches per step and
    exactly 4 of each per step it ran; (b) one table of runners, every
    backend in float32 and bfloat16 (``csr``, ``csr_fused``, ``auto``,
    which resolves to ``csr``), ``generic``, ``csr`` with remat and ``csr``
    with the per-tensor Adam, timed in blocks of BENCH_BLOCK steps in the
    order A..Z Z..A twice: step ms, edges/s, spread, device ms, busy share,
    kernels per step, MFU, the backend each layer resolved to and the
    launches per step (4 K1 + 4 K2 on ``csr`` and through ``generic``'s
    sparse bank, 8 K1 with remat, 4 K3 + 4 K4 on ``csr_fused``); (c) the
    flat Adam: 3 ``csr`` float32 steps with ``FlatAdam`` and with the
    per-tensor Adam from the same weights on the same gradients
    (parameters within 1e-6), the flat step's first gradients card against
    CPU at phase 4's limits, one update of each timed alone with CUDA
    events, and the kernels per training step of each from (b); (d) short
    runs of ``main`` with ``--no_edge_feat`` and with 80-wide layers in
    bfloat16, held like (a).

The GAT phase (``gat_phase``): the attention kernels ``csr_gat_attend`` and
``csr_gat_attend_bwd`` at the GAT cell's two layer shapes bit-equal to
their plain versions, twice, timed beside their byte bounds (their rows
close the kernels line), and ``cli.train_largegraph.main --model gat``
with its exact launches.

Every launch count a phase holds includes the row sum's, worked out from
the code (``ROWSUM_PER_LAYER``, ``ROWSUM_READOUT``, the embedding lookups,
``LG_ROWSUM``, ``sp_cases``).  The line before the last is ``{"kernels":
[...]}`` (its ``determinism`` entry holds the ``same_bits`` checks); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1
and prints no result.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from pna_tpu_torch import bench as twin
from pna_tpu_torch import dryrun_multichip, entry, hub_problem, native
from pna_tpu_torch.cli import common as mt_common
from pna_tpu_torch.cli import gat as mt_gat
from pna_tpu_torch.cli import gcn as mt_gcn
from pna_tpu_torch.cli import generate_dataset
from pna_tpu_torch.cli import gin as mt_gin
from pna_tpu_torch.cli import (main_HIV, main_molecules, main_superpixels,
                               pyg_example)
from pna_tpu_torch.cli import mpnn as mt_mpnn
from pna_tpu_torch.cli import train_largegraph as train_largegraph_cli
from pna_tpu_torch.cli import pna as mt_pna
from pna_tpu_torch.data.multitask import load_multitask_dataset
from pna_tpu_torch.data.hiv import HIVDataset
from pna_tpu_torch.data.molecules import (ZincDataset, batch_iterator,
                                          collate_records)
from pna_tpu_torch.data.superpixels import SuperpixelsDataset
from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.nn.pyg import (PNAConvPyG, PNAConvSimplePyG,
                                  PNANetPyGExample)
from pna_tpu_torch.nn.sparse import (GATLayerSparse, GCNLayerSparse,
                                     GINLayerSparse, PNALayerSparse,
                                     PNASimpleLayerSparse, aggregate_bank)
from pna_tpu_torch.ops import build, csr_bank, csr_kernels, rowsum
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import posttrans as pt
from pna_tpu_torch.ops.csr_bank import csr_layout, layout_from_graph
from pna_tpu_torch.ops.csr_kernels import SEG, CSRSegments, csr_segments
from pna_tpu_torch.parallel import multihost
from pna_tpu_torch.parallel.distributed_net import (DistributedPNANet,
                                                    mesh_groups)
from pna_tpu_torch.parallel.partition import (halo_exchange,
                                              partition_edges,
                                              powerlaw_graph,
                                              sort_partition_edges)
from pna_tpu_torch.ops.segment import gather_rows
from pna_tpu_torch.ops import timing
from pna_tpu_torch.ops.timing import (bound_ms, card_line, flush_buffer,
                                      hub_case, make_messages, nbytes,
                                      time_cuda)
from pna_tpu_torch.train.engine import MultitaskTrainer
from pna_tpu_torch.train.largegraph import (LargeGraphConfig, build_problem,
                                            make_node_train_step)
from pna_tpu_torch.train.realworld import PipelineConfig, RealworldTrainer
from pna_tpu_torch.train import step as twin_step
from pna_tpu_torch.train.step import loss_and_grads, make_optimizer, train_step
from pna_tpu_torch.utils import profiling

FLAGSHIP = dict(**timing.FLAGSHIP_WIDTHS, edge_feat=True,
                divide_input_first=True, divide_input_last=True, towers=5,
                n_layers=4, aggregators=('mean', 'max', 'min', 'std'),
                scalers=('identity', 'amplification', 'attenuation'),
                readout_type='sum', graph_norm=True, batch_norm=True,
                residual=True)
N_LAYERS = FLAGSHIP['n_layers']
FE = FLAGSHIP['edge_dim']
TRAIN_STEPS = 12
TIMED_FROM = 2               # steps before this one are warm-up
GHOST = 13                   # extra sender rows of the ghost-table case

# the kernels of each backend; the other backend's must not launch
BACKEND_KERNELS = {'csr': ('csr_moment_sketch', 'csr_dmsg'),
                   'csr_fused': ('csr_pretrans_sketch', 'csr_pretrans_dmsg')}
SOURCES = {
    "csr_moment_sketch": ("pna_tpu_torch/csrc/csr_moment_sketch.cu",
                          "pna_tpu/ops/pallas_kernels.py:199"),
    "csr_dmsg": ("pna_tpu_torch/csrc/csr_dmsg.cu",
                 "pna_tpu/ops/pallas_kernels.py:696"),
    "csr_pretrans_sketch": ("pna_tpu_torch/csrc/csr_pretrans_sketch.cu",
                            "pna_tpu/ops/pallas_kernels.py:464"),
    "csr_pretrans_dmsg": ("pna_tpu_torch/csrc/csr_pretrans_dmsg.cu",
                          "pna_tpu/ops/pallas_kernels.py:918"),
    # no pallas_call: XLA's scatter-add, jax.ops.segment_sum and the VJP of
    # a gather, in pna_tpu
    "sorted_row_sum": ("pna_tpu_torch/csrc/sorted_row_sum.cu",
                       "pna_tpu/ops/segment.py:33"),
}
ROW_SUM = "sorted_row_sum"
# the csr backend's edge messages: no TPU kernel to replace (JAX builds the
# messages with XLA gathers and matmuls, pna_tpu/nn/fused.py:311), so not in
# SOURCES' table; one launch per fused layer of every csr forward, as K1
# (twice a layer under remat)
MSG = "csr_edge_message"
MSG_SOURCE = "pna_tpu_torch/csrc/csr_edge_message.cu"
LAUNCHED = (*SOURCES, MSG)
# rows before ptr[0] and after ptr[N] (in no receiver's range) of the edge
# message checks
MSG_LEAD, MSG_PAD = 3, 9
# launches of the row sum (ops/rowsum.py) per fused layer of a train step,
# worked out from the code: one for the backward of every gather_rows of a
# tensor that needs a gradient, one for every float segment_sum on the card
# (forward; its backward is a row gather), one for csr_fused's d_u.  'csr'
# and 'generic' gather the senders and the receivers (2); 'csr_fused' sums
# d_u (1); with 'identity' (generic) the segment form counts the in-degrees
# too (IDENTITY_ROWSUM).  The readout adds ROWSUM_READOUT in every forward, and
# each embedding lookup (a row gather of its weight) one in a train step:
# the flagship looks up atoms and bonds (2), the ZINC CLI atoms (1), the
# OGB AtomEncoder of the HIV and PyG nets its 9 columns, the superpixel and
# large-graph nets none (dense embeddings)
ROWSUM_PER_LAYER = {'csr': 2, 'csr_fused': 1, 'generic': 2}
IDENTITY_ROWSUM = 1
# 'sum': one segment_sum; 'mean': the sum and the count
ROWSUM_READOUT = {'sum': 1, 'mean': 2}
OGB_ATOM_COLUMNS = 9


def rowsum_per_step(backend, n_layers, readout='sum', lookups=2):
    """Row-sum launches of one train step of a fused-layer net with
    ``lookups`` embedding lookups (the flagship's 2 by default)."""
    return (ROWSUM_PER_LAYER[backend] * n_layers + ROWSUM_READOUT[readout]
            + lookups)


def want_launches(backend=None, per=0, rows=0, msg=0):
    """Launch counts of a run: ``per`` of each kernel of ``backend`` ('csr':
    K1 and K2, 'csr_fused': K3 and K4, None: neither), ``rows`` of the row
    sum, ``msg`` of the edge messages, none of the others."""
    kern = BACKEND_KERNELS.get(backend, ())
    return {k: per if k in kern else rows if k == ROW_SUM
            else msg if k == MSG else 0 for k in LAUNCHED}

# tolerances of the kernel phase, kernel against plain version on the card:
# max, min and tie counts select values and must be equal (the plain
# versions form the fused messages bit for bit); sums are taken in another
# order (the plain version adds with atomics), so sum, sumsq and K4's d_v
# may differ by 1e-5 of the sum of magnitudes they add; d_msg repeats the
# plain version's roundings (no FMA contraction) and is held to rtol 1e-5,
# atol 1e-6
SUM_RTOL = 1e-5
DMSG_RTOL, DMSG_ATOL = 1e-5, 1e-6
# CPU against card, one whole float32 step: matmuls and reductions add in
# other orders, and 4 layers with batch-norm amplify it; every gradient
# tensor must agree within 2e-3 of its largest entry, the loss within 1e-4
GRAD_TOL, LOSS_RTOL = 2e-3, 1e-4
# bfloat16 compute: both devices round the same operands and sum in float32
# in other orders, and a float32 difference in the last place now and then
# moves a value across a bfloat16 rounding boundary (2^-8 of itself) or, on
# 'csr', a max/min gradient to another of its tied edges; every gradient
# tensor and batch-norm statistic must agree within 5e-2 of its norm, the
# loss within 1e-2 (the CPU tests hold the port to the JAX bfloat16 path
# with the same bounds)
BF16_GRAD_TOL, BF16_LOSS_RTOL = 5e-2, 1e-2
# the trainer steps' gradient check: the least scale of a gradient tensor,
# as a share of the model's largest gradient entry (see trainer_step_phase)
ZERO_GRAD_FLOOR = 1e-3

ZINC_CONFIG = 'molecules_graph_regression_pna_ZINC.json'
MNIST_CONFIG = 'superpixels_graph_classification_pna_MNIST.json'
CIFAR10_CONFIG = 'superpixels_graph_classification_pna_CIFAR10.json'
HIV_CONFIG = 'molecules_graph_classification_PNA_HIV.json'
# the PyG example has no JSON config: its flags' defaults
# (cli/pyg_example.py) and its net's (nn/pyg.py::PNANetPyGExample)
PYG_CONFIG = {'params': {'seed': 0, 'batch_size': 128},
              'net_params': {'L': 4, 'hidden_dim': 80}}
# the multitask dataset: the JAX split specification's bucket sizes (512
# train, 128 val, 256 test graphs) at N = 15 and 24 only, and one
# extrapolation bucket of 64 graphs at N = 95, in place of 10/5/5 buckets at
# N = 15..24 (and 9 extrapolation buckets): the script's time
MT_BUCKETS = {'train': [[15, 512], [24, 512]],
              'val': [[15, 128], [24, 128]],
              'test': [[15, 256], [24, 256]],
              'test-(95,100)': [[95, 64]]}
# the reference recipe (benchmarks/multitask_run.py, RESULTS_multitask.json)
MT_RECIPE = ['--variable', '--fixed', '--gru', '--variable_conv_layers',
             'N/2', '--fc_layers', '3', '--hidden', '16', '--lr', '0.003',
             '--weight_decay', '1e-6', '--dropout', '0.0', '--print_every',
             '1']
MT_CLIS = {
    'pna': (mt_pna, 3, ['--towers', '4', '--aggregators', 'mean max min std',
                        '--scalers', 'identity amplification attenuation']),
    'mpnn': (mt_mpnn, 1, ['--towers', '4', '--aggregation', 'sum']),
    'gcn': (mt_gcn, 1, []),
    'gat': (mt_gat, 1, ['--nheads', '4']),
    'gin': (mt_gin, 1, []),
}
# graphs of the N = 95 bucket evaluated on the CPU too
MT_EXTRA_CPU_GRAPHS = 4
# the multitask steps' float32 gradients depend on the order of float32
# sums beyond GRAD_TOL: a ReLU before a batch norm sees pre-activations near
# 0 (units active on a handful of the 7,680 rows), a rounding moves one
# across the kink, and the unit's few rows carry its whole gradient; std's
# sqrt(E[x^2] - E[x]^2 + 1e-5) and 7-12 layers sharing one conv_mid
# amplify the rest (one call read GIN's conv_0 weight gradient 5.8e-3 from
# the float64 one on the card and 8.4e-7 on the CPU).  So the steps hold
# their gradients card vs CPU in float64, and in float32 hold the loss and
# report the gradients.  Forward outputs are continuous in the roundings: a
# float32 output of the card is held to the CPU's float64 one within
# MT_F32_TOL of the largest entry, or within MT_F32_FACTOR times the CPU's
# own float32 error where that is larger
MT_F32_TOL, MT_F32_FACTOR = GRAD_TOL, 3.0


def log(*args):
    print(*args, flush=True)


def check_sketch(kern, plain, msg, ptr, what="K1", exact=False):
    """Max abs error over the outputs of a moment sketch of ``msg``; raises
    outside the tolerance.  ``exact``: the sums are held against the plain
    version in float64 (a node of 200,000 edges: the float32 plain
    version's own atomic sums are off by more than SUM_RTOL there)."""
    scale_s = csr_kernels.csr_moment_sketch_plain(msg.abs(), ptr)[0]
    if exact:
        ref = csr_kernels.csr_moment_sketch_plain(msg.double(), ptr)[:2]
        plain = tuple(r.float() for r in ref) + tuple(plain[2:])
    err = 0.0
    for i, (k, p) in enumerate(zip(kern, plain)):
        d = (k - p).abs()
        err = max(err, float(d.max()))
        if i == 0:
            ok = bool((d <= SUM_RTOL * scale_s + 1e-6).all())
        elif i == 1:
            ok = bool((d <= SUM_RTOL * p.abs() + 1e-6).all())
        else:
            ok = torch.equal(k, p)
        if not ok:
            raise AssertionError(f"{what} output {i} disagrees, max err "
                                 f"{float(d.max())}")
    return err


def sketch_messages(ptr, n_rows, f, tie_node, dev, gen):
    """Messages [n_rows, f] over ``segment_layout``: every other
    column drawn from five levels (ties everywhere), and +100 on either side
    of the first segment boundary of ``tie_node``, -100 on either side of its
    second: both its tie counts are 2 at every feature."""
    msg = torch.randn(n_rows, f, generator=gen)
    msg[:, ::2] = torch.randint(-2, 3, msg[:, ::2].shape,
                                generator=gen).float()
    lo = int(ptr[tie_node])
    msg[lo + SEG - 1:lo + SEG + 1] = 100.0
    msg[lo + 2 * SEG - 1:lo + 2 * SEG + 1] = -100.0
    return msg.to(dev)


def check_csr(msg, ptr, segs, gen, what, exact=False):
    """K1 with and without ties and K2 (every row) against their plain
    versions on one set of inputs (``exact``: see ``check_sketch``);
    returns (K1 error, K2 error, K2's arguments, K1's six outputs)."""
    plain6 = csr_kernels.csr_moment_sketch_plain(msg, ptr, True)
    kern6 = csr_kernels.csr_moment_sketch(msg, ptr, True, segments=segs)
    kern4 = csr_kernels.csr_moment_sketch(msg, ptr, False, segments=segs)
    torch.cuda.synchronize()
    e1 = max(check_sketch(kern6, plain6, msg, ptr, exact=exact),
             check_sketch(kern4, plain6[:4], msg, ptr, exact=exact))
    n, f = ptr.numel() - 1, msg.shape[1]
    fields = [torch.randn(n, f, generator=gen).to(msg.device)
              for _ in range(4)]
    fields[2] /= kern6[4]
    fields[3] /= kern6[5]
    args = (msg, ptr, *fields, kern6[2], kern6[3])
    d_k = csr_kernels.csr_dmsg(*args, segments=segs)
    d_p = csr_kernels.csr_dmsg_plain(*args)
    torch.cuda.synchronize()
    e2 = float((d_k - d_p).abs().max())
    if not torch.allclose(d_k, d_p, rtol=DMSG_RTOL, atol=DMSG_ATOL):
        raise AssertionError(f"K2 disagrees ({what}), max err {e2}")
    _, valid = csr_kernels._row_segments(ptr, msg.shape[0])
    if not bool((d_k[~valid] == 0).all()):
        raise AssertionError(f"K2 ({what}): a row of no node is not 0")
    return e1, e2, args, kern6


def segment_reduce_ms(msg, ptr, flush):
    """The nearest composition of PyTorch calls to K1 without ties: four
    ``torch.segment_reduce`` calls (sum, sum of squares, max, min) over the
    nodes' lengths.  Not one library call, and not K1's function (no tie
    counts, another value for an empty node): timed for scale only."""
    rows = msg[int(ptr[0]):int(ptr[-1])]
    lengths = (ptr[1:] - ptr[:-1]).long()

    def run():
        return (torch.segment_reduce(rows, "sum", lengths=lengths,
                                     unsafe=True),
                torch.segment_reduce(rows * rows, "sum", lengths=lengths,
                                     unsafe=True),
                torch.segment_reduce(rows, "max", lengths=lengths,
                                     unsafe=True),
                torch.segment_reduce(rows, "min", lengths=lengths,
                                     unsafe=True))
    got = run()
    want = csr_kernels.csr_moment_sketch_plain(msg, ptr)
    if not torch.allclose(got[0], want[0], rtol=1e-4, atol=1e-4):
        raise AssertionError("segment_reduce composition: another sum")
    return time_cuda(run, flush)


def csr_case(name, ptr, n_rows, segs, f, dev, gen, flush, exact=False):
    """K1 (with and without ties) and K2 on random messages [n_rows, f]
    over ``ptr`` (``segs``: its segment table): checked against their plain
    versions, then timed beside their byte bounds.  Returns (times, bounds
    and the messages; K1 error; K2 error; K2's arguments; K1's six
    outputs)."""
    n = ptr.numel() - 1
    msg = make_messages(n_rows, f, dev, gen)
    rows = int(ptr[-1] - ptr[0])
    e1, e2, args, kern6 = check_csr(msg, ptr, segs, gen, name, exact)
    t = {
        "k1": time_cuda(lambda: csr_kernels.csr_moment_sketch(
            msg, ptr, True, segments=segs), flush),
        "k1_no_ties": time_cuda(lambda: csr_kernels.csr_moment_sketch(
            msg, ptr, False, segments=segs), flush),
        "k1_plain": time_cuda(lambda: csr_kernels.csr_moment_sketch_plain(
            msg, ptr, True), flush),
        "k2": time_cuda(lambda: csr_kernels.csr_dmsg(
            *args, segments=segs), flush),
        "k2_plain": time_cuda(lambda: csr_kernels.csr_dmsg_plain(*args),
                              flush),
        "msg": msg,
    }
    # K1 reads the real rows and the table's pointers; K2 reads the real
    # rows, the row-to-node array and the node fields and writes every row
    # of d_msg, the rows of no node as 0
    t["k1_bound"] = bound_ms(rows * f * 4 + (segs.n_seg + 1) * 4
                             + 6 * n * f * 4, 7 * rows * f)
    t["k1_bound4"] = bound_ms(rows * f * 4 + (segs.n_seg + 1) * 4
                              + 4 * n * f * 4, 5 * rows * f)
    t["k2_bound"] = bound_ms(rows * f * 4 + n_rows * 4 + 6 * n * f * 4
                             + n_rows * f * 4, 6 * rows * f)
    log(f"kernels[{name}] N={n} E={n_rows} rows={rows} F={f}, "
        f"{segs.n_seg} segments, {segs.n_split} split nodes: "
        f"K1 ties {t['k1']:.4f} ms (plain {t['k1_plain']:.4f}, bound "
        f"{t['k1_bound'][0]:.4f}), K1 no ties {t['k1_no_ties']:.4f} ms "
        f"(bound {t['k1_bound4'][0]:.4f}), K2 {t['k2']:.4f} ms (plain "
        f"{t['k2_plain']:.4f}, bound {t['k2_bound'][0]:.4f}); max err K1 "
        f"{e1:.3g} K2 {e2:.3g}")
    return t, e1, e2, args, kern6


def kernel_phase(graph, dev, flush):
    """K1 and K2 on random messages over the flagship layout and the hub,
    and on whole and split nodes at several widths."""
    gen = torch.Generator().manual_seed(1)
    layout = csr_layout(graph.edge_ptr.to(dev), graph.edge_mask.to(dev),
                        max_in_degree=graph.max_in_degree)
    f = FLAGSHIP['hidden_dim']       # message width T * Ft of every layer
    hub_ptr, hub_rows = hub_case(dev, gen)
    cases = {
        "slice": (layout.ptr, graph.n_edge_pad, layout.segments),
        "hub": (hub_ptr, hub_rows, csr_segments(hub_ptr)),
    }
    res = {"csr_moment_sketch": {"err": 0.0}, "csr_dmsg": {"err": 0.0}}

    def record(e1, e2):
        res["csr_moment_sketch"]["err"] = max(res["csr_moment_sketch"]["err"],
                                              e1)
        res["csr_dmsg"]["err"] = max(res["csr_dmsg"]["err"], e2)

    for name, (ptr, n_rows, segs) in cases.items():
        t, e1, e2, args, kern6 = csr_case(name, ptr, n_rows, segs, f, dev,
                                          gen, flush)
        record(e1, e2)
        if name == "hub":       # no atomics, a fixed order: the same bits
            again = (csr_kernels.csr_moment_sketch(t["msg"], ptr, True,
                                                   segments=segs)
                     + (csr_kernels.csr_dmsg(*args, segments=segs),))
            first = kern6 + (csr_kernels.csr_dmsg(*args, segments=segs),)
            torch.cuda.synchronize()
            for x, y in zip(first, again):
                if not torch.equal(x, y):
                    raise AssertionError("hub: two runs of K1/K2 differ")
            log("kernels[hub] two runs of K1 and K2 give the same bits")
            res["csr_moment_sketch"].update(hub_ms=t["k1"],
                                            hub_bound_ms=t["k1_bound"][0])
            res["csr_dmsg"].update(hub_ms=t["k2"],
                                   hub_bound_ms=t["k2_bound"][0])
        else:
            comp = segment_reduce_ms(t["msg"], ptr, flush)
            log(f"kernels[slice] four torch.segment_reduce calls (sum, sum "
                f"of squares, max, min; no tie counts; not one library "
                f"call): {comp:.4f} ms")
            res["csr_moment_sketch"].update(
                ms=t["k1"], plain_ms=t["k1_plain"], bound=t["k1_bound"],
                ms_no_ties=t["k1_no_ties"],
                bound_no_ties_ms=t["k1_bound4"][0],
                segment_reduce_composition_ms=comp)
            res["csr_dmsg"].update(ms=t["k2"], plain_ms=t["k2_plain"],
                                   bound=t["k2_bound"])

    # whole and split nodes, ties across segment boundaries, 12 rows of no
    # node, at widths whose rows start on 4-, 8- and 16-byte boundaries;
    # with the cut table and with the row pointers as the table (no node
    # split, ranges longer than a staged span walked in several)
    mptr, n_rows, tie_node = segment_layout(gen)
    mptr = mptr.to(dev)
    n = mptr.numel() - 1
    tables = {"cut": csr_segments(mptr),
              "uncut": CSRSegments(seg_ptr=mptr, n_seg=n, n_nodes=n)}
    for width in (1, 33, 70, 75, 128, 300):
        msg = sketch_messages(mptr, n_rows, width, tie_node, dev, gen)
        for name, segs in tables.items():
            e1, e2, _, k6 = check_csr(msg, mptr, segs, gen,
                                      f"segments F={width} {name}")
            record(e1, e2)
            if not (bool((k6[4][tie_node] == 2).all())
                    and bool((k6[5][tie_node] == 2).all())):
                raise AssertionError(
                    f"segment case (F={width}, {name} table): the ties "
                    "across segment boundaries were not merged")
        log(f"kernels[segments] K1/K2 F={width}: cut and uncut table agree "
            f"with plain; ties across boundaries merged")
    return res


def pretrans_inputs(ptr, senders, n_u, bond, dev, gen):
    """(u [n_u, F] f32, v [N, F], ef [E, FE], ke [FE, F]) on the card, with
    tie material: u rows repeat in groups of four node ids and ef is a
    bond-type embedding, so two edges into one node from senders of one
    group with one bond type carry equal messages."""
    n, f = ptr.numel() - 1, FLAGSHIP['hidden_dim']
    u = torch.randn(n_u // 4 + 1, f, generator=gen)[
        torch.arange(n_u) // 4]
    table = torch.randn(int(bond.max()) + 1, FE, generator=gen)
    return (u.to(dev), torch.randn(n, f, generator=gen).to(dev),
            table[bond].to(dev), torch.randn(FE, f, generator=gen).to(dev))


def pretrans_bounds(u, v, snd, ptr, ef, ke, with_ties):
    """Byte and operation bounds of K3 (with or without ties) and K4 on
    these inputs: u, v, ef and the senders of the real rows read once, the
    outputs written once."""
    n, f = ptr.numel() - 1, u.shape[1]
    rows = int(ptr[-1] - ptr[0])
    fe = 0 if ef is None else ef.shape[1]
    common = (nbytes(u) + nbytes(v) + rows * 4 + (n + 1) * 4
              + rows * fe * (0 if ef is None else ef.element_size())
              + nbytes(ke))
    msg_ops = (2 * fe + 1) * rows * f
    k3 = bound_ms(common + (6 if with_ties else 4) * n * f * 4,
                  msg_ops + (7 if with_ties else 5) * rows * f)
    k4 = bound_ms(common + 6 * n * f * 4 + rows * f * 4 + n * f * 4,
                  msg_ops + 7 * rows * f)
    return k3, k4


def check_pretrans(u, v, snd, ptr, ef, ke, segs, gen, exact=False):
    """K3 with and without ties and K4 against their plain versions on one
    set of inputs (``segs``: the segment table of ``ptr``; ``exact``: sums
    and K4's d_v against float64 sums of the plain messages and d_msg, see
    ``check_sketch``); returns (K3 error, K4 error, K4 arguments, K3's six
    outputs)."""
    msg = fk.pretrans_messages_plain(u, v, snd, ptr, ef, ke)
    plain6 = fk.csr_pretrans_sketch_plain(u, v, snd, ptr, ef, ke, True)
    kern6 = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, True, segs)
    kern4 = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, False, segs)
    torch.cuda.synchronize()
    e3 = max(check_sketch(kern6, plain6, msg, ptr, "K3", exact),
             check_sketch(kern4, plain6[:4], msg, ptr, "K3", exact))
    if float(kern6[4].max()) < 2:
        raise AssertionError("K3 case has no max tie")
    n, f = ptr.numel() - 1, u.shape[1]
    fields = [torch.randn(n, f, generator=gen).to(u.device)
              for _ in range(4)]
    fields[2] /= kern6[4]
    fields[3] /= kern6[5]
    args = (u, v, snd, ptr, *fields, kern6[2], kern6[3], ef, ke)
    d_k, dv_k = fk.csr_pretrans_dmsg(*args, segs)
    d_p, dv_p = fk.csr_pretrans_dmsg_plain(*args)
    if exact:
        dv_p = csr_kernels.csr_moment_sketch_plain(d_p.double(),
                                                   ptr)[0].float()
    torch.cuda.synchronize()
    scale = csr_kernels.csr_moment_sketch_plain(d_p.abs(), ptr)[0]
    # every row: K4 writes the rows outside every range as 0, as the plain
    # version does
    e4 = float((d_k - d_p).abs().max())
    if not torch.allclose(d_k, d_p, rtol=DMSG_RTOL, atol=DMSG_ATOL):
        raise AssertionError(f"K4 d_msg disagrees, max err {e4}")
    dv_err = (dv_k - dv_p).abs()
    e4 = max(e4, float(dv_err.max()))
    if not bool((dv_err <= SUM_RTOL * scale + 1e-6).all()):
        raise AssertionError(f"K4 d_v disagrees, max err "
                             f"{float(dv_err.max())}")
    return e3, e4, args + (segs,), kern6


def segment_layout(gen):
    """A layout of whole and split nodes: 3,000 nodes of in-degree 0..4,
    then nodes of SEG - 1, SEG, SEG + 1, 0, 3 SEG, 0, 2 SEG + 5 and 1,000
    edges, then 12 rows of no node.  Returns (ptr on the CPU, rows, the node
    of 3 SEG edges)."""
    deg = torch.cat([torch.randint(0, 5, (3000,), generator=gen),
                     torch.tensor([SEG - 1, SEG, SEG + 1, 0, 3 * SEG, 0,
                                   2 * SEG + 5, 1000])])
    ptr = torch.zeros(deg.numel() + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(deg, 0)
    return ptr, int(ptr[-1]) + 12, 3004


def segment_case(dev, gen):
    """Pretrans inputs over ``segment_layout``.  The node of 3 SEG edges has,
    either side of its first segment boundary, two edges with one sender (a
    u row of +100) and one ef row, and either side of its second boundary
    two with a u row of -100: its max and its min are each reached once in
    two segments, so both tie counts must come out as 2 at every feature.
    Returns (u, v, snd, ptr, ef, ke, tie node, first row of each tied
    pair)."""
    ptr, e, tie_node = segment_layout(gen)
    n = ptr.numel() - 1
    snd = torch.randint(2, n, (e,), generator=gen, dtype=torch.int32)
    bond = torch.randint(0, 4, (e,), generator=gen)
    lo = int(ptr[tie_node])
    pairs = (lo + SEG - 1, lo + 2 * SEG - 1)
    for at, sender in zip(pairs, (0, 1)):
        snd[at:at + 2] = sender
        bond[at:at + 2] = 0
    u, v, ef, ke = pretrans_inputs(ptr, snd, n, bond, dev, gen)
    u[0], u[1] = 100.0, -100.0
    return u, v, snd.to(dev), ptr.to(dev), ef, ke, tie_node, pairs


def fused_kernel_phase(graph, dev, flush):
    """K3 and K4 at the flagship step's shapes (N = 19,792, E = 42,368,
    F = 70, Fe = 50; its senders and bond types) and on the hub, against
    their plain versions, with and without edge features, on a ghost sender
    table and with bfloat16 v/ef/ke; timed beside their byte bounds."""
    gen = torch.Generator().manual_seed(2)
    layout = csr_layout(graph.edge_ptr.to(dev), graph.edge_mask.to(dev),
                        senders=graph.senders.to(dev))
    ptr, snd, segs = layout.ptr, layout.senders, layout.segments
    n = ptr.numel() - 1
    bond = graph.edge_feats.squeeze(-1)
    hub_ptr, hub_e = hub_case(dev, gen)
    hub_segs = csr_segments(hub_ptr)
    hub_snd = torch.randint(0, hub_ptr.numel() - 1, (hub_e,), generator=gen,
                            dtype=torch.int32).to(dev)
    hub_bond = torch.randint(0, 4, (hub_e,), generator=gen)
    ghost_snd = snd.clone()
    ghost_snd[::3] = n + torch.randint(0, GHOST, (len(ghost_snd[::3]),),
                                       generator=gen,
                                       dtype=torch.int32).to(dev)
    res = {"csr_pretrans_sketch": {"err": 0.0},
           "csr_pretrans_dmsg": {"err": 0.0}}

    def record(e3, e4):
        res["csr_pretrans_sketch"]["err"] = max(
            res["csr_pretrans_sketch"]["err"], e3)
        res["csr_pretrans_dmsg"]["err"] = max(
            res["csr_pretrans_dmsg"]["err"], e4)

    # the flagship shapes, float32 with edge features: checked and timed
    u, v, ef, ke = pretrans_inputs(ptr, snd, n, bond, dev, gen)
    log(f"kernels[slice] K3/K4 segment table (SEG {SEG}): {segs.n_seg} "
        f"segments of {n} nodes, {segs.n_split} split nodes")
    e3, e4, args4, _ = check_pretrans(u, v, snd, ptr, ef, ke, segs, gen)
    record(e3, e4)
    k3b, k4b = pretrans_bounds(u, v, snd, ptr, ef, ke, True)
    k3b4, _ = pretrans_bounds(u, v, snd, ptr, ef, ke, False)
    t = {
        "k3": time_cuda(lambda: fk.csr_pretrans_sketch(
            u, v, snd, ptr, ef, ke, True, segs), flush),
        "k3_no_ties": time_cuda(lambda: fk.csr_pretrans_sketch(
            u, v, snd, ptr, ef, ke, False, segs), flush),
        "k3_plain": time_cuda(lambda: fk.csr_pretrans_sketch_plain(
            u, v, snd, ptr, ef, ke, True), flush),
        "k4": time_cuda(lambda: fk.csr_pretrans_dmsg(*args4), flush),
        "k4_plain": time_cuda(
            lambda: fk.csr_pretrans_dmsg_plain(*args4[:-1]), flush),
    }
    log(f"kernels[slice] K3/K4 N={n} E={snd.shape[0]} rows="
        f"{int(ptr[-1] - ptr[0])} F={u.shape[1]} Fe={FE} float32: K3 ties "
        f"{t['k3']:.4f} ms (plain {t['k3_plain']:.4f}, bound {k3b[0]:.4f}),"
        f" K3 no ties {t['k3_no_ties']:.4f} ms (bound {k3b4[0]:.4f}), K4 "
        f"{t['k4']:.4f} ms (plain {t['k4_plain']:.4f}, bound {k4b[0]:.4f});"
        f" max err K3 {e3:.3g} K4 {e4:.3g}")
    res["csr_pretrans_sketch"].update(
        ms=t["k3"], plain_ms=t["k3_plain"], bound=k3b,
        ms_no_ties=t["k3_no_ties"], bound_no_ties_ms=k3b4[0])
    res["csr_pretrans_dmsg"].update(ms=t["k4"], plain_ms=t["k4_plain"],
                                    bound=k4b)

    # without edge features, on the ghost table, in bfloat16: checked, and
    # the first and the last timed
    variants = {
        "no edge features": (u, v, snd, ptr, None, None),
        "ghost table": (torch.cat([u, torch.randn(GHOST, u.shape[1],
                                                  generator=gen).to(dev)]),
                        v, ghost_snd, ptr, ef, ke),
        "bfloat16 v/ef/ke": (u, v.bfloat16(), snd, ptr, ef.bfloat16(),
                             ke.bfloat16()),
    }
    for name, a in variants.items():
        e3, e4, args4, _ = check_pretrans(*a, segs, gen)
        record(e3, e4)
        line = f"kernels[slice] K3/K4 {name}: max err K3 {e3:.3g} K4 {e4:.3g}"
        if name != "ghost table":
            b3, b4 = pretrans_bounds(*a, True)
            t3 = time_cuda(lambda: fk.csr_pretrans_sketch(*a, True, segs),
                           flush)
            t4 = time_cuda(lambda: fk.csr_pretrans_dmsg(*args4), flush)
            key = "no_e" if name == "no edge features" else "bf16"
            res["csr_pretrans_sketch"].update(
                {f"ms_{key}": t3, f"bound_{key}_ms": b3[0]})
            res["csr_pretrans_dmsg"].update(
                {f"ms_{key}": t4, f"bound_{key}_ms": b4[0]})
            line += (f"; K3 ties {t3:.4f} ms (bound {b3[0]:.4f}), K4 "
                     f"{t4:.4f} ms (bound {b4[0]:.4f})")
        log(line)

    # whole and split nodes, ties across segment boundaries: float32,
    # bfloat16, and a wider ef (Fe 70)
    mu, mv, msnd, mptr, mef, mke, tie_node, pairs = segment_case(dev, gen)
    msegs = csr_segments(mptr)
    log(f"kernels[segments] N={mptr.numel() - 1} E={msnd.shape[0]}: "
        f"{msegs.n_seg} segments, {msegs.n_split} split nodes in "
        f"{msegs.n_part} segments")
    if msegs.n_split != 4 or msegs.n_part != 3 + 2 + 3 + 32:
        raise AssertionError("segment case: unexpected segment table")
    wide = torch.randn(msnd.shape[0], 70, generator=gen).to(dev)
    for at in pairs:
        wide[at + 1] = wide[at]
    mixed = {
        "float32": (mu, mv, msnd, mptr, mef, mke),
        "bfloat16 v/ef/ke": (mu, mv.bfloat16(), msnd, mptr, mef.bfloat16(),
                             mke.bfloat16()),
        "Fe 70": (mu, mv, msnd, mptr, wide,
                  torch.randn(70, mu.shape[1], generator=gen).to(dev)),
    }
    # the last with the row pointers as the table: no node is split, and
    # the ranges longer than a sub-tile of 64 edges are walked in several
    whole = CSRSegments(seg_ptr=mptr, n_seg=mptr.numel() - 1,
                        n_nodes=mptr.numel() - 1)
    mixed["float32, uncut table"] = mixed["float32"]
    for name, a in mixed.items():
        e3, e4, _, k6 = check_pretrans(
            *a, whole if name.endswith("uncut table") else msegs, gen)
        record(e3, e4)
        if not (bool((k6[4][tie_node] == 2).all())
                and bool((k6[5][tie_node] == 2).all())):
            raise AssertionError(f"segment case ({name}): the ties across "
                                 "segment boundaries were not merged")
        log(f"kernels[segments] K3/K4 {name}: max err K3 {e3:.3g} K4 "
            f"{e4:.3g}; ties across boundaries merged")

    # the hub, float32 with edge features: checked, run twice, timed
    hu, hv, hef, hke = pretrans_inputs(hub_ptr, hub_snd,
                                       hub_ptr.numel() - 1, hub_bond, dev,
                                       gen)
    a = (hu, hv, hub_snd, hub_ptr, hef, hke)
    e3, e4, args4, k6 = check_pretrans(*a, hub_segs, gen)
    record(e3, e4)
    again = (fk.csr_pretrans_sketch(*a, True, hub_segs),
             fk.csr_pretrans_dmsg(*args4))
    first = (k6, fk.csr_pretrans_dmsg(*args4))
    torch.cuda.synchronize()
    for x, y in zip(first[0] + first[1], again[0] + again[1]):
        if not torch.equal(x, y):
            raise AssertionError("hub: two runs of K3/K4 differ")
    b3, b4 = pretrans_bounds(*a, True)
    t3 = time_cuda(lambda: fk.csr_pretrans_sketch(*a, True, hub_segs), flush)
    t4 = time_cuda(lambda: fk.csr_pretrans_dmsg(*args4), flush)
    res["csr_pretrans_sketch"]["hub_ms"] = t3
    res["csr_pretrans_dmsg"]["hub_ms"] = t4
    log(f"kernels[hub] K3/K4 N={hub_ptr.numel() - 1} E={hub_e} F="
        f"{hu.shape[1]} Fe={FE}, {hub_segs.n_seg} segments, "
        f"{hub_segs.n_split} split nodes in {hub_segs.n_part} segments: K3 "
        f"ties {t3:.4f} ms (bound {b3[0]:.4f}), K4 {t4:.4f} ms (bound "
        f"{b4[0]:.4f}); max err K3 {e3:.3g} K4 {e4:.3g}; two runs equal")
    return res


# the row sum's bfloat16 output is its float32 sum rounded once: against the
# plain version's own rounding of a sum in another order, one bfloat16 step
# (2^-8 of the value) more
BF16_ROUND = 2.0 ** -8


def rowsum_case(name, src, index, n, flush, ptr=None, out_dtype=None,
                timed=False):
    """The row sum of ``src`` by ``index`` into ``n`` rows (``ptr``: the
    row pointers of an index that is sorted; no perm) over the layout's
    keys (the index itself where it is sorted), on the card against its
    plain version within SUM_RTOL of the summed magnitudes (plus one
    bfloat16 rounding for a bfloat16 output; the plain version adds with
    atomics in its last stages) and against index_add_ in float64 alike;
    two launches give the same bits.
    ``timed``: ``ops/timing.py::time_row_sum_case`` (the kernel after a
    dirty and a clean flush, the byte bound with the keys, the plain
    version, index_add_ and the index's sort)."""
    perm, p, keys = timing.row_sum_layout(index, n, ptr)
    out_dtype = src.dtype if out_dtype is None else out_dtype
    got = rowsum.sorted_row_sum(src, perm, p, keys, out_dtype)
    again = rowsum.sorted_row_sum(src, perm, p, keys, out_dtype)
    plain = rowsum.sorted_row_sum_plain(src, perm, p, out_dtype)
    idx = index.long()
    f = src.shape[1]
    exact = torch.zeros((n, f), dtype=torch.float64,
                        device=src.device).index_add_(0, idx, src.double())
    scale = torch.zeros((n, f), device=src.device).index_add_(
        0, idx, src.float().abs())
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"row sum [{name}]: two launches differ")
    r = {}
    for ref_name, ref in (("plain", plain.float()), ("float64", exact)):
        tol = SUM_RTOL * scale.double() + 1e-6
        if out_dtype == torch.bfloat16:
            tol = tol + BF16_ROUND * ref.abs().double()
        d = (got.double() - ref.double()).abs()
        r[f"err_{ref_name}"] = float(d.max())
        if not bool((d <= tol).all()):
            raise AssertionError(f"row sum [{name}]: {ref_name} differs by "
                                 f"{float(d.max())}")
    deg = torch.bincount(idx[(idx >= 0) & (idx < n)], minlength=n)
    r.update(rows=src.shape[0], nodes=n, f=f, src=str(src.dtype),
             out=str(out_dtype), perm=perm is not None,
             max_rows_per_node=int(deg.max()), empty_nodes=int((deg == 0).sum()))
    if timed:
        r.update(timing.time_row_sum_case(src, index, n, ptr, flush))
    log(f"kernels[row sum: {name}] E={src.shape[0]} N={n} F={f} "
        f"{src.dtype} -> {out_dtype}, perm {'yes' if perm is not None else 'none'}"
        f", largest node "
        f"{r['max_rows_per_node']} rows, {r['empty_nodes']} "
        f"empty: max err {r['err_plain']:.3g} (plain), {r['err_float64']:.3g}"
        " (float64); two launches equal" + (
            f"; {r['ms']:.4f} ms, clean L2 {r['clean_ms']:.4f} (bound "
            f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, index_add_ "
            f"{r['library_ms']:.4f}, clean {r['library_clean_ms']:.4f}, sort "
            f"{r['sort_ms']:.4f})" if timed else ""))
    return r


def rowsum_phase(graph, dev, flush):
    """The row-sum kernel against its plain version at the shapes of its
    paths, each timed (``ops/timing.py::row_sum_cases``: the flagship
    step's senders and sorted receivers at F = 70, its atom and bond
    lookups and readout, F = 1; the large-graph CLI's senders, 1M edges
    into 100,000 nodes with a 383,653-edge sender, at F = 64 and 70, and
    its receiver-hub twin, a node of in-degree 200,007, sorted: perm None),
    and, held only, bfloat16 in and out, widths 400 (towered PyG) and 500
    (MNIST) and an index that leaves every other row empty."""
    gen = torch.Generator().manual_seed(12)
    timed = timing.row_sum_cases(graph, dev, gen)

    def rnd(rows, f, dtype=torch.float32):
        return torch.randn(rows, f, generator=gen).to(dev, dtype)

    f = FLAGSHIP['hidden_dim']
    n, e = graph.n_node_pad, graph.n_edge_pad
    snd = graph.senders.to(dev)
    bf = torch.bfloat16
    cases = [(name, src, index, rows, ptr, None, True)
             for name, (src, index, rows, ptr) in timed.items()]
    cases += [
        # name, src, index, rows, sorted index's ptr, out dtype, timed
        ("flagship senders bf16", rnd(e, f, bf), snd, n, None, None, False),
        ("flagship senders bf16 -> f32", rnd(e, f, bf), snd, n, None,
         torch.float32, False),
        ("flagship senders F=400", rnd(e, 400), snd, n, None, None, False),
        ("flagship senders F=500", rnd(e, 500), snd, n, None, None, False),
        ("every other row empty", rnd(e, f), snd * 2, 2 * n, None, None,
         False),
    ]
    res = {"err": 0.0, "cases": {}}
    for name, src, index, rows, ptr, out_dtype, t in cases:
        r = rowsum_case(name, src, index, rows, flush, ptr, out_dtype, t)
        res["err"] = max(res["err"], r["err_plain"])
        res["cases"][name] = r
    del cases, timed
    # the kernels line: the flagship senders (the main path's first row
    # sum), the large-graph senders (hub_) and the receiver hub
    for prefix, name in (("", "flagship senders"),
                         ("hub_", "largegraph senders"),
                         ("receiver_hub_", "receiver hub, sorted")):
        r = res["cases"][name]
        res.update({prefix + k: r[k] for k in
                    ("ms", "clean_ms", "plain_ms", "library_ms", "sort_ms",
                     "bound_ms")})
    r = res["cases"]["flagship senders"]
    res["bound"] = (r["bound_ms"], r["bound_by"])
    if res["cases"]["largegraph senders"]["max_rows_per_node"] < 300_000:
        raise AssertionError("the large-graph senders lost their hub")
    return res


def message_inputs(ptr, f, with_w, dev, gen):
    """(u, v, senders int32, ptr, w or None) of the edge messages over
    ``ptr`` moved MSG_LEAD rows down, with MSG_PAD rows after its last: u
    has GHOST more rows than v (a ghost sender table), and one sender holds
    ~38% of the edges."""
    n = ptr.numel() - 1
    e = int(ptr[-1]) + MSG_LEAD + MSG_PAD
    snd = torch.randint(0, n + GHOST, (e,), generator=gen, dtype=torch.int32)
    snd[torch.rand(e, generator=gen) < 0.38] = 5
    w = torch.randn(e, f, generator=gen) if with_w else None
    return (torch.randn(n + GHOST, f, generator=gen).to(dev),
            torch.randn(n, f, generator=gen).to(dev), snd.to(dev),
            (ptr + MSG_LEAD).to(dev), None if w is None else w.to(dev))


def edge_message_phase(dev):
    """The edge messages (``csr_kernels.csr_edge_message``) against their
    plain version on the card, bit for bit: at the main path's shapes,
    timed beside the byte bound, the plain version and two ``index_select``
    and their sum (``ops/timing.py::time_edge_message``: the large graph's
    layer, 6,250,000 power-law edges into 625,000 nodes at F = 64 without
    the edge term; the flagship and ZINC b128 batches at F = 70 with it and
    their pad rows); then on whole and split nodes (``segment_layout`` and
    the hub) with rows outside every range, a ghost sender table and a
    sender of ~38% of the edges, at F = 1, 33, 64, 70 and 75, with and
    without the edge term, with the cut table and with the row pointers as
    an uncut one, each launched twice."""
    times = timing.time_edge_message(dev)
    for name, t in times.items():
        if not t["equal_to_plain"]:
            raise AssertionError(f"edge messages [{name}]: the kernel differs "
                                 "from its plain version")
        log(f"kernels[edge messages: {name}] E={t['rows']} N={t['nodes']} "
            f"F={t['f']} w={t['w']}: {t['ms']:.4f} ms (clean "
            f"{t['clean_ms']:.4f}), bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f}, two index_select "
            f"and their sum {t['library_ms']:.4f}; equal to plain")
    gen = torch.Generator().manual_seed(17)
    mptr = segment_layout(gen)[0]
    hub_ptr = hub_case(torch.device("cpu"), gen)[0]
    err, cases = 0.0, 0
    for layout, ptr in (("segments", mptr), ("hub", hub_ptr)):
        n = ptr.numel() - 1
        for f in (1, 33, 64, 70, 75):
            for with_w in (False, True):
                u, v, snd, p, w = message_inputs(ptr, f, with_w, dev, gen)
                want = csr_kernels.csr_edge_message_plain(u, v, snd, p, w)
                for table, segs in (
                        ("cut", csr_segments(p)),
                        ("uncut", CSRSegments(seg_ptr=p, n_seg=n,
                                              n_nodes=n))):
                    for _ in range(2):
                        got = csr_kernels.csr_edge_message(u, v, snd, p, w,
                                                           segments=segs)
                        err = max(err, float((got - want).abs().max()))
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"edge messages [{layout} F={f} w={with_w} "
                                f"{table} table]: the kernel differs from "
                                f"its plain version by {err:.3g}")
                    cases += 1
        log(f"kernels[edge messages: {layout}] N={n}, "
            f"{csr_segments(ptr.to(dev)).n_split} split nodes, "
            f"{MSG_LEAD} + {MSG_PAD} rows outside every range: F = 1, 33, 64, "
            "70, 75 with and without w, cut and uncut table, two launches "
            "each equal to plain")
    flag = times["flagship"]
    return dict(err=err, equal_cases=cases, ms=flag["ms"],
                clean_ms=flag["clean_ms"], plain_ms=flag["plain_ms"],
                bound=(flag["bound_ms"], flag["bound_by"]),
                library_ms=flag["library_ms"],
                library_clean_ms=flag["library_clean_ms"],
                shape=dict(rows=flag["rows"], nodes=flag["nodes"],
                           f=flag["f"], w=flag["w"]),
                largegraph_shapes=times["largegraph"],
                zinc_b128=times["zinc_b128"])


GAT_SOURCE = "pna_tpu_torch/csrc/csr_gat_attend.cu"
# the GAT cell's layers: (heads, head width) at 625,000 receivers and
# 6,250,000 power-law edges
GAT_LAYERS = ((4, 256), (6, 121))
GAT_CELL = (625_000, 6_250_000)
GAT_ARGV = ['--model', 'gat', '--d_graph', '1', '--nodes', '100000',
            '--edges', '1000000', '--steps', '12', '--eval_every', '6']


def max_gap(got, want) -> float:
    """The largest ``|got - want|`` over pairs of tensors."""
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


POSTTRANS_SOURCE = "pna_tpu_torch/csrc/scaled_posttrans.cu"
# the kernels against their plain versions: each output tensor's largest
# gap over its largest entry (float32, sums in another order)
POSTTRANS_GAP = 1e-5


def posttrans_phase(dev):
    """The scaled posttrans kernels (``ops/posttrans.py``) alone at the
    large graph's layer and at ZINC's b128 batch's layers
    (``timing.time_posttrans``): forward and backward within POSTTRANS_GAP
    of their plain versions, timed after an L2 flush beside their bounds,
    the plain version and the library's products."""
    res = timing.time_posttrans(dev)
    for name, r in res.items():
        if not r['max_rel_gap'] <= POSTTRANS_GAP:
            raise AssertionError(f"scaled posttrans {name}: gap "
                                 f"{r['max_rel_gap']} to the plain version")
        log(f"kernels[scaled posttrans {name}] N={r['nodes']} "
            f"T={r['towers']} {r['ft']}/{r['fo']}: " + "; ".join(
                f"{way} {r[way]['ms']:.4f} ms (bound {r[way]['bound_ms']:.4f}"
                f" by {r[way]['bound_by']}, plain {r[way]['plain_ms']:.4f}, "
                f"library {r[way]['library_ms']:.4f})"
                for way in ('fwd', 'bwd')) + f"; gap {r['max_rel_gap']:.2e}")
    torch.cuda.empty_cache()
    return res


def posttrans_rows(res, largegraph):
    """The kernels table's rows of the scaled posttrans: the large graph's
    timings, its CLI's launches."""
    csr = largegraph['cli']['csr']
    return [{"name": name, "route": "cuda", "source": POSTTRANS_SOURCE,
             "replaces": None,
             "launches": csr['posttrans_counts'][name],
             "max_rel_gap": max(r['max_rel_gap'] for r in res.values()),
             "ms": res['largegraph'][way]['ms'],
             "plain_ms": res['largegraph'][way]['plain_ms'],
             "bound_ms": res['largegraph'][way]['bound_ms'],
             "bound_by": res['largegraph'][way]['bound_by'],
             "library_ms": res['largegraph'][way]['library_ms'],
             "shapes": {k: dict({key: r[key] for key in
                                 ('nodes', 'towers', 'ft', 'fo')}, **r[way])
                        for k, r in res.items()}}
            for name, way in (("scaled_posttrans_fwd", "fwd"),
                              ("scaled_posttrans_bwd", "bwd"))]


def gat_kernel_case(lay, hw, a_src, a_dst, s_src, s_dst, flush):
    """Both GAT kernels at one layer's shape: bit-equal to their plain
    versions, a second launch bit-equal to the first, timed (L2 flushed)
    beside the byte bounds of ``portbench/counts_gat.py``'s rule (each
    input read once, each output written once)."""
    from pna_tpu_torch.ops import csr_gat as cg
    n, heads = s_dst.shape
    f, e = hw.shape[1] // heads, lay.n_edges
    fwd = cg.csr_gat_attend(hw, s_src, s_dst, lay)
    again = cg.csr_gat_attend(hw, s_src, s_dst, lay)
    plain = cg.csr_gat_attend_plain(hw, s_src, s_dst, lay)
    err = dict(fwd=max_gap(fwd, plain))
    if not all(torch.equal(a, b) and torch.equal(c, a)
               for a, b, c in zip(fwd, plain, again)):
        raise AssertionError(f"csr_gat_attend {heads} x {f}: the kernel "
                             "differs from its plain version or itself")
    del plain, again
    d_out = torch.randn(fwd[0].shape, device=hw.device)
    args = (hw, s_src, s_dst, *fwd, a_src, a_dst, d_out, lay)
    bwd = cg.csr_gat_attend_bwd(*args)
    again = cg.csr_gat_attend_bwd(*args)
    plain = cg.csr_gat_attend_bwd_plain(*args)
    err['bwd'] = max_gap(bwd, plain)
    if not all(torch.equal(a, b) and torch.equal(c, a)
               for a, b, c in zip(bwd, plain, again)):
        raise AssertionError(f"csr_gat_attend_bwd {heads} x {f}: the kernel "
                             "differs from its plain version or itself")
    del plain, again
    rows, hf = lay.n_table * heads * f, heads * f
    fwd_bytes = 4 * (rows + n * hf + lay.n_table * heads + 3 * n * heads
                     + e + n + 1)
    bwd_bytes = 4 * (2 * rows + 2 * n * hf + 2 * lay.n_table * heads
                     + 4 * n * heads + 2 * hf + e + n + 1)
    out = dict(heads=heads, f=f, nodes=n, edges=e, split_senders=lay.n_split)
    for name, fn, nbytes, ops, pfn in (
            ("fwd", lambda: cg.csr_gat_attend(hw, s_src, s_dst, lay),
             fwd_bytes, 2 * (e + n) * hf,
             lambda: cg.csr_gat_attend_plain(hw, s_src, s_dst, lay)),
            ("bwd", lambda: cg.csr_gat_attend_bwd(*args), bwd_bytes,
             4 * (e + n) * hf, lambda: cg.csr_gat_attend_bwd_plain(*args))):
        bound, by = bound_ms(nbytes, ops)
        out[name] = dict(ms=time_cuda(fn, flush, reps=5), bound_ms=bound,
                         bound_by=by, plain_ms=time_cuda(pfn, flush, reps=1),
                         max_abs_err=err[name])
        torch.cuda.empty_cache()
    return out


def gat_phase(dev):
    """The GAT attention kernels (``ops/csr_gat.py``) at the GAT cell's two
    layer shapes (4 x 256 and 6 x 121, 625,000 receivers, 6.25M power-law
    edges with a sender of ~38% of them): bit-equal to their plain
    versions, twice, timed beside their byte bounds; then
    ``cli.train_largegraph.main --model gat --d_graph 1`` on 100,000 nodes
    and 1M edges at the PPI widths: the loss falls, 3 forward launches a
    train step and an evaluation, 3 backward launches a train step, the row
    sum twice a train step (the backward of the halo exchange's send
    gather before the two later layers, whose inputs take a gradient), no
    launch of K1-K4 or the edge messages."""
    from pna_tpu_torch.ops import csr_gat as cg
    flush = flush_buffer(dev)
    cases = []
    for heads, f in GAT_LAYERS:
        case = timing.gat_case(*GAT_CELL, heads, f, dev)
        r = gat_kernel_case(*case, flush)
        cases.append(r)
        log(f"kernels[gat attention {heads} x {f}] N={r['nodes']} "
            f"E={r['edges']} ({r['split_senders']} split senders): forward "
            f"{r['fwd']['ms']:.3f} ms (bound {r['fwd']['bound_ms']:.3f}, "
            f"plain {r['fwd']['plain_ms']:.1f}), backward "
            f"{r['bwd']['ms']:.3f} ms (bound {r['bwd']['bound_ms']:.3f}, "
            f"plain {r['bwd']['plain_ms']:.1f}); equal to plain, twice")
        del case
        torch.cuda.empty_cache()
    del flush
    cg.reset_launch_counts()
    fk.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, hist = train_largegraph_cli.main(GAT_ARGV)
    torch.cuda.synchronize()
    counts, pna = cg.launch_counts(), fk.launch_counts()
    steps, evals = 12, 2
    want = {'csr_gat_attend': 3 * (steps + evals),
            'csr_gat_attend_bwd': 3 * steps}
    want_pna = dict.fromkeys(pna, 0)
    want_pna[ROW_SUM] = 2 * HALO_ROWSUM * steps
    if counts != want or pna != want_pna:
        raise AssertionError(f"largegraph CLI --model gat: launches "
                             f"{counts} and {pna}, expected {want} and "
                             f"{want_pna}")
    losses = [h['train_loss'] for h in hist]
    if not (losses[-1] < losses[0] and all(map(math.isfinite, losses))):
        raise AssertionError(f"largegraph CLI --model gat: train losses "
                             f"{losses}")
    sps = lg_steps_per_s(hist)
    log(f"largegraph CLI --model gat (100k nodes, 1M edges, PPI widths): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, {sps:.2f} steps/s, "
        f"launches {counts}, row sum {pna[ROW_SUM]}")
    cli = dict(first_loss=losses[0], last_loss=losses[-1], steps_per_s=sps,
               launches=counts)
    rows = []
    for name, part, calls in (("csr_gat_attend", "fwd", steps + evals),
                              ("csr_gat_attend_bwd", "bwd", steps)):
        rows.append({
            "name": name, "route": "cuda", "source": GAT_SOURCE,
            "replaces": None, "launches_per_step": counts[name] / calls,
            "max_abs_err": max(c[part]["max_abs_err"] for c in cases),
            "ms": cases[0][part]["ms"],
            "plain_ms": cases[0][part]["plain_ms"],
            "bound_ms": cases[0][part]["bound_ms"],
            "bound_by": cases[0][part]["bound_by"], "library_ms": None,
            "cell_shapes": [dict({k: c[k] for k in ("heads", "f", "nodes",
                                                     "edges")}, **c[part])
                            for c in cases],
            "cli_launches": counts[name]})
    return rows, cli


def same_bits(name, make, run):
    """Two runs of ``run(model)`` (forward, backward and, for a trainer's
    step, the update), each on a model ``make()`` builds from the same
    state, on the same inputs with the same generator state: the loss,
    every parameter, gradient and buffer (the batch-norm statistics) and
    every tensor ``run`` returns beside the loss must be bit-equal
    (``torch.equal``); the tensors that differ are named.  Returns how many
    tensors were held."""
    seen = []
    for _ in range(2):
        model = make()
        loss, extra = run(model)
        torch.cuda.synchronize()
        t = {"loss": torch.as_tensor(float(loss))}
        t.update({f"param {k}": p.detach().clone()
                  for k, p in model.named_parameters()})
        t.update({f"grad {k}": p.grad.detach().clone()
                  for k, p in model.named_parameters() if p.grad is not None})
        t.update({f"buffer {k}": b.detach().clone()
                  for k, b in model.named_buffers()})
        t.update({k: v.detach().clone() for k, v in extra.items()})
        seen.append(t)
        del model
    a, b = seen
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or set(a) != set(b):
        raise AssertionError(f"determinism[{name}]: two runs differ in "
                             f"{differ or sorted(set(a) ^ set(b))}")
    log(f"determinism[{name}]: two runs from the same state give the same "
        f"bits in all {len(a)} tensors (loss, parameters, gradients, "
        f"buffers{', ' + ', '.join(extra) if extra else ''})")
    return len(a)


def determinism_phase(ds, graph, labels, state, dev):
    """The flagship step on csr and csr_fused, float32 and bfloat16: two
    forward-and-backward passes from the same weights on the same batch
    give the same bits (``same_bits``)."""
    g_dev, y_dev = graph.to(dev), labels.to(dev)
    res = {}
    for kernel in ('csr', 'csr_fused'):
        for cdt in (torch.float32, torch.bfloat16):
            kw = dict(FLAGSHIP, num_atom_type=ds.num_atom_type,
                      num_bond_type=ds.num_bond_type, avg_d=ds.avg_d(),
                      kernel=kernel, compute_dtype=cdt,
                      max_degree=graph.max_in_degree)

            def make():
                model = PNANetMolecules(**kw, device=dev)
                model.load_state_dict(state)
                return model

            name = f"flagship {kernel} {'bf16' if cdt == torch.bfloat16 else 'f32'}"
            res[name] = same_bits(name, make, lambda m: (
                loss_and_grads(m, g_dev, y_dev), {}))
    return res


def grads(model):
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def rel_norm(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def compare_step(model, cpu_model, g_dev, y_dev, graph, labels, bf16):
    """One step on the card against the same weights on the CPU: loss,
    every gradient and the batch-norm statistics.  Returns the card's
    loss."""
    l_dev = float(loss_and_grads(model, g_dev, y_dev))
    l_cpu = float(loss_and_grads(cpu_model, graph, labels))
    loss_tol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    if not abs(l_dev - l_cpu) <= loss_tol * abs(l_cpu):
        raise AssertionError(f"loss card {l_dev} vs cpu {l_cpu}")
    gd, gc = grads(model), grads(cpu_model)
    worst = 0.0
    for k in gc:
        if bf16:
            r = rel_norm(gd[k], gc[k])
        else:
            scale = float(gc[k].abs().max())
            r = float((gd[k] - gc[k]).abs().max()) / max(scale, 1e-12)
        worst = max(worst, r)
        if r > (BF16_GRAD_TOL if bf16 else GRAD_TOL):
            raise AssertionError(f"gradient {k} disagrees: {r:.3g}")
    sd, sc = model.state_dict(), cpu_model.state_dict()
    for k in sc:
        if "running" not in k:
            continue
        ok = (rel_norm(sd[k].cpu(), sc[k]) <= BF16_GRAD_TOL if bf16 else
              torch.allclose(sd[k].cpu(), sc[k], rtol=1e-4, atol=1e-5))
        if not ok:
            raise AssertionError(f"batch-norm statistic {k} disagrees")
    how = "relative norm error" if bf16 else "error of its max"
    log(f"  card step matches CPU step: loss {l_dev:.6f} vs {l_cpu:.6f}, "
        f"worst gradient {how} {worst:.3g} (tolerance "
        f"{BF16_GRAD_TOL if bf16 else GRAD_TOL})")
    return l_dev


def run_steps(model, g_dev, y_dev, kernel, card, graph):
    """TRAIN_STEPS Adam steps: the loss is finite and falls, and only the
    backend's kernels launch, 4 times per step each, with the row sum's
    ``rowsum_per_step`` launches."""
    opt = make_optimizer(model)
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(model, opt, g_dev, y_dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = fk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  losses {[round(x, 5) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    want = want_launches(kernel, N_LAYERS * TRAIN_STEPS,
                         rowsum_per_step(kernel, N_LAYERS) * TRAIN_STEPS,
                         N_LAYERS * TRAIN_STEPS if kernel == 'csr' else 0)
    if counts != want:
        raise AssertionError(f"launches {counts} in {TRAIN_STEPS} steps, "
                             f"expected {want}")
    n_edges = int(graph.edge_mask.sum())
    n_nodes = int(graph.node_mask.sum())
    step_s = statistics.median(times[TIMED_FROM:])
    stats = dict(step_ms=step_s * 1e3, edges_per_s=n_edges * N_LAYERS / step_s,
                 peak_mib=peak, counts=counts)
    log(f"  {TRAIN_STEPS} steps, launches {counts}; median step "
        f"{step_s * 1e3:.3f} ms (steps {TIMED_FROM}..{TRAIN_STEPS - 1}, "
        f"min {min(times[TIMED_FROM:]) * 1e3:.3f}, max "
        f"{max(times[TIMED_FROM:]) * 1e3:.3f}); {n_nodes} nodes, {n_edges} "
        f"edges; {stats['edges_per_s']:.1f} edges/s on {card}; peak device "
        f"memory {peak:.1f} MiB")
    stats['profile'] = profile_steps(
        lambda: train_step(model, opt, g_dev, y_dev), step_s * 1e3)
    return stats, opt


def train_phase(ds, graph, labels, dev, card, kernel, cdt, state):
    """The flagship step on one backend and compute dtype, from ``state``:
    card against CPU, then timed steps and a profile."""
    bf16 = cdt == torch.bfloat16
    log(f"train[{kernel}, {'bfloat16' if bf16 else 'float32'}]:")
    kw = dict(FLAGSHIP, num_atom_type=ds.num_atom_type,
              num_bond_type=ds.num_bond_type, avg_d=ds.avg_d(), kernel=kernel,
              compute_dtype=cdt, max_degree=graph.max_in_degree)
    model = PNANetMolecules(**kw, device=dev)
    cpu_model = PNANetMolecules(**kw, device='cpu')
    model.load_state_dict(state)
    cpu_model.load_state_dict(state)
    g_dev, y_dev = graph.to(dev), labels.to(dev)
    first = compare_step(model, cpu_model, g_dev, y_dev, graph, labels, bf16)
    stats, opt = run_steps(model, g_dev, y_dev, kernel, card, graph)
    stats["first_loss"] = first
    return stats, (model, opt, g_dev, y_dev)


def interleaved_steps(trainers, rounds=2, block=3):
    """Median step ms of each configuration, timed in blocks of ``block``
    steps in the order A B C D D C B A (``rounds`` times), so that drift of
    the shared host falls on every configuration alike."""
    names = list(trainers)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            model, opt, g_dev, y_dev = trainers[name]
            for _ in range(block):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(model, opt, g_dev, y_dev)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
    return {name: statistics.median(t) * 1e3 for name, t in times.items()}


# device kernels of index_add_ (the gathers' backward and segment sums
# before the row sum) and of the index sorts (torch.sort's radix and small
# sorts; not searchsorted, not the row sum's own)
INDEX_ADD_NAMES = ('indexFuncLargeIndex', 'indexFuncSmallIndex',
                   'index_add')


def kernel_census(rows):
    """Per step, from a profile's (name, ms, launches) rows: the index_add_
    and sort kernels and the row sum's ms."""
    def is_sort(name):
        low = name.lower()
        return 'sort' in low and 'searchsorted' not in low \
            and ROW_SUM not in name
    return dict(
        index_add_kernels=sum(c for k, _, c in rows
                              if any(n in k for n in INDEX_ADD_NAMES)),
        sort_kernels=sum(c for k, _, c in rows if is_sort(k)),
        rowsum_ms=sum(ms for k, ms, _ in rows if f"{ROW_SUM}_" in k))


def profile_steps(step_fn, step_ms, steps=3):
    """Device time of ``steps`` calls of ``step_fn``, by kernel
    (torch.profiler); returns the device kernel ms and kernels per step and
    the busy share of ``step_ms``, or None when no device time was
    recorded."""
    with profiling.trace() as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    rows, host = profiling.op_times(prof, steps)
    total = sum(r[1] for r in rows)
    if total == 0:
        log("  profile: no device time recorded (not measured)")
        return None
    log(f"  profile: device kernel time {total:.3f} ms per step; busy share "
        f"{total / step_ms:.3f} of the median step ({step_ms:.3f} ms); "
        f"{sum(r[2] for r in rows)} device kernels per step")
    log("  profile: host ops by self CPU time per step (profiled, so slower "
        "than the timed steps): " + "; ".join(
            f"{key} {ms:.3f} ms x{count}" for key, ms, count in host[:8]))
    # the merge kernels of split nodes never launch on an unsplit batch
    ours = {k: (sum(r[1] for r in rows if f"{k}_" in r[0]),
                sum(r[2] for r in rows if f"{k}_" in r[0])) for k in LAUNCHED}
    log("  profile: " + ", ".join(f"{k} {ms:.4f} ms in {n} launches"
                                  for k, (ms, n) in ours.items())
        + " per step")
    census = kernel_census(rows)
    log(f"  profile: index_add_ kernels {census['index_add_kernels']}, sort "
        f"kernels {census['sort_kernels']} per step")
    for key, ms, count in rows[:12]:
        log(f"  profile:   {ms:8.4f} ms {100 * ms / total:5.1f}%  x{count}  "
            f"{key[:90]}")
    return dict(device_ms=total, kernels=sum(r[2] for r in rows),
                busy=total / step_ms, **census)


def entry_phase(dev):
    forward, (model, graph) = entry()
    cpu_model, _ = entry('cpu')[1]
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    fk.reset_launch_counts()
    out = forward(model, graph)
    torch.cuda.synchronize()
    counts = fk.launch_counts()
    if tuple(out.shape) != (graph.n_graph_pad, 1):
        raise AssertionError(f"entry output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("entry output not finite")
    # K1 and the edge messages per layer, K1 without ties; the row sum for
    # the readout
    if counts != dict(want_launches(rows=ROWSUM_READOUT['sum'],
                                    msg=N_LAYERS),
                      csr_moment_sketch=N_LAYERS):
        raise AssertionError(f"entry launches {counts}")
    ref = forward(cpu_model, graph.to('cpu'))
    err = float((out.cpu() - ref).abs().max())
    if not torch.allclose(out.cpu(), ref, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"entry output differs from CPU by {err}")
    log(f"entry: output {tuple(out.shape)} finite, launches {counts}, max "
        f"diff to CPU {err:.3g}")


def cli_config(cli, name):
    with open(os.path.join(cli.CONFIG_DIR, name)) as f:
        return json.load(f)


def widths(net):
    """Message width T * Ft of the first layers and of the last."""
    def w(divide):
        return net['towers'] * (net['hidden_dim'] // net['towers'] if divide
                                else net['hidden_dim'])
    return w(net['divide_input_first']), w(net['divide_input_last'])


def pipeline_batches():
    """Each CLI's JSON config, a dataset, its first training batch at full
    size and the message widths of its layers: the ZINC CLI's synthetic
    dataset (its seed, batch 128, epoch 0's shuffle), an MNIST-shaped one
    (128 synthetic graphs of 75 superpixels, k = 8 neighbours: 9,600 nodes,
    76,800 edges), the HIV CLI's (128 synthetic molecules of 8 to 30 atoms)
    and the PyG example's (the same molecules, its own shuffle, no filler
    graphs)."""
    out = {}
    zcfg = cli_config(main_molecules, ZINC_CONFIG)
    p = zcfg['params']
    zds = ZincDataset.synthetic(**main_molecules.SYNTHETIC, seed=p['seed'])
    out['zinc'] = (zcfg, zds) + next(batch_iterator(
        zds.train, p['batch_size'], p['seed'], shuffle=True)) + (
        widths(zcfg['net_params']),)
    mcfg = cli_config(main_superpixels, MNIST_CONFIG)
    p = mcfg['params']
    mds = SuperpixelsDataset.synthetic(n_train=p['batch_size'], n_val=1,
                                       n_test=1, seed=p['seed'], n_sp=75)
    out['mnist'] = (mcfg, mds) + next(batch_iterator(
        mds.train, p['batch_size'], p['seed'], shuffle=True)) + (
        widths(mcfg['net_params']),)
    hcfg = cli_config(main_HIV, HIV_CONFIG)
    p = hcfg['params']
    hds = HIVDataset.synthetic(**main_HIV.SYNTHETIC, seed=p['seed'])
    out['hiv'] = (hcfg, hds) + next(batch_iterator(
        hds.train, p['batch_size'], p['seed'], shuffle=True)) + (
        (hcfg['net_params']['hidden_dim'],),)
    p = PYG_CONFIG['params']
    pds = HIVDataset.synthetic(**pyg_example.SYNTHETIC, seed=p['seed'])
    out['pyg'] = (PYG_CONFIG, pds) + next(pyg_example.batches(
        pds.train, p['batch_size'], np.random.RandomState(p['seed']))) + (
        (PYG_CONFIG['net_params']['hidden_dim'],),)
    return out


def with_isolated_atom(records):
    """The records with one atom that no bond reaches appended to the first
    molecule (as a salt's counter-ion is in OGB molecules); returns them
    and that atom's node index in a collated batch."""
    first = dict(records[0])
    n = first['node_feats'].shape[0]
    first['node_feats'] = np.concatenate([first['node_feats'],
                                          first['node_feats'][:1]])
    return [first] + list(records[1:]), n


def pipeline_kernel_phase(batches, dev, flush):
    """K1 (with and without ties) and K2 against their plain versions on
    the first batch of each CLI at the message widths of its config's
    layers, timed beside their byte bounds."""
    gen = torch.Generator().manual_seed(3)
    res = {"csr_moment_sketch": {}, "csr_dmsg": {}}
    err = [0.0, 0.0]
    for kind, (cfg, _, graph, _, fs) in batches.items():
        layout = csr_layout(graph.edge_ptr.to(dev), graph.edge_mask.to(dev),
                            max_in_degree=graph.max_in_degree)
        log(f"kernels[{kind} batch] {int(graph.graph_mask.sum())} graphs, "
            f"{int(graph.node_mask.sum())} nodes, "
            f"{int(graph.edge_mask.sum())} edges, largest in-degree "
            f"{graph.max_in_degree}: {layout.segments.n_split} nodes split "
            f"over {layout.segments.n_part} segments")
        for f in sorted(set(fs)):
            name = f"{kind} F={f}"
            t, e1, e2, _, _ = csr_case(name, layout.ptr, graph.n_edge_pad,
                                       layout.segments, f, dev, gen, flush)
            err = [max(err[0], e1), max(err[1], e2)]
            res["csr_moment_sketch"][name] = dict(
                ms=t["k1"], bound_ms=t["k1_bound"][0],
                ms_no_ties=t["k1_no_ties"],
                bound_no_ties_ms=t["k1_bound4"][0], plain_ms=t["k1_plain"])
            res["csr_dmsg"][name] = dict(ms=t["k2"], bound_ms=t["k2_bound"][0],
                                         plain_ms=t["k2_plain"])
    return res, err


def cli_phase(kind, cli, argv, config, card, best_val=None,
              best_line="Best val", gathers=2, lookups=0):
    """One CLI run on the card through ``cli.main``: the training loss
    falls from the first epoch to the last (finite after one epoch), the
    ``best_line`` prints with a finite best validation metric
    (``best_val(returned)``; the record's ``val_metric`` by default), and
    the kernels launched exactly 4 K1 and 4 K2 times per train step, 4 K1
    per evaluation batch and no K3/K4, and the row sum ``gathers`` times per
    layer of a train step (the gathers' backward: 2 on the fused layers, 1
    on the sparse ones, which gather the senders only), ``lookups`` times
    per train step (the embedding lookups' backward) and the readout's
    launches in every forward.  Returns the launch counts and the per-epoch
    readings."""
    p, n_layers = config['params'], config['net_params']['L']
    epochs = int(argv[argv.index('--epochs') + 1])
    sizes = cli.SYNTHETIC
    eval_batches = epochs * sum(-(-sizes[k] // p['batch_size'])
                                for k in ('n_val', 'n_test'))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'metrics.jsonl')
        out = io.StringIO()
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            best = cli.main(argv + ['--metrics_path', path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fk.launch_counts()
        with open(path) as f:
            hist = [json.loads(line) for line in f]
    best = best['val_metric'] if best_val is None else best_val(best)
    for line in out.getvalue().splitlines():
        log(f"  {kind} cli| {line}")
    steps = sum(h['train_steps'] for h in hist)
    readout = ROWSUM_READOUT[config['net_params'].get('readout', 'mean')]
    want = {"csr_moment_sketch": n_layers * (steps + eval_batches),
            "csr_dmsg": n_layers * steps, "csr_pretrans_sketch": 0,
            "csr_pretrans_dmsg": 0,
            ROW_SUM: (gathers * n_layers + readout + lookups) * steps
            + readout * eval_batches,
            # the fused layers (2 gathers) build their messages with it
            MSG: (n_layers * (steps + eval_batches) if gathers == 2
                  else 0)}
    if counts != want:
        raise AssertionError(f"{kind} cli launches {counts}, expected {want} "
                             f"({steps} train steps, {eval_batches} "
                             "evaluation batches)")
    losses = [h['train_loss'] for h in hist]
    if (len(hist) != epochs or not all(map(math.isfinite, losses))
            or (epochs > 1 and not losses[-1] < losses[0])):
        raise AssertionError(f"{kind} cli: train loss did not fall: "
                             f"{losses}")
    if best_line not in out.getvalue() or not math.isfinite(best):
        raise AssertionError(f"{kind} cli: no finite best val metric")
    train_s = sum(h['train_s'] for h in hist)
    row = dict(
        epochs=epochs, wall_s=wall,
        epoch_s=[h['epoch_s'] for h in hist],
        train_steps=steps, eval_batches=eval_batches,
        steps_per_s=steps / train_s,
        collate_share=sum(h['collate_s'] for h in hist) / train_s,
        sync_share=sum(h['sync_s'] for h in hist) / train_s,
        train_loss=[h['train_loss'] for h in hist],
        best_val=best, launches=counts)
    log(f"pipeline[{kind}] {epochs} epochs in {wall:.2f} s on {card}: "
        f"seconds per epoch {[round(x, 3) for x in row['epoch_s']]}; "
        f"{steps} train steps at {row['steps_per_s']:.2f} steps/s of the "
        f"training passes; batch_iterator collation "
        f"{row['collate_share']:.3f} and the per-step loss read "
        f"{row['sync_share']:.3f} of them; train loss "
        f"{[round(x, 5) for x in row['train_loss']]}; best val "
        f"{best:.4f}; launches {counts} = {n_layers} x "
        f"({steps} steps + {eval_batches} evaluation batches) for K1, "
        f"{n_layers} x {steps} for K2, ({gathers} x {n_layers} + {readout} "
        f"+ {lookups}) x {steps} + {readout} x {eval_batches} for the row "
        "sum")
    return row


def trainer_step_phase(kind, cli, config, ds, records, dev):
    """The first train step of the CLI's configuration through
    ``RealworldTrainer.run_epoch`` on the same weights and the same batch
    of ``records``, on the card and on the CPU: the loss within LOSS_RTOL
    and every gradient within GRAD_TOL of its largest entry.  A gradient
    that is zero in exact arithmetic holds float noise only: a bias added
    before a batch norm, where graph-norm scales every node alike (a batch
    of graphs of one size, as the superpixel batch is).  So a tensor's
    scale is at least ZERO_GRAD_FLOOR of the largest gradient entry of the
    model."""
    net, p = config['net_params'], config['params']
    cpu_model, fwd = cli.make_model(net, ds, 'cpu', seed=p['seed'])
    model, _ = cli.make_model(net, ds, dev, seed=p['seed'])
    model.load_state_dict(cpu_model.state_dict())
    loss_fn = type(model).loss
    losses = {}
    for where, m in (('card', model), ('cpu', cpu_model)):
        trainer = RealworldTrainer(m, loss_fn, cli.make_config(p),
                                   forward_args=fwd,
                                   device=dev if where == 'card' else 'cpu')
        losses[where], _ = trainer.run_epoch(records[:p['batch_size']], True,
                                             p['seed'])
    worst = hold_step(f"{kind} trainer step", model, cpu_model, losses)
    log(f"trainer[{kind}] first step of the CLI config on the card matches "
        f"the CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f}, worst "
        f"gradient error of its max {worst:.3g} (tolerance {GRAD_TOL})")
    return dict(loss_card=losses['card'], loss_cpu=losses['cpu'],
                worst_grad=worst)


def hold_step(what, model, cpu_model, losses):
    """The card's loss within LOSS_RTOL of the CPU's, and every gradient
    finite and within GRAD_TOL of its scale (at least ZERO_GRAD_FLOOR of the
    model's largest entry, see trainer_step_phase); returns the worst
    gradient error."""
    if not abs(losses['card'] - losses['cpu']) <= LOSS_RTOL * abs(
            losses['cpu']):
        raise AssertionError(f"{what}: loss {losses}")
    worst = 0.0
    floor = ZERO_GRAD_FLOOR * max(float(b.grad.abs().max())
                                  for b in cpu_model.parameters())
    for (k, a), b in zip(model.named_parameters(), cpu_model.parameters()):
        if not (bool(torch.isfinite(a.grad).all())
                and bool(torch.isfinite(b.grad).all())):
            raise AssertionError(f"{what}: gradient {k} is not finite")
        scale = max(float(b.grad.abs().max()), floor)
        r = float((a.grad.cpu() - b.grad.cpu()).abs().max()) / scale
        worst = max(worst, r)
        if r > GRAD_TOL:
            raise AssertionError(f"{what}: gradient {k} {r:.3g}")
    return worst


def pyg_step_phase(ds, graph, labels, dev):
    """The PyG example net's first step (its avg_deg, dropout 0) on its
    first batch, card against CPU on the same weights, held as
    trainer_step_phase holds the trainers' steps."""
    avg_deg = pyg_example.avg_d_from_degree_hist(
        pyg_example.degree_histogram(ds.train))
    models, losses = {}, {}
    for where in ('cpu', 'card'):
        device = dev if where == 'card' else 'cpu'
        m = PNANetPyGExample(avg_deg, dropout=0.0, device=device, seed=0)
        # the weights and batch-norm statistics before the CPU's step (the
        # statistics are the shift of the batch moments)
        if where == 'cpu':
            state = {k: v.clone() for k, v in m.state_dict().items()}
        m.load_state_dict(state)
        m.train()
        g = graph.to(device)
        loss = PNANetPyGExample.loss(m(g, g.node_feats), labels.to(device),
                                     g.graph_mask)
        loss.backward()
        models[where], losses[where] = m, float(loss.detach())
    worst = hold_step("pyg step", models['card'], models['cpu'], losses)
    log(f"trainer[pyg] first step of the example net on the card matches the"
        f" CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f}, worst "
        f"gradient error of its max {worst:.3g} (tolerance {GRAD_TOL})")
    return dict(loss_card=losses['card'], loss_cpu=losses['cpu'],
                worst_grad=worst)


def isolated_phase(config, ds, dev):
    """K1 (with and without ties) and K2 against their plain versions on the
    HIV CLI's batch with an isolated atom, at the config's width: K1's max
    and min are 0 at that atom, as the segment reductions give; the CSR
    bank's forward and message gradient on the card (K1 with ties, K2)
    finite and equal to the CPU's (plain versions).  Returns (K1 error, K2
    error, the batch's records)."""
    net, p = config['net_params'], config['params']
    recs, iso = with_isolated_atom(ds.train[:p['batch_size']])
    graph, _ = collate_records(recs)
    layout = layout_from_graph(graph.to(dev))
    if float(layout.deg[iso]) != 0 or not bool(graph.node_mask[iso]):
        raise AssertionError("isolated atom: not a real node of in-degree 0")
    gen = torch.Generator().manual_seed(4)
    f = net['hidden_dim']
    msg = make_messages(graph.n_edge_pad, f, dev, gen)
    e1, e2, _, kern6 = check_csr(msg, layout.ptr, layout.segments, gen,
                                 "hiv isolated")
    if not (bool((kern6[2][iso] == 0).all())
            and bool((kern6[3][iso] == 0).all())):
        raise AssertionError("isolated atom: K1's max or min is not 0")
    aggs = tuple(net['aggregators'].split())
    out = {}
    for where in ('card', 'cpu'):
        g = graph.to(dev if where == 'card' else 'cpu')
        m = msg.to(g.edge_mask.device).detach().requires_grad_(True)
        z = csr_bank.csr_raw_bank(m, layout_from_graph(g), aggs)
        torch.sin(z).sum().backward()
        out[where] = (z.detach().cpu(), m.grad.cpu())
    (zc, dc), (zp, dp) = out['card'], out['cpu']
    if not (bool(torch.isfinite(dc).all()) and bool(torch.isfinite(dp).all())
            and torch.allclose(zc, zp, rtol=1e-5, atol=1e-5)
            and torch.allclose(dc, dp, rtol=1e-4, atol=1e-5)):
        raise AssertionError("isolated atom: the bank on the card differs "
                             "from the CPU or is not finite")
    log(f"kernels[hiv isolated] {int(graph.node_mask.sum())} nodes, atom "
        f"{iso} of in-degree 0: K1 max/min 0 there; bank forward and message"
        f" gradient finite, card vs CPU max diff "
        f"{float((zc - zp).abs().max()):.3g}, {float((dc - dp).abs().max()):.3g};"
        f" max err K1 {e1:.3g} K2 {e2:.3g}")
    return e1, e2, recs


def routing_phase(graph, dev):
    """The sparse bank's routing on the card: ``PNALayerSparse`` (75 wide,
    edge features, 5 towers, identity and softmax beside mean/max/min/std)
    and ``PNAConvPyG`` (80 wide, 2 towers, edge features, PyG's unclamped
    var) on the ZINC CLI's first batch, on the card (K1/K2 for the kernels'
    aggregators, plain torch for the rest) against the same weights on the
    CPU (every aggregator in the segment form): the output within rtol
    1e-4, atol 1e-4 and every gradient (weights and input) held as a
    trainer step's; one K1 and one K2 launch per tower (the towered PyG
    messages go to K1 as one [E, T*F] call); the row sum (the per-tower
    layer: each tower's sender and receiver gathers, its in-degree count and
    softmax's max gather, denominator, its gather and weighted sum, 7 a
    tower; the PyG conv: its two gathers of all towers at once)."""
    gen = torch.Generator().manual_seed(5)
    n, e = graph.n_node_pad, graph.n_edge_pad
    scalers = FLAGSHIP['scalers']
    avg_d = {'log': 1.2, 'lin': 2.2}
    cases = {
        "PNALayerSparse": (75, 5, 35, lambda device: PNALayerSparse(
            75, 75, FLAGSHIP['aggregators'] + ('identity', 'softmax'),
            scalers, avg_d, towers=5, edge_features=True, edge_dim=8,
            batch_norm=True, residual=True, device=device)),
        "PNAConvPyG": (80, 1, 2, lambda device: PNAConvPyG(
            80, 80, ('mean', 'var', 'max', 'std'), scalers, avg_d,
            edge_dim=8, towers=2, divide_input=True, device=device)),
    }
    ef = torch.randn(e, 8, generator=gen)
    res = {}
    for name, (width, k1_calls, rows, make) in cases.items():
        h = torch.randn(n, width, generator=gen)
        models, losses, outs, dh = {}, {}, {}, {}
        for where in ('cpu', 'card'):
            device = dev if where == 'card' else 'cpu'
            m = make(device)
            if where == 'cpu':
                state = {k: v.clone() for k, v in m.state_dict().items()}
            m.load_state_dict(state)
            m.train()
            g = graph.to(device)
            x = h.to(device).detach().requires_grad_(True)
            fk.reset_launch_counts()
            out = m(g, x, ef.to(device))
            loss = (torch.sin(out) * g.node_mask[:, None]).sum()
            loss.backward()
            if where == 'card':
                torch.cuda.synchronize()
                counts = fk.launch_counts()
            models[where], losses[where] = m, float(loss.detach())
            outs[where], dh[where] = out.detach().cpu(), x.grad.cpu()
        want = want_launches('csr', k1_calls, rows)
        if counts != want:
            raise AssertionError(f"routing {name}: launches {counts}, "
                                 f"expected {want}")
        if not torch.allclose(outs['card'], outs['cpu'], rtol=1e-4,
                              atol=1e-4):
            raise AssertionError(f"routing {name}: output differs by "
                                 f"{float((outs['card'] - outs['cpu']).abs().max())}")
        worst = hold_step(f"routing {name}", models['card'], models['cpu'],
                          losses)
        r = float((dh['card'] - dh['cpu']).abs().max()) / float(
            dh['cpu'].abs().max())
        if r > GRAD_TOL:
            raise AssertionError(f"routing {name}: input gradient {r:.3g}")
        worst = max(worst, r)
        res[name] = dict(worst_grad=worst, launches=counts)
        log(f"routing[{name}] card (K1/K2 + plain) vs CPU (segment form): "
            f"loss {losses['card']:.6f} vs {losses['cpu']:.6f}, output max "
            f"diff {float((outs['card'] - outs['cpu']).abs().max()):.3g}, "
            f"worst gradient error of its max {worst:.3g}; launches {counts}")
    return res


def resume_phase(dev):
    """Two epochs, then a fresh trainer resumes from latest.ckpt to three,
    against three straight epochs, on a small ZINC configuration with
    dropout (its generator's state is in the checkpoint).  Every sum of
    rows on the card adds in a fixed order (the row-sum kernel), so the
    resumed epoch must equal the straight one: ``==`` on every value."""
    ds = ZincDataset.synthetic(n_train=64, n_val=16, n_test=16, seed=0)
    net = dict(num_atom_type=ds.num_atom_type, num_bond_type=ds.num_bond_type,
               hidden_dim=16, out_dim=16, n_layers=2,
               aggregators=FLAGSHIP['aggregators'],
               scalers=FLAGSHIP['scalers'], avg_d=ds.avg_d(), towers=2,
               divide_input_first=False, edge_feat=True, edge_dim=8,
               dropout=0.1, in_feat_dropout=0.1, device=dev, seed=1)

    def fwd(g):
        return g, g.node_feats.squeeze(-1), g.edge_feats.squeeze(-1)

    def fit(ck, resume, epochs):
        cfg = PipelineConfig(epochs=epochs, batch_size=32, init_lr=5e-3,
                             checkpoint_dir=ck, resume=resume)
        trainer = RealworldTrainer(PNANetMolecules(**net),
                                   PNANetMolecules.loss, cfg,
                                   forward_args=fwd, device=dev)
        return trainer.fit(ds, log_fn=lambda s: None)[2]

    with tempfile.TemporaryDirectory() as tmp:
        straight = fit(os.path.join(tmp, 'a'), False, 3)
        fit(os.path.join(tmp, 'b'), False, 2)
        resumed = fit(os.path.join(tmp, 'b'), True, 3)
    if [h['epoch'] for h in resumed] != [2]:
        raise AssertionError("resume did not start at epoch 2")
    keys = ('train_loss', 'val_loss', 'val_metric', 'test_metric', 'lr')
    worst = max(abs(resumed[0][k] - straight[2][k]) for k in keys)
    if any(resumed[0][k] != straight[2][k] for k in keys):
        raise AssertionError(f"resumed epoch 2 differs by {worst!r}: "
                             f"{resumed[0]} vs {straight[2]}")
    log(f"resume: epoch 2 after a resume from latest.ckpt equals three "
        f"straight epochs on the card: worst difference {worst!r} over "
        f"{', '.join(keys)}")
    return worst


def multitask_cli(kind, cli, epochs, argv, card):
    """One multitask CLI run on the card through ``cli.main``: the training
    loss finite (and falling when it runs more than one epoch), "Test set
    results" printed with a finite loss for every split.  Returns the
    per-epoch readings."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'metrics.jsonl')
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = cli.main(argv + ['--epochs', str(epochs), '--metrics_path',
                                   path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(path) as f:
            hist = [json.loads(line) for line in f]
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  multitask {kind} cli| {line}")
    losses = [h['loss_train'] for h in hist]
    if (len(hist) != epochs or not all(map(math.isfinite, losses))
            or (epochs > 1 and not losses[-1] < losses[0])):
        raise AssertionError(f"multitask {kind}: train loss did not fall: "
                             f"{losses}")
    for split in MT_BUCKETS:
        if (f"Test set results {split}: loss=" not in text
                or not math.isfinite(res['test'][split]['total'])):
            raise AssertionError(f"multitask {kind}: no finite test result "
                                 f"for {split}")
    train_s = sum(h['train_s'] for h in hist)
    steps = sum(h['train_steps'] for h in hist)
    row = dict(epochs=epochs, wall_s=wall,
               epoch_s=[h['epoch_s'] for h in hist], train_steps=steps,
               steps_per_s=steps / train_s, train_loss=losses,
               val_loss=[h['loss_val'] for h in hist],
               test={k: v['total'] for k, v in res['test'].items()})
    log(f"multitask[{kind}] {epochs} epochs in {wall:.2f} s on {card} (the "
        f"test of every split included): seconds per epoch "
        f"{[round(x, 3) for x in row['epoch_s']]} (training pass and "
        f"validation); {steps} train steps at {row['steps_per_s']:.2f} "
        f"steps/s of the training passes; train loss "
        f"{[round(x, 5) for x in losses]}; test loss "
        f"{ {k: round(v, 5) for k, v in row['test'].items()} }")
    return row


def multitask_model(cli, extra, data, path, device):
    args = cli.parser().parse_args(['--data', path] + MT_RECIPE + extra)
    return mt_common.make_model(cli.gnn_args(args), args, data, device), args


def f32_errors(card, cpu, ref, floor):
    """{name: (card error, CPU error)}: each float32 tensor's largest
    difference from the float64 reference tensor, as a share of the
    reference tensor's largest entry (at least ``floor``)."""
    out = {}
    for k, r in ref.items():
        scale = max(float(r.abs().max()), floor)
        out[k] = tuple(float((x[k].double() - r).abs().max()) / scale
                       for x in (card, cpu))
    return out


def hold_f32(what, errs):
    """The card's float32 error against the float64 reference within
    MT_F32_TOL, or within MT_F32_FACTOR times the CPU's float32 error where
    that is larger; returns the worst card and CPU errors."""
    for k, (card, cpu) in errs.items():
        if not card <= max(MT_F32_TOL, MT_F32_FACTOR * cpu):
            raise AssertionError(f"{what}: {k}: float32 card error {card:.3g},"
                                 f" CPU {cpu:.3g} (against float64)")
    return (max(e[0] for e in errs.values()),
            max(e[1] for e in errs.values()))


def multitask_first_step(kind, cli, extra, data, path, dev):
    """The first trainer step (the N = 15 train bucket, 512 graphs) of the
    CLI's model on the card and on the CPU, from the same weights (the CPU
    model's, copied before any step), in float64 and in float32.  Float64:
    loss within LOSS_RTOL and every gradient within GRAD_TOL of its scale
    (``hold_step``).  Float32: the loss within LOSS_RTOL; the gradients'
    largest differences, card vs CPU and each against float64, are
    reported (see MT_F32_TOL)."""
    cpu_model, args = multitask_model(cli, extra, data, path, 'cpu')
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    models, losses = {}, {}
    for where, device, dtype in (('card', dev, torch.float32),
                                 ('cpu', 'cpu', torch.float32),
                                 ('card64', dev, torch.float64),
                                 ('cpu64', 'cpu', torch.float64)):
        m, _ = multitask_model(cli, extra, data, path, device)
        m.load_state_dict(state)
        m.to(dtype)
        trainer = MultitaskTrainer(m, data, mt_common.make_config(args),
                                   device=device)
        bucket = [t.to(dtype) for t in trainer.buckets('train')[0]]
        losses[where] = float(trainer.train_step(*bucket))
        models[where] = m
    worst64 = hold_step(f"multitask {kind} float64 step", models['card64'],
                        models['cpu64'], dict(card=losses['card64'],
                                              cpu=losses['cpu64']))
    if not abs(losses['card'] - losses['cpu']) <= LOSS_RTOL * abs(
            losses['cpu']):
        raise AssertionError(f"multitask {kind} float32 loss {losses}")
    grads = {w: {k: p.grad.detach().cpu().double()
                 for k, p in models[w].named_parameters()}
             for w in models}
    ref = grads['cpu64']
    floor = ZERO_GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    f32 = dict(card_vs_cpu=max(
        float((grads['card'][k] - grads['cpu'][k]).abs().max())
        / max(float(grads['cpu'][k].abs().max()), floor) for k in ref))
    errs = f32_errors(grads['card'], grads['cpu'], ref, floor)
    f32['card_vs_f64'] = max(e[0] for e in errs.values())
    f32['cpu_vs_f64'] = max(e[1] for e in errs.values())
    log(f"multitask[{kind}] first trainer step, card vs CPU: float64 loss "
        f"{losses['card64']:.9f} vs {losses['cpu64']:.9f}, worst gradient "
        f"error of its max {worst64:.3g} (tolerance {GRAD_TOL}); float32 "
        f"loss {losses['card']:.6f} vs {losses['cpu']:.6f} (tolerance "
        f"{LOSS_RTOL}); float32 gradients, worst error of a tensor's max: "
        f"card vs CPU {f32['card_vs_cpu']:.3g}, card vs float64 "
        f"{f32['card_vs_f64']:.3g}, CPU vs float64 {f32['cpu_vs_f64']:.3g} "
        "(reported, see MT_F32_TOL)")
    return dict(loss_card=losses['card'], loss_cpu=losses['cpu'],
                worst_grad_f64=worst64, f32_grad_errors=f32)


def multitask_extrapolation(data, path, dev):
    """The PNA recipe's net in eval mode on the N = 95 bucket (47 layers,
    95 LSTM steps): finite outputs of the expected shapes on the card; the
    first MT_EXTRA_CPU_GRAPHS graphs on the card and on the CPU in float32
    held to the CPU's float64 outputs by ``hold_f32``; the time of the
    card's evaluation."""
    cli, _, extra = MT_CLIS['pna']
    cpu_model, _ = multitask_model(cli, extra, data, path, 'cpu')
    model, _ = multitask_model(cli, extra, data, path, dev)
    model.load_state_dict(cpu_model.state_dict())
    feats, adj = (torch.as_tensor(data[k]['test-(95,100)'][0])
                  for k in ('features', 'adj'))
    n, depth = adj.shape[1], model.depth(adj.shape[1])
    k = MT_EXTRA_CPU_GRAPHS
    model.eval()
    cpu_model.eval()
    with torch.no_grad():
        x, a = feats.to(dev), adj.to(dev)
        model(x, a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, graph = model(x, a)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu32 = cpu_model(feats[:k], adj[:k])
        cpu64 = cpu_model.double()(feats[:k].double(), adj[:k].double())
    b = feats.shape[0]
    if (tuple(nodes.shape), tuple(graph.shape)) != ((b, n, 3), (b, 3)):
        raise AssertionError(f"N = {n} outputs {tuple(nodes.shape)}, "
                             f"{tuple(graph.shape)}")
    if not (bool(torch.isfinite(nodes).all())
            and bool(torch.isfinite(graph).all())):
        raise AssertionError(f"N = {n} outputs not finite")
    names = ('nodes', 'graph')
    errs = f32_errors(dict(zip(names, (nodes[:k].cpu(), graph[:k].cpu()))),
                      dict(zip(names, cpu32)), dict(zip(names, cpu64)),
                      1e-12)
    w_card, w_cpu = hold_f32(f"N = {n} eval", errs)
    log(f"multitask[pna] eval at N = {n} ({b} graphs, {depth} layers, {n} "
        f"LSTM steps) on the card in {ms:.1f} ms: outputs finite; {k} graphs"
        f" in float32 against the CPU's float64: card {w_card:.3g}, CPU "
        f"{w_cpu:.3g} of the largest output")
    return dict(n=n, layers=depth, eval_ms=ms, f32_card_err=w_card,
                f32_cpu_err=w_cpu)


def multitask_profile(data, path, dev, card):
    """The PNA recipe's train step on each train bucket: the median of 5
    timed steps (after 2 warm-up steps) and a profile of 3."""
    cli, _, extra = MT_CLIS['pna']
    model, args = multitask_model(cli, extra, data, path, dev)
    trainer = MultitaskTrainer(model, data, mt_common.make_config(args),
                               device=dev)
    res = {}
    for bucket in trainer.buckets('train'):
        n = bucket[1].shape[1]

        def step():
            trainer.train_step(*bucket)

        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms = statistics.median(times[2:]) * 1e3
        log(f"multitask[pna] train step at N = {n} ({bucket[0].shape[0]} "
            f"graphs, {model.depth(n)} layers): median {step_ms:.3f} ms of 5"
            f" (min {min(times[2:]) * 1e3:.3f}) on {card}")
        res[n] = dict(step_ms=step_ms, profile=profile_steps(step, step_ms))
    return res


def multitask_phase(dev, card):
    """Phase 11 (see the module docstring); returns its readings."""
    fk.reset_launch_counts()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'multitask.pkl')
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            generate_dataset.main(['--out', path, '--buckets',
                                   json.dumps(MT_BUCKETS)])
        res['generate_s'] = time.perf_counter() - t0
        if 'networkx' in sys.modules:
            raise AssertionError("networkx was imported")
        log(f"multitask: dataset generated in {res['generate_s']:.2f} s "
            "without networkx; cut from the JAX split specification (train "
            "10 buckets of 512 graphs at N = 15..24, val 5 of 128, test 5 of "
            "256) to " + "; ".join(
                f"{k} " + ", ".join(f"{c} at N = {n}" for n, c in v)
                for k, v in MT_BUCKETS.items()))
        res['cli'] = {
            kind: multitask_cli(kind, cli, epochs,
                                ['--data', path] + MT_RECIPE + extra, card)
            for kind, (cli, epochs, extra) in MT_CLIS.items()}
        data = load_multitask_dataset(path, print_baseline=False)
        res['first_step'] = {
            kind: multitask_first_step(kind, cli, extra, data, path, dev)
            for kind, (cli, _, extra) in MT_CLIS.items()}
        res['extrapolation'] = multitask_extrapolation(data, path, dev)
        res['profile'] = multitask_profile(data, path, dev, card)
    torch.cuda.synchronize()
    counts = fk.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the multitask phase launched {counts}")
    log(f"multitask: K1 to K4 and the row sum launched {counts} in the "
        "phase")
    res['launches'] = counts
    return res


# ---------------------------------------------------------------------------
# layouts phase: the generic backend, and remat
# ---------------------------------------------------------------------------

LAYOUT_STEPS = 6             # steps of each layout before its profile


def layout_steps(name, model, g_dev, y_dev, want_counts):
    """LAYOUT_STEPS Adam steps from the compared weights: the loss finite
    and falling, the launches of K1 to K4 and the row sum as
    ``want_counts`` per step, the peak memory; then a profile.  Returns the
    readings and the trainer tuple of interleaved_steps."""
    opt = make_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses = [float(train_step(model, opt, g_dev, y_dev))
              for _ in range(LAYOUT_STEPS)]
    torch.cuda.synchronize()
    counts = fk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"layouts[{name}]: losses {losses}")
    want = {k: v * LAYOUT_STEPS for k, v in want_counts.items()}
    if counts != want:
        raise AssertionError(f"layouts[{name}]: launches {counts}, "
                             f"expected {want}")
    log(f"  {LAYOUT_STEPS} steps, losses {[round(x, 5) for x in losses]}; "
        f"launches {counts}; peak device memory {peak:.1f} MiB")
    t0 = time.perf_counter()
    for _ in range(3):
        train_step(model, opt, g_dev, y_dev)
    torch.cuda.synchronize()
    prof = profile_steps(lambda: train_step(model, opt, g_dev, y_dev),
                         (time.perf_counter() - t0) / 3 * 1e3)
    return (dict(peak_mib=peak, counts=counts, losses=losses, profile=prof),
            (model, opt, g_dev, y_dev))


def flagship_layouts(ds, csr_graph, labels, csr, csr_trainer, dev, card):
    """The flagship step on the generic backend (identity added) at full
    width: the card step against the CPU step on the same weights
    (compare_step), its first loss against the same net's on the batch
    without ``edge_ptr`` (the segment form for every aggregator), its
    steps, launches, peak memory and profile, then interleaved with the
    'csr' float32 step."""
    name = 'generic+identity f32'
    ident = FLAGSHIP['aggregators'] + ('identity',)
    kw = dict(FLAGSHIP, aggregators=ident, num_atom_type=ds.num_atom_type,
              num_bond_type=ds.num_bond_type, avg_d=ds.avg_d(),
              kernel='generic')
    state = PNANetMolecules(**kw, device='cpu', seed=0).state_dict()
    # the sparse bank's K1 and K2 per layer on the CSR batch
    counts = want_launches('csr', N_LAYERS,
                           rowsum_per_step('generic', N_LAYERS)
                           + IDENTITY_ROWSUM * N_LAYERS)
    log(f"layouts[{name}]: CSR batch {csr_graph.n_node_pad} nodes, "
        f"{csr_graph.n_edge_pad} edges")
    model = PNANetMolecules(**kw, device=dev)
    cpu_model = PNANetMolecules(**kw, device='cpu')
    for m in (model, cpu_model):
        m.load_state_dict(state)
    g_dev, y_dev = csr_graph.to(dev), labels.to(dev)
    fk.reset_launch_counts()
    first = compare_step(model, cpu_model, g_dev, y_dev, csr_graph, labels,
                         False)
    torch.cuda.synchronize()
    step_counts = fk.launch_counts()
    if step_counts != counts:
        raise AssertionError(f"layouts[{name}]: launches {step_counts}")
    other = PNANetMolecules(**kw, device=dev)
    other.load_state_dict(state)
    ref = float(loss_and_grads(other, dataclasses.replace(g_dev,
                                                          edge_ptr=None),
                               y_dev))
    what = "generic on the batch without edge_ptr"
    del other, cpu_model
    if not abs(first - ref) <= LOSS_RTOL * abs(ref):
        raise AssertionError(f"layouts[{name}]: first loss {first} vs "
                             f"{what} {ref}")
    log(f"  first loss {first:.6f} vs {what} {ref:.6f} (rtol "
        f"{LOSS_RTOL}); launches in the compared step {step_counts}")
    res, trainers = {}, {'csr f32': csr_trainer}
    res[name], trainers[name] = layout_steps(name, model, g_dev, y_dev,
                                             counts)
    res[name].update(first_loss=first, ref_loss=ref,
                     step_launches=step_counts)
    inter = interleaved_steps(trainers)
    res['csr f32'] = dict(peak_mib=csr['stats']['peak_mib'],
                          profile=csr['stats']['profile'])
    log(f"layouts summary on {card} (interleaved median step, blocks of 3 "
        "steps in turns and back, twice; device kernel time and kernels per "
        "step from the profile; busy = device / interleaved step):")
    for key, ms in inter.items():
        r, prof = res[key], res[key]['profile']
        r['step_ms'] = ms
        if prof is not None:
            r['busy'] = prof['device_ms'] / ms
        log(f"  {key:22s} {ms:8.3f} ms  " + (
            f"device {prof['device_ms']:.3f} ms  {prof['kernels']} kernels  "
            f"busy {r['busy']:.3f}  " if prof else "profile not measured  ")
            + f"peak {r['peak_mib']:.1f} MiB")
    return res


def remat_step(ds, graph, labels, state, dev):
    """The 'csr' flagship step with dropout 0.1, remat=True against
    remat=False on the card, same weights and generator seed: loss rtol
    1e-5, gradients within GRAD_TOL of their scale, batch-norm statistics
    rtol 1e-6; K1 launches twice per layer (forward and recompute), K2
    once; the peak memory of both, then both timed interleaved."""
    g_dev, y_dev = graph.to(dev), labels.to(dev)
    out = {}
    for remat in (False, True):
        model = PNANetMolecules(
            **FLAGSHIP, num_atom_type=ds.num_atom_type,
            num_bond_type=ds.num_bond_type, avg_d=ds.avg_d(), dropout=0.1,
            remat=remat, max_degree=graph.max_in_degree, device=dev, seed=0)
        model.load_state_dict(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        loss = float(loss_and_grads(model, g_dev, y_dev))
        torch.cuda.synchronize()
        out[remat] = dict(loss=loss, counts=fk.launch_counts(), model=model,
                          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    plain, rm = out[False], out[True]
    if not abs(rm['loss'] - plain['loss']) <= 1e-5 * abs(plain['loss']):
        raise AssertionError(f"remat loss {rm['loss']} vs {plain['loss']}")
    losses = {'card': rm['loss'], 'cpu': plain['loss']}
    worst = hold_step("remat step", rm['model'], plain['model'], losses)
    for (k, a), b in zip(rm['model'].state_dict().items(),
                         plain['model'].state_dict().values()):
        if "running" in k and not torch.allclose(a, b, rtol=1e-6, atol=0):
            raise AssertionError(f"remat: batch-norm statistic {k}")
    # the recompute launches no row sum: the forward's gathers launch none
    want = dict(want_launches('csr', N_LAYERS,
                              rowsum_per_step('csr', N_LAYERS),
                              2 * N_LAYERS),
                csr_moment_sketch=2 * N_LAYERS)
    if rm['counts'] != want or plain['counts']['csr_moment_sketch'] \
            != N_LAYERS:
        raise AssertionError(f"remat launches {rm['counts']}, plain "
                             f"{plain['counts']}")
    inter = interleaved_steps({
        remat: (out[remat]['model'], make_optimizer(out[remat]['model']),
                g_dev, y_dev) for remat in (False, True)})
    log(f"layouts[remat] csr f32 step, dropout 0.1: loss {rm['loss']:.6f} "
        f"vs {plain['loss']:.6f} without remat; worst gradient error "
        f"{worst:.3g}; statistics within rtol 1e-6; launches {rm['counts']} "
        f"vs {plain['counts']}; peak {rm['peak_mib']:.1f} vs "
        f"{plain['peak_mib']:.1f} MiB; interleaved median step "
        f"{inter[True]:.3f} vs {inter[False]:.3f} ms")
    return dict(loss=rm['loss'], plain_loss=plain['loss'], worst_grad=worst,
                launches=rm['counts'], peak_mib=rm['peak_mib'],
                plain_peak_mib=plain['peak_mib'], step_ms=inter[True],
                plain_step_ms=inter[False])


def layouts_phase(ds, graph, labels, state, runs, csr_trainer, dev, card):
    """Phase 12 of the module docstring."""
    t0 = time.perf_counter()
    csr = dict(stats=runs['csr', torch.float32])
    res = dict(flagship=flagship_layouts(ds, graph, labels, csr,
                                         csr_trainer, dev, card),
               remat=remat_step(ds, graph, labels, state, dev))
    res['seconds'] = time.perf_counter() - t0
    log(f"layouts: phase took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# large-graph phase: the distributed stack on one card, over a 1-rank NCCL
# group

# the large-graph CLI at its defaults (100,000 nodes, 1,000,000 power-law
# edges, feat_dim 8, hidden 64, out 64, 4 layers, 4 towers, mean/max/min/std
# x identity/amplification/attenuation, batch norm), the whole graph on the
# one card
LG_ARGV = ['--d_graph', '1']
LG_LAYERS, LG_HIDDEN = 4, 64
LG_STEPS, LG_EVAL = 30, 10
LG_RESUME_AT = 20
# the trainer's step for the layout constants (ops/layout.py): warm-up and
# timed steps at each edge count
LG_WARM, LG_TIMED = 3, 10
LG_BENCH = (('csr', 1_000_000), ('csr_fused', 1_000_000),
            ('generic', 1_000_000), ('csr', 100_000))
LG_FE = 4                    # --edge_feat_dim of the csr_fused runs
# the width of the edge features K3/K4 read on that path: the net embeds
# them to the hidden width first (DistributedPNANet's embedding_e)
LG_KERNEL_FE = LG_HIDDEN


def lg_exchange(dev):
    """``halo_exchange`` over the 1-rank NCCL group equals the local gather,
    waited for at once and in flight, and its backward equals the gather's."""
    gen = torch.Generator().manual_seed(7)
    nl, h, f = 4096, 512, LG_HIDDEN
    x = torch.randn(nl, f, generator=gen).to(dev).requires_grad_(True)
    idx = torch.randint(0, nl, (1, h), generator=gen,
                        dtype=torch.int32).to(dev)
    mask = (torch.rand(1, h, generator=gen) < 0.7).to(dev)
    want = x[idx.reshape(-1).long()] * mask.reshape(-1, 1).float()
    got = halo_exchange(x, idx, mask, dist.group.WORLD)
    later = halo_exchange(x, idx, mask, dist.group.WORLD, wait=False).wait()
    w = torch.randn(h, f, generator=gen).to(dev)
    g_got, = torch.autograd.grad((got * w).sum(), x)
    g_want, = torch.autograd.grad((want * w).sum(), x)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(later, want)):
        raise AssertionError("the NCCL halo exchange differs from the "
                             "local gather")
    if not torch.allclose(g_got, g_want, rtol=1e-6, atol=1e-6):
        raise AssertionError("the halo exchange's gradient differs")
    log(f"largegraph: NCCL ({dist.get_backend()}, world "
        f"{dist.get_world_size()}) halo exchange of [{h}, {f}] equals the "
        "local gather, in flight too; its gradient equals the gather's")


LG_HUB_LR = 1e-2


def hold_update(what, card, cpu, lr):
    """After one SGD step of rate ``lr`` from the same weights: every
    parameter within ``lr`` x GRAD_TOL of its gradient's scale (as
    ``hold_step`` takes it) plus two float32 roundings of its largest
    entry; returns the worst difference as a share of its bound."""
    floor = ZERO_GRAD_FLOOR * max(float(b.grad.abs().max())
                                  for b in cpu.parameters())
    eps = torch.finfo(torch.float32).eps
    worst = 0.0
    for (k, a), b in zip(card.named_parameters(), cpu.parameters()):
        scale = max(float(b.grad.abs().max()), floor)
        bound = (lr * GRAD_TOL * scale
                 + 2 * eps * float(b.detach().abs().max()))
        d = float((a.detach().cpu() - b.detach()).abs().max())
        if not d <= bound:
            raise AssertionError(f"{what}: updated {k} differs by {d:.3g} "
                                 f"(bound {bound:.3g})")
        worst = max(worst, d / bound)
    return worst


def lg_hub_steps(dev):
    """The dryrun's hub-skewed configuration (``hub_problem``: 2,000 nodes,
    16,000 edges, node 0 the receiver of a fifth, edge features) at one
    part: the trainer's own step (``make_node_train_step``: the loss's
    all-reduce, the loss scale, the gradient all-reduce, the optimiser) on
    the card over the NCCL mesh against the same step on the CPU without
    groups, from the same weights, on csr and csr_fused; the loss, the
    gradients and the updated weights, and the launches of one step.  SGD
    (rate LG_HUB_LR): Adam's first update is the rate times the gradient's
    sign, which a last-place difference of a gradient near zero flips."""
    part, x, labels, efeats, net_kw = hub_problem(1)
    mesh = multihost.hybrid_mesh({'data': 1}, {'graph': 1},
                                 device_type='cuda')
    _, graph_group, _ = mesh_groups(mesh)
    out = {}
    for kernel in ('csr', 'csr_fused'):
        card = DistributedPNANet(kernel=kernel, graph_group=graph_group,
                                 bn_group=dist.group.WORLD, device=dev,
                                 seed=0, **net_kw)
        cpu = DistributedPNANet(kernel=kernel, device='cpu', seed=0,
                                **net_kw)
        losses, counts = {}, None
        for where, net, d, m in (('card', card, dev, mesh),
                                 ('cpu', cpu, 'cpu', None)):
            opt = torch.optim.SGD(net.parameters(), lr=LG_HUB_LR)
            step, _, _ = make_node_train_step(part, m, net, opt,
                                              efeats=efeats)
            xs, ys, ms = (torch.from_numpy(a[0]).to(d)
                          for a in (x, labels, part.node_mask))
            fk.reset_launch_counts()
            losses[where] = step(xs, ys, ms)
            if where == 'card':
                counts = fk.launch_counts()
        worst = hold_step(f"largegraph hub {kernel}", card, cpu, losses)
        worst_w = hold_update(f"largegraph hub {kernel}", card, cpu,
                              LG_HUB_LR)
        # node-level: no readout; the gathers' backward (csr) or d_u, and
        # the halo exchange's send gather
        want = want_launches(kernel, net_kw['n_layers'],
                             (ROWSUM_PER_LAYER[kernel] + HALO_ROWSUM)
                             * net_kw['n_layers'],
                             net_kw['n_layers'] if kernel == 'csr' else 0)
        if counts != want:
            raise AssertionError(f"hub {kernel}: one step launched {counts},"
                                 f" expected {want}")
        log(f"largegraph: the trainer's hub step on {kernel} (max in-degree "
            f"{int(np.diff(part.edge_ptr[0]).max())}): card {losses['card']:.6f}"
            f" vs CPU {losses['cpu']:.6f}, worst gradient error {worst:.3g} "
            f"(tolerance {GRAD_TOL}), worst updated weight {worst_w:.3g} of "
            f"its bound; launches per step {counts}")
        out[kernel] = dict(loss=losses, worst_grad=worst,
                           worst_update=worst_w, counts=counts)
    losses = dryrun_multichip(1)
    log(f"largegraph: dryrun_multichip(1) on the card: {losses}")
    out['dryrun'] = losses
    return out


def lg_pretrans_inputs(ptr, n_u, n_rows, dev, gen):
    """(u [n_u, F], v [N, F], ef [n_rows, LG_KERNEL_FE], ke [LG_KERNEL_FE,
    F]) with tie material: u rows repeat in groups of four senders, ef is
    one of four edge types."""
    n, f = ptr.numel() - 1, LG_HIDDEN
    u = torch.randn(n_u // 4 + 1, f, generator=gen)[torch.arange(n_u) // 4]
    table = torch.randn(4, LG_KERNEL_FE, generator=gen)
    bond = torch.randint(0, 4, (n_rows,), generator=gen)
    return (u.to(dev), torch.randn(n, f, generator=gen).to(dev),
            table[bond].to(dev),
            torch.randn(LG_KERNEL_FE, f, generator=gen).to(dev))


def lg_kernel_cases(dev):
    """K1-K4 against their plain versions at the large-graph path's shapes:
    the CLI's graph (100,000 nodes, 1,000,000 power-law edges) as one sorted
    part, messages of width 64, K3's u from the part's ghost table, and the
    same graph with a fifth of the edges sent to node 0 (a hub of in-degree
    200,000); timed beside their byte bounds."""
    gen = torch.Generator().manual_seed(11)
    flush = flush_buffer(dev)
    cfg = LargeGraphConfig()
    send, recv = powerlaw_graph(cfg.num_nodes, cfg.num_edges, seed=cfg.seed,
                                exponent=cfg.exponent)
    hub = recv.copy()
    hub[:cfg.num_edges // 5] = 0
    res = {k: {"err": 0.0} for k in SOURCES}
    for name, r in (("largegraph", recv), ("largegraph_hub", hub)):
        part = sort_partition_edges(partition_edges(send, r, cfg.num_nodes,
                                                    1))
        ptr = torch.from_numpy(part.edge_ptr[0]).to(dev)
        rows = part.edges_per_part
        segs = csr_segments(ptr)
        t, e1, e2, _, _ = csr_case(name, ptr, rows, segs, LG_HIDDEN, dev,
                                   gen, flush, exact=True)
        del t["msg"]
        snd = torch.from_numpy(part.senders_local[0]).to(dev)
        n_u = part.nodes_per_part + part.num_parts * part.halo_size
        u, v, ef, ke = lg_pretrans_inputs(ptr, n_u, rows, dev, gen)
        e3, e4, args, _ = check_pretrans(u, v, snd, ptr, ef, ke, segs, gen,
                                         exact=True)
        k3 = time_cuda(lambda: fk.csr_pretrans_sketch(
            u, v, snd, ptr, ef, ke, True, segs), flush)
        k3_plain = time_cuda(lambda: fk.csr_pretrans_sketch_plain(
            u, v, snd, ptr, ef, ke, True), flush)
        k4 = time_cuda(lambda: fk.csr_pretrans_dmsg(*args), flush)
        k4_plain = time_cuda(lambda: fk.csr_pretrans_dmsg_plain(*args[:-1]),
                             flush)
        b3, b4 = pretrans_bounds(u, v, snd, ptr, ef, ke, True)
        log(f"kernels[{name}] K3 ties {k3:.4f} ms (plain {k3_plain:.4f}, "
            f"bound {b3[0]:.4f}; u {n_u} rows from the ghost table, v "
            f"{ptr.numel() - 1}), K4 {k4:.4f} ms (plain {k4_plain:.4f}, "
            f"bound {b4[0]:.4f}); max err K3 {e3:.3g} K4 {e4:.3g}; "
            f"{segs.n_split} split nodes, max in-degree "
            f"{int(np.diff(part.edge_ptr[0]).max())}")
        hub_case_ = name.endswith("hub")
        pre = "hub_" if hub_case_ else ""
        for k, (ms, plain, bound, err) in {
                "csr_moment_sketch": (t["k1"], t["k1_plain"], t["k1_bound"],
                                      e1),
                "csr_dmsg": (t["k2"], t["k2_plain"], t["k2_bound"], e2),
                "csr_pretrans_sketch": (k3, k3_plain, b3, e3),
                "csr_pretrans_dmsg": (k4, k4_plain, b4, e4)}.items():
            res[k]["err"] = max(res[k]["err"], err)
            res[k].update({pre + "ms": ms, pre + "plain_ms": plain,
                           pre + "bound_ms": bound[0]})
        if not hub_case_:
            res["csr_moment_sketch"]["ms_no_ties"] = t["k1_no_ties"]
        res["shape"] = dict(nodes=cfg.num_nodes, rows=rows, f=LG_HIDDEN,
                            u_rows=n_u, fe=LG_KERNEL_FE)
    return res


# row sums of a large-graph train step and evaluation per layer (node-level:
# no readout): the ROWSUM_PER_LAYER of the fused backends and the backward
# of the halo exchange's send gather (HALO_ROWSUM); 'generic' on the
# unsorted part takes the segment form: in-degree count, mean's sum and
# std's two (4, also in an evaluation) and the two gathers' backward
HALO_ROWSUM = 1
LG_ROWSUM = {'csr': (2 + HALO_ROWSUM, 0), 'csr_fused': (1 + HALO_ROWSUM, 0),
             'generic': (6 + HALO_ROWSUM, 4)}


def lg_expected(kernel, steps, evals):
    """Launches of a large-graph run: K1 (or K3) per layer per train step
    and per evaluation, and on 'csr' the edge messages alike, K2 (or K4)
    per layer per train step, the row sum's (LG_ROWSUM), none other."""
    fwd, bwd = BACKEND_KERNELS.get(kernel, (None, None))
    train, ev = LG_ROWSUM[kernel]
    msg = MSG if kernel == 'csr' else None
    return {k: (LG_LAYERS * (steps + evals) if k in (fwd, msg)
                else LG_LAYERS * steps if k == bwd
                else LG_LAYERS * (train * steps + ev * evals) if k == ROW_SUM
                else 0) for k in LAUNCHED}


def lg_cli(kernel, steps, evals, extra=()):
    """``cli.train_largegraph.main`` at its defaults with ``--d_graph 1``;
    returns its history, launches, the printed lines and the wall time."""
    argv = LG_ARGV + ['--kernel', kernel, '--steps', str(steps),
                      '--eval_every', str(LG_EVAL)] + list(extra)
    fk.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, hist = train_largegraph_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fk.launch_counts()
    lines = buf.getvalue().strip().splitlines()
    losses = [h['train_loss'] for h in hist]
    vals = [h['val_loss'] for h in hist if 'val_loss' in h]
    if len(vals) != evals or not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"largegraph {kernel}: val losses {vals}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"largegraph {kernel}: train losses {losses}")
    return hist, counts, lines, wall


def lg_steps_per_s(hist):
    """Train steps per second of every step but the first, from the steps'
    own times (the trainer's ``StepTimer``; evaluations are outside
    them)."""
    return (len(hist) - 1) / sum(h['step_s'] for h in hist[1:])


def lg_bench(kernel, edges, dev):
    """The trainer's step on one backend at d_graph 1 (the CLI's graph with
    ``edges`` edges): median step ms of LG_TIMED steps after LG_WARM, peak
    device memory, bytes per padded-edge-row byte, and a profile."""
    cfg = LargeGraphConfig(num_edges=edges, d_graph=1, kernel=kernel,
                           edge_feat_dim=LG_FE if kernel == 'csr_fused'
                           else 0)
    mesh = multihost.hybrid_mesh({'data': 1}, {'graph': 1},
                                 device_type='cuda')
    _, graph_group, _ = mesh_groups(mesh)
    part, x, y, tmask, _, efeats, avg_d, k = build_problem(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    net = DistributedPNANet(cfg.feat_dim, hidden_dim=cfg.hidden_dim,
                            out_dim=cfg.out_dim, n_layers=cfg.n_layers,
                            towers=cfg.towers, avg_d=avg_d, kernel=k,
                            edge_features=efeats is not None,
                            edge_dim=cfg.edge_feat_dim, node_level=True,
                            graph_group=graph_group,
                            bn_group=dist.group.WORLD, device=dev, seed=0)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)
    step, _, _ = make_node_train_step(part, mesh, net, opt, efeats=efeats)
    args = [torch.from_numpy(a[0]).to(dev) for a in (x, y, tmask)]
    for _ in range(LG_WARM):
        step(*args)
    times = []
    for _ in range(LG_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)              # returns a float: the loss read syncs
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved()
    row = part.edges_per_part * cfg.hidden_dim * 4
    prof = profile_steps(lambda: step(*args), step_ms)
    r = dict(kernel=k, edges=edges, padded_edges=part.edges_per_part,
             step_ms=step_ms, steps_per_s=1e3 / step_ms,
             edges_per_s=edges * cfg.n_layers / (step_ms / 1e3),
             peak_mib=peak / 2 ** 20, bytes_per_row_byte=peak / row,
             reserved_mib=reserved / 2 ** 20,
             allocated_share=torch.cuda.max_memory_allocated() / reserved,
             device_ms=prof and prof['device_ms'],
             busy=prof and prof['busy'],
             index_add_kernels=prof and prof['index_add_kernels'],
             sort_kernels=prof and prof['sort_kernels'],
             rowsum_ms=prof and prof['rowsum_ms'])
    log(f"largegraph bench[{k}, {edges} edges]: median step {step_ms:.3f} "
        f"ms ({r['steps_per_s']:.2f} steps/s, {r['edges_per_s']:.4g} "
        f"edges/s), device {r['device_ms']} ms, busy {r['busy']}, peak "
        f"{r['peak_mib']:.1f} MiB over the {part.edges_per_part} padded "
        f"edge rows: {r['bytes_per_row_byte']:.2f} bytes per row byte; the "
        f"allocator reserved {r['reserved_mib']:.1f} MiB (peak allocated "
        f"{r['allocated_share']:.3f} of it) of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 20:.0f}")
    return r


def lg_same_bits(dev):
    """The trainer's ``csr`` step as ``lg_bench`` runs it (the CLI's graph,
    1,000,000 edges, d_graph 1, Adam) twice from the same weights
    (``same_bits``: the loss, the updated weights, their gradients and the
    batch-norm statistics)."""
    cfg = LargeGraphConfig(d_graph=1, kernel='csr')
    mesh = multihost.hybrid_mesh({'data': 1}, {'graph': 1},
                                 device_type='cuda')
    _, graph_group, _ = mesh_groups(mesh)
    part, x, y, tmask, _, efeats, avg_d, k = build_problem(cfg)
    args = [torch.from_numpy(a[0]).to(dev) for a in (x, y, tmask)]
    steps = []

    def make():
        net = DistributedPNANet(cfg.feat_dim, hidden_dim=cfg.hidden_dim,
                                out_dim=cfg.out_dim, n_layers=cfg.n_layers,
                                towers=cfg.towers, avg_d=avg_d, kernel=k,
                                node_level=True, graph_group=graph_group,
                                bn_group=dist.group.WORLD, device=dev,
                                seed=0)
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)
        steps.append(make_node_train_step(part, mesh, net, opt)[0])
        return net

    return same_bits("largegraph csr step", make,
                     lambda net: (steps[-1](*args), {}))


def largegraph_phase(dev, card):
    """The distributed stack on one card over a 1-rank NCCL group: the
    exchange, the dryrun's hub configuration card vs CPU, K1-K4 at the
    path's shapes, the large-graph CLI at its defaults on every backend with
    exact launches, a resume, and the readings of ops/layout.py's
    constants."""
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native graph library did not build")
    log(f"largegraph: native library {native.library_path()}")
    multihost.initialize()
    if dist.get_backend() != 'nccl':
        raise AssertionError(f"backend {dist.get_backend()}, not nccl")
    res = {}
    lg_exchange(dev)
    res['hub'] = lg_hub_steps(dev)
    kernels = lg_kernel_cases(dev)
    evals = LG_STEPS // LG_EVAL
    runs = {}
    for kernel, extra in (('csr', []), ('csr_fused',
                                        ['--edge_feat_dim', str(LG_FE)]),
                          ('generic', [])):
        pt.reset_launch_counts()
        hist, counts, lines, wall = lg_cli(kernel, LG_STEPS, evals, extra)
        want = lg_expected(kernel, LG_STEPS, evals)
        if counts != want:
            raise AssertionError(f"largegraph CLI {kernel}: launches "
                                 f"{counts}, expected {want}")
        # the scaled posttrans: once a layer forward (train steps and
        # evaluations) and backward (train steps); generic has its own
        post = pt.launch_counts()
        fused_bank = kernel != 'generic'
        want_post = {
            'scaled_posttrans_fwd': (LG_LAYERS * (LG_STEPS + evals)
                                     if fused_bank else 0),
            'scaled_posttrans_bwd': LG_LAYERS * LG_STEPS if fused_bank
            else 0}
        if post != want_post:
            raise AssertionError(f"largegraph CLI {kernel}: posttrans "
                                 f"launches {post}, expected {want_post}")
        losses = [h['train_loss'] for h in hist]
        if kernel in ('csr', 'csr_fused') and not losses[-1] < losses[0]:
            raise AssertionError(f"largegraph CLI {kernel}: the train loss "
                                 f"did not fall: {losses}")
        sps = lg_steps_per_s(hist)
        runs[kernel] = dict(
            steps_per_s=sps,
            edges_per_s=LargeGraphConfig.num_edges * LG_LAYERS * sps,
            first_loss=losses[0], last_loss=losses[-1],
            val_losses=[h['val_loss'] for h in hist if 'val_loss' in h],
            counts=counts, posttrans_counts=post, wall_s=wall, history=hist)
        log(f"largegraph CLI {kernel}: {LG_STEPS} steps in {wall:.1f} s "
            f"(problem build included), {sps:.2f} train steps/s (steps "
            f"2..{LG_STEPS}, evaluations excluded), train loss {losses[0]:.5f} -> {losses[-1]:.5f},"
            f" val {runs[kernel]['val_losses']}; launches {counts} "
            f"(expected {want}); {lines[-1]}")
    hist, _, lines, _ = lg_cli('auto', 1, 1)
    choice = [l for l in lines if l.startswith('[choose_layout]')]
    if not choice:
        raise AssertionError("--kernel auto printed no choice")
    log(f"largegraph CLI auto: {choice[0]}")
    res['auto_choice'] = choice[0]

    with tempfile.TemporaryDirectory() as tmp:
        lg_cli('csr', LG_RESUME_AT, LG_RESUME_AT // LG_EVAL,
               ['--ckpt_dir', tmp])
        resumed, _, _, _ = lg_cli('csr', LG_STEPS, LG_STEPS // LG_EVAL
                                  - LG_RESUME_AT // LG_EVAL,
                                  ['--ckpt_dir', tmp, '--resume'])
    straight = runs['csr']['history'][LG_RESUME_AT:]
    if [h['step'] for h in resumed] != [h['step'] for h in straight]:
        raise AssertionError("largegraph resume did not start at step "
                             f"{LG_RESUME_AT + 1}")
    pairs = [(a[k], b[k]) for a, b in zip(resumed, straight)
             for k in ('train_loss', 'val_loss') if k in b]
    worst = max(abs(a - b) for a, b in pairs)
    if any(a != b for a, b in pairs):
        raise AssertionError(f"largegraph resume differs by {worst!r}")
    log(f"largegraph: {LG_RESUME_AT} steps and a resume to {LG_STEPS} equal "
        f"{LG_STEPS} straight steps: worst difference {worst!r} over the "
        f"{len(pairs)} train and val losses")
    res['resume_worst'] = worst
    res['bench'] = [lg_bench(k, e, dev) for k, e in LG_BENCH]
    res['same_bits'] = lg_same_bits(dev)
    for r in runs.values():
        r.pop('history')
    res['cli'] = runs
    multihost.shutdown()
    res['seconds'] = time.perf_counter() - t0
    log(f"largegraph: phase took {res['seconds']:.1f} s on {card}")
    return res, kernels


# ---------------------------------------------------------------------------
# sparse path on the power-law graph: the edge-list layers at full width on
# the large-graph CLI's graph, whose senders follow a power law

SP_WARM, SP_TIMED = 2, 5
# the card-vs-CPU check's graph: powerlaw_graph at a tenth of the nodes and
# edges, and its receiver-hub twin
SP_CHECK_NODES, SP_CHECK_EDGES = 10_000, 100_000
SP_SEED = 13
# the cases also held card vs CPU on the full graph that is timed: the
# sender hub's index_add_ (hiv_simple), the towers' K1/K2 at E = 1M and
# F = 75 (zinc_towers) and the receiver hub of in-degree 200,007
# (segment_bank)
SP_FULL_HOLD = ('hiv_simple', 'zinc_towers', 'segment_bank')
# kernels and host ops of x[index]'s backward (index_put_ with accumulate:
# at::native's indexing_backward_kernel family); none may run on the path
INDEX_PUT_NAMES = ('index_put', 'indexing_backward')
# the PyG example net's aggregators and scalers (nn/pyg.py::
# PNANetPyGExample's defaults) at PYG_CONFIG's width
PYG_AGGS = ('mean', 'min', 'max', 'std')
PYG_SCALERS = ('identity', 'amplification', 'attenuation')
SEGMENT_AGGS = ('identity', 'normalised_mean', 'softmax', 'softmin',
                'moment3')


class SegmentBankCase(torch.nn.Module):
    """``aggregate_bank`` over messages ``h[senders] @ w`` with the
    aggregators no kernel computes (the segment form on every device);
    identity's self message is ``h @ w``."""

    def __init__(self, width, scalers, avg_d):
        super().__init__()
        gen = torch.Generator().manual_seed(SP_SEED)
        self.w = torch.nn.Parameter(torch.randn(width, width, generator=gen)
                                    / math.sqrt(width))
        self.scalers, self.avg_d = scalers, avg_d

    def forward(self, graph, h):
        hw = h @ self.w
        msg = gather_rows(hw, graph.senders)
        return aggregate_bank(graph, msg, SEGMENT_AGGS, self.scalers,
                              self.avg_d, self_msg=hw)


def sp_cases():
    """(name, graph kind, input width, K1 and K2 launches per step, row-sum
    launches per step, make (device, avg_d) -> layer) of the phase: the HIV
    config's simple layer (dropout 0), a middle layer of the ZINC config
    (fused_towers=False: a bank per tower), the PyG example's conv,
    PNAConvPyG with 5 towers, the edge-list GCN, GAT and GIN, and the
    segment form of the bank.  The row sums: the backward of each gather of
    a tensor that needs a gradient and each float segment_sum (hiv_simple,
    pyg_simple: the sender gather; zinc_towers: both gathers of 5 towers;
    pyg_towers: both gathers of the towers at once; gcn, gin: the sender
    gather and the sum; gat: two 1-wide logit gathers, the softmax's max
    gather, denominator and its gather, the message gather and the sum;
    segment_bank: the message gather, two degree counts, the two
    receiver-degree gathers' sum, and softmax and softmin five each, and
    moment3's mean gather and two means, as ``ops/aggregators.py`` builds
    them)."""
    hiv = cli_config(main_HIV, HIV_CONFIG)['net_params']
    zinc = cli_config(main_molecules, ZINC_CONFIG)['net_params']
    hw, zw = hiv['hidden_dim'], zinc['hidden_dim']
    pw = PYG_CONFIG['net_params']['hidden_dim']
    h_aggs, h_scal = (tuple(hiv['aggregators'].split()),
                      tuple(hiv['scalers'].split()))
    z_aggs, z_scal = (tuple(zinc['aggregators'].split()),
                      tuple(zinc['scalers'].split()))
    return [
        ('hiv_simple', 'powerlaw', hw, 1, 1, lambda d, a: PNASimpleLayerSparse(
            hw, hw, h_aggs, h_scal, a, batch_norm=hiv['batch_norm'],
            residual=hiv['residual'],
            posttrans_layers=hiv['posttrans_layers'], device=d)),
        ('zinc_towers', 'powerlaw', zw, zinc['towers'], 2 * zinc['towers'],
         lambda d, a: PNALayerSparse(
             zw, zw, z_aggs, z_scal, a, towers=zinc['towers'],
             divide_input=zinc['divide_input_first'],
             graph_norm=zinc['graph_norm'], batch_norm=zinc['batch_norm'],
             residual=zinc['residual'],
             pretrans_layers=zinc['pretrans_layers'],
             posttrans_layers=zinc['posttrans_layers'], device=d)),
        ('pyg_simple', 'powerlaw', pw, 1, 1, lambda d, a: PNAConvSimplePyG(
            pw, pw, PYG_AGGS, PYG_SCALERS, a, device=d)),
        ('pyg_towers', 'powerlaw', pw, 1, 2, lambda d, a: PNAConvPyG(
            pw, pw, PYG_AGGS, PYG_SCALERS, a, towers=5, device=d)),
        ('gcn', 'powerlaw', hw, 0, 2,
         lambda d, a: GCNLayerSparse(hw, hw, device=d)),
        ('gat', 'powerlaw', hw, 0, 7,
         lambda d, a: GATLayerSparse(hw, hw, nheads=1, device=d)),
        ('gin', 'powerlaw', hw, 0, 2,
         lambda d, a: GINLayerSparse(hw, hw, device=d)),
        ('segment_bank', 'hub', hw, 0, 15,
         lambda d, a: SegmentBankCase(hw, h_scal, a).to(d)),
    ]


def sp_graphs(num_nodes, num_edges, cfg):
    """The large-graph CLI's power-law graph at this size (its seed and
    exponent) and its twin with a fifth of the edges sent to node 0, each
    one receiver-sorted graph with ``edge_ptr`` and no edge features, with
    the avg_d of its in-degrees."""
    send, recv = powerlaw_graph(num_nodes, num_edges, seed=cfg.seed,
                                exponent=cfg.exponent)
    hub = recv.copy()
    hub[:num_edges // 5] = 0
    out = {}
    for kind, r in (('powerlaw', recv), ('hub', hub)):
        g = batch_graphs([dict(node_feats=np.zeros((num_nodes, 1),
                                                   np.float32),
                               senders=send, receivers=r)], with_snorm=True)
        deg = np.bincount(r, minlength=num_nodes).astype(np.float64)
        out[kind] = (g, {'lin': float(deg.mean()),
                         'log': float(np.log(deg + 1).mean())})
    return out


def sp_step(model, g, x):
    """One forward and backward of the layer: loss sum(sin(out)) over the
    real nodes."""
    model.zero_grad(set_to_none=True)
    x.grad = None
    out = model(g, x)
    loss = (torch.sin(out) * g.node_mask[:, None]).sum()
    loss.backward()
    return loss


def sp_hold(name, make, width, graph, avg_d, dev):
    """The layer on the card against the same weights on the CPU, on the
    check graph: the loss within LOSS_RTOL and every gradient (weights and
    input) within GRAD_TOL of its scale, as phase 4 holds a step.  Returns
    the card's layer (its weights go on to the timed steps) and the worst
    gradient error."""
    h = torch.randn(graph.n_node_pad, width,
                    generator=torch.Generator().manual_seed(SP_SEED))
    models, losses, dh = {}, {}, {}
    for where in ('cpu', 'card'):
        device = dev if where == 'card' else 'cpu'
        m = make(device, avg_d)
        if where == 'cpu':
            state = {k: v.clone() for k, v in m.state_dict().items()}
        m.load_state_dict(state)
        m.train()
        x = h.to(device).detach().requires_grad_(True)
        losses[where] = float(sp_step(m, graph.to(device), x).detach())
        models[where], dh[where] = m, x.grad.cpu()
    worst = hold_step(f"sparse_powerlaw {name}", models['card'],
                      models['cpu'], losses)
    r = float((dh['card'] - dh['cpu']).abs().max()) / float(
        dh['cpu'].abs().max())
    if not r <= GRAD_TOL:
        raise AssertionError(f"sparse_powerlaw {name}: input gradient "
                             f"{r:.3g}")
    return models['card'], losses, max(worst, r)


def sp_time(name, model, width, k_per_step, rows_per_step, graph, dev):
    """The layer's forward and backward on the full graph: the median of
    SP_TIMED steps after SP_WARM, each ending in torch.cuda.synchronize();
    the launches of those steps (k_per_step K1 and K2 each, no K3/K4,
    rows_per_step row sums), the peak memory, and one profiled step: device
    ms, the top kernels, the index_put-family kernels and host ops, of which
    there must be none, and the index_add_ and sort kernels."""
    g = graph.to(dev)
    x = torch.randn(g.n_node_pad, width,
                    generator=torch.Generator().manual_seed(SP_SEED + 1)
                    ).to(dev).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fk.reset_launch_counts()
    times = []
    for _ in range(SP_WARM + SP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = sp_step(model, g, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = fk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    loss = float(loss.detach())
    if not math.isfinite(loss):
        raise AssertionError(f"sparse_powerlaw {name}: loss {loss}")
    steps = SP_WARM + SP_TIMED
    want = want_launches('csr', k_per_step * steps, rows_per_step * steps)
    if counts != want:
        raise AssertionError(f"sparse_powerlaw {name}: launches {counts} "
                             f"in {steps} steps, expected {want}")
    with profiling.trace() as prof:
        sp_step(model, g, x)
        torch.cuda.synchronize()
    rows, host = profiling.op_times(prof, 1)
    device_ms = sum(r[1] for r in rows)
    put_rows, put_host = ([r for r in x if any(k in r[0]
                                               for k in INDEX_PUT_NAMES)]
                          for x in (rows, host))
    put_ms = sum(r[1] for r in put_rows)
    step_ms = statistics.median(times[SP_WARM:]) * 1e3
    r = dict(step_ms=step_ms, device_ms=device_ms, busy=device_ms / step_ms,
             index_put_kernels=sum(r[2] for r in put_rows),
             index_put_ms=put_ms, index_put_share=put_ms / device_ms,
             peak_mib=peak, launches_per_step=k_per_step,
             rowsum_per_step=rows_per_step, **kernel_census(rows),
             top=[(k[:70], ms, c) for k, ms, c in rows[:5]])
    log(f"sparse_powerlaw[{name}] {int(g.edge_mask.sum())} edges, max "
        f"in-degree {g.max_in_degree}, max out-degree "
        f"{int(g.out_degrees().max())}: median step {step_ms:.3f} ms "
        f"(steps {SP_WARM + 1}..{steps}, min {min(times[SP_WARM:]) * 1e3:.3f},"
        f" max {max(times[SP_WARM:]) * 1e3:.3f}); device {device_ms:.3f} ms "
        f"per step (busy {r['busy']:.3f}); index_put-family kernels "
        f"{r['index_put_kernels']} ({put_ms:.3f} ms, share "
        f"{r['index_put_share']:.3f}); index_add_ kernels "
        f"{r['index_add_kernels']}, sort kernels {r['sort_kernels']}, row "
        f"sum {r['rowsum_ms']:.3f} ms; peak {peak:.1f} MiB; launches "
        f"{counts} = ({k_per_step} K1 + {k_per_step} K2 + {rows_per_step} "
        f"row sums) x {steps} steps")
    for k, ms, c in rows[:5]:
        log(f"  sparse_powerlaw[{name}]   {ms:9.4f} ms "
            f"{100 * ms / device_ms:5.1f}%  x{c}  {k[:90]}")
    if put_rows or put_host:
        raise AssertionError(
            f"sparse_powerlaw {name}: index_put in the step: "
            f"{[(k[:60], c) for k, _, c in put_rows + put_host]}")
    return r, counts


def sp_same_bits(name, make, model, width, graph, avg_d, dev):
    """The layer's forward and backward on the full graph twice from
    ``model``'s weights (``same_bits``, the input's gradient too)."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    g = graph.to(dev)
    h = torch.randn(g.n_node_pad, width,
                    generator=torch.Generator().manual_seed(SP_SEED + 2)
                    ).to(dev)

    def fresh():
        m = make(dev, avg_d)
        m.load_state_dict(state)
        m.train()
        return m

    def run(m):
        x = h.detach().clone().requires_grad_(True)
        return sp_step(m, g, x), {'input grad': x.grad}

    return same_bits(f"sparse_powerlaw {name}", fresh, run)


def sparse_powerlaw_phase(dev, card):
    """The edge-list layers (``sp_cases``) at their configs' widths on the
    large-graph CLI's graph (100,000 nodes, 1,000,000 edges, a sender of
    about 380,000 edges) and on its receiver-hub twin: each held card vs
    CPU on the check graph (SP_FULL_HOLD on the full one too), then timed
    on the full one."""
    t0 = time.perf_counter()
    cfg = LargeGraphConfig()
    full = sp_graphs(cfg.num_nodes, cfg.num_edges, cfg)
    check = sp_graphs(SP_CHECK_NODES, SP_CHECK_EDGES, cfg)
    log(f"sparse_powerlaw: graphs built in {time.perf_counter() - t0:.1f} s"
        f"; the full graph's largest out-degree "
        f"{int(full['powerlaw'][0].out_degrees().max())}, the hub twin's "
        f"largest in-degree {full['hub'][0].max_in_degree}")
    res, launches = {}, {}
    for name, kind, width, k_per_step, rows, make in sp_cases():
        graph, avg_d = full[kind]
        held = {}
        for size, g in (('check', check[kind][0]), ('full', graph)):
            if size == 'full' and name not in SP_FULL_HOLD:
                continue
            t1 = time.perf_counter()
            model, losses, worst = sp_hold(name, make, width, g, avg_d, dev)
            held[size] = dict(loss=losses, worst_grad=worst)
            log(f"sparse_powerlaw[{name}] card vs CPU on the {kind} {size} "
                f"graph ({int(g.edge_mask.sum())} edges): loss "
                f"{losses['card']:.6f} vs {losses['cpu']:.6f}, worst "
                f"gradient error of its scale {worst:.3g} (tolerance "
                f"{GRAD_TOL}), {time.perf_counter() - t1:.1f} s")
        r, counts = sp_time(name, model, width, k_per_step, rows, graph,
                            dev)
        r.update(graph=kind, held=held)
        if name in SP_FULL_HOLD:
            r['same_bits'] = sp_same_bits(name, make, model, width, graph,
                                          avg_d, dev)
        res[name] = r
        launches[name] = counts
        del model
    res['seconds'] = time.perf_counter() - t0
    log(f"sparse_powerlaw: phase took {res['seconds']:.1f} s on {card}")
    return res, launches


# ---------------------------------------------------------------------------
# bench phase: the twin of bench.py (python -m pna_tpu_torch.bench)

# the flagship batch of the twin's defaults (PERF.md section 4)
BENCH_EDGES, BENCH_NODES = 42_356, 19_784
# the interleaved table: (label, kernel, dtype, flat Adam, remat)
BENCH_TABLE = [(f"{k} {dt}", k, dt, True, False)
               for k in ('csr', 'csr_fused', 'auto')
               for dt in ('f32', 'bf16')] + [
    ("generic f32", 'generic', 'f32', True, False),
    ("csr f32 remat", 'csr', 'f32', True, True),
    ("csr f32 per-tensor Adam", 'csr', 'f32', False, False)]
BENCH_WARM, BENCH_BLOCK, BENCH_ROUNDS = 3, 5, 2
# the backend each kernel flag resolves to on the twin's batch, and the
# kernels of its bank: generic's sparse bank takes K1 and K2 on the card
BENCH_RESOLVES = {'csr': 'csr', 'csr_fused': 'csr_fused', 'auto': 'csr',
                  'generic': 'generic'}
BENCH_BANK = {'csr': 'csr', 'csr_fused': 'csr_fused', 'generic': 'csr'}
BENCH_FINITE = ('step_ms', 'edges_per_sec', 'spread_ms',
                'matmul_tflops_per_step', 'device_ms_per_step', 'busy',
                'kernels_per_step')


def bench_launches(kernel, remat, edge_feat=True):
    """K1-K4 and row-sum launches per step of the twin's step on
    ``kernel`` (``edge_feat``: the bond lookup too)."""
    backend = BENCH_RESOLVES[kernel]
    want = want_launches(BENCH_BANK[backend], N_LAYERS, rowsum_per_step(
        backend, N_LAYERS, lookups=1 + edge_feat),
        N_LAYERS if backend == 'csr' else 0)
    if remat:
        want['csr_moment_sketch'] *= 2
        want[MSG] *= 2
    return want


def hold_bench_result(what, r, kernel, remat=False, edge_feat=True):
    """The twin's per-configuration numbers: finite, edges/s = real edges x
    4 / step, the launches per step of the backend, an MFU where the card
    is in the twin's table."""
    bad = [k for k in BENCH_FINITE
           if r[k] is None or not math.isfinite(r[k])]
    bad += [k for k in ('block_ms', 'block_start')
            if not all(math.isfinite(x) for x in r[k])]
    if bad:
        raise AssertionError(f"bench {what}: not finite: {bad}")
    want_eps = BENCH_EDGES * N_LAYERS / (r['step_ms'] / 1e3)
    if abs(r['edges_per_sec'] - want_eps) > 1e-9 * want_eps:
        raise AssertionError(f"bench {what}: edges/s {r['edges_per_sec']} "
                             f"!= {want_eps}")
    want = bench_launches(kernel, remat, edge_feat)
    if r['launches_per_step'] != want:
        raise AssertionError(f"bench {what}: launches per step "
                             f"{r['launches_per_step']}, expected {want}")
    if (torch.cuda.get_device_name(0) in twin.PEAK_FLOPS
            and (r['mfu'] is None or not math.isfinite(r['mfu']))):
        raise AssertionError(f"bench {what}: no MFU on a card of the table")


def bench_defaults():
    """(a) ``python -m pna_tpu_torch.bench`` with no flags, in this process:
    csr, both dtypes, flat Adam, 120 timed steps each."""
    fk.reset_launch_counts()
    out = twin.main([])
    counts = fk.launch_counts()
    d = out['detail']
    if (d['n_edges'], d['n_nodes']) != (BENCH_EDGES, BENCH_NODES):
        raise AssertionError(f"bench: {d['n_edges']} edges, {d['n_nodes']} "
                             f"nodes, expected {BENCH_EDGES}, {BENCH_NODES}")
    if d['backends'] != ['csr'] * N_LAYERS or set(d['results']) != {
            'f32', 'bf16'} or out['vs_baseline'] is not None:
        raise AssertionError(f"bench: unexpected defaults {d['backends']}, "
                             f"{sorted(d['results'])}, {out['vs_baseline']}")
    for name, r in d['results'].items():
        hold_bench_result(f"defaults {name}", r, 'csr')
    steps = sum(r['steps_run'] for r in d['results'].values())
    want = {k: v * steps for k, v in bench_launches('csr', False).items()}
    if counts != want:
        raise AssertionError(f"bench defaults: launches {counts} in {steps} "
                             f"steps, expected {want}")
    log(f"bench defaults: {steps} steps, launches {counts}; csr f32 "
        f"{d['results']['f32']['step_ms']:.3f} ms, bf16 "
        f"{d['results']['bf16']['step_ms']:.3f} ms; headline "
        f"{out['value']:.1f} edges/s on {d['device']}")
    return out, counts


def bench_table(dev, card):
    """(b) every backend of the twin in f32 and bf16, generic, remat and the
    per-tensor Adam, timed in blocks in the order A..Z Z..A, twice."""
    runners = {}
    for label, kernel, dt, flat, remat in BENCH_TABLE:
        r = twin.BenchRunner(1024, True, twin.DTYPES[dt], kernel,
                             flat_opt=flat, remat=remat, device=dev)
        want = [BENCH_RESOLVES[kernel]] * N_LAYERS
        if r.backends() != want:
            raise AssertionError(f"bench {label}: backends {r.backends()}")
        if (r.n_edges, r.n_nodes) != (BENCH_EDGES, BENCH_NODES):
            raise AssertionError(f"bench {label}: {r.n_edges} edges")
        r.warmup(BENCH_WARM)
        runners[label] = r
    labels = list(runners)
    for _ in range(BENCH_ROUNDS):
        for label in labels + labels[::-1]:
            runners[label].time_block(BENCH_BLOCK)
    table = {}
    for label, kernel, dt, flat, remat in BENCH_TABLE:
        r = runners.pop(label)
        rep = r.report()
        hold_bench_result(label, rep, kernel, remat)
        loss = float(r.step())
        if not math.isfinite(loss):
            raise AssertionError(f"bench {label}: loss {loss}")
        rep['median_block_ms'] = statistics.median(rep['block_ms'])
        table[label] = rep
        del r
    log(f"bench table ({BENCH_ROUNDS} x A..Z Z..A blocks of {BENCH_BLOCK} "
        f"steps; step = the minimum block mean; {card}):")
    log("  config | step ms | median block ms | edges/s | spread ms | "
        "device ms | busy | kernels/step | K1 K2 K3 K4 row-sum per step | "
        "MFU")
    for label, r in table.items():
        lps = r['launches_per_step']
        log(f"  {label} | {r['step_ms']:.3f} | {r['median_block_ms']:.3f} | "
            f"{r['edges_per_sec']:.1f} | {r['spread_ms']:.3f} | "
            f"{r['device_ms_per_step']:.3f} | {r['busy']:.3f} | "
            f"{r['kernels_per_step']} | "
            + " ".join(f"{lps[k]:g}" for k in SOURCES)
            + f" | {r['mfu']}")
    for label, r in table.items():
        log(f"  {label}: longest kernels " + "; ".join(
            f"{name[:60]} {ms:.3f} ms x{count}"
            for name, ms, count in r['top_kernels'][:3]))
    return table


def bench_flat_adam(dev, table):
    """(c) the flat Adam on the card: 3 csr f32 steps with FlatAdam and with
    the per-tensor Adam from the same weights and on the same gradients
    (the step's float32 gradients vary in their last bits from run to run:
    atomics), the third step's update timed alone (``time_cuda``: 23 more
    updates of each on those gradients), parameters within 1e-6; the flat
    step's gradients card vs CPU; the kernels per training step of each
    optimiser from the table (b)."""
    flat = twin.build_bench(kernel='csr', flat_opt=True, device=dev)
    per = twin.build_bench(kernel='csr', flat_opt=False, device=dev)
    cpu = twin.build_bench(kernel='csr', flat_opt=True, device='cpu')
    (_, m_f, o_f, (g, y), _, _), (_, m_p, o_p, _, _, _) = flat, per
    _, m_c, o_c, (g_c, y_c), _, _ = cpu
    for a, b in ((m_f, m_p), (m_f, m_c)):
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            if not torch.equal(va.cpu(), vb.cpu()):
                raise AssertionError(f"bench flat Adam: {k} differs at "
                                     "the start")
    if not isinstance(o_f, twin_step.FlatAdam):
        raise AssertionError("bench flat Adam: not a FlatAdam")
    log("bench flat Adam (csr f32, card step vs CPU step):")
    opt_ms = {}
    for i in range(3):
        if i == 0:
            compare_step(m_f, m_c, g, y, g_c, y_c, bf16=False)
        else:
            loss_and_grads(m_f, g, y)
        for pf, pp in zip(m_f.parameters(), m_p.parameters()):
            pp.grad = pf.grad.clone()
        if i == 2:
            flush = flush_buffer(dev)
            opt_ms = {'flat': time_cuda(o_f.step, flush),
                      'per_tensor': time_cuda(o_p.step, flush)}
            del flush
        else:
            o_f.step()
            o_p.step()
    worst = max(float((a - b).detach().abs().max())
                for a, b in zip(m_f.parameters(), m_p.parameters()))
    lo = o_f.flat.data_ptr()
    hi = lo + o_f.flat.numel() * o_f.flat.element_size()
    if not all(lo <= p.data_ptr() < hi for p in m_f.parameters()):
        raise AssertionError("bench flat Adam: a parameter left the buffer")
    if not worst <= 1e-6:
        raise AssertionError(f"bench flat Adam: parameters differ from the "
                             f"per-tensor Adam's by {worst:.3g}")
    n_params = len(list(m_p.parameters()))
    steps = {'flat': table['csr f32'],
             'per_tensor': table['csr f32 per-tensor Adam']}
    log(f"  steps on the same gradients: parameters within {worst:.3g} of "
        f"the per-tensor Adam's (tolerance 1e-6); {n_params} tensors, "
        f"{o_f.flat.numel()} parameters")
    for key, r in steps.items():
        log(f"  {key} Adam: one update {opt_ms[key]:.4f} ms (CUDA events); "
            f"the training step (table): {r['kernels_per_step']} kernels, "
            f"{r['device_ms_per_step']:.3f} device ms")
    return dict(worst_param_diff=worst, n_param_tensors=n_params,
                n_params=o_f.flat.numel(), update_ms=opt_ms,
                step_kernels={k: r['kernels_per_step']
                              for k, r in steps.items()})


def bench_variants():
    """(d) the twin's other flags through ``main``: no edge features, and
    80-wide layers in bfloat16; short runs, held like the defaults."""
    res = {}
    for name, argv in (('no_edge_feat', ['--no_edge_feat', '--dtype', 'f32']),
                       ('width_80_bf16', ['--hidden_dim', '80', '--out_dim',
                                           '80', '--edge_dim', '80',
                                           '--dtype', 'bf16'])):
        out = twin.main(argv + ['--iters', '10', '--repeats', '2',
                                '--warmup', '2'])
        for r in out['detail']['results'].values():
            hold_bench_result(name, r, 'csr',
                              edge_feat=name != 'no_edge_feat')
        res[name] = out
    return res


def bench_phase(dev, card):
    """Phase 15 of the module docstring."""
    t0 = time.perf_counter()
    res, parts = {}, {}
    for part, fn in (('defaults', bench_defaults),
                     ('table', lambda: bench_table(dev, card)),
                     ('flat_adam',
                      lambda: bench_flat_adam(dev, res['table'])),
                     ('variants', bench_variants)):
        t = time.perf_counter()
        res[part] = fn()
        parts[part] = time.perf_counter() - t
    res['defaults'], res['defaults_launches'] = res['defaults']
    log("bench: seconds by part " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    res['seconds'] = time.perf_counter() - t0
    log(f"bench: phase took {res['seconds']:.1f} s on {card}")
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    so = build.build()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {so}")
    with open(so + ".log") as f:
        log(f.read().strip())

    ds = ZincDataset.synthetic(n_train=1024, n_val=1, n_test=1, seed=0)
    graph, labels = collate_records(ds.train, with_snorm=True)
    flush = flush_buffer(dev)
    k = kernel_phase(graph, dev, flush)
    k.update(fused_kernel_phase(graph, dev, flush))
    k[ROW_SUM] = rowsum_phase(graph, dev, flush)
    k[MSG] = edge_message_phase(dev)
    post = posttrans_phase(dev)
    batches = pipeline_batches()
    pk, perr = pipeline_kernel_phase(batches, dev, flush)
    hcfg, hds = batches['hiv'][:2]
    ierr1, ierr2, iso_recs = isolated_phase(hcfg, hds, dev)
    k["csr_moment_sketch"]["err"] = max(k["csr_moment_sketch"]["err"],
                                        perr[0], ierr1)
    k["csr_dmsg"]["err"] = max(k["csr_dmsg"]["err"], perr[1], ierr2)
    del flush

    state = PNANetMolecules(
        **FLAGSHIP, num_atom_type=ds.num_atom_type,
        num_bond_type=ds.num_bond_type, avg_d=ds.avg_d(), device='cpu',
        seed=0).state_dict()
    runs, trainers = {}, {}
    for kernel, cdt in (('csr', torch.float32), ('csr_fused', torch.float32),
                        ('csr_fused', torch.bfloat16),
                        ('csr', torch.bfloat16)):
        runs[kernel, cdt], trainers[kernel, cdt] = train_phase(
            ds, graph, labels, dev, card, kernel, cdt, state)
    inter = interleaved_steps(trainers)
    determinism = determinism_phase(ds, graph, labels, state, dev)
    layouts = layouts_phase(ds, graph, labels, state, runs,
                            trainers['csr', torch.float32], dev, card)
    del trainers
    log("train interleaved (blocks of 3 steps, A B C D D C B A twice): "
        "median step " + ", ".join(
            f"{k}/{'bf16' if c == torch.bfloat16 else 'f32'} {ms:.3f} ms"
            for (k, c), ms in inter.items()))
    csr, fused = runs['csr', torch.float32], runs['csr_fused', torch.float32]
    if not (abs(fused["first_loss"] - csr["first_loss"])
            <= LOSS_RTOL * abs(csr["first_loss"])):
        raise AssertionError(f"fused first loss {fused['first_loss']} vs csr "
                             f"{csr['first_loss']}")
    log("train summary (float32, same weights): csr_fused vs csr: first loss "
        f"{fused['first_loss']:.6f} vs {csr['first_loss']:.6f}; median step "
        f"{fused['step_ms']:.3f} vs {csr['step_ms']:.3f} ms; "
        f"{fused['edges_per_s']:.1f} vs {csr['edges_per_s']:.1f} edges/s; "
        f"peak {fused['peak_mib']:.1f} vs {csr['peak_mib']:.1f} MiB")
    for kernel in ('csr_fused', 'csr'):
        b = runs[kernel, torch.bfloat16]
        log(f"train summary (bfloat16, {kernel}): median step "
            f"{b['step_ms']:.3f} ms; {b['edges_per_s']:.1f} edges/s; peak "
            f"{b['peak_mib']:.1f} MiB")
    entry_phase(dev)

    cifar = cli_config(main_superpixels, CIFAR10_CONFIG)
    clis = {
        'zinc': (main_molecules, ['--synthetic', '--epochs', '3'],
                 batches['zinc'][0], dict(lookups=1)),
        'mnist': (main_superpixels, ['--synthetic', '--epochs', '2'],
                  batches['mnist'][0], {}),
        'hiv': (main_HIV, ['--synthetic', '--epochs', '3'], hcfg,
                dict(gathers=1, lookups=OGB_ATOM_COLUMNS)),
        'pyg': (pyg_example, ['--synthetic', '--epochs', '2'], PYG_CONFIG,
                dict(best_val=lambda b: b[0], best_line="Best epoch val",
                     gathers=1, lookups=OGB_ATOM_COLUMNS)),
        'cifar10': (main_superpixels, [
            '--synthetic', '--epochs', '1', '--config',
            os.path.join(main_superpixels.CONFIG_DIR, CIFAR10_CONFIG)],
            cifar, {}),
    }
    pipeline = {kind: cli_phase(kind, cli, argv, cfg, card, **kw)
                for kind, (cli, argv, cfg, kw) in clis.items()}
    for kind, cli in (('zinc', main_molecules), ('mnist', main_superpixels)):
        cfg, ds = batches[kind][:2]
        pipeline[kind]['first_step'] = trainer_step_phase(
            kind, cli, cfg, ds, ds.train, dev)
    # dropout masks come from each device's own generator: the check runs
    # the HIV config without dropout, on the batch with the isolated atom
    no_drop = dict(hcfg, net_params=dict(hcfg['net_params'], dropout=0.0,
                                         in_feat_dropout=0.0))
    pipeline['hiv']['first_step'] = trainer_step_phase(
        'hiv', main_HIV, no_drop, hds, iso_recs, dev)
    pipeline['pyg']['first_step'] = pyg_step_phase(*batches['pyg'][1:4],
                                                   dev)
    routing = routing_phase(batches['zinc'][2], dev)
    resume_worst = resume_phase(dev)
    multitask = multitask_phase(dev, card)
    largegraph, lk = largegraph_phase(dev, card)
    sparse_pl, sparse_launches = sparse_powerlaw_phase(dev, card)
    bench_res = bench_phase(dev, card)
    gat_rows, gat_cli = gat_phase(dev)

    kernels = []
    for name, (src, tpu) in (*SOURCES.items(), (MSG, (MSG_SOURCE, None))):
        r = k[name]
        # the row sum's main path is the flagship 'csr' step's
        backend = ('csr_fused' if name in BACKEND_KERNELS['csr_fused']
                   else 'csr')
        row = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
               "launches": runs[backend, torch.float32]["counts"][name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
               "bound_by": r["bound"][1],
               "library_ms": r.get("library_ms")}
        row.update({key: val for key, val in r.items()
                    if key not in ("err", "ms", "plain_ms", "bound",
                                   "library_ms")})
        row["pipeline_launches"] = {kind: pr["launches"][name]
                                    for kind, pr in pipeline.items()}
        row["pipeline_launches"]["multitask"] = multitask["launches"][name]
        row["pipeline_launches"]["largegraph"] = largegraph["cli"][
            backend]["counts"][name]
        if name in lk:
            row["max_abs_err"] = max(row["max_abs_err"], lk[name]["err"])
            row["largegraph_shapes"] = dict(
                {key: val for key, val in lk[name].items() if key != "err"},
                **lk["shape"])
        if name in pk:
            row["pipeline_shapes"] = pk[name]
        row["sparse_powerlaw_launches"] = {
            case: c[name] for case, c in sparse_launches.items()}
        row["bench_launches"] = bench_res["defaults_launches"][name]
        row["bench_launches_per_step"] = {
            label: r["launches_per_step"][name]
            for label, r in bench_res["table"].items()}
        kernels.append(row)
    kernels += posttrans_rows(post, largegraph) + gat_rows
    summary = {kind: {key: val for key, val in pr.items()
                      if key != "launches"}
               for kind, pr in pipeline.items()}
    multitask.pop("launches")
    log(json.dumps({"kernels": kernels, "card": card, "pipeline": summary,
                    "resume_worst_diff": resume_worst,
                    "routing": routing, "multitask": multitask,
                    "determinism": dict(
                        determinism,
                        largegraph=largegraph['same_bits'],
                        **{f"sparse_powerlaw {c}": sparse_pl[c]['same_bits']
                           for c in SP_FULL_HOLD}),
                    "layouts": layouts, "largegraph": largegraph,
                    "sparse_powerlaw": sparse_pl, "gat_cli": gat_cli,
                    "bench": {k: v for k, v in bench_res.items()
                              if k not in ("defaults", "variants")}},
                   default=str))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
