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
   same bits;
4. train, the flagship ZINC step (PNANetMolecules, L=4, hidden 70, out 60,
   edge_dim 50, towers 5, 1024 synthetic graphs) on one set of weights, in
   four configurations: float32 on ``kernel='csr'`` (K1/K2) and on
   ``kernel='csr_fused'`` (K3/K4), then bfloat16 compute on both.  Each
   takes one step on the card against the same weights on the CPU (loss,
   every gradient, batch-norm statistics), then timed Adam steps whose loss
   must be finite and fall, with exactly 4 launches per step of each kernel
   of its backend and none of the others; then a profiler breakdown of three
   steps by kernel.  The fused step's first loss must equal the CSR step's.
   Then the four are timed again in alternating blocks of steps, so that
   host drift falls on all of them alike;
5. entry: the ``entry()`` twin (no edge features) in eval mode, K1 without
   ties, against the same model on the CPU.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

import json
import math
import statistics
import sys
import time

import torch

from pna_tpu_torch import entry
from pna_tpu_torch.data.molecules import ZincDataset, collate_records
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.ops import build, csr_kernels
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops.csr_bank import csr_layout
from pna_tpu_torch.ops.csr_kernels import SEG, CSRSegments, csr_segments
from pna_tpu_torch.ops.timing import (card_line, flush_buffer, hub_case,
                                      make_messages, time_cuda)
from pna_tpu_torch.train.step import loss_and_grads, make_optimizer, train_step

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FLAGSHIP = dict(hidden_dim=70, out_dim=60, edge_dim=50, edge_feat=True,
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
}

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


def log(*args):
    print(*args, flush=True)


def bound_ms(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(x):
    return 0 if x is None else x.numel() * x.element_size()


def check_sketch(kern, plain, msg, ptr, what="K1"):
    """Max abs error over the outputs of a moment sketch of ``msg``; raises
    outside the tolerance."""
    scale_s = csr_kernels.csr_moment_sketch_plain(msg.abs(), ptr)[0]
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


def check_csr(msg, ptr, segs, gen, what):
    """K1 with and without ties and K2 (every row) against their plain
    versions on one set of inputs; returns (K1 error, K2 error, K2's
    arguments, K1's six outputs)."""
    plain6 = csr_kernels.csr_moment_sketch_plain(msg, ptr, True)
    kern6 = csr_kernels.csr_moment_sketch(msg, ptr, True, segments=segs)
    kern4 = csr_kernels.csr_moment_sketch(msg, ptr, False, segments=segs)
    torch.cuda.synchronize()
    e1 = max(check_sketch(kern6, plain6, msg, ptr),
             check_sketch(kern4, plain6[:4], msg, ptr))
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
        n = ptr.numel() - 1
        msg = make_messages(n_rows, f, dev, gen)
        rows = int(ptr[-1] - ptr[0])
        e1, e2, args, kern6 = check_csr(msg, ptr, segs, gen, name)
        record(e1, e2)
        if name == "hub":       # no atomics, a fixed order: the same bits
            again = (csr_kernels.csr_moment_sketch(msg, ptr, True,
                                                   segments=segs)
                     + (csr_kernels.csr_dmsg(*args, segments=segs),))
            first = kern6 + (csr_kernels.csr_dmsg(*args, segments=segs),)
            torch.cuda.synchronize()
            for x, y in zip(first, again):
                if not torch.equal(x, y):
                    raise AssertionError("hub: two runs of K1/K2 differ")

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
        }
        # K1 reads the real rows and the table's pointers; K2 reads the real
        # rows, the row-to-node array and the node fields and writes every
        # row of d_msg, the rows of no node as 0
        k1_bound = bound_ms(rows * f * 4 + (segs.n_seg + 1) * 4
                            + 6 * n * f * 4, 7 * rows * f)
        k1_bound4 = bound_ms(rows * f * 4 + (segs.n_seg + 1) * 4
                             + 4 * n * f * 4, 5 * rows * f)
        k2_bound = bound_ms(rows * f * 4 + n_rows * 4 + 6 * n * f * 4
                            + n_rows * f * 4, 6 * rows * f)
        log(f"kernels[{name}] N={n} E={n_rows} rows={rows} F={f}, "
            f"{segs.n_seg} segments, {segs.n_split} split nodes: "
            f"K1 ties {t['k1']:.4f} ms (plain {t['k1_plain']:.4f}, bound "
            f"{k1_bound[0]:.4f}), K1 no ties {t['k1_no_ties']:.4f} ms (bound "
            f"{k1_bound4[0]:.4f}), K2 {t['k2']:.4f} ms (plain "
            f"{t['k2_plain']:.4f}, bound {k2_bound[0]:.4f}); max err K1 "
            f"{e1:.3g} K2 {e2:.3g}"
            + ("; two runs equal" if name == "hub" else ""))
        if name == "slice":
            comp = segment_reduce_ms(msg, ptr, flush)
            log(f"kernels[slice] four torch.segment_reduce calls (sum, sum "
                f"of squares, max, min; no tie counts; not one library "
                f"call): {comp:.4f} ms")
            res["csr_moment_sketch"].update(
                ms=t["k1"], plain_ms=t["k1_plain"], bound=k1_bound,
                ms_no_ties=t["k1_no_ties"], bound_no_ties_ms=k1_bound4[0],
                segment_reduce_composition_ms=comp)
            res["csr_dmsg"].update(ms=t["k2"], plain_ms=t["k2_plain"],
                                   bound=k2_bound)
        else:
            res["csr_moment_sketch"].update(hub_ms=t["k1"],
                                            hub_bound_ms=k1_bound[0])
            res["csr_dmsg"].update(hub_ms=t["k2"], hub_bound_ms=k2_bound[0])

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


def check_pretrans(u, v, snd, ptr, ef, ke, segs, gen):
    """K3 with and without ties and K4 against their plain versions on one
    set of inputs (``segs``: the segment table of ``ptr``); returns (K3
    error, K4 error, K4 arguments, K3's six outputs)."""
    msg = fk.pretrans_messages_plain(u, v, snd, ptr, ef, ke)
    plain6 = fk.csr_pretrans_sketch_plain(u, v, snd, ptr, ef, ke, True)
    kern6 = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, True, segs)
    kern4 = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, False, segs)
    torch.cuda.synchronize()
    e3 = max(check_sketch(kern6, plain6, msg, ptr, "K3"),
             check_sketch(kern4, plain6[:4], msg, ptr, "K3"))
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
    backend's kernels launch, 4 times per step each."""
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
    for k, c in counts.items():
        want = N_LAYERS * TRAIN_STEPS if k in BACKEND_KERNELS[kernel] else 0
        if c != want:
            raise AssertionError(f"{k}: {c} launches in {TRAIN_STEPS} steps,"
                                 f" expected {want // TRAIN_STEPS} per step")
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
    profile_steps(model, opt, g_dev, y_dev, step_s * 1e3)
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


def profile_steps(model, opt, graph, labels, step_ms, steps=3):
    """Device time of a few steps, by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(model, opt, graph, labels)
        torch.cuda.synchronize()
    rows, host = [], []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        # kernels only: a record_function range shows up on the device too
        if (str(ev.device_type).endswith("CUDA") and us > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.key, us / steps / 1e3, ev.count // steps))
        elif ev.self_cpu_time_total > 0:
            host.append((ev.key, ev.self_cpu_time_total / steps / 1e3,
                         ev.count // steps))
    total = sum(r[1] for r in rows)
    if total == 0:
        log("  profile: no device time recorded (not measured)")
        return
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    log(f"  profile: device kernel time {total:.3f} ms per step; busy share "
        f"{total / step_ms:.3f} of the median step ({step_ms:.3f} ms); "
        f"{sum(r[2] for r in rows)} device kernels per step")
    log("  profile: host ops by self CPU time per step (profiled, so slower "
        "than the timed steps): " + "; ".join(
            f"{key} {ms:.3f} ms x{count}" for key, ms, count in host[:8]))
    # the merge kernels of split nodes never launch on an unsplit batch
    ours = {k: sum(r[1] for r in rows if f"{k}_" in r[0]) for k in SOURCES}
    log("  profile: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in
                                  ours.items()) + " per step")
    for key, ms, count in rows[:12]:
        log(f"  profile:   {ms:8.4f} ms {100 * ms / total:5.1f}%  x{count}  "
            f"{key[:90]}")


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
    if counts != {"csr_moment_sketch": N_LAYERS, "csr_dmsg": 0,
                  "csr_pretrans_sketch": 0, "csr_pretrans_dmsg": 0}:
        raise AssertionError(f"entry launches {counts}")
    ref = forward(cpu_model, graph.to('cpu'))
    err = float((out.cpu() - ref).abs().max())
    if not torch.allclose(out.cpu(), ref, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"entry output differs from CPU by {err}")
    log(f"entry: output {tuple(out.shape)} finite, launches {counts}, max "
        f"diff to CPU {err:.3g}")


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

    kernels = []
    for name, (src, tpu) in SOURCES.items():
        r = k[name]
        backend = 'csr' if name in BACKEND_KERNELS['csr'] else 'csr_fused'
        row = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
               "launches": runs[backend, torch.float32]["counts"][name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
               "bound_by": r["bound"][1], "library_ms": None}
        row.update({key: val for key, val in r.items()
                    if key not in ("err", "ms", "plain_ms", "bound")})
        kernels.append(row)
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
