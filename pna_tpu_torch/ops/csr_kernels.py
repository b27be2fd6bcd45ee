"""The CSR kernels of the main path: K1 moment sketch and K2 message gradient.

Counterpart of ``pna_tpu/ops/pallas_kernels.py``:

* ``csr_moment_sketch`` replaces ``sorted_moment_sketch`` (CUDA source
  ``pna_tpu_torch/csrc/csr_moment_sketch.cu``);
* ``csr_dmsg`` replaces ``sorted_dmsg`` (``pna_tpu_torch/csrc/csr_dmsg.cu``).

Layout contract: edges sorted by receiver; node ``n`` owns rows
``[ptr[n], ptr[n+1])`` of ``msg``; ``ptr`` is nondecreasing.  The kernels
clamp every pointer to ``E``, so a bad ``ptr`` cannot make them read or write
outside ``msg``.

Each kernel has a wrapper, which checks device, dtype, shape and contiguity
and counts its launches in a plain integer attribute (``.launches``), and a
plain PyTorch version of the same function (``*_plain``) built on
``pna_tpu_torch/ops/segment.py``.  The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
The plain versions work on any device and are what the kernels are held
against on the card.  The registry of the launch counts of all the port's
kernels is ``csr_fused_kernels.launch_counts``.

The segment table (``csr_segments``) is the work list of K1 and of the fused
kernels K3/K4: every node's range cut into segments of at most ``SEG`` edges,
so that a hub node's range spreads over the card; a split node's segments
write partial sketches that a second small kernel merges in segment order
(``csr_fused_kernels.merge_segment_sketches_plain`` is that merge in plain
torch).  K2 is edge-owned and reads each row's node from the table's
``row_node`` array.  All four wrappers take the batch's table as
``segments=`` (``CSRLayout.segments``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from pna_tpu_torch.ops import build
from pna_tpu_torch.ops import segment as seg


def _row_segments(ptr: torch.Tensor, n_rows: int):
    """Node id of every message row (clamped into [0, N)) and whether the row
    lies inside some node's range.  No host synchronisation."""
    n = ptr.numel() - 1
    rows = torch.arange(n_rows, device=ptr.device, dtype=ptr.dtype)
    ids = torch.searchsorted(ptr[1:], rows, right=True).clamp_(max=n - 1)
    valid = (rows >= ptr[0]) & (rows < ptr[n])
    return ids, valid


# longest run of edges one thread of K1/K3/K4 reduces (kSeg of
# csrc/pretrans_msg.cuh).  32 keeps a hub's segments short enough to balance
# over the card while a node of ordinary degree (ZINC: at most 4) stays whole
SEG = 32


@dataclass
class CSRSegments:
    """Every node's range ``[ptr[n], ptr[n+1])`` cut into segments of at most
    ``SEG`` edges.  A node's segments are consecutive and in edge order; an
    empty node has one empty segment; rows outside ``[ptr[0], ptr[N])`` are in
    none.  Segment ``s`` spans ``[seg_ptr[s], seg_ptr[s+1])`` and belongs to
    node ``seg_node[s]``.  A node with more than one segment is *split*: its
    segments write partial results to the slots ``seg_slot[s]`` (-1 for the
    segment of an unsplit node), and split node ``j`` (``split_node[j]``)
    owns the slots ``[split_ptr[j], split_ptr[j+1])``, in segment order.
    Where no node is split the table is the row pointers themselves:
    ``seg_ptr is ptr`` and the other tensors are None.
    """
    seg_ptr: torch.Tensor                       # [S+1] int32
    n_seg: int                                  # S >= N
    n_nodes: int
    n_split: int = 0                            # nodes with > 1 segment
    n_part: int = 0                             # their segments in all
    seg_node: Optional[torch.Tensor] = None     # [S] int32
    seg_slot: Optional[torch.Tensor] = None     # [S] int32
    split_node: Optional[torch.Tensor] = None   # [n_split] int32
    split_ptr: Optional[torch.Tensor] = None    # [n_split+1] int32
    _row_node: Optional[torch.Tensor] = field(default=None, repr=False)

    def row_node(self, n_rows: int) -> torch.Tensor:
        """K2's receiver array: the node of each of the ``n_rows`` message
        rows, int32; a row in no node's range gets a value outside
        ``[0, N)`` (-1 before ``ptr[0]``; N, or -1 from a cut table, from
        ``ptr[N]`` on).  Built when it is first asked for, in three small
        kernels without device synchronisation where no node is split, and
        kept: a layout's table serves every layer of the batch."""
        if self._row_node is None or self._row_node.numel() != n_rows:
            sp = self.seg_ptr
            rows = torch.arange(n_rows, device=sp.device, dtype=sp.dtype)
            # the last segment that starts at or before the row
            at = torch.searchsorted(sp, rows, right=True, out_int32=True) - 1
            if self.seg_node is not None:
                inside = (at >= 0) & (at < self.n_seg)
                at = torch.where(
                    inside, self.seg_node[at.clamp(0, self.n_seg - 1).long()],
                    -1)
            self._row_node = at
        return self._row_node


def csr_segments(ptr: torch.Tensor,
                 max_in_degree: Optional[int] = None) -> CSRSegments:
    """The segment table of the layout ``ptr`` [N+1] (int32, nondecreasing),
    in plain torch on ``ptr``'s device.

    ``max_in_degree`` is the largest in-degree where the caller knows it on
    the host (``Graph.max_in_degree`` from collation): at most ``SEG`` means
    no node is split, and the table is ``ptr`` itself at no cost.  Otherwise
    the degrees are read from ``ptr``, which synchronises with the device
    once (the table's size depends on the data)."""
    n = ptr.numel() - 1
    whole = CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)
    if n < 1 or (max_in_degree is not None and max_in_degree <= SEG):
        return whole
    lo = ptr[:-1].long()
    per_node = torch.clamp((ptr[1:].long() - lo + (SEG - 1)) // SEG, min=1)
    split = per_node > 1
    n_split, n_part = torch.stack(
        [split.sum(), (per_node * split).sum()]).tolist()
    if n_split == 0:
        return whole
    n_seg = n + n_part - n_split
    first = torch.cumsum(per_node, 0) - per_node
    nodes = torch.arange(n, device=ptr.device)
    seg_node = torch.repeat_interleave(nodes, per_node, output_size=n_seg)
    k = torch.arange(n_seg, device=ptr.device) - first[seg_node]
    seg_ptr = torch.cat([lo[seg_node] + k * SEG, ptr[-1:].long()])
    in_split = split[seg_node]
    seg_slot = torch.where(in_split, torch.cumsum(in_split, 0) - 1,
                           torch.full_like(seg_node, -1))
    split_ptr = torch.zeros(n_split + 1, dtype=torch.long, device=ptr.device)
    split_ptr[1:] = torch.cumsum(per_node[split], 0)
    i32 = torch.int32
    return CSRSegments(
        seg_ptr=seg_ptr.to(i32), n_seg=n_seg, n_nodes=n, n_split=n_split,
        n_part=n_part, seg_node=seg_node.to(i32), seg_slot=seg_slot.to(i32),
        split_node=nodes[split].to(i32), split_ptr=split_ptr.to(i32))


def csr_moment_sketch_plain(msg: torch.Tensor, ptr: torch.Tensor,
                            with_ties: bool = False):
    """Plain version of K1: per node, (sum, sumsq, max, min) over its rows,
    plus (ties_max, ties_min) with ``with_ties``; empty nodes give 0 and tie
    counts are clamped to >= 1."""
    n = ptr.numel() - 1
    ids, valid = _row_segments(ptr, msg.shape[0])
    s = seg.segment_sum(msg, ids, n, valid)
    sq = seg.segment_sum(msg * msg, ids, n, valid)
    mx = seg.segment_max(msg, ids, n, valid)
    mn = seg.segment_min(msg, ids, n, valid)
    if not with_ties:
        return s, sq, mx, mn
    tmx = seg.segment_sum((msg == mx[ids]).to(msg.dtype), ids, n, valid)
    tmn = seg.segment_sum((msg == mn[ids]).to(msg.dtype), ids, n, valid)
    return s, sq, mx, mn, tmx.clamp_(min=1.0), tmn.clamp_(min=1.0)


def csr_dmsg_plain(msg, ptr, g_lin, g_quad, g_max, g_min, mx, mn):
    """Plain version of K2, the gather form of the JAX bank's backward
    (``pna_tpu/ops/pallas_bank.py``, bwd_kernel=False): every row in a node's
    range gets its d_msg; rows outside every range are 0."""
    ids, valid = _row_segments(ptr, msg.shape[0])
    d = (g_lin[ids] + 2.0 * msg * g_quad[ids]
         + (msg == mx[ids]).to(msg.dtype) * g_max[ids]
         + (msg == mn[ids]).to(msg.dtype) * g_min[ids])
    return torch.where(valid[:, None], d, torch.zeros_like(d))


def _check(name, msg, ptr, fields=()):
    if msg.dtype != torch.float32 or msg.ndim != 2:
        raise ValueError(f"{name}: msg must be 2-D float32, got "
                         f"{tuple(msg.shape)} {msg.dtype}")
    if ptr.dtype != torch.int32 or ptr.ndim != 1 or ptr.numel() < 1:
        raise ValueError(f"{name}: ptr must be 1-D int32, got "
                         f"{tuple(ptr.shape)} {ptr.dtype}")
    n, f = ptr.numel() - 1, msg.shape[1]
    for x in fields:
        if x.dtype != torch.float32 or tuple(x.shape) != (n, f):
            raise ValueError(f"{name}: node fields must be float32 [{n}, {f}],"
                             f" got {tuple(x.shape)} {x.dtype}")
    for x in (msg, ptr, *fields):
        if x.device != msg.device:
            raise ValueError(f"{name}: inputs on {x.device} and {msg.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if msg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {msg.device}")
    if msg.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit int32")


def check_segments(name, segments, ptr):
    """A caller's segment table must be the one of ``ptr``'s layout.  Its
    node count and device are checked; its cuts are the caller's word, and
    the kernels walk a segment of any length."""
    if segments is None:
        return
    if segments.n_nodes != ptr.numel() - 1:
        raise ValueError(f"{name}: segment table of {segments.n_nodes} nodes "
                         f"for a ptr of {ptr.numel() - 1}")
    if segments.seg_ptr.device != ptr.device:
        raise ValueError(f"{name}: segment table on {segments.seg_ptr.device}"
                         f", inputs on {ptr.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _at(x):
    return None if x is None else x.data_ptr()


def csr_moment_sketch(msg: torch.Tensor, ptr: torch.Tensor,
                      with_ties: bool = False,
                      segments: Optional[CSRSegments] = None):
    """K1.  msg [E, F] float32, ptr [N+1] int32 -> 4 (or 6 with ties)
    [N, F] float32 tensors: sum, sumsq, max, min (, ties_max, ties_min).

    ``segments`` is the segment table of ``ptr`` (``CSRLayout.segments``),
    the kernel's work list; without it the table is built here, which reads
    the degrees back from the card.  One call counts one launch; where a
    node is split it starts a second small kernel that merges the partials.
    """
    _check("csr_moment_sketch", msg, ptr)
    check_segments("csr_moment_sketch", segments, ptr)
    if msg.device.type == "cpu":
        return csr_moment_sketch_plain(msg, ptr, with_ties)
    n, f = ptr.numel() - 1, msg.shape[1]
    lib = build.load()
    widest = lib.pna_csr_moment_sketch_max_feat()
    if f > widest:
        raise ValueError(f"csr_moment_sketch: a row of F = {f} floats is over"
                         f" the {widest} a block stages in shared memory")
    segs = csr_segments(ptr) if segments is None else segments
    with torch.cuda.device(msg.device):
        # two buffers, not six: the sums, which the bank drops after the
        # forward, and the selections, which autograd keeps for K2 (in one
        # buffer the sums would stay alive with them until the backward)
        outs = (*torch.empty((2, n, f), dtype=torch.float32,
                             device=msg.device).unbind(0),
                *torch.empty((4 if with_ties else 2, n, f),
                             dtype=torch.float32,
                             device=msg.device).unbind(0))
        part = (torch.empty((segs.n_part, 6, f), dtype=torch.float32,
                            device=msg.device) if segs.n_split else None)
        out_ptrs = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
        rc = lib.pna_csr_moment_sketch(
            msg.data_ptr(), segs.seg_ptr.data_ptr(), _at(segs.seg_node),
            _at(segs.seg_slot), _at(segs.split_node), _at(segs.split_ptr),
            segs.n_seg, segs.n_split, segs.n_part, n, msg.shape[0], f,
            *out_ptrs, _at(part), int(with_ties), _stream(msg.device))
    build.check(lib, rc, "csr_moment_sketch")
    csr_moment_sketch.launches += 1
    return outs


csr_moment_sketch.launches = 0


def csr_dmsg(msg, ptr, g_lin, g_quad, g_max, g_min, mx, mn,
             segments: Optional[CSRSegments] = None) -> torch.Tensor:
    """K2.  msg [E, F] float32, ptr [N+1] int32, six [N, F] float32 node
    fields (g_max/g_min already divided by the tie counts; mx/mn the forward
    max/min) -> d_msg [E, F] float32.  Rows outside every node's range (the
    pad edges past ``ptr[N]``) are 0.

    The kernel reads each row's node from ``segments.row_node`` (the table
    of ``ptr``, ``CSRLayout.segments``, which keeps the array for the
    batch's other layers); without a table the array is built here."""
    fields = (g_lin, g_quad, g_max, g_min, mx, mn)
    _check("csr_dmsg", msg, ptr, fields)
    check_segments("csr_dmsg", segments, ptr)
    if msg.device.type == "cpu":
        return csr_dmsg_plain(msg, ptr, *fields)
    n, f = ptr.numel() - 1, msg.shape[1]
    if segments is None:      # K2 needs no cuts: the row pointers will do
        segments = CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)
    lib = build.load()
    with torch.cuda.device(msg.device):
        row_node = segments.row_node(msg.shape[0])
        out = torch.empty_like(msg)
        rc = lib.pna_csr_dmsg(msg.data_ptr(), row_node.data_ptr(),
                              *[x.data_ptr() for x in fields], n,
                              msg.shape[0], f,
                              out.data_ptr(), _stream(msg.device))
    build.check(lib, rc, "csr_dmsg")
    csr_dmsg.launches += 1
    return out


csr_dmsg.launches = 0
