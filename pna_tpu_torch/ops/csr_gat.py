"""Graph attention over the receiver-sorted layout: the GAT layer's kernels.

GAT (Velickovic et al., arXiv:1710.10903) on the port's CSR layout.  With
``hw`` [Nt, H*F] the projected sender table (its first N rows are the
receivers' own; on a partitioned graph the rest are the halo's), the head
scores ``s_src`` [Nt, H] and ``s_dst`` [N, H], and node i's in-edges plus an
implicit self edge:

    e_ij = LeakyReLU_0.2(s_dst[i] + s_src[j]),   j in N(i) and j = i
    out_i = sum_j softmax_j(e_ij) hw_j            (per head)

* ``csr_gat_attend`` (CUDA source ``pna_tpu_torch/csrc/csr_gat_attend.cu``)
  computes ``out`` [N, H*F] and keeps the softmax's maximum ``m`` and sum
  ``l`` [N, H]; ``csr_gat_attend_bwd`` gives ``d_hw`` (with the scores'
  terms ``d_s_src a_src + d_s_dst a_dst`` added), ``d_s_src`` and
  ``d_s_dst`` in three passes.  A pre-pass forms ``delta_i = d_out_i .
  out_i`` per receiver and head.  The sender pass walks the senders' stable
  sort in segments of at most ``SEG`` edges with ``hw_j`` held: for each
  edge it gathers ``d_out_i`` once, forms the weight a_ij from head
  scalars, the dot ``d_out_i . hw_j`` and d_ij, sums a_ij d_out_i and d_ij
  by sender and writes d_ij ([E, H]) in receiver order; a node of one
  segment finishes its row there (its self term, ``d_s_src a_src``).  A
  hub's segments are merged in ``RUNS`` runs in a fixed order, and the
  merge's last kernel finishes the hub's row whole; its other warps are the
  post-pass, which sums ``d_s_dst`` per receiver (self term first, then the
  in-edges in receiver order) and adds ``d_s_dst a_dst`` to the row.  No
  pass forms an [E, H*F] or [E, F] tensor or reads a row twice an edge.
* ``csr_gat_attend_plain`` and ``csr_gat_attend_bwd_plain`` are the same
  functions in torch, in the kernels' order of addition (lane slots, warp
  sums folded by halves, edges or segments in order, each self term where
  the kernel adds it), so that on the card the kernels equal them bit for
  bit.  The wrappers take them for tensors on the CPU; for CUDA tensors
  they launch the kernels or raise.
* ``gat_layout`` builds (once per layout and table size, kept on the
  ``CSRLayout``) the sender side: the stable sort of the real edges'
  senders, each edge's receiver, and the segment and merge tables.
* ``GATAttend`` is the autograd function of the layer (``nn/gat.py``): it
  takes ``hw``, the attention vectors and the scores the layer computed
  from them, and returns the gradients of ``hw`` and of the vectors.

Launch counts: ``csr_gat_attend.launches``, ``csr_gat_attend_bwd.launches``
(``launch_counts()``); they are not in ``csr_fused_kernels``' registry.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from pna_tpu_torch.ops import build

SLOPE = 0.2     # LeakyReLU's negative slope (GAT's)
SEG = 128       # sender-sorted edges a warp of the sender pass sums at most
RUNS = 64       # kRuns of csrc/csr_gat_attend.cu: runs of a split merge
LANES = 32


@dataclass
class GATLayout:
    """A receiver-sorted layout with its sender side, on one device."""
    ptr: torch.Tensor          # [N+1] int32, ptr[0] = 0, ptr[N] = E
    senders: torch.Tensor      # [>= E] int32, receiver order
    n_table: int               # sender table rows Nt
    n_edges: int               # real edges E
    sperm: torch.Tensor        # [E] int32: receiver-order position, by sender
    srows: torch.Tensor        # [E] int32: the receiver of each, by sender
    seg_lo: torch.Tensor       # [n_seg] int32, sorted positions
    seg_hi: torch.Tensor       # [n_seg] int32
    seg_node: torch.Tensor     # [n_seg] int32
    seg_slot: torch.Tensor     # [n_seg] int32, -1 for a node's only segment
    split_node: torch.Tensor   # [n_split] int32
    split_slot: torch.Tensor   # [n_split + 1] int32
    max_in_degree: int
    max_seg: int               # the longest segment

    @property
    def n_nodes(self) -> int:
        return self.ptr.numel() - 1

    @property
    def n_seg(self) -> int:
        return self.seg_node.numel()

    @property
    def n_split(self) -> int:
        return self.split_node.numel()

    @property
    def n_slots(self) -> int:
        return int(self.split_slot[-1]) if self.n_split else 0


def build_gat_layout(ptr: torch.Tensor, senders: torch.Tensor,
                     n_table: int, seg: int = SEG) -> GATLayout:
    """The layout of receiver pointers ``ptr`` [N+1] (the real edges are
    positions [0, ptr[N])) and ``senders`` [>= ptr[N]] (ids into a table of
    ``n_table`` rows), the senders' sorted edges cut in segments of at most
    ``seg``.  Reads a few sizes back from the device."""
    dev = ptr.device
    n = ptr.numel() - 1
    if n < 1 or n_table < n:
        raise ValueError(f"gat layout: {n} receivers, a table of {n_table}")
    ptr = ptr.to(torch.int32).contiguous()
    e, p0 = int(ptr[-1]), int(ptr[0])
    if p0 != 0 or e > senders.numel():
        raise ValueError(f"gat layout: ptr must run from 0 to at most the "
                         f"{senders.numel()} senders, got {p0}..{e}")
    snd = senders[:e].long()
    if e and (int(snd.min()) < 0 or int(snd.max()) >= n_table):
        raise ValueError(f"gat layout: sender ids outside [0, {n_table})")
    vals, perm = torch.sort(snd, stable=True)
    ar = torch.arange(n_table + 1, device=dev)
    sptr = torch.searchsorted(vals, ar)
    deg = sptr[1:] - sptr[:-1]
    nseg = torch.clamp((deg + seg - 1) // seg, min=1)
    n_seg = int(nseg.sum())
    node = torch.arange(n_table, device=dev)
    seg_node = torch.repeat_interleave(node, nseg, output_size=n_seg)
    first = torch.cumsum(nseg, 0) - nseg
    k = torch.arange(n_seg, device=dev) - first[seg_node]
    seg_lo = sptr[seg_node] + k * seg
    seg_hi = torch.minimum(seg_lo + seg, sptr[seg_node + 1])
    split = nseg[seg_node] > 1
    seg_slot = torch.where(split, torch.cumsum(split, 0) - 1, -1)
    split_node = node[nseg > 1]
    split_slot = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                            torch.cumsum(nseg[split_node], 0)])
    in_deg = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=dev), in_deg,
                                   output_size=e)
    i32 = torch.int32
    return GATLayout(
        ptr=ptr, senders=senders.to(i32).contiguous(), n_table=n_table,
        n_edges=e, sperm=perm.to(i32), srows=rows[perm].to(i32),
        seg_lo=seg_lo.to(i32), seg_hi=seg_hi.to(i32),
        seg_node=seg_node.to(i32), seg_slot=seg_slot.to(i32),
        split_node=split_node.to(i32), split_slot=split_slot.to(i32),
        max_in_degree=int(in_deg.max()) if n else 0,
        max_seg=int((seg_hi - seg_lo).max()) if n_seg else 0)


def gat_layout(csr, n_table: int) -> GATLayout:
    """The GAT layout of a ``csr_bank.CSRLayout`` (its clamped ``ptr`` and
    int32 senders) for a sender table of ``n_table`` rows, built at its
    first use and kept on the layout, so every layer and step of a graph
    shares it."""
    kept = csr.__dict__.setdefault('_gat_layouts', {})
    if n_table not in kept:
        if csr.senders is None:
            raise ValueError("gat layout: the CSR layout holds no senders")
        kept[n_table] = build_gat_layout(csr.ptr, csr.senders, n_table)
    return kept[n_table]


# ---------------------------------------------------------------------------
# plain versions, in the kernels' order
# ---------------------------------------------------------------------------

def lane_slots(head_dim: int) -> int:
    """KH of the kernels: the least of 1, 2, 4, 8 with 32 KH >= F."""
    for kh in (1, 2, 4, 8):
        if LANES * kh >= head_dim:
            return kh
    raise ValueError(f"csr_gat_attend: head width {head_dim} over 256")


def _lrelu(z):
    return torch.where(z > 0, z, z * SLOPE)


def _slots(x: torch.Tensor, heads: int, kh: int) -> torch.Tensor:
    """Rows [n, H*F] as each lane holds them: [n, H, KH, 32], feature
    ``lane + 32 k`` of each head, zeros past F."""
    n, f = x.shape[0], x.shape[1] // heads
    x = F.pad(x.reshape(n, heads, f), (0, LANES * kh - f))
    return x.reshape(n, heads, kh, LANES)


def _warp_sum(p: torch.Tensor) -> torch.Tensor:
    """[..., 32] lane values -> their warp sum, halves folded 16, .., 1."""
    for o in (16, 8, 4, 2, 1):
        p = p[..., :o] + p[..., o:2 * o]
    return p[..., 0]


def _dot(a_slots: torch.Tensor, b_slots: torch.Tensor) -> torch.Tensor:
    """Per row and head, each lane's products summed in slot order from 0,
    then the warp sum: [n, H]."""
    p = a_slots.new_zeros(a_slots.shape[:2] + (LANES,))
    for k in range(a_slots.shape[2]):
        p = p + a_slots[:, :, k] * b_slots[:, :, k]
    return _warp_sum(p)


def _ranges(ptr: torch.Tensor, n_edges: int):
    lo = ptr[:-1].long().clamp(0, n_edges)
    hi = torch.maximum(ptr[1:].long().clamp(0, n_edges), lo)
    return lo, hi - lo


def csr_gat_attend_plain(hw, s_src, s_dst, lay: GATLayout
                         ) -> Tuple[torch.Tensor, ...]:
    """The forward in torch, in the kernel's order: (out [N, H*F], m, l)."""
    n, nt, heads = lay.n_nodes, hw.shape[0], s_dst.shape[1]
    f = hw.shape[1] // heads
    lo, deg = _ranges(lay.ptr, lay.n_edges)
    snd = lay.senders.long()
    steps = lay.max_in_degree
    mx = _lrelu(s_dst + s_src[:n])
    for k in range(steps):
        act = torch.nonzero(deg > k).squeeze(1)
        j = snd[lo[act] + k].clamp(0, nt - 1)
        mx[act] = torch.maximum(mx[act], _lrelu(s_dst[act] + s_src[j]))
    hw3 = hw.reshape(nt, heads, f)
    w = torch.exp(_lrelu(s_dst + s_src[:n]) - mx)
    den = torch.zeros_like(mx) + w
    acc = hw.new_zeros((n, heads, f)) + w[..., None] * hw3[:n]
    for k in range(steps):
        act = torch.nonzero(deg > k).squeeze(1)
        j = snd[lo[act] + k].clamp(0, nt - 1)
        w = torch.exp(_lrelu(s_dst[act] + s_src[j]) - mx[act])
        den[act] = den[act] + w
        acc[act] = acc[act] + w[..., None] * hw3[j]
    return (acc / den[..., None]).reshape(n, heads * f), mx, den


def _merge_plain(part, part_ds, lay: GATLayout):
    """Each split sender's slots summed in ``RUNS`` runs of ceil(m / RUNS),
    then the runs in order: ([n_split, H, F], [n_split, H])."""
    s0 = lay.split_slot[:-1].long()
    s1 = lay.split_slot[1:].long()
    run_len = (s1 - s0 + RUNS - 1) // RUNS
    r = torch.arange(RUNS, device=part.device)
    b0 = torch.minimum(s0[:, None] + r * run_len[:, None], s1[:, None])
    b1 = torch.minimum(b0 + run_len[:, None], s1[:, None])
    runs = part.new_zeros((lay.n_split, RUNS) + part.shape[1:])
    runs_ds = part_ds.new_zeros((lay.n_split, RUNS) + part_ds.shape[1:])
    for t in range(int(run_len.max()) if lay.n_split else 0):
        q, rr = torch.nonzero(b0 + t < b1, as_tuple=True)
        s = b0[q, rr] + t
        runs[q, rr] = runs[q, rr] + part[s]
        runs_ds[q, rr] = runs_ds[q, rr] + part_ds[s]
    total = part.new_zeros((lay.n_split,) + part.shape[1:])
    total_ds = part_ds.new_zeros((lay.n_split,) + part_ds.shape[1:])
    for t in range(RUNS):
        q = torch.nonzero(b0[:, t] < b1[:, t]).squeeze(1)
        total[q] = total[q] + runs[q, t]
        total_ds[q] = total_ds[q] + runs_ds[q, t]
    return total, total_ds


def csr_gat_attend_bwd_plain(hw, s_src, s_dst, out, m, l, a_src, a_dst,
                             d_out, lay: GATLayout):
    """The backward in torch, in the kernels' order: (d_hw [Nt, H*F] with
    the scores' terms, d_s_src [Nt, H], d_s_dst [N, H])."""
    n, nt, e = lay.n_nodes, hw.shape[0], lay.n_edges
    heads = s_dst.shape[1]
    f = hw.shape[1] // heads
    kh = lane_slots(f)
    g = _slots(d_out, heads, kh)
    hws = _slots(hw, heads, kh)
    # the pre-pass
    delta = _dot(g, _slots(out, heads, kh))

    def terms(i, j):
        dot = _dot(g[i], hws[j])
        z = s_dst[i] + s_src[j]
        al = torch.exp(_lrelu(z) - m[i]) / l[i]
        dv = al * (dot - delta[i])
        return al, torch.where(z > 0, dv, dv * SLOPE)

    # the sender pass, segment by segment: each edge's weight, dot product
    # and d_ij from d_out_i and hw_j
    d3 = d_out.reshape(n, heads, f)
    seg_lo = lay.seg_lo.long()
    seg_len = lay.seg_hi.long() - seg_lo
    seg_node = lay.seg_node.long()
    de_e = hw.new_zeros((e, heads))
    acc = hw.new_zeros((lay.n_seg, heads, f))
    ds = hw.new_zeros((lay.n_seg, heads))
    for t in range(lay.max_seg):
        act = torch.nonzero(seg_len > t).squeeze(1)
        q = seg_lo[act] + t
        ed = lay.sperm[q].long().clamp(0, max(e - 1, 0))
        i = lay.srows[q].long().clamp(0, n - 1)
        al, dv = terms(i, seg_node[act])
        de_e[ed] = dv
        ds[act] = ds[act] + dv
        acc[act] = acc[act] + al[..., None] * d3[i]
    node_acc = hw.new_zeros((nt, heads, f))
    node_ds = hw.new_zeros((nt, heads))
    whole = lay.seg_slot < 0
    node_acc[seg_node[whole]] = acc[whole]
    node_ds[seg_node[whole]] = ds[whole]
    if lay.n_split:
        total, total_ds = _merge_plain(acc[~whole], ds[~whole], lay)
        node_acc[lay.split_node.long()] = total
        node_ds[lay.split_node.long()] = total_ds
    # where each sender's row is finished: its self term, then d_s_src a_src
    own = torch.arange(n, device=hw.device)
    alpha_self, de_self = terms(own, own)
    node_ds[:n] = node_ds[:n] + de_self
    node_acc[:n] = node_acc[:n] + alpha_self[..., None] * d3
    t = node_acc + node_ds[..., None] * a_src
    # the receiver sums: the self term first, then the in-edges in receiver
    # order; d_s_dst a_dst added to the rounded row
    lo, deg = _ranges(lay.ptr, e)
    dsd = torch.zeros_like(de_self) + de_self
    for k in range(lay.max_in_degree):
        act = torch.nonzero(deg > k).squeeze(1)
        dsd[act] = dsd[act] + de_e[lo[act] + k]
    t[:n] = t[:n] + dsd[..., None] * a_dst
    return t.reshape(nt, heads * f), node_ds, dsd


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = build.load()
    if not getattr(lib, '_pna_gat_declared', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # hw, s_src, s_dst, senders, ptr, 5 sizes, out, m, l, the stream
        lib.pna_gat_attend_fwd.argtypes = [p] * 5 + [i] * 5 + [p] * 4
        lib.pna_gat_attend_fwd.restype = i
        # 9 inputs, ptr, 8 layout tables, n_seg, n_split, 7 scratch, 3
        # outputs, 5 sizes, the stream
        lib.pna_gat_attend_bwd.argtypes = ([p] * 18 + [i] * 2 + [p] * 10
                                           + [i] * 5 + [p])
        lib.pna_gat_attend_bwd.restype = i
        lib.pna_gat_attend_runs.argtypes = []
        lib.pna_gat_attend_runs.restype = i
        lib._pna_gat_declared = True
    return lib


def _check(name, lay: GATLayout, **tensors):
    """Shapes from hw [Nt, H*F] and s_dst [N, H]; every tensor float32,
    contiguous, on the layout's device.  Returns (H, F)."""
    hw, s_dst = tensors['hw'], tensors['s_dst']
    heads = s_dst.shape[1] if s_dst.ndim == 2 else 0
    if heads < 1 or hw.ndim != 2 or hw.shape[1] % heads:
        raise ValueError(f"{name}: hw [Nt, H*F] and s_dst [N, H], got "
                         f"{tuple(hw.shape)}, {tuple(s_dst.shape)}")
    f = hw.shape[1] // heads
    if heads > 8 or f > (256 if heads <= 4 else 128):
        raise ValueError(f"{name}: {heads} heads of {f}: at most 4 heads of "
                         "256 or 8 of 128")
    n, nt, hf = lay.n_nodes, lay.n_table, heads * f
    want = dict(hw=(nt, hf), s_src=(nt, heads), s_dst=(n, heads),
                out=(n, hf), m=(n, heads), l=(n, heads), d_out=(n, hf),
                a_src=(heads, f), a_dst=(heads, f))
    for k, x in tensors.items():
        if (tuple(x.shape) != want[k] or x.dtype != torch.float32
                or x.device != lay.ptr.device or not x.is_contiguous()):
            raise ValueError(f"{name}: {k} must be contiguous float32 "
                             f"{want[k]} on {lay.ptr.device}, got "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")
    if hw.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"{name}: unsupported device {hw.device}")
    return heads, f


def csr_gat_attend(hw: torch.Tensor, s_src: torch.Tensor,
                   s_dst: torch.Tensor, lay: GATLayout):
    """The forward: hw [Nt, H*F], s_src [Nt, H], s_dst [N, H] float32 ->
    (out [N, H*F], m [N, H], l [N, H]), every row written.  One launch."""
    heads, f = _check('csr_gat_attend', lay, hw=hw, s_src=s_src,
                      s_dst=s_dst)
    if hw.device.type == 'cpu':
        return csr_gat_attend_plain(hw, s_src, s_dst, lay)
    n, dev = lay.n_nodes, hw.device
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((n, heads * f), dtype=torch.float32, device=dev)
        m = torch.empty((n, heads), dtype=torch.float32, device=dev)
        l = torch.empty((n, heads), dtype=torch.float32, device=dev)
        rc = lib.pna_gat_attend_fwd(
            hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            lay.senders.data_ptr(), lay.ptr.data_ptr(), n, lay.n_table,
            lay.n_edges, heads, f, out.data_ptr(), m.data_ptr(),
            l.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, 'csr_gat_attend')
    csr_gat_attend.launches += 1
    return out, m, l


csr_gat_attend.launches = 0


def csr_gat_attend_bwd(hw, s_src, s_dst, out, m, l, a_src, a_dst, d_out,
                       lay: GATLayout):
    """The backward: the forward's inputs, its ``out``, ``m``, ``l``, the
    attention vectors a_src, a_dst [H, F] and d_out [N, H*F] float32 ->
    (d_hw [Nt, H*F], d_s_src [Nt, H], d_s_dst [N, H]), every row written.
    One counted launch (three or four device kernels: the pre-pass, the
    sender pass, a split sender's merge runs, and the kernel that finishes
    the split senders and runs the post-pass)."""
    heads, f = _check('csr_gat_attend_bwd', lay, hw=hw, s_src=s_src,
                      s_dst=s_dst, out=out, m=m, l=l, a_src=a_src,
                      a_dst=a_dst, d_out=d_out)
    if hw.device.type == 'cpu':
        return csr_gat_attend_bwd_plain(hw, s_src, s_dst, out, m, l, a_src,
                                        a_dst, d_out, lay)
    dev, n, nt, e = hw.device, lay.n_nodes, lay.n_table, lay.n_edges
    lib = _lib()
    if lib.pna_gat_attend_runs() != RUNS:
        raise RuntimeError("csr_gat_attend_bwd: the kernel's runs are "
                           f"{lib.pna_gat_attend_runs()}, not {RUNS}")
    with torch.cuda.device(dev):
        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)
        slots = lay.n_slots
        delta, de_self = empty(n, heads), empty(n, heads)
        de_e = empty(e, heads)
        part, part_ds = empty(slots, heads * f), empty(slots, heads)
        runs = empty(lay.n_split * RUNS, heads * f)
        runs_ds = empty(lay.n_split * RUNS, heads)
        d_hw, d_s_src, d_s_dst = (empty(nt, heads * f), empty(nt, heads),
                                  empty(n, heads))
        rc = lib.pna_gat_attend_bwd(
            hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), a_src.data_ptr(),
            a_dst.data_ptr(), d_out.data_ptr(), lay.ptr.data_ptr(),
            lay.sperm.data_ptr(), lay.srows.data_ptr(),
            lay.seg_lo.data_ptr(), lay.seg_hi.data_ptr(),
            lay.seg_node.data_ptr(), lay.seg_slot.data_ptr(),
            lay.split_node.data_ptr(), lay.split_slot.data_ptr(),
            lay.n_seg, lay.n_split, delta.data_ptr(), de_e.data_ptr(),
            de_self.data_ptr(), part.data_ptr(), part_ds.data_ptr(),
            runs.data_ptr(), runs_ds.data_ptr(), d_hw.data_ptr(),
            d_s_src.data_ptr(), d_s_dst.data_ptr(), n, nt, e, heads, f,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, 'csr_gat_attend_bwd')
    csr_gat_attend_bwd.launches += 1
    return d_hw, d_s_src, d_s_dst


csr_gat_attend_bwd.launches = 0

KERNELS = (csr_gat_attend, csr_gat_attend_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ---------------------------------------------------------------------------
# the layer's pieces
# ---------------------------------------------------------------------------

def head_scores(hw: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_src [Nt, H], s_dst [N, H]): each row's head slices of ``hw``
    times the attention vectors [H, F], as one product with their block
    diagonal [2H, H*F]; no gradient (``GATAttend`` gives the vectors' and
    ``hw``'s)."""
    heads = a_src.shape[0]
    with torch.no_grad():
        mat = torch.cat([torch.block_diag(*a_src.unbind(0)),
                         torch.block_diag(*a_dst.unbind(0))])
        s = hw @ mat.t()
        return s[:, :heads].contiguous(), s[:n, heads:].contiguous()


def _diag_blocks(g: torch.Tensor, heads: int) -> torch.Tensor:
    """[H, H*F] -> its diagonal blocks [H, F]."""
    f = g.shape[1] // heads
    ar = torch.arange(heads, device=g.device)
    return g.reshape(heads, heads, f)[ar, ar]


class GATAttend(torch.autograd.Function):
    """out = attention of ``hw`` [Nt, H*F] over the layout, as a function
    of ``hw`` and the attention vectors ``a_src``, ``a_dst`` [H, F];
    ``s_src``, ``s_dst`` are their scores (``head_scores``), passed in so
    that the layer's projection phase computes them, and take no
    gradient."""

    @staticmethod
    def forward(ctx, hw, a_src, a_dst, s_src, s_dst, lay: GATLayout):
        out, m, l = csr_gat_attend(hw, s_src, s_dst, lay)
        ctx.save_for_backward(hw, a_src, a_dst, s_src, s_dst, out, m, l)
        ctx.lay = lay
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        hw, a_src, a_dst, s_src, s_dst, out, m, l = ctx.saved_tensors
        lay = ctx.lay
        d_hw, d_s_src, d_s_dst = csr_gat_attend_bwd(
            hw, s_src, s_dst, out, m, l, a_src.contiguous(),
            a_dst.contiguous(), d_out.contiguous(), lay)
        heads = a_src.shape[0]
        d_a_src = _diag_blocks(d_s_src.t() @ hw, heads)
        d_a_dst = _diag_blocks(d_s_dst.t() @ hw[:lay.n_nodes], heads)
        return d_hw, d_a_src, d_a_dst, None, None, None


def gat_attend(hw: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
               s_src: torch.Tensor, s_dst: torch.Tensor,
               lay: GATLayout) -> torch.Tensor:
    """``GATAttend``: out [N, H*F]."""
    return GATAttend.apply(hw, a_src, a_dst, s_src, s_dst, lay)
