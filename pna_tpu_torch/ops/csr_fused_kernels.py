"""The fused pretrans kernels: K3 moment sketch and K4 message gradient, with
the message formed inside the kernel; and the registry of all four kernels.

Counterpart of the pretrans half of ``pna_tpu/ops/pallas_kernels.py``:

* ``csr_pretrans_sketch`` replaces ``sorted_pretrans_sketch`` (CUDA source
  ``pna_tpu_torch/csrc/csr_pretrans_sketch.cu``);
* ``csr_pretrans_dmsg`` replaces ``sorted_pretrans_dmsg``
  (``pna_tpu_torch/csrc/csr_pretrans_dmsg.cu``).

The message of edge ``e`` into node ``r`` is
``m[e] = (u[senders[e]] + v[r]) + sum_k ef[e, k] * ke[k]``, formed in the
order of ``csrc/pretrans_msg.cuh``.  ``u [Nu, F]`` may have more rows than
``v [N, F]`` (a ghost sender table); ``senders [E]`` indexes ``u`` and
``ptr [N+1]`` spans ``v``'s nodes, with the CSR layout contract of
``csr_kernels``.  The kernels walk the segment table of ``ptr``
(``csr_kernels.csr_segments``): a range longer than ``SEG`` edges is cut,
its segments write partial results, and a second small kernel merges them in
segment order (``merge_segment_sketches_plain`` is that merge in plain
torch).  The wrappers cast ``u`` to float32, as the JAX wrapper
does; ``v``, ``ef`` and ``ke`` are all float32 or all bfloat16 (the kernels
widen bfloat16 on load).  Every output is float32.

Each wrapper checks its inputs, counts its launches in ``.launches`` and
takes the plain version (``*_plain``) only for tensors on the CPU.  The
plain versions form the edge-feature term by a loop over ``k`` with one
multiply and one add per step, never ``ef @ ke``, so their messages are
bit-identical to the kernels' and max, min and tie counts can be compared
exactly on the card.

There is no capacity rule here.  The TPU kernels keep ``u`` resident in
VMEM, so the JAX package checks ``pretrans_fits_vmem`` (a 12 MiB budget);
these kernels read ``u`` through L2 (5.5 MB at the flagship ZINC step, on a
card with a 50 MB L2) and take any size that fits int32 indexing and whose
tile fits a block's shared memory (``pretrans_tile`` of
``csrc/pretrans_msg.cuh``: the ``[Fe, F]`` slice of ``ke``, and ``Fe + F``
values for each of up to 64 edges, in float32, for at most 128 of the ``F``
features at a time): ``Fe`` up to 388 at ``F`` = 70, up to 320 at any ``F``;
a wider ``ef`` raises ``ValueError`` on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from pna_tpu_torch.ops import build
from pna_tpu_torch.ops import csr_kernels as ck
from pna_tpu_torch.ops import segment as seg

_FLOATS = (torch.float32, torch.bfloat16)


def pretrans_messages_plain(u, v, senders, ptr, ef=None, ke=None):
    """The message of every row, [E, F] float32, with the kernels'
    roundings.  Senders are clamped into ``[0, Nu)`` as the kernels clamp
    them; rows outside every range take node ``N - 1``'s ``v``."""
    ids, _ = ck._row_segments(ptr, senders.shape[0])
    snd = senders.long().clamp(0, u.shape[0] - 1)
    m = u.float()[snd] + v.float()[ids]
    if ef is not None and ef.shape[1] > 0:
        ef, ke = ef.float(), ke.float()
        acc = ef[:, 0:1] * ke[0]
        for k in range(1, ef.shape[1]):
            acc = acc + ef[:, k:k + 1] * ke[k]
        m = m + acc
    return m


def csr_pretrans_sketch_plain(u, v, senders, ptr, ef=None, ke=None,
                              with_ties: bool = False):
    """Plain version of K3: K1's plain version over the formed messages."""
    m = pretrans_messages_plain(u, v, senders, ptr, ef, ke)
    return ck.csr_moment_sketch_plain(m, ptr, with_ties)


def csr_pretrans_dmsg_plain(u, v, senders, ptr, g_lin, g_quad, g_max, g_min,
                            mx, mn, ef=None, ke=None):
    """Plain version of K4: K2's plain version over the formed messages, and
    the per-node sum of its rows.  Rows outside every range are 0."""
    m = pretrans_messages_plain(u, v, senders, ptr, ef, ke)
    d_msg = ck.csr_dmsg_plain(m, ptr, g_lin, g_quad, g_max, g_min, mx, mn)
    ids, valid = ck._row_segments(ptr, m.shape[0])
    return d_msg, seg.segment_sum(d_msg, ids, ptr.numel() - 1, valid)


def merge_segment_sketches_plain(parts, segments: ck.CSRSegments):
    """Plain version of the kernels' second pass: per-segment sketches
    (sum, sumsq, max, min [, ties_max, ties_min], each [S, F]) -> per-node
    ones [N, F] by the kernels' rule.  Sums add; the node's max (min) is
    the largest (smallest) of its segments', and its tie count the sum of
    the counts of the segments that reach it.  An empty segment (0, 0, 0, 0,
    1, 1) is the only one of its node and passes through."""
    if segments.seg_node is None:
        return tuple(parts)
    ids, n = segments.seg_node.long(), segments.n_nodes
    s, sq = (seg.segment_sum(p, ids, n) for p in parts[:2])
    mx = seg.segment_max(parts[2], ids, n)
    mn = seg.segment_min(parts[3], ids, n)
    if len(parts) == 4:
        return s, sq, mx, mn
    tmx = seg.segment_sum(parts[4] * (parts[2] == mx[ids]), ids, n)
    tmn = seg.segment_sum(parts[5] * (parts[3] == mn[ids]), ids, n)
    return s, sq, mx, mn, tmx, tmn


def _check(name, u, v, senders, ptr, ef, ke, fields=()):
    if u.ndim != 2 or u.dtype != torch.float32 or u.shape[0] < 1:
        raise ValueError(f"{name}: u must be 2-D float32 with a row, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if ptr.dtype != torch.int32 or ptr.ndim != 1 or ptr.numel() < 1:
        raise ValueError(f"{name}: ptr must be 1-D int32, got "
                         f"{tuple(ptr.shape)} {ptr.dtype}")
    if senders.dtype != torch.int32 or senders.ndim != 1:
        raise ValueError(f"{name}: senders must be 1-D int32, got "
                         f"{tuple(senders.shape)} {senders.dtype}")
    n, f, e = ptr.numel() - 1, u.shape[1], senders.shape[0]
    if v.dtype not in _FLOATS or tuple(v.shape) != (n, f):
        raise ValueError(f"{name}: v must be float32 or bfloat16 [{n}, {f}],"
                         f" got {tuple(v.shape)} {v.dtype}")
    if (ef is None) != (ke is None):
        raise ValueError(f"{name}: pass both ef and ke, or neither")
    if ef is not None:
        if ef.dtype not in _FLOATS or ef.ndim != 2 or ef.shape[0] != e:
            raise ValueError(f"{name}: ef must be float32 or bfloat16 "
                             f"[{e}, Fe], got {tuple(ef.shape)} {ef.dtype}")
        if ke.dtype not in _FLOATS or tuple(ke.shape) != (ef.shape[1], f):
            raise ValueError(f"{name}: ke must be float32 or bfloat16 "
                             f"[{ef.shape[1]}, {f}], got {tuple(ke.shape)} "
                             f"{ke.dtype}")
        if not v.dtype == ef.dtype == ke.dtype:
            raise ValueError(f"{name}: v, ef and ke must share one type, got"
                             f" {v.dtype}, {ef.dtype}, {ke.dtype}")
    for x in fields:
        if x.dtype != torch.float32 or tuple(x.shape) != (n, f):
            raise ValueError(f"{name}: node fields must be float32 [{n}, {f}],"
                             f" got {tuple(x.shape)} {x.dtype}")
    tensors = [x for x in (u, v, senders, ptr, ef, ke, *fields)
               if x is not None]
    for x in tensors:
        if x.device != u.device:
            raise ValueError(f"{name}: inputs on {x.device} and {u.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {u.device}")
    if max(n + 1, e, u.shape[0]) >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit int32")


def _check_shared(name, f, ef):
    """The kernel library's own account of a block's shared memory: a tile
    too large for a block is refused here, in words, before the launch would
    refuse it with a CUDA error."""
    fe = 0 if ef is None else ef.shape[1]
    lib = build.load()
    need, limit = (lib.pna_pretrans_shared_bytes(f, fe),
                   lib.pna_pretrans_shared_limit())
    if need > limit:
        raise ValueError(f"{name}: Fe = {fe} edge features at F = {f} need "
                         f"{need} bytes of shared memory, over the {limit} a "
                         f"block may use")


def _table_args(u, v, senders, segs, ef, ke):
    """Pointers shared by both entry points, up to the bfloat16 flag, and
    the sizes from ``n_seg`` to ``fe``."""
    at = ck._at
    fe = 0 if ef is None else ef.shape[1]
    return ([u.data_ptr(), v.data_ptr(), senders.data_ptr(),
             segs.seg_ptr.data_ptr(), at(segs.seg_node), at(segs.seg_slot),
             at(segs.split_node), at(segs.split_ptr), at(ef), at(ke),
             int(v.dtype == torch.bfloat16)],
            [segs.n_seg, segs.n_split, segs.n_part, segs.n_nodes, u.shape[0],
             senders.shape[0], u.shape[1], fe])


def _launch_sketch(u, v, senders, segs, ef, ke, with_ties):
    """Allocate K3's outputs (and the partials of split nodes) and launch."""
    n, f = segs.n_nodes, u.shape[1]
    outs = [torch.empty((n, f), dtype=torch.float32, device=u.device)
            for _ in range(6 if with_ties else 4)]
    tie_ptrs = ([o.data_ptr() for o in outs[4:]] if with_ties
                else [None, None])
    part = (torch.empty((segs.n_part, 6, f), dtype=torch.float32,
                        device=u.device) if segs.n_split else None)
    head, sizes = _table_args(u, v, senders, segs, ef, ke)
    lib = build.load()
    rc = lib.pna_csr_pretrans_sketch(
        *head, *sizes, *[o.data_ptr() for o in outs[:4]], *tie_ptrs,
        None if part is None else part.data_ptr(), int(with_ties),
        ck._stream(u.device))
    build.check(lib, rc, "csr_pretrans_sketch")
    return tuple(outs)


def _launch_dmsg(u, v, senders, segs, fields, ef, ke):
    """Allocate K4's outputs (and the partials of split nodes) and launch."""
    f = u.shape[1]
    d_msg = torch.empty((senders.shape[0], f), dtype=torch.float32,
                        device=u.device)
    d_v = torch.empty((segs.n_nodes, f), dtype=torch.float32, device=u.device)
    part = (torch.empty((segs.n_part, f), dtype=torch.float32,
                        device=u.device) if segs.n_split else None)
    head, sizes = _table_args(u, v, senders, segs, ef, ke)
    lib = build.load()
    rc = lib.pna_csr_pretrans_dmsg(
        *head, *[x.data_ptr() for x in fields], *sizes, d_msg.data_ptr(),
        d_v.data_ptr(), None if part is None else part.data_ptr(),
        ck._stream(u.device))
    build.check(lib, rc, "csr_pretrans_dmsg")
    return d_msg, d_v


def csr_pretrans_sketch(u: torch.Tensor, v: torch.Tensor,
                        senders: torch.Tensor, ptr: torch.Tensor,
                        ef: Optional[torch.Tensor] = None,
                        ke: Optional[torch.Tensor] = None,
                        with_ties: bool = False,
                        segments: Optional[ck.CSRSegments] = None):
    """K3.  u [Nu, F], v [N, F], int32 senders [E] and ptr [N+1], optional
    ef [E, Fe] and ke [Fe, F] -> 4 (or 6 with ties) [N, F] float32 tensors:
    sum, sumsq, max, min (, ties_max, ties_min) of the messages.

    ``segments`` is the segment table of ``ptr`` (``CSRLayout.segments``),
    the kernel's work list; without it the table is built here, which reads
    the degrees back from the card.  One call counts one launch; where a
    node is split it starts a second small kernel that merges the partials.
    """
    u = u.to(torch.float32)
    _check("csr_pretrans_sketch", u, v, senders, ptr, ef, ke)
    ck.check_segments("csr_pretrans_sketch", segments, ptr)
    if u.device.type == "cpu":
        return csr_pretrans_sketch_plain(u, v, senders, ptr, ef, ke,
                                         with_ties)
    _check_shared("csr_pretrans_sketch", u.shape[1], ef)
    segs = ck.csr_segments(ptr) if segments is None else segments
    with torch.cuda.device(u.device):
        outs = _launch_sketch(u, v, senders, segs, ef, ke, with_ties)
    csr_pretrans_sketch.launches += 1
    return outs


csr_pretrans_sketch.launches = 0


def csr_pretrans_dmsg(u, v, senders, ptr, g_lin, g_quad, g_max, g_min, mx,
                      mn, ef=None, ke=None,
                      segments: Optional[ck.CSRSegments] = None):
    """K4.  The inputs of K3 and six [N, F] float32 node fields (g_max/g_min
    already divided by the tie counts; mx/mn K3's max/min) -> (d_msg [E, F],
    d_v [N, F]), float32.  Rows of d_msg outside every node's range (the pad
    edges past ``ptr[N]``) are 0.  ``segments`` as in K3."""
    u = u.to(torch.float32)
    fields = (g_lin, g_quad, g_max, g_min, mx, mn)
    _check("csr_pretrans_dmsg", u, v, senders, ptr, ef, ke, fields)
    ck.check_segments("csr_pretrans_dmsg", segments, ptr)
    if u.device.type == "cpu":
        return csr_pretrans_dmsg_plain(u, v, senders, ptr, *fields, ef, ke)
    _check_shared("csr_pretrans_dmsg", u.shape[1], ef)
    segs = ck.csr_segments(ptr) if segments is None else segments
    with torch.cuda.device(u.device):
        out = _launch_dmsg(u, v, senders, segs, fields, ef, ke)
    csr_pretrans_dmsg.launches += 1
    return out


csr_pretrans_dmsg.launches = 0

# every CUDA kernel of the port, K1..K4
KERNELS = (ck.csr_moment_sketch, ck.csr_dmsg, csr_pretrans_sketch,
           csr_pretrans_dmsg)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
