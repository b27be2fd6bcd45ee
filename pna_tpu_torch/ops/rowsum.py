"""The port's deterministic scatter-add: a row sum over the index's stable
sort.

``pna_tpu`` adds rows by index with XLA's scatter-add (the VJP of a gather,
``jax.ops.segment_sum``), which adds in a fixed order on the TPU and the CPU.
On the card, ``index_add_`` adds with float atomics in an order that changes
from run to run, so two runs of a step from the same state differ in the last
bits and a resumed run drifts from a straight one.  Every float row
scatter-add of the port goes through ``sorted_row_sum`` on the card instead
(``ops/segment.py``: the backward of ``gather_rows``, ``segment_sum``;
``ops/csr_fused.py``'s ``d_u``; ``ops/partial_stats.py``):

* ``index_layout(index, n)`` is the layout of a scatter into ``n`` rows:
  ``perm``, the stable sort of the index (int32), ``ptr`` [n+1] int32, the
  row pointers of the sorted index (``torch.searchsorted``), and ``keys``,
  the sorted index itself (int32), from which the kernel reads each sorted
  position's row.  No host synchronisation.  The layout is kept on the index
  tensor, so the senders gathered by every layer of a batch are sorted once;
  an index the caller knows to be sorted (the receivers of a
  ``sort_edges=True`` batch, whose ``edge_ptr`` is its ``ptr``) needs no
  layout: ``perm`` None, the index its own keys;
* ``sorted_row_sum(src, perm, ptr, keys)`` -> ``out [n, F]``, ``out[k] =
  sum of src[perm[i]] over i in [ptr[k], ptr[k+1])`` in float32, rounded once
  to the output type: the CUDA kernel ``csrc/sorted_row_sum.cu`` on the card,
  its plain version for a tensor on the CPU.  ``keys`` (int32 or int64) must
  hold each position's row in ``[ptr[0], ptr[n])``: the kernel reads the
  rows from them, never from ``ptr``.  Its launches count in
  ``sorted_row_sum.launches`` (registered with K1-K4 in
  ``csr_fused_kernels.launch_counts``);
* ``sorted_row_sum_plain`` is that sum in torch, in the kernel's order of
  addition (tiles of ``TILE`` sorted positions, chunks of ``CHUNK``, strips
  of ``strip(...)`` positions, the merge of a node that spans tiles in
  ``MERGE_RUNS`` runs; see the source), so that on the CPU, where
  ``index_add_`` adds in index order, it gives the kernel's bits.  The order
  does not depend on ``keys``.  The CPU tests and ``chip_smoke.py`` hold the
  kernel to it; no path takes it when a card is present.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pna_tpu_torch.ops import build

TILE = 256          # kTile of csrc/sorted_row_sum.cu: sorted positions a block
CHUNK = 32          # kChunk: sorted positions a warp
FEAT = 128          # kFeat: features of a block, at most
MERGE_RUNS = 32     # kMergeRuns: runs of a split node's merge

_DTYPES = (torch.float32, torch.bfloat16)
_KEY_DTYPES = (torch.int32, torch.int64)


class RowLayout(NamedTuple):
    perm: Optional[torch.Tensor]    # [E] int32; None: the index is sorted
    ptr: torch.Tensor               # [n+1] int32
    keys: torch.Tensor              # [E] int32: the sorted index


def sort_layout(index: torch.Tensor, n: int) -> RowLayout:
    """The layout of ``index`` [E] into ``n`` rows, built anew: its stable
    sort, the row pointers of the sorted index and the sorted index as int32
    keys; ids outside ``[0, n)`` fall outside ``[ptr[0], ptr[n])`` and are
    dropped."""
    vals, perm = torch.sort(index.reshape(-1), stable=True)
    ptr = torch.searchsorted(
        vals, torch.arange(n + 1, device=vals.device, dtype=vals.dtype),
        out_int32=True)
    return RowLayout(perm.to(torch.int32), ptr, vals.to(torch.int32))


def index_layout(index: torch.Tensor, n: int) -> RowLayout:
    """The layout of a scatter of ``index`` [E] into ``n`` rows
    (``sort_layout``), kept on the index tensor (on its base, for a view
    such as ``node_feats.squeeze(-1)`` or a column ``x[:, i]``), keyed on
    ``n``, the tensor's version and the view's place, so a later scatter by
    the same tensor reuses it: a layout belongs to its index tensor, and a
    graph whose edges move (``Graph.to``, ``sort_by_receiver``) has new
    index tensors."""
    holder = index if index._base is None else index._base
    key = (n, index._version, index.data_ptr(), tuple(index.shape),
           index.stride())
    kept = holder.__dict__.setdefault("_pna_row_layouts", {})
    if key not in kept:
        kept[key] = sort_layout(index, n)
    return kept[key]


def strip(n_feat: int, fc: int) -> int:
    """Sorted positions a lane group of the kernel adds alone, in a block of
    ``fc`` of a row's ``n_feat`` features: a lane holds V = 4, 2 or 1
    features (the largest that divides ``n_feat``), a row ``fc / V`` lanes,
    and a warp R rows, the largest power of two with R fc / V <= 32; a
    group's strip is ``CHUNK / R`` positions."""
    vec = 4 if n_feat % 4 == 0 else 2 if n_feat % 2 == 0 else 1
    groups = 1
    while 2 * groups * (fc // vec) <= 32:
        groups *= 2
    return CHUNK // groups


def _groups(keys: torch.Tensor):
    """Group ids of a nondecreasing key sequence and each group's first
    position."""
    _, inv, counts = torch.unique_consecutive(keys, return_inverse=True,
                                              return_counts=True)
    return inv, torch.cumsum(counts, 0) - counts


def _add(src: torch.Tensor, ids: torch.Tensor, n_groups: int):
    return src.new_zeros((n_groups, src.shape[1])).index_add_(0, ids, src)


def _ordered_sum(x, pos, node, lo, n, run):
    """The rows ``x`` at sorted positions ``pos`` of rows ``node`` summed in
    the kernel's order with strips of ``run`` positions: [n, x.shape[1]]."""
    # (1) strip pieces, keyed (strip, node), and (where a strip is shorter
    # than a chunk) chunk pieces, keyed (chunk, node)
    for span in (run, CHUNK) if run < CHUNK else (run,):
        ids, first = _groups((pos // span) * (n + 1) + node)
        x, pos, node = _add(x, ids, first.numel()), pos[first], node[first]
    # (2) tile pieces, keyed (tile, node)
    tile = pos // TILE
    ids, first = _groups(tile * (n + 1) + node)
    x, tile, node = _add(x, ids, first.numel()), tile[first], node[first]
    # (3) runs of the tile pieces of a node over tiles t0..t1
    t0 = lo[node] // TILE
    m = (lo[node + 1] - 1) // TILE - t0 + 1
    run_of = (tile - t0) // ((m + MERGE_RUNS - 1) // MERGE_RUNS)
    ids, first = _groups(node * MERGE_RUNS + run_of)
    x, node = _add(x, ids, first.numel()), node[first]
    # (4) the runs of each node
    return x.new_zeros((n, x.shape[1])).index_add_(0, node, x)


def sorted_row_sum_plain(src: torch.Tensor, perm: Optional[torch.Tensor],
                         ptr: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version of the kernel: ``src`` [E, F] -> [n, F], n =
    ``ptr.numel() - 1``, summed in float32 in the kernel's order, for each
    block of ``FEAT`` features: (1) each node's rows of a strip of
    ``strip(F, fc)`` sorted positions, and where that is shorter than
    ``CHUNK``, a node's strip pieces within a chunk of ``CHUNK``, (2) a
    node's chunk pieces within a tile of ``TILE``, (3) a node's tile pieces
    in runs of ceil(m / ``MERGE_RUNS``) for a node over m tiles, (4) the
    runs; each stage from 0, in order.  Where ``index_add_`` adds in index
    order (the CPU) that is the kernel's rounding at every step."""
    out_dtype = src.dtype if out_dtype is None else out_dtype
    n, (e, f) = ptr.numel() - 1, src.shape
    x = src.to(torch.float32)
    if perm is not None:
        x = x.index_select(0, perm.long().clamp(0, max(e - 1, 0)))
    lo = ptr.long().clamp(0, e)
    pos = torch.arange(e, device=src.device)
    node = torch.searchsorted(lo, pos, right=True) - 1
    keep = (node >= 0) & (node < n)
    pos, node, x = pos[keep], node[keep], x[keep]
    out = torch.zeros((n, f), dtype=torch.float32, device=src.device)
    if pos.numel() == 0:
        return out.to(out_dtype)
    runs = {}
    for f0 in range(0, f, FEAT):
        fc = min(FEAT, f - f0)
        runs.setdefault(strip(f, fc), []).extend(range(f0, f0 + fc))
    for run, cols in runs.items():
        cols = torch.tensor(cols, device=src.device)
        out[:, cols] = _ordered_sum(x[:, cols], pos, node, lo, n, run)
    return out.to(out_dtype)


def _check(src, perm, ptr, out_dtype, keys):
    name = "sorted_row_sum"
    if src.ndim != 2 or src.dtype not in _DTYPES:
        raise ValueError(f"{name}: src must be 2-D float32 or bfloat16, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if out_dtype not in _DTYPES or (out_dtype == torch.bfloat16
                                    and src.dtype != torch.bfloat16):
        raise ValueError(f"{name}: out_dtype {out_dtype} from a {src.dtype} "
                         "src (float32, or bfloat16 from bfloat16)")
    if ptr.dtype != torch.int32 or ptr.ndim != 1 or ptr.numel() < 1:
        raise ValueError(f"{name}: ptr must be 1-D int32, got "
                         f"{tuple(ptr.shape)} {ptr.dtype}")
    if perm is not None and (perm.dtype != torch.int32
                             or tuple(perm.shape) != (src.shape[0],)):
        raise ValueError(f"{name}: perm must be int32 [{src.shape[0]}], got "
                         f"{tuple(perm.shape)} {perm.dtype}")
    if keys.dtype not in _KEY_DTYPES or tuple(keys.shape) != (src.shape[0],):
        raise ValueError(f"{name}: keys must be int32 or int64 "
                         f"[{src.shape[0]}], got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    for x in (src, ptr, perm, keys):
        if x is None:
            continue
        if x.device != src.device:
            raise ValueError(f"{name}: inputs on {x.device} and {src.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {src.device}")
    if src.shape[0] >= 2 ** 31 - 2 * TILE or ptr.numel() >= 2 ** 31 - 2 * TILE:
        raise ValueError(f"{name}: sizes must fit int32")


def sorted_row_sum(src: torch.Tensor, perm: Optional[torch.Tensor],
                   ptr: torch.Tensor, keys: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """src [E, F] float32 or bfloat16, perm [E] int32 or None, ptr [n+1]
    int32, keys [E] int32 or int64 (each sorted position's row, as
    ``RowLayout.keys``; the sorted index itself where ``perm`` is None) ->
    [n, F] in ``out_dtype`` (default src's type; float32 from either), every
    row written.  One call counts one launch (of the tile kernel and the
    merge behind it)."""
    out_dtype = src.dtype if out_dtype is None else out_dtype
    _check(src, perm, ptr, out_dtype, keys)
    if src.device.type == "cpu":
        return sorted_row_sum_plain(src, perm, ptr, out_dtype)
    n, e, f = ptr.numel() - 1, src.shape[0], src.shape[1]
    out = torch.empty((n, f), dtype=out_dtype, device=src.device)
    if n == 0 or f == 0:
        return out
    lib = build.load()
    if lib.pna_sorted_row_sum_tile() != TILE:
        raise RuntimeError("sorted_row_sum: the kernel's tile is "
                           f"{lib.pna_sorted_row_sum_tile()}, not {TILE}")
    tiles = max(1, -(-e // TILE))
    with torch.cuda.device(src.device):
        # two partial rows a tile, then 5 ints a tile and one a tile and
        # block of FEAT features
        part = torch.empty(tiles * (2 * f + 5 + -(-f // FEAT)),
                           dtype=torch.float32, device=src.device)
        rc = lib.pna_sorted_row_sum(
            src.data_ptr(), int(src.dtype == torch.bfloat16),
            None if perm is None else perm.data_ptr(),
            keys.data_ptr(), int(keys.dtype == torch.int64),
            ptr.data_ptr(), e, n, f, out.data_ptr(),
            int(out_dtype == torch.bfloat16), part.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream)
    build.check(lib, rc, "sorted_row_sum")
    sorted_row_sum.launches += 1
    return out


sorted_row_sum.launches = 0
