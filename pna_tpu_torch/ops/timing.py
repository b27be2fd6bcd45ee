"""Kernel timing on the card: the timer ``chip_smoke.py`` uses, the layouts
it times on, and commands that time K1 and K2 alone and the row sum alone.

    python -m pna_tpu_torch.ops.timing
    python -m pna_tpu_torch.ops.timing --rowsum

builds the kernels, times ``csr_moment_sketch`` (with and without tie counts)
and ``csr_dmsg`` through their wrappers at the flagship ZINC step's shapes
and on the hub layout, each after a flush that leaves L2 dirty (the timer of
the port's records) and after one that leaves it clean, beside two
yardsticks (a kernel of one element; device copies of as many bytes as the
kernels must move), and prints one JSON line with the card's name and power
limit.  It uses only what every tree of the port has had since its
first slice (the wrappers' positional arguments, ``csr_layout``, the synthetic
ZINC batch), and passes the layout's segment table where the wrappers take
one.  So the same file, copied over an earlier tree's
``pna_tpu_torch/ops/timing.py`` (``git archive <commit> | tar -x -C <dir>``),
times that tree's kernels: two trees are compared by running the command in
each, in turns, on one card.  Times of different cards or calls do not
compare.

``--rowsum`` times the row sum (``ops/rowsum.py``) at every shape of the
flagship step and at the large graph's (``row_sum_cases``), each after a
dirty and after a clean flush, beside its byte bound, its plain version,
``index_add_`` (the one library call of the same function) and the index's
sort, and prints one JSON line.  It times the row sum as its paths call it
(``ops/segment.py::_row_sum``, over the index's kept layout or a sorted
index's row pointers), which every tree of the port has had since the row
sum came, so it times an earlier tree's row sum the same way.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

SLEEP_CYCLES = 700_000       # about 0.4 ms of the card at 1.7 GHz
# the flagship ZINC net's widths (chip_smoke.py's FLAGSHIP takes them): its
# layers', its last layer's (the readout's) and its bond embedding's
FLAGSHIP_WIDTHS = dict(hidden_dim=70, out_dim=60, edge_dim=50)
FLAGSHIP_F = FLAGSHIP_WIDTHS["hidden_dim"]   # message width of every layer
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_cuda(fn, flush, reps=20, dirty=True):
    """Median ms of ``fn`` on the card, CUDA events around each launch, the
    L2 cache flushed before each one (a kernel of the step finds its inputs
    cold).  Before the first event the card is kept busy for about 0.4 ms
    (``torch.cuda._sleep``), so that the host has queued ``fn`` by the time
    the card reaches it: without that a wrapper whose host work outlasts the
    flush would be timed, not its kernel.

    The flush overwrites ``flush`` (``dirty``, the way every time of the
    port's records was taken: ``fn`` then also pays for the write-back of
    the lines the flush left modified in L2, up to the cache's size) or, with
    ``dirty=False``, reads it, which leaves L2 full of clean lines that cost
    nothing to drop."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
        torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(bytes_moved, ops):
    """The least time of a kernel that moves ``bytes_moved`` and does
    ``ops`` float32 operations, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(x):
    return 0 if x is None else x.numel() * x.element_size()


def flush_buffer(dev):
    """64 MiB to overwrite, more than the card's L2 holds."""
    return torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)


def hub_case(dev, gen):
    """N > 128 nodes, one node owning a fifth of the edges."""
    n, e = 4096, 65536
    recv = torch.randint(0, n, (e,), generator=gen)
    recv[: e // 5] = 17
    recv, _ = torch.sort(recv)
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    ptr[1:] = torch.searchsorted(recv, torch.arange(1, n + 1))
    return ptr.to(dev), e


def make_messages(n_rows, n_feat, dev, gen):
    msg = torch.randn(n_rows, n_feat, generator=gen).to(dev)
    dup = torch.arange(1, n_rows, 5, device=dev)
    msg[dup] = msg[dup - 1]          # neighbouring equal rows: tie material
    return msg.contiguous()


def time_csr_kernels(dev) -> dict:
    """K1 (ties, no ties) and K2 in ms at the flagship shapes and on the
    hub."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.ops import csr_bank, csr_kernels

    ds = ZincDataset.synthetic(n_train=1024, n_val=1, n_test=1, seed=0)
    graph, _ = collate_records(ds.train, with_snorm=True)
    gen = torch.Generator().manual_seed(1)
    flush = flush_buffer(dev)
    layout = csr_bank.csr_layout(graph.edge_ptr.to(dev),
                                 graph.edge_mask.to(dev),
                                 max_in_degree=graph.max_in_degree)
    hub_ptr, hub_rows = hub_case(dev, gen)
    takes_table = "segments" in inspect.signature(
        csr_kernels.csr_moment_sketch).parameters
    out = {"takes_segments": takes_table}
    for name, ptr, n_rows, table in (
            ("slice", layout.ptr, graph.n_edge_pad,
             layout.segments if takes_table else None),
            ("hub", hub_ptr, hub_rows,
             csr_kernels.csr_segments(hub_ptr) if takes_table else None)):
        kw = {"segments": table} if takes_table else {}
        n = ptr.numel() - 1
        msg = make_messages(n_rows, FLAGSHIP_F, dev, gen)
        k6 = csr_kernels.csr_moment_sketch(msg, ptr, True, **kw)
        fields = [torch.randn(n, FLAGSHIP_F, generator=gen).to(dev)
                  for _ in range(4)]
        args = (msg, ptr, *fields, k6[2], k6[3])
        calls = {
            "k1_ties": lambda: csr_kernels.csr_moment_sketch(
                msg, ptr, True, **kw),
            "k1_no_ties": lambda: csr_kernels.csr_moment_sketch(
                msg, ptr, False, **kw),
            "k2": lambda: csr_kernels.csr_dmsg(*args, **kw),
        }
        # yardsticks under the same timer: a kernel of one element (what a
        # launch and the two events cost) and device copies that move as
        # many bytes as K1 with ties and K2 must (half read, half written)
        one = torch.zeros(1, device=dev)
        fields_bytes = 6 * n * FLAGSHIP_F * 4
        k1_bytes = msg.numel() * 4 + fields_bytes
        k2_bytes = 2 * msg.numel() * 4 + n_rows * 4 + fields_bytes
        src = torch.empty(k2_bytes // 8, device=dev)
        dst = torch.empty_like(src)
        calls["one_element_kernel"] = lambda: one.add_(1.0)
        calls["copy_of_k1_bytes"] = lambda: dst[:k1_bytes // 8].copy_(
            src[:k1_bytes // 8])
        calls["copy_of_k2_bytes"] = lambda: dst.copy_(src)
        out[name] = {f"{k}_ms": time_cuda(fn, flush)
                     for k, fn in calls.items()}
        out[name].update({f"{k}_clean_l2_ms": time_cuda(fn, flush,
                                                        dirty=False)
                          for k, fn in calls.items()})
    return out


def row_sum_layout(index, n, ptr=None):
    """(perm, ptr, keys) of the row sum of ``index`` into ``n`` rows, as
    ``ops/segment.py::_row_sum`` passes them: over ``ptr`` for an index
    that is sorted (perm None, the index its own keys), else over its kept
    layout."""
    from pna_tpu_torch.ops import rowsum
    if ptr is not None:
        return None, ptr, index
    return tuple(rowsum.index_layout(index, n))


def row_sum_cases(graph, dev, gen):
    """The row sum's shapes on the flagship step (``graph``, the synthetic
    ZINC batch: the senders' and the sorted receivers' gathers at F = 70,
    the atom lookup of 19,792 rows into 28 types, the bond lookup of 42,368
    rows into 4 at F = 50, the readout of 19,792 rows into 1,025 graph slots
    at F = 60, and F = 1) and on the large graph (the CLI's 1,000,000 power-
    law edges into 100,000 nodes, a 383,653-edge sender, at F = 64 and 70,
    and the receiver hub: a fifth of the edges into node 0, sorted): name ->
    (src, index, rows, ptr of a sorted index or None)."""
    from pna_tpu_torch.data.molecules import NUM_ATOM_TYPE, NUM_BOND_TYPE
    from pna_tpu_torch.parallel.partition import powerlaw_graph
    from pna_tpu_torch.train.largegraph import LargeGraphConfig

    def rnd(rows, f):
        return torch.randn(rows, f, generator=gen).to(dev)

    n, e = graph.n_node_pad, graph.n_edge_pad
    snd, rcv = graph.senders.to(dev), graph.receivers.to(dev)
    cfg = LargeGraphConfig()
    send, recv = powerlaw_graph(cfg.num_nodes, cfg.num_edges, seed=cfg.seed,
                                exponent=cfg.exponent)
    hub = np.sort(np.where(np.arange(cfg.num_edges) < cfg.num_edges // 5, 0,
                           recv))
    hub_ptr = torch.from_numpy(np.searchsorted(
        hub, np.arange(cfg.num_nodes + 1)).astype(np.int32)).to(dev)
    lg_snd = torch.from_numpy(send).to(dev)
    return {
        "flagship senders": (rnd(e, FLAGSHIP_F), snd, n, None),
        "flagship receivers, sorted": (rnd(e, FLAGSHIP_F), rcv, n,
                                       graph.edge_ptr.to(dev)),
        "atom lookup": (rnd(n, FLAGSHIP_F),
                        graph.node_feats.squeeze(-1).to(dev), NUM_ATOM_TYPE,
                        None),
        "bond lookup": (rnd(e, FLAGSHIP_WIDTHS["edge_dim"]),
                        graph.edge_feats.squeeze(-1).to(dev), NUM_BOND_TYPE,
                        None),
        "readout": (rnd(n, FLAGSHIP_WIDTHS["out_dim"]),
                    graph.node_graph_ids.to(dev),
                    graph.n_graph_pad, None),
        "flagship senders F=1": (rnd(e, 1), snd, n, None),
        "largegraph senders": (rnd(cfg.num_edges, cfg.hidden_dim), lg_snd,
                               cfg.num_nodes, None),
        "largegraph senders F=70": (rnd(cfg.num_edges, FLAGSHIP_F), lg_snd,
                                    cfg.num_nodes, None),
        "receiver hub, sorted": (rnd(cfg.num_edges, cfg.hidden_dim),
                                 torch.from_numpy(hub).to(dev),
                                 cfg.num_nodes, hub_ptr),
    }


def time_row_sum_case(src, index, n, ptr, flush) -> dict:
    """The row sum of ``src`` by ``index`` into ``n`` rows, as its paths call
    it (``ops/segment.py::_row_sum``), timed with ``time_cuda`` after a
    dirty flush (``ms``, the records' way) and a clean one (``clean_ms``),
    beside its bound (src, perm, the keys and out, each moved once: the
    layout's int32 keys, or the sorted index itself), its plain version,
    ``index_add_`` into zeros (both flushes) and the index's sort."""
    from pna_tpu_torch.ops import rowsum, segment
    perm, p = row_sum_layout(index, n, ptr)[:2]
    f = src.shape[1]

    def library():
        return torch.zeros((n, f), dtype=src.dtype,
                           device=src.device).index_add_(0, index, src)

    def kernel():
        return segment._row_sum(src, index, n, ptr)

    keys_bytes = nbytes(index) if perm is None else index.numel() * 4
    bound, by = bound_ms(nbytes(src) + nbytes(perm) + keys_bytes
                         + n * f * src.element_size(), src.numel())
    return dict(
        rows=src.shape[0], nodes=n, f=f, perm=perm is not None,
        bound_ms=bound, bound_by=by,
        ms=time_cuda(kernel, flush),
        clean_ms=time_cuda(kernel, flush, dirty=False),
        plain_ms=time_cuda(lambda: rowsum.sorted_row_sum_plain(src, perm, p),
                           flush),
        library_ms=time_cuda(library, flush),
        library_clean_ms=time_cuda(library, flush, dirty=False),
        sort_ms=time_cuda(lambda: rowsum.sort_layout(index, n), flush))


def time_row_sum(dev) -> dict:
    """``time_row_sum_case`` at every shape of ``row_sum_cases``."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    ds = ZincDataset.synthetic(n_train=1024, n_val=1, n_test=1, seed=0)
    graph, _ = collate_records(ds.train, with_snorm=True)
    flush = flush_buffer(dev)
    cases = row_sum_cases(graph, dev, torch.Generator().manual_seed(12))
    return {name: time_row_sum_case(*case, flush)
            for name, case in cases.items()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    times = (time_row_sum(dev) if argv == ["--rowsum"]
             else time_csr_kernels(dev))
    print(json.dumps({"card": card_line(), **times}), flush=True)


if __name__ == "__main__":
    main()
