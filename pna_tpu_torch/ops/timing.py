"""Kernel timing on the card: the timer ``chip_smoke.py`` uses, the layouts
it times on, and commands that time K1 and K2 alone and the row sum alone.

    python -m pna_tpu_torch.ops.timing
    python -m pna_tpu_torch.ops.timing --rowsum
    python -m pna_tpu_torch.ops.timing --posttrans

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

``--edge-message`` times the edge messages (``csr_kernels.
csr_edge_message``) at the large graph's shape (625,000 nodes, 6,250,000
power-law edges sorted by receiver, F = 64, no edge-feature term) and at
the flagship's and the benchmark's ZINC batches (1,024 and 128 molecules,
F = 70, with the edge-feature term), each after a dirty and a clean flush,
beside its byte bound, its plain version and the library's yardstick (two
``index_select`` and their sum), and prints one JSON line.  Only a tree
that has the kernel runs it.

``--posttrans`` times the PNA layer's scaled posttrans (``ops/posttrans.py``)
at the large graph's layer (625,000 nodes, 4 towers of 16 in and 16 out, 4
aggregators x 3 scalers) and at ZINC's (a b128 batch's 2,944 nodes, 5 towers
of 14 in, 14 and 12 out): the forward and the backward kernels after a dirty
flush, each beside its bound (``posttrans_bytes``, ``posttrans_flops``), the
plain version (autograd's backward alone for the backward) and the library's
yardstick (``z @ W`` and the einsum with w, W built beforehand; backward: the
einsum forming d_y and the two products of d_z and d_W), and prints one JSON
line.  Only a tree that has the kernels runs it.
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


def edge_message_cases(dev, gen):
    """name -> (u, v, senders int32, ptr int32, w or None) of the edge
    messages at the large graph's shape and the ZINC batches'."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.parallel.partition import powerlaw_graph
    n, e = 625_000, 6_250_000
    send, recv = powerlaw_graph(n, e, seed=0, exponent=1.5)
    order = np.argsort(recv, kind="stable")
    ptr = np.searchsorted(recv[order], np.arange(n + 1)).astype(np.int32)

    def rnd(rows, f):
        return torch.randn(rows, f, generator=gen).to(dev)

    cases = {"largegraph": (rnd(n, 64), rnd(n, 64),
                            torch.from_numpy(send[order].astype(np.int32))
                            .to(dev), torch.from_numpy(ptr).to(dev), None)}
    ds = ZincDataset.synthetic(n_train=1024, n_val=1, n_test=1, seed=0)
    for name, count in (("flagship", 1024), ("zinc_b128", 128)):
        g, _ = collate_records(ds.train[:count], with_snorm=True)
        ptr = torch.minimum(g.edge_ptr, g.edge_mask.sum()).to(
            torch.int32).to(dev)
        cases[name] = (rnd(g.n_node_pad, FLAGSHIP_F),
                       rnd(g.n_node_pad, FLAGSHIP_F),
                       g.senders.to(torch.int32).to(dev), ptr,
                       rnd(g.n_edge_pad, FLAGSHIP_F))
    return cases


def time_edge_message(dev) -> dict:
    """The edge messages at every shape of ``edge_message_cases``: the
    kernel after a dirty flush (``ms``) and a clean one (``clean_ms``), its
    bound (msg written, u, v, w, the senders and the row-to-node array each
    moved once), its plain version and the library's two ``index_select``
    and their sum."""
    from pna_tpu_torch.ops import csr_kernels
    flush = flush_buffer(dev)
    out = {}
    for name, (u, v, snd, ptr, w) in edge_message_cases(
            dev, torch.Generator().manual_seed(13)).items():
        segs = csr_kernels.csr_segments(ptr)
        e, f = snd.numel(), u.shape[1]
        row_node = segs.row_node(e).long()
        snd_l = snd.long()

        def kernel():
            return csr_kernels.csr_edge_message(u, v, snd, ptr, w,
                                                segments=segs)

        def library():
            m = u.index_select(0, snd_l) + v.index_select(
                0, row_node.clamp(0, v.shape[0] - 1))
            return m if w is None else m + w

        bound, by = bound_ms(4 * e * f + nbytes(u) + nbytes(v) + nbytes(w)
                             + 8 * e, e * f * (1 if w is None else 2))
        out[name] = dict(
            rows=e, nodes=v.shape[0], f=f, w=w is not None, bound_ms=bound,
            bound_by=by, ms=time_cuda(kernel, flush),
            clean_ms=time_cuda(kernel, flush, dirty=False),
            plain_ms=time_cuda(lambda: csr_kernels.csr_edge_message_plain(
                u, v, snd, ptr, w), flush),
            library_ms=time_cuda(library, flush),
            library_clean_ms=time_cuda(library, flush, dirty=False),
            equal_to_plain=bool(torch.equal(
                kernel(), csr_kernels.csr_edge_message_plain(
                    u, v, snd, ptr, w))))
    return out


def posttrans_bytes(n, t, ft, fo, a, s, shared=False, backward=False):
    """The bytes the scaled posttrans must move, float32: z, h and w read
    once and out written once; backward d_out, z, h and w read once, d_z and
    d_h written once."""
    z, h, w, o = n * a * t * ft, n * (ft if shared else t * ft), s * n, \
        n * t * fo
    return 4 * (2 * z + 2 * h + w + o if backward else z + h + w + o)


def posttrans_flops(n, t, ft, fo, a, s, backward=False):
    """Its float32 operations: 2 N T (A S Ft Fo + Ft Fo) forward (each
    tower's products at its own width, the scalers' products), twice that
    backward."""
    return (2 if backward else 1) * 2 * n * t * (a * s * ft * fo + ft * fo)


def posttrans_cases(dev, gen):
    """name -> (z, h, w, kp, bp, d_out) at the large graph's layer and at
    ZINC's b128 batch's layers."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    out = {}
    for name, (n, t, ft, fo) in (("largegraph", (625_000, 4, 16, 16)),
                                 ("zinc_b128", (2_944, 5, 14, 14)),
                                 ("zinc_b128_last", (2_944, 5, 14, 12))):
        out[name] = (rnd(n, 4, t * ft), rnd(n, t * ft),
                     (torch.rand(3, n, generator=gen) + 0.5).to(dev),
                     rnd(t, 13 * ft, fo) / ft, rnd(t, fo), rnd(n, t, fo))
    return out


def time_posttrans(dev) -> dict:
    """The scaled posttrans at every shape of ``posttrans_cases``: forward
    and backward, kernel (after a dirty flush), bound, plain version,
    library; the kernels' largest gap to the plain version."""
    from pna_tpu_torch.ops import posttrans as pt
    flush = flush_buffer(dev)
    res = {}
    for name, (z, h, w, kp, bp, d_out) in posttrans_cases(
            dev, torch.Generator().manual_seed(14)).items():
        n, a, tf = z.shape
        t, _, fo = kp.shape
        ft, s = tf // t, w.shape[0]
        with torch.no_grad():
            kagg = kp[:, ft:].reshape(t, s, a, ft, fo)
            W = torch.einsum('tsafo,tu->atfuos', kagg, torch.eye(
                t, device=dev)).reshape(a * t * ft, t * fo * s)
        zf = z.reshape(n, a * t * ft)

        def library_fwd():
            y = (zf @ W).reshape(n, t, fo, s)
            return torch.einsum('ntos,sn->nto', y, w)

        def library_bwd():
            dy = torch.einsum('nto,sn->ntos', d_out, w).reshape(n, -1)
            return dy @ W.t(), zf.t() @ dy

        zg, hg, kg, bg = (x.clone().requires_grad_() for x in (z, h, kp, bp))
        plain_out = pt.scaled_posttrans_plain(zg, hg, w, kg, bg)

        def plain_bwd():
            return torch.autograd.grad(plain_out, (zg, hg, kg, bg), d_out,
                                       retain_graph=True)

        got = (pt.scaled_posttrans_fwd(z, h, w, kp, bp),
               *pt.scaled_posttrans_bwd(z, h, w, kp, d_out))
        want = (plain_out.detach(), *plain_bwd())
        gap = max(float((g - x).abs().max() / x.abs().max())
                  for g, x in zip(got, want))
        row = dict(nodes=n, towers=t, ft=ft, fo=fo, max_rel_gap=gap)
        for way, kernel, plain, library in (
                ("fwd", lambda: pt.scaled_posttrans_fwd(z, h, w, kp, bp),
                 lambda: pt.scaled_posttrans_plain(z, h, w, kp, bp),
                 library_fwd),
                ("bwd", lambda: pt.scaled_posttrans_bwd(z, h, w, kp, d_out),
                 plain_bwd, library_bwd)):
            back = way == "bwd"
            bound, by = bound_ms(posttrans_bytes(n, t, ft, fo, a, s,
                                                 backward=back),
                                 posttrans_flops(n, t, ft, fo, a, s,
                                                 backward=back))
            with torch.no_grad() if not back else torch.enable_grad():
                row[way] = dict(bound_ms=bound, bound_by=by,
                                ms=time_cuda(kernel, flush),
                                plain_ms=time_cuda(plain, flush),
                                library_ms=time_cuda(library, flush))
        res[name] = row
    return res


def gat_case(n, e, heads, f, dev, seed=0, seg=None):
    """A GAT layer's attention inputs at (n receivers, e edges): the large
    graph's power-law senders (``partition.powerlaw_graph``, exponent 1.5:
    a sender of ~38% of the edges), uniform receivers, sorted by receiver;
    its ``ops/csr_gat.py::GATLayout`` (senders cut at ``seg``), hw [n,
    heads f], the attention vectors and their scores, from ``seed``."""
    from pna_tpu_torch.ops import csr_gat
    from pna_tpu_torch.parallel.partition import powerlaw_graph
    send, recv = powerlaw_graph(n, e, seed=seed, exponent=1.5)
    order = np.argsort(recv, kind='stable')
    ptr = np.searchsorted(recv[order], np.arange(n + 1)).astype(np.int32)
    lay = csr_gat.build_gat_layout(
        torch.from_numpy(ptr).to(dev),
        torch.from_numpy(send[order].astype(np.int32)).to(dev), n,
        seg=seg or csr_gat.SEG)
    gen = torch.Generator().manual_seed(seed)
    hw = torch.randn(n, heads * f, generator=gen).to(dev)
    a_src = (torch.randn(heads, f, generator=gen) / f ** 0.5).to(dev)
    a_dst = (torch.randn(heads, f, generator=gen) / f ** 0.5).to(dev)
    s_src, s_dst = csr_gat.head_scores(hw, a_src, a_dst, n)
    return lay, hw, a_src, a_dst, s_src, s_dst


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    times = (time_row_sum(dev) if argv == ["--rowsum"]
             else time_edge_message(dev) if argv == ["--edge-message"]
             else time_posttrans(dev) if argv == ["--posttrans"]
             else time_csr_kernels(dev))
    print(json.dumps({"card": card_line(), **times}), flush=True)


if __name__ == "__main__":
    main()
