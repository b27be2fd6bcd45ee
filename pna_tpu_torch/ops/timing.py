"""Kernel timing on the card: the timer ``chip_smoke.py`` uses, the layouts
it times on, and a command that times K1 and K2 alone.

    python -m pna_tpu_torch.ops.timing

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
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys

import torch

SLEEP_CYCLES = 700_000       # about 0.4 ms of the card at 1.7 GHz
FLAGSHIP_F = 70              # message width of every layer of the flagship


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


def main():
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        sys.exit(1)
    times = time_csr_kernels(torch.device("cuda"))
    print(json.dumps({"card": card_line(), **times}), flush=True)


if __name__ == "__main__":
    main()
