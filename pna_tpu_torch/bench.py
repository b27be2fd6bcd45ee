"""Benchmark harness of the port, the twin of ``bench.py``: prints ONE JSON
line with the headline metric, edges/sec/chip of a full PNA training step in
the reference's headline ZINC configuration (edge features on: L=4, hidden
70, out 60, edge_dim 50, towers 5, mean/max/min/std x identity/
amplification/attenuation, graph- and batch-norm, residual; 1024 synthetic
graphs), in float32 and with bfloat16 compute.

    python -m pna_tpu_torch.bench                  # csr, f32 and bf16, the card
    python -m pna_tpu_torch.bench --kernel csr_fused --dtype f32
    python -m pna_tpu_torch.bench --device cpu --batch 8 --iters 2  # plain versions

"edges/sec" counts message-layer traversals: real edges x 4 layers / step
time (``bench.py:9-10``).  Each dtype's step is timed in blocks of
``--iters / --repeats`` steps, each ending in ``torch.cuda.synchronize()``,
the dtypes' blocks interleaved, and the step time is the minimum block mean;
the headline is bf16's when it was timed.

Departures from ``bench.py``:

* ``--kernel`` defaults to ``csr`` (K1/K2), the port's default backend
  (``nn/nets.py``), not ``auto``; every backend takes the receiver-sorted
  batch, where ``auto`` resolves to ``csr`` on the card.  ``bench.py``'s
  ``auto`` on its degree-bucketed batch has no counterpart: the port has no
  bucketed or ELL layout, and ``--kernel bucketed`` or ``ell`` raises
  ``ValueError``, as do the JAX names ``pallas`` and ``pallas_fused``,
  naming ``csr`` and ``csr_fused``.
* ``vs_baseline`` is null: ``benchmarks/baseline_value.json`` holds a TPU
  reading, and this harness neither reads nor writes any file.
* XLA's cost analysis has no counterpart.  ``matmul_tflops_per_step`` is
  what ``torch.utils.flop_counter.FlopCounterMode`` counts over one step:
  the matrix products only, as they run: the zero blocks of the towers'
  block-diagonal weights (``nn/fused.py::_ein``) count; K1-K4, the gathers,
  the elementwise work and the reductions do not.  ``mfu`` is those FLOPs / step time / the
  card's dense peak for the dtype the products ran in (``matmul_dtype``):
  the bf16 path widens its rounded operands to float32 (``nn/fused.py``), so
  its products run on the CUDA cores too, as float32 does with TF32 off.
  Peaks are NVIDIA's H100 SXM5 data sheet's, keyed by the card's name; on
  another card, and on the CPU, ``mfu`` is null.
* Per dtype, three steps after the timed blocks run under the profiler
  (``utils/profiling.py``): ``device_ms_per_step`` (the kernels' own time),
  ``busy`` (that over ``step_ms``), ``kernels_per_step``, the longest
  kernels (``top_kernels``), and the launches per step of K1-K4 and the
  row sum from the wrappers' counts.  The profiled steps are not
  the timed ones.  On the CPU the device fields are null.
* ``detail`` names the card and its power limit (nvidia-smi), the torch
  and CUDA versions, the host's CPU, the backend each layer resolved to,
  and the wall-clock start of every block (the host's speed differs between
  calls).

The optimiser is Adam 1e-3 over one flat vector by default (``FlatAdam``,
the counterpart of ``optax.flatten(optax.adam)``); ``--no_flat_opt`` takes
the per-tensor ``torch.optim.Adam``.  ``--remat`` recomputes each layer in
the backward pass.  Weights come from a generator seeded with ``seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from pna_tpu_torch.device import DeviceLike, resolve_device

N_LAYERS = 4
METRIC = "pna_zinc_train_step_edges_per_sec_per_chip"
PROFILE_STEPS = 3
TOP_KERNELS = 5              # the longest device kernels a report names
DTYPES = {"f32": None, "bf16": torch.bfloat16}
# dense peak FLOP/s of NVIDIA's H100 SXM5 data sheet: float32 on the CUDA
# cores, TF32 and bf16 on the tensor cores
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12,
                                        "bfloat16": 989e12}}


def build_bench(batch_graphs_n: int = 1024, seed: int = 0,
                edge_feat: bool = True, compute_dtype=None,
                kernel: str = 'csr', flat_opt: bool = False,
                remat: bool = False,
                hidden_dim: Optional[int] = None,
                out_dim: Optional[int] = None,
                edge_dim: Optional[int] = None, towers: int = 5,
                device: DeviceLike = None):
    """The flagship training step (``bench.py::build_bench``).  Returns
    (step, model, optimizer, (graph, labels), n_edges, n_nodes): ``step()``
    runs one Adam step on the batch, which lives on ``device`` (default the
    card; raises without one), and returns the loss before the update."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.nn.nets import PNANetMolecules
    from pna_tpu_torch.train.step import make_optimizer, train_step

    device = resolve_device(device)
    ds = ZincDataset.synthetic(n_train=batch_graphs_n, n_val=1, n_test=1,
                               seed=seed)
    graph, labels = collate_records(ds.train, with_snorm=True)
    n_edges = int(graph.edge_mask.sum())
    n_nodes = int(graph.node_mask.sum())
    if edge_feat:
        # the reference's headline ZINC recipe (README.md:62)
        net_kw = dict(hidden_dim=70, out_dim=60, edge_dim=50, edge_feat=True,
                      divide_input_first=True, divide_input_last=True)
    else:
        # the no-edge-feature recipe (README.md:61)
        net_kw = dict(hidden_dim=75, out_dim=70, edge_dim=0, edge_feat=False,
                      divide_input_first=False, divide_input_last=True)
    for key, val in (('hidden_dim', hidden_dim), ('out_dim', out_dim),
                     ('edge_dim', edge_dim)):
        if val is not None:
            net_kw[key] = val
    model = PNANetMolecules(
        num_atom_type=ds.num_atom_type, num_bond_type=ds.num_bond_type,
        n_layers=N_LAYERS, aggregators=('mean', 'max', 'min', 'std'),
        scalers=('identity', 'amplification', 'attenuation'),
        avg_d=ds.avg_d(), readout_type='sum', towers=towers,
        graph_norm=True, batch_norm=True, residual=True,
        compute_dtype=compute_dtype, kernel=kernel, max_degree=32,
        remat=remat, device=device, seed=seed, **net_kw)
    opt = make_optimizer(model, lr=1e-3, flat=flat_opt)
    # the batch goes to the device once
    graph, labels = graph.to(device), labels.to(device)

    def step():
        return train_step(model, opt, graph, labels)

    return step, model, opt, (graph, labels), n_edges, n_nodes


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def count_matmul_flops(fn: Callable[[], object]):
    """(FLOPs, dtype names) of the matrix products of one call of ``fn``:
    ``FlopCounterMode``'s count, and the dtypes their operands had."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    dtypes = set()

    class _Operands(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in flop_registry:
                dtypes.update(str(a.dtype).replace('torch.', '')
                              for a in args if isinstance(a, torch.Tensor))
            return func(*args, **(kwargs or {}))

    with FlopCounterMode(display=False) as counter, _Operands():
        fn()
    return counter.get_total_flops(), sorted(dtypes)


def peak_flops(device: torch.device, matmul_dtypes: Sequence[str]
               ) -> Optional[float]:
    """The card's dense peak for the dtype its products ran in, or None
    (the CPU, a card or a dtype mix the table does not hold)."""
    if device.type != 'cuda' or len(matmul_dtypes) != 1:
        return None
    key = matmul_dtypes[0]
    if key == 'float32' and torch.backends.cuda.matmul.allow_tf32:
        key = 'tf32'
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(key)


class BenchRunner:
    """One training step plus its carried state (``bench.py::BenchRunner``).

    ``time_block(n)`` runs n steps ending in a synchronisation and returns
    the mean seconds per step; it also keeps each block's wall-clock start
    and mean, so that callers can interleave runners of several
    configurations and read each one's ``report()`` afterwards.  One step
    under ``count_matmul_flops`` runs at construction."""

    def __init__(self, batch: int, edge_feat: bool, compute_dtype,
                 kernel: str, flat_opt: bool = False,
                 remat: bool = False, hidden_dim: Optional[int] = None,
                 out_dim: Optional[int] = None,
                 edge_dim: Optional[int] = None, towers: int = 5,
                 device: DeviceLike = None):
        (self._step, self.model, self.optimizer, (self.graph, self.labels),
         self.n_edges, self.n_nodes) = build_bench(
            batch_graphs_n=batch, edge_feat=edge_feat,
            compute_dtype=compute_dtype, kernel=kernel,
            flat_opt=flat_opt, remat=remat,
            hidden_dim=hidden_dim, out_dim=out_dim, edge_dim=edge_dim,
            towers=towers, device=device)
        self.device = self.graph.senders.device
        self.steps = 0                   # steps run, every kind
        self.blocks: List[tuple] = []    # (wall-clock start, s per step)
        self.flops, self.matmul_dtypes = count_matmul_flops(self.step)

    def step(self):
        self.steps += 1
        return self._step()

    def _run(self, n: int) -> None:
        for _ in range(n):
            self.step()
        _sync(self.device)

    def warmup(self, n: int = 5) -> None:
        self._run(n)

    def time_block(self, n: int) -> float:
        _sync(self.device)
        start = time.time()
        t0 = time.perf_counter()
        self._run(n)
        dt = (time.perf_counter() - t0) / n
        self.blocks.append((start, dt))
        return dt

    def backends(self) -> List[str]:
        """The backend each fused layer resolves to on this batch."""
        from pna_tpu_torch.nn.fused import resolve_backend
        return [resolve_backend(layer.kernel, self.graph, layer.aggregators,
                                self.device)
                for layer in self.model.layers]

    def profile(self, steps: int = PROFILE_STEPS) -> dict:
        """Device ms, kernels, the longest kernels (name, ms, launches) and
        K1-K4 and row-sum launches per step over ``steps`` profiled
        steps."""
        from pna_tpu_torch.ops.csr_fused_kernels import launch_counts
        from pna_tpu_torch.utils import profiling

        before = launch_counts()
        with profiling.trace() as prof:
            self._run(steps)
        after = launch_counts()
        rows, _ = profiling.op_times(prof, steps)
        return dict(
            device_ms_per_step=sum(r[1] for r in rows) if rows else None,
            kernels_per_step=sum(r[2] for r in rows) if rows else None,
            top_kernels=[[name[:100], ms, count]
                         for name, ms, count in rows[:TOP_KERNELS]],
            launches_per_step={k: (after[k] - before[k]) / steps
                               for k in after})

    def report(self) -> dict:
        """The configuration's numbers from its timed blocks, then a
        profile of ``PROFILE_STEPS`` steps."""
        if not self.blocks:
            raise ValueError("report() before any time_block()")
        secs = [s for _, s in self.blocks]
        dt = min(secs)
        prof = self.profile()
        peak = peak_flops(self.device, self.matmul_dtypes)
        dev_ms = prof['device_ms_per_step']
        return dict(
            step_ms=dt * 1e3,
            edges_per_sec=self.n_edges * N_LAYERS / dt,
            block_ms=[s * 1e3 for s in secs],
            block_start=[t for t, _ in self.blocks],
            spread_ms=(max(secs) - dt) * 1e3,
            matmul_tflops_per_step=self.flops / 1e12,
            matmul_dtype=self.matmul_dtypes,
            mfu=self.flops / dt / peak if peak else None,
            busy=dev_ms / (dt * 1e3) if dev_ms is not None else None,
            steps_run=self.steps, **prof)


def run_config(batch, edge_feat, compute_dtype, kernel, n_iters,
               flat_opt=False, remat=False,
               device: DeviceLike = None) -> dict:
    """One configuration alone (``bench.py::run_config``): 5 warm-up steps,
    3 blocks of ``n_iters // 3`` steps, the report with ``n_edges`` and
    ``n_nodes``."""
    r = BenchRunner(batch, edge_feat, compute_dtype, kernel,
                    flat_opt=flat_opt, remat=remat, device=device)
    r.warmup(5)
    for _ in range(3):
        r.time_block(max(1, n_iters // 3))
    return dict(r.report(), n_edges=r.n_edges, n_nodes=r.n_nodes)


def host_cpu() -> str:
    """The host CPU's model name; where the kernel reports none (or
    'unknown'), its vendor, family and model numbers; else the
    architecture."""
    info = {}
    if os.path.exists('/proc/cpuinfo'):
        with open('/proc/cpuinfo') as f:
            for line in f:
                if not line.strip():
                    break                    # the first processor's block
                key, _, val = line.partition(':')
                info[key.strip()] = val.strip()
    name = info.get('model name', 'unknown')
    if name != 'unknown':
        return name
    if 'vendor_id' in info:
        return (f"{info['vendor_id']} family {info.get('cpu family')} "
                f"model {info.get('model')}")
    return platform.processor() or platform.machine()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog='python -m pna_tpu_torch.bench',
        description="Times the flagship ZINC training step; prints one "
                    "JSON line.")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--kernel", default="csr",
                    help="auto, csr, csr_fused or generic")
    ap.add_argument("--dtype", default="both", choices=["both", "f32", "bf16"])
    ap.add_argument("--no_edge_feat", action="store_true")
    ap.add_argument("--hidden_dim", type=int, default=None)
    ap.add_argument("--towers", type=int, default=5)
    ap.add_argument("--out_dim", type=int, default=None)
    ap.add_argument("--edge_dim", type=int, default=None)
    ap.add_argument("--iters", type=int, default=120,
                    help="timed steps per dtype, split into --repeats "
                         "interleaved blocks")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing blocks per dtype; the step time is the "
                         "minimum block mean")
    ap.add_argument("--warmup", type=int, default=8,
                    help="warm-up steps per dtype before timing")
    ap.add_argument("--no_flat_opt", dest="flat_opt", action="store_false",
                    help="per-tensor Adam in place of the flat one")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); 'cpu' "
                         "runs the kernels' plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Time the configuration ``argv`` names, print the JSON line and
    return it as a dict."""
    from pna_tpu_torch.nn.fused import check_backend

    args = parse_args(argv)
    check_backend(args.kernel)
    device = resolve_device(args.device)
    edge_feat = not args.no_edge_feat
    overrides = {k: v for k, v in (("hidden_dim", args.hidden_dim),
                                   ("out_dim", args.out_dim),
                                   ("edge_dim", args.edge_dim))
                 if v is not None}
    if device.type == 'cuda':
        from pna_tpu_torch.ops.timing import card_line
        where = card_line()
    else:
        where = 'cpu'
    detail = {"device": where, "torch": torch.__version__,
              "cuda": torch.version.cuda, "host_cpu": host_cpu(),
              "host_cpus": os.cpu_count(), "batch_graphs": args.batch,
              "kernel": args.kernel, "edge_feat": edge_feat,
              "flat_opt": args.flat_opt, "remat": args.remat,
              **({"dim_overrides": overrides} if overrides else {}),
              "config": "ZINC headline (L=4, hidden 70, out 60, edge_dim 50,"
                        " towers 5)" if edge_feat else
                        "ZINC no-edge-feat (L=4, hidden 75, out 70, "
                        "towers 5)"}
    names = [n for n in DTYPES if args.dtype in ("both", n)]
    runners: Dict[str, BenchRunner] = {}
    for name in names:
        runners[name] = BenchRunner(
            args.batch, edge_feat, DTYPES[name], args.kernel,
            flat_opt=args.flat_opt, remat=args.remat,
            hidden_dim=args.hidden_dim,
            out_dim=args.out_dim, edge_dim=args.edge_dim,
            towers=args.towers, device=device)
        runners[name].warmup(args.warmup)
    block_n = max(1, args.iters // args.repeats)
    for _ in range(args.repeats):
        for name in names:
            runners[name].time_block(block_n)
    first = runners[names[0]]
    detail.update(n_edges=first.n_edges, n_nodes=first.n_nodes,
                  backends=first.backends())
    results = {name: runners[name].report() for name in names}
    detail["results"] = results
    head = results.get("bf16") or results["f32"]
    out = {"metric": METRIC, "value": head["edges_per_sec"],
           "unit": "edges/sec", "vs_baseline": None, "detail": detail}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
