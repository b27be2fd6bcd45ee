"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell (inputs and weights from
the seed, the program built and driven through its first steps, warm-up),
measures for ``--seconds``, with ``--trace 1`` profiles a few steps more,
frees the program, runs the reference over the first steps and compares,
then prints the numbers compared and their limits as the last lines of
standard error and one JSON line as the last line of standard output:
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``).  It exits with 2, printing no result, without as many
CUDA devices as the cell asks for, and with 3 if a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or its libraries write, inside the checkout at a
# fixed path, so that only a checkout's first run builds
CACHES = {'CUDA_CACHE_PATH': 'nv', 'TORCH_EXTENSIONS_DIR': 'torch_extensions',
          'TRITON_CACHE_DIR': 'triton'}

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'optax', 'pna_tpu'})


@dataclass
class Context:
    """What a metric's ``read`` is given."""
    cell: object
    driver: object
    window: dict
    setup_s: float
    window_peak_bytes: Optional[int]
    trace: object
    peak: Optional[dict]


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float):
    """Set up, measure, compare: (the result as a dict, whose ``checks``
    hold each number compared beside its limit, and the window's record).
    ``device`` 'cpu' runs the program's plain versions, for the tests: no
    device metric is read."""
    import torch

    from portbench import compare, peaks, spec

    on_card = torch.device(device).type == 'cuda'
    tf32 = bool(cell.config['run'].get('tf32', False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    driver = spec.load_driver(cell.traffic['driver']).Driver(cell, device)
    start_s = time.perf_counter() - t0
    driver.setup(seed)
    setup_peak = window_peak = None
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    window = driver.window(seconds)
    window['setup_phases'] = dict(start=start_s, **driver.phases)
    if on_card:
        window_peak = torch.cuda.max_memory_allocated()
    traced = driver.traced() if trace else None
    peak_bytes = None
    if on_card:
        peak_bytes = max(setup_peak, torch.cuda.max_memory_allocated())
    driver.release()

    nums, _ = compare.numbers(driver.program_readings, driver.reference())
    limits = cell.traffic['limits']
    correct = compare.judge(nums, limits) and window['attempted'] > 0

    card = torch.cuda.get_device_name() if on_card else 'cpu'
    ctx = Context(cell=cell, driver=driver, window=window, setup_s=setup_s,
                  window_peak_bytes=window_peak, trace=traced,
                  peak=peaks.peak(card) if on_card else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_metric(m['name']).read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    dev = dict(platform='gpu' if on_card else 'cpu', kind=card,
               count=cell.chips, memory_peak_bytes=peak_bytes)
    out = dict(correct=bool(correct), attempted=window['attempted'],
               failed=window['failed'], metrics=metrics, device=dev)
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        out['breakdown'] = traced.breakdown()
    # the numbers the cell holds to a limit, last; the others beside them
    out['readings'] = {k: v for k, v in nums.items() if k not in limits}
    out['checks'] = {k: {'value': v, 'limit': limits[k]}
                     for k, v in nums.items() if k in limits}
    return out, window


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, '.portbench_cache', sub)

    import torch

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, window = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), 'cuda', T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    times = window.get('epoch_s') or window.get('step_s') or []
    print(f"window {window['steps']} steps in {window['seconds']!r} s; "
          f"{'epoch' if window.get('epoch_s') else 'step'} seconds "
          f"{[round(t, 4) for t in times]}", file=sys.stderr)
    print("set-up seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in window['setup_phases'].items()),
        file=sys.stderr)
    for k, v in result['readings'].items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in result['checks'].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
