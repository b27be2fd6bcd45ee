"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--control]

For each seed, in one process: the cell's set-up (its first steps through
the program; no warm-up, no window), the program freed, the reference, and
the three numbers of the program against it (the lower readings).  With
``--control``: also the numbers of the control (the reference with TF32
products) and of the half-batch fault (the reference with half the batch
or training nodes left out of the loss), each in the program's place.  A
state left unchanged reads 1 on ``change_gap`` by definition and is not
run.  One JSON line per seed on standard output.  Not part of a benchmark
run.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time


def readings(cell, seed: int, device, control: bool) -> dict:
    from portbench import compare, spec
    cell = copy.copy(cell)
    cell.traffic = dict(cell.traffic, warmup_steps=0)
    driver = spec.load_driver(cell.traffic['driver']).Driver(cell, device)
    t0 = time.perf_counter()
    driver.setup(seed)
    driver.release()
    ref = driver.reference()
    nums, left_out = compare.numbers(driver.program_readings, ref)
    out = dict(seed=seed, program=nums, left_out=left_out)
    if control:
        out['control'] = compare.numbers(driver.reference(tf32=True),
                                         ref)[0]
        out['half_batch'] = compare.numbers(driver.reference(half=True),
                                            ref)[0]
    out['seconds'] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control', action='store_true')
    args = p.parse_args(argv)
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    for s in args.seeds.split(','):
        print(json.dumps(readings(cell, int(s), 'cuda', args.control)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
