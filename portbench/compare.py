"""The numbers that decide ``correct`` for a training cell.

The program and the reference each take the same first steps from the same
weights on the same batches, and each gives its readings (``reference/
pna.py::train_readings``): every step's loss, every weight's first gradient
as Adam takes it (the program's read from its optimiser's first moment
after one step), and every weight's and running statistic's change after
the first and after the last step, each by its norm.  The numbers:

* ``first_loss_gap``: the relative gap of the first step's loss;
* ``loss_gap``: the largest relative gap of any step's loss;
* ``grad_gap``: over the weights, the largest gap between the two norms of
  a first gradient, over the reference's norm of that weight or of the
  median weight, whichever is larger; ``grad_gap_median``: the median
  weight's such gap;
* ``first_change_gap`` and ``change_gap``: the largest such gap of the
  change after the first and after the last step, over the weights and
  statistics that count: a weight whose reference gradient is under
  ``GRAD_FLOOR`` of the median weight's (a bias that a batch norm cancels)
  moves under Adam by round-off alone and is left out.

A cell's traffic file holds the limits of the numbers it compares; the
others are reported beside them.  Why each cell compares the ones it does
is in ``PERF.md``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

GRAD_FLOOR = 1e-3
NUMBERS = ('first_loss_gap', 'loss_gap', 'grad_gap', 'grad_gap_median',
           'first_change_gap', 'change_gap')


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys
          ) -> List[float]:
    floor = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys]


def numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], List[str]]:
    """(the numbers, the weights left out of the change gaps)."""
    if len(prog['losses']) != len(ref['losses']):
        raise ValueError(f"{len(prog['losses'])} program steps against "
                         f"{len(ref['losses'])} of the reference")
    for key in ('grad', 'first_change', 'change'):
        if set(prog[key]) != set(ref[key]):
            raise ValueError(f"the program's {key} leaves differ from the "
                             f"reference's: "
                             f"{sorted(set(prog[key]) ^ set(ref[key]))}")
    losses = [abs(p - r) / abs(r) if r else math.inf
              for p, r in zip(prog['losses'], ref['losses'])]
    grads = _gaps(prog['grad'], ref['grad'], list(ref['grad']))
    med_g = statistics.median(ref['grad'].values())
    left_out = sorted(k for k, g in ref['grad'].items()
                      if g < GRAD_FLOOR * med_g)
    counted = [k for k in ref['change'] if k not in left_out]
    out = dict(first_loss_gap=losses[0], loss_gap=max(losses),
               grad_gap=max(grads), grad_gap_median=statistics.median(grads),
               first_change_gap=max(_gaps(prog['first_change'],
                                          ref['first_change'], counted)),
               change_gap=max(_gaps(prog['change'], ref['change'], counted)))
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in out.items()}, left_out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it; a cell with no limit
    is not correct."""
    held = [k for k in NUMBERS if k in limits]
    return bool(held) and all(nums[k] <= limits[k] for k in held)
