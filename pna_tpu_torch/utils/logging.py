"""Structured metrics logging.

Counterpart of ``pna_tpu/utils/logging.py``: one JSON line per call
(machine-readable per-epoch curves) and, when a directory is given, the same
scalars as a TensorBoard event file.  The port always writes the events with
its own dependency-free writer (``utils/tb_writer.py``), so the files are the
same whichever packages are installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import torch

from pna_tpu_torch.utils.tb_writer import TBEventWriter


class MetricsLogger:
    def __init__(self, path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 stdout: bool = False):
        self.path = path
        self.stdout = stdout
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, 'a')
        self._tb = TBEventWriter(tensorboard_dir) if tensorboard_dir else None

    def log(self, step: int, **metrics: Any) -> None:
        rec = dict(step=step, time=time.time(), **metrics)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.stdout:
            print(json.dumps(rec))
        if self._tb:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()


def param_count(model: torch.nn.Module) -> int:
    """Number of trainable parameters (the reference's view_model_param)."""
    return sum(p.numel() for p in model.parameters())
