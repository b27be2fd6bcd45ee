"""Checkpoint and resume.

Counterpart of ``pna_tpu/utils/checkpoint.py``: a checkpoint is one
``torch.save`` file holding ``dict(state=..., metadata=...)``, written to
``path + '.tmp'`` and renamed over ``path``, so a run killed while writing
leaves the previous file whole.  ``load_checkpoint`` reads it with
``weights_only=True``: a payload holds tensors, numbers, strings, lists and
dicts only (model and optimizer state dicts, a generator's state tensor, the
scheduler's state), never an arbitrary pickled object.  Tensors come back on
the CPU; ``load_state_dict`` copies them to the module's device.

``CheckpointManager`` keeps a ``latest.ckpt`` for resume and the best ``k``
checkpoints by their recorded metric, rotating worse ones out.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, state: Dict[str, Any],
                    metadata: Optional[dict] = None) -> None:
    """Atomically write a checkpoint (state dicts and metadata)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(dict(state=state, metadata=metadata or {}), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """(state, metadata) of a checkpoint, tensors on the CPU."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    return payload['state'], payload.get('metadata', {})


def _best_files(directory: str):
    """[(metric, path)] of the ``best_*.ckpt`` files in ``directory`` whose
    metadata records a metric."""
    out = []
    for fname in os.listdir(directory):
        if not (fname.startswith('best_') and fname.endswith('.ckpt')):
            continue
        path = os.path.join(directory, fname)
        try:
            _, meta = load_checkpoint(path)
            out.append((float(meta['metric']), path))
        except (OSError, EOFError, RuntimeError, pickle.UnpicklingError,
                KeyError, TypeError, ValueError):
            continue        # unreadable or foreign file: not a best checkpoint
    return out


class CheckpointManager:
    """Best-k rotation (``keep_best=1`` keeps only the best epoch, as the
    reference does) plus a 'latest' checkpoint for resume."""

    def __init__(self, directory: str, keep_best: int = 1, mode: str = 'min'):
        self.dir = directory
        self.keep_best = keep_best
        self.mode = mode
        os.makedirs(directory, exist_ok=True)
        # seeded from the checkpoints written before a resume, so rotation
        # deletes them and restore_best never prefers a stale file
        self.best: list = _best_files(directory)     # [(metric, path)]
        self._sort()

    def _sort(self):
        self.best.sort(key=lambda t: t[0], reverse=(self.mode == 'max'))

    def _better(self, a, b):
        return a < b if self.mode == 'min' else a > b

    def save_latest(self, state, epoch: int, **meta):
        save_checkpoint(os.path.join(self.dir, 'latest.ckpt'), state,
                        dict(epoch=epoch, **meta))

    def save_best(self, state, metric: float, epoch: int, **meta) -> bool:
        """Save if among the best k, rotating the worst out; returns whether
        this checkpoint was kept."""
        if len(self.best) < self.keep_best or self._better(
                metric, self.best[-1][0]):
            path = os.path.join(self.dir, f'best_{epoch}.ckpt')
            save_checkpoint(path, state, dict(epoch=epoch, metric=metric,
                                              **meta))
            self.best.append((metric, path))
            self._sort()
            while len(self.best) > self.keep_best:
                _, old = self.best.pop()
                if os.path.exists(old):
                    os.remove(old)
            return True
        return False

    def restore_latest(self):
        path = os.path.join(self.dir, 'latest.ckpt')
        if not os.path.exists(path):
            return None, None
        return load_checkpoint(path)

    def restore_best(self):
        """The best checkpoint by recorded metric (not by file name: best_5
        and best_12 sort the wrong way as strings)."""
        cands = self.best or sorted(_best_files(self.dir), key=lambda t: t[0],
                                    reverse=(self.mode == 'max'))
        if not cands:
            return None, None
        return load_checkpoint(cands[0][1])
