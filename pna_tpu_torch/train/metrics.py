"""Evaluation metrics on numpy arrays.

A copy of ``pna_tpu/train/metrics.py`` (which imports no JAX; the port keeps
its own copy so that it loads nothing of ``pna_tpu``): MAE, the accuracy
count, the class-averaged accuracy, the F1 scores and the binary ROC-AUC of
the OGB evaluator.  The F1 scores call sklearn; the ROC-AUC, which the
MolHIV trainers read every epoch, is computed in numpy, so the CLIs need no
sklearn on the card's machine."""

from __future__ import annotations

import numpy as np


def MAE(scores, targets, mask=None) -> float:
    scores = np.asarray(scores).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        scores, targets = scores[mask], targets[mask]
    return float(np.mean(np.abs(scores - targets)))


def accuracy(scores, targets, mask=None) -> float:
    """Classification accuracy, as a raw count in the reference
    (metrics.py accuracy_MNIST_CIFAR returns #correct); we return the count so
    epoch code can divide by #samples, same contract."""
    pred = np.asarray(scores).argmax(axis=-1).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        pred, targets = pred[mask], targets[mask]
    return float((pred == targets).sum())


def accuracy_SBM(scores, targets, mask=None) -> float:
    """Class-averaged accuracy (metrics.py accuracy_SBM)."""
    pred = np.asarray(scores).argmax(axis=-1).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        pred, targets = pred[mask], targets[mask]
    accs = []
    for c in np.unique(targets):
        sel = targets == c
        accs.append(float((pred[sel] == c).mean()))
    return float(np.mean(accs)) * 100.0


def binary_f1_score(scores, targets, mask=None) -> float:
    from sklearn.metrics import f1_score
    pred = np.asarray(scores).argmax(axis=-1).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        pred, targets = pred[mask], targets[mask]
    return float(f1_score(targets, pred, average='binary'))


def weighted_f1_score(scores, targets, mask=None) -> float:
    from sklearn.metrics import f1_score
    pred = np.asarray(scores).argmax(axis=-1).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        pred, targets = pred[mask], targets[mask]
    return float(f1_score(targets, pred, average='weighted'))


def roc_auc(scores, targets, mask=None) -> float:
    """Binary ROC-AUC over raw scores (OGB Evaluator for ogbg-molhiv), in
    numpy: the Mann-Whitney statistic over average ranks (tied scores share
    their rank), which is sklearn's ``roc_auc_score``.  One class alone
    raises ``ValueError``, as sklearn does."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    if mask is not None:
        mask = np.asarray(mask).reshape(-1).astype(bool)
        scores, targets = scores[mask], targets[mask]
    pos = targets == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    order = np.argsort(scores, kind='mergesort')
    s = scores[order]
    # 1-based ranks, each run of equal scores given the mean of its ranks
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], s.size]
    ranks = np.empty(s.size)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
