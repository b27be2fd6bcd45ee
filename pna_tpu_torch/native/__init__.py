"""The host-side C++ graph operations, loaded with ctypes.

Counterpart of ``pna_tpu/native/__init__.py``; ``graph_ops.cpp`` is a copy of
that package's source without its ELL table, a layout the port does not
have.  These are host preprocessing, not device kernels; the port binds the
three that the edge partition runs (its per-part counts, its index tables
and its locality order).  The library's degree count and receiver sort stay
unbound: the batcher builds those in numpy (``graph.py``).  The library is
compiled at first use with ``g++`` into ``pna_tpu_torch/_build/`` under a
name keyed on a hash of the source and the flags, as ``ops/build.py`` does
for the CUDA kernels, so a stale or foreign build is never loaded.  Every
entry point has a numpy twin that gives the same arrays, which is used when
no compiler is present: a missing toolchain costs preprocessing speed, not
correctness.
``chip_smoke.py`` checks that the library loads on the card's machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graph_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """The library's path, keyed on the source and the flags."""
    with open(_SRC, 'rb') as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"graph_ops_{h[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def get_lib():
    """The native library, built if needed; None without a compiler."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.partition_stats.argtypes = [i64p, i64p, i64, i64, i64, i64,
                                        i64p, i64p]
        lib.build_partition_indices.argtypes = [
            i64p, i64p, i64, i64, i64, i64, i64, i64,
            i32p, i32p, u8p, i32p, u8p]
        lib.locality_order.argtypes = [i64p, i64p, i64, i64, i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def partition_stats_numpy(senders: np.ndarray, receivers: np.ndarray,
                          nl: int, num_parts: int, n_nodes: int):
    senders, receivers = _i64(senders), _i64(receivers)
    owner_r = receivers // nl
    owner_s = senders // nl
    edge_count = np.bincount(owner_r, minlength=num_parts).astype(np.int64)
    rem = owner_s != owner_r
    keys = np.unique(owner_r[rem] * np.int64(n_nodes) + senders[rem])
    up, us = keys // n_nodes, keys % n_nodes
    halo_count = np.zeros((num_parts, num_parts), dtype=np.int64)
    np.add.at(halo_count, (us // nl, up), 1)
    return edge_count, halo_count


def partition_stats(senders: np.ndarray, receivers: np.ndarray,
                    nl: int, num_parts: int, n_nodes: int):
    """(edge_count [P], halo_count [P, P]) of contiguous node ranges of
    ``nl`` nodes: edges per receiver-owning part, and per (sender part q,
    receiver part p) the distinct remote senders q ships to p (the
    diagonal counts nothing)."""
    lib = get_lib()
    if lib is None:
        return partition_stats_numpy(senders, receivers, nl, num_parts,
                                     n_nodes)
    senders, receivers = _i64(senders), _i64(receivers)
    edge_count = np.zeros(num_parts, dtype=np.int64)
    halo_count = np.zeros(num_parts * num_parts, dtype=np.int64)
    lib.partition_stats(_ptr(senders, ctypes.c_int64),
                        _ptr(receivers, ctypes.c_int64), len(senders), nl,
                        num_parts, n_nodes, _ptr(edge_count, ctypes.c_int64),
                        _ptr(halo_count, ctypes.c_int64))
    return edge_count, halo_count.reshape(num_parts, num_parts)


def build_partition_indices(senders: np.ndarray, receivers: np.ndarray,
                            nl: int, num_parts: int, n_nodes: int,
                            el: int, h: int):
    """The partition's index tables (``graph_ops.cpp`` states the layout):
    (senders_local [P, el] int32, receivers_local [P, el] int32, edge_mask
    [P, el] bool, send_idx [P, P, h] int32, send_mask [P, P, h] bool), or
    None without the library (``parallel/partition.py`` has the numpy
    twin)."""
    lib = get_lib()
    if lib is None:
        return None
    senders, receivers = _i64(senders), _i64(receivers)
    P = num_parts
    senders_local = np.zeros((P, el), dtype=np.int32)
    receivers_local = np.zeros((P, el), dtype=np.int32)
    edge_mask = np.zeros((P, el), dtype=np.uint8)
    send_idx = np.zeros((P, P, h), dtype=np.int32)
    send_mask = np.zeros((P, P, h), dtype=np.uint8)
    lib.build_partition_indices(
        _ptr(senders, ctypes.c_int64), _ptr(receivers, ctypes.c_int64),
        len(senders), nl, P, n_nodes, el, h,
        _ptr(senders_local, ctypes.c_int32),
        _ptr(receivers_local, ctypes.c_int32),
        _ptr(edge_mask, ctypes.c_uint8),
        _ptr(send_idx, ctypes.c_int32),
        _ptr(send_mask, ctypes.c_uint8))
    return (senders_local, receivers_local, edge_mask.astype(bool),
            send_idx, send_mask.astype(bool))


def locality_order_numpy(senders: np.ndarray, receivers: np.ndarray,
                         n_nodes: int) -> np.ndarray:
    """The numpy twin of ``graph_ops.cpp:locality_order``."""
    senders, receivers = _i64(senders), _i64(receivers)
    od = np.bincount(senders, minlength=n_nodes)
    edge_order = np.argsort(senders, kind='stable')
    ptr = np.concatenate([[0], np.cumsum(od)])
    rs = receivers[edge_order]
    placed = np.zeros(n_nodes, bool)
    out = np.empty(n_nodes, np.int64)
    pos = 0
    for s in np.argsort(od, kind='stable'):
        if od[s] == 0:
            continue
        for v in rs[ptr[s]:ptr[s + 1]]:
            if not placed[v]:
                placed[v] = True
                out[pos] = v
                pos += 1
        if not placed[s]:
            placed[s] = True
            out[pos] = s
            pos += 1
    rest = np.nonzero(~placed)[0]
    out[pos:pos + len(rest)] = rest
    return out


def locality_order(senders: np.ndarray, receivers: np.ndarray,
                   n_nodes: int) -> np.ndarray:
    """A node order for contiguous-range partitioning that lays each
    sender's receivers out together, rare senders first
    (``graph_ops.cpp:locality_order`` states why): order[i] is the old id of
    the node at new position i."""
    lib = get_lib()
    if lib is None:
        return locality_order_numpy(senders, receivers, n_nodes)
    senders, receivers = _i64(senders), _i64(receivers)
    out = np.zeros(n_nodes, dtype=np.int64)
    lib.locality_order(_ptr(senders, ctypes.c_int64),
                       _ptr(receivers, ctypes.c_int64), len(senders),
                       n_nodes, _ptr(out, ctypes.c_int64))
    return out
