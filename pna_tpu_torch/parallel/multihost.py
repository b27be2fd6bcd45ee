"""The multi-process runtime: one process per rank under torch.distributed.

Counterpart of ``pna_tpu/parallel/multihost.py``.  The JAX package runs one
SPMD program over a mesh of devices; the port runs one process per rank,
each on its own card (``cuda:{local_rank}``; NCCL) or, when the caller
asks for it, on the CPU (gloo).  Without a card and without the CPU asked
for, ``default_backend`` and ``rank_device`` raise.

* ``initialize`` joins the process group: from ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (what ``torchrun`` sets), from
  its arguments, or, in one process with no environment, as a 1-rank group
  on a ``dist.HashStore``, so that one card runs the same NCCL code path as
  a cluster;
* ``hybrid_mesh(dcn_axes, ici_axes)`` is a ``DeviceMesh`` whose leading
  axes are the host-to-host (DCN) ones, so collectives over the trailing
  axes stay inside a host;
* ``put_global(x, mesh, axis)`` is this rank's row of a host array stacked
  over the mesh axis ``axis``, on the rank's device: the counterpart of
  placing a table sharded over that axis.  Each rank builds the whole
  partition on the host, as every JAX process does, and keeps its row.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pna_tpu_torch.device import DeviceLike, resolve_device


def default_backend(device: DeviceLike = None) -> str:
    """NCCL for a card, gloo for the CPU; ``device`` None means a card
    (``device.resolve_device``: raises when there is none)."""
    return 'nccl' if resolve_device(device).type == 'cuda' else 'gloo'


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    else the global rank modulo the cards of the host)."""
    if 'LOCAL_RANK' in os.environ:
        return int(os.environ['LOCAL_RANK'])
    r = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count()
    return r % n if n else r


def initialize(master_addr: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               master_port: Optional[int] = None,
               device: DeviceLike = None) -> None:
    """Join the process group (a no-op when already joined).

    ``init_method`` (e.g. ``file://<path>`` or ``tcp://host:port``) wins;
    else ``master_addr``/``master_port`` or the environment's
    ``MASTER_ADDR``/``MASTER_PORT``; with neither, and a world of one, a
    1-rank group on an in-memory store.  ``backend`` None takes
    ``default_backend(device)``: NCCL unless the caller asks for the CPU.
    On NCCL the rank's card (``cuda:{local_rank}``) becomes the current
    device first."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if world_size is None and 'WORLD_SIZE' in os.environ:
        world_size = int(os.environ['WORLD_SIZE'])
    if rank is None and 'RANK' in os.environ:
        rank = int(os.environ['RANK'])
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if backend == 'nccl':
        n = torch.cuda.device_count()
        lr = int(os.environ.get('LOCAL_RANK', rank % max(n, 1)))
        torch.cuda.set_device(lr)
    master_addr = master_addr or os.environ.get('MASTER_ADDR')
    if master_port is None and 'MASTER_PORT' in os.environ:
        master_port = int(os.environ['MASTER_PORT'])
    if init_method is None and master_addr is not None:
        init_method = f"tcp://{master_addr}:{master_port or 29500}"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        raise ValueError(f"a world of {world_size} needs MASTER_ADDR or an "
                         "init_method")


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The world size (``WORLD_SIZE`` before the group is joined)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', 1))


def process_index() -> int:
    """This process's rank (``RANK`` before the group is joined)."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get('RANK', 0))


def is_coordinator() -> bool:
    """True on the process that owns writes (checkpoints, logs)."""
    return process_index() == 0


def barrier() -> None:
    """Block until every process reaches this point."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` when the caller gives one, else its
    card, ``cuda:{local_rank}`` (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device('cuda', local_rank())


def hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank with the ``dcn_axes`` leading and the
    ``ici_axes`` trailing (ordered ``{name: size}``; the sizes multiply to the
    world size), over ``device_type`` (default: the card's, ``'cuda'``)."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    if int(np.prod(shape)) != process_count():
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{int(np.prod(shape))} ranks, the world has "
                         f"{process_count()}")
    if device_type is None:
        device_type = rank_device().type
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def put_global(x, mesh: DeviceMesh, axis: Optional[str],
               device: DeviceLike = None) -> torch.Tensor:
    """This rank's row of ``x`` [size of ``axis``, ...] (all of ``x`` when
    ``axis`` is None), on ``device`` (default: this rank's card)."""
    x = np.asarray(x)
    if axis is not None:
        x = x[mesh.get_local_rank(axis)]
    return torch.as_tensor(np.ascontiguousarray(x)).to(rank_device(device))
