"""pna_tpu_torch: the PNA framework of ``pna_tpu`` ported to PyTorch and CUDA
for an NVIDIA H100.

The JAX package ``pna_tpu`` is the reference; this package never imports it
(nor JAX).  Modules keep the JAX layout and names; each module's docstring
names its counterpart.  The TPU kernels on the ported path are CUDA kernels
under ``csrc/``, built at first use (``ops/build.py``).

``entry()`` is the counterpart of ``__graft_entry__.entry``: the
no-edge-feature flagship ``PNANetMolecules`` and its example batch, on the
card.  ``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one training step of the
edge-partitioned net over n ranks, which every rank calls.
``python -m pna_tpu_torch.bench`` is the counterpart of ``bench.py``.

The package exports the JAX package's names (``Graph``, ``batch_graphs``,
``build_graph``, ``from_dense``, ``__version__``) beside its entry points;
``pna_tpu_torch.nn`` and ``pna_tpu_torch.ops`` export those of ``pna_tpu.nn``
and ``pna_tpu.ops``.
"""

from __future__ import annotations

__version__ = "0.1.0"

from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.graph import Graph, batch_graphs, build_graph, from_dense

__all__ = ["Graph", "batch_graphs", "build_graph", "from_dense",
           "__version__", "entry", "hub_problem", "dryrun_multichip"]


def entry(device: DeviceLike = None):
    """(forward, (model, graph)): the no-edge-feature ZINC flagship (hidden
    75, out 70, L=4, towers 5) on a 32-graph synthetic batch, on ``device``
    (default ``cuda``; raises without a card).  ``forward(model, graph)``
    runs the net in eval mode without autograd and returns [G_pad, 1]."""
    import torch

    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.nn.nets import PNANetMolecules

    device = resolve_device(device)
    ds = ZincDataset.synthetic(n_train=32, n_val=8, n_test=8, seed=0)
    graph, _ = collate_records(ds.train[:32], with_snorm=True)
    model = PNANetMolecules(
        num_atom_type=ds.num_atom_type, num_bond_type=ds.num_bond_type,
        hidden_dim=75, out_dim=70, n_layers=4,
        aggregators=('mean', 'max', 'min', 'std'),
        scalers=('identity', 'amplification', 'attenuation'),
        avg_d=ds.avg_d(), readout_type='sum', towers=5,
        divide_input_first=False, divide_input_last=True,
        graph_norm=True, batch_norm=True, residual=True, edge_feat=False,
        kernel='csr', device=device, seed=0)

    def forward(model, graph):
        model.eval()
        with torch.no_grad():
            return model(graph, graph.node_feats.squeeze(-1), None)

    return forward, (model, graph.to(device))


def hub_problem(d_graph: int):
    """The hub-skewed node-level configuration of the dryrun: a power-law
    graph of 2,000 nodes per part and 8 edges per node (exponent 2) whose
    first fifth of edges all point at node 0, partitioned over ``d_graph``
    parts in the sorted layout, with 4 edge features.  Returns (part, node
    features [P, Nl, 16], labels [P, Nl], edge features [P, El, 4], the
    ``DistributedPNANet`` arguments)."""
    import numpy as np

    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph,
                                                  sort_partition_edges)
    from pna_tpu_torch.train.largegraph import neighbor_stats_labels

    n, f = 2_000 * d_graph, 16
    e = 8 * n
    send, recv = powerlaw_graph(n, e, seed=1, exponent=2.0)
    recv[:e // 5] = 0                           # hub in-degree ~ E/5
    part = sort_partition_edges(partition_edges(send, recv, n, d_graph))
    efeats = part.scatter_edge_features(
        np.random.RandomState(1).randn(e, 4).astype(np.float32))
    x = np.random.RandomState(2).randn(n, f).astype(np.float32)
    labels = part.scatter_features(
        neighbor_stats_labels(send, recv, x, n)[:, None])[..., 0]
    net_kw = dict(feat_dim=f, hidden_dim=32, out_dim=32, n_layers=2,
                  towers=4, avg_d={'lin': 8.0, 'log': 2.0},
                  batch_norm=True, residual=True, node_level=True,
                  edge_features=True, edge_dim=4)
    return part, part.scatter_features(x), labels, efeats, net_kw


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """One training step of the edge-partitioned flagship stack on this
    rank of an ``n_devices``-rank ('data', 'graph') mesh (2 x n/2 from 4
    even ranks, else 1 x n); every rank calls it, under ``torchrun`` or in
    one process for one rank.  The configurations of the JAX dryrun but
    its bucketed one (a layout the port does not have): 10,000 power-law
    nodes per part (5 edges each, hidden 64, 4 towers, 2 layers) on the
    generic backend with the graph readout, and the hub-skewed node-level
    configuration with edge features (``hub_problem``) on ``csr`` and
    ``csr_fused``.  Returns {kernel:
    loss}; raises on a loss that is not finite.  ``device``: None for this
    rank's card, ``'cpu'`` for the CPU (gloo)."""
    import torch.distributed as dist

    from pna_tpu_torch.parallel import multihost

    dev_type = resolve_device(device).type      # raises without a card
    created = not dist.is_initialized()
    multihost.initialize(device=dev_type)
    try:
        return _dryrun(n_devices, dev_type)
    finally:
        if created:
            multihost.shutdown()


def _dryrun(n_devices: int, dev_type: str) -> dict:
    import math

    import numpy as np
    import torch
    import torch.distributed as dist

    from pna_tpu_torch.parallel import multihost
    from pna_tpu_torch.parallel.distributed_net import (
        DistributedPNANet, make_distributed_train_step, mesh_groups)
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph)
    from pna_tpu_torch.train.largegraph import make_node_train_step

    if multihost.process_count() != n_devices:
        raise ValueError(f"dryrun over {n_devices} ranks in a world of "
                         f"{multihost.process_count()}")
    if n_devices >= 4 and n_devices % 2 == 0:
        d_data, d_graph = 2, n_devices // 2
    else:
        d_data, d_graph = 1, n_devices
    mesh = multihost.hybrid_mesh({'data': d_data}, {'graph': d_graph},
                                 device_type=dev_type)
    _, graph_group, (di, gi) = mesh_groups(mesh)
    dev = (torch.device('cuda', multihost.local_rank())
           if dev_type == 'cuda' else torch.device('cpu'))
    groups = dict(graph_group=graph_group, bn_group=dist.group.WORLD,
                  device=dev, seed=0)
    losses = {}

    def report(kernel, loss, part, what):
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} ({kernel})")
        losses[kernel] = loss
        if multihost.is_coordinator():
            print(f"dryrun_multichip ok: mesh=({d_data}x{d_graph}) "
                  f"kernel={kernel}{what} nodes/part={part.nodes_per_part} "
                  f"edges/part={part.edges_per_part} loss={loss:.4f}",
                  flush=True)

    num_nodes, f = 10_000 * d_graph, 16
    send, recv = powerlaw_graph(num_nodes, 5 * num_nodes, seed=0)
    part = partition_edges(send, recv, num_nodes, d_graph)
    x = np.random.RandomState(0).randn(num_nodes, f).astype(np.float32)
    net = DistributedPNANet(f, hidden_dim=64, out_dim=64, n_layers=2,
                            towers=4, avg_d={'lin': 5.0, 'log': 1.6},
                            kernel='generic', **groups)
    step, _ = make_distributed_train_step(
        part, mesh, net, torch.optim.Adam(net.parameters(), lr=1e-3))
    feats = torch.from_numpy(part.scatter_features(x)[gi]).to(dev)
    report('generic', step(feats, float(di)), part, '')

    part, x, labels, efeats, net_kw = hub_problem(d_graph)
    for kernel in ('csr', 'csr_fused'):
        net = DistributedPNANet(kernel=kernel, **net_kw, **groups)
        step, _, _ = make_node_train_step(
            part, mesh, net, torch.optim.Adam(net.parameters(), lr=1e-3),
            efeats=efeats)
        loss = step(*(torch.from_numpy(a[gi]).to(dev)
                      for a in (x, labels, part.node_mask)))
        report(kernel, loss, part, ' (hub-skewed, node-level, edge feats)')
    return losses
