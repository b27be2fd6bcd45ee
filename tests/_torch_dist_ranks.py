"""Spawned gloo ranks for the port's distributed tests.

This module imports no JAX, so that the ranks start fast: a test computes the
JAX reference in its own process, hands each rank its inputs, and reads back
what the ranks saved.  ``run_world`` starts ``world`` processes with
``torch.multiprocessing.start_processes(start_method='spawn')``, each of
which joins a gloo group through a file store under the test's temporary
directory (no port, so that concurrent test workers cannot collide), runs one
module-level function of this file and saves its result as
``<out>/rank<r>.pt``.  A world that does not finish within its timeout is
terminated and fails the test instead of hanging the suite.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist


def state_of(net):
    """The net's state dict, copied to the CPU."""
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def _entry(rank, world, out, fn_name, args):
    torch.set_num_threads(1)
    from pna_tpu_torch.parallel import multihost
    multihost.initialize(world_size=world, rank=rank, backend='gloo',
                         init_method='file://' + os.path.join(out, 'store'))
    try:
        result = globals()[fn_name](rank, world, *args)
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
    finally:
        multihost.shutdown()


def run_world(fn_name, world, out, *args, timeout=240):
    """Run ``fn_name(rank, world, *args)`` in ``world`` spawned ranks; the
    list of their results, by rank."""
    import torch.multiprocessing as mp
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, str(out), fn_name, args),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            raise TimeoutError(f"{fn_name}: {world} ranks did not finish in "
                               f"{timeout} s")
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


# -- the distributed PNA step --------------------------------------------


def _partition(case):
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  sort_partition_edges)
    part = partition_edges(case['send'], case['recv'], case['num_nodes'],
                           case['d_graph'])
    if case.get('layout') == 'sorted':
        part = sort_partition_edges(part)
    return part


def dist_step_cases(rank, world, cases, aggregate):
    """One SGD step of ``DistributedPNANet`` per case, each on its own mesh
    over the world: each case's loss and updated state; then
    ``make_distributed_aggregate`` over the world on ``aggregate``'s graph
    (this rank's part of the bank); then ``dryrun_multichip(world)``."""
    from pna_tpu_torch.parallel import multihost
    from pna_tpu_torch.parallel.distributed_net import (
        DistributedPNANet, make_distributed_train_step)
    results = []
    for case in cases:
        d_data, d_graph = case['d_data'], case['d_graph']
        mesh = multihost.hybrid_mesh({'data': d_data}, {'graph': d_graph},
                                     device_type='cpu')
        graph_group = mesh.get_group('graph')
        di, gi = mesh.get_local_rank('data'), mesh.get_local_rank('graph')
        part = _partition(case)
        # this rank's row of a table stacked over the graph axis
        assert torch.equal(multihost.put_global(part.send_idx, mesh, 'graph',
                                                'cpu'),
                           torch.from_numpy(part.send_idx[gi]))
        efeats = (part.scatter_edge_features(case['efeats'])
                  if case.get('efeats') is not None else None)
        net = DistributedPNANet(
            case['feat_dim'], device='cpu', graph_group=graph_group,
            bn_group=dist.group.WORLD, edge_dim=case.get('edge_dim', 0),
            **case['net'])
        net.load_state_dict(case['state'])
        opt = torch.optim.SGD(net.parameters(), lr=case['lr'])
        step, _ = make_distributed_train_step(part, mesh, net, opt,
                                              efeats=efeats)
        # features in the partition's padded node space [D, P*Nl, F]
        feats = case['feats'][di].reshape(d_graph, part.nodes_per_part,
                                          -1)[gi]
        loss = step(torch.from_numpy(np.ascontiguousarray(feats)),
                    float(case['targets'][di]))
        results.append(dict(loss=loss, state=state_of(net)))
    from pna_tpu_torch.parallel.partition import (make_distributed_aggregate,
                                                  partition_edges)
    a = aggregate
    part = partition_edges(a['send'], a['recv'], a['num_nodes'], world)
    agg = make_distributed_aggregate(part, rank, dist.group.WORLD,
                                     a['aggregators'], a['scalers'],
                                     a['avg_d'], device='cpu')
    x = torch.from_numpy(part.scatter_features(a['feats'])[rank])
    import pna_tpu_torch
    return results, agg(x), pna_tpu_torch.dryrun_multichip(world,
                                                            device='cpu')


# -- the large-graph trainer ----------------------------------------------


def largegraph_ranks(rank, world, cfg_kwargs, init_state):
    """The trainer on this rank from ``init_state``; its history."""
    from pna_tpu_torch.train.largegraph import (LargeGraphConfig,
                                                train_largegraph)
    _, history = train_largegraph(LargeGraphConfig(**cfg_kwargs),
                                  device='cpu', init_state=init_state)
    return history


# -- tower tensor parallelism -----------------------------------------------


def tower_tp_ranks(rank, world, layer_kw, state, records):
    """``PNALayerFused`` with its towers split over tp = 2 (ranks {0, 1}
    and {2, 3}) and tp = 4 (the world): for each tp, the output, the loss
    sum(out^2) and this rank's gradients (its towers' blocks, the rest
    whole), each rank back-propagating loss / tp and summing the
    replicated parameters' gradients over its group."""
    from pna_tpu_torch.graph import batch_graphs
    from pna_tpu_torch.nn.fused import PNALayerFused
    from pna_tpu_torch.parallel import collectives, tower_tp
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    graph = batch_graphs(records)
    out = {}
    for tp, group in ((2, pairs[rank // 2]), (4, dist.group.WORLD)):
        layer = PNALayerFused(**layer_kw, tp_group=group, device='cpu')
        layer.load_state_dict(tower_tp.shard_tower_state(
            state, dist.get_rank(group), tp))
        y = layer(graph, graph.node_feats)
        loss = (y * y).sum()
        (loss / tp).backward()
        specs = tower_tp.tower_param_specs(dict(layer.named_parameters()))
        collectives.all_reduce_grads(
            [p for n, p in layer.named_parameters() if not specs[n]], group)
        out[tp] = dict(out=y.detach(), loss=float(loss),
                       grads={n: p.grad.clone()
                              for n, p in layer.named_parameters()})
    return out


# -- multitask data parallelism ---------------------------------------------


def multitask_dp_ranks(rank, world, gnn_kw, state, frozen, cfg):
    """One step of ``MultitaskTrainer(data_parallel=True)`` on the first
    train bucket of the synthetic dataset from ``state``: its loss and the
    state after it."""
    from pna_tpu_torch.data import multitask as tmt
    from pna_tpu_torch.nn import gnn as tgnn
    from pna_tpu_torch.train import engine as teng
    data = tmt.load_multitask_dataset('synthetic', print_baseline=False)
    model = tgnn.GNN(in_features=2, device='cpu', seed=0, **gnn_kw)
    model.load_state_dict(state)
    for n in frozen:
        model.get_parameter(n).requires_grad_(False)
    trainer = teng.MultitaskTrainer(
        model, data, teng.TrainConfig(**cfg, data_parallel=True),
        device='cpu')
    loss = trainer.train_step(*trainer.buckets('train')[0])
    return dict(loss=float(loss), state=state_of(model))
