"""CLI: edge-partitioned training on one large graph over a ('data',
'graph') mesh.

Counterpart of ``pna_tpu/cli/train_largegraph.py``, with its flags; the
kernel choices are the port's (``--kernel {auto,generic,csr,csr_fused}``).
One process per rank:

    # one card, the whole graph on it (100k nodes, 1M power-law edges)
    python -m pna_tpu_torch.cli.train_largegraph --d_graph 1 --kernel csr

    # N cards of one host, the graph partitioned over them
    torchrun --nproc_per_node N -m pna_tpu_torch.cli.train_largegraph \\
        --d_graph N --kernel csr --log runs/lg.jsonl

    # the GAT paper's PPI model (train/largegraph.py::ppi_gat_config) on
    # the same graph: 50 features, 121 labels, lr 0.005, the csr layout
    python -m pna_tpu_torch.cli.train_largegraph --d_graph 1 --model gat

``main(argv, device='cpu')`` runs it on the CPU (gloo).  It prints one JSON
line: the steps run, the first train loss and the last record.
"""

from __future__ import annotations

import argparse
import json

from pna_tpu_torch.parallel import multihost
from pna_tpu_torch.train.largegraph import (KERNELS, MODELS,
                                            LargeGraphConfig,
                                            ppi_gat_config, train_largegraph)


def build_parser():
    """The flags.  One whose default is None takes the model's default
    (``LargeGraphConfig``'s, or ``ppi_gat_config``'s for ``--model gat``)."""
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--model', default='pna', choices=list(MODELS))
    p.add_argument('--nodes', type=int, default=100_000)
    p.add_argument('--edges', type=int, default=1_000_000)
    p.add_argument('--graph', default='powerlaw',
                   choices=['powerlaw', 'uniform'])
    p.add_argument('--exponent', type=float, default=1.5)
    p.add_argument('--feat_dim', type=int, default=None,
                   help='default: 8, or 50 for --model gat')
    p.add_argument('--edge_feat_dim', type=int, default=0)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--d_data', type=int, default=1)
    p.add_argument('--d_graph', type=int, default=8)
    p.add_argument('--kernel', default=None, choices=list(KERNELS),
                   help="default: 'auto' ('csr' for --model gat)")
    p.add_argument('--hidden_dim', type=int, default=64)
    p.add_argument('--out_dim', type=int, default=64)
    p.add_argument('--n_layers', type=int, default=4)
    p.add_argument('--towers', type=int, default=4)
    p.add_argument('--aggregators', default='mean max min std')
    p.add_argument('--scalers', default='identity amplification attenuation')
    p.add_argument('--no_batch_norm', action='store_true')
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--lr', type=float, default=None,
                   help='default: 1e-3, or 0.005 for --model gat')
    p.add_argument('--weight_decay', type=float, default=0.0)
    p.add_argument('--val_frac', type=float, default=0.1)
    p.add_argument('--eval_every', type=int, default=10)
    p.add_argument('--ckpt_every', type=int, default=25)
    p.add_argument('--patience', type=int, default=0)
    p.add_argument('--log', default=None, help='JSONL curve path')
    p.add_argument('--ckpt_dir', default=None)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--max_degree', type=int, default=0)
    return p


def config_from_args(args) -> LargeGraphConfig:
    common = dict(
        num_nodes=args.nodes, num_edges=args.edges, graph_kind=args.graph,
        exponent=args.exponent, feat_dim=args.feat_dim,
        edge_feat_dim=args.edge_feat_dim, seed=args.seed,
        d_data=args.d_data, d_graph=args.d_graph, kernel=args.kernel,
        steps=args.steps, lr=args.lr, weight_decay=args.weight_decay,
        val_frac=args.val_frac, eval_every=args.eval_every,
        ckpt_every=args.ckpt_every, patience=args.patience,
        log_path=args.log, ckpt_dir=args.ckpt_dir, resume=args.resume)
    common = {k: v for k, v in common.items() if v is not None}
    if args.model == 'gat':
        return ppi_gat_config(**common)
    return LargeGraphConfig(
        hidden_dim=args.hidden_dim, out_dim=args.out_dim,
        n_layers=args.n_layers, towers=args.towers,
        aggregators=tuple(args.aggregators.split()),
        scalers=tuple(args.scalers.split()),
        batch_norm=not args.no_batch_norm, max_degree=args.max_degree,
        **common)


def main(argv=None, device=None):
    """Train; returns (net, history).  ``device``: None runs on this rank's
    card, ``'cpu'`` on the CPU."""
    args = build_parser().parse_args(argv)
    net, history = train_largegraph(config_from_args(args), device=device)
    if multihost.is_coordinator():
        first = history[0]['train_loss'] if history else float('nan')
        last = history[-1] if history else {}
        print(json.dumps({'steps_run': len(history),
                          'first_train_loss': first, 'final': last}),
              flush=True)
    return net, history


if __name__ == '__main__':
    main()
