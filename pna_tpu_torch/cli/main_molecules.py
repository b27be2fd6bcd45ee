"""ZINC molecular regression main.

Counterpart of ``pna_tpu/cli/main_molecules.py``: the JSON config with CLI
overrides (the same flags and bool parsing), avg_d from the train
in-degrees, the synthetic dataset when asked for or when the split pickles
are absent, and the training pipeline on the CSR kernels.

    python -m pna_tpu_torch.cli.main_molecules --synthetic --epochs 3

runs on the card; ``main(argv, device='cpu')`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

from pna_tpu_torch.data.molecules import ZincDataset
from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train.realworld import PipelineConfig, RealworldTrainer

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs')
# split sizes of the synthetic dataset (--synthetic, or no data files)
SYNTHETIC = dict(n_train=1000, n_val=200, n_test=200)


def add_override_flags(p: argparse.ArgumentParser):
    """CLI overrides of the JSON config (main_molecules.py:254-361 merge:
    CLI wins when given)."""
    p.add_argument('--config',
                   default=os.path.join(
                       CONFIG_DIR, 'molecules_graph_regression_pna_ZINC.json'))
    p.add_argument('--dataset', default=None)
    p.add_argument('--data_dir', default='data/molecules',
                   help='directory with {train,val,test}.pickle + .index')
    p.add_argument('--checkpoint_dir', type=str, default=None,
                   help='directory for latest+best checkpoints (resume-able)')
    p.add_argument('--metrics_path', type=str, default=None,
                   help='JSONL per-epoch curve output')
    p.add_argument('--tensorboard_dir', type=str, default=None,
                   help='TensorBoard event dir (reference main_*.py TB logging)')
    p.add_argument('--resume', action='store_true', default=False,
                   help='resume from checkpoint_dir/latest.ckpt')
    p.add_argument('--synthetic', action='store_true', default=False,
                   help='use the synthetic ZINC-like dataset (no files needed)')
    for flag, typ in [('seed', int), ('epochs', int), ('batch_size', int),
                      ('init_lr', float), ('lr_reduce_factor', float),
                      ('lr_schedule_patience', int), ('min_lr', float),
                      ('weight_decay', float), ('max_time', float)]:
        p.add_argument(f'--{flag}', type=typ, default=None)
    for flag, typ in [('L', int), ('hidden_dim', int), ('out_dim', int),
                      ('residual', str), ('edge_feat', str), ('readout', str),
                      ('in_feat_dropout', float), ('dropout', float),
                      ('graph_norm', str), ('batch_norm', str),
                      ('aggregators', str), ('scalers', str), ('towers', int),
                      ('divide_input_first', str), ('divide_input_last', str),
                      ('gru', str), ('edge_dim', int),
                      ('pretrans_layers', int), ('posttrans_layers', int)]:
        p.add_argument(f'--{flag}', type=typ, default=None)
    return p


def merge_config(args) -> dict:
    with open(args.config) as f:
        config = json.load(f)
    bools = {'residual', 'edge_feat', 'graph_norm', 'batch_norm',
             'divide_input_first', 'divide_input_last', 'gru'}
    for section in ('params', 'net_params'):
        for k in list(config.get(section, {})):
            v = getattr(args, k, None)
            if v is not None:
                config[section][k] = (v in ('True', 'true', True)
                                      if k in bools else v)
    return config


def make_model(net: dict, ds, device: DeviceLike = None, *, seed: int):
    """The net of a config's ``net_params`` for dataset ``ds``, its weights
    and dropout generator seeded with ``seed``, and its forward adapter
    ``fwd(graph) -> model arguments``."""
    avg_d = ds.avg_d()
    model = PNANetMolecules(
        num_atom_type=ds.num_atom_type, num_bond_type=ds.num_bond_type,
        hidden_dim=net['hidden_dim'], out_dim=net['out_dim'],
        n_layers=net['L'],
        aggregators=tuple(net['aggregators'].split()),
        scalers=tuple(net['scalers'].split()), avg_d=avg_d,
        readout_type=net['readout'],
        in_feat_dropout=net['in_feat_dropout'], dropout=net['dropout'],
        graph_norm=net['graph_norm'], batch_norm=net['batch_norm'],
        residual=net['residual'], towers=net['towers'],
        divide_input_first=net['divide_input_first'],
        divide_input_last=net['divide_input_last'],
        edge_feat=net['edge_feat'], edge_dim=net['edge_dim'],
        pretrans_layers=net['pretrans_layers'],
        posttrans_layers=net['posttrans_layers'], gru_enable=net['gru'],
        device=device, seed=seed)

    def fwd(graph):
        if net['edge_feat']:
            return (graph, graph.node_feats.squeeze(-1),
                    graph.edge_feats.squeeze(-1))
        return (graph, graph.node_feats.squeeze(-1), None)

    return model, fwd


def make_config(params: dict, **outputs) -> PipelineConfig:
    """The pipeline settings of a config's ``params``; ``outputs`` are
    the checkpoint, resume and log settings."""
    return PipelineConfig(
        seed=params['seed'], epochs=params['epochs'],
        batch_size=params['batch_size'], init_lr=params['init_lr'],
        lr_reduce_factor=params['lr_reduce_factor'],
        lr_schedule_patience=params['lr_schedule_patience'],
        min_lr=params['min_lr'], weight_decay=params['weight_decay'],
        max_time=params['max_time'], metric='mae',
        **outputs)


def main(argv=None, *, device: DeviceLike = None):
    """Train as the flags say; returns the best epoch's record.  ``device``
    defaults to ``cuda``."""
    device = resolve_device(device)
    args = add_override_flags(argparse.ArgumentParser()).parse_args(argv)
    config = merge_config(args)
    params, net = config['params'], config['net_params']

    if args.synthetic or not os.path.exists(
            os.path.join(args.data_dir, 'train.pickle')):
        print('[data] using synthetic ZINC-like dataset')
        ds = ZincDataset.synthetic(**SYNTHETIC,
                                   seed=params['seed'])
    else:
        ds = ZincDataset.from_dir(args.data_dir)

    model, fwd = make_model(net, ds, device, seed=params['seed'])
    cfg = make_config(params, checkpoint_dir=args.checkpoint_dir,
                      resume=args.resume,
                      metrics_path=args.metrics_path,
                      tensorboard_dir=args.tensorboard_dir)
    trainer = RealworldTrainer(model, PNANetMolecules.loss, cfg,
                               forward_args=fwd, metric='mae', device=device)
    _, best, _ = trainer.fit(ds)
    print(f"Best val MAE {best['val_metric']:.4f} @ epoch {best['epoch']}; "
          f"test MAE {best['test_metric']:.4f}")
    return best


if __name__ == '__main__':
    main()
