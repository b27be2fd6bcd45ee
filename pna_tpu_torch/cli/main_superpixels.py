"""MNIST/CIFAR10 superpixel classification main.

Counterpart of ``pna_tpu/cli/main_superpixels.py``: the molecules main's
structure with its own config merge (no bool parsing), the accuracy metric
and the best epoch chosen by the largest validation accuracy.

    python -m pna_tpu_torch.cli.main_superpixels --synthetic --epochs 2

runs on the card; ``main(argv, device='cpu')`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

from pna_tpu_torch.data.superpixels import SuperpixelsDataset
from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.nn.nets import PNANetSuperpixels
from pna_tpu_torch.train.realworld import PipelineConfig, RealworldTrainer

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs')
# split sizes of the synthetic dataset (--synthetic, or no data files)
SYNTHETIC = dict(n_train=600, n_val=100, n_test=100)


def make_model(net: dict, ds, device: DeviceLike = None):
    """The net of a config's ``net_params`` for dataset ``ds``, and
    its forward adapter ``fwd(graph) -> model arguments``."""
    avg_d = ds.avg_d()
    in_dim = ds.train[0]['node_feats'].shape[-1]
    model = PNANetSuperpixels(
        in_dim=in_dim, in_dim_edge=1,
        hidden_dim=net['hidden_dim'], out_dim=net['out_dim'],
        n_classes=ds.n_classes, n_layers=net['L'],
        aggregators=tuple(net['aggregators'].split()),
        scalers=tuple(net['scalers'].split()), avg_d=avg_d,
        readout_type=net['readout'], dropout=net['dropout'],
        graph_norm=net['graph_norm'], batch_norm=net['batch_norm'],
        residual=net['residual'], towers=net['towers'],
        divide_input_first=net['divide_input_first'],
        divide_input_last=net['divide_input_last'],
        edge_feat=net['edge_feat'], edge_dim=net['edge_dim'],
        pretrans_layers=net['pretrans_layers'],
        posttrans_layers=net['posttrans_layers'], gru_enable=net['gru'],
        device=device)

    def fwd(graph):
        if net['edge_feat']:
            return graph, graph.node_feats, graph.edge_feats
        return graph, graph.node_feats, None

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
        max_time=params['max_time'], metric='accuracy',
        **outputs)


def main(argv=None, *, device: DeviceLike = None):
    """Train as the flags say; returns the best epoch's record.  ``device``
    defaults to ``cuda``."""
    device = resolve_device(device)
    p = argparse.ArgumentParser()
    p.add_argument('--config', default=os.path.join(
        CONFIG_DIR, 'superpixels_graph_classification_pna_MNIST.json'))
    p.add_argument('--dataset', default=None, choices=[None, 'MNIST', 'CIFAR10'])
    p.add_argument('--data_dir', default='data/superpixels')
    p.add_argument('--checkpoint_dir', type=str, default=None,
                   help='directory for latest+best checkpoints (resume-able)')
    p.add_argument('--metrics_path', type=str, default=None,
                   help='JSONL per-epoch curve output')
    p.add_argument('--tensorboard_dir', type=str, default=None,
                   help='TensorBoard event dir (reference main_*.py TB logging)')
    p.add_argument('--resume', action='store_true', default=False,
                   help='resume from checkpoint_dir/latest.ckpt')
    p.add_argument('--synthetic', action='store_true', default=False)
    for flag, typ in [('seed', int), ('epochs', int), ('batch_size', int),
                      ('init_lr', float), ('lr_reduce_factor', float),
                      ('lr_schedule_patience', int), ('min_lr', float),
                      ('weight_decay', float), ('max_time', float),
                      ('L', int), ('hidden_dim', int), ('out_dim', int),
                      ('dropout', float), ('in_feat_dropout', float),
                      ('readout', str), ('aggregators', str), ('scalers', str),
                      ('towers', int), ('pretrans_layers', int),
                      ('posttrans_layers', int), ('edge_dim', int)]:
        p.add_argument(f'--{flag}', type=typ, default=None)
    args = p.parse_args(argv)

    with open(args.config) as f:
        config = json.load(f)
    if args.dataset:
        config['dataset'] = args.dataset
    for section in ('params', 'net_params'):
        for k in list(config.get(section, {})):
            v = getattr(args, k, None)
            if v is not None:
                config[section][k] = v
    params, net = config['params'], config['net_params']
    dataset_name = config['dataset']

    have_files = os.path.exists(os.path.join(
        args.data_dir,
        ('mnist_75sp_train.pkl' if dataset_name == 'MNIST'
         else 'cifar10_150sp_train.pkl')))
    if args.synthetic or not have_files:
        print('[data] using synthetic superpixel dataset')
        ds = SuperpixelsDataset.synthetic(**SYNTHETIC,
                                          seed=params['seed'])
    else:
        ds = SuperpixelsDataset.from_dir(args.data_dir, dataset_name)

    model, fwd = make_model(net, ds, device)
    cfg = make_config(params, checkpoint_dir=args.checkpoint_dir,
                      resume=args.resume,
                      metrics_path=args.metrics_path,
                      tensorboard_dir=args.tensorboard_dir)
    trainer = RealworldTrainer(model, PNANetSuperpixels.loss, cfg,
                               forward_args=fwd, metric='accuracy',
                               device=device)
    _, best, _ = trainer.fit(ds, select_best='max')
    print(f"Best val acc {best['val_metric']:.4f} @ epoch {best['epoch']}; "
          f"test acc {best['test_metric']:.4f}")
    return best


if __name__ == '__main__':
    main()
