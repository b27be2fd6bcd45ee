"""OGB MolHIV classification main.

Counterpart of ``pna_tpu/cli/main_HIV.py``: the JSON config with CLI
overrides (the same flags), avg_d from the train in-degrees, the synthetic
dataset when asked for or when the OGB directory is absent, ``PNANetHIV``
and the training pipeline with the ROC-AUC metric and the best epoch chosen
by the largest validation ROC-AUC.  Its layers aggregate on the CSR kernels
(K1 with tie counts and K2 in training, K1 without ties in evaluation).

    python -m pna_tpu_torch.cli.main_HIV --synthetic

runs on the card; ``main(argv, device='cpu')`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

from pna_tpu_torch.data.hiv import HIVDataset
from pna_tpu_torch.device import DeviceLike, resolve_device
from pna_tpu_torch.nn.nets import PNANetHIV
from pna_tpu_torch.train.realworld import PipelineConfig, RealworldTrainer

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs')
# split sizes of the synthetic dataset (--synthetic, or no OGB directory)
SYNTHETIC = dict(n_train=1000, n_val=200, n_test=200)


def make_model(net: dict, ds, device: DeviceLike = None, *, seed: int):
    """The net of a config's ``net_params`` for dataset ``ds``, its weights
    and dropout generator seeded with ``seed``, and its forward adapter
    ``fwd(graph) -> model arguments``."""
    model = PNANetHIV(
        hidden_dim=net['hidden_dim'], out_dim=net['out_dim'],
        n_layers=net['L'], aggregators=tuple(net['aggregators'].split()),
        scalers=tuple(net['scalers'].split()), avg_d=ds.avg_d(),
        readout_type=net['readout'],
        in_feat_dropout=net['in_feat_dropout'], dropout=net['dropout'],
        batch_norm=net['batch_norm'], residual=net['residual'],
        posttrans_layers=net['posttrans_layers'], device=device, seed=seed)

    def fwd(graph):
        return graph, graph.node_feats

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
        max_time=params['max_time'], metric='roc_auc', **outputs)


def main(argv=None, *, device: DeviceLike = None):
    """Train as the flags say; returns the best epoch's record.  ``device``
    defaults to ``cuda``."""
    device = resolve_device(device)
    p = argparse.ArgumentParser()
    p.add_argument('--config', default=os.path.join(
        CONFIG_DIR, 'molecules_graph_classification_PNA_HIV.json'))
    p.add_argument('--data_dir', default='data/ogbg_molhiv')
    p.add_argument('--synthetic', action='store_true', default=False)
    p.add_argument('--checkpoint_dir', type=str, default=None,
                   help='directory for latest+best checkpoints (resume-able)')
    p.add_argument('--metrics_path', type=str, default=None,
                   help='JSONL per-epoch curve output')
    p.add_argument('--tensorboard_dir', type=str, default=None,
                   help='TensorBoard event dir (reference main_*.py TB logging)')
    p.add_argument('--resume', action='store_true', default=False,
                   help='resume from checkpoint_dir/latest.ckpt')
    for flag, typ in [('seed', int), ('epochs', int), ('batch_size', int),
                      ('init_lr', float), ('lr_reduce_factor', float),
                      ('lr_schedule_patience', int), ('min_lr', float),
                      ('weight_decay', float), ('max_time', float),
                      ('L', int), ('hidden_dim', int), ('out_dim', int),
                      ('dropout', float), ('in_feat_dropout', float),
                      ('readout', str), ('aggregators', str), ('scalers', str),
                      ('posttrans_layers', int)]:
        p.add_argument(f'--{flag}', type=typ, default=None)
    args = p.parse_args(argv)

    with open(args.config) as f:
        config = json.load(f)
    for section in ('params', 'net_params'):
        for k in list(config.get(section, {})):
            v = getattr(args, k, None)
            if v is not None:
                config[section][k] = v
    params, net = config['params'], config['net_params']

    if args.synthetic or not os.path.isdir(args.data_dir):
        print('[data] using synthetic MolHIV-like dataset')
        ds = HIVDataset.synthetic(**SYNTHETIC, seed=params['seed'])
    else:
        ds = HIVDataset.from_ogb_dir(args.data_dir)

    model, fwd = make_model(net, ds, device, seed=params['seed'])
    cfg = make_config(params, checkpoint_dir=args.checkpoint_dir,
                      resume=args.resume, metrics_path=args.metrics_path,
                      tensorboard_dir=args.tensorboard_dir)
    trainer = RealworldTrainer(model, PNANetHIV.loss, cfg, forward_args=fwd,
                               metric='roc_auc', device=device)
    _, best, _ = trainer.fit(ds, select_best='max')
    print(f"Best val ROC-AUC {best['val_metric']:.4f} @ epoch "
          f"{best['epoch']}; test ROC-AUC {best['test_metric']:.4f}")
    return best


if __name__ == '__main__':
    main()
