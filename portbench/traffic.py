"""The one generator of the benchmark's inputs, driven by a traffic file.

A cell's traffic (``portbench/workloads/<cell>.json``) names its ``kind``
and the parameters of that kind; the configuration gives the sizes that
belong to the model.  The same seed gives the same inputs.

* ``molecules``: ``n_graphs`` ZINC-shaped molecules of ``n_min`` to
  ``n_max`` atoms (``generators.zinc_like_molecules``).
* ``graph``: one graph of the configuration's ``num_nodes`` and
  ``num_edges``, ``graph_kind`` 'powerlaw' (senders ~ rank^-``exponent``,
  uniform receivers) or 'uniform'; ``feat_dim`` standard normal features
  per node, the neighbour-statistics target, and a validation share
  ``val_frac`` of the nodes left out of the loss.
"""

from __future__ import annotations

import numpy as np

from portbench import generators
from portbench.weights import sub_seeds


def make_inputs(config: dict, traffic: dict, seed: int) -> dict:
    s = sub_seeds(seed, 4)
    kind = traffic['kind']
    if kind == 'molecules':
        return dict(records=generators.zinc_like_molecules(
            traffic['n_graphs'], int(s[0]), traffic['n_min'],
            traffic['n_max']))
    if kind == 'graph':
        n, e = config['num_nodes'], config['num_edges']
        if traffic['graph_kind'] == 'powerlaw':
            send, recv = generators.powerlaw_graph(n, e, int(s[0]),
                                                   traffic['exponent'])
        elif traffic['graph_kind'] == 'uniform':
            send, recv = generators.uniform_graph(n, e, int(s[0]))
        else:
            raise ValueError(f"graph_kind {traffic['graph_kind']!r}")
        rng = np.random.RandomState(int(s[1]))
        feats = rng.randn(n, config['feat_dim']).astype(np.float32)
        labels = generators.neighbor_stats_labels(send, recv, feats, n)
        val = rng.rand(n) < traffic['val_frac']
        return dict(senders=send, receivers=recv, feats=feats,
                    labels=labels, val=val, num_nodes=n)
    raise ValueError(f"traffic kind {kind!r}")
