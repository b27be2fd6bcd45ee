"""Cells of the benchmark cut to a size the CPU runs in seconds."""

import copy

from portbench import spec

SMALL = {
    'zinc_pna.train_b128': dict(n_graphs=600, warmup_steps=0,
                                traced_steps=2),
    'largegraph_pna.powerlaw_6m': dict(num_nodes=3000, num_edges=30000,
                                       warmup_steps=0, traced_steps=2),
}


def small_cell(name, root=spec.ROOT):
    cell = spec.load_cell(name, root)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    for k, v in SMALL[name].items():
        (cell.config if k in cell.config else cell.traffic)[k] = v
    return cell
