"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is an entry of ``workloads``; its
configuration is the file the ``configs`` entry names, its traffic is
``portbench/workloads/<cell>.json``, its driver is
``portbench/drivers/<traffic['driver']>.py`` and each metric is
``portbench/metrics/<metric>.py``.  Adding a cell, a configuration or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


@dataclass
class Cell:
    name: str
    entry: dict          # the workloads entry
    config: dict         # the configuration file
    traffic: dict        # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.entry['chips'])


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w['name']: w for w in bench['workloads']}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[name]
    configs = {c['name']: c for c in bench['configs']}
    config = _read(os.path.join(root, configs[entry['config']]['file']))
    traffic = _read(os.path.join(root, 'portbench', 'workloads',
                                 f'{name}.json'))
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench['end_to_end']
                            if _applies(m, name)],
                per_layer=[m for m in bench['per_layer']
                           if _applies(m, name)])


def load_metric(name: str, root: str = ROOT) -> ModuleType:
    """``portbench/metrics/<name>.py``, loaded by its path (a name may hold
    dots); it defines ``read(ctx) -> float or None``."""
    path = os.path.join(root, 'portbench', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_").replace("-", "_")}',
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str) -> ModuleType:
    """``portbench/drivers/<name>.py``: it defines ``Driver``."""
    return importlib.import_module(f'portbench.drivers.{name}')
