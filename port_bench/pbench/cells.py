"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads the configuration from the file the entry gives, the mix
from ``traffic/<name>.json``, the check's sample sizes and limits from
``checks/<cell>.json``, each per-layer metric's reader from
``metrics/<name>.py`` and each reference scorer the checks name from
``pbref/<module>.py``, all beside ``run.py``.  A new cell, mix, metric,
scorer or configuration is a new file and a new entry; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(root: str, harness: str, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(harness, "traffic", w["traffic"] + ".json"))
    checks = load_json(os.path.join(harness, "checks", name + ".json"))
    return Cell(name, w["chips"], config, traffic, checks,
                [m for m in bench["end_to_end"] if reported_in(m, name)],
                [m for m in bench["per_layer"] if reported_in(m, name)])


def _load(harness: str, folder: str, name: str):
    path = os.path.join(harness, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(harness: str, metric: str):
    """The ``read(window)`` function of ``metrics/<metric>.py``."""
    return _load(harness, "metrics", metric).read


def scorer(harness: str, module: str):
    """The ``score(gt, seqs, device)`` function of ``pbref/<module>.py``:
    a scoring route's (pools, candidate haplotypes) float64 reference
    scores of one locus, or None where it cannot score it."""
    return _load(harness, "pbref", module).score
