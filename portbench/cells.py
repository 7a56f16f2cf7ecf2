"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its ``file``) and a traffic mix
(``traffic/<name>.json``).  Each metric is a reader of its own,
``metrics/<name>.py``, with ``read(rec)`` returning a number or None; each
configuration's limits for the numbers that decide ``correct`` are in
``limits/<configuration>.json``.  Adding a configuration, a mix, a cell or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json and the benchmark's folder


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # [(name, unit)] the cell reports with --trace 0
    per_layer: list  # [(name, unit)] the cell reports with --trace 1
    limits: dict


def _reports(metric: dict, cell: str, end_to_end_names) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end_names


def load(cell: str, root: Path = ROOT) -> Cell:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    folder = root / HERE.name
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {n for n, _ in e2e}
    layer = [(m["name"], m["unit"]) for m in bench["per_layer"] if _reports(m, cell, names)]
    return Cell(name=cell, chips=int(w["chips"]),
                config=json.loads((root / c["file"]).read_text()),
                traffic=json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=layer,
                limits=json.loads((folder / "limits" / f"{c['name']}.json").read_text()))


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
