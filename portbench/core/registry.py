"""Finds a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the file its ``configs`` entry names
  (``portbench/configs/<config>.json``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a cell: ``portbench/workloads/<cell>.json`` (its limits for ``correct``
  and its trace plan);
* a metric, end-to-end or per-layer: ``portbench/metrics/<metric>.py``, a
  reader that declares its unit, its layer and the end-to-end metric it
  moves, and whose ``read(run)`` returns the number or None where the run
  holds nothing to read. The cells that report a metric are listed in one
  place only: its entry's ``workloads`` in ``BENCHMARK.json`` (every cell
  where the entry has none).

A later cell, configuration or metric is a new file and a new entry (a
new cell that reports a metric with a ``workloads`` list joins that list):
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and cell files."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "portbench")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", entry["traffic"] + ".json")),
        spec=_json(os.path.join(here, "workloads", name + ".json")))


def reader(name: str, root: str = ROOT):
    """The module ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, cell_name: str, trace: bool, root: str = ROOT) -> list:
    """[(entry, reader)] of the metrics a run of ``cell_name`` reports: with
    ``trace`` the per-layer ones, else the end-to-end ones; each where its
    ``workloads`` key (if any) lists the cell."""
    out = []
    for entry in bench["per_layer" if trace else "end_to_end"]:
        if cell_name in entry.get("workloads", [cell_name]):
            out.append((entry, reader(entry["name"], root)))
    return out
