"""Everything the harness runs, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell with its
configuration, traffic and chips, and each metric. Beside it, under
``perfbench/``:

- ``configs/<config>.json``: a configuration's sizes (the file that
  ``BENCHMARK.json`` names for it);
- ``traffic/<traffic>.json``: a traffic mix's parameters, with ``kind``
  naming the generator in ``generators/<kind>.py`` that reads them, and the
  limits of the numbers by which its answers are judged;
- ``layer_metrics/<name>.py``: the reader of one per-layer metric.

A later cell, configuration or metric is new files and new entries; no
file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass
from typing import List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file's contents
    traffic: dict                # the traffic file's contents
    end_to_end: List[dict]       # the metrics the cell reports, --trace 0
    per_layer: List[dict]        # the metrics the cell reports, --trace 1


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str, e2e_names: Optional[set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without a list: every cell that reports the end-to-end metric it moves
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, bench: Optional[dict] = None,
              root: pathlib.Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    traffic = load_traffic(w["traffic"], root)
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _for_cell(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def load_traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    with open(root / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def generator_class(kind: str):
    """The generator class of a traffic kind: ``generators/<kind>.py``'s
    ``Generator``."""
    return importlib.import_module(f"perfbench.generators.{kind}").Generator


def layer_reader(name: str, root: pathlib.Path = ROOT):
    """``layer_metrics/<name>.py``'s ``read``; the name may hold dots, so
    the file is loaded by its path."""
    path = root / "perfbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_layer_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
