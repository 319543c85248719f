"""Driving a cell on the CPU at a small size, for the tests: every step of
a run but the look for a card, with gloo in place of NCCL."""

from __future__ import annotations

import copy
import importlib
import time

from perfbench import harness, manifest

# sizes a CPU test run holds, by traffic kind (the card's widths kept)
SMALL = {
    "attention": {"traffic": {"seq": 128}},
    "triad": {"config": {"hbm_size_mb": 2.0, "hbm_cols": 4096},
              "traffic": {"per_batch": 4}},
    "allreduce": {"config": {"nvlink_size_mb": 1.0},
                  "traffic": {"per_batch": 4}},
}


def small_cell(name: str, world: int = None) -> manifest.Cell:
    cell = copy.deepcopy(manifest.load_cell(name))
    small = SMALL[cell.traffic["kind"]]
    cell.config.update(small.get("config", {}))
    cell.traffic.update(small.get("traffic", {}))
    if world is not None:
        cell.chips = world
    return cell


# the entries a fault may replace, restored after each run in this process
_ENTRIES = (("tpu_operator_torch.workloads.flashattention", "flash_attention"),
            ("tpu_operator_torch.workloads.hbm_probe", "triad_"),
            ("tpu_operator_torch.workloads.collectives", "_step"))


def run(cell: manifest.Cell, seed: int = 12345678901, seconds: float = 0.5,
        trace: bool = False, patch: str = None) -> dict:
    """The result line a run of ``cell`` on the CPU prints."""
    spec = harness.RunSpec(cell=cell, seed=seed, seconds=seconds, trace=trace,
                           t_start=time.perf_counter(), device_type="cpu",
                           patch=patch)
    saved = [(mod, name, getattr(importlib.import_module(mod), name))
             for mod, name in _ENTRIES]
    try:
        return harness.result(spec, harness.run_ranks(spec), "cpu", None)
    finally:
        for mod, name, fn in saved:
            setattr(importlib.import_module(mod), name, fn)
