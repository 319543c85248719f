"""The controls: each cell's plain reference put in the program's place,
computed one precision below the one its configuration states, and
judged by the cell's own numbers and limits. A control has to come out
not correct; its readings are the upper readings from which a cell's
limits are set.

    python3 perfbench/controls.py --workload <cell> --seeds 1,2,3

runs at the cell's own size on one card (a cell on several chips has its
every rank's inputs drawn on the one card) and prints one JSON line a
seed. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, device_type: str = "cuda") -> dict:
    """{number: (control's reading, limit)} of one seed."""
    import torch

    from perfbench import harness, manifest

    spec = harness.RunSpec(cell=cell, seed=seed, seconds=1.0, trace=False,
                           t_start=time.perf_counter(),
                           device_type=device_type)
    device = torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device("cpu")
    gen = manifest.generator_class(cell.traffic["kind"])(
        harness.Rank(spec, 0, device))
    return {c.name: (c.value, c.limit) for c in gen.control()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from perfbench import manifest

    cell = manifest.load_cell(args.workload)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed)
        fails = any(not v <= lim for v, lim in got.values())
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_fails": fails,
                          "seconds": time.perf_counter() - t0,
                          "readings": {k: v for k, (v, _) in got.items()},
                          "limits": {k: lim for k, (_, lim) in got.items()}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
