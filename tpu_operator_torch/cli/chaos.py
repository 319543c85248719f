"""gpuop-chaos: deterministic chaos scenarios against the mock cluster.

    gpuop-chaos list
    gpuop-chaos run --scenario upgrade-under-fire --nodes 100 --seed 7

``run`` builds an N-node mock cluster, converges it, replays the seeded
fault schedule (apiserver 409/429/5xx/latency, dropped watch streams,
node churn, chip loss, operand crash-loops — chaos/faults.py), checks
cluster invariants continuously (chaos/invariants.py), and prints one
JSON verdict: the schedule, every fault injected, every invariant
violation, and the virtual convergence time. The verdict is a pure
function of (scenario, nodes, seed, steps) — two runs are byte-identical
— so a red verdict IS its own reproducer. Exit 0 only when the cluster
converged with zero violations.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..chaos.runner import DEFAULT_STEPS, SCENARIOS, run_scenario


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpuop-chaos")
    from .. import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list the named scenarios")

    r = sub.add_parser(
        "run", help="run one scenario; print the JSON verdict; exit 0 "
                    "only on convergence with zero invariant violations")
    r.add_argument("--scenario", required=True, choices=SCENARIOS)
    r.add_argument("--nodes", type=int, default=100,
                   help="GPU node count of the mock cluster (default 100)")
    r.add_argument("--seed", type=int, default=0,
                   help="fault-schedule seed; same seed, same verdict")
    r.add_argument("--steps", type=int, default=DEFAULT_STEPS,
                   help=f"fault-injection steps (default {DEFAULT_STEPS})")
    r.add_argument("--no-cache", action="store_true",
                   help="controllers read through to the apiserver instead "
                        "of the informer cache (also drops the "
                        "cache-staleness invariant)")

    args = p.parse_args(argv)
    if args.cmd == "list":
        for s in SCENARIOS:
            print(s)
        return 0

    verdict = run_scenario(args.scenario, nodes=args.nodes, seed=args.seed,
                           steps=args.steps, cached=not args.no_cache)
    print(json.dumps(verdict, indent=2, sort_keys=True))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
