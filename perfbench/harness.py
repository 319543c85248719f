"""One run of one cell: set-up, the measured window, the optional trace,
the check against the plain reference, and the result line.

A run is one process (rank 0) and, for a cell on more than one chip, one
spawned process for each further rank, joined over TCP on 127.0.0.1. Each
rank runs the traffic's generator (``generators/<kind>.py``) through the
same steps:

1. ``setup``: inputs from the seed, on the device; every shape the window
   uses warmed, so the kernels are built (first run in a checkout) or
   loaded (every later run) before the window opens;
2. the window: ``batch`` again and again until ``--seconds`` have passed
   on rank 0's host clock (rank 0's decision is broadcast to the others
   after each batch); with ``--trace 1`` under ``torch.profiler``;
3. the peak of device memory is read, the program's state freed, and
   ``check`` holds what the window produced to the reference.

Rank 0 gathers every rank's figures and prints the result: the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``),
with each number compared and its limit, last, on standard error and in
the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import manifest, roofline

# modules a run may not hold once its window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_operator")
RANK_TIMEOUT_S = 300.0


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one input, from the run's seed and its tags."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tags):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class RunSpec:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float                  # perf_counter at the start of the process
    device_type: str = "cuda"
    patch: Optional[str] = None     # "module:function" run in every rank first
    world: int = field(init=False)

    def __post_init__(self):
        self.world = self.cell.chips


class Rank:
    """What a generator is handed: its device, rank, seed, the cell's
    files, and the span helper."""

    def __init__(self, spec: RunSpec, rank: int, device):
        self.rank = rank
        self.world = spec.world
        self.device = device
        self.seed = spec.seed
        self.config = spec.cell.config
        self.traffic = spec.cell.traffic
        self.seconds = spec.seconds
        self.tracing = spec.trace

    def gen(self, *tags):
        return generator(self.device, self.seed, *tags)

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("perfbench." + name)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            with self.span("sync"):
                torch.cuda.synchronize(self.device)


def _run_rank(spec: RunSpec, rank: int, port: Optional[int]) -> Optional[dict]:
    """Every rank's run; rank 0 returns all ranks' figures."""
    import torch
    import torch.distributed as dist

    if spec.patch:
        mod, fn = spec.patch.split(":")
        getattr(__import__(mod, fromlist=[fn]), fn)()
    if spec.device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * spec.world)))
    if spec.world > 1:
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=spec.world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S), **kw)
    try:
        return _rank_body(spec, rank, device)
    finally:
        if spec.world > 1:
            dist.destroy_process_group()


def _stop(rank: Rank, mine: bool) -> bool:
    """Rank 0's decision, on every rank."""
    if rank.world == 1:
        return mine
    import torch
    import torch.distributed as dist

    with rank.span("stop"):
        flag = torch.tensor([1 if mine else 0], dtype=torch.int32,
                            device=rank.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


def _rank_body(spec: RunSpec, rank_id: int, device) -> Optional[dict]:
    import torch

    rank = Rank(spec, rank_id, device)
    gen = manifest.generator_class(spec.cell.traffic["kind"])(rank)
    gen.setup()
    rank.sync()
    if spec.world > 1:
        import torch.distributed as dist

        dist.barrier()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if spec.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - spec.t_start
    calls = 0
    t0 = time.perf_counter()
    with rank.span("window"):
        while True:
            calls += gen.batch(time.perf_counter() - t0)
            if _stop(rank, time.perf_counter() - t0 >= spec.seconds):
                break
    window_s = time.perf_counter() - t0
    trace_path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, trace_path = tempfile.mkstemp(prefix="perfbench-trace-",
                                          suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    mine = {"rank": rank_id, "calls": calls, "window_s": window_s,
            "setup_s": setup_s, "peak": peak,
            "e2e": gen.end_to_end(window_s, calls)}
    facts = gen.facts()
    gen.release()
    if on_card:
        torch.cuda.empty_cache()
    mine["checks"] = [c.__dict__ for c in gen.check()]
    mine["notes"] = gen.notes()
    if trace_path is not None:
        from . import trace

        kind = torch.cuda.get_device_name(device) if on_card else "cpu"
        try:
            t = trace.read_chrome_trace(trace_path, calls, facts,
                                        roofline.peak_for(kind))
        finally:
            os.unlink(trace_path)
        mine["busy_s"] = t.busy_s
        mine["trace_window_s"] = t.window_s
        mine["notes"].append(f"trace: {len(t.ops)} device operations, "
                             f"{t.tied} tied to their launch")
        if rank_id == 0:
            layer = {}
            for m in spec.cell.per_layer:
                v = manifest.layer_reader(m["name"])(t)
                if v is not None:
                    layer[m["name"]] = v
            mine["layer"] = layer
            mine["breakdown"] = {"device_ops": t.top_ops(10),
                                 "idle_gaps": [list(g) for g in t.gaps[:10]]}
    mine["modules"] = sorted({m.split(".")[0] for m in sys.modules}
                             & set(FORBIDDEN))
    if spec.world == 1:
        return {"ranks": [mine]}
    import torch.distributed as dist

    gathered = [None] * spec.world
    dist.all_gather_object(gathered, mine)
    return {"ranks": gathered} if rank_id == 0 else None


def _child(spec: RunSpec, rank: int, port: int) -> None:
    try:
        _run_rank(spec, rank, port)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec: RunSpec) -> dict:
    """Every rank's figures; the further ranks are spawned processes, all
    ended and waited for before this returns."""
    if spec.world == 1:
        return _run_rank(spec, 0, None)
    import multiprocessing as mp

    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(spec, r, port))
             for r in range(1, spec.world)]
    for p in procs:
        p.start()
    try:
        out = _run_rank(spec, 0, port)
    finally:
        deadline = time.monotonic() + 60
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank process failed (exit codes {bad})")
    return out


def _power_limit() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if res.returncode == 0 and lines else None


def merge_checks(ranks: List[dict]) -> List[Check]:
    """Each number compared, the worst over the ranks."""
    merged: Dict[str, Check] = {}
    for r in ranks:
        for c in r["checks"]:
            c = Check(**c)
            old = merged.get(c.name)
            if old is None or not (c.value <= old.value):
                merged[c.name] = c
    return list(merged.values())


def result(spec: RunSpec, out: dict, kind: str, power_limit) -> dict:
    ranks = out["ranks"]
    r0 = ranks[0]
    checks = merge_checks(ranks)
    correct = bool(checks) and all(c.ok for c in checks)
    units = {m["name"]: m["unit"]
             for m in spec.cell.end_to_end + spec.cell.per_layer}
    if spec.trace:
        values = dict(r0.get("layer", {}))
    else:
        values = dict(r0["e2e"])
        values["setup_s"] = r0["setup_s"]
        values["peak_gib"] = max(r["peak"] for r in ranks) / 2**30
        missing = [m["name"] for m in spec.cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the generator gave no {missing}")
        values = {m["name"]: values[m["name"]] for m in spec.cell.end_to_end}
    device = {"platform": "gpu" if spec.device_type == "cuda" else "cpu",
              "kind": kind, "count": spec.world,
              "memory_peak_bytes": max(r["peak"] for r in ranks),
              "power_limit": power_limit}
    if spec.trace:
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in ranks)
        device["window_s"] = r0["trace_window_s"]
    # failed: the numbers compared that are over their limits
    line = {"correct": correct, "attempted": r0["calls"],
            "failed": sum(not c.ok for c in checks),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if spec.trace and "breakdown" in r0:
        line["breakdown"] = r0["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's "
                                "benchmark once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "alone", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    spec = RunSpec(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=t_start)
    out = run_ranks(spec)
    return emit(spec, out, torch.cuda.get_device_name(0), _power_limit())


def emit(spec: RunSpec, out: dict, kind: str, power_limit) -> int:
    """Print the notes, the compared numbers and the result line; 0 if
    the result may stand, 3 if a forbidden module was loaded."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    for r in out["ranks"]:
        found = sorted(set(found) | set(r["modules"]))
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    line = result(spec, out, kind, power_limit)
    for note in out["ranks"][0]["notes"]:
        print(note, file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
