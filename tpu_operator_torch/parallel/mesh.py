"""Process groups: the ring of ranks the collective proofs run over.

Counterpart of ``ring_mesh`` in ``tpu_operator/parallel/mesh.py``. Where
JAX runs one program over a 1-D mesh of devices, torch runs one process
per card in a process group: NCCL on the card (over NVLink inside a
host), gloo on the CPU.

``spawn`` starts the ranks of one host with ``torch.multiprocessing``.
The rendezvous address is a free port found at run time, never a fixed
one, so concurrent runs (test workers, two validators) cannot collide;
and the join has a deadline, so a hung rank fails the run instead of
hanging it.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ring(rank: int, world_size: int, init_method: str,
              device_type: str,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group as ``rank``; returns this rank's device
    (``cuda:<rank>`` on the card, the CPU otherwise)."""
    kwargs = {}
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev  # binds the NCCL communicator to the card
    else:
        dev = torch.device("cpu")
        # the ranks share the host's cores: an equal share each keeps
        # torch's thread pools from spinning against one another
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def _rank_main(fn, rank, world_size, init_method, device_type, timeout_s,
               args, results) -> None:
    try:
        dev = init_ring(rank, world_size, init_method, device_type, timeout_s)
        results.put((rank, True, fn(rank, world_size, dev, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device_type: str,
          args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    joined in one process group; returns the per-rank results in rank
    order. ``fn`` and ``args`` must pickle (``fn`` at module level).

    Raises RuntimeError if a rank raises, dies, or the ranks have not all
    reported within ``timeout_s``; every rank is stopped either way.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, init_method,
                               device_type, timeout_s, tuple(args), results),
                         daemon=True)
             for rank in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        # drain the queue before joining: a rank blocks in exit until
        # its result is read
        while len(got) < world_size and failure is None:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    failure = f"rank(s) {dead} exited without a result"
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(world_size)) - set(got))} "
                               f"still running after {timeout_s:.0f}s")
                continue
            if ok:
                got[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if failure is None:  # all reported: let them exit on their own
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"collective run over {world_size} rank(s): {failure}")
    return [got[r] for r in range(world_size)]
