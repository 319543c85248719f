"""Process groups and device meshes of ranks.

Counterpart of ``ring_mesh``, ``factor_axes`` and ``build_mesh`` in
``tpu_operator/parallel/mesh.py``. Where JAX runs one program over a mesh
of devices, torch runs one process per card in a process group: NCCL on
the card (over NVLink inside a host), gloo on the CPU. A mesh is a
``DeviceMesh`` over those ranks; its *layout*, the numpy array of rank
ids, is computed apart (``mesh_layout``) so it can be checked without a
process group.

``spawn`` starts the ranks of one host with ``torch.multiprocessing``.
The rendezvous address is a free port found at run time, never a fixed
one, so concurrent runs (test workers, two validators) cannot collide;
and the join has a deadline, so a hung rank fails the run instead of
hanging it.
"""

from __future__ import annotations

import datetime
import math
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..workloads.backend import synchronize

DEFAULT_TIMEOUT_S = 300.0


def factor_axes(n: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """Split n ranks into (data, model). When unspecified, model gets the
    largest power-of-two factor <= sqrt(n) so both axes stay useful."""
    if model_parallel:
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by "
                             f"model_parallel={model_parallel}")
        return n // model_parallel, model_parallel
    model = 1
    while model * 2 <= int(math.isqrt(n)) and n % (model * 2) == 0:
        model *= 2
    return n // model, model


def mesh_layout(ranks: Sequence[int],
                model_parallel: Optional[int] = None) -> np.ndarray:
    """The [data, model] array of rank ids ``build_mesh`` lays out:
    ``ranks`` in order, row-major, so a model group is consecutive ranks."""
    dp, mp_ = factor_axes(len(ranks), model_parallel)
    return np.asarray(ranks, dtype=np.int64).reshape(dp, mp_)


def device_type() -> str:
    """The device type of this rank's process group's meshes."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_of(layout: np.ndarray, axis_names: Sequence[str]):
    """A ``DeviceMesh`` over ``layout``'s ranks of the current process
    group. Every rank of the group calls it (it makes sub-groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type(), torch.as_tensor(layout),
                      mesh_dim_names=tuple(axis_names))


def build_mesh(ranks: Optional[Sequence[int]] = None,
               model_parallel: Optional[int] = None,
               axis_names: Tuple[str, str] = ("data", "model")):
    """[data, model] ``DeviceMesh`` over ``ranks`` (default: every rank of
    the current group)."""
    if ranks is None:
        ranks = range(dist.get_world_size())
    return mesh_of(mesh_layout(list(ranks), model_parallel), axis_names)


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


def timed(call: Callable, device, repeats: int = 1):
    """``call()`` on every rank of the current group: one warm-up call,
    then ``repeats`` calls, each begun together after a barrier with the
    card drained; returns the last output and the best wall seconds."""
    out = call()
    best = math.inf
    for _ in range(repeats):
        synchronize(device)
        dist.barrier()
        t0 = time.perf_counter()
        out = call()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


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
