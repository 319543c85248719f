"""Multi-node backend: process bootstrap, node-aware meshes, DCN probe.

Counterpart of ``tpu_operator/parallel/multihost.py``. On GPUs a "slice"
is a node: one NVLink domain, whose cards talk over NVLink, while traffic
between nodes crosses the data-centre network (DCN). Two halves:

- **Process bootstrap** (``initialize``): one process per card, all
  joined in one ``torch.distributed`` process group. Sources, most
  explicit first: the framework's GPU_* contract (coordinator address,
  process count and id), then torchrun's env (``MASTER_ADDR`` set: the
  launcher knows the process topology, so the group is joined through
  ``env://``), else a single process. Idempotent: a rank that
  ``mesh.spawn`` started has already joined.
- **Hybrid mesh shaping** (``hybrid_mesh``, ``training_mesh``): ranks are
  grouped by node, the grouping must be rectangular, and the mesh is
  shaped [dcn, data, model] (or [data, model] with the model axis inside
  one node), so only data-parallel traffic crosses the DCN.

Each mesh's layout (a numpy array of rank ids) is computed apart from the
``DeviceMesh`` built on it, so the layouts can be checked without a
process group. ``dcn_allreduce_probe`` measures the cross-node gradient
sync: an all-reduce over the mesh's dcn axis only.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import mesh
from ..workloads.backend import resolve_device, synchronize

log = logging.getLogger("tpu_operator_torch.multihost")

# torchrun's default rendezvous port, where JAX's coordinator uses 8080
DEFAULT_MASTER_PORT = 29500


@dataclass
class DistributedConfig:
    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    auto: bool = False  # the launcher's env (torchrun) holds the topology

    @property
    def multi_process(self) -> bool:
        return self.auto or self.num_processes > 1

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "DistributedConfig":
        """Resolve the process-bootstrap contract from the environment.

        Precedence: the framework's own GPU_* contract, then torchrun's
        env (``MASTER_ADDR``), else single-process. torchrun's env names
        the rendezvous, and the launcher, not the node, knows the process
        topology: such a process joins through ``env://`` (``auto``)."""
        e = os.environ if env is None else env
        if e.get("GPU_COORDINATOR_ADDRESS"):
            return cls(coordinator_address=e["GPU_COORDINATOR_ADDRESS"],
                       num_processes=int(e.get("GPU_NUM_PROCESSES", "1")),
                       process_id=int(e.get("GPU_PROCESS_ID",
                                            e.get("GPU_WORKER_ID", "0"))))
        if e.get("MASTER_ADDR"):
            return cls(coordinator_address=None, num_processes=0,
                       process_id=0, auto=True)
        return cls(coordinator_address=None, num_processes=1, process_id=0)


def initialize(config: Optional[DistributedConfig] = None
               ) -> DistributedConfig:
    """Join the process group from the env contract. A no-op for a
    single process and where this process has already joined; NCCL on
    the card, gloo on the CPU."""
    cfg = config or DistributedConfig.from_env()
    if not cfg.multi_process or dist.is_initialized():
        return cfg
    kwargs = {}
    if torch.cuda.is_available():
        local = int(os.environ.get(
            "LOCAL_RANK", cfg.process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if cfg.auto:
        dist.init_process_group(backend, init_method="env://", **kwargs)
        log.info("joined process group (torchrun env): rank %s/%s",
                 os.environ.get("RANK"), os.environ.get("WORLD_SIZE"))
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.process_id, **kwargs)
        log.info("joined process group: process %d/%d via %s",
                 cfg.process_id, cfg.num_processes, cfg.coordinator_address)
    return cfg


def spawn_or_join(fn: Callable, args: Sequence = (), device=None,
                  world_size: Optional[int] = None):
    """``fn(rank, world_size, device, *args)`` on every rank of the job;
    returns rank 0's result (this rank's, in a job that was joined).

    Without CUDA this raises unless the caller asked for the CPU, under
    torchrun too. A process launched by torchrun (or given the GPU_*
    contract) joins its job's group (``initialize``) and runs ``fn`` in
    place; otherwise ``world_size`` ranks are spawned (default: one per
    visible card over NCCL; ``device="cpu"``: gloo ranks, one unless
    asked)."""
    dev_type = resolve_device(device).type
    if DistributedConfig.from_env().multi_process:
        initialize()
        return fn(dist.get_rank(), dist.get_world_size(), local_device(),
                  *args)
    if world_size is None:
        world_size = torch.cuda.device_count() if dev_type == "cuda" else 1
    return mesh.spawn(fn, world_size, dev_type, args=tuple(args))[0]


def axis_group(m, name: str):
    """The process group of ``m``'s axis ``name``, or None where there is
    no mesh or the axis has one rank (nothing to reduce over)."""
    if m is None or m[name].size() == 1:
        return None
    return m.get_group(name)


def data_rows(t: torch.Tensor, m) -> torch.Tensor:
    """This rank's rows of a global [B, ...] tensor: ``m``'s data axis
    shards the batch (``m=None``: every row)."""
    if m is None:
        return t
    n, i = m["data"].size(), m["data"].get_local_rank()
    rows = t.shape[0] // n
    return t[i * rows:(i + 1) * rows]


def local_device() -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if mesh.device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# a process group's node ids, gathered once per group
_node_ids: Dict[int, List[int]] = {}


def slice_id_of(rank: int) -> int:
    """A rank's slice: the node it runs on, torchrun's ``GROUP_RANK``
    (0 where unset), gathered from every rank on first use. Without a
    process group there is one rank, on slice 0."""
    if not dist.is_initialized():
        return 0
    key = id(dist.group.WORLD)
    if key not in _node_ids:
        ids: List[Optional[int]] = [None] * dist.get_world_size()
        dist.all_gather_object(ids, int(os.environ.get("GROUP_RANK", "0")))
        _node_ids[key] = [int(i) for i in ids]
    return _node_ids[key][rank]


def fake_slice_getter(ranks: Sequence[int], n_slices: int) -> Callable:
    """Split ``ranks`` into ``n_slices`` equal index-contiguous groups —
    the slice_getter fake/test clusters (one node holding every rank)
    inject into hybrid/training meshes and the DCN probe."""
    per = len(ranks) // n_slices
    if per < 1:
        raise ValueError(f"{n_slices} slices exceed the "
                         f"{len(ranks)} visible devices")
    index = {r: i for i, r in enumerate(ranks)}
    return lambda r: index[r] // per


def _ranks(ranks: Optional[Sequence[int]]) -> List[int]:
    if ranks is not None:
        return list(ranks)
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def group_by_slice(ranks: Sequence[int],
                   slice_getter: Callable = slice_id_of) -> List[List[int]]:
    groups: Dict[int, List[int]] = {}
    for r in ranks:
        groups.setdefault(slice_getter(r), []).append(r)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) > 1:
        raise ValueError(
            f"slices are not the same size: "
            f"{ {k: len(v) for k, v in groups.items()} } — a hybrid mesh "
            "needs a rectangular slice grouping")
    return [groups[k] for k in sorted(groups)]


def hybrid_layout(ranks: Optional[Sequence[int]] = None,
                  model_parallel: Optional[int] = None,
                  slice_getter: Callable = slice_id_of) -> np.ndarray:
    """[num_slices, data, model] array of rank ids: the slice axis (DCN)
    outermost, so only the least chatty parallelism (data) crosses
    nodes, and each node's ranks contiguous inside one dcn index."""
    slices = group_by_slice(_ranks(ranks), slice_getter)
    dp, mp_ = mesh.factor_axes(len(slices[0]), model_parallel)
    return np.array([r for g in slices for r in g],
                    dtype=np.int64).reshape(len(slices), dp, mp_)


def hybrid_mesh(ranks: Optional[Sequence[int]] = None,
                model_parallel: Optional[int] = None,
                axis_names: Tuple[str, str, str] = ("dcn", "data", "model"),
                slice_getter: Callable = slice_id_of):
    """``DeviceMesh`` on ``hybrid_layout``: tensor/model axes stay inside
    one node's NVLink domain."""
    return mesh.mesh_of(hybrid_layout(ranks, model_parallel, slice_getter),
                        axis_names)


def training_layout(ranks: Optional[Sequence[int]] = None,
                    model_parallel: Optional[int] = None,
                    slice_getter: Callable = slice_id_of) -> np.ndarray:
    """[data, model] array of rank ids whose model axis sits inside one
    slice: ranks ordered slice by slice, the model factor taken from the
    per-slice size, so tensor-parallel collectives stay on NVLink and
    the data axis (gradient all-reduce) is what spans the DCN."""
    slices = group_by_slice(_ranks(ranks), slice_getter)
    per_slice = len(slices[0])
    if model_parallel and model_parallel > per_slice:
        raise ValueError(
            f"model_parallel={model_parallel} exceeds the slice size "
            f"{per_slice}: the model axis must not cross the DCN")
    dp_inner, mp_ = mesh.factor_axes(per_slice, model_parallel)
    ordered = [r for g in slices for r in g]
    return np.array(ordered, dtype=np.int64).reshape(
        len(slices) * dp_inner, mp_)


def training_mesh(ranks: Optional[Sequence[int]] = None,
                  model_parallel: Optional[int] = None,
                  slice_getter: Callable = slice_id_of):
    """2D [data, model] ``DeviceMesh`` on ``training_layout``. Workloads
    written against [data, model] placements (the burn-in step) run
    unchanged on multi-node topologies through this."""
    return mesh.mesh_of(training_layout(ranks, model_parallel, slice_getter),
                        ("data", "model"))


def mesh_for_env(ranks: Optional[Sequence[int]] = None,
                 model_parallel: Optional[int] = None):
    """Hybrid [dcn, data, model] when the ranks span nodes, plain
    [data, model] otherwise."""
    ranks = _ranks(ranks)
    if len({slice_id_of(r) for r in ranks}) > 1:
        return hybrid_mesh(ranks, model_parallel)
    return mesh.build_mesh(ranks, model_parallel)


# ---------------------------------------------------------------------------
# DCN bandwidth probe (cross-node gradient-sync measurement)
# ---------------------------------------------------------------------------


@dataclass
class DCNProbeResult:
    """Gradient-sync bandwidth across the DCN: an all-reduce over ONLY
    the hybrid mesh's dcn axis — the traffic a data-parallel-across-nodes
    step generates — measured with the chained protocol of the NVLink
    suite."""

    slices: int
    devices_per_slice: int
    bytes_per_device: int
    seconds: float
    algo_bw_gbps: float       # per-device gradient bytes / time
    bus_bw_gbps: float        # per-device DCN traffic (ring accounting)
    device_kind: str
    correct: bool


def dcn_allreduce_probe(size_mb: float = 64.0, iters: int = 8,
                        repeats: int = 3, ranks=None,
                        slice_getter: Callable = slice_id_of,
                        ) -> DCNProbeResult:
    """Run on every rank of the current group. ``correct`` is this rank's
    own check of its shard; a caller over several ranks ands them."""
    layout = hybrid_layout(ranks, slice_getter=slice_getter)
    s = layout.shape[0]
    if s < 2:
        raise ValueError("single slice: no DCN axis to probe")
    per_slice = layout.shape[1] * layout.shape[2]
    n_dev = s * per_slice
    hmesh = mesh.mesh_of(layout, ("dcn", "data", "model"))
    flat = [int(r) for r in layout.flatten()]
    rank = dist.get_rank()
    dev = local_device()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    k = max(1, int(size_mb * 1e6 / 4))
    if rank not in flat:  # a rank left out of the layout moves nothing
        return DCNProbeResult(s, per_slice, k * 4, 0.0, 0.0, 0.0, kind, True)
    group = hmesh.get_group("dcn")
    x = torch.ones(k, dtype=torch.float32, device=dev)

    def chain(c):
        for _ in range(iters):
            dist.all_reduce(c, group=group)
            c.mul_(1.0 / s)
        return c

    chain(x)
    synchronize(dev)  # warm-up: the group's communicators are built here
    calls = 4
    best = float("inf")
    for _ in range(repeats):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(calls):
            chain(x)
        synchronize(dev)
        best = min(best, time.perf_counter() - t0)

    # correctness on varying data: the sum over dcn must equal the sum of
    # the corresponding shards from every slice; each rank checks its own
    base = np.arange(n_dev * 8, dtype=np.float32)
    idx = flat.index(rank)
    shard = torch.from_numpy(base[idx * 8:(idx + 1) * 8].copy()).to(dev)
    dist.all_reduce(shard, group=group)
    want_full = np.tile(base.reshape(s, per_slice * 8).sum(axis=0), (s,))
    correct = bool(np.allclose(shard.cpu().numpy(),
                               want_full[idx * 8:(idx + 1) * 8], rtol=1e-4))

    per_iter = best / (iters * calls)
    nbytes = k * 4
    algo = nbytes / per_iter / 1e9
    bus = (2.0 * (s - 1) / s) * nbytes / per_iter / 1e9
    return DCNProbeResult(
        slices=s, devices_per_slice=per_slice, bytes_per_device=nbytes,
        seconds=best, algo_bw_gbps=algo, bus_bw_gbps=bus,
        device_kind=kind, correct=correct)


def fake_slices_probe_rank(rank, world_size, device, n_slices: int,
                           kwargs: dict) -> DCNProbeResult:
    """Per-rank body for ``mesh.spawn``: the probe over ``n_slices``
    equal groups of the spawned ranks (one node, so the "DCN" traffic
    rides NVLink)."""
    ranks = list(range(world_size))
    per = world_size // n_slices
    return dcn_allreduce_probe(
        ranks=ranks[:per * n_slices],
        slice_getter=fake_slice_getter(ranks, n_slices), **kwargs)


def fake_slices_probe(n_slices: int, device=None,
                      world_size: Optional[int] = None,
                      **kwargs) -> DCNProbeResult:
    """``dcn_allreduce_probe`` over ``n_slices`` fake slices of this
    host's cards, one spawned rank per card (``device="cpu"``: gloo
    ranks, ``world_size`` of them). Rank 0's figures; ``correct`` only if
    every rank's shard was."""
    dev_type = resolve_device(device).type
    if world_size is None:
        world_size = torch.cuda.device_count() if dev_type == "cuda" else 1
    if world_size // n_slices < 1:
        raise ValueError(f"{n_slices} slices exceed the {world_size} "
                         f"visible devices")
    results = mesh.spawn(fake_slices_probe_rank, world_size, dev_type,
                         args=(n_slices, kwargs))
    first = results[0]
    first.correct = all(r.correct for r in results)
    return first
