"""Pipeline parallelism (GPipe) over a process group, one stage a rank.

Counterpart of ``tpu_operator/workloads/pipeline.py``. Each rank holds one
stage (a pre-norm FFN block with a residual); microbatches stream through
the ranks, the activations handed from stage to stage with
``parallel.comm.ring_shift``, in JAX's schedule: M + S - 1 ticks for M
microbatches over S stages, every rank computing its stage on every tick
(the fill and drain ticks compute on garbage, as the SPMD program does),
the last stage recording microbatch t - (S - 1) at tick t. The masked
output buffer is summed over the ranks (``replicate_sum``), so the output
is replicated and its gradient is JAX's.

The rank-local branches are ``torch.where`` on a flag, not Python ``if``:
every rank's autograd graph then holds every hop, so every rank runs each
hop's backward exchange, in the same order, as the transposed SPMD program
does (a rank that skipped one would leave its neighbour waiting).

Like every workload here it is also a proof: the pipelined forward must
match the sequential single-device oracle, ``reference_forward``, so a
stage hand-off that corrupts activations cannot pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import comm
from ..parallel import mesh as pmesh
from ..parallel import multihost
from .backend import resolve_device
from .hardware import device_kind


def init_stage_params(seed: int, n_stages: int, d_model: int, d_ff: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """Stacked per-stage FFN-block weights, f32, leading dim = stage, drawn
    from a ``torch.Generator`` at JAX's scales (normal / sqrt(fan_in),
    zero biases). The draws differ from JAX's ``PRNGKey``; tests carry
    JAX's parameters across through ``convert.pipeline_params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "w1": torch.randn((n_stages, d_model, d_ff), generator=gen)
        / math.sqrt(d_model),
        "b1": torch.zeros((n_stages, d_ff)),
        "w2": torch.randn((n_stages, d_ff, d_model), generator=gen)
        / math.sqrt(d_ff),
        "b2": torch.zeros((n_stages, d_model)),
    }
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def stage_of(params: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    """Stage ``s``'s weights from the stacked tree."""
    return {k: v[s] for k, v in params.items()}


def stage_fn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One pipeline stage: pre-norm FFN block with residual. The variance
    is the population one (``jnp.var``), the GELU the tanh form
    (``jax.nn.gelu``)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    h = (x - mu) * torch.rsqrt(var + 1e-6)
    h = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
    return x + h @ p["w2"] + p["b2"]


def reference_forward(params: Dict[str, torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: every stage of the stacked tree on one device."""
    for s in range(params["w1"].shape[0]):
        x = stage_fn(stage_of(params, s), x)
    return x


def pipeline_forward(stage_params: Dict[str, torch.Tensor], x: torch.Tensor,
                     group=None, n_microbatches: int = 4) -> torch.Tensor:
    """Call on every rank of ``group``, rank s holding stage s's weights
    and the same x: [B, T, D], B divisible by ``n_microbatches``. Returns
    the pipeline's output [B, T, D] on every rank; differentiable."""
    batch, seq, d_model = x.shape
    if batch % n_microbatches:
        raise ValueError(f"batch={batch} not divisible by "
                         f"n_microbatches={n_microbatches}")
    n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
    x_micro = x.reshape(n_microbatches, batch // n_microbatches, seq, d_model)
    on, off = (torch.tensor(b, device=x.device) for b in (True, False))
    first = on if stage == 0 else off
    last = on if stage == n_stages - 1 else off
    act = torch.zeros_like(x_micro[0])
    slots = [torch.zeros_like(x_micro[0]) for _ in range(n_microbatches)]
    for t in range(n_microbatches + n_stages - 1):
        # stage 0 injects microbatch t (clipped: injections past M are
        # drain garbage that never reaches the output window)
        inject = x_micro[min(t, n_microbatches - 1)]
        my_out = stage_fn(stage_params, torch.where(first, inject, act))
        # the last stage completes microbatch t - (S - 1) at tick t
        idx = t - (n_stages - 1)
        slot = min(max(idx, 0), n_microbatches - 1)
        write = last if 0 <= idx < n_microbatches else off
        slots[slot] = torch.where(write, my_out, slots[slot])
        act = comm.ring_shift(my_out, group)
    outbuf = torch.stack(slots)
    # results live on the last stage; the sum of the masked buffer
    # replicates them everywhere
    mine = torch.where(last, outbuf, torch.zeros_like(outbuf))
    return comm.replicate_sum(mine, group).reshape(batch, seq, d_model)


@dataclass
class PipelineResult:
    stages: int
    microbatches: int
    batch: int
    seq_len: int
    d_model: int
    max_abs_err: float
    correct: bool
    device_kind: str


class CaseReport(NamedTuple):
    """One case on one rank: the harness's result (errors nan off rank 0),
    the oracle's largest |value| (nan off rank 0), and the best seconds of
    the timed calls."""
    result: PipelineResult
    oracle_max: float
    seconds: float


def pipeline_case(device, batch: int = 8, seq_len: int = 16,
                  d_model: int = 32, d_ff: int = 64, n_microbatches: int = 4,
                  seed: int = 0, repeats: int = 1) -> CaseReport:
    """One case on this rank of the current group, one stage a rank:
    seeded weights and input (the same on every rank; each takes its
    stage), one warm-up call, then ``repeats`` timed calls; rank 0 holds
    the output to the sequential oracle in f32 (JAX's 1e-4)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    params = init_stage_params(seed, n, d_model, d_ff, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((batch, seq_len, d_model), generator=gen).to(device)
    mine = stage_of(params, rank)

    def call():
        with torch.no_grad():
            return pipeline_forward(mine, x, n_microbatches=n_microbatches)

    out, best = pmesh.timed(call, device, repeats)
    err = top = float("nan")
    if rank == 0:
        with torch.no_grad():
            want = reference_forward(params, x)
        err = (out - want).abs().max().item()
        top = want.abs().max().item()
    result = PipelineResult(
        stages=n, microbatches=n_microbatches, batch=batch, seq_len=seq_len,
        d_model=d_model, max_abs_err=err, correct=err < 1e-4,
        device_kind=device_kind(device))
    return CaseReport(result, top, best)


def pipeline_rank(rank, world_size, device, case: dict) -> CaseReport:
    """Per-rank body for ``mesh.spawn``: ``pipeline_case(device, **case)``."""
    return pipeline_case(device, **case)


def run(batch: int = 8, seq_len: int = 16, d_model: int = 32, d_ff: int = 64,
        n_microbatches: int = 4, seed: int = 0, device=None,
        world_size: Optional[int] = None) -> PipelineResult:
    """Build a pipeline of one stage per rank (default: one rank per
    visible card, NCCL; ``device="cpu"`` runs gloo ranks, one unless
    asked), stream microbatches through it, and diff against the
    sequential oracle."""
    if batch % n_microbatches:
        raise ValueError(f"batch={batch} not divisible by "
                         f"n_microbatches={n_microbatches}")
    case = dict(batch=batch, seq_len=seq_len, d_model=d_model, d_ff=d_ff,
                n_microbatches=n_microbatches, seed=seed)
    return multihost.spawn_or_join(pipeline_rank, (case,), device,
                                   world_size).result


def main() -> int:
    res = run()
    print(res)
    return 0 if res.correct else 1


if __name__ == "__main__":
    raise SystemExit(main())
