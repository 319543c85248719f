"""Expert parallelism: a Switch-style top-1 MoE layer over a process group.

Counterpart of ``tpu_operator/workloads/moe.py``. One expert FFN a rank;
each rank routes its resident tokens (top-1, a fixed capacity per source
rank and expert, overflow dropped: static shapes, as in JAX), dispatches
them to their experts with ``all_to_all``, applies its own expert, and
sends the results back with a second ``all_to_all``: the exchange that
stresses the all-to-all path of the interconnect.

Gradients are JAX's: the expert weights get theirs through the
all-to-all's backward (the reverse exchange), and the replicated router,
whose JAX gradient is the sum over devices, goes through
``parallel.comm.grad_sum``, so its gradient is summed over the group.

Like every workload here it is also a proof: the sharded layer must match
a single-device oracle running the identical routing math,
``reference_moe``, so a corrupted all-to-all cannot pass.
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


def init_moe_params(seed: int, n_experts: int, d_model: int, d_ff: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router [D, E] (replicated) and stacked per-expert FFN weights
    (leading dim = expert, one a rank), f32, drawn from a
    ``torch.Generator`` at JAX's scales (normal / sqrt(fan_in)). Tests
    carry JAX's parameters across through ``convert.moe_params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "router": torch.randn((d_model, n_experts), generator=gen)
        / math.sqrt(d_model),
        "w1": torch.randn((n_experts, d_model, d_ff), generator=gen)
        / math.sqrt(d_model),
        "w2": torch.randn((n_experts, d_ff, d_model), generator=gen)
        / math.sqrt(d_ff),
    }
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def expert_of(params: Dict[str, torch.Tensor], e: int
              ) -> Dict[str, torch.Tensor]:
    """The router and expert ``e``'s weights: what rank e holds."""
    return {"router": params["router"], "w1": params["w1"][e],
            "w2": params["w2"][e]}


def _route(x, router, n_experts: int, capacity: int):
    """Top-1 routing with fixed capacity. x: [b, D]. Returns the combine
    weights [b, E, C] (zero for dropped tokens) and the 0/1 dispatch mask
    of the same shape, f32."""
    logits = x @ router                                    # [b, E]
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)                          # [b]
    gate = probs.amax(dim=-1)                              # [b]
    onehot = F.one_hot(expert, n_experts).to(torch.int32)  # [b, E]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1         # [b, E]
    kept = (pos >= 0) & (pos < capacity)
    slots = torch.arange(capacity, device=x.device)
    pos_oh = (pos.clamp(0, max(capacity - 1, 0))[..., None] == slots) \
        .to(x.dtype)                                       # [b, E, C]
    dispatch = pos_oh * kept[..., None]
    combine = dispatch * gate[:, None, None]
    return combine, dispatch


def expert_ffn(w1, w2, x):
    return F.gelu(x @ w1, approximate="tanh") @ w2


def moe_forward(params: Dict[str, torch.Tensor], x_local: torch.Tensor,
                group=None, capacity: Optional[int] = None) -> torch.Tensor:
    """Call on every rank of ``group``: rank e holds expert e's ``w1``
    [D, F] and ``w2`` [F, D] and the router [D, E]; ``x_local`` [b, D]
    is its resident tokens. Returns this rank's [b, D]; differentiable.
    ``capacity`` defaults to b; an explicit 0 drops every token."""
    n_experts = dist.get_world_size(group)
    cap = x_local.shape[0] if capacity is None else capacity
    router = comm.grad_sum(params["router"], group)
    combine, dispatch = _route(x_local, router, n_experts, cap)
    # this rank's outgoing tokens per expert: [E, C, D]
    sent = torch.einsum("bec,bd->ecd", dispatch, x_local)
    # exchange: dim 0 becomes the SOURCE rank, my expert everywhere
    received = comm.all_to_all(sent, group)
    flat = received.reshape(-1, received.shape[-1])
    done = expert_ffn(params["w1"], params["w2"], flat).reshape(received.shape)
    # results back to their source ranks: [E, C, D]
    returned = comm.all_to_all(done, group)
    # combine weights zero out dropped tokens (they contribute nothing,
    # matching the oracle's capacity semantics)
    return torch.einsum("bec,ecd->bd", combine, returned)


def reference_moe(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  n_devices: int, capacity: int) -> torch.Tensor:
    """Single-device oracle with the identical per-rank routing and
    capacity math: each source rank's [b_local, D] slice is routed on its
    own, at the sharded path's shapes (capacity is per source rank per
    expert)."""
    n_experts = params["w1"].shape[0]
    b_local = x.shape[0] // n_devices
    outs = []
    for d in range(n_devices):
        xd = x[d * b_local:(d + 1) * b_local]
        combine, dispatch = _route(xd, params["router"], n_experts, capacity)
        sent = torch.einsum("bec,bd->ecd", dispatch, xd)     # [E, C, D]
        done = torch.stack([
            expert_ffn(params["w1"][e], params["w2"][e], sent[e])
            for e in range(n_experts)])
        outs.append(torch.einsum("bec,ecd->bd", combine, done))
    return torch.cat(outs, dim=0)


@dataclass
class MoEResult:
    experts: int
    tokens: int
    capacity: int
    dropped_fraction: float
    max_abs_err: float
    correct: bool
    device_kind: str


class CaseReport(NamedTuple):
    """One case on one rank: the harness's result (errors nan off rank 0),
    the oracle's largest |value| (nan off rank 0), and the best seconds of
    the timed calls."""
    result: MoEResult
    oracle_max: float
    seconds: float


def moe_case(device, tokens_per_expert: int = 16, d_model: int = 32,
             d_ff: int = 64, seed: int = 0,
             capacity: Optional[int] = None, repeats: int = 1) -> CaseReport:
    """One case on this rank of the current group, one expert a rank:
    seeded weights and tokens (the same on every rank; each takes its
    expert and its resident tokens), one warm-up call, then ``repeats``
    timed calls; rank 0 gathers the output and holds it to the oracle in
    f32 (JAX's 1e-4). ``capacity`` defaults to ``tokens_per_expert``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    cap = tokens_per_expert if capacity is None else capacity
    params = init_moe_params(seed, n, d_model, d_ff, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((n * tokens_per_expert, d_model), generator=gen).to(device)
    mine = expert_of(params, rank)
    x_local = x[rank * tokens_per_expert:(rank + 1) * tokens_per_expert]

    def call():
        with torch.no_grad():
            return moe_forward(mine, x_local, capacity=cap)

    out, best = pmesh.timed(call, device, repeats)
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out)
    err = top = dropped = float("nan")
    if rank == 0:
        with torch.no_grad():
            want = reference_moe(params, x, n, cap)
        err = (torch.cat(parts) - want).abs().max().item()
        top = want.abs().max().item()
        # tokens beyond an expert's capacity on their rank give zero rows
        dropped = (want == 0.0).all(dim=-1).float().mean().item()
    result = MoEResult(experts=n, tokens=x.shape[0], capacity=cap,
                       dropped_fraction=dropped, max_abs_err=err,
                       correct=err < 1e-4, device_kind=device_kind(device))
    return CaseReport(result, top, best)


def moe_rank(rank, world_size, device, case: dict) -> CaseReport:
    """Per-rank body for ``mesh.spawn``: ``moe_case(device, **case)``."""
    return moe_case(device, **case)


def run(tokens_per_expert: int = 16, d_model: int = 32, d_ff: int = 64,
        seed: int = 0, device=None,
        world_size: Optional[int] = None) -> MoEResult:
    """Expert-parallel MoE, one expert per rank (default: one rank per
    visible card, NCCL; ``device="cpu"`` runs gloo ranks, one unless
    asked), diffed against the oracle."""
    case = dict(tokens_per_expert=tokens_per_expert, d_model=d_model,
                d_ff=d_ff, seed=seed)
    return multihost.spawn_or_join(moe_rank, (case,), device,
                                   world_size).result


def main() -> int:
    res = run()
    print(res)
    return 0 if res.correct else 1


if __name__ == "__main__":
    raise SystemExit(main())
