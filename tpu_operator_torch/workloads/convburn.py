"""Conv burn-in: the vision/conv model family of the fleet-exercise set.

Counterpart of ``tpu_operator/workloads/convburn.py``. The transformer
burn-in (``burnin.py``) exercises the tensor cores through products; this
workload exercises convolutions, which reach other kernels (cuDNN's
convolution algorithms) and other memory access patterns (feature maps in
place of attention caches). A card that only ever ran products can still
fault on convolutions.

Layout: activations NCHW (stored ``channels_last``, the layout cuDNN's
tensor-core convolutions run in), filters OIHW, ``padding=1`` (JAX's
"SAME" for a 3x3 at stride 1); ``convert.conv_params_from_jax`` moves
JAX's HWIO filters across. bf16 compute, f32 norm statistics and head.

Sharding over a [data, model] mesh, one rank per card, in the JAX
package's placements (``param_specs``), with Megatron's collectives
written out (``parallel.comm``) rather than left to DTensor, whose rule
for ``aten.convolution`` does not shard a filter's channels:

- each residual block's ``conv1`` is column-parallel (output channels on
  ``model``, ``scale1`` following them) and ``conv2`` row-parallel (input
  channels on ``model``); the block's input goes through ``grad_sum``
  (identity forward, gradient summed over ``model``) and ``conv2``'s
  partial sums through ``replicate_sum`` (one all-reduce a block);
- the head is column-parallel (classes on ``model``), its logits
  gathered (``gather_last``);
- data parallelism over the batch, gradients averaged over ``data``.

The correctness oracle is the burn-in's: the loss must fall over a few
steps (gradients flowed through every shard).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import comm
from ..parallel import multihost
from .backend import resolve_device
from .burnin import adamw


@dataclass(frozen=True)
class ConvBurninConfig:
    image_size: int = 32
    in_channels: int = 3
    width: int = 32          # channel width; divisible by the model axis
    n_blocks: int = 2
    n_classes: int = 16
    batch: int = 8
    learning_rate: float = 1e-3
    dtype: torch.dtype = torch.bfloat16


# --- parameters + shardings ------------------------------------------------


def init_params(cfg: ConvBurninConfig, seed: int = 0, device=None) -> Dict:
    """The parameter tree (JAX's: ``stem``, ``head``, ``blocks``), f32,
    filters OIHW, drawn from a ``torch.Generator`` in the JAX init's order
    and scales (He init over the fan-in kH·kW·I; the head normal /
    sqrt(width); norm scales one). Tests carry JAX's parameters across
    through ``convert.conv_params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)

    def he(o, i):
        return torch.randn((o, i, 3, 3), generator=gen) * math.sqrt(
            2.0 / (9 * i))

    w = cfg.width
    p: Dict = {"stem": he(w, cfg.in_channels),
               "head": torch.randn((w, cfg.n_classes), generator=gen)
               / math.sqrt(w),
               "blocks": []}
    for _ in range(cfg.n_blocks):
        p["blocks"].append({"conv1": he(w, w), "conv2": he(w, w),
                            "scale1": torch.ones(w), "scale2": torch.ones(w)})
    return to_device(p, resolve_device(device))


def to_device(params: Dict, device) -> Dict:
    return {"stem": params["stem"].to(device),
            "head": params["head"].to(device),
            "blocks": [{k: v.to(device) for k, v in b.items()}
                       for b in params["blocks"]]}


def leaves(params: Dict) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (stem, head, then each block's
    conv1, conv2, scale1, scale2)."""
    out = [params["stem"], params["head"]]
    for b in params["blocks"]:
        out += [b[k] for k in ("conv1", "conv2", "scale1", "scale2")]
    return out


# per block leaf, the dim sharded over "model" (JAX's param_specs:
# conv1 HWIO P(.., "model") is OIHW dim 0, conv2's I is dim 1); the head
# shards its classes (dim 1); the stem and scale2 are replicated
_MODEL_DIM = {"conv1": 0, "conv2": 1, "scale1": 0, "scale2": None}


def param_specs(cfg: ConvBurninConfig) -> Dict:
    """Per leaf, the dim of the port's layout on the mesh's model axis
    (None: replicated); every leaf is replicated over ``data``."""
    return {"stem": None, "head": 1,
            "blocks": [dict(_MODEL_DIM) for _ in range(cfg.n_blocks)]}


def _local(t: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    if dim is None or n == 1:
        return t.clone()
    return t.chunk(n, dim=dim)[i].clone()


def shard_params(params: Dict, mesh, cfg: ConvBurninConfig) -> Dict:
    """This rank's shard of the full tree: each leaf's ``param_specs`` dim
    cut into the model axis's equal parts."""
    n, i = mesh["model"].size(), mesh["model"].get_local_rank()
    specs = param_specs(cfg)
    return {"stem": _local(params["stem"], specs["stem"], n, i),
            "head": _local(params["head"], specs["head"], n, i),
            "blocks": [{k: _local(v, spec[k], n, i) for k, v in b.items()}
                       for b, spec in zip(params["blocks"], specs["blocks"])]}


def full_params(params: Dict, mesh, cfg: ConvBurninConfig) -> Dict:
    """The whole tree from every model rank's shard (``shard_params``'s
    inverse), on every rank; detached."""
    group = multihost.axis_group(mesh, "model")
    specs = param_specs(cfg)

    def whole(t, dim):
        t = t.detach()
        if dim is None or group is None:
            return t.clone()
        n = dist.get_world_size(group)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    return {"stem": whole(params["stem"], specs["stem"]),
            "head": whole(params["head"], specs["head"]),
            "blocks": [{k: whole(v, spec[k]) for k, v in b.items()}
                       for b, spec in zip(params["blocks"], specs["blocks"])]}


# --- model -----------------------------------------------------------------


def _conv(x, w):
    return F.conv2d(x, w, padding=1)


def _norm(x, scale):
    """Channel RMS norm with f32 statistics over the spatial dims (batch
    size independent, no running statistics to shard)."""
    var = x.float().square().mean(dim=(2, 3), keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale[:, None, None]


def forward(params: Dict, images: torch.Tensor, cfg: ConvBurninConfig,
            mesh=None) -> torch.Tensor:
    """images [B, C_in, H, W] (this data rank's rows) -> logits
    [B, n_classes] f32, whole on every model rank. With a mesh,
    ``params`` are this rank's shards (``shard_params``); without one the
    same code runs on one device."""
    group = multihost.axis_group(mesh, "model")
    f = (lambda t: t) if group is None else (lambda t: comm.grad_sum(t, group))
    g = (lambda t: t) if group is None else (
        lambda t: comm.replicate_sum(t, group))
    dt = cfg.dtype
    x = images.to(dt).contiguous(memory_format=torch.channels_last)
    x = _conv(x, params["stem"].to(dt))
    for bp in params["blocks"]:
        h = _conv(f(x), bp["conv1"].to(dt))          # column-parallel out
        h = F.relu(_norm(h, bp["scale1"].to(dt)))
        h = g(_conv(h, bp["conv2"].to(dt)))          # partial sums reduced
        x = F.relu(x + _norm(h, bp["scale2"].to(dt)))
    pooled = x.float().mean(dim=(2, 3))              # [B, width]
    logits = f(pooled) @ params["head"].float()
    return logits if group is None else comm.gather_last(logits, group)


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: ConvBurninConfig, mesh=None) -> torch.Tensor:
    """Mean NLL over this data rank's rows."""
    logp = F.log_softmax(forward(params, batch["images"], cfg, mesh), dim=-1)
    return -torch.gather(logp, -1, batch["labels"][:, None])[:, 0].mean()


# --- training step ---------------------------------------------------------


@dataclass
class ConvTrainState:
    params: Dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(mesh, cfg: ConvBurninConfig,
                    optimizer: Optional[Callable] = None, device=None):
    """Returns (train_step, init_state): ``train_step(state, batch) ->
    (state, loss)`` takes one AdamW step in place and returns the loss
    averaged over the data axis; ``init_state(seed)`` builds the
    parameters (this rank's shards on ``mesh``) and the optimizer.
    ``optimizer`` maps parameters to a torch optimizer (default
    ``burnin.adamw``, optax's). ``mesh=None`` runs on one device,
    ``device`` (default ``cuda:0``)."""
    optimizer = optimizer or adamw(cfg.learning_rate)
    group = multihost.axis_group(mesh, "data")
    dp = 1 if group is None else dist.get_world_size(group)
    dev = multihost.local_device() if mesh is not None else resolve_device(device)

    def init_state(seed: int = 0) -> ConvTrainState:
        params = init_params(cfg, seed, "cpu")
        if mesh is not None:
            params = shard_params(params, mesh, cfg)
        params = to_device(params, dev)
        for p in leaves(params):
            p.requires_grad_(True)
        return ConvTrainState(params, optimizer(leaves(params)))

    def train_step(state: ConvTrainState, batch) -> Tuple[ConvTrainState,
                                                          torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch, cfg, mesh)
        loss.backward()
        if group is not None:
            for p in leaves(state.params):
                dist.all_reduce(p.grad, group=group)
                p.grad.div_(dp)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss /= dp
        return state, loss

    return train_step, init_state


def global_batch(cfg: ConvBurninConfig, seed: int) -> Dict[str, torch.Tensor]:
    """The whole batch, the same on every rank: images [B, C_in, H, W]
    normal, labels uniform over the classes, from a generator seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((cfg.batch, cfg.in_channels, cfg.image_size,
                          cfg.image_size), generator=gen)
    labels = torch.randint(0, cfg.n_classes, (cfg.batch,), generator=gen)
    return {"images": images, "labels": labels}


def make_batch(cfg: ConvBurninConfig, mesh, seed: int,
               device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of ``global_batch(cfg, seed)`` on its device
    (``mesh=None``: the whole batch on ``device``)."""
    dev = multihost.local_device() if mesh is not None else resolve_device(device)
    return {k: multihost.data_rows(v, mesh).to(dev)
            for k, v in global_batch(cfg, seed).items()}


# --- harness ---------------------------------------------------------------


def convburn_rank(rank, world_size, device, cfg: ConvBurninConfig,
                  steps: int, model_parallel: Optional[int] = None
                  ) -> Tuple[float, float]:
    """The conv burn-in on this rank: ``steps`` steps on the training mesh
    of the current process group; returns (first_loss, last_loss)."""
    mesh = multihost.training_mesh(model_parallel=model_parallel)
    step, init_state = make_train_step(mesh, cfg)
    state = init_state(0)
    first = last = None
    for i in range(steps):
        state, loss = step(state, make_batch(cfg, mesh, i))
        last = float(loss)
        first = last if first is None else first
    return first, last


def run(cfg: Optional[ConvBurninConfig] = None, steps: int = 5,
        model_parallel: Optional[int] = None, device=None,
        world_size: Optional[int] = None) -> Tuple[float, float]:
    """Run the conv burn-in; returns (first_loss, last_loss), and the loss
    must fall (the gradients-flowed-through-every-shard proof).

    Spawns ``world_size`` ranks (default: one per visible card, NCCL;
    ``device="cpu"`` runs gloo ranks, one unless asked) that each run
    ``convburn_rank``. A process launched by torchrun (or given the GPU_*
    contract) joins its job's group and runs it in place."""
    return multihost.spawn_or_join(
        convburn_rank, (cfg or ConvBurninConfig(), steps, model_parallel),
        device, world_size)


def main() -> int:
    first, last = run()
    ok = last < first
    print(json.dumps({"workload": "convburn", "first_loss": first,
                      "last_loss": last, "loss_fell": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
