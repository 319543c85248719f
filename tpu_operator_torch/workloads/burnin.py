"""Sharded burn-in training step — the fleet-exercise workload.

Counterpart of ``tpu_operator/workloads/burnin.py``: a small transformer
LM trained for a few steps exercises every subsystem the operator
certifies at once: tensor cores (products), HBM (activations and
optimizer state) and the interconnect (data-parallel gradient reduction
and tensor-parallel activation collectives).

Sharding runs over a [data, model] ``DeviceMesh``, one rank per card:

- **Tensor parallelism** through DTensor on the mesh's model axis, in
  Megatron's layout: column-parallel first product (``qkv``, ``ff_in``,
  heads and d_ff sharded), row-parallel second (``attn_out``,
  ``ff_out``), whose partial sums are reduced once per block.
- **Sequence parallelism**: the residual stream and the norms run with
  the sequence sharded over the model axis (``Shard(1)``); the sequence
  is gathered before each column-parallel product, and each row-parallel
  product's partial sums are reduce-scattered back onto it.
- **Data parallelism**: each data rank takes its share of the batch; the
  gradients are averaged over the data axis (an all-reduce, or FSDP2's
  reduce-scatter with ``fsdp=True``).
- **FSDP** (``fsdp=True``): FSDP2 ``fully_shard`` over the data axis,
  composed with TP, so parameters and AdamW moments are sharded over
  both axes, in the JAX package's placements (``param_specs``).

Parameters keep the JAX layout (``x @ W``, W stored [in, out]) and f32;
the forward casts them to ``cfg.dtype``, rounding where the JAX forward
rounds. One difference: ``qkv``'s 3·d_model columns are grouped head by
head (head, {q, k, v}, head_dim) where JAX's are ({q, k, v}, head,
head_dim), so a contiguous model shard holds its own heads' q, k and v;
``convert.burnin_params_from_jax`` permutes them.

``run`` spawns one rank per card (NCCL) or on the CPU (gloo) and runs
``burnin_rank`` there; under torchrun it joins the job's process group
and runs it in place.
"""

from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..parallel import multihost
from .backend import resolve_device

# where the mask puts a future key: JAX's where(causal, scores, -1e9) in
# bf16 rounds it to -998244352, and so does torch's where
MASK_VALUE = -1e9


@dataclass(frozen=True)
class BurninConfig:
    vocab: int = 512
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 64
    batch: int = 8
    learning_rate: float = 1e-3
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# --- model -----------------------------------------------------------------


def _place(x, placement):
    """``x`` redistributed to ``placement`` on its (model) mesh; a plain
    tensor (no mesh) as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(placements=[placement])
    return x


def _rmsnorm(x, w):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * w


def _attention(qkv, cfg: BurninConfig, scale: float):
    """Causal attention over this rank's heads. ``qkv``: [B, S, 3·D/mp]
    in the port's head-grouped layout (a DTensor sharded on its last dim
    under TP). Heads are independent, so it runs on the local shard."""
    local = qkv.to_local() if isinstance(qkv, DTensor) else qkv
    B, S, C = local.shape
    hd = cfg.head_dim
    heads = C // (3 * hd)
    q, k, v = local.view(B, S, heads, 3, hd).unbind(dim=3)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    causal = torch.ones((S, S), dtype=torch.bool, device=local.device).tril()
    scores = torch.where(causal, scores, MASK_VALUE)
    probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, heads * hd)
    if isinstance(qkv, DTensor):
        return DTensor.from_local(attn, qkv.device_mesh, [Shard(2)])
    return attn


class Block(nn.Module):
    def __init__(self, cfg: BurninConfig):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        # JAX divides the scores by sqrt(head_dim) taken in the working
        # dtype: in bf16 that is 5.65625 for 32, not 5.6569
        self.scale = torch.tensor(float(cfg.head_dim),
                                  dtype=cfg.dtype).sqrt().item()
        self.norm1 = nn.Parameter(torch.ones(d))
        self.qkv = nn.Parameter(torch.empty(d, 3 * d))
        self.attn_out = nn.Parameter(torch.empty(d, d))
        self.norm2 = nn.Parameter(torch.ones(d))
        self.ff_in = nn.Parameter(torch.empty(d, f))
        self.ff_out = nn.Parameter(torch.empty(f, d))

    def forward(self, x):
        dt = self.cfg.dtype
        # sequence-parallel section: the norm runs on this rank's share of
        # the sequence (no tensor dim is sharded here)
        h = _rmsnorm(x, self.norm1.to(dt))
        h = _place(h, Replicate())
        attn = _attention(h @ self.qkv.to(dt), self.cfg, self.scale)
        x = x + _place(attn @ self.attn_out.to(dt), Shard(1))
        h = _rmsnorm(x, self.norm2.to(dt))
        h = _place(h, Replicate())
        ff = F.gelu(h @ self.ff_in.to(dt), approximate="tanh")
        return x + _place(ff @ self.ff_out.to(dt), Shard(1))


class BurninLM(nn.Module):
    """The burn-in transformer; parameter names are the JAX tree's
    (``embed``, ``unembed``, ``final_norm``, ``layers.<i>.<name>``)."""

    def __init__(self, cfg: BurninConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.unembed = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))

    def forward(self, tokens):
        """tokens [B, S] int64 (this data rank's rows) -> logits
        [B, S, vocab] f32, whole on every model rank."""
        dt = self.cfg.dtype
        if isinstance(self.embed, DTensor):
            tokens = DTensor.from_local(tokens, self.embed.device_mesh,
                                        [Replicate()])
        # the gather reads the embedding after its cast, as JAX's does
        x = _place(F.embedding(tokens, self.embed.to(dt)), Shard(1))
        for layer in self.layers:
            x = layer(x)
        x = _rmsnorm(x, self.final_norm.to(dt))
        logits = _place(_place(x, Replicate()) @ self.unembed.to(dt),
                        Replicate())
        if isinstance(logits, DTensor):
            logits = logits.to_local()
        return logits.float()


def init_params(cfg: BurninConfig, seed: int = 0,
                device=None) -> BurninLM:
    """The model, f32, on ``device`` (``None`` means ``cuda:0``), drawn
    from its own ``torch.Generator`` in the JAX init's order and scales
    (normal·0.02 for the embedding, normal / sqrt(fan_in) for the
    products, ones for the norms). The draws differ from JAX's
    ``PRNGKey``; tests carry JAX's parameters across through
    ``convert.burnin_params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    model = BurninLM(cfg)

    def normal(p, scale):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * scale)

    normal(model.embed, 0.02)
    normal(model.unembed, 1.0 / math.sqrt(cfg.d_model))
    for layer in model.layers:
        normal(layer.qkv, 1.0 / math.sqrt(cfg.d_model))
        normal(layer.attn_out, 1.0 / math.sqrt(cfg.d_model))
        normal(layer.ff_in, 1.0 / math.sqrt(cfg.d_model))
        normal(layer.ff_out, 1.0 / math.sqrt(cfg.d_ff))
    return model.to(resolve_device(device))


# --- placements -------------------------------------------------------------


# per parameter: the dim the JAX layout maps to "model" (None: none) and
# the dim ``fsdp=True`` maps to "data"
_LAYOUT = {
    "embed": (1, 0), "unembed": (0, 1), "final_norm": (None, 0),
    "norm1": (None, 0), "qkv": (1, 0), "attn_out": (0, 1),
    "norm2": (None, 0), "ff_in": (1, 0), "ff_out": (0, 1),
}


def param_specs(cfg: BurninConfig, fsdp: bool = False) -> Dict[str, tuple]:
    """Per parameter name, its DTensor placements over ("data", "model"):
    Megatron's tensor-parallel layout (column-parallel first product,
    row-parallel second). ``fsdp=True`` also shards each parameter's
    other dim over ``data`` — JAX's ``P(d, "model")`` / ``P("model", d)``.
    """
    names = ["embed", "unembed", "final_norm"] + [
        f"layers.{i}.{n}" for i in range(cfg.n_layers)
        for n in ("norm1", "qkv", "attn_out", "norm2", "ff_in", "ff_out")]
    specs = {}
    for name in names:
        model_dim, data_dim = _LAYOUT[name.rsplit(".", 1)[-1]]
        specs[name] = (
            Shard(data_dim) if fsdp else Replicate(),
            Replicate() if model_dim is None else Shard(model_dim))
    return specs


def shard_params(model: BurninLM, mesh, cfg: BurninConfig,
                 fsdp: bool = False) -> BurninLM:
    """Place ``model``'s parameters on ``mesh`` (moved to this rank's
    device): DTensors over the model axis, and with ``fsdp`` FSDP2's
    ``fully_shard`` over the data axis, one unit per block and one for
    the rest, each parameter sharded on its ``param_specs`` dim."""
    specs = param_specs(cfg, fsdp=fsdp)
    tp = mesh["model"]
    model = model.to(multihost.local_device())
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        placed = distribute_tensor(p.detach(), tp, [specs[name][1]])
        owner.register_parameter(leaf, nn.Parameter(placed))
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        names = {id(p): n for n, p in model.named_parameters()}
        data_placement = lambda p: specs[names[id(p)]][0]
        for layer in model.layers:
            fully_shard(layer, mesh=mesh["data"],
                        shard_placement_fn=data_placement)
        fully_shard(model, mesh=mesh["data"],
                    shard_placement_fn=data_placement)
    return model


def forward(model: BurninLM, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] f32. With a mesh the model's
    parameters carry it (``shard_params``) and ``tokens`` are this data
    rank's rows; without one the same code runs on one device."""
    return model(tokens)


def loss_fn(model: BurninLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token NLL over this data rank's rows."""
    logp = F.log_softmax(forward(model, batch["tokens"]), dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"][..., None])[..., 0]
    return nll.mean()


# --- training step ---------------------------------------------------------


def adamw(learning_rate: float) -> Callable:
    """optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8 and a weight
    decay of 1e-4 on every parameter, norms too (torch's default decay
    is 0.01)."""
    return lambda params: torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4)


class TrainState:
    """Model, optimizer and step count; a ``torch.distributed.checkpoint``
    Stateful, whose state dict (``get_state_dict``) is keyed by parameter
    name whatever the placements, so a checkpoint restores into another
    layout."""

    def __init__(self, model: BurninLM, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> dict:
        from torch.distributed.checkpoint.state_dict import get_state_dict

        model_sd, optim_sd = get_state_dict(self.model, self.optimizer)
        return {"model": model_sd, "optim": optim_sd,
                "step": torch.tensor(self.step, dtype=torch.int64)}

    def load_state_dict(self, state: dict) -> None:
        from torch.distributed.checkpoint.state_dict import set_state_dict

        set_state_dict(self.model, self.optimizer,
                       model_state_dict=state["model"],
                       optim_state_dict=state["optim"])
        self.step = int(state["step"])


def make_train_step(mesh, cfg: BurninConfig, optimizer: Optional[Callable] = None,
                    fsdp: bool = False, device=None):
    """Returns (step_fn, init_state, shard_batch): ``step_fn(state,
    batch) -> (state, loss)`` takes one AdamW step in place and returns
    the loss averaged over the data axis; ``init_state(seed)`` builds a
    ``TrainState`` placed on ``mesh`` (``fsdp=True``: FSDP2 over data,
    see ``param_specs``); ``shard_batch`` takes this rank's rows of a
    global batch. ``optimizer`` maps parameters to a torch optimizer
    (default ``adamw(cfg.learning_rate)``). ``mesh=None`` runs on one
    device, ``device`` (default ``cuda:0``)."""
    optimizer = optimizer or adamw(cfg.learning_rate)
    group = multihost.axis_group(mesh, "data")
    dp = 1 if group is None else dist.get_world_size(group)
    dev = multihost.local_device() if mesh is not None else resolve_device(device)

    def init_state(seed: int = 0) -> TrainState:
        model = init_params(cfg, seed, dev)
        if mesh is not None:
            model = shard_params(model, mesh, cfg, fsdp=fsdp)
        return TrainState(model, optimizer(model.parameters()))

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch)
        loss.backward()
        if mesh is not None and not fsdp:
            for p in state.model.parameters():
                grad = p.grad
                # a replicated norm's gradient comes back as partial sums
                # over the sequence shards
                if grad.placements != p.placements:
                    grad = p.grad = grad.redistribute(placements=p.placements)
                if group is not None:
                    dist.all_reduce(grad.to_local(), group=group)
                    grad.to_local().div_(dp)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss /= dp
        return state, loss

    def shard_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: multihost.data_rows(v, mesh).to(dev)
                for k, v in batch.items()}

    return train_step, init_state, shard_batch


def global_batch(cfg: BurninConfig, seed: int) -> Dict[str, torch.Tensor]:
    """The whole [batch, seq_len] batch, the same on every rank: tokens
    from a generator seeded with ``seed``, targets the next token."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                           generator=gen)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def make_batch(cfg: BurninConfig, mesh, seed: int,
               device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of ``global_batch(cfg, seed)``, on its device
    (``mesh=None``: the whole batch on ``device``)."""
    dev = multihost.local_device() if mesh is not None else resolve_device(device)
    return {k: multihost.data_rows(v, mesh).to(dev)
            for k, v in global_batch(cfg, seed).items()}


def eval_loss(model: BurninLM, batch, mesh) -> torch.Tensor:
    """The loss without a step, averaged over the data axis."""
    with torch.no_grad():
        loss = loss_fn(model, batch)
    group = multihost.axis_group(mesh, "data")
    if group is not None:
        dist.all_reduce(loss, group=group)
        loss /= dist.get_world_size(group)
    return loss


# --- harness ---------------------------------------------------------------


def burnin_rank(rank, world_size, device, cfg: BurninConfig, steps: int,
                model_parallel: Optional[int] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 0) -> Tuple[float, float]:
    """The burn-in on this rank: ``steps`` steps on the training mesh of
    the current process group (one device when there is none); returns
    (first_loss, last_loss). The loss must fall — that is the proof that
    gradients flowed through every shard.

    With ``checkpoint_dir`` the run is preemption-safe: it resumes from
    the latest checkpoint found there and (with ``checkpoint_every`` > 0)
    saves the sharded train state on that cadence."""
    mesh = (multihost.training_mesh(model_parallel=model_parallel)
            if dist.is_initialized() else None)
    step, init_state, _ = make_train_step(mesh, cfg, device=device)
    state = init_state(0)
    ckpt = None
    start = 0
    first = last = None
    meta_path = None
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if checkpoint_dir:
        from .checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(checkpoint_dir)
        # the run's FIRST loss lives in a sidecar, so the loss-must-fall
        # proof spans the whole run across preemptions, not just the tail
        meta_path = pathlib.Path(checkpoint_dir) / "run-meta.json"
        if ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            start = state.step
            if meta_path.exists():
                first = json.loads(meta_path.read_text()).get("first_loss")
    try:
        if start >= steps:
            # checkpoint already at/past the target: nothing to train,
            # report the current loss so the (first, last) contract holds
            batch = make_batch(cfg, mesh, steps - 1, device)
            last = float(eval_loss(state.model, batch, mesh))
            first = last if first is None else first
            return first, last
        for i in range(start, steps):
            state, loss = step(state, make_batch(cfg, mesh, i, device))
            loss = float(loss)
            if first is None:
                first = loss
                if meta_path is not None and start == 0 and writer:
                    meta_path.parent.mkdir(parents=True, exist_ok=True)
                    meta_path.write_text(json.dumps({"first_loss": first}))
            last = loss
            if ckpt and checkpoint_every and (i + 1) % checkpoint_every == 0:
                ckpt.save(state, i + 1)
    finally:
        if ckpt:
            ckpt.close()
    return first, last


def run(cfg: Optional[BurninConfig] = None, steps: int = 5,
        model_parallel: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0, device=None,
        world_size: Optional[int] = None) -> Tuple[float, float]:
    """Run the burn-in; returns (first_loss, last_loss).

    Spawns ``world_size`` ranks (default: one per visible card, NCCL;
    ``device="cpu"`` runs gloo ranks, one unless asked) that each run
    ``burnin_rank``. A process launched by torchrun (or given the GPU_*
    contract) joins its job's group through ``multihost.initialize`` and
    runs ``burnin_rank`` in place."""
    cfg = cfg or BurninConfig()
    args = (cfg, steps, model_parallel, checkpoint_dir, checkpoint_every)
    return multihost.spawn_or_join(burnin_rank, args, device, world_size)


def main() -> int:
    first, last = run()
    ok = last < first
    devices = (dist.get_world_size() if dist.is_initialized()
               else torch.cuda.device_count())
    print(json.dumps({"first_loss": first, "last_loss": last,
                      "improved": ok, "devices": devices}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
