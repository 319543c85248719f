"""Carry arrays across: numpy (including JAX arrays seen as numpy) to torch.

The JAX package's arrays reach this module as ``np.asarray(x)``. A JAX
bf16 array then has the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` refuses; it goes through a float32 view and back to
``torch.bfloat16``, which is exact (every bf16 value is a float32 value).
The burn-in's parameter tree is carried across whole, into the port's
module and back (``burnin_params_from_jax``, ``burnin_params_to_jax``);
the pipeline's and the MoE's one rank's share at a time (a stage, an
expert), and the conv burn-in's whole, its filters HWIO to OIHW and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .workloads.backend import resolve_device


def to_torch(x, device=None) -> torch.Tensor:
    """A copy of ``x`` (array-like) as a tensor on ``device`` (``None``
    means ``cuda:0``), keeping its dtype; bf16 stays bf16."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a host numpy array; bf16 widens exactly to
    float32. A DTensor is gathered whole first."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    # a copy: a CPU tensor's numpy() shares its memory, which an
    # optimizer step would then change under the caller
    return t.numpy().copy()


# --- burn-in parameters -----------------------------------------------------
#
# Both sides store products as [in, out] (x @ W), so no matrix is
# transposed. Only qkv's columns move: JAX orders them ({q, k, v}, head,
# head_dim), the port (head, {q, k, v}, head_dim), so that a contiguous
# tensor-parallel shard of columns holds whole heads' q, k and v.

_BURNIN_LAYER_KEYS = ("norm1", "qkv", "attn_out", "norm2", "ff_in", "ff_out")


def _qkv_to_port(w: np.ndarray, n_heads: int) -> np.ndarray:
    d = w.shape[0]
    return w.reshape(d, 3, n_heads, -1).transpose(0, 2, 1, 3).reshape(d, -1)


def _qkv_to_jax(w: np.ndarray, n_heads: int) -> np.ndarray:
    d = w.shape[0]
    return w.reshape(d, n_heads, 3, -1).transpose(0, 2, 1, 3).reshape(d, -1)


def burnin_params_from_jax(params: dict, cfg, device=None):
    """A ``burnin.BurninLM`` holding the JAX burn-in's parameters
    (``init_params``'s tree, leaves as numpy arrays) on ``device``
    (``None`` means ``cuda:0``)."""
    from .workloads.burnin import BurninLM

    state = {k: to_torch(params[k], "cpu")
             for k in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(params["layers"]):
        for k in _BURNIN_LAYER_KEYS:
            w = np.asarray(layer[k])
            if k == "qkv":
                w = _qkv_to_port(w, cfg.n_heads)
            state[f"layers.{i}.{k}"] = to_torch(w, "cpu")
    model = BurninLM(cfg)
    model.load_state_dict(state)
    return model.to(resolve_device(device))


def burnin_params_to_jax(model, cfg) -> dict:
    """The port's burn-in parameters as the JAX ``init_params`` tree of
    numpy arrays (DTensors gathered whole)."""
    sd = {k: to_numpy(v) for k, v in model.named_parameters()}
    tree = {k: sd[k] for k in ("embed", "unembed", "final_norm")}
    tree["layers"] = []
    for i in range(cfg.n_layers):
        layer = {k: sd[f"layers.{i}.{k}"] for k in _BURNIN_LAYER_KEYS}
        layer["qkv"] = _qkv_to_jax(layer["qkv"], cfg.n_heads)
        tree["layers"].append(layer)
    return tree


# --- pipeline, MoE and conv parameters --------------------------------------
#
# The pipeline's and the MoE's products are stored [in, out] on both
# sides, so only the stacked leading dim (stage, expert) is cut. The conv
# filters move from JAX's HWIO to torch's OIHW.


def pipeline_params_from_jax(params: dict, stage: int, device=None) -> dict:
    """Stage ``stage``'s weights (``w1``, ``b1``, ``w2``, ``b2``) from the
    JAX pipeline's stacked ``[S, ...]`` tree, as ``stage_fn`` takes them."""
    return {k: to_torch(np.asarray(v)[stage], device)
            for k, v in params.items()}


def moe_params_from_jax(params: dict, expert: int, device=None) -> dict:
    """What rank ``expert`` holds of the JAX MoE's tree: the router and
    that expert's ``w1``/``w2``, as ``moe.moe_forward`` takes them."""
    return {"router": to_torch(params["router"], device),
            "w1": to_torch(np.asarray(params["w1"])[expert], device),
            "w2": to_torch(np.asarray(params["w2"])[expert], device)}


def _hwio_to_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _oihw_to_hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def conv_params_from_jax(params: dict, device=None) -> dict:
    """The JAX conv burn-in's tree (HWIO filters) as the port's (OIHW)."""
    return {"stem": to_torch(_hwio_to_oihw(params["stem"]), device),
            "head": to_torch(params["head"], device),
            "blocks": [{k: to_torch(_hwio_to_oihw(v) if k.startswith("conv")
                                    else v, device)
                        for k, v in b.items()} for b in params["blocks"]]}


def conv_params_to_jax(params: dict) -> dict:
    """The port's conv tree (OIHW) as JAX's (HWIO), leaves numpy."""
    return {"stem": _oihw_to_hwio(to_numpy(params["stem"])),
            "head": to_numpy(params["head"]),
            "blocks": [{k: _oihw_to_hwio(to_numpy(v)) if k.startswith("conv")
                        else to_numpy(v) for k, v in b.items()}
                       for b in params["blocks"]]}
