"""Per-rank body of tests/test_torch_ringattention.py, in a module of its
own that imports no JAX, so the spawned gloo ranks start quickly."""

import numpy as np
import torch

from tpu_operator_torch.workloads import ringattention as ra

WORLD = 4

def qkv(seq=64, heads=4, dim=8, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, seq, heads, dim)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for _ in range(3))


# name -> (inputs, strategy, causal, use_flash)
CASES = {
    "ring_causal": (qkv(), "ring", True, False),
    "ring_full": (qkv(), "ring", False, False),
    "ring_flash": (qkv(), "ring", True, True),
    "ring_3_heads": (qkv(heads=3), "ring", True, False),
    "ulysses_causal": (qkv(), "ulysses", True, False),
    "ulysses_full": (qkv(), "ulysses", False, False),
}
GRAD_INPUTS = qkv(seq=64, heads=4, dim=8, batch=1, seed=1)


def _shard(x, rank, n):
    s = x.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(x[:, rank * s:(rank + 1) * s]))


def rank_cases(rank, world_size, device):
    """Every case on this rank; returns its shards and the errors."""
    fns = {"ring": ra.ring_attention, "ulysses": ra.ulysses_attention}
    res = {}
    for name, (inputs, strategy, causal, use_flash) in CASES.items():
        q, k, v = (_shard(x, rank, world_size) for x in inputs)
        kw = dict(use_flash=True) if use_flash else {}
        res[name] = fns[strategy](q, k, v, causal=causal, **kw).numpy()
    try:
        ra.ulysses_attention(*(_shard(x, rank, world_size)
                               for x in qkv(heads=3)))
        res["ulysses_3_heads"] = None
    except ValueError as e:
        res["ulysses_3_heads"] = str(e)
    for strategy in ("ring", "ulysses"):
        ts = [_shard(x, rank, world_size).requires_grad_() for x in GRAD_INPUTS]
        (fns[strategy](*ts) ** 2).sum().backward()
        res[f"{strategy}_grads"] = [t.grad.numpy() for t in ts]
    ts = [_shard(x, rank, world_size).requires_grad_() for x in GRAD_INPUTS]
    try:
        ra.ring_attention(*ts, use_flash=True).sum().backward()
        res["flash_backward"] = None
    except RuntimeError as e:
        res["flash_backward"] = str(e)
    # the per-rank body of run(), both strategies
    res["run_body"] = [r.result for r in ra.context_parallel_rank(
        rank, world_size, device,
        [dict(strategy=s, seq_len=64, n_heads=4, head_dim=8, batch=2)
         for s in ("ring", "ulysses")])]
    return res
