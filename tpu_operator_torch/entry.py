"""The forward entry point: the burn-in model's forward on one card.

Counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``
(the flagship workload's forward, single chip). The multi-card dry run
is ``dryrun.dryrun_multichip``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .workloads.burnin import BurninConfig, BurninLM, forward, init_params

# the reference's entry configuration (bf16, the burn-in's dtype)
CONFIG = BurninConfig(vocab=256, d_model=128, n_heads=4, n_layers=2,
                      d_ff=512, seq_len=64, batch=4)


def entry(device=None) -> Tuple[Callable, Tuple[BurninLM, torch.Tensor]]:
    """``(fn, (model, tokens))`` with ``fn(model, tokens)`` the logits
    [batch, seq_len, vocab] f32: the model drawn from seed 0, the tokens
    int64 zeros. ``device``: ``None`` means ``cuda:0`` (raising where
    there is no card); ``"cpu"`` runs on the CPU. Where JAX's entry
    holds the parameter tree, this one holds the module."""
    model = init_params(CONFIG, 0, device)
    tokens = torch.zeros((CONFIG.batch, CONFIG.seq_len), dtype=torch.int64,
                         device=model.embed.device)
    return forward, (model, tokens)
