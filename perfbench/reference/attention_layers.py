"""Plain attention in float32 with grouped KV heads and a sliding window:
the reference that the ``attention_layers`` cells' outputs and gradients
are judged against.

Softmax attention as written, ``softmax(Q·Kᵀ/sqrt(D) + mask)·V``, and its
gradients by the chain rule, in plain PyTorch, as ``attention.py`` has
it, with two more rules: query head h reads KV head h // (H // Hkv)
(transformers' ``repeat_kv``; dK and dV of a KV head sum over its
group), and under a window of W keys the query at i sees the keys j with
i - W < j <= i (transformers' sliding-window causal mask). Each block of
query rows sees all the keys it may see at once, and only those: a window
layer's block reaches back W - 1 keys before its first row, so 32 heads
at 16k fit. Float32 with TF32 switched off for the products.

Layout [B, S, H, D] for q and the upstream gradient, [B, S, Hkv, D] for
k and v, as the port's ``flash_attention`` takes them. Imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .attention import _BLOCK_ELEMS, full_f32


def _rows(s: int, window: Optional[int]) -> int:
    """Query rows a block: its [rows, keys] scores within _BLOCK_ELEMS,
    and under a window no more rows than the window (and 256) so that a
    block's keys stay near its band."""
    rows = max(1, min(s, _BLOCK_ELEMS // max(1, s)))
    return rows if window is None else min(rows, max(window, 256))


def _scores(qh, kh, q0, q1, window, scale):
    """Scores of query rows [q0, q1) against the keys they may see, which
    run from k0; returns (scores, k0, k1)."""
    k0 = 0 if window is None else max(0, q0 - window + 1)
    s = (qh[q0:q1] @ kh[k0:q1].T) * scale
    qpos = torch.arange(q0, q1, device=s.device)[:, None]
    kpos = torch.arange(k0, q1, device=s.device)[None, :]
    seen = kpos <= qpos
    if window is not None:
        seen &= qpos - kpos < window
    s.masked_fill_(~seen, float("-inf"))
    return s, k0, q1


@torch.no_grad()
def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int] = None) -> torch.Tensor:
    """out [B, S, H, D] in float32, causal."""
    B, S, H, D = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    rows = _rows(S, window)
    with full_f32():
        for b in range(B):
            for h in range(H):
                qh = q[b, :, h].float()
                kh, vh = (t[b, :, h // group].float() for t in (k, v))
                for q0 in range(0, S, rows):
                    q1 = min(S, q0 + rows)
                    s, k0, k1 = _scores(qh, kh, q0, q1, window, scale)
                    out[b, q0:q1, h] = torch.softmax(s, dim=-1) @ vh[k0:k1]
    return out


@torch.no_grad()
def forward_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(out, dq, dk, dv) in float32, causal, for the upstream gradient
    ``dout``; dk and dv [B, S, Hkv, D], each KV head's summed over its
    group:

        P = softmax(S), S = Q·Kᵀ·scale (masked)
        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − rowsum(dO ∘ O))
        dQ = dS·K·scale,  dK = dSᵀ·Q·scale
    """
    B, S, H, D = q.shape
    hkv = k.shape[2]
    group = H // hkv
    scale = 1.0 / math.sqrt(D)
    f32 = dict(dtype=torch.float32, device=q.device)
    out, dq = (torch.zeros((B, S, H, D), **f32) for _ in range(2))
    dk, dv = (torch.zeros((B, S, hkv, D), **f32) for _ in range(2))
    rows = _rows(S, window)
    with full_f32():
        for b in range(B):
            for h in range(H):
                qh, gh = (t[b, :, h].float() for t in (q, dout))
                kh, vh = (t[b, :, h // group].float() for t in (k, v))
                for q0 in range(0, S, rows):
                    q1 = min(S, q0 + rows)
                    s, k0, k1 = _scores(qh, kh, q0, q1, window, scale)
                    p = torch.softmax(s, dim=-1)
                    del s
                    o = p @ vh[k0:k1]
                    out[b, q0:q1, h] = o
                    g = gh[q0:q1]
                    dv[b, k0:k1, h // group] += p.T @ g
                    dp = g @ vh[k0:k1].T
                    dp -= (g * o).sum(dim=-1, keepdim=True)
                    dp *= p                                  # dS
                    del p
                    dq[b, q0:q1, h] = (dp @ kh[k0:k1]) * scale
                    dk[b, k0:k1, h // group] += (dp.T @ qh[q0:q1]) * scale
    return out, dq, dk, dv
