"""Plain attention in float32: the reference that the attention cells'
outputs and gradients are judged against.

Softmax attention as written, ``softmax(Q·Kᵀ/sqrt(D) + causal mask)·V``,
and its gradients by the chain rule, in plain PyTorch. No online softmax,
no tiling of keys: each block of query rows sees all the keys it may see
at once, and the blocks only bound the memory of the [rows, keys] score
matrix. Float32 with TF32 switched off for the products, since a float32
product on the card may otherwise run in TF32.

Layout [B, S, H, D] in and out, as the port's ``flash_attention``.
Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch

# the score block's f32 elements: 2**28 is 1 GiB
_BLOCK_ELEMS = 1 << 28


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Float32 products in float32, not TF32, restored afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _rows(s: int) -> int:
    return max(1, min(s, _BLOCK_ELEMS // max(1, s)))


def _scores(qh, kh, q0, q1, causal, scale):
    """Scores of query rows [q0, q1) against the keys they may see, and
    the number of those keys."""
    nk = q1 if causal else kh.shape[0]
    s = (qh[q0:q1] @ kh[:nk].T) * scale
    if causal:
        qpos = torch.arange(q0, q1, device=s.device)[:, None]
        kpos = torch.arange(nk, device=s.device)[None, :]
        s.masked_fill_(kpos > qpos, float("-inf"))
    return s, nk


@torch.no_grad()
def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True) -> torch.Tensor:
    """out [B, S, H, D] in float32."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    rows = _rows(S)
    with full_f32():
        for b in range(B):
            for h in range(H):
                qh, kh, vh = (t[b, :, h].float() for t in (q, k, v))
                for q0 in range(0, S, rows):
                    q1 = min(S, q0 + rows)
                    s, nk = _scores(qh, kh, q0, q1, causal, scale)
                    p = torch.softmax(s, dim=-1)
                    out[b, q0:q1, h] = p @ vh[:nk]
    return out


@torch.no_grad()
def forward_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, causal: bool = True
                     ) -> Tuple[torch.Tensor, ...]:
    """(out, dq, dk, dv), each [B, S, H, D] in float32, for the upstream
    gradient ``dout``:

        P = softmax(S), S = Q·Kᵀ·scale (masked)
        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − rowsum(dO ∘ O))
        dQ = dS·K·scale,  dK = dSᵀ·Q·scale
    """
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    f32 = dict(dtype=torch.float32, device=q.device)
    out, dq, dk, dv = (torch.zeros((B, S, H, D), **f32) for _ in range(4))
    rows = _rows(S)
    with full_f32():
        for b in range(B):
            for h in range(H):
                qh, kh, vh, gh = (t[b, :, h].float()
                                  for t in (q, k, v, dout))
                for q0 in range(0, S, rows):
                    q1 = min(S, q0 + rows)
                    s, nk = _scores(qh, kh, q0, q1, causal, scale)
                    p = torch.softmax(s, dim=-1)
                    del s
                    o = p @ vh[:nk]
                    out[b, q0:q1, h] = o
                    g = gh[q0:q1]
                    dv[b, :nk, h] += p.T @ g
                    dp = g @ vh[:nk].T
                    dp -= (g * o).sum(dim=-1, keepdim=True)
                    dp *= p                                  # dS
                    del p
                    dq[b, q0:q1, h] = (dp @ kh[:nk]) * scale
                    dk[b, :nk, h] += (dp.T @ qh[q0:q1]) * scale
    return out, dq, dk, dv


def fp8(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` rounded to float8 e4m3 and back to float32: the control's
    inputs, one precision below the bfloat16 that the configuration
    states. Unit-scale inputs need no scaling (e4m3 holds up to 448)."""
    return None if t is None else t.to(torch.float8_e4m3fn).float()
