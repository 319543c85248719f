"""Plain attention in float32 with values narrower than keys, grouped KV
heads, a sliding window and attention sinks: the reference that the
``attention_period`` cells' outputs are judged against.

Softmax attention as written, ``softmax(Q·Kᵀ/sqrt(D) + mask)·V``, in
plain PyTorch, as ``attention_layers.py`` has it, with two more rules: q
and k are D wide and v DV wide, the scale D**-0.5 (out is DV wide); and
with sinks (one learned logit a query head) each row's softmax takes its
head's sink as one more column, which is then dropped, since it has no
value (transformers' gpt-oss eager attention). Query head h reads KV head
h // (H // Hkv) (transformers' ``repeat_kv``, here by batching each KV
head's group of query heads against it, not by repeating K and V), and
under a window of W keys the query at i sees the keys j with
i - W < j <= i. Each block of query rows, all heads at once, sees all the
keys it may see at once, and only those: a block's scores stay within
``attention._BLOCK_ELEMS`` float32 elements, so 64 heads at 64k fit.
Float32 with TF32 switched off for the products.

Layout [B, S, H, D] for q, [B, S, Hkv, D] for k, [B, S, Hkv, DV] for v,
as the port's ``flash_attention`` takes them. Imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import attention
from .attention import full_f32


def _rows(s: int, heads: int, window: Optional[int]) -> int:
    """Query rows a block: its [heads, rows, keys] scores within
    ``attention._BLOCK_ELEMS``, and under a window no more rows than the
    window (and 256), so that a block's keys stay near its band."""
    rows = max(1, min(s, attention._BLOCK_ELEMS // max(1, heads * s)))
    return rows if window is None else min(rows, max(window, 256))


@torch.no_grad()
def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int] = None,
            sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [B, S, H, DV] in float32, causal; ``sinks`` [H] or None."""
    B, S, H, D = q.shape
    hkv, dv = v.shape[2], v.shape[3]
    group = H // hkv
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, dv), dtype=torch.float32, device=q.device)
    rows = _rows(S, H, window)
    with full_f32():
        for b in range(B):
            # [Hkv, S, D] and [Hkv, S, DV]: each KV head once
            kh, vh = (t[b].float().transpose(0, 1).contiguous()
                      for t in (k, v))
            for q0 in range(0, S, rows):
                q1 = min(S, q0 + rows)
                k0 = 0 if window is None else max(0, q0 - window + 1)
                n = q1 - q0
                # [Hkv, group * n, D]: a KV head's group of query heads
                qh = q[b, q0:q1].float().transpose(0, 1).reshape(
                    hkv, group * n, D)
                s = (qh @ kh[:, k0:q1].transpose(1, 2)) * scale
                s = s.reshape(hkv, group, n, q1 - k0)
                qpos = torch.arange(q0, q1, device=q.device)[:, None]
                kpos = torch.arange(k0, q1, device=q.device)[None, :]
                seen = kpos <= qpos
                if window is not None:
                    seen &= qpos - kpos < window
                s.masked_fill_(~seen, float("-inf"))
                if sinks is None:
                    p = torch.softmax(s, dim=-1)
                else:
                    col = sinks.float().reshape(hkv, group, 1, 1).expand(
                        hkv, group, n, 1)
                    p = torch.softmax(torch.cat([s, col], dim=-1),
                                      dim=-1)[..., :-1]
                del s
                o = p.reshape(hkv, group * n, q1 - k0) @ vh[:, k0:q1]
                del p
                out[b, q0:q1] = o.reshape(H, n, dv).transpose(0, 1)
    return out
