"""Plain attention in float32 with grouped KV heads and a sliding window:
the reference that the port's ``flash_attention`` is held to for models
that mix window and full layers over fewer KV heads than query heads.

The attention core of a decoder layer as transformers writes it
(``repeat_kv`` and ``eager_attention_forward``): K and V repeated so that
query head h reads KV head h // (H // Hkv), dense scores
``Q·Kᵀ·D^-1/2``, the causal mask, under a window of W keys also the
sliding-window mask (the query at position i sees the keys j with
i - W < j <= i, W keys with itself), a softmax over keys, and ``P·V``.
Gradients come from autograd over the same operations. Everything runs in
float32 with TF32 switched off for matrix products and convolutions, since
a float32 product on the card may otherwise run in TF32.

Departures from a published layer such as Trinity-Mini's (``afmoe``): no
RoPE, no q/k/v/o projections, no gate on the output and no q/k norms. The
inputs are the heads as those would hand them to the attention core, and
the softmax scale is ``head_dim**-0.5``.

Imports nothing but ``torch``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch


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


def band(sq: int, sk: int, causal: bool = True, window: Optional[int] = None,
         device=None) -> Optional[torch.Tensor]:
    """[sq, sk] bool, True where query i sees key j: j <= i under the
    causal mask, and i - window < j as well under a window; None where
    every pair is seen."""
    if window is not None and not causal:
        raise ValueError("a window needs the causal mask")
    if not causal:
        return None
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    seen = j <= i
    return seen if window is None else seen & (i - j < window)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """out [B, S, H, D] in float32 from q [B, S, H, D] and k, v [B, S, Hkv,
    D], H a multiple of Hkv; differentiable with respect to float32
    inputs."""
    B, S, H, D = q.shape
    hkv = k.shape[2]
    if k.shape != v.shape or H % hkv:
        raise ValueError(f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}: H must be a multiple of Hkv")
    group = H // hkv
    with full_f32():
        qh = q.float().transpose(1, 2)                           # [B, H, S, D]
        kh, vh = (t.float().transpose(1, 2).repeat_interleave(group, dim=1)
                  for t in (k, v))                               # repeat_kv
        s = (qh @ kh.transpose(-1, -2)) * D ** -0.5
        seen = band(S, k.shape[1], causal, window, q.device)
        if seen is not None:
            s = s.masked_fill(~seen, float("-inf"))
        return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2)


def forward_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, causal: bool = True,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(out, dq, dk, dv) in float32 for the upstream gradient ``dout``: the
    forward above and its gradients by autograd, both in full float32;
    dk and dv have k's and v's head count, each summed over its group."""
    xs = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    with full_f32(), torch.enable_grad():
        out = attention(*xs, causal=causal, window=window)
        grads = torch.autograd.grad(out, xs, dout.float())
    return (out.detach(), *grads)
