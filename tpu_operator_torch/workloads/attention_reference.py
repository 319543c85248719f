"""Plain attention in float32 with grouped KV heads, a sliding window,
values narrower than keys and attention sinks: the reference that the
port's ``flash_attention`` is held to for models that mix window and full
layers over fewer KV heads than query heads.

The attention core of a decoder layer as transformers writes it
(``repeat_kv`` and ``eager_attention_forward``): K and V repeated so that
query head h reads KV head h // (H // Hkv), dense scores
``Q·Kᵀ·D^-1/2`` with D the width of q and k (v may be narrower, as
MiMo-V2-Flash's 192-wide keys over 128-wide values), the causal mask,
under a window of W keys also the sliding-window mask (the query at
position i sees the keys j with i - W < j <= i, W keys with itself), a
softmax over keys, and ``P·V``. With sinks (one learned logit a query
head, as gpt-oss's eager attention adds it), each row's softmax takes the
head's sink as one more column, which is then dropped: it has no value.
Gradients come from autograd over the same operations. Everything runs in
float32 with TF32 switched off for matrix products and convolutions, since
a float32 product on the card may otherwise run in TF32.

Departures from a published layer such as Trinity-Mini's (``afmoe``) or
MiMo-V2-Flash's: no RoPE, no q/k/v/o projections, no gate on the output,
no q/k norms and no value scale. The inputs are the heads as those would
hand them to the attention core, and the softmax scale is
``head_dim**-0.5``.

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
              causal: bool = True, window: Optional[int] = None,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [B, S, H, DV] in float32 from q [B, S, H, D], k [B, S, Hkv, D]
    and v [B, S, Hkv, DV], H a multiple of Hkv, and ``sinks`` [H] (or
    None); differentiable with respect to float32 inputs."""
    B, S, H, D = q.shape
    hkv = k.shape[2]
    if k.shape[:3] != v.shape[:3] or k.shape[3] != D or H % hkv:
        raise ValueError(f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}: k as wide as q, v over k's "
                         f"heads, H a multiple of Hkv")
    group = H // hkv
    with full_f32():
        qh = q.float().transpose(1, 2)                           # [B, H, S, D]
        kh, vh = (t.float().transpose(1, 2).repeat_interleave(group, dim=1)
                  for t in (k, v))                               # repeat_kv
        s = (qh @ kh.transpose(-1, -2)) * D ** -0.5
        seen = band(S, k.shape[1], causal, window, q.device)
        if seen is not None:
            s = s.masked_fill(~seen, float("-inf"))
        if sinks is None:
            return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2)
        col = sinks.float().reshape(1, H, 1, 1).expand(B, H, S, 1)
        p = torch.softmax(torch.cat([s, col], dim=-1), dim=-1)[..., :-1]
        return (p @ vh).transpose(1, 2)


def forward_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, causal: bool = True,
                     window: Optional[int] = None,
                     sinks: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(out, dq, dk, dv) in float32 for the upstream gradient ``dout``, and
    with ``sinks`` their gradient fifth: the forward above and its
    gradients by autograd, both in full float32; dk and dv have k's and
    v's head count, each summed over its group."""
    xs = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    if sinks is not None:
        xs.append(sinks.detach().float().requires_grad_(True))
    with full_f32(), torch.enable_grad():
        out = attention(*xs[:3], causal=causal, window=window,
                        sinks=xs[3] if sinks is not None else None)
        grads = torch.autograd.grad(out, xs, dout.float())
    return (out.detach(), *grads)
