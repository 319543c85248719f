"""Plain attention in float32 in MLA's training form: the reference that
the ``attention_mla`` cells' outputs and gradients are judged against.

Multi-head latent attention (DeepSeek-V2/V3, arXiv:2405.04434 §2.1) in
training and prefill expands its latent into per-head keys and values and
runs ordinary causal attention. Head h's key is its own ``k_nope`` (128
wide in DeepSeek-V3) with one rope key ``k_pe`` (64 wide) that every head
shares appended, so queries and keys are 192 wide and values 128:

    k_h = [k_nope_h ; k_pe],  S_h = Q_h·k_hᵀ·scale (causal),
    P_h = softmax(S_h),  out_h = P_h·V_h

with the caller's ``scale`` (DeepSeek's rule: 192**-0.5 times YaRN's
mscale squared). The gradients by the chain rule, written out by hand as
``attention_layers.forward_backward`` has them:

    dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − rowsum(dO ∘ O))
    dQ = dS·K·scale,  dK = dSᵀ·Q·scale

and, since k_pe enters every head's key, its gradient is the sum over the
heads of the rope columns of dK; dk_nope is the other columns.

Each block of query rows, all heads at once, sees all the keys it may
see at once, and only those: a block's scores stay within
``attention._BLOCK_ELEMS`` float32 elements, so 128 heads at 16k fit.
Float32 with TF32 switched off for the products.

Layout [B, S, H, D] for q, [B, S, H, DN] for k_nope, [B, S, 1, DR] for
k_pe, [B, S, H, DV] for v and the upstream gradient, as the
``attention_mla`` generator draws them. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import attention
from .attention import full_f32


def _rows(s: int, heads: int) -> int:
    """Query rows a block: its [heads, rows, keys] scores within
    ``attention._BLOCK_ELEMS``."""
    return max(1, min(s, attention._BLOCK_ELEMS // max(1, heads * s)))


@torch.no_grad()
def forward_backward(q: torch.Tensor, k_nope: torch.Tensor,
                     k_pe: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, scale: float
                     ) -> Tuple[torch.Tensor, ...]:
    """(out, dq, dk_nope, dk_pe, dv) in float32, causal, for the upstream
    gradient ``dout``: out [B, S, H, DV], dq [B, S, H, D], dk_nope
    [B, S, H, DN], dk_pe [B, S, 1, DR] (summed over the heads), dv
    [B, S, H, DV]."""
    B, S, H, D = q.shape
    dn, dr, dvw = k_nope.shape[3], k_pe.shape[3], v.shape[3]
    if dn + dr != D or k_pe.shape[2] != 1:
        raise ValueError(f"MLA: q's width {D} must be k_nope's {dn} and "
                         f"one shared k_pe's {dr}, got k_pe "
                         f"{tuple(k_pe.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, S, H, dvw), **f32)
    dq = torch.empty((B, S, H, D), **f32)
    dk_nope = torch.empty((B, S, H, dn), **f32)
    dk_pe = torch.empty((B, S, 1, dr), **f32)
    dv = torch.empty((B, S, H, dvw), **f32)
    rows = _rows(S, H)
    with full_f32():
        for b in range(B):
            # [H, S, D]: each head's key, the shared rope key appended
            kh = torch.cat([k_nope[b].float(),
                            k_pe[b].float().expand(S, H, dr)],
                           dim=-1).transpose(0, 1).contiguous()
            vh = v[b].float().transpose(0, 1).contiguous()    # [H, S, DV]
            dkh = torch.zeros((H, S, D), **f32)
            dvh = torch.zeros((H, S, dvw), **f32)
            for q0 in range(0, S, rows):
                q1 = min(S, q0 + rows)
                qh = q[b, q0:q1].float().transpose(0, 1)       # [H, n, D]
                gh = dout[b, q0:q1].float().transpose(0, 1)    # [H, n, DV]
                s = (qh @ kh[:, :q1].transpose(1, 2)) * scale  # [H, n, q1]
                qpos = torch.arange(q0, q1, device=q.device)[:, None]
                kpos = torch.arange(q1, device=q.device)[None, :]
                s.masked_fill_(kpos > qpos, float("-inf"))
                p = torch.softmax(s, dim=-1)
                del s
                o = p @ vh[:, :q1]
                out[b, q0:q1] = o.transpose(0, 1)
                dvh[:, :q1] += p.transpose(1, 2) @ gh
                dp = gh @ vh[:, :q1].transpose(1, 2)
                dp -= (gh * o).sum(dim=-1, keepdim=True)
                dp *= p                                        # dS
                del p, o
                dq[b, q0:q1] = ((dp @ kh[:, :q1]) * scale).transpose(0, 1)
                dkh[:, :q1] += (dp.transpose(1, 2) @ qh) * scale
                del dp
            dk = dkh.transpose(0, 1)                           # [S, H, D]
            dk_nope[b] = dk[..., :dn]
            dk_pe[b, :, 0] = dk[..., dn:].sum(dim=1)
            dv[b] = dvh.transpose(0, 1)
            del kh, vh, dkh, dvh, dk
    return out, dq, dk_nope, dk_pe, dv
