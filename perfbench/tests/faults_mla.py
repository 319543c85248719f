"""Faults planted under the ``attention_mla`` cell's timed path, for
``test_bench_mla.py``: each replaces the port's ``flash_attention`` with a
broken copy that takes the ``scale`` keyword, in the process that calls
it. The key the broken copy receives is the generator's assembled one,
k = [k_nope ; k_pe expanded over the heads]."""

from __future__ import annotations

import torch


def _patch(broken):
    from tpu_operator_torch.workloads import flashattention as fa

    good = fa.flash_attention
    fa.flash_attention = lambda q, k, v, causal=True, window=None, \
        sinks=None, scale=None: broken(good, q, k, v, causal, scale)


def default_scale():
    """The softmax scale is the default D**-0.5, not YaRN's."""
    _patch(lambda good, q, k, v, causal, scale: good(q, k, v, causal))


def k_pe_not_shared():
    """The rope key reaches head 0 alone: the other heads' keys hold
    zeros in its columns, as a broadcast that copies once would leave
    them."""
    def broken(good, q, k, v, causal, scale):
        dn = v.shape[3]  # k_nope's width, as v's in DeepSeek-V3
        rest = torch.cat([k[:, :, 1:, :dn],
                          torch.zeros_like(k[:, :, 1:, dn:])], dim=-1)
        return good(q, torch.cat([k[:, :, :1], rest], dim=2), v, causal,
                    scale=scale)
    _patch(broken)


class _MeanOverHeads(torch.autograd.Function):
    """Identity forward; the backward divides the rope columns' gradient
    by the head count, so the sum over the heads that autograd takes for
    the shared k_pe becomes their mean."""

    @staticmethod
    def forward(ctx, k, dn):
        ctx.dn = dn
        return k.view_as(k)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[..., ctx.dn:] /= g.shape[2]
        return g, None


def dk_pe_not_summed():
    """dk_pe takes the mean of the heads' rope-column gradients, not
    their sum."""
    _patch(lambda good, q, k, v, causal, scale: good(
        q, _MeanOverHeads.apply(k, v.shape[3]), v, causal, scale=scale))
