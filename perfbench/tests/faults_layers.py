"""Faults planted under the ``attention_layers`` cells' timed path, for
``test_bench_layers.py``: each replaces the port's ``flash_attention``
with a broken copy that takes the ``window`` keyword, in the process that
calls it."""

from __future__ import annotations

import torch


def _patch(broken):
    from tpu_operator_torch.workloads import flashattention as fa

    good = fa.flash_attention
    fa.flash_attention = lambda q, k, v, causal=True, window=None: broken(
        good, q, k, v, causal, window)


def window_ignored():
    """Window layers run as full layers."""
    _patch(lambda good, q, k, v, causal, window: good(q, k, v, causal))


def window_one_key_wide():
    """Window layers see one key more than the window."""
    _patch(lambda good, q, k, v, causal, window: good(
        q, k, v, causal, None if window is None else window + 1))


def answer_altered():
    """One row of every answer (one head at one position) is negated."""
    def broken(good, q, k, v, causal, window):
        out = good(q, k, v, causal, window)
        sign = torch.ones(out.shape[1:3], dtype=out.dtype, device=out.device)
        sign[out.shape[1] // 2, 0] = -1
        return out * sign[..., None]
    _patch(broken)


def window_off_the_kernel_path():
    """Window layers answer right, through the plain reference with K/V
    repeated, never reaching the kernels' window path."""
    def broken(good, q, k, v, causal, window):
        if window is None:
            return good(q, k, v, causal)
        from tpu_operator_torch.workloads import attention_reference

        return attention_reference.attention(q, k, v, causal,
                                             window).to(q.dtype)
    _patch(broken)
