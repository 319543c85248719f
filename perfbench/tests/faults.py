"""Faults planted under the timed path, for ``test_faults.py``: each
replaces one entry of the port with a broken copy, in the process that
calls it (the harness runs a patch in every rank's process before its
set-up)."""

from __future__ import annotations

import torch


def _patch_attention(broken):
    from tpu_operator_torch.workloads import flashattention as fa

    good = fa.flash_attention
    fa.flash_attention = lambda q, k, v, causal=True: broken(good, q, k, v,
                                                             causal)


def attention_state_unchanged():
    """The call hands its input back as its answer."""
    _patch_attention(lambda good, q, k, v, causal: q * 1.0)


def attention_half_batch():
    """Half of the heads are left out (their output and gradients zero)."""
    def broken(good, q, k, v, causal):
        out = good(q, k, v, causal)
        keep = torch.ones(out.shape[2], dtype=out.dtype, device=out.device)
        keep[out.shape[2] // 2:] = 0
        return out * keep[:, None]
    _patch_attention(broken)


def attention_answer_altered():
    """One row of the answer (one head at one position) is negated."""
    def broken(good, q, k, v, causal):
        out = good(q, k, v, causal)
        sign = torch.ones(out.shape[1:3], dtype=out.dtype, device=out.device)
        sign[out.shape[1] // 2, 0] = -1
        return out * sign[..., None]
    _patch_attention(broken)


def _patch_triad(broken):
    from tpu_operator_torch.workloads import hbm_probe

    good = hbm_probe.triad_
    hbm_probe.triad_ = lambda a, b, alpha=2.0: broken(good, a, b, alpha)


def triad_state_unchanged():
    """Every 1000th triad returns ``a`` as it was."""
    count = [0]

    def broken(good, a, b, alpha):
        count[0] += 1
        return a if count[0] % 1000 == 0 else good(a, b, alpha)
    _patch_triad(broken)


def triad_half_batch():
    """The triad covers the first half of the rows only."""
    _patch_triad(lambda good, a, b, alpha: good(a[: a.shape[0] // 2],
                                                b[: b.shape[0] // 2], alpha))


def triad_answer_altered():
    """One element is off by one after a triad."""
    def broken(good, a, b, alpha):
        good(a, b, alpha)
        a.view(-1)[a.numel() // 3] += 1.0
        return a
    _patch_triad(broken)


def _patch_step(broken):
    from tpu_operator_torch.workloads import collectives

    good = collectives._step
    collectives._step = lambda op, c, n, rank: broken(good, op, c, n, rank)


def allreduce_state_unchanged():
    """The step returns the buffer as it was."""
    _patch_step(lambda good, op, c, n, rank: c)


def allreduce_half_batch():
    """The first half of the buffer is reduced; the mean is taken of that
    half alone and the rest scaled as it stands."""
    def broken(good, op, c, n, rank):
        import torch.distributed as dist

        dist.all_reduce(c[: c.numel() // 2])
        return c.mul_(1.0 / n)
    _patch_step(broken)


def allreduce_exchange_left_out():
    """No exchange between the ranks: each scales its own buffer."""
    _patch_step(lambda good, op, c, n, rank: c.mul_(1.0 / n))


def allreduce_answer_altered():
    """One element is off by one after the step, on rank 1."""
    def broken(good, op, c, n, rank):
        good(op, c, n, rank)
        if rank == 1:
            c[c.numel() // 3] += 1.0
        return c
    _patch_step(broken)
