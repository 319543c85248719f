"""The STREAM triad's closed form: the reference for a chain of in-place
triads ``a = a + alpha * b``.

After ``n`` triads, ``a = a0 + n * alpha * b``. Worked out in float64,
this is exact for the benchmark's inputs (small integers, alpha a power
of two), so the float32 chain has to match it bit for bit.
Imports nothing of the program.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def after(a0: torch.Tensor, b: torch.Tensor, alpha: float, n: int,
          dtype=torch.float64) -> torch.Tensor:
    """``a0`` after ``n`` triads, in ``dtype``."""
    return a0.to(dtype) + (n * alpha) * b.to(dtype)


@torch.no_grad()
def chain(a0: torch.Tensor, b: torch.Tensor, alpha: float, n: int,
          dtype: torch.dtype) -> torch.Tensor:
    """``n`` triads one after another with ``a`` and ``b`` held in
    ``dtype``: the control, a precision below the float32 that the
    configuration states, rounds at every step."""
    a = a0.to(dtype, copy=True)
    bd = (alpha * b.double()).to(dtype)
    for _ in range(n):
        a.add_(bd)
    return a
