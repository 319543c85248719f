"""The numbers by which an answer is held to its reference.

``rel`` is the whole tensor's error, steady from seed to seed; ``row_max``
is the worst row's, which one altered row or head cannot hide in. A row
is a vector over the last dimension (one head at one position); its
error is measured against the reference row's norm or the median row's,
whichever is larger, since some rows (a key that few queries see) are
all but zero. ``row_rms`` measures the worst row's error against the
root mean square of the rows' norms instead: for a tensor whose rows
near zero carry rounding that is large against the median row (the
query gradient's first positions), it still finds one altered row.
"""

from __future__ import annotations

import torch


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    """‖x − ref‖ / ‖ref‖ over the whole tensor."""
    r = ref.float()
    num = torch.linalg.vector_norm(x.float() - r, dtype=torch.float64)
    den = torch.linalg.vector_norm(r, dtype=torch.float64)
    return float(num / den) if float(den) > 0 else float(num)


def row_max(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ‖x_row − ref_row‖ / max(‖ref_row‖, median ‖ref_row‖)."""
    r = ref.float().reshape(-1, ref.shape[-1])
    d = torch.linalg.vector_norm(x.float().reshape(-1, ref.shape[-1]) - r,
                                 dim=-1)
    n = torch.linalg.vector_norm(r, dim=-1)
    den = torch.clamp(n, min=float(n.median()))
    den = torch.where(den > 0, den, torch.ones_like(den))
    return float((d / den).max())


def max_abs(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest elementwise |x − ref|, in float64."""
    return float((x.double() - ref.double()).abs().max())


def row_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ‖x_row − ref_row‖ over the root mean square of the
    reference rows' norms."""
    r = ref.float().reshape(-1, ref.shape[-1])
    d = torch.linalg.vector_norm(x.float().reshape(-1, ref.shape[-1]) - r,
                                 dim=-1)
    rms = float(torch.linalg.vector_norm(r)) / r.shape[0] ** 0.5
    return float(d.max()) / rms if rms > 0 else float(d.max())
