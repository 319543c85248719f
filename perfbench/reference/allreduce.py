"""The mean over ranks: the reference for the NVLink proof's all-reduce
step (sum over the ranks, then a scale by 1/n).

Worked out in float64 from every rank's inputs. For the benchmark's
inputs (small integers, four ranks) the float32 mean is exact, so the
program's buffers have to match it bit for bit.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def mean(parts: Sequence[torch.Tensor], dtype=torch.float64) -> torch.Tensor:
    """The elementwise mean of ``parts``, summed and scaled in ``dtype``."""
    acc = torch.zeros(parts[0].shape, dtype=dtype, device=parts[0].device)
    for p in parts:
        acc += p.to(dtype)
    return acc * (1.0 / len(parts))
