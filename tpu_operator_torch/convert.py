"""Carry arrays across: numpy (including JAX arrays seen as numpy) to torch.

The JAX package's arrays reach this module as ``np.asarray(x)``. A JAX
bf16 array then has the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` refuses; it goes through a float32 view and back to
``torch.bfloat16``, which is exact (every bf16 value is a float32 value).
"""

from __future__ import annotations

import numpy as np
import torch

from .workloads.backend import resolve_device


def to_torch(x, device=None) -> torch.Tensor:
    """A copy of ``x`` (array-like) as a tensor on ``device`` (``None``
    means ``cuda:0``), keeping its dtype; bf16 stays bf16."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 widens exactly to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
