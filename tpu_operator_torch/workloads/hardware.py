"""CUDA card identification + public peak numbers.

Counterpart of ``tpu_operator/workloads/hardware.py``. Peaks are NVIDIA's
published per-card data-sheet figures (dense, without sparsity); they
anchor the validator's utilization fractions and the interconnect
threshold (>= 80% of link bandwidth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ChipSpec:
    generation: str
    peak_bf16_tflops: float    # per card, dense
    hbm_gb: float
    hbm_bw_gbps: float         # GB/s per card
    nvlink_bw_gbps: float      # GB/s per card, ONE direction (see CHIPS)


# NCCL's bus bandwidth counts the bytes one card sends (equally, receives)
# per second, so it is held against the link rate in one direction, never
# against the bidirectional sum that data sheets headline: an SXM card's
# NVLink is 900 GB/s as send + receive, 450 GB/s each way, and a 0.8 gate
# against 900 could never pass.
CHIPS = {
    # H100 SXM5: 18 NVLink-4 links, 900 GB/s bidirectional -> 450 each way
    "h100-sxm": ChipSpec("h100-sxm", 989.0, 80, 3350, 450.0),
    # H100 PCIe: the link every PCIe card is sure to have is PCIe Gen5 x16,
    # 64 GB/s each way; a pair joined by an NVLink bridge (600 GB/s
    # bidirectional) exceeds it, which a floor-type gate tolerates
    "h100-pcie": ChipSpec("h100-pcie", 756.0, 80, 2000, 64.0),
}

# substrings of a card's name, most specific first, after '-' and '_'
# became spaces: torch.cuda.get_device_name() and NVML's name, the
# feature label's form of it (NVIDIA-H100-80GB-HBM3) and GKE's
# accelerator label (nvidia-h100-80gb, nvidia-h100-mega-80gb, both SXM).
# An unknown card maps to None and its proofs report without gating
_KIND_HINTS = (
    ("h100 pcie", "h100-pcie"),
    ("h100 80gb hbm3", "h100-sxm"),
    ("h100 sxm", "h100-sxm"),
    ("h100 mega 80gb", "h100-sxm"),
    ("nvidia h100 80gb", "h100-sxm"),
)


def chip_spec_for(device_kind: str) -> Optional[ChipSpec]:
    """Map a card name (e.g. 'NVIDIA H100 80GB HBM3') to a ChipSpec."""
    kind = (device_kind or "").lower().replace("-", " ").replace("_", " ")
    for hint, gen in _KIND_HINTS:
        if hint in kind:
            return CHIPS[gen]
    return None


def device_kind(device) -> str:
    """The card name of a torch device, ``"cpu"`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def detect() -> tuple:
    """(platform, device_count, device_kind, ChipSpec|None) for CUDA, or
    ``("cpu", 1, "cpu", None)`` where there is no card."""
    if not torch.cuda.is_available():
        return "cpu", 1, "cpu", None
    kind = torch.cuda.get_device_name(0)
    return "gpu", torch.cuda.device_count(), kind, chip_spec_for(kind)
