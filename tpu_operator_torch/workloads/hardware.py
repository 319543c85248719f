"""CUDA card identification + public peak numbers.

Counterpart of ``tpu_operator/workloads/hardware.py``. Peaks are NVIDIA's
published per-card data-sheet figures (dense, without sparsity); they
anchor the validator's utilization fractions and the interconnect
threshold (>= 80% of link bandwidth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
    # A100 SXM4 80GB: 312 TFLOP/s bf16 dense, HBM2e at 2039 GB/s, 12
    # NVLink-3 links, 600 GB/s bidirectional -> 300 each way
    "a100-sxm": ChipSpec("a100-sxm", 312.0, 80, 2039, 300.0),
    # GB200 NVL72, per Blackwell GPU: 180 PFLOP/s dense bf16 over 72 GPUs
    # (the data sheet's 360 is with sparsity), 13.4 TB of HBM3e at 576
    # TB/s (186 GB and 8 TB/s a GPU), NVLink-5 1.8 TB/s bidirectional ->
    # 900 each way
    "gb200": ChipSpec("gb200", 2500.0, 186, 8000, 900.0),
}

# substrings of a card's name, most specific first, after '-' and '_'
# became spaces: torch.cuda.get_device_name() and NVML's name, the
# feature label's form of it (NVIDIA-H100-80GB-HBM3) and GKE's
# accelerator label (nvidia-h100-80gb, nvidia-h100-mega-80gb, both SXM).
# The A100 is known by its SXM4 name alone: GKE's nvidia-a100-80gb (A2
# Ultra's SXM4 card) and the PCIe card's name share "a100 80gb".
# An unknown card maps to None and its proofs report without gating
_KIND_HINTS = (
    ("h100 pcie", "h100-pcie"),
    ("h100 80gb hbm3", "h100-sxm"),
    ("h100 sxm", "h100-sxm"),
    ("h100 mega 80gb", "h100-sxm"),
    ("nvidia h100 80gb", "h100-sxm"),
    ("a100 sxm", "a100-sxm"),
    ("gb200", "gb200"),
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
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def detect() -> tuple:
    """(platform, device_count, device_kind, ChipSpec|None) for CUDA, or
    ``("cpu", 1, "cpu", None)`` where there is no card."""
    import torch

    if not torch.cuda.is_available():
        return "cpu", 1, "cpu", None
    kind = torch.cuda.get_device_name(0)
    return "gpu", torch.cuda.device_count(), kind, chip_spec_for(kind)
