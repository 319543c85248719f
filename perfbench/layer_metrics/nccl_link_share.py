"""nccl_link_share: one all-reduce's bus bytes over the NCCL all-reduce
kernel's device time a launch, as a share of one-way NVLink. Moves
proof_gbps."""

from perfbench import roofline

KERNEL = ("nccl", "allreduce")


def read(t):
    n = t.launches(KERNEL)
    if n == 0 or t.peak is None:
        return None
    bus = roofline.allreduce_bus_bytes(t.facts["bytes"], t.facts["world"])
    return 100.0 * bus / (t.device_s(KERNEL) / n) / t.peak.nvlink_bytes_s
