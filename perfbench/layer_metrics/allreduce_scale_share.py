"""allreduce_scale_share: the device time of the proof's step outside
the NCCL all-reduce kernel (the in-place scale by 1/n), over the step's.
Moves proof_gbps."""

KERNEL = ("nccl", "allreduce")


def read(t):
    step = t.device_s(span="perfbench.step")
    if step <= 0 or t.launches(KERNEL, span="perfbench.step") == 0:
        return None
    return 100.0 * (step - t.device_s(KERNEL, span="perfbench.step")) / step
