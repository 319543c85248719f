"""b1_roofline: one triad's bytes at the HBM rate over kernel B1's
device time a launch. Moves proof_gbps."""

from perfbench import roofline

KERNEL = ("triad",)


def read(t):
    n = t.launches(KERNEL)
    if n == 0 or t.peak is None:
        return None
    bound = roofline.triad_bound(t.peak, t.facts["elements"],
                                 t.facts["itemsize"])
    return 100.0 * bound / (t.device_s(KERNEL) / n)
