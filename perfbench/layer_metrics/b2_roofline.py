"""b2_roofline: kernel B2's bound (``roofline.flash_bound`` at the
call's shape) over its device time a launch. Moves attn_tok_s."""

from perfbench import roofline

KERNEL = ("flash_fwd",)


def read(t):
    n = t.launches(KERNEL)
    if n == 0 or t.peak is None:
        return None
    f = t.facts
    bound, _ = roofline.flash_bound(t.peak, f["bh"], f["seq"], f["head_dim"])
    return 100.0 * bound / (t.device_s(KERNEL) / n)
