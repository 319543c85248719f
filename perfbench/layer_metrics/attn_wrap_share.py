"""attn_wrap_share: the device time of the forward outside kernel B2
(the fold's copies and whatever else ``flash_attention`` launches), over
the forward's device time. Moves attn_tok_s."""

KERNEL = ("flash_fwd",)


def read(t):
    fwd = t.device_s(span="perfbench.fwd")
    if fwd <= 0:
        return None
    return 100.0 * (fwd - t.device_s(KERNEL, span="perfbench.fwd")) / fwd
