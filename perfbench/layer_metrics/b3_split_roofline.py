"""b3_split_roofline: the summed backward bounds (``roofline_split_bwd``)
of every layer's backward of the traced window whose values are narrower
than its keys, over the device time of kernel B3's main kernel
(``flash_bwd``, its ``flash_bwd_pre`` and ``flash_bwd_post`` left out by
name). Moves attn_tok_s."""

from perfbench import roofline_split_bwd


def read(t):
    calls = [c for c in t.facts.get("layer_calls") or ()
             if "d_v" in c and c["d_v"] != c["d_qk"]]
    dev = (t.device_s(("flash_bwd",)) - t.device_s(("flash_bwd_pre",))
           - t.device_s(("flash_bwd_post",)))
    if not calls or not t.facts.get("train") or t.steps == 0 \
            or t.peak is None or dev <= 0:
        return None
    bound = roofline_split_bwd.calls_bound(t.peak, calls)
    return 100.0 * bound * t.steps / dev
