"""b3_layers_roofline: the summed backward bounds (``roofline_layers``) of
every layer's backward of the traced window, over the device time of
kernel B3's main kernel (``flash_bwd``, its ``flash_bwd_pre`` and
``flash_bwd_post`` left out by name). Moves attn_tok_s."""

from perfbench import roofline_layers


def read(t):
    calls = t.facts.get("layer_calls")
    dev = (t.device_s(("flash_bwd",)) - t.device_s(("flash_bwd_pre",))
           - t.device_s(("flash_bwd_post",)))
    if not calls or not t.facts.get("train") or t.steps == 0 \
            or t.peak is None or dev <= 0:
        return None
    bound = roofline_layers.calls_bound(t.peak, calls, backward=True)
    return 100.0 * bound * t.steps / dev
