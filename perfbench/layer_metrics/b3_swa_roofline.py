"""b3_swa_roofline: the summed backward bounds (``roofline_layers``) of
the sliding-window layers of the traced window, over the device time of
kernel B3's main kernel (``flash_bwd``, without ``flash_bwd_pre`` and
``flash_bwd_post``) launched under ``perfbench.swa_bwd``. Moves
attn_tok_s."""

from perfbench import roofline_layers

SPAN = "perfbench.swa_bwd"


def read(t):
    calls = [c for c in t.facts.get("layer_calls") or ()
             if c["kind"] == "swa"]
    dev = (t.device_s(("flash_bwd",), SPAN)
           - t.device_s(("flash_bwd_pre",), SPAN)
           - t.device_s(("flash_bwd_post",), SPAN))
    if not calls or not t.facts.get("train") or t.steps == 0 \
            or t.peak is None or dev <= 0:
        return None
    bound = roofline_layers.calls_bound(t.peak, calls, backward=True)
    return 100.0 * bound * t.steps / dev
