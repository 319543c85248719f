"""The ``attention_period`` cell: the split-width bounds against
``roofline_layers`` and by hand, the reference against float64 and the
port's CPU path, the readers on a hand-written trace, whole runs of the
generator on the CPU at a small size (sound runs come out correct and
load no JAX, runs with a fault planted in the port, ``faults_period.py``,
do not), and, on the card, B3's refusal of what it has no instantiation
for."""

import copy
import ctypes
import json
import subprocess
import sys

import pytest
import torch

from perfbench import (compare, controls, harness, manifest, roofline,
                       roofline_layers, roofline_split, trace)
from perfbench.reference import attention_period as ref
from perfbench.tests import cpu

H100 = roofline.H100_SXM
CELL = "attn.mimo-prefill-mixlen"


def small():
    """The cell at the CPU's size: the heads and widths kept, the lengths
    cut, and the window cut below them, so a window layer differs from a
    full one."""
    c = copy.deepcopy(manifest.load_cell(CELL))
    c.config.update({"sliding_window": 16})
    c.traffic.update({"seqs": [33, 70]})
    return c


@pytest.mark.parametrize("bh, bh_kv, s, d, w", [
    (8, 8, 32768, 128, None), (32, 4, 16384, 128, 2048), (1, 1, 16, 64, 3),
    (64, 8, 65535, 192, 128)])
def test_split_bound_reduces_to_roofline_layers(bh, bh_kv, s, d, w):
    """At d_v = d_qk and no sink the counts are ``roofline_layers``'."""
    assert roofline_split.split_fwd_flops(bh, s, d, d, w) == \
        roofline_layers.layer_fwd_flops(bh, s, d, w)
    assert roofline_split.split_fwd_bytes(bh, bh_kv, s, d, d) == \
        roofline_layers.layer_fwd_bytes(bh, bh_kv, s, d)
    assert roofline_split.split_fwd_bound(H100, bh, bh_kv, s, d, d, w) == \
        roofline_layers.layer_fwd_bound(H100, bh, bh_kv, s, d, w)


def test_mimo_counts_by_hand():
    # the full layer at 65535 positions: 2 * 64 * (65535 * 65536 / 2) *
    # (192 + 128) operations, ~88.9 ms at 989 TFLOP/s
    flops = 2 * 64 * (65535 * 65536 // 2) * 320
    assert roofline_split.split_fwd_flops(64, 65535, 192, 128) == flops
    bound, by = roofline_split.split_fwd_bound(H100, 64, 4, 65535, 192, 128)
    assert by == "operations"
    assert bound * 1e3 == pytest.approx(88.938, abs=0.001)
    # a window layer: q at 192 and out at 128 over 64 heads, k and v over
    # 8, m and l, and 64 sinks: ~3.05 GB, bound by its bytes
    nbytes = 2 * 64 * 65535 * 320 + 2 * 8 * 65535 * 320 \
        + 2 * 64 * 65535 * 4 + 4 * 64
    assert roofline_split.split_fwd_bytes(64, 8, 65535, 192, 128, True) \
        == nbytes
    bound, by = roofline_split.split_fwd_bound(H100, 64, 8, 65535, 192, 128,
                                               128, True)
    assert by == "bytes" and bound == nbytes / 3.35e12
    assert nbytes == pytest.approx(3.054e9, rel=1e-3)


def _dense64(q, k, v, window, sinks):
    B, S, H, D = q.shape
    g = H // k.shape[2]
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / D ** 0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    seen = (j <= i) & ((i - j < window) if window else True)
    s = s.masked_fill(~seen, float("-inf"))
    if sinks is None:
        return (torch.softmax(s, -1) @ v).transpose(1, 2)
    col = sinks.double().reshape(1, H, 1, 1).expand(B, H, S, 1)
    p = torch.softmax(torch.cat([s, col], -1), -1)[..., :-1]
    return (p @ v).transpose(1, 2)


def _inputs(S=48, H=8, hkv=2, D=48, DV=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, S, H, D, generator=g).to(torch.bfloat16)
    k = torch.randn(1, S, hkv, D, generator=g).to(torch.bfloat16)
    v = torch.randn(1, S, hkv, DV, generator=g).to(torch.bfloat16)
    sinks = torch.rand(H, generator=g) * 4 + 2
    return q, k, v, sinks


@pytest.mark.parametrize("window, sinks", [(None, False), (None, True),
                                           (5, True), (300, False)])
def test_reference_against_float64(monkeypatch, window, sinks):
    """Blocked by query rows (forced small here), over the band only."""
    from perfbench.reference import attention

    monkeypatch.setattr(attention, "_BLOCK_ELEMS", 8 * 37 * 48)
    q, k, v, s = _inputs()
    s = s if sinks else None
    got = ref.forward(q, k, v, window, s)
    assert got.shape == (1, 48, 8, 32)
    assert compare.rel(got, _dense64(q, k, v, window, s)) < 1e-6


def test_reference_against_the_port():
    from tpu_operator_torch.workloads import flashattention as fa

    q, k, v, s = _inputs()
    for window, sinks in ((None, None), (7, s)):
        out = fa.flash_attention(q, k, v, causal=True, window=window,
                                 sinks=sinks)
        assert compare.rel(out, ref.forward(q, k, v, window, sinks)) < 1e-2


def test_sound_run_is_correct():
    line = cpu.run(small(), seconds=0.4)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["window_path_misses"]["value"] == 0.0
    assert line["checks"]["sink_path_misses"]["value"] == 0.0
    assert set(line["metrics"]) == {"attn_tok_s", "attn_p95_ms", "peak_gib",
                                    "setup_s"}


FAULTS = ["sink_dropped", "sink_once_per_chunk", "values_at_the_key_width",
          "full_group_on_window_layers"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    line = cpu.run(small(), seconds=0.4,
                   patch=f"perfbench.tests.faults_period:{fault}")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["out_rel"]["value"] > \
        line["checks"]["out_rel"]["limit"]
    if fault == "sink_dropped":
        assert line["checks"]["sink_path_misses"]["value"] > 0


def test_control_fails_the_limits():
    got = controls.readings(small(), 20261018, "cpu")
    assert any(not value <= limit for value, limit in got.values()), got


def test_no_jax_in_a_run():
    """A whole CPU run of the cell, in a process of its own, loads no
    module named jax, jaxlib, flax or tpu_operator."""
    code = ("import sys, json; from perfbench.tests import "
            "test_bench_period as t; from perfbench.tests import cpu; "
            "line = cpu.run(t.small(), seconds=0.3); "
            "print(json.dumps([line['correct'], sorted({m.split('.')[0] "
            "for m in sys.modules})]))")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(manifest.ROOT),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    correct, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct is True
    assert "tpu_operator_torch" in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def _trace(tmp_path, facts):
    """One cycle of a period on a hand-written trace: B2 under the full
    layer's span and under a window layer's, each inside ``fwd``."""
    spans = [("window", 0, 1000), ("fwd", 0, 300), ("full_fwd", 0, 300),
             ("fwd", 300, 400), ("swa_fwd", 300, 400)]
    kernels = [("flash_fwd<192, 128, true>", 10, 10, 290),
               ("flash_fwd<192, 128, true>", 310, 310, 350)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench." + n,
           "ts": a, "dur": b - a} for n, a, b in spans]
    for corr, (name, host, d0, d1) in enumerate(kernels, 1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": host, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": d0,
                   "dur": d1 - d0, "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path), 1, facts, H100)


def test_readers_on_a_hand_written_trace(tmp_path):
    calls = [{"layer": 0, "kind": "full", "bh": 64, "bh_kv": 4, "seq": 8191,
              "d_qk": 192, "d_v": 128, "window": None, "sinks": False},
             {"layer": 1, "kind": "swa", "bh": 64, "bh_kv": 8, "seq": 8191,
              "d_qk": 192, "d_v": 128, "window": 128, "sinks": True}]
    t = _trace(tmp_path, {"layer_calls": calls, "train": False,
                          "model_flops_per_call": 1e9})
    split = manifest.layer_reader("b2_split_roofline")(t)
    sink = manifest.layer_reader("b2_sink_roofline")(t)
    full, _ = roofline_split.split_fwd_bound(H100, 64, 4, 8191, 192, 128)
    swa, by = roofline_split.split_fwd_bound(H100, 64, 8, 8191, 192, 128,
                                             128, True)
    assert by == "bytes"
    assert split == pytest.approx(100 * full / 280e-6)
    assert sink == pytest.approx(100 * swa / 40e-6)
    # the accepted readers this cell reports read it too
    assert manifest.layer_reader("attn_wrap_share")(t) == 0.0
    assert manifest.layer_reader("idle_pct.attn")(t) == pytest.approx(68.0)
    # another cell's facts (one head width): nothing to read
    old = [dict(c, head_dim=128) for c in calls]
    for c in old:
        del c["d_qk"], c["d_v"], c["sinks"]
    t = _trace(tmp_path, {"layer_calls": old, "train": False})
    assert manifest.layer_reader("b2_split_roofline")(t) is None
    assert manifest.layer_reader("b2_sink_roofline")(t) is None


@pytest.mark.card
def test_b3_refuses_split_widths_and_sinks(card):
    """On the card ``flash_bwd`` raises, naming B3, for values narrower
    than keys or a sink, and B3's C entry itself returns
    cudaErrorInvalidValue (1) for dv != d or a sink pointer."""
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.workloads import flashattention as fa

    def operands(dv):
        q, k = (torch.randn(8, 256, 192, device=card).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn(8, 256, dv, device=card).to(torch.bfloat16)
        return q, k, v

    q, k, v = operands(128)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True)
    with pytest.raises(ValueError, match="kernel B3"):
        fa.flash_bwd(q, k, v, out, m, l, torch.randn_like(out), True)
    q, k, v = (t[..., :128].contiguous() for t in operands(128))
    sinks = torch.full((8,), 3.0, device=card)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True, sinks=sinks)
    with pytest.raises(ValueError, match="kernel B3"):
        fa.flash_bwd(q, k, v, out, m, l, torch.randn_like(out), True,
                     sinks=sinks)
    lib = build.load("flash_attention_bwd", fa._BWD_SIGNATURES)
    strides = (ctypes.c_int64 * 16)(*([8] * 16))
    args = [q.data_ptr()] * 12 + [8, 256, 256]
    assert lib.flash_attention_bwd_bf16(
        *args, 192, 128, 1, 0.07, 1, 0, None, strides, card.index,
        None) == 1
    assert lib.flash_attention_bwd_bf16(
        *args, 128, 128, 1, 0.07, 1, 0, sinks.data_ptr(), strides,
        card.index, None) == 1
