"""The ``attention_mla`` cell: the split-width backward bound against
``roofline_layers`` and by hand, DeepSeek's softmax scale, the reference
against float64, the readers on a hand-written trace, and whole runs of
the generator on the CPU at a small size: sound runs come out correct and
load no JAX, runs with a fault planted in the port (``faults_mla.py``) do
not, nor does the float8 control; and, on the card, B3 taking keys 192
over values 128 and refusing sinks."""

import copy
import ctypes
import json
import math
import subprocess
import sys

import pytest
import torch

from perfbench import (compare, controls, harness, manifest, roofline,
                       roofline_layers, roofline_split, roofline_split_bwd,
                       trace)
from perfbench.generators import attention_mla
from perfbench.reference import attention_mla as ref
from perfbench.tests import cpu

H100 = roofline.H100_SXM
CELL = "attn.dsv3-train-16k"


def small():
    """The cell at the CPU's size: the widths and the scale kept, 4 heads
    and 160 positions (two and a half of B3's 64-row tiles)."""
    c = copy.deepcopy(manifest.load_cell(CELL))
    c.config.update({"num_attention_heads": 4})
    c.traffic.update({"seqs": [160]})
    return c


@pytest.mark.parametrize("bh, bh_kv, s, d, w", [
    (16, 16, 16384, 128, None), (32, 4, 16384, 128, 2048), (1, 1, 16, 64, 3),
    (128, 128, 16384, 192, None), (8, 8, 300, 64, 500)])
def test_split_bwd_reduces_to_roofline_layers(bh, bh_kv, s, d, w):
    """At d_v = d_qk the backward's counts are ``roofline_layers``'."""
    assert roofline_split_bwd.split_bwd_flops(bh, s, d, d, w) == \
        roofline_layers.layer_bwd_flops(bh, s, d, w)
    assert roofline_split_bwd.split_bwd_bytes(bh, bh_kv, s, d, d) == \
        roofline_layers.layer_bwd_bytes(bh, bh_kv, s, d)
    assert roofline_split_bwd.split_bwd_bound(H100, bh, bh_kv, s, d, d, w) \
        == roofline_layers.layer_bwd_bound(H100, bh, bh_kv, s, d, w)


def test_dsv3_counts_by_hand():
    # one layer at 16384 positions, 128 heads: 11.0 TFLOP forward (192 +
    # 128) and 28.6 TFLOP backward (3 * 192 + 2 * 128), both bound by
    # their operations
    pairs = 16384 * 16385 // 2
    assert roofline_split.split_fwd_flops(128, 16384, 192, 128) == \
        2 * 128 * pairs * 320 == pytest.approx(11.0e12, rel=2e-3)
    flops = roofline_split_bwd.split_bwd_flops(128, 16384, 192, 128)
    assert flops == 2 * 128 * pairs * 832 == pytest.approx(28.59e12,
                                                           rel=1e-3)
    bound, by = roofline_split_bwd.split_bwd_bound(H100, 128, 128, 16384,
                                                   192, 128)
    assert by == "operations" and bound == flops / 989e12
    # q, dq, k, dk at 192; out, dout, v, dv at 128; m and l: ~5.4 GB
    nbytes = 4 * 128 * 16384 * 320 + 2 * 128 * 16384 * 4 \
        + 4 * 128 * 16384 * 320
    assert roofline_split_bwd.split_bwd_bytes(128, 128, 16384, 192, 128) \
        == nbytes
    # the step: four layers, 4 * (11.1 + 28.9) ms at the bf16 peak
    step = 4 * (roofline_split.split_fwd_bound(H100, 128, 128, 16384, 192,
                                               128)[0] + bound)
    assert step * 1e3 == pytest.approx(160.1, abs=0.1)


def test_deepseek_softmax_scale():
    """DeepSeek's rule on the configuration's own numbers: 192**-0.5
    times (0.1 ln 40 + 1)**2."""
    cfg = manifest.load_cell(CELL).config
    assert attention_mla.yarn_mscale(40, 1) == pytest.approx(1.368888,
                                                             abs=1e-6)
    assert attention_mla.softmax_scale(cfg) == pytest.approx(0.1352338,
                                                             abs=1e-7)
    assert attention_mla.softmax_scale(cfg) == \
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    # no YaRN (or a factor of 1): the width's own scale
    assert attention_mla.softmax_scale(dict(cfg, rope_scaling=None)) == \
        192 ** -0.5
    assert attention_mla.yarn_mscale(1, 1) == 1.0


def _dense64(q, k_nope, k_pe, v, dout, scale):
    """The layer through autograd in float64, all at once."""
    H = q.shape[2]
    leaves = [t.double().requires_grad_() for t in (q, k_nope, k_pe, v)]
    qd, knd, kpd, vd = leaves
    k = torch.cat([knd, kpd.expand(-1, -1, H, -1)], dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, k) * scale
    S = q.shape[1]
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    out.backward(dout.double())
    return (out.detach(), *(t.grad for t in leaves))


def _inputs(S=40, H=4, seed=1):
    g = torch.Generator().manual_seed(seed)
    shapes = ((1, S, H, 192), (1, S, H, 128), (1, S, 1, 64), (1, S, H, 128),
              (1, S, H, 128))
    return [torch.randn(*s, generator=g).to(torch.bfloat16) for s in shapes]


def test_reference_against_float64(monkeypatch):
    """Blocked by query rows (forced small here), the rope key's gradient
    summed over the heads."""
    from perfbench.reference import attention

    monkeypatch.setattr(attention, "_BLOCK_ELEMS", 4 * 7 * 40)
    x = _inputs()
    got = ref.forward_backward(*x, 0.135)
    want = _dense64(*x, 0.135)
    assert [tuple(t.shape) for t in got] == [
        (1, 40, 4, 128), (1, 40, 4, 192), (1, 40, 4, 128), (1, 40, 1, 64),
        (1, 40, 4, 128)]
    for a, b in zip(got, want):
        assert compare.rel(a, b) < 1e-6


def test_sound_run_is_correct():
    line = cpu.run(small(), seconds=1.0)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["scaled_path_misses"]["value"] == 0.0
    assert {"dk_pe_rel", "dk_nope_row_max"} <= set(line["checks"])
    assert set(line["metrics"]) == {"attn_tok_s", "peak_gib", "setup_s"}


# each fault and a number it must push over its limit
FAULTS = {"default_scale": "out_rel", "k_pe_not_shared": "out_rel",
          "dk_pe_not_summed": "dk_pe_rel"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    line = cpu.run(small(), seconds=1.0,
                   patch=f"perfbench.tests.faults_mla:{fault}")
    assert line["correct"] is False, line["checks"]
    c = line["checks"][FAULTS[fault]]
    assert c["value"] > c["limit"], line["checks"]
    if fault == "dk_pe_not_summed":
        # the rest of the answer is untouched
        assert line["checks"]["out_rel"]["value"] <= \
            line["checks"]["out_rel"]["limit"]


def test_control_fails_the_limits():
    got = controls.readings(small(), 20261018, "cpu")
    assert any(not value <= limit for value, limit in got.values()), got


def test_no_jax_in_a_run():
    """A whole CPU run of the cell, in a process of its own, loads no
    module named jax, jaxlib, flax or tpu_operator."""
    code = ("import sys, json; from perfbench.tests import "
            "test_bench_mla as t; from perfbench.tests import cpu; "
            "line = cpu.run(t.small(), seconds=1.0); "
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
    """One step of two layers on a hand-written trace: B2 under each
    forward's span, B3's three kernels under each backward's."""
    spans = [("window", 0, 1000), ("fwd", 0, 100), ("full_fwd", 0, 100),
             ("fwd", 100, 200), ("full_fwd", 100, 200), ("bwd", 200, 600),
             ("full_bwd", 200, 600), ("bwd", 600, 1000),
             ("full_bwd", 600, 1000)]
    kernels = [("CatArrayBatchedCopy", 5, 5, 15),
               ("flash_fwd<192, 128, true>", 20, 20, 90),
               ("flash_fwd<192, 128, true>", 120, 120, 190),
               ("flash_bwd_pre<192, 128>", 210, 200, 210),
               ("flash_bwd<192, 128, true>", 220, 210, 500),
               ("flash_bwd_post<192>", 230, 500, 520),
               ("flash_bwd_pre<192, 128>", 610, 600, 610),
               ("flash_bwd<192, 128, true>", 620, 610, 900),
               ("flash_bwd_post<192>", 630, 900, 920)]
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
    calls = [{"layer": i, "kind": "full", "bh": 128, "bh_kv": 128,
              "seq": 4096, "d_qk": 192, "d_v": 128, "window": None,
              "sinks": False} for i in range(2)]
    t = _trace(tmp_path, {"layer_calls": calls, "train": True,
                          "model_flops_per_call": 1e9})
    bwd, by = roofline_split_bwd.split_bwd_bound(H100, 128, 128, 4096, 192,
                                                 128)
    fwd, _ = roofline_split.split_fwd_bound(H100, 128, 128, 4096, 192, 128)
    assert by == "operations"
    assert manifest.layer_reader("b3_split_roofline")(t) == \
        pytest.approx(100 * 2 * bwd / 580e-6)
    assert manifest.layer_reader("b2_split_roofline")(t) == \
        pytest.approx(100 * 2 * fwd / 140e-6)
    # the key's assembly is the forward's device time outside B2
    assert manifest.layer_reader("attn_wrap_share")(t) == \
        pytest.approx(100 * 10 / 150)
    assert manifest.layer_reader("bwd_ms")(t) == pytest.approx(0.64)
    assert manifest.layer_reader("idle_pct.attn")(t) == pytest.approx(21.0)
    # the facts of a cell with one head width, or of prefill: nothing
    old = [dict(c, head_dim=128) for c in calls]
    for c in old:
        del c["d_qk"], c["d_v"], c["sinks"]
    t = _trace(tmp_path, {"layer_calls": old, "train": True})
    assert manifest.layer_reader("b3_split_roofline")(t) is None
    t = _trace(tmp_path, {"layer_calls": calls, "train": False})
    assert manifest.layer_reader("b3_split_roofline")(t) is None


@pytest.mark.card
def test_b3_takes_split_widths_and_refuses_sinks(card):
    """On the card ``flash_bwd`` takes keys 192 wide over values 128 and
    raises, naming B3, for a sink (B3 has no sink gradient); B3's C entry
    itself returns cudaErrorInvalidValue (1) for split widths it has no
    instantiation for (192 over 64) or a sink pointer."""
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.workloads import flashattention as fa

    def operands(dv):
        q, k = (torch.randn(8, 256, 192, device=card).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn(8, 256, dv, device=card).to(torch.bfloat16)
        return q, k, v

    q, k, v = operands(128)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, m, l, torch.randn_like(out), True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    q, k, v = (t[..., :128].contiguous() for t in operands(128))
    sinks = torch.full((8,), 3.0, device=card)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True, sinks=sinks)
    with pytest.raises(ValueError, match="kernel B3 takes no sinks"):
        fa.flash_bwd(q, k, v, out, m, l, torch.randn_like(out), True,
                     sinks=sinks)
    lib = build.load("flash_attention_bwd", fa._BWD_SIGNATURES)
    strides = (ctypes.c_int64 * 16)(*([8] * 16))
    args = [q.data_ptr()] * 12 + [8, 256, 256]
    assert lib.flash_attention_bwd_bf16(
        *args, 192, 64, 1, 0.07, 1, 0, None, strides, card.index,
        None) == 1
    assert lib.flash_attention_bwd_bf16(
        *args, 128, 128, 1, 0.07, 1, 0, sinks.data_ptr(), strides,
        card.index, None) == 1
