"""The ``attention_layers`` cells: the window's pair count against brute
force, the layered bounds against ``roofline.flash_bound``, the reference
against float64, and whole runs of the generator on the CPU at a small
size: sound runs come out correct, runs with a fault planted in the port
(``faults_layers.py``) do not."""

import copy

import pytest
import torch

from perfbench import compare, manifest, roofline, roofline_layers, trace
from perfbench.reference import attention_layers as ref
from perfbench.tests import cpu

H100 = roofline.H100_SXM
CELLS = ("attn.trinity-train-16k", "attn.prefill-mixlen")
# the CPU's size: the widths kept, the lengths cut; the window cut below
# the lengths, so a window layer differs from a full one
SMALL = {"attn.trinity-train-16k": ({"sliding_window": 16}, {"seqs": [96]}),
         "attn.prefill-mixlen": ({}, {"seqs": [33, 70]})}


def small(cell):
    c = copy.deepcopy(manifest.load_cell(cell))
    config, traffic = SMALL[cell]
    c.config.update(config)
    c.traffic.update(traffic)
    return c


@pytest.mark.parametrize("s", [1, 2, 7, 64, 200])
@pytest.mark.parametrize("w", [None, 1, 3, 64, 500])
def test_window_pairs_against_brute_force(s, w):
    seen = sum(1 for i in range(s) for j in range(s)
               if j <= i and (w is None or i - j < w))
    assert roofline_layers.window_pairs(s, w) == seen
    if w is None or w >= s:
        assert roofline_layers.window_pairs(s, w) == roofline.causal_pairs(s)


def test_trinity_window_pairs():
    # one head at 16384 positions: a full layer's pairs and a 2048-key
    # window layer's
    assert roofline_layers.window_pairs(16384) == 134_225_920
    assert roofline_layers.window_pairs(16384, 2048) == 31_458_304


@pytest.mark.parametrize("bh, s, d", [(8, 32768, 128), (1, 16, 128),
                                      (16, 16384, 64)])
def test_bounds_reduce_to_flash_bound(bh, s, d):
    """Group 1 and no window: the forward bound is ``flash_bound``, the
    backward's operations ``attention_bwd_flops``."""
    assert roofline_layers.layer_fwd_bound(H100, bh, bh, s, d) == \
        roofline.flash_bound(H100, bh, s, d)
    assert roofline_layers.layer_bwd_flops(bh, s, d) == \
        roofline.attention_bwd_flops(bh, s, d)
    assert roofline_layers.layer_fwd_flops(bh, s, d, s) == \
        roofline.attention_fwd_flops(bh, s, d)


def test_grouped_bytes():
    # 32 query heads over 4 KV heads at [16384, 128]
    q = 32 * 16384 * 128 * 2
    kv = 4 * 16384 * 128 * 2
    stats = 32 * 16384 * 4
    assert roofline_layers.layer_fwd_bytes(32, 4, 16384, 128) == \
        2 * q + 2 * kv + 2 * stats
    assert roofline_layers.layer_bwd_bytes(32, 4, 16384, 128) == \
        4 * q + 2 * stats + 4 * kv
    _, by = roofline_layers.layer_bwd_bound(H100, 32, 4, 16384, 128, 2048)
    assert by == "operations"


def _dense64(q, k, v, window):
    B, S, H, D = q.shape
    g = H // k.shape[2]
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / D ** 0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    seen = (j <= i) & ((i - j < window) if window else True)
    s = s.masked_fill(~seen, float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2)


@pytest.mark.parametrize("window", [None, 5, 300])
def test_reference_against_float64(monkeypatch, window):
    """Blocked by query rows (forced small here), over the band only."""
    monkeypatch.setattr(ref, "_BLOCK_ELEMS", 37 * 48)
    g = torch.Generator().manual_seed(1)
    q, dout = (torch.randn(1, 48, 6, 32, generator=g).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn(1, 48, 2, 32, generator=g).to(torch.bfloat16)
            for _ in range(2))
    xs = [t.double().requires_grad_(True) for t in (q, k, v)]
    o64 = _dense64(*xs, window)
    o64.backward(dout.double())
    out, dq, dk, dv = ref.forward_backward(q, k, v, dout, window)
    assert compare.rel(ref.forward(q, k, v, window), o64.detach()) < 1e-6
    for got, want in ((out, o64), (dq, xs[0].grad), (dk, xs[1].grad),
                      (dv, xs[2].grad)):
        assert compare.rel(got, want.detach()) < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = cpu.run(small(cell), seconds=0.4)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["window_path_misses"]["value"] == 0.0
    assert set(line["metrics"]) >= {"attn_tok_s", "peak_gib", "setup_s"}


FAULTS = ["window_ignored", "window_one_key_wide", "answer_altered",
          "window_off_the_kernel_path"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    line = cpu.run(small("attn.trinity-train-16k"), seconds=0.4,
                   patch=f"perfbench.tests.faults_layers:{fault}")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1
    if fault == "window_off_the_kernel_path":
        assert line["checks"]["window_path_misses"]["value"] > 0


def test_control_fails_the_limits():
    from perfbench import controls

    for cell in CELLS:
        got = controls.readings(small(cell), 20261018, "cpu")
        assert any(not value <= limit for value, limit in got.values()), got


def _trace(tmp_path, facts):
    """One step of the period on a hand-written trace: a layout copy and
    B2 under the forward spans (each layer's inside ``fwd``), B3 and its
    pre and post under the backward spans (inside ``bwd``)."""
    import json

    spans = [("window", 0, 1000), ("fwd", 0, 100), ("swa_fwd", 0, 100),
             ("fwd", 100, 200), ("full_fwd", 100, 200), ("bwd", 200, 500),
             ("swa_bwd", 200, 500), ("bwd", 500, 900), ("full_bwd", 500, 900)]
    kernels = [("elementwise_copy", 5, 0, 10),
               ("flash_fwd<128, true>", 10, 10, 60),
               ("flash_fwd<128, true>", 110, 60, 160),
               ("flash_bwd_pre<128>", 210, 200, 210),
               ("flash_bwd<128, true>", 220, 210, 400),
               ("flash_bwd_post<128>", 230, 400, 410),
               ("flash_bwd<128, true>", 520, 410, 800)]
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
    calls = [{"layer": 0, "kind": "swa", "bh": 32, "bh_kv": 4, "seq": 16384,
              "head_dim": 128, "window": 2048},
             {"layer": 1, "kind": "full", "bh": 32, "bh_kv": 4, "seq": 16384,
              "head_dim": 128, "window": None}]
    t = _trace(tmp_path, {"layer_calls": calls, "train": True,
                          "model_flops_per_call": 1e9})
    read = {n: manifest.layer_reader(n)(t) for n in (
        "attn_mfu", "b2_layers_roofline", "b3_layers_roofline",
        "b2_swa_roofline", "b3_swa_roofline", "idle_pct.attn",
        "attn_wrap_share", "bwd_ms")}
    fwd = [roofline_layers.layer_fwd_bound(H100, 32, 4, 16384, 128, w)[0]
           for w in (2048, None)]
    bwd = [roofline_layers.layer_bwd_bound(H100, 32, 4, 16384, 128, w)[0]
           for w in (2048, None)]
    assert read["b2_layers_roofline"] == pytest.approx(
        100 * sum(fwd) / 150e-6)
    assert read["b2_swa_roofline"] == pytest.approx(100 * fwd[0] / 50e-6)
    # B3's pre and post are left out by name
    assert read["b3_layers_roofline"] == pytest.approx(
        100 * sum(bwd) / 580e-6)
    assert read["b3_swa_roofline"] == pytest.approx(100 * bwd[0] / 190e-6)
    assert read["idle_pct.attn"] == pytest.approx(24.0)
    assert read["attn_mfu"] == pytest.approx(100 * 1e9 / 1e-3 / 989e12)
    # the accepted readers of the forward's copies and of the backward
    # find the layers inside their spans
    assert read["attn_wrap_share"] == pytest.approx(100 * 10 / 160)
    assert read["bwd_ms"] == pytest.approx(0.6)
    # a prefill's facts: no backward to read
    t = _trace(tmp_path, {"layer_calls": calls, "train": False,
                          "model_flops_per_call": 1e9})
    assert manifest.layer_reader("b3_layers_roofline")(t) is None
