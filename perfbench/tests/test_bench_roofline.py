"""The yardstick's counts, each against a case worked by hand."""

import pytest

from perfbench import roofline

H100 = roofline.H100_SXM


def test_peaks_by_card_name():
    assert roofline.peak_for("NVIDIA H100 80GB HBM3") is H100
    assert roofline.peak_for("cpu") is None


def test_flash_bound_exact():
    # [8*1, 32768, 128]: 4*8*128*32768*32769/2 = 2.199e12 operations
    flops = 4 * 8 * 128 * 32768 * 32769 / 2
    assert roofline.attention_fwd_flops(8, 32768, 128) == flops
    bound, by = roofline.flash_bound(H100, 8, 32768, 128)
    assert by == "operations"
    assert bound == pytest.approx(flops / 989e12, rel=1e-12)
    assert bound * 1e3 == pytest.approx(2.2235, abs=1e-4)
    # a short one is bound by its bytes: q, k, v, out bf16, m and l f32
    bound, by = roofline.flash_bound(H100, 1, 16, 128)
    assert by == "bytes"
    assert bound == (4 * 16 * 128 * 2 + 2 * 16 * 4) / 3.35e12


def test_attention_flops():
    assert roofline.causal_pairs(4) == 10
    assert roofline.attention_fwd_flops(2, 4, 8) == 4 * 2 * 8 * 10
    assert roofline.attention_fwd_flops(2, 4, 8, causal=False) == 4 * 2 * 8 * 16
    assert roofline.attention_bwd_flops(2, 4, 8) == 2.5 * 4 * 2 * 8 * 10
    # Ouro's prefill: 17.59 TFLOP a call
    assert roofline.attention_fwd_flops(16, 65536, 128) == pytest.approx(
        17.59e12, rel=1e-3)


def test_triad_bytes():
    assert roofline.triad_bytes(1) == 12
    n = 31232 * 4096
    assert roofline.triad_bytes(n) == 1_535_115_264
    assert roofline.triad_bound(H100, n) * 1e3 == pytest.approx(0.4582,
                                                                abs=1e-4)


def test_bus_factor():
    assert roofline.allreduce_bus_factor(1) == 0
    assert roofline.allreduce_bus_factor(2) == 1
    assert roofline.allreduce_bus_factor(4) == 1.5
    assert roofline.allreduce_bus_bytes(256_000_000, 4) == 384_000_000
