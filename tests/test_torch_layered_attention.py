"""Grouped KV heads and a sliding window on the port's attention path,
held to the plain float32 reference (``workloads/attention_reference.py``)
on the CPU, where ``flash_attention_blocks`` and ``flash_bwd`` run their
plain versions; kernels B2 and B3 are held to those on the card by
``chip_smoke.py``, whose reading of ptxas's report (every instantiation
of each kernel, MHA and band at both head widths and B2's split and
persistent ones, spill free) is tested last. The JAX package has neither mechanism, so nothing
here imports it.

Tolerances: both sides compute in float32 in another order, which reads
~1e-7 of a tensor's norm here. Each tensor is held to 1e-5 of its norm (a
tensor that is 0 exactly, dq under a window of one key, by its root mean
square) and its worst row [.., D] to 1e-4 of the larger of its norm and
the median row's, so a window one key too wide (a share of about 1/W of each row's
weight moved) fails by orders of magnitude.
"""

import pytest
import torch

from tpu_operator_torch.workloads import attention_reference as ref
from tpu_operator_torch.workloads import flashattention as fa

REL_TOL = 1e-5
ROW_TOL = 1e-4


def _inputs(S, H, Hkv, D=16, B=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g)
    k, v = (torch.randn(B, S, Hkv, D, generator=g) for _ in range(2))
    dout = torch.randn(B, S, H, D, generator=g)
    return q, k, v, dout


def _errors(x, r):
    x, r = x.detach().double(), r.detach().double()
    rows = r.reshape(-1, r.shape[-1])
    d = (x.reshape(-1, r.shape[-1]) - rows).norm(dim=-1)
    n = rows.norm(dim=-1)
    den = torch.clamp(n, min=float(n.median()))
    den = torch.where(den > 0, den, torch.ones_like(den))
    # a gradient that is 0 exactly (dq under a window of one key) is held
    # by its root mean square
    norm = float(r.norm()) or r.numel() ** 0.5
    return float((x - r).norm()) / norm, float((d / den).max())


def _close(x, r) -> bool:
    rel, row = _errors(x, r)
    return rel <= REL_TOL and row <= ROW_TOL


def _port(q, k, v, dout, window):
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*xs, causal=True, window=window)
    out.backward(dout)
    return (out.detach(), *(x.grad for x in xs))


def _fold(t):
    B, S, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, S, D)


@pytest.mark.parametrize("S", [33, 200])
@pytest.mark.parametrize("window", [None, 1, 3, 64, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_attention_matches_the_reference(group, window, S):
    """Forward and gradients through ``flash_attention``; a window of 256
    is at least S, so it equals the causal mask alone."""
    q, k, v, dout = _inputs(S, 2 * group, 2, B=2, seed=S + group)
    got = _port(q, k, v, dout, window)
    want = ref.forward_backward(q, k, v, dout, True, window)
    for name, x, r in zip(("out", "dq", "dk", "dv"), got, want):
        assert x.shape == r.shape, name
        assert _close(x, r), (name, _errors(x, r))
    if window is not None and window >= S:
        plain = ref.forward_backward(q, k, v, dout, True, None)
        for x, r in zip(got, plain):
            assert _close(x, r)


@pytest.mark.parametrize("window", [None, 5, 40])
@pytest.mark.parametrize("group", [1, 4])
def test_blocks_apply_the_window_in_global_positions(group, window):
    """Offsets move the window with the positions: a block of query rows
    at its own offset, and K/V split in two blocks merged by their row
    statistics as the ring merges hops, give the reference's rows."""
    S, q0, split = 120, 50, 70
    q, k, v, _ = _inputs(S, 2 * group, 2, seed=group)
    want = _fold(ref.attention(q, k, v, True, window))
    fq, fk, fv = (_fold(t) for t in (q, k, v))
    # the same positions shifted together: the same answer
    shifted, _, _ = fa.flash_attention_blocks(fq, fk, fv, 1000, 1000,
                                              window=window)
    assert _close(shifted, want)
    # rows q0.. at their own offset, against every key
    rows, _, _ = fa.flash_attention_blocks(fq[:, q0:], fk, fv, q0, 0,
                                           window=window, q_tile=16, chunk=8)
    assert _close(rows, want[:, q0:])
    # keys in two blocks at their offsets, merged
    parts = [fa.flash_attention_blocks(fq, fk[:, a:b], fv[:, a:b], 0, a,
                                       window=window, chunk=32)
             for a, b in ((0, split), (split, S))]
    m = torch.maximum(parts[0][1], parts[1][1])
    acc = torch.zeros_like(fq)
    l = torch.zeros_like(m)
    for o, mi, li in parts:
        w = torch.exp(mi - m) * li
        acc += o * w[..., None]
        l += w
    assert _close(acc / l[..., None], want)


@pytest.mark.parametrize("S, window", [(33, 3), (200, 64), (200, None)])
def test_flash_bwd_sums_dk_dv_over_the_group(S, window):
    """``flash_bwd`` on the folded residuals: dk and dv come back with
    k's and v's head count, each the sum over its group's query heads."""
    q, k, v, dout = _inputs(S, 8, 1, B=2, seed=7)
    fq, fk, fv, fdo = (_fold(t) for t in (q, k, v, dout))
    out, m, l = fa.flash_attention_blocks(fq, fk, fv, 0, 0, window=window)
    dq, dk, dv = fa.flash_bwd(fq, fk, fv, out, m, l, fdo, True, chunk=16,
                              window=window)
    assert dk.shape == fk.shape and dv.shape == fv.shape
    _, rdq, rdk, rdv = ref.forward_backward(q, k, v, dout, True, window)
    for x, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _close(x, _fold(r)), _errors(x, _fold(r))


# Trinity-Mini's period at a small size: three window layers, one full
TRINITY_PERIOD = ("sliding_attention",) * 3 + ("full_attention",)


@pytest.mark.parametrize("layer", range(len(TRINITY_PERIOD)))
def test_trinity_period_small(layer):
    """H 8 over one KV head, a window of 16, 100 positions."""
    window = 16 if TRINITY_PERIOD[layer] == "sliding_attention" else None
    q, k, v, dout = _inputs(100, 8, 1, D=32, seed=100 + layer)
    got = _port(q, k, v, dout, window)
    want = ref.forward_backward(q, k, v, dout, True, window)
    for x, r in zip(got, want):
        assert _close(x, r), _errors(x, r)


def test_a_window_one_key_too_wide_fails():
    """The planted fault: the port run with W + 1 keys, held to the
    reference with W, fails the comparison the other tests pass."""
    q, k, v, dout = _inputs(100, 8, 1, D=32, seed=3)
    wrong = _port(q, k, v, dout, 17)
    want = ref.forward_backward(q, k, v, dout, True, 16)
    for x, r in zip(wrong, want):
        rel, row = _errors(x, r)
        assert rel > 100 * REL_TOL and row > 100 * ROW_TOL
        assert not _close(x, r)


def test_counters():
    """``.window_calls`` and ``.grouped_calls`` count on the CPU path;
    ``.launches`` counts the card's launches only."""
    counters = [(fn, name) for fn in (fa.flash_attention_blocks, fa.flash_bwd)
                for name in ("launches", "window_calls", "grouped_calls")]
    before = {c: getattr(*c) for c in counters}

    def delta():
        return tuple(getattr(*c) - before[c] for c in counters)

    q, k, v, dout = _inputs(40, 4, 2)
    _port(q, k, v, dout, None)                     # grouped, no window
    assert delta() == (0, 0, 1, 0, 0, 1)
    _port(q, k, v, dout, 8)                        # grouped and windowed
    assert delta() == (0, 1, 2, 0, 1, 2)
    q, k, v, dout = _inputs(40, 2, 2)
    _port(q, k, v, dout, 8)                        # windowed only
    assert delta() == (0, 2, 2, 0, 2, 2)
    _port(q, k, v, dout, None)                     # neither
    assert delta() == (0, 2, 2, 0, 2, 2)


@pytest.mark.parametrize("case, match", [
    ("not causal", "needs the causal mask"),
    ("zero window", "whole number of keys"),
    ("float window", "whole number of keys"),
    ("heads", "multiple"),
])
def test_refusals(case, match):
    q, k, v, _ = _inputs(16, 4, 2)
    fq, fk, fv = (_fold(t) for t in (q, k, v))
    kw = dict(causal=True, window=4)
    if case == "not causal":
        kw["causal"] = False
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(q, k, v, **kw)
    elif case == "zero window":
        kw["window"] = 0
    elif case == "float window":
        kw["window"] = 4.0
    elif case == "heads":
        fk, fv = (torch.cat([t, t[:1]]) for t in (fk, fv))   # 4 over 3
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_blocks(fq, fk, fv, 0, 0, **kw)


def test_reference_imports_torch_alone():
    """The reference is plain torch in a file of its own: it imports
    nothing of the port and nothing of JAX."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ref))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "typing", "torch"}, names


def _ptxas(kernel, spills, registers=None):
    """A ptxas -v report of one kernel's instantiations, as nvcc writes it:
    spills by (head width, band) in bytes stored, and registers a thread
    (168 where ``registers`` does not say). B2's and B3's are templated on
    the key and the value width (a width alone, or a (key, value) pair);
    band ``"persistent"`` is B2's persistent kernel, templated on the
    widths alone."""
    lines = []
    for (width, band), stored in spills.items():
        used = (registers or {}).get((width, band), 168)
        d, dv = width if isinstance(width, tuple) else (width, width)
        widths = f"ILi{d}ELi{dv}E"
        if band == "persistent":
            name = f"_ZN12_GLOBAL__N_120{kernel}_persistent{widths}EEvPKv"
        else:
            name = f"_ZN12_GLOBAL__N_19{kernel}{widths}Lb{int(band)}EEEvPKv"
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {stored} bytes spill stores, "
                  f"0 bytes spill loads",
                  f"ptxas info    : Used {used} registers, used 2 barriers"]
    return "\n".join(lines)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
def test_ptxas_report_holds_all_four_instantiations(kernel):
    """``chip_smoke.check_flash_build`` reads each kernel's MHA and band
    instantiations at both head widths, the band one at keys 192 wide over
    values 128 wide (and B2's persistent ones), and fails on a spill in
    any of them, on one missing, or on an MHA instantiation whose
    registers moved from ``FLASH_MHA_REGISTERS``."""
    import chip_smoke

    clean = {(w, b): 0 for w in (64, 128) for b in (False, True)}
    want = ["64", "128", "64.band", "128.band"]
    # both kernels have keys 192 wide over values 128 wide, a band one
    clean[(192, 128), True] = 0
    want.append("192x128.band")
    if kernel == "flash_fwd":
        # B2 alone has a persistent kernel at each width for its calls
        # with a window
        for w in (64, 128, (192, 128)):
            clean[w, "persistent"] = 0
        want += ["64.persistent", "128.persistent", "192x128.persistent"]
    got = chip_smoke.check_flash_build(_ptxas(kernel, clean), kernel)
    assert got == {k: {"spills": (0, 0), "registers": 168} for k in want}
    with pytest.raises(RuntimeError, match="spills"):
        chip_smoke.check_flash_build(
            _ptxas(kernel, {**clean, (128, True): 8}), kernel)
    with pytest.raises(RuntimeError, match="spills"):
        chip_smoke.check_flash_build(
            _ptxas(kernel, {**clean, ((192, 128), True): 56}), kernel)
    if kernel == "flash_fwd":
        with pytest.raises(RuntimeError, match="spills"):
            chip_smoke.check_flash_build(
                _ptxas(kernel, {**clean, ((192, 128), "persistent"): 8}),
                kernel)
    with pytest.raises(RuntimeError, match="registers"):
        chip_smoke.check_flash_build(
            _ptxas(kernel, clean, {(64, False): 176}), kernel)
    # the band instantiations' registers are logged, not held
    got = chip_smoke.check_flash_build(
        _ptxas(kernel, clean, {(128, True): 160}), kernel)
    assert got["128.band"]["registers"] == 160
    del clean[(64, True)]
    with pytest.raises(RuntimeError, match="lacks an instantiation"):
        chip_smoke.check_flash_build(_ptxas(kernel, clean), kernel)
