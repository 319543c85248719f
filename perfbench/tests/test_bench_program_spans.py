"""The port records its own ``tpu_operator_torch.*`` spans while a profiler
runs. The trace reader keeps only the harness's ``perfbench.*`` spans, so
the port's spans move nothing the benchmark reads: no device operation
ties to them, no idle gap is named by them, and every per-layer reader
reads exactly what it reads on the same trace without them.

The trace is written by hand: one window of 1000 us holding a forward
(copies under the fold and the align, B2, a copy under the unfold), a
backward (the recompute, then a gradient copy outside it), an all-reduce
step (the NCCL kernel, then the scale) and a triad, with idle gaps under
the align, the harness's sync, the backward's recompute and the window
alone."""

import json

import pytest

from perfbench import manifest, roofline, trace

H = "perfbench."
P = "tpu_operator_torch."

# (name, host start, host end), in us
HARNESS = [("window", 0, 1000), ("call", 0, 400), ("fwd", 10, 390),
           ("sync", 390, 400), ("bwd", 400, 700), ("step", 700, 880),
           ("triads", 881, 899)]
PROGRAM = [("flash_attention", 20, 380), ("flash_attention.fold", 22, 32),
           ("flash_attention_blocks", 35, 300),
           ("flash_attention_blocks.align", 40, 60),
           ("flash_attention_blocks.launch", 200, 290),
           ("flash_attention.unfold", 300, 320), ("flash_bwd", 420, 680),
           ("collectives.step", 710, 870), ("collectives.reduce", 720, 760),
           ("collectives.scale", 770, 800), ("triad_", 882, 888)]
# (kernel, host launch, device start, device end)
KERNELS = [("elementwise_kernel (copy q)", 30, 100, 110),
           ("elementwise_kernel (copy k)", 45, 110, 120),
           ("elementwise_kernel (copy v)", 55, 120, 130),
           ("void flash_fwd<128>(Params)", 250, 130, 330),
           ("elementwise_kernel (unfold copy)", 310, 330, 335),
           ("sm80_xmma_gemm_f32f32", 430, 450, 600),
           ("elementwise_kernel (grad copy)", 690, 600, 640),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 730, 700, 780),
           ("vectorized_elementwise_kernel (mul)", 780, 780, 800),
           ("triad_vec4", 885, 800, 810)]
FACTS = {"bh": 16, "seq": 4096, "head_dim": 128,
         "model_flops_per_call": 1e9, "elements": 1 << 20, "itemsize": 4,
         "world": 4, "bytes": 1 << 24}
# the readers the benchmark had when the port first recorded spans: each
# reads a value on the hand-written trace
HARNESS_READERS = ("attn_mfu", "b2_roofline", "attn_wrap_share", "bwd_ms",
                   "b1_roofline", "nccl_link_share", "allreduce_scale_share",
                   "idle_pct.attn", "idle_pct.proof")
PER_LAYER = [m["name"] for m in manifest.load_benchmark()["per_layer"]]


def _events(program=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": H + n, "ts": a,
           "dur": b - a} for n, a, b in HARNESS]
    if program:
        ev += [{"ph": "X", "cat": "user_annotation", "name": P + n,
                "ts": a, "dur": b - a} for n, a, b in PROGRAM]
    for corr, (name, host, d0, d1) in enumerate(KERNELS, 1):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": host, "dur": 2,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": d0,
                   "dur": d1 - d0, "args": {"correlation": corr}})
    if program:
        # the device-side copy of a span, as the profiler writes it
        ev.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": P + "flash_attention", "ts": 100, "dur": 235})
    return ev


def _read(tmp_path, program=True, steps=2):
    path = tmp_path / f"trace-{int(program)}.json"
    path.write_text(json.dumps({"traceEvents": _events(program)}))
    return trace.read_chrome_trace(str(path), steps, dict(FACTS),
                                   roofline.H100_SXM)


def test_ops_tie_to_the_harness_spans_alone(tmp_path):
    t = _read(tmp_path)
    assert t.tied == len(KERNELS)
    spans = {op.name: set(op.spans) for op in t.ops}
    assert spans["void flash_fwd<128>(Params)"] == {
        H + "window", H + "call", H + "fwd"}
    assert spans["vectorized_elementwise_kernel (mul)"] == {
        H + "window", H + "step"}
    assert not any(s.startswith(P) for ss in spans.values() for s in ss)


def test_gaps_are_named_by_the_harness_spans_alone(tmp_path):
    with_spans, without = _read(tmp_path), _read(tmp_path, program=False)
    assert with_spans.busy_s == pytest.approx(535e-6)
    assert with_spans.window_s == pytest.approx(1000e-6)
    got = [(n, round(s * 1e6, 6)) for n, s in with_spans.gaps]
    assert got == [(H + "window", 190.0), (H + "sync", 115.0),
                   (H + "fwd", 100.0), (H + "bwd", 60.0)]
    assert with_spans.gaps == without.gaps
    assert with_spans.busy_s == without.busy_s
    assert with_spans.window_s == without.window_s
    assert [(o.name, o.start, o.dur, o.spans) for o in with_spans.ops] == [
        (o.name, o.start, o.dur, o.spans) for o in without.ops]
    assert with_spans.top_ops() == without.top_ops()


def test_the_harness_readers_are_in_the_benchmark():
    assert set(HARNESS_READERS) <= set(PER_LAYER)


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_reads_the_same_with_and_without_program_spans(tmp_path,
                                                              name):
    """The guard: every per-layer reader, those added later too, reads
    exactly the same value on the trace with and without the port's
    ``tpu_operator_torch.*`` events."""
    read = manifest.layer_reader(name)
    a, b = read(_read(tmp_path)), read(_read(tmp_path, program=False))
    assert a == b
    if name in HARNESS_READERS:
        assert a is not None
