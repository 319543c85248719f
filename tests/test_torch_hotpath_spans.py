"""The port's hot-path spans: ``backend.span`` records
``tpu_operator_torch.*`` spans only while ``torch.profiler`` runs, and
``flash_attention`` (with its backward), ``triad_`` and
``collectives._step`` record the spans an operator reads in the
profiler's trace, nested as the code nests them."""

import json

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import backend, collectives, hbm_probe
from tpu_operator_torch.workloads import flashattention as fa

P = backend.SPAN_PREFIX


def _qkv(seed=0, shape=(2, 48, 2, 16)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, requires_grad=True)
            for _ in range(3)]


def _attend(q, k, v):
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(torch.ones_like(out))
    return out.detach(), q.grad, k.grad, v.grad


def _traced(fn, tmp_path):
    """``fn()``'s result and the program's spans in the exported trace:
    (name, start, end), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith(P)]
    return res, sorted(spans, key=lambda s: s[1])


def _one(spans, name):
    found = [s for s in spans if s[0] == P + name]
    assert len(found) == 1, (name, spans)
    return found[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def one_rank_group():
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{mesh.free_port()}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    assert backend.span("a") is backend.span("b")
    _attend(*_qkv())
    hbm_probe.triad_(torch.zeros(4, 8), torch.ones(4, 8))
    assert entered == []


def test_span_under_a_profiler_is_a_named_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = backend.span("x")
    assert isinstance(s, torch.profiler.record_function)
    assert s.name == "tpu_operator_torch.x"
    assert s is not backend.span("x")


def test_flash_attention_forward_spans_nest(tmp_path):
    q, k, v = _qkv()
    with torch.no_grad():
        _, spans = _traced(lambda: fa.flash_attention(q, k, v), tmp_path)
    whole = _one(spans, "flash_attention")
    fold = _one(spans, "flash_attention.fold")
    blocks = _one(spans, "flash_attention_blocks")
    unfold = _one(spans, "flash_attention.unfold")
    for part in (fold, blocks, unfold):
        assert _inside(part, whole)
    assert fold[2] <= blocks[1] and blocks[2] <= unfold[1]
    # the CPU path runs the plain version: nothing is launched
    assert not [s for s in spans if s[0].endswith(".launch")]
    assert {s[0] for s in spans} == {P + "flash_attention",
                                     P + "flash_attention.fold",
                                     P + "flash_attention_blocks",
                                     P + "flash_attention.unfold"}


def test_flash_attention_backward_span(tmp_path):
    _, spans = _traced(lambda: _attend(*_qkv()), tmp_path)
    bwd = _one(spans, "flash_bwd")
    fwd = _one(spans, "flash_attention")
    assert fwd[2] <= bwd[1]
    assert not _inside(bwd, fwd)


def test_triad_span(tmp_path):
    a, b = torch.zeros(4, 8), torch.ones(4, 8)
    _, spans = _traced(lambda: [hbm_probe.triad_(a, b, alpha=0.5)
                                for _ in range(3)], tmp_path)
    assert [s[0] for s in spans] == [P + "triad_"] * 3
    assert torch.equal(a, torch.full((4, 8), 1.5))


@pytest.mark.parametrize("op, parts", [
    ("all_reduce", ["collectives.reduce", "collectives.scale"]),
    ("reduce_scatter", ["collectives.reduce", "collectives.scale",
                        "collectives.reduce"]),
    ("all_gather", ["collectives.reduce"]),
])
def test_collectives_step_spans(one_rank_group, tmp_path, op, parts):
    c = torch.arange(8, dtype=torch.float32)
    _, spans = _traced(lambda: collectives._step(op, c, 1, 0), tmp_path)
    step = _one(spans, "collectives.step")
    inner = [s for s in spans if s is not step]
    assert [s[0] for s in inner] == [P + p for p in parts]
    assert all(_inside(s, step) for s in inner)


def test_no_span_nests_inside_itself(one_rank_group, tmp_path):
    def everything():
        _attend(*_qkv())
        hbm_probe.triad_(torch.zeros(4, 8), torch.ones(4, 8))
        collectives._chain("all_reduce", torch.ones(8), 1, 0, 3)

    _, spans = _traced(everything, tmp_path)
    by = {}
    for name, t0, t1 in spans:
        by.setdefault(name, []).append((t0, t1))
    assert len(by) == 9
    for name, iv in by.items():
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            assert e0 <= s1, name


def test_outputs_bit_equal_with_and_without_a_profiler(one_rank_group):
    def run():
        outs = list(_attend(*_qkv(seed=3)))
        a = torch.arange(32, dtype=torch.float32).reshape(4, 8)
        outs.append(hbm_probe.triad_(a, torch.full((4, 8), -2.0), 0.25))
        c = torch.arange(8, dtype=torch.float32)
        outs.append(collectives._step("reduce_scatter", c, 1, 0))
        outs.append(collectives._step("all_reduce", c, 1, 0))
        return outs

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert len(plain) == len(traced) == 7
    for x, y in zip(plain, traced):
        assert torch.equal(x, y)
