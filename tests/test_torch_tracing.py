"""The port's lineage plane against the JAX package's: the same scripted
traces under one stepped clock give equal ``to_dict()`` trees (ring,
pinned failed and slowest traces included); ``TracingClient`` tags reads
``source=cache`` over a ``CachedClient`` and ``source=api`` over a bare
``FakeClient``, in both packages; the timeline rings keep the same
events; and ``SLOEngine.evaluate`` over the same observations gives the
same report (descriptions through the name map)."""

import threading

import pytest
from prometheus_client import CollectorRegistry, Counter, Histogram

from tpu_operator.metrics import slo as rslo
from tpu_operator.runtime import tracing as rtr
from tpu_operator.runtime import timeline as rtl
from tpu_operator.runtime import workqueue as rwq
from tpu_operator.runtime.cache import CachedClient as RCached
from tpu_operator.runtime.fake import FakeClient as RFake
from tpu_operator_torch.metrics import slo
from tpu_operator_torch.runtime import timeline as tl
from tpu_operator_torch.runtime import tracing as tr
from tpu_operator_torch.runtime import workqueue as wq
from tpu_operator_torch.runtime.cache import CachedClient
from tpu_operator_torch.runtime.fake import FakeClient

REF = (rtr, rtl, rwq, rslo, RFake, RCached)
PORT = (tr, tl, wq, slo, FakeClient, CachedClient)


class Stepped:
    """A clock that advances a fixed step on every read."""

    def __init__(self, step: float = 0.001):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def fresh_lineage():
    """Both packages' process-wide recorders start and end empty."""
    for t, l, s in ((rtr.TRACER, rtl.TIMELINE, rslo.SLO_ENGINE),
                    (tr.TRACER, tl.TIMELINE, slo.SLO_ENGINE)):
        t.reset(enabled=True)
        l.reset(enabled=True)
        s.reset()
    yield
    import time

    for t, l, s in ((rtr.TRACER, rtl.TIMELINE, rslo.SLO_ENGINE),
                    (tr.TRACER, tl.TIMELINE, slo.SLO_ENGINE)):
        t.reset(clock=time.perf_counter, enabled=True)
        l.reset(clock=time.perf_counter, enabled=True)
        s.reset(clock=time.monotonic)


def scripted_traces(trmod, wqmod, n: int = 9, **kw) -> dict:
    """Reconciles of varied shape under a stepped clock: nested spans,
    tags, a DAG-style span_under from a worker thread, failures."""
    t = trmod.Tracer(clock=Stepped(), enabled=True, **kw)
    for i in range(n):
        causes = (wqmod.Cause("watch:MODIFIED", f"DaemonSet/ds-{i}", i - 1),)
        try:
            with t.trace("ctl-a" if i % 3 else "ctl-b", f"key-{i % 4}",
                         queue_wait_s=0.01 * i, causes=causes):
                with t.span("state:one", weight=i) as sp:
                    sp.tags["status"] = "ready"
                    t.tag("hint", i)
                handle = t.current()

                def worker():
                    with t.span_under(handle, "state:two") as sp2:
                        sp2.tags["status"] = "notReady"
                        with t.span("client:get", verb="get"):
                            pass

                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=10)
                for _ in range(i % 4):  # some traces are slower
                    with t.span("pad"):
                        pass
                if i % 4 == 3:
                    raise RuntimeError(f"boom {i}")
        except RuntimeError:
            pass
    return {"traces": t.traces(),
            "failed": t.failed_traces(),
            "slowest": t.slowest_trace(),
            "ctl_a": t.traces(controller="ctl-a", min_ms=2.0, limit=3),
            "errors": t.traces(outcome="error")}


@pytest.mark.parametrize("kw", [{}, {"capacity": 4, "failed_capacity": 1,
                                     "slow_keep": 2}])
def test_scripted_traces_agree(kw):
    ref = scripted_traces(rtr, rwq, **kw)
    port = scripted_traces(tr, wq, **kw)
    assert port == ref
    if kw:  # the ring holds 4, the pins the failed and the slowest
        ids = [t["id"] for t in port["traces"]]
        assert ids[:4] == [8, 7, 6, 5] and 3 in ids and 7 in ids
        assert [t["id"] for t in port["failed"]] == [7]


def test_disabled_tracer_records_nothing():
    for trmod in (rtr, tr):
        t = trmod.Tracer(clock=Stepped(), enabled=False)
        with t.trace("c", "k") as handle:
            assert handle is None
            with t.span("x") as sp:
                assert sp is None
        assert t.traces() == [] and not t.active()
    assert tr.env_trace_enabled({"OPERATOR_TRACE": "0"}) is False


def client_spans(side) -> list:
    """Verbs through TracingClient inside one trace, over a bare fake and
    over a cache: the span names and tags of each verb."""
    trmod, _, _, _, fake_cls, cached_cls = side
    out = []
    for wrap in (False, True):
        fake = fake_cls()
        fake.add_node("n0", labels={"a": "b"})
        inner = cached_cls(fake) if wrap else fake
        t = trmod.Tracer(clock=Stepped(), enabled=True)
        c = trmod.TracingClient(inner, tracer=t)
        with t.trace("ctl", "k"):
            c.get("v1", "Node", "n0")
            c.list("v1", "Node")
            c.create({"apiVersion": "v1", "kind": "ConfigMap",
                      "metadata": {"name": "cm", "namespace": "ns"}})
            c.patch("v1", "Node", "n0", {"metadata": {"labels": {"x": "y"}}})
            c.delete("v1", "ConfigMap", "cm", "ns")
        root = t.traces()[0]["root"]
        out.append([(ch["name"], ch["tags"]) for ch in root["children"]])
        if wrap:
            assert c.cache_reads > 0  # non-verb surface reaches the cache
            inner.close()
    return out


def test_tracing_client_tags_source():
    ref = client_spans(REF)
    port = client_spans(PORT)
    assert port == ref
    bare, cached = port
    assert [tags["source"] for _, tags in bare] == ["api"] * 5
    assert [tags["source"] for _, tags in cached] == ["cache", "cache",
                                                      "api", "api", "api"]
    # evict is a timed verb of the wrapper, as the reference's
    assert "evict" in vars(tr.TracingClient)


def timelines(tlmod, wqmod) -> dict:
    rec = tlmod.TimelineRecorder(max_keys=3, ring=4, clock=Stepped())
    for i in range(14):
        rec.record("Kind", f"obj-{i % 5}", "reconcile" if i % 2 else "enqueue",
                   {"controller": "c", "i": i},
                   causes=(wqmod.Cause("watch:ADDED", "x", i),))
    return {"snapshot": rec.snapshot(), "keys": rec.keys(),
            "one": rec.timeline("Kind", "obj-3"),
            "gone": rec.timeline("Kind", "obj-0")}


def test_timeline_rings_agree():
    ref = timelines(rtl, rwq)
    port = timelines(tl, wq)
    assert port == ref
    assert len(port["keys"]) == 3 and port["gone"] == []
    assert all(len(v) <= 4 for v in port["snapshot"].values())


def slo_reports(slomod) -> list:
    """The default SLOs over a fresh registry holding the series they
    name, fed the same observations, evaluated at stepped times."""
    reg = CollectorRegistry()
    series = {}
    for spec in slomod.DEFAULT_SLOS:
        labels = [k for k, _ in spec.labels]
        if spec.sli == "latency":
            series[spec.name] = Histogram(
                spec.histogram, "h", labels, registry=reg,
                buckets=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0))
        else:
            series[spec.name] = Counter(spec.counter, "c", [spec.label],
                                        registry=reg)
    clock = [0.0]
    engine = slomod.SLOEngine(registry=reg, clock=lambda: clock[0])
    reports = []
    for step, values in enumerate(([0.002, 0.3, 2.0], [0.04] * 5,
                                   [3.0, 3.0], [])):
        for spec in slomod.DEFAULT_SLOS:
            s = series[spec.name]
            if spec.sli == "latency":
                child = s.labels(**dict(spec.labels)) if spec.labels else s
                for v in values:
                    child.observe(v)
            else:
                s.labels(**{spec.label: spec.good[0]}).inc(len(values))
                s.labels(**{spec.label: spec.bad[0]}).inc(step)
        clock[0] += 400.0
        reports.append(engine.evaluate(
            extra_window_s=600.0 if step == 2 else None))
    return reports


def test_slo_engine_agrees():
    ref = slo_reports(rslo)
    port = slo_reports(slo)
    for r in ref + port:
        for s in r["slos"]:
            s["description"] = (s.pop("description")
                                .replace("TPUClusterPolicy", "GPUClusterPolicy")
                                .replace("degraded chips", "degraded cards"))
    assert port == ref
    assert any(s["breached"] for r in port for s in r["slos"])
    assert [s.name for s in slo.DEFAULT_SLOS] == \
        [s.name for s in rslo.DEFAULT_SLOS]
    for a, b in zip(rslo.DEFAULT_SLOS, slo.DEFAULT_SLOS):
        assert b.histogram == a.histogram.replace("tpu_operator_",
                                                  "gpu_operator_")
        assert b.counter == a.counter.replace("tpu_operator_", "gpu_operator_")


def test_burn_verdict_agrees():
    for args in ((0, 0, 0.99, 14.4), (95, 5, 0.99, 14.4), (9, 1, 0.9, 1.0),
                 (1, 0, 0.5, 2.0)):
        assert slo.burn_verdict(*args) == rslo.burn_verdict(*args)
