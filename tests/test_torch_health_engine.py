"""The port's health engine (tpu_operator_torch.metrics.health_engine)
against the JAX package's, case for case: the same samples graded by both
(``evaluate_chip`` over one grid), the engines over each package's fake
host (TPU_FAKE_CHIPS / GPU_FAKE_CHIPS) with a card falling off the bus,
the digest, and ``serve``'s /v1/health (200, or 503 on FAIL), /v1/samples
and /healthz. Card IDs compare under accel<i> -> gpu<i>."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from tpu_operator.metrics import health_engine as rhe
from tpu_operator.metrics import libtpu_exporter as rexp
from tpu_operator.runtime import FakeClient
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.metrics import gpu_exporter as exp
from tpu_operator_torch.metrics import health_engine as he

GIB = 1 << 30


def port(value):
    if isinstance(value, str):
        return value.replace("accel", "gpu")
    if isinstance(value, list):
        return [port(v) for v in value]
    if isinstance(value, dict):
        return {port(k): port(v) for k, v in value.items()}
    return value


@pytest.fixture
def fake_host(monkeypatch):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    for k in ("GPU_HEALTH_ENGINE_INFO", "TPU_HEALTH_ENGINE_INFO",
              "GPU_TELEMETRY_WATCH"):
        monkeypatch.delenv(k, raising=False)


def sample_pair(i, temp, used_frac, known, total=16 * GIB):
    kw = dict(duty_cycle_pct=10.0 * i, hbm_used=int(used_frac * total),
              hbm_total=total, tensorcore_util_pct=5.0,
              temperature_c=temp, hbm_usage_known=known)
    return rexp.ChipSample(f"accel{i}", **kw), exp.ChipSample(f"gpu{i}", **kw)


@pytest.mark.parametrize("temp", [None, 40.0, 74.9, 75.0, 89.9, 90.0, 105.0])
def test_evaluate_chip_grid(temp):
    for used in (0.0, 0.5, 0.9499, 0.95, 1.0):
        for known in (True, False):
            ref, ours = sample_pair(0, temp, used, known)
            assert he.evaluate_chip(ours) == port(rhe.evaluate_chip(ref))
    # a card without a memory total grades on temperature alone
    ref, ours = sample_pair(0, temp, 0.0, True, total=0)
    assert he.evaluate_chip(ours) == port(rhe.evaluate_chip(ref))


def test_samples_round_trip():
    _, ours = sample_pair(3, 61.5, 0.25, False)
    d = he.sample_to_dict(ours)
    assert vars(he.sample_from_dict(d)) == vars(ours)
    ref, _ = sample_pair(3, 61.5, 0.25, False)
    assert d == port(rhe.sample_to_dict(ref))


def engines():
    ref, ours = rhe.HealthEngine(), he.HealthEngine()
    assert ours.collect_once() == ref.collect_once()
    return ref, ours


def test_health_and_samples_on_the_fake_host(fake_host):
    ref, ours = engines()
    assert ours.samples() == port(ref.samples())
    assert ours.health() == port(ref.health())
    assert ours.health()["status"] == "ok"


def test_a_card_off_the_bus_fails_the_node(fake_host, monkeypatch):
    ref, ours = engines()
    monkeypatch.setenv("TPU_FAKE_CHIPS", "3")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "3")
    assert ours.collect_once() == ref.collect_once() == 3
    health = ours.health()
    assert health == port(ref.health())
    assert health["status"] == "fail"
    assert health["reasons"] == ["1 of 4 chips missing"]


@pytest.mark.parametrize("temps", [(40.0, 41.0), (80.0, 41.0),
                                   (95.0, 80.0)], ids=["ok", "warn", "fail"])
def test_digest(monkeypatch, temps):
    pairs = [sample_pair(i, t, 0.3 + 0.1 * i, True)
             for i, t in enumerate(temps)]
    monkeypatch.setattr(rhe, "collect_local", lambda: [p[0] for p in pairs])
    monkeypatch.setattr(he, "collect_local", lambda: [p[1] for p in pairs])
    ref, ours = engines()
    digest = ours.digest("gen-7", 3)
    assert digest == port(ref.digest("gen-7", 3))
    assert digest["v"] == he.DIGEST_SCHEMA_VERSION == 1
    wire = he.digest_annotation(digest)
    assert wire == port(rhe.digest_annotation(ref.digest("gen-7", 3)))
    assert he.parse_digest(wire) == digest


@pytest.mark.parametrize("raw", [None, "", "{", "[1]", '{"v": 2}',
                                 '{"v": 1, "status": "ok"}'])
def test_parse_digest(raw):
    assert he.parse_digest(raw) == rhe.parse_digest(raw)


def test_publish_digests_annotates_the_node(fake_host):
    out = []
    for mod, eng in ((rhe, rhe.HealthEngine()), (he, he.HealthEngine())):
        c = FakeClient()
        c.add_node("n0")
        eng.collect_once()
        stop = threading.Event()
        stop.set()  # one publish, then return
        assert mod.publish_digests(c, "n0", eng, "g", stop_event=stop) == 1
        out.append(c.get("v1", "Node", "n0")["metadata"]["annotations"])
    [(rkey, rval)], [(key, val)] = out[0].items(), out[1].items()
    assert key == L.HEALTH_DIGEST == "gpu.graft.dev/health-digest"
    assert rkey == "tpu.graft.dev/health-digest"
    assert json.loads(val) == port(json.loads(rval))


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("hot", [False, True], ids=["ok-200", "fail-503"])
def test_serve(fake_host, monkeypatch, hot):
    if hot:
        pairs = [sample_pair(0, 95.0, 0.1, True), sample_pair(1, 40.0, 0.1,
                                                               True)]
        monkeypatch.setattr(rhe, "collect_local",
                            lambda: [p[0] for p in pairs])
        monkeypatch.setattr(he, "collect_local",
                            lambda: [p[1] for p in pairs])
    answers = []
    for serve in (rhe.serve, he.serve):
        stop = threading.Event()
        srv = serve(0, interval=3600, stop_event=stop)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            answers.append([get(url + p) for p in
                            ("/v1/health", "/v1/samples", "/healthz",
                             "/nope")])
        finally:
            stop.set()
            srv.shutdown()
            srv.server_close()
    ref, ours = answers
    assert [a[0] for a in ours] == [a[0] for a in ref] == [
        503 if hot else 200, 200, 200, 404]
    for (_, rbody), (_, body) in zip(ref[:2], ours[:2]):
        assert json.loads(body) == port(json.loads(rbody))


def test_the_exporter_reads_the_engine(fake_host, monkeypatch):
    """The exporter's remote backend reads the engine's /v1/samples back
    into the samples the engine holds."""
    stop = threading.Event()
    srv = he.serve(0, interval=3600, stop_event=stop)
    try:
        monkeypatch.setenv("GPU_HEALTH_ENGINE_INFO",
                           f"127.0.0.1:{srv.server_address[1]}")
        got = [he.sample_to_dict(s) for s in exp.collect()]
        assert got == [he.sample_to_dict(s) for s in exp.collect_fake()]
    finally:
        stop.set()
        srv.shutdown()
        srv.server_close()
