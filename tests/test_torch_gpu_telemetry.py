"""Chip telemetry of the port (tpu_operator_torch.metrics.gpu_exporter and
csrc/gpu_telemetry.cc) against the JAX package's libtpu exporter, on the
CPU. ``gpu-telemetry`` is built with the host compiler against a fake
``libnvidia-ml.so.1`` that this file compiles from C: its JSON contract,
its exit codes and its ``--watch`` ticks. The port's samples go through
the reference's health engine (``sample_to_dict``, ``evaluate_chip``),
the port's ``collect_remote`` reads a reference ``HealthEngine`` server,
and the two exporters' gauges agree under the renames. The inventory's
NVLink facts (``--inventory``: active links and what each reaches, NVLink
peers, the fabric registration) are parsed into the device plugin's
``Card`` and classified by ``state.nodepool.topology_of``; each call NVML
refuses, or the library lacks, is reported as missing with its code."""

import json
import os
import subprocess
import threading
import time

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tpu_operator.metrics import health_engine
from tpu_operator.metrics import libtpu_exporter as ref
from tpu_operator_torch.deviceplugin import plugin
from tpu_operator_torch.kernels import build
from tpu_operator_torch.metrics import gpu_exporter as exp
from tpu_operator_torch.state.nodepool import topology_of

# a fake NVML: FAKE_NVML_CARDS cards (default 2), FAKE_NVML_INIT_FAIL
# fails nvmlInit_v2, FAKE_NVML_UNSUPPORTED names the queries that answer
# NOT_SUPPORTED (3): "memory", "utilization", "temperature", "nvlink",
# "remote", "fabric"; "p2p" answers NO_PERMISSION (4). The inventory's
# NVLink facts: FAKE_NVML_LINK_COUNT links a card (default 18; a link past
# it is INVALID_ARGUMENT), the first FAKE_NVML_LINKS of them active
# (default all), each reaching FAKE_NVML_REMOTE (NVML's device type,
# default 2, an NVSwitch); cards are NVLink peers when links are active;
# the fabric is registered (v3 layout, or v2 alone under
# FAKE_NVML_FABRIC_V2) with a zero cluster UUID, or under FAKE_NVML_CLUSTER
# a cluster's. Built with -DNO_NVLINK it lacks those four entry points.
FAKE_NVML_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
typedef struct { unsigned long long total, free, used; } mem_t;
typedef struct { unsigned int gpu, memory; } util_t;
static int refused(const char* what) {
  const char* s = getenv("FAKE_NVML_UNSUPPORTED");
  return s && strstr(s, what) ? 3 : 0;
}
int nvmlInit_v2(void) { return getenv("FAKE_NVML_INIT_FAIL") ? 9 : 0; }
int nvmlShutdown(void) { return 0; }
const char* nvmlErrorString(int rc) {
  return rc == 3 ? "Not Supported" : rc ? "Driver Not Loaded" : "Success";
}
int nvmlDeviceGetCount_v2(unsigned int* n) {
  const char* s = getenv("FAKE_NVML_CARDS");
  *n = s ? (unsigned) atoi(s) : 2;
  return 0;
}
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  *h = (void*) (unsigned long) (i + 1);
  return 0;
}
static unsigned int index_of(void* h) { return (unsigned) (unsigned long) h - 1; }
int nvmlDeviceGetMemoryInfo(void* h, mem_t* m) {
  if (refused("memory")) return 3;
  m->total = (80ULL << 30) + index_of(h);
  m->used = (index_of(h) + 1ULL) << 30;
  m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void* h, util_t* u) {
  if (refused("utilization")) return 3;
  u->gpu = 30 + index_of(h);
  u->memory = 7;
  return 0;
}
int nvmlDeviceGetTemperature(void* h, int sensor, unsigned int* t) {
  if (refused("temperature")) return 3;
  *t = sensor == 0 ? 40 + index_of(h) : 0;
  return 0;
}
int nvmlSystemGetDriverVersion(char* v, unsigned int n) {
  snprintf(v, n, "580.159.03");
  return 0;
}
int nvmlDeviceGetUUID(void* h, char* v, unsigned int n) {
  snprintf(v, n, "GPU-fake-%u", index_of(h));
  return 0;
}
int nvmlDeviceGetMinorNumber(void* h, unsigned int* m) {
  *m = index_of(h);
  return 0;
}
int nvmlDeviceGetName(void* h, char* v, unsigned int n) {
  snprintf(v, n, "NVIDIA H100 80GB HBM3");
  return 0;
}
#ifndef NO_NVLINK
static unsigned int env_or(const char* name, unsigned int fallback) {
  const char* s = getenv(name);
  return s ? (unsigned) atoi(s) : fallback;
}
int nvmlDeviceGetNvLinkState(void* h, unsigned int link, int* active) {
  if (refused("nvlink")) return 3;
  if (link >= env_or("FAKE_NVML_LINK_COUNT", 18)) return 2;
  *active = link < env_or("FAKE_NVML_LINKS", 18);
  return 0;
}
int nvmlDeviceGetNvLinkRemoteDeviceType(void* h, unsigned int link, int* t) {
  if (refused("remote")) return 3;
  *t = (int) env_or("FAKE_NVML_REMOTE", 2);
  return 0;
}
int nvmlDeviceGetP2PStatus(void* a, void* b, int index, int* status) {
  if (refused("p2p")) return 4;
  *status = index == 2 && env_or("FAKE_NVML_LINKS", 18) > 0 ? 0 : 5;
  return 0;
}
typedef struct {
  unsigned int version;
  unsigned char cluster_uuid[16];
  int status;
  unsigned int clique_id;
  unsigned char state;
  unsigned int health_mask;
  unsigned char health_summary;
} fabric_t;
int nvmlDeviceGetGpuFabricInfoV(void* h, fabric_t* f) {
  if (refused("fabric")) return 3;
  unsigned int want = getenv("FAKE_NVML_FABRIC_V2") ? 36u | (2u << 24)
                                                    : 40u | (3u << 24);
  if (f->version != want) return 25;
  int cluster = getenv("FAKE_NVML_CLUSTER") != NULL;
  for (int i = 0; i < 16; ++i) f->cluster_uuid[i] = cluster ? 0x10 + i : 0;
  f->status = 0;
  f->clique_id = cluster ? 7 : 0;
  f->state = 3;
  return 0;
}
#endif
"""

CARD = "NVIDIA H100 80GB HBM3"
GAUGE_RENAMES = {
    "tpu_duty_cycle_percent": "gpu_duty_cycle_percent",
    "tpu_hbm_used_bytes": "gpu_hbm_used_bytes",
    "tpu_hbm_total_bytes": "gpu_hbm_total_bytes",
    "tpu_hbm_usage_known": "gpu_hbm_usage_known",
    "tpu_tensorcore_utilization_percent": "gpu_tensorcore_utilization_percent",
    "tpu_temperature_celsius": "gpu_temperature_celsius",
    "tpu_chips_total": "gpu_chips_total",
}
FIELDS = ("chip_id", "duty_cycle_pct", "hbm_used", "hbm_total",
          "tensorcore_util_pct", "temperature_c", "hbm_usage_known")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(gpu-telemetry, fake NVML, the fake without NVLink entry points):
    the scraper built by ``build_host`` into a private build directory."""
    d = tmp_path_factory.mktemp("telemetry")
    src = d / "fake_nvml.c"
    src.write_text(FAKE_NVML_C)
    lib = d / "libnvidia-ml.so.1"
    old = d / "old" / "libnvidia-ml.so.1"
    old.parent.mkdir()
    for out, flags in ((lib, []), (old, ["-DNO_NVLINK"])):
        subprocess.run([build.find_cxx(), "-x", "c", "-shared", "-fPIC",
                        *flags, "-o", str(out), str(src)], check=True,
                       capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "BUILD_DIR", d / "kernels")
        binary = build.build_host("gpu_telemetry").path
    return str(binary), str(lib), str(old)


@pytest.fixture
def env(monkeypatch, built):
    binary, lib, _ = built
    for k in ("GPU_FAKE_CHIPS", "TPU_FAKE_CHIPS", "GPU_TELEMETRY_WATCH",
              "GPU_HEALTH_ENGINE_INFO", "GPU_EXPORTER_USE_TORCH",
              "FAKE_NVML_CARDS", "FAKE_NVML_INIT_FAIL",
              "FAKE_NVML_UNSUPPORTED", "FAKE_NVML_LINK_COUNT",
              "FAKE_NVML_LINKS", "FAKE_NVML_REMOTE", "FAKE_NVML_FABRIC_V2",
              "FAKE_NVML_CLUSTER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GPU_TELEMETRY_BIN", binary)
    monkeypatch.setenv("GPU_TELEMETRY_NVML", lib)
    return binary, lib


def scrape(binary, *args):
    return subprocess.run([binary, *args], capture_output=True, text=True,
                          timeout=10)


def fields(s):
    return tuple(getattr(s, f) for f in FIELDS)


# --- the scraper -------------------------------------------------------------


def test_json_contract(env):
    binary, _ = env
    out = scrape(binary)
    assert out.returncode == 0
    rows = json.loads(out.stdout)
    assert rows == [{"chip_id": f"gpu{i}", "duty_cycle_pct": 30 + i,
                     "hbm_used_bytes": (i + 1) << 30,
                     "hbm_total_bytes": (80 << 30) + i,
                     "hbm_usage_known": True, "tensorcore_util_pct": 0,
                     "temperature_c": 40.0 + i} for i in range(2)]
    # the reference's row keys, in the reference's order
    ref_keys = ["chip_id", "duty_cycle_pct", "hbm_used_bytes",
                "hbm_total_bytes", "hbm_usage_known", "tensorcore_util_pct",
                "temperature_c"]
    assert all(list(r) == ref_keys for r in rows)
    assert out.stderr == ""


@pytest.mark.parametrize("setting", [
    {"GPU_TELEMETRY_NVML": "/nonexistent/libnvidia-ml.so.1"},
    {"FAKE_NVML_INIT_FAIL": "1"},
    {"FAKE_NVML_CARDS": "0"},
], ids=["no-nvml", "init-fails", "no-card"])
def test_exit_1_without_a_card(env, monkeypatch, setting):
    for k, v in setting.items():
        monkeypatch.setenv(k, v)
    out = scrape(env[0])
    assert out.returncode == 1 and json.loads(out.stdout) == []


def test_nvml_path_flag_overrides_the_env(env, monkeypatch):
    binary, lib = env
    monkeypatch.setenv("GPU_TELEMETRY_NVML", "/nonexistent/lib.so")
    assert scrape(binary, "--nvml", lib).returncode == 0


@pytest.mark.parametrize("refused, row", [
    ("temperature", {"temperature_c": None}),
    ("memory", {"hbm_used_bytes": 0, "hbm_total_bytes": 0,
                "hbm_usage_known": False}),
    ("utilization", {"duty_cycle_pct": 0}),
])
def test_not_supported_is_reported_not_invented(env, monkeypatch, refused,
                                                row):
    monkeypatch.setenv("FAKE_NVML_UNSUPPORTED", refused)
    monkeypatch.setenv("FAKE_NVML_CARDS", "1")
    out = scrape(env[0])
    assert out.returncode == 0
    got = json.loads(out.stdout)[0]
    for k, v in row.items():
        assert got[k] == v, k
    assert "Not Supported (3)" in out.stderr
    # the reference's parser reads it as the reference's missing counter
    s = ref._rows_to_samples(json.loads(out.stdout))[0]
    p = exp._rows_to_samples(json.loads(out.stdout))[0]
    assert fields(p) == fields(s)


def test_watch_ticks_and_survives_empty_ticks(env, monkeypatch):
    binary, _ = env
    monkeypatch.setenv("FAKE_NVML_CARDS", "1")
    for nvml, cards in ((None, 1), ("/nonexistent/lib.so", 0)):
        cmd = [binary, "--watch", "1"] + (["--nvml", nvml] if nvml else [])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            t0 = time.monotonic()
            lines = [proc.stdout.readline() for _ in range(2)]
            # two ticks of 1 s, with room for a loaded host
            assert time.monotonic() - t0 < 15
            assert proc.poll() is None  # still running after an empty tick
        finally:
            proc.terminate()
            proc.wait(5)
        assert [len(json.loads(line)) for line in lines] == [cards, cards]


# --- the inventory's NVLink facts --------------------------------------------

ZERO_UUID = "00000000-0000-0000-0000-000000000000"
CLUSTER_UUID = "10111213-1415-1617-1819-1a1b1c1d1e1f"


def inventory_cards(binary):
    out = scrape(binary, "--inventory")
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)["cards"], out.stderr


def test_inventory_nvlink_facts(env):
    cards, stderr = inventory_cards(env[0])
    assert [c["chip_id"] for c in cards] == ["gpu0", "gpu1"]
    for i, c in enumerate(cards):
        assert c["nvlink"] == [{"link": ln, "remote": "nvswitch"}
                               for ln in range(18)]
        assert c["nvlink_peers"] == [f"gpu{1 - i}"]
        assert c["fabric"] == {"cluster_uuid": ZERO_UUID, "clique_id": 0,
                               "state": "completed", "status": 0}
        assert c["refused"] == {}
    assert stderr == ""


@pytest.mark.parametrize("setting, links, fabric, topology", [
    ({}, [(ln, "nvswitch") for ln in range(18)], ZERO_UUID, "nvswitch-2"),
    ({"FAKE_NVML_LINK_COUNT": "12", "FAKE_NVML_LINKS": "4",
      "FAKE_NVML_REMOTE": "0"}, [(ln, "gpu") for ln in range(4)],
     ZERO_UUID, "nvlink-2"),
    ({"FAKE_NVML_LINKS": "0"}, [], ZERO_UUID, "pcie-2"),
    ({"FAKE_NVML_CLUSTER": "1", "FAKE_NVML_FABRIC_V2": "1"},
     [(ln, "nvswitch") for ln in range(18)], CLUSTER_UUID, "mnnvl-2"),
], ids=["nvswitch", "bridges", "no-link", "cluster-v2-layout"])
def test_inventory_is_parsed_and_classified(env, monkeypatch, setting,
                                            links, fabric, topology):
    for k, v in setting.items():
        monkeypatch.setenv(k, v)
    inv = plugin.card_inventory()
    assert [c.uuid for c in inv.cards] == ["GPU-fake-0", "GPU-fake-1"]
    for c in inv.cards:
        assert c.nvlink == tuple(links)
        assert c.fabric.cluster_uuid == fabric
        assert c.fabric.spans_hosts == (fabric == CLUSTER_UUID)
        assert c.refused == ()
    assert inv.cards[0].nvlink_peers == (("gpu1",) if links else ())
    assert topology_of(inv) == topology


@pytest.mark.parametrize("refused, missing, call, code, topology", [
    ("nvlink", "nvlink", "nvmlDeviceGetNvLinkState", 3, None),
    ("remote", None, "nvmlDeviceGetNvLinkRemoteDeviceType", 3, None),
    ("p2p", "nvlink_peers", "nvmlDeviceGetP2PStatus", 4, "nvswitch-2"),
    ("fabric", "fabric", "nvmlDeviceGetGpuFabricInfoV", 3, "nvswitch-2"),
])
def test_nvlink_refusals_are_reported_not_invented(env, monkeypatch, refused,
                                                   missing, call, code,
                                                   topology):
    monkeypatch.setenv("FAKE_NVML_UNSUPPORTED", refused)
    cards, stderr = inventory_cards(env[0])
    for c in cards:
        assert c["refused"] == {call: code}
        if missing:
            assert c[missing] is None
        else:  # the links are known, what they reach is not
            assert {ln["remote"] for ln in c["nvlink"]} == {None}
    assert f"{call}: " in stderr and f"({code})" in stderr
    assert topology_of(plugin.card_inventory()) == topology


def test_a_library_without_the_nvlink_calls(env, monkeypatch, built):
    monkeypatch.setenv("GPU_TELEMETRY_NVML", built[2])
    cards, stderr = inventory_cards(env[0])
    absent = {"nvmlDeviceGetNvLinkState": None,
              "nvmlDeviceGetP2PStatus": None,
              "nvmlDeviceGetGpuFabricInfoV": None}
    assert [(c["nvlink"], c["nvlink_peers"], c["fabric"], c["refused"])
            for c in cards] == [(None, None, None, absent)] * 2
    inv = plugin.card_inventory()
    assert [c.refused for c in inv.cards] == [tuple(absent.items())] * 2
    assert topology_of(inv) is None


# --- the samples against the reference's health engine -----------------------


def test_samples_feed_the_reference_health_engine(env, monkeypatch):
    monkeypatch.setenv("FAKE_NVML_CARDS", "3")
    port = exp.collect_native()
    rows = json.loads(scrape(env[0]).stdout)
    want = ref._rows_to_samples(rows)
    assert [fields(p) for p in port] == [fields(s) for s in want]
    for p, s in zip(port, want):
        assert health_engine.sample_to_dict(p) == \
            health_engine.sample_to_dict(s)
        assert health_engine.evaluate_chip(p) == health_engine.evaluate_chip(s)
    # and back: the engine's dict is a port sample again
    d = health_engine.sample_to_dict(port[0])
    assert fields(exp.sample_from_dict(d)) == fields(port[0])


@pytest.mark.parametrize("sample, status", [
    (dict(temperature_c=95.0), "fail"),
    (dict(temperature_c=80.0), "warn"),
    (dict(hbm_used=79 << 30, hbm_total=80 << 30), "warn"),
    (dict(hbm_used=0, hbm_total=80 << 30, hbm_usage_known=False), "ok"),
])
def test_health_rules_read_port_samples(sample, status):
    p = exp.ChipSample("gpu0", **sample)
    r = ref.ChipSample("gpu0", **sample)
    assert health_engine.evaluate_chip(p) == health_engine.evaluate_chip(r)
    assert health_engine.evaluate_chip(p)["status"] == status


def test_collect_remote_reads_a_reference_engine(env, monkeypatch):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "2")
    stop = threading.Event()
    server = health_engine.serve(0, interval=60, stop_event=stop)
    info = f"127.0.0.1:{server.server_address[1]}"
    try:
        want = ref.collect_remote(info)
        got = exp.collect_remote(info)
        monkeypatch.setenv("GPU_HEALTH_ENGINE_INFO", info)
        through_chain = exp.collect()
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
    assert len(got) == 2
    assert [fields(g) for g in got] == [fields(w) for w in want] == \
        [fields(s) for s in through_chain]


# --- the chain and the exporter ----------------------------------------------


def series(text, renamed=False):
    out = {}
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            name, labels = s.name, dict(s.labels)
            if renamed:
                name = GAUGE_RENAMES[name]
                if "chip" in labels:
                    labels["chip"] = labels["chip"].replace("accel", "gpu")
            out[(name, tuple(sorted(labels.items())))] = s.value
    return out


def test_fake_exporters_agree(env, monkeypatch):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "3")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "3")
    r, p = ref.LibtpuExporter("node-0"), exp.GpuExporter("node-0")
    assert r.collect_once() == p.collect_once() == 3
    assert series(p.render().decode()) == \
        series(r.render().decode(), renamed=True)


@pytest.mark.parametrize("samples", [
    [dict(chip_id="gpu0", hbm_used=0, hbm_total=80 << 30,
          hbm_usage_known=False)],
    [dict(chip_id="gpu0", temperature_c=None, duty_cycle_pct=12.0)],
    [],
], ids=["usage-unknown", "no-temperature", "no-card"])
def test_exporters_agree_on_missing_fields(monkeypatch, samples):
    monkeypatch.setattr(ref, "collect",
                        lambda: [ref.ChipSample(**s) for s in samples])
    monkeypatch.setattr(exp, "collect",
                        lambda: [exp.ChipSample(**s) for s in samples])
    r, p = ref.LibtpuExporter("n"), exp.GpuExporter("n")
    r.collect_once()
    p.collect_once()
    assert series(p.render().decode()) == \
        series(r.render().decode(), renamed=True)


def test_a_failed_collection_clears_the_series(env, monkeypatch):
    monkeypatch.setenv("GPU_FAKE_CHIPS", "2")
    p = exp.GpuExporter("n")
    assert p.collect_once() == 2

    def down():
        raise OSError("health engine down")

    monkeypatch.setattr(exp, "collect", down)
    assert p.collect_once() == 0
    got = series(p.render().decode())
    assert got == {("gpu_chips_total", (("node", "n"),)): 0.0}


def test_chain_prefers_fake_then_native(env, monkeypatch):
    monkeypatch.setenv("GPU_FAKE_CHIPS", "1")
    assert [s.chip_id for s in exp.collect_local()] == ["gpu0"]
    assert exp.collect_local()[0].hbm_total == 16 << 30
    monkeypatch.delenv("GPU_FAKE_CHIPS")
    monkeypatch.setenv("FAKE_NVML_CARDS", "2")
    assert [s.hbm_total for s in exp.collect_local()] == [
        (80 << 30) + i for i in range(2)]


def test_chain_reaches_torch_only_where_asked(env, monkeypatch):
    monkeypatch.setenv("GPU_TELEMETRY_NVML", "/nonexistent/lib.so")
    monkeypatch.setattr(exp, "collect_cuda",
                        lambda: [exp.ChipSample("gpu0", hbm_total=1)])
    assert exp.collect_local() == []
    monkeypatch.setenv("GPU_EXPORTER_USE_TORCH", "true")
    assert [s.chip_id for s in exp.collect_local()] == ["gpu0"]


def test_native_falls_through_when_the_binary_is_missing(env, monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("GPU_TELEMETRY_BIN", str(tmp_path / "missing"))
    assert exp.collect_native() == []


def test_default_binary_is_built_at_first_use(env, monkeypatch, tmp_path):
    monkeypatch.delenv("GPU_TELEMETRY_BIN")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    binary = exp.telemetry_binary()
    assert binary.startswith(str(tmp_path / "kernels" / "gpu_telemetry-"))
    assert os.access(binary, os.X_OK)
    assert exp.telemetry_binary() == binary  # built once


def test_watch_engine_serves_the_newest_tick(env, monkeypatch):
    monkeypatch.setenv("GPU_TELEMETRY_WATCH", "1")
    monkeypatch.setenv("FAKE_NVML_CARDS", "2")
    monkeypatch.setattr(exp, "_engine", None)
    engine = exp._watch_engine()
    try:
        assert engine is not None and engine.alive()
        assert exp._watch_engine() is engine  # one engine a process
        deadline = time.monotonic() + 15
        while engine.latest_samples() is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert [s.chip_id for s in exp.collect_native()] == ["gpu0", "gpu1"]
    finally:
        engine.stop()
    assert not engine.alive()


@pytest.mark.parametrize("value", ["", "0", "-1", "soon"])
def test_watch_engine_off(monkeypatch, value):
    monkeypatch.setenv("GPU_TELEMETRY_WATCH", value)
    assert exp._watch_engine() is None


# --- torch.cuda against the reference's JAX collector ------------------------


class FakeJaxDevice:
    platform, device_kind = "gpu", CARD

    def __init__(self, i, stats):
        self.id, self._stats = i, stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [
    {"bytes_limit": 80 << 30, "bytes_in_use": 3 << 30},
    {},
], ids=["observable", "unobservable"])
def test_collect_cuda_follows_collect_jax(monkeypatch, stats):
    import jax
    import torch

    monkeypatch.setattr(jax, "devices", lambda: [FakeJaxDevice(0, stats)])
    want = ref.collect_jax()[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: CARD)

    def mem_get_info(i):
        if not stats:
            raise RuntimeError("no memory accounting")
        return stats["bytes_limit"] - stats["bytes_in_use"], \
            stats["bytes_limit"]

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    got = exp.collect_cuda()[0]
    assert got.chip_id == "gpu0"
    assert got.hbm_usage_known == want.hbm_usage_known == bool(stats)
    assert got.hbm_used == want.hbm_used
    if stats:
        assert got.hbm_total == want.hbm_total
    else:
        # the data sheet's capacity: the H100's 80 GB, where the
        # reference's is the TPU's
        assert got.hbm_total == 80 << 30


def test_collect_cuda_without_a_card_is_empty(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert exp.collect_cuda() == []
