"""Per-card telemetry exporter: the DCGM + dcgm-exporter slot.

Counterpart of ``tpu_operator/metrics/libtpu_exporter.py``. Per-card
telemetry as Prometheus gauges (duty cycle, HBM usage, tensor-core
utilisation, temperature), collected through pluggable backends:

- ``fake``:   fixed values for tests and fake clusters (GPU_FAKE_CHIPS)
- ``native``: the ``gpu-telemetry`` scraper over NVML
              (``csrc/gpu_telemetry.cc``), one fork per scrape, or the
              newest tick of its ``--watch`` engine (GPU_TELEMETRY_WATCH)
- ``cuda``:   ``torch.cuda.mem_get_info`` per card, in this process
              (GPU_EXPORTER_USE_TORCH=true)
- ``remote``: a node-local health engine's ``/v1/samples``
              (GPU_HEALTH_ENGINE_INFO=host:port)

The reference's ``sysfs`` backend has no NVIDIA counterpart (NVIDIA's
driver exposes no per-card counters under /sys), so the on-node chain is
fake -> native -> cuda. The exporter holds no CUDA context by default: a
context costs the card's memory and would make the monitor a client of
the card it monitors, which is why DCGM runs as its own host engine.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from prometheus_client import CollectorRegistry, Gauge, generate_latest

log = logging.getLogger("gpu_exporter")

METRICS_PORT = 9400


class ChipSample:
    """One card's sample, under the reference's field names (its health
    engine reads this class's objects as they are)."""

    def __init__(self, chip_id: str, duty_cycle_pct: float = 0.0,
                 hbm_used: int = 0, hbm_total: int = 0,
                 tensorcore_util_pct: float = 0.0,
                 temperature_c: Optional[float] = None,
                 hbm_usage_known: bool = True):
        self.chip_id = chip_id
        self.duty_cycle_pct = duty_cycle_pct
        self.hbm_used = hbm_used
        self.hbm_total = hbm_total
        self.tensorcore_util_pct = tensorcore_util_pct
        self.temperature_c = temperature_c
        # False when the backend exposes no memory accounting and
        # hbm_total is the data sheet's capacity (or 0): a dashboard must
        # tell an idle card (used=0, known) from missing telemetry
        self.hbm_usage_known = hbm_usage_known


def collect_fake() -> List[ChipSample]:
    n = int(os.environ.get("GPU_FAKE_CHIPS", "0") or 0)
    return [ChipSample(f"gpu{i}", duty_cycle_pct=50.0 + i,
                       hbm_used=(i + 1) * (1 << 30), hbm_total=16 << 30,
                       tensorcore_util_pct=40.0 + i, temperature_c=45.0 + i)
            for i in range(n)]


def _rows_to_samples(rows) -> List[ChipSample]:
    return [ChipSample(
        r.get("chip_id", f"gpu{i}"),
        duty_cycle_pct=float(r.get("duty_cycle_pct") or 0),
        hbm_used=int(r.get("hbm_used_bytes") or 0),
        hbm_total=int(r.get("hbm_total_bytes") or 0),
        tensorcore_util_pct=float(r.get("tensorcore_util_pct") or 0),
        temperature_c=(float(r["temperature_c"])
                       if r.get("temperature_c") is not None else None),
        # a row without the field: a nonzero total is the best signal
        hbm_usage_known=bool(r.get(
            "hbm_usage_known",
            int(r.get("hbm_total_bytes") or 0) > 0)))
        for i, r in enumerate(rows)]


def telemetry_binary() -> str:
    """``$GPU_TELEMETRY_BIN``, else ``gpu-telemetry`` built from the
    checkout's ``csrc/gpu_telemetry.cc`` (at its first use)."""
    binary = os.environ.get("GPU_TELEMETRY_BIN")
    if binary:
        return binary
    from ..kernels import build

    return str(build.build_host("gpu_telemetry").path)


class NativeEngine:
    """Long-lived native scraper (``gpu-telemetry --watch N``), DCGM's
    host-engine model: one C++ process owns the NVML session and streams
    a JSON array per tick; a reader thread keeps the newest line, so a
    scrape never forks or blocks on NVML."""

    def __init__(self, binary: str, interval_s: int):
        self._interval = max(1, int(interval_s))
        self._proc = subprocess.Popen(
            [binary, "--watch", str(self._interval)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._latest: Optional[str] = None
        self._latest_at = 0.0
        self.ticks = 0  # lines read so far
        self._lock = threading.Lock()
        threading.Thread(target=self._reader, daemon=True,
                         name="gpu-telemetry-engine").start()

    def _reader(self):
        assert self._proc.stdout is not None
        for line in self._proc.stdout:
            with self._lock:
                self._latest = line
                self._latest_at = time.monotonic()
                self.ticks += 1

    def alive(self) -> bool:
        return self._proc.poll() is None

    def latest_samples(self) -> Optional[List[ChipSample]]:
        """The newest tick's samples ([] is an authoritative empty scan);
        None when nothing parseable arrived yet or the last tick is
        stale: an alive but silent engine (blocked in a driver call on a
        wedged card) must not serve frozen values forever."""
        with self._lock:
            line, at = self._latest, self._latest_at
        if not line:
            return None
        if time.monotonic() - at > max(3.0 * self._interval, 10.0):
            return None  # stale: fall through to the bounded one-shot
        try:
            return _rows_to_samples(json.loads(line))
        except (json.JSONDecodeError, TypeError, ValueError,
                AttributeError):
            return None

    def stop(self):
        try:
            self._proc.terminate()
            self._proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            self._proc.kill()
            self._proc.wait(timeout=5)


_engine: Optional[NativeEngine] = None
_engine_lock = threading.Lock()


def _watch_engine() -> Optional[NativeEngine]:
    """The process-wide engine, started at first use when
    GPU_TELEMETRY_WATCH is a positive number of seconds. A dead engine
    is dropped so collection falls through to the one-shot path."""
    global _engine
    secs = os.environ.get("GPU_TELEMETRY_WATCH", "")
    try:
        interval = int(float(secs)) if secs else 0
    except ValueError:
        return None
    if interval <= 0:  # unset, "0" or negative: engine off
        return None
    with _engine_lock:
        if _engine is not None and _engine.alive():
            return _engine
        try:
            _engine = NativeEngine(telemetry_binary(), interval)
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            log.warning("gpu-telemetry engine not started: %s", e)
            _engine = None
        return _engine


def collect_native() -> List[ChipSample]:
    """The preferred on-node backend: the ``gpu-telemetry`` scraper over
    NVML. With GPU_TELEMETRY_WATCH set, the newest tick of the persistent
    engine; otherwise one fork per scrape. Empty when the binary cannot
    be built or run, or sees no card: callers fall through."""
    engine = _watch_engine()
    if engine is not None:
        samples = engine.latest_samples()
        if samples is not None:
            return samples  # [] is an authoritative empty scan
        # no fresh tick yet (start-up, or a wedged engine): one-shot below
    try:
        out = subprocess.run([telemetry_binary()], capture_output=True,
                             timeout=10, text=True)
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        log.warning("gpu-telemetry unavailable: %s", e)
        return []
    if out.returncode != 0 or not out.stdout.strip():
        return []
    try:
        return _rows_to_samples(json.loads(out.stdout))
    except (json.JSONDecodeError, TypeError, ValueError, AttributeError):
        log.warning("gpu-telemetry produced unusable output; ignoring")
        return []


def collect_cuda() -> List[ChipSample]:
    """Every visible card through ``torch.cuda.mem_get_info``. Where a
    card's memory cannot be read, the data sheet's capacity stands in and
    the usage is marked unobservable."""
    import torch

    from ..workloads.hardware import chip_spec_for

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            free, total = torch.cuda.mem_get_info(i)
        except RuntimeError:
            free = total = 0
        usage_known = bool(total)
        if not total:
            spec = chip_spec_for(torch.cuda.get_device_name(i))
            if spec is not None:
                total = int(spec.hbm_gb * (1 << 30))
        out.append(ChipSample(
            f"gpu{i}", hbm_used=(total - free) if usage_known else 0,
            hbm_total=total, hbm_usage_known=usage_known))
    return out


def sample_from_dict(d: Dict) -> ChipSample:
    """A health engine's ``/v1/samples`` entry as a sample."""
    return ChipSample(
        d.get("chip_id", ""),
        duty_cycle_pct=d.get("duty_cycle_pct", 0.0),
        hbm_used=d.get("hbm_used", 0),
        hbm_total=d.get("hbm_total", 0),
        tensorcore_util_pct=d.get("tensorcore_util_pct", 0.0),
        temperature_c=d.get("temperature_c"),
        hbm_usage_known=d.get("hbm_usage_known", True))


def collect_remote(info: str) -> List[ChipSample]:
    """Samples from a node-local health engine at ``info`` (host:port),
    which owns the telemetry session; this exporter only presents."""
    host, _, port = info.rpartition(":")
    host = host or "localhost"
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # a bare IPv6 host must be bracketed in a URL
    with urllib.request.urlopen(f"http://{host}:{port}/v1/samples",
                                timeout=5) as resp:
        return [sample_from_dict(d) for d in json.loads(resp.read())]


def collect_local() -> List[ChipSample]:
    """The on-node chain (what a health engine itself runs): fake (tests)
    -> native scraper -> torch.cuda, the last only where asked for."""
    if os.environ.get("GPU_FAKE_CHIPS"):
        return collect_fake()
    samples = collect_native()
    if samples:
        return samples
    if os.environ.get("GPU_EXPORTER_USE_TORCH", "").lower() == "true":
        return collect_cuda()
    return []


def collect() -> List[ChipSample]:
    remote = os.environ.get("GPU_HEALTH_ENGINE_INFO")
    if remote:
        return collect_remote(remote)
    return collect_local()


class GpuExporter:
    def __init__(self, node_name: str = ""):
        self.node_name = node_name
        self.registry = CollectorRegistry()
        labels = ("chip", "node")

        def g(name, doc):
            return Gauge(name, doc, labelnames=labels, registry=self.registry)

        self.duty_cycle = g("gpu_duty_cycle_percent",
                            "Share of the sample period a kernel ran (%)")
        self.hbm_used = g("gpu_hbm_used_bytes", "HBM bytes in use")
        self.hbm_total = g("gpu_hbm_total_bytes", "HBM capacity bytes")
        self.hbm_usage_known = g(
            "gpu_hbm_usage_known",
            "1 when HBM usage is measured; 0 when the backend exposes no "
            "memory accounting (gpu_hbm_used_bytes is then absent and "
            "gpu_hbm_total_bytes is the data sheet's)")
        self.tc_util = g("gpu_tensorcore_utilization_percent",
                         "Tensor-core utilization (%)")
        self.temperature = g("gpu_temperature_celsius", "Card temperature")
        self.chips = Gauge("gpu_chips_total", "Cards visible to the exporter",
                           labelnames=("node",), registry=self.registry)

    def collect_once(self) -> int:
        # a failed collection (health engine down, driver gone) clears the
        # series and keeps the exporter up: the engine's DaemonSet has no
        # start-up order relative to this one
        try:
            samples = collect()
        except Exception:
            log.exception("collection failed; clearing series")
            samples = []
        # a vanished card's last values must not be served forever
        for gauge in (self.duty_cycle, self.hbm_used, self.hbm_total,
                      self.tc_util, self.temperature, self.hbm_usage_known):
            gauge.clear()
        self.chips.labels(node=self.node_name).set(len(samples))
        for s in samples:
            lab = dict(chip=s.chip_id, node=self.node_name)
            self.duty_cycle.labels(**lab).set(s.duty_cycle_pct)
            self.hbm_usage_known.labels(**lab).set(
                1 if s.hbm_usage_known else 0)
            if s.hbm_usage_known:
                # an unobservable usage must not serve as a confident 0
                self.hbm_used.labels(**lab).set(s.hbm_used)
            self.hbm_total.labels(**lab).set(s.hbm_total)
            self.tc_util.labels(**lab).set(s.tensorcore_util_pct)
            if s.temperature_c is not None:
                self.temperature.labels(**lab).set(s.temperature_c)
        return len(samples)

    def render(self) -> bytes:
        return generate_latest(self.registry)


def serve(port: int, node_name: str = "", interval: float = 15.0,
          stop_event: Optional[threading.Event] = None) -> ThreadingHTTPServer:
    exporter = GpuExporter(node_name)
    exporter.collect_once()
    stop = stop_event or threading.Event()

    def loop():
        while not stop.wait(interval):
            try:
                exporter.collect_once()
            except Exception:
                log.exception("collection failed")

    threading.Thread(target=loop, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/metrics":
                body, code, ctype = (exporter.render(), 200,
                                     "text/plain; version=0.0.4")
            elif self.path == "/healthz":
                body, code, ctype = b"ok", 200, "text/plain"
            else:
                body, code, ctype = b"not found", 404, "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log.info("gpu metrics exporter on :%d", server.server_address[1])
    return server


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    port = int(os.environ.get("METRICS_PORT", str(METRICS_PORT)))
    interval = float(os.environ.get("COLLECTION_INTERVAL", "15"))
    serve(port, node_name=os.environ.get("NODE_NAME", ""), interval=interval)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    raise SystemExit(main())
