"""Node validation-status exporter: the barrier files as gauges.

Counterpart of ``tpu_operator/validator/metrics.py`` (the NVIDIA
validator's metrics.go). It polls the barrier status files, re-proves the
driver layer every minute, and serves ``gpu_operator_node_*`` gauges for
the node-status-exporter DaemonSet: one ``component_ready`` series per
proof, the card count from ``driver-ready`` and the figures the proofs
measured (``cuda-ready``'s TENSOR_CORE_UTILIZATION, ``nvlink-ready``'s
FRACTION_OF_PEAK and SUITE_*_BUS_GBPS, ``hbm-ready``'s FRACTION_OF_PEAK).
On nodes of the isolated plane it adds the ``fencing`` and ``vgpu``
readiness series.
"""

from __future__ import annotations

import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from prometheus_client import CollectorRegistry, Gauge, generate_latest

from . import barrier, components

log = logging.getLogger("gpu_validator.metrics")

POLL_INTERVAL_S = 30.0        # status-file poll
REVALIDATE_INTERVAL_S = 60.0  # driver re-proof cadence

COMPONENT_FILES = {
    "driver": "driver-ready",
    "runtime": "runtime-ready",
    "cuda": "cuda-ready",
    "plugin": "plugin-ready",
    "nvlink": "nvlink-ready",
}

# isolated-plane components: served only where the plane runs (a fence
# published), so a container node does not export a constant 0 that
# reads like a failed validation
ISOLATION_COMPONENT_FILES = {
    "fencing": "fencing-ready",
    "vgpu": "vgpu-ready",
}


def _as_float(s) -> Optional[float]:
    try:
        return float(s)
    except (TypeError, ValueError):
        return None


def set_or_remove(gauge, value, ordered_label_values) -> None:
    """Set the series, or remove it when its source has gone: a stale
    series would show a degraded node's dashboard the old healthy figure
    as if it were current. ``ordered_label_values`` are in the gauge's
    declared label order."""
    if value is not None:
        gauge.labels(*ordered_label_values).set(value)
    else:
        try:
            gauge.remove(*ordered_label_values)
        except KeyError:
            pass  # never published


class NodeMetrics:
    def __init__(self, node_name: str = ""):
        self.registry = CollectorRegistry()
        self.node_name = node_name

        def gauge(name, doc, labels=("node",)):
            return Gauge(name, doc, labelnames=labels, registry=self.registry)

        self.ready = gauge("gpu_operator_node_component_ready",
                           "1 when the component's validation is current",
                           ("component", "node"))
        self.gpus = gauge("gpu_operator_node_gpus",
                          "CUDA cards discovered on this node")
        self.revalidations = gauge("gpu_operator_node_revalidations_total",
                                   "Driver re-validation attempts")
        self.revalidation_ok = gauge(
            "gpu_operator_node_driver_revalidation_ok",
            "1 when the last periodic driver re-proof succeeded")
        # the proofs' measured figures (barrier file lines) as gauges
        self.tensor_core_utilization = gauge(
            "gpu_operator_node_matmul_tensor_core_utilization",
            "Fraction of peak bf16 the cuda proof sustained")
        self.nvlink_fraction = gauge(
            "gpu_operator_node_nvlink_fraction_of_peak",
            "Fraction of one-way NVLink bandwidth the all-reduce proof "
            "reached")
        self.hbm_fraction = gauge(
            "gpu_operator_node_hbm_fraction_of_peak",
            "Fraction of peak HBM bandwidth the triad proof reached")
        self.collective_bus = gauge(
            "gpu_operator_node_collective_bus_gbps",
            "Per-primitive NVLink bus bandwidth from the full suite",
            ("op", "node"))
        self._published_ops: set = set()
        self._reval_count = 0

    @staticmethod
    def _isolation_plane_present() -> bool:
        """The node runs the isolated plane iff a fence is published (or
        its proof passed): what the exporter sees without the
        apiserver."""
        from ..isolation.fencing import read_fencing_file

        return read_fencing_file() is not None or \
            barrier.is_ready("fencing-ready")

    def collect_once(self, revalidate: bool = False) -> None:
        node = self.node_name
        if revalidate:
            self._reval_count += 1
            self.revalidations.labels(node=node).set(self._reval_count)
            try:
                components.validate_driver()
                self.revalidation_ok.labels(node=node).set(1)
            except components.ValidationFailed as e:
                # the gauge reports it; the barrier file belongs to the
                # validator DaemonSet, and clearing it from here would wedge
                # every operand whenever this pod merely lacks the cards
                log.warning("driver re-validation failed: %s", e)
                self.revalidation_ok.labels(node=node).set(0)
        files = dict(COMPONENT_FILES)
        if self._isolation_plane_present():
            files.update(ISOLATION_COMPONENT_FILES)
        for comp, fname in files.items():
            self.ready.labels(component=comp, node=node).set(
                1 if barrier.is_ready(fname) else 0)
        info = barrier.read_status("driver-ready") or {}
        self.gpus.labels(node=node).set(int(info.get("CHIP_COUNT", "0") or 0))
        self._publish_perf_figures()

    def _publish_perf_figures(self) -> None:
        node = self.node_name
        cuda_info = barrier.read_status("cuda-ready") or {}
        set_or_remove(self.tensor_core_utilization,
                      _as_float(cuda_info.get("TENSOR_CORE_UTILIZATION")),
                      (node,))
        nvlink_info = barrier.read_status("nvlink-ready") or {}
        set_or_remove(self.nvlink_fraction,
                      _as_float(nvlink_info.get("FRACTION_OF_PEAK")), (node,))
        present_ops = set()
        for key, val in nvlink_info.items():
            if key.startswith("SUITE_") and key.endswith("_BUS_GBPS"):
                bw = _as_float(val)
                if bw is not None:
                    op = key[len("SUITE_"):-len("_BUS_GBPS")].lower()
                    present_ops.add(op)
                    self.collective_bus.labels(op=op, node=node).set(bw)
        for op in self._published_ops - present_ops:
            set_or_remove(self.collective_bus, None, (op, node))
        self._published_ops = present_ops
        hbm_info = barrier.read_status("hbm-ready") or {}
        set_or_remove(self.hbm_fraction,
                      _as_float(hbm_info.get("FRACTION_OF_PEAK")), (node,))

    def render(self) -> bytes:
        return generate_latest(self.registry)


def serve(port: int, node_name: str = "",
          poll_interval: float = POLL_INTERVAL_S,
          revalidate_interval: float = REVALIDATE_INTERVAL_S,
          stop_event: Optional[threading.Event] = None) -> ThreadingHTTPServer:
    """Start the exporter on ``port`` (0: any free port) and return the
    server; the caller sets ``stop_event`` and shuts the server down."""
    metrics = NodeMetrics(node_name)
    metrics.collect_once(revalidate=False)
    stop = stop_event or threading.Event()

    def poll_loop():
        last_reval = time.monotonic()
        while not stop.is_set():
            revalidate = time.monotonic() - last_reval >= revalidate_interval
            if revalidate:
                last_reval = time.monotonic()
            try:
                metrics.collect_once(revalidate=revalidate)
            except Exception:
                log.exception("metrics collection failed")
            stop.wait(poll_interval)

    threading.Thread(target=poll_loop, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/metrics":
                body, code, ctype = (metrics.render(), 200,
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
    server._stop_event = stop  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
