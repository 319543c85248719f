"""Card health engine: the standalone DCGM host-engine slot.

Counterpart of ``tpu_operator/metrics/health_engine.py``. One process
owns the node's telemetry session (DCGM's reason to run as its own
DaemonSet) and:

- samples the cards through the exporter's on-node chain
  (``gpu_exporter.collect_local``: fake -> NVML scraper -> torch.cuda),
- grades them (DCGM's health watch): overheat, memory exhaustion, and
  cards disappearing after the first enumeration,
- serves node-local JSON over HTTP (``/v1/samples``, ``/v1/health`` —
  503 when a card FAILs — and ``/healthz``); the exporter and the
  device plugins read it when ``GPU_HEALTH_ENGINE_INFO`` is set.

Card IDs are ``gpu<i>``, NVML's index, the IDs the device plugin
advertises, so a verdict keys the unit it grades.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

# sample_from_dict reads a /v1/samples entry back (the exporter's remote
# backend reads them with it too)
from .gpu_exporter import (ChipSample, collect_local,  # noqa: F401
                           sample_from_dict)

log = logging.getLogger("gpu_health_engine")

DEFAULT_PORT = 9402

OK = "ok"
WARN = "warn"
FAIL = "fail"

TEMP_WARN_C = 75.0
TEMP_FAIL_C = 90.0
HBM_WARN_FRACTION = 0.95

# digest consumers refuse a version they don't speak instead of
# misreading it; bump on any change of a key's meaning
DIGEST_SCHEMA_VERSION = 1


def sample_to_dict(s: ChipSample) -> Dict:
    return {
        "chip_id": s.chip_id,
        "duty_cycle_pct": s.duty_cycle_pct,
        "hbm_used": s.hbm_used,
        "hbm_total": s.hbm_total,
        "tensorcore_util_pct": s.tensorcore_util_pct,
        "temperature_c": s.temperature_c,
        "hbm_usage_known": s.hbm_usage_known,
    }


def evaluate_chip(s: ChipSample) -> Dict:
    """One card's verdict: ok, warn or fail, with the reasons."""
    status, reasons = OK, []
    if s.temperature_c is not None:
        if s.temperature_c >= TEMP_FAIL_C:
            status = FAIL
            reasons.append(f"temperature {s.temperature_c:.0f}C >= "
                           f"{TEMP_FAIL_C:.0f}C")
        elif s.temperature_c >= TEMP_WARN_C:
            status = WARN
            reasons.append(f"temperature {s.temperature_c:.0f}C >= "
                           f"{TEMP_WARN_C:.0f}C")
    # a data-sheet total with unobservable usage would make the card look
    # healthy or full arbitrarily: say so instead of guessing
    if s.hbm_usage_known and s.hbm_total \
            and s.hbm_used / s.hbm_total >= HBM_WARN_FRACTION:
        if status != FAIL:
            status = WARN
        reasons.append(f"HBM {s.hbm_used / s.hbm_total:.0%} full")
    out = {"chip_id": s.chip_id, "status": status, "reasons": reasons}
    if not s.hbm_usage_known:
        out["usage_unobservable"] = True
    return out


class HealthEngine:
    def __init__(self):
        self._lock = threading.Lock()
        self._samples: List[ChipSample] = []
        self._expected_chips: Optional[int] = None

    def collect_once(self) -> int:
        samples = collect_local()
        with self._lock:
            self._samples = samples
            # the first enumeration pins the expected count: a later drop
            # is a card off the bus, which no per-card rule can see
            if self._expected_chips is None and samples:
                self._expected_chips = len(samples)
        return len(samples)

    def samples(self) -> List[Dict]:
        with self._lock:
            return [sample_to_dict(s) for s in self._samples]

    def health(self) -> Dict:
        with self._lock:
            samples = list(self._samples)
            expected = self._expected_chips
        chips = [evaluate_chip(s) for s in samples]
        status = OK
        reasons: List[str] = []
        if expected is not None and len(samples) < expected:
            status = FAIL
            reasons.append(
                f"{expected - len(samples)} of {expected} chips missing")
        for c in chips:
            if c["status"] == FAIL:
                status = FAIL
            elif c["status"] == WARN and status == OK:
                status = WARN
        return {"status": status, "reasons": reasons, "chips": chips}

    def digest(self, generation: str = "", seq: int = 0) -> Dict:
        """The node's health digest, the payload of the
        ``gpu.graft.dev/health-digest`` annotation: per-card grades and
        three scalar summaries, bounded by the cards of one host."""
        health = self.health()
        with self._lock:
            samples = list(self._samples)
        duty = [s.duty_cycle_pct for s in samples]
        temps = [s.temperature_c for s in samples
                 if s.temperature_c is not None]
        free = [1.0 - s.hbm_used / s.hbm_total for s in samples
                if s.hbm_usage_known and s.hbm_total]
        return {
            "v": DIGEST_SCHEMA_VERSION,
            "status": health["status"],
            "grades": {c["chip_id"]: c["status"] for c in health["chips"]},
            "duty_pct": round(sum(duty) / len(duty), 1) if duty else 0.0,
            "hbm_free_frac": round(min(free), 4) if free else 1.0,
            "temp_max_c": round(max(temps), 1) if temps else 0.0,
            "gen": generation,
            "seq": int(seq),
        }


def digest_annotation(digest: Dict) -> str:
    """A digest's wire form: compact, key-sorted JSON, byte-stable for a
    given digest, so unchanged health is a no-op write."""
    return json.dumps(digest, sort_keys=True, separators=(",", ":"))


def parse_digest(raw: Optional[str]) -> Optional[Dict]:
    """The digest of an annotation, or None when absent, malformed or of
    a schema version this build doesn't speak."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(d, dict) or d.get("v") != DIGEST_SCHEMA_VERSION:
        return None
    return d


def publish_digests(client, node_name: str, engine: HealthEngine,
                    generation: str = "", interval: float = 30.0,
                    stop_event: Optional[threading.Event] = None,
                    jitter: float = 0.2) -> int:
    """Patch the node's digest annotation on a jittered cadence (seeded
    from the node name, so one node's schedule is reproducible and a
    fleet does not write on the same second) until ``stop_event`` is
    set; returns the number of digests published."""
    from ..api import labels as L

    stop = stop_event or threading.Event()
    rng = random.Random(f"digest:{node_name}")
    seq = 0
    while True:
        seq += 1
        ann = digest_annotation(engine.digest(generation, seq))
        try:
            client.patch("v1", "Node", node_name,
                         {"metadata": {"annotations": {
                             L.HEALTH_DIGEST: ann}}})
        except Exception:
            log.exception("digest publish failed for %s", node_name)
        wait = interval * (1.0 + jitter * (2.0 * rng.random() - 1.0))
        if stop.wait(max(wait, 0.1)):
            return seq


def serve(port: int, interval: float = 15.0,
          stop_event: Optional[threading.Event] = None,
          engine: Optional[HealthEngine] = None) -> ThreadingHTTPServer:
    """Start the engine's HTTP server on ``port`` (0: any free port) and
    its collection loop; the caller sets ``stop_event`` and shuts the
    server down."""
    eng = engine or HealthEngine()
    eng.collect_once()
    stop = stop_event or threading.Event()

    def loop():
        while not stop.wait(interval):
            try:
                eng.collect_once()
            except Exception:
                log.exception("health collection failed")

    threading.Thread(target=loop, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/v1/samples":
                body = json.dumps(eng.samples()).encode()
                code = 200
            elif self.path == "/v1/health":
                health = eng.health()
                body = json.dumps(health).encode()
                code = 200 if health["status"] != FAIL else 503
            elif self.path == "/healthz":
                body, code = b"ok", 200
            else:
                body, code = b"not found", 404
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log.info("gpu health engine on :%d", server.server_address[1])
    return server


def main() -> int:  # pragma: no cover - container entrypoint
    logging.basicConfig(level=logging.INFO)
    serve(int(os.environ.get("HEALTH_PORT", str(DEFAULT_PORT))),
          interval=float(os.environ.get("COLLECTION_INTERVAL", "15")))
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    raise SystemExit(main())
