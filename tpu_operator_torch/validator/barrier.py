"""Status-file barrier protocol (the port's own copy).

Same protocol as ``tpu_operator/validator/barrier.py``: each validation
component writes ``<validation-dir>/<component>-ready`` on success; every
downstream operand's initContainer blocks on the file it needs. The
directory is a hostPath (default /run/nvidia/validations, the NVIDIA
operator's own) so the barrier spans pods on the same node; the
``GPU_VALIDATION_DIR`` env var moves it.
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Dict, Optional

DEFAULT_DIR = "/run/nvidia/validations"
RETRY_INTERVAL_S = 5.0
DEFAULT_TIMEOUT_S = 300.0

KNOWN_STATUS_FILES = (
    "driver-ready",
    "runtime-ready",
    "cuda-ready",
    "plugin-ready",
    "hbm-ready",
    "nvlink-ready",
    "dcn-ready",
)


def validation_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("GPU_VALIDATION_DIR", DEFAULT_DIR))


def status_path(name: str) -> pathlib.Path:
    return validation_dir() / name


def write_status(name: str, info: Optional[Dict[str, str]] = None) -> pathlib.Path:
    """Write a status file atomically (tmp+rename) with KEY=VALUE lines."""
    path = status_path(name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    lines = [f"{k}={v}" for k, v in (info or {}).items()]
    tmp.write_text("\n".join(lines) + ("\n" if lines else ""))
    tmp.rename(path)
    return path


def read_status(name: str) -> Optional[Dict[str, str]]:
    path = status_path(name)
    if not path.exists():
        return None
    out: Dict[str, str] = {}
    for line in path.read_text().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def is_ready(name: str) -> bool:
    return status_path(name).exists()


def clear_status(name: str) -> None:
    try:
        status_path(name).unlink()
    except FileNotFoundError:
        pass


def cleanup_all() -> None:
    """preStop: drop every status file so a departing validator re-gates
    the node."""
    if not validation_dir().is_dir():
        return
    for name in KNOWN_STATUS_FILES:
        clear_status(name)


def wait_for(name: str, timeout: float = DEFAULT_TIMEOUT_S,
             interval: float = RETRY_INTERVAL_S) -> bool:
    """Block until a status file exists (the wait initContainer primitive)."""
    deadline = time.monotonic() + timeout
    while True:
        if is_ready(name):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(min(interval, max(0.01, deadline - time.monotonic())))
