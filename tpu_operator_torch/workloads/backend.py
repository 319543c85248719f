"""CUDA bring-up for validator workloads.

Counterpart of ``tpu_operator/workloads/backend.py``. A card whose driver
is still loading, or that another process holds in exclusive-process
compute mode, fails CUDA initialisation; the validator retries its proofs
on a 5 s cadence until the layer below is ready, and this module gives
device *initialization* the same discipline:

- ``init_devices()`` — initialise CUDA with bounded retries and
  exponential backoff, logging the holders of the device nodes between
  attempts so a failure is attributable.
- ``diagnose_holders()`` — best-effort report of which processes hold the
  NVIDIA device nodes (``/dev/nvidia[0-9]*``, ``/dev/nvidiactl``,
  ``/dev/nvidia-uvm``).
- ``resolve_device()`` — the one place an entry point's ``device``
  argument becomes a ``torch.device``: ``None`` is ``cuda:0``, and a CUDA
  device where CUDA is unusable raises instead of running on the CPU.

No k8s dependencies: this runs inside validator pods and on bare hosts.
"""

from __future__ import annotations

import glob
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

_DEVICE_GLOBS = ("/dev/nvidia[0-9]*", "/dev/nvidiactl", "/dev/nvidia-uvm")


@dataclass
class HolderInfo:
    pid: int
    cmdline: str
    paths: List[str] = field(default_factory=list)


def _read_cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read().replace(b"\x00", b" ").decode("utf-8", "replace")
        return raw.strip()[:200] or "?"
    except OSError:
        return "?"


def device_nodes() -> List[str]:
    return sorted(d for pat in _DEVICE_GLOBS for d in glob.glob(pat))


def diagnose_holders() -> List[HolderInfo]:
    """Scan /proc/*/fd for open handles on the NVIDIA device nodes.

    Returns holders other than the current process; silently skips pids
    it cannot inspect.
    """
    targets = set(device_nodes())
    if not targets:
        return []
    me = os.getpid()
    holders = {}
    for proc in glob.glob("/proc/[0-9]*"):
        try:
            pid = int(proc.rsplit("/", 1)[1])
        except ValueError:
            continue
        if pid == me:
            continue
        hits = []
        try:
            for fd in os.listdir(f"{proc}/fd"):
                try:
                    dest = os.readlink(f"{proc}/fd/{fd}")
                except OSError:
                    continue
                if dest in targets:
                    hits.append(dest)
        except OSError:
            continue
        if hits:
            holders[pid] = HolderInfo(pid, _read_cmdline(pid), sorted(set(hits)))
    return [holders[p] for p in sorted(holders)]


def describe_environment() -> str:
    """One-line summary of the CUDA-relevant environment for diagnostics."""
    bits = []
    for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                "CUDA_DEVICE_ORDER"):
        if os.environ.get(var):
            bits.append(f"{var}={os.environ[var]}")
    bits.append(f"device_nodes={device_nodes() or 'none'}")
    return " ".join(bits)


def log_holders(log, holders: Optional[list] = None) -> None:
    """Report card holders (or the absence of any) through ``log``."""
    if holders is None:
        holders = diagnose_holders()
    for h in holders:
        log(f"#   card held by pid={h.pid} ({h.cmdline}) via {h.paths}")
    if not holders:
        log(f"#   no local holder found; env: {describe_environment()}")


def init_devices(attempts: int = 3, backoff_s: float = 5.0,
                 log=None) -> list:
    """The visible CUDA devices, initialising CUDA with retry/backoff.

    Raises the final exception (after holder diagnostics) if every
    attempt fails. ``log`` is a callable for diagnostic lines (defaults to
    stderr).
    """
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr)

    delay = backoff_s
    last_exc: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        try:
            torch.cuda.init()
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("CUDA initialised but sees no device "
                                   f"({describe_environment()})")
            return [torch.device("cuda", i) for i in range(n)]
        except (RuntimeError, AssertionError) as exc:
            # torch raises AssertionError when built without CUDA
            last_exc = exc
            log(f"# CUDA init attempt {attempt}/{attempts} failed: "
                f"{type(exc).__name__}: {str(exc)[:200]}")
            log_holders(log)
            if attempt < attempts:
                time.sleep(delay)
                delay = min(delay * 2, 60.0)
    assert last_exc is not None
    raise last_exc


def resolve_device(device=None):
    """``device`` as a ``torch.device``: ``None`` means ``cuda:0``.

    A CUDA device where CUDA is unusable raises RuntimeError: the port
    never quietly runs a proof on the CPU. Callers that want the CPU say
    so (``device="cpu"``).
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA is not available ({describe_environment()}); pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist: "
                               f"{torch.cuda.device_count()} card(s) visible")
    return dev


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
