"""Validation components on CUDA.

Counterpart of ``tpu_operator/validator/components.py`` for the
accelerator half of the chain. Each component proves one layer of the
stack and writes its barrier status file. Component -> proof:

- ``driver``   cards visible (nvidia-smi, /dev/nvidia* nodes, or CUDA
               enumeration); writes the inventory into driver-ready
- ``runtime``  device nodes usable + env contract -> runtime-ready
- ``cuda``     REAL compute proof: bf16 matmul on a card -> cuda-ready
               (the NVIDIA operator's own barrier name)
- ``hbm``      STREAM triad through kernel B1 must reach a fraction of
               the card's HBM bandwidth -> hbm-ready
- ``nvlink``   all-reduce across the host's cards must reach a fraction
               of NVLink bandwidth -> nvlink-ready; skipped on one card
- ``dcn``      multi-node reachability: the job's rendezvous answers over
               the data-centre network -> dcn-ready; skipped on one node;
               optionally the cross-node all-reduce bandwidth
- ``cleanup``  preStop barrier teardown

Env knobs, by their JAX-package names: ``TPU_FAKE_CHIPS`` ->
``GPU_FAKE_CHIPS``, ``TPU_VALIDATOR_ALLOW_CPU`` ->
``GPU_VALIDATOR_ALLOW_CPU``, ``TPU_VALIDATOR_USE_JAX`` ->
``GPU_VALIDATOR_USE_TORCH``, ``ICI_*`` -> ``NVLINK_*``,
``MEGASCALE_NUM_SLICES`` -> ``GPU_NUM_NODES``,
``MEGASCALE_COORDINATOR_ADDRESS`` -> ``MASTER_ADDR:MASTER_PORT``
(torchrun's; port 29500 by default), ``MEGASCALE_SLICE_ID`` ->
``GROUP_RANK``; ``MATMUL_SIZE``, ``HBM_THRESHOLD``, ``HBM_SIZE_MB`` and
the ``DCN_*`` knobs keep their names.
"""

from __future__ import annotations

import errno
import glob
import logging
import os
import stat
import subprocess
import time
from typing import Dict, List, Optional

import torch

from ..parallel import multihost
from ..workloads import collectives, hbm_probe, matmul
from ..workloads.backend import resolve_device
from . import barrier

log = logging.getLogger("gpu_validator")

CARD_NODE_GLOB = "/dev/nvidia[0-9]*"
CONTROL_NODE = "/dev/nvidiactl"


class ValidationFailed(Exception):
    pass


# ---------------------------------------------------------------------------
# card discovery
# ---------------------------------------------------------------------------


def _nvidia_smi_inventory() -> Optional[Dict]:
    smi = os.environ.get("NVIDIA_SMI_BIN", "nvidia-smi")
    try:
        out = subprocess.run(
            [smi, "--query-gpu=index,name,uuid", "--format=csv,noheader"],
            capture_output=True, timeout=30, text=True)
    except (OSError, subprocess.TimeoutExpired):
        return None
    rows = [[f.strip() for f in line.split(",")]
            for line in out.stdout.splitlines() if line.strip()]
    if out.returncode != 0 or not rows or any(len(r) != 3 for r in rows):
        return None
    # cards are named by UUID: nvidia-smi's index is not the minor number
    # of the card's /dev/nvidia<N> node (index 0 may be /dev/nvidia6)
    return {"count": len(rows), "source": "nvidia-smi",
            "devices": [r[2] for r in rows], "kind": rows[0][1]}


def discover_chips() -> Dict:
    """Enumerate CUDA cards on this host, best source first:

    1. GPU_FAKE_CHIPS env (tests / fake clusters)
    2. ``nvidia-smi --query-gpu=index,name,uuid`` (NVIDIA_SMI_BIN moves it)
    3. /dev/nvidia[0-9]* device nodes
    4. CUDA enumeration through torch (initialises CUDA in this process,
       so only used when GPU_VALIDATOR_USE_TORCH=true)
    """
    fake = os.environ.get("GPU_FAKE_CHIPS")
    if fake:
        n = int(fake)
        return {"count": n, "source": "fake",
                "devices": [f"/dev/nvidia{i}" for i in range(n)]}

    smi = _nvidia_smi_inventory()
    if smi:
        return smi

    devices = sorted(glob.glob(CARD_NODE_GLOB))
    if devices:
        return {"count": len(devices), "source": "devfs", "devices": devices}

    if os.environ.get("GPU_VALIDATOR_USE_TORCH", "").lower() == "true":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {"count": n, "source": "torch",
                "devices": [f"cuda:{i}" for i in range(n)],
                "kind": torch.cuda.get_device_name(0) if n else ""}

    return {"count": 0, "source": "none", "devices": []}


def _allow_cpu(allow_cpu: Optional[bool]) -> bool:
    if allow_cpu is None:
        return os.environ.get("GPU_VALIDATOR_ALLOW_CPU", "").lower() == "true"
    return allow_cpu


def _proof_device(allow_cpu: Optional[bool], what: str) -> torch.device:
    """The card a proof runs on. A proof must run on an actual card:
    certifying a node off a CPU run would defeat the whole gate, so the
    CPU is used only when the caller opted in (tests, fake clusters)."""
    if torch.cuda.is_available():
        return resolve_device(None)
    if _allow_cpu(allow_cpu):
        return torch.device("cpu")
    raise ValidationFailed(
        f"CUDA is not usable from this container — cannot {what} "
        "(set GPU_VALIDATOR_ALLOW_CPU=true only for fake/test clusters)")


def _card_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------


def validate_driver() -> Dict[str, str]:
    chips = discover_chips()
    if chips["count"] == 0:
        raise ValidationFailed(
            "no CUDA cards visible (nvidia-smi found none, no /dev/nvidia* "
            "nodes)")
    info = {
        "CHIP_COUNT": str(chips["count"]),
        "SOURCE": chips["source"],
        "DEVICES": ",".join(chips.get("devices", [])),
    }
    if chips.get("kind"):
        info["DEVICE_KIND"] = chips["kind"]
    barrier.write_status("driver-ready", info)
    return info


def device_node_error(path: str) -> Optional[str]:
    """Real device-node proof: a card's node must be a *character device*
    that opens O_RDWR — permission-bit checks pass a present-but-broken
    node, e.g. a regular file left behind by a failed driver install.
    Returns None when healthy, else the reason."""
    try:
        st = os.stat(path)
    except OSError as e:
        return f"{path}: stat failed ({e.strerror})"
    if not stat.S_ISCHR(st.st_mode):
        return f"{path}: not a character device (mode {oct(st.st_mode)})"
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError as e:
        if e.errno == errno.EBUSY:
            # held exclusively by a running workload: demonstrably alive
            return None
        return f"{path}: open(O_RDWR) failed ({e.strerror})"
    os.close(fd)
    return None


def validate_runtime() -> Dict[str, str]:
    if not barrier.is_ready("driver-ready"):
        if os.environ.get("WITH_WAIT", "").lower() == "true":
            if not barrier.wait_for("driver-ready"):
                raise ValidationFailed("timed out waiting for driver-ready")
        else:
            raise ValidationFailed("driver-ready gate not passed")
    chips = discover_chips()
    info = {"DEVICE_COUNT": str(chips["count"])}
    if chips["count"] and chips["source"] != "fake":
        info["DEVICE_NODES"] = ",".join(_usable_card_nodes(chips["count"]))
    # control-plane belief vs node reality: the operator renders its
    # detected runtime into the DS env; the node records what it actually
    # runs next to it, so drift is visible in the barrier file
    expected = os.environ.get("EXPECTED_CONTAINER_RUNTIME")
    if expected:
        info["EXPECTED_CONTAINER_RUNTIME"] = expected
        actual = _node_container_runtime()
        if actual:
            info["CONTAINER_RUNTIME"] = actual
            if not actual.startswith(expected):
                log.warning(
                    "container runtime drift: operator detected %r, "
                    "node reports %r", expected, actual)
    barrier.write_status("runtime-ready", info)
    return info


def _usable_card_nodes(count: int) -> List[str]:
    """The card nodes this container can open; raises unless the control
    node is usable and there are at least ``count`` of them.

    A node per visible card is required, not every node under /dev: a
    container may see nodes of cards that are not its own, which refuse
    to open (EPERM), and a card's node number is its minor number, not
    its nvidia-smi index."""
    ctl = device_node_error(CONTROL_NODE)
    if ctl:
        raise ValidationFailed(f"device nodes not usable: {[ctl]}")
    errors, usable = [], []
    for node in sorted(glob.glob(CARD_NODE_GLOB)):
        err = device_node_error(node)
        if err:
            errors.append(err)
        else:
            usable.append(node)
    if len(usable) < count:
        raise ValidationFailed(
            f"device nodes not usable: {count} card(s) visible, "
            f"{len(usable)} usable card node(s) {usable}; {errors}")
    return usable


def _node_container_runtime() -> str:
    """The runtime serving this node, from its socket under the host
    rootfs (mounted at HOST_ROOT)."""
    host = os.environ.get("HOST_ROOT", "/host").rstrip("/")
    for sock, name in (("/run/containerd/containerd.sock", "containerd"),
                       ("/var/run/docker.sock", "docker"),
                       ("/var/run/crio/crio.sock", "cri-o")):
        if os.path.exists(host + sock):
            return name
    return ""


def validate_cuda(matmul_size: Optional[int] = None,
                  allow_cpu: Optional[bool] = None) -> Dict[str, str]:
    """In-process single-card matmul proof."""
    size = matmul_size or int(os.environ.get("MATMUL_SIZE", "4096"))
    dev = _proof_device(allow_cpu, "run the compute proof")
    res = matmul.run(size=size, iters=8, calls=2, repeats=1, device=dev)
    if not res.checksum_ok:
        raise ValidationFailed("matmul produced non-finite values")
    info = {
        "MATMUL_SIZE": str(size),
        # 4 significant digits: a tiny proof on a slow host must not
        # round to "0.00"
        "TFLOPS": f"{res.tflops:.4g}",
        "DEVICE_KIND": res.device_kind,
    }
    if res.utilization is not None:
        info["TENSOR_CORE_UTILIZATION"] = f"{res.utilization:.3f}"
    barrier.write_status("cuda-ready", info)
    return info


def validate_nvlink(threshold: Optional[float] = None,
                    allow_cpu: Optional[bool] = None) -> Dict[str, str]:
    dev = _proof_device(allow_cpu, "measure NVLink")
    thr = threshold if threshold is not None else float(
        os.environ.get("NVLINK_THRESHOLD", "0.8"))
    n = _card_count(dev)
    if n < 2:
        info = {"SKIPPED": "single-card host, no NVLink to validate",
                "DEVICES": str(n)}
        barrier.write_status("nvlink-ready", info)
        return info
    res = collectives.run(
        size_mb=float(os.environ.get("NVLINK_SIZE_MB", "256")),
        world_size=n, device=dev.type)
    if not res.correct:
        raise ValidationFailed("allreduce produced wrong values")
    info = {
        "DEVICES": str(res.devices),
        "BUS_BW_GBPS": f"{res.bus_bw_gbps:.2f}",
        "DEVICE_KIND": res.device_kind,
    }
    if res.fraction_of_peak is not None:
        info["FRACTION_OF_PEAK"] = f"{res.fraction_of_peak:.3f}"
        if res.fraction_of_peak < thr:
            raise ValidationFailed(
                f"NVLink allreduce reached {res.fraction_of_peak:.1%} of "
                f"peak, below the {thr:.0%} threshold")
    if os.environ.get("NVLINK_FULL_SUITE", "").lower() == "true":
        # the NCCL-tests slot: one figure per primitive (informational —
        # the all-reduce above stays the gate; a primitive that moves
        # wrong data still fails hard)
        suite = collectives.run_suite(
            size_mb=float(os.environ.get("NVLINK_SUITE_SIZE_MB", "64")),
            world_size=n, device=dev.type)
        for op, r in suite.items():
            if not r.correct:
                raise ValidationFailed(f"collective {op} produced wrong "
                                       f"values")
            info[f"SUITE_{op.upper()}_BUS_GBPS"] = f"{r.bus_bw_gbps:.2f}"
    barrier.write_status("nvlink-ready", info)
    return info


def validate_hbm(threshold: Optional[float] = None,
                 allow_cpu: Optional[bool] = None) -> Dict[str, str]:
    """HBM bandwidth proof: the STREAM triad (kernel B1) must sustain a
    healthy fraction of the card's published HBM bandwidth (a slow HBM
    is a failing card). Default bar is 0.5."""
    dev = _proof_device(allow_cpu, "measure HBM")
    thr = threshold if threshold is not None else float(
        os.environ.get("HBM_THRESHOLD", "0.5"))
    res = hbm_probe.run(size_mb=float(os.environ.get("HBM_SIZE_MB", "512")),
                        device=dev)
    if not res.correct:
        raise ValidationFailed("triad kernel produced wrong values")
    info = {
        "BANDWIDTH_GBPS": f"{res.bandwidth_gbps:.2f}",
        "DEVICE_KIND": res.device_kind,
    }
    if res.fraction_of_peak is not None:
        info["FRACTION_OF_PEAK"] = f"{res.fraction_of_peak:.3f}"
        if res.fraction_of_peak < thr:
            raise ValidationFailed(
                f"HBM triad reached {res.fraction_of_peak:.1%} of peak, "
                f"below the {thr:.0%} threshold")
    barrier.write_status("hbm-ready", info)
    return info


def validate_dcn(timeout: Optional[float] = None) -> Dict[str, str]:
    """Multi-node DCN reachability: a multi-node job's ranks discover each
    other through torchrun's rendezvous (``MASTER_ADDR:MASTER_PORT``);
    this proof resolves and TCP-connects it. On a single-node job there is
    no DCN to validate — skipped."""
    import socket

    num_slices = int(os.environ.get("GPU_NUM_NODES", "1") or 1)
    addr = os.environ.get("MASTER_ADDR", "")
    if num_slices <= 1 or not addr:
        info = {"SKIPPED": "single-node job, no DCN to validate",
                "NUM_SLICES": str(num_slices)}
        barrier.write_status("dcn-ready", info)
        return info
    port = int(os.environ.get("MASTER_PORT", "") or
               multihost.DEFAULT_MASTER_PORT)
    coordinator = f"{addr}:{port}"
    deadline = time.monotonic() + (
        timeout if timeout is not None
        else float(os.environ.get("DCN_TIMEOUT_S", "60")))
    last_err: Optional[Exception] = None
    info: Optional[Dict[str, str]] = None
    while time.monotonic() < deadline:
        start = time.perf_counter()
        try:
            with socket.create_connection((addr, port), timeout=5.0):
                rtt_ms = (time.perf_counter() - start) * 1e3
            info = {
                "COORDINATOR": coordinator,
                "NUM_SLICES": str(num_slices),
                "SLICE_ID": os.environ.get("GROUP_RANK", ""),
                "RTT_MS": f"{rtt_ms:.2f}",
            }
            break
        except OSError as e:
            last_err = e
            time.sleep(1.0)
    if info is None:
        raise ValidationFailed(
            f"rendezvous {coordinator} unreachable over DCN: {last_err}")
    # outside the connect-retry loop: a probe error must never be
    # misread as rendezvous unreachability (and never re-run per retry)
    _maybe_dcn_bandwidth_probe(info)
    barrier.write_status("dcn-ready", info)
    return info


def _maybe_dcn_bandwidth_probe(info: Dict[str, str]) -> None:
    """DCN_BANDWIDTH_PROBE=true: measure the cross-node gradient-sync path
    (an all-reduce over the hybrid mesh's dcn axis) and add its figures
    to the barrier info. ``DCN_PROBE_FAKE_SLICES=N`` runs it over N equal
    groups of this host's cards, one spawned rank per card (fake/test
    clusters: the traffic then rides NVLink). Wrong sums fail the proof;
    a probe that cannot run (no card, too few cards, a single node)
    records the error and leaves the reachability verdict standing."""
    if os.environ.get("DCN_BANDWIDTH_PROBE", "").lower() != "true":
        return
    try:
        fake_n = int(os.environ.get("DCN_PROBE_FAKE_SLICES", "0") or 0)
        size_mb = float(os.environ.get("DCN_PROBE_SIZE_MB", "64"))
        if fake_n > 1:
            res = multihost.fake_slices_probe(fake_n, size_mb=size_mb)
        else:
            multihost.initialize()
            res = multihost.dcn_allreduce_probe(size_mb=size_mb)
    except Exception as e:
        # a probe that cannot RUN (no visible backend, bad config) is a
        # recorded error, not a failed proof — reachability stands; only
        # a probe that ran and moved WRONG DATA fails below
        info["DCN_PROBE_ERROR"] = f"{type(e).__name__}: {e}"
        return
    if not res.correct:
        raise ValidationFailed("DCN all-reduce produced wrong values")
    info["DCN_SLICES"] = str(res.slices)
    info["DCN_BUS_GBPS"] = f"{res.bus_bw_gbps:.2f}"
    # DCN_THRESHOLD (GB/s bus bandwidth): absolute, not a fraction of a
    # peak — the inter-node fabric's peak is not visible from the node.
    # Off unless set: reachability plus correct data is the contract.
    thr_s = os.environ.get("DCN_THRESHOLD", "")
    if thr_s:
        thr = float(thr_s)
        if res.bus_bw_gbps < thr:
            raise ValidationFailed(
                f"DCN all-reduce bus bandwidth {res.bus_bw_gbps:.2f} is "
                f"below the {thr:g} DCN_THRESHOLD")


def component_cleanup() -> None:
    barrier.cleanup_all()
    log.info("validation status files removed")
