"""Node-level operand agents: the container entry points of the operand
DaemonSets.

Counterpart of ``tpu_operator/cli/node_agents.py``:

- ``gpu-driver-manager preflight``: close every validation gate before
  the driver agent (re)proves the driver, so the operands re-prove
  against the new one (the k8s-driver-manager initContainer's role).
- ``gpu-driver-install run|verify``: find the user-space driver
  (``libcuda.so.1`` under INSTALL_DIR, else on the loader's path),
  ``dlopen`` it and ask ``cuDriverGetVersion``, read NVML's driver
  version, fail where GPU_DRIVER_VERSION pins another, and open the
  ``.driver-ctr-ready`` gate with LIBCUDA_PATH, DRIVER_VERSION and
  CUDA_DRIVER_VERSION. The reference copies a bundled libtpu.so into the
  host; this agent copies nothing: NVIDIA's user-space driver must match
  the loaded kernel module, and the host installs the two together.
- ``gpu-runtime-setup run|verify``: the device nodes a container needs
  (the cards' ``/dev/nvidia<minor>`` from the device plugin's discovery,
  plus the control nodes) written to /run/nvidia/gpu-env;
  DEVICE_PATH_GLOB narrows the card list and never widens it. ``verify``
  also opens each node.
- ``gpu-device-plugin`` / ``gpu-isolated-device-plugin``: serve the
  shared and the isolated pool; the shared plugin picks its per-node
  config by the ``gpu.graft.dev/device-plugin.config`` label.
- ``gpu-topology-manager``: group the node's cards by the profile its
  ``gpu.graft.dev/slice.config`` label names (``topology.manager``).

Run as ``python -m tpu_operator_torch.cli.node_agents <agent> [args]``,
or under the agent's name as argv[0].
"""

from __future__ import annotations

import argparse
import ctypes
import fnmatch
import logging
import os
import sys
import time
from typing import Optional, Tuple

from ..validator import barrier

log = logging.getLogger("gpu_node_agent")


def _park() -> None:  # pragma: no cover - container main loop
    while True:
        time.sleep(3600)


# ---------------------------------------------------------------------------
# gpu-driver-manager
# ---------------------------------------------------------------------------


def driver_manager_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-driver-manager")
    p.add_argument("action", choices=["preflight"])
    p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # close every gate: each operand re-validates against the driver
    # about to be (re)proved (the list lives in barrier.KNOWN_STATUS_FILES)
    barrier.cleanup_all()
    log.info("preflight: validation gates closed for the driver")
    return 0


# ---------------------------------------------------------------------------
# gpu-driver-install
# ---------------------------------------------------------------------------


LIBCUDA = "libcuda.so.1"


def _loaded_path(name: str) -> Optional[str]:
    """Where the loader found ``name`` in this process (/proc/self/maps)."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1] if line.strip() else ""
                if os.path.basename(path).startswith(name):
                    return path
    except OSError:
        pass
    return None


def find_libcuda(install_dir: str) -> Tuple[str, ctypes.CDLL]:
    """(path, handle) of the user-space driver: ``libcuda.so.1`` under
    ``install_dir`` (or its lib64/), else the one the loader finds."""
    for cand in (os.path.join(install_dir, LIBCUDA),
                 os.path.join(install_dir, "lib64", LIBCUDA)):
        if os.path.exists(cand):
            return cand, ctypes.CDLL(cand)
    lib = ctypes.CDLL(LIBCUDA)  # OSError when the loader has none
    return _loaded_path("libcuda.so") or LIBCUDA, lib


def cuda_driver_version(lib: ctypes.CDLL) -> int:
    """``cuDriverGetVersion``: 1000 * major + 10 * minor (13000 = 13.0).
    Needs no cuInit and opens no context."""
    fn = lib.cuDriverGetVersion
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    version = ctypes.c_int(0)
    rc = fn(ctypes.byref(version))
    if rc != 0:
        raise OSError(f"cuDriverGetVersion failed (CUresult {rc})")
    return version.value


def verify_driver(install_dir: str,
                  pinned: str = "") -> dict:
    """The ``.driver-ctr-ready`` payload; raises OSError when the driver
    cannot be loaded, NVML gives no version, or ``pinned`` differs."""
    from ..deviceplugin.plugin import nvml_inventory

    path, lib = find_libcuda(install_dir)
    cuda = cuda_driver_version(lib)
    driver = nvml_inventory().driver_version
    if not driver:
        raise OSError("NVML reports no driver version "
                      "(nvmlSystemGetDriverVersion)")
    if pinned and pinned != driver:
        raise OSError(f"driver {driver} is loaded, GPU_DRIVER_VERSION "
                      f"pins {pinned}")
    return {"LIBCUDA_PATH": path, "DRIVER_VERSION": driver,
            "CUDA_DRIVER_VERSION": str(cuda)}


def driver_install_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-driver-install")
    p.add_argument("action", choices=["run", "verify"])
    p.add_argument("--no-park", action="store_true",
                   help="exit after the proof instead of sleeping (tests)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    install_dir = os.environ.get("INSTALL_DIR", "/usr/local/nvidia/lib64")
    try:
        info = verify_driver(install_dir,
                             os.environ.get("GPU_DRIVER_VERSION", ""))
    except OSError as e:
        log.error("driver check failed: %s", e)
        return 1
    barrier.write_status(".driver-ctr-ready", info)
    log.info("driver %s ready (%s); gate .driver-ctr-ready open",
             info["DRIVER_VERSION"], info["LIBCUDA_PATH"])
    if args.action == "run" and not args.no_park:
        _park()  # pragma: no cover
    return 0


# ---------------------------------------------------------------------------
# gpu-runtime-setup
# ---------------------------------------------------------------------------


def runtime_setup_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-runtime-setup")
    p.add_argument("action", choices=["run", "verify"])
    p.add_argument("--no-park", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from ..deviceplugin.plugin import (CONTROL_NODES, card_inventory,
                                       device_host_path)

    # the device plugin's discovery, so the runtime contract and the
    # allocations name the same nodes
    devices = [device_host_path(c) for c in card_inventory().cards
               if c.minor is not None]
    pattern = os.environ.get("DEVICE_PATH_GLOB")
    if pattern:
        devices = [d for d in devices if fnmatch.fnmatch(d, pattern)]
    if not devices:
        log.error("no card device nodes found (NVML inventory%s)",
                  f", narrowed by {pattern}" if pattern else "")
        return 1
    if args.action == "verify" and not os.environ.get("GPU_FAKE_CHIPS"):
        from ..validator.components import device_node_error

        errors = [e for e in map(device_node_error,
                                 devices + [CONTROL_NODES[0]]) if e]
        if errors:
            log.error("device nodes not usable: %s", errors)
            return 1
    env_file = os.path.normpath(
        os.path.join(str(barrier.validation_dir()), "..", "gpu-env"))
    os.makedirs(os.path.dirname(env_file), exist_ok=True)
    with open(env_file, "w") as f:
        f.write(f"GPU_DEVICES={','.join(devices)}\n")
        f.write(f"GPU_CONTROL_DEVICES={','.join(CONTROL_NODES)}\n")
        for key in ("GPU_TOPOLOGY", "GPU_WORKER_ID", "GPU_ACCELERATOR_TYPE"):
            if os.environ.get(key):
                f.write(f"{key}={os.environ[key]}\n")
    log.info("runtime contract written to %s (%d devices)", env_file,
             len(devices))
    if args.action == "run" and not args.no_park:
        _park()  # pragma: no cover
    return 0


# ---------------------------------------------------------------------------
# gpu-device-plugin
# ---------------------------------------------------------------------------


def _node_config_selector():
    """The per-node plugin config's selector: this Node's
    ``gpu.graft.dev/device-plugin.config`` label, read through the
    in-cluster client. None off-cluster or without NODE_NAME (the default
    config then applies)."""
    node_name = os.environ.get("NODE_NAME")
    if not node_name:
        return None
    from ..api import labels as L
    from ..runtime.kubeclient import InClusterClient

    try:
        client = InClusterClient.from_env()
    except Exception as e:
        log.warning("no cluster client for config selection (%s); "
                    "per-node label selection disabled", e)
        return None

    def selector():
        # metadata only: polling one label each health tick must not
        # pull the whole Node (status.images alone can be tens of KB)
        node = client.get("v1", "Node", node_name, metadata_only=True)
        return ((node.get("metadata") or {}).get("labels")
                or {}).get(L.DEVICE_PLUGIN_CONFIG)

    return selector


def device_plugin_main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    from ..deviceplugin.plugin import DEFAULT_RESOURCE, GpuDevicePlugin

    plugin = GpuDevicePlugin(
        resource_name=os.environ.get("RESOURCE_NAME", DEFAULT_RESOURCE),
        config_selector=_node_config_selector())
    try:
        plugin.serve_forever(register=True)
    except KeyboardInterrupt:
        plugin.stop()
    return 0


def isolated_device_plugin_main(argv=None) -> int:
    """The sandbox-device-plugin slot: serve the fenced/vGPU pool."""
    logging.basicConfig(level=logging.INFO)
    from ..deviceplugin.plugin import IsolatedGpuDevicePlugin

    plugin = IsolatedGpuDevicePlugin(
        resource_name=os.environ.get("RESOURCE_NAME"),
        vgpu_resource_name=os.environ.get("VGPU_RESOURCE_NAME"))
    try:
        plugin.serve_forever(register=True)
    except KeyboardInterrupt:
        plugin.stop()
    return 0


def topology_manager_main(argv=None) -> int:
    """The mig-manager slot: group the node's cards by profile."""
    from ..topology.manager import main

    return main()


MAINS = {
    "gpu-driver-manager": driver_manager_main,
    "gpu-driver-install": driver_install_main,
    "gpu-runtime-setup": runtime_setup_main,
    "gpu-device-plugin": device_plugin_main,
    "gpu-isolated-device-plugin": isolated_device_plugin_main,
    "gpu-topology-manager": topology_manager_main,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = os.path.basename(sys.argv[0])
    if prog in MAINS:
        return MAINS[prog](argv)
    if argv and argv[0] in MAINS:
        return MAINS[argv[0]](argv[1:])
    print(f"usage: node_agents {{{','.join(MAINS)}}} [args]",
          file=sys.stderr)
    return 2


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
