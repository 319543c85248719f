"""CUDA kubelet device plugins: ``nvidia.com/gpu``, and the isolated pool
(``nvidia.com/gpu-isolated`` whole, or ``nvidia.com/vgpu`` fractions).

Counterpart of ``tpu_operator/deviceplugin/plugin.py`` (the
k8s-device-plugin and sandbox-device-plugin slots). A gRPC server on a
unix socket under /var/lib/kubelet/device-plugins/ registers with
kubelet and serves the v1beta1 DevicePlugin API.

The plugin's core needs neither grpc nor protobuf: discovery, health,
preferred allocation and ``allocate`` (a ``ContainerAllocation`` of
device specs and envs) are plain Python over plain dataclasses. The RPC
methods convert to and from the v1beta1 messages (``api_pb2``), and grpc
and protobuf are imported where the server starts or a message is built.

Card identity: a device is ``gpu<i>``, ``i`` being NVML's index (the
chip IDs of the telemetry and the health engine). ``card_inventory``
maps each ID to the card's UUID and minor number through NVML
(``gpu-telemetry --inventory``). The index is neither the minor number
(index 0 may be /dev/nvidia4) nor the CUDA ordinal, so an allocation
names its cards by UUID (``NVIDIA_VISIBLE_DEVICES``, the container
toolkit's contract) and mounts ``/dev/nvidia<minor>``. Nothing here
opens a CUDA context: a plugin holding one on every card would cost
each card hundreds of MB.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import labels as L

log = logging.getLogger("gpu_device_plugin")

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

KUBELET_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET = "kubelet.sock"
PLUGIN_SOCKET = "gpu-device-plugin.sock"
API_VERSION = "v1beta1"
DEFAULT_RESOURCE = L.GPU_RESOURCE
# the driver's control nodes every CUDA process opens besides its card's
CONTROL_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")
INVENTORY_TIMEOUT_S = 30.0

_SVC_PLUGIN = "v1beta1.DevicePlugin"
_SVC_REGISTRATION = "v1beta1.Registration"


class DeviceNotFound(LookupError):
    """An allocation names a device this node cannot hand out."""


# ---------------------------------------------------------------------------
# card inventory and device discovery
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fabric:
    """A card's NVLink fabric registration (nvmlDeviceGetGpuFabricInfoV)."""
    cluster_uuid: str
    clique_id: int
    state: str                 # not_supported|not_started|in_progress|completed
    status: int                # NVML's code for the registration

    @property
    def spans_hosts(self) -> bool:
        """NVML names a cluster: the card's NVLink domain reaches other
        hosts (a single host's NVSwitch fabric registers with a zero
        cluster UUID)."""
        return (self.state == "completed" and self.status == 0
                and self.cluster_uuid.strip("0-") != "")


@dataclass(frozen=True)
class Card:
    id: str                    # gpu<index>
    index: int                 # NVML's index
    uuid: Optional[str]        # GPU-..., None where NVML refused it
    minor: Optional[int]       # /dev/nvidia<minor>
    name: str = ""             # NVML's product name
    memory_total_bytes: int = 0
    # (link, what it reaches: gpu|ibmnpu|nvswitch|unknown, None where
    # refused) of each active NVLink; None where NVML refused the links
    nvlink: Optional[Tuple[Tuple[int, Optional[str]], ...]] = None
    nvlink_peers: Optional[Tuple[str, ...]] = None  # cards over NVLink
    fabric: Optional[Fabric] = None
    # (NVML call, its code; None where the library lacks the call)
    refused: Tuple[Tuple[str, Optional[int]], ...] = ()


@dataclass(frozen=True)
class Inventory:
    cards: Tuple[Card, ...] = ()
    driver_version: str = ""

    def card(self, chip_id: str) -> Optional[Card]:
        return next((c for c in self.cards if c.id == chip_id), None)


def fake_uuid(index: int) -> str:
    return f"GPU-fa4e0000-0000-4000-8000-{index:012d}"


def nvml_inventory() -> Inventory:
    """The host's cards and driver through NVML (``gpu-telemetry
    --inventory``; GPU_TELEMETRY_BIN and GPU_TELEMETRY_NVML move the
    scraper and the library). Empty, with a warning, where NVML cannot
    be read: the node then advertises no card."""
    from ..metrics.gpu_exporter import telemetry_binary

    try:
        out = subprocess.run([telemetry_binary(), "--inventory"],
                             capture_output=True, text=True,
                             timeout=INVENTORY_TIMEOUT_S)
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        log.warning("NVML inventory unavailable: %s", e)
        return Inventory()
    if out.returncode != 0:
        log.warning("gpu-telemetry --inventory failed (%d): %s",
                    out.returncode, out.stderr.strip()[-500:])
        return Inventory()
    doc = json.loads(out.stdout)
    return Inventory(tuple(map(_card_of, doc.get("cards", []))),
                     doc.get("driver_version") or "")


def _card_of(c: dict) -> Card:
    """One card of ``gpu-telemetry --inventory``'s JSON."""
    links = c.get("nvlink")
    peers = c.get("nvlink_peers")
    fabric = c.get("fabric")
    return Card(
        c["chip_id"], int(c["index"]), c.get("uuid"), c.get("minor"),
        c.get("name") or "", int(c.get("memory_total_bytes") or 0),
        nvlink=None if links is None else tuple(
            (int(ln["link"]), ln.get("remote")) for ln in links),
        nvlink_peers=None if peers is None else tuple(peers),
        fabric=None if fabric is None else Fabric(
            fabric["cluster_uuid"], int(fabric["clique_id"]),
            fabric["state"], int(fabric["status"])),
        refused=tuple((c.get("refused") or {}).items()))


FAKE_NVLINKS = 18  # an H100 SXM's links, each to an NVSwitch


def card_inventory() -> Inventory:
    """GPU_FAKE_CHIPS=N (tests, fake clusters: gpu0..gpuN-1, fake UUIDs,
    minor = index, an HGX node's NVLink facts: every link to an NVSwitch,
    every other card a peer, a single-host fabric), else NVML."""
    fake = os.environ.get("GPU_FAKE_CHIPS")
    if fake:
        n = int(fake)
        ids = [f"gpu{i}" for i in range(n)]
        fabric = Fabric("00000000-0000-0000-0000-000000000000", 0,
                        "completed", 0)
        return Inventory(tuple(
            Card(ids[i], i, fake_uuid(i), i,
                 nvlink=tuple((ln, "nvswitch") for ln in range(FAKE_NVLINKS)),
                 nvlink_peers=tuple(c for c in ids if c != ids[i]),
                 fabric=fabric)
            for i in range(n)))
    return nvml_inventory()


def discover_chips() -> List[str]:
    """Card IDs on this host, in NVML's index order."""
    return [c.id for c in card_inventory().cards]


REPLICA_SEP = "::"  # replica ID convention: <unit>::r<j>


def sharing_replicas() -> int:
    """Replication factor for time-shared cards: each allocation unit is
    advertised N times so N pods can time-share a card. 1 = exclusive."""
    try:
        n = int(os.environ.get("SHARING_REPLICAS", "1"))
    except ValueError:
        return 1
    return max(1, n)


@dataclass(frozen=True)
class Device:
    """One advertised unit, under the v1beta1 message's field names."""
    ID: str
    health: str = HEALTHY


@dataclass
class DeviceSpec:
    container_path: str
    host_path: str
    permissions: str = "rw"


@dataclass
class ContainerAllocation:
    devices: List[DeviceSpec] = field(default_factory=list)
    envs: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# per-node plugin config (devicePlugin.config ConfigMap slot)
# ---------------------------------------------------------------------------


class PluginConfig:
    """One named config from the devicePlugin.config ConfigMap; the
    plugin process selects it by node label and live-reloads it. Keys
    (YAML): ``sharingPolicy`` (exclusive|time-shared) and
    ``sharingReplicas``."""

    def __init__(self, name: str, sharing_policy: str = "exclusive",
                 sharing_replicas: int = 1):
        self.name = name
        self.sharing_policy = sharing_policy
        self.sharing_replicas = max(1, int(sharing_replicas))

    @property
    def effective_replicas(self) -> int:
        return self.sharing_replicas \
            if self.sharing_policy == "time-shared" else 1

    def __eq__(self, other):
        return isinstance(other, PluginConfig) and vars(self) == vars(other)

    def __repr__(self):
        return (f"PluginConfig({self.name!r}, {self.sharing_policy!r}, "
                f"replicas={self.sharing_replicas})")


def parse_plugin_config(name: str, text: str) -> PluginConfig:
    import yaml

    raw = yaml.safe_load(text) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"config {name!r} must be a mapping")
    policy = raw.get("sharingPolicy", "exclusive")
    if policy not in ("exclusive", "time-shared"):
        raise ValueError(f"config {name!r}: unknown sharingPolicy "
                         f"{policy!r} (exclusive|time-shared)")
    try:
        replicas = int(raw.get("sharingReplicas") or 1)
    except (TypeError, ValueError):
        raise ValueError(f"config {name!r}: sharingReplicas must be an "
                         f"integer, got {raw.get('sharingReplicas')!r}")
    return PluginConfig(name, sharing_policy=policy,
                        sharing_replicas=replicas)


def read_plugin_config(config_dir: str, name: str) -> PluginConfig:
    """One named config from the mounted ConfigMap directory (kubelet
    keeps the mount in sync, so a re-read sees updates)."""
    with open(os.path.join(config_dir, name)) as f:
        return parse_plugin_config(name, f.read())


def slice_groups() -> Optional[Dict[str, List[str]]]:
    """slice-unit ID -> member card IDs, from the topology manager's slice
    file (GPU_SLICE_FILE)."""
    from ..topology.manager import DEFAULT_SLICE_FILE, read_slice_file

    cfg = read_slice_file(os.environ.get("GPU_SLICE_FILE",
                                         DEFAULT_SLICE_FILE))
    if not cfg or not cfg.get("groups"):
        return None
    if int(cfg.get("subslices", 1)) <= 1:
        return None  # full profile: advertise per card
    return {f"slice{i}": g for i, g in enumerate(cfg["groups"])}


def discover_devices(replicas: Optional[int] = None) -> List[Device]:
    """Advertised allocation units: each card, or each slice group when a
    slice file groups them (allocating a unit grants all its cards),
    each advertised ``sharing_replicas()`` times (or ``replicas``, a
    per-node config's). Fenced cards never appear: they belong to the
    isolated plugin's pool."""
    from ..isolation.fencing import fenced_chips

    fenced = set(fenced_chips())
    groups = slice_groups()
    if groups:
        units = [u for u, members in groups.items()
                 if not fenced.intersection(members)]
    else:
        units = [c for c in discover_chips() if c not in fenced]
    n = sharing_replicas() if replicas is None else max(1, replicas)
    if n > 1:
        return [Device(f"{u}{REPLICA_SEP}r{j}") for u in units
                for j in range(n)]
    return [Device(u) for u in units]


def expand_to_chips(device_ids: List[str]) -> List[str]:
    """Replica IDs collapse to their unit; slice units expand to member
    cards; duplicates (two replicas of one card) dedup."""
    groups = slice_groups() or {}
    chips: List[str] = []
    for device_id in device_ids:
        unit = device_id.split(REPLICA_SEP, 1)[0]
        for chip in groups.get(unit, [unit]):
            if chip not in chips:
                chips.append(chip)
    return chips


def identified_card(inventory: Inventory, chip_id: str) -> Card:
    """The card ``chip_id`` names, with the UUID and minor number an
    allocation needs; DeviceNotFound otherwise."""
    card = inventory.card(chip_id)
    if card is None:
        raise DeviceNotFound(
            f"card {chip_id!r} is not on this node (NVML lists "
            f"{[c.id for c in inventory.cards]})")
    if not card.uuid or card.minor is None:
        raise DeviceNotFound(
            f"card {chip_id!r}: NVML gave no UUID or minor number")
    return card


def device_host_path(card: Card) -> str:
    return f"/dev/nvidia{card.minor}"


def allocation_for(cards: List[Card],
                   envs: Optional[Dict[str, str]] = None
                   ) -> ContainerAllocation:
    """The cards' nodes, the control nodes and the UUID contract."""
    specs = [DeviceSpec(device_host_path(c), device_host_path(c))
             for c in cards]
    specs += [DeviceSpec(p, p) for p in CONTROL_NODES]
    out = {"NVIDIA_VISIBLE_DEVICES": ",".join(c.uuid for c in cards)}
    out.update(envs or {})
    return ContainerAllocation(specs, out)


# ---------------------------------------------------------------------------
# per-device health
# ---------------------------------------------------------------------------


FAIL_STATUS = "fail"  # health_engine.FAIL, without importing the exporter


def health_engine_chip_status(timeout: float = 2.0) -> Dict[str, str]:
    """chip_id -> ok|warn|fail from the node's health engine
    (``GPU_HEALTH_ENGINE_INFO``, host:port). Unset or unreachable gives
    {}: no verdicts, not all-unhealthy, since a telemetry outage must
    not deschedule a node's cards."""
    info = os.environ.get("GPU_HEALTH_ENGINE_INFO")
    if not info:
        return {}
    import urllib.error
    import urllib.request

    url = f"http://{info}/v1/health"
    try:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                doc = json.loads(r.read())
        except urllib.error.HTTPError as e:
            # the engine answers 503 when a card FAILs: that body is the
            # verdict payload, not an outage
            doc = json.loads(e.read())
    except Exception as e:
        log.warning("health engine %s unreachable (%s); no verdicts", info, e)
        return {}
    return {c.get("chip_id", ""): c.get("status", "ok")
            for c in doc.get("chips", [])}


# ---------------------------------------------------------------------------
# isolated pool (sandbox-device-plugin slot)
# ---------------------------------------------------------------------------


def discover_isolated_devices() -> List[Device]:
    """The isolated plugin's inventory: vGPUs where the vGPU manager has
    published them, else the fenced cards whole. Empty before the fence
    exists."""
    from ..isolation.fencing import fenced_chips
    from ..isolation.vgpu import read_vgpu_file

    vgpu = read_vgpu_file()
    if vgpu and vgpu.get("devices"):
        return [Device(d["id"]) for d in vgpu["devices"]]
    return [Device(c) for c in fenced_chips()]


def vgpu_lookup() -> Dict[str, dict]:
    """vGPU device ID -> its inventory entry (chip, mem_mb, fraction)."""
    from ..isolation.vgpu import read_vgpu_file

    vgpu = read_vgpu_file()
    if not vgpu:
        return {}
    return {d["id"]: d for d in vgpu.get("devices", [])}


# ---------------------------------------------------------------------------
# the plugins
# ---------------------------------------------------------------------------


def _replica_sort_key(device_id: str):
    """(replica index, unit): all r0s across units sort before any r1."""
    unit, _, rep = device_id.partition(REPLICA_SEP)
    try:
        idx = int(rep.lstrip("r")) if rep else 0
    except ValueError:
        idx = 0
    return (idx, unit)


def _pb():
    from . import api_pb2

    return api_pb2


class GpuDevicePlugin:
    """The DevicePlugin service and the kubelet registration client."""

    def __init__(self, resource_name: str = DEFAULT_RESOURCE,
                 socket_dir: str = KUBELET_SOCKET_DIR,
                 plugin_socket: str = PLUGIN_SOCKET,
                 discover: Optional[Callable[[], List[Device]]] = None,
                 health_interval_s: float = 30.0,
                 config_dir: Optional[str] = None,
                 default_config: Optional[str] = None,
                 config_selector: Optional[
                     Callable[[], Optional[str]]] = None,
                 health_source: Optional[
                     Callable[[], Dict[str, str]]] = None):
        self.resource_name = resource_name
        # chip_id -> ok|warn|fail; by default the node's health engine
        # where GPU_HEALTH_ENGINE_INFO is set
        self.health_source = health_source or health_engine_chip_status
        # unit -> last advertised device IDs: a unit that leaves discovery
        # without a reason (fenced away, slice regrouping) is advertised
        # Unhealthy instead of silently shrinking the list, so kubelet
        # stops scheduling onto it and the operator can see why
        self._seen_units: Dict[str, List[str]] = {}
        self._group_sig: Optional[tuple] = None
        self.socket_dir = socket_dir
        self.plugin_socket = plugin_socket
        self.discover = discover or self._default_discover
        self.health_interval_s = health_interval_s
        # per-node config ConfigMap: its mount, default key, and the
        # selector naming this node's config (the node-label watcher of
        # the CLI entry point; None -> env and default)
        self.config_dir = config_dir \
            if config_dir is not None \
            else os.environ.get("GPU_PLUGIN_CONFIG_DIR")
        self.default_config = default_config \
            if default_config is not None \
            else os.environ.get("GPU_PLUGIN_CONFIG_DEFAULT")
        self.config_selector = config_selector
        self.plugin_config: Optional[PluginConfig] = None
        self._devices: List[Device] = []
        self._cond = threading.Condition()
        self._stopped = threading.Event()
        self._reregister = threading.Event()  # force a kubelet re-register
        self._server = None
        self.allocations: List[Dict] = []  # audit trail of Allocate calls

    # -- the core ----------------------------------------------------------

    def devices(self) -> List[Device]:
        with self._cond:
            return list(self._devices)

    def preferred_allocation(self, available: List[str], must: List[str],
                             size: int) -> List[str]:
        """Low-numbered cards first; with sharing, spread across distinct
        units first so one request never time-shares a card with
        itself."""
        ids = sorted(available, key=_replica_sort_key)
        must = list(must)
        picked = must + [i for i in ids if i not in must]
        return picked[:size]

    def allocate(self, device_ids: List[str]) -> ContainerAllocation:
        chips = expand_to_chips(list(device_ids))
        inventory = card_inventory()
        cards = [identified_card(inventory, c) for c in chips]
        alloc = allocation_for(cards)
        self.allocations.append({"devices": list(device_ids),
                                 "chips": chips})
        log.info("allocated %s -> cards %s", list(device_ids), chips)
        return alloc

    # -- DevicePlugin RPCs: v1beta1 messages around the core ---------------

    def GetDevicePluginOptions(self, request, context):
        return _pb().DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        """The device list, then an update whenever it changes (kubelet
        keeps the stream open for the plugin's lifetime). The yield is
        outside the lock: gRPC may park the generator on a stalled peer,
        and holding the lock there would deadlock refresh_devices() and
        stop()."""
        pb = _pb()
        last: Optional[List[tuple]] = None
        while not self._stopped.is_set():
            response = None
            with self._cond:
                snapshot = [(d.ID, d.health) for d in self._devices]
                if snapshot != last:
                    last = snapshot
                    response = pb.ListAndWatchResponse(devices=[
                        pb.Device(ID=i, health=h) for i, h in snapshot])
                else:
                    self._cond.wait(timeout=1.0)
            if response is not None:
                yield response

    def GetPreferredAllocation(self, request, context):
        resp = _pb().PreferredAllocationResponse()
        for creq in request.container_requests:
            resp.container_responses.add(deviceIDs=self.preferred_allocation(
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs), creq.allocation_size))
        return resp

    def Allocate(self, request, context):
        resp = _pb().AllocateResponse()
        for creq in request.container_requests:
            try:
                alloc = self.allocate(list(creq.devicesIDs))
            except DeviceNotFound as e:
                # fail the RPC cleanly rather than hand the container a
                # device path that does not exist
                log.error("%s", e)
                if context is not None:
                    import grpc

                    context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                raise
            cresp = resp.container_responses.add()
            for spec in alloc.devices:
                cresp.devices.add(container_path=spec.container_path,
                                  host_path=spec.host_path,
                                  permissions=spec.permissions)
            cresp.envs.update(alloc.envs)
        return resp

    def PreStartContainer(self, request, context):
        return _pb().PreStartContainerResponse()

    # -- lifecycle ---------------------------------------------------------

    def _handlers(self):
        import grpc

        pb = _pb()

        def unary(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        return grpc.method_handlers_generic_handler(_SVC_PLUGIN, {
            "GetDevicePluginOptions": unary(self.GetDevicePluginOptions,
                                            pb.Empty, pb.DevicePluginOptions),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                self.ListAndWatch, request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ListAndWatchResponse.SerializeToString),
            "GetPreferredAllocation": unary(self.GetPreferredAllocation,
                                            pb.PreferredAllocationRequest,
                                            pb.PreferredAllocationResponse),
            "Allocate": unary(self.Allocate, pb.AllocateRequest,
                              pb.AllocateResponse),
            "PreStartContainer": unary(self.PreStartContainer,
                                       pb.PreStartContainerRequest,
                                       pb.PreStartContainerResponse),
        })

    @property
    def socket_path(self) -> str:
        return os.path.join(self.socket_dir, self.plugin_socket)

    def _default_discover(self) -> List[Device]:
        cfg = self.plugin_config
        return discover_devices(
            replicas=cfg.effective_replicas if cfg else None)

    def reload_plugin_config(self) -> bool:
        """Re-resolve this node's named config; True if it changed. Any
        failure, of the selector (an apiserver read) or of the config
        file (missing, invalid), keeps the last good config: shrinking
        kubelet's capacity over a transient read error would reject pods
        for nothing."""
        if not self.config_dir:
            return False
        if self.config_selector is not None:
            try:
                selected = self.config_selector()
            except Exception as e:
                log.warning("config selector failed (%s); keeping %r",
                            e, self.plugin_config)
                return False
        else:
            selected = None
        # selector None = genuinely unlabelled -> static env, then default
        name = selected or os.environ.get("GPU_PLUGIN_CONFIG_SELECT") \
            or self.default_config or None
        if not name:
            changed = self.plugin_config is not None
            self.plugin_config = None
            return changed
        try:
            cfg = read_plugin_config(self.config_dir, name)
        except Exception as e:  # OSError, YAMLError, ValueError, TypeError
            log.warning("plugin config %r unusable (%s); keeping %r",
                        name, e, self.plugin_config)
            return False
        if cfg != self.plugin_config:
            log.info("plugin config now %r (was %r)", cfg,
                     self.plugin_config)
            self.plugin_config = cfg
            return True
        return False

    def _chip_status(self) -> Dict[str, str]:
        try:
            return self.health_source() or {}
        except Exception as e:
            log.warning("health source failed (%s); no verdicts", e)
            return {}

    def _apply_health(self, devices: List[Device]) -> List[Device]:
        """Health-engine verdicts and vanished-unit tracking. A unit with
        a FAILing member card goes Unhealthy; a unit that leaves
        discovery stays advertised Unhealthy until it returns, unless it
        left for a reason: fenced into the isolated pool, or a slice
        regrouping renamed it."""
        from ..isolation.fencing import fenced_chips

        status = self._chip_status()
        groups = slice_groups() or {}
        fenced = set(fenced_chips())
        out: List[Device] = []
        seen_now: Dict[str, List[str]] = {}
        for d in devices:
            unit = d.ID.split(REPLICA_SEP, 1)[0]
            members = groups.get(unit, [unit])
            bad = any(status.get(m) == FAIL_STATUS for m in members)
            out.append(Device(d.ID, UNHEALTHY if bad else d.health))
            seen_now.setdefault(unit, []).append(d.ID)
        # a slice regroup renames every unit: stale IDs are not vanished
        # hardware, so tracking starts over
        sig = tuple(sorted(groups)) if groups else None
        if sig != self._group_sig:
            self._group_sig = sig
            self._seen_units = {}
        for unit, ids in self._seen_units.items():
            if unit in seen_now:
                continue
            if set(groups.get(unit, [unit])) & fenced:
                continue  # moved to the isolated pool, not dead
            for device_id in ids:
                out.append(Device(device_id, UNHEALTHY))
            seen_now[unit] = list(ids)
            log.warning("unit %s vanished from discovery; advertising "
                        "Unhealthy", unit)
        self._seen_units = seen_now
        return out

    def refresh_devices(self) -> None:
        self.reload_plugin_config()
        devices = self._apply_health(self.discover())
        with self._cond:
            if devices != self._devices:
                self._devices = devices
                log.info("device inventory: %s",
                         [(d.ID, d.health) for d in devices])
            self._cond.notify_all()

    def _health_loop(self):
        while not self._stopped.wait(self.health_interval_s):
            try:
                self.refresh_devices()
            except Exception:
                log.exception("device re-discovery failed")

    def _converge_node_regime(self) -> None:
        """This plugin runs only on container-routed nodes, so isolation
        files found here are leftovers of a node that left the isolated
        plane (whose DaemonSets are gone and cannot withdraw them).
        Withdrawing them at start is the plane's exit path."""
        from ..isolation.fencing import fencing_file_path
        from ..isolation.vgpu import vgpu_file_path

        for path in (fencing_file_path(), vgpu_file_path()):
            try:
                os.unlink(path)
                log.info("withdrew stale isolation file %s (node is "
                         "container-routed)", path)
            except FileNotFoundError:
                pass

    def start(self) -> None:
        import grpc
        from concurrent import futures

        os.makedirs(self.socket_dir, exist_ok=True)
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        self._converge_node_regime()
        self.refresh_devices()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        threading.Thread(target=self._health_loop, daemon=True).start()
        log.info("device plugin serving on %s (%d devices)",
                 self.socket_path, len(self._devices))

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None,
                              timeout: float = 10.0) -> None:
        """Dial kubelet's registration socket and announce ourselves."""
        import grpc

        pb = _pb()
        sock = kubelet_socket or os.path.join(self.socket_dir, KUBELET_SOCKET)
        with grpc.insecure_channel(f"unix://{sock}") as channel:
            grpc.channel_ready_future(channel).result(timeout=timeout)
            register = channel.unary_unary(
                f"/{_SVC_REGISTRATION}/Register",
                request_serializer=pb.RegisterRequest.SerializeToString,
                response_deserializer=pb.Empty.FromString)
            register(pb.RegisterRequest(
                version=API_VERSION,
                endpoint=self.plugin_socket,
                resource_name=self.resource_name,
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=True)),
                timeout=timeout)
        log.info("registered %s with kubelet", self.resource_name)

    def stop(self) -> None:
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()
        if self._server:
            self._server.stop(grace=1.0)

    def serve_forever(self, register: bool = True,
                      poll_s: float = 5.0) -> None:
        """The DaemonSet container's loop: serve, register, and recover
        from kubelet restarts. A restarting kubelet wipes the
        device-plugins directory (our socket with it) and recreates
        kubelet.sock, so on either signal the plugin re-binds its socket
        first and then re-registers; re-registering alone would advertise
        a dead endpoint."""
        self.start()
        kubelet_sock = os.path.join(self.socket_dir, KUBELET_SOCKET)
        registered_ino = None
        while not self._stopped.is_set():
            if not os.path.exists(self.socket_path):
                log.warning("plugin socket vanished (kubelet restart?); "
                            "re-binding %s", self.socket_path)
                if self._server:
                    self._server.stop(grace=1.0)
                self._stopped.clear()
                self.start()
                registered_ino = None  # force re-registration below
            if register and os.path.exists(kubelet_sock):
                try:
                    ino = os.stat(kubelet_sock).st_ino
                except OSError:
                    ino = None
                if ino is not None and (ino != registered_ino
                                        or self._reregister.is_set()):
                    try:
                        self.register_with_kubelet()
                        registered_ino = ino
                        self._reregister.clear()
                    except Exception as e:
                        log.warning("kubelet registration failed: %s", e)
            self._stopped.wait(poll_s)


class IsolatedGpuDevicePlugin(GpuDevicePlugin):
    """The plugin of the fenced pool (the sandbox-device-plugin slot):
    whole fenced cards as ``nvidia.com/gpu-isolated``, or vGPU fractions
    as ``nvidia.com/vgpu`` once the vGPU manager has published a
    profile.

    A vGPU allocation grants the backing card's node and a memory
    budget that PyTorch's caching allocator enforces in the container
    (``PYTORCH_CUDA_ALLOC_CONF=per_process_memory_fraction:<f>``, with
    ``GPU_MEM_LIMIT_MB`` beside it)."""

    ISOLATED_RESOURCE = L.GPU_ISOLATED_RESOURCE
    VGPU_RESOURCE = L.VGPU_RESOURCE
    ISOLATED_SOCKET = "gpu-isolated-device-plugin.sock"

    def __init__(self, resource_name: Optional[str] = None,
                 vgpu_resource_name: Optional[str] = None, **kw):
        self._whole_resource = resource_name or self.ISOLATED_RESOURCE
        self._vgpu_resource = vgpu_resource_name or self.VGPU_RESOURCE
        kw.setdefault("plugin_socket", self.ISOLATED_SOCKET)
        kw.setdefault("discover", discover_isolated_devices)
        super().__init__(resource_name=self._pick_resource(), **kw)

    def _pick_resource(self) -> str:
        return self._vgpu_resource if vgpu_lookup() else self._whole_resource

    def _converge_node_regime(self) -> None:
        # the isolated plugin runs where the fence belongs: never
        # withdraw it here
        pass

    def _apply_health(self, devices: List[Device]) -> List[Device]:
        # a vGPU carries its backing card's health; no vanished-unit
        # tracking: leaving this pool (unfencing, a profile withdrawn) is
        # the normal exit, not a dead card
        status = self._chip_status()
        vgpus = vgpu_lookup()
        return [Device(d.ID, UNHEALTHY
                       if status.get((vgpus.get(d.ID) or {}).get("chip",
                                                                 d.ID))
                       == FAIL_STATUS else d.health)
                for d in devices]

    def refresh_devices(self) -> None:
        # the resource follows the pool's mode: kubelet binds an endpoint
        # to the resource named at Register, so flipping between whole
        # cards and vGPUs must re-register (a new list alone would be
        # advertised under the old name)
        picked = self._pick_resource()
        if picked != self.resource_name:
            self.resource_name = picked
            self._reregister.set()
            log.info("isolated pool mode changed; re-registering as %s",
                     picked)
        super().refresh_devices()

    def allocate(self, device_ids: List[str]) -> ContainerAllocation:
        from ..isolation.fencing import fenced_chips

        vgpus = vgpu_lookup()
        fenced = set(fenced_chips())
        ids = list(device_ids)
        chips: List[str] = []
        per_chip_mem: Dict[str, int] = {}
        per_chip_fraction: Dict[str, float] = {}
        any_vgpu = False
        for device_id in ids:
            entry = vgpus.get(device_id)
            if entry is None and device_id not in fenced:
                raise DeviceNotFound(
                    f"unknown isolated device {device_id!r}: not in the "
                    f"vGPU inventory and not a fenced card (inventory "
                    f"withdrawn?)")
            chip = entry["chip"] if entry else device_id
            if chip not in chips:
                chips.append(chip)
            if entry:
                any_vgpu = True
                per_chip_mem[chip] = per_chip_mem.get(chip, 0) + int(
                    entry.get("mem_mb") or 0)
                per_chip_fraction[chip] = per_chip_fraction.get(
                    chip, 0.0) + float(entry.get("fraction") or 0.0)
        inventory = card_inventory()
        cards = [identified_card(inventory, c) for c in chips]
        envs = {"GPU_WORKLOAD_ISOLATION": "isolated"}
        if any_vgpu:
            mem_total = sum(per_chip_mem.values())
            if mem_total:
                envs["GPU_MEM_LIMIT_MB"] = str(mem_total)
            # the allocator's fraction applies to each card alike, so the
            # safe value is the smallest per-card share in the request:
            # an average would over-grant the card this pod owns less of
            fractions = [f for f in per_chip_fraction.values() if f > 0]
            if fractions and min(fractions) < 1.0:
                envs["PYTORCH_CUDA_ALLOC_CONF"] = (
                    f"per_process_memory_fraction:{min(fractions):.4f}")
        alloc = allocation_for(cards, envs)
        self.allocations.append({"devices": ids, "chips": chips})
        log.info("isolated allocation %s -> cards %s", ids, chips)
        return alloc
