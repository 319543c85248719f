"""``gpuop-cfg``'s cluster verbs and ``gpuop-must-gather`` against a
live mock apiserver (``tests/mock_apiserver.py``, its admission gate
running the port's ``admission_errors`` over the port's CRDs), with
``$KUBECONFIG`` pointing the CLIs at it, and must-gather's bundle
against the JAX package's on mapped FakeClients.

``status`` and must-gather's ``fleet/fleet.json`` read the same
``rollup_nodes`` as ``/debug/fleet``; must-gather's bundle carries the
federation section (``federation/cells.json``), as the reference's does.
"""

import json

import pytest
import yaml

import torch_naming as N
from test_torch_fleet import digest
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.cli import gpuop_cfg as cfg
from tpu_operator_torch.cli import must_gather as mg
from tpu_operator_torch.metrics.fleet import rollup_nodes
from tpu_operator_torch.metrics.health_engine import digest_annotation

NS = "gpu-operator"


def gpu_node(name, status=None, pool=None):
    labels = {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
              L.GKE_ACCELERATOR_COUNT: "8",
              L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
              L.GPU_TOPOLOGY: "nvswitch-8"}
    if pool:
        labels[L.GKE_NODEPOOL] = pool
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels, "annotations": {}},
            "spec": {},
            "status": {"allocatable": {L.GPU_RESOURCE: "8"},
                       "capacity": {L.GPU_RESOURCE: "8"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}
    if status:
        node["metadata"]["annotations"][L.HEALTH_DIGEST] = \
            digest_annotation(digest(status, 4, chips=8))
    return node


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    import mock_apiserver
    from mock_apiserver import MockApiServer

    from tpu_operator_torch.api.validate import admission_errors
    from tpu_operator_torch.runtime.kubeclient import HTTPClient, KubeConfig

    def admission(handler, coll_path, new, old):
        schema = handler.st.schema_for_collection(coll_path)
        return [] if schema is None else admission_errors(new, old, schema)

    monkeypatch.setattr(mock_apiserver._Handler, "_admission", admission)
    srv = MockApiServer().start()
    ops = HTTPClient(KubeConfig(server=srv.url, token="admin",
                                namespace=NS))
    ops.create(gpu_node("gpu-0", "fail", pool="pool-a"))
    ops.create(gpu_node("gpu-1", "ok", pool="pool-a"))
    ops.create(gpu_node("gpu-2"))
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "mock",
        "contexts": [{"name": "mock", "context": {
            "cluster": "mock", "user": "admin", "namespace": NS}}],
        "clusters": [{"name": "mock", "cluster": {"server": srv.url}}],
        "users": [{"name": "admin", "user": {"token": "admin"}}]}))
    monkeypatch.setenv("KUBECONFIG", str(kubeconfig))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    try:
        yield ops
    finally:
        ops.close()
        srv.stop()


def run(argv, capsys, main=cfg.main):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_install_status_diff_upgrade_uninstall(cluster, capsys):
    ops = cluster
    rc, out, _ = run(["status"], capsys)
    assert rc == 1 and "no GPUClusterPolicy/GPUDriver CRs found" in out
    rc, out, _ = run(["status", "-o", "json"], capsys)
    empty = json.loads(out)
    assert rc == 1 and empty["crs"] == [] and empty["ready"] is False
    assert empty["nodes"] == {"gpu": 0, "upgradeStates": {}}
    roll = rollup_nodes(ops.list("v1", "Node"))
    assert empty["fleet"] == {
        "degradedChips": roll["totals"]["degraded_chips"],
        "chips": roll["totals"]["chips"], "condemned": 0,
        "reporting": roll["totals"]["reporting"],
        "worstDomain": roll["worst_domain"]}
    assert empty["fleet"]["chips"] == 24 and \
        empty["fleet"]["worstDomain"] == "pool-a"

    rc, out, _ = run(["install"], capsys)
    assert rc == 0 and "created" in out + _
    crds = ops.list("apiextensions.k8s.io/v1", "CustomResourceDefinition")
    assert {c["metadata"]["name"] for c in crds} == {
        "gpuclusterpolicies.gpu.graft.dev", "gpudrivers.gpu.graft.dev",
        "slicerequests.gpu.graft.dev"}
    live = ops.get("gpu.graft.dev/v1", "GPUClusterPolicy",
                   "gpu-cluster-policy")
    from tpu_operator_torch.api.clusterpolicy import (
        GPUClusterPolicySpec,
        new_cluster_policy,
    )

    assert GPUClusterPolicySpec.from_obj(live).to_obj() == \
        GPUClusterPolicySpec.from_obj(new_cluster_policy()).to_obj()
    rc, out, _ = run(["status"], capsys)
    assert rc == 1 and out.strip().splitlines()[-1] == "NOT READY"
    assert "GPUClusterPolicy/gpu-cluster-policy: unset" in out
    assert "fleet health: 1/24 cards degraded" in out
    rc, out, _ = run(["status", "-o", "json", "--operator-url",
                      "http://127.0.0.1:1"], capsys)
    assert rc == 1 and json.loads(out)["fleet"] == empty["fleet"]

    rc, out, _ = run(["diff"], capsys)
    assert rc == 0, out
    dep = ops.get("apps/v1", "Deployment", "gpu-operator", NS)
    dep["spec"]["replicas"] = 5
    ops.update(dep)
    rc, out, _ = run(["diff"], capsys)
    assert rc == 1 and "Deployment" in out
    rc, _, _ = run(["upgrade"], capsys)
    assert rc == 0
    rc, out, _ = run(["diff"], capsys)
    assert rc == 0, out

    from tpu_operator_torch.api.slicerequest import new_slice_request

    ops.create(new_slice_request("train", namespace="ml", spec={
        "chips": 8, "topology": "nvswitch"}))
    rc, out, _ = run(["slices", "-o", "json"], capsys)
    rows = json.loads(out)["requests"]
    assert rc == 0 and [(r["namespace"], r["name"], r["phase"])
                        for r in rows] == [("ml", "train", "Pending")]
    rc, out, _ = run(["slices", "--migrations"], capsys)
    assert rc == 0 and out.startswith("ml/train: Pending, chips 0")

    rc, _, err = run(["uninstall", "--purge-crds", "--timeout", "10"],
                     capsys)
    assert rc == 0, err
    assert ops.list("apiextensions.k8s.io/v1",
                    "CustomResourceDefinition") == []
    rc, _, _ = run(["status"], capsys)
    assert rc == 1


def test_install_rejects_invalid_values(cluster, capsys, tmp_path):
    bad = tmp_path / "v.yaml"
    bad.write_text(yaml.safe_dump({"clusterPolicy": {"spec": {
        "validator": {"nvlink": {"enabled": False}}}}}))
    rc, _, err = run(["install", "--values", str(bad)], capsys)
    assert rc == 1 and "core proof 'nvlink'" in err
    assert cluster.list("apiextensions.k8s.io/v1",
                        "CustomResourceDefinition") == []


def test_must_gather_over_kubeconfig(cluster, tmp_path, capsys):
    out = tmp_path / "bundle"
    rc = mg.main(["-o", str(out)])
    capsys.readouterr()
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["errors"] == []
    assert summary["federation_rendered"] is True
    assert json.loads((out / "federation" / "cells.json").read_text()) == \
        {"cells": {}, "unrouted": []}
    assert summary["fleet_digests"] == 2
    fleet = json.loads((out / "fleet" / "fleet.json").read_text())
    assert fleet == rollup_nodes(cluster.list("v1", "Node"))
    assert sorted(p.name for p in (out / "fleet" / "digests").iterdir()) == \
        ["gpu-0.json", "gpu-1.json"]
    rc, text, _ = run(["top", "-f", str(out)], capsys)
    assert rc == 0 and "pool-a" in text and "h100-sxm-nvswitch-8" in text


def _bundle_files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file())


def test_must_gather_agrees_with_the_reference(tmp_path):
    """Both packages' bundles from mapped FakeClients: the same files
    under the rule, and the same summary, the federation section
    included."""
    from tpu_operator.api import labels as RL
    from tpu_operator.cli import must_gather as rmg
    from tpu_operator.runtime import FakeClient as RFake
    from tpu_operator_torch.runtime import FakeClient

    ref, port = RFake(), FakeClient()
    ref.add_node("n0", labels={RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
                               RL.GKE_TPU_TOPOLOGY: "2x2x1",
                               RL.GKE_ACCELERATOR_COUNT: "4"},
                 allocatable={"google.com/tpu": "4"})
    port.add_node("n0", labels={L.GKE_ACCELERATOR: "nvidia-h100-80gb",
                                L.GPU_TOPOLOGY: "nvswitch-4",
                                L.GKE_ACCELERATOR_COUNT: "4"},
                  allocatable={L.GPU_RESOURCE: "4"})
    for c, lab in ((ref, RL), (port, L)):
        c.patch("v1", "Node", "n0", {"metadata": {"annotations": {
            lab.HEALTH_DIGEST: digest_annotation(digest("warn", 2))}}})
    rs = rmg.gather(ref, tmp_path / "ref")
    ps = mg.gather(port, tmp_path / "port")
    assert ps["errors"] == rs["errors"] == []
    # the flight recorders are each package's process-wide singletons:
    # their counts are the sections' presence, not a parity figure
    assert set(ps) == set(rs)
    assert ps["federation_rendered"] is rs["federation_rendered"] is True
    assert ps["kinds"] == {N.CRD.get(k, k): v for k, v in rs["kinds"].items()}
    assert ps["fleet_digests"] == rs["fleet_digests"] == 1
    assert _bundle_files(tmp_path / "port") == _bundle_files(
        tmp_path / "ref")
    for side in ("ref", "port"):
        assert json.loads((tmp_path / side / "federation" / "cells.json")
                          .read_text()) == {"cells": {}, "unrouted": []}
    rroll = json.loads((tmp_path / "ref" / "fleet" / "fleet.json")
                       .read_text())
    roll = json.loads((tmp_path / "port" / "fleet" / "fleet.json")
                      .read_text())
    assert roll["totals"] == rroll["totals"]
    assert list(roll["domains"]) == ["h100-sxm-nvswitch-4"]
    assert N.CLIS["tpuop-must-gather"] == "gpuop-must-gather"


def test_operator_serves_debug_fleet(tmp_path):
    """``gpu-operator``'s wiring (``wire_manager``, as ``--fake-cluster``
    runs it) answers ``/debug/fleet`` with the fold of its cache."""
    import urllib.request

    from tpu_operator_torch.cli import operator as op
    from tpu_operator_torch.metrics.fleet import FLEET_TELEMETRY
    from tpu_operator_torch.runtime import FakeClient

    FLEET_TELEMETRY.reset()
    client = FakeClient()
    for i in range(2):
        client.add_node(f"gpu-node-{i}", labels=op.FAKE_NODE_LABELS,
                        allocatable=op.FAKE_NODE_ALLOCATABLE)
    mgr = op.wire_manager(client, op.build_parser().parse_args(
        ["--health-port", "0", "--no-trace"]), snapshot_dir=None)
    mgr.start()
    try:
        client.patch("v1", "Node", "gpu-node-1", {"metadata": {
            "annotations": {L.HEALTH_DIGEST: digest_annotation(
                digest("ok", 1))}}})
        port = mgr._http.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/fleet", timeout=10) as r:
            body = json.load(r)
    finally:
        mgr.stop()
        FLEET_TELEMETRY.reset()
    assert body["totals"]["nodes"] == 2 and body["totals"]["reporting"] == 1
    assert list(body["domains"]) == ["h100-sxm-any"]
