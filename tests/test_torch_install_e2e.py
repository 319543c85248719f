"""The port's one-command install lifecycle over the live mock apiserver,
with a real Manager standing in for the operator Deployment the install
creates: the parts of the reference's ``tests/test_install_e2e.py`` that
``tests/test_torch_cfg_cluster.py`` does not already hold. ``install
--wait`` blocks until the policy is ready, ``uninstall --purge-crds``
drops the CRDs, ``status`` tracks the lifecycle (a multi-host slice's
row among it), ``diff`` is clean after an install and flags a manual
edit, and install to ready stays inside the reference's five minutes.
``tpu_operator_torch/scripts/install.sh`` is driven as a process the
same way, and refuses a bad verb or a flag without its value (exit 2)."""

import json
import os
import subprocess
import threading
import time

import pytest
import yaml

from mock_apiserver import MockApiServer
from torch_http_e2e import (NS, POLICY, boot, config, cr_state, gpu_node,
                            operator_globals,  # noqa: F401
                            shutdown, wait_for)
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.cli import gpuop_cfg
from tpu_operator_torch.runtime.kubeclient import HTTPClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTALL_SH = os.path.join(ROOT, "tpu_operator_torch", "scripts",
                          "install.sh")
CRDS = ("apiextensions.k8s.io/v1", "CustomResourceDefinition")


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    """(server, ops client, kubeconfig path): an empty cluster but for two
    GPU nodes, the mock's admission running the port's checks over the
    port's CRDs, and $KUBECONFIG pointing the CLI at it."""
    import mock_apiserver

    from tpu_operator_torch.api.validate import admission_errors

    def admission(handler, coll_path, new, old):
        schema = handler.st.schema_for_collection(coll_path)
        return [] if schema is None else admission_errors(new, old, schema)

    monkeypatch.setattr(mock_apiserver._Handler, "_admission", admission)
    srv = MockApiServer().start()
    ops = HTTPClient(config(srv, "admin"))
    for i in range(2):
        ops.create(gpu_node(f"gpu-{i}"))
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
        yield srv, ops, kubeconfig
    finally:
        ops.close()
        srv.stop()


def test_install_wait_blocks_until_ready(cluster):
    """``--wait`` is ``helm install --wait``: rc 0 only once every
    GPUClusterPolicy reports ready."""
    srv, ops, _ = cluster
    rc_box = {}

    def run_install():
        rc_box["rc"] = gpuop_cfg.main(["install", "--wait",
                                       "--timeout", "120"])

    t = threading.Thread(target=run_install, daemon=True)
    t.start()
    mgr, client = boot(srv)
    try:
        wait_for(ops, lambda: cr_state(ops) == "ready", "CR ready")
        t.join(timeout=60)
        assert not t.is_alive(), "--wait did not return after ready"
        assert rc_box["rc"] == 0
    finally:
        shutdown(mgr, client)


def test_uninstall_purge_crds(cluster):
    srv, ops, _ = cluster
    assert gpuop_cfg.main(["install"]) == 0
    assert len(ops.list(*CRDS)) == 3
    assert gpuop_cfg.main(["uninstall", "--purge-crds"]) == 0
    assert ops.list(*CRDS) == []


def test_status_verb_tracks_lifecycle(cluster, capsys):
    """``gpuop-cfg status`` is the helm-status slot: NOT READY right after
    install, READY with per-operand, per-slice and cluster-facts detail
    once converged, rc 1 after uninstall. The reference's 2-host v5p
    slice is a 2-host GB200 NVLink domain (an ``mnnvl-4`` GKE nodepool)."""
    srv, ops, _ = cluster
    for i in range(2):
        node = gpu_node(f"slice-a-{i}", topology="mnnvl-4")
        node["metadata"]["labels"].update({
            L.GKE_ACCELERATOR: "nvidia-gb200",
            L.GPU_PRODUCT: "NVIDIA-GB200",
            L.GKE_NODEPOOL: "pool-slice-a"})
        ops.create(node)
    assert gpuop_cfg.main(["status"]) == 1
    assert "no GPUClusterPolicy" in capsys.readouterr().out
    assert gpuop_cfg.main(["status", "-o", "json"]) == 1
    empty = json.loads(capsys.readouterr().out)
    assert empty["ready"] is False and empty["crs"] == []
    assert empty["nodes"] == {"gpu": 0, "upgradeStates": {}}

    assert gpuop_cfg.main(["install"]) == 0
    capsys.readouterr()
    assert gpuop_cfg.main(["status"]) == 1  # the CR exists, nothing acts
    assert "NOT READY" in capsys.readouterr().out

    mgr, client = boot(srv)
    try:
        wait_for(ops, lambda: cr_state(ops) == "ready", "ready")
        assert gpuop_cfg.main(["status"]) == 0
        out = capsys.readouterr().out
        assert f"GPUClusterPolicy/{POLICY}: ready" in out
        assert "gpu-device-plugin-daemonset: 4/4 ready" in out
        assert "generations {'h100-sxm': 2, 'gb200': 2}" in out
        # the multi-host slice is one readable row (status.slices[])
        assert ("slice pool-slice-a [NVIDIA-GB200 mnnvl-4]: "
                "2/2 hosts validated") in out
        assert out.strip().splitlines()[-1] == "READY"
        assert gpuop_cfg.main(["status", "-o", "json"]) == 0
        jdoc = json.loads(capsys.readouterr().out)
        assert jdoc["ready"] is True
        assert any(cr["kind"] == "GPUClusterPolicy"
                   and cr["state"] == "ready" for cr in jdoc["crs"])
        [srow] = [s for cr in jdoc["crs"] for s in cr["slices"]]
        assert srow["validated"] is True and srow["hosts"] == 2
        assert any(op["name"] == "gpu-device-plugin-daemonset"
                   and op["ready"] for op in jdoc["operands"])
        assert jdoc["nodes"]["gpu"] == 4
    finally:
        shutdown(mgr, client)
    assert gpuop_cfg.main(["uninstall"]) == 0
    capsys.readouterr()
    assert gpuop_cfg.main(["status"]) == 1


def test_diff_clean_after_install_then_flags_manual_edit(cluster, capsys):
    srv, ops, _ = cluster
    assert gpuop_cfg.main(["install"]) == 0
    capsys.readouterr()
    assert gpuop_cfg.main(["diff"]) == 0, capsys.readouterr().out
    # a cluster-admin hand-edits the operator Deployment
    dep = dict(ops.get("apps/v1", "Deployment", "gpu-operator", NS))
    dep["spec"] = dict(dep["spec"], replicas=5)
    ops.update(dep)
    assert gpuop_cfg.main(["diff"]) == 1
    assert "Deployment" in capsys.readouterr().out


def test_install_wall_time_stays_inside_budget(cluster):
    """Install and operator start to all-operands-ready under the
    reference's five minutes (gpu_operator_test.go:83-88)."""
    srv, ops, _ = cluster
    t0 = time.time()
    assert gpuop_cfg.main(["install"]) == 0
    mgr, client = boot(srv)
    try:
        wait_for(ops, lambda: cr_state(ops) == "ready", "ready")
        elapsed = time.time() - t0
        assert elapsed < 300.0, f"install->ready {elapsed:.1f}s"
    finally:
        shutdown(mgr, client)


def install_sh(*args, kubeconfig=None):
    env = {"PATH": os.environ["PATH"], "HOME": "/tmp"}
    if kubeconfig:
        env["KUBECONFIG"] = str(kubeconfig)
    return subprocess.run(["bash", INSTALL_SH, *args], cwd="/", env=env,
                          capture_output=True, text=True, timeout=120)


def test_install_sh_installs_and_uninstalls_as_a_process(cluster, tmp_path):
    """The script from any directory: ``-f`` values reach ``gpuop-cfg``,
    and ``uninstall --purge-crds`` leaves no CR, DaemonSet or CRD."""
    srv, ops, kubeconfig = cluster
    values = tmp_path / "values.yaml"
    values.write_text(yaml.safe_dump({"operator": {"leaderElect": True,
                                                   "replicas": 2}}))
    out = install_sh("install", "-f", str(values), kubeconfig=kubeconfig)
    assert out.returncode == 0, out.stderr
    dep = ops.get("apps/v1", "Deployment", "gpu-operator", NS)
    assert dep["spec"]["replicas"] == 2
    assert "--leader-elect" in dep["spec"]["template"]["spec"][
        "containers"][0]["command"]
    mgr, client = boot(srv)
    try:
        wait_for(ops, lambda: cr_state(ops) == "ready", "ready")
    finally:
        shutdown(mgr, client)
    out = install_sh("uninstall", "--purge-crds", kubeconfig=kubeconfig)
    assert out.returncode == 0, out.stderr
    assert ops.list(*CRDS) == [] and ops.list("apps/v1", "DaemonSet") == []
    assert ops.get_or_none("apps/v1", "Deployment", "gpu-operator",
                           NS) is None


@pytest.mark.parametrize("args, message", [
    ((), "usage:"),
    (("rollback",), "usage:"),
    (("install", "-f"), "error: -f requires a value"),
    (("upgrade", "--namespace"), "error: --namespace requires a value"),
], ids=["no-verb", "bad-verb", "values-without-file",
        "namespace-without-value"])
def test_install_sh_refuses_bad_arguments(args, message):
    out = install_sh(*args)
    assert out.returncode == 2 and message in out.stderr
