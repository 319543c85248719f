"""Chart-render equals ``render_bundle`` across a values matrix for the
port's chart (``deploy/helmchart.py``), rendered with the port's
``render/engine.py``: the matrix of the reference's
``tests/test_helm_chart.py``, its values under ``torch_naming``'s map
(``gpuDrivers`` with a ``driverVersion``), plus a daemonsets toleration.
Object-for-object equality."""

import copy

import pytest

from test_torch_helm_chart import _assert_stream_equal
from tpu_operator_torch.deploy import helmchart as helm
from tpu_operator_torch.deploy import values as vm

# every knob the chart parameterizes, against the python renderer
MATRIX = {
    "defaults": {},
    "image-and-operator-knobs": {
        "namespace": "gpu-sys",
        "operator": {"repository": "gcr.io/acme", "image": "op",
                     "version": "v9.9", "replicas": 3, "leaderElect": True,
                     "healthPort": 9090, "imagePullPolicy": "Always",
                     "env": [{"name": "LOG_LEVEL", "value": "debug"}],
                     "labels": {"team": "ml"}, "annotations": {"a": "b"},
                     "nodeSelector": {"pool": "ctrl"},
                     "priorityClassName": "high",
                     "imagePullSecrets": [{"name": "regcred"}]},
    },
    "digest-image": {"operator": {"version": "sha256:" + "ab" * 32}},
    "upgrade-hook": {"operator": {"upgradeCRD": True, "version": "v2.0"}},
    "crs-and-plugin-config": {
        "clusterPolicy": {
            "name": "prod-policy",
            "spec": {"devicePlugin": {"configMap": "plugin-cfgs",
                                      "defaultConfig": "gold"}}},
        "pluginConfig": {
            "create": True,
            "data": {"gold": "sharingPolicy: time-shared\n"
                             "sharingReplicas: 2\n"}},
        "gpuDrivers": [
            {"name": "pool-a", "spec": {"driverVersion": "580.159.03",
                                        "nodeSelector": {"p": "a"}}},
            {"name": "pool-b"}],
    },
    "cr-disabled": {"clusterPolicy": {"enabled": False}},
    "nulled-scheduling": {"operator": {"resources": None,
                                       "tolerations": None,
                                       "affinity": None}},
    "string-pull-secrets": {
        "operator": {"imagePullSecrets": ["regcred", {"name": "other"}]}},
    "replicas-zero": {"operator": {"replicas": 0, "healthPort": 0}},
    "null-cluster-policy": {"clusterPolicy": None},
    "null-plugin-config": {"pluginConfig": None},
    "toleration": {"clusterPolicy": {"spec": {"daemonsets": {
        "tolerations": [{"key": "nvidia.com/gpu", "operator": "Exists",
                         "effect": "NoSchedule"}]}}}},
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_chart_render_equals_bundle(name):
    overrides = MATRIX[name]
    vals = vm.deep_merge(vm.default_values(), overrides)
    _assert_stream_equal(helm.render_chart(values=copy.deepcopy(overrides)),
                         vm.render_bundle(vals, include_crds=True), name)


def test_cleanup_hook_renders_the_cleanup_stream():
    overrides = {"operator": {"cleanupCRD": True}}
    vals = vm.deep_merge(vm.default_values(), overrides)
    expected = vm.render_bundle(vals, include_crds=True) + \
        vm.render_cleanup(vals)
    _assert_stream_equal(helm.render_chart(values=overrides), expected,
                         "cleanupCRD")


def test_upgrade_job_name_versioned_by_image():
    def job_name(version):
        docs = helm.render_chart(values={"operator": {"upgradeCRD": True,
                                                      "version": version}})
        [job] = [d for d in docs if d.get("kind") == "Job"]
        return job["metadata"]["name"]

    first = job_name("v1.0")
    assert first != job_name("v1.1")
    assert first.startswith("gpu-operator-upgrade-crd-")
    # the python renderer names the same Job for the same image
    vals = vm.deep_merge(vm.default_values(), {"operator": {
        "upgradeCRD": True, "version": "v1.0"}})
    [job] = [d for d in vm.render_bundle(vals) if d["kind"] == "Job"]
    assert job["metadata"]["name"] == first
