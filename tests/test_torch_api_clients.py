"""The port's typed clientset (``api/versioned.py``) and image
resolvability (``api/registry.py``) against the JAX package's.

The clientset scenarios run one script on both packages' clientsets
(``gpu_v1()``/``gpu_v1alpha1()``/``gpu_drivers()`` against
``tpu_v1()``/``tpu_v1alpha1()``/``tpu_drivers()``) and compare what each
step returns under ``torch_naming``'s map. The registry is a local fake
OCI registry on 127.0.0.1 (``tests/test_registry.py``'s); both packages'
resolvers answer the same references alike, and a driver CR's image is
collected as the ``driver`` component (the reference's ``libtpu``).
Equality throughout.
"""

import pytest
import yaml

import torch_naming as N
from test_registry import _FakeRegistry
from tpu_operator.api import registry as rreg
from tpu_operator.api import versioned as rver
from tpu_operator_torch.api import registry, versioned
from tpu_operator_torch.api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from tpu_operator_torch.runtime.client import ConflictError, NotFoundError
from tpu_operator_torch.runtime.objects import thaw_obj

# each side's clientset vocabulary
SIDES = {
    "ref": dict(mod=rver, v1="tpu_v1", v1alpha1="tpu_v1alpha1",
                drivers="tpu_drivers", Driver=rver.TPUDriver,
                policy="tpu-cluster-policy", version_field="libtpu",
                accel="cloud.google.com/gke-tpu-accelerator"),
    "port": dict(mod=versioned, v1="gpu_v1", v1alpha1="gpu_v1alpha1",
                 drivers="gpu_drivers", Driver=versioned.GPUDriver,
                 policy="gpu-cluster-policy", version_field="driver",
                 accel="cloud.google.com/gke-accelerator"),
}


def _policies(side, cs):
    return getattr(cs, side["v1"])().cluster_policies()


def _drivers(side, cs):
    return getattr(getattr(cs, side["v1alpha1"])(), side["drivers"])()


def scenario(side) -> list:
    """One script through a side's clientset; what each step saw."""
    mod = side["mod"]
    out = []
    cs = mod.new_simple_clientset()
    cp = mod.ClusterPolicy.new(side["policy"])
    cp.spec.device_plugin.enabled = False
    getattr(cp.spec, side["version_field"]).version = "1.2.3"
    _policies(side, cs).create(cp)
    got = _policies(side, cs).get(side["policy"])
    raw = cs.dynamic.get(mod.ClusterPolicy.api_version,
                         mod.ClusterPolicy.kind, side["policy"])
    out.append(("created", got.spec.device_plugin.is_enabled(),
                getattr(got.spec, side["version_field"]).version,
                raw["spec"]["devicePlugin"]))
    # update persists a typed edit; update_status ignores spec edits
    got.spec.metrics_exporter.enabled = False
    _policies(side, cs).update(got)
    cp = _policies(side, cs).get(side["policy"])
    cp.spec.validator.enabled = False
    cp.raw["status"] = {"state": "notReady", "slices": [
        {"id": "pool0", "hosts": 8, "hostsValidated": 8,
         "validated": True}]}
    _policies(side, cs).update_status(cp)
    got = _policies(side, cs).get(side["policy"])
    out.append(("status", got.spec.metrics_exporter.is_enabled(),
                got.spec.validator.is_enabled(), got.status.state,
                got.status.slices[0].hosts_validated))
    # a stale resourceVersion conflicts
    stale = _policies(side, cs).get(side["policy"])
    fresh = _policies(side, cs).get(side["policy"])
    fresh.spec.validator.enabled = True
    _policies(side, cs).update(fresh)
    try:
        _policies(side, cs).update(stale)
        out.append(("stale", "accepted"))
    except Exception as e:
        out.append(("stale", type(e).__name__))
    # typed watch events
    events = []
    stop = _policies(side, cs).watch(events.append)
    try:
        cp = _policies(side, cs).get(side["policy"])
        getattr(cp.spec, side["version_field"]).version = "9.9.9"
        _policies(side, cs).update(cp)
    finally:
        stop()
    out.append(("watch", [e.type for e in events[:2]],
                type(events[1].obj).__name__,
                getattr(events[1].obj.spec, side["version_field"]).version))
    # drivers: list by label, defaults surface
    d = side["Driver"].new("a")
    d.labels["pool"] = "a"
    d.spec.node_selector = {side["accel"]: "x"}
    _drivers(side, cs).create(d)
    e = side["Driver"].new("b")
    e.labels["pool"] = "b"
    _drivers(side, cs).create(e)
    only_a = _drivers(side, cs).list(label_selector={"pool": "a"})
    out.append(("drivers", sorted(x.name for x in _drivers(side, cs).list()),
                [x.name for x in only_a], only_a[0].spec.node_selector,
                side["Driver"].new("d").spec.driver_type))
    # delete, get_or_none, a kind mismatch
    _policies(side, cs).delete(side["policy"])
    out.append(("deleted", _policies(side, cs).get_or_none(side["policy"])))
    try:
        mod.ClusterPolicy({"kind": "Pod", "metadata": {"name": "x"}})
        out.append(("mismatch", "accepted"))
    except ValueError:
        out.append(("mismatch", "ValueError"))
    return out


def test_clientset_scenario_agrees():
    import json

    ref, port = (json.loads(json.dumps(scenario(SIDES[s])))
                 for s in ("ref", "port"))
    want = N.obj(ref)
    # the drivers' node selector key and default type follow the rule
    want[4][3] = {"cloud.google.com/gke-accelerator": "x"}
    want[4][4] = N.DRIVER_SPEC_DEFAULTS["driverType"][1]
    assert port == want
    assert port[2] == ["stale", "ConflictError"]


def test_clientset_surface_and_wiring():
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )
    from tpu_operator_torch.runtime import FakeClient, Request

    assert set(versioned.__all__) == {
        N.name(n) if n != "TPUDriverStatus" else "GPUDriverStatus"
        for n in rver.__all__} | {"GpuV1", "GpuV1alpha1"}
    client = FakeClient()
    cs = versioned.new_clientset(client)
    client.create(versioned.ClusterPolicy.new("p").to_wire())
    cp = cs.gpu_v1().cluster_policies().get("p")
    cp.spec.gpu_health.enabled = True
    cs.gpu_v1().cluster_policies().update(cp)
    assert client.get(V1, KIND_CLUSTER_POLICY, "p")["spec"]["gpuHealth"][
        "enabled"] is True
    stale = cs.gpu_v1().cluster_policies().get("p")
    fresh = cs.gpu_v1().cluster_policies().get("p")
    fresh.spec.gpu_health.enabled = False
    cs.gpu_v1().cluster_policies().update(fresh)
    with pytest.raises(ConflictError):
        cs.gpu_v1().cluster_policies().update(stale)
    with pytest.raises(NotFoundError):
        cs.gpu_v1alpha1().gpu_drivers().get("none")
    seeded = versioned.new_simple_clientset(
        versioned.ClusterPolicy.new("gpu-cluster-policy"),
        {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n0"}})
    assert seeded.dynamic.get("v1", "Node", "n0")["metadata"]["name"] == "n0"
    ClusterPolicyReconciler(client=seeded.dynamic, namespace="gpu-operator") \
        .reconcile(Request(name="gpu-cluster-policy"))
    st = seeded.gpu_v1().cluster_policies().get("gpu-cluster-policy").status
    assert st.state in ("ready", "notReady", "ignored")
    raw = thaw_obj(seeded.dynamic.get(V1, KIND_CLUSTER_POLICY,
                                      "gpu-cluster-policy"))
    assert versioned.ClusterPolicy(raw).status.state == st.state


@pytest.fixture()
def fake_registry():
    reg = _FakeRegistry({
        "gpu-operator/gpu-driver-installer": {
            "tags": ["v2.0.0"], "digests": ["sha256:" + "ab" * 32]},
        "gpu-operator/gpu-device-plugin": {"tags": ["stable"]},
    })
    yield reg
    reg.stop()


REFS = ["gcr.io/proj/img:v1.2.3", "localhost:5000/img", "ubuntu:22.04",
        "gcr.io/proj/img@sha256:" + "cd" * 32, "gcr.io/img:bad tag",
        "gcr.io/img@sha256:short", "", " x"]


@pytest.mark.parametrize("ref", REFS)
def test_parse_image_ref_agrees(ref):
    def parse(mod):
        try:
            r = mod.parse_image_ref(ref)
            return tuple(r), r.reference, str(r)
        except mod.ImageResolveError as e:
            return str(e)

    assert parse(registry) == parse(rreg)


def test_resolvers_agree_on_a_local_registry(fake_registry):
    host = fake_registry.host
    refs = [f"{host}/gpu-operator/gpu-driver-installer:v2.0.0",
            f"{host}/gpu-operator/gpu-driver-installer@sha256:{'ab' * 32}",
            f"{host}/gpu-operator/gpu-driver-installer:v9.9.9-nope",
            f"{host}/no/such-repo:v1", "127.0.0.1:1/img:v1"]

    def verdicts(mod):
        out = []
        for ref in refs:
            try:
                mod.RegistryResolver(plain_http=True, timeout=2.0).resolve(
                    ref)
                out.append("ok")
            except mod.ImageResolveError as e:
                out.append(str(e).split("(")[0])
        return out

    port = verdicts(registry)
    assert port == verdicts(rreg)
    assert port[:2] == ["ok", "ok"]


def test_token_auth_dance():
    reg = _FakeRegistry({"private/img": {"tags": ["v1"]}},
                        require_auth=True)
    try:
        registry.RegistryResolver(plain_http=True).resolve(
            f"{reg.host}/private/img:v1")
        assert any(p.startswith("/token") for p in reg.requests)
        with pytest.raises(registry.ImageResolveError, match="not found"):
            registry.RegistryResolver(plain_http=True).resolve(
                f"{reg.host}/private/img:v2")
    finally:
        reg.stop()


def test_cr_images_collect_and_resolve_alike(fake_registry):
    host = f"{fake_registry.host}/gpu-operator"
    ref_policy = {"kind": "TPUClusterPolicy", "spec": {
        "libtpu": {"repository": host, "image": "gpu-driver-installer",
                   "version": "v2.0.0"},
        "devicePlugin": {"repository": host, "image": "gpu-device-plugin",
                         "version": "v-broken"},
        "validator": {"matmulSize": 64},
        "metricsExporter": {"enabled": True}}}
    policy = {"kind": "GPUClusterPolicy", "spec": N.spec(
        ref_policy["spec"])}
    want = [(N.name(p) if p != "/spec/libtpu" else "/spec/driver", r)
            for p, r in rreg.collect_cr_images(ref_policy)]
    assert sorted(registry.collect_cr_images(policy)) == sorted(want)
    errs = registry.resolve_cr_images(policy,
                                      registry.RegistryResolver(
                                          plain_http=True))
    rerrs = rreg.resolve_cr_images(ref_policy, rreg.RegistryResolver(
        plain_http=True))
    assert len(errs) == len(rerrs) == 1
    assert errs[0].startswith("/spec/devicePlugin")
    # a driver CR is the `driver` component (the reference's `libtpu`)
    driver = {"kind": "GPUDriver", "spec": {
        "repository": host, "image": "gpu-driver-installer",
        "version": "v2.0.0"}}
    ref_driver = {"kind": "TPUDriver", "spec": dict(driver["spec"])}
    assert registry.collect_cr_images(driver) == [
        ("/spec/driver", f"{host}/gpu-driver-installer:v2.0.0")]
    assert rreg.collect_cr_images(ref_driver)[0][1] == \
        registry.collect_cr_images(driver)[0][1]
    assert registry.resolve_cr_images(
        driver, registry.RegistryResolver(plain_http=True)) == []
    assert registry.collect_cr_images({"kind": "GPUDriver", "spec": {}}) == []


def test_cli_verify_images(fake_registry, tmp_path, capsys):
    from tpu_operator_torch.cli.gpuop_cfg import main

    f = tmp_path / "driver.yaml"
    spec = {"repository": f"{fake_registry.host}/gpu-operator",
            "image": "gpu-driver-installer", "version": "v-missing"}
    f.write_text(yaml.safe_dump({
        "apiVersion": "gpu.graft.dev/v1alpha1", "kind": "GPUDriver",
        "metadata": {"name": "d"}, "spec": spec}))
    assert main(["validate", "gpudriver", "-f", str(f)]) == 0
    assert main(["validate", "gpudriver", "-f", str(f), "--verify-images",
                 "--plain-http"]) == 1
    assert "manifest not found" in capsys.readouterr().err
    spec["version"] = "v2.0.0"
    f.write_text(yaml.safe_dump({
        "apiVersion": "gpu.graft.dev/v1alpha1", "kind": "GPUDriver",
        "metadata": {"name": "d"}, "spec": spec}))
    assert main(["validate", "gpudriver", "-f", str(f), "--verify-images",
                 "--plain-http"]) == 0
