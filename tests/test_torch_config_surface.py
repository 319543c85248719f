"""The reference's config-surface tier (``tests/test_config_surface.py``, its
21 functions) held on the port: every ComponentSpec knob of every operand
state, and every ``daemonsets`` knob, changes the port's render, carries
its probe value into it, and changes it where the reference's render
changes under ``torch_naming.py`` (the set of changed places, each a
document index and a key path, mapped). The other functions state TPU
facts, each through the rule: the driver state's preflight container
``gpu-driver-manager``, the proofs ``cuda``/``nvlink``, the plugin's
``GPU_PLUGIN_CONFIG_*``, the image env ``GPU_DRIVER_IMAGE``, the deploy
label ``gpu.graft.dev/deploy.gpu-device-plugin``. Where a function reads
one value off the render, the reference's value, mapped, is asserted too.
"""

import functools

import pytest
import yaml

import torch_naming as N
from test_config_surface import (BASE_SPEC, COMPONENT_FIELD_PROBES,
                                 DAEMONSETS_FIELD_PROBES, STATE_SPEC_KEY,
                                 merged)
from tpu_operator.api.clusterpolicy import (TPUClusterPolicySpec,
                                            new_cluster_policy as rnew)
from tpu_operator.state.operands import build_states as rbuild
from tpu_operator.state.state import SyncContext as RCtx
from tpu_operator_torch.api.clusterpolicy import (GPUClusterPolicySpec,
                                                  new_cluster_policy)
from tpu_operator_torch.state.operands import build_states
from tpu_operator_torch.state.state import SyncContext

REF_STATES = {s.name: s for s in rbuild()}
STATES = {s.name: s for s in build_states()}
# the reference's states, each with its port name (the tests' ids)
STATE_NAMES = sorted(STATE_SPEC_KEY)
PORT_STATE = {s: N.name(s) for s in STATE_NAMES}


def port_ctx(spec_dict):
    """The port's render context of a reference spec, mapped."""
    policy = new_cluster_policy(spec=N.spec(spec_dict))
    return SyncContext(client=None, policy=policy,
                       spec=GPUClusterPolicySpec.from_obj(policy),
                       namespace="gpu-operator")


def ref_ctx(spec_dict):
    policy = rnew(spec=spec_dict)
    return RCtx(client=None, policy=policy,
                spec=TPUClusterPolicySpec.from_obj(policy),
                namespace="tpu-operator")


def state_and_ctx(state_name, spec_dict, ref):
    """One package's state of the reference's ``state_name`` and its
    context under ``spec_dict`` (a reference spec; the port's is it
    under the rule)."""
    if ref:
        return REF_STATES[state_name], ref_ctx(spec_dict)
    return STATES[N.name(state_name)], port_ctx(spec_dict)


def render(state_name, spec_dict, ref=False):
    """The objects one state renders under ``spec_dict``."""
    state, ctx = state_and_ctx(state_name, spec_dict, ref)
    assert state.enabled(ctx), f"{state.name} disabled under base spec"
    return state.render(ctx)


@functools.lru_cache(maxsize=None)
def baseline(state_name, ref):
    return render(state_name, BASE_SPEC, ref)


def dump(objects) -> str:
    return yaml.safe_dump_all(objects, sort_keys=True)


def leaves(tree, path=()):
    """{key path: leaf value} of an object tree; an empty dict or list is
    a leaf of its own."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, path + (k,)))
        return out
    if isinstance(tree, list) and tree:
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, path + (i,)))
        return out
    return {path: tree}


def changed_places(before, after, ref=False):
    """The key paths (document index first) where ``after`` differs from
    ``before``; a reference path under the rule."""
    a = leaves(list(before))
    b = leaves(list(after))
    places = {p for p in set(a) | set(b) if a.get(p, KeyError) !=
              b.get(p, KeyError)}
    if ref:
        places = {tuple(N.name(x) for x in p) for p in places}
    return places


def probe_both(state_name, spec_dict, marker, what):
    """The reference's assertions on the port (the knob changes the
    render, its probe value is in it), and the place it changes equal to
    the reference's under the rule."""
    base, ours = baseline(state_name, False), render(state_name, spec_dict)
    assert ours != base, f"{what} is a silent no-op for {state_name}"
    assert marker in dump(ours), (
        f"{what}: probe value {marker!r} absent from render of {state_name}")
    ref_places = changed_places(baseline(state_name, True),
                                render(state_name, spec_dict, True), True)
    assert changed_places(base, ours) == ref_places, what


@pytest.mark.parametrize("field", sorted(COMPONENT_FIELD_PROBES))
@pytest.mark.parametrize("state_name", STATE_NAMES,
                         ids=[PORT_STATE[s] for s in STATE_NAMES])
def test_component_field_changes_render(state_name, field):
    probe, marker = COMPONENT_FIELD_PROBES[field]
    key = STATE_SPEC_KEY[state_name]
    probe_both(state_name, merged(BASE_SPEC, key, probe), marker,
               f"{N.SPEC_FIELDS.get(key, key)}.{field}")


@pytest.mark.parametrize("field", sorted(DAEMONSETS_FIELD_PROBES))
@pytest.mark.parametrize("state_name", STATE_NAMES,
                         ids=[PORT_STATE[s] for s in STATE_NAMES])
def test_daemonsets_field_changes_render(state_name, field):
    if state_name == "libtpu-driver" and field in (
            "updateStrategy", "rollingUpdateMaxUnavailable"):
        # the driver DaemonSet is always OnDelete, in both packages
        pytest.skip("gpu-driver deliberately pins OnDelete")
    probe, marker = DAEMONSETS_FIELD_PROBES[field]
    probe_both(state_name, merged(BASE_SPEC, "daemonsets", probe), marker,
               f"daemonsets.{field}")


def enabled(state_name, spec_dict, ref=False):
    state, ctx = state_and_ctx(state_name, spec_dict, ref)
    return state.enabled(ctx)


@pytest.mark.parametrize("state_name", sorted(
    set(STATE_SPEC_KEY) - {"isolated-validation", "operator-validation"}))
def test_enabled_false_disables_state(state_name):
    spec = merged(BASE_SPEC, STATE_SPEC_KEY[state_name], {"enabled": False})
    assert not enabled(state_name, spec)
    assert not enabled(state_name, spec, ref=True)


def test_validator_enabled_false_disables_both_validation_states():
    spec = merged(BASE_SPEC, "validator", {"enabled": False})
    for name in ("operator-validation", "isolated-validation"):
        assert not enabled(name, spec) and not enabled(name, spec, True)


def daemonset(objects):
    return next(d for d in objects if d["kind"] == "DaemonSet")


def test_per_operand_overrides_beat_daemonset_defaults():
    spec_dict = merged(BASE_SPEC, "daemonsets", {
        "priorityClassName": "ds-level",
        "labels": {"shared": "from-ds"},
        "tolerations": [{"key": "ds-taint", "operator": "Exists"}]})
    spec_dict = merged(spec_dict, "devicePlugin", {
        "priorityClassName": "operand-level",
        "labels": {"shared": "from-operand"},
        "tolerations": [{"key": "operand-taint", "operator": "Exists"}]})
    seen = []
    for ref in (True, False):
        ds = daemonset(render("tpu-device-plugin", spec_dict, ref))
        pod = ds["spec"]["template"]["spec"]
        assert pod["priorityClassName"] == "operand-level"
        assert ds["metadata"]["labels"]["shared"] == "from-operand"
        keys = [t["key"] for t in pod["tolerations"]]
        assert "ds-taint" in keys and "operand-taint" in keys
        seen.append(N.obj(keys) if ref else keys)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("state_name", STATE_NAMES,
                         ids=[PORT_STATE[s] for s in STATE_NAMES])
def test_operator_wide_labels_annotations(state_name):
    spec_dict = merged(BASE_SPEC, "operator", {
        "labels": {"org/team": "probe-op-label"},
        "annotations": {"org/contact": "probe-op-ann"}})
    out = dump(render(state_name, spec_dict))
    assert "probe-op-label" in out and "probe-op-ann" in out
    assert changed_places(baseline(state_name, False),
                          render(state_name, spec_dict)) == changed_places(
        baseline(state_name, True), render(state_name, spec_dict, True),
        True)


def test_operator_labels_lowest_precedence():
    spec_dict = merged(BASE_SPEC, "operator", {"labels": {"k": "op"}})
    spec_dict = merged(spec_dict, "daemonsets", {"labels": {"k": "ds"}})
    for ref in (True, False):
        ds = daemonset(render("tpu-device-plugin", spec_dict, ref))
        assert ds["metadata"]["labels"]["k"] == "ds"


def driver_pod(spec_dict, ref=False):
    return daemonset(render("libtpu-driver", spec_dict, ref))[
        "spec"]["template"]["spec"]


def preflight(pod, ref=False):
    name = "tpu-driver-manager" if ref else N.name("tpu-driver-manager")
    return next(c for c in pod["initContainers"] if c["name"] == name)


def test_operator_init_container_image_override():
    spec_dict = merged(BASE_SPEC, "operator", {"initContainer": {
        "repository": "gcr.io/util", "image": "preflight",
        "version": "v3"}})
    for ref in (True, False):
        pod = driver_pod(spec_dict, ref)
        assert preflight(pod, ref)["image"] == "gcr.io/util/preflight:v3"
        assert pod["containers"][0]["image"] != "gcr.io/util/preflight:v3"


def validator_inits(spec_dict, state="operator-validation", ref=False):
    ds = daemonset(render(state, spec_dict, ref))
    return {c["name"]: c
            for c in ds["spec"]["template"]["spec"]["initContainers"]}


@pytest.mark.parametrize("proof,ctr_name", [
    ("driver", "driver-validation"), ("plugin", "plugin-validation"),
    ("jax", "jax-validation"), ("ici", "ici-validation")],
    ids=["driver", "plugin", "cuda", "nvlink"])
def test_validator_per_proof_overrides(proof, ctr_name):
    spec_dict = merged(BASE_SPEC, "validator", {proof: {
        "env": [{"name": "PROOF_PROBE", "value": f"probe-{proof}"}],
        "repository": "gcr.io/proofs", "image": "validator",
        "version": "v8",
        "resources": {"limits": {"cpu": "123m"}}}})
    seen = []
    for ref in (True, False):
        inits = validator_inits(spec_dict, ref=ref)
        target = inits[ctr_name if ref else N.name(ctr_name)]
        assert {"name": "PROOF_PROBE", "value": f"probe-{proof}"} in \
            target.get("env", [])
        assert target["image"] == "gcr.io/proofs/validator:v8"
        assert target["resources"] == {"limits": {"cpu": "123m"}}
        probed = sorted(n for n, c in inits.items() if any(
            e.get("name") == "PROOF_PROBE" for e in c.get("env", [])))
        seen.append([N.name(n) for n in probed] if ref else probed)
    assert seen[0] == seen[1] == [N.name(ctr_name)]


def test_partial_proof_override_inherits_validator_coordinates():
    spec_dict = merged(BASE_SPEC, "validator", {
        "repository": "gcr.io/acme", "image": "val", "version": "v2",
        "driver": {"version": "v3"}})
    for ref in (True, False):
        inits = validator_inits(spec_dict, ref=ref)
        assert inits["driver-validation"]["image"] == "gcr.io/acme/val:v3"
        cuda = "jax-validation" if ref else N.name("jax-validation")
        assert inits[cuda]["image"] == "gcr.io/acme/val:v2"


def test_partial_init_container_override_keeps_user_version():
    spec_dict = merged(BASE_SPEC, "operator",
                       {"initContainer": {"version": "v3-init"}})
    spec_dict = merged(spec_dict, "libtpu", {
        "repository": "gcr.io/private", "image": "inst", "version": "v1"})
    for ref in (True, False):
        pod = driver_pod(spec_dict, ref)
        assert preflight(pod, ref)["image"] == "gcr.io/private/inst:v3-init"
        assert pod["containers"][0]["image"] == "gcr.io/private/inst:v1"


def test_partial_init_override_inherits_env_resolved_image(monkeypatch):
    """The operand's image from its env fallback: LIBTPU_DRIVER_IMAGE in
    the reference, GPU_DRIVER_IMAGE in the port (``api/image.py``)."""
    spec_dict = merged(BASE_SPEC, "operator",
                       {"initContainer": {"version": "v9-env"}})
    for ref in (True, False):
        var = "LIBTPU_DRIVER_IMAGE"
        with monkeypatch.context() as m:
            m.setenv(var if ref else N.IMAGE_ENV[var],
                     "gcr.io/airgap/inst:v1")
            pod = driver_pod(spec_dict, ref)
        assert preflight(pod, ref)["image"] == "gcr.io/airgap/inst:v9-env"


def test_the_image_env_row_is_the_ports_env_var():
    from tpu_operator.api.image import env_var_for as ref_env_var_for
    from tpu_operator_torch.api.image import env_var_for

    for ref_var, port_var in N.IMAGE_ENV.items():
        state = next(s for s in REF_STATES
                     if ref_env_var_for(s) == ref_var)
        assert env_var_for(N.name(state)) == port_var


def test_fully_qualified_override_image_passes_through():
    spec_dict = merged(BASE_SPEC, "operator", {
        "initContainer": {"image": "gcr.io/x/inst:v9"}})
    digest = "gcr.io/x/val@sha256:" + "ab" * 32
    proof = merged(BASE_SPEC, "validator", {"jax": {"image": digest}})
    for ref in (True, False):
        assert preflight(driver_pod(spec_dict, ref), ref)["image"] == \
            "gcr.io/x/inst:v9"
        cuda = "jax-validation" if ref else N.name("jax-validation")
        assert validator_inits(proof, ref=ref)[cuda]["image"] == digest


def test_driver_proof_override_reaches_isolated_validation():
    spec_dict = merged(BASE_SPEC, "validator", {"driver": {
        "env": [{"name": "ISOLATED_PROBE", "value": "on"}]}})
    for ref in (True, False):
        for state in ("operator-validation", "isolated-validation"):
            drv = validator_inits(spec_dict, state, ref)["driver-validation"]
            assert any(e.get("name") == "ISOLATED_PROBE"
                       for e in drv.get("env", [])), (state, ref)


def test_validator_pull_secrets_ride_along_on_every_operand():
    spec_dict = merged(BASE_SPEC, "validator",
                       {"imagePullSecrets": ["validator-cred"]})
    spec_dict = merged(spec_dict, "devicePlugin",
                       {"imagePullSecrets": ["dp-cred"]})
    for ref in (True, False):
        ds = daemonset(render("tpu-device-plugin", spec_dict, ref))
        assert [s["name"] for s in ds["spec"]["template"]["spec"][
            "imagePullSecrets"]] == ["dp-cred", "validator-cred"]


def test_template_selector_labels_survive_common_labels():
    deploy = "tpu.graft.dev/deploy.tpu-device-plugin"
    spec_dict = merged(BASE_SPEC, "devicePlugin", {
        "labels": {"app": "evil-override"},
        "nodeSelector": {deploy: "false"}})
    for ref in (True, False):
        ds = daemonset(render("tpu-device-plugin", spec_dict, ref))
        name = (lambda v: v) if ref else N.name
        assert ds["spec"]["template"]["metadata"]["labels"]["app"] == \
            name("tpu-device-plugin-daemonset")
        sel = ds["spec"]["template"]["spec"]["nodeSelector"]
        assert sel[name(deploy)] == "true"
    assert N.name(deploy) == "gpu.graft.dev/deploy.gpu-device-plugin"


def test_device_plugin_config_map_changes_render():
    probed_spec = merged(BASE_SPEC, "devicePlugin", {
        "configMap": "probe-plugin-configs", "defaultConfig": "probe-key"})
    for ref in (True, False):
        env_dir, env_default = (
            ("TPU_PLUGIN_CONFIG_DIR", "TPU_PLUGIN_CONFIG_DEFAULT") if ref
            else (N.ENV["TPU_PLUGIN_CONFIG_DIR"],
                  N.ENV["TPU_PLUGIN_CONFIG_DEFAULT"]))
        baseline_out = dump(baseline("tpu-device-plugin", ref))
        assert "plugin-config" not in baseline_out
        assert env_dir not in baseline_out
        pod = daemonset(render("tpu-device-plugin", probed_spec, ref))[
            "spec"]["template"]["spec"]
        vol = next(v for v in pod["volumes"] if v["name"] == "plugin-config")
        assert vol["configMap"]["name"] == "probe-plugin-configs"
        ctr = pod["containers"][0]
        env = {e["name"]: e.get("value") for e in ctr["env"]}
        assert env[env_default] == "probe-key" and env_dir in env
        assert any(m["name"] == "plugin-config"
                   for m in ctr["volumeMounts"])


def test_every_proof_has_a_cr_override_slot():
    markers = {"driver": "P_DRIVER", "runtime": "P_RUNTIME", "jax": "P_JAX",
               "ici": "P_ICI", "hbm": "P_HBM", "dcn": "P_DCN",
               "plugin": "P_PLUGIN"}
    spec_dict = merged(BASE_SPEC, "validator", {
        proof: {"env": [{"name": m, "value": "1"}]}
        for proof, m in markers.items()})
    for ref in (True, False):
        inits = validator_inits(spec_dict, ref=ref)
        ds = daemonset(render("operator-validation", spec_dict, ref))
        out = dump([ds])
        for marker in markers.values():
            assert marker in out, (f"{marker} not rendered", ref)
        # each marker lands on its own proof's container
        for proof, marker in markers.items():
            name = f"{proof}-validation"
            name = name if ref else N.name(name)
            if name in inits:
                assert {"name": marker, "value": "1"} in inits[name]["env"]


def test_hbm_proof_disable_knob():
    spec_dict = merged(BASE_SPEC, "validator", {"hbm": {"enabled": False}})
    for ref in (True, False):
        out = dump(render("operator-validation", spec_dict, ref))
        assert "hbm-validation" not in out
        assert "dcn-validation" in out


def test_aux_proof_disable_knobs_work():
    spec_dict = merged(BASE_SPEC, "validator", {
        "dcn": {"enabled": False}, "runtime": {"enabled": False}})
    for ref in (True, False):
        out = dump(render("operator-validation", spec_dict, ref))
        assert "dcn-validation" not in out
        assert "runtime-validation" not in out
        assert ("ici-validation" if ref else N.name("ici-validation")) in out


def test_core_proof_disable_rejected_at_validation():
    from tpu_operator.api.validate import validate_cr as ref_validate
    from tpu_operator_torch.api.validate import validate_cr

    for proof in ("driver", "jax", "ici", "plugin"):
        ours = N.SPEC_FIELDS.get(proof, proof)
        errs, _ = validate_cr(new_cluster_policy(spec={
            "validator": {ours: {"enabled": False}}}))
        assert any(f"core proof '{ours}' cannot be disabled" in e
                   for e in errs), f"{ours}: no semantic rejection"
        ref_errs, _ = ref_validate(rnew(spec={
            "validator": {proof: {"enabled": False}}}))
        assert len(errs) == len(ref_errs)
    errs, _ = validate_cr(new_cluster_policy(spec={
        "validator": {"hbm": {"enabled": False},
                      "dcn": {"enabled": False}}}))
    assert errs == []
