"""The reference's property tier for the operand render path
(``tests/test_fuzz_operands.py``, 3 properties) held on the port: hostile
user config (strings chosen to break YAML and template quoting) through
every operand state. Each rendered stream parses back to well-formed
objects, hostile env values, args and annotations come back byte-
identical, every DaemonSet's selector matches its pod template; and each
drawn spec, through ``torch_naming.py``, renders the same objects in the
reference (or both packages refuse it).

The reference renders all 15 states an example; here the states are split
over three files so that each stays under 15 s (this file: the first
five, and the hostile-values property, which reads the device plugin;
``_b`` and ``_c``: five each). The drawn specs are the same in each file
(the same property, the same fixed seed), so the three files together
are the reference's properties at its 40 examples; ``GPU_FUZZ_EXAMPLES``
raises the count."""

import os

import yaml
from hypothesis import HealthCheck, assume, given, settings, strategies as st

import torch_naming as N
from test_fuzz_operands import _ENV, _HOSTILE, _SPEC
from torch_render_all import render_docs
from tpu_operator.render.engine import TemplateError as RTemplateError
from tpu_operator_torch.render.engine import TemplateError
from tpu_operator_torch.state.operands import build_states

FUZZ = settings(
    max_examples=int(os.environ.get(N.FUZZ_ENV["TPU_FUZZ_EXAMPLES"], "40")),
    deadline=None, derandomize=True, database=None,
    suppress_health_check=[HealthCheck.too_slow])

STATE_NAMES = [s.name for s in build_states()]
REF_NAMES = {v: k for k, v in N.STATES.items()}


def reference_docs(spec, states):
    """The reference's objects for the same spec and states."""
    from tpu_operator.api.clusterpolicy import (TPUClusterPolicySpec,
                                                new_cluster_policy)
    from tpu_operator.state.operands import build_states as rbuild
    from tpu_operator.state.state import SyncContext

    policy = new_cluster_policy(spec=spec)
    ctx = SyncContext(client=None, policy=policy,
                      spec=TPUClusterPolicySpec.from_obj(policy),
                      namespace="tpu-operator")
    names = {REF_NAMES.get(s, s) for s in states}
    docs = []
    for state in rbuild():
        if state.name in names and state.enabled(ctx):
            docs.extend(state.render(ctx))
    return docs


def rendered(spec, states, parity=True):
    """The port's stream for the reference spec ``spec`` (through the rule
    with ``parity``, else as it is), parsed; with ``parity``, the
    reference's objects mapped must equal the port's (or both refuse the
    spec). A refusal rejects the example, as the reference's ``_render``
    does."""
    try:
        docs = render_docs(N.spec(spec) if parity else spec, states)
    except (TemplateError, ValueError):
        ours = None
    else:
        ours = [d for d in yaml.safe_load_all(
            yaml.safe_dump_all(docs, sort_keys=True)) if d is not None]
    if parity:
        try:
            ref = reference_docs(spec, states)
        except (RTemplateError, ValueError):
            ref = None
        assert (ours is None) == (ref is None), (spec, ours is None)
        if ref is not None:
            assert N.obj(ref) == docs
    assume(ours is not None)
    return ours


def properties(states, hostile=False):
    """The reference's properties over ``states`` (port names)."""

    class TestOperandRenderFuzz:
        @FUZZ
        @given(_SPEC)
        def test_stream_roundtrips_and_objects_wellformed(self, spec):
            docs = rendered(spec, states)
            for d in docs:
                assert d.get("apiVersion"), d
                assert d.get("kind"), d
                assert d.get("metadata", {}).get("name"), d

        @FUZZ
        @given(_SPEC)
        def test_daemonset_selectors_match_pod_labels(self, spec):
            for d in rendered(spec, states, parity=False):
                if d.get("kind") != "DaemonSet":
                    continue
                sel = d["spec"]["selector"]["matchLabels"]
                pod_labels = d["spec"]["template"]["metadata"]["labels"]
                for k, v in sel.items():
                    assert pod_labels.get(k) == v, (
                        f"{d['metadata']['name']}: selector {k}={v} not on "
                        f"pod template ({pod_labels})")

        if hostile:
            @FUZZ
            @given(_ENV, st.lists(_HOSTILE, max_size=2),
                   st.dictionaries(st.sampled_from(["note", "contact"]),
                                   _HOSTILE, max_size=2))
            def test_hostile_values_roundtrip_verbatim(self, env, args,
                                                       annotations):
                """The quoting proof: env values, args and annotations
                set on the device plugin come back byte-identical from
                the parsed stream. The values are the user's, not names:
                they reach the port as drawn."""
                docs = rendered({"devicePlugin": {
                    "env": env, "args": args, "annotations": annotations}},
                    ["gpu-device-plugin"], parity=False)
                ds = next(d for d in docs if d["kind"] == "DaemonSet"
                          and "device-plugin" in d["metadata"]["name"])
                ctr = ds["spec"]["template"]["spec"]["containers"][0]
                got = {e["name"]: e.get("value", "")
                       for e in ctr.get("env", [])}
                expected = {x["name"]: x["value"] for x in env}
                for name, value in expected.items():
                    assert got.get(name) == value, (name, got.get(name))
                if args:
                    assert ctr.get("args") == args, (ctr.get("args"), args)
                meta_ann = ds["metadata"].get("annotations") or {}
                for k, v in annotations.items():
                    assert meta_ann.get(k) == v, (k, meta_ann.get(k), v)

    return TestOperandRenderFuzz


TestOperandRenderFuzz = properties(STATE_NAMES[:5], hostile=True)
