"""The port's counterpart of ``tests/test_golden_render.py``'s ``render_all``:
every enabled operand state of a GPUClusterPolicy spec rendered, in the
states' order, namespace ``gpu-operator``. ``states`` narrows it to the
states of those names. JAX-free: it imports nothing of the JAX package."""

from __future__ import annotations

from tpu_operator_torch.api.clusterpolicy import (GPUClusterPolicySpec,
                                                  new_cluster_policy)
from tpu_operator_torch.state.operands import build_states
from tpu_operator_torch.state.state import SyncContext

NAMESPACE = "gpu-operator"


def render_docs(spec_dict, states=None) -> list:
    """The objects the enabled states render under ``spec_dict``."""
    policy = new_cluster_policy(spec=spec_dict)
    ctx = SyncContext(client=None, policy=policy,
                      spec=GPUClusterPolicySpec.from_obj(policy),
                      namespace=NAMESPACE)
    docs = []
    for state in build_states():
        if states is not None and state.name not in states:
            continue
        if state.enabled(ctx):
            docs.extend(state.render(ctx))
    return docs


def render_all(spec_dict, states=None) -> str:
    """``render_docs`` as one YAML stream, keys sorted."""
    import yaml

    return yaml.safe_dump_all(render_docs(spec_dict, states), sort_keys=True)
