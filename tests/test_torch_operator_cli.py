"""The port's ``gpu-operator`` entry point against the reference's
``tpu-operator``: ``main(["--fake-cluster", "--once", ...])`` returns 0
in both packages once the fake cluster's policy is ready, the parsers'
flags map one to one (``--fake-tpu-nodes`` -> ``--fake-gpu-nodes``), and
``[project.scripts]`` names the port's ``main``."""

import pathlib
import tomllib

import pytest

import torch_naming as N
from tpu_operator.cli import operator as rop
from tpu_operator.runtime import tracing as rtr
from tpu_operator.runtime.client import SPEC_HASH_GATE as RSPEC
from tpu_operator.state.scheduler import DAG_GATE as RDAG
from tpu_operator_torch.cli import operator as op
from tpu_operator_torch.runtime import tracing as tr
from tpu_operator_torch.runtime.client import SPEC_HASH_GATE
from tpu_operator_torch.state.scheduler import DAG_GATE

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def gates():
    """main() sets the process-wide gates from its flags: restore them."""
    saved = [(g, g.enabled) for g in (RSPEC, RDAG, SPEC_HASH_GATE, DAG_GATE,
                                      rtr.TRACER, tr.TRACER)]
    yield
    for g, enabled in saved:
        g.enabled = enabled


def options(parser) -> dict:
    return {max(a.option_strings, key=len): a for a in parser._actions
            if a.option_strings}


def test_flags_map_one_to_one():
    ref = options(rop.build_parser())
    port = options(op.build_parser())
    assert sorted(N.name(f) for f in ref) == sorted(port)
    for flag, action in ref.items():
        mine = port[N.name(flag)]
        assert type(mine) is type(action), flag
        assert mine.option_strings == [N.name(s) for s in
                                       action.option_strings]
        if flag not in ("--namespace", "--version", "--help"):
            assert mine.default == action.default, flag
            assert mine.type == action.type, flag
    assert port["--namespace"].default == \
        N.name(ref["--namespace"].default) == "gpu-operator"
    assert op.build_parser().prog == N.name(rop.build_parser().prog)


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_fake_cluster_once_reaches_ready(ref):
    mod = rop if ref else op
    flag = "--fake-tpu-nodes" if ref else "--fake-gpu-nodes"
    assert mod.main(["--fake-cluster", "--once", flag, "1",
                     "--workers", "2"]) == 0


def test_fake_nodes_are_gke_h100_hosts():
    import inspect

    src = inspect.getsource(rop.main)
    for key in ("GKE_TPU_ACCELERATOR", "GKE_ACCELERATOR_COUNT"):
        assert key in src  # the reference's fake node carries both
    assert N.name("tpu-v5p-slice") in op.FAKE_NODE_LABELS.values()
    assert op.FAKE_NODE_LABELS == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "cloud.google.com/gke-accelerator-count": "4"}
    assert op.FAKE_NODE_ALLOCATABLE == {"nvidia.com/gpu": "4"}


def test_wire_manager_stacks_trace_over_cache():
    from tpu_operator_torch.runtime import (CachedClient, FakeClient,
                                            TracingClient)

    fake = FakeClient()
    mgr = op.wire_manager(fake, op.build_parser().parse_args(
        ["--workers", "3", "--serial-states", "--no-spec-hash"]))
    assert isinstance(mgr.client, TracingClient)
    assert isinstance(mgr.client.inner, CachedClient)
    assert mgr.client.inner.inner is fake and mgr.find_cache() is not None
    # the reference's CLI order (cli/operator.py:167-179), placement not
    # ported yet
    assert [c.name for c in mgr.controllers] == [
        "gpuclusterpolicy", "gpudriver", "gpu-upgrade"]
    assert all(c.workers == 3 for c in mgr.controllers)
    assert not DAG_GATE.enabled and not SPEC_HASH_GATE.enabled
    plain = op.wire_manager(fake, op.build_parser().parse_args(
        ["--no-cache", "--no-trace"]))
    assert plain.client is fake and not tr.TRACER.enabled


def test_project_script():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["gpu-operator"] == "tpu_operator_torch.cli.operator:main"
    assert scripts["tpu-operator"] == "tpu_operator.cli.operator:main"
