#!/usr/bin/env bash
# Shell e2e of the GPU operator: the tests/scripts/end-to-end.sh tier of
# NVIDIA's gpu-operator (install-operator -> verify-operator -> workload
# -> update-clusterpolicy -> restart-operator -> uninstall), run against
# the in-memory cluster so it needs no kubeconfig. CI entrypoint:
#
#     bash tpu_operator_torch/scripts/end-to-end.sh
#
# Each stage prints STAGE_OK <name>; the script fails fast on any error.
# The workload-proof stage runs the CUDA matmul proof on the card; on a
# host without one, set GPU_VALIDATOR_ALLOW_CPU=true to run it on the CPU.
set -euo pipefail
cd "$(dirname "$0")/../.."

PY=${PYTHON:-python}
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT

stage() { echo "STAGE_OK $1"; }

# -- install-operator: the full bundle must render and self-validate ------
$PY -m tpu_operator_torch.cli.gpuop_cfg generate all > "$WORK/bundle.yaml"
grep -q "kind: CustomResourceDefinition" "$WORK/bundle.yaml"
grep -q "kind: GPUClusterPolicy" "$WORK/bundle.yaml"
$PY -m tpu_operator_torch.cli.gpuop_cfg generate bundle > "$WORK/csv.yaml"
grep -q "kind: ClusterServiceVersion" "$WORK/csv.yaml"
grep -q "operators.operatorframework.io.bundle.mediatype.v1" "$WORK/csv.yaml"
stage install-manifests

# -- values pipeline: user overrides render a valid, merged CR ------------
cat > "$WORK/values.yaml" <<'VALUES'
clusterPolicy:
  spec:
    gpuHealth:
      enabled: true
    metricsExporter:
      serviceMonitor: true
VALUES
$PY -m tpu_operator_torch.cli.gpuop_cfg generate all \
    --values "$WORK/values.yaml" > "$WORK/bundle-custom.yaml"
grep -q "serviceMonitor: true" "$WORK/bundle-custom.yaml"
if $PY -m tpu_operator_torch.cli.gpuop_cfg generate all \
       --values <(echo "bogusKey: {}") >/dev/null 2>"$WORK/err"; then
  echo "FAIL: invalid values accepted"; exit 1
fi
grep -q "INVALID values" "$WORK/err"
stage values-pipeline

# -- lifecycle hooks: upgrade-CRD rides the stream, cleanup is explicit ---
cat > "$WORK/hook-values.yaml" <<'VALUES'
operator:
  upgradeCRD: true
  cleanupCRD: true
VALUES
$PY -m tpu_operator_torch.cli.gpuop_cfg generate all \
    --values "$WORK/hook-values.yaml" > "$WORK/bundle-hooks.yaml" \
    2> "$WORK/hooks.err"
grep -q "gpu-operator-upgrade-crd" "$WORK/bundle-hooks.yaml"
# the DESTRUCTIVE cleanup Job must NOT be in the install stream
if grep -q "gpu-operator-cleanup-crd" "$WORK/bundle-hooks.yaml"; then
  echo "FAIL: cleanup Job leaked into the install stream"; exit 1
fi
grep -q "generate cleanup" "$WORK/hooks.err"   # the reminder note
$PY -m tpu_operator_torch.cli.gpuop_cfg generate cleanup > "$WORK/cleanup.yaml"
grep -q "gpu-operator-cleanup-crd" "$WORK/cleanup.yaml"
stage lifecycle-hooks

# -- offline CR validation (gpuop-cfg validate) ---------------------------
$PY - > "$WORK/policy.yaml" <<'PYTHON'
import yaml
from tpu_operator_torch.deploy.packaging import sample_cluster_policy
print(yaml.safe_dump(sample_cluster_policy()), end="")
PYTHON
$PY -m tpu_operator_torch.cli.gpuop_cfg validate clusterpolicy \
    -f "$WORK/policy.yaml"
stage validate-clusterpolicy

# -- verify-operator: reconcile the fake cluster to all-operands-Ready ----
$PY -m tpu_operator_torch.cli.operator --fake-cluster --once \
    > "$WORK/op1.log" 2>&1
grep -q "reached ready" "$WORK/op1.log"
stage verify-operator

# -- restart-operator: a fresh manager must converge again (stateless) ----
$PY -m tpu_operator_torch.cli.operator --fake-cluster --once \
    > "$WORK/op2.log" 2>&1
grep -q "reached ready" "$WORK/op2.log"
stage restart-operator

# -- per-node validation components (validator barrier protocol) ----------
export GPU_VALIDATION_DIR="$WORK/validations"
mkdir -p "$GPU_VALIDATION_DIR"
GPU_FAKE_CHIPS=4 $PY -m tpu_operator_torch.cli.validator -c driver
test -f "$GPU_VALIDATION_DIR/driver-ready"
GPU_FAKE_CHIPS=4 $PY -m tpu_operator_torch.cli.validator -c runtime
$PY -m tpu_operator_torch.cli.validator -c dcn   # single-node skip path
test -f "$GPU_VALIDATION_DIR/dcn-ready"
$PY -m tpu_operator_torch.cli.validator cleanup
test ! -f "$GPU_VALIDATION_DIR/driver-ready"
stage validator-components

# -- workload proof (the cuda-workload slot): one-card CUDA matmul --------
MATMUL_SIZE=256 $PY -m tpu_operator_torch.cli.validator -c cuda
test -f "$GPU_VALIDATION_DIR/cuda-ready"
stage workload-proof

# -- isolated-workload plane (sandbox tier): fence -> vGPU -> proofs ------
export GPU_FENCING_FILE="$WORK/fencing.json" GPU_VGPU_FILE="$WORK/vgpu.json"
export GPU_FAKE_CHIPS=4 GPU_WORKLOAD_CONFIG=virtual
if $PY -m tpu_operator_torch.cli.validator -c fencing 2>/dev/null; then
  echo "FAIL: fencing proof passed without a fence"; exit 1
fi
$PY - <<'PYTHON'
import os
from tpu_operator_torch.isolation.fencing import write_fencing_file
from tpu_operator_torch.isolation.vgpu import (VGPUProfile,
                                               build_vgpu_devices,
                                               write_vgpu_file)
write_fencing_file(os.environ["GPU_FENCING_FILE"], ["gpu0", "gpu1"],
                   "gpu0,gpu1")
write_vgpu_file(os.environ["GPU_VGPU_FILE"], VGPUProfile("vgpu-2", 2),
                build_vgpu_devices(["gpu0", "gpu1"],
                                   VGPUProfile("vgpu-2", 2), 40960))
PYTHON
$PY -m tpu_operator_torch.cli.validator -c fencing
test -f "$GPU_VALIDATION_DIR/fencing-ready"
$PY -m tpu_operator_torch.cli.validator -c vgpu
test -f "$GPU_VALIDATION_DIR/vgpu-ready"
unset GPU_FENCING_FILE GPU_VGPU_FILE GPU_FAKE_CHIPS GPU_WORKLOAD_CONFIG
stage isolated-plane

# -- optional live-cluster tier (the holodeck/kind slot) ------------------
# Opt-in: GPUOP_E2E_LIVE=1 with KUBECONFIG pointing at a real cluster
# (e.g. kind) runs the actual lifecycle there: install --wait, drift
# check, uninstall. NVIDIA runs this tier on provisioned cloud instances
# (tests/holodeck.yaml, tests/e2e/gpu_operator_test.go:36-100); without
# GPU nodes the CR sits notReady, so --wait is only enforced when
# GPUOP_E2E_EXPECT_READY=1 (a cluster with GPU-labelled nodes).
if [[ "${GPUOP_E2E_LIVE:-}" == "1" && -n "${KUBECONFIG:-}" ]]; then
  if [[ "${GPUOP_E2E_EXPECT_READY:-}" == "1" ]]; then
    $PY -m tpu_operator_torch.cli.gpuop_cfg install --wait \
        --timeout "${GPUOP_E2E_TIMEOUT:-300}"
  else
    $PY -m tpu_operator_torch.cli.gpuop_cfg install
  fi
  $PY -m tpu_operator_torch.cli.gpuop_cfg diff       # fresh install: no drift
  $PY -m tpu_operator_torch.cli.gpuop_cfg uninstall --purge-crds
  stage live-cluster
fi

echo "END_TO_END_OK"
