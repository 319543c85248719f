#!/usr/bin/env bash
# One-command install/upgrade/uninstall for the GPU operator: the
# `helm install/upgrade/uninstall gpu-operator` UX (deployments/gpu-operator/)
# without Helm. Thin wrapper over `gpuop-cfg install|upgrade|uninstall`,
# which renders the full stream from a values file and applies it against
# $KUBECONFIG (or the in-cluster service account).
#
#   tpu_operator_torch/scripts/install.sh install  [-f values.yaml] [-n namespace] [--wait]
#   tpu_operator_torch/scripts/install.sh upgrade  [-f values.yaml] [-n namespace] [--wait]
#   tpu_operator_torch/scripts/install.sh uninstall [--purge-crds]
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"

VERB="${1:-}"
case "$VERB" in
  install|upgrade|uninstall) shift ;;
  *) echo "usage: $0 install|upgrade|uninstall [args]" >&2; exit 2 ;;
esac

ARGS=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    -f|--values|-n|--namespace)
      [[ $# -ge 2 ]] || { echo "error: $1 requires a value" >&2; exit 2; }
      case "$1" in
        -f|--values) ARGS+=(--values "$2") ;;
        *) ARGS+=(-n "$2") ;;
      esac
      shift 2 ;;
    *) ARGS+=("$1"); shift ;;
  esac
done

# stock distros ship python3 only; prefer it, fall back to python
PY="$(command -v python3 || command -v python)" || {
  echo "python3 not found" >&2; exit 127; }
exec "$PY" -m tpu_operator_torch.cli.gpuop_cfg "$VERB" "${ARGS[@]+"${ARGS[@]}"}"
