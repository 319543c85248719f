"""gpu-validator entrypoint: the per-node validation chain on CUDA.

Counterpart of ``tpu_operator/cli/validator.py``. Usage:
    python -m tpu_operator_torch.cli.validator -c driver|runtime|cuda|hbm|nvlink|dcn|plugin|metrics
    python -m tpu_operator_torch.cli.validator -c cuda --pod-mode
    python -m tpu_operator_torch.cli.validator wait <status-file>
    python -m tpu_operator_torch.cli.validator cleanup

``plugin`` and ``cuda --pod-mode`` spawn a workload pod through the
apiserver (the pod's service account); ``metrics`` serves the node's
validation status on METRICS_PORT (9401) until stopped.

Flags mirror to env vars (WITH_WAIT, NODE_NAME, OPERATOR_NAMESPACE,
VALIDATOR_IMAGE, METRICS_PORT, MATMUL_SIZE, HBM_THRESHOLD, HBM_SIZE_MB,
NVLINK_THRESHOLD, NVLINK_SIZE_MB, NVLINK_FULL_SUITE, GPU_NUM_NODES,
MASTER_ADDR, MASTER_PORT, GROUP_RANK, DCN_TIMEOUT_S, DCN_BANDWIDTH_PROBE,
DCN_PROBE_FAKE_SLICES, DCN_PROBE_SIZE_MB, DCN_THRESHOLD,
GPU_VALIDATION_DIR). Exit codes: 0 proof passed, 1 proof failed, 2 no
component given.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from ..validator import barrier, components

# each runs components.validate_<name>, but plugin and metrics, which
# reach the apiserver or serve the barrier files
_COMPONENTS = ("driver", "runtime", "cuda", "hbm", "nvlink", "dcn", "plugin",
               "metrics")
METRICS_PORT = 9401


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-validator",
                                description="per-node CUDA stack validator")
    sub = p.add_subparsers(dest="cmd")
    p.add_argument("-c", "--component", default=None,
                   choices=_COMPONENTS)
    p.add_argument("--pod-mode", action="store_true",
                   help="cuda: spawn a workload pod via the apiserver "
                        "instead of running in-process")
    p.add_argument("--with-wait", action="store_true",
                   default=os.environ.get("WITH_WAIT", "").lower() == "true",
                   help="retry until the proof passes instead of failing")
    wait = sub.add_parser("wait", help="block until a status file exists")
    wait.add_argument("status_file")
    wait.add_argument("--timeout", type=float, default=300.0)
    sub.add_parser("cleanup", help="remove all validation status files")
    return p


def _client_and_identity():
    from ..runtime.kubeclient import InClusterClient

    node = os.environ.get("NODE_NAME", "")
    ns = os.environ.get("OPERATOR_NAMESPACE", "gpu-operator")
    image = os.environ.get("VALIDATOR_IMAGE",
                           "ghcr.io/gpu-operator/gpu-validator:latest")
    return InClusterClient.from_env(), node, ns, image


def _serve_metrics(log) -> None:
    from ..validator.metrics import serve

    port = int(os.environ.get("METRICS_PORT", str(METRICS_PORT)))
    serve(port, node_name=os.environ.get("NODE_NAME", ""))
    log.info("node metrics exporter on :%d", port)
    while True:
        time.sleep(3600)


def _validate(comp: str, pod_mode: bool) -> dict:
    if comp == "plugin" or (comp == "cuda" and pod_mode):
        from ..validator import workload

        client, node, ns, image = _client_and_identity()
        if comp == "plugin":
            return workload.validate_plugin(client, node, ns, image)
        return workload.validate_cuda_pod(client, node, ns, image)
    return getattr(components, f"validate_{comp}")()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    log = logging.getLogger("gpu_validator")

    if args.cmd == "wait":
        if not barrier.wait_for(args.status_file, timeout=args.timeout):
            log.error("timed out waiting for %s", args.status_file)
            return 1
        return 0
    if args.cmd == "cleanup":
        components.component_cleanup()
        return 0

    comp = args.component
    if not comp:
        build_parser().print_help()
        return 2

    if comp == "metrics":
        try:
            _serve_metrics(log)
        except KeyboardInterrupt:
            return 130
    while True:
        try:
            info = _validate(comp, args.pod_mode)
            log.info("%s validation OK: %s", comp, info)
            return 0
        except components.ValidationFailed as e:
            log.error("%s validation failed: %s", comp, e)
            if not args.with_wait:
                return 1
            time.sleep(barrier.RETRY_INTERVAL_S)
        except KeyboardInterrupt:
            return 130


if __name__ == "__main__":
    sys.exit(main())
