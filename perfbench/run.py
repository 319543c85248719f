"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``tpu_operator_torch``), on a machine with as many CUDA cards as the
cell asks for. Kernel builds and compiler caches go under ``build/`` in
the checkout, so only a checkout's first run of a cell builds.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock: ``T_START`` less
    the interpreter's own start-up, as far as ``/proc`` tells it."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - started / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START
    return T_START - min(max(age, 0.0), 5.0)


def _environment() -> None:
    build = os.path.join(ROOT, "build")
    # caches inside the checkout, at fixed paths, so a later run finds them
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    # libraries that would load JAX by themselves
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


if __name__ == "__main__":
    _environment()
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], t_start=_process_start()))
