"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout. The
hash covers the source, the headers of ``csrc/`` and the flags, so an
edited source or header is rebuilt at its first use and an unchanged one
is loaded as built. Nothing is built when a module is imported: only
``load`` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# sm_90a: Hopper with its architecture-specific instructions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_TIMEOUT_S = 600.0

# (restype, argtypes) per C entry point
Signatures = Dict[str, Tuple[object, Sequence[object]]]


@dataclass
class BuildResult:
    path: pathlib.Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built at first use")


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a digest of ``csrc/<name>.cu``, every
    ``csrc/*.cuh`` (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless this exact source is built. The
    compiler's output is kept beside the library (``.log``), so a library
    loaded as built still reports its registers and spills."""
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.exists():
        return BuildResult(out, 0.0, log_path.read_text()
                           if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, renamed into place: concurrent builders
    # never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=BUILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}.cu:\n{log}")
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with ``restype``/``argtypes`` set from ``signatures``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).path))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _loaded[name] = lib
        return lib
