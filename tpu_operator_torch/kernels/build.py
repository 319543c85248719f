"""Build the hand-written CUDA kernels and load them with ctypes; build
the host programs of ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout. The
hash covers the source, the headers of ``csrc/`` and the flags, so an
edited source or header is rebuilt at its first use and an unchanged one
is loaded as built. Each ``csrc/<name>.cc`` is a host program with no
device code (``gpu_telemetry.cc``), compiled by the host's C++ compiler
into ``build/kernels/<name>-<hash>``, keyed by its source and flags.
Nothing is built when a module is imported: only ``load``, ``build`` and
``build_host`` build.
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
# host programs: no device code, dlopen for the libraries they reach
HOST_CXX_FLAGS = ("-O2", "-std=c++17")
HOST_LINK_FLAGS = ("-ldl",)
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


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH); "
                       "the host programs are built at first use")


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a digest of ``csrc/<name>.cu``, every
    ``csrc/*.cuh`` (a source may include any of them) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    return BUILD_DIR / f"lib{name}-{_digest(sources, NVCC_FLAGS)}.so"


def host_program_path(name: str) -> pathlib.Path:
    """The host program's path, named by a digest of ``csrc/<name>.cc``
    and the flags."""
    flags = HOST_CXX_FLAGS + HOST_LINK_FLAGS
    return BUILD_DIR / f"{name}-{_digest([CSRC_DIR / f'{name}.cc'], flags)}"


def _compile(out: pathlib.Path, cmd_for, what: str) -> BuildResult:
    """Run ``cmd_for(tmp)`` unless ``out`` is built, then rename ``tmp``
    into place. The compiler's output is kept beside ``out`` (``.log``),
    so an artefact loaded as built still reports its registers and
    spills."""
    log_path = out.with_name(out.name.removesuffix(".so") + ".log")
    if out.exists():
        return BuildResult(out, 0.0, log_path.read_text()
                           if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, renamed into place: concurrent builders
    # never load a half-written file
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run(cmd_for(tmp), capture_output=True, text=True,
                         timeout=BUILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} failed ({res.returncode}):\n{log}")
    log_tmp = tmp.with_name(tmp.name + ".log")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless this exact source is built."""
    src = CSRC_DIR / f"{name}.cu"
    return _compile(library_path(name),
                    lambda tmp: [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)],
                    f"nvcc for {name}.cu")


def build_host(name: str) -> BuildResult:
    """Compile the host program ``csrc/<name>.cc`` unless this exact
    source is built."""
    src = CSRC_DIR / f"{name}.cc"
    return _compile(host_program_path(name),
                    lambda tmp: [find_cxx(), *HOST_CXX_FLAGS, "-o", str(tmp),
                                 str(src), *HOST_LINK_FLAGS],
                    f"the C++ compiler for {name}.cc")


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
