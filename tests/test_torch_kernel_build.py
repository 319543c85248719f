"""The kernels' build key (tpu_operator_torch.kernels.build.library_path):
a library is rebuilt when its source, a header of ``csrc/`` or the flags
change, and only then; a host program (``host_program_path``) when its
own source or the host flags change. Runs on the CPU; nothing is
compiled."""

import pytest

from tpu_operator_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "helpers.cuh"\nint f();\n')
    (tmp_path / "helpers.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit, rebuilds", [
    ("helpers.cuh", True),
    ("k.cu", True),
    ("other.cu", False),
    ("notes.txt", False),
])
def test_library_path_follows_source_and_headers(csrc, edit, rebuilds):
    before = build.library_path("k")
    path = csrc / edit
    path.write_text((path.read_text() if path.exists() else "") + "// x\n")
    assert (build.library_path("k") != before) is rebuilds


def test_library_path_follows_flags(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != before


@pytest.mark.parametrize("edit, rebuilds", [
    ("t.cc", True),
    ("helpers.cuh", False),
    ("k.cu", False),
])
def test_host_program_path_follows_its_source_only(csrc, edit, rebuilds):
    (csrc / "t.cc").write_text("int main() { return 0; }\n")
    before = build.host_program_path("t")
    path = csrc / edit
    path.write_text(path.read_text() + "// x\n")
    assert (build.host_program_path("t") != before) is rebuilds
    assert before.parent == build.BUILD_DIR and before.name.startswith("t-")


def test_host_program_path_follows_flags(csrc, monkeypatch):
    (csrc / "t.cc").write_text("int main() { return 0; }\n")
    before = build.host_program_path("t")
    monkeypatch.setattr(build, "HOST_LINK_FLAGS",
                        build.HOST_LINK_FLAGS + ("-lm",))
    assert build.host_program_path("t") != before


def test_library_path_names_the_kernel_under_the_build_dir(csrc):
    path = build.library_path("k")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libk-") and path.suffix == ".so"


def test_build_keeps_the_compiler_report_beside_the_library(
        csrc, tmp_path, monkeypatch):
    # a stand-in for nvcc that writes the library and a ptxas line
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
                    'done\n'
                    'echo "ptxas info    : Used 42 registers" >&2\n'
                    ': > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.build("k")
    again = build.build("k")
    assert first.path == again.path and first.path.exists()
    assert "Used 42 registers" in first.log
    assert again.seconds == 0.0 and again.log == first.log
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        [first.path.name, first.path.with_suffix(".log").name])
