"""The kernels' build: `build.library_path` names a library by a hash of its
source and of every file under `csrc/` the source includes, so a changed
header never loads a stale library; the package data ships every such file;
an installed package builds into the user's cache; a toolkit below CUDA
12.5 is refused with a clear message.  Needs no nvcc and no card."""

import pytest

from deflicker_torch.ops.cuda import build


def _tree(root):
    (root / "sub").mkdir()
    (root / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint f();\n')
    (root / "a.cuh").write_text('#include "sub/b.cuh"\n#include "missing.cuh"\n')
    # an include cycle back to a.cuh, relative to the including file
    (root / "sub" / "b.cuh").write_text('#include "../a.cuh"\n// v1\n')


def test_sources_follow_includes_once(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k") and first.name.startswith("libk-")
    (tmp_path / "sub" / "b.cuh").write_text('#include "../a.cuh"\n// v2\n')
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint g();\n')
    assert build.library_path("k") not in (first, second)


def test_shipped_sources_and_their_headers():
    assert [p.name for p in build.sources("imlp_chain")] == ["imlp_chain.cu",
                                                              "hopper.cuh"]
    assert [p.name for p in build.sources("corr_lookup")] == ["corr_lookup.cu",
                                                               "hopper.cuh"]


def test_package_data_ships_every_source_and_header():
    """An installed package builds from what `pyproject.toml` ships: every
    file a shipped source compiles from matches a package-data glob."""
    import fnmatch
    import tomllib
    from pathlib import Path

    root = Path(build.__file__).resolve().parents[3]
    conf = tomllib.loads((root / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["deflicker_torch"]
    package = root / "deflicker_torch"
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert names == ["corr_lookup", "imlp_chain"]
    for name in names:
        for path in build.sources(name):
            rel = path.relative_to(package).as_posix()
            assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_build_dir_in_a_checkout_and_in_an_install(tmp_path, monkeypatch):
    checkout = tmp_path / "repo"
    (checkout / "deflicker_torch").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("[project]\n")
    assert build.build_dir(checkout) == checkout / "build" / "kernels"
    site = tmp_path / "site-packages"
    (site / "deflicker_torch").mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(site) == tmp_path / "cache" / "deflicker_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir(site) == tmp_path / "home" / ".cache" / "deflicker_torch" / "kernels"


NVCC_OUT = ("nvcc: NVIDIA (R) Cuda compiler driver\n"
            "Copyright (c) 2005-2025 NVIDIA Corporation\n"
            "Cuda compilation tools, release {v}, V{v}.41\n")


@pytest.mark.parametrize("release, ok", [("12.1", False), ("12.4", False),
                                         ("12.5", True), ("12.9", True),
                                         ("13.0", True), (None, False)])
def test_nvcc_version_floor(release, ok, monkeypatch):
    """The build reads `nvcc --version` and raises a clear message below
    CUDA 12.5 (or when it cannot read a release) before compiling."""
    import subprocess

    out = NVCC_OUT.format(v=release) if release else "nvcc: unknown\n"
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build, "_checked", {})
    if ok:
        major, minor = release.split(".")
        assert build.check_nvcc("/opt/cuda/bin/nvcc") == (int(major), int(minor))
    else:
        with pytest.raises(RuntimeError, match="12.5 or later" if release else "cannot read"):
            build.check_nvcc("/opt/cuda/bin/nvcc")
    assert seen == [["/opt/cuda/bin/nvcc", "--version"]]


def test_build_checks_nvcc_before_compiling(tmp_path, monkeypatch):
    """A toolkit below the floor stops the build before any nvcc compile."""
    import subprocess

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_checked", {})
    monkeypatch.setattr(build, "nvcc_path", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 0, stdout=NVCC_OUT.format(v="12.4"), stderr=""))

    def popen(*a, **kw):
        raise AssertionError("compiled despite the old toolkit")

    monkeypatch.setattr(build.subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match="CUDA 12.4"):
        build.build(["imlp_chain"])
