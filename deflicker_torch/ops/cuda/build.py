"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles, at first use, into
`<repo>/build/kernels/lib<name>-<hash>.so` for `sm_90a` (an installed
package, which has no checkout around it, builds into the user's cache
directory instead: `$XDG_CACHE_HOME` or `~/.cache`, under
`deflicker_torch/kernels`); the hash of the source and of every file under
`csrc/` that it includes (`#include "..."`, followed through included
files) names the file, so an edited source or header never loads a stale
library.  The sources need CUDA 12.5 or later (`imlp_chain.cu` looks up
the driver's tensor-map encoder with `cudaGetDriverEntryPointByVersion`);
the build checks `nvcc --version` first and raises below that.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CUDA_FLOOR = (12, 5)


def build_dir(root: Path) -> Path:
    """`<root>/build/kernels` when `root`, the directory that holds the
    package, is a checkout of the repository; else the user's cache."""
    if (root / "pyproject.toml").is_file() and (root / "deflicker_torch").is_dir():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "deflicker_torch" / "kernels"


CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = build_dir(Path(__file__).resolve().parents[3])
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


_RELEASE = re.compile(r"release (\d+)\.(\d+)")
_checked: Dict[str, tuple] = {}


def check_nvcc(nvcc: str) -> tuple:
    """(major, minor) of the toolkit `nvcc --version` reports; raises below
    CUDA_FLOOR or when the version cannot be read."""
    if nvcc not in _checked:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout
        found = _RELEASE.search(out)
        if found is None:
            raise RuntimeError(f"cannot read the CUDA version from `{nvcc} "
                               f"--version`:\n{out}")
        version = (int(found.group(1)), int(found.group(2)))
        if version < CUDA_FLOOR:
            raise RuntimeError(
                f"{nvcc} is CUDA {version[0]}.{version[1]}; the kernels need CUDA "
                f"{CUDA_FLOOR[0]}.{CUDA_FLOOR[1]} or later "
                "(cudaGetDriverEntryPointByVersion)")
        _checked[nvcc] = version
    return _checked[nvcc]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """`csrc/<name>.cu` and the files under `csrc/` it includes, directly or
    through another included file, in the order first reached."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen or not path.is_file():
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile_cmd(nvcc: str, name: str, out: Path, verbose: bool) -> list:
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together.  Returns the compiler output
    per source (empty for sources already built)."""
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    check_nvcc(nvcc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(nvcc, name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
