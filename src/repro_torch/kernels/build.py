"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and compiles with one
``nvcc`` call into its own shared library under ``build/torch_kernels/`` at
the root of the checkout (``.gitignore`` lists ``build/``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so \\
         src/repro_torch/kernels/csrc/<name>.cu

The library is loaded with ``ctypes``.  Its file name carries a hash of the
source, of every header it includes from ``csrc/`` (``#include "..."``,
followed recursively) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  ``ptxas -v``'s report
(registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.ptxas`` and read back with it, so a cached build reports
the same as a fresh one; a library without its report is rebuilt.  ``build_all`` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import time: the kernel wrappers build on first
launch, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> loaded library, filled on first use
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> what ptxas reported (registers, shared memory, spills), for every
#: library built or loaded from the cache
PTXAS_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and need the CUDA "
        "toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_includes(src: pathlib.Path) -> List[pathlib.Path]:
    """Every file ``src`` includes with ``#include "..."`` from its own
    directory, recursively, in a fixed order."""
    found: List[pathlib.Path] = []
    todo = [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = src.parent / name.decode()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return sorted(found)


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for inc in local_includes(src):
        h.update(inc.name.encode() + b"\0" + inc.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def report_path(lib: pathlib.Path) -> pathlib.Path:
    """Where ``ptxas -v``'s report of library ``lib`` is kept."""
    return lib.with_suffix(".ptxas")


def nvcc_command(nvcc: str, name: str, out: pathlib.Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start the build of ``name`` unless its library and its report
    exist; returns (final path, temporary path, process or None)."""
    out = library_path(name)
    if out.exists() and report_path(out).exists():
        PTXAS_LOG[name] = report_path(out).read_text()
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(find_nvcc(), name, tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def build_all(names=None) -> Dict[str, pathlib.Path]:
    """Compile every source in ``names`` (default: all of ``csrc/*.cu``),
    one ``nvcc`` each, all started together.  Raises on any failure after
    every started compiler has exited."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    started: List[Tuple[str, pathlib.Path, pathlib.Path, object]] = []
    for name in names:
        out, tmp, proc = _start(name)
        started.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        PTXAS_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            if tmp.exists():
                tmp.unlink()
            continue
        report = report_path(tmp)
        report.write_text(log)
        os.replace(report, report_path(out))
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: out for name, out, _, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
