"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under the
package's ``_build/`` directory (listed in ``.gitignore``), or under the
directory that DSGD_COMPILE_CACHE names (compile_cache.py: shared by
processes, each library found there a hit, each ``nvcc`` run a miss), at
first use, from the sources in the checkout only.  The library is loaded with
``ctypes``.  A library is named by a hash of its source, of every
``csrc/*.cuh`` header the source includes, and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded.

Nothing here runs at import: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

from distributed_sgd_tpu_torch.utils import fsio

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
KERNELS = ("worker_grads", "sync_epoch")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the CUDA toolkit that torch
    resolves (``CUDA_HOME``).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH and no CUDA toolkit under CUDA_HOME): "
        "the port's CUDA kernels are built at first use on the GPU host")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, in include order."""
    found: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC_DIR / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return found


def build_dir() -> Path:
    """Where the libraries are built and loaded from: the configured
    compile cache (DSGD_COMPILE_CACHE), else ``BUILD_DIR``."""
    from distributed_sgd_tpu_torch import compile_cache

    configured = compile_cache.configured_dir()
    return Path(configured) if configured else BUILD_DIR


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"lib{name}.{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no current library, one
    ``nvcc`` process per source, all started together.  Returns each
    compiled kernel's compiler report (``-Xptxas -v``: registers, shared
    memory, spills); raises with the compiler's output if any fails."""
    from distributed_sgd_tpu_torch import compile_cache

    build_dir().mkdir(parents=True, exist_ok=True)
    reports, failed = {}, []
    # each library is installed by an atomic replace once every compile
    # succeeded: a reader never sees half a library
    with contextlib.ExitStack() as installs:
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                compile_cache.record_build(name, hit=True)
                continue
            tmp = installs.enter_context(fsio.replacing(out))
            procs[name] = subprocess.Popen(nvcc_command(name, Path(tmp)), stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
                continue
            compile_cache.record_build(name, hit=False)
            reports[name] = report
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            build([name])  # counts the hit or the miss; builds only if missing
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
