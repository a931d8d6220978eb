"""Build and load the port's native RCV1 parser (parser.cpp) with ctypes.

The library is compiled with ``g++`` at first use, from this directory's
``parser.cpp`` only, into the package's ``_build/`` directory (listed in
``.gitignore``), at a path keyed by the toolchain's fingerprint: the
compiler's version, the arch ``-march=native`` resolves to on this host,
the flags and the ABI (``_lib_path``).  A library older than the source is
rebuilt, and so is one that reports another ABI.  A build writes a
pid-unique temporary file and renames it into place, so processes that
build at once each install a whole library and none loads half of one.

The parser is host code, not a CUDA kernel: it is not built through
``ops/_build.py`` and the compile cache does not count it
(``compile.cache.*`` counts the kernels only).  Without ``g++`` the loader
warns once and ``data/rcv1.py`` parses and packs in python;
``native_loaded()`` tells a caller which route runs.
"""

from __future__ import annotations

import _ctypes
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("dsgd.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "parser.cpp")
# the package's _build/ (distributed_sgd_tpu_torch/_build), beside the kernels
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_unavailable: Optional[str] = None  # why the last load fell back to python
# the last build in this process: {"command": [...], "seconds": s}, or None
last_build: Optional[dict] = None
# must match parser.cpp dsgd_abi_version(): the CsrResult layout and every
# function signature are pinned by this number
_ABI_VERSION = 2
_CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]


class _CsrResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("doc_ids", ctypes.POINTER(ctypes.c_int32)),
        ("row_ptr", ctypes.POINTER(ctypes.c_int64)),
        ("col_idx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("skipped_lines", ctypes.c_int64),
    ]


def _abi_version(lib: ctypes.CDLL) -> int:
    """The library's ABI version; 0 if it has no such export."""
    try:
        fn = lib.dsgd_abi_version
    except AttributeError:
        return 0
    fn.restype = ctypes.c_int32
    fn.argtypes = []
    return int(fn())


def _toolchain_sig() -> Optional[dict]:
    """The fingerprint of what a build on this host produces: the compiler's
    version, the arch ``-march=native`` resolves to here, the flags and the
    ABI.  None without ``g++``.  Two ``g++`` runs, once a process (the
    loaded library is kept).

    The resolved arch is in the key because a library can outlive the host
    that built it (a shared volume, a copied tree): one built for a newer
    ISA would crash with SIGILL on an older host, which neither the mtime
    nor the ABI check can see."""
    try:
        ver = subprocess.run(["g++", "--version"], check=True, capture_output=True,
                             text=True).stdout.splitlines()[0].strip()
        target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], check=True,
                                capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None
    march = ""
    for line in target.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0] in ("-march=", "-mtune="):
            march += f"{parts[0]}{parts[1]} "
    key = f"{ver}|{march.strip()}|{' '.join(_CXXFLAGS)}|abi={_ABI_VERSION}"
    return {"sig": hashlib.sha256(key.encode()).hexdigest(), "compiler": ver,
            "march": march.strip(), "flags": _CXXFLAGS, "abi": _ABI_VERSION}


def _lib_path(sig: dict) -> str:
    """One library per (compiler, resolved arch, flags, ABI): hosts of
    different arches sharing the tree each keep their own."""
    return os.path.join(_BUILD_DIR, f"libdsgd_parser.{sig['sig'][:12]}.so")


def _build(sig: dict) -> str:
    """Compile to the keyed path through a pid-unique temporary file and an
    atomic replace, and write the fingerprint beside it; returns the path."""
    global last_build
    from distributed_sgd_tpu_torch.utils.fsio import atomic_write_json, replacing

    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = _lib_path(sig)
    t0 = time.perf_counter()
    with replacing(lib_path) as tmp:
        cmd = ["g++", *_CXXFLAGS, _SRC, "-o", tmp]
        log.info("building the native parser: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
    last_build = {"command": cmd[:-1] + [lib_path], "seconds": time.perf_counter() - t0}
    atomic_write_json(f"{lib_path}.build.json", sig)
    return lib_path


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first if missing, older than the source
    or of another ABI; None (after one warning) where it cannot be had."""
    global _lib, _unavailable
    with _LOCK:
        if _lib is not None or _unavailable is not None:
            return _lib
        try:
            sig = _toolchain_sig()
            if sig is None:
                raise RuntimeError("no g++ to build it with")
            lib_path = _lib_path(sig)
            if (not os.path.exists(lib_path)
                    or os.path.getmtime(lib_path) < os.path.getmtime(_SRC)):
                lib_path = _build(sig)
            lib = ctypes.CDLL(lib_path)
            if _abi_version(lib) != _ABI_VERSION:
                # a stale library whose mtime survived a copy: reading the
                # result through another layout would read out of bounds.
                # It is closed first: dlopen of the same path would hand the
                # stale handle back
                log.info("native parser ABI mismatch; rebuilding")
                _ctypes.dlclose(lib._handle)
                lib_path = _build(sig)
                lib = ctypes.CDLL(lib_path)
                if _abi_version(lib) != _ABI_VERSION:
                    raise RuntimeError(f"the rebuilt native parser reports ABI "
                                       f"{_abi_version(lib)}, expected {_ABI_VERSION}")
            lib.dsgd_parse_svm.restype = ctypes.POINTER(_CsrResult)
            lib.dsgd_parse_svm.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
            lib.dsgd_free_csr.argtypes = [ctypes.POINTER(_CsrResult)]
            lib.dsgd_free_csr.restype = None
            lib.dsgd_pack_csr.restype = ctypes.c_int64
            lib.dsgd_pack_csr.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        except Exception as e:  # noqa: BLE001 - no toolchain, a failed build: python
            _unavailable = str(e)
            log.warning("native parser unavailable (%s); using the python parser", e)
        return _lib


def native_loaded() -> bool:
    """Whether the native route runs: the library loads (built if need be)."""
    return load() is not None


def parse_svm_file(
    path: str, n_threads: int = 0, index_offset: int = -1
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Parse with the native library: (doc_ids, row_ptr, col_idx, values)
    as owned numpy arrays, or None where the library is unavailable.
    `n_threads` 0 takes the host's hardware threads."""
    lib = load()
    if lib is None:
        return None
    res = lib.dsgd_parse_svm(path.encode(), n_threads, index_offset)
    if not res:
        raise IOError(f"native parser failed to open {path!r}")
    try:
        r = res.contents
        n, nnz = r.n_rows, r.nnz
        if r.skipped_lines:
            # the python parser raises on a non-numeric doc id; the scan
            # drops such lines, counted here
            log.warning("native parser skipped %d malformed line(s) in %s (python "
                        "fallback would raise on these)", r.skipped_lines, path)
        doc_ids = np.ctypeslib.as_array(r.doc_ids, shape=(n,)).copy()
        row_ptr = np.ctypeslib.as_array(r.row_ptr, shape=(n + 1,)).copy()
        col_idx = np.ctypeslib.as_array(r.col_idx, shape=(max(nnz, 1),))[:nnz].copy()
        values = np.ctypeslib.as_array(r.values, shape=(max(nnz, 1),))[:nnz].copy()
        return doc_ids, row_ptr, col_idx, values
    finally:
        lib.dsgd_free_csr(res)


def pack_csr(
    row_ptr: np.ndarray, col_idx: np.ndarray, values: np.ndarray, p: int
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """CSR -> padded [N, p] with the native library: (indices int32[N, p],
    values f32[N, p], rows truncated), or None where it is unavailable.
    A row wider than p keeps its p largest-|value| features in column
    order, as the numpy route does.  ctypes releases the GIL for the call."""
    lib = load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    n = len(row_ptr) - 1
    out_idx = np.zeros((n, p), dtype=np.int32)
    out_val = np.zeros((n, p), dtype=np.float32)
    truncated = lib.dsgd_pack_csr(
        n,
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        p,
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_idx, out_val, int(truncated)
