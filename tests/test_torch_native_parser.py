"""The port's native RCV1 parser and pack (distributed_sgd_tpu_torch/data/
_native: parser.cpp built with g++ and loaded through ctypes) against the
JAX package's native parser and both packages' python routes, on the CPU.

On the reference-format fixture of tests/test_data.py the port's native
parse equals JAX's native parse and both python parses bit for bit, at
index offsets -1 and 0 and 1, 2 and 7 threads; on messy lines both native
scans give the same arrays and skip the same line, where both python
parsers raise.  The native pack equals the numpy route and JAX's native
pack (lossless, truncating, |value| ties, NaN values, empty rows, the
truncated count).  The loader builds into the port's own ``_build/``,
rebuilds a touched source and a library of another ABI, installs a whole
library when two processes build at once, falls back to python without
``g++``, and never loads the JAX package's library; the kernels' build
list is unchanged.  Each test runs under a time limit of its own
(`LIMIT_S`)."""

import logging
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_sgd_tpu.data import _native as jnative
from distributed_sgd_tpu.data import rcv1 as jrcv1
from distributed_sgd_tpu_torch.data import _native
from distributed_sgd_tpu_torch.data import rcv1
from distributed_sgd_tpu_torch.ops import _build as kernel_build

ROOT = Path(__file__).resolve().parent.parent
LIMIT_S = 90  # each test's own time limit, seconds

# tests/test_data.py's fixture: 'docid  f:v ...' rows, double space after the id
VEC_CONTENT = (
    "2286  1:0.5 7:0.25 47236:1.0\n"
    "2287  2:0.125\n"
    "2288  1:0.75 3:-0.5 4:0.0625 9:0.3\n"
)
# and its messy lines: leading blanks, '+' signs, bad tokens, a non-numeric line
MESSY_CONTENT = (
    "  +10  1:0.5 2:+0.25\n"
    "garbage line without numbers\n"
    "11  3:abc 4:0.125 nocolon 5:1e-2\n"
)


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def fresh_loader(tmp_path, monkeypatch):
    """The port's loader with nothing loaded, building from a copy of the
    source into a directory of the test's own."""
    src = tmp_path / "parser.cpp"
    shutil.copy(_native._SRC, src)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_native, "_SRC", str(src))
    monkeypatch.setattr(_native, "_BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_unavailable", None)
    monkeypatch.setattr(_native, "last_build", None)
    return src, build_dir


def _bits(a: np.ndarray) -> tuple:
    return a.dtype.str, a.shape, a.tobytes()


def _same(*arrays_lists):
    first = arrays_lists[0]
    for other in arrays_lists[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            assert _bits(a) == _bits(b)


# -- the parse ---------------------------------------------------------------


@pytest.mark.parametrize("n_threads", [1, 2, 7])
@pytest.mark.parametrize("index_offset", [-1, 0])
def test_the_native_parse_equals_jax_native_and_both_python_parses(tmp_path, index_offset,
                                                                   n_threads):
    path = tmp_path / "lyrl2004_vectors_train.dat"
    path.write_text(VEC_CONTENT)
    port = _native.parse_svm_file(str(path), n_threads=n_threads, index_offset=index_offset)
    assert port is not None, "the port's native parser did not build"
    jax_native = jnative.parse_svm_file(str(path), n_threads=n_threads,
                                        index_offset=index_offset)
    _same(port, jax_native, rcv1.parse_svm_file_py(str(path), index_offset),
          jrcv1.parse_svm_file_py(str(path), index_offset),
          rcv1.parse_svm_file(str(path), index_offset, n_threads))
    assert port[0].tolist() == [2286, 2287, 2288]
    assert port[1].tolist() == [0, 3, 4, 8]
    assert port[2].tolist() == [c + 1 + index_offset for c in [0, 6, 47235, 1, 0, 2, 3, 8]]


@pytest.mark.parametrize("n_threads", [1, 2, 7])
def test_messy_lines_give_both_native_scans_the_same_arrays_and_skip(tmp_path, caplog,
                                                                     n_threads):
    path = tmp_path / "messy.dat"
    path.write_text(MESSY_CONTENT)
    with caplog.at_level(logging.WARNING, logger="dsgd.native"):
        port = _native.parse_svm_file(str(path), n_threads=n_threads)
    port_warnings = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dsgd.native"):
        jax_native = jnative.parse_svm_file(str(path), n_threads=n_threads)
    jax_warnings = [r.getMessage() for r in caplog.records]
    _same(port, jax_native)
    assert port[0].tolist() == [10, 11]
    assert port[1].tolist() == [0, 2, 4]
    assert port[2].tolist() == [0, 1, 3, 4]
    np.testing.assert_array_equal(port[3], np.float32([0.5, 0.25, 0.125, 0.01]))
    assert port_warnings == jax_warnings
    assert len(port_warnings) == 1 and "skipped 1 malformed line(s)" in port_warnings[0]
    # the python parsers raise on a non-numeric doc id or value
    for parse in (rcv1.parse_svm_file_py, jrcv1.parse_svm_file_py):
        with pytest.raises(ValueError):
            parse(str(path))


def test_a_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="failed to open"):
        _native.parse_svm_file(str(tmp_path / "absent.dat"))


# -- the pack ----------------------------------------------------------------


def _csr(rows):
    """[(cols, values)] -> (row_ptr, col_idx, values)."""
    row_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(c) for c, _ in rows], out=row_ptr[1:])
    cols = np.concatenate([np.asarray(c, np.int32) for c, _ in rows] or [np.zeros(0, np.int32)])
    vals = np.concatenate([np.asarray(v, np.float32) for _, v in rows]
                          or [np.zeros(0, np.float32)])
    return row_ptr, cols.astype(np.int32), vals.astype(np.float32)


PACK_CASES = {
    # (rows, pad widths to pack at; None = the lossless max nnz)
    "lossless": ([([0, 3, 9], [0.5, -1.0, 2.0]), ([4], [0.25]), ([1, 2], [3.0, -3.0])],
                 [None, 5]),
    "truncating": ([([1, 2, 3, 4], [0.1, -9.0, 0.2, 5.0]), ([7, 8, 9], [1.0, 2.0, 3.0]),
                    ([5], [0.5])], [1, 2, 3]),
    "ties": ([([10, 11, 12, 13, 14], [2.0, -2.0, 2.0, 1.0, -2.0]),
              ([0, 1, 2, 3], [-1.0, 1.0, 1.0, -1.0])], [1, 2, 3]),
    "nan": ([([0, 1, 2, 3], [np.nan, 1.0, -np.nan, 0.5]),
             ([4, 5, 6], [np.nan, np.nan, np.nan]), ([7, 8], [np.nan, 3.0])], [None, 1, 2]),
    "empty rows": ([([], []), ([3, 4, 5], [1.0, -4.0, 2.0]), ([], []), ([6], [7.0])],
                   [None, 1, 2]),
    "all empty": ([([], []), ([], [])], [None, 2]),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_the_native_pack_equals_numpy_and_jax_native(case):
    rows, pads = PACK_CASES[case]
    row_ptr, cols, vals = _csr(rows)
    nnz = np.diff(row_ptr)
    for pad in pads:
        p = pad or max(int(nnz.max()) if len(nnz) else 0, 1)
        port = _native.pack_csr(row_ptr, cols, vals, p)
        assert port is not None
        numpy_route = rcv1.pack_csr_numpy(row_ptr, cols, vals, p)
        jax_native = jnative.pack_csr(row_ptr, cols, vals, p)
        want_truncated = int((nnz > p).sum())
        assert port[2] == numpy_route[2] == jax_native[2] == want_truncated
        _same(port[:2], numpy_route[:2], jax_native[:2])
        # the wrapper: the same arrays as the JAX package's pack_csr
        _same(rcv1.pack_csr(row_ptr, cols, vals, pad_width=pad),
              jrcv1.pack_csr(row_ptr, cols, vals, pad_width=pad))


def test_truncation_keeps_the_heaviest_in_column_order_with_ties_to_the_earlier(caplog):
    row_ptr, cols, vals = _csr([([10, 11, 12, 13], [2.0, -3.0, -2.0, 1.0]),
                                ([20, 21, 22], [np.nan, 0.5, np.nan])])
    with caplog.at_level(logging.WARNING, logger="dsgd.data"):
        idx, val = rcv1.pack_csr(row_ptr, cols, vals, pad_width=2)
    # |-3| first, then the first of the two |2|s; NaN sorts below every value
    assert idx.tolist() == [[10, 11], [20, 21]]
    assert val[0].tolist() == [2.0, -3.0]
    assert np.isnan(val[1, 0]) and val[1, 1] == 0.5
    assert any("truncated 2/2 rows" in r.getMessage() for r in caplog.records)


# -- the loader --------------------------------------------------------------


def test_the_first_use_builds_into_the_build_dir_and_a_second_loads_it(fresh_loader):
    src, build_dir = fresh_loader
    lib = _native.load()
    assert lib is not None and _native.native_loaded()
    libs = sorted(p.name for p in build_dir.glob("libdsgd_parser.*.so"))
    assert len(libs) == 1 and Path(lib._name) == build_dir / libs[0]
    assert _native.last_build["command"][0] == "g++" and "-march=native" in \
        _native.last_build["command"]
    sig = _native._toolchain_sig()
    assert (build_dir / f"{libs[0]}.build.json").exists()
    assert libs[0] == f"libdsgd_parser.{sig['sig'][:12]}.so"
    # a second process-like start: nothing loaded, the library current
    first_mtime = (build_dir / libs[0]).stat().st_mtime_ns
    _native._lib, _native.last_build = None, None
    assert _native.load() is not None and _native.last_build is None
    assert (build_dir / libs[0]).stat().st_mtime_ns == first_mtime
    assert not list(build_dir.glob("*.tmp.*"))


def test_a_touched_source_rebuilds(fresh_loader):
    src, build_dir = fresh_loader
    assert _native.load() is not None
    lib_path = next(build_dir.glob("libdsgd_parser.*.so"))
    newer = lib_path.stat().st_mtime + 1
    os.utime(src, (newer, newer))  # the source is now newer than its library
    _native._lib, _native.last_build = None, None
    assert _native.load() is not None and _native.last_build is not None
    assert _native.last_build["command"][-1] == str(lib_path)
    assert [p.name for p in build_dir.glob("libdsgd_parser.*.so")] == [lib_path.name]


def test_a_library_of_another_abi_is_rebuilt(fresh_loader, tmp_path):
    src, build_dir = fresh_loader
    sig = _native._toolchain_sig()
    lib_path = Path(_native._lib_path(sig))
    build_dir.mkdir()
    stale_src = tmp_path / "stale.cpp"
    stale_src.write_text(src.read_text().replace("int32_t dsgd_abi_version() { return 2; }",
                                                 "int32_t dsgd_abi_version() { return 1; }"))
    subprocess.run(["g++", *_native._CXXFLAGS, str(stale_src), "-o", str(lib_path)], check=True)
    newer = src.stat().st_mtime + 10
    os.utime(lib_path, (newer, newer))  # its mtime says current: only the ABI tells
    lib = _native.load()
    assert lib is not None and _native._abi_version(lib) == 2
    assert _native.last_build is not None


def test_two_processes_building_at_once_each_load_a_whole_library(tmp_path):
    src = tmp_path / "parser.cpp"
    shutil.copy(_native._SRC, src)
    build_dir = tmp_path / "_build"
    child = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from distributed_sgd_tpu_torch.data import _native\n"
        "_native._SRC, _native._BUILD_DIR = sys.argv[1], sys.argv[2]\n"
        "lib = _native.load()\n"
        "assert lib is not None and _native._abi_version(lib) == 2\n"
        "out = _native.parse_svm_file(sys.argv[3])\n"
        "print(out[1].tolist(), _native.last_build is not None)\n"
    )
    data = tmp_path / "rows.dat"
    data.write_text(VEC_CONTENT)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", child, str(src), str(build_dir), str(data)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=80) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split()[0:4] == ["[0,", "3,", "4,", "8]"]
    assert len(list(build_dir.glob("libdsgd_parser.*.so"))) == 1
    assert not list(build_dir.glob("*.tmp.*"))


def test_without_gpp_the_loader_warns_once_and_python_parses(fresh_loader, tmp_path,
                                                              monkeypatch, caplog):
    monkeypatch.setattr(_native, "_toolchain_sig", lambda: None)
    path = tmp_path / "lyrl2004_vectors_train.dat"
    path.write_text(VEC_CONTENT)
    (tmp_path / "rcv1-v2.topics.qrels").write_text("CCAT 2286 1\nGCAT 2287 1\nMCAT 2288 1\n")
    with caplog.at_level(logging.WARNING, logger="dsgd.native"):
        assert not _native.native_loaded()
        assert _native.parse_svm_file(str(path)) is None
        ds = rcv1.load_rcv1(str(tmp_path))
    warnings = [r.getMessage() for r in caplog.records if r.name == "dsgd.native"]
    assert len(warnings) == 1 and "using the python parser" in warnings[0]
    want = jrcv1.load_rcv1(str(tmp_path))
    _same([ds.indices, ds.values, ds.labels], [want.indices, want.values, want.labels])


def test_the_port_loads_its_own_library_never_the_jax_packages(tmp_path):
    data = tmp_path / "rows.dat"
    data.write_text(VEC_CONTENT)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from distributed_sgd_tpu_torch.data import _native, rcv1\n"
        "assert _native.native_loaded()\n"
        "rcv1.parse_svm_file(sys.argv[1])\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('JAX_LIB', 'distributed_sgd_tpu/data/_native' in maps)\n"
        "print('PORT_LIB', _native._lib._name)\n"
        "print('JAX_MODULES', sorted(m for m in sys.modules if m.startswith('distributed_sgd_tpu.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(data)], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                         text=True, timeout=80)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["JAX_LIB"] == "False"
    assert lines["PORT_LIB"].startswith(str(ROOT / "distributed_sgd_tpu_torch" / "_build"))
    assert lines["JAX_MODULES"] == "[]"


def test_the_kernel_build_list_is_unchanged():
    # the parser is host code: the kernels' build (and the compile cache's
    # hit and miss counts, two a cold start) stay the two CUDA sources
    assert kernel_build.KERNELS == ("worker_grads", "sync_epoch")
    assert sorted(p.stem for p in kernel_build.CSRC_DIR.glob("*.cu")) == sorted(
        kernel_build.KERNELS)
