"""The port's spin-up fast path (distributed_sgd_tpu_torch/compile_cache.py,
DSGD_COMPILE_CACHE) on the CPU, where there is no nvcc.

Knobs off the libraries stay in the package's ``_build/`` and nothing
counts, starts or writes; with a stub compiler put in place of nvcc (a
script that writes its ``-o`` file and logs its run) a first process
counts misses and a second, on the same directory, counts hits and runs
no compiler; ``warmup_async`` counts kernels, seconds and errors; a
worker's reply after its warm-up (or racing it) is bitwise the reply of a
worker without one, and the warm-up writes none of the worker's state;
an empty slice has no thunks; the mesh binding's and a serving replica's
warm-ups run when the cache is on.  Each test runs under a time limit of
its own (`LIMIT_S`)."""

import json
import os
import signal
import stat
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sgd_tpu_torch import compile_cache
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.host_shard import dataset_reader
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMIT_S = 60  # each test's own time limit, seconds

# one process of the spin-up: a stub nvcc, the cache configured (unless
# argv[1] is "-"), both kernels' libraries loaded (ctypes.CDLL stubbed:
# the stub's output is no library)
_CHILD = """
import json, sys
from distributed_sgd_tpu_torch import compile_cache
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.utils import metrics as mm

cache, stub, build_dir = sys.argv[1], sys.argv[2], sys.argv[3]
_build.find_nvcc = lambda: stub
_build.BUILD_DIR = _build.Path(build_dir)
_build.ctypes.CDLL = lambda path: path
if cache != "-":
    compile_cache.configure(cache)
paths = [str(_build.load(name)) for name in _build.KERNELS]
m = mm.global_metrics()
names = [c.name for c in m.counters()]
print(json.dumps({"paths": paths, "files": compile_cache.cache_file_count(),
                  "hits": m.counter(mm.COMPILE_CACHE_HITS).value,
                  "misses": m.counter(mm.COMPILE_CACHE_MISSES).value,
                  "registered": [n for n in names if n.startswith("compile.")]}))
"""


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
def stub_nvcc(tmp_path):
    """A stand-in compiler: writes its -o file, appends one line to a log."""
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'not a library')\n"
        f"open({str(log)!r}, 'a').write(out + '\\n')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    return stub, log


def _child(cache: str, stub: Path, build_dir: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("DSGD_COMPILE_CACHE", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, cache, str(stub), str(build_dir)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=50)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _runs(log: Path) -> int:
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_the_knob_is_off_in_this_process():
    assert not compile_cache.enabled() and compile_cache.configured_dir() is None
    assert compile_cache.cache_file_count() == 0
    assert _build.build_dir() == _build.BUILD_DIR
    for name in _build.KERNELS:
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert Config().compile_cache is None


def test_a_second_process_hits_and_runs_no_compiler(tmp_path, stub_nvcc):
    stub, log = stub_nvcc
    cache = tmp_path / "cc"
    cold = _child(str(cache), stub, tmp_path / "build")
    assert (cold["misses"], cold["hits"], _runs(log)) == (2, 0, 2)
    assert cold["files"] == 2 and all(Path(p).parent == cache for p in cold["paths"])
    warm = _child(str(cache), stub, tmp_path / "build")
    assert (warm["misses"], warm["hits"], _runs(log)) == (0, 2, 2), "the warm process compiled"
    assert warm["files"] == 2 and warm["paths"] == cold["paths"]
    assert not (tmp_path / "build").exists(), "a cached build wrote into _build/"


def test_knobs_off_builds_in_build_and_writes_nothing_else(tmp_path, stub_nvcc):
    stub, log = stub_nvcc
    cache = tmp_path / "cc"
    off = _child("-", stub, tmp_path / "build")
    assert off["registered"] == [] and off["files"] == 0
    assert all(Path(p).parent == tmp_path / "build" for p in off["paths"])
    assert _runs(log) == 2 and not cache.exists()


def test_warmup_async_counts_kernels_seconds_and_errors(caplog):
    m = mm.Metrics()
    ran = []

    def boom():
        raise RuntimeError("nvcc exited 1")

    t = compile_cache.warmup_async("t", [("a", lambda: ran.append("a")), ("b", boom),
                                         ("c", lambda: ran.append("c"))], metrics=m)
    assert t is not None and t.name == "warmup-t"
    t.join(timeout=30)
    assert ran == ["a", "c"]
    assert m.counter(mm.COMPILE_WARMUP_KERNELS).value == 2
    assert m.counter(mm.COMPILE_WARMUP_ERRORS).value == 1
    assert m.gauge(mm.COMPILE_WARMUP_SECONDS).value >= 0.0
    assert "warmup t/b failed: nvcc exited 1" in caplog.text
    assert compile_cache.warmup_async("t", []) is None
    assert compile_cache.run_warmup("t", [("a", lambda: None)], metrics=m) == 1


def _worker(seed=0, n=64, **kw):
    data = rcv1_like(n, n_features=128, nnz=4, seed=seed)
    model = make_model("hinge", 1e-5, 128, device="cpu")
    return WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, data, model, metrics=mm.Metrics(), **kw)


def test_a_reply_after_the_warmup_is_bitwise_the_reply_without_it():
    worker, reference = _worker(), _worker()
    thunks = worker.warmup_thunks(8, 2)
    assert [label for label, _ in thunks] == ["grad[cap8]", "window[k2,b8]"]
    res = worker._resident
    before = (res.idx.clone(), res.val.clone(), res.y.clone())
    t = compile_cache.warmup_async("test", thunks)
    t.join(timeout=30)
    assert worker._resident is res and all(
        torch.equal(a, b) for a, b in zip(before, (res.idx, res.val, res.y)))
    assert worker.metrics.counter("slave.sync.backward").value == 0
    assert worker._replica is None
    w0 = np.random.default_rng(0).normal(size=128).astype(np.float32)
    assert worker.compute_gradient(w0, np.arange(8)).tobytes() == \
        reference.compute_gradient(w0, np.arange(8)).tobytes()
    assert worker.compute_local_window(w0, np.arange(16), 2, 8, 0.1).tobytes() == \
        reference.compute_local_window(w0, np.arange(16), 2, 8, 0.1).tobytes()
    worker.stop()
    reference.stop()


def test_a_reply_racing_the_warmup_is_bitwise_the_reply_without_it():
    worker, reference = _worker(seed=1), _worker(seed=1)
    w0 = np.random.default_rng(1).normal(size=128).astype(np.float32)
    want = reference.compute_gradient(w0, np.arange(8)).tobytes()
    for _ in range(5):
        t = compile_cache.warmup_async("race", worker.warmup_thunks(8, 2))
        got = worker.compute_gradient(w0, np.arange(8)).tobytes()  # races the warm-up
        t.join(timeout=30)
        assert got == want
    worker.stop()
    reference.stop()


def test_an_empty_slice_worker_has_no_thunks():
    data = rcv1_like(64, n_features=128, nnz=4, seed=0)
    model = make_model("hinge", 1e-5, 128, device="cpu")
    w = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, data.slice(slice(0, 0)), model,
                   data_offset=0, row_reader=dataset_reader(data), total_rows=64)
    assert w.warmup_thunks(8, 2) == []
    assert compile_cache.warmup_async("empty", w.warmup_thunks(8, 2)) is None
    w.stop()


def test_the_worker_role_warms_only_with_the_knob(monkeypatch):
    started = []
    monkeypatch.setattr(compile_cache, "warmup_async",
                        lambda name, thunks, metrics=None: started.append(
                            (name, [label for label, _ in thunks])))
    worker = _worker()
    tmain._warmup_worker(Config(), worker)
    assert started == []
    tmain._warmup_worker(Config(compile_cache="cc", port=4001, local_steps=4), worker)
    assert started == [("worker[:4001]", ["grad[cap128]", "window[k4,b100]"])]
    worker.stop()


def _enable(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_configured_dir", str(tmp_path / "cc"))
    monkeypatch.setattr(compile_cache, "_metrics", mm.Metrics())


def test_the_mesh_binding_warms_at_bind_and_keeps_its_state(monkeypatch, tmp_path):
    data = rcv1_like(256, n_features=128, nnz=4, seed=2)
    model = make_model("hinge", 1e-5, 128, device="cpu")
    engine = SyncEngine(model, batch_size=8, learning_rate=0.5, virtual_workers=2,
                        optimizer="adam", device="cpu")
    want = engine.bind(data).epoch(torch.zeros(128), 3)
    _enable(monkeypatch, tmp_path)
    threads = []
    real = compile_cache.warmup_async
    monkeypatch.setattr(compile_cache, "warmup_async", lambda name, thunks, metrics=None: (
        threads.append(real(name, thunks, metrics)) or threads[-1]))
    bound = engine.bind(data)
    assert len(threads) == 1 and threads[0].name == "warmup-mesh[1xsparse]"
    threads[0].join(timeout=30)
    assert torch.equal(bound.epoch(torch.zeros(128), 3), want)
    assert [label for label, _ in bound.warmup_thunks()] == ["epoch"]


def test_a_serving_replica_warms_its_buckets_with_the_knob(monkeypatch, tmp_path):
    from distributed_sgd_tpu_torch.serving.server import ServingServer

    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(1, np.ones(32, np.float32))
    ck.close()
    for enabled in (False, True):
        if enabled:
            _enable(monkeypatch, tmp_path)
        m = mm.Metrics()
        server = ServingServer(str(tmp_path / "ckpt"), port=0, metrics=m, ckpt_poll_s=30.0,
                               device="cpu").start()
        try:
            deadline = time.monotonic() + 30
            while enabled and m.counter(mm.COMPILE_WARMUP_KERNELS).value < 2:
                assert time.monotonic() < deadline, "the replica never warmed"
                time.sleep(0.05)
        finally:
            server.stop()
        names = [c.name for c in m.counters()]
        assert (mm.COMPILE_WARMUP_KERNELS in names) is enabled
        assert not any(t.name == "serve-warmup" and t.is_alive() for t in threading.enumerate())
