"""The port's worker-local rows (data/row_store.py, data/host_shard.py, and
the host-local WorkerNode of core/worker.py) against the JAX package's, on
the CPU.

A row store either package writes is read by the other, and both write
byte-equal files from the same rows; ``host_slice``,
``overprovisioned_slice``, ``load_host_shard`` and ``reload_slice`` give
the JAX functions' answers; a host-local port worker reloads only the
delta when a resplit moves its slice, and its gradients, windows and
fits equal a full-corpus worker's; and the worker role maps the store
through the CLI (``DSGD_ROW_STORE``, ``DSGD_HOST_INDEX``,
``DSGD_HOST_OVERPROVISION``).  Each test runs under a time limit of its
own (`LIMIT_S`)."""

import filecmp
import os
import signal
import threading

import numpy as np
import pytest
import torch

from distributed_sgd_tpu.data import host_shard as jhs
from distributed_sgd_tpu.data import row_store as jrs
from distributed_sgd_tpu.data.rcv1 import Dataset as JDataset
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data import host_shard, row_store
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR = 200, 1e-4, 16, 0.5
LIMIT_S = 90  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _port(ds) -> Dataset:
    return Dataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _jax(ds) -> JDataset:
    return JDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def corpus():
    return _port(rcv1_like(600, n_features=D, nnz=10, seed=21, idf_values=True))


# -- the store ----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_store_one_package_writes_the_other_reads_byte_equal(corpus, tmp_path, writer):
    train, _ = train_test_split(corpus)
    ds = dim_sparsity(train)
    port_path, jax_path = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    meta_p = row_store.build_row_store(corpus, port_path, train_rows=len(train),
                                       dim_sparsity=ds)
    meta_j = jrs.build_row_store(_jax(corpus), jax_path, train_rows=len(train),
                                 dim_sparsity=ds)
    assert meta_p == meta_j
    for suffix in ("", ".meta.json", ".ds.npy"):
        assert filecmp.cmp(port_path + suffix, jax_path + suffix, shallow=False), suffix
    written = port_path if writer == "port" else jax_path
    reader = jrs.RowStore(written) if writer == "port" else row_store.RowStore(written)
    back = reader.read_rows(37, 411)
    np.testing.assert_array_equal(back.indices, corpus.indices[37:411])
    np.testing.assert_array_equal(back.values, corpus.values[37:411])
    np.testing.assert_array_equal(back.labels, corpus.labels[37:411])
    assert reader.train_rows == len(train) and reader.rows_read == 374
    np.testing.assert_array_equal(reader.dim_sparsity(), ds)


def test_a_store_refuses_a_truncated_payload(corpus, tmp_path):
    path = str(tmp_path / "rows.bin")
    row_store.build_row_store(corpus, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)
    with pytest.raises(ValueError, match="truncated"):
        row_store.RowStore(path)
    with pytest.raises(FileNotFoundError):
        row_store.RowStore(str(tmp_path / "missing.bin"))


# -- the host slices ----------------------------------------------------------


@pytest.mark.parametrize("n,hosts", [(480, 3), (481, 4), (7, 3), (100, 1)])
def test_host_slices_match_jax(n, hosts):
    for i in range(hosts):
        assert host_shard.host_slice(n, i, hosts) == jhs.host_slice(n, i, hosts)
        for f in (0.0, 0.1, 0.5):
            assert (host_shard.overprovisioned_slice(n, i, hosts, overprovision=f)
                    == jhs.overprovisioned_slice(n, i, hosts, overprovision=f))
    assert host_shard.host_slice(n, 0, hosts, weights=[2] + [1] * (hosts - 1)) == \
        jhs.host_slice(n, 0, hosts, weights=[2] + [1] * (hosts - 1))


@pytest.mark.parametrize("old,new", [((100, 200), (150, 260)), ((100, 200), (40, 120)),
                                     ((100, 200), (300, 380)), ((500, 600), (550, 640))])
def test_load_and_reload_slice_match_jax(corpus, old, new):
    n = len(corpus)
    reader, jreader = host_shard.dataset_reader(corpus), jhs.dataset_reader(_jax(corpus))
    cur = host_shard.load_host_shard(reader, n, D, corpus.pad_width, *old)
    jcur = jhs.load_host_shard(jreader, n, D, corpus.pad_width, *old)
    for a, b in ((cur.indices, jcur.indices), (cur.values, jcur.values),
                 (cur.labels, jcur.labels)):
        np.testing.assert_array_equal(a, b)
    got, rows = host_shard.reload_slice(cur, old[0], reader, n, D, corpus.pad_width, *new)
    want, jrows = jhs.reload_slice(jcur, old[0], jreader, n, D, corpus.pad_width, *new)
    assert rows == jrows
    for a, b in ((got.indices, want.indices), (got.values, want.values),
                 (got.labels, want.labels)):
        np.testing.assert_array_equal(a, b)


# -- the host-local worker ------------------------------------------------------


class _SpyReader:
    def __init__(self, data):
        self.data, self.calls = data, []

    def __call__(self, start, stop):
        self.calls.append((start, stop))
        return self.data.slice(slice(start, stop))


def _worker(data, model, **kw):
    return WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, data, model, **kw)


def _close(*workers):
    for w in workers:
        w.server.stop(None)
        w._master_channel.close()


def test_a_host_local_worker_reloads_the_delta_and_matches_a_full_worker(corpus):
    model = make_model("hinge", LAM, D, device="cpu")
    n = len(corpus)
    lo, hi, s, e = host_shard.overprovisioned_slice(n, 1, 4, overprovision=0.1)
    spy = _SpyReader(corpus)
    m = mm.Metrics()
    w = _worker(corpus.slice(slice(lo, hi)), model, data_offset=lo, row_reader=spy,
                total_rows=n, host_overprovision=0.1, metrics=m)
    full = _worker(corpus, model)
    no_reader = _worker(corpus.slice(slice(s, e)), model, data_offset=s)
    try:
        w0 = (np.random.default_rng(1).normal(size=D) * 0.1).astype(np.float32)
        ids = np.arange(lo, lo + 32)
        np.testing.assert_array_equal(w.compute_gradient(w0, ids),
                                      full.compute_gradient(w0, ids))
        assert spy.calls == []  # in the slice: no reload
        ids = np.arange(hi, hi + 32)
        g = w.compute_gradient(w0, ids)
        (a, b), = spy.calls
        assert a == hi and b - a <= 32 + host_shard.overprovision_margin(32, 0.1)
        assert m.counter(mm.DATA_RELOADS).value == 1
        assert m.counter(mm.DATA_RELOAD_ROWS).value == b - a
        np.testing.assert_array_equal(g, full.compute_gradient(w0, ids))
        win = np.arange(hi - 20, hi + 30)
        np.testing.assert_allclose(w.compute_local_window(w0, win, 4, B, LR),
                                   full.compute_local_window(w0, win, 4, B, LR), atol=1e-6)
        # a hedge for rows far outside: a scratch read, no reload
        far = np.arange(0, 24)
        np.testing.assert_array_equal(w.compute_gradient_hedged(w0, far),
                                      full.compute_gradient(w0, far))
        assert m.counter(mm.HEDGE_SCRATCH).value == 1
        assert m.counter(mm.DATA_RELOADS).value == 1
        with pytest.raises(ValueError, match="resident slice"):
            no_reader.compute_gradient(w0, np.arange(e, e + 8))
    finally:
        _close(w, full, no_reader)


def test_drifting_resplits_keep_a_bounded_resident_window():
    data = _port(rcv1_like(2000, n_features=32, nnz=3, seed=1))
    model = make_model("hinge", LAM, 32, device="cpu")
    spy = _SpyReader(data)
    w = _worker(data.slice(slice(0, 200)), model, data_offset=0, row_reader=spy,
                total_rows=2000)
    try:
        w0 = np.zeros(32, np.float32)
        for step in range(1, 9):
            lo = step * 100
            w.compute_gradient(w0, np.arange(lo + 100, lo + 200))
            res = w._resident
            assert res.n <= 300
            assert res.offset <= lo + 100 and res.offset + res.n >= lo + 200
        assert sum(b - a for a, b in spy.calls) <= 900
    finally:
        _close(w)


def test_the_reader_needs_an_offset_and_a_total(corpus):
    model = make_model("hinge", LAM, D, device="cpu")
    with pytest.raises(ValueError, match="total_rows"):
        _worker(corpus.slice(slice(0, 10)), model, data_offset=0,
                row_reader=host_shard.dataset_reader(corpus))
    with pytest.raises(ValueError, match="data_offset"):
        _worker(corpus, model, row_reader=host_shard.dataset_reader(corpus), total_rows=600)


@pytest.mark.parametrize("levers", [{}, {"local_steps": 4, "delta_broadcast": True,
                                         "stream": True}], ids=["plain", "levers"])
def test_a_host_local_cluster_resplit_equals_a_full_corpus_cluster(corpus, levers):
    """A leave mid-way (between two fits) moves the survivors' slices: they
    reload only the delta, and every fit equals the full-corpus cluster's
    bit for bit."""
    train, test = train_test_split(corpus)
    model = make_model("hinge", LAM, D, dim_sparsity=dim_sparsity(train), device="cpu")
    out = {}
    for host_local in (False, True):
        m = mm.Metrics()
        with DevCluster(model, train, test, n_workers=3, seed=0, metrics=m,
                        host_local=host_local, host_overprovision=0.1) as c:
            first = c.master.fit_sync(1, B, LR, **levers)
            assert m.counter(mm.DATA_RELOADS).value == 0
            c.leave_worker(2)
            second = c.master.fit_sync(1, B, LR, initial_weights=first.weights, **levers)
            out[host_local] = (first, second, m.counter(mm.DATA_RELOADS).value,
                               m.counter(mm.DATA_RELOAD_ROWS).value)
    for a, b in zip(out[False][:2], out[True][:2]):
        np.testing.assert_array_equal(np.asarray(a.weights), np.asarray(b.weights))
    assert out[False][2] == 0
    # the survivors' slices grow from 160 (+16 a side) to 240 rows: only the
    # delta is read, never the slices again
    assert 0 < out[True][3] < len(train)


def test_a_host_local_async_fit_reshards_on_start_async(corpus):
    train, test = train_test_split(corpus)
    model = make_model("hinge", LAM, D, dim_sparsity=dim_sparsity(train), device="cpu")
    m = mm.Metrics()
    with DevCluster(model, train, test, n_workers=2, seed=0, metrics=m, host_local=True) as c:
        c.master.fit_async(1, B, LR, check_every=20)
        c.leave_worker(1)
        joined = c.add_worker()
        assert joined.n_rows == 0
        res = c.master.fit_async(2, B, LR, check_every=20)
    assert np.isfinite(res.state.loss)
    assert m.counter(mm.DATA_RELOADS).value >= 1


# -- the worker role through the CLI ------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_the_worker_role_maps_the_row_store_through_main(monkeypatch, tmp_path):
    """A master (DSGD_SYNTHETIC) and two workers that map a row store built
    from the same rows, each holding only its slice: the fit runs with
    the pipelined levers and each worker holds about half the rows."""
    n = 600
    corpus = _port(rcv1_like(n, seed=0, idf_values=True))  # the CLI's synthetic rows
    train, _ = train_test_split(corpus)
    store = str(tmp_path / "rows.bin")
    row_store.build_row_store(corpus, store, train_rows=len(train),
                              dim_sparsity=dim_sparsity(train))
    monkeypatch.setenv("DSGD_SYNTHETIC", str(n))
    port = _free_port()
    common = dict(master_host="127.0.0.1", master_port=port, node_count=2, max_epochs=1,
                  local_steps=2, delta_broadcast=True, stream=True)
    box, nodes = {}, []
    real_init = WorkerNode.__init__

    def spy_init(self, *a, **kw):
        real_init(self, *a, **kw)
        nodes.append(self)

    monkeypatch.setattr(WorkerNode, "__init__", spy_init)

    def run(name, cfg):
        try:
            box[name] = tmain.main(device="cpu", cfg=cfg)
        except Exception as e:  # noqa: BLE001 - surfaced below
            box[name] = e

    threads = [threading.Thread(target=run, daemon=True, args=(
        "master", Config(host="127.0.0.1", port=port, **common)))]
    for i in range(2):
        threads.append(threading.Thread(target=run, daemon=True, args=(
            f"w{i}", Config(host="127.0.0.1", port=0, row_store=store, host_index=i,
                            host_overprovision=0.1, **common))))
    for t in threads:
        t.start()
    threads[0].join(timeout=70)
    tmain.stop_workers()
    for t in threads[1:]:
        t.join(timeout=15)
    assert not any(t.is_alive() for t in threads)
    for name in ("master", "w0", "w1"):
        assert not isinstance(box[name], Exception), box[name]
    assert box["master"].fit.epochs_run == 1
    assert sorted(node._resident.offset for node in nodes) == [0, 216]
    for node in nodes:
        assert node.n_rows == 264  # 240 rows and a margin of 24, clipped at an end
