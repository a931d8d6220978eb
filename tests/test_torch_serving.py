"""The port's serving replica (distributed_sgd_tpu_torch/serving/: bucketing,
batcher, model_store, server, health_probe) against the JAX package's, on
the CPU over real loopback gRPC.

The same rows, made from a seed with numpy, go through both packages:
the padded buckets are byte-equal, the batchers coalesce, flush on their
deadline, shed and survive a failed batch alike, and the port's engine
answers within 1e-5 of the JAX engine's margins and of a float64 numpy
oracle, with equal predictions wherever |margin| >= 1e-4 (XLA and torch
may sum a row's cells in another order).  On one device a served margin
equals the port's own ``model.margins`` on the same padded batch bit for
bit.  A row made invalid by a swap that shrinks the model fails alone.
The store hot-swaps, keeps its last good snapshot on a bad file, never
writes into a published tensor (a delta that lands mid-flush leaves that
flush on its step), and takes a JAX pusher's full and delta pushes to
weights bitwise equal to a JAX store fed the same pushes.  A JAX client
talks to a port replica; the CLI's serve role answers and exits 0 on
SIGTERM, and a training role with DSGD_SERVE_PUSH pushes to a replica."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.config import Config as JaxConfig
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.rpc.service import ServeStub as JaxServeStub
from distributed_sgd_tpu.rpc.service import new_channel as jax_new_channel
from distributed_sgd_tpu.serving import batcher as jbatcher
from distributed_sgd_tpu.serving import bucketing as jbucketing
from distributed_sgd_tpu.serving.push import WeightPusher as JaxWeightPusher
from distributed_sgd_tpu.serving.server import InvalidRow as JaxInvalidRow
from distributed_sgd_tpu.serving.server import PredictEngine as JaxPredictEngine
from distributed_sgd_tpu.serving.server import ServingServer as JaxServingServer
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import sparse as tsparse
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel
from distributed_sgd_tpu_torch.serving import batcher as tbatcher
from distributed_sgd_tpu_torch.serving import bucketing as tbucketing
from distributed_sgd_tpu_torch.serving import health_probe
from distributed_sgd_tpu_torch.serving.model_store import ModelStore
from distributed_sgd_tpu_torch.serving.server import InvalidRow, PredictEngine, ServingServer
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
D = 1000  # features
N_ROWS = 300
MARGIN_ATOL = 1e-5  # port against JAX and against the float64 oracle
PRED_MARGIN = 1e-4  # predictions must agree where |margin| is at least this
LIMIT_S = 60  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _rows(n=N_ROWS, seed=5, nnz=24):
    """n (indices, values) rows of RCV1's shape at width D, pads stripped."""
    ds = rcv1_like(n, n_features=D, nnz=nnz, seed=seed, idf_values=True)
    return [(ds.indices[i][ds.values[i] != 0].astype(np.int32),
             ds.values[i][ds.values[i] != 0].astype(np.float32)) for i in range(n)]


def _weights(seed=3, d=D):
    return (np.random.default_rng(seed).normal(size=d) * 0.3).astype(np.float32)


def _oracle(rows, w):
    return np.array([np.dot(v.astype(np.float64), w.astype(np.float64)[i]) for i, v in rows])


def _pending(mod, rows):
    return [mod.PendingRequest(i, v) for i, v in rows]


# -- bucketing -----------------------------------------------------------------


@pytest.mark.parametrize("n,widths", [(1, [3]), (3, [9, 1, 0]), (64, None), (5, [200])])
def test_buckets_and_packed_rows_are_byte_equal_to_jax(n, widths):
    rng = np.random.default_rng(n)
    widths = widths or list(rng.integers(0, 130, n))
    rows = [(rng.choice(D, size=k, replace=False).astype(np.int32),
             rng.normal(size=k).astype(np.float32)) for k in widths]
    assert tbucketing.bucket_shape(n, max(widths)) == jbucketing.bucket_shape(n, max(widths))
    ti, tv = tbucketing.pack_rows(rows)
    ji, jv = jbucketing.pack_rows(rows)
    assert ti.dtype == ji.dtype and tv.dtype == jv.dtype
    assert ti.tobytes() == ji.tobytes() and tv.tobytes() == jv.tobytes()


def test_pad_rows_truncates_a_wide_row_like_jax():
    from distributed_sgd_tpu.ops.sparse import pad_rows as jax_pad_rows

    rng = np.random.default_rng(0)
    rows = [(rng.choice(D, size=k, replace=False).astype(np.int32),
             rng.normal(size=k).astype(np.float32)) for k in (40, 8, 17)]
    ti, tv = tsparse.pad_rows(rows, 16)
    ji, jv = jax_pad_rows(rows, 16)
    assert ti.tobytes() == ji.tobytes() and tv.tobytes() == jv.tobytes()
    # the heaviest 16 of the 40 cells, in their original order
    keep = np.sort(np.argsort(-np.abs(rows[0][1]))[:16])
    np.testing.assert_array_equal(ti[0], rows[0][0][keep])


# -- the batcher, on the port's class and on JAX's -----------------------------

_BATCHERS = {"port": tbatcher, "jax": jbatcher}
_METRICS = {"port": Metrics, "jax": JaxMetrics}


def _echo_rows(rows):
    return [(r.indices.copy(), r.values.copy()) for r in rows]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batcher_coalesces_concurrent_requests(pkg):
    mod, m = _BATCHERS[pkg], _METRICS[pkg]()
    gate, sizes = threading.Event(), []

    def run(rows):
        gate.wait(5)
        sizes.append(len(rows))
        return _echo_rows(rows)

    b = mod.MicroBatcher(run, max_batch=8, max_delay_ms=50.0, queue_depth=64,
                         metrics=m).start()
    pendings = [b.submit(np.array([i], np.int32), np.array([1.0], np.float32))
                for i in range(8)]
    gate.set()
    results = [p.wait(5) for p in pendings]
    b.stop()
    assert [int(idx[0]) for idx, _ in results] == list(range(8))
    assert max(sizes) > 1 and m.histogram("serve.batch.size").count == len(sizes)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batcher_deadline_flushes_a_partial_batch(pkg):
    mod = _BATCHERS[pkg]
    b = mod.MicroBatcher(_echo_rows, max_batch=1000, max_delay_ms=20.0,
                         queue_depth=64).start()
    t0 = time.monotonic()
    idx, val = b.submit(np.array([7], np.int32), np.array([2.0], np.float32)).wait(5)
    elapsed = time.monotonic() - t0
    b.stop()
    assert (int(idx[0]), float(val[0])) == (7, 2.0) and elapsed < 2.0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batcher_queue_full_rejects_and_counts(pkg):
    mod, m = _BATCHERS[pkg], _METRICS[pkg]()
    release = threading.Event()

    def slow(rows):
        release.wait(10)
        return _echo_rows(rows)

    b = mod.MicroBatcher(slow, max_batch=1, max_delay_ms=0.0, queue_depth=2,
                         metrics=m).start()
    row = (np.array([0], np.int32), np.array([1.0], np.float32))
    admitted = [b.submit(*row)]
    deadline = time.monotonic() + 5
    with pytest.raises(mod.QueueFull):
        while time.monotonic() < deadline:
            admitted.append(b.submit(*row))
    assert m.counter("serve.rejected").value >= 1
    release.set()
    for p in admitted:
        p.wait(5)
    b.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batcher_error_fails_the_batch_not_the_server(pkg):
    mod, m = _BATCHERS[pkg], _METRICS[pkg]()
    calls = []

    def flaky(rows):
        calls.append(len(rows))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return _echo_rows(rows)

    b = mod.MicroBatcher(flaky, max_batch=4, max_delay_ms=1.0, queue_depth=16,
                         metrics=m).start()
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(np.array([1], np.int32), np.array([1.0], np.float32)).wait(5)
    idx, _ = b.submit(np.array([2], np.int32), np.array([1.0], np.float32)).wait(5)
    b.stop()
    assert int(idx[0]) == 2 and m.counter("serve.batch.errors").value == 1


# -- the engine: port against JAX and the float64 oracle ------------------------


def test_predict_engine_matches_jax_and_the_float64_oracle():
    rows, w = _rows(), _weights()
    port = PredictEngine("hinge", device="cpu")
    jax_engine = JaxPredictEngine("hinge")
    got, want = [], []
    for lo in range(0, len(rows), 64):  # flushes of 64 rows, and a short tail
        chunk = rows[lo:lo + 64]
        got += port.run((7, torch.from_numpy(w)), _pending(tbatcher, chunk))
        want += jax_engine.run((7, jnp.asarray(w)), _pending(jbatcher, chunk))
    margins = np.array([m for _, m, _ in got])
    jmargins = np.array([m for _, m, _ in want])
    oracle = _oracle(rows, w)
    np.testing.assert_allclose(margins, jmargins, rtol=0, atol=MARGIN_ATOL)
    np.testing.assert_allclose(margins, oracle, rtol=0, atol=MARGIN_ATOL)
    firm = np.abs(margins) >= PRED_MARGIN
    assert firm.sum() > 0.9 * len(rows)
    np.testing.assert_array_equal(np.array([p for p, _, _ in got])[firm],
                                  np.array([p for p, _, _ in want])[firm])
    assert {s for _, _, s in got} == {7}


def test_a_served_margin_is_the_models_margin_on_the_same_padded_batch():
    rows, w = _rows(40, seed=9), _weights(4)
    engine = PredictEngine("logistic", device="cpu")
    got = engine.run((1, torch.from_numpy(w)), _pending(tbatcher, rows))
    idx, val = tbucketing.pack_rows(rows)
    model = make_model("logistic", 1e-5, D, device="cpu")
    want = model.margins(torch.from_numpy(w), tsparse.SparseBatch(
        torch.from_numpy(idx), torch.from_numpy(val)))[:len(rows)].numpy()
    assert np.array([m for _, m, _ in got], np.float32).tobytes() == want.tobytes()
    np.testing.assert_array_equal([p for p, _, _ in got], np.where(want >= 0, 1.0, -1.0))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_row_made_invalid_by_a_shrinking_swap_fails_alone(pkg):
    """Both engines answer every other row of the flush and InvalidRow for
    the row past the new model's width (JAX clamps its gather; the port
    zeroes the row's cells before the copy to the device)."""
    small = np.linspace(-1, 1, 16).astype(np.float32)
    ok = [(np.array([1, 5], np.int32), np.array([1.0, 2.0], np.float32)),
          (np.array([15], np.int32), np.array([-1.0], np.float32))]
    stale = (np.array([3, 40], np.int32), np.array([1.0, 1.0], np.float32))
    rows = [ok[0], stale, ok[1]]
    if pkg == "port":
        out = PredictEngine("hinge", device="cpu").run((2, torch.from_numpy(small)),
                                                      _pending(tbatcher, rows))
        invalid = InvalidRow
    else:
        out = JaxPredictEngine("hinge").run((2, jnp.asarray(small)), _pending(jbatcher, rows))
        invalid = JaxInvalidRow
    assert isinstance(out[1], invalid)
    for got, (i, v) in zip((out[0], out[2]), ok):
        assert got[2] == 2 and got[1] == pytest.approx(float(np.dot(v, small[i])), abs=1e-6)
    if pkg == "port":
        # what the zeroing prevents: on the CPU a torch gather out of range
        # fails the whole batch (on the card it would poison the context)
        with pytest.raises(IndexError):
            torch.from_numpy(small).index_select(0, torch.tensor([40]))


def test_serve_jit_compile_counts_the_first_use_of_each_bucket():
    m = Metrics()
    engine = PredictEngine("hinge", metrics=m, device="cpu")
    snap = (1, torch.from_numpy(np.linspace(-1, 1, 32).astype(np.float32)))

    def rows(n, nnz):
        return [tbatcher.PendingRequest(np.arange(nnz, dtype=np.int32),
                                        np.ones(nnz, np.float32)) for _ in range(n)]

    engine.run(snap, rows(3, 5))
    assert m.counter("serve.jit.compile").value == 1
    engine.run(snap, rows(4, 2))  # the same (4, 8) bucket
    engine.run(snap, rows(1, 8))
    assert m.counter("serve.jit.compile").value == 1
    engine.run(snap, rows(5, 5))  # (8, 8): a new bucket
    assert m.counter("serve.jit.compile").value == 2
    # the warm-up thunks run the forward on zero rows and mark their buckets
    names = [name for name, _ in engine.warmup_thunks(32, 64)]
    assert names == [name for name, _ in JaxPredictEngine("hinge").warmup_thunks(32, 64)]
    for _, thunk in engine.warmup_thunks(32, 64):
        thunk()
    engine.run(snap, rows(64, 8))  # (64, 8), warmed
    assert m.counter("serve.jit.compile").value == 2


# -- the model store -----------------------------------------------------------


def test_the_store_loads_hot_swaps_and_keeps_the_last_good_snapshot(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ModelStore(str(tmp_path / "empty"), poll_s=30.0, device="cpu").get() is None
    m = Metrics()
    w1, w2 = _weights(1, 64), _weights(2, 64)
    ck.save(1, w1)
    store = ModelStore(str(tmp_path), poll_s=30.0, metrics=m, device="cpu")
    step, t1 = store.get()
    assert step == 1 and t1.dtype == torch.float32 and t1.device.type == "cpu"
    assert t1.numpy().tobytes() == w1.tobytes()
    assert not store.poll_once()  # nothing newer
    ck.save(2, w2)
    assert store.poll_once() and store.step == 2
    assert store.get()[1].numpy().tobytes() == w2.tobytes()
    assert t1.numpy().tobytes() == w1.tobytes()  # the old snapshot is untouched
    assert m.gauge("serve.model.version").value == 2
    with open(tmp_path / "3.npz", "wb") as f:  # a torn file
        f.write(b"not an npz")
    assert not store.poll_once()
    assert store.step == 2 and m.counter("serve.model.reload.errors").value == 1
    assert m.counter("serve.model.reload").value == 2  # steps 1 and 2
    store.stop()


def test_an_orbax_directory_fails_the_store_at_start(tmp_path):
    (tmp_path / "5").mkdir()  # an orbax step directory
    with pytest.raises(ValueError, match="orbax"):
        ModelStore(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        ServingServer(str(tmp_path), port=0, host="127.0.0.1", device="cpu")


def _full(version, w):
    req = pb.PushWeightsRequest(version=version)
    req.weights.CopyFrom(codec.encode_tensor(np.asarray(w, np.float32)))
    return req


def _delta(version, base, idx, vals):
    req = pb.PushWeightsRequest(version=version)
    req.delta.CopyFrom(pb.WeightDelta(base_version=base, indices=np.asarray(idx, np.int32),
                                      values=np.asarray(vals, np.float32)))
    return req


def test_a_delta_that_lands_mid_flush_leaves_that_flush_on_its_step(tmp_path):
    w1 = _weights(1, 64)
    Checkpointer(str(tmp_path)).save(1, w1)
    server = ServingServer(str(tmp_path), port=0, host="127.0.0.1", max_batch=1,
                           max_delay_ms=0.0, ckpt_poll_s=30.0, metrics=Metrics(),
                           device="cpu").start()
    entered, release = threading.Event(), threading.Event()
    forward = server.engine.forward

    def gated(*a):
        entered.set()
        assert release.wait(10)
        return forward(*a)

    server.engine.forward = gated
    try:
        row = (np.array([3, 7], np.int32), np.array([1.0, -2.0], np.float32))
        pending = server.batcher.submit(*row)
        assert entered.wait(10)
        published = server.store.get()[1]
        assert server.store.apply_push(_delta(2, 1, [3, 7], [5.0, 6.0])) == (True, 2)
        release.set()
        _, margin, step = pending.wait(10)
        assert step == 1 and margin == pytest.approx(float(w1[3] - 2 * w1[7]), abs=1e-6)
        assert published.numpy().tobytes() == w1.tobytes()  # never written into
        _, margin, step = server.batcher.submit(*row).wait(10)
        assert step == 2 and margin == pytest.approx(5.0 - 12.0, abs=1e-6)
    finally:
        release.set()
        server.stop()


def _port_server(tmp_path, name="port", **kw):
    return ServingServer(str(tmp_path / name), port=0, host="127.0.0.1", metrics=Metrics(),
                         device="cpu", **kw).start()


def test_jax_pushes_give_port_weights_bitwise_equal_to_a_jax_store(tmp_path):
    port = _port_server(tmp_path, ckpt_poll_s=30.0)
    jax_server = JaxServingServer(str(tmp_path / "jax"), port=0, host="127.0.0.1",
                                  ckpt_poll_s=30.0, metrics=JaxMetrics()).start()
    pusher = JaxWeightPusher([("127.0.0.1", port.bound_port),
                              ("127.0.0.1", jax_server.bound_port)], metrics=JaxMetrics())
    rng = np.random.default_rng(11)
    w = _weights(5)
    try:
        for version in (1, 2, 3, 4):
            if version > 1:  # a sparse update: about 2% of the coordinates
                w = w.copy()
                hit = rng.choice(D, size=20, replace=False)
                w[hit] = rng.normal(size=20).astype(np.float32)
            assert pusher.push(version, w) == 2
            pw = port.store.get()[1].numpy()
            jw = np.asarray(jax_server.store.get()[1])
            assert port.store.step == jax_server.store.step == version
            assert pw.tobytes() == jw.tobytes() == w.tobytes()
        pm = port.metrics
        assert pm.counter("serve.model.push.full").value == 1
        assert pm.counter("serve.model.push.delta").value == 3
        assert pusher.metrics.counter("serve.push.delta").value == 6
    finally:
        pusher.close()
        port.stop()
        jax_server.stop()


def test_a_version_gap_nacks_and_reloads_from_the_directory(tmp_path):
    ck = Checkpointer(str(tmp_path / "port"))
    w_file = _weights(8, 64)
    ck.save(9, w_file)
    port = _port_server(tmp_path, ckpt_poll_s=30.0)
    try:
        assert port.store.apply_push(_full(3, _weights(1, 64))) == (True, 3)
        assert port.store.push_mode and port.store.step == 3
        ck.save(10, w_file)
        assert not port.store.poll_once()  # push mode: the file poll does not swap
        # a delta on a base the replica does not hold: NACK, then the file wins
        ok, step = port.store.apply_push(_delta(5, 4, [0], [1.0]))
        assert (ok, step) == (False, 10)
        assert port.store.get()[1].numpy().tobytes() == w_file.tobytes()
        assert port.metrics.counter("serve.model.push.gap").value == 1
    finally:
        port.stop()


# -- the replica over gRPC, a JAX client against it -----------------------------


@pytest.fixture
def replica(tmp_path):
    server = ServingServer(str(tmp_path), port=0, host="127.0.0.1", max_batch=8,
                           max_delay_ms=5.0, queue_depth=32, ckpt_poll_s=0.1,
                           metrics=Metrics(), device="cpu").start()
    channel = jax_new_channel("127.0.0.1", server.bound_port)
    try:
        yield server, JaxServeStub(channel), lambda step, w: Checkpointer(
            str(tmp_path)).save(step, w)
    finally:
        channel.close()
        server.stop()


def test_a_jax_client_against_a_port_replica(replica):
    from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb

    server, stub, save = replica
    health = stub.ServeHealth(jpb.Empty(), timeout=5)
    assert not health.ok
    with pytest.raises(grpc.RpcError) as err:
        stub.Predict(jpb.PredictRequest(indices=[0], values=[1.0]), timeout=5)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    w = _weights(6)
    save(1, w)
    server.store.poll_once()
    rows = _rows(40, seed=2)
    replies = [stub.Predict(jpb.PredictRequest(indices=i, values=v), timeout=15) for i, v in rows]
    margins = np.array([r.margin for r in replies])
    np.testing.assert_allclose(margins, _oracle(rows, w), rtol=0, atol=MARGIN_ATOL)
    firm = np.abs(margins) >= PRED_MARGIN
    np.testing.assert_array_equal(np.array([r.prediction for r in replies])[firm],
                                  -np.sign(margins[firm]))
    assert {r.model_step for r in replies} == {1}
    assert stub.ServeHealth(jpb.Empty(), timeout=5).ok
    assert server.metrics.histogram("serve.predict.duration").count == len(rows)
    with pytest.raises(grpc.RpcError) as err:  # a feature past the model's width
        stub.Predict(jpb.PredictRequest(indices=[D], values=[1.0]), timeout=5)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    snap = stub.Metrics(jpb.Empty(), timeout=5)  # the telemetry scrape, in the JAX proto
    assert snap.role == "serve"
    assert {h.name: h.count for h in snap.hists}["serve.predict.duration"] == len(rows)


def test_answers_for_one_row_in_one_bucket_repeat_bit_for_bit(replica):
    server, stub, save = replica
    save(1, _weights(6))
    server.store.poll_once()
    i, v = _rows(1, seed=4)[0]
    margins = {stub.Predict(pb.PredictRequest(indices=i, values=v), timeout=15).margin
               for _ in range(20)}
    assert len(margins) == 1


def test_a_hot_swap_mid_traffic_fails_no_request(replica):
    server, stub, save = replica
    w1 = np.ones(32, np.float32)
    save(1, w1)
    server.store.poll_once()
    stop, failures, steps = threading.Event(), [], set()

    def traffic():
        while not stop.is_set():
            try:
                r = stub.Predict(pb.PredictRequest(indices=[3], values=[1.0]), timeout=15)
                steps.add((r.model_step, r.margin))
            except Exception as e:  # noqa: BLE001 - collected for the assert
                failures.append(e)

    threads = [threading.Thread(target=traffic) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    save(2, w1 * -5.0)  # the 0.1 s poll picks it up under traffic
    deadline = time.time() + 20
    while time.time() < deadline and 2 not in {s for s, _ in steps}:
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join()
    assert not failures, failures[:3]
    assert steps == {(1, 1.0), (2, -5.0)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_one_bad_row_after_a_shrinking_swap_gets_invalid_argument_alone(pkg, tmp_path):
    """Three rows admitted against a 64-feature model share one flush; the
    model shrinks to 16 features before it runs: the row past 16 fails
    with INVALID_ARGUMENT, the two others are answered from the new
    model."""
    big, small = _weights(1, 64), _weights(2, 16)
    if pkg == "port":
        server = _port_server(tmp_path, max_batch=3, max_delay_ms=5000.0, ckpt_poll_s=30.0)
        server.store.apply_push(_full(1, big))
    else:
        server = JaxServingServer(str(tmp_path / "jax"), port=0, host="127.0.0.1",
                                  max_batch=3, max_delay_ms=5000.0, ckpt_poll_s=30.0,
                                  metrics=JaxMetrics()).start()
        server.store.apply_push(_full(1, big))
    entered, gate = threading.Event(), threading.Event()
    run = server.batcher._run_batch

    def gated(rows):
        entered.set()  # all three rows collected; the flush waits on the gate
        assert gate.wait(20)
        return run(rows)

    server.batcher._run_batch = gated
    channel = new_channel("127.0.0.1", server.bound_port)
    stub = ServeStub(channel)
    try:
        rows = [([1, 5], [1.0, 2.0]), ([3, 40], [1.0, 1.0]), ([15], [-1.0])]
        futs = [stub.Predict.future(pb.PredictRequest(indices=i, values=v), timeout=30)
                for i, v in rows]
        assert entered.wait(20)
        server.store.apply_push(_full(2, small))
        gate.set()
        good = [futs[0].result(), futs[2].result()]
        with pytest.raises(grpc.RpcError) as err:
            futs[1].result()
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert [r.model_step for r in good] == [2, 2]
        assert good[0].margin == pytest.approx(float(small[1] + 2 * small[5]), abs=1e-6)
        assert good[1].margin == pytest.approx(float(-small[15]), abs=1e-6)
    finally:
        gate.set()
        channel.close()
        server.stop()


def test_the_health_probe_reads_a_replica(replica):
    server, _, save = replica
    assert health_probe.main([str(server.bound_port)]) == 1  # no snapshot yet
    save(1, _weights(1, 8))
    server.store.poll_once()
    assert health_probe.main([str(server.bound_port)]) == 0


# -- config --------------------------------------------------------------------

_SERVE_ENV = {
    "DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": "/tmp/ck", "DSGD_SERVE_PORT": "4242",
    "DSGD_SERVE_MAX_BATCH": "16", "DSGD_SERVE_MAX_DELAY_MS": "2.5",
    "DSGD_SERVE_QUEUE_DEPTH": "64", "DSGD_SERVE_CKPT_POLL_S": "0.5",
    "DSGD_SERVE_REPLICAS": "3", "DSGD_SERVE_CANARY": "0.34", "DSGD_SERVE_PROBE": "p.npz",
    "DSGD_SERVE_HEDGE_MS": "100", "DSGD_SERVE_HEALTH_S": "0.5",
    "DSGD_SERVE_STATE": "s.json", "DSGD_SERVE_PROBE_REFRESH_S": "30",
    "DSGD_SERVE_SLO_MS": "25", "DSGD_SERVE_SCALE_MAX": "6",
    "DSGD_SERVE_SCALE_COOLDOWN_S": "2", "DSGD_RESOURCE_PROBE_S": "0.5",
    "DSGD_BLACKBOX_DIR": "bb",
}
_SERVE_FIELDS = ("serve_port", "serve_max_batch", "serve_max_delay_ms", "serve_queue_depth",
                 "serve_ckpt_poll_s", "serve_replicas", "serve_targets", "serve_push",
                 "serve_canary", "serve_probe", "serve_hedge_ms", "serve_health_s",
                 "serve_state", "serve_probe_refresh_s", "serve_ha", "serve_slo_ms",
                 "serve_scale_max", "serve_scale_cooldown_s", "resource_probe_s",
                 "blackbox_dir", "role_override", "checkpoint_dir")


def test_the_serving_env_parses_as_the_jax_configs(monkeypatch):
    def fields(cfg):
        return {f: getattr(cfg, f) for f in _SERVE_FIELDS}

    assert fields(Config()) == fields(JaxConfig())  # the defaults
    for k, v in _SERVE_ENV.items():
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    assert fields(cfg) == fields(JaxConfig.from_env()) and cfg.role == "serve"
    monkeypatch.setenv("DSGD_ROLE", "route")
    monkeypatch.setenv("DSGD_SERVE_TARGETS", "127.0.0.1:1,10.0.0.2:4100")
    monkeypatch.setenv("DSGD_SERVE_HA", "peers:127.0.0.1:9;self=127.0.0.1:8;sync=100ms")
    monkeypatch.setenv("DSGD_SERVE_PUSH", "127.0.0.1:4100")
    assert fields(Config.from_env()) == fields(JaxConfig.from_env())


@pytest.mark.parametrize("kw", [
    {"role_override": "serve"},  # no checkpoint_dir
    {"serve_max_batch": 0}, {"serve_max_delay_ms": -1.0}, {"serve_queue_depth": 0},
    {"serve_ckpt_poll_s": 0.0}, {"serve_replicas": -1},
    {"role_override": "route"},  # no targets
    {"role_override": "route", "serve_targets": "nohost"},
    {"serve_push": "127.0.0.1:1"},  # no checkpoint_dir
    {"serve_push": "127.0.0.1:1,x", "checkpoint_dir": "c"},
    {"serve_canary": 1.5},
    {"role_override": "route", "serve_targets": "h:1", "serve_canary": 0.5},  # no probe
    {"serve_hedge_ms": -1.0}, {"serve_health_s": 0.0}, {"serve_probe_refresh_s": -1.0},
    {"role_override": "serve", "checkpoint_dir": "c", "serve_probe_refresh_s": 5.0},
    {"serve_ha": "peers:h:1"},  # not a router
    {"role_override": "route", "serve_targets": "h:1", "serve_ha": "h:1"},
    {"role_override": "route", "serve_targets": "h:1", "serve_ha": "peers:h:1;sync=0"},
    {"role_override": "route", "serve_targets": "h:1", "serve_ha": "peers:h:1;bogus=1"},
    {"serve_slo_ms": -1.0},
    {"role_override": "serve", "checkpoint_dir": "c", "serve_slo_ms": 10.0},  # no fleet
    {"serve_scale_max": 0},
    {"serve_slo_ms": 10.0, "serve_replicas": 4, "serve_scale_max": 2},
    {"serve_scale_cooldown_s": -1.0},
    {"resource_probe_s": -1.0},
    {"blackbox_dir": "bb"},  # no probe
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_a_bad_serving_setting_is_refused_as_jax_refuses_it(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        Config(**kw)


@pytest.mark.parametrize("env", [
    {"DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": "c", "DSGD_HEALTH_ACTION": "warn"},
    {"DSGD_ROLE": "route", "DSGD_SERVE_TARGETS": "h:1", "DSGD_TELEMETRY": "1"},
    {"DSGD_ROLE": "route", "DSGD_SERVE_TARGETS": "h:1", "DSGD_AUTOPILOT": "1"},
    {"DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": "c", "DSGD_CHAOS": "seed=1;drop=0.1"},
    {"DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": "c", "DSGD_HOST_DEVICES": "2"},
], ids=lambda env: "+".join(f"{k[5:].lower()}={v}" for k, v in env.items()))
def test_a_serving_role_refuses_what_is_not_ported_and_takes_the_rest(env, monkeypatch):
    # nothing is refused any more.  DSGD_TELEMETRY is acted on: the route
    # role builds its router with the fleet telemetry endpoint on
    # DSGD_TELEMETRY_PORT (default 9091); so is DSGD_AUTOPILOT: the router
    # samples its own traffic into a probe reservoir, rotated in every
    # DSGD_AUTOPILOT_SOURCE_REFRESH_S.  DSGD_HOST_DEVICES is a worker host's
    # setting, DSGD_HEALTH_ACTION a training fit's and DSGD_CHAOS the
    # training roles' wire, which the serve role takes and ignores, as the
    # JAX CLI does: it builds its server
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "DSGD_HOST_DEVICES" in env or "DSGD_HEALTH_ACTION" in env or "DSGD_CHAOS" in env:
        from distributed_sgd_tpu_torch.serving import server as tserver

        class _Served(Exception):
            pass

        def served(cfg, **kw):
            raise _Served(cfg.host_devices)

        monkeypatch.setattr(tserver.ServingServer, "from_config", served)
        with pytest.raises(_Served) as got:
            tmain.main(device="cpu")
        assert got.value.args == (int(env.get("DSGD_HOST_DEVICES", 1)),)
        from distributed_sgd_tpu_torch import chaos

        assert chaos.state() is None  # the serve role installs no plan
        return
    if "DSGD_AUTOPILOT" in env:
        from distributed_sgd_tpu_torch.autopilot import ProbeReservoir
        from distributed_sgd_tpu_torch.serving import router as trouter

        class _Sourced(Exception):
            pass

        def sourced(*a, **kw):
            src = kw.get("probe_source")
            raise _Sourced(type(src), src.capacity, src.label_delay, src.min_fill,
                           kw.get("probe_source_refresh_s"))

        monkeypatch.setattr(trouter, "ServingRouter", sourced)
        with pytest.raises(_Sourced) as got:
            tmain.main(device="cpu")
        assert got.value.args == (ProbeReservoir, 64, 0, 32, 2.0)
        return
    if "DSGD_TELEMETRY" in env:
        from distributed_sgd_tpu_torch.serving import router as trouter

        class _Built(Exception):
            pass

        def built(*a, **kw):
            raise _Built(kw.get("telemetry_port"))

        monkeypatch.setattr(trouter, "ServingRouter", built)
        with pytest.raises(_Built) as got:
            tmain.main(device="cpu")
        assert got.value.args == (9091,)
        return
    raise AssertionError(f"no case for {env}")


# -- the CLI -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _role_process(env: dict) -> subprocess.Popen:
    """A role of the port's CLI in a process of its own, on the CPU (the
    CLI itself takes the card)."""
    full = {**os.environ, "PYTHONPATH": str(ROOT), **env}
    return subprocess.Popen(
        [sys.executable, "-c", "from distributed_sgd_tpu_torch.main import main; "
                               "main(device='cpu')"],
        env=full, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_for_health(port: int, want_ok: bool = True, timeout: float = 30.0):
    channel = new_channel("127.0.0.1", port)
    stub = ServeStub(channel)
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            try:
                reply = stub.ServeHealth(pb.Empty(), timeout=1)
                if reply.ok or not want_ok:
                    return reply
            except grpc.RpcError:
                pass
            time.sleep(0.1)
    finally:
        channel.close()
    raise AssertionError(f"nothing healthy on :{port} after {timeout} s")


def test_the_serve_and_route_roles_answer_and_exit_0_on_sigterm(tmp_path):
    w = _weights(7)
    Checkpointer(str(tmp_path)).save(4, w)
    serve_port, route_port = _free_port(), _free_port()
    serve = _role_process({"DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": str(tmp_path),
                           "DSGD_SERVE_PORT": str(serve_port)})
    route = _role_process({"DSGD_ROLE": "route", "DSGD_SERVE_PORT": str(route_port),
                           "DSGD_SERVE_TARGETS": f"127.0.0.1:{serve_port}",
                           "DSGD_SERVE_HEALTH_S": "0.2"})
    try:
        _wait_for_health(serve_port)
        assert _wait_for_health(route_port).model_step == 4
        rows = _rows(20, seed=12)
        for port in (serve_port, route_port):
            channel = new_channel("127.0.0.1", port)
            stub = ServeStub(channel)
            margins = [stub.Predict(pb.PredictRequest(indices=i, values=v), timeout=15).margin
                       for i, v in rows]
            channel.close()
            np.testing.assert_allclose(margins, _oracle(rows, w), rtol=0, atol=MARGIN_ATOL)
    finally:
        for proc in (route, serve):
            proc.send_signal(signal.SIGTERM)
        outs = [proc.communicate(timeout=30)[0] for proc in (route, serve)]
    assert (route.returncode, serve.returncode) == (0, 0), outs
    assert "routing on :" in outs[0] and "serving model=hinge" in outs[1]


def test_a_training_role_with_serve_push_pushes_to_a_replica(tmp_path, monkeypatch):
    port = _port_server(tmp_path, ckpt_poll_s=30.0)
    ckpt = tmp_path / "train"
    try:
        for k, v in {"DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "2",
                     "DSGD_CHECKPOINT_DIR": str(ckpt),
                     "DSGD_SERVE_PUSH": f"127.0.0.1:{port.bound_port}"}.items():
            monkeypatch.setenv(k, v)
        run = tmain.main(device="cpu")
        step, state = Checkpointer(str(ckpt)).restore_latest()
        assert port.store.step == step
        assert port.store.get()[1].numpy().tobytes() == state["weights"].tobytes()
        assert run.fit.weights.numpy().tobytes() == state["weights"].tobytes()
        assert port.metrics.counter("serve.model.push.full").value >= 1
    finally:
        port.stop()


def _role_in_thread(cfg):
    box = {}

    def run():
        try:
            box["run"] = tmain.main(device="cpu", cfg=cfg)
        except BaseException as e:  # noqa: BLE001 - raised in the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def test_the_fleet_role_with_the_autoscaler_serves_until_stopped(tmp_path):
    w = _weights(3)
    Checkpointer(str(tmp_path)).save(2, w)
    port = _free_port()
    t, box = _role_in_thread(Config(role_override="serve", checkpoint_dir=str(tmp_path),
                                    serve_port=port, serve_replicas=2, serve_slo_ms=50.0,
                                    serve_scale_max=3, serve_health_s=0.2))
    try:
        assert _wait_for_health(port).model_step == 2
        channel = new_channel("127.0.0.1", port)
        rows = _rows(10, seed=1)
        margins = [ServeStub(channel).Predict(pb.PredictRequest(indices=i, values=v),
                                              timeout=15).margin for i, v in rows]
        channel.close()
        np.testing.assert_allclose(margins, _oracle(rows, w), rtol=0, atol=MARGIN_ATOL)
        assert [s for s in threading.enumerate() if s.name == "route-autoscale"]
    finally:
        tmain.stop_serving()
        t.join(30)
    assert not t.is_alive() and "error" not in box and box["run"].fit is None
    assert not [s for s in threading.enumerate() if s.name == "route-autoscale"]


def test_a_wedged_flush_sheds_with_resource_exhausted(tmp_path):
    """A bounded queue behind a stuck flush answers RESOURCE_EXHAUSTED,
    and the admitted requests complete once it unwedges."""
    server = _port_server(tmp_path, max_batch=1, max_delay_ms=0.0, queue_depth=2,
                          ckpt_poll_s=30.0)
    server.store.apply_push(_full(1, _weights(1, 8)))
    release = threading.Event()
    run = server.batcher._run_batch
    server.batcher._run_batch = lambda rows: (release.wait(30), run(rows))[1]
    channel = new_channel("127.0.0.1", server.bound_port)
    try:
        futs = [ServeStub(channel).Predict.future(pb.PredictRequest(indices=[0], values=[1.0]))
                for _ in range(12)]
        deadline = time.time() + 10
        shed = 0
        while time.time() < deadline and not shed:
            shed = sum(1 for f in futs if f.done() and f.exception() is not None
                       and f.exception().code() == grpc.StatusCode.RESOURCE_EXHAUSTED)
            time.sleep(0.05)
        assert shed and server.metrics.counter("serve.rejected").value >= 1
        release.set()
        answered = [f.result(timeout=15) for f in futs if f.exception() is None]
        assert answered and all(r.model_step == 1 for r in answered)
    finally:
        release.set()
        channel.close()
        server.stop()


def test_the_serve_profile_window_writes_a_trace(tmp_path):
    engine = PredictEngine("hinge", device="cpu", profile_dir=str(tmp_path / "prof"))
    snap = (1, torch.from_numpy(_weights(2, 64)))
    rows = [(np.array([1, 2], np.int32), np.array([1.0, 0.5], np.float32))]
    for _ in range(PredictEngine.PROFILE_BATCHES + 1):
        engine.run(snap, _pending(tbatcher, rows))
    assert (tmp_path / "prof" / "predict.trace.json").exists()


def test_readers_never_see_a_step_with_another_steps_weights(tmp_path):
    """Stress: pushers (full pushes and delta chains) and readers race on
    one store with a shortened switch interval.  Version v's weights are
    all v, so every snapshot a reader takes must hold only its own step,
    and a delta never lands on a base it was not built for."""
    import sys

    d = 256
    store = ModelStore(str(tmp_path), poll_s=30.0, device="cpu")
    store.apply_push(_full(1, np.full(d, 1.0, np.float32)))
    stop, bad, versions = threading.Event(), [], iter(range(2, 10 ** 9))
    lock = threading.Lock()

    def pusher(k):
        while not stop.is_set():
            with lock:
                v = next(versions)
            if k % 2:
                store.apply_push(_full(v, np.full(d, float(v), np.float32)))
            else:  # a delta on whatever is current: every coordinate set to v
                base = store.step
                store.apply_push(_delta(v, base, np.arange(d), np.full(d, float(v))))

    def reader():
        while not stop.is_set():
            step, w = store.get()
            if not bool((w == float(step)).all()):
                bad.append(step)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = ([threading.Thread(target=pusher, args=(k,)) for k in range(6)]
               + [threading.Thread(target=reader) for _ in range(6)])
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(old)
        store.stop()
    assert not any(t.is_alive() for t in threads)
    assert not bad, f"{len(bad)} snapshots held another step's weights"
    assert store.step > 1


def test_a_stop_that_lands_before_the_role_registers_ends_it(tmp_path, monkeypatch):
    """stop_serving() between the serve node's start and its registration
    (the role answers, but stop_serving finds no role to stop): main()
    returns all the same."""
    Checkpointer(str(tmp_path)).save(2, _weights(3))
    real = tmain._serve_until_stopped

    def stop_first(role, stops_before):
        tmain.stop_serving()
        return real(role, stops_before)

    monkeypatch.setattr(tmain, "_serve_until_stopped", stop_first)
    t, box = _role_in_thread(Config(role_override="serve", checkpoint_dir=str(tmp_path),
                                    serve_port=_free_port(), serve_health_s=0.2))
    t.join(30)
    assert not t.is_alive() and "error" not in box and box["run"].fit is None
