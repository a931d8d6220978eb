"""The port's gradient compression (compress/, ops/topk.py, DSGD_COMPRESS)
against the JAX package's, on the same numpy inputs, on the CPU.

The non-slow cases of tests/test_compress.py, each run through both
packages: the codecs' bytes, the top-k support (ties broken as
``lax.top_k`` breaks them: the lower index first, also where the vector
has fewer nonzeros than k), the qint8 codes for one seed, error feedback
(telescoping, a residual a destination, snapshot, restore and drop), the
bytes on the wire, the worker's retry guard, fit token and quorum
rollback.  Then the engines: one Hogwild worker's compressed deltas with
the JAX worker's draws injected, sync RPC fits with top-k and error
feedback over port, JAX and mixed clusters within 1e-5 of the all-JAX
cluster, a mixed async qint8 gossip cluster that trains, the knobs
through the CLI, and the warning of the mesh engines in the JAX CLI's
words.  Each test runs under a time limit of its own (`LIMIT_S`)."""

import logging
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu import compress as jcompress
from distributed_sgd_tpu import main as jmain
from distributed_sgd_tpu.config import Config as JaxConfig
from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.core.worker import _WorkerServicer as JaxServicer
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.ops.topk import resolve_k as jax_resolve_k
from distributed_sgd_tpu.ops.topk import topk_magnitude as jax_topk
from distributed_sgd_tpu.parallel import hogwild as jhog
from distributed_sgd_tpu.rpc import codec as jcodec
from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.compress import (
    COMPRESS_CHOICES,
    NoneCompressor,
    QInt8Compressor,
    TopKCompressor,
    make_compressor,
)
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode, _WorkerServicer
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops.topk import resolve_k, topk_magnitude
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel.sync import ShardedData
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR, WORKERS, EPOCHS = 200, 1e-4, 16, 0.5, 3, 2
K_FRAC = 0.05  # top-k's DSGD_COMPRESS_K in the fits: 10 of 200 coordinates
ATOL = 1e-5
DIM_RCV1 = 47236
LIMIT_S = 90  # each test's own time limit, seconds
# the planted ties: equal magnitudes at 1, 2, 5 (3), at 4, 7 (1), and 5 zeros
TIES = np.array([0, 3, -3, 0, 1, 3, 0, -1, 2, 0, 0], np.float32)


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _vec(rng, dim, density=1.0):
    x = rng.normal(size=dim).astype(np.float32)
    if density < 1.0:
        x[rng.random(dim) >= density] = 0.0
    return x


def _pair(kind, **kw):
    """(the JAX compressor, the port's) of one kind, each on a registry of
    its own; the port's top-k selects on the CPU."""
    if kind == "topk":
        return (jcompress.TopKCompressor(metrics=jmetrics.Metrics(), **kw),
                TopKCompressor(metrics=mm.Metrics(), device="cpu", **kw))
    if kind == "qint8":
        return (jcompress.QInt8Compressor(metrics=jmetrics.Metrics(), **kw),
                QInt8Compressor(metrics=mm.Metrics(), **kw))
    return (jcompress.NoneCompressor(metrics=jmetrics.Metrics()),
            NoneCompressor(metrics=mm.Metrics()))


def _same_bytes(jmsg, tmsg):
    assert tmsg.SerializeToString() == jmsg.SerializeToString()


# -- the codecs ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_none_roundtrip_is_the_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    dim = int(rng.integers(1, 3000))
    x = _vec(rng, dim, density=float(rng.choice([1.0, 0.3, 0.01])))
    j, t = _pair("none")
    msg = t.compress(x)
    np.testing.assert_array_equal(codec.decode_grad(msg), x)
    _same_bytes(j.compress(x), msg)
    assert msg.SerializeToString() == codec.encode_grad(x).SerializeToString()


def test_make_compressor_none_returns_none_and_top_k_needs_a_device():
    for name in (None, "", "none"):
        assert make_compressor(name) is None
    with pytest.raises(ValueError, match="gzip"):
        make_compressor("gzip")
    assert COMPRESS_CHOICES == jcompress.COMPRESS_CHOICES
    assert make_compressor("topk", device="cpu").device == torch.device("cpu")
    assert isinstance(make_compressor("qint8"), QInt8Compressor)  # host numpy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_compressor("topk")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            topk_magnitude(np.ones(4, np.float32), 2)


@pytest.mark.parametrize("seed", range(5))
def test_topk_recovers_the_jax_support(seed):
    rng = np.random.default_rng(100 + seed)
    dim = int(rng.integers(50, 5000))
    k = int(rng.integers(1, max(2, dim // 10)))
    x = _vec(rng, dim)
    j, t = _pair("topk", k=k, error_feedback=False)
    msg = t.compress(x)
    _same_bytes(j.compress(x), msg)
    out = codec.decode_grad(msg)
    expect_idx = np.sort(np.argsort(np.abs(x))[-k:])
    np.testing.assert_array_equal(np.nonzero(out)[0], expect_idx)
    np.testing.assert_array_equal(out[expect_idx], x[expect_idx])


def test_topk_k_resolution_is_the_jax_one():
    for k, dim in ((0.01, DIM_RCV1), (100, DIM_RCV1), (0.5, 10), (1e9, 10), (1e-9, 10),
                   (0.999, 7), (1.0, 7), (2.5, 7)):
        assert resolve_k(k, dim) == jax_resolve_k(k, dim)
    assert resolve_k(0.01, DIM_RCV1) == 472
    with pytest.raises(ValueError):
        resolve_k(0.0, 10)


@pytest.mark.parametrize("k", [2, 8, 10])
def test_planted_ties_break_to_the_lower_index_as_lax_top_k(k):
    # at k=2 torch.topk keeps [1, 5] and at k=8 drops index 0: lax.top_k
    # keeps the lower index among equal magnitudes, and so must the port
    # (k=10 is more than the 6 nonzeros: the zeros tie)
    j_idx, j_val = jax_topk(TIES, k)
    t_idx, t_val = topk_magnitude(TIES, k, device="cpu")
    assert (t_idx.dtype, t_val.dtype) == (np.int32, np.float32)
    assert t_idx.tobytes() == j_idx.tobytes()
    assert t_val.tobytes() == j_val.tobytes()
    assert {2: [1, 2], 8: [0, 1, 2, 3, 4, 5, 7, 8]}.get(k, t_idx.tolist()) == t_idx.tolist()
    # a tensor is selected on its own device, the same way
    got, _ = topk_magnitude(torch.from_numpy(TIES), k)
    assert got.tobytes() == j_idx.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_fewer_nonzeros_than_k_pick_the_jax_zeros(seed):
    # a sparse delta: 100 rows x ~8 nonzeros asks for k past its support
    rng = np.random.default_rng(300 + seed)
    dim = int(rng.integers(200, 3000))
    x = _vec(rng, dim, density=0.05)
    x[rng.integers(0, dim, 8)] = 1.5  # and ties among the nonzeros
    k = int(np.count_nonzero(x)) + int(rng.integers(1, 50))
    j_idx, j_val = jax_topk(x, k)
    t_idx, t_val = topk_magnitude(x, k, device="cpu")
    assert t_idx.tobytes() == j_idx.tobytes() and t_val.tobytes() == j_val.tobytes()


def test_topk_selection_indices_sorted_ascending():
    idx, vals = topk_magnitude(np.random.default_rng(7).normal(size=500).astype(np.float32), 32,
                               device="cpu")
    assert np.all(np.diff(idx) > 0) and len(idx) == len(vals) == 32


@pytest.mark.parametrize("seed", range(3))
def test_qint8_codes_are_the_jax_codes_for_one_seed(seed):
    rng = np.random.default_rng(200 + seed)
    j, t = _pair("qint8", seed=seed, error_feedback=False)
    for _ in range(4):
        x = _vec(rng, int(rng.integers(10, 4000))) * float(rng.uniform(0.01, 100))
        _same_bytes(j.compress(x), t.compress(x))


def test_compressed_grad_survives_wire_serialization_both_ways():
    x = _vec(np.random.default_rng(1), 1000)
    for kind, kw in (("topk", {"k": 0.05}), ("qint8", {})):
        _, t = _pair(kind, **kw)
        msg = t.compress(x, dest="d")
        msg.n_steps = 7
        parsed = jpb.GradUpdate.FromString(msg.SerializeToString())  # a JAX receiver
        assert parsed.WhichOneof("grad") == "compressed" and parsed.n_steps == 7
        np.testing.assert_array_equal(jcodec.decode_grad(parsed), codec.decode_grad(msg))


# -- error feedback --------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [("topk", {"k": 0.02}), ("qint8", {"seed": 5})])
def test_error_feedback_telescopes_as_the_jax_codec(kind, kw):
    """sum(decoded) + final residual == sum(inputs), and every message and
    the residual are the JAX compressor's."""
    j, t = _pair(kind, error_feedback=True, **kw)
    rng = np.random.default_rng(42)
    total_in = np.zeros(600, np.float64)
    total_out = np.zeros(600, np.float64)
    for _ in range(40):
        x = _vec(rng, 600) * 0.1
        total_in += x
        msg = t.compress(x, dest="p")
        _same_bytes(j.compress(x, dest="p"), msg)
        total_out += codec.decode_grad(msg)
    residual = t.residual_snapshot("p")
    np.testing.assert_array_equal(residual, j.residual_snapshot("p"))
    np.testing.assert_allclose(total_out + residual, total_in, atol=1e-3)


def test_residuals_are_per_destination_with_snapshot_restore_and_drop():
    j, t = _pair("topk", k=2, error_feedback=True)
    rng = np.random.default_rng(9)
    x1, x2 = _vec(rng, 100), _vec(rng, 100)
    for c in (j, t):
        c.compress(x1, dest="a")
        c.compress(x2, dest="b")
    assert set(t._residuals) == {"a", "b"}
    a = t.residual_snapshot("a")
    assert isinstance(a, np.ndarray)
    np.testing.assert_array_equal(a, j.residual_snapshot("a"))
    # compressing zero ships the top of the residual itself
    msg = t.compress(np.zeros(100, np.float32), dest="a")
    _same_bytes(j.compress(np.zeros(100, np.float32), dest="a"), msg)
    sent_a = codec.decode_grad(msg)
    assert np.count_nonzero(sent_a) == 2
    np.testing.assert_allclose(sent_a[sent_a != 0], a[sent_a != 0], rtol=1e-6)
    # restore, drop, reset
    t.residual_restore("a", a)
    np.testing.assert_array_equal(t.residual_snapshot("a"), a)
    t.residual_restore("b", None)
    assert t.residual_snapshot("b") is None
    t.residual_drop("a")
    t.residual_drop("missing")  # idempotent
    assert not t._residuals
    t.reset()
    assert not t._residuals


def test_without_error_feedback_no_state_accumulates():
    for kind in ("topk", "qint8"):
        _, t = _pair(kind, error_feedback=False, **({"k": 2} if kind == "topk" else {}))
        t.compress(np.arange(10, dtype=np.float32), dest="a")
        assert not t._residuals


# -- comms accounting ------------------------------------------------------------


def test_bytes_on_wire_are_the_serialized_sizes_and_the_jax_counts():
    m, jm = mm.Metrics(), jmetrics.Metrics()
    rng = np.random.default_rng(11)
    comps = [(jcompress.NoneCompressor(metrics=jm), NoneCompressor(metrics=m)),
             (jcompress.TopKCompressor(k=0.01, metrics=jm),
              TopKCompressor(k=0.01, metrics=m, device="cpu")),
             (jcompress.QInt8Compressor(metrics=jm), QInt8Compressor(metrics=m))]
    sizes = n_msgs = 0
    for j, t in comps:
        for _ in range(3):
            x = _vec(rng, 2000)
            msg = t.compress(x, dest="d")
            j.compress(x, dest="d")
            sizes += msg.ByteSize()
            assert msg.ByteSize() == len(msg.SerializeToString())
            n_msgs += 1
    assert m.counter(mm.COMMS_BYTES_ON_WIRE).value == sizes
    assert m.counter(mm.COMMS_BYTES_DENSE).value == 4 * 2000 * n_msgs
    assert m.histogram(mm.COMMS_RATIO).count == n_msgs
    assert m.histogram(mm.COMMS_RESIDUAL_NORM).count == 6
    for name in (mm.COMMS_BYTES_ON_WIRE, mm.COMMS_BYTES_DENSE):
        assert m.counter(name).value == jm.counter(name).value


def test_topk_1pct_wire_reduction_at_rcv1_dim():
    _, t = _pair("topk", k=0.01)
    msg = t.compress(np.random.default_rng(0).normal(size=DIM_RCV1).astype(np.float32),
                     dest="peer")
    assert 4 * DIM_RCV1 / msg.ByteSize() >= 20.0


def test_both_exporters_emit_comms_instruments():
    m = mm.Metrics()
    TopKCompressor(k=0.1, metrics=m, device="cpu").compress(
        np.arange(100, dtype=np.float32), dest="d")
    prom = m.prometheus_text()
    for name in ("comms_bytes_on_wire", "comms_compression_ratio", "comms_residual_norm"):
        assert name in prom
    influx = m.influx_lines()
    assert "comms.bytes_on_wire" in influx and "comms.compression_ratio" in influx


def test_config_compress_knobs_are_the_jax_ones(monkeypatch):
    cfg = Config()
    assert (cfg.compress, cfg.compress_k, cfg.compress_ef) == ("none", 0.01, True)
    monkeypatch.setenv("DSGD_COMPRESS", "topk")
    monkeypatch.setenv("DSGD_COMPRESS_K", "0.05")
    monkeypatch.setenv("DSGD_COMPRESS_EF", "0")
    got, want = Config.from_env(), JaxConfig.from_env()
    assert (got.compress, got.compress_k, got.compress_ef) == ("topk", 0.05, False)
    assert (got.compress, got.compress_k, got.compress_ef) == (
        want.compress, want.compress_k, want.compress_ef)
    for bad in ({"compress": "lz4"}, {"compress_k": 0.0}):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            Config(**bad)


# -- the worker's sync replies ------------------------------------------------------


class _Guarded:
    """Duck-typed stand-in: encode_sync_grad and rollback_sync_ef touch
    only these."""

    def __init__(self, compressor, metrics):
        self._compressor = compressor
        self._sync_ef_guard = (None, None)
        self._sync_guard_lock = threading.Lock()
        self._sync_fit_token = 0
        self.metrics = metrics
        self.node_label = "127.0.0.1:1"


def _guarded_pair(k=4):
    j, t = _pair("topk", k=k, error_feedback=True)
    return _Guarded(j, j.metrics), _Guarded(t, t.metrics)


def test_a_retried_window_rolls_the_residual_drain_back_as_jax():
    jw, tw = _guarded_pair()
    rng = np.random.default_rng(17)
    g0, g1, g2 = (_vec(rng, 200) for _ in range(3))
    for key, g in ((b"w0", g0), (b"w1", g1), (b"w1", g2), (b"w2", g1)):
        _same_bytes(JaxWorker.encode_sync_grad(jw, g, key),
                    WorkerNode.encode_sync_grad(tw, g, key))
        np.testing.assert_array_equal(tw._compressor.residual_snapshot("sync:master"),
                                      jw._compressor.residual_snapshot("sync:master"))
    assert tw._sync_ef_guard[0] == b"w2"
    np.testing.assert_array_equal(tw._sync_ef_guard[1], jw._sync_ef_guard[1])


def test_a_new_fit_token_drops_the_sync_residual_as_jax():
    jw, tw = _guarded_pair()
    rng = np.random.default_rng(23)
    g1, g2, g3 = (_vec(rng, 200) for _ in range(3))
    for key, g, tok in ((b"a", g1, 1), (b"b", g2, 1), (b"c", g3, 2), (b"d", g1, 0)):
        got = WorkerNode.encode_sync_grad(tw, g, key, fit_token=tok)
        _same_bytes(JaxWorker.encode_sync_grad(jw, g, key, fit_token=tok), got)
        if key == b"c":
            fresh = TopKCompressor(k=4, metrics=mm.Metrics(), device="cpu")
            _same_bytes(fresh.compress(g3, dest="sync:master"), got)
    assert tw._sync_fit_token == jw._sync_fit_token == 2


def test_a_quorum_rollback_restores_the_residual_and_counts_as_jax():
    jw, tw = _guarded_pair()
    rng = np.random.default_rng(5)
    g0, g1 = _vec(rng, 200), _vec(rng, 200)
    for w, enc in ((jw, JaxWorker.encode_sync_grad), (tw, WorkerNode.encode_sync_grad)):
        enc(w, g0, 1)
        enc(w, g1, 2)  # the window the quorum discards
    before = tw._compressor.residual_snapshot("sync:master")
    JaxWorker.rollback_sync_ef(jw, 2)
    WorkerNode.rollback_sync_ef(tw, 2)
    restored = tw._compressor.residual_snapshot("sync:master")
    np.testing.assert_array_equal(restored, jw._compressor.residual_snapshot("sync:master"))
    assert not np.array_equal(restored, before)
    assert tw.metrics.counter("slave.sync.ef.rollback").value == 1
    assert tw._sync_ef_guard == (None, None)
    # a key the guard does not hold is a no-op, safe to repeat
    WorkerNode.rollback_sync_ef(tw, 2)
    WorkerNode.rollback_sync_ef(tw, 7)
    assert tw.metrics.counter("slave.sync.ef.rollback").value == 1
    np.testing.assert_array_equal(tw._compressor.residual_snapshot("sync:master"), restored)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(600, n_features=D, nnz=10, seed=11,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _models(data):
    _, _, ds = data
    return (jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu"))


def test_the_gradient_body_over_the_servicer_is_the_jax_workers(data):
    """One port and one JAX worker, top-k 5% + EF, get the same Gradient
    requests through their servicers (a window, its retry, the next window
    carrying a rollback of the one before, a hedge): the same reply bytes,
    the same residual, one rollback counted each."""
    train, _, _ = data
    jmodel, tmodel = _models(data)
    tw = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tmodel, seed=0,
                    metrics=mm.Metrics(), compress="topk", compress_k=K_FRAC)
    jw = JaxWorker("127.0.0.1", 0, "127.0.0.1", 1, train, jmodel, seed=0,
                   metrics=jmetrics.Metrics(), compress="topk", compress_k=K_FRAC)
    try:
        w = (np.random.default_rng(3).normal(size=D) * 0.1).astype(np.float32)
        ids = np.arange(0, 32, dtype=np.int32)

        def req(version, **kw):
            r = pb.GradientRequest(samples=ids, fit_token=9, step_version=version,
                                   weights=codec.encode_tensor(w), **kw)
            return r, jpb.GradientRequest.FromString(r.SerializeToString())

        for version, kw in ((1, {}), (1, {}), (2, {"ef_rollback_version": 1}),
                            (3, {"hedge": True})):
            t_req, j_req = req(version, **kw)
            got = _WorkerServicer(tw)._gradient_update(t_req)
            want = JaxServicer(jw)._gradient_update(j_req)
            assert got.WhichOneof("grad") == ("compressed" if version < 3 else want.WhichOneof(
                "grad"))
            np.testing.assert_allclose(codec.decode_grad(got), jcodec.decode_grad(want),
                                       atol=ATOL)
            np.testing.assert_allclose(tw._compressor.residual_snapshot("sync:master"),
                                       jw._compressor.residual_snapshot("sync:master"),
                                       atol=ATOL)
        assert tw.metrics.counter("slave.sync.ef.rollback").value == 1
        assert jw.metrics.counter("slave.sync.ef.rollback").value == 1
        assert tw.metrics.counter("slave.sync.hedge").value == 1
    finally:
        for node in (tw, jw):
            node._stopped.set()
            node.server.stop(grace=0)
            node._master_channel.close()


def test_worker_lifecycle_clears_stale_residuals(data):
    """remove_peer drops the departed peer's residual; a new StartAsync
    resets every residual and the retry guard, as the JAX worker does."""
    train, _, _ = data
    tmodel = _models(data)[1]
    w = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tmodel,
                   metrics=mm.Metrics(), compress="topk", compress_k=2)
    try:
        rng = np.random.default_rng(0)
        peer = ("peer", ("10.0.0.9", 4001))
        w._compressor.compress(_vec(rng, D), dest=peer)
        w._compressor.compress(_vec(rng, D), dest="sync:master")
        w._sync_ef_guard = (b"w", None)
        w.remove_peer("10.0.0.9", 4001)
        assert peer not in w._compressor._residuals
        assert "sync:master" in w._compressor._residuals
        w.start_async(np.zeros(D, np.float32), np.arange(32), batch_size=4,
                      learning_rate=0.1)
        w.stop_async()
        assert "sync:master" not in w._compressor._residuals
        assert w._sync_ef_guard == (None, None)
    finally:
        w.stop()


# -- the engines -------------------------------------------------------------------


class _Coordinator:
    """The engine's side of one worker: takes `n` messages, then stops it."""

    def __init__(self, n):
        self.n, self.got, self.worker = n, [], None

    def _update_grad(self, delta, n_steps=1):
        self.got.append((np.array(delta, np.float32), n_steps))
        if len(self.got) >= self.n:
            self.worker.stop_async()


@pytest.mark.parametrize("kind", ["topk", "qint8"])
def test_one_hogwild_worker_gossips_the_jax_workers_messages(data, kind):
    """A worker of each engine, one dispatch after another from the same
    ids (the JAX worker's draws injected into the port's): the coordinator
    receives the same decoded deltas, and the worker's own weights keep
    the full ones."""
    train, _, _ = data
    jmodel, tmodel = _models(data)
    k_steps, n, seed = 4, 12, 3
    shard = train.slice(slice(0, 240))

    def compressor(pkg):
        if pkg == "jax":
            return jcompress.make_compressor(kind, k=K_FRAC, seed=seed, metrics=jmetrics.Metrics())
        return make_compressor(kind, k=K_FRAC, seed=seed, metrics=mm.Metrics(), device="cpu")

    jw = jhog._Worker(0, jmodel, shard, jax.devices()[0], B, LR, seed, jmetrics.Metrics(),
                      steps_per_dispatch=k_steps, compressor=compressor("jax"))
    key = jax.random.PRNGKey(seed + 1000)
    draws = []
    for _ in range(n):
        key, kk = jax.random.split(key)
        draws.append(np.stack([np.asarray(jax.random.randint(s, (B,), 0, len(shard)))
                               for s in jax.random.split(kk, k_steps)])[:, None, :])
    sd = ShardedData(torch.from_numpy(shard.indices), torch.from_numpy(shard.values),
                     torch.from_numpy(shard.labels).float(), n_true=len(shard))
    tw = thog._Worker(0, tmodel, sd, B, LR, seed, mm.Metrics(), steps_per_dispatch=k_steps,
                      compressor=compressor("torch"))
    it = iter(draws)
    tw._sample_ids = lambda: torch.from_numpy(next(it).astype(np.int64))
    coords = []
    for w in (jw, tw):
        c = _Coordinator(n)
        c.worker = w
        w.connect([w], c)
        w.start_async(np.zeros(D, np.float32))
        w._thread.join(timeout=60)
        assert not w._thread.is_alive(), "the worker did not stop after its messages"
        coords.append(c)
    (jgot, tgot) = (c.got for c in coords)
    assert len(jgot) == len(tgot) == n
    for (jd, jk), (td, tk) in zip(jgot, tgot):
        assert jk == tk == k_steps
        np.testing.assert_allclose(td, jd, atol=ATOL)
    if kind == "topk":
        assert all(np.count_nonzero(td) <= resolve_k(K_FRAC, D) for td, _ in tgot)
    # the worker's own weights took the full deltas: they are not the sum
    # of what the coordinator received, but within the residual of it
    full = np.asarray(jw.w)
    np.testing.assert_allclose(tw.w.numpy(), full, atol=ATOL)
    shipped = -sum(td for td, _ in tgot)
    np.testing.assert_allclose(shipped + tw._compressor.residual_snapshot("master") * -1,
                               full, atol=1e-4)


_jax_fits = {}


def _jax_fit(data, **kw):
    """The all-JAX cluster's sync fit with `kw` (3 workers, seed 0), cached."""
    key = tuple(sorted(kw.items()))
    if key not in _jax_fits:
        train, test, _ = data
        with JaxCluster(_models(data)[0], train, test, n_workers=WORKERS, seed=0, **kw) as c:
            _jax_fits[key] = c.master.fit_sync(EPOCHS, B, LR)
    return _jax_fits[key]


def _assert_close_fit(got, want):
    assert got.epochs_run == want.epochs_run
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=ATOL)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=ATOL)


TOPK = dict(compress="topk", compress_k=K_FRAC)


def test_a_port_cluster_with_topk_lands_on_the_jax_clusters_fit(data):
    train, test, _ = data
    want = _jax_fit(data, **TOPK)
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                    metrics=m, **TOPK) as c:
        got = c.master.fit_sync(EPOCHS, B, LR)
    _assert_close_fit(got, want)
    # the fit is not the uncompressed one, and its replies are top-k's
    assert np.abs(np.asarray(got.weights) - np.asarray(_jax_fit(data).weights)).max() > 1e-3
    assert m.counter(mm.COMMS_BYTES_ON_WIRE).value < m.counter(mm.COMMS_BYTES_DENSE).value / 4
    assert m.histogram(mm.COMMS_RESIDUAL_NORM).count > 0


@pytest.mark.parametrize("jax_master", [True, False], ids=["jax_master", "port_master"])
def test_mixed_clusters_with_topk_land_on_the_all_jax_fit(data, jax_master):
    """A JAX master over port workers with top-k + EF, and a port master
    over JAX workers: each within 1e-5 of the all-JAX cluster, no worker
    evicted."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    if jax_master:
        master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                           seed=0).start()
        workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                              seed=i, metrics=mm.Metrics(), **TOPK) for i in range(WORKERS)]
    else:
        master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                            expected_workers=WORKERS, seed=0, metrics=mm.Metrics()).start()
        workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel, seed=i,
                             **TOPK) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0)
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert members == {(w.host, w.port) for w in workers}, "a worker was evicted"
    _assert_close_fit(got, _jax_fit(data, **TOPK))


def test_a_mixed_async_qint8_gossip_cluster_trains(data):
    """A port master over a port and a JAX worker, qint8 on every gossip
    edge: the async fit trains and the master takes compressed bytes."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    m = mm.Metrics()
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=2, seed=0, metrics=m).start()
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                          seed=0, steps_per_dispatch=8, metrics=mm.Metrics(),
                          compress="qint8"),
               JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel, seed=1,
                         steps_per_dispatch=8, compress="qint8")]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        loss0, _ = master.local_loss(np.zeros(D, np.float32), test=True)
        res = master.fit_async(3, B, 0.1, check_every=100, backoff_s=0.02)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert float(res.state.loss) < 0.7 * loss0, (res.state.loss, loss0)
    assert m.counter("master.async.grad.bytes").value > 0
    assert workers[0].metrics.counter(mm.COMMS_BYTES_ON_WIRE).value > 0
    assert workers[0].metrics.histogram(mm.COMMS_RESIDUAL_NORM).count > 0


# -- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {"DSGD_ENGINE": "rpc", "DSGD_COMPRESS": "topk", "DSGD_COMPRESS_K": "0.05"},
    {"DSGD_ENGINE": "rpc", "DSGD_COMPRESS": "qint8", "DSGD_ASYNC": "1"},
    {"DSGD_ASYNC": "1", "DSGD_COMPRESS": "topk", "DSGD_COMPRESS_EF": "0"},
], ids=["rpc-sync-topk", "rpc-async-qint8", "hogwild-topk-no-ef"])
def test_the_compression_knobs_act_through_main(env, monkeypatch):
    made = []
    from distributed_sgd_tpu_torch.compress import codecs

    for cls in (codecs.TopKCompressor, codecs.QInt8Compressor):
        init = cls.__init__

        def spy(self, *a, _init=init, **kw):
            made.append((type(self).__name__, kw.get("error_feedback")))
            _init(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", spy)
    for k, v in {"DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1", "DSGD_NODE_COUNT": "2",
                 "DSGD_CHECK_EVERY": "100", **env}.items():
        monkeypatch.setenv(k, v)
    assert tmain.main(device="cpu").fit is not None
    want = "TopKCompressor" if env["DSGD_COMPRESS"] == "topk" else "QInt8Compressor"
    assert [name for name, _ in made] == [want] * 2  # one a worker
    assert {ef for _, ef in made} == {env.get("DSGD_COMPRESS_EF") != "0"}


@pytest.mark.parametrize("env", [{}, {"DSGD_ASYNC": "1", "DSGD_ASYNC_MODE": "local_sgd"}],
                         ids=["sync", "local_sgd"])
def test_compress_on_a_mesh_engine_warns_in_the_jax_words(env, monkeypatch, caplog):
    for k, v in {"DSGD_SYNTHETIC": "300", "DSGD_MAX_EPOCHS": "1", "DSGD_NODE_COUNT": "1",
                 "DSGD_COMPRESS": "topk", **env}.items():
        monkeypatch.setenv(k, v)
    said = {}
    for pkg, run in (("jax", lambda: jmain.main()), ("port", lambda: tmain.main(device="cpu"))):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="dsgd.main"):
            run()
        said[pkg] = [r.getMessage() for r in caplog.records
                     if r.name == "dsgd.main" and "DSGD_COMPRESS" in r.getMessage()]
    assert said["port"] == said["jax"] == [
        "DSGD_COMPRESS=topk ignored: in-mesh engines have no wire path "
        "(use engine=rpc or async_mode=gossip)"]
