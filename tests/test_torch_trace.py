"""The port's observability planes (distributed_sgd_tpu_torch/trace,
utils/metrics.py, utils/measure.py) against the JAX package's, on the CPU.

The exporters give the JAX package's text for the same recorded values
(timestamps injected), a trace context crosses between the two packages
through the same gRPC metadata key, and the trace files of a mixed
cluster (a JAX master, torch workers) merge into one timeline whose
rounds carry one trace id on both sides.  The tracer and the flight
recorder are process globals of each package: in one process they are
two objects, one per package."""

import http.server
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu import trace as jtrace
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu_torch import trace as ttrace
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.trace import flight, merge
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _record(m):
    """The same values into a registry of either package."""
    m.tags.update({"role": "master", "node": "a b,c"})
    m.counter("master.sync.rounds").increment(7)
    m.counter(tmetrics.SYNC_GRAD_BYTES).increment(123456)
    m.gauge(tmetrics.PROC_RSS_BYTES).set(1.5e9)
    m.gauge("never.set")
    rng = np.random.default_rng(0)
    for v in rng.lognormal(size=700):  # past the reservoir's 512 slots
        m.histogram("master.sync.batch.duration").record(v)
    m.histogram("span.slave.grad.compute").record(0.25)
    m.histogram("empty.hist")
    return m


def test_prometheus_and_influx_text_equal_the_jax_exporters():
    port, jax_side = _record(tmetrics.Metrics()), _record(jmetrics.Metrics())
    assert port.prometheus_text() == jax_side.prometheus_text()
    assert port.influx_lines(ts_ns=1234567890) == jax_side.influx_lines(ts_ns=1234567890)
    assert tmetrics.Histogram.BUCKET_BOUNDS == jmetrics.Histogram.BUCKET_BOUNDS
    for name in ("SYNC_ROUNDS", "SYNC_GRAD_BYTES", "SYNC_BCAST_BYTES", "SYNC_BCAST_FULL",
                 "SYNC_RESPLITS", "MASTER_EVICTIONS", "COMMS_BYTES_ON_WIRE"):
        assert getattr(tmetrics, name) == getattr(jmetrics, name)


def test_record_helpers_and_process_gauges_match_the_jax_package():
    port, jax_side = tmetrics.Metrics(), jmetrics.Metrics()
    for mod, m in ((tmetrics, port), (jmetrics, jax_side)):
        mod.record_broadcast(m, "full", 4000)
        mod.record_wire(m, 100, 400)
    assert port.prometheus_text() == jax_side.prometheus_text()
    rss, fds = tmetrics.sample_process_gauges(port)
    assert rss > 0 and fds > 0
    assert port.gauge(tmetrics.PROC_RSS_BYTES).value == rss


def test_prometheus_exporter_serves_metrics_and_404s_the_rest():
    m = _record(tmetrics.Metrics())
    ex = tmetrics.PrometheusExporter(m, 0, host="127.0.0.1").start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert body == m.prometheus_text() and "master_sync_rounds_total" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/", timeout=10)
        assert e.value.code == 404
    finally:
        ex.stop()


def test_influx_pusher_posts_the_line_protocol_and_counts_failures():
    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            got.append(self.rfile.read(int(self.headers["Content-Length"])).decode())
            self.send_response(204)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    m = tmetrics.Metrics()
    m.counter("slave.sync.backward").increment(3)
    try:
        pusher = tmetrics.InfluxPusher(m, f"http://127.0.0.1:{srv.server_address[1]}/write")
        assert pusher.push_once()
        assert got and got[0].startswith("slave.sync.backward value=3i ")
    finally:
        srv.shutdown()
        srv.server_close()
    dead = tmetrics.InfluxPusher(m, f"http://127.0.0.1:{srv.server_address[1]}/write",
                                 timeout_s=1.0)
    assert not dead.push_once()
    assert m.counter("metrics.push.errors").value == 1


@pytest.fixture
def tracers(tmp_path):
    t = ttrace.configure(enabled=True, dir=str(tmp_path), service="port")
    j = jtrace.configure(enabled=True, dir=str(tmp_path), service="jax")
    try:
        yield t, j
    finally:
        ttrace.configure(enabled=False)
        jtrace.configure(enabled=False)


def test_inject_and_extract_cross_the_two_packages(tracers):
    t, j = tracers
    assert ttrace.METADATA_KEY == jtrace.METADATA_KEY
    assert ttrace.SPAN_SYNC_WINDOW == jtrace.SPAN_SYNC_WINDOW
    with j.root_span("sync.window", node="master") as root:
        ctx = ttrace.extract(jtrace.inject(root.ctx))
        assert ctx == jtrace.extract(jtrace.inject(root.ctx))
        child = t.child_span("Gradient", ctx, node="w0")
        child.end()
    back = jtrace.extract(ttrace.inject(child.ctx))
    assert back.trace_id == root.ctx.trace_id
    assert ttrace.extract([("dsgd-trace", "no-separator-here-")]) is None
    assert t is not j  # one tracer per package in one process


def test_measure_span_is_a_trace_span_when_tracing_is_on(tracers):
    t, _ = tracers
    m = tmetrics.Metrics()
    with measure.span("sync.window", metrics=m) as outer:
        with measure.span("slave.grad.compute", metrics=m, root=False, samples=4) as inner:
            assert inner.ctx.trace_id == outer.ctx.trace_id
    with measure.span("slave.grad.compute", metrics=m, root=False) as orphan:
        assert orphan is ttrace.NOOP_SPAN  # no orphan roots outside a trace
    names = [e["name"] for e in t.events() if e["ph"] == "X"]
    assert names.count("slave.grad.compute") == 1 and "sync.window" in names
    assert m.histogram("span.slave.grad.compute").count == 2
    ttrace.configure(enabled=False)
    with measure.span("sync.window", metrics=m) as off:
        assert off is ttrace.NOOP_SPAN


def test_a_mixed_cluster_trace_merges_into_one_trace_per_round(tracers, tmp_path):
    """A JAX master (JAX tracer) fans rounds out to torch workers (port
    tracer): the merge of both files puts each master sync.window and the
    workers' Gradient server spans under one trace id."""
    train, test = train_test_split(rcv1_like(600, n_features=200, nnz=8, seed=4,
                                             idf_values=True))
    ds = dim_sparsity(train)
    master = JaxMaster("127.0.0.1", 0, train, test,
                       jax_make_model("hinge", 1e-4, 200, dim_sparsity=jnp.asarray(ds)),
                       expected_workers=2).start()
    tds = TDataset(train.indices, train.values, train.labels, train.n_features)
    tmodel = make_model("hinge", 1e-4, 200, dim_sparsity=ds, device="cpu")
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, tds, tmodel)
               for _ in range(2)]
    try:
        for w in workers:
            w.start()
        master.await_ready(30)
        master.fit_sync(1, 60, 0.5)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert jtrace.flush() and ttrace.flush()
    assert merge.main([str(tmp_path), "-o", str(tmp_path / "merged.json")]) == 0
    events = json.load(open(tmp_path / "merged.json"))["traceEvents"]
    windows = {e["args"]["trace_id"] for e in events if e.get("name") == "sync.window"}
    grads = {e["args"]["trace_id"] for e in events
             if e.get("name") == "Gradient" and e.get("ph") == "X"}
    computes = {e["args"]["trace_id"] for e in events if e.get("name") == "slave.grad.compute"}
    assert windows and grads == windows and computes == windows


def test_flight_ring_is_bounded_and_dumps(tmp_path):
    rec = flight.FlightRecorder(capacity=5, service="t", dir=str(tmp_path))
    for i in range(12):
        rec.record("evt", i=i)
    assert rec.ring_len() == 5 and [e["i"] for e in rec.snapshot()] == list(range(7, 12))
    path = rec.dump("test")
    payload = json.load(open(path))
    assert payload["reason"] == "test" and len(payload["events"]) == 5
    assert "resources" in payload
    assert flight.FlightRecorder(capacity=0, dir=str(tmp_path)).dump("off") is None


def test_the_worker_profile_window_writes_a_trace(tmp_path):
    train, test = train_test_split(rcv1_like(300, n_features=100, nnz=6, seed=1))
    tds = TDataset(train.indices, train.values, train.labels, train.n_features)
    model = make_model("hinge", 1e-4, 100, device="cpu")
    w = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, tds, model,
                   profile_dir=str(tmp_path), profile_steps=2)
    try:
        for _ in range(3):
            w.compute_gradient(np.zeros(100, np.float32), np.arange(10))
    finally:
        w.server.stop(None)
        w._master_channel.close()
    assert w._profile.stopped and os.path.exists(w._profile.path)
    with open(w._profile.path) as f:
        assert json.load(f)["traceEvents"]
