"""Worker node: a gRPC server over training rows resident on the card.

The port of the sync seams of the JAX package's WorkerNode
(distributed_sgd_tpu/core/worker.py, after the reference's
core/Slave.scala): registration with the master (retried with jittered
exponential backoff through `RpcPolicy`), the peer map the master's
full-mesh introduction fills, and the two bodies a sync fit calls —
``Forward`` (per-sample predictions and margins, Slave.scala:129-140) and
``Gradient`` (the sum of backwards over the requested samples, then the
regularizer, Slave.scala:142-157).  The gradient is ``ops.worker_grads``
at K=1 on the worker's device (models/linear.py ``grad_regularized``):
the hand-written CUDA kernel on the card, its plain version on the CPU.

The rows live on the worker's device for the life of the node; a request
carries sample ids, which gather their rows there.  The JAX worker pads
the ids to a power of two for its jit buckets; the port does not pad.

Every request this slice does not serve answers gRPC ``UNIMPLEMENTED``
with a message that names the ROADMAP item that holds it, never a wrong
reply: a Gradient with ``local_steps > 1``, a weight delta or a header-only
weight arm, ``hedge``, ``ef_rollback_version``, ``shard_count`` or
``agg_*``; and the methods ``StartAsync``, ``StopAsync``, ``UpdateGrad``,
``FitStream``, ``AggregateGrad`` and ``Metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import (
    MasterStub,
    RpcPolicy,
    WorkerStub,
    add_worker_servicer,
    new_channel,
    new_server,
)
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.log import node_logger

# where each unserved request kind is ported (ROADMAP.md Queue A, [A8] is
# the RPC engine; its sub-slices 3.2-3.4, and item 8's modules)
NOT_PORTED = {
    "local_steps": "local_steps > 1 (the pipelined sync levers): ROADMAP.md Queue A [A8] 3.4",
    "delta": "a weight delta or a header-only weight arm (DSGD_DELTA_BROADCAST): "
             "ROADMAP.md Queue A [A8] 3.4",
    "hedge": "a hedged request (DSGD_QUORUM): ROADMAP.md Queue A [A8] 3.3",
    "ef_rollback_version": "an error-feedback rollback (DSGD_QUORUM with "
                           "compression): ROADMAP.md Queue A [A8] 3.3",
    "shard_count": "a sharded-master leg (DSGD_MASTER_SHARDS, shardedps/): "
                   "ROADMAP.md Queue A [A13] item 8",
    "agg": "an aggregation-tree request (DSGD_AGG_TREE, aggtree/): "
           "ROADMAP.md Queue A [A13] item 8",
    "StartAsync": "the async RPC engine (fit_async): ROADMAP.md Queue A [A8] 3.2",
    "StopAsync": "the async RPC engine (fit_async): ROADMAP.md Queue A [A8] 3.2",
    "UpdateGrad": "the async RPC engine's delta gossip: ROADMAP.md Queue A [A8] 3.2",
    "FitStream": "the streaming fan-out (DSGD_STREAM): ROADMAP.md Queue A [A8] 3.4",
    "AggregateGrad": "the aggregation tree (DSGD_AGG_TREE, aggtree/): "
                     "ROADMAP.md Queue A [A13] item 8",
    "Metrics": "the cluster telemetry scrape (DSGD_TELEMETRY, telemetry/): "
               "ROADMAP.md Queue A [A13] item 8",
}


def _not_ported(context, what: str):
    context.abort(grpc.StatusCode.UNIMPLEMENTED,
                  f"not ported to the torch worker yet: {NOT_PORTED[what]}")


class WorkerNode:
    def __init__(
        self,
        host: str,
        port: int,
        master_host: str,
        master_port: int,
        data: Dataset,
        model: LinearModel,
        device: DeviceLike = None,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        rpc_policy: Optional[RpcPolicy] = None,
        profile_dir: Optional[str] = None,
        profile_steps: int = 16,
    ):
        """`device` defaults to the model's, and must equal it: the
        regularizer's vector lives there."""
        self.host, self.port = host, port
        self.log = node_logger(host, port, master=False)
        self.metrics = metrics or metrics_mod.global_metrics()
        self.rpc_policy = rpc_policy or RpcPolicy(seed=seed + port, metrics=self.metrics)
        self.model = model
        self.device = torch.device(device) if device is not None else model.device
        if self.device != model.device:
            raise ValueError(f"worker device {self.device} differs from the model's "
                             f"{model.device}")
        self.seed = seed
        self.n_rows = len(data)
        self._idx = torch.as_tensor(np.ascontiguousarray(data.indices, np.int32),
                                    device=self.device)
        self._val = torch.as_tensor(np.ascontiguousarray(data.values, np.float32),
                                    device=self.device)
        self._y = torch.as_tensor(np.asarray(data.labels, np.float32), device=self.device)

        self._peers: Dict[Tuple[str, int], WorkerStub] = {}
        self._peers_lock = threading.Lock()
        # server first: port 0 resolves to the bound port here
        self.server = new_server(port, host="0.0.0.0")
        self.port = self.port or self.server.bound_port
        self._master_channel = new_channel(master_host, master_port, origin=(host, self.port))
        self._master = MasterStub(self._master_channel)
        # DSGD_PROFILE_DIR on the worker role: torch.profiler over the
        # first `profile_steps` Gradient/Forward bodies
        self._profile = measure.ProfileWindow(
            profile_dir, profile_steps, logger=self.log, name=f"worker-{self.port}",
            cuda=self.device.type == "cuda")
        add_worker_servicer(self.server, _WorkerServicer(self), node=self.node_label)
        self._registered = threading.Event()
        self._stopped = threading.Event()

    @property
    def node_label(self) -> str:
        """Stable identity for trace spans."""
        return f"{self.host}:{self.port}"

    # -- lifecycle (Slave.scala:40-77) -------------------------------------

    def start(self, wait_registered: bool = True) -> "WorkerNode":
        self.server.start()
        self.log.info("worker started on %s:%d", self.host, self.port)
        t = threading.Thread(target=self._register_loop, daemon=True, name="register")
        t.start()
        if wait_registered:
            self._registered.wait()
        return self

    def _register_loop(self) -> None:
        """Register with the master until it answers, retrying with the
        policy's jittered exponential backoff (2 s first delay, the
        reference's fixed retry period, Slave.scala:56)."""
        node = pb.Node(host=self.host, port=self.port)
        attempt = 0
        while not self._stopped.is_set() and not self._registered.is_set():
            try:
                self._master.RegisterSlave(node, timeout=self.rpc_policy.deadline_s)
                self._registered.set()
                self.log.info("registered with master")
            except grpc.RpcError as e:
                delay = self.rpc_policy.backoff_s(attempt)
                attempt += 1
                self.log.info("registration failed (%s); retry %d in %.1fs",
                              e.code(), attempt, delay)
                self._stopped.wait(delay)

    def stop(self) -> None:
        self._stopped.set()
        self._profile.close()
        if self._registered.is_set():
            try:
                self._master.UnregisterSlave(pb.Node(host=self.host, port=self.port),
                                             timeout=2.0)
            except grpc.RpcError:
                pass
        self.server.stop(grace=1.0)
        self._master_channel.close()
        with self._peers_lock:
            peers, self._peers = list(self._peers.values()), {}
        for stub in peers:
            stub.channel.close()
        self.log.info("worker stopped")

    def await_termination(self) -> None:
        self.server.wait_for_termination()

    # -- peer management (the master's full-mesh introduction) -------------

    def add_peer(self, host: str, port: int) -> None:
        key = (host, port)
        if key == (self.host, self.port):
            return
        with self._peers_lock:
            if key not in self._peers:
                ch = new_channel(host, port, origin=(self.host, self.port))
                stub = WorkerStub(ch)
                stub.channel = ch
                self._peers[key] = stub
                self.log.info("peer added: %s:%d", host, port)

    def remove_peer(self, host: str, port: int) -> None:
        with self._peers_lock:
            stub = self._peers.pop((host, port), None)
        if stub is not None:
            stub.channel.close()

    @property
    def peers(self):
        with self._peers_lock:
            return sorted(self._peers)

    # -- the bodies ----------------------------------------------------------

    def _rows(self, ids: np.ndarray):
        """(rows, labels) of the sample ids, gathered on the device."""
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise ValueError(f"sample ids outside this worker's {self.n_rows} rows")
        t = torch.from_numpy(ids).to(self.device)
        batch = SparseBatch(self._idx.index_select(0, t), self._val.index_select(0, t))
        return batch, self._y.index_select(0, t)

    def compute_gradient(self, w: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Sync Gradient body: the sum of backwards over `ids` plus the
        regularizer (Slave.scala:142-157), as f32[D] on the host."""
        self._profile.tick()
        batch, y = self._rows(ids)
        wt = torch.from_numpy(np.asarray(w, dtype=np.float32)).to(self.device)
        g = self.model.grad_regularized(wt, batch, y)
        self.metrics.counter("slave.sync.backward").increment()
        return g.cpu().numpy()

    def compute_forward(self, w: np.ndarray, ids: np.ndarray):
        """Forward body (Slave.scala:129-140) -> (predictions, margins).
        The margins ride along so that the master computes margin-based
        losses (logistic) exactly."""
        self._profile.tick()
        batch, _ = self._rows(ids)
        wt = torch.from_numpy(np.asarray(w, dtype=np.float32)).to(self.device)
        margins = self.model.margins(wt, batch)
        preds = self.model.predict(margins)
        self.metrics.counter("slave.sync.forward").increment()
        return preds.float().cpu().numpy(), margins.cpu().numpy()


class _WorkerServicer:
    """gRPC method bodies (SlaveImpl, Slave.scala:113-196)."""

    def __init__(self, w: WorkerNode):
        self.w = w

    def RegisterSlave(self, request, context):  # noqa: N802
        self.w.add_peer(request.host, request.port)
        return pb.Ack()

    def UnregisterSlave(self, request, context):  # noqa: N802
        self.w.remove_peer(request.host, request.port)
        return pb.Ack()

    def Ping(self, request, context):  # noqa: N802
        return pb.Ack()

    def Forward(self, request, context):  # noqa: N802
        w = codec.decode_tensor(request.weights)
        ids = np.fromiter(request.samples, dtype=np.int64)
        preds, margins = self.w.compute_forward(w, ids)
        if request.want_margins:
            return pb.ForwardReply(predictions=preds, margins=margins)
        return pb.ForwardReply(predictions=preds)

    def Gradient(self, request, context):  # noqa: N802
        """One sync-window Gradient body on the plain wire: full weights
        in, the regularized gradient sum out (dense or sparse, whichever
        is smaller, as the JAX worker replies)."""
        if request.local_steps > 1:
            _not_ported(context, "local_steps")
        if request.hedge:
            _not_ported(context, "hedge")
        if request.ef_rollback_version:
            _not_ported(context, "ef_rollback_version")
        if request.shard_count:
            _not_ported(context, "shard_count")
        if request.agg_parent or request.agg_children:
            _not_ported(context, "agg")
        if not request.HasField("weights"):
            _not_ported(context, "delta")
        w = codec.decode_tensor(request.weights)
        ids = np.fromiter(request.samples, dtype=np.int64)
        with measure.span("slave.grad.compute", metrics=self.w.metrics, root=False,
                          samples=len(ids), local_steps=1):
            g = self.w.compute_gradient(w, ids)
        with measure.span("slave.grad.encode", metrics=self.w.metrics, root=False):
            return codec.encode_grad(g)

    def StartAsync(self, request, context):  # noqa: N802
        _not_ported(context, "StartAsync")

    def StopAsync(self, request, context):  # noqa: N802
        _not_ported(context, "StopAsync")

    def UpdateGrad(self, request, context):  # noqa: N802
        _not_ported(context, "UpdateGrad")

    def Metrics(self, request, context):  # noqa: N802
        _not_ported(context, "Metrics")

    def AggregateGrad(self, request, context):  # noqa: N802
        _not_ported(context, "AggregateGrad")

    def FitStream(self, request_iterator, context):  # noqa: N802
        _not_ported(context, "FitStream")
