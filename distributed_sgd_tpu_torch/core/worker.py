"""Worker node: a gRPC server over training rows resident on the card.

The port of the sync and async seams of the JAX package's WorkerNode
(distributed_sgd_tpu/core/worker.py, after the reference's
core/Slave.scala): registration with the master (retried with jittered
exponential backoff through `RpcPolicy`), the peer map the master's
full-mesh introduction fills, and the bodies a fit calls:

- ``Forward`` (per-sample predictions and margins, Slave.scala:129-140)
  and ``Gradient`` (the sum of backwards over the requested samples, then
  the regularizer, Slave.scala:142-157).  The gradient is
  ``ops.worker_grads`` at K=1 on the worker's device (models/linear.py
  ``grad_regularized``): the hand-written CUDA kernel on the card, its
  plain version on the CPU;
- the async mode (Slave.scala:79-111,159-195): ``StartAsync`` starts a
  loop thread over the assigned samples; each dispatch draws
  `steps_per_dispatch` (k) batches of ids from a generator on the device
  seeded ``seed + port`` (the JAX worker's ``PRNGKey(seed + port)``) and
  runs them as ONE ``sync_epoch`` launch in the optimizer's mean mode
  (``parallel.sync.MeanSteps``), from a snapshot of w; it applies the
  weight-space delta ``snapshot - w_k`` to its own w and gossips it,
  encoded with ``n_steps = k``, to the topology's peers and always to
  the master, each through a bounded fire-and-forget ``GossipSender``.
  ``UpdateGrad`` subtracts a peer's delta; ``StopAsync`` ends the loop.
  The optimizer's state is the worker's own, made anew at each
  StartAsync, and never gossiped.  All of the async loop's device work
  and every applied delta run on one CUDA stream of the node's own, so
  the nodes of a one-process cluster overlap on the card and no tensor
  crosses streams; deltas cross nodes through host memory.

The rows live on the worker's device for the life of the node; a request
carries sample ids, which gather their rows there.  The JAX worker pads
the ids to a power of two for its jit buckets; the port does not pad.

The quorum barrier's requests are served: a ``hedge`` (another worker's
slice) is the plain Gradient body on the ids it names, replied
uncompressed and counted ``slave.sync.hedge``; an ``ef_rollback_version``
is a no-op, since the port's worker has no compressor and so no
error-feedback residual.  Full weights stamped with ``step_version`` and
``fit_token`` install the worker's replica (``resolve_request_weights``).
With ``master_watch_s`` the worker watches the master after registering
(``Master.Ping`` with its own identity) and registers again when the
master forgets it or stops answering.

Every request this slice does not serve answers gRPC ``UNIMPLEMENTED``
with a message that names the ROADMAP item that holds it, never a wrong
reply: a Gradient with ``local_steps > 1``, a weight delta or a header-only
weight arm, ``shard_count`` or ``agg_*``; and the methods ``FitStream``,
``AggregateGrad`` and ``Metrics``.
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
from distributed_sgd_tpu_torch.parallel import topology as topo
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike
from distributed_sgd_tpu_torch.parallel.sync import MeanSteps, resolve_optimizer
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import (
    GossipSender,
    MasterStub,
    RpcPolicy,
    WorkerStub,
    add_worker_servicer,
    new_channel,
    new_server,
)
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.log import node_logger

# where each unserved request kind is ported (ROADMAP.md Queue A, [A8] is
# the RPC engine; its sub-slices 3.2-3.4, and item 8's modules)
NOT_PORTED = {
    "local_steps": "local_steps > 1 (the pipelined sync levers): ROADMAP.md Queue A [A8] 3.4",
    "delta": "a weight delta or a header-only weight arm (DSGD_DELTA_BROADCAST): "
             "ROADMAP.md Queue A [A8] 3.4",
    "shard_count": "a sharded-master leg (DSGD_MASTER_SHARDS, shardedps/): "
                   "ROADMAP.md Queue A [A13] item 8",
    "agg": "an aggregation-tree request (DSGD_AGG_TREE, aggtree/): "
           "ROADMAP.md Queue A [A13] item 8",
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
        steps_per_dispatch: int = 1,
        max_inflight_gossip: int = 64,
        gossip_topology: str = "all",
        master_watch_s: Optional[float] = None,
        master_watch_misses: int = 3,
    ):
        """`device` defaults to the model's, and must equal it: the
        regularizer's vector lives there.  `steps_per_dispatch` local steps
        run in each async dispatch and gossip as one delta;
        `gossip_topology` ('all' | 'ring' | 'random:k') picks each
        dispatch's peers; `max_inflight_gossip` bounds each sender.
        `master_watch_s` (None: register once, as the reference) pings the
        master at that period once registered; a NOT_FOUND, or
        `master_watch_misses` misses in a row, registers again."""
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
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self._topo_mode, self._topo_k = topo.parse_topology(gossip_topology)
        self._dispatch_no = 0
        self._master_watch_s = master_watch_s
        self._master_watch_misses = max(1, int(master_watch_misses))
        # the last full broadcast: (fit_token, step_version, weights)
        self._replica: Optional[Tuple[int, int, np.ndarray]] = None
        self.n_rows = len(data)
        self._idx = torch.as_tensor(np.ascontiguousarray(data.indices, np.int32),
                                    device=self.device)
        self._val = torch.as_tensor(np.ascontiguousarray(data.values, np.float32),
                                    device=self.device)
        self._y = torch.as_tensor(np.asarray(data.labels, np.float32), device=self.device)

        self._peers: Dict[Tuple[str, int], WorkerStub] = {}
        # bounded fire-and-forget gossip to each peer and to the master:
        # drop-oldest past max_inflight_gossip UpdateGrads in flight
        self._gossip: Dict[Tuple[str, int], GossipSender] = {}
        self._max_inflight_gossip = int(max_inflight_gossip)
        self._peers_lock = threading.Lock()
        # server first: port 0 resolves to the bound port here
        self.server = new_server(port, host="0.0.0.0")
        self.port = self.port or self.server.bound_port
        self._master_channel = new_channel(master_host, master_port, origin=(host, self.port))
        self._master = MasterStub(self._master_channel)
        self._master_gossip = GossipSender(
            self._master.UpdateGrad, self.metrics, self._max_inflight_gossip,
            breaker=self.rpc_policy.breaker((master_host, master_port)),
            deadline_s=self.rpc_policy.deadline_s)

        # the async mode (Slave.scala:23-34): w and the loop's work on one
        # stream of the node's own; ids from a generator on the device
        self._w_lock = threading.Lock()
        self._w: Optional[torch.Tensor] = None
        self._running_async = threading.Event()
        self._async_thread: Optional[threading.Thread] = None
        self._assignment: Optional[torch.Tensor] = None
        self._async_bs = 0
        self._steps: Optional[MeanSteps] = None
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._gen = torch.Generator(device=self.device)
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
        reference's fixed retry period, Slave.scala:56): the jitter spreads
        a fleet's retries after a master restart.  With the master watch on,
        the registered worker then pings the master with its own identity:
        a NOT_FOUND (a master that does not know it: a fast restart, or an
        eviction it missed) registers again at once, and
        `master_watch_misses` misses in a row (a slow restart, a partition)
        register again through the backoff."""
        node = pb.Node(host=self.host, port=self.port)
        while not self._stopped.is_set():
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
            if self._master_watch_s is None or self._stopped.is_set():
                return
            misses = 0
            while not self._stopped.wait(self._master_watch_s):
                try:
                    self._master.Ping(node, timeout=self.rpc_policy.deadline_s)
                    misses = 0
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.NOT_FOUND:
                        self.log.warning("master no longer knows us (restart or eviction); "
                                         "re-registering")
                        flight.record("master.forgot", worker=self.node_label)
                        self._registered.clear()
                        break
                    misses += 1
                    if misses >= self._master_watch_misses:
                        self.log.warning("master unreachable for %d probes (%s); "
                                         "re-registering", misses, e.code())
                        flight.record("master.lost", worker=self.node_label, misses=misses)
                        self._registered.clear()
                        break
            if self._registered.is_set():
                return  # stopped while the watch was healthy

    def stop(self) -> None:
        self._stopped.set()
        self._running_async.clear()
        if self._async_thread is not None:
            self._async_thread.join()
        self._profile.close()
        if self._registered.is_set():
            try:
                self._master.UnregisterSlave(pb.Node(host=self.host, port=self.port),
                                             timeout=2.0)
            except grpc.RpcError:
                pass
        with self._peers_lock:
            senders, self._gossip = list(self._gossip.values()), {}
        for sender in senders:
            sender.close()
        self._master_gossip.close()
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
                # a (re)introduction is evidence of liveness: a breaker the
                # peer's previous incarnation tripped closes again
                breaker = self.rpc_policy.breaker(key)
                breaker.record_ok()
                self._gossip[key] = GossipSender(
                    stub.UpdateGrad, self.metrics, self._max_inflight_gossip,
                    breaker=breaker, deadline_s=self.rpc_policy.deadline_s)
                self.log.info("peer added: %s:%d", host, port)

    def remove_peer(self, host: str, port: int) -> None:
        with self._peers_lock:
            stub = self._peers.pop((host, port), None)
            sender = self._gossip.pop((host, port), None)
        if sender is not None:
            sender.close()
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

    def resolve_request_weights(self, request) -> np.ndarray:
        """The weights of a sync Gradient request that carries them in
        full: installed as the worker's replica under the request's
        (fit_token, step_version), as the JAX worker's install arm does.
        A plain request has both 0.  The delta and header-only arms are
        Queue A [A8] 3.4 and answer UNIMPLEMENTED before this."""
        w = codec.decode_tensor(request.weights)
        self._replica = (request.fit_token, request.step_version, w)
        return w

    def rollback_sync_ef(self, version: int) -> None:
        """The quorum's contribution mask (GradientRequest.
        ef_rollback_version): the master discarded this worker's reply for
        broadcast `version`.  A worker with a compressor restores the
        residual drained for that window; the port's worker replies
        uncompressed and keeps no residual, so there is nothing to undo."""
        del version

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


    # -- the async mode (Slave.scala:79-111,159-195) -------------------------

    def start_async(self, w0: np.ndarray, assignment: np.ndarray, batch_size: int,
                    learning_rate: float, optimizer: str = "", momentum: float = 0.9) -> None:
        """StartAsync: the loop over `assignment` (row ids of this worker)
        from the weights `w0`.  A repeated StartAsync (the master's
        re-issue after an eviction) replaces a running loop, joined first
        so two loops never share the state.  The optimizer is resolved by
        name here, so an unknown name fails the call, not the loop."""
        if self._async_thread is not None and self._async_thread.is_alive():
            self.log.info("StartAsync re-issued: replacing the running async loop")
            self._running_async.clear()
            self._async_thread.join()
        opt = self._prepare_async(w0, assignment, batch_size, learning_rate, optimizer,
                                  momentum)
        self._running_async.set()
        self._async_thread = threading.Thread(target=self._async_loop, daemon=True,
                                              name=f"async-{self.port}")
        self._async_thread.start()
        self.log.info("async started: %d samples, bs=%d lr=%g optimizer=%s",
                      len(assignment), batch_size, learning_rate, opt.kind)

    def _prepare_async(self, w0, assignment, batch_size, learning_rate, optimizer,
                       momentum):
        """StartAsync's state: the replica, the rows, the steps and the
        generator; returns the resolved optimizer."""
        assignment = np.asarray(assignment, dtype=np.int64)
        if len(assignment) == 0:
            raise ValueError("StartAsync with no samples")
        if assignment.min() < 0 or assignment.max() >= self.n_rows:
            raise ValueError(f"StartAsync samples outside this worker's {self.n_rows} rows")
        # momentum passes through as given: an explicit 0.0 is honoured
        opt = resolve_optimizer(optimizer or None, float(momentum))
        with torch.cuda.stream(self._stream):
            with self._w_lock:
                self._w = torch.as_tensor(np.asarray(w0, dtype=np.float32)).to(self.device)
            self._assignment = torch.from_numpy(assignment).to(self.device)
            self._steps = MeanSteps(self.model, self._idx, self._val, self._y,
                                    float(learning_rate), opt)
        self._async_bs = int(batch_size)
        self._gen.manual_seed(self.seed + self.port)  # the JAX worker's PRNGKey(seed + port)
        return opt

    def stop_async(self) -> None:
        """StopAsync: the loop ends after its dispatch in flight, which is
        waited for (unless the loop itself asks)."""
        self._running_async.clear()
        t = self._async_thread
        if t is not None and t is not threading.current_thread():
            t.join()

    def apply_delta(self, delta: np.ndarray) -> None:
        """A peer's or the master's UpdateGrad: w <- w - delta
        (Slave.scala:177-185), on the node's stream."""
        with torch.cuda.stream(self._stream), self._w_lock:
            if self._w is not None:
                self._w = self._w - torch.from_numpy(np.asarray(delta, np.float32)).to(
                    self.device)
        self.metrics.counter("slave.async.grad.update").increment()

    def _draw_ids(self, k: int) -> torch.Tensor:
        """One dispatch's row ids, int64[k, 1, B]: uniform positions in
        the assignment, with replacement, from the node's generator."""
        pos = torch.randint(0, len(self._assignment), (k, 1, self._async_bs),
                            generator=self._gen, device=self.device)
        return self._assignment[pos]

    def _async_loop(self) -> None:
        # a daemon thread's exception would end training silently (the
        # master's stall watchdog notices much later): leave evidence first
        try:
            self._async_loop_impl()
        except Exception as e:  # noqa: BLE001 - record, dump, then surface
            flight.record("async.loop.crash", worker=self.node_label, error=repr(e))
            flight.dump("exception")
            self.log.exception("async loop crashed")
            raise

    def _async_loop_impl(self) -> None:
        k = self.steps_per_dispatch
        with torch.cuda.stream(self._stream):  # this thread's launches go on the node's stream
            state = self._steps.init_state()
            while self._running_async.is_set():
                self._profile.tick()
                delta_np, state = self._dispatch(state)
                with measure.span("slave.async.gossip", metrics=self.metrics,
                                  node=self.node_label, k=k):
                    self._gossip_dispatch(delta_np, k)

    def _dispatch(self, state):
        """One dispatch on the current stream: k local steps from a
        snapshot of w (one mean-mode launch), the delta ``snapshot - w_k``
        applied to w.  Returns (the delta on the host, the optimizer's
        next state)."""
        k = self.steps_per_dispatch
        with self._w_lock:
            snapshot = self._w  # the stale read is the algorithm
        w_k, state = self._steps.run(snapshot, self._draw_ids(k), state)
        delta = snapshot - w_k
        with self._w_lock:
            self._w = self._w - delta
        self.metrics.counter("slave.async.batch").increment(k)
        return delta.cpu().numpy(), state  # the wire is the host's

    def _select_gossip(self):
        """This dispatch's peer senders under the topology: 'all' in the
        senders' insertion order, as the JAX worker; ring and random:k
        from parallel/topology.py, past peers whose breaker refuses."""
        with self._peers_lock:
            senders = dict(self._gossip)
        if self._topo_mode == "all":
            return list(senders.items())

        def suppressed(key):
            s = senders.get(key)
            return s is not None and s.breaker is not None and s.breaker.suppressed()

        keys, reselects = topo.select_gossip_peers(
            self._topo_mode, self._topo_k, list(senders), (self.host, self.port),
            self._dispatch_no, seed=self.seed, suppressed=suppressed)
        if reselects:
            self.metrics.counter(metrics_mod.TOPOLOGY_RESELECT).increment(reselects)
            flight.record("topology.reselect", worker=self.node_label, edges=reselects)
        return [(key, senders[key]) for key in keys]

    def _gossip_dispatch(self, delta_np: np.ndarray, k: int) -> None:
        """One dispatch's delta to the selected peers and to the master,
        which always receives it: it counts the budget."""
        self._dispatch_no += 1
        msg = codec.encode_grad(delta_np)
        msg.n_steps = k
        for _key, sender in self._select_gossip():
            sender.send(msg)  # fire-and-forget (Slave.scala:103-105)
        self._master_gossip.send(msg)


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
        is smaller, as the JAX worker replies).  A hedge (another worker's
        slice under the quorum barrier) runs the same body on the ids it
        names and is counted; an EF rollback is a no-op here."""
        if request.local_steps > 1:
            _not_ported(context, "local_steps")
        if request.shard_count:
            _not_ported(context, "shard_count")
        if request.agg_parent or request.agg_children:
            _not_ported(context, "agg")
        if not request.HasField("weights"):
            _not_ported(context, "delta")
        if request.ef_rollback_version:
            self.w.rollback_sync_ef(request.ef_rollback_version)
        w = self.w.resolve_request_weights(request)
        ids = np.fromiter(request.samples, dtype=np.int64)
        with measure.span("slave.grad.compute", metrics=self.w.metrics, root=False,
                          samples=len(ids), local_steps=1):
            g = self.w.compute_gradient(w, ids)
        if request.hedge:
            self.w.metrics.counter("slave.sync.hedge").increment()
        with measure.span("slave.grad.encode", metrics=self.w.metrics, root=False):
            return codec.encode_grad(g)

    def StartAsync(self, request, context):  # noqa: N802
        self.w.start_async(
            codec.decode_tensor(request.weights),
            np.fromiter(request.samples, dtype=np.int64),
            request.batch_size,
            request.learning_rate,
            optimizer=request.optimizer,
            momentum=request.momentum,
        )
        return pb.Ack()

    def StopAsync(self, request, context):  # noqa: N802
        self.w.stop_async()
        return pb.Ack()

    def UpdateGrad(self, request, context):  # noqa: N802
        self.w.apply_delta(codec.decode_grad(request))
        return pb.Ack()

    def Metrics(self, request, context):  # noqa: N802
        _not_ported(context, "Metrics")

    def AggregateGrad(self, request, context):  # noqa: N802
        _not_ported(context, "AggregateGrad")

    def FitStream(self, request_iterator, context):  # noqa: N802
        _not_ported(context, "FitStream")
