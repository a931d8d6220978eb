"""Master node: cluster membership, the readiness barrier, the sync fit.

The port of the plain sync parts of the JAX package's MasterNode
(distributed_sgd_tpu/core/master.py, after the reference's
core/Master.scala and core/MasterSync.scala):

- membership: registration with the join cap and full-mesh peer
  introduction (Master.scala:222-243), unregistration with its broadcast
  (Master.scala:245-253), the readiness barrier that gates all work
  (Master.scala:34-59);
- evaluation: `predict` over the workers' Forward fan-out,
  `distributed_loss`/`distributed_accuracy` (Master.scala:61-101), and
  `local_loss` on the master's own device (parallel/sync.py
  ``BoundSync.evaluate``);
- `fit_sync`: per window, each worker's sample ids drawn from its
  partition with a generator keyed by (seed, epoch), one Gradient request
  per worker carrying the full weights, a full barrier with deadlines,
  the replies summed IN SEND ORDER and divided by their count (so the
  result bit-matches ``np.mean`` over the replies), and the update applied
  on the host: ``w - lr * g`` in numpy for sgd (Master.scala:197), the
  port's ``ops.sync_epoch.apply_update`` for momentum and adam.  Worker
  failures are retried (`grad_retries`), then the worker is unregistered
  and the window re-split over the survivors (``on_worker_death=
  "resplit"``) or the fit raises (``"fail"``).  Checkpoints save and
  resume through checkpoint.py's sync-fit snapshot, the JAX package's
  format.

- `fit_async` (MasterAsync.scala, with the JAX master's superset): each
  worker gets its split of the train rows in a StartAsync and gossips
  weight-space deltas; the master applies each delta (UpdateGrad) to its
  own weights on its device, counts local steps against the lifetime
  budget ``len(train) * max_epochs``, resumed from the checker's count,
  evaluates the smoothed test loss every `check_every` updates with the
  LossChecker and its checkpointer, and returns the BEST weights.  A stall
  watchdog probes the workers when no update arrives for the stall window,
  evicts the dead and re-issues their rows to survivors with the current
  weights; a worker that leaves mid-fit has its rows re-issued at once.
  With `batch_drain` the deltas go through a bounded inbox and one summed
  apply per drain.  Every worker that ever held rows gets StopAsync when
  the fit ends.

The workers compute on their own devices; the master only encodes,
decodes and applies, and evaluates on its device.  Every lever of the JAX
fits that is not ported raises NotImplementedError naming the ROADMAP
item that holds it (the heartbeat, fit_async's elastic membership).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.checkpoint import (
    opt_kind_tag,
    restore_sync_fit,
    save_sync_fit,
    save_sync_fit_final,
)
from distributed_sgd_tpu_torch.convert import opt_state_from_jax, opt_state_to_jax
from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.core.loss_check import LossChecker, async_fit_result
from distributed_sgd_tpu_torch.core.split import vanilla_split
from distributed_sgd_tpu_torch.core.trainer import FitResult, record_epoch
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.sync_epoch import apply_update, init_opt_state
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, resolve_optimizer
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import (
    RpcPolicy,
    WorkerStub,
    add_master_servicer,
    new_channel,
    new_server,
)
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.log import node_logger

SplitFn = Callable[[int, int], List[np.ndarray]]

# the host-side phases of one fit_sync window, each a histogram of seconds
# (the JAX master records only the whole window, master.sync.batch.duration)
SYNC_FANOUT_SECONDS = "master.sync.fanout.seconds"    # draw, encode and send
SYNC_BARRIER_SECONDS = "master.sync.barrier.seconds"  # wait for the replies
SYNC_DECODE_SECONDS = "master.sync.decode.seconds"    # sum and divide the replies
SYNC_APPLY_SECONDS = "master.sync.apply.seconds"      # the update


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported to the torch master yet "
                               f"(ROADMAP.md Queue A {where})")


class _FailureTracker:
    """Consecutive-failure counter with an eviction threshold: a success
    resets a worker's count; `record_failure` returns True once the worker
    has failed `threshold` consecutive times."""

    def __init__(self, threshold: int):
        self.threshold = max(1, int(threshold))
        self._counts: Dict[Tuple[str, int], int] = {}

    def record_ok(self, key: Tuple[str, int]) -> None:
        self._counts.pop(key, None)

    def record_failure(self, key: Tuple[str, int]) -> Tuple[int, bool]:
        n = self._counts.get(key, 0) + 1
        if n >= self.threshold:
            self._counts.pop(key, None)
            return n, True
        self._counts[key] = n
        return n, False


def _await_futures(futs, bytes_counter=None):
    """Barrier with failure classification over [(key, future-or-None)].

    Returns (ok, failed): ok = [(key, reply)] in input order, failed =
    [(key, status-or-error)].  A None future stands for a channel that
    closed under us at call time.  `bytes_counter` accounts every reply
    that arrived, so a window later retried still counts its bytes."""
    ok, failed = [], []
    for key, fut in futs:
        try:
            if fut is None:
                raise ValueError("channel closed")
            reply = fut.result()
            if bytes_counter is not None:
                bytes_counter.increment(reply.ByteSize())
            ok.append((key, reply))
        except (grpc.RpcError, ValueError) as e:
            failed.append((key, e.code() if isinstance(e, grpc.RpcError) else e))
    return ok, failed


def _draw_ids(rng: np.random.Generator, part: np.ndarray, start: int,
              size: int) -> np.ndarray:
    """Uniform without-replacement draw of up to `size` sample ids from one
    worker's partition, clipped by the epoch cursor: the reference's slice
    [start : start + size] of a fresh permutation of the partition
    (Master.scala:184), drawn at O(size).  The JAX master draws the same
    ids from the same generator state."""
    take = min(int(size), max(0, len(part) - start))
    if take <= 0:
        return np.empty(0, dtype=np.int64)
    return np.asarray(part)[rng.choice(len(part), size=take, replace=False)]


class MasterNode:
    def __init__(
        self,
        host: str,
        port: int,
        train: Dataset,
        test: Dataset,
        model: LinearModel,
        expected_workers: int,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        rpc_policy: Optional[RpcPolicy] = None,
    ):
        """Evaluation and the optimizer run on the model's device."""
        self.host, self.port = host, port
        self.log = node_logger(host, port, master=True)
        self.metrics = metrics or metrics_mod.global_metrics()
        self.rpc_policy = rpc_policy or RpcPolicy(seed=seed, metrics=self.metrics)
        self.model = model
        self.device = model.device
        self.train = train
        self.test = test
        self.expected_workers = expected_workers
        self.seed = seed

        self._workers: Dict[Tuple[str, int], WorkerStub] = {}
        self._channels: Dict[Tuple[str, int], grpc.Channel] = {}
        self._order: List[Tuple[str, int]] = []  # registration order
        self._members_lock = threading.Lock()
        self.cluster_ready = threading.Event()  # Master.scala:34-35

        # master-local eval (Master.localLoss/localAccuracy) on this device
        engine = SyncEngine(model, batch_size=1, learning_rate=0.0, device=self.device)
        self._eval_train = engine.bind(train)
        self._eval_test = engine.bind(test)

        # the async fit's state (MasterAsync.scala:28-40): the weights on
        # this device, the update count, and the batch-drain inbox
        self._async_lock = threading.Lock()
        self._w_async: Optional[torch.Tensor] = None
        self._updates = 0
        self._max_steps = 0
        self._async_running = threading.Event()
        self._async_done = threading.Event()
        self._inbox_cv = threading.Condition()
        self._inbox: list = []
        self._drain_on = False

        self.server = new_server(port, host="0.0.0.0")
        self.port = self.port or self.server.bound_port
        add_master_servicer(self.server, _MasterServicer(self), node="master")

    # -- lifecycle ---------------------------------------------------------

    def start(self, heartbeat_s: Optional[float] = None,
              heartbeat_max_misses: int = 3) -> "MasterNode":
        if heartbeat_s:
            raise not_ported(f"the heartbeat (DSGD_HEARTBEAT_S={heartbeat_s})",
                             "[A8] 3.3, elastic membership")
        self.server.start()
        self.log.info("master started on %s:%d, expecting %d workers",
                      self.host, self.port, self.expected_workers)
        return self

    def stop(self) -> None:
        self.server.stop(grace=1.0)
        with self._members_lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.close()
        self.log.info("master stopped")

    def await_ready(self, timeout: Optional[float] = None) -> bool:
        return self.cluster_ready.wait(timeout)

    def _require_ready(self) -> None:
        if not self.cluster_ready.is_set():  # withClusterReady barrier
            self.log.info("waiting for %d workers to join", self.expected_workers)
            self.cluster_ready.wait()

    # -- membership (Master.scala:222-253) ---------------------------------

    def register_worker(self, host: str, port: int) -> None:
        """At most `expected_workers` members at any instant (the
        reference `require`s the same cap, Master.scala:224); the cap is on
        current membership, so an unregistration frees a slot.  A new
        member is introduced to every other member and they to it."""
        key = (host, port)
        with self._members_lock:
            if key in self._workers:
                # a registration retry whose first reply was lost: no-op
                return
            if len(self._workers) >= self.expected_workers:
                raise ValueError("cluster already at expected node count")
            others = list(self._workers.keys())
            ch = new_channel(host, port, origin=(self.host, self.port))
            stub = WorkerStub(ch)
            self._workers[key] = stub
            self._channels[key] = ch
            self._order.append(key)
            count = len(self._workers)
        self.log.info("worker registered: %s:%d (%d/%d)",
                      host, port, count, self.expected_workers)
        # full-mesh introduction, both directions (Master.scala:229-233)
        new_node = pb.Node(host=host, port=port)
        for oh, op in others:
            try:
                self.rpc_policy.call_with_retry(
                    self._workers[(oh, op)].RegisterSlave, new_node,
                    peer=(oh, op), retries=1)
                self.rpc_policy.call_with_retry(
                    stub.RegisterSlave, pb.Node(host=oh, port=op), peer=key, retries=1)
            except (grpc.RpcError, KeyError) as e:
                self.log.warning("peer introduction failed for %s:%d (%s)", oh, op,
                                 e.code() if isinstance(e, grpc.RpcError) else "left")
        if count >= self.expected_workers:
            self.cluster_ready.set()  # Master.scala:235-241

    def unregister_worker(self, host: str, port: int, evicted: bool = False) -> None:
        """`evicted=True` marks an involuntary removal (Gradient or Forward
        failures past the threshold): it is counted and dumps the flight
        recorder; a graceful leave does not."""
        key = (host, port)
        if evicted:
            self.metrics.counter(metrics_mod.MASTER_EVICTIONS).increment()
            flight.record("worker.evicted", worker=f"{host}:{port}")
            flight.dump("eviction")
        with self._members_lock:
            self._workers.pop(key, None)
            ch = self._channels.pop(key, None)
            if key in self._order:
                self._order.remove(key)
            remaining = list(self._workers.values())
        if ch is not None:
            ch.close()
        node = pb.Node(host=host, port=port)
        for stub in remaining:  # broadcast (Master.scala:245-253)
            try:
                stub.UnregisterSlave(node, timeout=self.rpc_policy.deadline_s)
            except (grpc.RpcError, ValueError):
                pass  # ValueError: that member's channel closed under us
        self.log.info("worker unregistered: %s:%d", host, port)

    def _members(self) -> List[Tuple[Tuple[str, int], WorkerStub]]:
        with self._members_lock:
            return [(k, self._workers[k]) for k in self._order]

    @property
    def members(self) -> List[Tuple[str, int]]:
        return [k for k, _ in self._members()]

    # -- distributed eval (Master.scala:61-98) -----------------------------

    def predict(self, weights: np.ndarray, split: SplitFn = vanilla_split,
                timeout_s: float = 60.0, retries: int = 1,
                return_margins: bool = False, quorum: Optional[int] = None,
                straggler_soft_s: Optional[float] = None):
        """Fan ForwardRequests out to every worker over the train split;
        gather predictions (and with `return_margins` the margins).  A
        worker that fails `retries + 1` times in a row is unregistered and
        the fan-out re-split over the survivors; RuntimeError when every
        worker is lost."""
        if quorum is not None or straggler_soft_s is not None:
            raise not_ported("predict with a quorum barrier (DSGD_QUORUM)", "[A8] 3.3")
        self._require_ready()
        wmsg = codec.encode_tensor(weights)
        tracker = _FailureTracker(retries + 1)
        while True:
            members = self._members()
            if not members:
                raise RuntimeError("all workers lost during predict")
            parts = split(len(self.train), len(members))
            part_by_key = {key: ids for (key, _), ids in zip(members, parts)}
            # one trace per eval fan-out attempt
            with trace_mod.root_span(trace_mod.SPAN_EVAL_FORWARD, node="master",
                                     workers=len(members)):
                futs = []
                for (key, stub), ids in zip(members, parts):
                    try:
                        fut = stub.Forward.future(
                            pb.ForwardRequest(samples=ids.astype(np.int32), weights=wmsg,
                                              want_margins=return_margins),
                            timeout=timeout_s)
                    except ValueError:
                        fut = None
                    futs.append((key, fut))
                ok, failed = _await_futures(futs)
            if not failed:
                out = np.zeros(len(self.train), dtype=np.float32)
                margins = np.zeros(len(self.train), dtype=np.float32)
                for key, reply in ok:
                    ids = part_by_key[key]
                    out[ids] = np.asarray(reply.predictions, dtype=np.float32)
                    if return_margins:
                        if len(reply.margins) != len(ids):
                            margins = None  # an older worker without margins
                        elif margins is not None:
                            margins[ids] = np.asarray(reply.margins, dtype=np.float32)
                return (out, margins) if return_margins else out
            for key, _ in ok:
                tracker.record_ok(key)
            for key, code in failed:
                n, evict = tracker.record_failure(key)
                if evict:
                    self.log.warning("worker %s:%d failed Forward %d times (%s); "
                                     "declaring dead", key[0], key[1], n, code)
                    self.unregister_worker(*key, evicted=True)
                else:
                    self.log.warning("worker %s:%d failed Forward (%s); retry %d/%d",
                                     key[0], key[1], code, n, retries)

    def distributed_loss(self, weights: np.ndarray) -> float:
        """Objective from the Forward fan-out (Master.scala:77-98), from
        the workers' margins: exact for every model.  A worker that replies
        without margins falls back to the reference's prediction-based
        loss."""
        preds, margins = self.predict(weights, return_margins=True)
        y = torch.as_tensor(np.asarray(self.train.labels), device=self.device)
        w = np.asarray(weights, dtype=np.float32)
        reg = self.model.lam * float(np.dot(w, w))
        if margins is not None:
            sample = self.model.losses_from_margins(
                torch.as_tensor(margins, device=self.device), y)
        else:
            self.log.warning("a worker replied without margins; reconstructing the "
                             "loss from predictions (Master.scala:77-98)")
            sample = self.model.sample_loss(torch.as_tensor(preds, device=self.device), y)
        return reg + float(sample.mean())

    def distributed_accuracy(self, weights: np.ndarray) -> float:
        preds = self.predict(weights)
        return float((preds == self.train.labels).mean())

    def local_loss(self, weights, test: bool = False) -> Tuple[float, float]:
        """(objective, accuracy) of `weights` (host array or tensor) over
        the train (or test) split, on the master's device."""
        bound = self._eval_test if test else self._eval_train
        if isinstance(weights, torch.Tensor):
            w = weights.to(self.device, torch.float32)
        else:
            w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=self.device)
        return bound.evaluate(w)

    # -- the sync fit (MasterSync.scala) -------------------------------------

    def fit_sync(
        self,
        max_epochs: int,
        batch_size: int,
        learning_rate: float,
        criterion: Optional[Criterion] = None,
        split: SplitFn = vanilla_split,
        initial_weights: Optional[np.ndarray] = None,
        grad_timeout_s: float = 30.0,
        on_worker_death: str = "resplit",
        grad_retries: int = 1,
        checkpointer=None,
        checkpoint_every: int = 1,
        optimizer=None,
        momentum: float = 0.9,
        local_steps: int = 1,
        delta_broadcast: bool = False,
        quorum: Optional[int] = None,
        straggler_soft_s: Optional[float] = None,
        hedge: bool = True,
        fit_state_path: Optional[str] = None,
        fit_state_every: int = 0,
        health=None,
        stream: bool = False,
        fanin_lanes: Optional[int] = None,
        stage_pool: Optional[int] = None,
        agg_tree: Optional[str] = None,
        master_shards: Optional[int] = None,
    ) -> FitResult:
        """Fault-tolerant sync fit over the registered workers.

        Every Gradient call carries a deadline (`grad_timeout_s`) and
        membership is re-read every window; a worker whose call fails
        `grad_retries + 1` consecutive times is declared dead:
        ``on_worker_death="resplit"`` unregisters it and retries the window
        across the survivors with a fresh split, ``"fail"`` raises without
        touching membership.  With a `checkpointer` the fit resumes from
        the latest snapshot and saves every `checkpoint_every` epochs.
        `optimizer` is None/'sgd', 'momentum' or 'adam'.

        The JAX fit_sync's other levers are not ported; a non-default value
        raises NotImplementedError (ROADMAP.md Queue A [A8] 3.3 and 3.4,
        [A13] item 8)."""
        levers = (
            (local_steps != 1, f"local_steps={local_steps}", "[A8] 3.4"),
            (delta_broadcast, "delta_broadcast", "[A8] 3.4"),
            (stream, "stream", "[A8] 3.4"),
            (bool(fanin_lanes), f"fanin_lanes={fanin_lanes}", "[A8] 3.4"),
            (bool(stage_pool), f"stage_pool={stage_pool}", "[A8] 3.4"),
            (quorum is not None, f"quorum={quorum}", "[A8] 3.3"),
            (straggler_soft_s is not None, f"straggler_soft_s={straggler_soft_s}",
             "[A8] 3.3"),
            (bool(fit_state_path) or bool(fit_state_every),
             "fit_state_path/fit_state_every (the crash-safe fit state)", "[A8] 3.3"),
            (health is not None, "health (the training-health monitor)",
             "[A13] item 8, telemetry/"),
            (bool(agg_tree), f"agg_tree={agg_tree!r}", "[A13] item 8, aggtree/"),
            (bool(master_shards), f"master_shards={master_shards}",
             "[A13] item 8, shardedps/"),
        )
        for bad, what, where in levers:
            if bad:
                raise not_ported(f"fit_sync({what})", where)
        if on_worker_death not in ("resplit", "fail"):
            raise ValueError(f"on_worker_death must be resplit|fail, got {on_worker_death!r}")
        opt = resolve_optimizer(optimizer, momentum)
        opt_kind = opt_kind_tag(optimizer)
        self._require_ready()
        members = self._members()
        keys = [k for k, _ in members]
        parts = split(len(self.train), len(members))
        max_samples = max(len(p) for p in parts)
        w = (np.zeros(self.model.n_features, dtype=np.float32) if initial_weights is None
             else np.asarray(initial_weights, dtype=np.float32))
        result = FitResult(state=GradState(weights=w))
        test_newest_first: List[float] = []
        tracker = _FailureTracker(grad_retries + 1)
        grad_acc = np.zeros(self.model.n_features, dtype=np.float32)
        m = self.metrics
        grad_bytes = m.counter(metrics_mod.SYNC_GRAD_BYTES)
        rounds = m.counter(metrics_mod.SYNC_ROUNDS)
        phase_s = {name: m.histogram(name) for name in (
            SYNC_FANOUT_SECONDS, SYNC_BARRIER_SECONDS, SYNC_DECODE_SECONDS,
            SYNC_APPLY_SECONDS)}
        opt_state = init_opt_state(opt, self.model.n_features, self.device)

        def leaves():
            return opt_state_to_jax(opt_state, opt.kind)

        start_epoch = 0
        restored = restore_sync_fit(checkpointer, opt_kind, leaves())
        if restored is not None:
            start_epoch, w_np, test_newest_first, opt_leaves = restored
            w = np.asarray(w_np, dtype=np.float32)
            if opt_leaves:
                opt_state = opt_state_from_jax(opt_leaves, opt.kind, self.model.n_features,
                                               self.device)
            self.log.info("resumed sync fit from checkpoint at epoch %d", start_epoch)
        if start_epoch >= max_epochs:
            loss, acc = self.local_loss(w)
            self.log.info("fit state already complete at epoch %d (max_epochs %d): "
                          "nothing to run (loss=%.6f acc=%.4f)",
                          start_epoch, max_epochs, loss, acc)
            result.epochs_run = start_epoch
            result.state = GradState(weights=w, loss=loss).finish()
            return result

        bcast_w: Optional[np.ndarray] = None  # the weights `bcast` encodes
        bcast: Optional[pb.Tensor] = None
        for epoch in range(start_epoch, max_epochs):
            t0 = time.perf_counter()
            batch = 0
            # keyed by absolute epoch: a resumed run draws the same stream
            rng = np.random.default_rng((self.seed, epoch))
            while batch < max_samples:
                # live membership: an unregistration reaches the loop here
                current = self._members()
                if [k for k, _ in current] != keys:
                    if not current:
                        raise RuntimeError("all workers lost mid-fit")
                    members, keys = current, [k for k, _ in current]
                    parts = split(len(self.train), len(members))
                    max_samples = max(len(p) for p in parts)
                    m.counter(metrics_mod.SYNC_RESPLITS).increment()
                    flight.record("sync.resplit", members=len(members))
                    self.log.warning("membership changed; re-split across %d workers",
                                     len(members))
                    if batch >= max_samples:
                        break
                t_batch = time.perf_counter()
                # one trace per fan-out window: the Gradient calls become
                # client/server child spans through rpc/service.py's hooks
                wspan = trace_mod.root_span(trace_mod.SPAN_SYNC_WINDOW, node="master",
                                            epoch=epoch, batch=int(batch), version=0)
                with wspan:
                    if bcast_w is not w:  # one encode per weight version
                        bcast, bcast_w = codec.encode_tensor(w), w
                    futs = []
                    for (key, stub), part in zip(members, parts):
                        ids = _draw_ids(rng, part, batch, batch_size)
                        req = pb.GradientRequest(samples=ids.astype(np.int32), weights=bcast)
                        metrics_mod.record_broadcast(m, "full", bcast.ByteSize())
                        try:
                            fut = stub.Gradient.future(req, timeout=grad_timeout_s)
                        except ValueError:  # channel closed under us
                            fut = None
                        futs.append((key, fut))
                    t_sent = time.perf_counter()
                    ok, failed = _await_futures(futs, bytes_counter=grad_bytes)
                    t_replies = time.perf_counter()
                    phase_s[SYNC_FANOUT_SECONDS].record(t_sent - t_batch)
                    phase_s[SYNC_BARRIER_SECONDS].record(t_replies - t_sent)
                    rounds.increment()
                    for key, _ in ok:
                        tracker.record_ok(key)
                    if failed:
                        for key, code in failed:
                            n, evict = tracker.record_failure(key)
                            if not evict:
                                self.log.warning(
                                    "worker %s:%d failed Gradient (%s); retry %d/%d",
                                    key[0], key[1], code, n, grad_retries)
                                continue
                            if on_worker_death == "fail":
                                raise RuntimeError(
                                    f"worker {key[0]}:{key[1]} died mid-fit "
                                    f"({n} consecutive Gradient failures: {code})")
                            self.log.warning(
                                "worker %s:%d failed Gradient %d times (%s); declaring dead",
                                key[0], key[1], n, code)
                            self.unregister_worker(*key, evicted=True)
                        wspan.set(retry=True)
                        continue  # retry this window (survivors or re-split)
                    # the replies summed in send order, then one true divide:
                    # bit-matching np.mean over the decoded replies
                    grad_acc.fill(0.0)
                    for _, reply in ok:
                        codec.decode_grad_into(reply, grad_acc)
                    grad_acc /= len(ok)
                    t_decoded = time.perf_counter()
                    if opt.kind == "sgd":
                        w = w - learning_rate * grad_acc  # Master.scala:197
                    else:
                        wt, opt_state = apply_update(
                            torch.from_numpy(w).to(self.device),
                            torch.from_numpy(grad_acc).to(self.device),
                            learning_rate, opt, opt_state)
                        w = wt.cpu().numpy()
                    t_applied = time.perf_counter()
                    phase_s[SYNC_DECODE_SECONDS].record(t_decoded - t_replies)
                    phase_s[SYNC_APPLY_SECONDS].record(t_applied - t_decoded)
                    m.histogram("master.sync.batch.duration").record(t_applied - t_batch)
                    batch += batch_size
            epoch_s = time.perf_counter() - t0

            loss, acc = self.local_loss(w)
            test_loss, test_acc = self.local_loss(w, test=True)
            record_epoch(result, test_newest_first, epoch, loss, acc, test_loss, test_acc,
                         epoch_s)
            m.histogram("master.sync.loss").record(loss)
            m.histogram("master.sync.acc").record(100 * acc)
            m.histogram("master.sync.epoch.seconds").record(epoch_s)
            self.log.info(
                "epoch %d: loss=%.6f acc=%.4f test_loss=%.6f test_acc=%.4f (%.2fs)",
                epoch, loss, acc, test_loss, test_acc, epoch_s)
            if checkpointer is not None and (epoch + 1) % checkpoint_every == 0:
                save_sync_fit(checkpointer, epoch + 1, w, test_newest_first, opt_kind,
                              leaves())
            if criterion is not None and criterion(test_newest_first):
                self.log.info("Converged to target: stopping computation")
                break

        save_sync_fit_final(checkpointer, result.epochs_run, start_epoch, checkpoint_every,
                            w, test_newest_first, opt_kind, leaves())
        result.state = GradState(
            weights=w, loss=result.losses[-1] if result.losses else float("nan")).finish()
        return result

    # -- the async fit (MasterAsync.scala) -----------------------------------

    def fit_async(
        self,
        max_epochs: int,
        batch_size: int,
        learning_rate: float,
        criterion: Optional[Criterion] = None,
        check_every: int = 100,
        leaky_loss: float = 0.9,
        backoff_s: float = 2.5,
        split: SplitFn = vanilla_split,
        initial_weights: Optional[np.ndarray] = None,
        checkpointer=None,
        optimizer: Optional[str] = None,
        momentum: float = 0.9,
        stall_checks: int = 4,
        max_stall_interventions: int = 3,
        stall_window_s: Optional[float] = None,
        startup_grace_s: Optional[float] = None,
        elastic: bool = False,
        batch_drain: bool = False,
    ) -> FitResult:
        """Async fit over the registered workers, with the JAX master's
        stall watchdog: when no update arrives for the stall window, every
        assigned worker is probed, the unresponsive are evicted and their
        rows re-issued to survivors (StartAsync with the current weights),
        so the lifetime budget completes on the survivors; with nobody left,
        or after `max_stall_interventions` interventions without progress,
        the fit raises RuntimeError.  `stall_window_s` defaults to
        max(stall_checks * backoff_s, 60) and the window before the first
        update to `startup_grace_s`, max(stall window, 180).

        `optimizer` is a name ('sgd', 'momentum', 'adam'): it crosses the
        wire in StartAsyncRequest.  `batch_drain` (DSGD_ASYNC_DRAIN) buffers
        the deltas in an inbox of at most ASYNC_INBOX_CAP and applies one
        sum per drain; a full inbox falls back to the per-message apply,
        counted.  `elastic` (DSGD_ELASTIC) is not ported: it raises.

        Returns the BEST weights (MasterAsync.scala:87-94) as a host array."""
        if elastic:
            raise not_ported("fit_async(elastic=True) (elastic membership, DSGD_ELASTIC)",
                             "[A8] 3.3")
        if optimizer is not None and not isinstance(optimizer, str):
            raise ValueError(
                "the RPC topology ships the optimizer by NAME in StartAsyncRequest; pass "
                "'sgd'/'momentum'/'adam' (an optimizer object cannot cross the wire)")
        # an unknown name fails here, before any worker starts
        resolve_optimizer(optimizer, momentum)
        self._require_ready()
        if self._async_running.is_set():
            raise RuntimeError("a computation is already running")  # MasterAsync.scala:42
        members = self._members()
        parts = split(len(self.train), len(members))
        # each worker's rows, kept for the watchdog's re-issue
        assignments = {key: part for (key, _), part in zip(members, parts)}
        w0 = (np.zeros(self.model.n_features, dtype=np.float32) if initial_weights is None
              else np.asarray(initial_weights, dtype=np.float32))
        # the checker restores any snapshot with its lifetime update count:
        # maxSteps is a LIFETIME budget (MasterAsync.scala:83), so a resumed
        # fit spends only the rest
        checker = LossChecker(leaky_loss, criterion, checkpointer=checkpointer,
                              device=self.device)
        t_start = time.time()
        with self._async_lock:
            self._w_async = torch.as_tensor(w0).to(self.device)
            self._updates = checker.restored_updates
            self._max_steps = len(self.train) * max_epochs  # MasterAsync.scala:83
        if self._updates >= self._max_steps:
            self.log.info("resumed past the %d-step budget (%d updates done): nothing to run",
                          self._max_steps, self._updates)
            return self._async_result(checker, w0, t_start, batch_size)
        self._async_done.clear()
        self._async_running.set()

        last_step = self._updates - check_every  # the first check runs at once
        if stall_window_s is None:
            stall_window_s = max(max(1, stall_checks) * backoff_s, 60.0)
        if startup_grace_s is None:
            startup_grace_s = max(stall_window_s, 180.0)
        start_updates = last_progress = self._updates
        last_progress_t = time.monotonic()
        interventions = 0
        # every endpoint that ever held rows gets StopAsync at the end, even
        # if evicted: a falsely evicted but live worker must stop training
        ever_assigned = set(assignments)
        drain_thread = None
        if batch_drain:
            with self._inbox_cv:
                self._inbox.clear()  # never apply a prior fit's stragglers
                self._drain_on = True
            drain_thread = threading.Thread(target=self._drain_loop, daemon=True,
                                            name="async-drain")
            drain_thread.start()
        try:
            # the fan-out inside the try: a worker dying mid-fan-out still
            # reaches the finally, which stops the ones started
            for key, part in assignments.items():  # MasterAsync.scala:52-55
                self._start_async_worker(key, part, w0, batch_size, learning_rate,
                                         optimizer, momentum)
            self.log.info("waiting for slaves updates")
            while self._async_running.is_set():
                with self._async_lock:
                    updates, w_now = self._updates, self._w_async
                window = startup_grace_s if updates == start_updates else stall_window_s
                # a worker that left mid-fit has its rows re-issued at once
                with self._members_lock:
                    member_keys = set(self._order)
                gone = [k for k in assignments if k not in member_keys]
                if gone:
                    self.log.warning("async fit: %d assigned worker(s) no longer members; "
                                     "reassigning", len(gone))
                    self._reassign_async(assignments, gone, w_now, batch_size,
                                         learning_rate, optimizer, momentum)
                if updates > last_progress:
                    last_progress, last_progress_t = updates, time.monotonic()
                    interventions = 0
                elif time.monotonic() - last_progress_t > window:
                    interventions += 1
                    if interventions > max_stall_interventions:
                        raise RuntimeError(
                            f"async fit stalled: no update progress after "
                            f"{interventions - 1} watchdog interventions "
                            f"(budget {updates}/{self._max_steps})")
                    self._async_watchdog(assignments, w_now, batch_size, learning_rate,
                                         optimizer, momentum)
                    last_progress_t = time.monotonic()
                if updates - last_step < check_every:
                    self._async_done.wait(backoff_s)
                    continue
                raw_loss, raw_acc = self.local_loss(w_now, test=True)
                stop = checker.check(raw_loss, raw_acc, w_now, step=updates)
                # the counter keeps the reference's toLong truncation
                # (MasterAsync.scala:126); the histogram the real value
                self.metrics.counter("master.async.loss").increment(int(checker.smoothed[0]))
                self.metrics.histogram("master.async.loss.value").record(checker.smoothed[0])
                self.log.info("loss computed at %d updates: test_loss=%.6f test_acc=%.4f",
                              updates, checker.smoothed[0], checker.smoothed_accs[0])
                last_step = updates
                if stop:
                    self.log.info("converged to target: stopping computation")
                    break
        finally:
            self._end_async_endpoints(ever_assigned)
            if drain_thread is not None:
                # the drain stops after StopAsync: gossip in flight lands in
                # the weights instead of staying in the inbox
                with self._inbox_cv:
                    self._drain_on = False
                    self._inbox_cv.notify()
                drain_thread.join(timeout=10.0)
        return self._async_result(checker, w0, t_start, batch_size)

    def _async_result(self, checker, w0, t_start: float, batch_size: int) -> FitResult:
        """The async fit's FitResult: the best weights, as a host array."""
        res = async_fit_result(checker, w0, t_start, self._updates, batch_size,
                               len(self.train))
        w = res.state.weights
        if isinstance(w, torch.Tensor):
            res.state = dataclasses.replace(res.state, weights=w.cpu().numpy())
        return res

    def _end_async_endpoints(self, endpoints) -> None:
        """StopAsync to every endpoint that ever held rows: members through
        their stubs, evicted ones through a short-lived channel (best
        effort: a dead process refuses the connection)."""
        self._async_running.clear()
        self._async_done.set()
        deadline = self.rpc_policy.deadline_s
        for key in endpoints:
            with self._members_lock:
                stub = self._workers.get(key)
            try:
                if stub is not None:
                    stub.StopAsync(pb.Empty(), timeout=deadline)
                else:
                    ch = new_channel(*key, origin=(self.host, self.port))
                    try:
                        WorkerStub(ch).StopAsync(pb.Empty(), timeout=deadline)
                    finally:
                        ch.close()
            except (grpc.RpcError, ValueError):
                pass

    def _start_async_worker(self, key, part, w, batch_size, learning_rate, optimizer,
                            momentum) -> None:
        with self._members_lock:
            stub = self._workers.get(key)
        if stub is None:
            raise RuntimeError(f"worker {key[0]}:{key[1]} vanished before StartAsync")
        # a generous deadline: a re-issued StartAsync first joins the
        # worker's running loop, which may finish a dispatch in flight
        stub.StartAsync(
            pb.StartAsyncRequest(
                weights=codec.encode_tensor(_host(w)),
                samples=np.asarray(part).astype(np.int32),
                batch_size=batch_size,
                learning_rate=learning_rate,
                optimizer=optimizer or "",
                momentum=momentum,
            ),
            timeout=60.0,
        )

    def _async_watchdog(self, assignments, w_now, batch_size, learning_rate, optimizer,
                        momentum) -> None:
        """No update for the stall window: probe every assigned worker,
        evict the unresponsive and re-issue their rows; with every worker
        answering, re-issue every assignment (their loops are gone).
        RuntimeError when nobody is left."""
        with self._members_lock:
            member_keys = set(self._workers)
        dead = [k for k in assignments if k not in member_keys]
        for key in assignments:
            if key in dead:
                continue
            with self._members_lock:
                stub = self._workers.get(key)
            try:
                if stub is None:
                    raise ValueError("channel closed")
                stub.Ping(pb.Empty(), timeout=self.rpc_policy.deadline_s)
            except (grpc.RpcError, ValueError) as e:
                code = e.code() if isinstance(e, grpc.RpcError) else e
                self.log.warning("async watchdog: worker %s:%d unresponsive (%s); "
                                 "declaring dead", key[0], key[1], code)
                self.unregister_worker(*key, evicted=True)
                dead.append(key)
        if not dead:
            if not assignments:
                raise RuntimeError("async fit: all workers lost mid-fit")
            self.log.warning("async watchdog: stalled with %d live workers; re-issuing all "
                             "StartAsync assignments", len(assignments))
            for key in list(assignments):
                self._try_start_async_worker(key, assignments[key], w_now, batch_size,
                                             learning_rate, optimizer, momentum)
            return
        self._reassign_async(assignments, dead, w_now, batch_size, learning_rate, optimizer,
                             momentum)

    def _reassign_async(self, assignments, dead, w_now, batch_size, learning_rate,
                        optimizer, momentum) -> None:
        """Merge each dead worker's rows into a survivor's and re-issue
        StartAsync there with the current weights.  RuntimeError when no
        survivor is left."""
        survivors = [k for k in assignments if k not in dead]
        if not survivors:
            raise RuntimeError("async fit: all workers lost mid-fit")
        targets = []
        for i, key in enumerate(dead):
            target = survivors[i % len(survivors)]
            part = assignments.pop(key)
            assignments[target] = np.concatenate([assignments[target], part])
            if target not in targets:
                targets.append(target)
            self.log.warning("async fit: re-issuing %d samples of dead worker %s:%d to "
                             "%s:%d", len(part), key[0], key[1], *target)
        for target in targets:
            self._try_start_async_worker(target, assignments[target], w_now, batch_size,
                                         learning_rate, optimizer, momentum)

    def _try_start_async_worker(self, key, part, w, batch_size, learning_rate, optimizer,
                                momentum) -> None:
        """A re-issue whose target died since its probe evicts it instead of
        ending the fit: the next tick reassigns its rows."""
        try:
            self._start_async_worker(key, part, w, batch_size, learning_rate, optimizer,
                                     momentum)
        except (grpc.RpcError, RuntimeError) as e:
            code = e.code() if isinstance(e, grpc.RpcError) else e
            self.log.warning("async fit: StartAsync re-issue to %s:%d failed (%s); evicting "
                             "(its samples reassign next tick)", key[0], key[1], code)
            self.unregister_worker(*key, evicted=True)

    # -- the batch-drain inbox (DSGD_ASYNC_DRAIN) ----------------------------

    # each entry is a dense [D] delta: past this many the per-message apply
    # takes over, so the inbox cannot grow without bound
    ASYNC_INBOX_CAP = 1024

    def _inbox_put(self, delta: np.ndarray, n_steps: int) -> bool:
        """Buffer a delta iff the drain is on and the inbox has room,
        checked under the inbox lock (so no delta lands after the drain
        ended).  False: the caller applies it itself; on a full inbox that
        is counted under ASYNC_DRAIN_FALLBACK."""
        with self._inbox_cv:
            if not self._drain_on or len(self._inbox) >= self.ASYNC_INBOX_CAP:
                if self._drain_on:
                    self.metrics.counter(metrics_mod.ASYNC_DRAIN_FALLBACK).increment()
                return False
            self._inbox.append((delta, n_steps))
            self.metrics.gauge(metrics_mod.HEALTH_DRAIN_BACKLOG).set(len(self._inbox))
            self._inbox_cv.notify()
            return True

    def _drain_loop(self) -> None:
        """Sum every buffered delta on the host and apply them at once
        (deltas commute); ends once the fit turned the drain off and the
        inbox is empty."""
        drains = self.metrics.counter(metrics_mod.ASYNC_DRAINS)
        sizes = self.metrics.histogram(metrics_mod.ASYNC_DRAIN_SIZE)
        while True:
            with self._inbox_cv:
                while not self._inbox and self._drain_on:
                    self._inbox_cv.wait(timeout=0.25)
                batch, self._inbox = self._inbox, []
                self.metrics.gauge(metrics_mod.HEALTH_DRAIN_BACKLOG).set(0)
                if not batch and not self._drain_on:
                    return
            if not batch:
                continue
            acc = np.array(batch[0][0], dtype=np.float32, copy=True)
            total = int(batch[0][1])
            for delta, n in batch[1:]:
                acc += delta
                total += int(n)
            self._update_grad(acc, n_steps=total)
            drains.increment()
            sizes.record(len(batch))

    def _update_grad(self, delta: np.ndarray, n_steps: int = 1) -> None:
        """One gossip message (MasterAsync.scala:164-177): w <- w - delta on
        this device; `n_steps` local steps counted against the budget."""
        d = torch.from_numpy(np.asarray(delta, dtype=np.float32)).to(self.device)
        with self._async_lock:
            if self._w_async is None:
                return
            self._w_async = self._w_async - d
            stride = max(1, int(n_steps))
            self._updates += stride
            updates = self._updates
        if updates % 1000 < stride:  # a crossing: strides of k
            self.log.info("%d updates received", updates)
        if updates >= self._max_steps and self._async_running.is_set():
            self.log.info("max number of steps reached: stopping computation")
            self._async_running.clear()
            self._async_done.set()  # wake the check loop


def _host(w) -> np.ndarray:
    """Weights as a host f32 array (from a tensor on any device)."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w, dtype=np.float32)


class _MasterServicer:
    """gRPC method bodies (AbstractMasterGrpc, Master.scala:220-253)."""

    def __init__(self, m: MasterNode):
        self.m = m

    def RegisterSlave(self, request, context):  # noqa: N802
        if request.devices > 1:
            context.abort(grpc.StatusCode.UNIMPLEMENTED,
                          "a multi-device worker host (DSGD_HOST_DEVICES > 1): not ported "
                          "to the torch master yet (ROADMAP.md Queue A [A10])")
        try:
            self.m.register_worker(request.host, request.port)
        except ValueError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return pb.Ack()

    def UnregisterSlave(self, request, context):  # noqa: N802
        self.m.unregister_worker(request.host, request.port)
        return pb.Ack()

    def UpdateGrad(self, request, context):  # noqa: N802
        # the gossip's bytes as received (the workers' sends are not counted)
        self.m.metrics.counter("master.async.grad.bytes").increment(request.ByteSize())
        delta = codec.decode_grad(request)
        n_steps = request.n_steps or 1
        # batch drain: decoded here, on the servicer's thread, and summed
        # by the drain thread; declined when the drain is off or full
        if not self.m._inbox_put(delta, n_steps):
            self.m._update_grad(delta, n_steps=n_steps)
        return pb.Ack()

    def Ping(self, request, context):  # noqa: N802
        # membership probe: a caller this master does not know gets NOT_FOUND
        if request.host:
            with self.m._members_lock:
                known = (request.host, request.port) in self.m._workers
            if not known:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"{request.host}:{request.port} is not a member")
        return pb.Ack()
