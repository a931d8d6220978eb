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

The workers compute on their own devices; the master only encodes,
decodes and applies, and evaluates on its device.  Every lever of the JAX
fit_sync that is not ported raises NotImplementedError naming the ROADMAP
item that holds it; so do `fit_async` and the heartbeat.
"""

from __future__ import annotations

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
        """(objective, accuracy) of `weights` over the train (or test)
        split, on the master's device."""
        bound = self._eval_test if test else self._eval_train
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

    def fit_async(self, *args, **kwargs):
        raise not_ported("fit_async (DSGD_ASYNC=1 on the rpc engine)", "[A8] 3.2")


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
        context.abort(grpc.StatusCode.UNIMPLEMENTED,
                      "the async RPC engine's delta gossip: not ported to the torch "
                      "master yet (ROADMAP.md Queue A [A8] 3.2)")

    def Ping(self, request, context):  # noqa: N802
        # membership probe: a caller this master does not know gets NOT_FOUND
        if request.host:
            with self.m._members_lock:
                known = (request.host, request.port) in self.m._workers
            if not known:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"{request.host}:{request.port} is not a member")
        return pb.Ack()
