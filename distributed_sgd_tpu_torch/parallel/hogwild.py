"""Asynchronous Hogwild SGD with delta gossip, on one CUDA card.

The port of the JAX package's parallel/hogwild.py (after the reference's
async mode, Slave.scala:79-111 and MasterAsync.scala:32-177).  The
asynchrony lives on the host, as in the JAX engine:

- worker i owns a weights replica and a contiguous shard of the train
  split (the vanilla split).  The split is put on the card once; each
  worker reads a row view of it;
- each worker runs on its own host thread and its own CUDA stream, so the
  workers' launches overlap on the card.  Each dispatch drains the inbox
  (the queued peer deltas, summed on the host and applied at once), takes
  a snapshot of w, runs `steps_per_dispatch` (k) local steps from it,
  applies the summed delta ``snapshot - w_k`` and gossips it to the
  topology's peers and always to the coordinator.  The k local steps are
  one ``sync_epoch`` launch in the mean mode (``MeanSteps``): each step
  draws B ids uniformly from the shard, with replacement, and applies the
  optimizer's update of ``regularize(mean of backwards)`` (Slave.scala:93-99;
  a MEAN here, where the sync mode sums; 'sgd' is ``w - lr*g``);
- with a stateful optimizer (momentum, adam) each worker's state is its
  own: made with zeros at StartAsync, carried from dispatch to dispatch,
  and never gossiped, as in the JAX engine;
- every weight mutation is a delta subtraction, so a step from a stale
  snapshot composes with the deltas that arrive meanwhile; the gossiped
  delta stays in weight space (``snapshot - w_k``) whatever the optimizer;
- a delta crosses to its peers and the coordinator through host memory
  (``delta.cpu()``, the JAX engine's wire hop): each receiver uploads it
  on its own stream, so no tensor is shared between streams.  Inboxes are
  bounded and drop the oldest delta when full, counted in metrics;
- the coordinator applies every delta to its own copy of w on a stream of
  its own, counts updates against ``n_samples * max_epochs``
  (MasterAsync.scala:83), and its loss checker evaluates the smoothed test
  loss every `check_every` updates with `backoff_s` between polls, keeps
  the best weights, and stops on the smoothed history.  The fit returns
  the BEST weights, not the last (MasterAsync.scala:87-94);
- a watchdog restarts dead worker threads with the current weights, up to
  `max_restarts` times each, and raises when the fit stalls for good.

Not ported yet: the compressed gossip (``compress``); it raises.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.loss_check import LossChecker, async_fit_result
from distributed_sgd_tpu_torch.core.split import vanilla_split
from distributed_sgd_tpu_torch.core.trainer import FitResult
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops.sync_epoch import Optimizer
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.parallel.sync import (
    MeanSteps,
    ShardedData,
    SyncEngine,
    resolve_optimizer,
)
from distributed_sgd_tpu_torch.parallel.topology import parse_topology, select_gossip_peers
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.hogwild")


def _stream_for(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A stream of its own on a CUDA device; None (no stream) on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class _Worker:
    """One async worker: a row view of the train split, a weights replica,
    an inbox, a thread and a stream."""

    def __init__(
        self,
        wid: int,
        model: LinearModel,
        shard: ShardedData,
        batch_size: int,
        learning_rate: float,
        seed: int,
        metrics: metrics_mod.Metrics,
        max_inbox: int = 1024,
        steps_per_dispatch: int = 1,
        gossip_topology: str = "all",
        optimizer: Optional[Optimizer] = None,
    ):
        """`shard` holds this worker's rows on the device, unpadded;
        `optimizer` shapes its local steps (sgd when None)."""
        self.wid = wid
        self.metrics = metrics
        self._topo_mode, self._topo_k = parse_topology(gossip_topology)
        self._topo_seed = seed
        self._dispatch_no = 0
        self.k = max(1, int(steps_per_dispatch))
        self.batch_size = int(batch_size)
        self.inbox: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=max_inbox)
        self._lock = threading.Lock()
        self._push_lock = threading.Lock()
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.device = shard.indices.device
        self._stream = _stream_for(self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1000 * (wid + 1))
        self.shard_n = shard.n_true
        self._steps = MeanSteps(model, shard.indices, shard.values, shard.labels,
                                learning_rate, optimizer)
        self.w: Optional[torch.Tensor] = None
        with torch.cuda.stream(self._stream):
            self._opt_state = self._steps.init_state()  # made anew at each StartAsync
        self._peers: List["_Worker"] = []
        self._master: Optional["HogwildEngine"] = None

    # -- wiring ------------------------------------------------------------
    def connect(self, peers: List["_Worker"], master: "HogwildEngine") -> None:
        self._peers = [p for p in peers if p.wid != self.wid]
        self._master = master

    # -- the Slave service's surface (proto.proto:37-49) -------------------
    def push_delta(self, delta: np.ndarray) -> None:
        """A peer's updateGrad (Slave.scala:177-185): into the inbox.  Under
        overload the oldest delta is dropped, and counted, not silent.
        Pushers hold `_push_lock`, so between the drop and the put no other
        peer can fill the freed slot; the owner only takes from the inbox."""
        with self._push_lock:
            try:
                self.inbox.put_nowait(delta)
                return
            except queue.Full:
                pass
            try:
                self.inbox.get_nowait()
                dropped = True
            except queue.Empty:  # the owner drained it meanwhile
                dropped = False
            self.inbox.put_nowait(delta)
        if dropped:
            self.metrics.counter("slave.async.grad.dropped").increment()

    def start_async(self, w0: np.ndarray) -> None:
        """StartAsync (Slave.scala:159-175): the replica from host weights
        and a fresh optimizer state, as the JAX worker's ``opt.init``."""
        with torch.cuda.stream(self._stream):
            self.w = torch.as_tensor(np.asarray(w0, dtype=np.float32)).to(self.device)
            self._opt_state = self._steps.init_state()
        self._running.set()
        self._thread = threading.Thread(target=self._loop, name=f"hogwild-{self.wid}",
                                        daemon=True)
        self._thread.start()

    def stop_async(self) -> None:
        """StopAsync (Slave.scala:187-195)."""
        self._running.clear()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    # -- the hot loop (Slave.asyncTask, Slave.scala:79-111) ----------------
    def _sample_ids(self) -> torch.Tensor:
        """This dispatch's ids, int64[k, 1, B], uniform over the shard with
        replacement, from the worker's own generator on the device."""
        return torch.randint(0, self.shard_n, (self.k, 1, self.batch_size),
                             generator=self._gen, device=self.device)

    def _step(self, snapshot: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The summed delta of the local steps ids[k, 1, B] from `snapshot`
        (the JAX worker's sum of ``-updates``); advances the optimizer state."""
        w, self._opt_state = self._steps.run(snapshot, ids, self._opt_state)
        return snapshot - w

    def _drain_inbox(self) -> None:
        # deltas commute (w <- w - d), so the queued ones sum on the host
        # and apply in one upload
        acc = None
        n = 0
        while True:
            try:
                d = self.inbox.get_nowait()
            except queue.Empty:
                break
            acc = d if acc is None else acc + d
            n += 1
        if acc is not None:
            d = torch.from_numpy(acc).to(self.device)
            with self._lock:
                self.w = self.w - d
            self.metrics.counter("slave.async.grad.update").increment(n)

    def _gossip_peers(self) -> List["_Worker"]:
        """This dispatch's destinations under the topology."""
        if self._topo_mode == "all" or not self._peers:
            return self._peers
        by_wid = {p.wid: p for p in self._peers}
        sel, _ = select_gossip_peers(
            self._topo_mode, self._topo_k, list(by_wid), self.wid,
            self._dispatch_no, seed=self._topo_seed)
        return [by_wid[w] for w in sel]

    def _loop(self) -> None:
        with torch.cuda.stream(self._stream):  # this thread's launches go on its stream
            while self._running.is_set():
                self._drain_inbox()
                snapshot = self.w  # the stale read is the algorithm (Hogwild)
                delta = self._step(snapshot, self._sample_ids())
                with self._lock:
                    self.w = self.w - delta
                self.metrics.counter("slave.async.batch").increment(self.k)
                delta_np = delta.cpu().numpy()  # the host hop is the wire
                self._dispatch_no += 1
                for peer in self._gossip_peers():
                    peer.push_delta(delta_np)
                if self._master is not None:
                    self._master._update_grad(delta_np, n_steps=self.k)


class HogwildEngine:
    """Coordinator: spawns the workers, counts updates, checks the smoothed
    test loss."""

    def __init__(
        self,
        model: LinearModel,
        n_workers: int,
        batch_size: int,
        learning_rate: float,
        check_every: int = 100,
        leaky_loss: float = 0.9,
        backoff_s: float = 2.5,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        steps_per_dispatch: int = 1,
        checkpointer=None,
        optimizer=None,
        momentum: float = 0.9,
        compress: str = "none",
        gossip_topology: str = "all",
        device: DeviceLike = None,
    ):
        """steps_per_dispatch=k: each worker runs k local steps in one
        launch and gossips their summed delta; k=1 is the reference's
        per-step gossip (Slave.scala:103-105).  `optimizer` ('sgd' |
        'momentum' | 'adam', `momentum` its decay) shapes each worker's
        local steps; its state stays with the worker.  gossip_topology:
        all | ring | random:k (parallel/topology.py); the coordinator
        receives every delta whatever the topology."""
        if not (0.0 <= leaky_loss <= 1.0):
            raise ValueError("leaking coefficient must be between 0 and 1")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.optimizer = resolve_optimizer(optimizer, momentum)
        if compress != "none":
            raise NotImplementedError(
                f"compress={compress!r} is not ported yet (ROADMAP.md Queue A 13: "
                f"compress/); use 'none'")
        if checkpointer is not None:
            raise NotImplementedError(
                "async checkpoints are not ported yet (ROADMAP.md Queue A: "
                "'async checkpoint resume')")
        parse_topology(gossip_topology)  # fail typos at construction
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.gossip_topology = gossip_topology
        self.model = model
        self.n_workers = int(n_workers)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.check_every = check_every
        self.leaky_loss = leaky_loss
        self.backoff_s = backoff_s
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.seed = seed
        self.metrics = metrics or metrics_mod.global_metrics()
        # the coordinator's weights and the checker's evaluations are ordered
        # on this one stream
        self._stream = _stream_for(self.device)
        self._lock = threading.Lock()
        self._updates = 0
        self._w_master: Optional[torch.Tensor] = None
        self._stop = threading.Event()
        self._max_steps = 0
        self._workers: List[_Worker] = []  # live during fit (watchdog + tests)

    # the master's updateGrad (MasterAsync.scala:164-177); one message
    # carries n_steps local steps, and maxSteps counts local steps
    def _update_grad(self, delta: np.ndarray, n_steps: int = 1) -> None:
        with torch.cuda.stream(self._stream):
            d = torch.from_numpy(delta).to(self.device)
            with self._lock:
                self._w_master = self._w_master - d
                self._updates += n_steps
                updates = self._updates
        if updates % 1000 < max(1, n_steps):  # crossing check: strides of k
            log.info("%d updates received", updates)
        if updates >= self._max_steps:
            self._stop.set()

    def _shards(self, train: Dataset) -> List[ShardedData]:
        """The vanilla split of `train`, put on the device once, as one row
        view per worker."""
        splits = vanilla_split(len(train), self.n_workers)
        if any(len(s) == 0 for s in splits):
            raise ValueError(
                f"{len(train)} train rows leave some of {self.n_workers} workers "
                f"without a shard")
        idx = torch.as_tensor(train.indices, dtype=torch.int32).to(self.device)
        val = torch.as_tensor(train.values, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(train.labels).float().to(self.device)
        views = [slice(int(s[0]), int(s[-1]) + 1) for s in splits]
        return [ShardedData(idx[v], val[v], y[v], n_true=len(s)) for v, s in zip(views, splits)]

    def fit(
        self,
        train: Dataset,
        test: Dataset,
        max_epochs: int,
        criterion: Optional[Criterion] = None,
        initial_weights: Optional[np.ndarray] = None,
        stall_timeout_s: float = 60.0,
        max_restarts: int = 2,
        startup_grace_s: Optional[float] = None,
    ) -> FitResult:
        """`stall_timeout_s` arms the watchdog: when no update arrives for
        that long, dead worker threads get their StartAsync re-issued with
        the current weights, up to `max_restarts` times each; a stall with
        nobody restartable and nobody alive raises RuntimeError.  Before
        the first update the window is `startup_grace_s` (default
        max(stall_timeout_s, 180))."""
        n = len(train)
        w0 = (np.zeros(self.model.n_features, dtype=np.float32) if initial_weights is None
              else np.asarray(initial_weights, dtype=np.float32))
        checker = LossChecker(self.leaky_loss, criterion)
        t_start = time.time()
        with torch.cuda.stream(self._stream):
            w_init = self._w_master = torch.as_tensor(w0).to(self.device)
        self._updates = 0
        self._max_steps = n * max_epochs  # MasterAsync.scala:83
        self._stop.clear()
        if self._max_steps <= 0:
            return async_fit_result(checker, w_init, t_start, 0, self.batch_size, n)

        workers = [
            _Worker(i, self.model, shard, self.batch_size, self.learning_rate, self.seed,
                    self.metrics, steps_per_dispatch=self.steps_per_dispatch,
                    gossip_topology=self.gossip_topology, optimizer=self.optimizer)
            for i, shard in enumerate(self._shards(train))
        ]
        for w in workers:
            w.connect(workers, self)
        self._workers = workers
        # the coordinator's test evaluation (the loss checker's localLoss)
        eval_bound = SyncEngine(self.model, self.batch_size, 0.0, device=self.device).bind(test)
        if self.device.type == "cuda":
            # the uploads above, on the default stream, are done before the
            # workers' and the coordinator's streams read them; the kernel
            # is built here, not by the first worker threads
            torch.cuda.synchronize(self.device)
            _build.load("sync_epoch" if workers[0]._steps.fused else "worker_grads")

        for w in workers:
            w.start_async(w0)

        last_step = self._updates - self.check_every  # the first check runs at once
        if startup_grace_s is None:
            startup_grace_s = max(stall_timeout_s, 180.0)
        restarts = {w.wid: 0 for w in workers}
        start_updates = self._updates
        last_progress = self._updates
        last_progress_t = time.monotonic()
        interventions = 0
        try:
            with torch.cuda.stream(self._stream):
                while not self._stop.is_set():
                    with self._lock:
                        updates = self._updates
                        w_now = self._w_master
                    window = startup_grace_s if updates == start_updates else stall_timeout_s
                    if updates > last_progress:
                        last_progress, last_progress_t = updates, time.monotonic()
                        interventions = 0
                    elif time.monotonic() - last_progress_t > window:
                        interventions += 1
                        dead = [w for w in workers
                                if w._thread is None or not w._thread.is_alive()]
                        alive = [w for w in workers if w not in dead]
                        restartable = [w for w in dead if restarts[w.wid] < max_restarts]
                        if not alive and not restartable:
                            raise RuntimeError(
                                f"hogwild fit stalled: no live workers and no restarts "
                                f"left (budget {updates}/{self._max_steps})")
                        if restartable:
                            for w in restartable:
                                restarts[w.wid] += 1
                                log.warning(
                                    "watchdog: worker %d dead; re-issuing StartAsync "
                                    "with current weights (restart %d/%d)",
                                    w.wid, restarts[w.wid], max_restarts)
                                w.start_async(w_now.cpu().numpy())
                            interventions = 0  # a restart earns a fresh window
                        elif interventions > 3:
                            # nothing restartable and still no progress
                            raise RuntimeError(
                                f"hogwild fit stalled after {interventions - 1} quiet "
                                f"windows ({len(alive)} live worker(s), {len(dead)} dead, "
                                f"budget {updates}/{self._max_steps})")
                        last_progress_t = time.monotonic()
                    if updates - last_step < self.check_every:
                        self._stop.wait(self.backoff_s)
                        continue
                    raw_loss, raw_acc = eval_bound.evaluate(w_now)
                    stop = checker.check(raw_loss, raw_acc, w_now)
                    # the reference's toLong truncation (MasterAsync.scala:126),
                    # and the real value beside it
                    self.metrics.counter("master.async.loss").increment(int(checker.smoothed[0]))
                    self.metrics.histogram("master.async.loss.value").record(checker.smoothed[0])
                    log.info("loss computed at %d updates: test_loss=%.6f test_acc=%.4f",
                             updates, checker.smoothed[0], checker.smoothed_accs[0])
                    last_step = updates
                    if stop:
                        log.info("converged to target: stopping computation")
                        self._stop.set()
        finally:
            for w in workers:
                w.stop_async()
            for w in workers:
                w.join()
            self._workers = []  # an engine kept after fit pins no replicas
            if self._stream is not None:
                self._stream.synchronize()  # the result is ready for any stream

        # the BEST weights (MasterAsync.scala:87-94)
        return async_fit_result(checker, w_init, t_start, self._updates, self.batch_size, n)
