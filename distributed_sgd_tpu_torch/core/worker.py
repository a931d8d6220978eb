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

The rows live on the worker's device for the life of the node (or of the
slice, see below); a request carries sample ids, which gather their rows
there.  The JAX worker pads the ids to a power of two for its jit
buckets; the port does not pad.

The pipelined sync levers (docs/SYNC_PIPELINE.md of the JAX package):

- versioned weights (``resolve_request_weights``): a full broadcast
  installs the worker's replica under (fit_token, step_version), a
  ``WeightDelta`` assigns the master's absolute new values on top of the
  replica at ``base_version``, and a header-only request reuses it; any
  mismatch replies ``stale_version`` and computes nothing;
- the K-step local window (``compute_local_window``, a request with
  ``local_steps`` K > 1): up to K plain SGD steps over the ids in
  batches of ``batch_size``, as ONE ``sync_epoch`` launch in the sum mode
  (``parallel.sync.WindowSteps``), replying the decrement ``w - w_end``;
- ``FitStream``: one persistent stream a master, each frame the unary
  Gradient body.

The quorum barrier's requests are served: a ``hedge`` (another worker's
slice) is the plain Gradient body (or the window) on the ids it names,
replied uncompressed and counted ``slave.sync.hedge``; an
``ef_rollback_version`` is a no-op, since the port's worker has no
compressor and so no error-feedback residual.  With ``master_watch_s``
the worker watches the master after registering (``Master.Ping`` with its
own identity) and registers again when the master forgets it or stops
answering.

Host-local rows (data/host_shard.py, data/row_store.py): with
``data_offset`` the worker holds only global rows [data_offset,
data_offset + len(data)) and maps the master's global ids into them.
With a ``row_reader`` over the corpus (``total_rows`` long), ids outside
the slice RELOAD it incrementally (``ensure_rows``: only the uncovered
delta is read, widened by ``host_overprovision``), a StartAsync
re-shards it to its assignment, and a hedge for another worker's rows
reads them into a scratch batch; without a reader such ids are refused.
Each resident slice is one ``_Resident`` snapshot, swapped whole, so a
body computes on one slice, its bounds and its sentinel row.

Every request the port does not serve yet answers gRPC ``UNIMPLEMENTED``
with a message that names the ROADMAP item that holds it, never a wrong
reply: a Gradient with ``shard_count`` or ``agg_*``, and the methods
``AggregateGrad`` and ``Metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch.data import host_shard
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel import topology as topo
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike
from distributed_sgd_tpu_torch.parallel.sync import MeanSteps, WindowSteps, resolve_optimizer
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

# where each unserved request kind is ported (ROADMAP.md Queue A, item 8's
# modules)
NOT_PORTED = {
    "shard_count": "a sharded-master leg (DSGD_MASTER_SHARDS, shardedps/): "
                   "ROADMAP.md Queue A [A13] item 8",
    "agg": "an aggregation-tree request (DSGD_AGG_TREE, aggtree/): "
           "ROADMAP.md Queue A [A13] item 8",
    "AggregateGrad": "the aggregation tree (DSGD_AGG_TREE, aggtree/): "
                     "ROADMAP.md Queue A [A13] item 8",
    "Metrics": "the cluster telemetry scrape (DSGD_TELEMETRY, telemetry/): "
               "ROADMAP.md Queue A [A13] item 8",
}


def _not_ported(context, what: str):
    context.abort(grpc.StatusCode.UNIMPLEMENTED,
                  f"not ported to the torch worker yet: {NOT_PORTED[what]}")


class _Resident(NamedTuple):
    """One consistent snapshot of the worker's resident rows, swapped whole
    (one attribute assignment) when an elastic reload re-shards the slice
    (``ensure_rows``): a body that took the snapshot before the swap
    computes entirely on the old slice, with the old offset, and with the
    old data's bounds (ops/sync_epoch.py ``data_bounds`` is kept per
    tensor).  The device tensors hold `n` rows and one more, the zero
    sentinel row at index `n` (all values 0, label 0) that fills a short
    window.  ``host`` keeps the host arrays only with a row reader (the
    rows a reload reuses)."""

    offset: Optional[int]  # global row id of local row 0 (None: the full corpus)
    n: int  # resident rows, the sentinel not counted
    idx: torch.Tensor  # int32[n + 1, P]
    val: torch.Tensor  # f32[n + 1, P]
    y: torch.Tensor  # f32[n + 1]
    host: Optional[Dataset]


def _with_sentinel(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """`arr` on `device` as `dtype`, with one zero row appended."""
    if not arr.flags.writeable:  # a row store's mmap view
        arr = np.array(arr)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.zeros((host.shape[0] + 1,) + tuple(host.shape[1:]), dtype=dtype,
                      device=device)
    out[:host.shape[0]].copy_(host.to(dtype))
    return out


def _resident(data: Dataset, offset: Optional[int], keep_host: bool, device) -> _Resident:
    return _Resident(offset, len(data), _with_sentinel(data.indices, torch.int32, device),
                     _with_sentinel(data.values, torch.float32, device),
                     _with_sentinel(np.asarray(data.labels, np.float32), torch.float32,
                                    device),
                     data if keep_host else None)


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
        data_offset: Optional[int] = None,
        row_reader=None,
        total_rows: Optional[int] = None,
        host_overprovision: float = 0.0,
    ):
        """`device` defaults to the model's, and must equal it: the
        regularizer's vector lives there.  `steps_per_dispatch` local steps
        run in each async dispatch and gossip as one delta;
        `gossip_topology` ('all' | 'ring' | 'random:k') picks each
        dispatch's peers; `max_inflight_gossip` bounds each sender.
        `master_watch_s` (None: register once, as the reference) pings the
        master at that period once registered; a NOT_FOUND, or
        `master_watch_misses` misses in a row, registers again.

        `data_offset` makes `data` global rows [data_offset, data_offset +
        len(data)) (None: the full corpus, ids untouched); `row_reader`
        (data/host_shard.py ``RowReader`` over `total_rows` rows) lets the
        slice reload, widened by `host_overprovision` (a fraction of the
        span on each side)."""
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
        # the weights of the last applied broadcast, versioned:
        # (fit_token, step_version, weights)
        self._replica_lock = threading.Lock()
        self._replica: Optional[Tuple[int, int, np.ndarray]] = None
        if row_reader is not None:
            if total_rows is None:
                raise ValueError("row_reader needs total_rows: a reload clips its slice to "
                                 "the reader's corpus")
            if data_offset is None:
                raise ValueError("row_reader without data_offset: a full-corpus worker "
                                 "has nothing to reload")
        self._row_reader = row_reader
        self._total_rows = total_rows
        self._overprovision = max(0.0, float(host_overprovision))
        self._reload_lock = threading.Lock()
        # the rows a reload may hold: the constructed slice, re-anchored by
        # each StartAsync's assignment (see ensure_rows)
        self._resident_budget = len(data)
        self._resident = _resident(data, data_offset, row_reader is not None, self.device)

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

    @property
    def n_rows(self) -> int:
        """Resident rows."""
        return self._resident.n

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

    def _rows(self, ids: np.ndarray, res: _Resident):
        """(rows, labels) of the local ids `ids` of snapshot `res`, gathered
        on the device."""
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) and (ids.min() < 0 or ids.max() >= res.n):
            raise ValueError(f"sample ids outside this worker's {res.n} rows")
        t = torch.from_numpy(ids).to(self.device)
        batch = SparseBatch(res.idx.index_select(0, t), res.val.index_select(0, t))
        return batch, res.y.index_select(0, t)

    def _local_ids(self, ids: np.ndarray) -> Tuple[np.ndarray, _Resident]:
        """(the global sample ids mapped into the resident rows, the snapshot
        they are valid for): the caller computes on THAT snapshot, never on
        the attributes again, since a reload may swap them meanwhile.

        With the full corpus resident the ids pass through.  A host-local
        slice maps id -> id - offset; ids outside it reload the slice
        through the row reader (`ensure_rows`), or are refused without
        one: a gradient over the wrong rows would be worse than the
        failure the master classifies (retry, evict)."""
        res = self._resident
        if res.offset is None:
            return ids, res
        local = np.asarray(ids, dtype=np.int64) - res.offset
        if len(local) and (local.min() < 0 or local.max() >= res.n):
            if self._row_reader is not None:
                res = self.ensure_rows(int(np.min(ids)), int(np.max(ids)) + 1)
                local = np.asarray(ids, dtype=np.int64) - res.offset
                if local.min() >= 0 and local.max() < res.n:
                    return local, res
            raise ValueError(
                f"sample ids outside this host's resident slice [{res.offset}, "
                f"{res.offset + res.n}): the master's split is not host-granular "
                f"for this worker")
        return local, res

    def ensure_rows(self, lo: int, hi: int) -> _Resident:
        """Grow or shift the resident slice to cover global rows [lo, hi)
        through the row reader, reading ONLY the uncovered delta
        (data/host_shard.py ``reload_slice``), widened by the
        over-provision margin; returns the current snapshot.

        A covered range returns at once.  An overlapping reload keeps the
        union with the resident rows, bounded by the resident budget (the
        constructed slice, re-anchored by each StartAsync): past it the
        rows farthest from the requested range are dropped, so drifting
        resplits slide a window of fixed size.  A disjoint range drops the
        old rows.  The new snapshot replaces the old in one assignment;
        bodies in flight keep the one they took."""
        with self._reload_lock:
            res = self._resident
            if (res.offset is None or self._row_reader is None
                    or (lo >= res.offset and hi <= res.offset + res.n)):
                return res
            total = self._total_rows
            margin = host_shard.overprovision_margin(hi - lo, self._overprovision)
            req_lo = max(0, lo - margin)
            req_hi = min(total, max(hi, lo + 1) + margin)
            want_lo, want_hi = req_lo, req_hi
            if want_lo < res.offset + res.n and res.offset < want_hi:
                # overlap: the union keeps earlier rows warm
                want_lo = min(want_lo, res.offset)
                want_hi = max(want_hi, res.offset + res.n)
            budget = max(self._resident_budget, req_hi - req_lo)
            excess = (want_hi - want_lo) - budget
            if excess > 0:
                # trim the old slack outside the requested range, the
                # larger side first
                slack_lo, slack_hi = req_lo - want_lo, want_hi - req_hi
                if slack_lo >= slack_hi:
                    cut = min(slack_lo, excess)
                    want_lo += cut
                    want_hi -= min(slack_hi, excess - cut)
                else:
                    cut = min(slack_hi, excess)
                    want_hi -= cut
                    want_lo += min(slack_lo, excess - cut)
            host = res.host
            new_data, rows_read = host_shard.reload_slice(
                host, res.offset, self._row_reader, total, host.n_features,
                host.pad_width if not host.is_dense else 0, want_lo, want_hi,
                labels_dtype=host.labels.dtype)
            new_res = _resident(new_data, want_lo, True, self.device)
            self._resident = new_res
            self.metrics.counter(metrics_mod.DATA_RELOADS).increment()
            self.metrics.counter(metrics_mod.DATA_RELOAD_ROWS).increment(rows_read)
            flight.record("data.reload", worker=self.node_label, start=want_lo, end=want_hi,
                          rows_read=rows_read)
            self.log.info("resident slice re-sharded: [%d, %d) -> [%d, %d), %d row(s) read "
                          "(delta only)", res.offset, res.offset + res.n, want_lo, want_hi,
                          rows_read)
            return new_res

    def compute_gradient(self, w: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Sync Gradient body: the sum of backwards over `ids` plus the
        regularizer (Slave.scala:142-157), as f32[D] on the host."""
        self._profile.tick()
        ids, res = self._local_ids(ids)
        return self._gradient(w, *self._rows(ids, res))

    def _gradient(self, w: np.ndarray, batch: SparseBatch, y: torch.Tensor) -> np.ndarray:
        wt = torch.from_numpy(np.asarray(w, dtype=np.float32)).to(self.device)
        g = self.model.grad_regularized(wt, batch, y)
        self.metrics.counter("slave.sync.backward").increment()
        return g.cpu().numpy()

    def compute_gradient_hedged(self, w: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """A hedge's body (GradientRequest.hedge): compute_gradient's, but
        another worker's rows outside a host-local donor's slice are read
        through the row reader into a scratch batch, never through
        `ensure_rows`: the donor's slice, reload counters and budget are
        its own.  A full-corpus worker takes the plain body."""
        res = self._resident
        if res.offset is not None and self._row_reader is not None and len(ids):
            local = np.asarray(ids, dtype=np.int64) - res.offset
            if local.min() < 0 or local.max() >= res.n:
                return self._scratch_gradient(w, ids, res)
        return self.compute_gradient(w, ids)

    def _scratch_gradient(self, w: np.ndarray, ids: np.ndarray, res: _Resident) -> np.ndarray:
        """One gradient over rows [min(ids), max(ids) + 1) read into scratch
        tensors (no margin, no swap, no reload counted), dropped after."""
        self._profile.tick()
        gmin, gmax = int(np.min(ids)), int(np.max(ids)) + 1
        host = res.host
        scratch = host_shard.load_host_shard(
            self._row_reader, self._total_rows, host.n_features,
            host.pad_width if not host.is_dense else 0, gmin, gmax,
            labels_dtype=host.labels.dtype)
        self.metrics.counter(metrics_mod.HEDGE_SCRATCH).increment()
        return self._gradient(w, *self._rows(np.asarray(ids, np.int64) - gmin,
                                             _resident(scratch, gmin, False, self.device)))

    def resolve_request_weights(self, request) -> Tuple[Optional[np.ndarray], bool]:
        """The versioned weights of a sync Gradient request: (weights,
        stale), as the JAX worker's.  A full broadcast (``weights`` set)
        installs the replica at (fit_token, step_version); a
        ``WeightDelta`` assigns the master's ABSOLUTE new values at its
        indices on top of the replica when ``base_version`` matches; a
        header-only request (neither arm) reuses the replica.  A request
        whose version the replica already holds gets the replica whatever
        its arm, so a re-sent delta is never applied twice.  Any mismatch
        (no replica after a start, another fit's token, another base)
        returns stale=True and nothing is computed: the master falls back
        to a full broadcast.  A plain request (both 0) installs every
        window."""
        tok, version = request.fit_token, request.step_version
        with self._replica_lock:
            if self._replica is not None and self._replica[0] != tok:
                self._replica = None  # a new fit: the old replica is not its
            if request.HasField("weights"):
                w = codec.decode_tensor(request.weights)
                self._replica = (tok, version, w)
                return w, False
            if self._replica is None:
                return None, True
            _, cached_version, cached = self._replica
            if cached_version == version:
                return cached, False
            if request.HasField("delta") and cached_version == request.delta.base_version:
                w = codec.apply_weight_delta(cached, request.delta)
                self._replica = (tok, version, w)
                return w, False
            return None, True

    def compute_local_window(self, w: np.ndarray, ids: np.ndarray, k: int, batch_size: int,
                             learning_rate: float) -> np.ndarray:
        """Up to `k` local SGD steps over `ids` in batches of `batch_size`,
        as the JAX worker's window: min(ceil(n / batch_size), k) steps,
        the ids past k * batch_size dropped, a short last batch filled with
        the zero sentinel row.  Returns the decrement w - w_end, f32[D] on
        the host (at K=1 that is lr * compute_gradient(w, ids))."""
        self._profile.tick()
        ids, res = self._local_ids(ids)
        ids = np.asarray(ids, dtype=np.int64)
        bs = max(1, int(batch_size))
        steps = max(1, min(-(-len(ids) // bs), max(1, int(k))))
        n = min(len(ids), steps * bs)
        if n and (ids[:n].min() < 0 or ids[:n].max() >= res.n):
            raise ValueError(f"sample ids outside this worker's {res.n} rows")
        padded = np.full(steps * bs, res.n, dtype=np.int64)  # res.n: the sentinel row
        padded[:n] = ids[:n]
        window = WindowSteps(self.model, res.idx, res.val, res.y, float(learning_rate))
        wt = torch.from_numpy(np.asarray(w, dtype=np.float32)).to(self.device)
        w_end, _ = window.run(wt, torch.from_numpy(padded.reshape(steps, 1, bs)).to(
            self.device))
        self.metrics.counter("slave.sync.backward").increment(steps)
        return (wt - w_end).cpu().numpy()

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
        ids, res = self._local_ids(ids)
        batch, _ = self._rows(ids, res)
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
        generator; returns the resolved optimizer.  A host-local slice is
        first re-sharded to cover the assignment (only the delta read), and
        the assignment re-anchors its resident budget."""
        assignment = np.asarray(assignment, dtype=np.int64)
        if len(assignment) == 0:
            raise ValueError("StartAsync with no samples")
        res = self._resident
        if res.offset is not None:
            if self._row_reader is not None:
                a_lo, a_hi = int(assignment.min()), int(assignment.max()) + 1
                self._resident_budget = (a_hi - a_lo) + 2 * host_shard.overprovision_margin(
                    a_hi - a_lo, self._overprovision)
                res = self.ensure_rows(a_lo, a_hi)
            assignment = assignment - res.offset
        if assignment.min() < 0 or assignment.max() >= res.n:
            raise ValueError(f"StartAsync samples outside this worker's {res.n} resident rows")
        # momentum passes through as given: an explicit 0.0 is honoured
        opt = resolve_optimizer(optimizer or None, float(momentum))
        with torch.cuda.stream(self._stream):
            with self._w_lock:
                self._w = torch.as_tensor(np.asarray(w0, dtype=np.float32)).to(self.device)
            self._assignment = torch.from_numpy(assignment).to(self.device)
            self._steps = MeanSteps(self.model, res.idx, res.val, res.y,
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
        return self._gradient_update(request, context)

    def _gradient_update(self, request, context):
        """One sync-window Gradient body, shared by the unary Gradient and
        the FitStream loop: streaming changes the transport, never the
        math.  The weights resolve by version (a stale replica replies
        ``stale_version`` and computes nothing); ``local_steps`` K > 1 runs
        the K-step window; a hedge (another worker's slice under the
        quorum barrier) is counted and replied as computed; an EF rollback
        is a no-op here."""
        if request.shard_count:
            _not_ported(context, "shard_count")
        if request.agg_parent or request.agg_children:
            _not_ported(context, "agg")
        if request.ef_rollback_version:
            self.w.rollback_sync_ef(request.ef_rollback_version)
        w, stale = self.w.resolve_request_weights(request)
        if stale:
            self.w.metrics.counter("slave.sync.stale").increment()
            return pb.GradUpdate(stale_version=True)
        ids = np.fromiter(request.samples, dtype=np.int64)
        k = request.local_steps
        with measure.span("slave.grad.compute", metrics=self.w.metrics, root=False,
                          samples=len(ids), local_steps=int(k or 1)):
            if k > 1:
                g = self.w.compute_local_window(w, ids, k, request.batch_size,
                                                request.learning_rate)
            elif request.hedge:
                g = self.w.compute_gradient_hedged(w, ids)
            else:
                g = self.w.compute_gradient(w, ids)
        if request.hedge:
            self.w.metrics.counter("slave.sync.hedge").increment()
        with measure.span("slave.grad.encode", metrics=self.w.metrics, root=False):
            msg = codec.encode_grad(g)
        if k > 1:
            msg.n_steps = k  # steps a round, for the wire's accounting
        return msg

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
        """The streaming sync fan-out (DSGD_STREAM): one persistent bidi
        stream a master for the life of a fit; each frame runs the unary
        Gradient body and answers on the stream under the request's seq.
        The master closing the stream, a transport reset, or an exception
        out of the body ends the generator, which the master's stream
        client takes as a failed call: its windows in flight replay over
        unary."""
        m = self.w.metrics
        m.counter(metrics_mod.SLAVE_STREAM_OPENED).increment()
        self.w.log.info("FitStream opened by %s", context.peer())
        try:
            for frame in request_iterator:
                if frame.WhichOneof("payload") != "request":
                    continue  # an arm this worker does not know is skipped
                m.counter(metrics_mod.SLAVE_STREAM_FRAMES).increment()
                update = self._gradient_update(frame.request, context)
                yield pb.Frame(seq=frame.seq, fit_token=frame.fit_token, update=update)
        except grpc.RpcError:
            # the client tore the stream down (the fit ended, a cancel, a
            # reset): nobody is left to answer
            self.w.log.info("FitStream closed by peer")
        except Exception as e:  # noqa: BLE001 - record, then tear down
            # a frame has no error arm: tearing the stream down IS the
            # failure (the master replays over unary, where the same
            # request fails per call)
            self.w.log.warning("FitStream servicer loop failed: %r", e)
            flight.record("stream.servicer.error", worker=self.w.node_label, error=repr(e))
            raise
        finally:
            m.counter(metrics_mod.SLAVE_STREAM_CLOSED).increment()
