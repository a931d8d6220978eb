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
  the replies summed IN SEND ORDER as they arrive and divided by their
  count (so the result bit-matches ``np.mean`` over the replies), and the
  update applied
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

The JAX master's fault tolerance (docs/FAULT_TOLERANCE.md, docs/
ELASTICITY.md), with its names:

- the heartbeat (`start(heartbeat_s=)`): one probe per worker on the
  shared deadline wheel (rpc/stream.py); `heartbeat_max_misses` misses in
  a row evict the worker;
- re-registration: a member that registers again during an async fit is
  kicked with a fresh StartAsync and re-introduced to its peers;
- the quorum barrier (`fit_sync(quorum=, straggler_soft_s=, hedge=)`,
  `predict(quorum=)`): past a soft deadline with `quorum` replies in
  hand, each missing slice is hedged to the fastest responders, the
  replies are summed in canonical slice order over the contributors, and
  below quorum the window falls back to the full barrier;
- the crash-safe fit state (`fit_sync(fit_state_path=,
  fit_state_every=)`): the full loop state every R windows, from which a
  new master resumes bit for bit;
- elastic membership (`fit_async(elastic=True)`): any change of members
  re-splits the rows and re-issues StartAsync to the workers whose slice
  changed.

and the JAX master's pipelined sync levers (`fit_sync(local_steps=,
delta_broadcast=, stream=, fanin_lanes=, stage_pool=)`): K-step local
windows with the mean decrement applied as a pseudo-gradient, versioned
sparse broadcasts (``_BroadcastState``, the next version encoded ahead
while the levers that read it are on), one persistent FitStream a worker (rpc/stream.py), the
fan-in parsed in lanes and summed in send order (``_ArrivalDecoder``),
and the next round's draws and requests staged on a pool during the
barrier (``_DispatchStager``).

The workers compute on their own devices; the master only encodes,
decodes and applies, and evaluates on its device.  Every lever of the JAX
fits that is not ported raises NotImplementedError naming the ROADMAP
item that holds it (the health monitor, the aggregation tree and the
sharded master).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.checkpoint import (
    opt_kind_tag,
    restore_fit_state,
    restore_sync_fit,
    save_fit_state,
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
# with fan-in lanes the replies are parsed and summed during the barrier,
# and the decode span is only the tail left after it
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


class _ArrivalDecoder:
    """Send-ordered decode-on-arrival for the sync fan-in, SHARDED into K
    decoder lanes (DSGD_FANIN_LANES); the JAX master's lanes path.

    The plain fan-in decodes every Gradient reply AFTER the barrier closes:
    N dim-sized scatter-decodes serialized on the critical path while N-1
    of them could have run during the wait.  This moves each reply's decode
    into the reply's own arrival callback, constrained to SEND ORDER (the
    decode cursor only advances over the contiguous settled prefix), so the
    float accumulation order, and therefore the weights, stay bit-identical
    to the post-barrier loop.

    Workers map to lanes by a fixed send-index assignment (``i % K``), each
    lane guards its own slot map with its own lock, and the expensive half
    of the decode (`codec.parse_grad`: repeated-field -> ndarray) runs in
    the arrival callback BEFORE any lock is taken, so K callbacks parse
    concurrently.  Only the cheap float ACCUMULATION (`codec.add_parsed`)
    is serialized, under the accumulator lock, walking the contiguous
    settled prefix in send order.  Keeping the accumulation a single
    send-ordered f32 chain is what makes the lanes BIT-EXACT against the
    post-barrier loop: a per-lane partial-sum + K-way reduce would regroup
    the float additions ((r0+r1)+(r2+r3) instead of ((r0+r1)+r2)+r3) and
    drift in the last ulp.  ``lanes`` below 1 is taken as one lane (the
    JAX master's single-lock path sums in the same order).

    ``defer=True`` (the quorum barrier's mode) parses arrivals into a
    side table but never accumulates: the contributor set (hedge wins,
    late originals) is only known at round close, when the caller replays
    it in canonical order through ``add_into`` — pre-parsed replies cost
    O(dim) adds only, unparsed ones (hedge replies arrive on unary
    futures nobody watches) parse on the spot.

    Lock discipline: parse outside every lock; lane locks guard only
    their slot maps (set-once per index, so a callback racing `finish()`
    can never decode a reply twice); the accumulator lock serializes the
    cursor walk and is never held while a lane lock is awaited in the
    other direction.  A failed or stale reply marks the window dirty and
    freezes the cursor — the caller retries the window and the
    accumulator is re-zeroed on the next attempt, so partially-decoded
    state never leaks into an applied update."""

    def __init__(self, acc: np.ndarray, lanes: int = 1, defer: bool = False):
        self.acc = acc
        self.lanes = max(1, int(lanes))
        self.defer = bool(defer)
        self._lock = threading.Lock()
        self._cursor = 0
        self.dirty = False
        self.decoded = 0
        self.parsed = 0
        self.reused = 0  # defer mode: replies add_into took pre-parsed
        self._lane_locks = [threading.Lock() for _ in range(self.lanes)]
        # per-lane slot maps: index -> (reply | None, parsed | None)
        self._lane_slots: List[Dict[int, tuple]] = [dict() for _ in range(self.lanes)]
        # defer mode's side table: id(reply) -> (reply, parsed); the reply
        # reference keeps the id stable until the round closes
        self._parsed_by_reply: Dict[int, tuple] = {}

    def watch(self, i: int, fut) -> None:
        if fut is None:
            self._settle_lane(i, None)
            return
        fut.add_done_callback(lambda f, i=i: self._on_done_lane(i, f))

    def finish(self, futs) -> bool:
        """Drain any settled tail the callbacks have not reached yet (the
        barrier already awaited every future, but gRPC's callback threads
        may lag the main thread's own `result()`); returns clean?"""
        for i, (_key, fut) in enumerate(futs):
            lane = self._lane_locks[i % self.lanes]
            with lane:
                seen = i in self._lane_slots[i % self.lanes]
            if not seen:
                try:
                    reply = fut.result() if fut is not None else None
                except Exception:  # noqa: BLE001
                    reply = None
                self._settle_lane(i, reply)
        self._advance_lanes()
        return not self.dirty

    def _on_done_lane(self, i: int, fut) -> None:
        try:
            reply = fut.result()
        except Exception:  # noqa: BLE001 - classification is the barrier's job
            reply = None
        self._settle_lane(i, reply)

    def _settle_lane(self, i: int, reply) -> None:
        # parse BEFORE any lock: this is the concurrency the lanes buy
        parsed = None
        if reply is not None and not reply.stale_version:
            parsed = codec.parse_grad(reply)
        lane = i % self.lanes
        with self._lane_locks[lane]:
            slots = self._lane_slots[lane]
            if i in slots:  # set-once: a lagging callback must not re-enter
                return
            slots[i] = (reply, parsed)
        if parsed is not None:
            with self._lock:  # exact count; defer's side table reads here too
                self.parsed += 1
                if self.defer:
                    self._parsed_by_reply[id(reply)] = (reply, parsed)
        if not self.defer:
            self._advance_lanes()

    def _advance_lanes(self) -> None:
        if self.defer:
            return
        with self._lock:  # the accumulator lock: one ordered f32 chain
            while not self.dirty:
                lane = self._cursor % self.lanes
                with self._lane_locks[lane]:
                    item = self._lane_slots[lane].get(self._cursor)
                if item is None:
                    return
                reply, parsed = item
                if reply is None or reply.stale_version:
                    self.dirty = True
                    return
                codec.add_parsed(parsed, self.acc)
                self.decoded += 1
                self._cursor += 1

    def add_into(self, reply, out: np.ndarray) -> None:
        """Defer mode's round-close accumulate: reuse the arrival
        callback's parse when one landed for this reply object, parse on
        the spot otherwise (hedge replies, late settles) — the float adds
        are `decode_grad_into`'s exactly, in the caller's order."""
        item = None
        if self.defer:
            with self._lock:
                item = self._parsed_by_reply.get(id(reply))
        if item is not None and item[0] is reply:
            codec.add_parsed(item[1], out)
            self.reused += 1
        else:
            codec.decode_grad_into(reply, out)


class _LatencyEwma:
    """Per-worker reply-latency EWMA (mean and mean absolute deviation),
    the quorum barrier's adaptive soft deadline.

    `soft_deadline_s(keys, quorum)`: a p95 proxy per worker (mean + 3
    deviations), then the quorum-th smallest of them, with slack, so that
    a straggler's own tail does not stretch the deadline that cuts it
    off.  None until `quorum` workers have history: the first windows run
    as full barriers, and they seed the EWMA."""

    SLACK = 1.5
    FLOOR_S = 0.05

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._mean: Dict[Tuple[str, int], float] = {}
        self._dev: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()

    def record(self, key: Tuple[str, int], seconds: float) -> None:
        with self._lock:
            m = self._mean.get(key)
            if m is None:
                self._mean[key] = seconds
                self._dev[key] = 0.0
                return
            err = seconds - m
            self._mean[key] = m + self.alpha * err
            self._dev[key] = (1 - self.alpha) * self._dev[key] + self.alpha * abs(err)

    def p95_s(self, key: Tuple[str, int]) -> Optional[float]:
        with self._lock:
            m = self._mean.get(key)
            if m is None:
                return None
            return m + 3.0 * self._dev[key]

    def soft_deadline_s(self, keys, quorum: int) -> Optional[float]:
        ests = sorted(e for e in (self.p95_s(k) for k in keys) if e is not None)
        if len(ests) < max(1, quorum):
            return None
        return max(self.FLOOR_S, self.SLACK * ests[max(1, quorum) - 1])


def _reply_weight(reply) -> int:
    """Quorum mass of one barrier reply: one worker's gradient.  (The JAX
    master also weighs aggregation-tree replies by their contributors,
    ROADMAP.md Queue A [A13] item 8; the port has no tree.)"""
    del reply
    return 1


def _await_quorum(futs, quorum: int, soft_deadline: float, bytes_counter=None,
                  latency: Optional[_LatencyEwma] = None):
    """Quorum barrier over [(key, future-or-None)].

    Waits until every future settles, or until `soft_deadline` (absolute
    time.monotonic) has passed with `quorum` successful replies in hand.
    Returns (ok, failed, pending): ok and failed as _await_futures,
    pending = [(key, future)] still in flight, for the caller to hedge,
    wait for or discard.  Bytes and each worker's latency are accounted as
    the replies arrive, so a discarded straggler still feeds the EWMA."""
    cv = threading.Condition()

    def _notify(_):
        with cv:
            cv.notify()

    t_sent = time.monotonic()
    ok, failed, pending = [], [], []
    ok_weight = 0
    for key, fut in futs:
        if fut is None:
            failed.append((key, ValueError("channel closed")))
        else:
            pending.append((key, fut))
            fut.add_done_callback(_notify)
    while pending:
        still = []
        for key, fut in pending:
            if not fut.done():
                still.append((key, fut))
                continue
            try:
                reply = fut.result()
                if bytes_counter is not None:
                    bytes_counter.increment(reply.ByteSize())
                if latency is not None:
                    latency.record(key, time.monotonic() - t_sent)
                ok.append((key, reply))
                ok_weight += _reply_weight(reply)
            except grpc.RpcError as e:
                failed.append((key, e.code()))
        pending = still
        if not pending:
            break
        remaining = soft_deadline - time.monotonic()
        if remaining <= 0 and ok_weight >= quorum:
            break
        with cv:
            # below quorum past the soft deadline: the per-call deadline
            # is the hard bound; wake on each settle
            cv.wait(timeout=0.25 if remaining <= 0 else max(0.005, min(0.25, remaining)))
    return ok, failed, pending


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


class _DispatchStager:
    """Pooled round-(t+1) dispatch staging (DSGD_STAGE_POOL); the JAX
    master's.

    The serialized master draws every worker's sample ids ON the dispatch
    critical path, one worker after another, each round.  With staging
    on, round t+1's draws run on the stage pool DURING round t's barrier
    (the main thread is blocked in gRPC with the GIL released, so the
    staging thread genuinely overlaps) — dispatch then starts from a
    ready ids-by-worker map.

    Determinism is the whole contract.  The sample stream is one
    epoch-keyed np.random.Generator consumed in (round, worker) order;
    a resumed fit replays it from a snapshotted bit-generator state.  So:

    - the pre-draw consumes the SAME values, in the SAME order, the
      serial path's next round would have consumed (one staging task
      draws all workers sequentially — never one task per worker);
    - the pre-draw snapshots the generator state first, and ANY
      discard — a retry re-dispatching the same cursor, a resplit
      changing membership/partitions, an epoch ending — RESTORES it, so
      the serial path's draw at that point reads the exact values it
      would have read had staging never run;
    - `rng_state()` exposes the state a SERIAL run would hold right now
      (the pre-draw base while a stage is pending), which is what the
      crash-safe fit-state snapshot must persist — persisting the
      post-pre-draw state would make a resumed fit skip a round's draws.

    The same pool is handed to `_BroadcastState` so per-worker request
    builds (weight-arm attach + frame construction) fan out across it at
    encode time; `hits`/`discards` feed master.sync.stage.* counters."""

    def __init__(self, pool_size: int):
        from concurrent.futures import ThreadPoolExecutor

        self.pool = ThreadPoolExecutor(
            max_workers=max(1, int(pool_size)), thread_name_prefix="stage-pool")
        self._fut = None
        self._base_state = None
        self._tag: Optional[Tuple[int, int]] = None
        self._keys: List[Tuple[str, int]] = []
        self.hits = 0
        self.discards = 0

    def stage(self, rng, keys, parts, epoch: int, cursor: int,
              span: int) -> None:
        """Arm one pre-draw for (epoch, cursor); call only with no stage
        pending (take/discard every round)."""
        assert self._fut is None, "a staged draw is already pending"
        self._base_state = rng.bit_generator.state
        self._tag = (int(epoch), int(cursor))
        self._keys = list(keys)
        parts = list(parts)

        def _draw_all():
            # sequential, in fan-out order: the exact consumption pattern
            # of the serial dispatch loop
            return [_draw_ids(rng, part, cursor, span) for part in parts]

        self._fut = self.pool.submit(_draw_all)

    def take(self, rng, keys, epoch: int, cursor: int):
        """The staged ids-by-worker map when the staging assumptions still
        hold (same epoch, same window cursor, same membership); None
        otherwise — the generator state is restored and the caller draws
        serially, reading the values a never-staged run would read."""
        if self._fut is None:
            return None
        draws = self._fut.result()  # join: surfaces staging exceptions
        self._fut = None
        if self._tag != (int(epoch), int(cursor)) or list(keys) != self._keys:
            rng.bit_generator.state = self._base_state
            self._base_state = None
            self.discards += 1
            return None
        self._base_state = None
        self.hits += 1
        return dict(zip(self._keys, draws))

    def discard(self, rng) -> None:
        """Membership moved under the stage (resplit): drop the pre-drawn
        ids and restore the generator."""
        if self._fut is None:
            return
        self._fut.result()
        self._fut = None
        rng.bit_generator.state = self._base_state
        self._base_state = None
        self.discards += 1

    def rng_state(self, rng):
        """The bit-generator state a SERIAL run would hold right now — the
        pre-draw base while a stage is pending, the live state otherwise.
        Crash-safe fit-state snapshots persist THIS, never the raw state."""
        return (self._base_state if self._fut is not None
                else rng.bit_generator.state)

    def close(self) -> None:
        self.pool.shutdown(wait=False)


class _BroadcastState:
    """Versioned master->worker weight broadcast for fit_sync; the JAX
    master's.

    Tracks the master's weight version, each worker's last-acknowledged
    replica version, and encodes — at most once per version — the wire
    forms a window can need: the full tensor, the sparse WeightDelta vs
    the previous version (absolute new values at the changed coordinates),
    or nothing at all (header-only, when the worker's replica is already
    current — retry windows re-serialize zero bytes).  With
    `delta_broadcast` off it degrades to the pre-pipeline wire — every
    request carries the full dense tensor and no version fields, byte-
    identical to the unpipelined fit — while still re-encoding only when
    the weights actually changed.

    The sparse form is used only while it is cheaper than the tensor
    (8 bytes/changed coordinate vs 4 bytes/element dense: break-even at
    50% density); denser updates fall back to a full broadcast, as do a
    (re)joined worker, a worker more than one version behind, and any
    stale_version reply.
    """

    SPARSE_BREAK_EVEN = 0.5  # changed fraction above which dense is smaller

    def __init__(self, delta_broadcast: bool, metrics, versioned: bool = False,
                 stage_pool=None):
        self.delta_broadcast = delta_broadcast
        self.metrics = metrics
        # pooled dispatch (DSGD_STAGE_POOL): when a stage
        # pool executor is handed in, _build_staged fans the per-worker
        # request builds (weight-arm attach included) across it instead of
        # building N requests serially on the one encoder thread — and
        # staging is armed for UNARY fits too (raw GradientRequests
        # instead of stream Frames), so the serialized per-worker build
        # leaves the dispatch critical path on both transports
        self._stage_exec = stage_pool
        # encode-ahead, while delta_broadcast or staging (stage_for) is
        # on: `advance()` hands the new version's wire forms (full tensor
        # bytes + the np.nonzero sparse delta) and the staged requests to
        # a single background encoder thread, overlapping the encode with
        # the window's host-side bookkeeping (fit-state snapshot,
        # membership check, sample draws) and — under quorum — with
        # straggler replies still in flight.  `populate` joins the
        # pending encode before reading, so the wire forms are
        # byte-identical to the synchronous path.  With those levers off
        # (and before the first advance) encoding stays lazy in populate,
        # on the fit's thread, as the unpipelined fit encodes.
        self._enc_pool = None
        self._enc_future = None
        # `versioned` without delta_broadcast (the quorum barrier's mode):
        # every request still carries the full dense tensor, but stamped
        # with step_version — the quorum contribution mask
        # (GradientRequest.ef_rollback_version) keys on the version
        self.versioned = bool(delta_broadcast or versioned)
        # versions start at 1: step_version=0 on the wire means "no version
        # tracking" (a pre-pipeline master), and the workers' EF retry
        # guard keys on the version alone whenever one is present — a
        # retried window may switch wire form (full -> header-only) while
        # keeping its version, so the version must never be ambiguous
        self.version = 1 if self.versioned else 0
        self._worker_ver: Dict[Tuple[str, int], int] = {}
        self._w_prev: Optional[np.ndarray] = None
        # the version's wire forms (full tensor / sparse delta), each
        # encoded lazily at most once — the shared versioned weight-send
        # plan (rpc/codec.py WeightSendPlan)
        self._send_plan: Optional[codec.WeightSendPlan] = None
        # pre-staged round dispatch (DSGD_STREAM): with staging armed (stage_for), the
        # encoder thread ALSO builds each worker's next request frame —
        # weight arm attached, version stamped — so when the window
        # barrier closes, dispatch is one sample draw + one stream write
        # per worker with zero weight re-serialization on the critical
        # path.  Entries carry the assumptions they were built under
        # (version, the worker's acknowledged version) and are discarded
        # when reality moved (stale fallback, resplit, retry window).
        self._stage_keys: list = []
        self._stage_ctx: Optional[Tuple[int, int, int, float]] = None
        self._stage_frames = True
        self._stage_lock = threading.Lock()
        self._staged: Dict[Tuple[str, int], tuple] = {}

    def stage_for(self, keys, fit_token: int, local_steps: int,
                  batch_size: int, learning_rate: float,
                  frames: bool = True) -> None:
        """Arm (or re-arm after a membership change) request staging for
        `keys`; takes effect from the next advance().  `frames=True`
        stages stream `pb.Frame`s (the DSGD_STREAM dispatch path);
        `frames=False` stages raw `pb.GradientRequest`s for the unary
        plane (DSGD_STAGE_POOL) — with neither knob on, nothing ever
        calls this and populate()'s call graph stays untouched."""
        self._stage_keys = list(keys)
        self._stage_ctx = (int(fit_token), int(local_steps),
                           int(batch_size), float(learning_rate))
        self._stage_frames = bool(frames)
        with self._stage_lock:
            self._staged = {}

    def advance(self, w_new: np.ndarray, w_old: np.ndarray) -> None:
        """Weights moved: bump the version, invalidate encoded forms, and,
        while delta_broadcast or staging is on, start encoding the new
        version off-thread."""
        self.version += 1
        self._w_prev = w_old
        self._send_plan = None
        with self._stage_lock:
            self._staged = {}
        if not (self.delta_broadcast or self._stage_ctx is not None):
            return
        if self._enc_pool is None:
            import weakref
            from concurrent.futures import ThreadPoolExecutor

            self._enc_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bcast-encode")
            # the broadcast state is fit-scoped: release the encoder
            # thread when the fit drops it (every exit path, exceptions
            # included) without threading a close() through fit_sync
            weakref.finalize(self, self._enc_pool.shutdown, wait=False)
        self._enc_future = self._enc_pool.submit(self._preencode, w_new)

    def _preencode(self, w: np.ndarray) -> None:
        """Encoder-thread body: build the forms `populate` will need —
        the resolved plan lands in the lazy slot, `_join_encode` gives
        the happens-before edge — then stage per-worker request frames
        when staging is armed (the slot is set by then, so _attach_arm
        never joins from the encoder thread itself)."""
        plan = self._new_plan(w)
        plan.full()
        if self.delta_broadcast:
            plan.delta()  # "use the full form" is itself a computed result
        self._send_plan = plan
        if self._stage_keys and self._stage_ctx is not None:
            self._build_staged(w)

    def _build_staged(self, w: np.ndarray) -> None:
        """Encoder-thread tail: one ready-to-send Frame (stream) or
        GradientRequest (unary, stage-pool fits) per staged worker for the
        NEXT window, fanned across the stage pool when one was handed in
        (per-worker weight-arm attach is the O(N x dim) serial wall this
        removes).  Wire accounting stays at dispatch time
        (take_staged_frame / take_staged_request), so counters equal the
        populate() path's."""
        token, k, bs, lr = self._stage_ctx
        version = self.version
        frames = self._stage_frames

        def _build(key):
            if frames:
                frame = pb.Frame()
                req = frame.request
                msg = frame
            else:
                req = pb.GradientRequest()
                msg = req
            req.fit_token = token
            if k > 1:
                req.local_steps = k
                req.batch_size = bs
                req.learning_rate = lr
            assumed = self._worker_ver.get(key)
            form, nbytes = self._attach_arm(req, key, w)
            return key, (msg, form, nbytes, assumed, version)

        keys = list(self._stage_keys)
        if self._stage_exec is not None and len(keys) > 1:
            staged = dict(self._stage_exec.map(_build, keys))
        else:
            staged = dict(_build(key) for key in keys)
        with self._stage_lock:
            self._staged = staged

    def _take_staged(self, key, frames: bool):
        """The pre-staged message for `key` if its staging assumptions
        still hold (same broadcast version, same acknowledged worker
        version, same transport); None otherwise — the caller builds and
        populates a fresh one.  Joins the encoder first, exactly like
        populate()'s lazy reads, and accounts the send here so metrics
        match the unstaged path."""
        self._join_encode()
        with self._stage_lock:
            if self._stage_frames != frames:
                return None
            item = self._staged.pop(key, None)
        if item is None:
            return None
        msg, form, nbytes, assumed, version = item
        if version != self.version or self._worker_ver.get(key) != assumed:
            return None  # stale fallback / resplit moved under the stage
        metrics_mod.record_broadcast(self.metrics, form, nbytes)
        return msg

    def take_staged_frame(self, key):
        """Stream dispatch's staged `pb.Frame`, or None (build fresh)."""
        return self._take_staged(key, frames=True)

    def take_staged_request(self, key):
        """Unary dispatch's staged `pb.GradientRequest`, or None."""
        return self._take_staged(key, frames=False)

    def _join_encode(self) -> None:
        f = self._enc_future
        if f is not None:
            f.result()  # surfaces encoder exceptions on the fit thread
            self._enc_future = None

    def note_ok(self, key) -> None:
        self._worker_ver[key] = self.version

    def note_stale(self, key) -> None:
        self._worker_ver.pop(key, None)

    def forget_missing(self, keys) -> None:
        """Membership changed: drop version claims for departed workers so
        a same-endpoint rejoin starts from a full broadcast."""
        live = set(keys)
        for k in [k for k in self._worker_ver if k not in live]:
            self._worker_ver.pop(k, None)

    def populate(self, req, key, w: np.ndarray) -> None:
        """Attach the cheapest valid weight arm for worker `key` to `req`
        and account it (utils/metrics.py master.sync.bcast.*)."""
        form, nbytes = self._attach_arm(req, key, w)
        metrics_mod.record_broadcast(self.metrics, form, nbytes)

    def _attach_arm(self, req, key, w: np.ndarray):
        """Choose + attach the weight arm for `key`; returns the
        (form, bytes) pair the caller accounts.  Shared by populate()
        (dispatch thread, joins the encoder through the lazy slot reads)
        and _build_staged (encoder thread, slots already set)."""
        if not self.delta_broadcast:
            full = self._plan_for(w).full()
            req.weights.CopyFrom(full)
            if self.versioned:
                req.step_version = self.version
            return "full", full.ByteSize()
        req.step_version = self.version
        plan = self._plan_for(w)
        arm = plan.choose_arm(self._worker_ver.get(key), self.version)
        if arm == "cached":
            return "cached", 0
        if arm == "delta":
            delta = plan.delta()
            req.delta.CopyFrom(delta)
            return "delta", delta.ByteSize()
        full = plan.full()
        req.weights.CopyFrom(full)
        return "full", full.ByteSize()

    def _new_plan(self, w: np.ndarray) -> "codec.WeightSendPlan":
        """This version's shared weight-send plan (rpc/codec.py): the
        delta-vs-full choice and both lazy encodes.  Without
        delta_broadcast the sparse form is disabled outright
        (w_prev=None), so the plan degrades to a lazy encode_tensor."""
        return codec.plan_weight_send(
            w, self._w_prev if self.delta_broadcast else None,
            base_version=self.version - 1,
            break_even=self.SPARSE_BREAK_EVEN)

    def _plan_for(self, w: np.ndarray) -> "codec.WeightSendPlan":
        # slot first, join only on a miss: a set slot IS the encoder's
        # finished result (assigned last, forms already resolved), and
        # checking first lets the encoder thread itself resolve forms
        # while staging frames without deadlocking on its own future
        if self._send_plan is None:
            self._join_encode()
        if self._send_plan is None:
            self._send_plan = self._new_plan(w)
        return self._send_plan


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
        # reply latencies for the quorum barriers' adaptive soft deadlines,
        # one tracker a fan-out: Gradient and Forward differ in scale
        self._latency = _LatencyEwma()
        self._fwd_latency = _LatencyEwma()
        self.model = model
        self.device = model.device
        self.train = train
        self.test = test
        self.expected_workers = expected_workers
        self.seed = seed

        # the fan-in lanes and the stage pool fit_sync resolves against
        # when its parameters are None (main.py passes the DSGD_* values)
        self.fanin_lanes = 0
        self.stage_pool = 0

        self._workers: Dict[Tuple[str, int], WorkerStub] = {}
        self._channels: Dict[Tuple[str, int], grpc.Channel] = {}
        self._order: List[Tuple[str, int]] = []  # registration order
        self._members_lock = threading.Lock()
        self.cluster_ready = threading.Event()  # Master.scala:34-35
        # the persistent gradient streams of a fit with stream=True, opened
        # at a worker's first streamed dispatch and closed at the fit's end,
        # an unregistration or stop; the peers that answered UNIMPLEMENTED
        # to FitStream stay unary for the life of this process (until they
        # register again: a restarted worker may be another binary)
        self._streams: Dict[Tuple[str, int], object] = {}
        self._streams_lock = threading.Lock()
        self._stream_unsupported: set = set()

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
        # members that registered again during an async fit (a worker
        # process restarted on the same endpoint): the fit's loop re-kicks
        # each with its slice, since no membership change shows it
        self._rereg_pending: set = set()

        self.server = new_server(port, host="0.0.0.0")
        self.port = self.port or self.server.bound_port
        add_master_servicer(self.server, _MasterServicer(self), node="master")

        self._hb_stop = threading.Event()
        self._hb_wake = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # each fit_sync stamps its requests with a fresh token; the base is
        # a nonce of this incarnation, so a restarted master never reuses
        # a token its long-lived workers saw (48 bits + a 15-bit sequence)
        self._fit_token_base = random.getrandbits(48) << 15
        self._fit_seq = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, heartbeat_s: Optional[float] = None,
              heartbeat_max_misses: int = 3) -> "MasterNode":
        """`heartbeat_s` (DSGD_HEARTBEAT_S) starts the heartbeat: every
        member is probed at that period and evicted after
        `heartbeat_max_misses` (DSGD_HEARTBEAT_MAX_MISSES) misses in a
        row."""
        self.server.start()
        self.log.info("master started on %s:%d, expecting %d workers",
                      self.host, self.port, self.expected_workers)
        if heartbeat_s:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                args=(heartbeat_s, max(1, int(heartbeat_max_misses))),
                daemon=True, name="heartbeat")
            self._hb_thread.start()
        return self

    # at most this many probes in flight at once; a probe past the cap
    # waits for the next wake
    HB_PROBE_POOL = 16

    def _heartbeat_loop(self, interval_s: float, max_failures: int = 3) -> None:
        """Per-worker liveness probes on the shared deadline wheel: each
        worker's probe fires at its own due time, settles on its own
        deadline (the interval, capped by the policy's), and re-arms
        `interval_s` after it settles, so a slow peer delays only itself.
        New members' first probes are staggered across one interval.  The
        decisions (`max_failures` misses in a row, a success resets, then
        ``unregister_worker(evicted=True)``) run on this thread; the gRPC
        callbacks only queue what they saw.  (The JAX master also scrapes
        the workers' metrics at this cadence: ROADMAP.md Queue A [A13]
        item 8.)"""
        from distributed_sgd_tpu_torch.rpc.stream import Wheel

        tracker = _FailureTracker(max_failures)
        probe_timeout = min(interval_s, self.rpc_policy.deadline_s)
        wheel = Wheel(name="heartbeat-wheel")
        due_ready: collections.deque = collections.deque()  # keys due now
        completions: collections.deque = collections.deque()  # (key, ok)
        wake = self._hb_wake
        scheduled: set = set()  # keys with a wheel entry or a probe in flight
        in_flight: set = set()
        deferred: List[Tuple[str, int]] = []  # due past the probe pool's cap

        def _fire(key):
            due_ready.append(key)
            wake.set()

        def _probe(key, stub):
            in_flight.add(key)
            try:
                fut = stub.Ping.future(pb.Empty(), timeout=probe_timeout)
            except ValueError:  # the channel closed under us
                completions.append((key, False))
                wake.set()
                return

            def _done(f, key=key):
                try:
                    f.result()
                    completions.append((key, True))
                except Exception:  # noqa: BLE001 - any failure is a miss
                    completions.append((key, False))
                wake.set()

            fut.add_done_callback(_done)

        while not self._hb_stop.is_set():
            now = time.monotonic()
            members = self._members()
            stub_by_key = dict(members)
            fresh = [k for k, _ in members if k not in scheduled]
            for i, key in enumerate(fresh):
                scheduled.add(key)
                wheel.watch(now + interval_s * (i + 1) / (len(fresh) + 1),
                            lambda key=key: _fire(key))
            while completions:
                key, ok = completions.popleft()
                in_flight.discard(key)
                with self._members_lock:
                    still_member = key in self._workers
                if not still_member:
                    scheduled.discard(key)
                    tracker.record_ok(key)  # drop a departed member's count
                    continue
                if ok:
                    tracker.record_ok(key)
                else:
                    n, evict = tracker.record_failure(key)
                    self.log.warning("heartbeat miss %d/%d for %s:%d", n, max_failures, *key)
                    if evict:
                        self.log.warning("worker %s:%d declared dead", *key)
                        self.unregister_worker(*key, evicted=True)
                        scheduled.discard(key)
                        continue
                wheel.watch(time.monotonic() + interval_s, lambda key=key: _fire(key))
            pending = deferred + [due_ready.popleft() for _ in range(len(due_ready))]
            deferred = []
            for key in pending:
                stub = stub_by_key.get(key)
                if stub is None or key not in scheduled:
                    # a departed member: a later registration on the same
                    # endpoint starts with no misses
                    scheduled.discard(key)
                    tracker.record_ok(key)
                    continue
                if len(in_flight) >= self.HB_PROBE_POOL:
                    deferred.append(key)
                    continue
                _probe(key, stub)
            wake.wait(timeout=min(interval_s, 0.5) if deferred else interval_s)
            wake.clear()

    def stop(self) -> None:
        self._hb_stop.set()
        self._hb_wake.set()
        self._async_running.clear()
        self._async_done.set()
        self._close_streams()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
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
        current membership, so an eviction or a leave frees a slot, and a
        running fit absorbs a new member at its next window (sync) or tick
        (elastic async).  A new member is introduced to every other member
        and they to it.  A member that registers again (a lost reply's
        retry, or a process restarted on the same endpoint) is re-introduced
        to its peers, and during an async fit re-kicked with a fresh
        StartAsync: the restarted process passes every heartbeat, so
        nothing else would re-issue its slice."""
        key = (host, port)
        rereg_stub = None
        with self._members_lock:
            if key in self._workers:
                if self._async_running.is_set():
                    self._rereg_pending.add(key)
                rereg_stub = self._workers[key]
                rereg_others = [k for k in self._workers if k != key]
            elif len(self._workers) >= self.expected_workers:
                raise ValueError("cluster already at expected node count")
            else:
                others = list(self._workers.keys())
                ch = new_channel(host, port, origin=(self.host, self.port))
                stub = WorkerStub(ch)
                self._workers[key] = stub
                self._channels[key] = ch
                self._order.append(key)
                count = len(self._workers)
        if rereg_stub is not None:
            # a restarted process starts with no peers; add_peer is
            # idempotent, so a live worker's retry costs a no-op fan-out
            for oh, op in rereg_others:
                try:
                    self.rpc_policy.call_with_retry(
                        rereg_stub.RegisterSlave, pb.Node(host=oh, port=op),
                        peer=key, retries=1)
                except (grpc.RpcError, ValueError) as e:
                    self.log.warning("peer re-introduction failed for %s:%d (%s)", oh, op,
                                     e.code() if isinstance(e, grpc.RpcError) else "closed")
            return
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
            except (grpc.RpcError, KeyError, ValueError) as e:
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
        # the departed worker's stream closes with its membership, and its
        # UNIMPLEMENTED mark clears
        with self._streams_lock:
            stream = self._streams.pop(key, None)
            self._stream_unsupported.discard(key)
        if stream is not None:
            stream.close()
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

    # -- the streaming fan-out (DSGD_STREAM) ---------------------------------

    def _grad_stream(self, key, stub):
        """The live FitStream client for `key`, opened lazily; None (the
        window goes unary) when the peer answered UNIMPLEMENTED before,
        when its breaker suppresses (each teardown fed it a failure), or
        when it is no member any more."""
        s = self._streams.get(key)
        if s is not None and s.usable:
            return s
        from distributed_sgd_tpu_torch.rpc.stream import FitStreamClient

        with self._streams_lock:
            if key in self._stream_unsupported:
                return None
            s = self._streams.get(key)
            if s is not None:
                if s.usable:
                    return s
                if s.unsupported:
                    self._stream_unsupported.add(key)
                    return None
                self._streams.pop(key, None)  # broken: replaced below
            breaker = self.rpc_policy.breaker(key)
            if breaker.suppressed():
                return None
            with self._members_lock:
                if key not in self._workers:
                    return None
            try:
                s = FitStreamClient(stub.FitStream, peer=f"{key[0]}:{key[1]}",
                                    metrics=self.metrics, log=self.log,
                                    on_break=breaker.record_failure)
            except Exception:  # noqa: BLE001 - the channel closed under us
                return None  # this window goes unary; the barrier classifies
            self._streams[key] = s
            return s

    def _close_streams(self) -> None:
        with self._streams_lock:
            streams, self._streams = dict(self._streams), {}
            for k, s in streams.items():
                if s.unsupported:
                    self._stream_unsupported.add(k)
        for s in streams.values():
            s.close()

    def _dispatch_gradient(self, key, stub, frame, req, timeout_s: float, use_stream: bool):
        """One worker's Gradient send for a window: a frame down its stream
        (which replays the request over unary with the deadline left, if
        the stream tears down), or the unary future.  None: the channel
        closed under us (the barrier classifies it)."""
        if use_stream and frame is not None:
            s = self._grad_stream(key, stub)
            if s is not None:
                fut = s.send(frame, timeout_s, unary_call=stub.Gradient, request=req)
                if fut is not None:
                    return fut
        try:
            return stub.Gradient.future(req, timeout=timeout_s)
        except ValueError:
            return None

    # -- distributed eval (Master.scala:61-98) -----------------------------

    def predict(self, weights: np.ndarray, split: SplitFn = vanilla_split,
                timeout_s: float = 60.0, retries: int = 1,
                return_margins: bool = False, quorum: Optional[int] = None,
                straggler_soft_s: Optional[float] = None):
        """Fan ForwardRequests out to every worker over the train split;
        gather predictions (and with `return_margins` the margins).  A
        worker that fails `retries + 1` times in a row is unregistered and
        the fan-out re-split over the survivors; RuntimeError when every
        worker is lost.

        With `quorum`, once `quorum` replies are in hand and the soft
        deadline (`straggler_soft_s`, or adaptive from the Forward latency
        EWMA) has passed, each missing worker's slice is sent again to the
        fastest responders.  Evaluation never drops a slice: the quorum
        only bounds how long a straggler holds the fan-out, and a slice no
        hedge covers goes to the retry and evict loop."""
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
                if quorum is None:
                    ok, failed = _await_futures(futs)
                else:
                    ok, failed = self._forward_quorum(
                        futs, members, part_by_key, quorum, straggler_soft_s, timeout_s,
                        wmsg, return_margins)
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

    def _forward_quorum(self, futs, members, part_by_key, quorum, straggler_soft_s,
                        timeout_s, wmsg, want_margins):
        """predict's quorum barrier with hedges.  Returns (ok, failed), each
        keyed by the SLICE's worker: a winning hedge's reply stands under
        the straggler's key, so the assembly and the failure tracker need
        not know who computed it."""
        quorum_n = min(quorum, len(members))
        soft_s = straggler_soft_s
        if soft_s is None:
            soft_s = self._fwd_latency.soft_deadline_s(part_by_key.keys(), quorum_n)
        soft_s = min(soft_s, timeout_s) if soft_s else timeout_s
        ok, failed, pending = _await_quorum(futs, quorum_n, time.monotonic() + soft_s,
                                            latency=self._fwd_latency)
        uncovered = [k for k, _ in pending] + [k for k, _ in failed]
        if uncovered and len(ok) >= quorum_n:
            stub_by_key = dict(members)
            donors = sorted((k for k, _ in ok),
                            key=lambda k: self._fwd_latency.p95_s(k) or float("inf"))
            hedges = []
            for i, skey in enumerate(uncovered):
                donor = donors[i % len(donors)]
                try:
                    hfut = stub_by_key[donor].Forward.future(
                        pb.ForwardRequest(samples=part_by_key[skey].astype(np.int32),
                                          weights=wmsg, want_margins=want_margins),
                        timeout=min(timeout_s, 2.0 * soft_s))
                except ValueError:
                    continue
                hedges.append((skey, hfut))
                self.metrics.counter(metrics_mod.QUORUM_HEDGES).increment()
                trace_mod.event(trace_mod.EVENT_QUORUM_HEDGE, straggler=f"{skey[0]}:{skey[1]}",
                                donor=f"{donor[0]}:{donor[1]}")
                self.log.info("hedging Forward slice of straggler %s:%d on %s:%d",
                              *skey, *donor)
            h_ok, _h_failed = _await_futures(hedges)
            still = []
            for key, fut in pending:  # a late original is preferred
                if not fut.done():
                    still.append((key, fut))
                    continue
                try:
                    ok.append((key, fut.result()))
                except grpc.RpcError as e:
                    failed.append((key, e.code()))
            pending = still
            covered = {k for k, _ in ok}
            for skey, reply in h_ok:
                if skey not in covered:
                    ok.append((skey, reply))
                    covered.add(skey)
                    self.metrics.counter(metrics_mod.QUORUM_HEDGE_WINS).increment()
        elif pending:
            # below quorum: the classic barrier, to the hard deadline
            ok2, failed2, _ = _await_quorum(pending, len(pending) + 1,
                                            time.monotonic() + timeout_s + 5.0,
                                            latency=self._fwd_latency)
            ok.extend(ok2)
            failed.extend(failed2)
            pending = []
        covered = {k for k, _ in ok}
        # a slice no reply covers joins the retry and evict loop
        failed = [(k, c) for k, c in failed if k not in covered]
        for key, _fut in pending:
            if key not in covered:
                failed.append((key, grpc.StatusCode.DEADLINE_EXCEEDED))
        return ok, failed

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

        The pipelined levers, each off by default (then the wire and the
        weights are the unpipelined fit's, byte for byte):

        - `delta_broadcast` (DSGD_DELTA_BROADCAST): versioned broadcasts;
          the workers keep the last weights, and the master sends only the
          changed coordinates' new values (or nothing on a retry), a full
          tensor to a (re)joined or stale worker, after a resplit, or when
          the update is denser than the break-even;
        - `local_steps` K > 1 (DSGD_LOCAL_STEPS): each worker runs K plain
          SGD steps over K batches of its partition a round and replies
          the decrement; the master applies the mean decrement (``w -
          mean`` for sgd, the optimizer on ``mean / lr`` otherwise): K
          times fewer rounds an epoch;
        - `stream` (DSGD_STREAM): each window's requests ride one
          persistent FitStream a worker, with the next window's requests
          built by the encode-ahead thread during the barrier; a broken
          stream replays its window over unary, an UNIMPLEMENTED peer
          stays unary, and hedges are always unary;
        - `fanin_lanes` K (DSGD_FANIN_LANES): each reply is parsed in its
          own arrival callback, off the decoder's lock, and summed in
          send order: the weights are the lane-free fit's bit for bit.  The
          count is pinned for the fit (None: `self.fanin_lanes`);
        - `stage_pool` P (DSGD_STAGE_POOL): the next round's sample draws
          (one task, the serial order, the generator restored on any
          discard) and request builds run on a P-thread pool during the
          barrier (None: `self.stage_pool`).

        Quorum barrier (`quorum=Q`, DSGD_QUORUM): a window closes when
        every reply has landed, or when the soft deadline
        (`straggler_soft_s`, or adaptive from each worker's reply-latency
        EWMA) has passed with Q replies in hand.  Each missing worker's
        slice is then hedged to the fastest responders (`hedge`), a
        straggler's own reply is preferred if it lands meanwhile, the
        contributions are summed in canonical slice order (so a round with
        every reply equals the plain barrier bit for bit) and divided by
        their count, and each worker whose reply went unused gets
        ``ef_rollback_version`` on its next request.  A slow worker is
        never counted as failed; below quorum the window runs the full
        barrier with retry and evict.  A quorum stamps `step_version` on
        the plain wire.  `straggler_soft_s` without a quorum only counts
        the windows that overran it (`master.sync.barrier.stalled`).

        Crash-safe fit state (`fit_state_path` with `fit_state_every=R`,
        DSGD_FIT_CKPT_EVERY): every R applied windows the loop's whole
        state (weights, optimizer leaves, epoch and window cursor, the
        sample generator's state as a serial run holds it, the
        early-stopping history, the broadcast version, the fit-token
        lineage) is written atomically, and once more at the end.  A new
        master that finds it resumes from it bit for bit, unless the epoch
        checkpoint is newer; a finished snapshot runs nothing.  Snapshots
        do not change the result.

        The JAX fit_sync's health monitor, aggregation tree and sharded
        master are not ported; a non-default value raises
        NotImplementedError (ROADMAP.md Queue A [A13] item 8)."""
        levers = (
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
        if quorum is not None and int(quorum) < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        quorum = int(quorum) if quorum is not None else None
        if straggler_soft_s is not None and straggler_soft_s <= 0:
            raise ValueError(f"straggler_soft_s must be > 0, got {straggler_soft_s}")
        local_steps = max(1, int(local_steps))
        # the lane count is pinned for the fit: every attempt of a window
        # must walk the same cursor layout
        lanes = max(0, int(self.fanin_lanes if fanin_lanes is None else fanin_lanes))
        pool_n = int(self.stage_pool if stage_pool is None else stage_pool)
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
        self._fit_seq += 1
        fit_token = self._fit_token_base + self._fit_seq
        window_span = batch_size * local_steps
        # ef_rollback[worker]: the version whose reply the quorum discarded,
        # sent with that worker's next request
        ef_rollback: Dict[Tuple[str, int], int] = {}
        grad_acc = np.zeros(self.model.n_features, dtype=np.float32)
        m = self.metrics
        grad_bytes = m.counter(metrics_mod.SYNC_GRAD_BYTES)
        rounds = m.counter(metrics_mod.SYNC_ROUNDS)
        stalled = m.counter(metrics_mod.SYNC_STALLED)
        fanin_parsed = m.counter(metrics_mod.FANIN_PARSED) if lanes else None
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

        # the window-cadence snapshot outranks the epoch checkpoint unless
        # that one is newer (fit_state_every past an epoch's windows)
        resume_batch = 0
        resume_rng_state = None
        resume_version = 0
        fit_tokens = [fit_token]
        fit_state_every = max(0, int(fit_state_every))
        fs = restore_fit_state(fit_state_path, opt_kind, leaves()) if fit_state_path else None
        if fs is not None and fs.epoch < start_epoch:
            self.log.info("fit-state snapshot at epoch %d is older than the epoch checkpoint "
                          "at %d: ignoring it", fs.epoch, start_epoch)
            fs = None
        if fs is not None:
            start_epoch, resume_batch, resume_rng_state = fs.epoch, fs.batch, fs.rng_state
            w = np.asarray(fs.weights, dtype=np.float32)
            test_newest_first = list(fs.test_losses_nf)
            if fs.opt_leaves:
                opt_state = opt_state_from_jax(fs.opt_leaves, opt.kind, self.model.n_features,
                                               self.device)
            resume_version = int(fs.bcast_version)
            fit_tokens = fs.fit_tokens + [fit_token]
            self.log.info("resumed crash-safe fit state at epoch %d window cursor %d "
                          "(fit lineage: %d token(s))", start_epoch, resume_batch,
                          len(fit_tokens))
        if start_epoch >= max_epochs or (fs is not None and fs.finished):
            # the budget is spent, or the snapshot is a converged fit's
            # terminal one: resuming would train past convergence
            loss, acc = self.local_loss(w)
            self.log.info("fit state already %s at epoch %d (max_epochs %d): nothing to run "
                          "(loss=%.6f acc=%.4f)",
                          "finished" if (fs is not None and fs.finished) else "complete",
                          start_epoch, max_epochs, loss, acc)
            result.epochs_run = start_epoch
            result.state = GradState(weights=w, loss=loss).finish()
            return result

        stager = _DispatchStager(pool_n) if pool_n > 0 else None
        # a quorum stamps the version on the plain wire too: the EF
        # rollback keys on it
        bcast = _BroadcastState(delta_broadcast, m, versioned=quorum is not None,
                                stage_pool=stager.pool if stager else None)
        if bcast.versioned and resume_version > 0:
            # never reuse a version the long-lived workers have seen
            bcast.version = resume_version
        use_stream = bool(stream)
        if use_stream or stager is not None:
            # from the first advance() on, the encoder thread builds each
            # worker's next request (a Frame for the stream, a
            # GradientRequest otherwise) while this window's replies fly
            bcast.stage_for(keys, fit_token, local_steps, batch_size, learning_rate,
                            frames=use_stream)

        def serial_rng_state(rng):
            # the generator's state as a serial run holds it: the stage's
            # base while a pre-draw is pending
            return stager.rng_state(rng) if stager is not None else rng.bit_generator.state

        rounds_since_save = 0
        stopped_early = False
        try:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.perf_counter()
                batch = 0
                # keyed by absolute epoch: a resumed run draws the same stream
                rng = np.random.default_rng((self.seed, epoch))
                if resume_rng_state is not None:
                    # a crash-safe resume lands mid-epoch: the generator's
                    # state and the window cursor of the snapshot
                    rng.bit_generator.state = resume_rng_state
                    batch = resume_batch
                    resume_rng_state = None
                while batch < max_samples:
                    live_lanes = self.fanin_lanes if fanin_lanes is None else fanin_lanes
                    if max(0, int(live_lanes)) != lanes:
                        raise RuntimeError(f"fan-in lane count changed mid-fit ({lanes} -> "
                                           f"{live_lanes}): it is pinned at fit start")
                    # live membership: an unregistration reaches the loop here
                    current = self._members()
                    if [k for k, _ in current] != keys:
                        if not current:
                            raise RuntimeError("all workers lost mid-fit")
                        if stager is not None:
                            # the pre-draw was for the old partitions: drop
                            # it and rewind the generator
                            stager.discard(rng)
                        members, keys = current, [k for k, _ in current]
                        parts = split(len(self.train), len(members))
                        max_samples = max(len(p) for p in parts)
                        bcast.forget_missing(keys)  # a rejoin starts from full weights
                        if use_stream or stager is not None:
                            bcast.stage_for(keys, fit_token, local_steps, batch_size,
                                            learning_rate, frames=use_stream)
                        m.counter(metrics_mod.SYNC_RESPLITS).increment()
                        flight.record("sync.resplit", members=len(members))
                        self.log.warning("membership changed; re-split across %d workers",
                                         len(members))
                        if batch >= max_samples:
                            break
                    t_batch = time.perf_counter()
                    # one trace per fan-out window: the Gradient calls (hedges
                    # included) become client/server child spans through
                    # rpc/service.py's hooks
                    wspan = trace_mod.root_span(trace_mod.SPAN_SYNC_WINDOW, node="master",
                                                epoch=epoch, batch=int(batch),
                                                version=bcast.version)
                    with wspan:
                        futs = []
                        ids_by_key: Dict[Tuple[str, int], np.ndarray] = {}
                        rb_sent: Dict[Tuple[str, int], int] = {}
                        # with fan-in lanes each reply is parsed as it
                        # arrives: the full barrier also sums it then, in
                        # send order; a quorum's contributors are known only
                        # at round close.  Without lanes every reply is
                        # decoded after the barrier
                        decoder = None
                        if lanes:
                            grad_acc.fill(0.0)
                            decoder = _ArrivalDecoder(grad_acc, lanes=lanes,
                                                      defer=quorum is not None)
                        staged_ids = (stager.take(rng, keys, epoch, batch)
                                      if stager is not None else None)
                        for (key, stub), part in zip(members, parts):
                            ids = (staged_ids[key] if staged_ids is not None
                                   else _draw_ids(rng, part, batch, window_span))
                            ids_by_key[key] = ids
                            frame = req = None
                            if use_stream:
                                frame = bcast.take_staged_frame(key)
                                if frame is not None:
                                    req = frame.request
                            elif stager is not None:
                                req = bcast.take_staged_request(key)
                            if req is not None:
                                req.samples.extend(ids.astype(np.int32))
                            else:
                                if use_stream:
                                    frame = pb.Frame()
                                    req = frame.request
                                    req.samples.extend(ids.astype(np.int32))
                                    req.fit_token = fit_token
                                else:
                                    req = pb.GradientRequest(samples=ids.astype(np.int32),
                                                             fit_token=fit_token)
                                if local_steps > 1:
                                    req.local_steps = local_steps
                                    req.batch_size = batch_size
                                    req.learning_rate = learning_rate
                                bcast.populate(req, key, w)
                            rb = ef_rollback.pop(key, None)
                            if rb is not None:
                                req.ef_rollback_version = rb
                                rb_sent[key] = rb  # re-armed if this request fails
                            fut = self._dispatch_gradient(key, stub, frame, req,
                                                          grad_timeout_s, use_stream)
                            futs.append((key, fut))
                            if decoder is not None:
                                decoder.watch(len(futs) - 1, fut)
                        if stager is not None and batch + window_span < max_samples:
                            # the next round's draws run on the pool while
                            # this round's replies fly (an epoch's last round
                            # stages nothing: the next epoch re-keys)
                            stager.stage(rng, keys, parts, epoch, batch + window_span,
                                         window_span)
                        t_sent = time.perf_counter()
                        if quorum is None:
                            ok, failed = _await_futures(futs, bytes_counter=grad_bytes)
                            if decoder is not None:
                                decoder.finish(futs)
                            good, stale = [], []
                            for key, reply in ok:
                                (stale if reply.stale_version else good).append((key, reply))
                            replies = [r for _, r in good]
                            satisfied = False
                            # pure observation: how often a quorum would have
                            # had to step in
                            if (straggler_soft_s is not None
                                    and time.perf_counter() - t_batch > straggler_soft_s):
                                stalled.increment()
                        else:
                            replies, good, stale, failed, satisfied = self._quorum_barrier(
                                futs, members, ids_by_key, quorum, straggler_soft_s,
                                grad_timeout_s, fit_token, local_steps, batch_size,
                                learning_rate, bcast, w, hedge, ef_rollback, grad_bytes,
                                rb_sent)
                            if not satisfied:
                                flight.record("quorum.below", epoch=epoch, batch=int(batch),
                                              version=bcast.version, got=len(good),
                                              quorum=min(quorum, len(members)))
                                flight.dump("below_quorum", min_interval_s=10.0)
                        t_replies = time.perf_counter()
                        phase_s[SYNC_FANOUT_SECONDS].record(t_sent - t_batch)
                        phase_s[SYNC_BARRIER_SECONDS].record(t_replies - t_sent)
                        rounds.increment()
                        for key, _ in good:
                            tracker.record_ok(key)
                            bcast.note_ok(key)
                        for key, _ in stale:
                            # a stale reply is a live worker whose replica
                            # missed a version: a full broadcast on the retry
                            tracker.record_ok(key)
                            bcast.note_stale(key)
                            m.counter(metrics_mod.SYNC_STALE).increment()
                            trace_mod.event(trace_mod.EVENT_BCAST_STALE,
                                            worker=f"{key[0]}:{key[1]}")
                            self.log.warning("worker %s:%d replica stale at v%d; falling back "
                                             "to full broadcast", key[0], key[1],
                                             bcast.version)
                        if not satisfied:
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
                                    "worker %s:%d failed Gradient %d times (%s); declaring "
                                    "dead", key[0], key[1], n, code)
                                self.unregister_worker(*key, evicted=True)
                            if failed or stale:
                                wspan.set(retry=True)
                                continue  # retry this window (survivors or re-split)
                        # the replies summed in send order (a quorum's in
                        # canonical slice order), then one true divide:
                        # bit-matching np.mean over the decoded replies.  With
                        # lanes the full barrier summed them as they arrived.
                        if decoder is not None:
                            # exact once the window closed (a callback may
                            # still be counting `parsed`)
                            fanin_parsed.increment(decoder.reused if decoder.defer
                                                   else decoder.decoded)
                        if decoder is not None and decoder.defer:
                            grad_acc.fill(0.0)
                            for reply in replies:
                                decoder.add_into(reply, grad_acc)
                        elif decoder is None or decoder.decoded != len(replies):
                            grad_acc.fill(0.0)
                            for reply in replies:
                                codec.decode_grad_into(reply, grad_acc)
                        grad_acc /= len(replies)
                        t_decoded = time.perf_counter()
                        w_old = w
                        if local_steps > 1 and opt.kind == "sgd":
                            # the mean decrement, applied as it is
                            w = w - grad_acc
                        elif local_steps > 1:
                            # the optimizer takes the pseudo-gradient
                            # mean / lr, divided in f32
                            w, opt_state = self._apply_update(
                                w, grad_acc / np.float32(learning_rate), learning_rate, opt,
                                opt_state)
                        elif opt.kind == "sgd":
                            w = w - learning_rate * grad_acc  # Master.scala:197
                        else:
                            w, opt_state = self._apply_update(w, grad_acc, learning_rate, opt,
                                                              opt_state)
                        bcast.advance(w, w_old)
                        t_applied = time.perf_counter()
                        phase_s[SYNC_DECODE_SECONDS].record(t_decoded - t_replies)
                        phase_s[SYNC_APPLY_SECONDS].record(t_applied - t_decoded)
                        m.histogram("master.sync.batch.duration").record(t_applied - t_batch)
                        batch += window_span
                        rounds_since_save += 1
                        if (fit_state_path and fit_state_every
                                and rounds_since_save >= fit_state_every):
                            # the cursor points past the applied window and
                            # the generator's state is what the next window
                            # draws from
                            save_fit_state(
                                fit_state_path, weights=w, epoch=epoch, batch=batch,
                                rng_state=serial_rng_state(rng),
                                test_losses_nf=test_newest_first, opt_kind=opt_kind,
                                opt_leaves=leaves(), bcast_version=bcast.version,
                                fit_tokens=fit_tokens)
                            rounds_since_save = 0
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
                    stopped_early = True
                    break
        finally:
            # the streams and the stage pool are the fit's
            if use_stream:
                self._close_streams()
            if stager is not None:
                stager.close()
                m.counter(metrics_mod.STAGE_HITS).increment(stager.hits)
                m.counter(metrics_mod.STAGE_DISCARDS).increment(stager.discards)

        save_sync_fit_final(checkpointer, result.epochs_run, start_epoch, checkpoint_every,
                            w, test_newest_first, opt_kind, leaves())
        if fit_state_path and fit_state_every:
            # the terminal snapshot: `finished` marks a converged fit; a
            # spent budget is not marked (the cursor says it), so a raised
            # max_epochs resumes
            save_fit_state(
                fit_state_path, weights=w, epoch=result.epochs_run, batch=0,
                rng_state=np.random.default_rng(
                    (self.seed, result.epochs_run)).bit_generator.state,
                test_losses_nf=test_newest_first, opt_kind=opt_kind, opt_leaves=leaves(),
                bcast_version=bcast.version, fit_tokens=fit_tokens, finished=stopped_early)
        result.state = GradState(
            weights=w, loss=result.losses[-1] if result.losses else float("nan")).finish()
        return result

    def _apply_update(self, w: np.ndarray, g: np.ndarray, learning_rate: float, opt,
                      opt_state):
        """(w, the optimizer's state) after the update of host weights `w`
        by the mean gradient `g`, on the master's device."""
        wt, opt_state = apply_update(torch.from_numpy(w).to(self.device),
                                     torch.from_numpy(g).to(self.device),
                                     learning_rate, opt, opt_state)
        return wt.cpu().numpy(), opt_state

    def _quorum_barrier(self, futs, members, ids_by_key, quorum, straggler_soft_s,
                        grad_timeout_s, fit_token, local_steps, batch_size, learning_rate,
                        bcast, w, hedge, ef_rollback, grad_bytes, rb_sent):
        """One window's quorum barrier with straggler hedges.  Returns
        (replies, good, stale, failed, satisfied):

        - satisfied: the round closes now with `replies` (at least the
          quorum), in canonical slice order; `good` lists the workers whose
          own reply was used.  Each fanned-out worker whose own reply was
          not used is marked in `ef_rollback`, its late reply is counted
          and dropped, and no failure is recorded: slow is not dead.  A
          stale reply's slice is hedged like a missing one.
        - not satisfied: below quorum at the soft deadline, everything was
          awaited to the hard deadline, and the caller runs the full
          barrier's failure, stale and retry path over (good, stale,
          failed)."""
        quorum_n = min(quorum, len(members))
        soft_s = straggler_soft_s
        if soft_s is None:
            # adaptive; until the EWMA has history the window is a full
            # barrier, which seeds it
            soft_s = self._latency.soft_deadline_s(ids_by_key.keys(), quorum_n)
        soft_s = min(soft_s, grad_timeout_s) if soft_s else grad_timeout_s
        t0 = time.monotonic()
        ok, failed, pending = _await_quorum(futs, quorum_n, t0 + soft_s,
                                            bytes_counter=grad_bytes, latency=self._latency)
        # a stalled round: the barrier overran the soft deadline because
        # the quorum was not in hand when it fired
        if time.monotonic() - t0 > soft_s + max(0.05, 0.25 * soft_s):
            self.metrics.counter(metrics_mod.SYNC_STALLED).increment()
            trace_mod.event(trace_mod.EVENT_BARRIER_STALLED, soft_s=round(soft_s, 4),
                            got=len(ok))
            flight.record("barrier.stalled", soft_s=round(soft_s, 4), got=len(ok),
                          quorum=quorum_n)
        good, stale = [], []
        for key, reply in ok:
            (stale if reply.stale_version else good).append((key, reply))
        uncovered = [k for k, _ in pending] + [k for k, _ in failed] + [k for k, _ in stale]
        h_ok = []
        if uncovered and len(good) >= quorum_n and hedge and good:
            # each missing slice to the fastest responders: the straggler's
            # drawn ids again, with this window's weights (header-only under
            # delta broadcast: the donor just proved this version)
            donors = sorted((k for k, _ in good),
                            key=lambda k: self._latency.p95_s(k) or float("inf"))
            stub_by_key = dict(members)
            hedge_deadline = min(grad_timeout_s, 2.0 * soft_s)
            hedge_futs = []
            for i, skey in enumerate(uncovered):
                donor = donors[i % len(donors)]
                hreq = pb.GradientRequest(samples=ids_by_key[skey].astype(np.int32),
                                          fit_token=fit_token, hedge=True)
                if local_steps > 1:
                    hreq.local_steps = local_steps
                    hreq.batch_size = batch_size
                    hreq.learning_rate = learning_rate
                bcast.note_ok(donor)  # its own reply proved this version
                bcast.populate(hreq, donor, w)
                try:
                    hfut = stub_by_key[donor].Gradient.future(hreq, timeout=hedge_deadline)
                except ValueError:
                    continue
                hedge_futs.append((skey, hfut))
                self.metrics.counter(metrics_mod.QUORUM_HEDGES).increment()
                trace_mod.event(trace_mod.EVENT_QUORUM_HEDGE, straggler=f"{skey[0]}:{skey[1]}",
                                donor=f"{donor[0]}:{donor[1]}")
                flight.record("quorum.hedge", straggler=f"{skey[0]}:{skey[1]}",
                              donor=f"{donor[0]}:{donor[1]}")
                self.log.info("hedging slice of straggler %s:%d on %s:%d", *skey, *donor)
            h_ok, _h_failed = _await_futures(hedge_futs, bytes_counter=grad_bytes)

        # originals that landed while the hedges ran: a straggler's own
        # reply is preferred over its hedge
        still_pending = []
        for key, fut in pending:
            if not fut.done():
                still_pending.append((key, fut))
                continue
            try:
                reply = fut.result()
                grad_bytes.increment(reply.ByteSize())
                self._latency.record(key, soft_s)  # at least the soft window
                (stale if reply.stale_version else good).append((key, reply))
            except grpc.RpcError as e:
                failed.append((key, e.code()))

        own = {k for k, _ in good}
        hedge_wins = [(skey, r) for skey, r in h_ok if skey not in own and not r.stale_version]
        # canonical slice order, whatever the arrival order: a round with
        # every reply in hand equals the plain barrier bit for bit
        order = {key: i for i, key in enumerate(ids_by_key)}
        good.sort(key=lambda kr: order[kr[0]])
        replies = [r for _, r in sorted(good + hedge_wins, key=lambda kr: order[kr[0]])]
        reply_weight = sum(_reply_weight(r) for r in replies)
        if reply_weight >= quorum_n:
            if len(good) < len(ids_by_key):
                self.metrics.counter(metrics_mod.QUORUM_DEGRADED).increment()
                missing = [f"{k[0]}:{k[1]}" for k in ids_by_key if k not in own]
                trace_mod.event(trace_mod.EVENT_QUORUM_DEGRADED, contributors=reply_weight,
                                missing=missing)
                flight.record("quorum.degraded", contributors=reply_weight, missing=missing)
            for skey, _ in hedge_wins:
                self.metrics.counter(metrics_mod.QUORUM_HEDGE_WINS).increment()
                trace_mod.event(trace_mod.EVENT_QUORUM_HEDGE_WIN,
                                straggler=f"{skey[0]}:{skey[1]}")
            # every worker whose own reply went unused rolls its EF drain
            # back on its next request; a request that failed outright may
            # never have been processed, so its old marker is re-armed
            late_counter = self.metrics.counter(metrics_mod.QUORUM_LATE)
            failed_keys = {k for k, _ in failed}
            for key in ids_by_key:
                if key not in own:
                    if key in failed_keys and key in rb_sent:
                        ef_rollback[key] = rb_sent[key]
                    else:
                        ef_rollback[key] = bcast.version
            # the late settle runs on a gRPC thread after this window's
            # span closed: capture the window's context now
            w_ctx = trace_mod.current()
            for key, fut in still_pending:
                def _count_late(f, _c=late_counter, _k=key):
                    if not f.cancelled():
                        _c.increment()
                        trace_mod.event_in(w_ctx, trace_mod.EVENT_QUORUM_LATE, node="master",
                                           worker=f"{_k[0]}:{_k[1]}")
                        flight.record("quorum.late", worker=f"{_k[0]}:{_k[1]}")
                fut.add_done_callback(_count_late)
            return replies, good, stale, [], True

        # below quorum: the full barrier, to the hard deadline; hedge
        # replies are dropped and the fan-out's order kept
        if still_pending:
            ok2, failed2, _ = _await_quorum(still_pending, len(still_pending) + 1,
                                            time.monotonic() + grad_timeout_s + 5.0,
                                            bytes_counter=grad_bytes, latency=self._latency)
            for key, reply in ok2:
                (stale if reply.stale_version else good).append((key, reply))
            failed.extend(failed2)
        good.sort(key=lambda kr: order[kr[0]])
        own = {k for k, _ in good}
        for key, rb in rb_sent.items():
            if key not in own:
                ef_rollback.setdefault(key, rb)
        return [r for _, r in good], good, stale, failed, False

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
        counted.

        `elastic` (DSGD_ELASTIC): each tick compares the members with the
        assignments, and on any change (a join, a leave, an eviction)
        re-splits the rows over the members in registration order with
        `split` and re-issues StartAsync, with the current weights, only
        to the workers whose slice changed; the others train on.  Without
        it a departed worker's rows go to a survivor and a join waits for
        the next fit.  Either way a member that registered again is
        re-kicked with its slice.

        Returns the BEST weights (MasterAsync.scala:87-94) as a host array."""
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
        with self._members_lock:
            self._rereg_pending.clear()  # a prior fit's kicks
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
                # membership reaches the fit here each tick: a worker that
                # left has its rows re-issued at once, and with `elastic` a
                # join or a leave re-splits
                with self._members_lock:
                    member_order = list(self._order)
                if elastic:
                    if set(member_order) != set(assignments):
                        self._elastic_resplit(assignments, member_order, w_now, batch_size,
                                              learning_rate, optimizer, momentum, split,
                                              ever_assigned)
                else:
                    gone = [k for k in assignments if k not in set(member_order)]
                    if gone:
                        self.log.warning("async fit: %d assigned worker(s) no longer "
                                         "members; reassigning", len(gone))
                        self._reassign_async(assignments, gone, w_now, batch_size,
                                             learning_rate, optimizer, momentum)
                # a member that registered again shows no membership change
                with self._members_lock:
                    rejoined = [k for k in self._rereg_pending if k in assignments]
                    self._rereg_pending.clear()
                for key in rejoined:
                    self.log.warning("async fit: %s:%d re-registered while assigned; "
                                     "re-issuing its StartAsync", key[0], key[1])
                    self._try_start_async_worker(key, assignments[key], w_now, batch_size,
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

    def _elastic_resplit(self, assignments, member_order, w_now, batch_size, learning_rate,
                         optimizer, momentum, split, ever_assigned) -> None:
        """An elastic membership change: re-split the rows over the current
        members with `split`, in registration order (any master looking at
        the same members derives the same slices), and re-issue StartAsync
        with the current weights only to the workers whose slice changed.
        A departed worker drops out of the assignments; its peers dropped
        it when the unregistration was broadcast."""
        if not member_order:
            raise RuntimeError("async fit: all workers lost mid-fit")
        parts = split(len(self.train), len(member_order))
        new_assign = dict(zip(member_order, parts))
        changed = [key for key in member_order
                   if key not in assignments
                   or not np.array_equal(assignments[key], new_assign[key])]
        joined = [key for key in member_order if key not in assignments]
        departed = [key for key in assignments if key not in new_assign]
        assignments.clear()
        assignments.update(new_assign)
        ever_assigned.update(member_order)
        self.metrics.counter(metrics_mod.ASYNC_RESPLITS).increment()
        flight.record("async.resplit", members=len(member_order), joined=len(joined),
                      departed=len(departed), reissued=len(changed))
        self.log.warning("elastic resplit across %d member(s): %d joined, %d departed, "
                         "%d assignment(s) re-issued", len(member_order), len(joined),
                         len(departed), len(changed))
        for key in changed:
            self._try_start_async_worker(key, assignments[key], w_now, batch_size,
                                         learning_rate, optimizer, momentum)

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
