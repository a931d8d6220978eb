"""The master's shard lanes; the port of the JAX package's
shardedps/coordinator.py.

Knobs off, the sync fit sends the whole weight vector to N workers and
decodes N whole gradients through one master.  ``ShardedCoordinator``
range-partitions that traffic across M lanes (shardedps/plan.py): each
lane has its own versioned broadcast state over its slice (the master's
``_BroadcastState``, so delta broadcasts compose lane by lane), its own
shard-colored reduce tree under DSGD_AGG_TREE (the tree seed offset by the
lane index, so lanes elect different aggregators), and its own byte
ledger (``bytes_by_lane``).

Correctness is commutativity: SGD applies ``w -= lr * mean(g)``
coordinate by coordinate, so range-disjoint slices summed in the same
worker order and divided once land on the flat fit's weights bit for
bit.  A worker is good for a round only if every lane's leg succeeded;
any stale or failed leg degrades it as the flat fit would, once a round
(M failed legs are ONE failure, never M).

``kill(i)`` (``MasterNode.kill_shard``) marks lane i dead.  The next
window is ONE flat single-master round (untagged full-weight requests,
the workers' flat path), then the plan rebuilds over the surviving lanes
before the window after it: no live worker is evicted for a master-side
death.  With every lane dead the fit goes on flat.

Built only by ``MasterNode.fit_sync`` when the knob is on.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import grpc
import numpy as np

from distributed_sgd_tpu_torch.core.master import MasterNode, _BroadcastState
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.shardedps.plan import build_shard_plan
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod


class ShardLane:
    """One master shard: a contiguous feature range, its broadcast state
    over the slice, its shard-colored tree and its byte ledger."""

    def __init__(self, index: int, lo: int, hi: int, delta_broadcast: bool, metrics):
        self.index = int(index)
        self.lo = int(lo)
        self.hi = int(hi)
        # no encoder thread a lane: a dim/M slice's encode is short
        self.bcast = _BroadcastState(delta_broadcast, metrics, encode_ahead=False)
        self.tree_plan = None
        self.bcast_bytes = 0
        self.grad_bytes = 0


class ShardedCoordinator:
    """A fit's shard fan-out and fan-in, called from fit_sync at its
    hooks (plan build, membership rebuild, dispatch, collect, accumulate,
    advance); registration, liveness and resplits stay the master's."""

    def __init__(self, master, shards: int, dim: int, keys, delta_broadcast: bool,
                 tree_fanout: int):
        self.master = master
        self.metrics = master.metrics
        self.log = master.log
        self.dim = int(dim)
        self.delta_broadcast = bool(delta_broadcast)
        self.tree_fanout = int(tree_fanout or 0)
        self.plan = build_shard_plan(self.dim, shards)
        self._keys = list(keys)
        self._lanes: List[ShardLane] = []
        # kill() may land from any thread mid-round; the fit's thread takes
        # it in at the next dispatch
        self._kill_lock = threading.Lock()
        self._killed: set = set()
        self._permanent_flat = False
        self._flat_round = False
        # the round in flight: ("sharded" | "flat", [(key, lane | None, future)])
        self._round: Optional[Tuple[str, list]] = None
        self._collected: List[tuple] = []
        self._bcast_total = self.metrics.counter(metrics_mod.SHARD_BCAST_BYTES)
        self._grad_total = self.metrics.counter(metrics_mod.SHARD_GRAD_BYTES)
        self._build_lanes()
        flight.record("shard.plan", shards=self.plan.shards, dim=self.dim,
                      digest=self.plan.digest()[:12])
        self.log.info("sharded master plane: %r", self.plan)

    # -- the plan and the lanes ------------------------------------------------

    def _build_lanes(self) -> None:
        self._lanes = [ShardLane(i, lo, hi, self.delta_broadcast, self.metrics)
                       for i, (lo, hi) in enumerate(self.plan.ranges)]
        self.metrics.gauge(metrics_mod.SHARD_COUNT).set(len(self._lanes))
        if self.tree_fanout:
            self._build_lane_trees()

    def _build_lane_trees(self) -> None:
        """One reduce tree a lane, its seed offset by the lane index, so
        no one worker carries every shard's reduce."""
        from distributed_sgd_tpu_torch.aggtree import build_plan

        for lane in self._lanes:
            lane.tree_plan = build_plan(self._keys, self.tree_fanout,
                                        seed=self.master.seed + lane.index)

    def on_membership(self, keys) -> None:
        """fit_sync's membership hook, where the resplit and the flat tree
        rebuild run: the lanes' trees and version claims follow."""
        self._keys = list(keys)
        if self.tree_fanout:
            self._build_lane_trees()
        for lane in self._lanes:
            lane.bcast.forget_missing(keys)

    def kill(self, index: int) -> None:
        """Mark shard `index` dead, from any thread: the next dispatch
        falls back to one flat round, then the plan rebuilds."""
        with self._kill_lock:
            lanes = {lane.index for lane in self._lanes}
            if index not in lanes:
                raise ValueError(f"no live master shard {index} (live: {sorted(lanes)})")
            self._killed.add(int(index))
        self.log.warning("master shard %d killed; next window falls back to the flat "
                         "single-master plane", index)
        flight.record("shard.kill", shard=int(index))

    def bytes_by_lane(self) -> List[Tuple[int, int, int]]:
        """[(shard_index, broadcast bytes, gradient bytes)] of the live
        lanes: the per-process wire ledger."""
        return [(lane.index, lane.bcast_bytes, lane.grad_bytes) for lane in self._lanes]

    # -- a round's hooks -------------------------------------------------------

    def dispatch(self, members, ids_by_key, w: np.ndarray, fit_token: int,
                 grad_timeout_s: float, agg_round_seq: int) -> int:
        """Fan a window out: M tagged slice requests a worker, or ONE flat
        request a worker while a kill is taken in.  Returns the new
        agg_round_seq: a sharded round takes one tree round a lane, so a
        stale push from an abandoned attempt never aliases another lane's
        round."""
        with self._kill_lock:
            fallback = bool(self._killed) or self._permanent_flat
        if fallback:
            return self._dispatch_flat(members, ids_by_key, w, fit_token, grad_timeout_s,
                                       agg_round_seq)
        self._flat_round = False
        shard_round = int(agg_round_seq)
        futs = []
        for lane in self._lanes:
            w_slice = w[lane.lo:lane.hi]
            for key, stub in members:
                req = pb.GradientRequest(samples=ids_by_key[key].astype(np.int32),
                                         fit_token=fit_token)
                req.shard_index = lane.index
                req.shard_count = len(self._lanes)
                req.shard_lo = lane.lo
                req.shard_hi = lane.hi
                req.shard_round = shard_round
                form, nbytes = lane.bcast._attach_arm(req, key, w_slice)
                metrics_mod.record_broadcast(self.metrics, form, nbytes)
                self._bcast_total.increment(nbytes)
                lane.bcast_bytes += nbytes
                if lane.tree_plan is not None and not lane.tree_plan.trivial:
                    MasterNode._annotate_tree(req, key, lane.tree_plan,
                                              agg_round_seq + lane.index, grad_timeout_s)
                fut = self.master._dispatch_gradient(key, stub, None, req, grad_timeout_s,
                                                     False)
                futs.append((key, lane, fut))
        self._round = ("sharded", futs)
        return agg_round_seq + len(self._lanes) - 1

    def _dispatch_flat(self, members, ids_by_key, w, fit_token, grad_timeout_s,
                       agg_round_seq: int) -> int:
        """The degraded round: untagged full-weight requests; the workers
        take their flat path, so a shard's death costs this round's speed
        and never an eviction."""
        self._flat_round = True
        self.metrics.counter(metrics_mod.SHARD_FALLBACK_ROUNDS).increment()
        flight.record("shard.fallback", killed=sorted(self._killed),
                      permanent=self._permanent_flat)
        flight.dump("shard-kill", min_interval_s=10.0)
        full = codec.plan_weight_send(w).full()  # encoded once
        futs = []
        for key, stub in members:
            req = pb.GradientRequest(samples=ids_by_key[key].astype(np.int32),
                                     fit_token=fit_token)
            req.weights.CopyFrom(full)
            metrics_mod.record_broadcast(self.metrics, "full", full.ByteSize())
            fut = self.master._dispatch_gradient(key, stub, None, req, grad_timeout_s, False)
            futs.append((key, None, fut))
        self._round = ("flat", futs)
        return agg_round_seq

    def collect(self, grad_bytes):
        """The barrier over this round's M x N (or flat N) legs, collapsed
        a worker: good iff every leg arrived and none was stale; a stale or
        short-counted worker is stale (every lane drops its claim, full
        slices on the retry); failures deduplicated a worker.  Returns
        (good, stale, failed) shaped like the flat barrier's lists."""
        kind, futs = self._round
        self._collected = []
        failed: Dict[tuple, object] = {}
        stale_keys: List[tuple] = []
        arrived: Dict[tuple, int] = {}
        for key, lane, fut in futs:
            try:
                if fut is None:
                    raise ValueError("channel closed")
                reply = fut.result()
                nbytes = reply.ByteSize()
                grad_bytes.increment(nbytes)
                if lane is not None:
                    self._grad_total.increment(nbytes)
                    lane.grad_bytes += nbytes
                if reply.stale_version:
                    if key not in stale_keys:
                        stale_keys.append(key)
                else:
                    arrived[key] = arrived.get(key, 0) + 1
                    self._collected.append((key, lane, reply))
            except (grpc.RpcError, ValueError) as e:
                failed.setdefault(key, e.code() if isinstance(e, grpc.RpcError) else e)
        expect = len(self._lanes) if kind == "sharded" else 1
        good, stale = [], []
        seen = set()
        for key, _lane, _fut in futs:
            if key in seen:
                continue
            seen.add(key)
            if key in failed:
                continue
            if key in stale_keys or arrived.get(key, 0) != expect:
                stale.append((key, None))
                for ln in self._lanes:
                    ln.bcast.note_stale(key)
                continue
            good.append((key, None))
            for ln in self._lanes:
                ln.bcast.note_ok(key)
        return good, stale, list(failed.items())

    def accumulate(self, grad_acc: np.ndarray) -> None:
        """The range-disjoint fan-in: each lane decodes its replies into its
        own view of the accumulator in dispatch (worker) order and divides
        by its own contributor count: per coordinate the flat barrier's
        float chain (same order, one true divide)."""
        grad_acc.fill(0.0)
        kind, _ = self._round
        if kind == "flat":
            replies = [r for _, _, r in self._collected]
            for r in replies:
                codec.decode_grad_into(r, grad_acc)
            grad_acc /= len(replies)
            return
        for lane in self._lanes:
            view = grad_acc[lane.lo:lane.hi]
            lane_replies = [r for _, ln, r in self._collected if ln is lane]
            treed = lane.tree_plan is not None and not lane.tree_plan.trivial
            n_contrib = 0
            for r in lane_replies:
                codec.decode_grad_into(r, view)
                if r.agg_contributors:
                    n_contrib += len(r.agg_contributors)
                elif not r.agg_forwarded:
                    n_contrib += 1
                if r.agg_partial:
                    self.metrics.counter(metrics_mod.TREE_PARTIAL).increment()
                if r.agg_flat:
                    self.metrics.counter(metrics_mod.TREE_FLAT_FALLBACK).increment()
            view /= max(1, n_contrib) if treed else len(lane_replies)
        self.metrics.counter(metrics_mod.SHARD_ROUNDS).increment()

    def advance(self, w_new: np.ndarray, w_old: np.ndarray) -> None:
        """After the update: every lane's version advances over its slice;
        after a flat round the kill is taken in by rebuilding the plan over
        the surviving shard count (new lanes, full broadcasts next round;
        the workers' assemblers reset on the new geometry)."""
        if self._flat_round:
            self._flat_round = False
            with self._kill_lock:
                killed = set(self._killed)
                self._killed.clear()
            if not killed:
                return  # permanent flat: nothing left to rebuild
            survivors = len(self._lanes) - len(killed)
            if survivors < 1:
                self._permanent_flat = True
                self.metrics.gauge(metrics_mod.SHARD_COUNT).set(0)
                self.log.error("every master shard is dead: continuing in permanent flat "
                               "fallback")
                return
            self.plan = build_shard_plan(self.dim, survivors)
            self._build_lanes()
            self.metrics.counter(metrics_mod.SHARD_REBUILDS).increment()
            flight.record("shard.rebuild", shards=survivors, digest=self.plan.digest()[:12])
            self.log.warning("shard plan rebuilt over %d surviving shard(s): %r", survivors,
                             self.plan)
            return
        for lane in self._lanes:
            lane.bcast.advance(w_new[lane.lo:lane.hi], w_old[lane.lo:lane.hi])
