"""Delta checkpoint distribution — the trainer side of ``PushWeights``.

The port's copy of the JAX package's serving/push.py, on the port's
``Checkpointer`` (``<step>.npz`` files).

Without this, every serving replica re-reads full checkpoint files from a
shared directory: N replicas x 4 bytes/feature per new version, plus an
file restore on each.  ``WeightPusher`` streams versioned weight updates
instead, encoding each version ONCE (the sync broadcast plane's
economics, core/master.py ``_BroadcastState``) and sending each target the
cheapest valid form:

- a sparse absolute-value ``WeightDelta`` vs the previous version
  (rpc/codec.py ``encode_weight_delta`` — the SAME codec the training
  broadcast uses) when the target acknowledged that previous version and
  the delta is below the dense break-even;
- the full tensor otherwise (first contact, dense-ish update, or after a
  NACK/failed push dropped the target's version claim).

A NACK (``PushWeightsReply.ok=false`` — version gap on the replica, or a
canary rollback on the router) resends the full form once; a transport
failure just drops the claim, so the NEXT push is full.  Send bytes are
accounted per target under ``serve.push.*`` (utils/metrics.py
``record_push``): the fleet's wire savings.

``CheckpointDistributor`` is the watch loop that turns a training run into
a push stream with no fit-loop coupling: it polls the checkpoint
directory the trainer already writes (``Checkpointer.poll_newer`` — the
same primitive the serving hot-reload poll uses) and pushes every new
step to the fleet, typically to the ROUTER so new versions ride the
canary gate (serving/router.py).  Wired in main.py via ``DSGD_SERVE_PUSH``
on the master/dev roles.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import grpc
import numpy as np

from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.rpc import codec
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import RpcPolicy, ServeStub, new_channel
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.serving")


def parse_targets(spec: str) -> List[Tuple[str, int]]:
    """'host:port,host:port' -> [(host, port)] (DSGD_SERVE_TARGETS /
    DSGD_SERVE_PUSH grammar; validated at Config construction)."""
    targets = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"serve target {part!r} must be host:port "
                f"(comma-separated list)")
        targets.append((host, int(port)))
    if not targets:
        raise ValueError("serve target list is empty")
    return targets


class WeightPusher:
    """Stateful delta-encoding sender for one fleet of targets."""

    def __init__(self, targets: Sequence[Tuple[str, int]], metrics=None,
                 policy: Optional[RpcPolicy] = None):
        if metrics is None:
            metrics = metrics_mod.global_metrics()
        self.metrics = metrics
        self._policy = policy or RpcPolicy(metrics=metrics)
        self._targets = [(h, int(p)) for h, p in targets]
        self._channels = {t: new_channel(*t) for t in self._targets}
        self._stubs = {t: ServeStub(ch) for t, ch in self._channels.items()}
        # per-target last-acknowledged version; a missing claim -> full form
        self._acked: Dict[Tuple[str, int], int] = {}
        self._prev: Optional[Tuple[int, np.ndarray]] = None

    def _send(self, target, req) -> Optional["pb.PushWeightsReply"]:
        form = "delta" if req.HasField("delta") else "full"
        dense = 4 * (len(self._prev[1]) if self._prev is not None
                     else req.weights.size)
        try:
            reply = self._policy.call_with_retry(
                self._stubs[target].PushWeights, req, peer=target, log=log)
        except grpc.RpcError as e:
            self.metrics.counter(metrics_mod.SERVE_PUSH_ERRORS).increment()
            log.warning("push v%d (%s) to %s:%d failed: %s",
                        req.version, form, *target, e)
            return None
        # accounted per DELIVERED send only: a transport failure shipped
        # nothing, and padding serve.push.bytes would skew the
        # wire-savings ratio these counters give
        metrics_mod.record_push(self.metrics, form, req.ByteSize(), dense)
        return reply

    def push(self, version: int, weights) -> int:
        """Push `weights` as `version` to every target; returns how many
        acknowledged ok.  Encoded at most twice total (one delta, one full
        tensor), shared across all N targets."""
        w = np.ascontiguousarray(np.asarray(weights, dtype=np.float32))
        version = int(version)
        prev_version = self._prev[0] if self._prev is not None else None
        # the shared versioned weight-send plan (rpc/codec.py
        # WeightSendPlan) — the SAME delta-vs-full choice and lazy
        # single encodes the sync broadcast plane and the shard lanes
        # ride; an all-delta round never pays for the full tensor
        plan = codec.plan_weight_send(
            w, self._prev[1] if self._prev is not None else None,
            base_version=prev_version if prev_version is not None else 0)
        delta = plan.delta()
        full = None  # the request wrapper, built lazily around plan.full()

        def full_req():
            nonlocal full
            if full is None:
                full = pb.PushWeightsRequest(version=version)
                full.weights.CopyFrom(plan.full())
            return full

        delta_req = None
        if delta is not None:
            delta_req = pb.PushWeightsRequest(version=version)
            delta_req.delta.CopyFrom(delta)

        acked = 0
        for t in self._targets:
            use_delta = (delta_req is not None
                         and self._acked.get(t) == prev_version
                         and prev_version is not None)
            reply = self._send(t, delta_req if use_delta else full_req())
            if reply is not None and not reply.ok and use_delta:
                # version gap on the target (restart, missed push): one
                # full resend inside the same round
                self.metrics.counter(metrics_mod.SERVE_PUSH_NACK).increment()
                reply = self._send(t, full_req())
            if reply is not None and reply.ok:
                self._acked[t] = version
                acked += 1
            else:
                # transport failure or NACK (e.g. the router rejected the
                # version at its canary gate): drop the claim so the next
                # push starts from the full form
                if reply is not None and not reply.ok:
                    self.metrics.counter(
                        metrics_mod.SERVE_PUSH_NACK).increment()
                self._acked.pop(t, None)
        self._prev = (version, w)
        return acked

    def retarget(self, targets: Sequence[Tuple[str, int]]) -> None:
        """Re-point the pusher at a new target set mid-stream (router
        decider failover, serving/ha.py: the distributor re-targets its
        pushes to the surviving LIVE routers).  Claims and channels of
        KEPT targets survive — their delta chains stay unbroken; dropped
        targets close, new ones start claimless (first contact is a full
        send, as ever)."""
        new = [(h, int(p)) for h, p in targets]
        if not new:
            raise ValueError("retarget needs at least one target")
        for t in self._targets:
            if t not in new:
                self._channels.pop(t).close()
                self._stubs.pop(t)
                self._acked.pop(t, None)
        for t in new:
            if t not in self._channels:
                self._channels[t] = new_channel(*t)
                self._stubs[t] = ServeStub(self._channels[t])
        self._targets = new

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()


class CheckpointDistributor:
    """Checkpoint-directory watcher that streams new steps to the fleet.

    The trainer keeps writing checkpoints exactly as before (fit loops are
    untouched); this loop turns each new step into one ``WeightPusher.push``
    — so checkpoint distribution costs delta bytes on the wire while the
    replicas stay hot mid-traffic, and a router target applies its canary
    gate to every new version.
    """

    def __init__(self, checkpoint_dir: str, targets: Sequence[Tuple[str, int]],
                 poll_s: float = 1.0, metrics=None,
                 policy: Optional[RpcPolicy] = None):
        if poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        self._ckpt = Checkpointer(checkpoint_dir)
        self.pusher = WeightPusher(targets, metrics=metrics, policy=policy)
        self.poll_s = float(poll_s)
        self._last: Optional[int] = None
        self._stop = threading.Event()
        # serializes the watcher thread's poll against start()'s immediate
        # poll and stop()'s final sweep: WeightPusher's _prev/_acked state
        # is not thread-safe, and a push can outlive the thread-join
        # timeout when a target is down (retry backoff >> poll_s)
        self._poll_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-push")

    def poll_once(self) -> bool:
        """Push the newest unseen checkpoint step, if any.  True iff pushed
        to at least one target — a push NO target took does not advance the
        cursor, so the next poll (or the stop() final sweep) retries it
        instead of silently marking the step distributed."""
        with self._poll_lock:
            try:
                restored = self._ckpt.poll_newer(self._last)
            except Exception as e:  # noqa: BLE001 - racing a half-committed write
                log.warning("checkpoint poll for push failed (will retry): %s", e)
                return False
            if restored is None:
                return False
            step, state = restored
            acked = self.pusher.push(step, np.asarray(state["weights"]))
            if not acked:
                log.warning("checkpoint step %d reached NO fleet target; "
                            "will retry", step)
                return False
            log.info("distributed checkpoint step %d to %d/%d fleet target(s)",
                     step, acked, len(self.pusher._targets))
            self._last = step
            return True

    def retarget(self, targets: Sequence[Tuple[str, int]]) -> None:
        """Swap the fleet target set between polls (decider failover:
        drop the dead router, keep pushing to the survivors)."""
        with self._poll_lock:
            self.pusher.retarget(targets)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    def start(self) -> "CheckpointDistributor":
        self.poll_once()  # push an already-present snapshot immediately
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.poll_s + 1.0)
        self.poll_once()  # final sweep: a step saved at fit end still ships
        # the lock orders this after any poll the (possibly still-joining)
        # watcher thread had in flight; a post-close loop iteration is
        # impossible because _stop is set before the join above
        with self._poll_lock:
            self.pusher.close()
            self._ckpt.close()
