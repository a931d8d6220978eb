"""The worker's reduce-node role; the port of the JAX package's
aggtree/reduce.py.

An elected aggregator's Gradient body does three things more a round, all
driven by the master's stamp (GradientRequest.agg_*):

1. **collect** its children's subtree sums: each child PUSHES its encoded
   GradUpdate over ``Worker.AggregateGrad``, and the parent's Gradient
   body waits on the round's buffer up to ``agg_wait_ms``.  A push may
   land before the parent's own request, so the buffer is keyed
   (fit_token, agg_round) and bounded: rounds a retry abandoned age out;
2. **reduce** its own gradient and the children's in the CANONICAL
   (stamped) order: ``acc.add_(child)`` one f32 add at a time on the
   worker's device, then one copy back.  That is the JAX chain of
   sequential adds (a ``lax.fori_loop``), so the sums are the JAX
   reducer's bit for bit; a pairwise or tree sum (``np.sum``,
   ``torch.sum``) would change the bits;
3. **send the sum up once**: to the stamped parent over AggregateGrad, or
   as the Gradient reply when the node is a root child.  A failed push
   replies to the master directly, tagged ``agg_flat`` (the tree loses
   speed, never the round); a missing child leaves a partial sum tagged
   with its contributors, which the master averages honestly.

Nothing here is built while DSGD_AGG_TREE is off: the worker builds its
``Reducer`` on the first tree-stamped request or child push.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

# the bounded pending-round buffer: a retry bumps agg_round and a rebuilt
# tree re-parents children, so pushes for abandoned rounds age out; 8 is
# more than one live round and the stragglers of a few retries
MAX_PENDING_ROUNDS = 8


class _Round:
    """One (fit_token, agg_round) collection buffer."""

    __slots__ = ("updates",)

    def __init__(self):
        self.updates: Dict[str, pb.GradUpdate] = {}


class Reducer:
    """A worker's aggregation state and its reduce and push, built lazily
    by ``WorkerNode._ensure_reducer``.  `worker` gives the metrics, the
    device, the node label, the peer table and the rpc policy."""

    def __init__(self, worker):
        self.w = worker
        self.device = worker.device
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._rounds: "OrderedDict[Tuple[int, int], _Round]" = OrderedDict()
        m = worker.metrics
        self.children_counter = m.counter(metrics_mod.AGG_CHILDREN)
        self.bytes_in = m.counter(metrics_mod.AGG_BYTES_IN)
        self.bytes_up = m.counter(metrics_mod.AGG_BYTES_UP)

    # -- child-push intake (the AggregateGrad body) --------------------------

    def offer(self, fit_token: int, agg_round: int, origin: str,
              update: pb.GradUpdate) -> None:
        """Buffer one child's subtree sum and wake the collector; the
        oldest round ages out past MAX_PENDING_ROUNDS."""
        self.bytes_in.increment(update.ByteSize())
        key = (int(fit_token), int(agg_round))
        with self._cv:
            rnd = self._rounds.get(key)
            if rnd is None:
                while len(self._rounds) >= MAX_PENDING_ROUNDS:
                    self._rounds.popitem(last=False)
                rnd = self._rounds[key] = _Round()
            rnd.updates[origin] = update
            self._cv.notify_all()

    def collect(self, fit_token: int, agg_round: int, children: Sequence[str],
                wait_s: float) -> Dict[str, pb.GradUpdate]:
        """Wait up to `wait_s` for every child in `children`; returns what
        arrived, in `children` order (the caller tags a miss partial).  The
        round's buffer is consumed: a late push makes it anew and ages
        out."""
        key = (int(fit_token), int(agg_round))
        want = set(children)
        t_end = time.monotonic() + max(0.0, wait_s)
        with self._cv:
            while True:
                rnd = self._rounds.get(key)
                got = rnd.updates if rnd is not None else {}
                if want.issubset(got.keys()):
                    break
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 0.25))
            out = {c: got[c] for c in children if c in got}
            self._rounds.pop(key, None)
            return out

    # -- the canonical-order reduce -------------------------------------------

    def reduce(self, own: np.ndarray, updates: List[pb.GradUpdate]) -> np.ndarray:
        """own + each update, in list order (the stamped child order), as
        sequential f32 adds on the worker's device; f32[D] on the host."""
        if not updates:
            return own
        self.children_counter.increment(len(updates))
        acc = torch.from_numpy(np.array(own, dtype=np.float32)).to(self.device)
        for u in updates:
            acc.add_(torch.from_numpy(codec.decode_grad(u)).to(self.device))
        return acc.cpu().numpy()

    # -- the upstream push ------------------------------------------------------

    def push_up(self, parent: str, fit_token: int, agg_round: int,
                msg: pb.GradUpdate) -> bool:
        """Send the subtree sum to `parent` ("host:port") over
        AggregateGrad; False on any failure (breaker open, channel gone,
        deadline, UNIMPLEMENTED), and the caller replies to the master
        instead.  The outcome feeds the edge's breaker, so a dead parent
        costs one probe a cooldown, not a deadline a round."""
        host, _, port_s = parent.rpartition(":")
        try:
            pkey = (host, int(port_s))
        except ValueError:
            return False
        w = self.w
        # the parent's stub from the peer table the master's introductions
        # fill; one missing (this worker joined after them) is added here
        with w._peers_lock:
            stub = w._peers.get(pkey)
        if stub is None:
            w.add_peer(*pkey)
            with w._peers_lock:
                stub = w._peers.get(pkey)
            if stub is None:
                return False
        breaker = w.rpc_policy.breaker(pkey)
        if not breaker.allow():
            return False
        req = pb.AggGrad(fit_token=int(fit_token), round=int(agg_round), origin=w.node_label)
        req.update.CopyFrom(msg)
        try:
            stub.AggregateGrad(req, timeout=w.rpc_policy.deadline_s)
        except Exception as e:  # noqa: BLE001 - any failure: the flat fallback
            breaker.record_failure()
            flight.record("agg.push.failed", worker=w.node_label, parent=parent,
                          error=repr(e))
            return False
        breaker.record_ok()
        self.bytes_up.increment(req.ByteSize())
        return True


def wait_budget_s(request) -> float:
    """This node's child-wait budget from the master's stamp
    (``agg_wait_ms``, scaled by subtree height); without one (an older
    master) the control plane's 5 s deadline."""
    ms = int(getattr(request, "agg_wait_ms", 0) or 0)
    return ms / 1000.0 if ms > 0 else 5.0
