"""The worker's shard rendezvous; the port of the JAX package's
shardedps/assemble.py.

A sharded round reaches a worker as M concurrent Gradient requests, one a
master shard lane, each carrying only its range slice of the weights (the
full slice, a WeightDelta against the lane's previous version, or a
header-only form).  The gradient reads the whole vector, so
``ShardAssembler`` is the meeting point:

- each request resolves ITS slice against a per-shard resident cache,
  the flat replica's install/cached/delta/stale ladder
  (``WorkerNode.resolve_request_weights``) keyed by shard index;
- the M requests of a round meet on (fit_token, shard_round); the one
  that completes the set builds the full vector on the HOST from the
  slices and calls ``compute`` once (``WorkerNode.compute_gradient``:
  one ``worker_grads`` launch for all M legs), keeping the result as one
  host array;
- each request then slices that array by its own [shard_lo, shard_hi).

The legs that wait never touch the device.  A slice that fails to
resolve marks the whole round stale: every leg replies ``stale_version``
and the master's retry sends full slices on every lane.  Abandoned rounds
age out of a bounded buffer.  Built lazily on the first shard-tagged
request (``WorkerNode._ensure_shard_assembler``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from distributed_sgd_tpu_torch.rpc import codec
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

# how long a leg waits for its round's sibling slices before replying
# stale: the wait covers only the skew between M sends of one round
ASSEMBLE_BUDGET_S = 5.0

# the bounded rendezvous buffer: the oldest round is evicted and its
# waiters woken to reply stale
MAX_PENDING_ROUNDS = 8


class _Round:
    """One shard round's rendezvous state (under the assembler's lock)."""

    __slots__ = ("slices", "stale", "grad", "done", "computing")

    def __init__(self):
        self.slices = {}  # shard_index -> (lo, hi, slice)
        self.stale = False
        self.grad: Optional[np.ndarray] = None
        self.done = False
        self.computing = False


class ShardAssembler:
    def __init__(self, metrics=None, log=None):
        self.metrics = metrics if metrics is not None else metrics_mod.global_metrics()
        self.log = log
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (fit_token, shard_count): a new fit or a rebuilt plan (other
        # ranges) drops every resident slice
        self._geometry = None
        self._resident = {}  # shard_index -> (version, slice)
        self._rounds: "OrderedDict[tuple, _Round]" = OrderedDict()

    def _resolve_slice(self, request):
        """The flat replica's ladder for one shard index: install, cached,
        delta or stale.  Returns (slice, stale).  Under the lock."""
        i = int(request.shard_index)
        version = request.step_version
        if request.HasField("weights"):
            sl = codec.decode_tensor(request.weights)
            self._resident[i] = (version, sl)
            return sl, False
        held = self._resident.get(i)
        if held is None:
            return None, True
        cached_ver, cached = held
        if cached_ver == version:
            return cached, False  # a retry: idempotent
        if request.HasField("delta") and cached_ver == request.delta.base_version:
            sl = codec.apply_weight_delta(cached, request.delta)
            self._resident[i] = (version, sl)
            return sl, False
        return None, True

    def _round_for(self, key) -> _Round:
        """The round of `key`, made if new; evicting the oldest past the
        bound wakes its waiters stale.  Under the lock."""
        rd = self._rounds.get(key)
        if rd is None:
            rd = self._rounds[key] = _Round()
            while len(self._rounds) > MAX_PENDING_ROUNDS:
                _, old = self._rounds.popitem(last=False)
                old.stale = old.done = True
                self._cv.notify_all()
        return rd

    def gradient(self, request, compute: Callable[[np.ndarray, np.ndarray], np.ndarray]
                 ) -> Optional[np.ndarray]:
        """Resolve this leg's slice, meet the round's other legs, and
        return the round's full-dimension gradient (shared and read-only:
        the caller slices its own range), or None for a stale slice
        anywhere in the round, an abandoned round or a timeout."""
        rkey = (request.fit_token, int(request.shard_round))
        count = int(request.shard_count)
        with self._cv:
            geometry = (request.fit_token, count)
            if self._geometry != geometry:
                self._resident.clear()
                self._geometry = geometry
            sl, stale = self._resolve_slice(request)
            rd = self._round_for(rkey)
            if stale or rd.stale:
                rd.stale = rd.done = True
                self._cv.notify_all()
                return None
            rd.slices[int(request.shard_index)] = (int(request.shard_lo),
                                                   int(request.shard_hi), sl)
            assemble = len(rd.slices) == count and not rd.computing
            if assemble:
                # exactly one leg a round assembles and computes
                rd.computing = True
                pieces = dict(rd.slices)
        if assemble:
            dim = max(hi for _, hi, _ in pieces.values())
            w = np.empty(dim, dtype=np.float32)
            for lo, hi, piece in pieces.values():
                w[lo:hi] = piece
            ids = np.fromiter(request.samples, dtype=np.int64)
            try:
                g = np.asarray(compute(w, ids), dtype=np.float32)
            except BaseException:
                # the other legs answer at once instead of at the budget
                with self._cv:
                    rd.stale = rd.done = True
                    self._cv.notify_all()
                raise
            with self._cv:
                rd.grad = g
                rd.done = True
                self._cv.notify_all()
            self.metrics.counter(metrics_mod.SHARD_ASSEMBLED).increment()
            return g
        deadline = time.monotonic() + ASSEMBLE_BUDGET_S
        with self._cv:
            while not rd.done:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    rd.stale = rd.done = True
                    self._cv.notify_all()
                    self.metrics.counter(metrics_mod.SHARD_ASM_TIMEOUTS).increment()
                    if self.log is not None:
                        self.log.warning("shard round %s timed out waiting for %d/%d slices",
                                         rkey, len(rd.slices), count)
                    return None
                self._cv.wait(remaining)
            return rd.grad if not rd.stale else None
