"""Checkpoint-backed model store with atomic hot-swap and push-apply.

The port's copy of the JAX package's serving/model_store.py, on the port's
``Checkpointer`` (``<step>.npz`` files; an orbax directory raises its
``ValueError`` when the store is built).  The published weights are one
float32 tensor on the serve device.

Serves the model the trainer just saved, with no server restart.  Two
update paths feed the published snapshot:

- **file poll**: a background poll re-reads the checkpoint directory
  (`Checkpointer.poll_newer`) every `poll_s` seconds and, when a newer
  step appears, copies its weights to the device and swaps the published
  snapshot in one reference assignment;
- **push** (`apply_push`, the serving-fleet path): the trainer's master
  streams versioned weight updates over the `PushWeights` RPC — a full
  tensor, or a sparse absolute-value `WeightDelta` (rpc/codec.py, the same
  codec the sync broadcast plane uses) applied on top of the current
  snapshot.  The first applied push switches the store to push mode: the
  periodic file poll stops swapping (the push stream is authoritative —
  after a canary rollback the file may hold exactly the version that was
  rolled back), but a push whose delta base does not match the current
  snapshot (version gap: restarted replica, missed push) NACKs and falls
  back to one forced full-file reload, so a replica can always catch up
  from the shared directory.

Readers (`get()`) always see a complete (step, weights) pair — a flush
that started on step N finishes on step N even if N+1 lands mid-batch,
and the NEXT flush picks up N+1.  JAX arrays are immutable; a torch
tensor is not, so no writer ever touches a published tensor: a delta
builds new weights (a device ``clone()`` plus ``index_copy_`` of the
delta's coordinates) and publishes them with one tuple assignment under
``_swap_lock``.  A new tensor is published only after the device has
finished building it (`_settled`), so no reader on another thread or
stream can see a copy still in flight.

A restore that fails keeps the previous snapshot and counts
`serve.model.reload.errors`; successful swaps count `serve.model.reload`,
applied pushes count `serve.model.push.full` / `serve.model.push.delta`,
and every swap (either path) publishes the `serve.model.version` gauge.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.rpc import codec
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.serving")


def _settled(t: torch.Tensor) -> torch.Tensor:
    """`t` once every device operation queued to build it has finished."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


class ModelStore:
    def __init__(self, checkpoint_dir: str, poll_s: float = 2.0, metrics=None,
                 device: DeviceLike = None):
        if poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        self.device = resolve_device(device)
        self._ckpt = Checkpointer(checkpoint_dir)
        self.poll_s = float(poll_s)
        self._metrics = metrics
        # the published snapshot; swapped by ONE reference assignment, so
        # readers never lock.  _swap_lock serializes WRITERS only (the poll
        # thread vs concurrent PushWeights servicer calls — a delta apply
        # is a read-modify-write and must not race another swap).
        self._current: Optional[Tuple[int, torch.Tensor]] = None
        self._swap_lock = threading.Lock()
        # set by the first applied push: the push stream is authoritative
        # and the periodic file poll stops swapping (see module docstring)
        self._push_mode = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-ckpt-poll")
        self.poll_once()  # serve immediately if a snapshot already exists

    # -- readers -------------------------------------------------------------

    def get(self) -> Optional[Tuple[int, torch.Tensor]]:
        """(step, weights) of the newest loaded snapshot, or None before the
        first checkpoint lands."""
        return self._current

    @property
    def step(self) -> Optional[int]:
        cur = self._current
        return cur[0] if cur is not None else None

    @property
    def push_mode(self) -> bool:
        """True once a push has been applied (file poll no longer swaps)."""
        return self._push_mode

    # -- the swap ------------------------------------------------------------

    def _to_device(self, weights) -> torch.Tensor:
        """A new f32 tensor on the serve device holding `weights` (host
        values), its copy finished."""
        host = np.ascontiguousarray(np.asarray(weights, dtype=np.float32))
        return _settled(torch.from_numpy(host).to(self.device, copy=True))

    def _publish(self, step: int, weights: torch.Tensor, reason: str) -> None:
        """One reference assignment + version gauge; callers hold _swap_lock."""
        self._current = (int(step), weights)
        if self._metrics is not None:
            self._metrics.gauge(metrics_mod.SERVE_MODEL_VERSION).set(step)
        log.info("serving model swapped to step %d (%d features, %s)",
                 step, weights.shape[0], reason)

    # -- the file poll -------------------------------------------------------

    def poll_once(self, force: bool = False) -> bool:
        """Check for a newer checkpoint file; swap it in.  True iff swapped.

        `force` (the version-gap fallback of `apply_push`) bypasses push
        mode AND the newer-step comparison: the file's latest snapshot
        wins outright, whatever version the push stream left behind."""
        cur = self._current
        if self._push_mode and not force:
            return False
        try:
            restored = self._ckpt.poll_newer(
                None if force else (cur[0] if cur is not None else None))
            if restored is None:
                return False
            step, state = restored
            weights = self._to_device(state["weights"])
        except Exception as e:  # noqa: BLE001 - keep serving the old snapshot
            log.warning("checkpoint reload failed (serving stays on step %s): %s",
                        cur[0] if cur else None, e)
            if self._metrics is not None:
                self._metrics.counter("serve.model.reload.errors").increment()
            return False
        with self._swap_lock:
            # re-check under the writer lock: the restore above ran
            # unlocked, and a push may have landed meanwhile — the push
            # stream is authoritative, so an unforced file poll must never
            # clobber it
            now = self._current
            if not force and (self._push_mode
                              or (now is not None and step <= now[0])):
                return False
            self._publish(step, weights, reason="file reload")
        if self._metrics is not None:
            self._metrics.counter("serve.model.reload").increment()
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    # -- push-apply (PushWeights) --------------------------------------------

    def apply_push(self, request) -> Tuple[bool, int]:
        """Apply one PushWeightsRequest; returns (ok, serving_step).

        Full form: the pushed tensor replaces the snapshot at the pushed
        version unconditionally — the pusher is authoritative, which is
        what lets a canary ROLLBACK re-install an older version (a
        monotone guard would wedge the rollback).  Delta form: applied iff
        the current snapshot IS the delta's base version, into a copy of
        it; anything else — empty store, missed push, restarted replica —
        is a version gap: NACK (the pusher resends full) plus one forced
        full-file reload so a shared checkpoint directory also heals it.
        """
        version = int(request.version)
        with self._swap_lock:
            if request.HasField("weights"):
                w = self._to_device(codec.decode_tensor(request.weights))
                self._push_mode = True
                self._publish(version, w, reason="push full")
                if self._metrics is not None:
                    self._metrics.counter(
                        metrics_mod.SERVE_MODEL_PUSH_FULL).increment()
                return True, version
            cur = self._current
            if (request.HasField("delta") and cur is not None
                    and cur[0] == request.delta.base_version):
                w = cur[1].clone()
                if len(request.delta.indices):
                    idx = torch.from_numpy(
                        np.asarray(request.delta.indices, dtype=np.int64)).to(self.device)
                    val = torch.from_numpy(
                        np.asarray(request.delta.values, dtype=np.float32)).to(self.device)
                    w.index_copy_(0, idx, val)
                self._push_mode = True
                self._publish(version, _settled(w), reason="push delta")
                if self._metrics is not None:
                    self._metrics.counter(
                        metrics_mod.SERVE_MODEL_PUSH_DELTA).increment()
                return True, version
        # version gap (or a request with neither arm): count it, then fall
        # back to a full-file reload OUTSIDE the swap lock (file I/O must
        # not block concurrent pushes); whatever the directory holds is
        # better than a replica pinned on a stale snapshot
        if self._metrics is not None:
            self._metrics.counter(metrics_mod.SERVE_MODEL_PUSH_GAP).increment()
        log.warning(
            "push version gap: delta base %s vs serving step %s — NACK + "
            "full-file reload fallback",
            request.delta.base_version if request.HasField("delta") else None,
            self.step)
        self.poll_once(force=True)
        return False, self.step or 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ModelStore":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.poll_s + 1.0)
        self._ckpt.close()
