"""gRPC serving front end: dynamic micro-batched Predict over the sparse
forward pass on the card, with checkpoint hot-reload.

The port's copy of the JAX package's serving/server.py.  Request path:
`Predict` validates the row against the live snapshot's feature
dimension, submits it to the MicroBatcher (QueueFull ->
RESOURCE_EXHAUSTED at the edge), and blocks on its PendingRequest.  The
batcher thread flushes coalesced rows through `PredictEngine.run`, which
pads them to a powers-of-two (batch, nnz) bucket (bucketing.py), copies
the `[B, P]` indices and values to the device, and runs the port's
``model.predict(matvec(...))`` there — the composition every trainer
uses (models/linear.py), so a served margin equals
``model.margins(w, batch)`` on the same padded batch bit for bit.  In the
JAX package this forward is XLA (a gather and a sum), not a Pallas
kernel; here it is torch ops on the card.

Weights are an argument of the forward, not state of it, so a hot swap
(model_store.py) changes nothing but the tensor the next flush reads.

Wired into main.py as the `DSGD_ROLE=serve` role; knobs in config.py
(`DSGD_SERVE_*`).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch, matvec
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import add_serve_servicer, new_server
from distributed_sgd_tpu_torch.serving.batcher import MicroBatcher, PendingRequest, QueueFull
from distributed_sgd_tpu_torch.serving.bucketing import (
    MIN_BATCH_BUCKET,
    MIN_NNZ_BUCKET,
    bucket_shape,
    pack_rows,
)
from distributed_sgd_tpu_torch.serving.model_store import ModelStore
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.serving")

# what Metrics answers: the cluster telemetry scrape is not ported
METRICS_NOT_PORTED = ("not ported to the torch server yet: the cluster telemetry scrape "
                      "(DSGD_TELEMETRY, telemetry/): ROADMAP.md Queue A [A13] item 8")


class ModelUnavailable(Exception):
    """No checkpoint snapshot has been loaded yet."""


class InvalidRow(Exception):
    """A row is inconsistent with the snapshot its batch executed under."""


class PredictEngine:
    """Bucket-padded forward pass over a weight snapshot, on the device.

    Runs on the single batcher thread (no locking needed).  Counts the
    first use of each bucket shape under `serve.jit.compile`: the JAX
    server compiles one program a shape there, the port compiles nothing,
    and the count keeps the JAX name and meaning — in steady state it
    stays flat.
    """

    PROFILE_BATCHES = 8  # torch.profiler capture length (DSGD_PROFILE_DIR)

    def __init__(self, model_name: str = "hinge", lam: float = 1e-5,
                 metrics=None, profile_dir: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._model_name = model_name
        self._lam = float(lam)
        self._metrics = metrics
        self._model = None
        self._compiled_buckets = set()
        # DSGD_PROFILE_DIR on the serve role: capture the FIRST
        # PROFILE_BATCHES Predict batches (utils/measure.py)
        self._profile = measure.ProfileWindow(
            profile_dir, self.PROFILE_BATCHES, logger=log, name="predict",
            cuda=self.device.type == "cuda")

    def _ensure_model(self, n_features: int) -> None:
        if self._model is None or self._model.n_features != n_features:
            # predict() needs only the margin->label map, so no
            # dim_sparsity vector; lam is carried for parity but unused
            self._model = make_model(self._model_name, self._lam, n_features,
                                     device=self.device)

    def forward(self, w: torch.Tensor, indices: torch.Tensor,
                values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(predictions, margins) of the padded rows on `w`'s device."""
        margins = matvec(SparseBatch(indices, values), w)
        return self._model.predict(margins), margins

    def warmup_thunks(self, n_features: int, max_batch: int):
        """The per-bucket warm-up thunks of the JAX engine (its AOT pass,
        DSGD_COMPILE_CACHE): the single-row bucket and the full
        `max_batch` flush bucket at the minimum nnz width.  Each runs the
        forward once on zero rows on the device and marks its bucket
        used.  Nothing in the port calls them yet: DSGD_COMPILE_CACHE is
        ROADMAP.md Queue A [A13] item 8."""
        self._ensure_model(int(n_features))
        buckets = sorted({
            bucket_shape(1, MIN_NNZ_BUCKET),
            bucket_shape(max(MIN_BATCH_BUCKET, int(max_batch)), MIN_NNZ_BUCKET),
        })
        w = torch.zeros(int(n_features), dtype=torch.float32, device=self.device)

        def thunk(b, p):
            def run():
                self.forward(w, torch.zeros((b, p), dtype=torch.int32, device=self.device),
                             torch.zeros((b, p), dtype=torch.float32,
                                         device=self.device))[0].cpu()
                # only a SUCCESSFUL warm counts: a failed thunk leaves
                # run()'s serve.jit.compile accounting to real traffic
                self._compiled_buckets.add((b, p))

            return run

        return [(f"predict[B{b},P{p}]", thunk(b, p)) for b, p in buckets]

    def run(
        self, snapshot: Optional[Tuple[int, torch.Tensor]],
        rows: Sequence[PendingRequest],
    ) -> List[Tuple[float, float, int]]:
        """rows -> [(prediction, margin, model_step)] in request order;
        a row inconsistent with the FLUSH-TIME snapshot gets an InvalidRow
        result instead (the servicer's admission check ran against whatever
        snapshot was live at enqueue time — a hot swap that changes the
        feature dimension in between must not index past the weights).
        Such a row's cells are zeroed before the copy to the device: JAX
        clamps an out-of-range gather, but a CUDA gather out of range
        fails the whole context, and on the CPU the whole batch."""
        if snapshot is None:
            raise ModelUnavailable("no checkpoint loaded yet")
        self._profile.tick()
        step, w = snapshot
        n_features = int(w.shape[0])
        self._ensure_model(n_features)
        valid = [
            r.indices.size == 0
            or (r.indices.min() >= 0 and int(r.indices.max()) < n_features)
            for r in rows
        ]
        idx, val = pack_rows([(r.indices, r.values) for r in rows])
        for i, ok in enumerate(valid):
            if not ok:
                idx[i] = 0
                val[i] = 0.0
        bucket = idx.shape
        if bucket not in self._compiled_buckets:
            self._compiled_buckets.add(bucket)
            if self._metrics is not None:
                self._metrics.counter("serve.jit.compile").increment()
            log.info("first flush at bucket B=%d P=%d", *bucket)
        preds, margins = self.forward(w, torch.from_numpy(idx).to(self.device),
                                      torch.from_numpy(val).to(self.device))
        preds = preds.cpu().numpy()
        margins = margins.cpu().numpy()
        return [
            (float(preds[i]), float(margins[i]), step) if valid[i]
            else InvalidRow(
                f"feature index out of range for model step {step} with "
                f"{n_features} features")
            for i in range(len(rows))
        ]


class ServingServicer:
    """dsgd.Serving method implementations (rpc/service.py _SERVE_METHODS)."""

    def __init__(self, store: ModelStore, batcher: MicroBatcher,
                 metrics=None, request_timeout_s: float = 30.0,
                 node: Optional[str] = None):
        self._store = store
        self._batcher = batcher
        self._metrics = metrics
        self._timeout = float(request_timeout_s)
        self._node = node or f"serve:{os.getpid()}"

    def Predict(self, request, context):  # noqa: N802 - gRPC method name
        t0 = time.perf_counter()
        snap = self._store.get()
        if snap is None:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "no model snapshot loaded yet")
        n_features = int(snap[1].shape[0])
        # queue-wait vs decode attribution: under an active trace these
        # nest inside the Predict server span (root=False: untraced
        # external calls must not root fragments)
        with measure.span("serve.predict.decode", metrics=self._metrics,
                          root=False):
            idx = np.fromiter(request.indices, dtype=np.int32)
            val = np.fromiter(request.values, dtype=np.float32)
        if idx.size != val.size:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"indices ({idx.size}) and values ({val.size}) "
                          f"lengths differ")
        if idx.size and (idx.min() < 0 or int(idx.max()) >= n_features):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"feature index out of range for model with "
                          f"{n_features} features")
        try:
            pending = self._batcher.submit(idx, val)
        except QueueFull as e:
            # the backpressure contract: bounded queue, shed at the edge
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        try:
            with measure.span("serve.predict.queue", metrics=self._metrics,
                              root=False):
                result = pending.wait(self._timeout)
        except ModelUnavailable as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except TimeoutError as e:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except Exception as e:  # noqa: BLE001 - surface batch failure per-call
            context.abort(grpc.StatusCode.INTERNAL, f"prediction failed: {e}")
        if isinstance(result, InvalidRow):
            # flush-time re-validation (outside the try: abort raises): a
            # hot swap between admission and flush changed the model's
            # feature dimension under this row
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(result))
        prediction, margin, step = result
        if self._metrics is not None:
            self._metrics.histogram("serve.predict.duration").record(
                time.perf_counter() - t0)
        return pb.PredictReply(prediction=prediction, margin=margin,
                               model_step=step)

    def ServeHealth(self, request, context):  # noqa: N802 - gRPC method name
        cur = self._store.get()
        return pb.ServeHealthReply(
            ok=cur is not None,
            model_step=cur[0] if cur is not None else 0,
            queue_depth=self._batcher.depth,
        )

    def PushWeights(self, request, context):  # noqa: N802 - gRPC method name
        # delta checkpoint distribution: the store builds the new weights
        # beside the published ones — in-flight batches finish on the
        # snapshot they started on, and the NEXT flush runs the pushed
        # weights.  ok=False = version gap (the pusher resends full; the
        # store already fell back to a full-file reload).
        ok, step = self._store.apply_push(request)
        return pb.PushWeightsReply(ok=ok, model_step=step)

    def Metrics(self, request, context):  # noqa: N802 - gRPC method name
        context.abort(grpc.StatusCode.UNIMPLEMENTED, METRICS_NOT_PORTED)


class ServingServer:
    """Owns the store + engine + batcher + gRPC server lifecycle."""

    def __init__(
        self,
        checkpoint_dir: str,
        model: str = "hinge",
        lam: float = 1e-5,
        port: int = 0,
        host: str = "0.0.0.0",
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        queue_depth: int = 256,
        ckpt_poll_s: float = 2.0,
        metrics=None,
        request_timeout_s: float = 30.0,
        profile_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if metrics is None:
            metrics = metrics_mod.global_metrics()
        self.metrics = metrics
        self.device = resolve_device(device)
        self.store = ModelStore(checkpoint_dir, poll_s=ckpt_poll_s, metrics=metrics,
                                device=self.device)
        self.engine = PredictEngine(model, lam, metrics=metrics,
                                    profile_dir=profile_dir, device=self.device)
        self.batcher = MicroBatcher(
            lambda rows: self.engine.run(self.store.get(), rows),
            max_batch=max_batch, max_delay_ms=max_delay_ms,
            queue_depth=queue_depth, metrics=metrics,
        )
        self._server = new_server(port, host=host)
        add_serve_servicer(self._server, ServingServicer(
            self.store, self.batcher, metrics=metrics,
            request_timeout_s=request_timeout_s,
            node=f"serve:{self._server.bound_port}"),
            node=f"serve:{self._server.bound_port}")

    @classmethod
    def from_config(cls, cfg, metrics=None, device: DeviceLike = None) -> "ServingServer":
        if not cfg.checkpoint_dir:
            raise ValueError(
                "role=serve needs DSGD_CHECKPOINT_DIR: serving loads (and "
                "hot-reloads) the weights the trainer checkpoints there")
        return cls(
            cfg.checkpoint_dir, model=cfg.model, lam=cfg.lam,
            port=cfg.serve_port, max_batch=cfg.serve_max_batch,
            max_delay_ms=cfg.serve_max_delay_ms,
            queue_depth=cfg.serve_queue_depth,
            ckpt_poll_s=cfg.serve_ckpt_poll_s, metrics=metrics,
            profile_dir=cfg.profile_dir, device=device,
        )

    @property
    def bound_port(self) -> int:
        return self._server.bound_port

    def start(self) -> "ServingServer":
        self.store.start()
        self.batcher.start()
        self._server.start()
        self._maybe_warmup()
        log.info("serving on :%d (model step %s)", self.bound_port, self.store.step)
        return self

    def _maybe_warmup(self) -> None:
        """The JAX server's spin-up fast path (DSGD_COMPILE_CACHE) warms
        each bucket's program here.  The port compiles no program a
        bucket and does not read the setting yet (ROADMAP.md Queue A
        [A13] item 8): a no-op."""

    def await_termination(self) -> None:
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()
        self.batcher.stop()
        self.store.stop()
        # a replica that served fewer batches than the capture window must
        # still close its profiler trace on the way out
        self.engine._profile.close()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
