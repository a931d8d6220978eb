"""Compressor implementations: policy and error-feedback state per codec.

The port of the JAX package's compress/codecs.py.  The stateless wire
pack and unpack live in rpc/codec.py; these classes decide WHAT ships
(selection, quantization, residual bookkeeping) and account the bytes
(utils/metrics.py ``comms.*``).  One instance per sending node: residuals
are keyed by destination, so a worker gossiping to P peers and the master
holds P + 1 accumulators, and a destination that joins mid-stream starts
from a zero residual (as if it had missed the earlier messages, which the
fire-and-forget wire already permits).

The top-k residual is a tensor on the compressor's device, beside the
delta it is added to; ``residual_snapshot`` returns a numpy copy and
``residual_restore`` takes one, as the JAX compressors' do.  The qint8
residual is numpy on the host, where its codes are drawn.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from distributed_sgd_tpu_torch.ops.topk import resolve_k, select
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod


def _host(x) -> np.ndarray:
    """`x` (numpy or a tensor on any device) as host f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


@runtime_checkable
class Compressor(Protocol):
    """One sending node's gradient -> wire policy.

    `compress` returns a ready-to-send GradUpdate for `x` bound for `dest`
    (any hashable: a peer's address, "master", ...).  Implementations with
    error feedback change the destination's residual on every call, so the
    caller compresses once for each destination it actually sends to.
    """

    name: str

    def compress(self, x, dest: Hashable = None) -> pb.GradUpdate: ...

    def reset(self) -> None:
        """Drop all error-feedback state (e.g. between fits)."""


class _AccountingMixin:
    """Shared bytes, ratio and residual accounting (``comms.*``)."""

    def _account(self, msg: pb.GradUpdate, dim: int) -> None:
        metrics_mod.record_wire(self.metrics, msg.ByteSize(), 4 * dim)

    def _record_residual(self, norm: float) -> None:
        self.metrics.histogram(metrics_mod.COMMS_RESIDUAL_NORM).record(norm)


class _ResidualStateMixin:
    """Snapshot, restore and drop of one destination's EF residual.

    `compress` drains the shipped coordinates out of the residual at encode
    time, which assumes the message is delivered.  A caller whose transport
    can DISCARD an encoded reply (the sync master drops every ok reply of a
    window when a sibling fails, and the quorum barrier proceeds without a
    late one) rolls the drain back before it encodes the retry: otherwise
    each retry loses the largest-magnitude coordinates for good.  Retries
    are known by a key the caller chooses (core/worker.py
    ``encode_sync_grad``).  The mechanics do not care what the payload
    means: a K-step window's weight-space decrement accumulates in the
    residual just as a gradient sum does."""

    def _export(self, r):
        return r.copy()

    def _import(self, snapshot):
        return snapshot

    def residual_snapshot(self, dest: Hashable) -> Optional[np.ndarray]:
        """A host copy of `dest`'s residual, or None when it has none."""
        with self._lock:
            r = self._residuals.get(dest)
            return None if r is None else self._export(r)

    def residual_restore(self, dest: Hashable, snapshot) -> None:
        with self._lock:
            if snapshot is None:
                self._residuals.pop(dest, None)
            else:
                self._residuals[dest] = self._import(snapshot)

    def residual_drop(self, dest: Hashable) -> None:
        """Forget one destination's residual, for a departed peer: a peer
        that rejoins starts from zero, as the joined-mid-stream contract
        promises, and a departed one pins no dim-sized array."""
        with self._lock:
            self._residuals.pop(dest, None)

    def reset(self) -> None:
        with self._lock:
            self._residuals.clear()


class NoneCompressor(_AccountingMixin):
    """Identity codec: the dense-or-sparse auto switch of
    ``codec.encode_grad``.  `make_compressor("none")` returns None instead,
    so the hot paths skip the wrapper; the class drives every codec
    through one interface in tests, the wire accounting included."""

    name = "none"

    def __init__(self, metrics: Optional[metrics_mod.Metrics] = None, **_):
        self.metrics = metrics or metrics_mod.global_metrics()

    def compress(self, x, dest: Hashable = None) -> pb.GradUpdate:
        x = _host(x)
        msg = codec.encode_grad(x)
        self._account(msg, len(x))
        return msg

    def reset(self) -> None:
        pass

    # stateless: the snapshot surface exists for a uniform interface only
    def residual_snapshot(self, dest: Hashable = None):
        return None

    def residual_restore(self, dest: Hashable, snapshot) -> None:
        pass

    def residual_drop(self, dest: Hashable) -> None:
        pass


class TopKCompressor(_AccountingMixin, _ResidualStateMixin):
    """Magnitude top-k sparsification with per-destination error feedback.

    Ships the k largest-|v| coordinates of v = x + residual[dest]; the
    unsent coordinates become the new residual.  With error_feedback=False
    no residual is kept (plain sparsification: biased, kept for ablation).
    The sum, the selection and the residual run on `device` (the card when
    None; ``"cpu"`` for the CPU)."""

    name = "topk"

    def __init__(
        self,
        k: float = 0.01,
        error_feedback: bool = True,
        metrics: Optional[metrics_mod.Metrics] = None,
        device: DeviceLike = None,
        **_,
    ):
        if k <= 0:
            raise ValueError(f"compress_k must be > 0, got {k}")
        self.k = k
        self.error_feedback = bool(error_feedback)
        self.metrics = metrics or metrics_mod.global_metrics()
        self.device = resolve_device(device)
        # gRPC servicer threads and the async loop both compress: a
        # destination's read-modify-write must not interleave
        self._lock = threading.Lock()
        self._residuals: Dict[Hashable, torch.Tensor] = {}

    def _export(self, r: torch.Tensor) -> np.ndarray:
        return r.cpu().numpy().copy()

    def _import(self, snapshot) -> torch.Tensor:
        return torch.as_tensor(np.asarray(snapshot, dtype=np.float32)).to(self.device)

    def compress(self, x, dest: Hashable = None) -> pb.GradUpdate:
        if isinstance(x, torch.Tensor):
            xt = x.detach().to(self.device, torch.float32)
        else:
            xt = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(self.device)
        dim = int(xt.shape[0])
        k = resolve_k(self.k, dim)
        with self._lock:
            r = self._residuals.get(dest) if self.error_feedback else None
            v = xt + r if r is not None else xt
            idx = select(v, k)
            parts = [idx.to(torch.int32), v.index_select(0, idx).view(torch.int32)]
            if self.error_feedback:
                residual = v.clone()
                residual[idx] = 0.0
                self._residuals[dest] = residual
                parts.append(torch.linalg.vector_norm(residual).reshape(1).view(torch.int32))
            # one copy to the host: the indices, the values' and the norm's bits
            host = torch.cat(parts).cpu().numpy()
            if self.error_feedback:
                self._record_residual(float(host[2 * k:].view(np.float32)[0]))
        msg = codec.encode_topk(host[:k], host[k:2 * k].view(np.float32), dim)
        self._account(msg, dim)
        return msg


class QInt8Compressor(_AccountingMixin, _ResidualStateMixin):
    """Stochastic int8 quantization with per-chunk scales (QSGD-style).

    Full support, ~4x fewer payload bytes, unbiased codes (E[decode] = x).
    With error feedback the quantization error of the destination's
    previous message is folded into the next one.  Host numpy, the codes
    drawn from a numpy generator seeded `seed`, as in the JAX codec."""

    name = "qint8"

    def __init__(
        self,
        chunk: int = codec.QINT8_CHUNK,
        error_feedback: bool = True,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        **_,
    ):
        if chunk < 1:
            raise ValueError(f"qint8 chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)
        self.error_feedback = bool(error_feedback)
        self.metrics = metrics or metrics_mod.global_metrics()
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._residuals: Dict[Hashable, np.ndarray] = {}

    def compress(self, x, dest: Hashable = None) -> pb.GradUpdate:
        x = _host(x)
        dim = len(x)
        with self._lock:
            r = self._residuals.get(dest) if self.error_feedback else None
            v = x + r if r is not None else x
            msg = codec.quantize_qint8(v, self._rng, self.chunk)
            if self.error_feedback:
                residual = v - codec.decode_compressed(msg.compressed)
                self._residuals[dest] = residual
                self._record_residual(float(np.linalg.norm(residual)))
        self._account(msg, dim)
        return msg


def make_compressor(
    name: Optional[str],
    k: float = 0.01,
    error_feedback: bool = True,
    seed: int = 0,
    metrics: Optional[metrics_mod.Metrics] = None,
    device: DeviceLike = None,
) -> Optional[Compressor]:
    """Config surface -> compressor instance, or None for the identity path.

    None keeps the callers' uncompressed paths literally unchanged (one
    encode shared across destinations, no accounting): the
    DSGD_COMPRESS=none byte-identity guarantee.  `device` is where top-k
    selects (the card when None); qint8 runs on the host."""
    if name in (None, "", "none"):
        return None
    if name == "topk":
        return TopKCompressor(k=k, error_feedback=error_feedback, metrics=metrics,
                              device=device)
    if name == "qint8":
        return QInt8Compressor(error_feedback=error_feedback, seed=seed, metrics=metrics)
    raise ValueError(f"unknown compressor {name!r} (none | topk | qint8)")
