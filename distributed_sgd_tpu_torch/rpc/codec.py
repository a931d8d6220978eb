"""numpy <-> wire codecs.

The port's copy of the JAX package's rpc/codec.py: the same bytes on the
wire for the same vectors, so a JAX node and a torch node read each
other's messages.

The counterpart of the reference's ScalaPB TypeMappers that marshal proto
maps into `math.Vec` (core/package.scala:11-13, proto.proto:8-11).  Dense
f32 vectors travel as raw little-endian bytes; small-support deltas can
travel as coordinate lists, chosen automatically by `encode_grad` when the
sparse form is smaller on the wire.

Lossy compressed forms (CompressedGrad: top-k coordinate lists, int8
quantization with per-chunk scales) live here as STATELESS pack/unpack
functions; the policy and state around them — which codec, error-feedback
residuals, comms accounting — is the compress/ subsystem's job
(docs/COMPRESSION.md).  `decode_grad` understands every arm, so receivers
never need to know what the sender negotiated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb

QINT8_CHUNK = 512  # default elements per quantization scale chunk
_QINT8_LEVELS = 127.0  # int8 code range is [-127, 127]; -128 unused


def encode_tensor(x: np.ndarray) -> pb.Tensor:
    x = np.ascontiguousarray(np.asarray(x, dtype="<f4"))
    return pb.Tensor(data=x.tobytes(), size=x.shape[0])


def decode_tensor(t: pb.Tensor) -> np.ndarray:
    return np.frombuffer(t.data, dtype="<f4", count=t.size).copy()


def encode_grad(x: np.ndarray, sparse_threshold: float = 0.25) -> pb.GradUpdate:
    """Dense or sparse wire form, whichever is smaller.

    Coordinate form costs ~8 bytes/nonzero vs 4 bytes/element dense, so
    sparse wins below ~50% density; the threshold is conservative.
    """
    x = np.asarray(x, dtype=np.float32)
    nz = np.nonzero(x)[0]
    if len(nz) <= sparse_threshold * len(x):
        return pb.GradUpdate(
            sparse=pb.SparseTensor(
                indices=nz.astype(np.int32), values=x[nz], size=len(x)
            )
        )
    return pb.GradUpdate(dense=encode_tensor(x))


def encode_topk(indices: np.ndarray, values: np.ndarray, size: int) -> pb.GradUpdate:
    """Top-k support as a CompressedGrad (compress/ picks the support).
    The repeated fields take Python lists: filled from numpy scalars they
    cost about 3x the time, for the same bytes."""
    return pb.GradUpdate(
        compressed=pb.CompressedGrad(
            codec="topk",
            size=int(size),
            indices=np.asarray(indices, dtype=np.int32).tolist(),
            values=np.asarray(values, dtype=np.float32).tolist(),
        )
    )


def quantize_qint8(
    x: np.ndarray, rng: np.random.Generator, chunk: int = QINT8_CHUNK
) -> pb.GradUpdate:
    """Stochastic int8 quantization with one f32 scale per `chunk` elements.

    Per chunk c: scale_c = max|x_c| / 127 and each element rounds to
    floor(x/scale + u), u ~ U[0,1) — unbiased (E[decode] = x) with
    per-element error < scale_c.  An all-zero chunk gets scale 0 and codes 0.
    """
    x = np.asarray(x, dtype=np.float32)
    n = len(x)
    chunk = max(1, int(chunk))
    n_chunks = -(-n // chunk) if n else 0
    pad = n_chunks * chunk - n
    xp = np.pad(x, (0, pad)).reshape(n_chunks, chunk) if n else x.reshape(0, chunk)
    scales = np.abs(xp).max(axis=1) / _QINT8_LEVELS
    safe = np.where(scales > 0, scales, 1.0)[:, None]
    q = np.floor(xp / safe + rng.random(xp.shape, dtype=np.float32))
    codes = np.clip(q, -_QINT8_LEVELS, _QINT8_LEVELS).astype(np.int8)
    codes[scales == 0] = 0
    return pb.GradUpdate(
        compressed=pb.CompressedGrad(
            codec="qint8",
            size=n,
            data=codes.reshape(-1)[:n].tobytes(),
            scales=scales.astype(np.float32),
            chunk=chunk,
        )
    )


def _scatter(indices, values, size: int) -> np.ndarray:
    """Coordinate list -> dense f32 via bulk conversion (the repeated-field
    containers support the sequence protocol, and np.asarray over them is
    ~10x fromiter on 47k-dim gossip decodes)."""
    out = np.zeros(size, dtype=np.float32)
    if len(indices):
        out[np.asarray(indices, dtype=np.int64)] = np.asarray(
            values, dtype=np.float32
        )
    return out


def decode_compressed(c: pb.CompressedGrad) -> np.ndarray:
    if c.codec == "topk":
        return _scatter(c.indices, c.values, c.size)
    if c.codec == "qint8":
        return _qint8_values(c)
    raise ValueError(f"unknown CompressedGrad codec {c.codec!r}")


def decode_grad(g: pb.GradUpdate) -> np.ndarray:
    which = g.WhichOneof("grad")
    if which == "sparse":
        return _scatter(g.sparse.indices, g.sparse.values, g.sparse.size)
    if which == "compressed":
        return decode_compressed(g.compressed)
    return decode_tensor(g.dense)


def _qint8_values(c: pb.CompressedGrad) -> np.ndarray:
    codes = np.frombuffer(c.data, dtype=np.int8, count=c.size).astype(np.float32)
    chunk = max(1, c.chunk or QINT8_CHUNK)
    scales = np.asarray(c.scales, dtype=np.float32)
    return codes * np.repeat(scales, chunk)[: c.size]


# -- versioned weight deltas (docs/SYNC_PIPELINE.md, docs/SERVING.md) ---------
#
# The ONE encode/apply pair for sparse absolute-value weight updates, shared
# by the sync broadcast plane (core/master.py _BroadcastState -> worker
# replica caches) and the serving fleet's checkpoint distribution
# (serving/push.py WeightPusher -> ModelStore.apply_push, and the router's
# own promoted-weights cache).  `values` are ABSOLUTE new weights at
# `indices` (assignment, not increment): application is idempotent and
# reconstructs the sender's vector bit-exactly.

SPARSE_BREAK_EVEN = 0.5  # changed fraction above which dense is smaller


def encode_weight_delta(
    w: np.ndarray, w_prev: Optional[np.ndarray], base_version: int,
    break_even: float = SPARSE_BREAK_EVEN,
) -> Optional[pb.WeightDelta]:
    """Sparse WeightDelta of `w` vs `w_prev`, or None when a full tensor is
    the smaller (or only possible) wire form: no previous vector, or more
    than `break_even` of the coordinates changed (8 bytes/changed
    coordinate vs 4 bytes/element dense -> break-even at 50% density)."""
    if w_prev is None or w_prev.shape != w.shape:
        return None
    changed = np.nonzero(w != w_prev)[0]
    if len(changed) > break_even * len(w):
        return None  # dense-ish: full is smaller
    return pb.WeightDelta(
        base_version=int(base_version),
        indices=changed.astype(np.int32),
        values=np.ascontiguousarray(w[changed]),
    )


def apply_weight_delta(w: np.ndarray, delta: pb.WeightDelta) -> np.ndarray:
    """New weight vector: `w` with the delta's ABSOLUTE values assigned at
    its indices.  Returns a fresh array; the caller's `w` is untouched (a
    published snapshot must never mutate under a reader).  Version
    bookkeeping (does `delta.base_version` match what `w` is?) belongs to
    the caller — this is pure application."""
    out = np.asarray(w, dtype=np.float32).copy()
    if len(delta.indices):
        out[np.asarray(delta.indices, dtype=np.int64)] = np.asarray(
            delta.values, dtype=np.float32)
    return out


class WeightSendPlan:
    """One weight version's candidate wire forms, each encoded at most
    once and shared across every recipient of that version.

    This is the ONE versioned weight-send path (previously triplicated
    by hand): the master's sync broadcast (core/master.py
    `_BroadcastState`), the serving fleet's checkpoint distribution
    (serving/push.py `WeightPusher`), and the shard lanes' range-slice
    broadcast (shardedps/coordinator.py) all resolve their delta-vs-full
    choice and their lazy single encodes here.  `w_prev=None` disables
    the sparse form entirely (an unversioned / first-contact send);
    both encodes are lazy, so an all-delta round never pays for the
    full tensor and vice versa — the economics every caller relied on
    before the extraction, byte-identical on the wire (the delta is
    `encode_weight_delta`, the full form `encode_tensor`, unchanged).
    """

    def __init__(self, w: np.ndarray, w_prev: Optional[np.ndarray] = None,
                 base_version: int = 0,
                 break_even: float = SPARSE_BREAK_EVEN):
        self._w = w
        self._w_prev = w_prev
        self.base_version = int(base_version)
        self._break_even = float(break_even)
        self._full: Optional[pb.Tensor] = None
        self._delta: Optional[pb.WeightDelta] = None
        self._delta_done = False  # "computed, dense fallback" != "not yet"

    def full(self) -> pb.Tensor:
        """The full dense tensor, encoded on first use."""
        if self._full is None:
            self._full = encode_tensor(self._w)
        return self._full

    def delta(self) -> Optional[pb.WeightDelta]:
        """The sparse WeightDelta vs `w_prev`, or None when the full
        tensor is the smaller (or only possible) wire form; computed on
        first use."""
        if not self._delta_done:
            self._delta = encode_weight_delta(
                self._w, self._w_prev, base_version=self.base_version,
                break_even=self._break_even)
            self._delta_done = True
        return self._delta

    def choose_arm(self, acked_version: Optional[int],
                   version: int) -> str:
        """The cheapest valid arm for a recipient whose last
        acknowledged version is `acked_version` (None = no claim):
        'cached' (zero bytes — the recipient already holds `version`),
        'delta' (the recipient holds exactly `base_version` and the
        sparse form exists), else 'full'."""
        if acked_version is not None and acked_version == version:
            return "cached"
        if (acked_version is not None
                and acked_version == self.base_version
                and self.delta() is not None):
            return "delta"
        return "full"


def plan_weight_send(w: np.ndarray, w_prev: Optional[np.ndarray] = None,
                     base_version: int = 0,
                     break_even: float = SPARSE_BREAK_EVEN) -> WeightSendPlan:
    """Build the shared lazy encode plan for one weight version (see
    WeightSendPlan)."""
    return WeightSendPlan(np.asarray(w, dtype=np.float32),
                          w_prev, base_version, break_even)


def parse_grad(g: pb.GradUpdate):
    """Materialize a GradUpdate's wire payload into ndarrays WITHOUT
    touching any accumulator — the expensive half of `decode_grad_into`
    (repeated-field -> numpy conversion, qint8 dequantization), split out
    so the sharded fan-in lanes (core/master.py `_ArrivalDecoder`,
    DSGD_FANIN_LANES) can run it concurrently across gRPC arrival
    callbacks while the float ACCUMULATION stays strictly send-ordered
    (and therefore bit-identical to the unsharded path).

    Returns an opaque parsed form for `add_parsed`:
      ('scatter', int64 indices, f32 values)  — sparse / topk arms
      ('add', f32 vector)                     — dense (zero-copy
                                                frombuffer view of the
                                                proto bytes) / qint8
      ('zero',)                               — empty coordinate list
    """
    which = g.WhichOneof("grad")
    if which == "sparse" or (which == "compressed" and g.compressed.codec == "topk"):
        src = g.sparse if which == "sparse" else g.compressed
        if not len(src.indices):
            return ("zero",)
        return ("scatter", np.asarray(src.indices, dtype=np.int64),
                np.asarray(src.values, dtype=np.float32))
    if which == "compressed":
        if g.compressed.codec != "qint8":
            raise ValueError(
                f"unknown CompressedGrad codec {g.compressed.codec!r}")
        return ("add", _qint8_values(g.compressed))
    if which is None and not g.dense.size:
        # armless update: an aggregation-tree child that PUSHED its
        # gradient to its parent acks the master with no payload
        # (GradUpdate.agg_forwarded, docs/AGGREGATION.md) — it
        # contributes nothing to the accumulator, not an empty vector
        return ("zero",)
    return ("add", np.frombuffer(g.dense.data, dtype="<f4", count=g.dense.size))


def add_parsed(parsed, out: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Accumulate a `parse_grad` result into `out` — the float ops are
    EXACTLY `decode_grad_into`'s (fancy-indexed `+=` over strictly unique
    indices for coordinate forms, one vector `+=` for dense forms), so
    parse-then-add is bit-identical to the fused decode whatever thread
    ran the parse."""
    kind = parsed[0]
    if kind == "scatter":
        vals = parsed[2]
        out[parsed[1]] += vals * scale if scale != 1.0 else vals
    elif kind == "add":
        v = parsed[1]
        out += v * scale if scale != 1.0 else v
    return out


def decode_grad_into(g: pb.GradUpdate, out: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Accumulate a GradUpdate into a caller-owned buffer: out += scale * g.

    The sync fan-in's former `[decode_grad(r) for r in ok]` +
    `np.mean(..., axis=0)` materialized a (workers x dim) dense stack per
    batch window just to average it; this scatters/adds each reply straight
    into one preallocated accumulator instead.  Dense payloads are read as
    zero-copy `np.frombuffer` views of the proto bytes (never written to);
    coordinate forms add O(nnz) work without a dense intermediate.  Every
    encoder in this module emits strictly unique indices (np.nonzero /
    topk support), which the fancy-indexed `+=` relies on.

    Equivalent to `out += scale * decode_grad(g)` up to float evaluation
    order; returns `out` for chaining.  Composed from `parse_grad` +
    `add_parsed` so the sharded fan-in can split the two halves across
    threads without a second decode implementation to drift.
    """
    return add_parsed(parse_grad(g), out, scale)
