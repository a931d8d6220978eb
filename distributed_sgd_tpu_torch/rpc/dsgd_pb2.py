# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dsgd.proto
"""Generated protocol buffer code.

The port's copy of the JAX package's rpc/dsgd_pb2.py.  The descriptor it
registers must stay byte-identical to the JAX package's: both register
the file ``dsgd.proto`` in protobuf's default pool, which accepts an
identical second registration (and hands back the same message classes)
but refuses a differing one.  tests/test_torch_rpc.py holds the two
serialized descriptors equal.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# protoc output for the pre-compression IDL.  The CompressedGrad message and
# the GradUpdate `compressed` oneof arm are spliced into this descriptor
# programmatically below (grpc_tools/protoc is unavailable in this image, see
# the serving-surface note at the bottom): the blob is parsed back into a
# FileDescriptorProto, mutated, and re-serialized before registration, which
# is wire-identical to regenerating from rpc/proto/dsgd.proto.
_RAW_DSGD = (b'\n\ndsgd.proto\x12\x04\x64sgd\"\"\n\x04Node\x12\x0c\n\x04host\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\x05\"\x05\n\x03\x41\x63k\"\x07\n\x05\x45mpty\"$\n\x06Tensor\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0c\n\x04size\x18\x02 \x01(\x05\"E\n\x0cSparseTensor\x12\x13\n\x07indices\x18\x01 \x03(\x05\x42\x02\x10\x01\x12\x12\n\x06values\x18\x02 \x03(\x02\x42\x02\x10\x01\x12\x0c\n\x04size\x18\x03 \x01(\x05\"j\n\nGradUpdate\x12\x1d\n\x05\x64\x65nse\x18\x01 \x01(\x0b\x32\x0c.dsgd.TensorH\x00\x12$\n\x06sparse\x18\x02 \x01(\x0b\x32\x12.dsgd.SparseTensorH\x00\x12\x0f\n\x07n_steps\x18\x03 \x01(\x05\x42\x06\n\x04grad\"Z\n\x0e\x46orwardRequest\x12\x13\n\x07samples\x18\x01 \x03(\x05\x42\x02\x10\x01\x12\x1d\n\x07weights\x18\x02 \x01(\x0b\x32\x0c.dsgd.Tensor\x12\x14\n\x0cwant_margins\x18\x03 \x01(\x08\"<\n\x0c\x46orwardReply\x12\x17\n\x0bpredictions\x18\x01 \x03(\x02\x42\x02\x10\x01\x12\x13\n\x07margins\x18\x02 \x03(\x02\x42\x02\x10\x01\"E\n\x0fGradientRequest\x12\x1d\n\x07weights\x18\x01 \x01(\x0b\x32\x0c.dsgd.Tensor\x12\x13\n\x07samples\x18\x02 \x03(\x05\x42\x02\x10\x01\"\x97\x01\n\x11StartAsyncRequest\x12\x1d\n\x07weights\x18\x01 \x01(\x0b\x32\x0c.dsgd.Tensor\x12\x13\n\x07samples\x18\x02 \x03(\x05\x42\x02\x10\x01\x12\x12\n\nbatch_size\x18\x03 \x01(\x05\x12\x15\n\rlearning_rate\x18\x04 \x01(\x02\x12\x11\n\toptimizer\x18\x05 \x01(\t\x12\x10\n\x08momentum\x18\x06 \x01(\x02\x32\x8b\x01\n\x06Master\x12(\n\rRegisterSlave\x12\n.dsgd.Node\x1a\t.dsgd.Ack\"\x00\x12*\n\x0fUnregisterSlave\x12\n.dsgd.Node\x1a\t.dsgd.Ack\"\x00\x12+\n\nUpdateGrad\x12\x10.dsgd.GradUpdate\x1a\t.dsgd.Ack\"\x00\x32\xf6\x02\n\x06Worker\x12(\n\rRegisterSlave\x12\n.dsgd.Node\x1a\t.dsgd.Ack\"\x00\x12*\n\x0fUnregisterSlave\x12\n.dsgd.Node\x1a\t.dsgd.Ack\"\x00\x12 \n\x04Ping\x12\x0b.dsgd.Empty\x1a\t.dsgd.Ack\"\x00\x12\x35\n\x07\x46orward\x12\x14.dsgd.ForwardRequest\x1a\x12.dsgd.ForwardReply\"\x00\x12\x35\n\x08Gradient\x12\x15.dsgd.GradientRequest\x1a\x10.dsgd.GradUpdate\"\x00\x12\x32\n\nStartAsync\x12\x17.dsgd.StartAsyncRequest\x1a\t.dsgd.Ack\"\x00\x12%\n\tStopAsync\x12\x0b.dsgd.Empty\x1a\t.dsgd.Ack\"\x00\x12+\n\nUpdateGrad\x12\x10.dsgd.GradUpdate\x1a\t.dsgd.Ack\"\x00\x62\x06proto3')


# -- compression surface (rpc/proto/dsgd.proto "gradient compression") -------

from google.protobuf import descriptor_pb2 as _descriptor_pb2

_F = _descriptor_pb2.FieldDescriptorProto


def _splice_compression(raw: bytes) -> "_descriptor_pb2.FileDescriptorProto":
    """Add CompressedGrad + the GradUpdate oneof arm to the protoc blob;
    returns the mutated FileDescriptorProto so further splices can chain
    before the final SerializeToString at registration."""
    fdp = _descriptor_pb2.FileDescriptorProto.FromString(raw)

    cg = fdp.message_type.add()
    cg.name = "CompressedGrad"
    for number, name, ftype, repeated in (
        (1, "codec", _F.TYPE_STRING, False),
        (2, "size", _F.TYPE_INT32, False),
        (3, "indices", _F.TYPE_INT32, True),
        (4, "values", _F.TYPE_FLOAT, True),
        (5, "data", _F.TYPE_BYTES, False),
        (6, "scales", _F.TYPE_FLOAT, True),
        (7, "chunk", _F.TYPE_INT32, False),
    ):
        fld = cg.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
        if repeated:  # match the [packed = true] of SparseTensor
            fld.options.packed = True

    gu = next(m for m in fdp.message_type if m.name == "GradUpdate")
    fld = gu.field.add()
    fld.name = "compressed"
    fld.number = 4
    fld.type = _F.TYPE_MESSAGE
    fld.type_name = ".dsgd.CompressedGrad"
    fld.label = _F.LABEL_OPTIONAL
    fld.oneof_index = 0  # joins the existing `grad` oneof (dense | sparse)

    # fit-session token: lets a long-lived worker drop the sync-reply EF
    # residual when a NEW fit starts (0/absent = no session tracking)
    gr = next(m for m in fdp.message_type if m.name == "GradientRequest")
    fld = gr.field.add()
    fld.name = "fit_token"
    fld.number = 3
    fld.type = _F.TYPE_INT64
    fld.label = _F.LABEL_OPTIONAL
    return fdp


# -- pipelined sync engine surface (rpc/proto/dsgd.proto "pipelined sync") ----


def _splice_sync_pipeline(fdp):
    """Add WeightDelta + the versioned-broadcast / local-step fields
    (docs/SYNC_PIPELINE.md) to the descriptor, same technique as
    _splice_compression above."""
    wd = fdp.message_type.add()
    wd.name = "WeightDelta"
    for number, name, ftype, repeated in (
        (1, "base_version", _F.TYPE_INT64, False),
        (2, "indices", _F.TYPE_INT32, True),
        (3, "values", _F.TYPE_FLOAT, True),
    ):
        fld = wd.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
        if repeated:  # match the [packed = true] of SparseTensor
            fld.options.packed = True

    gr = next(m for m in fdp.message_type if m.name == "GradientRequest")
    for number, name, ftype, type_name in (
        (4, "delta", _F.TYPE_MESSAGE, ".dsgd.WeightDelta"),
        (5, "step_version", _F.TYPE_INT64, None),
        (6, "local_steps", _F.TYPE_INT32, None),
        (7, "learning_rate", _F.TYPE_FLOAT, None),
        (8, "batch_size", _F.TYPE_INT32, None),
    ):
        fld = gr.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        if type_name:
            fld.type_name = type_name
        fld.label = _F.LABEL_OPTIONAL

    # reply fault arm: replica/version mismatch, no gradient computed —
    # NOT part of the `grad` oneof (a stale reply carries no payload)
    gu = next(m for m in fdp.message_type if m.name == "GradUpdate")
    fld = gu.field.add()
    fld.name = "stale_version"
    fld.number = 5
    fld.type = _F.TYPE_BOOL
    fld.label = _F.LABEL_OPTIONAL
    return fdp


# -- quorum / straggler-hedging surface (rpc/proto/dsgd.proto "quorum") -------


def _splice_quorum(fdp):
    """Add the quorum-barrier fields (docs/FAULT_TOLERANCE.md) to
    GradientRequest, same technique as the splices above.  Both fields
    default to 0/false and are only ever set by a quorum-enabled master,
    so the knobs-off wire stays byte-identical."""
    gr = next(m for m in fdp.message_type if m.name == "GradientRequest")
    for number, name, ftype in (
        # the step_version whose reply this worker sent but the master
        # DISCARDED (quorum proceeded without it): the worker rolls its
        # error-feedback residual drain for that window back before
        # encoding this one (core/worker.py rollback_sync_ef)
        (9, "ef_rollback_version", _F.TYPE_INT64),
        # straggler hedge: this request duplicates another worker's data
        # slice — the reply must NOT touch the recipient's own sync EF
        # residual (it is encoded uncompressed)
        (10, "hedge", _F.TYPE_BOOL),
    ):
        fld = gr.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_OPTIONAL
    return fdp


# -- hierarchical multi-host surface (rpc/proto/dsgd.proto "hierarchy") -------


def _splice_hierarchy(fdp):
    """Add the host-shape field (docs/HIERARCHY.md) to Node, same
    technique as the splices above.  `devices` defaults to 0 ("shape
    unknown / single device") and is only ever set by a hierarchical
    worker (DSGD_HOST_DEVICES > 1), so the knobs-off registration wire
    stays byte-identical."""
    node = next(m for m in fdp.message_type if m.name == "Node")
    fld = node.field.add()
    fld.name = "devices"
    fld.number = 3
    fld.type = _F.TYPE_INT32
    fld.label = _F.LABEL_OPTIONAL
    return fdp


# -- streaming fan-out surface (rpc/proto/dsgd.proto "streaming") -------------


def _splice_stream(fdp):
    """Add the Frame envelope + the Worker.FitStream bidi method
    (docs/SYNC_PIPELINE.md "Streaming transport"), same technique as the
    splices above.  Frame is a NEW top-level message and FitStream a NEW
    method — no existing message gains a field, so every unary wire form
    stays byte-identical (and a knobs-off master never opens a stream at
    all, asserted by tests/test_stream.py)."""
    fr = fdp.message_type.add()
    fr.name = "Frame"
    fr.oneof_decl.add().name = "payload"
    for number, name, ftype, type_name, in_oneof in (
        (1, "fit_token", _F.TYPE_INT64, None, False),
        (2, "seq", _F.TYPE_INT64, None, False),
        (3, "request", _F.TYPE_MESSAGE, ".dsgd.GradientRequest", True),
        (4, "update", _F.TYPE_MESSAGE, ".dsgd.GradUpdate", True),
    ):
        fld = fr.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_OPTIONAL
        if type_name:
            fld.type_name = type_name
        if in_oneof:
            fld.oneof_index = 0
    worker = next(s for s in fdp.service if s.name == "Worker")
    m = worker.method.add()
    m.name = "FitStream"
    m.input_type = ".dsgd.Frame"
    m.output_type = ".dsgd.Frame"
    m.client_streaming = True
    m.server_streaming = True
    return fdp


# -- cluster telemetry surface (rpc/proto/dsgd.proto "telemetry") -------------


def _splice_telemetry(fdp):
    """Add the Metrics-scrape messages (docs/OBSERVABILITY.md "cluster
    telemetry plane") to the descriptor, same technique as the splices
    above.  Only NEW top-level messages are added — no existing message
    gains a field — so every pre-telemetry wire form stays byte-identical
    (asserted by tests/test_telemetry.py's field-list drift gate)."""

    def message(name, *fields):
        m = fdp.message_type.add()
        m.name = name
        for number, fname, ftype, repeated in fields:
            fld = m.field.add()
            fld.name = fname
            fld.number = number
            fld.type = ftype
            fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
            if repeated:  # match the [packed = true] of SparseTensor
                fld.options.packed = True
        return m

    message(
        "MetricCounter",
        (1, "name", _F.TYPE_STRING, False),
        (2, "value", _F.TYPE_INT64, False),
    )
    message(
        "MetricGauge",
        (1, "name", _F.TYPE_STRING, False),
        (2, "value", _F.TYPE_DOUBLE, False),
    )
    # bucket counts index into the shared fixed bounds
    # (utils/metrics.py Histogram.BUCKET_BOUNDS), so the wire ships only
    # the counts and cross-worker bucket sums stay exact
    message(
        "MetricHistogram",
        (1, "name", _F.TYPE_STRING, False),
        (2, "count", _F.TYPE_INT64, False),
        (3, "sum", _F.TYPE_DOUBLE, False),
        (4, "min", _F.TYPE_DOUBLE, False),
        (5, "max", _F.TYPE_DOUBLE, False),
        (6, "last", _F.TYPE_DOUBLE, False),
        (7, "buckets", _F.TYPE_INT64, True),
    )
    snap = message(
        "MetricsSnapshot",
        (1, "role", _F.TYPE_STRING, False),
        (2, "node", _F.TYPE_STRING, False),
    )
    for number, fname, type_name in (
        (3, "counters", ".dsgd.MetricCounter"),
        (4, "gauges", ".dsgd.MetricGauge"),
        (5, "hists", ".dsgd.MetricHistogram"),
    ):
        fld = snap.field.add()
        fld.name = fname
        fld.number = number
        fld.type = _F.TYPE_MESSAGE
        fld.type_name = type_name
        fld.label = _F.LABEL_REPEATED
    return fdp


# -- aggregation-tree surface (rpc/proto/dsgd.proto "aggregation tree") -------


def _splice_aggtree(fdp):
    """Add the sub-aggregator plane (docs/AGGREGATION.md, DSGD_AGG_TREE)
    to the descriptor, same technique as the splices above.  Every new
    field defaults to 0/""/empty and is only ever set by a tree-enabled
    master or an elected aggregator, so the knobs-off wire stays
    byte-identical (asserted by tests/test_aggtree.py)."""
    gr = next(m for m in fdp.message_type if m.name == "GradientRequest")
    for number, name, ftype, repeated in (
        # this worker's elected parent ("host:port"); absent = reply the
        # payload straight to the master (root child, or flat topology)
        (11, "agg_parent", _F.TYPE_STRING, False),
        # per-ATTEMPT round id: retries bump it, so a stale child push
        # for the abandoned attempt can never double-count into the new
        # attempt's reduce buffer
        (12, "agg_round", _F.TYPE_INT64, False),
        # child-wait budget for this node's collect, scaled by its
        # subtree height so deep chains cascade inside grad_timeout_s
        (13, "agg_wait_ms", _F.TYPE_INT32, False),
        # this node's children in CANONICAL accumulation order (float
        # addition is order-sensitive; the stamped order IS the sum's
        # determinism witness)
        (14, "agg_children", _F.TYPE_STRING, True),
    ):
        fld = gr.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL

    gu = next(m for m in fdp.message_type if m.name == "GradUpdate")
    for number, name, ftype, repeated in (
        # contributor set of a subtree sum ("host:port" per contributor):
        # the master averages over the TOTAL contributor count, so a
        # partial subtree stays an unbiased mean over who actually summed
        (6, "agg_contributors", _F.TYPE_STRING, True),
        # ack arm: the payload traveled up the tree instead (this reply
        # carries no grad oneof — receivers decode it as zero)
        (7, "agg_forwarded", _F.TYPE_BOOL, False),
        # one or more children missed the wait budget; the contributor
        # set says who made it
        (8, "agg_partial", _F.TYPE_BOOL, False),
        # upstream push failed: this reply carries the subtree sum
        # direct-to-master (flat fallback — performance lost, round kept)
        (9, "agg_flat", _F.TYPE_BOOL, False),
    ):
        fld = gu.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL

    ag = fdp.message_type.add()
    ag.name = "AggGrad"
    for number, name, ftype, type_name in (
        (1, "fit_token", _F.TYPE_INT64, None),
        (2, "round", _F.TYPE_INT64, None),
        (3, "origin", _F.TYPE_STRING, None),
        (4, "update", _F.TYPE_MESSAGE, ".dsgd.GradUpdate"),
    ):
        fld = ag.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        if type_name:
            fld.type_name = type_name
        fld.label = _F.LABEL_OPTIONAL

    worker = next(s for s in fdp.service if s.name == "Worker")
    m = worker.method.add()
    m.name = "AggregateGrad"
    m.input_type = ".dsgd.AggGrad"
    m.output_type = ".dsgd.Ack"
    return fdp


# -- sharded master surface (rpc/proto/dsgd.proto "sharded master") ----------


def _splice_shardedps(fdp):
    """Add the feature-sharded master plane (docs/MASTER_SHARDING.md,
    DSGD_MASTER_SHARDS) to the descriptor, same technique as the
    splices above.  Every new field defaults to 0 and is only ever set
    by a shard-enabled coordinator (or echoed by a worker answering
    one), so the knobs-off wire stays byte-identical — proto3 unset
    scalar fields serialize to nothing (tests/test_shardedps.py)."""
    gr = next(m for m in fdp.message_type if m.name == "GradientRequest")
    for number, name, ftype in (
        # which shard lane this request belongs to, [0, shard_count)
        (15, "shard_index", _F.TYPE_INT32),
        # total lanes in the coordinator's current shard plan; 0/absent
        # = flat (unsharded) wire — the ONE bit workers branch on
        (16, "shard_count", _F.TYPE_INT32),
        # this lane's contiguous feature range [shard_lo, shard_hi):
        # the weight arm is in SHARD FRAME (a (hi-lo)-long slice), and
        # the reply must carry the gradient's same range
        (17, "shard_lo", _F.TYPE_INT32),
        (18, "shard_hi", _F.TYPE_INT32),
        # per-ATTEMPT rendezvous round, shared by all M lanes of one
        # window (retries bump it): the worker assembles the M slices
        # of one round into one weight vector and computes ONCE
        (19, "shard_round", _F.TYPE_INT64),
    ):
        fld = gr.field.add()
        fld.name = name
        fld.number = number
        fld.type = ftype
        fld.label = _F.LABEL_OPTIONAL

    gu = next(m for m in fdp.message_type if m.name == "GradUpdate")
    fld = gu.field.add()
    # echo of the request's lane index — self-describing replies for
    # flight/trace attribution (the master routes by future, not this)
    fld.name = "shard_index"
    fld.number = 10
    fld.type = _F.TYPE_INT32
    fld.label = _F.LABEL_OPTIONAL
    return fdp


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    _splice_shardedps(_splice_aggtree(_splice_stream(_splice_hierarchy(
        _splice_telemetry(_splice_quorum(_splice_sync_pipeline(
            _splice_compression(_RAW_DSGD)))))))).SerializeToString())

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dsgd_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SPARSETENSOR.fields_by_name['indices']._options = None
  _SPARSETENSOR.fields_by_name['indices']._serialized_options = b'\020\001'
  _SPARSETENSOR.fields_by_name['values']._options = None
  _SPARSETENSOR.fields_by_name['values']._serialized_options = b'\020\001'
  _FORWARDREQUEST.fields_by_name['samples']._options = None
  _FORWARDREQUEST.fields_by_name['samples']._serialized_options = b'\020\001'
  _FORWARDREPLY.fields_by_name['predictions']._options = None
  _FORWARDREPLY.fields_by_name['predictions']._serialized_options = b'\020\001'
  _FORWARDREPLY.fields_by_name['margins']._options = None
  _FORWARDREPLY.fields_by_name['margins']._serialized_options = b'\020\001'
  _GRADIENTREQUEST.fields_by_name['samples']._options = None
  _GRADIENTREQUEST.fields_by_name['samples']._serialized_options = b'\020\001'
  _STARTASYNCREQUEST.fields_by_name['samples']._options = None
  _STARTASYNCREQUEST.fields_by_name['samples']._serialized_options = b'\020\001'
  _COMPRESSEDGRAD.fields_by_name['indices']._options = None
  _COMPRESSEDGRAD.fields_by_name['indices']._serialized_options = b'\020\001'
  _COMPRESSEDGRAD.fields_by_name['values']._options = None
  _COMPRESSEDGRAD.fields_by_name['values']._serialized_options = b'\020\001'
  _COMPRESSEDGRAD.fields_by_name['scales']._options = None
  _COMPRESSEDGRAD.fields_by_name['scales']._serialized_options = b'\020\001'
  _WEIGHTDELTA.fields_by_name['indices']._options = None
  _WEIGHTDELTA.fields_by_name['indices']._serialized_options = b'\020\001'
  _WEIGHTDELTA.fields_by_name['values']._options = None
  _WEIGHTDELTA.fields_by_name['values']._serialized_options = b'\020\001'
  # the protoc-emitted _serialized_start/_end offsets were dropped here:
  # they indexed into the pre-splice blob and are pure codegen metadata
# @@protoc_insertion_point(module_scope)


# -- serving surface (dsgd_serve.proto) --------------------------------------
#
# The serving messages are NOT part of the protoc-serialized blob above:
# grpc_tools/protoc is unavailable in this image (see rpc/service.py
# docstring), so they are declared as a programmatic FileDescriptorProto and
# registered in the same default descriptor pool.  Wire-compatible with a
# protoc-generated module for the IDL in rpc/proto/dsgd.proto ("serving
# surface" section); the dsgd.Serving method table lives in rpc/service.py
# next to Master/Worker.

from google.protobuf import descriptor_pb2 as _descriptor_pb2
from google.protobuf import message_factory as _message_factory

_F = _descriptor_pb2.FieldDescriptorProto


def _serve_file() -> _descriptor_pb2.FileDescriptorProto:
    f = _descriptor_pb2.FileDescriptorProto(
        name="dsgd_serve.proto", package="dsgd", syntax="proto3"
    )
    # PushWeights reuses the training wire's Tensor + WeightDelta message
    # types (the _RAW_DSGD file registered above), so the serving file
    # declares the cross-file dependency instead of re-declaring them
    f.dependency.append("dsgd.proto")

    def message(name, *fields):
        m = f.message_type.add()
        m.name = name
        for number, fname, ftype, repeated in fields:
            fld = m.field.add()
            fld.name = fname
            fld.number = number
            fld.type = ftype
            fld.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
            if repeated:  # match the [packed = true] of SparseTensor above
                fld.options.packed = True
        return m

    # One sparse feature row (same coordinate-list layout as SparseTensor;
    # no `size` — the server knows the model dimension).
    message(
        "PredictRequest",
        (1, "indices", _F.TYPE_INT32, True),
        (2, "values", _F.TYPE_FLOAT, True),
    )
    message(
        "PredictReply",
        (1, "prediction", _F.TYPE_FLOAT, False),
        (2, "margin", _F.TYPE_FLOAT, False),
        # checkpoint step of the weights that answered — observability for
        # hot-reload (which snapshot served me?)
        (3, "model_step", _F.TYPE_INT64, False),
    )
    message(
        "ServeHealthReply",
        (1, "ok", _F.TYPE_BOOL, False),
        (2, "model_step", _F.TYPE_INT64, False),
        (3, "queue_depth", _F.TYPE_INT32, False),
    )

    # -- delta checkpoint distribution (docs/SERVING.md "serving fleet") ----
    # The trainer's master streams versioned weight updates to the fleet:
    # `weights` (full tensor — first contact, or any version-gap fallback)
    # or `delta` (sparse absolute-value update on top of the replica's
    # current snapshot at delta.base_version) — the SAME WeightDelta codec
    # the sync broadcast plane uses (rpc/codec.py encode_weight_delta).
    pw = message(
        "PushWeightsRequest",
        (1, "version", _F.TYPE_INT64, False),
    )
    for number, fname, type_name in (
        (2, "weights", ".dsgd.Tensor"),
        (3, "delta", ".dsgd.WeightDelta"),
    ):
        fld = pw.field.add()
        fld.name = fname
        fld.number = number
        fld.type = _F.TYPE_MESSAGE
        fld.type_name = type_name
        fld.label = _F.LABEL_OPTIONAL
    # ok=false signals a version gap (a delta whose base the replica does
    # not hold): the pusher resends full, and the replica may additionally
    # fall back to a full-file checkpoint reload; model_step reports what
    # the replica serves NOW either way.
    message(
        "PushWeightsReply",
        (1, "ok", _F.TYPE_BOOL, False),
        (2, "model_step", _F.TYPE_INT64, False),
    )

    # -- serving-plane HA (docs/SERVING.md "HA"; DSGD_SERVE_HA) -------------
    # Peer routers exchange their versioned promoted-state record: the
    # monotonically-numbered `seq` totally orders promote/rollback/
    # probe-baseline transitions, so whichever side carries the HIGHER seq
    # wins the exchange and a rejoining router can never resurrect a
    # rolled-back version.  Both directions carry the FULL record (request
    # = sender's state, reply = receiver's state after applying), so one
    # exchange converges the pair no matter which side is stale.  proto3
    # scalars serialize to nothing when unset, and the `has_*` bools make
    # "no promoted version yet" distinguishable from version 0.
    ha_record = (
        (2, "seq", _F.TYPE_INT64, False),
        (3, "has_promoted", _F.TYPE_BOOL, False),
        (4, "promoted_version", _F.TYPE_INT64, False),
        (5, "has_best", _F.TYPE_BOOL, False),
        (6, "best_loss", _F.TYPE_DOUBLE, False),
        (7, "rejected", _F.TYPE_INT64, True),
    )
    message(
        "SyncServeStateRequest",
        # sender's endpoint label ("host:port") — feeds the receiver's
        # peer-liveness clock (the lease's failure detector)
        (1, "node", _F.TYPE_STRING, False),
        *ha_record,
        # sender holds the decider lease right now (observability; the
        # lease itself is decided by the coordinator, not this flag)
        (8, "decider", _F.TYPE_BOOL, False),
    )
    message(
        "SyncServeStateReply",
        (1, "applied", _F.TYPE_BOOL, False),
        *ha_record,
    )
    return f


_serve_fd = _descriptor_pool.Default().Add(_serve_file())
PredictRequest = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["PredictRequest"])
PredictReply = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["PredictReply"])
ServeHealthReply = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["ServeHealthReply"])
PushWeightsRequest = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["PushWeightsRequest"])
PushWeightsReply = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["PushWeightsReply"])
SyncServeStateRequest = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["SyncServeStateRequest"])
SyncServeStateReply = _message_factory.GetMessageClass(
    _serve_fd.message_types_by_name["SyncServeStateReply"])
