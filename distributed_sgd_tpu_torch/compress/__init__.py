"""Pluggable gradient compression (DSGD_COMPRESS).

The port of the JAX package's compress/, on its wire: every gradient that
crosses the wire -- the sync fan-in replies (core/worker.py Gradient), the
async delta gossip (core/worker.py, parallel/hogwild.py) and the
master-bound update stream -- goes through a `Compressor`, which turns a
dense f32 vector into a `GradUpdate` wire message and keeps the
per-destination error-feedback state that makes the lossy codecs
converge:

- ``none``   identity; `make_compressor` returns None, so the hot paths
             keep their ``codec.encode_grad`` calls byte for byte (the
             `NoneCompressor` class exists for tests driving every codec
             through one interface);
- ``topk``   magnitude top-k sparsification (Deep Gradient Compression,
             Lin et al.): ship the k largest-|x| coordinates, keep the rest
             in a per-destination residual that rides a later message.
             The selection and the residual live on the compressor's
             device (ops/topk.py): only the k chosen values cross to the
             host;
- ``qint8``  stochastic int8 quantization with per-chunk scales (QSGD,
             Alistarh et al.): full support, 4x fewer payload bytes,
             unbiased codes; the quantization error optionally fed back.
             Numpy on the host, as in JAX: its codes come from a numpy
             generator stream, which a torch generator would change.

Every message is still a plain weight-space delta: error feedback moves
WHEN a coordinate's mass ships, never what the receiving merge does with
it, so the commutative merges of the async engines are untouched.
"""

from distributed_sgd_tpu_torch.compress.codecs import (  # noqa: F401
    Compressor,
    NoneCompressor,
    QInt8Compressor,
    TopKCompressor,
    make_compressor,
)

COMPRESS_CHOICES = ("none", "topk", "qint8")
