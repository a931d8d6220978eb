"""Fused per-worker gradient sums: the CUDA kernel and its plain version.

``worker_grads(w, idx, val, y, coeff_kind) -> f32[K, D]`` computes, for
each of K workers over its B padded rows,

    m_b = x_b . w,    c_b = grad_coeff(m_b, y_b),    g_k = sum_b c_b * x_b

— what the JAX package's Pallas kernel (distributed_sgd_tpu/ops/
pallas_sparse.py::worker_grads) computes, on flat ``f32[D]`` weights
instead of the TPU's lane-blocked ``[R, 128]`` view.  Pad entries
(idx 0, val 0, y 0) are inert.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/worker_grads.cu`` (built at first use, ops/_build.py) or raises.
The kernel sums each g_k in 64-bit integers at a power-of-two scale, so
one input always gives one output bit for bit (csrc/worker_grads.cu says
how).  On a CPU tensor it runs ``worker_grads_plain``, the same function
in plain torch.  ``worker_grads.launches`` counts calls that launched the
kernel (three kernels on the current stream), under
a lock: the RPC workers of one process call it from several threads.

A Python coefficient function cannot be traced into CUDA the way the JAX
package traces ``coeff_fn`` into Pallas, so each model names its rule by
``coeff_kind`` (HINGE, LOGISTIC, LEAST_SQUARES); ``grad_coeff`` is the one
torch definition of each rule and the kernel mirrors it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

HINGE, LOGISTIC, LEAST_SQUARES = 0, 1, 2
COEFF_KINDS = (HINGE, LOGISTIC, LEAST_SQUARES)
_counts_lock = threading.Lock()


def grad_coeff(kind: int, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample gradient coefficient of rule `kind` (labels as f32)."""
    yf = y.float()
    if kind == HINGE:
        # backward = 0 if y*(x.w) < 0 else y  (reference hinge subgradient)
        return torch.where(yf * margins < 0, torch.zeros_like(yf), yf)
    if kind == LOGISTIC:
        return -yf * torch.sigmoid(-yf * margins)
    if kind == LEAST_SQUARES:
        return 2.0 * (margins - yf)
    raise ValueError(f"coeff_kind must be one of {COEFF_KINDS}, got {kind!r}")


def _check(w, idx, val, y, coeff_kind):
    if coeff_kind not in COEFF_KINDS:
        raise ValueError(f"coeff_kind must be one of {COEFF_KINDS}, got {coeff_kind!r}")
    if w.dim() != 1 or idx.dim() != 3 or y.dim() != 2:
        raise ValueError(
            f"want w[D], idx/val[K, B, P], y[K, B]; got w{list(w.shape)}, "
            f"idx{list(idx.shape)}, y{list(y.shape)}")
    if val.shape != idx.shape or y.shape != idx.shape[:2]:
        raise ValueError(
            f"shape mismatch: idx{list(idx.shape)} val{list(val.shape)} "
            f"y{list(y.shape)}")
    for name, t, dtype in (("w", w, torch.float32), ("idx", idx, torch.int32),
                           ("val", val, torch.float32), ("y", y, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def worker_grads_plain(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                       y: torch.Tensor, coeff_kind: int) -> torch.Tensor:
    """The kernel's function in plain torch: ``index_select`` and a row sum
    for the margins, the coefficient, then one ``index_add_`` over all
    workers' rows (worker k's ids offset by k*D)."""
    k, b, p = idx.shape
    d = w.shape[0]
    flat = idx.reshape(-1).long()
    margins = (w.index_select(0, flat).view(k, b, p) * val).sum(dim=-1)
    coeff = grad_coeff(coeff_kind, margins, y)
    contrib = (coeff[..., None] * val).reshape(-1)
    offset = (torch.arange(k, device=w.device) * d).view(k, 1, 1)
    g = torch.zeros(k * d, dtype=torch.float32, device=w.device)
    g.index_add_(0, (idx.long() + offset).reshape(-1), contrib)
    return g.view(k, d)


def _launch(w, idx, val, y, coeff_kind):
    from distributed_sgd_tpu_torch.ops import _build

    lib = _build.load("worker_grads")
    fn = lib.dsgd_worker_grads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    k, b, p = idx.shape
    d = w.shape[0]
    with torch.cuda.device(w.device):
        g = torch.empty((k, d), dtype=torch.float32, device=w.device)  # zeroed by the kernel
        # scratch: the integer sums; the coefficients, the sample maxima and
        # each worker's maximum (float bits)
        acc = torch.empty((k, d), dtype=torch.int64, device=w.device)
        scratch = torch.empty((2 * k * b + k,), dtype=torch.float32, device=w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), idx.data_ptr(), val.data_ptr(), y.data_ptr(),
                 g.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
                 k, b, p, d, coeff_kind, stream)
    if err != 0:
        raise RuntimeError(f"worker_grads kernel launch failed: cudaError {err}")
    with _counts_lock:
        worker_grads.launches += 1
    return g


def worker_grads(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                 y: torch.Tensor, coeff_kind: int) -> torch.Tensor:
    """Fused gradients for K workers: f32[K, D] from w f32[D], idx i32[K,B,P],
    val f32[K,B,P], y f32[K,B].  CUDA tensors launch the kernel (or raise);
    CPU tensors run `worker_grads_plain`."""
    _check(w, idx, val, y, coeff_kind)
    if idx.shape[1] == 0:  # no rows: nothing to launch, every g_k is zero
        return torch.zeros((idx.shape[0], w.shape[0]), dtype=torch.float32, device=w.device)
    if w.device.type == "cuda":
        return _launch(w, idx, val, y, coeff_kind)
    if w.device.type == "cpu":
        return worker_grads_plain(w, idx, val, y, coeff_kind)
    raise ValueError(f"worker_grads runs on cuda or cpu tensors, got {w.device}")


worker_grads.launches = 0
