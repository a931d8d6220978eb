"""Fused per-worker gradient sums: the CUDA kernel and its plain version.

``worker_grads(w, idx, val, y, coeff) -> f32[K, D]`` computes, for
each of K workers over its B padded rows,

    m_b = x_b . w,    c_b = grad_coeff(m_b, y_b),    g_k = sum_b c_b * x_b

— what the JAX package's Pallas kernel (distributed_sgd_tpu/ops/
pallas_sparse.py::worker_grads) computes, on flat ``f32[D]`` weights
instead of the TPU's lane-blocked ``[R, 128]`` view.  Pad entries
(idx 0, val 0, y 0) are inert.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/worker_grads.cu`` (built at first use, ops/_build.py) or raises:
one launch a call, K x R blocks, each summing a range of its worker's
features in 64-bit integers in its shared memory at a power-of-two scale,
so one input always gives one output bit for bit (csrc/worker_grads.cu
says how; ``launch_plan`` gives R).  On a CPU tensor it runs
``worker_grads_plain``, the same function in plain torch.
``worker_grads.launches`` counts calls that launched the kernel (and
``worker_grads.user_launches`` those of a user rule's variant), under a
lock: the RPC workers of one process call it from several threads.

The rule ``coeff`` is the JAX kernel's ``coeff_fn`` (ops/coeff.py): a
built-in kind (HINGE, LOGISTIC, LEAST_SQUARES), or a model's own rule, a
`Coeff` of kind USER, whose torch function the plain version applies and
whose CUDA body runs in the kernel's variant (built per rule, ops/
_build.py).  A user rule without CUDA raises on a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from distributed_sgd_tpu_torch.ops import coeff as co

_counts_lock = threading.Lock()

COEFF_CHUNK = 512  # samples whose coefficients a block keeps at once
# entries a block walks at once: its 1,024 threads, 8 each (csrc/worker_grads.cu
# kThreads * kPerThread)
WALK = 8 * 1024
# Features a block owns at most: 8 blocks a worker at 47,236 features, each
# sharing out the zero-fill, the atomics and the write (and each reading all
# of its worker's rows, from L2).  A block's shared memory, 8 bytes a feature
# and 4 a coefficient, stays within 51,208 bytes of the 232,448 a Hopper
# block may have, whatever D (the kernel declares no static __shared__).
SPAN_TARGET = 6144


def _check(w, idx, val, y, coeff) -> co.Coeff:
    """The resolved rule, after checking every argument."""
    rule = co.resolve(coeff)
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
    return rule


def worker_grads_plain(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                       y: torch.Tensor, coeff) -> torch.Tensor:
    """The kernel's function in plain torch: ``index_select`` and a row sum
    for the margins, the coefficient, then one ``index_add_`` over all
    workers' rows (worker k's ids offset by k*D)."""
    k, b, p = idx.shape
    d = w.shape[0]
    flat = idx.reshape(-1).long()
    margins = (w.index_select(0, flat).view(k, b, p) * val).sum(dim=-1)
    c = co.resolve(coeff).plain(margins, y)
    contrib = (c[..., None] * val).reshape(-1)
    offset = (torch.arange(k, device=w.device) * d).view(k, 1, 1)
    g = torch.zeros(k * d, dtype=torch.float32, device=w.device)
    g.index_add_(0, (idx.long() + offset).reshape(-1), contrib)
    return g.view(k, d)


class LaunchPlan(NamedTuple):
    ranges: int  # R: blocks a worker
    span: int  # features a block owns; the last block may own fewer
    cap: int  # coefficients a block keeps at once
    smem: int  # dynamic shared bytes a block: int64 sums, f32 coefficients, two words


@functools.lru_cache(maxsize=1024)
def launch_plan(k: int, b: int, p: int, d: int) -> LaunchPlan:
    """The kernel's grid for K workers of B rows of P entries over D
    features: R ranges a worker of at most SPAN_TARGET features, so any D
    is taken.  The kernel's entry point checks the same invariants."""
    # a block walks a chunk's cap * P entries with int indices
    cap = max(1, min(b, COEFF_CHUNK, (2 ** 31 - 1 - WALK) // max(1, p)))
    ranges = max(1, math.ceil(d / SPAN_TARGET))
    span = max(1, math.ceil(d / ranges))
    ranges = max(1, math.ceil(d / span))
    return LaunchPlan(ranges, span, cap, 8 * span + 4 * cap + 8)


_fns = {}  # the rule's content key (None: the built-in library) -> its entry point


def _kernel(rule: co.Coeff):
    """The C entry point of the library for `rule` with its argument types,
    the library built and bound at first use."""
    key = rule.key if rule.kind == co.USER else None
    fn = _fns.get(key)
    if fn is None:
        from distributed_sgd_tpu_torch.ops import _build

        fn = _build.load("worker_grads", rule if key else None).dsgd_worker_grads
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _launch(w, idx, val, y, rule: co.Coeff):
    k, b, p = idx.shape
    d = w.shape[0]
    plan = launch_plan(k, b, p, d)
    fn = _kernel(rule)
    g = torch.empty((k, d), dtype=torch.float32, device=w.device)  # written whole by the kernel
    dev = w.device.index
    # the raw current stream: no torch.cuda.Stream object, no device switch
    # where w's device is current
    with contextlib.nullcontext() if dev == torch.cuda.current_device() else torch.cuda.device(dev):
        err = fn(w.data_ptr(), idx.data_ptr(), val.data_ptr(), y.data_ptr(), g.data_ptr(),
                 k, b, p, d, rule.kind, *plan, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"worker_grads kernel launch failed: cudaError {err}")
    with _counts_lock:
        worker_grads.launches += 1
        if rule.kind == co.USER:
            worker_grads.user_launches += 1
    return g


def worker_grads(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                 y: torch.Tensor, coeff) -> torch.Tensor:
    """Fused gradients for K workers: f32[K, D] from w f32[D], idx i32[K,B,P],
    val f32[K,B,P], y f32[K,B], under the rule `coeff` (a built-in kind or
    a `Coeff`).  CUDA tensors launch the kernel (or raise); CPU tensors
    run `worker_grads_plain`."""
    rule = _check(w, idx, val, y, coeff)
    if w.device.type == "cuda":
        co.check_launchable(rule, w.device)
    if idx.shape[1] == 0:  # no rows: nothing to launch, every g_k is zero
        return torch.zeros((idx.shape[0], w.shape[0]), dtype=torch.float32, device=w.device)
    if w.device.type == "cuda":
        return _launch(w, idx, val, y, rule)
    if w.device.type == "cpu":
        return worker_grads_plain(w, idx, val, y, rule)
    raise ValueError(f"worker_grads runs on cuda or cpu tensors, got {w.device}")


worker_grads.launches = 0
worker_grads.user_launches = 0  # of them, launches of a user rule's variant
