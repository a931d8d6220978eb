"""S whole sync SGD steps in one launch: the CUDA cluster kernel and its
plain version.

``sync_epoch(w, ids, indices, values, labels_f32, ...) -> w_out`` runs, for
each step s with sample ids ``ids[s]`` (``[K, B]`` rows of the data),

    g_k = sum_b grad_coeff(x_b . w, y_b) * x_b      for each worker k
    g_k = g_k / grad_divisor
    g_k = regularize(g_k, w)                         per worker, by reg_kind
    w   = w - lr * (sum_k g_k) / n_total_workers

— with ``grad_divisor`` 1, what the sync engine's per-step path
(parallel/sync.py ``_one_step``) computes ``S`` times over, and through it
the JAX engine's step (the Pallas ``worker_grads``, ``regularize_blocked``
per worker, the sum, the mean and the update).  In the mean mode (K = 1,
``grad_divisor`` = B) each step is the JAX async engines' local step:
``grad_mean``, ``regularize``, ``w - lr*g``.  The input ``w`` is left
untouched.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/sync_epoch.cu`` (one thread-block cluster holding w, dim_sparsity
and g in distributed shared memory for the whole run; built at first use,
ops/_build.py) or raises.  On a CPU tensor it runs ``sync_epoch_plain``.
``sync_epoch.launches`` counts kernel launches and ``sync_epoch.steps`` the
steps they ran; the async engines launch from several threads, so both are
added under a lock.

``cluster_plan(K, D)`` says whether that state fits the cluster's shared
memory; the engine picks its path by it, before any launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from distributed_sgd_tpu_torch.ops.worker_grads import COEFF_KINDS, worker_grads_plain

REG_KINDS = ("dim_sparsity", "l2", "none")  # the kernel's reg_kind is the index
CLUSTER_BLOCKS = 8  # the portable cluster size
SMEM_BYTES_PER_BLOCK = 232_448  # what one Hopper block may use (227 KB)
_SCRATCH_FLOATS = 2 + 32  # the w . dim_sparsity partial by step parity, one sum per warp
_CLUSTER_UNSCHEDULABLE = 100000  # the C function's code for that
_counts_lock = threading.Lock()


class ClusterPlan(NamedTuple):
    blocks: int  # blocks in the one cluster
    slice: int  # entries of w (and of each g_k, dim_sparsity) each block owns
    smem_bytes: int  # dynamic shared memory per block


def cluster_plan(k: int, d: int) -> Optional[ClusterPlan]:
    """The cluster that holds w, dim_sparsity and g[K, D] in shared memory,
    or None when that state does not fit (at D=47,236: K <= 7)."""
    if k < 1 or d < 1:
        return None
    owned = -(-d // CLUSTER_BLOCKS)
    owned = -(-owned // 4) * 4  # 16-byte aligned sub-arrays
    smem = 4 * ((2 + k) * owned + _SCRATCH_FLOATS)
    if smem > SMEM_BYTES_PER_BLOCK:
        return None
    return ClusterPlan(CLUSTER_BLOCKS, owned, smem)


def regularize(gk: torch.Tensor, w: torch.Tensor, reg_kind: str, lam: float,
               dim_sparsity: Optional[torch.Tensor]) -> torch.Tensor:
    """Add the regularizer `reg_kind` to gradient sums `gk` ([D], or [K, D]
    for K workers, each masked by its own nonzeros)."""
    if reg_kind == "dim_sparsity":
        scalar = lam * 2.0 * torch.dot(w.float(), dim_sparsity)
        return gk + torch.where(gk != 0, scalar, torch.zeros_like(gk))
    if reg_kind == "l2":
        return gk + 2.0 * lam * w
    if reg_kind == "none":
        return gk
    raise ValueError(f"reg_kind must be one of {REG_KINDS}, got {reg_kind!r}")


def sync_epoch_plain(w, ids, indices, values, labels_f32, *, coeff_kind, reg_kind,
                     lam, dim_sparsity, lr, n_total_workers,
                     grad_divisor: float = 1) -> torch.Tensor:
    """The kernel's function in plain torch: the per-step path's arithmetic
    in a loop over ``ids[S, K, B]``."""
    for rows in ids:
        gk = worker_grads_plain(w, indices[rows], values[rows], labels_f32[rows], coeff_kind)
        gk = regularize(gk / grad_divisor, w, reg_kind, lam, dim_sparsity)  # / 1 is exact
        w = w - lr * (gk.sum(dim=0) / n_total_workers)
    return w.clone() if ids.shape[0] == 0 else w


def _check(w, ids, indices, values, labels_f32, coeff_kind, reg_kind, dim_sparsity,
           n_total_workers, grad_divisor):
    if coeff_kind not in COEFF_KINDS:
        raise ValueError(f"coeff_kind must be one of {COEFF_KINDS}, got {coeff_kind!r}")
    if reg_kind not in REG_KINDS:
        raise ValueError(f"reg_kind must be one of {REG_KINDS}, got {reg_kind!r}")
    if n_total_workers < 1:
        raise ValueError(f"n_total_workers must be >= 1, got {n_total_workers}")
    if not grad_divisor > 0:
        raise ValueError(f"grad_divisor must be > 0, got {grad_divisor}")
    if w.dim() != 1 or ids.dim() != 3 or indices.dim() != 2 or labels_f32.dim() != 1:
        raise ValueError(
            f"want w[D], ids[S, K, B], indices/values[N, P], labels[N]; got "
            f"w{list(w.shape)}, ids{list(ids.shape)}, indices{list(indices.shape)}, "
            f"labels{list(labels_f32.shape)}")
    if values.shape != indices.shape or labels_f32.shape[0] != indices.shape[0]:
        raise ValueError(
            f"shape mismatch: indices{list(indices.shape)} values{list(values.shape)} "
            f"labels{list(labels_f32.shape)}")
    tensors = [("w", w, torch.float32), ("ids", ids, torch.int64),
               ("indices", indices, torch.int32), ("values", values, torch.float32),
               ("labels_f32", labels_f32, torch.float32)]
    if reg_kind == "dim_sparsity":
        if dim_sparsity is None or dim_sparsity.shape != w.shape:
            raise ValueError(f"reg_kind='dim_sparsity' needs dim_sparsity f32{list(w.shape)}")
        tensors.append(("dim_sparsity", dim_sparsity, torch.float32))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel():
    """The C entry point with its argument types, the library built at
    first use."""
    from distributed_sgd_tpu_torch.ops import _build

    fn = _build.load("sync_epoch").dsgd_sync_epoch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def _launch(w, ids, indices, values, labels_f32, coeff_kind, reg_kind, lam,
            dim_sparsity, lr, n_total_workers, grad_divisor):
    s, k, b = ids.shape
    n, p = indices.shape
    d = w.shape[0]
    plan = cluster_plan(k, d)
    if plan is None:
        raise ValueError(
            f"K={k} workers at D={d} do not fit one cluster's shared memory "
            f"(cluster_plan); run the per-step path")
    fn = _kernel()
    ds_ptr = dim_sparsity.data_ptr() if reg_kind == "dim_sparsity" else 0
    with torch.cuda.device(w.device):
        w_out = torch.empty_like(w)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), ds_ptr, ids.data_ptr(), indices.data_ptr(),
                 values.data_ptr(), labels_f32.data_ptr(), w_out.data_ptr(), n, s, k, b,
                 p, d, plan.blocks, plan.slice, plan.smem_bytes, coeff_kind,
                 REG_KINDS.index(reg_kind), 2.0 * lam, lr, float(n_total_workers),
                 float(grad_divisor), stream)
    if err == _CLUSTER_UNSCHEDULABLE:
        raise RuntimeError(
            f"sync_epoch: a cluster of {plan.blocks} blocks with {plan.smem_bytes} B of "
            f"shared memory each cannot be scheduled on this card")
    if err != 0:
        raise RuntimeError(f"sync_epoch kernel launch failed: cudaError {err}")
    with _counts_lock:
        sync_epoch.launches += 1
        sync_epoch.steps += s
    return w_out


def sync_epoch(w: torch.Tensor, ids: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor, labels_f32: torch.Tensor, *, coeff_kind: int,
               reg_kind: str, lam: float, dim_sparsity: Optional[torch.Tensor],
               lr: float, n_total_workers: int, grad_divisor: float = 1) -> torch.Tensor:
    """The weights after ``ids.shape[0]`` sync steps from `w` (f32[D]) over
    the data ``indices`` i32[N, P], ``values`` f32[N, P], ``labels_f32``
    f32[N]; ``grad_divisor`` B gives the async mean mode.  CUDA tensors
    launch the kernel (or raise); CPU tensors run `sync_epoch_plain`."""
    _check(w, ids, indices, values, labels_f32, coeff_kind, reg_kind, dim_sparsity,
           n_total_workers, grad_divisor)
    args = (w, ids, indices, values, labels_f32)
    kw = dict(coeff_kind=coeff_kind, reg_kind=reg_kind, lam=lam, dim_sparsity=dim_sparsity,
              lr=lr, n_total_workers=n_total_workers, grad_divisor=grad_divisor)
    if w.device.type == "cuda":
        return _launch(*args, **kw)
    if w.device.type == "cpu":
        return sync_epoch_plain(*args, **kw)
    raise ValueError(f"sync_epoch runs on cuda or cpu tensors, got {w.device}")


sync_epoch.launches = 0
sync_epoch.steps = 0
