"""S whole sync SGD steps in one launch: the CUDA cluster kernel and its
plain version.

``sync_epoch(w, ids, indices, values, labels_f32, ...) -> w_out`` runs, for
each step s with sample ids ``ids[s]`` (``[K, B]`` rows of the data),

    g_k = sum_b grad_coeff(x_b . w, y_b) * x_b      for each worker k
    g_k = g_k / grad_divisor
    g_k = regularize(g_k, w)                         per worker, by reg_kind
    g   = (sum_k g_k) / n_total_workers
    w   = update(w, g)                               by the optimizer

— with ``grad_divisor`` 1, what the sync engine's per-step path
(parallel/sync.py ``_one_step``) computes ``S`` times over, and through it
the JAX engine's step (the Pallas ``worker_grads``, ``regularize_blocked``
per worker, the sum, the mean and the optax update).  In the mean mode
(K = 1, ``grad_divisor`` = B) each step is the JAX async engines' local
step: ``grad_mean``, ``regularize``, ``local_update``.  The input ``w``
and optimizer state are left untouched.

The update (`apply_update`) is the reference's ``w - lr*g`` ('sgd'), or
one of the JAX package's optax optimizers: 'momentum' is
``optax.sgd(lr, momentum=m)`` with a trace ``[D]``, 'adam' is
``optax.adam(lr)`` with ``mu``, ``nu`` ``[D]`` and a step count.  The
kernel keeps that state in shared memory beside w.  Adam divides by
``1 - b^count``; JAX takes that power in float32, the port from a table
(`bias_corrections`) that the kernel and the plain version share.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/sync_epoch.cu`` (one thread-block cluster holding w, the optimizer
state and g in distributed shared memory for the whole run; built at
first use, ops/_build.py) or raises.  On a CPU tensor it runs
``sync_epoch_plain``.  The kernel sums g in a fixed order: each term is
scaled by a power of two (`scale_exponent`, from the data's bounds,
`data_bounds`) and added as a 64-bit integer, so one input gives one
output bit for bit.

``coeff`` is the rule (ops/coeff.py): a built-in kind, or a model's
own `Coeff`, whose torch function the plain version applies and whose
CUDA body runs in the kernel's variant (ops/_build.py).  That variant
takes each step's scale from the cluster's largest finite term after a
first pass over the step's samples (csrc/sync_epoch.cu), so it needs no
bound from the data.
``sync_epoch.launches`` counts kernel launches (``sync_epoch.user_launches``
those of a user rule's variant), ``sync_epoch.steps`` the
steps they ran and ``sync_epoch.opt_launches`` the launches of each
optimizer; the async engines launch from several threads, so all are added
under a lock.

``cluster_plan(K, D, n_state)`` says whether that state fits the
cluster's shared memory; the engine picks its path by it, before any
launch, and whether dim_sparsity's slice fits there too.
"""

from __future__ import annotations

import ctypes
import math
import threading
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.ops import coeff as co
from distributed_sgd_tpu_torch.ops.coeff import LEAST_SQUARES
from distributed_sgd_tpu_torch.ops.worker_grads import worker_grads_plain

REG_KINDS = ("dim_sparsity", "l2", "none")  # the kernel's reg_kind is the index
# the kernel's opt_kind is the index, which is also the number of [D] state vectors
OPT_KINDS = ("sgd", "momentum", "adam")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)
CLUSTER_BLOCKS = 8  # the portable cluster size
SMEM_BYTES_PER_BLOCK = 232_448  # what one Hopper block may use (227 KB)
# the w . dim_sparsity partials and the largest |w| pushed by each block,
# one value per warp, and the non-finite flag by step parity
_SCRATCH_FLOATS = 2 * CLUSTER_BLOCKS + 32 + 2
SUM_BITS = 62  # the integer sums of g stay within 2^62 < 2^63
SCALE_LIMIT = 1000  # |e|: 2^e stays a normal double
_CLUSTER_UNSCHEDULABLE = 100000  # the C function's code for that
# samples the cluster holds at once (csrc/sync_epoch.cu kCluster * kSlots; the C
# entry refuses a scratch buffer shorter than it needs)
IN_FLIGHT = 512
_counts_lock = threading.Lock()


class ClusterPlan(NamedTuple):
    blocks: int  # blocks in the one cluster
    slice: int  # entries of w (and of each g_k, dim_sparsity) each block owns
    smem_bytes: int  # dynamic shared memory per block
    ds_local: bool  # dim_sparsity's slice in shared memory (else in an L2 scratch)


def cluster_plan(k: int, d: int, n_state: int = 0) -> Optional[ClusterPlan]:
    """The cluster that holds w (4 B a feature), `n_state` optimizer state
    vectors (4 B each) and the integer sums g[K, D] (8 B a worker) in
    shared memory, or None when that does not fit: at D=47,236, K <= 4 for
    sgd and K <= 3 for momentum and adam; at K=1 (the mean mode) D up to
    154,816 for sgd, 116,096 for momentum and 92,896 for adam.  Where what
    is left holds dim_sparsity's slice too (4 B a feature: sgd and momentum
    at K <= 3 and the mean mode at D=47,236), the sweep reads it from there
    (the kernel's layout in csrc/sync_epoch.cu, in the same order)."""
    if k < 1 or d < 1:
        return None
    owned = -(-d // CLUSTER_BLOCKS)
    owned = -(-owned // 4) * 4  # 16-byte aligned sub-arrays
    smem = (8 * k + 4 * (1 + n_state)) * owned + 4 * _SCRATCH_FLOATS
    if smem > SMEM_BYTES_PER_BLOCK:
        return None
    ds_local = smem + 4 * owned <= SMEM_BYTES_PER_BLOCK
    return ClusterPlan(CLUSTER_BLOCKS, owned, smem + 4 * owned * ds_local, ds_local)


def scale_exponent(bound: float, count: int) -> int:
    """The exponent e of the power-of-two scale at which `count` terms of
    magnitude at most `bound`, each scaled by 2^e and rounded to an
    integer, sum within 2^SUM_BITS: with bound < 2^E, a scaled term is at
    most 2^(E + e) (an f32 term rounds to at most 2^E), and
    e = SUM_BITS - E - ceil(log2(count)).  A bound that is not finite takes
    2^128, above every finite f32; a zero bound (no nonzero term) takes 0.
    The kernel's scale_exponent is the same rule."""
    if not bound > 0 or count < 1:
        return 0
    if not math.isfinite(bound):
        bound = 2.0 ** 128
    e = SUM_BITS - math.frexp(bound)[1] - (int(count) - 1).bit_length()
    return max(-SCALE_LIMIT, min(SCALE_LIMIT, e))


class DataBounds(NamedTuple):
    """The largest finite |label| and |value| of the data, and its largest
    row sum of finite |value| (computed in double)."""

    y_max: float
    v_max: float
    l1_max: float


def term_bound(coeff_kind: int, bounds: DataBounds, w_max: float = 0.0) -> float:
    """A bound on every finite term c * v a step can add: hinge and
    logistic have |c| <= |y|; least squares, c = 2 (m - y), gets
    4 (max|w| L1 + max|y|) max|v| from the step's largest |w| (twice the
    exact bound, which covers the f32 rounding of the margin).  The
    kernel computes the least-squares bound each step from the cluster's
    max |w|; the others the wrapper computes once a launch.  A user rule
    has no bound: its variant measures each step's terms."""
    if coeff_kind == LEAST_SQUARES:
        return 4.0 * (w_max * bounds.l1_max + bounds.y_max) * bounds.v_max
    return bounds.y_max * bounds.v_max


_bounds_lock = threading.Lock()
# (id(values), id(labels)) -> (weakrefs, versions, DataBounds)
_bounds_cache: Dict[Tuple[int, int], tuple] = {}


def data_bounds(values: torch.Tensor, labels_f32: torch.Tensor) -> DataBounds:
    """The data's `DataBounds`, computed once per (values, labels) pair and
    kept while both tensors live and are not written to: an engine
    launches over the same data every epoch or dispatch."""
    key = (id(values), id(labels_f32))
    version = (values._version, labels_f32._version)
    with _bounds_lock:
        hit = _bounds_cache.get(key)
        if hit is not None and hit[0][0]() is values and hit[0][1]() is labels_f32 \
                and hit[1] == version:
            return hit[2]
    av = values.abs()
    av = torch.where(torch.isfinite(av), av, torch.zeros_like(av))
    ay = labels_f32.abs()
    ay = torch.where(torch.isfinite(ay), ay, torch.zeros_like(ay))
    zero = torch.zeros((), dtype=torch.float64, device=values.device)
    got = torch.stack([ay.max().double() if ay.numel() else zero,
                       av.max().double() if av.numel() else zero,
                       av.double().sum(dim=1).max() if av.numel() else zero]).tolist()
    bounds = DataBounds(*got)
    with _bounds_lock:
        for k in [k for k, v in _bounds_cache.items() if v[0][0]() is None or v[0][1]() is None]:
            del _bounds_cache[k]
        _bounds_cache[key] = ((weakref.ref(values), weakref.ref(labels_f32)), version, bounds)
    return bounds


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


class Optimizer(NamedTuple):
    """The update after the mean gradient, as the JAX package's optimizers
    compute it (optax 0.2.6): 'sgd' is the reference's ``w - lr*g``;
    'momentum' is ``optax.sgd(lr, momentum=momentum)``; 'adam' is
    ``optax.adam(lr)``."""

    kind: str = "sgd"
    momentum: float = 0.9

    @property
    def n_state(self) -> int:
        """[D] state vectors: sgd 0, momentum 1 (the trace), adam 2 (mu, nu)."""
        return OPT_KINDS.index(self.kind)


class OptState(NamedTuple):
    """An optimizer's state: its [D] vectors (momentum: the trace; adam:
    mu, nu) and adam's step count, kept on the host."""

    vectors: Tuple[torch.Tensor, ...] = ()
    count: int = 0


def init_opt_state(optimizer: Optimizer, n_features: int, device) -> OptState:
    """Zeros and count 0, as optax's ``init``."""
    return OptState(tuple(torch.zeros(n_features, dtype=torch.float32, device=device)
                          for _ in range(optimizer.n_state)), 0)


def bias_corrections(count: int, steps: int) -> np.ndarray:
    """Adam's ``1 - b1**c`` and ``1 - b2**c`` for the step counts
    c = count+1 .. count+steps, as f32 [steps, 2].  b1 and b2 are taken as
    JAX takes them, rounded to float32; the power is computed in double and
    rounded once.  JAX computes it in float32 and lands up to about 7e-6
    (relative) away at b2 = 0.999 over the first 3,000 steps; the kernel
    and the plain version read this same table."""
    c = np.arange(count + 1, count + steps + 1, dtype=np.float64)[:, None]
    b = np.array([np.float32(ADAM_B1), np.float32(ADAM_B2)], dtype=np.float64)
    return (1.0 - b ** c).astype(np.float32)


def apply_update(w: torch.Tensor, g: torch.Tensor, lr: float, optimizer: Optimizer,
                 state: OptState) -> Tuple[torch.Tensor, OptState]:
    """One update of `w` by the mean gradient `g`; returns (w, the new
    state).  The constants enter as JAX's weakly typed Python floats do:
    rounded to f32, ``1 - b`` computed in double first."""
    vectors, count = state
    if optimizer.kind == "sgd":
        return w - lr * g, state
    if optimizer.kind == "momentum":
        t = g + optimizer.momentum * vectors[0]
        return w + (-lr) * t, OptState((t,), count)
    mu, nu = vectors
    b1, b2 = ADAM_B1, ADAM_B2
    bc1, bc2 = bias_corrections(count, 1)[0].tolist()
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    return w + (-lr) * u, OptState((mu, nu), count + 1)


def sync_epoch_plain(w, ids, indices, values, labels_f32, *, coeff, reg_kind,
                     lam, dim_sparsity, lr, n_total_workers, grad_divisor: float = 1,
                     optimizer: Optional[Optimizer] = None,
                     opt_state: Optional[OptState] = None):
    """The kernel's function in plain torch: the per-step path's arithmetic
    in a loop over ``ids[S, K, B]``.  Returns w, or with an `optimizer`
    (w, its new OptState)."""
    opt = optimizer or Optimizer()
    state = init_opt_state(opt, w.shape[0], w.device) if opt_state is None else opt_state
    for rows in ids:
        gk = worker_grads_plain(w, indices[rows], values[rows], labels_f32[rows], coeff)
        gk = regularize(gk / grad_divisor, w, reg_kind, lam, dim_sparsity)  # / 1 is exact
        w, state = apply_update(w, gk.sum(dim=0) / n_total_workers, lr, opt, state)
    if ids.shape[0] == 0:
        w, state = w.clone(), OptState(tuple(v.clone() for v in state.vectors), state.count)
    return w if optimizer is None else (w, state)


def _check(w, ids, indices, values, labels_f32, coeff, reg_kind, dim_sparsity,
           n_total_workers, grad_divisor, optimizer, opt_state):
    rule = co.resolve(coeff)
    if w.device.type == "cuda":
        co.check_launchable(rule, w.device)
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
    if optimizer is not None:
        if not isinstance(optimizer, Optimizer) or optimizer.kind not in OPT_KINDS:
            raise ValueError(f"optimizer must be an Optimizer of a kind in {OPT_KINDS}, "
                             f"got {optimizer!r}")
        vectors, count = opt_state or OptState()
        if len(vectors) != optimizer.n_state or not (
                isinstance(count, (int, np.integer)) and count >= 0):
            raise ValueError(f"a {optimizer.kind!r} state is {optimizer.n_state} [D] vectors "
                             f"and a count >= 0, got {len(vectors)} and {count!r}")
        for i, v in enumerate(vectors):
            if v.shape != w.shape:
                raise ValueError(f"optimizer state vector {i} is {list(v.shape)}, "
                                 f"w {list(w.shape)}")
            tensors.append((f"optimizer state vector {i}", v, torch.float32))
    elif opt_state is not None:
        raise ValueError("opt_state given without an optimizer")
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel(rule: co.Coeff):
    """The C entry point of the library for `rule` (the built-in one, or
    the rule's variant) with its argument types, built at first use."""
    from distributed_sgd_tpu_torch.ops import _build

    return bind(_build.load("sync_epoch", rule).dsgd_sync_epoch)


def bind(fn):
    """`fn`, the C entry point ``dsgd_sync_epoch`` of a built library, with
    its argument types."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 14
                       + [ctypes.c_double] * 3 + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return fn


def _launch(w, ids, indices, values, labels_f32, coeff, reg_kind, lam,
            dim_sparsity, lr, n_total_workers, grad_divisor, optimizer, opt_state, fn=None):
    """The kernel's launch (`fn`: another build's entry point, as the
    tools time them)."""
    s, k, b = ids.shape
    n, p = indices.shape
    d = w.shape[0]
    opt = optimizer or Optimizer()
    vectors, count = opt_state or OptState()
    plan = cluster_plan(k, d, opt.n_state)
    if plan is None:
        raise ValueError(
            f"K={k} workers at D={d} with {opt.kind}'s {opt.n_state} state vectors do not "
            f"fit one cluster's shared memory (cluster_plan); run the per-step path")
    rule = co.resolve(coeff)
    fn = _kernel(rule) if fn is None else bind(fn)
    ds_ptr = dim_sparsity.data_ptr() if reg_kind == "dim_sparsity" else 0
    bounds = data_bounds(values, labels_f32)
    n_terms = b * p  # terms a step adds into one g[k, i], at most
    user = rule.kind == co.USER
    # the user variant measures each step's terms itself
    scale_e = 0 if user else scale_exponent(term_bound(rule.kind, bounds), n_terms)
    # ... and keeps the coefficients past the first IN_FLIGHT samples of a step
    kept = max(0, -(-k * b // IN_FLIGHT) - 1) * IN_FLIGHT if user else 0
    # decay1, decay2, keep1, keep2: 1 - b in double, then f32, as JAX's
    # weakly typed constants
    consts = {"sgd": (0.0, 0.0, 0.0, 0.0), "momentum": (opt.momentum, 0.0, 0.0, 0.0),
              "adam": (ADAM_B1, ADAM_B2, 1 - ADAM_B1, 1 - ADAM_B2)}[opt.kind]
    with torch.cuda.device(w.device):
        w_out = torch.empty_like(w)
        outs = tuple(torch.empty_like(v) for v in vectors)
        bias = (torch.from_numpy(bias_corrections(count, s)).to(w.device)
                if opt.kind == "adam" and s > 0 else None)
        # dim_sparsity by owner, the non-finite terms' f32 sums, the kept coefficients
        scratch = torch.empty((1 + k) * plan.blocks * plan.slice + kept, dtype=torch.float32,
                              device=w.device)
        ins_ptr = [v.data_ptr() for v in vectors] + [0] * (2 - len(vectors))
        outs_ptr = [v.data_ptr() for v in outs] + [0] * (2 - len(outs))
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), ds_ptr, ids.data_ptr(), indices.data_ptr(),
                 values.data_ptr(), labels_f32.data_ptr(), w_out.data_ptr(), *ins_ptr,
                 *outs_ptr, 0 if bias is None else bias.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), n, s, k, b, p, d, plan.blocks, plan.slice, plan.smem_bytes,
                 int(plan.ds_local), rule.kind, REG_KINDS.index(reg_kind),
                 OPT_KINDS.index(opt.kind), scale_e,
                 (n_terms - 1).bit_length(), bounds.l1_max, bounds.y_max, bounds.v_max,
                 2.0 * lam, lr, float(n_total_workers), float(grad_divisor), *consts,
                 ADAM_EPS, stream)
    if err == _CLUSTER_UNSCHEDULABLE:
        raise RuntimeError(
            f"sync_epoch: a cluster of {plan.blocks} blocks with {plan.smem_bytes} B of "
            f"shared memory each cannot be scheduled on this card")
    if err != 0:
        raise RuntimeError(f"sync_epoch kernel launch failed: cudaError {err}")
    with _counts_lock:
        sync_epoch.launches += 1
        sync_epoch.user_launches += user
        sync_epoch.steps += s
        sync_epoch.opt_launches[opt.kind] += 1
    if optimizer is None:
        return w_out
    return w_out, OptState(outs, count + s if opt.kind == "adam" else count)  # adam counts steps


def sync_epoch(w: torch.Tensor, ids: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor, labels_f32: torch.Tensor, *, coeff,
               reg_kind: str, lam: float, dim_sparsity: Optional[torch.Tensor],
               lr: float, n_total_workers: int, grad_divisor: float = 1,
               optimizer: Optional[Optimizer] = None, opt_state: Optional[OptState] = None):
    """The weights after ``ids.shape[0]`` sync steps from `w` (f32[D]) over
    the data ``indices`` i32[N, P], ``values`` f32[N, P], ``labels_f32``
    f32[N]; ``grad_divisor`` B gives the async mean mode.  With an
    `optimizer` (and its `opt_state`, zeros when None) it returns (w, the
    new OptState).  `coeff` is a built-in kind or a `Coeff`
    (ops/coeff.py).  CUDA tensors launch the kernel (or raise); CPU tensors
    run `sync_epoch_plain`."""
    _check(w, ids, indices, values, labels_f32, coeff, reg_kind, dim_sparsity,
           n_total_workers, grad_divisor, optimizer, opt_state)
    if optimizer is not None and opt_state is None:
        opt_state = init_opt_state(optimizer, w.shape[0], w.device)
    args = (w, ids, indices, values, labels_f32)
    kw = dict(coeff=coeff, reg_kind=reg_kind, lam=lam, dim_sparsity=dim_sparsity,
              lr=lr, n_total_workers=n_total_workers, grad_divisor=grad_divisor,
              optimizer=optimizer, opt_state=opt_state)
    if w.device.type == "cuda":
        return _launch(*args, **kw)
    if w.device.type == "cpu":
        return sync_epoch_plain(*args, **kw)
    raise ValueError(f"sync_epoch runs on cuda or cpu tensors, got {w.device}")


sync_epoch.launches = 0
sync_epoch.user_launches = 0  # of them, launches of a user rule's variant
sync_epoch.steps = 0
sync_epoch.opt_launches = dict.fromkeys(OPT_KINDS, 0)  # launches by optimizer
