#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each fatal (a traceback and a non-zero exit):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel of the port from csrc/ with nvcc;
3. kernels: hold each kernel against its plain torch version on the same
   CUDA tensors, at the main path's shapes and at edge shapes, and time
   both (CUDA events, in turns: plain, kernel, kernel, plain);
4. engine: one epoch of the sync engine on the card against the same
   epoch on the CPU, fed the same sample ids;
5. main path: ``main()`` of the port at full width (804,414 synthetic
   RCV1-shaped rows x 47,236 features, 3 epochs), checking that the test
   loss falls, the test accuracy, and that every step launched the kernel;
6. summary: the card line, one JSON line of per-kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_sgd_tpu_torch import main as port_main
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, steps_per_epoch_for

# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the bound tests/test_pallas_kernels.py holds the Pallas kernel to
# against the blocked path; atomics reorder f32 sums the same way
RTOL, ATOL = 1e-4, 1e-5
K, B, P, D = 3, 100, 76, 47236  # the main path's worker_grads shape
MAIN_ROWS, MAIN_EPOCHS = 804414, 3


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main_path_batch(seed: int):
    """[K, B, P] rows shaped like the main path's batches: RCV1-like
    Zipf ids with duplicate draws zeroed, cosine-normalised ltc values."""
    ds = rcv1_like(K * B, n_features=D, nnz=P, seed=seed, idf_values=True)
    return (ds.indices.reshape(K, B, P), ds.values.reshape(K, B, P),
            ds.labels.reshape(K, B).astype(np.float32))


def edge_batch(k: int, b: int, p: int, seed: int, dups: bool = False, pad_rows: bool = False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (k, b, p)).astype(np.int32)
    val = rng.normal(size=(k, b, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (k, b)).astype(np.float32)
    if dups and p > 1:
        idx[:, :, 1] = idx[:, :, 0]
    if pad_rows:
        idx[:, ::3], val[:, ::3], y[:, ::3] = 0, 0.0, 0.0
    return idx, val, y


def check_worker_grads() -> dict:
    """Kernel against plain version; returns the kernel's summary row."""
    rng = np.random.default_rng(0)
    cases = [(f"main-shape kind={kind}", main_path_batch(kind), kind) for kind in wg.COEFF_KINDS]
    cases += [
        ("B=37", edge_batch(3, 37, P, 1), wg.HINGE),
        ("P=1", edge_batch(3, B, 1, 2), wg.LOGISTIC),
        ("duplicate ids", edge_batch(3, B, P, 3, dups=True), wg.LEAST_SQUARES),
        ("all-pad rows", edge_batch(3, B, P, 4, pad_rows=True), wg.HINGE),
        ("K=1", edge_batch(1, B, P, 5), wg.HINGE),
    ]
    max_err = 0.0
    for label, (idx, val, y), kind in cases:
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        args = [torch.from_numpy(a).cuda() for a in (idx, val, y)]
        got = wg.worker_grads(w, *args, kind)
        want = wg.worker_grads_plain(w, *args, kind)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
        print(f"worker_grads {label}: max_abs_err={err:.3e} nonzero={int((want != 0).sum())}",
              flush=True)
        if not ok:
            raise AssertionError(f"worker_grads {label} disagrees with its plain version "
                                 f"(max abs err {err}, rtol {RTOL}, atol {ATOL})")
        max_err = max(max_err, err)

    # timing at the main path's shape, hinge (the main path's model)
    idx, val, y = main_path_batch(0)
    w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    args = [w] + [torch.from_numpy(a).cuda() for a in (idx, val, y)] + [wg.HINGE]
    kernel = lambda: wg.worker_grads(*args)  # noqa: E731
    plain = lambda: wg.worker_grads_plain(*args)  # noqa: E731
    plain_ms = [time_ms(plain)]
    kernel_ms = [time_ms(kernel), time_ms(kernel)]
    plain_ms.append(time_ms(plain))
    nz = val != 0
    n_nz = int(nz.sum())
    bytes_moved = idx.nbytes + val.nbytes + y.nbytes + 4 * len(np.unique(idx[nz])) + 4 * K * D
    flops = 4 * n_nz + 8 * K * B  # margin mul+add, scatter mul+add; the coefficient
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    row = {
        "kernel": "worker_grads", "max_abs_err": max_err,
        "kernel_us": min(kernel_ms) * 1e3, "plain_us": min(plain_ms) * 1e3,
        "bound_us": max(bound_bytes_ms, bound_ops_ms) * 1e3,
        "kernel_us_runs": [t * 1e3 for t in kernel_ms],
        "plain_us_runs": [t * 1e3 for t in plain_ms],
        "bytes": bytes_moved, "flops": flops,
    }
    print(json.dumps(row), flush=True)
    return {
        "name": "worker_grads", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/worker_grads.cu",
        "replaces": "distributed_sgd_tpu/ops/pallas_sparse.py:154",
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call computes the fused gather + coefficient + scatter
        "library_ms": None,
    }


def check_engine() -> None:
    """One epoch on the card against the same epoch on the CPU."""
    data = rcv1_like(3000, n_features=2000, nnz=20, seed=5, idf_values=True)
    ds = dim_sparsity(data)
    bounds = {}
    for dev in ("cuda", "cpu"):
        model = make_model("hinge", 1e-4, 2000, dim_sparsity=ds, device=dev)
        bounds[dev] = SyncEngine(model, batch_size=50, learning_rate=0.5,
                                 virtual_workers=3, device=dev).bind(
            Dataset(data.indices, data.values, data.labels, data.n_features))
    gpu, cpu = bounds["cuda"], bounds["cpu"]
    sub, starts, sizes = cpu._subshards()
    sel = np.random.default_rng(0).integers(0, sub, (cpu.steps_per_epoch, 3, 50))
    ids = torch.from_numpy(sel % np.minimum(sub, sizes)[:, None] + starts[:, None])
    gpu._sample_ids = lambda key: ids.cuda()
    cpu._sample_ids = lambda key: ids
    w_gpu = gpu.epoch(torch.zeros(2000, device="cuda"), 0)
    w_cpu = cpu.epoch(torch.zeros(2000), 0)
    torch.cuda.synchronize()
    err = float((w_gpu.cpu() - w_cpu).abs().max())
    ev_gpu, ev_cpu = gpu.evaluate(w_gpu), cpu.evaluate(w_cpu)
    print(f"engine: weights max_abs_err={err:.3e} evaluate gpu={ev_gpu} cpu={ev_cpu}", flush=True)
    # atol 1e-5 on weights (atomic sums reorder over 20 steps); rtol 1e-5 on evaluate
    if err > 1e-5 or not np.allclose(ev_gpu, ev_cpu, rtol=1e-5, atol=0):
        raise AssertionError("sync engine on the card disagrees with the CPU run")


def run_main_path() -> int:
    """The port's CLI run at full width; returns the kernel launches."""
    os.environ["DSGD_SYNTHETIC"] = str(MAIN_ROWS)
    os.environ["DSGD_MAX_EPOCHS"] = str(MAIN_EPOCHS)
    wg.worker_grads.launches = 0
    t0 = time.perf_counter()
    run = port_main.main()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = wg.worker_grads.launches
    fit = run.fit
    n_train = int(MAIN_ROWS * 0.8)
    steps = steps_per_epoch_for(n_train, 1, 3, 100)
    print(f"data generation seconds: {run.data_seconds:.3f}")
    for e, s in enumerate(fit.epoch_seconds):
        print(f"epoch {e} seconds: {s:.4f} steps/s: {fit.steps_per_epoch / s:.1f}")
    print(f"main path seconds: {total_s:.3f}")
    print(f"test losses: {fit.test_losses} test accuracies: {fit.test_accuracies}")
    print(f"worker_grads launches: {launches} (steps per epoch {fit.steps_per_epoch})", flush=True)
    w = fit.weights
    if w.shape != (D,) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"final weights not finite f32[{D}]: {w.shape}")
    if fit.epochs_run != MAIN_EPOCHS or fit.steps_per_epoch != steps:
        raise AssertionError(f"ran {fit.epochs_run} epochs of {fit.steps_per_epoch} steps, "
                             f"want {MAIN_EPOCHS} of {steps}")
    # at w = 0 every hinge prediction is 0 and the test loss is 1
    losses = [1.0] + fit.test_losses
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"test loss did not fall every epoch: {fit.test_losses}")
    if fit.test_accuracies[-1] < 0.70:
        raise AssertionError(f"test accuracy {fit.test_accuracies[-1]} < 0.70")
    if launches != MAIN_EPOCHS * steps:
        raise AssertionError(f"worker_grads launched {launches} times, want {MAIN_EPOCHS * steps}")
    return launches


def main() -> None:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        sys.exit(1)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build seconds: {time.perf_counter() - t0:.2f}")
    for name, report in reports.items():
        print(f"{name} nvcc report:\n{report.strip()}", flush=True)

    phase("3 kernels against their plain versions")
    row = check_worker_grads()

    phase("4 engine on the card against the CPU")
    check_engine()

    phase("5 main path")
    row["launches"] = run_main_path()

    phase("6 summary")
    print(card)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
