"""Where a step of the sync_epoch kernel spends its time, on the card.

    python -m distributed_sgd_tpu_torch.tools.sync_epoch_phases

Builds the kernel from ``csrc/sync_epoch.cu`` and variants of it, each
with one part of the step taken out or changed (text edits of a copy in a
temporary directory; the checkout is not touched), and times one epoch
of each with CUDA events at the main path's shape: 643,531 RCV1-shaped
rows (the CLI's train split), K=3 workers, B=100, P=76, D=47,236, 2,146
steps, hinge with the dim_sparsity regularizer.  Each variant runs at
lr 0.5 (the CLI's: most samples turn inactive, as in training) and at
lr 0 (w stays 0, so every sample is active and every variant does the
same work).  The variants other than ``kernel`` compute wrong weights:
at lr 0.5 their ``max_abs_err`` against the plain version after 50 steps
says so (at lr 0 no variant moves w).

- ``kernel``: the kernel as it is;
- ``no_scatter``: no sample adds into g (the gather and the coefficient
  stay);
- ``no_phase_a``: no sample is gathered or scattered: the two cluster
  barriers, the w . dim_sparsity exchange and the dense sweep;
- ``spread_atomics``: every atomic goes to the same owner block as in the
  kernel, but to a scrambled entry, so no two samples add into one
  address: the cost of same-address contention;
- ``local_atomics``: every atomic goes to the same entry of the block's
  own shared memory instead of the owner's: the cost of the remote path;
- ``contiguous_owner``: block r owns features [r*slice, (r+1)*slice)
  instead of every 8th: the ownership that puts the most popular features
  on one block.

Prints the card's name and power limit, then one JSON line per run.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import sync_epoch as se

N, K, B, P, D, STEPS = 643531, 3, 100, 76, 47236, 2146
HELD_ATOMIC = "atomicAdd(owned(cluster, g_k, r.i[t]), c * r.v[t]);"
OWNER = "return cluster.map_shared_rank(base + i / kCluster, i % kCluster);"


def variants(slice_: int):
    return {
        "kernel": [],
        "no_scatter": [("if (c == 0.f) return;", "if (c == c) return;")],
        "no_phase_a": [("run_sample(cluster, p, first, sub, w_s, g_s);", ";")],
        "spread_atomics": [(HELD_ATOMIC, (
            "atomicAdd(cluster.map_shared_rank(g_k + (r.i[t] / kCluster + 613 * "
            "(threadIdx.x / kLanes) + 97 * t) % (p.slice - 4), r.i[t] % kCluster), "
            "c * r.v[t]);"))],
        "local_atomics": [(HELD_ATOMIC, "atomicAdd(g_k + r.i[t] / kCluster, c * r.v[t]);")],
        "contiguous_owner": [(OWNER, (
            f"return cluster.map_shared_rank(base + i % {slice_}, i / {slice_});"))],
    }


def build(tmp: Path, slice_: int):
    src = (_build.CSRC_DIR / "sync_epoch.cu").read_text()
    for header in _build._sources("sync_epoch")[1:]:
        (tmp / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, edits in variants(slice_).items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in sync_epoch.cu")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"lib{name}.so"),
             str(tmp / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{report}")
        fn = ctypes.CDLL(str(tmp / f"lib{name}.so")).dsgd_sync_epoch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sync_epoch_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    plan = se.cluster_plan(K, D)
    train = rcv1_like(N, n_features=D, nnz=P, seed=0, idf_values=True)
    idx = torch.from_numpy(train.indices).cuda()
    val = torch.from_numpy(train.values).cuda()
    y = torch.from_numpy(train.labels.astype(np.float32)).cuda()
    ds = torch.from_numpy(dim_sparsity(train)).cuda()
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, N, (STEPS, K, B))).cuda()
    w = torch.zeros(D, device="cuda")

    def run(fn, steps, lr):
        out = torch.empty_like(w)
        err = fn(w.data_ptr(), ds.data_ptr(), ids.data_ptr(), idx.data_ptr(), val.data_ptr(),
                 y.data_ptr(), out.data_ptr(), N, steps, K, B, P, D, plan.blocks, plan.slice,
                 plan.smem_bytes, 0, 0, 2e-5, lr, float(K),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), plan.slice)
        for lr in (0.5, 0.0):
            want = se.sync_epoch_plain(w, ids[:50], idx, val, y, coeff_kind=0,
                                       reg_kind="dim_sparsity", lam=1e-5, dim_sparsity=ds,
                                       lr=lr, n_total_workers=K)
            for name, fn in libs.items():
                run(fn, STEPS, lr)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(fn, STEPS, lr)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
                err = float((run(fn, 50, lr) - want).abs().max())
                print(json.dumps({"variant": name, "lr": lr, "ms_per_epoch": ms,
                                  "us_per_step": ms / STEPS * 1e3,
                                  "max_abs_err_50_steps": err}), flush=True)


if __name__ == "__main__":
    main()
