"""Where a step of the sync_epoch kernel spends its time, on the card.

    python -m distributed_sgd_tpu_torch.tools.sync_epoch_phases

Builds the kernel from ``csrc/sync_epoch.cu`` and variants of it, each
with one part of the step taken out or changed (text edits of a copy in a
temporary directory; the checkout is not touched), and times each with
CUDA events (the least of 3 runs after a warm-up) at the main path's
shape: one epoch over 643,531 RCV1-shaped rows (the CLI's train split),
K=3 workers, B=100, P=76, D=47,236, 2,146 steps, hinge with the
dim_sparsity regularizer; and the mean mode's 64-step dispatch (K=1,
``grad_divisor`` = B) from the state 500 steps leave.  Each variant runs
at lr 0.5 (the CLI's: most samples turn inactive, as in training) and at
lr 0 (w stays 0, so every sample is active and every variant does the
same work).  ``kernel`` and the variants that only move work
(``dense_sweep``, ``ds_in_l2``, ``pulled_scalar``, ``rows_before_sweep``,
``sgd_only``, and the dropped levers ``kheld5``, ``one_multiply``,
``split_mid_barrier``) compute the kernel's weights, bit for bit (the epoch's
``digest``); the others take work out and compute wrong ones: at lr 0.5
the ``max_abs_err`` against the plain version after 50 steps says which
(at lr 0 no variant moves w).  Each lever of the design is the
difference between ``kernel`` and the variant without it:

- ``kernel``: the kernel as it is;
- ``dense_sweep``: every entry updated every step (the sparse sgd sweep
  off);
- ``ds_in_l2``: dim_sparsity read from the global scratch slice, not
  shared memory;
- ``pulled_scalar``: each block keeps its w . dim_sparsity partial (and
  largest |w|) in its own slot and every block reads the 8 slots
  remotely, in place of the pushed copies;
- ``rows_before_sweep``: the next step's rows loaded into registers after
  the mid-step barrier and held over the sweep, not between the closing
  barrier's arrive and wait (the placement the redesign replaced);
- ``no_scatter``: no sample adds into g (the gather and the coefficient
  stay);
- ``no_phase_a``: no sample is gathered or scattered: the two cluster
  barriers, the pushed partials and the sweep: the floor of an empty step;
- ``spread_atomics``: every term goes to the same owner block as in the
  kernel, but to a scrambled entry, so no two samples add into one
  address: the cost of same-address contention;
- ``local_atomics``: every term goes to the same entry of the block's own
  shared memory instead of the owner's: the cost of the remote path;
- ``contiguous_owner``: block r owns features [r*slice, (r+1)*slice)
  instead of every 8th: the ownership that puts the most popular features
  on one block;
- ``sgd_only``: the momentum and adam branches of the sweep compiled out:
  what their presence (registers, spills) costs the sgd mode.

Levers measured and dropped, kept here as variants: ``kheld5``, 5 row
entries a lane held in registers in place of 8; ``one_multiply``, each
sum scaled by one multiply where 2^-e is a normal float, in place of
ldexpf; ``split_mid_barrier``, the mid-step barrier's arrive and wait
apart, the next step's rows asked into L2 between them.  A hot set (each
block summing the most frequent features' terms in its own shared memory
and keeping a copy of their weights) and g in global memory (L2
atomics) were dropped too (PERF.md).

Prints the card's name and power limit, each variant's register and
spill report from ptxas, then one JSON line per run.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
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

N, K, B, P, D, STEPS, DISPATCH = 643531, 3, 100, 76, 47236, 2146, 64
HELD_TERM = "add_term(cluster, p, sink, r.k, r.i[t], c * r.v[t]);"
REMOTE_ADD = "cluster_add(sink.g + (size_t)k * p.slice + j, owner, (unsigned long long)q);"
OWNER = "return cluster.map_shared_rank(base + i / kCluster, i % kCluster);"
TERM_OWNER = "const int owner = i % kCluster, j = i / kCluster;"
PUSH = "if (lane < kCluster) *cluster.map_shared_rank(slots + rank, lane) = v;"
LOCAL_SUM = "out = largest ? fmaxf(out, slots[r]) : out + slots[r];"
REMOTE_SUM = ("{ const float x = *cg::this_cluster().map_shared_rank(const_cast<float*>(slots) "
              "+ r, r); out = largest ? fmaxf(out, x) : out + x; }")
DS_LOCAL = "const bool ds_local = p.ds_local != 0;"
MID_SYNC = "cluster.sync();  // the remote adds are visible to their owners"
END_LOAD = "first = load_row(p, next_id, slot, sub);\n    cluster_wait();"
SPARSE = "const bool sparse = p.opt_kind == 0"
TO_F32 = "return acc != 0 ? ldexpf(__ll2float_rn(acc), -e) : 0.f;"
OWNED_DOC = "// Feature i's entry of `base` in the block that owns it"
PREFETCH_ROW = """// the next rows into L2, holding no register
__device__ __forceinline__ void prefetch_row(const Params& p, int64_t row, int sub) {
  if ((uint64_t)row >= (uint64_t)p.n_rows || 32 * sub >= p.P + 31) return;
  const int q = min(32 * sub, p.P - 1);
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p.idx + row * p.P + q));
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p.val + row * p.P + q));
}

"""


def variants(slice_: int):
    """name -> text edits of the source."""
    return {
        "kernel": [],
        "dense_sweep": [(SPARSE, "const bool sparse = false && p.opt_kind == 0")],
        "ds_in_l2": [(DS_LOCAL, "const bool ds_local = false;")],
        "pulled_scalar": [(PUSH, "if (lane == 0) slots[rank] = v;"), (LOCAL_SUM, REMOTE_SUM)],
        "rows_before_sweep": [(END_LOAD, "cluster_wait();"),
                              (MID_SYNC, MID_SYNC + "\n    first = load_row(p, next_id, slot, sub);")],
        "no_scatter": [("if (c == 0.f) return;", "if (c == c) return;")],
        "no_phase_a": [("run_sample(cluster, p, first, sub, w_s, sink);", ";")],
        "spread_atomics": [(HELD_TERM, (
            "add_term(cluster, p, sink, r.k, (r.i[t] + kCluster * (613 * (threadIdx.x / "
            "kLanes) + 97 * t)) % (p.D - p.D % kCluster), c * r.v[t]);"))],
        "local_atomics": [(REMOTE_ADD, (
            "atomicAdd(sink.g + (size_t)k * p.slice + j, (unsigned long long)q);"))],
        "contiguous_owner": [
            (OWNER, f"return cluster.map_shared_rank(base + i % {slice_}, i / {slice_});"),
            (TERM_OWNER, f"const int owner = i / {slice_}, j = i % {slice_};")],
        "sgd_only": [("if (p.opt_kind == kOptMomentum) {", "if (false) {"),
                     ("} else if (p.opt_kind == kOptAdam) {", "} else if (false) {")],
        "kheld5": [("constexpr int kHeld = 8;", "constexpr int kHeld = 5;")],
        "one_multiply": [(TO_F32, (
            "if (acc == 0) return 0.f;\n  const float x = __ll2float_rn(acc);\n  return e >= -127 "
            "&& e <= 126 ? __fmul_rn(x, __int_as_float((127 - e) << 23)) : ldexpf(x, -e);"))],
        "split_mid_barrier": [(OWNED_DOC, PREFETCH_ROW + OWNED_DOC), (MID_SYNC, (
            "cluster_arrive();\n    prefetch_row(p, next_id, sub);\n    cluster_wait();"))],
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
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        libs[name] = se.bind(ctypes.CDLL(str(tmp / f"lib{name}.so")).dsgd_sync_epoch)
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
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, N, (STEPS, K, B))).cuda()
    mean_ids = torch.from_numpy(rng.integers(0, -(-N // K), (DISPATCH, 1, B))).cuda()
    w = torch.zeros(D, device="cuda")
    print(json.dumps({"plan": plan._asdict()}), flush=True)

    def run(fn, steps, lr):
        # the wrapper's launch with the variant's entry point: sgd, K=3
        return se._launch(w, ids[:steps], idx, val, y, 0, "dim_sparsity", 1e-5, ds, lr, K, 1,
                          None, None, fn=fn)

    def least_ms(launch, iters):
        launch()  # warm-up
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                launch()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        return min(runs)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), plan.slice)
        for lr in (0.5, 0.0):
            want = se.sync_epoch_plain(w, ids[:50], idx, val, y, coeff=0,
                                       reg_kind="dim_sparsity", lam=1e-5, dim_sparsity=ds,
                                       lr=lr, n_total_workers=K)
            # the mean mode from the state 500 steps leave (a Hogwild dispatch)
            w_mid = se.sync_epoch(w, ids[:500], idx, val, y, coeff=0, reg_kind="dim_sparsity",
                                  lam=1e-5, dim_sparsity=ds, lr=lr, n_total_workers=K)
            for name, fn in libs.items():
                ms = least_ms(lambda: run(fn, STEPS, lr), 1)
                mean_ms = least_ms(lambda: se._launch(
                    w_mid, mean_ids, idx, val, y, 0, "dim_sparsity", 1e-5, ds, lr, 1, B, None,
                    None, fn=fn), 20)
                err = float((run(fn, 50, lr) - want).abs().max())
                digest = hashlib.sha256(run(fn, STEPS, lr).cpu().numpy().tobytes()).hexdigest()
                print(json.dumps({"variant": name, "lr": lr, "ms_per_epoch": ms,
                                  "us_per_step": ms / STEPS * 1e3,
                                  "mean_mode_ms": mean_ms,
                                  "mean_mode_us_per_step": mean_ms / DISPATCH * 1e3,
                                  "max_abs_err_50_steps": err, "digest": digest[:16]}),
                      flush=True)


if __name__ == "__main__":
    main()
