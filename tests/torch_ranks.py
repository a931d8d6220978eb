"""One rank of a gloo process group for the port's multi-rank CPU tests.

    python tests/torch_ranks.py <dir> <rank> <world> <port> <case> [<case> ...]

Imports only the port (never jax).  Each case reads ``<dir>/case_<name>.npz``
(arrays, and a ``meta`` JSON string saying what to run), runs it on this
rank and writes ``<dir>/out_<name>_r<rank>.npz``.  The tests
(tests/test_torch_distributed.py, tests/test_torch_feature_sharded.py)
write the cases, start the ranks, and hold the outputs against the JAX
package's engines on a mesh of as many CPU devices.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from distributed_sgd_tpu_torch import checkpoint as tckpt
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer
from distributed_sgd_tpu_torch.data.host_shard import dataset_reader
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel import mesh, multihost
from distributed_sgd_tpu_torch.parallel.feature_sharded import FeatureShardedEngine, make_mesh_2d
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine
from distributed_sgd_tpu_torch.utils.metrics import Metrics


def _dataset(z, prefix: str) -> Dataset:
    return Dataset(z[f"{prefix}_indices"], z[f"{prefix}_values"], z[f"{prefix}_labels"],
                   int(z[f"{prefix}_n_features"]))


def _model(z, meta):
    ds = z["ds"] if meta["reg"] == "dim_sparsity" else None
    return make_model(meta["model"], meta["lam"], int(z["train_n_features"]), dim_sparsity=ds,
                      regularizer=meta["reg"], device="cpu")


def sync(z, meta, r):
    """One epoch of the sync engine from zeros with the injected ids, its
    evaluations and predictions."""
    model = _model(z, meta)
    eng = SyncEngine(model, meta["batch"], meta["lr"], virtual_workers=meta["k"],
                     optimizer=meta.get("optimizer"), device="cpu")
    bound = eng.bind(_dataset(z, "train"))
    ids = torch.from_numpy(z["ids"][r])
    bound._sample_ids = lambda key: ids
    w = bound.epoch(torch.zeros(model.n_features), key=0)
    test = eng.bind(_dataset(z, "test"))
    return dict(w=w.numpy(), train_eval=np.array(bound.evaluate(w)),
                test_eval=np.array(test.evaluate(w)), preds=test.predict(w),
                steps=np.array(bound.steps_per_epoch), shard_n=np.array(bound.shard_n))


def local(z, meta, r):
    """A local SGD fit with the injected draws."""
    model = _model(z, meta)
    eng = LocalSGDEngine(model, meta["batch"], meta["lr"], sync_period=meta["h"],
                         check_every=meta["check_every"], seed=meta["seed"],
                         optimizer=meta.get("optimizer"), metrics=Metrics(), device="cpu")
    draws = z["draws"][r]
    eng._sample_ids = lambda rnd, shard_n: torch.from_numpy(draws[rnd])
    res = eng.fit(_dataset(z, "train"), _dataset(z, "test"), 1)
    return dict(w=res.weights.numpy(), test_losses=np.array(res.test_losses),
                test_accuracies=np.array(res.test_accuracies),
                updates=np.array(res.state.updates))


def host_local(z, meta, r):
    """bind against bind_host_local on the same rows, for both layouts."""
    out = {}
    for prefix in ("train", "dense"):
        data = _dataset(z, prefix)
        model = make_model("hinge", 1e-4, data.n_features, regularizer="l2", device="cpu")
        eng = SyncEngine(model, 8, 0.1, virtual_workers=2, device="cpu")
        a = eng.bind(data)
        b = eng.bind_host_local(dataset_reader(data), len(data), data.n_features,
                                0 if data.is_dense else data.indices.shape[1],
                                labels_dtype=data.labels.dtype)
        for name in ("indices", "values", "labels"):
            x, y = getattr(a.data, name), getattr(b.data, name)
            out[f"{prefix}_{name}_equal"] = np.array(x.dtype == y.dtype and torch.equal(x, y))
            out[f"{prefix}_{name}"] = x.numpy()
        out[f"{prefix}_layout"] = np.array([a.shard_n, b.shard_n, a.eval_chunk, b.eval_chunk,
                                            a.steps_per_epoch, b.steps_per_epoch])
    return out


def resume(z, meta, r):
    """A 3-epoch SyncTrainer fit run through, and the same fit stopped
    after 1 epoch and resumed to 3 by a new trainer on the directory; the
    snapshots each rank wrote."""
    model = _model(z, meta)
    train, test = _dataset(z, "train"), _dataset(z, "test")
    written = []
    save = tckpt.Checkpointer.save

    def counted(self, step, weights, extra=None):
        done = save(self, step, weights, extra)
        written.append(step if done else -1)
        return done

    tckpt.Checkpointer.save = counted
    kw = dict(batch_size=meta["batch"], learning_rate=meta["lr"], seed=3,
              virtual_workers=meta["k"], optimizer=meta.get("optimizer"), device="cpu")
    through = SyncTrainer(model, checkpointer=tckpt.Checkpointer(os.path.join(meta["dir"], "a")),
                          **kw).fit(train, test, 3)
    n_through = len(written)
    d = os.path.join(meta["dir"], "b")
    SyncTrainer(model, checkpointer=tckpt.Checkpointer(d), **kw).fit(train, test, 1)
    resumed = SyncTrainer(model, checkpointer=tckpt.Checkpointer(d), **kw).fit(train, test, 3)
    tckpt.Checkpointer.save = save
    return dict(through=through.weights.numpy(), resumed=resumed.weights.numpy(),
                through_losses=np.array(through.test_losses),
                resumed_losses=np.array(resumed.test_losses),
                written_through=np.array(written[:n_through], np.int64),
                written=np.array(written, np.int64))


def feature_sharded(z, meta, r):
    """One epoch of the dp x tp engine from zeros with the injected ids (the
    data rank's), its evaluations and predictions."""
    model = _model(z, meta)
    grid = make_mesh_2d(meta["w"], meta["f"], device="cpu")
    eng = FeatureShardedEngine(model, grid, meta["batch"], meta["lr"]).bind(
        _dataset(z, "train"))
    ids = torch.from_numpy(z["ids"][grid.worker_index])
    eng._sample_ids = lambda key: ids
    w = eng.epoch(eng.init_weights(), 0)
    test = FeatureShardedEngine(model, grid, meta["batch"], meta["lr"]).bind(
        _dataset(z, "test"))
    return dict(w=eng.to_dense(w), train_eval=np.array(eng.evaluate(w)),
                test_eval=np.array(test.evaluate(w)), preds=test.predict(w),
                bounds=np.array([eng.lo, eng.hi, eng.shard_n, eng.steps_per_epoch]))


def fs_resume(z, meta, r):
    """A dp x tp fit of 2 epochs with a checkpointer, then the 1-D
    SyncTrainer resuming it to 3 on the same ranks."""
    model = _model(z, meta)
    train, test = _dataset(z, "train"), _dataset(z, "test")
    d = os.path.join(meta["dir"], "fs")
    grid = make_mesh_2d(meta["w"], meta["f"], device="cpu")
    fs = FeatureShardedEngine(model, grid, meta["batch"], meta["lr"]).fit(
        train, test, 2, checkpointer=tckpt.Checkpointer(d), seed=1)
    sync = SyncTrainer(model, batch_size=meta["batch"], learning_rate=meta["lr"], seed=1,
                       checkpointer=tckpt.Checkpointer(d), device="cpu").fit(train, test, 3)
    return dict(fs_w=fs.weights.numpy(), fs_losses=np.array(fs.test_losses),
                sync_losses=np.array(sync.test_losses), sync_epochs=np.array(sync.epochs_run),
                steps=np.array(sorted(int(f.split(".")[0]) for f in os.listdir(d))))


CASES = dict(sync=sync, local=local, host_local=host_local, resume=resume,
             feature_sharded=feature_sharded, fs_resume=fs_resume)


def main(argv) -> None:
    out_dir, r, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, r, device="cpu")
    try:
        assert (mesh.world_size(), mesh.rank()) == (world, r)
        for name in argv[4:]:
            with np.load(os.path.join(out_dir, f"case_{name}.npz")) as z:
                meta = json.loads(str(z["meta"]))
                meta["dir"] = os.path.join(out_dir, f"{name}_files")
                out = CASES[meta["kind"]](z, meta, r)
            np.savez(os.path.join(out_dir, f"out_{name}_r{r}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()



def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_ranks(argvs, envs, timeout: float):
    """One process a rank, all within `timeout` seconds; a rank that fails
    or outlives it fails the call (every rank is killed).  Returns the
    ranks' output."""
    import subprocess
    import time

    procs = [subprocess.Popen([sys.executable, *argv], env={**os.environ, "PYTHONPATH": ROOT,
                                                            **env},
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for argv, env in zip(argvs, envs)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"ranks failed {failed}:\n" + "\n".join(
            f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
    return logs


def spawn(out_dir: str, world: int, cases, timeout: float = 120.0):
    """Run `cases` on `world` ranks started from this file.  Returns each
    case's outputs, one dict a rank."""
    port = _free_port()
    _run_ranks([[os.path.abspath(__file__), out_dir, str(r), str(world), str(port), *cases]
                for r in range(world)], [{}] * world, timeout)
    out = {}
    for name in cases:
        out[name] = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"out_{name}_r{r}.npz")) as z:
                out[name].append({k: z[k] for k in z.files})
    return out


def cli_world(tmp_path, world: int, env: dict, timeout: float = 90.0):
    """``main(device='cpu')`` of the port's CLI on `world` ranks with
    torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) and `env`; returns each rank's weights, test losses and
    epochs run, and the ranks' logs."""
    port = _free_port()
    script = ("import sys, numpy as np; from distributed_sgd_tpu_torch.main import main; "
              "f = main(device='cpu').fit; "
              "np.savez(sys.argv[1], w=f.weights.numpy(), losses=np.array(f.test_losses), "
              "epochs=np.array(f.epochs_run))")
    envs = [{"WORLD_SIZE": str(world), "RANK": str(r), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
             **env} for r in range(world)]
    logs = _run_ranks([["-c", script, str(tmp_path / f"rank{r}.npz")] for r in range(world)],
                      envs, timeout)
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs, logs


def write_case(out_dir: str, name: str, meta: dict, **arrays) -> None:
    """`<out_dir>/case_<name>.npz` for `main`: the arrays and `meta`."""
    np.savez(os.path.join(out_dir, f"case_{name}.npz"), meta=json.dumps(meta), **arrays)


def dataset_arrays(prefix: str, data) -> dict:
    """A dataset's arrays under `prefix` (any package's Dataset)."""
    return {f"{prefix}_indices": data.indices, f"{prefix}_values": data.values,
            f"{prefix}_labels": data.labels, f"{prefix}_n_features": data.n_features}


if __name__ == "__main__":
    main(sys.argv[1:])
