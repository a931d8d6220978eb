"""The port across processes: parallel/mesh.py's process-group reduces,
parallel/multihost.py, the sync and local SGD engines over 2 gloo ranks,
rank 0's snapshots, and the CLI under a 2-rank world.

Each multi-rank case runs in ranks started as processes of their own that
import only the port (tests/torch_ranks.py); the JAX side runs here on
the test process's CPU devices (tests/conftest.py), on a mesh of as many
devices as the port has ranks.  Both are fed the same sample ids: the JAX
engine's ``_sample_ids`` replaced on the instance (a device reads its row
of the table by its mesh position), the port's on each rank.  Weights are
held to atol 1e-5 and evaluations to rtol 1e-5, as at one rank
(tests/test_torch_sync.py): f32 sums in another order.  Every test has a
SIGALRM limit of its own; the ranks have theirs."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import dense_regression, rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import multihost as jmultihost
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.local_sgd import LocalSGDEngine as JaxLocalSGD
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.parallel import mesh as tmesh
from distributed_sgd_tpu_torch.parallel import multihost as tmultihost
from distributed_sgd_tpu_torch.parallel import sync as tsync

LIMIT_S = 60
N, D, NNZ, K, B, LR = 3000, 2000, 20, 3, 50, 0.5
WORLD = 2


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _split(n=N, seed=5):
    train, test = train_test_split(rcv1_like(n, n_features=D, nnz=NNZ, seed=seed,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _owned_ids(n_true, rng, k=K, b=B, world=WORLD):
    """[world, steps, K, B] ids, each rank's workers drawing from their own
    sub-shards of the rank's padded shard."""
    total, _ = jsync.padded_layout(n_true, world)
    shard_n = total // world
    steps = tsync.steps_per_epoch_for(n_true, world, k, b)
    sub = -(-shard_n // k)
    starts = np.minimum(np.arange(k) * sub, shard_n - 1)
    sizes = np.maximum(shard_n - starts, 1)
    sel = rng.integers(0, sub, (world, steps, k, b))
    return (sel % np.minimum(sub, sizes)[:, None] + starts[:, None]).astype(np.int64)


def _jax_local_sgd_draws(seed, n_rounds, h, b, shard_n, world=WORLD):
    """[world, rounds, h, 1, B]: the ids of a JAX LocalSGDEngine fit on a
    mesh of `world` devices (split the key per round, fold in the device
    position, then the step)."""
    key = jax.random.PRNGKey(seed)
    out = [[] for _ in range(world)]
    for _ in range(n_rounds):
        key, rk = jax.random.split(key)
        for d in range(world):
            dk = jax.random.fold_in(rk, d)
            out[d].append(np.stack([
                np.asarray(jax.random.randint(jax.random.fold_in(dk, t), (b,), 0, shard_n))
                for t in range(h)])[:, None, :].astype(np.int64))
    return np.asarray(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every 2-rank case of this file, written here and run in one world
    (one start of the ranks); the JAX references are computed by the
    tests."""
    d = str(tmp_path_factory.mktemp("ranks"))
    train, test, ds = _split()
    base = dict(ds=ds, **torch_ranks.dataset_arrays("train", train),
                **torch_ranks.dataset_arrays("test", test))
    meta = dict(model="hinge", lam=1e-4, reg="dim_sparsity", batch=B, lr=LR, k=K)
    ids = _owned_ids(len(train), np.random.default_rng(0))
    torch_ranks.write_case(d, "sync", dict(meta, kind="sync"), ids=ids, **base)

    dense = dense_regression(1000, n_features=64, seed=3)
    dtrain, dtest = dense.slice(slice(0, 800)), dense.slice(slice(800, 1000))
    dids = _owned_ids(len(dtrain), np.random.default_rng(1), k=2, b=16)
    torch_ranks.write_case(
        d, "dense", dict(model="least_squares", lam=1e-4, reg="l2", batch=16, lr=0.01, k=2,
                         kind="sync"),
        ids=dids, ds=np.zeros(64, np.float32),
        **torch_ranks.dataset_arrays("train", dtrain), **torch_ranks.dataset_arrays("test", dtest))

    h, lb = 16, 16
    shard_n = jsync.padded_layout(len(train), WORLD)[0] // WORLD
    rounds = -(-len(train) // (WORLD * h))
    draws = _jax_local_sgd_draws(4, rounds, h, lb, shard_n)
    torch_ranks.write_case(
        d, "local", dict(meta, kind="local", batch=lb, lr=0.001, h=h, check_every=256, seed=4,
                         optimizer="adam"),
        draws=draws, **base)

    torch_ranks.write_case(d, "host_local", dict(kind="host_local"),
                           **torch_ranks.dataset_arrays("train", train),
                           **torch_ranks.dataset_arrays("dense", dtrain))
    torch_ranks.write_case(d, "resume", dict(meta, kind="resume", optimizer="adam", lr=0.001),
                           **base)
    out = torch_ranks.spawn(d, WORLD, ["sync", "dense", "local", "host_local", "resume"],
                            timeout=150)
    return dict(out=out, train=train, test=test, ds=ds, ids=ids, dense=(dtrain, dtest),
                dids=dids, draws=draws, h=h, lb=lb)


# -- one process: the seams with no group ------------------------------------


def test_with_no_process_group_the_world_is_this_process():
    t = torch.arange(4.0)
    assert (tmesh.world_size(), tmesh.rank(), tmesh.distributed()) == (1, 0, False)
    assert tmesh.all_reduce_sum(t) is t and tmesh.all_reduce_max(7) == 7
    assert tmesh.all_gather_cat(t) is t
    tmesh.barrier()


def test_local_device_groups_match_jax():
    from distributed_sgd_tpu.parallel.mesh import local_device_groups as jgroups

    devs = ["cpu"] * 8
    got = tmesh.local_device_groups(devs, 3, 2)
    assert [len(g) for g in got] == [len(g) for g in jgroups(list(range(8)), 3, 2)] == [2] * 3
    assert all(d == torch.device("cpu") for g in got for d in g)
    for fn in (tmesh.local_device_groups, jgroups):
        with pytest.raises(ValueError, match="5 workers x 2 devices need 10 devices, found 8"):
            fn(devs, 5, 2)


@pytest.mark.parametrize("n", [1, 7, 100, 4095, 4096, 4097, 10_001, 804_414])
def test_host_shard_bounds_match_jax(n):
    for procs in (1, 2, 3, 4, 8):
        for chunk in (64, 4096):
            want = [jmultihost.host_shard_bounds(n, p, procs, local_device_count=1,
                                                 eval_chunk=chunk) for p in range(procs)]
            got = [tmultihost.host_shard_bounds(n, p, procs, eval_chunk=chunk)
                   for p in range(procs)]
            assert got == want
            total, _ = tsync.padded_layout(n, procs, chunk)
            assert got[0][0] == 0 and got[-1][1] == total


# -- two ranks against a 2-device mesh ----------------------------------------


@pytest.mark.parametrize("kernel", ["pallas", "mxu"])
def test_two_ranks_of_the_sync_engine_match_a_two_device_mesh(ranks, kernel):
    train, test, ds = ranks["train"], ranks["test"], ranks["ds"]
    jm = jax_make_model("hinge", 1e-4, D, dim_sparsity=jnp.asarray(ds))
    eng = jsync.SyncEngine(jm, make_mesh(WORLD), batch_size=B, learning_rate=LR, kernel=kernel,
                           virtual_workers=K)
    jb = eng.bind(train)
    table = jnp.asarray(ranks["ids"], jnp.int32)
    jb._sample_ids = lambda key, step: table[jax.lax.axis_index("workers"), step]
    w_j = np.asarray(jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0)))
    r0, r1 = ranks["out"]["sync"]
    assert int(r0["steps"]) == jb.steps_per_epoch == ranks["ids"].shape[1]
    assert int(r0["shard_n"]) == jb.shard_n
    # every rank applies the update to the same all-reduced bits
    for key in ("w", "train_eval", "test_eval", "preds"):
        np.testing.assert_array_equal(r0[key], r1[key])
    assert np.abs(w_j).max() > 1e-2
    np.testing.assert_allclose(r0["w"], w_j, atol=1e-5)
    np.testing.assert_allclose(r0["train_eval"], jb.evaluate(jnp.asarray(w_j)), rtol=1e-5)
    jt = eng.bind(test)
    np.testing.assert_allclose(r0["test_eval"], jt.evaluate(jnp.asarray(w_j)), rtol=1e-5)
    # the ranks' predictions, gathered in rank order, are one process's
    tm = convert.model_from_jax("hinge", 1e-4, D, ds, device="cpu")
    one = tsync.SyncEngine(tm, batch_size=B, learning_rate=LR, device="cpu").bind(
        TDataset(test.indices, test.values, test.labels, D))
    np.testing.assert_array_equal(r0["preds"], one.predict(torch.from_numpy(r0["w"])))
    assert r0["preds"].shape == (len(test),)


def test_two_ranks_of_the_dense_layout_match_a_two_device_mesh(ranks):
    dtrain, dtest = ranks["dense"]
    jm = jax_make_model("least_squares", 1e-4, 64, regularizer="l2")
    eng = jsync.SyncEngine(jm, make_mesh(WORLD), batch_size=16, learning_rate=0.01,
                           virtual_workers=2)
    jb = eng.bind(dtrain)
    assert jb.kernel == "dense"
    table = jnp.asarray(ranks["dids"], jnp.int32)
    jb._sample_ids = lambda key, step: table[jax.lax.axis_index("workers"), step]
    w_j = np.asarray(jb.epoch(jnp.zeros(64, jnp.float32), jax.random.PRNGKey(0)))
    r0, r1 = ranks["out"]["dense"]
    np.testing.assert_array_equal(r0["w"], r1["w"])
    assert np.abs(w_j).max() > 1e-3
    np.testing.assert_allclose(r0["w"], w_j, atol=1e-5)
    np.testing.assert_allclose(r0["train_eval"], jb.evaluate(jnp.asarray(w_j)), rtol=1e-5)
    np.testing.assert_allclose(r0["test_eval"], eng.bind(dtest).evaluate(jnp.asarray(w_j)),
                               rtol=1e-5)


def test_two_ranks_of_local_sgd_with_adam_match_a_two_device_mesh(ranks):
    train, test, ds = ranks["train"], ranks["test"], ranks["ds"]
    jm = jax_make_model("hinge", 1e-4, D, dim_sparsity=jnp.asarray(ds))
    jr = JaxLocalSGD(jm, make_mesh(WORLD), batch_size=ranks["lb"], learning_rate=0.001,
                     sync_period=ranks["h"], check_every=256, seed=4, optimizer="adam",
                     metrics=JaxMetrics()).fit(train, test, 1)
    r0, r1 = ranks["out"]["local"]
    np.testing.assert_array_equal(r0["w"], r1["w"])
    np.testing.assert_array_equal(r0["test_losses"], r1["test_losses"])
    assert int(r0["updates"]) == jr.state.updates
    assert len(r0["test_losses"]) == len(jr.test_losses) >= 4
    np.testing.assert_allclose(r0["test_losses"], jr.test_losses, atol=1e-5)
    np.testing.assert_allclose(r0["test_accuracies"], jr.test_accuracies, atol=1e-5)
    np.testing.assert_allclose(r0["w"], np.asarray(jr.weights), atol=1e-5)


def test_bind_host_local_is_bind_bitwise(ranks):
    train, dtrain = ranks["train"], ranks["dense"][0]
    for r, got in enumerate(ranks["out"]["host_local"]):
        for prefix, data in (("train", train), ("dense", dtrain)):
            for name in ("indices", "values", "labels"):
                assert bool(got[f"{prefix}_{name}_equal"]), (r, prefix, name)
            lay = got[f"{prefix}_layout"]
            assert lay[0] == lay[1] and lay[2] == lay[3] and lay[4] == lay[5]
            # each rank holds its padded range of the rows, no more
            start, end = tmultihost.host_shard_bounds(len(data), r, WORLD)
            want = np.zeros(end - start, np.float32)
            real = data.labels[start:min(end, len(data))]
            want[:len(real)] = real
            np.testing.assert_array_equal(got[f"{prefix}_labels"], want)


def test_a_resumed_two_rank_fit_equals_the_run_through_and_rank_0_writes(ranks):
    r0, r1 = ranks["out"]["resume"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["resumed"], r["through"])
        # the resumed fit's epochs 1 and 2 are the run through's
        np.testing.assert_array_equal(r["resumed_losses"], r["through_losses"][1:])
    np.testing.assert_array_equal(r0["through"], r1["through"])
    # one snapshot a step, rank 0's: rank 1 wrote nothing at all
    assert r0["written_through"].tolist() == [1, 2, 3]
    assert r0["written"].tolist() == [1, 2, 3, 1, 2, 3]
    assert r1["written"].size == 0


# -- the CLI under torchrun's environment -------------------------------------


@pytest.mark.parametrize("node_count", [3, 1])
def test_the_cli_runs_the_sync_fit_over_a_two_rank_world(tmp_path, node_count):
    # node_count 3 on 2 ranks: 2 ranks x 2 virtual workers (rounded up, as
    # JAX's select_topology); node_count 1: rank 1 takes no part and
    # returns rank 0's result
    env = {"DSGD_SYNTHETIC": "3000", "DSGD_MAX_EPOCHS": "2", "DSGD_NODE_COUNT": str(node_count),
           "DSGD_CHECKPOINT_DIR": str(tmp_path / "ckpt")}
    outs, logs = torch_ranks.cli_world(tmp_path, WORLD, env)
    np.testing.assert_array_equal(outs[0]["w"], outs[1]["w"])
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    assert int(outs[0]["epochs"]) == 2 and outs[0]["losses"][-1] < 1.0
    assert "process 0/2" in logs[0] and "process 1/2" in logs[1]
    want = "devices=2 virtual_workers=2" if node_count == 3 else "devices=1 virtual_workers=1"
    assert want in logs[0]
    if node_count == 1:
        assert "rank 1 takes no part in the fit" in logs[1]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1.npz", "2.npz"]
