"""The port's SyncTrainer and CLI scenario (distributed_sgd_tpu_torch/
core/trainer.py, main.py) against the JAX package's, on the CPU.

With the same sample ids injected on both sides, the four per-epoch
series agree to rtol 1e-5 (f32 sums in another order).  With each side's
own random source, the port's main scenario lands within 0.03 test
accuracy of the JAX trainer at the same config and one-card topology."""

import logging
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.trainer import SyncTrainer as JaxTrainer
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.main import select_topology as jax_select_topology
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset

torch.set_num_threads(1)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _inject(trainer, ids_for):
    """Wrap trainer.engine.bind so every bound split gets injected ids."""
    bind = trainer.engine.bind

    def bind_injected(data, *args, **kw):
        bound = bind(data, *args, **kw)
        ids_for(bound)
        return bound

    trainer.engine.bind = bind_injected


def test_fit_with_injected_ids_gives_the_same_four_series():
    d, k, b = 1500, 3, 40
    data = rcv1_like(2400, n_features=d, nnz=16, seed=8, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    jt = JaxTrainer(jax_make_model("hinge", 1e-4, d, dim_sparsity=jnp.asarray(ds)),
                    make_mesh(1), batch_size=b, learning_rate=0.5, virtual_workers=k)
    tt = SyncTrainer(tmain.make_model("hinge", 1e-4, d, dim_sparsity=ds, device="cpu"),
                     batch_size=b, learning_rate=0.5, virtual_workers=k, device="cpu")
    rng = np.random.default_rng(0)
    ids = {}

    def draw(bound):  # the same ids every epoch, on both sides
        if bound.shard_n not in ids:
            sub, starts, sizes = bound._subshards()
            sel = rng.integers(0, sub, (bound.steps_per_epoch, k, b))
            ids[bound.shard_n] = sel % np.minimum(sub, sizes)[:, None] + starts[:, None]
        return ids[bound.shard_n]

    def jax_ids(bound):
        bound._sample_ids = lambda key, step, a=jnp.asarray(draw(bound), jnp.int32): a[step]

    def torch_ids(bound):
        bound._sample_ids = lambda key, a=torch.from_numpy(draw(bound)): a

    _inject(jt, jax_ids)
    _inject(tt, torch_ids)
    jr = jt.fit(train, test, 3)
    tr = tt.fit(_torch(train), _torch(test), 3)
    assert tr.epochs_run == jr.epochs_run == 3
    assert tr.steps_per_epoch == 16
    for name in ("losses", "accuracies", "test_losses", "test_accuracies"):
        np.testing.assert_allclose(getattr(tr, name), getattr(jr, name), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights), atol=1e-5)


def test_main_scenario_lands_in_the_jax_accuracy_band(caplog):
    d = 5000
    data = rcv1_like(20000, n_features=d, nnz=40, seed=0, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    cfg = Config(max_epochs=3)
    n, virtual = jax_select_topology(cfg.node_count, 1, False)
    assert tmain.select_topology(cfg.node_count, 1, False) == (n, virtual) == (1, 3)
    jr = JaxTrainer(jax_make_model(cfg.model, cfg.lam, d, dim_sparsity=jnp.asarray(ds)),
                    make_mesh(n), batch_size=cfg.batch_size,
                    learning_rate=cfg.learning_rate, seed=cfg.seed,
                    virtual_workers=virtual).fit(train, test, cfg.max_epochs)
    model = tmain.make_model(cfg.model, cfg.lam, d, dim_sparsity=ds, device="cpu")
    with caplog.at_level(logging.INFO, logger="dsgd"):
        res = tmain.scenario_mesh(cfg, _torch(train), _torch(test), model, device="cpu")
    assert res.epochs_run == 3 and res.steps_per_epoch == 54
    assert abs(res.test_accuracies[-1] - jr.test_accuracies[-1]) <= 0.03
    assert res.test_losses[-1] < res.test_losses[0]
    assert "epoch 2: loss=" in caplog.text and "test losses:" in caplog.text


def test_config_reads_the_jax_env_names_and_refuses_what_is_not_ported(monkeypatch):
    monkeypatch.setenv("DSGD_BATCH_SIZE", "64")
    monkeypatch.setenv("DSGD_LAMBDA", "0.002")
    monkeypatch.setenv("DSGD_EXACT_TOPOLOGY", "yes")
    cfg = Config.from_env()
    assert (cfg.batch_size, cfg.lam, cfg.exact_topology) == (64, 0.002, True)
    assert cfg.learning_rate == 0.5 and cfg.node_count == 3 and cfg.max_epochs == 10
    monkeypatch.setenv("DSGD_ASYNC", "1")
    monkeypatch.setenv("DSGD_ASYNC_MODE", "local_sgd")
    monkeypatch.setenv("DSGD_SYNC_PERIOD", "256")
    monkeypatch.setenv("DSGD_GOSSIP_TOPOLOGY", "random:2")
    cfg = Config.from_env()
    assert (cfg.use_async, cfg.async_mode, cfg.sync_period, cfg.gossip_topology) == (
        True, "local_sgd", 256, "random:2")
    assert (cfg.check_every, cfg.leaky_loss, cfg.steps_per_dispatch, cfg.compress) == (
        100, 0.9, 1, "none")
    assert (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.profile_dir, cfg.feature_shards) == (
        None, 1, None, 1)
    monkeypatch.setenv("DSGD_ENGINE", "rpc")
    assert Config.from_env().engine == "rpc"  # the in-process gRPC cluster
    monkeypatch.setenv("DSGD_ENGINE", "grpc")
    with pytest.raises(ValueError, match="DSGD_ENGINE"):
        Config.from_env()
    monkeypatch.setenv("DSGD_ENGINE", "mesh")
    # the role, as the JAX Config derives it (config.py:683-693)
    assert Config.from_env().role == "dev"
    monkeypatch.setenv("DSGD_MASTER_HOST", "10.0.0.1")
    monkeypatch.setenv("DSGD_MASTER_PORT", "4000")
    assert Config.from_env().role == "worker"
    monkeypatch.setenv("DSGD_NODE_HOST", "10.0.0.1")
    assert Config.from_env().role == "master"
    monkeypatch.setenv("DSGD_ROLE", "worker")
    assert Config.from_env().role == "worker"
    monkeypatch.setenv("DSGD_ROLE", "leader")
    with pytest.raises(ValueError, match="DSGD_ROLE"):
        Config.from_env()
    with pytest.raises(ValueError, match="async_mode"):
        Config(use_async=True, async_mode="hogwild")
    with pytest.raises(ValueError, match="DSGD_GOSSIP_TOPOLOGY"):
        Config(gossip_topology="star")
    # the fault tolerance's settings, validated as the JAX Config does
    monkeypatch.setenv("DSGD_HEARTBEAT_MAX_MISSES", "7")
    monkeypatch.setenv("DSGD_QUORUM", "2")
    monkeypatch.setenv("DSGD_STRAGGLER_SOFT_S", "0.5")
    monkeypatch.setenv("DSGD_ROLE", "master")
    cfg = Config.from_env()
    assert (cfg.heartbeat_max_misses, cfg.quorum, cfg.straggler_soft_s) == (7, 2, 0.5)
    for bad, words in (({"quorum": 0}, "quorum"), ({"straggler_soft_s": 0.0}, "straggler"),
                       ({"heartbeat_max_misses": 0}, "heartbeat_max_misses"),
                       ({"fit_ckpt_every": 5}, "DSGD_CHECKPOINT_DIR")):
        with pytest.raises(ValueError, match=words):
            Config(**bad)


_MASTER = {"DSGD_MASTER_HOST": "127.0.0.1", "DSGD_MASTER_PORT": "4000",
           "DSGD_NODE_HOST": "127.0.0.1", "DSGD_NODE_PORT": "4000"}
_WORKER = {"DSGD_MASTER_HOST": "127.0.0.1", "DSGD_MASTER_PORT": "4000",
           "DSGD_NODE_PORT": "4001"}
_RPC = {"DSGD_ENGINE": "rpc"}


@pytest.mark.parametrize("env", [
    {"DSGD_FEATURE_SHARDS": "2"},
    {"DSGD_COMPRESS": "topk", "DSGD_ASYNC": "1"},
    {"DSGD_COMPRESS": "qint8", "DSGD_ASYNC": "1", "DSGD_ASYNC_MODE": "local_sgd"},
    # every role: autopilot, chaos, the telemetry scrape, the health action
    # (the serving roles, push, the resource probe and the blackbox run
    # now: tests/test_torch_serving.py, tests/test_torch_resources.py)
    {"DSGD_AUTOPILOT": "1"},
    {"DSGD_CHAOS": "seed=7;drop=0.05"},
    {"DSGD_TELEMETRY": "1"},
    {"DSGD_HEALTH_ACTION": "warn"},
    {"DSGD_HOST_DEVICES": "2"},
    # the rpc fits (dev engine=rpc, and the master role); DSGD_ASYNC=1,
    # DSGD_ASYNC_DRAIN, the fault tolerance and the pipelined levers run
    # there now (tests/test_torch_rpc_async.py, the test after this one,
    # tests/test_torch_rpc_pipeline.py), and so do the aggregation tree and
    # the sharded master (the next three: accepted now, see the test;
    # tests/test_torch_aggtree.py, tests/test_torch_shardedps.py)
    {**_RPC, "DSGD_AGG_TREE": "fanout:2"},
    {**_RPC, "DSGD_MASTER_SHARDS": "2"},
    {**_MASTER, "DSGD_AGG_TREE": "fanout:2", "DSGD_LOCAL_STEPS": "2"},
], ids=lambda env: "+".join(f"{k[5:].lower()}={v}" for k, v in env.items()
                            if k not in ("DSGD_MASTER_HOST", "DSGD_NODE_HOST")))
def test_settings_not_ported_raise_before_any_data_loads(env, monkeypatch):
    # the JAX CLI acts on each of these; the port must not ignore one.
    # DSGD_AGG_TREE and DSGD_MASTER_SHARDS once raised here too; they are
    # accepted now, and the run goes on to load its data
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "DSGD_AGG_TREE" in env or "DSGD_MASTER_SHARDS" in env:
        class _Loaded(Exception):
            pass

        def loaded(cfg):
            raise _Loaded

        monkeypatch.setattr(tmain, "load_data", loaded)
        with pytest.raises(_Loaded):
            tmain.main(device="cpu")
        return
    monkeypatch.setattr(tmain, "load_data", lambda cfg: pytest.fail("data was loaded"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        tmain.main(device="cpu")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("role,env", [
    ("dev", {**_RPC, "DSGD_HEARTBEAT_S": "0.5"}),
    ("dev", {**_RPC, "DSGD_QUORUM": "2"}),
    ("dev", {**_RPC, "DSGD_STRAGGLER_SOFT_S": "1.0"}),
    ("dev", {**_RPC, "DSGD_ELASTIC": "1", "DSGD_ASYNC": "1"}),
    ("dev", {**_RPC, "DSGD_FIT_CKPT_EVERY": "10"}),
    ("master", {"DSGD_HEARTBEAT_S": "0.5"}),
    ("master", {"DSGD_QUORUM": "2"}),
    ("worker", {"DSGD_ELASTIC": "1", "DSGD_HEARTBEAT_S": "0.2"}),
], ids=lambda x: x if isinstance(x, str) else "+".join(
    f"{k[5:].lower()}={v}" for k, v in x.items()))
def test_the_fault_tolerance_settings_act_in_their_role(role, env, monkeypatch, tmp_path):
    """The settings of the rpc engine's fault tolerance, once refused,
    reach the node that acts on them and the fit runs: the heartbeat on
    the master, the quorum and the soft deadline in fit_sync, elastic
    membership in fit_async, the fit-state snapshots under the checkpoint
    directory, and the master watch on the worker role."""
    from distributed_sgd_tpu_torch.core.master import MasterNode
    from distributed_sgd_tpu_torch.core.worker import WorkerNode

    for k, v in {**env, "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "2"}.items():
        monkeypatch.setenv(k, v)
    if "DSGD_FIT_CKPT_EVERY" in env:
        monkeypatch.setenv("DSGD_CHECKPOINT_DIR", str(tmp_path))
    seen = {"start": [], "fit_sync": [], "fit_async": [], "watch": [], "hb": []}
    real = {name: getattr(MasterNode, name) for name in ("start", "fit_sync", "fit_async")}

    def start(node, *a, **kw):
        seen["start"].append(kw)
        out = real["start"](node, *a, **kw)
        seen["hb"].append(node._hb_thread is not None)
        return out

    def fit(name):
        def run(node, *a, **kw):
            seen[name].append(kw)
            return real[name](node, *a, **kw)
        return run

    real_init = WorkerNode.__init__

    def init(node, *a, **kw):
        seen["watch"].append(kw.get("master_watch_s"))
        real_init(node, *a, **kw)

    monkeypatch.setattr(MasterNode, "start", start)
    monkeypatch.setattr(MasterNode, "fit_sync", fit("fit_sync"))
    monkeypatch.setattr(MasterNode, "fit_async", fit("fit_async"))
    monkeypatch.setattr(WorkerNode, "__init__", init)
    if role == "dev":
        run = tmain.main(device="cpu")
        assert run.fit is not None and np.isfinite(run.fit.state.loss)
    else:
        port = _free_port()
        box = {}

        def go(name, cfg):
            try:
                box[name] = tmain.main(device="cpu", cfg=cfg)
            except Exception as e:  # noqa: BLE001 - surfaced below
                box[name] = e

        master_cfg = Config.from_env(host="127.0.0.1", port=port, master_host="127.0.0.1",
                                     master_port=port)
        assert master_cfg.role == "master"
        threads = [threading.Thread(target=go, args=("master", master_cfg), daemon=True)]
        for i in range(2):
            cfg = Config.from_env(host="127.0.0.1", port=0, master_host="127.0.0.1",
                                  master_port=port)
            assert cfg.role == "worker"
            threads.append(threading.Thread(target=go, args=(f"w{i}", cfg), daemon=True))
        for t in threads:
            t.start()
        threads[0].join(timeout=120)
        tmain.stop_workers()
        for t in threads[1:]:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for name, out in box.items():
            assert not isinstance(out, Exception), (name, out)
        assert box["master"].fit.epochs_run == 1
    if "DSGD_HEARTBEAT_S" in env and role != "worker":
        assert seen["start"][0]["heartbeat_s"] == 0.5 and seen["hb"] == [True]
    if "DSGD_QUORUM" in env:
        assert seen["fit_sync"][0]["quorum"] == 2
    if "DSGD_STRAGGLER_SOFT_S" in env:
        assert seen["fit_sync"][0]["straggler_soft_s"] == 1.0
    if "DSGD_ASYNC" in env:
        assert seen["fit_async"][0]["elastic"] is True
    if "DSGD_FIT_CKPT_EVERY" in env:
        assert seen["fit_sync"][0]["fit_state_every"] == 10
        with np.load(tmp_path / "fit_state.npz") as z:
            assert (int(z["epoch"]), int(z["batch"])) == (1, 0)
    if role == "worker":
        assert seen["watch"] == [0.2, 0.2]


@pytest.mark.parametrize("env,words", [
    ({"DSGD_LOCAL_STEPS": "4"}, "DSGD_LOCAL_STEPS/DSGD_DELTA_BROADCAST/DSGD_STREAM/"),
    ({"DSGD_DELTA_BROADCAST": "1"}, "DSGD_MASTER_SHARDS ignored"),
    ({"DSGD_STREAM": "1"}, "the pipelined sync engine is the rpc topology's"),
    ({"DSGD_FANIN_LANES": "2"}, "DSGD_FANIN_LANES/DSGD_STAGE_POOL"),
    ({"DSGD_STAGE_POOL": "2"}, "DSGD_FANIN_LANES/DSGD_STAGE_POOL"),
    ({"DSGD_AGG_TREE": "fanout:2"}, "DSGD_STAGE_POOL/DSGD_AGG_TREE/"),
    ({"DSGD_MASTER_SHARDS": "2"}, "DSGD_MASTER_SHARDS ignored"),
    ({"DSGD_QUORUM": "2"}, "DSGD_QUORUM/DSGD_CHAOS ignored"),
    ({"DSGD_ELASTIC": "1"}, "DSGD_ELASTIC/DSGD_ASYNC_DRAIN/DSGD_FIT_CKPT_EVERY ignored"),
    ({"DSGD_ASYNC_DRAIN": "1"}, "the elastic + crash-recovery subsystem"),
    ({"DSGD_FIT_CKPT_EVERY": "5", "DSGD_CHECKPOINT_DIR": "ckpt"},
     "DSGD_FIT_CKPT_EVERY ignored"),
    ({"DSGD_HOST_DEVICES": "0"}, "DSGD_HOST_DEVICES ignored"),
    ({"DSGD_GOSSIP_TOPOLOGY": "ring"}, "DSGD_GOSSIP_TOPOLOGY=ring ignored"),
], ids=lambda x: x if isinstance(x, str) and " " not in x else None)
def test_the_mesh_engine_warns_about_the_rpc_settings_it_ignores(env, words, monkeypatch,
                                                                 caplog):
    # the JAX mesh scenario's warnings, in its words (main.py:152-206)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    assert (cfg.role, cfg.engine) == ("dev", "mesh")
    with caplog.at_level(logging.WARNING, logger="dsgd"):
        tmain.warn_mesh_ignored(cfg)
    assert words in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dsgd"):
        tmain.warn_mesh_ignored(Config())
    assert caplog.text == ""


def test_the_optimizer_setting_reaches_the_trainer(monkeypatch):
    # the JAX CLI trains momentum or Adam under DSGD_OPTIMIZER; so does the
    # port, with DSGD_MOMENTUM as the trace's decay
    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_OPTIMIZER", "adam")
    monkeypatch.setenv("DSGD_MOMENTUM", "0.5")
    cfg = Config.from_env()
    assert (cfg.optimizer, cfg.momentum) == ("adam", 0.5)
    from distributed_sgd_tpu_torch.ops import sync_epoch as se

    seen, real = [], se.apply_update
    monkeypatch.setattr(se, "apply_update", lambda w, g, lr, opt, state: seen.append(
        (opt, state.count)) or real(w, g, lr, opt, state))
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1 and run.fit.steps_per_epoch == 2
    assert [(opt.kind, count) for opt, count in seen] == [("adam", 0), ("adam", 1)]
    assert np.isfinite(run.fit.test_losses).all()
    monkeypatch.setenv("DSGD_OPTIMIZER", "momentum")
    seen.clear()
    run = tmain.main(device="cpu")
    assert [(opt.kind, opt.momentum) for opt, _ in seen] == [("momentum", 0.5)] * 2
    assert run.fit.epochs_run == 1 and np.isfinite(run.fit.test_losses).all()
    monkeypatch.setenv("DSGD_OPTIMIZER", "rmsprop")
    with pytest.raises(ValueError, match="optimizer"):
        Config.from_env()
    monkeypatch.setenv("DSGD_OPTIMIZER", "sgd")
    seen.clear()
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1 and run.fit.steps_per_epoch == 2
    assert [opt.kind for opt, _ in seen] == ["sgd"] * 2
    assert Config().optimizer == "sgd"


@pytest.mark.parametrize("mode", ["sync", "gossip", "local_sgd"])
def test_the_checkpoint_dir_saves_and_resumes_through_main(mode, tmp_path, monkeypatch, caplog):
    # DSGD_CHECKPOINT_DIR, which the port refused before, now leaves a
    # snapshot that a second run resumes, in every engine
    from distributed_sgd_tpu_torch.checkpoint import Checkpointer

    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_CHECKPOINT_DIR", str(tmp_path))
    if mode != "sync":
        monkeypatch.setenv("DSGD_ASYNC", "1")
        monkeypatch.setenv("DSGD_ASYNC_MODE", mode)
        monkeypatch.setenv("DSGD_STEPS_PER_DISPATCH", "8")
        monkeypatch.setenv("DSGD_SYNC_PERIOD", "4")
        monkeypatch.setenv("DSGD_CHECK_EVERY", "120")
        monkeypatch.setenv("DSGD_PATIENCE", "1000")  # the budget ends each fit
    first = tmain.main(device="cpu").fit
    step, state = Checkpointer(str(tmp_path)).restore_latest()
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "2")
    with caplog.at_level(logging.INFO, logger="dsgd"):
        second = tmain.main(device="cpu").fit
    if mode == "sync":
        assert step == 1 and state["test_losses_nf"].tolist() == pytest.approx(first.test_losses)
        np.testing.assert_array_equal(state["weights"], first.weights.numpy())
        assert "resumed from checkpoint at epoch 1" in caplog.text
        assert second.epochs_run == 2 and len(second.losses) == 1
        assert Checkpointer(str(tmp_path)).latest_step() == 2
        monkeypatch.delenv("DSGD_CHECKPOINT_DIR")
        whole = tmain.main(device="cpu").fit
        assert second.test_losses == whole.test_losses[1:]
        assert torch.equal(second.weights, whole.weights)
    else:
        np.testing.assert_array_equal(state["weights"], first.weights.numpy())
        assert int(state["updates"]) <= first.state.updates
        assert "warm start from checkpoint at step %d" % step in caplog.text
        n = 480  # train rows: the budget is n a max epoch, counted over both runs
        assert first.state.updates >= n and second.state.updates >= 2 * n
        assert second.test_losses[:len(state["smoothed_nf"])] == pytest.approx(
            state["smoothed_nf"][::-1].tolist())


def test_the_profile_dir_leaves_a_trace_through_main(tmp_path, monkeypatch):
    # DSGD_PROFILE_DIR, which the port refused before, now writes the
    # torch.profiler trace of the second epoch
    import json

    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "2")
    monkeypatch.setenv("DSGD_PROFILE_DIR", str(tmp_path))
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 2
    assert os.listdir(tmp_path) == ["trainer-epoch1.trace.json"]
    with open(tmp_path / "trainer-epoch1.trace.json") as f:
        assert any(e.get("name") == "aten::randint" for e in json.load(f)["traceEvents"])
