"""The port's checkpoint plane (distributed_sgd_tpu_torch/checkpoint.py,
utils/fsio.py, utils/measure.py, the Timer in utils/metrics.py) and its
wiring through SyncTrainer, LossChecker, Hogwild and local SGD, against
the JAX package's on the same numpy inputs, on the CPU.

The JAX package writes through orbax, the port through its own
``<step>.npz`` files; both speak one snapshot contract, so the JAX
trainer and checker run here on the port's Checkpointer, and the port on
snapshots the JAX trainer wrote.  Tolerances: restored arrays and file
contents bitwise; a resumed port fit against its own uninterrupted fit
bitwise (the plain kernel on the CPU is deterministic); training series
across the two packages rtol 1e-5 (f32 sums in another order), with the
same sample ids injected on both sides as tests/test_torch_trainer.py
does."""

import json
import logging
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu import checkpoint as jckpt
from distributed_sgd_tpu.core.loss_check import LossChecker as JaxChecker
from distributed_sgd_tpu.core.trainer import SyncTrainer as JaxTrainer
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.utils import fsio as jfsio
from distributed_sgd_tpu.utils import measure as jmeasure
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import checkpoint as tckpt
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.core.loss_check import LossChecker
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer, profile_trace_path
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel import sync as tsync
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.utils import fsio, measure
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

D, K, B = 300, 3, 20
LR = {"sgd": 0.5, "momentum": 0.05, "adam": 0.01}


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(1200, n_features=D, nnz=10, seed=3,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _port_trainer(ds, opt="sgd", **kw):
    model = convert.model_from_jax("hinge", 1e-4, D, ds, device="cpu")
    return SyncTrainer(model, B, LR[opt], virtual_workers=K, optimizer=opt, device="cpu", **kw)


def _jax_trainer(ds, opt="sgd", **kw):
    model = jax_make_model("hinge", 1e-4, D, dim_sparsity=jnp.asarray(ds))
    return JaxTrainer(model, make_mesh(1), B, LR[opt], virtual_workers=K,
                      optimizer=None if opt == "sgd" else opt, **kw)


def _steps(directory):
    """The saved steps of a directory in either format, ascending."""
    return sorted(int(n.split(".")[0]) for n in os.listdir(directory)
                  if n.split(".")[0].isdigit() and (n.endswith(".npz") or "." not in n))


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# -- the Checkpointer against orbax's ----------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "jax", "torch"])
def test_round_trip_restores_what_orbax_restores(kind, tmp_path):
    w = np.arange(10, dtype=np.float32) / 7
    weights = {"numpy": w, "jax": jnp.asarray(w), "torch": torch.from_numpy(w)}[kind]
    extra = {"loss": np.float32(0.5), "best_loss": 0.25, "updates": 7,
             "smoothed_nf": np.asarray([0.3, 0.4], np.float32),
             "opt_kind": np.frombuffer(b"adam", np.uint8)}
    j = jckpt.Checkpointer(str(tmp_path / "orbax"))
    t = tckpt.Checkpointer(str(tmp_path / "port"))
    assert j.save(3, weights, extra=extra) and t.save(3, weights, extra=extra)
    (js, jstate), (ts, tstate) = j.restore_latest(), t.restore_latest()
    assert js == ts == 3 and j.latest_step() == t.latest_step() == 3
    assert all(type(v) is np.ndarray for v in tstate.values())
    _same_state(tstate, jstate)
    j.close()
    t.close()


def test_keeps_the_newest_as_orbax_does(tmp_path):
    j = jckpt.Checkpointer(str(tmp_path / "orbax"), keep=2)
    t = tckpt.Checkpointer(str(tmp_path / "port"), keep=2)
    for step in (1, 2, 3):
        for c in (j, t):
            c.save(step, np.full(4, float(step), dtype=np.float32))
    assert _steps(j.directory) == _steps(t.directory) == [2, 3]
    step, state = t.restore_latest()
    assert step == 3
    np.testing.assert_array_equal(state["weights"], np.full(4, 3.0, np.float32))
    j.close()


def test_a_save_to_an_existing_step_writes_nothing(tmp_path, caplog):
    j = jckpt.Checkpointer(str(tmp_path / "orbax"))
    t = tckpt.Checkpointer(str(tmp_path / "port"))
    for c in (j, t):
        assert c.save(5, np.ones(3, np.float32)) is True
    with caplog.at_level(logging.WARNING, logger="dsgd.checkpoint"):
        assert j.save(5, np.zeros(3, np.float32)) is False
        assert t.save(5, np.zeros(3, np.float32)) is False
    assert caplog.text.count("checkpoint at step 5 NOT saved (step exists?)") == 2
    for c in (j, t):
        np.testing.assert_array_equal(np.asarray(c.restore_latest()[1]["weights"]), np.ones(3))
    j.close()


def test_poll_newer_sees_another_writer(tmp_path):
    reader = tckpt.Checkpointer(str(tmp_path))
    assert reader.latest_step() is None and reader.restore_latest() is None
    assert reader.poll_newer(None) is None
    tckpt.Checkpointer(str(tmp_path)).save(4, np.ones(2, np.float32))
    step, state = reader.poll_newer(None)
    assert step == 4 and state["weights"].tolist() == [1.0, 1.0]
    assert reader.poll_newer(4) is None
    tckpt.Checkpointer(str(tmp_path)).save(9, np.zeros(2, np.float32))
    reader.reload()
    assert reader.poll_newer(4)[0] == 9


def test_a_failed_save_leaves_no_file(tmp_path, monkeypatch):
    t = tckpt.Checkpointer(str(tmp_path))
    t.save(1, np.ones(2, np.float32))

    def broken(f, **state):
        f.write(b"PK partial")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        t.save(2, np.zeros(2, np.float32))
    assert sorted(os.listdir(tmp_path)) == ["1.npz"] and t.latest_step() == 1


def test_an_orbax_directory_raises(tmp_path, monkeypatch):
    j = jckpt.Checkpointer(str(tmp_path / "orbax"))
    j.save(2, np.ones(3, np.float32))
    j.close()
    with pytest.raises(ValueError, match="orbax") as err:
        tckpt.Checkpointer(str(tmp_path / "orbax"))
    assert "Re-save it in the port's format" in str(err.value)
    # the CLI fails the same way rather than start a fresh fit beside it
    from distributed_sgd_tpu_torch import main as tmain

    monkeypatch.setenv("DSGD_SYNTHETIC", "300")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_CHECKPOINT_DIR", str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="orbax"):
        tmain.main(device="cpu")
    assert _steps(tmp_path / "orbax") == [2]


# -- the sync-fit contract ----------------------------------------------------

def _leaves(kind, rng, blocked=False):
    n = {"sgd": 0, "momentum": 1, "adam": 2}[kind]
    vecs = [rng.normal(size=D).astype(np.float32) for _ in range(n)]
    if blocked:
        vecs = [convert.to_blocked(v, D) for v in vecs]
    return ([np.asarray(17, np.int32)] if kind == "adam" else []) + vecs


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_the_sync_fit_contract_matches_jax(kind):
    rng = np.random.default_rng(0)
    leaves = _leaves(kind, rng)
    hist = [0.5, 0.6, 0.9]
    je, te = jckpt.sync_fit_extra(hist, kind, leaves), tckpt.sync_fit_extra(
        hist, kind, [torch.from_numpy(np.asarray(x)) for x in leaves])
    _same_state(te, je)
    assert tckpt.opt_kind_tag(kind) == jckpt.opt_kind_tag(kind)
    assert tckpt.opt_kind_tag(None) == jckpt.opt_kind_tag(None) == "sgd"
    state = dict(je, weights=np.ones(D, np.float32))
    (jh, jl), (th, tl) = (m.decode_sync_fit_state(state, kind, leaves) for m in (jckpt, tckpt))
    assert jh == th == pytest.approx(hist)
    assert len(jl) == len(tl) == len(leaves)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["kind", "count", "shape"])
def test_a_mismatched_snapshot_is_refused_as_jax_refuses_it(case):
    rng = np.random.default_rng(1)
    saved = jckpt.sync_fit_extra([0.5], "momentum", _leaves("momentum", rng))
    want_kind, expected = {
        "kind": ("adam", _leaves("adam", rng)),
        "count": ("momentum", _leaves("momentum", rng) * 2),
        "shape": ("momentum", [np.zeros(D + 1, np.float32)]),
    }[case]
    msgs = []
    for m in (jckpt, tckpt):
        with pytest.raises(ValueError) as err:
            m.decode_sync_fit_state(saved, want_kind, expected)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("optimizer" if case == "kind" else "kernel") in msgs[1]


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_the_port_accepts_blocked_leaves_and_jax_refuses_flat_ones_blocked(kind):
    # a JAX mxu engine holds its state lane-blocked [R, 128]; the port's
    # check accepts those leaves beside its own flat ones.  The JAX check
    # refuses flat leaves where it expects blocked ones: a fact of the
    # reference (ROADMAP Queue C), held here so a change to it shows
    rng = np.random.default_rng(2)
    blocked, flat = _leaves(kind, rng, blocked=True), _leaves(kind, rng)
    saved = jckpt.sync_fit_extra([0.5], kind, blocked)
    _, got = tckpt.decode_sync_fit_state(saved, kind, flat)
    state = convert.opt_state_from_jax(got, kind, D, "cpu")
    for v, b in zip(state.vectors, blocked[-len(state.vectors):]):
        np.testing.assert_array_equal(v.numpy(), convert.from_blocked(b, D))
    with pytest.raises(ValueError, match="kernel"):
        jckpt.decode_sync_fit_state(jckpt.sync_fit_extra([], kind, flat), kind, blocked)


class _Recorder:
    def __init__(self):
        self.saves = []

    def save(self, step, weights, extra=None):
        self.saves.append((step, np.asarray(weights).tolist(), sorted(extra or {})))
        return True


@pytest.mark.parametrize("epochs_run,start,every", [
    (3, 0, 5), (5, 0, 5), (4, 2, 3), (2, 2, 1), (7, 3, 2), (0, 0, 1)])
def test_the_off_cadence_final_save_matches_jax(epochs_run, start, every):
    got = []
    for m in (jckpt, tckpt):
        rec = _Recorder()
        called = []
        m.save_sync_fit_final(rec, epochs_run, start, every,
                              lambda: called.append(1) or np.ones(2, np.float32),
                              [0.4], "sgd", [])
        got.append((rec.saves, called))
    assert got[0] == got[1]
    assert bool(got[1][0]) == (epochs_run > start and epochs_run % every != 0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fit_state_files_interchange_bit_for_bit(direction, tmp_path):
    rng = np.random.default_rng(3)
    leaves = _leaves("adam", rng)
    kw = dict(weights=rng.normal(size=D).astype(np.float32), epoch=4, batch=17,
              rng_state=np.random.default_rng(9).bit_generator.state,
              test_losses_nf=[0.5, 0.75], opt_kind="adam", opt_leaves=leaves,
              bcast_version=12, fit_tokens=[3, 8], finished=True)
    writer, reader = (jckpt, tckpt) if direction == "jax_to_port" else (tckpt, jckpt)
    path = writer.fit_state_path(str(tmp_path))
    assert path == jckpt.fit_state_path(str(tmp_path)) == str(tmp_path / "fit_state.npz")
    writer.save_fit_state(path, **kw)
    # the same npz members, dtypes and bytes as the reader's own file
    own = str(tmp_path / "own.npz")
    reader.save_fit_state(own, **kw)
    with np.load(path) as a, np.load(own) as b:
        _same_state({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    got, want = (m.restore_fit_state(path, "adam", leaves) for m in (reader, writer))
    for f in ("epoch", "batch", "rng_state", "test_losses_nf", "bcast_version",
              "fit_tokens", "finished"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.weights, kw["weights"])
    for a, b in zip(got.opt_leaves, leaves):
        np.testing.assert_array_equal(a, b)
    assert tckpt.restore_fit_state(str(tmp_path / "absent.npz"), "adam", leaves) is None
    assert sorted(os.listdir(tmp_path)) == ["fit_state.npz", "own.npz"]


# -- SyncTrainer --------------------------------------------------------------

@pytest.mark.parametrize("opt,sampling", [
    ("sgd", "fresh"), ("sgd", "epoch"), ("adam", "fresh"), ("adam", "epoch"),
    ("momentum", "fresh")])
def test_a_resumed_fit_equals_the_uninterrupted_one(opt, sampling, data, tmp_path):
    train, test, ds = data
    tr, te = _torch(train), _torch(test)
    full = _port_trainer(ds, opt, sampling=sampling).fit(tr, te, 3)
    _port_trainer(ds, opt, sampling=sampling,
                  checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(tr, te, 1)
    resumed = _port_trainer(ds, opt, sampling=sampling,
                            checkpointer=tckpt.Checkpointer(str(tmp_path)))
    res = resumed.fit(tr, te, 3)
    assert res.epochs_run == 3 and len(res.losses) == 2
    assert res.test_losses == full.test_losses[1:] and res.losses == full.losses[1:]
    assert torch.equal(res.weights, full.weights)
    _, state = tckpt.Checkpointer(str(tmp_path)).restore_latest()
    assert state["test_losses_nf"].tolist() == pytest.approx(full.test_losses[::-1])
    if opt == "adam":
        assert int(state["opt_0"]) == 3 * res.steps_per_epoch


def test_a_lost_optimizer_state_shows(data, tmp_path, monkeypatch):
    # the counter-case of the resume: with the restored state dropped, the
    # resumed adam fit no longer equals the uninterrupted one
    train, test, ds = data
    tr, te = _torch(train), _torch(test)
    full = _port_trainer(ds, "adam").fit(tr, te, 3)
    _port_trainer(ds, "adam", checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(tr, te, 1)
    monkeypatch.setattr(tsync.BoundSync, "load_opt_state_leaves", lambda self, leaves: None)
    res = _port_trainer(ds, "adam", checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(
        tr, te, 3)
    assert float((res.weights - full.weights).abs().max()) > 1e-3


def test_an_optimizer_mismatch_is_refused(data, tmp_path):
    train, test, ds = data
    tr, te = _torch(train), _torch(test)
    _port_trainer(ds, "momentum", checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(tr, te, 1)
    for trainer in (_port_trainer(ds, "sgd", checkpointer=tckpt.Checkpointer(str(tmp_path))),
                    _jax_trainer(ds, "sgd", checkpointer=tckpt.Checkpointer(str(tmp_path)))):
        with pytest.raises(ValueError, match="optimizer"):
            trainer.fit(tr if isinstance(trainer, SyncTrainer) else train,
                        te if isinstance(trainer, SyncTrainer) else test, 2)
    # the JAX mxu engine holds momentum blocked: the port's flat trace is refused there
    with pytest.raises(ValueError, match="kernel"):
        _jax_trainer(ds, "momentum", checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(
            train, test, 2)


def test_the_final_state_is_saved_off_cadence(data, tmp_path):
    train, test, ds = data
    res = _port_trainer(ds, checkpointer=tckpt.Checkpointer(str(tmp_path / "port")),
                        checkpoint_every=5).fit(_torch(train), _torch(test), 3)
    jres = _jax_trainer(ds, checkpointer=tckpt.Checkpointer(str(tmp_path / "jax")),
                        checkpoint_every=5).fit(train, test, 3)
    assert res.epochs_run == jres.epochs_run == 3
    assert _steps(tmp_path / "port") == _steps(tmp_path / "jax") == [3]
    step, state = tckpt.Checkpointer(str(tmp_path / "port")).restore_latest()
    np.testing.assert_array_equal(state["weights"], res.weights.numpy())


def test_nothing_to_run_evaluates_the_restored_weights(data, tmp_path, monkeypatch):
    train, test, ds = data
    tr, te = _torch(train), _torch(test)
    first = _port_trainer(ds, checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(tr, te, 2)
    runs = []
    real = tsync.BoundSync._run
    monkeypatch.setattr(tsync.BoundSync, "_run",
                        lambda self, w, ids: runs.append(1) or real(self, w, ids))
    res = _port_trainer(ds, checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(tr, te, 2)
    jres = _jax_trainer(ds, checkpointer=tckpt.Checkpointer(str(tmp_path))).fit(train, test, 2)
    assert runs == [] and res.epochs_run == jres.epochs_run == 2
    assert res.losses == [] and torch.equal(res.weights, first.weights)
    assert res.state.loss == pytest.approx(first.losses[-1], rel=1e-6)
    assert res.state.loss == pytest.approx(jres.state.loss, rel=1e-5)


def test_the_stopping_window_continues_after_a_resume(data, tmp_path):
    train, test, ds = data

    def needs_four(newest_first):
        return len(newest_first) >= 4

    got = []
    for sub, make, tr, te in (("port", _port_trainer, _torch(train), _torch(test)),
                              ("jax", _jax_trainer, train, test)):
        d = str(tmp_path / sub)
        make(ds, checkpointer=tckpt.Checkpointer(d)).fit(tr, te, 3)
        got.append(make(ds, checkpointer=tckpt.Checkpointer(d)).fit(
            tr, te, 10, criterion=needs_four).epochs_run)
    assert got == [4, 4]


def test_the_trainer_records_the_jax_instruments(data):
    train, test, ds = data
    pm, jm = Metrics(), JaxMetrics()
    res = _port_trainer(ds, metrics=pm).fit(_torch(train), _torch(test), 2)
    _jax_trainer(ds, metrics=jm).fit(train, test, 2)
    for name in ("master.sync.loss", "master.sync.acc", "master.sync.epoch.seconds",
                 "master.sync.batch.duration", "span.trainer.epoch"):
        assert pm.histogram(name).count == jm.histogram(name).count == 2, name
    assert pm.histogram("master.sync.acc").sum == pytest.approx(100 * sum(res.accuracies))
    assert pm.histogram("master.sync.epoch.seconds").sum == pytest.approx(sum(res.epoch_seconds))


@pytest.mark.parametrize("max_epochs,traced", [(1, 0), (3, 1)])
def test_a_cpu_profile_writes_a_trace_that_parses(max_epochs, traced, data, tmp_path):
    train, test, ds = data
    prof = str(tmp_path / "prof")
    _port_trainer(ds, profile_dir=prof).fit(_torch(train), _torch(test), max_epochs)
    assert os.listdir(prof) == [os.path.basename(profile_trace_path(prof, traced))]
    with open(profile_trace_path(prof, traced)) as f:
        events = json.load(f)["traceEvents"]
    # the epoch's id draw and steps ran inside the capture, and no
    # evaluation did (the hinge evaluation's sign and clamp)
    names = {e.get("name", "") for e in events}
    assert {"aten::randint", "aten::index_add_"} <= names
    assert not names & {"aten::sign", "aten::clamp"}


def test_a_fit_that_stops_first_warns_of_no_profile(data, tmp_path, caplog):
    train, test, ds = data
    prof = str(tmp_path / "prof")
    with caplog.at_level(logging.WARNING, logger="dsgd.trainer"):
        res = _port_trainer(ds, profile_dir=prof).fit(
            _torch(train), _torch(test), 5, criterion=lambda nf: True)
    assert res.epochs_run == 1 and not os.path.exists(prof)
    assert "no profiler trace captured: the fit stopped before epoch 1" in caplog.text


# -- interchange: one directory, written by one package, resumed by the other --

def _draw(rng, cache):
    def draw(bound):  # the same ids every epoch, in both packages
        if bound.shard_n not in cache:
            sub, starts, sizes = bound._subshards()
            sel = rng.integers(0, sub, (bound.steps_per_epoch, K, B))
            cache[bound.shard_n] = sel % np.minimum(sub, sizes)[:, None] + starts[:, None]
        return cache[bound.shard_n]
    return draw


def _inject(trainer, draw, jax_side):
    bind = trainer.engine.bind

    def bind_injected(d, *args, **kw):
        bound = bind(d, *args, **kw)
        a = draw(bound)
        if jax_side:
            bound._sample_ids = lambda key, step, a=jnp.asarray(a, jnp.int32): a[step]
        else:
            bound._sample_ids = lambda key, a=torch.from_numpy(a): a
        return bound

    trainer.engine.bind = bind_injected
    return trainer


def _series_close(got, want):
    for name in ("losses", "accuracies", "test_losses", "test_accuracies"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_the_port_resumes_what_the_jax_trainer_wrote(opt, data, tmp_path):
    train, test, ds = data
    draw = _draw(np.random.default_rng(0), {})
    first = str(tmp_path / "first")
    _inject(_jax_trainer(ds, opt, checkpointer=tckpt.Checkpointer(first)), draw, True).fit(
        train, test, 1)
    shutil.copytree(first, str(tmp_path / "again"))
    jres = _inject(_jax_trainer(ds, opt, checkpointer=tckpt.Checkpointer(first)), draw,
                   True).fit(train, test, 3)
    tres = _inject(_port_trainer(ds, opt, checkpointer=tckpt.Checkpointer(
        str(tmp_path / "again"))), draw, False).fit(_torch(train), _torch(test), 3)
    assert tres.epochs_run == jres.epochs_run == 3 and len(tres.losses) == 2
    _series_close(tres, jres)
    (js, jstate), (ts, tstate) = (tckpt.Checkpointer(str(tmp_path / d)).restore_latest()
                                  for d in ("first", "again"))
    assert js == ts == 3 and sorted(jstate) == sorted(tstate)
    if opt == "adam":  # the JAX mxu engine wrote blocked leaves, the port flat ones
        assert jstate["opt_1"].shape == (convert.n_blocks(D), convert.LANES)
        assert tstate["opt_1"].shape == (D,) and int(jstate["opt_0"]) == int(tstate["opt_0"])


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_the_jax_trainer_resumes_what_the_port_wrote(opt, data, tmp_path):
    # the JAX 'scalar' kernel holds its state flat, as the port writes it
    train, test, ds = data
    draw = _draw(np.random.default_rng(1), {})
    first = str(tmp_path / "first")
    _inject(_port_trainer(ds, opt, checkpointer=tckpt.Checkpointer(first)), draw, False).fit(
        _torch(train), _torch(test), 1)
    shutil.copytree(first, str(tmp_path / "again"))
    tres = _inject(_port_trainer(ds, opt, checkpointer=tckpt.Checkpointer(first)), draw,
                   False).fit(_torch(train), _torch(test), 3)
    jres = _inject(_jax_trainer(ds, opt, kernel="scalar", checkpointer=tckpt.Checkpointer(
        str(tmp_path / "again"))), draw, True).fit(train, test, 3)
    assert tres.epochs_run == jres.epochs_run == 3 and len(jres.losses) == 2
    _series_close(tres, jres)


def test_an_orbax_adam_snapshot_resaved_resumes_in_the_port(data, tmp_path):
    train, test, ds = data
    draw = _draw(np.random.default_rng(2), {})
    jc = jckpt.Checkpointer(str(tmp_path / "orbax"))
    _inject(_jax_trainer(ds, "adam", checkpointer=jc), draw, True).fit(train, test, 1)
    # the re-save the port's refusal names, in a process that has orbax
    step, state = jc.restore_latest()
    assert step == 1 and np.shape(state["opt_1"]) == (convert.n_blocks(D), convert.LANES)
    tckpt.Checkpointer(str(tmp_path / "port")).save(step, state.pop("weights"), extra=state)
    jres = _inject(_jax_trainer(ds, "adam", checkpointer=jc), draw, True).fit(train, test, 3)
    jc.close()
    tres = _inject(_port_trainer(ds, "adam", checkpointer=tckpt.Checkpointer(
        str(tmp_path / "port"))), draw, False).fit(_torch(train), _torch(test), 3)
    assert tres.epochs_run == jres.epochs_run == 3 and len(tres.losses) == 2
    _series_close(tres, jres)


# -- LossChecker against the JAX checker on orbax ----------------------------

SEQUENCES = {  # (raw losses, leaky coefficient)
    "falling": ([1.0, 0.8, 0.7, 0.65, 0.6, 0.58, 0.57], 0.5),
    "plateau": ([0.9, 0.6, 0.61, 0.62, 0.6, 0.63, 0.64, 0.6, 0.65, 0.59], 0.5),
    # leaky 1.0: a nan does not carry into the next smoothed value
    "nan_first": ([float("nan"), float("nan"), 0.7, 0.75, 0.69, 0.8], 1.0),
}


@pytest.mark.parametrize("kind", sorted(SEQUENCES))
def test_the_checker_saves_and_restores_as_the_jax_checker(kind, tmp_path):
    losses, leaky = SEQUENCES[kind]
    rng = np.random.default_rng(len(kind))
    weights = [rng.normal(size=8).astype(np.float32) for _ in losses]
    accs = list(rng.random(len(losses)))
    half = len(losses) // 2
    jdir, tdir = str(tmp_path / "orbax"), str(tmp_path / "port")

    def run(part, checkers):
        for i in part:
            jc, tc = checkers
            jc.check(losses[i], accs[i], weights[i], step=100 * (i + 1))
            tc.check(losses[i], accs[i], torch.from_numpy(weights[i]), step=100 * (i + 1))
            assert _steps(jdir) == _steps(tdir), i
            assert tc.best_loss == jc.best_loss or (np.isnan(tc.best_loss) and np.isnan(jc.best_loss))
            assert tc.smoothed == jc.smoothed or np.allclose(tc.smoothed, jc.smoothed,
                                                              rtol=0, atol=0, equal_nan=True)

    for part in (range(half), range(half, len(losses))):  # a restart between the halves
        jk, tk = jckpt.Checkpointer(jdir), tckpt.Checkpointer(tdir)
        jc = JaxChecker(leaky, checkpointer=jk, save_every=3)
        tc = LossChecker(leaky, checkpointer=tk, save_every=3, device="cpu")
        assert (tc.restored_updates, tc._step_base) == (jc.restored_updates, jc._step_base)
        np.testing.assert_array_equal(tc.smoothed, jc.smoothed)
        np.testing.assert_array_equal(tc.smoothed_accs, jc.smoothed_accs)
        if jc.best_weights is not None:
            np.testing.assert_array_equal(tc.best_weights.numpy(), jc.best_weights)
        run(part, (jc, tc))
        if jk.latest_step() is not None:
            (js, jstate), (ts, tstate) = jk.restore_latest(), tk.restore_latest()
            assert js == ts
            _same_state(tstate, {k: np.asarray(v) for k, v in jstate.items()})
        jk.close()
    assert jc.restored_updates == tc.restored_updates
    if kind == "nan_first":
        assert _steps(tdir)[0] >= 300  # nothing saved before a finite best


def test_refresh_matches_jax():
    jc, tc = JaxChecker(0.5), LossChecker(0.5)
    for c, w in ((jc, np.ones(4, np.float32)), (tc, torch.ones(4))):
        c.check(0.5, 0.9, w)
        c.refresh(best_loss=0.3, best_weights=w * 2)
    assert tc.best_loss == jc.best_loss == 0.3 and tc.smoothed == jc.smoothed == []
    np.testing.assert_array_equal(tc.best_weights.numpy(), jc.best_weights)
    for c in (jc, tc):
        c.refresh(best_loss=float("nan"))
    assert tc.best_loss == jc.best_loss == float("inf") and tc.best_weights is None


# -- the async engines: kill and resume --------------------------------------

@pytest.fixture(scope="module")
def async_data():
    train, test = train_test_split(rcv1_like(300, n_features=64, nnz=6, seed=50))
    model = convert.model_from_jax("hinge", 1e-4, 64, None, "l2", device="cpu")
    return _torch(train), _torch(test), model


def _hogwild(model, ckpt, **kw):
    return thog.HogwildEngine(model, 2, 8, 0.1, check_every=20, backoff_s=0.01,
                              steps_per_dispatch=4, checkpointer=ckpt, metrics=Metrics(),
                              device="cpu", **kw)


def _local(model, ckpt):
    return LocalSGDEngine(model, 8, 0.1, sync_period=4, check_every=16, checkpointer=ckpt,
                          metrics=Metrics(), device="cpu")


@pytest.mark.parametrize("engine", ["hogwild", "local_sgd"])
def test_an_async_fit_resumes_from_its_best_weights(engine, async_data, tmp_path):
    train, test, model = async_data
    make = _hogwild if engine == "hogwild" else _local
    res1 = make(model, tckpt.Checkpointer(str(tmp_path))).fit(train, test, max_epochs=1)
    step, state = tckpt.Checkpointer(str(tmp_path)).restore_latest()
    np.testing.assert_array_equal(state["weights"], res1.weights.numpy())  # the best weights
    restored = int(state["updates"])
    assert restored <= res1.state.updates
    res2 = make(model, tckpt.Checkpointer(str(tmp_path))).fit(
        train, test, max_epochs=3, initial_weights=state["weights"])
    # the restored history goes on, and the first new check is warm: not
    # the cold w = 0 loss (1.0 for the hinge)
    n_restored = len(state["smoothed_nf"])
    assert res2.test_losses[:n_restored] == pytest.approx(state["smoothed_nf"][::-1].tolist())
    assert res2.test_losses[n_restored] < 1.0
    # the lifetime budget: 3n in all, counted on from the restored updates
    assert res2.state.updates >= 3 * len(train)
    assert res2.state.updates - restored < 3 * len(train)


@pytest.mark.parametrize("engine", ["hogwild", "local_sgd"])
def test_an_async_fit_past_its_budget_runs_nothing(engine, async_data, tmp_path, monkeypatch):
    train, test, model = async_data
    n = len(train)
    w_best = np.full(64, 3.0, np.float32)
    # a snapshot as the JAX checker writes it, through the port's Checkpointer
    JaxChecker(1.0, checkpointer=tckpt.Checkpointer(str(tmp_path)), save_every=1).check(
        0.25, 0.9, w_best, step=2 * n)
    launched = []
    monkeypatch.setattr(tsync.MeanSteps, "run", lambda self, *a, **kw: launched.append(1))
    before = set(threading.enumerate())
    make = _hogwild if engine == "hogwild" else _local
    res = make(model, tckpt.Checkpointer(str(tmp_path))).fit(train, test, max_epochs=2)
    assert launched == [] and res.state.updates == 2 * n
    assert [t for t in threading.enumerate() if t not in before] == []
    np.testing.assert_array_equal(res.weights.numpy(), w_best)
    assert res.state.loss == pytest.approx(0.25)


def test_a_resumed_hogwild_fit_spends_only_what_is_left(async_data, tmp_path):
    train, test, model = async_data
    n = len(train)
    restored_at = n - 40
    JaxChecker(1.0, checkpointer=tckpt.Checkpointer(str(tmp_path)), save_every=1).check(
        0.5, 0.9, np.zeros(64, np.float32), step=restored_at)
    res = _hogwild(model, tckpt.Checkpointer(str(tmp_path))).fit(train, test, max_epochs=1)
    assert n <= res.state.updates and res.state.updates - restored_at < n


# -- utils: span, timer, atomic JSON -----------------------------------------

def test_span_records_the_histogram_the_jax_span_records():
    pm, jm = Metrics(), JaxMetrics()
    with measure.span("unit", logger=logging.getLogger("t"), metrics=pm):
        pass
    with jmeasure.span("unit", logger=logging.getLogger("t"), metrics=jm):
        pass
    assert pm.histogram("span.unit").count == jm.histogram("span.unit").count == 1
    with pytest.raises(RuntimeError):
        with measure.span("ckpt.save", metrics=pm):
            raise RuntimeError("recorded all the same")
    assert pm.histogram("span.ckpt.save").count == 1
    out, secs = measure.duration(lambda: 42)
    assert out == 42 and secs >= 0
    assert measure.duration_log("x", lambda: 7) == 7


def test_the_span_name_guard_matches_jax(monkeypatch):
    assert measure.SPAN_NAME_ALLOWLIST == jmeasure.SPAN_NAME_ALLOWLIST
    assert (measure.MAX_DISTINCT_SPAN_NAMES, measure.SPAN_OVERFLOW_NAME) == (
        jmeasure.MAX_DISTINCT_SPAN_NAMES, jmeasure.SPAN_OVERFLOW_NAME)
    for m in (measure, jmeasure):
        monkeypatch.setattr(m, "_seen_names", set())
        monkeypatch.setattr(m, "_warned_names", set())
    names = ["trainer.epoch"] + [f"id.{i}" for i in range(70)] + ["ckpt.save", "id.3"]
    assert [measure._bounded_name(n) for n in names] == [jmeasure._bounded_name(n) for n in names]
    assert measure._bounded_name("id.69") == "other" and measure._bounded_name("ckpt.restore") == "ckpt.restore"


def test_the_timer_and_atomic_json_match_jax(tmp_path):
    pm, jm = Metrics(), JaxMetrics()
    for m in (pm, jm):
        with m.timer("master.sync.batch.duration"):
            pass
    assert pm.histogram("master.sync.batch.duration").count == 1
    assert jm.histogram("master.sync.batch.duration").count == 1
    obj = {"b": [1, 2.5], "a": {"z": None, "y": "s"}}
    fsio.atomic_write_json(str(tmp_path / "port.json"), obj)
    jfsio.atomic_write_json(str(tmp_path / "jax.json"), obj)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["jax.json", "port.json"]
