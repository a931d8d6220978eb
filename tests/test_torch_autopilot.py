"""The port's continual-learning autopilot (distributed_sgd_tpu_torch/
autopilot/, DSGD_AUTOPILOT) against the JAX package's autopilot/, on the CPU.

JAX's tests/test_autopilot.py cases, each held to the JAX function on the
same inputs: the drifting stream's rows, schedules, eval sets,
``window_split`` and ``continual_criterion``; the oracle labeler; the
probe reservoir's admissions and sidecar state; the drift detector's trip
sequences; the controller's transition lists over a fake router
(promotion, rollback, canary timeout, a retrain that raises,
``max_retrains``, residual settling, band 0, the thread); and the config
knobs' validation and env parsing against JAX's Config.  Each test runs
under a time limit of its own (`LIMIT_S`)."""

import signal
import threading
import time

import numpy as np
import pytest

from distributed_sgd_tpu.autopilot import controller as jctl
from distributed_sgd_tpu.autopilot import probe_source as jps
from distributed_sgd_tpu.autopilot import stream as jst
from distributed_sgd_tpu.config import Config as JaxConfig
from distributed_sgd_tpu.utils import metrics as jmm
from distributed_sgd_tpu_torch.autopilot import STATES, controller as tctl
from distributed_sgd_tpu_torch.autopilot import probe_source as tps
from distributed_sgd_tpu_torch.autopilot import stream as tst
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.utils import metrics as mm

LIMIT_S = 60  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _streams(**kw):
    kw.setdefault("n_features", 512)
    kw.setdefault("nnz", 8)
    kw.setdefault("seed", 3)
    kw.setdefault("shift_at", 2 * tst.BLOCK)
    return tst.DriftingStream(**kw), jst.DriftingStream(**kw)


def _same(ours, theirs):
    assert isinstance(ours, TDataset)
    for name in ("indices", "values", "labels"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert ours.n_features == theirs.n_features


# -- the drifting stream ------------------------------------------------------

@pytest.mark.parametrize("schedule", tst.SCHEDULES)
@pytest.mark.parametrize("lo,n", [(0, 3 * 256), (100, 150), (700, 333)])
def test_stream_rows_are_jax_s_byte_for_byte(schedule, lo, n):
    ours, theirs = _streams(schedule=schedule, ramp_rows=300, period_rows=200,
                            shift_magnitude=0.7)
    _same(ours.rows(lo, n), theirs.rows(lo, n))
    for r in (0, lo, lo + n, 5000):
        assert ours.phase(r) == theirs.phase(r)
        assert ours.separator(r).tobytes() == theirs.separator(r).tobytes()
    _same(ours.take(100), theirs.take(100))
    assert ours.cursor == theirs.cursor == 100
    with pytest.raises(ValueError, match="positive"):
        ours.rows(0, 0)


def test_stream_defaults_and_schedules_are_jax_s():
    assert tst.SCHEDULES == jst.SCHEDULES and tst.BLOCK == jst.BLOCK
    ours, theirs = tst.DriftingStream(seed=0), jst.DriftingStream(seed=0)
    assert (ours.n_features, ours.nnz, ours.shift_at, ours.schedule) == (
        theirs.n_features, theirs.nnz, theirs.shift_at, theirs.schedule) == (
        16384, 8, 4096, "step")
    _same(ours.rows(4000, 200), theirs.rows(4000, 200))
    for bad in (dict(schedule="sudden"), dict(shift_magnitude=1.5), dict(ramp_rows=0)):
        with pytest.raises(ValueError) as jerr:
            _streams(**bad)[1]
        with pytest.raises(ValueError) as terr:
            tst.DriftingStream(**{"n_features": 64, **bad})
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n,at", [(64, 0), (300, None), (64, 2 * 256 + 256)])
def test_eval_sets_are_jax_s(n, at):
    ours, theirs = _streams()
    ours.take(128)
    theirs.take(128)
    _same(ours.eval_set(n, at=at), theirs.eval_set(n, at=at))
    assert ours.cursor == 128


def test_window_split_and_continual_criterion_are_jax_s():
    for lo, hi, n, k in ((20, 60, 100, 4), (20, 200, 100, 2), (0, 4096, 4096, 2),
                         (1000, 5096, 12288, 3)):
        ours, theirs = tst.window_split(lo, hi)(n, k), jst.window_split(lo, hi)(n, k)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    for args, words in (((30, 30), "bad stream window"), ((-1, 5), "bad stream window")):
        with pytest.raises(ValueError, match=words):
            tst.window_split(*args)
    with pytest.raises(ValueError, match="past the resident corpus"):
        tst.window_split(80, 120)(70, 2)
    seen = {"t": [], "j": []}
    for key, mod in (("t", tst), ("j", jst)):
        crit = mod.continual_criterion(lambda losses, k=key: seen[k].append(list(losses)),
                                       horizon=3)
        crit([5.0, 4.0, 3.0, 2.0, 1.0])
    assert seen["t"] == seen["j"] == [[5.0, 4.0, 3.0]]
    with pytest.raises(ValueError, match="horizon"):
        tst.continual_criterion(lambda losses: False, horizon=0)


def test_the_oracle_labeler_is_jax_s():
    ours, theirs = _streams(shift_at=2 * 256)
    start = ours.shift_at - 40
    rows = ours.rows(start, 80)
    lt, lj = ours.oracle_labeler(start=start), theirs.oracle_labeler(start=start)
    got = [lt(rows.indices[i], rows.values[i]) for i in range(80)]
    assert got == [lj(rows.indices[i], rows.values[i]) for i in range(80)]
    assert set(got) == {1.0, -1.0}


# -- the probe reservoir ---------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(capacity=16), dict(capacity=16, recency=32, min_fill=8),
                                dict(capacity=8, label_delay=5, recency=16)])
def test_the_reservoir_admits_what_jax_s_admits(kw):
    ours_s, theirs_s = _streams()
    traffic = ours_s.rows(0, 400)
    rt = tps.ProbeReservoir(ours_s.oracle_labeler(), seed=5, **kw)
    rj = jps.ProbeReservoir(theirs_s.oracle_labeler(), seed=5, **kw)
    for i in range(len(traffic)):
        rt.observe(traffic.indices[i], traffic.values[i])
        rj.observe(traffic.indices[i], traffic.values[i])
        if i % 50 == 0:
            assert rt.ready() == rj.ready() and rt.fill == rj.fill
    assert (rt.seen, rt.fill) == (rj.seen, rj.fill)
    for (ai, av, ay), (bi, bv, by) in zip(rt.rows(), rj.rows()):
        assert ai.tobytes() == bi.tobytes() and av.tobytes() == bv.tobytes() and ay == by
    assert rt.state_dict() == rj.state_dict()
    # a sidecar written by either package restores in the other
    other = jps.ProbeReservoir(theirs_s.oracle_labeler(start=400), seed=5, **kw)
    other.load_state(rt.state_dict())
    back = tps.ProbeReservoir(ours_s.oracle_labeler(start=400), seed=5, **kw)
    back.load_state(rj.state_dict())
    more = ours_s.rows(400, 50)
    for i in range(50):
        other.observe(more.indices[i], more.values[i])
        back.observe(more.indices[i], more.values[i])
    assert back.state_dict() == other.state_dict()


def test_the_reservoir_refuses_what_jax_s_refuses():
    for bad in (dict(capacity=0), dict(label_delay=-1), dict(capacity=8, recency=4),
                dict(capacity=8, min_fill=9)):
        with pytest.raises(ValueError) as jerr:
            jps.ProbeReservoir(lambda i, v: 1.0, **bad)
        with pytest.raises(ValueError) as terr:
            tps.ProbeReservoir(lambda i, v: 1.0, **bad)
        assert str(terr.value) == str(jerr.value)


def test_a_label_that_never_arrives_is_dropped():
    r = tps.ProbeReservoir(lambda i, v: None, capacity=4)
    r.observe(np.array([1], np.int32), np.array([1.0], np.float32))
    assert r.fill == 0 and r.seen == 1


# -- the drift detector ----------------------------------------------------------

def _series():
    rng = np.random.default_rng(11)
    return {
        "step": [0.5] * 8 + [1.4] * 6,
        "noise": list(0.5 + 0.05 * rng.standard_normal(300)),
        "tiny": [0.01] * 3 + [0.05] * 10 + [0.2, 0.2],
        "nonfinite": [0.3, float("nan"), 0.3, float("inf")],
        "ramp": list(np.linspace(0.2, 1.5, 60)),
    }


@pytest.mark.parametrize("name", sorted(_series()))
@pytest.mark.parametrize("kw", [dict(), dict(ratio=1.5, patience=2, warmup=3, abs_floor=0.1,
                                             alpha=1.0),
                                dict(ratio=2.0, patience=1, warmup=0, abs_floor=0.0)])
def test_the_detector_trips_where_jax_s_trips(name, kw):
    series = _series()[name]
    dt, dj = tctl.DriftDetector(metrics=mm.Metrics(), **kw), jctl.DriftDetector(
        metrics=jmm.Metrics(), **kw)
    got, want = [], []
    for i, x in enumerate(series):
        got.append(dt.observe(float(x)))
        want.append(dj.observe(float(x)))
        if i == len(series) - 2:
            dt.rebase()
            dj.rebase()
        assert (dt._ewma, dt._baseline, dt._checks, dt._over) == (
            dj._ewma, dj._baseline, dj._checks, dj._over)
    assert got == want
    if name == "step" and not kw:
        assert any(got)
    if name == "noise" and not kw:  # JAX's false-positive gate
        assert not any(got)
    assert dt.metrics.gauge(mm.AUTOPILOT_DRIFT_EWMA).value == dj.metrics.gauge(
        jmm.AUTOPILOT_DRIFT_EWMA).value or name == "nonfinite"


def test_the_detector_refuses_what_jax_s_refuses():
    for bad in (dict(alpha=0.0), dict(ratio=1.0), dict(abs_floor=-0.1)):
        with pytest.raises(ValueError) as jerr:
            jctl.DriftDetector(**bad)
        with pytest.raises(ValueError) as terr:
            tctl.DriftDetector(**bad)
        assert str(terr.value) == str(jerr.value)


# -- the controller over a fake router ----------------------------------------------


class _FakeRouter:
    """probe_losses + the two canary counters: all the controller reads."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.promoted_version = 7
        self._losses = []

    def feed(self, *losses):
        self._losses.extend(losses)

    def probe_losses(self):
        return list(self._losses)


def _pair(verdict, **kw):
    """A port and a JAX controller, each over its fake router, whose retrain
    gives `verdict` ('promote' | 'rollback' | 'none' | 'raise'); each
    records its transitions."""
    out = []
    for ctl, metrics in ((tctl, mm), (jctl, jmm)):
        router = _FakeRouter(metrics.Metrics())

        def retrain(router=router, metrics=metrics):
            if verdict == "raise":
                raise RuntimeError("fit fell over")
            if verdict == "promote":
                router.metrics.counter(metrics.ROUTER_CANARY_PROMOTED).increment()
            elif verdict == "rollback":
                router.metrics.counter(metrics.ROUTER_CANARY_ROLLBACK).increment()

        args = {"poll_s": 0.01, "cooldown_s": 0.0, "canary_timeout_s": 0.2, **kw}
        args.setdefault("detector", ctl.DriftDetector(alpha=1.0, ratio=1.5, patience=2,
                                                      warmup=2, abs_floor=0.05))
        c = ctl.AutopilotController(router, retrain, metrics=metrics.Metrics(), **args)
        c.transitions = []
        to = c._to
        c._to = lambda state, _to=to, c=c, **info: (c.transitions.append(
            (c.state, state, info)), _to(state, **info))
        out.append((c, router))
    return out


def _drive(pairs, *feeds):
    for losses in feeds:
        for c, router in pairs:
            router.feed(*losses)
            c._step()
    (ct, _), (cj, _) = pairs
    assert ct.transitions == cj.transitions
    assert (ct.state, ct.retrains, ct._settle_baseline, ct._consumed) == (
        cj.state, cj.retrains, cj._settle_baseline, cj._consumed)
    for name in ("AUTOPILOT_TRANSITIONS", "AUTOPILOT_DRIFT_TRIPPED", "AUTOPILOT_RETRAINS",
                 "AUTOPILOT_RETRAIN_ERRORS", "AUTOPILOT_PROMOTED", "AUTOPILOT_ROLLED_BACK"):
        assert ct.metrics.counter(getattr(mm, name)).value == cj.metrics.counter(
            getattr(jmm, name)).value, name
    return ct


def test_the_controller_states_are_jax_s():
    assert STATES == jctl.STATES


@pytest.mark.parametrize("verdict,want", [("promote", "PROMOTED"), ("rollback", "ROLLED_BACK"),
                                          ("none", "ROLLED_BACK")])
def test_a_cycle_makes_jax_s_transitions(verdict, want):
    c = _drive(_pair(verdict), (0.2, 0.2, 0.2), (1.0, 1.0))
    assert [t[1] for t in c.transitions] == [
        "DRIFT_DETECTED", "RETRAINING", "CANARY", want, "SERVING"]
    if verdict == "none":
        assert c.transitions[3][2] == {"reason": "canary_timeout"}
    assert c.retrains == 1 and c.state == "SERVING" and c.detector._checks == 0


def test_a_retrain_that_raises_makes_jax_s_transitions(tmp_path, monkeypatch):
    from distributed_sgd_tpu.trace import flight as jflight
    from distributed_sgd_tpu_torch.trace import flight as tflight

    monkeypatch.setattr(tflight, "_RECORDER", tflight.FlightRecorder(dir=str(tmp_path)))
    monkeypatch.setattr(jflight, "_RECORDER", jflight.FlightRecorder(dir=str(tmp_path)))
    c = _drive(_pair("raise"), (0.2, 0.2, 1.0, 1.0))
    assert [t[1] for t in c.transitions] == ["DRIFT_DETECTED", "RETRAINING", "SERVING"]
    assert c.retrains == 0 and c.metrics.counter(mm.AUTOPILOT_RETRAIN_ERRORS).value == 1
    assert any("autopilot" in p.name for p in tmp_path.iterdir())  # the ring was dumped


def test_max_retrains_caps_the_flywheel_as_jax_s():
    c = _drive(_pair("promote", max_retrains=1), (0.2, 0.2, 1.0, 1.0), (0.2, 0.2, 1.0, 1.0))
    assert c.retrains == 1 and c.metrics.counter(mm.AUTOPILOT_DRIFT_TRIPPED).value == 1


def test_residual_settling_earns_jax_s_second_retrain():
    c = _drive(_pair("promote", recovery_band=1.3), (0.2, 0.2, 0.2), (1.0, 1.0),
               (0.5, 0.5, 0.5), (0.21, 0.21, 0.21))
    assert c.retrains == 2 and c._settle_baseline is None
    assert c.transitions[5] == ("SERVING", "DRIFT_DETECTED", {
        "ewma": 0.5, "baseline": 0.5, "reason": "residual"})


def test_band_zero_tolerates_the_plateau_as_jax_s():
    c = _drive(_pair("promote", recovery_band=0.0), (0.2, 0.2, 0.2, 1.0, 1.0),
               (0.5, 0.5, 0.5))
    assert c.retrains == 1


def test_the_controller_refuses_what_jax_s_refuses():
    for bad in (dict(poll_s=0.0), dict(recovery_band=1.0)):
        with pytest.raises(ValueError) as jerr:
            jctl.AutopilotController(_FakeRouter(jmm.Metrics()), lambda: None, **bad)
        with pytest.raises(ValueError) as terr:
            tctl.AutopilotController(_FakeRouter(mm.Metrics()), lambda: None, **bad)
        assert str(terr.value) == str(jerr.value)


def test_the_controller_thread_lives_between_start_and_stop():
    (c, router), _ = _pair("promote", poll_s=0.02)
    c.start()
    try:
        assert any(t.name == "autopilot-controller" for t in threading.enumerate())
        router.feed(0.2, 0.2, 1.0, 1.0)
        deadline = time.monotonic() + 30.0
        while c.retrains < 1:
            assert time.monotonic() < deadline, "the thread never ran the flywheel"
            time.sleep(0.02)
    finally:
        c.stop()
    assert not any("autopilot" in t.name for t in threading.enumerate())
    assert c.metrics.gauge(mm.AUTOPILOT_STATE).value == STATES.index("SERVING")


# -- the config knobs ----------------------------------------------------------------

KNOBS = ("autopilot_poll_s", "autopilot_cooldown_s", "autopilot_drift_ratio",
         "autopilot_drift_patience", "autopilot_drift_warmup", "autopilot_drift_floor",
         "autopilot_window", "autopilot_max_retrains", "autopilot_canary_timeout_s",
         "autopilot_recovery_band", "autopilot_probe_capacity", "autopilot_label_delay",
         "autopilot_source_refresh_s")


def test_the_knobs_and_defaults_are_jax_s():
    assert len(KNOBS) == 13
    for name in KNOBS + ("autopilot", "chaos", "compile_cache"):
        assert getattr(Config(), name) == getattr(JaxConfig(), name), name


@pytest.mark.parametrize("bad", [
    dict(autopilot_poll_s=0.0), dict(autopilot_cooldown_s=-1.0),
    dict(autopilot_drift_ratio=1.0), dict(autopilot_drift_patience=0),
    dict(autopilot_drift_warmup=-1), dict(autopilot_drift_floor=-0.1),
    dict(autopilot_window=0), dict(autopilot_max_retrains=-1),
    dict(autopilot_canary_timeout_s=0.0), dict(autopilot_recovery_band=1.0),
    dict(autopilot_probe_capacity=0), dict(autopilot_label_delay=-1),
    dict(autopilot_source_refresh_s=0.0),
    dict(autopilot=True, role_override="worker"),
    dict(autopilot=True, role_override="serve", checkpoint_dir="c"),
    dict(autopilot=True, serve_probe_refresh_s=1.0),
    dict(chaos="drop=2.0"), dict(chaos="scenario:meteor-strike"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_a_bad_knob_is_refused_as_jax_refuses_it(bad):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as terr:
        Config(**bad)
    assert str(terr.value) == str(jerr.value)


def test_the_knobs_parse_from_the_env_as_jax_s(monkeypatch):
    env = {"DSGD_AUTOPILOT": "1", "DSGD_AUTOPILOT_POLL_S": "0.5",
           "DSGD_AUTOPILOT_COOLDOWN_S": "2", "DSGD_AUTOPILOT_DRIFT_RATIO": "2.5",
           "DSGD_AUTOPILOT_DRIFT_PATIENCE": "3", "DSGD_AUTOPILOT_DRIFT_WARMUP": "6",
           "DSGD_AUTOPILOT_DRIFT_FLOOR": "0.2", "DSGD_AUTOPILOT_WINDOW": "2048",
           "DSGD_AUTOPILOT_MAX_RETRAINS": "4", "DSGD_AUTOPILOT_CANARY_TIMEOUT_S": "30",
           "DSGD_AUTOPILOT_RECOVERY_BAND": "1.5", "DSGD_AUTOPILOT_PROBE_CAPACITY": "48",
           "DSGD_AUTOPILOT_LABEL_DELAY": "4", "DSGD_AUTOPILOT_SOURCE_REFRESH_S": "0.25",
           "DSGD_CHAOS": "scenario:flaky-rack;scope=named", "DSGD_COMPILE_CACHE": "/cc"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = Config.from_env(), JaxConfig.from_env()
    for name in KNOBS + ("autopilot", "chaos", "compile_cache"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.autopilot_window, ours.autopilot_label_delay) == (2048, 4)
    # validated whether or not the switch is on: a zero window stops the CLI
    monkeypatch.setenv("DSGD_AUTOPILOT", "0")
    monkeypatch.setenv("DSGD_AUTOPILOT_WINDOW", "0")
    with pytest.raises(ValueError, match="DSGD_AUTOPILOT_WINDOW"):
        JaxConfig.from_env()
    with pytest.raises(ValueError, match="DSGD_AUTOPILOT_WINDOW"):
        Config.from_env()


def test_the_master_role_trains_on_jax_s_stream_window():
    """DSGD_AUTOPILOT on the master role: the corpus is the stream's first
    window and the eval set sits at its trailing edge, as the JAX CLI's."""
    from distributed_sgd_tpu import main as jmain
    from distributed_sgd_tpu_torch import main as tmain

    kw = dict(autopilot=True, autopilot_window=512, seed=4)
    train, test, model = tmain._autopilot_stream_build(Config(**kw), device="cpu")
    jtrain, jtest, jmodel = jmain._autopilot_stream_build(JaxConfig(**kw))
    _same(train, jtrain)
    _same(test, jtest)
    assert len(test) == 256 and model.n_features == jmodel.n_features == 16384
    np.testing.assert_array_equal(model.dim_sparsity.numpy(), np.asarray(jmodel.dim_sparsity))
