"""The port's resource plane (distributed_sgd_tpu_torch/telemetry/:
resources, slope, blackbox) against the JAX package's, on the CPU.

Theil–Sen and the leak sentinel give the JAX slopes and trips on the same
series; a blackbox ring written by either package reads the same through
the other's readers and CLI; the probe ticks through gauges, sentinel and
blackbox; pressure sources (the master's drain inbox, the serving
batcher's admission queue) reach the probe; every flight dump carries the
resource sample; and DSGD_RESOURCE_PROBE_S acts through main() in a
role, while unset it starts no thread and writes no file."""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sgd_tpu.telemetry import blackbox as jblackbox
from distributed_sgd_tpu.telemetry import slope as jslope
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.telemetry import blackbox, resources, slope
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as mm
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
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


def _probe_threads():
    return [t for t in threading.enumerate() if t.name == "resource-probe"]


# -- the slope and the sentinel --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_theil_sen_equals_jax_on_the_same_series(seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 100, 40)).tolist()
    vs = (3.0 * np.asarray(ts) + rng.normal(0, 20, 40)).tolist()
    vs[5] += 1e4  # a spike the median ignores
    assert slope.theil_sen(ts, vs) == jslope.theil_sen(ts, vs)
    assert np.isnan(slope.theil_sen([1.0, 1.0], [2.0, 3.0]))


_SERIES = {
    "flat": [100.0] * 40,
    "noisy": [1000.0 + (50.0 if i % 2 else -50.0) for i in range(40)],
    "rel_leak": [1000.0 + 5.0 * i for i in range(40)],
    "abs_leak": [10.0 + 0.5 * i for i in range(40)],
    "slow": [1e6 + 0.01 * i for i in range(40)],
}


@pytest.mark.parametrize("name", sorted(_SERIES))
@pytest.mark.parametrize("thresholds", [None, {"abs_leak": 0.1, "slow": 1e-3}])
def test_the_sentinel_trips_as_jax_trips(name, thresholds, tmp_path):
    """Both sentinels fed the same series at the same times trip at the
    same observation (or not at all), latch, and report the same slope."""
    flight.configure(capacity=8, service="sentinel-test", dir=str(tmp_path))
    trips = {}
    for pkg, mod, metrics in (("port", slope, Metrics), ("jax", jslope, JaxMetrics)):
        s = mod.LeakSentinel(metrics=metrics(), min_samples=6, min_horizon_s=5.0,
                             thresholds=thresholds)
        seq = [s.observe(name, float(i), v) for i, v in enumerate(_SERIES[name])]
        trips[pkg] = (seq, s.tripped(name), s.slope(name),
                      s.metrics.counter(mm.HEALTH_LEAK_SUSPECT).value)
    flight.configure()
    assert trips["port"] == trips["jax"]
    assert trips["port"][1] == (name in ("rel_leak", "abs_leak")
                                or (thresholds is not None and name == "slow"))


def test_a_trip_logs_counts_and_dumps_as_the_warn_action_does(tmp_path):
    flight.configure(capacity=8, service="leak-test", dir=str(tmp_path))
    m = Metrics()
    s = slope.LeakSentinel(metrics=m, min_samples=4, min_horizon_s=0.0,
                           thresholds={"fds": 0.5})
    for i in range(8):
        s.observe("fds", float(i), 10.0 + i)
    s.observe("rss", 0.0, 1.0)
    flight.configure()
    assert s.tripped("fds") and not s.tripped("rss")
    assert m.counter(mm.HEALTH_LEAK_SUSPECT).value == 1  # latched: one trip
    assert m.gauge(f"{mm.HEALTH_LEAK_SLOPE}.fds").value == pytest.approx(1.0)
    dumps = [p for p in os.listdir(tmp_path) if p.endswith("-leak.json")]
    payload = json.load(open(tmp_path / dumps[0]))
    assert payload["events"][-1]["kind"] == "leak.suspect"
    assert mm.PROC_THREADS in payload["resources"]


# -- the blackbox ------------------------------------------------------------------


def _fill(mod, path, service, n=8):
    box = mod.Blackbox(str(path), service=service, max_segment_bytes=400, max_segments=3)
    for i in range(n):
        box.append({"resources": {mm.PROC_RSS: 1e6 + 1000.0 * i, mm.PROC_FDS: 10.0},
                    "round": i})
    return box


def test_a_ring_written_by_either_package_reads_the_same_in_the_other(tmp_path):
    _fill(blackbox, tmp_path / "port", "port", n=20)
    _fill(jblackbox, tmp_path / "jax", "jax", n=20)
    for d in ("port", "jax"):
        names = sorted(os.listdir(tmp_path / d))
        assert 1 < len(names) <= 3  # rotated and bounded
        got = blackbox.read_records(str(tmp_path / d))
        want = jblackbox.read_records(str(tmp_path / d))
        assert got == want and [r["round"] for r in got][-1] == 19
        summary = blackbox.summarize(got)
        assert summary == jblackbox.summarize(want)
        assert summary["slopes_per_s"][mm.PROC_FDS] == pytest.approx(0.0)
    # a torn final line (a crash mid-write) is skipped by both readers
    with open(next((tmp_path / "port").glob("bb-port-*[0-9].jsonl")), "a") as f:
        f.write('{"round": 99, "resour')
    assert ([r["round"] for r in blackbox.read_records(str(tmp_path / "port"))]
            == [r["round"] for r in jblackbox.read_records(str(tmp_path / "port"))])


def test_the_blackbox_cli_summarizes_a_jax_ring(tmp_path):
    _fill(jblackbox, tmp_path, "cli")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch.telemetry.blackbox",
                          "summary", str(tmp_path)], capture_output=True, text=True, check=True,
                         env=env, cwd=str(ROOT))
    summary = json.loads(out.stdout)
    assert summary["snapshots"] == 8 and summary["last_round"] == 7
    assert mm.PROC_RSS in summary["slopes_per_s"]
    assert blackbox.main(["tail", "-n", "2", str(tmp_path)]) == 0


def test_an_unusable_blackbox_dir_never_raises(tmp_path):
    deny = tmp_path / "deny"
    deny.write_text("a file, not a directory")
    box = blackbox.Blackbox(str(deny), service="t")
    box.append({"round": 1})
    assert box._failed and blackbox.read_records(str(deny)) == []


# -- the probe ---------------------------------------------------------------------


def test_a_probe_tick_reaches_gauges_sentinel_and_blackbox(tmp_path):
    flight.configure(capacity=64, service="plant-test", dir=str(tmp_path))
    m = Metrics()
    leak = {"v": 0.0}

    def plant():
        leak["v"] += 1.0
        return {"plant.leak": 100.0 * leak["v"]}

    sentinel = slope.LeakSentinel(metrics=m, min_samples=4, min_horizon_s=0.0,
                                  thresholds={"plant.leak": 10.0, "rss": 1e18, "fds": 1e18,
                                              "threads": 1e18})
    box = blackbox.Blackbox(str(tmp_path / "bb"), service="plant", metrics=m)
    probe = resources.ResourceProbe(metrics=m, interval_s=60.0, sentinel=sentinel,
                                    blackbox=box, plant=plant)
    for _ in range(12):
        probe.tick()
    flight.configure()
    assert probe.ticks == 12 and sentinel.tripped("plant.leak")
    assert m.gauge("plant.leak").value == pytest.approx(1200.0)
    assert m.gauge(mm.PROC_RSS).value > 0 and m.gauge(mm.PROC_THREADS).value >= 1
    records = jblackbox.read_records(str(tmp_path / "bb"))  # JAX reads the port's ring
    assert len(records) == 12 and mm.BLACKBOX_SNAPSHOTS in records[-1]["counters"]
    assert records[-1]["resources"]["plant.leak"] == pytest.approx(1200.0)
    # the port has no compile cache: that pressure gauge is never sampled
    assert mm.PROC_PRESSURE_COMPILE_CACHE not in records[-1]["resources"]


def test_pressure_sources_sum_and_self_clean():
    name = "proc.pressure.test_registry"
    t1 = resources.register_pressure(name, lambda: 3.0)
    t2 = resources.register_pressure(name, lambda: 4.0)
    dead = resources.register_pressure(name, lambda: None)
    raising = resources.register_pressure(name, lambda: 1 / 0)
    try:
        assert resources._sample_pressures()[name] == 7.0
        with resources._PRESSURE_LOCK:
            assert set(resources._PRESSURE[name]) == {t1, t2}
    finally:
        for tok in (t1, t2, dead, raising):
            resources.unregister_pressure(name, tok)
    assert name not in resources._sample_pressures()


def test_the_batcher_and_the_master_publish_their_queues_to_the_probe():
    from distributed_sgd_tpu.data.rcv1 import train_test_split
    from distributed_sgd_tpu.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.core.master import MasterNode
    from distributed_sgd_tpu_torch.data.rcv1 import Dataset
    from distributed_sgd_tpu_torch.models.linear import make_model
    from distributed_sgd_tpu_torch.serving.batcher import MicroBatcher

    release = threading.Event()
    b = MicroBatcher(lambda rows: (release.wait(10), [None] * len(rows))[1], max_batch=1,
                     max_delay_ms=0.0, queue_depth=8).start()
    train, test = train_test_split(rcv1_like(60, n_features=20, nnz=4, seed=1))
    master = MasterNode("127.0.0.1", 0, *(Dataset(d.indices, d.values, d.labels, d.n_features)
                                          for d in (train, test)),
                        make_model("hinge", 1e-4, 20, device="cpu"), expected_workers=1)
    try:
        for _ in range(4):
            b.submit(np.array([0], np.int32), np.array([1.0], np.float32))
        sample = resources.sample_resources()
        # one row is in the (held) flush, three wait in the queue; the port
        # reads the batcher's depth property (the JAX source calls it and is
        # dropped), and keeps answering tick after tick
        assert sample[mm.PROC_PRESSURE_ADMISSION_QUEUE] >= 3
        assert mm.PROC_PRESSURE_ADMISSION_QUEUE in resources.sample_resources()
        assert sample[mm.PROC_PRESSURE_DRAIN_INBOX] == 0.0
    finally:
        release.set()
        b.stop()
        master.stop()
    after = resources.sample_resources()
    assert mm.PROC_PRESSURE_ADMISSION_QUEUE not in after
    assert mm.PROC_PRESSURE_DRAIN_INBOX not in after


def test_every_flight_dump_carries_the_resource_sample(tmp_path):
    rec = flight.FlightRecorder(capacity=8, service="res-test", dir=str(tmp_path))
    rec.record("anything", x=1)
    payload = json.load(open(rec.dump("quorum")))
    assert payload["resources"][mm.PROC_RSS] > 0
    assert mm.PROC_PRESSURE_FLIGHT_RING in payload["resources"]


# -- the settings through main() ---------------------------------------------------


def test_the_probe_settings_validate_as_jax_validates_them():
    from distributed_sgd_tpu.config import Config as JaxConfig

    for kw in ({"resource_probe_s": -1.0}, {"blackbox_dir": "bb"}):
        for cls in (Config, JaxConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    cfg = Config(resource_probe_s=0.5, blackbox_dir="bb")
    assert (cfg.resource_probe_s, cfg.blackbox_dir) == (0.5, "bb")


def test_unset_the_probe_starts_no_thread_and_set_it_acts_in_a_role(tmp_path, monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    seen = []
    real_fit = tmain.scenario_mesh

    def fit(*a, **kw):
        seen.append(_probe_threads())
        return real_fit(*a, **kw)

    monkeypatch.setattr(tmain, "scenario_mesh", fit)
    tmain.main(device="cpu")
    assert seen == [[]] and resources.active() is None
    monkeypatch.setenv("DSGD_RESOURCE_PROBE_S", "0.05")
    monkeypatch.setenv("DSGD_BLACKBOX_DIR", str(tmp_path / "bb"))
    real_build = tmain.build

    def slow_build(cfg, device=None):
        import time

        time.sleep(0.3)  # a few probe ticks while the data loads
        return real_build(cfg, device)

    monkeypatch.setattr(tmain, "build", slow_build)
    tmain.main(device="cpu")
    assert len(seen) == 2 and len(seen[1]) == 1  # the probe ran during the fit
    assert not _probe_threads()  # and stopped with main
    records = jblackbox.read_records(str(tmp_path / "bb"))
    assert records and all(r["resources"][mm.PROC_RSS] > 0 for r in records)
    assert os.listdir(tmp_path / "bb")[0].startswith("bb-dev-")
