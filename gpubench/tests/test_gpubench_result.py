"""The result line's shape, on the CPU at a tiny size (the look for a card
skipped), and a traced run whose trace holds no device event."""

import json
import time

import pytest

from gpubench import harness, trace
from gpubench.roofline import SYNC_EPOCH_KERNEL

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["sync3-b100-sgd", "local-b256-h16-sgd", "local-b256-h16-adam"])
def test_the_result_line(tiny, cell):
    lines = []
    out = harness.run_cell(tiny, cell, 2 ** 31 + 7, 0.2, False, time.perf_counter(),
                           device="cpu", log=lines.append)
    assert list(out) == KEYS, "checks come last"
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(m["value"] > 0 and m["unit"] for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] == {k: out["checks"][k] for k in tiny.cell(cell).limits}
    compared = [line for line in lines[-len(out["checks"]):]]
    assert all(line.startswith("check ") and "limit" in line for line in compared), \
        "each number beside its limit, last on standard error"


KERNEL = "(anonymous namespace)::sync_epoch_kernel((anonymous namespace)::Params)"


def _sync_run():
    cell = harness.Registry().cell("sync3-b100-sgd")
    host = harness.Part(2.0, 20, 100, [0.1 * i for i in range(21)],
                        {"epoch_seconds": [0.02] * 20})
    return harness.Run(cell, host, host)


def test_per_layer_readers_read_what_a_run_holds():
    run, reg = _sync_run(), harness.Registry()
    assert reg.metric_reader("sync.epoch_ms_p90")(run) == pytest.approx(100.0)
    assert reg.metric_reader("sync.eval_ms_per_epoch")(run) == pytest.approx(80.0)
    for name in ("eval.kernels_per_epoch", "device_idle_pct", "mfu_pct",
                 "sync_epoch.roofline_pct", "local.round_us"):
        assert reg.metric_reader(name)(run) is None, f"{name} read nothing as nothing"
    run.traced = harness.Part(1.0, 5, 25, [2.0 + 0.2 * i for i in range(6)],
                              {"epoch_seconds": [0.02] * 5})
    run.trace = trace.Summary(window_s=1.0, busy_s=0.25, kernels={"k": (10, 0.1)},
                              device_ops=[], idle_gaps=[])
    assert reg.metric_reader("device_idle_pct")(run) == pytest.approx(75.0)
    assert reg.metric_reader("sync_epoch.roofline_pct")(run) is None, "no sync_epoch launch"
    assert reg.metric_reader("eval.kernels_per_epoch")(run) is None, \
        "a trace without the kernel's name does not count it as evaluation"
    run.trace.kernels[KERNEL] = (5, 0.1)
    assert reg.metric_reader("eval.kernels_per_epoch")(run) == pytest.approx(2.0), \
        "over the traced part's epochs"
    assert reg.metric_reader("sync.epoch_ms_p90")(run) == pytest.approx(100.0), \
        "host metrics read the untraced part"


def test_a_listed_metric_that_reads_nothing_fails_the_run(tiny, monkeypatch):
    """A renamed kernel or a lost counter fails the run: no metric listed
    for the cell goes missing from its result line unseen."""
    real = tiny.metric_reader

    def reader(name):
        return (lambda run: None) if name == "samples_per_s" else real(name)
    monkeypatch.setattr(tiny, "metric_reader", reader)
    with pytest.raises(harness.MissingMetric, match="samples_per_s"):
        harness.run_cell(tiny, "local-b256-h16-sgd", 5, 0.1, False, time.perf_counter(),
                         device="cpu", log=lambda m: None)


def test_a_traced_window_is_traced_only_in_its_last_part(monkeypatch):
    """The profiler opens at the first boundary past the window's length
    less TRACED_S (at most half the window), its traced part starts once
    the profiler is up and lasts TRACED_S, and the profiler closes with
    the window; the host's part ends where the profiler starts."""

    class Prof:
        stopped = False

        def stop(self):
            self.stopped = True
    monkeypatch.setattr(trace, "start", Prof)
    clock = iter(range(100))
    monkeypatch.setattr(harness.time, "perf_counter", lambda: float(next(clock)))
    units = [0]
    w = harness.Window(40.0, traced=True)
    w.open(lambda: {"units": units[0]})
    ends = 0
    while True:
        units[0] += 1
        if w.boundary():
            break
        ends += 1
    w.close()
    measure = lambda lo, hi: (hi["units"] - lo["units"], 0, {})  # noqa: E731
    assert w.split == 31 and w.prof.stopped, "split at 40 - 10 s, after the profiler's start"
    host, traced = w.part(0, w.split - 1, measure), w.part(w.split, len(w.marks) - 1, measure)
    assert (host.seconds, host.units) == (30.0, 30), "the host's part ends at the split"
    assert (traced.seconds, traced.units) == (11.0, 10), "the traced part lasts its full length"
    assert harness.Window(6.0, traced=True).split_at == 3.0, "at most half the window traced"
    assert harness.Window(6.0, traced=False).split_at is None


def test_a_trace_without_device_events_fails():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    lo = time.time_ns()
    torch.ones(1000).cumsum(0)
    hi = time.time_ns()
    prof.stop()
    with pytest.raises(trace.NoDeviceEvents):
        trace.summarize(prof, lo, hi)


def test_union_and_gaps():
    busy, gaps = trace.union([(0, 10), (5, 20), (30, 40)], 0, 50)
    assert busy == 30 and gaps == [(20, 30), (40, 50)]


class _Event:
    """An event as torch 2.11's profiler gives it: no activity type."""

    def __init__(self, name, start, dur, cuda=True, annotation=False):
        self._n, self._s, self._d, self._c, self._a = name, start, dur, cuda, annotation

    def name(self):
        return self._n

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_summary_of_device_events_told_by_device_and_name():
    from types import SimpleNamespace

    events = [_Event("cudaLaunchKernel", 0, 5, cuda=False), _Event(KERNEL, 10, 30),
              _Event("Memcpy HtoD (Pageable -> Device)", 50, 10), _Event("reduce_kernel", 70, 10),
              _Event("gpubench range", 0, 100, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    s = trace.summarize(prof, 0, 100)
    assert s.busy_s == pytest.approx(50e-9) and s.window_s == pytest.approx(100e-9)
    assert s.kernel_matching(SYNC_EPOCH_KERNEL) == (1, pytest.approx(30e-9))
    assert s.kernels_not_matching(SYNC_EPOCH_KERNEL) == 1, "copies are not kernels"
    assert dict(s.idle_gaps) == pytest.approx({f"before {KERNEL}": 10e-9,
                                               "before Memcpy HtoD (Pageable -> Device)": 10e-9,
                                               "before reduce_kernel": 10e-9,
                                               "after the last": 20e-9})
