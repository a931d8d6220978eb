"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, cell, engine
or per-layer metric sits in a file of its own, found by its name in
``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (source, rows, model, engine
  and its settings, precision, what was reduced and assumed);
- ``traffic/<traffic>.json``: the cell's training stream (the sampling,
  the optimizer and its rate), read over the configuration's settings;
- ``workloads/<cell>.json``: the limits of the cell's `correct` check
  (its configuration and traffic are named in ``BENCHMARK.json`` alone);
- ``drivers/<engine>.py``: a class ``Driver`` that builds the program's
  object for the engine, drives its first steps, runs the window and
  follows the first steps with the plain reference;
- ``metrics/<metric>.py``: a function ``read(run)`` that returns the
  metric's value, or None where the run holds nothing to read.  A metric
  that ``BENCHMARK.json`` lists for the cell and that reads None fails
  the run: a renamed kernel or a lost counter never drops a metric from
  the result line unseen.

A later cell, configuration, mix, engine or metric is added as files;
no file here changes.

A traced run (``--trace 1``) measures the window in two parts split at a
unit boundary: the host's metrics (``host_clock``, ``program_span``) are
read over the first, untraced part, and the one profiler session covers
only the last TRACED_S seconds, which the device's metrics are read from.
The profiler slows the host's launches, so a host metric read under it
would measure the profiler too.  The profiler's start, seconds long,
falls between the two parts, so a traced run's window is that much
longer than an untraced one's.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from gpubench import isolation, judge, trace
from gpubench.data import make_rows
from gpubench.reference.linear import REFERENCE, fold_in

FILES = Path(__file__).resolve().parent
BENCHMARK = FILES.parent / "BENCHMARK.json"
TRACED_S = 10.0  # seconds of a traced run's window under the profiler, at most half


class MissingMetric(RuntimeError):
    """A metric listed for the cell read nothing in this run."""


class Registry:
    """The benchmark's entries and the files they name."""

    def __init__(self, benchmark: Path = BENCHMARK, files: Path = FILES):
        self.files = Path(files)
        self.bench = json.loads(Path(benchmark).read_text())

    def _json(self, kind: str, name: str) -> Dict[str, Any]:
        path = self.files / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
        return json.loads(path.read_text())

    def _module(self, kind: str, name: str):
        path = self.files / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> Dict[str, Any]:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def cell(self, name: str) -> "Cell":
        entry = self.workload(name)
        config = self._json("configs", entry["config"])
        traffic = self._json("traffic", entry["traffic"])
        return Cell(name, entry, config, traffic, self._json("workloads", name)["limits"])

    def driver(self, engine: str):
        return self._module("drivers", engine).Driver

    def metric_reader(self, name: str):
        return self._module("metrics", name).read

    def metrics(self, group: str, cell: str) -> List[Dict[str, Any]]:
        """The `group` ('end_to_end' or 'per_layer') metrics the cell reports."""
        return [m for m in self.bench[group] if cell in m.get("workloads", [cell])]


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]

    @property
    def settings(self) -> Dict[str, Any]:
        """The engine's settings: the configuration's, then the traffic's."""
        return {**self.config["engine_args"], **self.traffic.get("engine_args", {})}


@dataclass
class Part:
    """A stretch of the window from one unit boundary to a later one."""

    seconds: float
    units: int  # epochs or rounds
    samples: int
    ends: List[float]  # perf_counter at the part's start and at each boundary in it
    extra: Dict[str, Any] = field(default_factory=dict)  # the engine's own totals


@dataclass
class Run:
    """What a run measured, as the metric readers see it: the whole window
    (end-to-end metrics), its untraced part (the host's per-layer metrics;
    the whole window in an untraced run) and its traced part with the
    trace (the device's)."""

    cell: Cell
    whole: Part
    host: Part
    traced: Optional[Part] = None
    trace: Optional[trace.Summary] = None
    work: Any = None  # roofline.Work of the traced part
    launch_work: Any = None  # roofline.Work of one sync_epoch launch
    setup_s: float = 0.0


class Window:
    """The measured window, driven by an engine's driver: `open` once the
    fit's first steps are made, `boundary` at each later unit boundary
    (an epoch's end, a loss check), which says whether the window ends
    there, and `close` once the fit has returned and the card is idle.
    `totals` is the driver's: the running totals it reads at each mark."""

    def __init__(self, seconds: float, traced: bool):
        self.seconds = seconds
        self.split_at = seconds - min(TRACED_S, seconds / 2) if traced else None
        self.marks: List[Tuple[float, Dict[str, Any]]] = []  # (perf_counter, totals)
        self.split: Optional[int] = None  # the mark the traced part starts at
        self.end_at = seconds  # from the window's start
        self.prof = None
        self.lo_ns = self.hi_ns = 0
        self.totals = dict

    @property
    def t0(self) -> float:
        return self.marks[0][0]

    def open(self, totals) -> None:
        self.totals = totals
        self.marks.append((time.perf_counter(), totals()))

    def boundary(self) -> bool:
        now = time.perf_counter()
        self.marks.append((now, self.totals()))
        if self.split_at is not None and self.split is None and now - self.t0 >= self.split_at:
            # the host's part ends here; the traced part starts once the
            # profiler is up, which takes seconds, and lasts its full length
            self.prof = trace.start()
            self.lo_ns = time.time_ns()
            self.marks.append((time.perf_counter(), self.totals()))
            self.split = len(self.marks) - 1
            self.end_at = self.marks[-1][0] - self.t0 + self.seconds - self.split_at
            return False
        return now - self.t0 >= self.end_at

    def close(self) -> None:
        self.hi_ns = time.time_ns()
        self.marks.append((time.perf_counter(), self.totals()))
        if self.prof is not None:
            self.prof.stop()

    def part(self, lo: int, hi: int, measure) -> Part:
        """The part from mark `lo` to mark `hi`; `measure(totals_lo,
        totals_hi)` is the driver's (units, samples, extra) between them."""
        units, samples, extra = measure(self.marks[lo][1], self.marks[hi][1])
        ends = [t for t, _ in self.marks[lo:hi + 1]]
        return Part(ends[-1] - ends[0], units, samples, ends, extra)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell asks for {n} cards, {torch.cuda.device_count()} found")


def run_cell(reg: Registry, workload: str, seed: int, seconds: float, traced: bool,
             t_process: float, device: str = "cuda", log=print) -> Dict[str, Any]:
    """One run: the result line's object.  `t_process` is the
    perf_counter at the process's start; on `device` 'cpu' (the tests)
    the look for a card is skipped."""
    t_imported = time.perf_counter()
    cell = reg.cell(workload)
    chips = int(cell.entry["chips"])
    if device == "cuda":
        require_cards(chips)
        log(f"card: {card_line()}; {torch.cuda.device_count()} visible, {chips} used")
        torch.cuda.set_device(0)
    dev = torch.device(device)
    torch.zeros(1, device=dev)  # the context
    t_context = time.perf_counter()
    train, test = make_rows(cell.config["data"], fold_in(seed, 1), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_rows = time.perf_counter()
    drv = reg.driver(cell.config["engine"])(cell, train, test, fold_in(seed, 2), dev)
    t_built = time.perf_counter()
    window = Window(seconds, traced)
    prog = drv.run(window)
    if window.prof is not None:
        t_read = time.perf_counter()
        summary = trace.summarize(window.prof, window.lo_ns, window.hi_ns)
        log(f"trace: the session stopped in {t_read - window.marks[-1][0]:.3f} s; "
            f"{summary.n_device_events} device events read in {time.perf_counter() - t_read:.3f} s")
    elif traced:
        raise trace.NoDeviceEvents("the window ended before its traced part began")
    else:
        summary = None
    setup_s = window.t0 - t_process
    log(f"set-up: imports {t_imported - t_process:.3f} s, the card {t_context - t_imported:.3f} s,"
        f" the rows {t_rows - t_context:.3f} s, host rows and model {t_built - t_rows:.3f} s, "
        f"the fit's first steps {window.t0 - t_built:.3f} s")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    drv.release()

    ref = drv.follow(REFERENCE)
    got = judge.numbers(prog, ref, drv.evaluate)
    correct, checks = judge.verdict(got, cell.limits)
    found = isolation.forbidden_modules()
    if found:
        raise isolation.Forbidden(found)

    last = len(window.marks) - 1
    host_end = last if window.split is None else window.split - 1
    run = Run(cell, window.part(0, last, drv.measure), window.part(0, host_end, drv.measure),
              setup_s=setup_s, launch_work=drv.launch_work())
    if summary is not None:
        run.traced, run.trace = window.part(window.split, last, drv.measure), summary
        run.work = drv.part_work(run.traced)
    metrics = {}
    for m in reg.metrics("per_layer" if traced else "end_to_end", cell.name):
        value = reg.metric_reader(m["name"])(run)
        if value is None:
            raise MissingMetric(f"{m['name']} read nothing in this run of {cell.name}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    whole = run.whole
    log(f"window: {whole.units} {drv.unit}s, {whole.samples} samples in {whole.seconds:.4f} s "
        f"({whole.samples / whole.seconds:.1f} samples/s); set-up {setup_s:.3f} s; "
        f"peak {peak} B" + (f"; traced the last {run.traced.units} {drv.unit}s"
                            if run.traced else ""))
    result: Dict[str, Any] = {
        "correct": correct, "attempted": whole.units,
        "failed": 0 if all(bool(torch.isfinite(w).all()) for w in prog.weights) else whole.units,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = checks
    for k, v in got.items():
        if k not in checks:
            log(f"not compared {k}: {v!r}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result
