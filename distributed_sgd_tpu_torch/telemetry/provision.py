"""Provisioned dashboards and alerts, generated from the instrument names.

The port of the JAX package's telemetry/provision.py.  The cluster
dashboard (``grafana-dashboard-cluster.json``) and the Prometheus alert
rules (``prometheus-alerts.yaml``) are GENERATED from the constants in
utils/metrics.py, so that dashboards, alerts and code cannot drift
apart: tests/test_torch_provision.py holds the generation to the files
committed under ``kube/observability/`` byte for byte (the JAX
generator's output, whose header names it), every instrument either file
references to a port module that records it, and the curated core set
below to the files.

Write the two files into a directory:

    python -m distributed_sgd_tpu_torch.telemetry.provision <out_dir>
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Tuple

from distributed_sgd_tpu_torch.utils import metrics as mm
from distributed_sgd_tpu_torch.utils.metrics import prom_name as _prom

DASHBOARD_FILE = "grafana-dashboard-cluster.json"
ALERTS_FILE = "prometheus-alerts.yaml"


# _prom is utils/metrics.prom_name, the one mangling rule the expositions
# share, so the artifacts cannot drift from the exporters.

# -- the single source both artifacts draw from -------------------------------
#
# (instrument, kind): kind picks the family suffix the cluster exposition
# emits — counters gain `_total`, gauges are bare, histograms are read
# through their `_sum`/`_count` scalars (telemetry/aggregate.py).
_C, _G, _H = "counter", "gauge", "histogram"

REFERENCED_INSTRUMENTS: Dict[str, str] = {
    mm.SYNC_ROUNDS: _C,
    mm.SYNC_BCAST_BYTES: _C,
    mm.SYNC_GRAD_BYTES: _C,
    mm.QUORUM_DEGRADED: _C,
    mm.QUORUM_HEDGES: _C,
    mm.QUORUM_HEDGE_WINS: _C,
    mm.SYNC_STALLED: _C,
    mm.BREAKER_OPEN: _C,
    mm.TELEMETRY_SCRAPES: _C,
    mm.TELEMETRY_SCRAPE_ERRORS: _C,
    mm.TELEMETRY_SCRAPE_SKIPPED: _C,
    mm.TELEMETRY_WORKERS: _G,
    mm.HEALTH_GRAD_NORM: _G,
    mm.HEALTH_STALENESS: _G,
    mm.HEALTH_EF_RESIDUAL_NORM: _G,
    mm.HEALTH_DRAIN_BACKLOG: _G,
    mm.HEALTH_LOSS_EWMA: _G,
    mm.HEALTH_TRIPPED: _C,
    # the long-horizon resource plane (telemetry/resources.py)
    mm.PROC_RSS: _G,
    mm.PROC_FDS: _G,
    mm.PROC_THREADS: _G,
    mm.HEALTH_LEAK_SUSPECT: _C,
    "master.sync.loss": _H,
    "master.sync.batch.duration": _H,
}

# The curated core set the consistency gate enforces in BOTH directions:
# these must exist in code AND appear in the dashboard/alert artifacts.
CORE_INSTRUMENTS = (
    mm.SYNC_ROUNDS,
    mm.HEALTH_GRAD_NORM,
    mm.HEALTH_STALENESS,
    mm.HEALTH_LOSS_EWMA,
    mm.HEALTH_TRIPPED,
    mm.QUORUM_DEGRADED,
    mm.TELEMETRY_SCRAPE_ERRORS,
    mm.BREAKER_OPEN,
    mm.PROC_RSS,
    mm.HEALTH_LEAK_SUSPECT,
)


def _panel(pid: int, title: str, targets: List[Tuple[str, str]],
           x: int, y: int) -> dict:
    return {
        "id": pid,
        "type": "timeseries",
        "title": title,
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "targets": [{"expr": expr, "legendFormat": legend}
                    for expr, legend in targets],
    }


def dashboard() -> dict:
    """The cluster dashboard: every expr is built through _prom() from a
    REFERENCED_INSTRUMENTS key, so a renamed instrument fails the
    consistency gate instead of silently blanking a panel."""
    rounds = _prom(mm.SYNC_ROUNDS, "_total")
    loss_sum = _prom("master.sync.loss", "_sum")
    loss_cnt = _prom("master.sync.loss", "_count")
    dur_sum = _prom("master.sync.batch.duration", "_sum")
    dur_cnt = _prom("master.sync.batch.duration", "_count")
    panels = [
        _panel(1, "training rounds / s (cluster)", [
            (f'rate({rounds}{{role="cluster"}}[1m])', "rounds/s"),
        ], 0, 0),
        _panel(2, "loss (per-epoch mean + health EWMA)", [
            (f'rate({loss_sum}{{role="cluster"}}[5m]) / '
             f'rate({loss_cnt}{{role="cluster"}}[5m])', "epoch loss (5m)"),
            (_prom(mm.HEALTH_LOSS_EWMA), "health EWMA {{worker}}"),
        ], 12, 0),
        _panel(3, "gradient norm per worker", [
            (f'{_prom(mm.HEALTH_GRAD_NORM)}{{role="worker"}}', "{{worker}}"),
        ], 0, 8),
        _panel(4, "reply staleness per worker (s)", [
            (f'{_prom(mm.HEALTH_STALENESS)}{{role="worker"}}', "{{worker}}"),
        ], 12, 8),
        _panel(5, "EF residual norm per worker", [
            (f'{_prom(mm.HEALTH_EF_RESIDUAL_NORM)}{{role="worker"}}',
             "{{worker}}"),
        ], 0, 16),
        _panel(6, "quorum pressure (cluster)", [
            (f'rate({_prom(mm.QUORUM_DEGRADED, "_total")}{{role="cluster"}}[1m])',
             "degraded rounds/s"),
            (f'rate({_prom(mm.QUORUM_HEDGES, "_total")}{{role="cluster"}}[1m])',
             "hedges/s"),
            (f'rate({_prom(mm.QUORUM_HEDGE_WINS, "_total")}{{role="cluster"}}[1m])',
             "hedge wins/s"),
            (f'rate({_prom(mm.SYNC_STALLED, "_total")}{{role="cluster"}}[1m])',
             "stalled barriers/s"),
        ], 12, 16),
        _panel(7, "wire bytes / s (cluster)", [
            (f'rate({_prom(mm.SYNC_BCAST_BYTES, "_total")}{{role="cluster"}}[1m])',
             "broadcast B/s"),
            (f'rate({_prom(mm.SYNC_GRAD_BYTES, "_total")}{{role="cluster"}}[1m])',
             "fan-in B/s"),
        ], 0, 24),
        _panel(8, "round duration (s, cluster mean)", [
            (f'rate({dur_sum}{{role="cluster"}}[1m]) / '
             f'rate({dur_cnt}{{role="cluster"}}[1m])', "batch duration (1m)"),
        ], 12, 24),
        _panel(9, "telemetry plane health", [
            (f'rate({_prom(mm.TELEMETRY_SCRAPES, "_total")}[5m])', "scrapes/s"),
            (f'rate({_prom(mm.TELEMETRY_SCRAPE_ERRORS, "_total")}[5m])',
             "scrape errors/s"),
            (f'rate({_prom(mm.TELEMETRY_SCRAPE_SKIPPED, "_total")}[5m])',
             "breaker-skipped/s"),
            (_prom(mm.TELEMETRY_WORKERS), "workers scraped"),
        ], 0, 32),
        _panel(10, "failure signals", [
            (f'increase({_prom(mm.HEALTH_TRIPPED, "_total")}[10m])',
             "health trips (10m)"),
            (f'increase({_prom(mm.BREAKER_OPEN, "_total")}[10m])',
             "breaker opens (10m)"),
            (_prom(mm.HEALTH_DRAIN_BACKLOG), "drain backlog"),
        ], 12, 32),
        _panel(11, "process resources per node (rss / fds / threads)", [
            (_prom(mm.PROC_RSS), "rss {{role}} {{worker}}"),
            (_prom(mm.PROC_FDS), "fds {{role}} {{worker}}"),
            (_prom(mm.PROC_THREADS), "threads {{role}} {{worker}}"),
        ], 0, 40),
        _panel(12, "leak suspects (slope sentinel trips)", [
            (f'increase({_prom(mm.HEALTH_LEAK_SUSPECT, "_total")}[10m])',
             "leak trips (10m) {{role}} {{worker}}"),
        ], 12, 40),
    ]
    return {
        "uid": "dsgd-cluster",
        "title": "distributed-sgd cluster telemetry",
        "timezone": "browser",
        "refresh": "5s",
        "time": {"from": "now-15m", "to": "now"},
        "schemaVersion": 39,
        "panels": panels,
    }


def alert_rules() -> str:
    """Prometheus rule file (YAML text, no yaml dependency): every metric
    identifier comes through _prom(), same drift discipline as the
    dashboard."""
    rules = [
        ("DsgdHealthWatchdogTripped", "critical", "2m",
         f'increase({_prom(mm.HEALTH_TRIPPED, "_total")}[10m]) > 0',
         "the training-health watchdog tripped (loss divergence or "
         "NaN/Inf): read the flight-*-health.json dump and the fit-state "
         "snapshot before restarting"),
        ("DsgdTrainingRoundsFlat", "critical", "5m",
         f'rate({_prom(mm.SYNC_ROUNDS, "_total")}{{role="cluster"}}[5m]) == 0',
         "no sync rounds completed for 5m while the master is up — a "
         "stalled barrier or a dead fan-out"),
        ("DsgdTelemetryScrapeFailing", "warning", "5m",
         f'rate({_prom(mm.TELEMETRY_SCRAPE_ERRORS, "_total")}[5m]) > 0.5',
         "worker metric scrapes are failing: the cluster view is partial "
         "(dead worker, version skew, or network trouble)"),
        ("DsgdBreakerOpen", "warning", "1m",
         f'increase({_prom(mm.BREAKER_OPEN, "_total")}[5m]) > 0',
         "a per-peer circuit breaker opened: one or more RPC edges are "
         "failing repeatedly"),
        ("DsgdQuorumDegradedSustained", "warning", "10m",
         f'rate({_prom(mm.QUORUM_DEGRADED, "_total")}{{role="cluster"}}[5m]) > 0.5',
         "most rounds are closing below full strength: a persistent "
         "straggler is being hedged around — check its node"),
        ("DsgdSyncBarrierStalled", "warning", "5m",
         f'rate({_prom(mm.SYNC_STALLED, "_total")}{{role="cluster"}}[5m]) > 0.2',
         "soft-deadline overruns without quorum relief: the cluster is "
         "slower than its straggler budget"),
        ("DsgdDrainBacklogSaturated", "warning", "2m",
         f'{_prom(mm.HEALTH_DRAIN_BACKLOG)} > 900',
         "the async drain inbox is near its 1024 cap: arrivals outrun "
         "the drain thread and deltas will fall back to per-message "
         "apply"),
        ("DsgdLeakSuspect", "warning", "1m",
         f'increase({_prom(mm.HEALTH_LEAK_SUSPECT, "_total")}[10m]) > 0',
         "the leak-slope sentinel tripped on a process resource series "
         "(rss/fds/threads): read the flight-*-leak.json dump and the "
         "blackbox ring (python -m distributed_sgd_tpu.telemetry.blackbox "
         "summary $DSGD_BLACKBOX_DIR) before the process dies of it"),
        ("DsgdEfResidualGrowing", "warning", "10m",
         f'{_prom(mm.HEALTH_EF_RESIDUAL_NORM)} > 10 * '
         f'{_prom(mm.HEALTH_GRAD_NORM)}',
         "a worker's error-feedback residual dwarfs its gradient: "
         "compression is starving coordinates — lower DSGD_COMPRESS_K "
         "pressure or disable EF"),
    ]
    lines = [
        "# GENERATED by `python -m distributed_sgd_tpu.telemetry.provision`",
        "# from the instrument-name constants in utils/metrics.py — edit",
        "# the generator, not this file (tests/test_observability.py",
        "# fails the build when they drift).",
        "groups:",
        "  - name: dsgd-cluster-telemetry",
        "    rules:",
    ]
    for name, severity, for_, expr, summary in rules:
        lines += [
            f"      - alert: {name}",
            f"        expr: {expr}",
            f"        for: {for_}",
            "        labels:",
            f"          severity: {severity}",
            "        annotations:",
            f"          summary: >-",
            f"            {summary}",
        ]
    return "\n".join(lines) + "\n"


def render_dashboard() -> str:
    return json.dumps(dashboard(), indent=2, sort_keys=True) + "\n"


def main(out_dir: str) -> None:
    """Write the dashboard and the alert rules into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    dash_path = os.path.join(out_dir, DASHBOARD_FILE)
    with open(dash_path, "w") as f:
        f.write(render_dashboard())
    alerts_path = os.path.join(out_dir, ALERTS_FILE)
    with open(alerts_path, "w") as f:
        f.write(alert_rules())
    print(f"wrote {dash_path}\nwrote {alerts_path}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m distributed_sgd_tpu_torch.telemetry.provision <out_dir>")
    main(sys.argv[1])
