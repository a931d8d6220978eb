"""Cluster telemetry: one node's snapshot on the wire, and the merged view.

The port's copy of the JAX package's telemetry/aggregate.py, with the
same names, metric names and wire behaviour, so that JAX and port nodes
scrape each other:

- ``snapshot_metrics`` serializes one node's instrument registry into the
  ``MetricsSnapshot`` proto that the ``Metrics`` RPC of a worker, a
  serving replica and a router answers;
- ``ClusterTelemetry`` keeps the latest snapshot a node on a master or a
  router, scrapes them over ``Metrics`` and renders one Prometheus
  exposition for the cluster;
- ``ClusterExporter`` is its HTTP endpoint: each GET first runs the
  owner's throttled scrape.

Merge semantics (the JAX module's): counters SUM into a
``role="cluster"`` series, and a snapshot REPLACES its node's previous one,
so scraping twice equals scraping once; histogram buckets SUM over the
shared bounds (utils/metrics.py ``Histogram.BUCKET_BOUNDS``, equal to the
JAX tuple), so cross-package sums are exact, and reservoir quantiles never
cross the wire; gauges are last-write per node and never summed.

A scrape consults the per-peer circuit breakers read-only (a tripped peer
is skipped and counted) and never feeds them; a failed scrape of a node is
counted under ``master.telemetry.scrape.errors`` and its last snapshot
stays until membership drops it.  Snapshots are read without locks, as in
JAX: the counters of one snapshot taken mid-fit need not agree with each
other.  Host work only: no tensor is touched.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import grpc

from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.metrics import (
    Histogram,
    Metrics,
    PrometheusExporter,
    _prom_escape,
    prom_name as _mangle,
)


def snapshot_metrics(metrics: Metrics, role: str, node: str) -> "pb.MetricsSnapshot":
    """One registry as the wire snapshot: every counter, every gauge that
    was ever set (a never-set gauge is NaN and stays off the wire), and
    every histogram with at least one value."""
    snap = pb.MetricsSnapshot(role=role, node=node)
    for c in metrics.counters():
        snap.counters.add(name=c.name, value=c.value)
    for g in metrics.gauges():
        if g.value == g.value:
            snap.gauges.add(name=g.name, value=g.value)
    for h in metrics.histograms():
        if not h.count:
            continue
        hm = snap.hists.add(name=h.name, count=h.count, sum=h.sum,
                            min=h.min, max=h.max, last=h.last)
        hm.buckets.extend(h.bucket_counts())
    return snap


def _labels(snap) -> str:
    return (f'role="{_prom_escape(snap.role)}",'
            f'worker="{_prom_escape(snap.node)}"')


def cluster_prometheus_text(snaps: List["pb.MetricsSnapshot"]) -> str:
    """The merged cluster exposition of per-node snapshots, as JAX renders
    it: per family one ``# TYPE`` line, the per-node samples (labelled
    ``role``/``worker``), then for counters and histograms the cluster
    aggregate labelled ``role="cluster"``; histogram ``le`` buckets at the
    cluster level only.  Families sorted by name, samples by node."""
    snaps = sorted(snaps, key=lambda s: (s.role, s.node))
    lines: List[str] = []

    gauges: Dict[str, List[Tuple[str, float]]] = {}
    counters: Dict[str, List[Tuple[str, int]]] = {}
    hists: Dict[str, List[Tuple[str, "pb.MetricHistogram"]]] = {}
    for s in snaps:
        lab = _labels(s)
        for g in s.gauges:
            gauges.setdefault(g.name, []).append((lab, g.value))
        for c in s.counters:
            counters.setdefault(c.name, []).append((lab, c.value))
        for h in s.hists:
            hists.setdefault(h.name, []).append((lab, h))

    for name in sorted(gauges):
        base = _mangle(name)
        lines.append(f"# TYPE {base} gauge")
        for lab, v in gauges[name]:
            lines.append(f"{base}{{{lab}}} {v}")

    for name in sorted(counters):
        base = _mangle(name)
        lines.append(f"# TYPE {base}_total counter")
        for lab, v in counters[name]:
            lines.append(f"{base}_total{{{lab}}} {v}")
        total = sum(v for _, v in counters[name])
        lines.append(f'{base}_total{{role="cluster"}} {total}')

    n_bounds = len(Histogram.BUCKET_BOUNDS)
    for name in sorted(hists):
        base = _mangle(name)
        per_node = hists[name]
        for lab, h in per_node:
            lines.append(f"{base}_count{{{lab}}} {h.count}")
            lines.append(f"{base}_sum{{{lab}}} {h.sum}")
            lines.append(f"{base}_min{{{lab}}} {h.min}")
            lines.append(f"{base}_max{{{lab}}} {h.max}")
            lines.append(f"{base}_last{{{lab}}} {h.last}")
        # the cluster merge: counts and sums add, min and max fold, the
        # buckets add exactly over the shared bounds
        count = sum(h.count for _, h in per_node)
        total = sum(h.sum for _, h in per_node)
        lo = min(h.min for _, h in per_node)
        hi = max(h.max for _, h in per_node)
        merged = [0] * n_bounds
        for _, h in per_node:
            for i, b in enumerate(h.buckets[:n_bounds]):
                merged[i] += b
        lines.append(f'{base}_count{{role="cluster"}} {count}')
        lines.append(f'{base}_sum{{role="cluster"}} {total}')
        lines.append(f'{base}_min{{role="cluster"}} {lo}')
        lines.append(f'{base}_max{{role="cluster"}} {hi}')
        lines.append(f"# TYPE {base}_hist histogram")
        cum = 0
        for le, n in zip(Histogram.BUCKET_BOUNDS, merged):
            cum += n
            lines.append(
                f'{base}_hist_bucket{{role="cluster",le="{le:.9g}"}} {cum}')
        lines.append(f'{base}_hist_bucket{{role="cluster",le="+Inf"}} {count}')
        lines.append(f'{base}_hist_sum{{role="cluster"}} {total}')
        lines.append(f'{base}_hist_count{{role="cluster"}} {count}')
    return "\n".join(lines) + "\n"


class ClusterTelemetry:
    """The latest snapshot a node, and the scrape over ``Metrics``, on a
    master (role "master") or a router (role "route").

    ``scrape(members, rpc_policy)`` sends concurrent ``Metrics`` futures to
    every member whose breaker does not suppress calls, waits at most one
    deadline, and replaces each answering node's snapshot.  A failure
    (UNIMPLEMENTED from an older node included) counts under
    ``master.telemetry.scrape.errors``; the node's last snapshot stays
    until ``drop``.  ``min_age_s`` throttles triggers that come close
    together (the heartbeat's and the endpoint's)."""

    def __init__(self, metrics: Metrics, node: str = "master", role: str = "master"):
        self.metrics = metrics  # the owner's own registry, rendered beside the nodes'
        self.node = node
        self.role = role
        self._snaps: Dict[Tuple[str, int], "pb.MetricsSnapshot"] = {}
        self._lock = threading.Lock()
        self._last_scrape = -float("inf")

    def observe(self, key, snap: "pb.MetricsSnapshot") -> None:
        """Replace `key`'s snapshot: counters are cumulative, so replacing
        (not adding) keeps repeated scrapes idempotent."""
        with self._lock:
            self._snaps[key] = snap
            self.metrics.gauge(metrics_mod.TELEMETRY_WORKERS).set(len(self._snaps))

    def drop(self, key) -> None:
        """Membership removed the node: its series leave the exposition."""
        with self._lock:
            self._snaps.pop(key, None)
            self.metrics.gauge(metrics_mod.TELEMETRY_WORKERS).set(len(self._snaps))

    def scrape(self, members, rpc_policy, deadline_s: Optional[float] = None,
               min_age_s: float = 0.0) -> int:
        """One scrape over [(key, stub)]; returns the snapshots merged.
        Never raises, and a dead node costs one deadline shared by the
        concurrent futures, not one a node."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_scrape < min_age_s:
                return 0
            self._last_scrape = now
        deadline = deadline_s if deadline_s is not None else rpc_policy.deadline_s
        errors = self.metrics.counter(metrics_mod.TELEMETRY_SCRAPE_ERRORS)
        futs = []
        for key, stub in members:
            # a read-only look at the breaker: a tripped peer is skipped
            # without taking its half-open probe, and no outcome is fed back
            if rpc_policy.breaker(key).suppressed():
                self.metrics.counter(metrics_mod.TELEMETRY_SCRAPE_SKIPPED).increment()
                continue
            try:
                futs.append((key, stub.Metrics.future(pb.Empty(), timeout=deadline)))
            except (ValueError, AttributeError):  # the channel closed under us
                errors.increment()
        got = 0
        for key, fut in futs:
            try:
                self.observe(key, fut.result())
                got += 1
            except grpc.RpcError:
                errors.increment()
        self.metrics.counter(metrics_mod.TELEMETRY_SCRAPES).increment()
        return got

    def prometheus_text(self) -> str:
        """The cluster exposition: every stored snapshot and a fresh one of
        the owner's own registry."""
        with self._lock:
            snaps = list(self._snaps.values())
        snaps.append(snapshot_metrics(self.metrics, self.role, self.node))
        return cluster_prometheus_text(snaps)


class ClusterExporter(PrometheusExporter):
    """The cluster exposition's HTTP endpoint (one a master or router):
    PrometheusExporter's routing and threading with the cluster `render`
    and a `refresh` that runs the owner's throttled scrape before each
    GET.  A port that cannot be bound raises."""

    def __init__(self, render: Callable[[], str], port: int, host: str = "0.0.0.0",
                 refresh: Optional[Callable[[], None]] = None):
        super().__init__(None, port, host=host, render=render, refresh=refresh)
