"""Crash-surviving blackbox timeseries.

The port's copy of the JAX package's telemetry/blackbox.py: the same file
names, record format and ring, so either package's post-mortem CLI reads
the other's rings.

The /metrics page dies with the process — exactly when the hours-horizon
question ("what was RSS doing for the last ten minutes?") matters most.
The blackbox is the flight recorder's timeseries sibling: the resource
probe appends one JSON snapshot per tick (resources + every counter +
the round cursor) to an on-disk ring under ``DSGD_BLACKBOX_DIR``, and a
post-mortem reads the dead process's last minutes with::

    python -m distributed_sgd_tpu_torch.telemetry.blackbox summary <dir>

Crash-survival discipline, mirrored from trace/flight.py:

- every append is open → write one line → flush → close, so the newest
  complete snapshot is always on disk; a crash can lose at most the
  snapshot being written, and a torn final line is skipped by readers;
- rotation is ``os.replace`` of the live segment to a numbered one — a
  reader never observes a half-rotated file — and segments beyond the
  ring bound are unlinked oldest-first, so the footprint is bounded at
  roughly ``max_segments * max_segment_bytes`` per process forever;
- :meth:`append` never raises: a full disk degrades the blackbox, not
  the training run.

Files are ``bb-<service>-<pid>.jsonl`` (live) and
``bb-<service>-<pid>.<seq>.jsonl`` (rotated, seq ascending with age of
rotation — higher seq is NEWER).  The CLI merges every segment of every
process in the dir and orders records by wall time.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.blackbox")

_SEG_RE = re.compile(r"^bb-(?P<service>.+)-(?P<pid>\d+)"
                     r"(?:\.(?P<seq>\d+))?\.jsonl$")


class Blackbox:
    """Bounded on-disk ring of JSONL snapshot segments."""

    def __init__(self, dir: str, service: Optional[str] = None,
                 max_segment_bytes: int = 262144, max_segments: int = 4,
                 metrics: Optional[metrics_mod.Metrics] = None):
        if max_segment_bytes <= 0 or max_segments < 1:
            raise ValueError("blackbox ring bounds must be positive")
        self.dir = dir
        self.service = service or "proc"
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = int(max_segments)
        # same registry the probe snapshots from, so the write count
        # rides along inside each snapshot's counters section
        self.metrics = metrics or metrics_mod.global_metrics()
        self._seq = 0
        self._lock = threading.Lock()
        self._failed = False
        self._path = os.path.join(
            dir, f"bb-{self.service}-{os.getpid()}.jsonl")
        try:
            os.makedirs(dir, exist_ok=True)
        except OSError as e:
            log.warning("blackbox dir %s unusable: %s", dir, e)
            self._failed = True

    def append(self, snapshot: Dict) -> None:
        """Stamp and persist one snapshot.  Never raises — an unwritable
        blackbox logs once and goes quiet."""
        if self._failed:
            return
        rec = dict(snapshot)
        rec["t_wall"] = time.time()
        rec["t_mono"] = time.monotonic()
        # the ring's own write count rides along INSIDE each snapshot, so
        # a tail of a rotated-away ring still knows how much history the
        # process ever produced
        counter = self.metrics.counter(metrics_mod.BLACKBOX_SNAPSHOTS)
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError) as e:  # pragma: no cover
            log.warning("blackbox snapshot not serializable: %s", e)
            return
        with self._lock:
            try:
                with open(self._path, "a") as f:
                    f.write(line + "\n")
                    f.flush()
                counter.increment()
                if os.path.getsize(self._path) >= self.max_segment_bytes:
                    self._rotate()
            except OSError as e:
                log.warning("blackbox write failed (%s); disabling", e)
                self._failed = True

    def _rotate(self) -> None:
        """Atomically move the live segment into the numbered ring and
        unlink the oldest segment past the bound.  Caller holds _lock."""
        self._seq += 1
        base, ext = os.path.splitext(self._path)
        os.replace(self._path, f"{base}.{self._seq}{ext}")
        drop = self._seq - (self.max_segments - 1)
        if drop >= 1:
            try:
                os.unlink(f"{base}.{drop}{ext}")
            except OSError:  # pragma: no cover - already gone
                pass

    def close(self) -> None:  # symmetry with probe.stop(); nothing held open
        pass


# -- post-mortem readers (CLI) -------------------------------------------------


def _segments(dir: str) -> List[str]:
    """Every blackbox segment in dir, oldest-first per process (rotated
    seqs ascending, then the live segment)."""
    try:
        names = os.listdir(dir)
    except OSError:
        return []
    found: List[Tuple[str, int, float, str]] = []
    for name in names:
        m = _SEG_RE.match(name)
        if m is None:
            continue
        seq = int(m.group("seq")) if m.group("seq") else sys.maxsize
        found.append((m.group("service"), int(m.group("pid")), seq,
                      os.path.join(dir, name)))
    found.sort()
    return [path for _, _, _, path in found]


def read_records(dir: str) -> List[Dict]:
    """All parseable snapshots from every segment of every process,
    ordered by wall time.  Torn final lines (crash mid-write) skip."""
    records: List[Dict] = []
    for path in _segments(dir):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue  # torn write: the crash-survival contract
        except OSError:
            continue
    records.sort(key=lambda r: r.get("t_wall", 0.0))
    return records


def summarize(records: Iterable[Dict]) -> Dict:
    """Span, round cursor travel, and Theil–Sen slopes of the watched
    resource series — the one-screen post-mortem answer."""
    recs = list(records)
    if not recs:
        return {"snapshots": 0}
    out: Dict = {
        "snapshots": len(recs),
        "span_s": recs[-1].get("t_wall", 0.0) - recs[0].get("t_wall", 0.0),
        "first_round": recs[0].get("round", 0),
        "last_round": recs[-1].get("round", 0),
        "slopes_per_s": {},
        "last": recs[-1].get("resources", {}),
    }
    from distributed_sgd_tpu_torch.telemetry import slope as slope_mod

    for key in (metrics_mod.PROC_RSS, metrics_mod.PROC_FDS,
                metrics_mod.PROC_THREADS):
        ts, vs = [], []
        for r in recs:
            v = r.get("resources", {}).get(key)
            if v is not None:
                ts.append(float(r.get("t_wall", 0.0)))
                vs.append(float(v))
        if len(ts) >= 2:
            s = slope_mod.theil_sen(ts, vs)
            if s == s:
                out["slopes_per_s"][key] = s
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_sgd_tpu_torch.telemetry.blackbox",
        description="Read a dead process's blackbox ring.")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, help_ in (("tail", "print the newest N snapshots"),
                        ("merge", "print every snapshot, time-ordered"),
                        ("summary", "span, rounds, and leak slopes")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("dir", help="DSGD_BLACKBOX_DIR to read")
        if name == "tail":
            sp.add_argument("-n", type=int, default=10,
                            help="snapshots to print (default 10)")
    args = p.parse_args(argv)
    records = read_records(args.dir)
    if args.cmd == "tail":
        for rec in records[-max(args.n, 0):]:
            print(json.dumps(rec))
    elif args.cmd == "merge":
        for rec in records:
            print(json.dumps(rec))
    else:
        print(json.dumps(summarize(records), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess test
    sys.exit(main())
