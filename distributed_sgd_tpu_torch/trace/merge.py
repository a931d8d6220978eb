"""Collate per-process trace files into one openable timeline.

The port's own copy of the JAX package's trace/merge.py: it merges the
files of both packages alike (one format).

Each traced process writes ``trace-<service>-<pid>.json`` under
``DSGD_TRACE_DIR`` (trace/__init__.py).  This tool merges them into a
single Chrome/Perfetto trace-event JSON — every record carries
``args.trace_id``, so a multi-process round (master window + worker
server spans + serving calls) lands on one coherent timeline; node
identity renders as one ``pid`` lane per node.

Usage:

    python -m distributed_sgd_tpu_torch.trace.merge [DIR] [-o OUT]
        [--trace-id ID] [--list] [--profile-dir DIR]

- ``DIR``            directory of trace-*.json files (default:
                     $DSGD_TRACE_DIR, else ".")
- ``-o OUT``         output path (default: DIR/merged-trace.json)
- ``--trace-id ID``  keep only one trace (one round end to end); metadata
                     records are always kept so lanes stay named
- ``--list``         print the distinct trace ids (with span counts and
                     root span names) instead of writing a merge
- ``--profile-dir``  correlate with a profiler capture
                     (DSGD_PROFILE_DIR): the ``*.trace.json``
                     and ``*.trace.json.gz`` files found there are listed and
                     recorded in the merged file's ``otherData`` so the
                     two timelines can be opened side by side in Perfetto

Open the result at https://ui.perfetto.dev (or chrome://tracing).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_events(path: str) -> List[dict]:
    """One trace file -> its event list (accepts both the wrapped
    {"traceEvents": [...]} object form and a bare JSON array)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return list(data.get("traceEvents", []))
    return list(data)


def trace_files(dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(dir, "trace-*.json")))


def merge_paths(paths: List[str], trace_id: Optional[str] = None) -> dict:
    """Concatenate + time-sort the given files' events; with `trace_id`,
    keep only that trace's records (plus 'M' metadata, which carries the
    process-name lanes)."""
    events: List[dict] = []
    for p in paths:
        events.extend(read_events(p))
    if trace_id is not None:
        events = [e for e in events
                  if e.get("ph") == "M"
                  or e.get("args", {}).get("trace_id") == trace_id]
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("ph") != "M"))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"sources": paths}}


def merge_dir(dir: str, trace_id: Optional[str] = None) -> dict:
    return merge_paths(trace_files(dir), trace_id=trace_id)


def list_traces(events: List[dict]) -> Dict[str, dict]:
    """trace_id -> {spans, events, roots} summary."""
    out: Dict[str, dict] = {}
    for e in events:
        tid = e.get("args", {}).get("trace_id")
        if tid is None:
            continue
        entry = out.setdefault(tid, {"spans": 0, "events": 0, "roots": set()})
        if e.get("ph") == "X":
            entry["spans"] += 1
            if not e.get("args", {}).get("parent_id"):
                entry["roots"].add(e.get("name", "?"))
        elif e.get("ph") == "i":
            entry["events"] += 1
    return out


def profile_captures(profile_dir: str) -> List[str]:
    """Profiler output files worth opening next to the merge: the port's
    torch.profiler Chrome traces (and a JAX capture's files)."""
    pats = ("**/*.trace.json", "**/*.trace.json.gz", "**/*.xplane.pb")
    found: List[str] = []
    for pat in pats:
        found.extend(glob.glob(os.path.join(profile_dir, pat), recursive=True))
    return sorted(found)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_sgd_tpu_torch.trace.merge",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dir", nargs="?",
                    default=os.environ.get("DSGD_TRACE_DIR", "."))
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--trace-id", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--profile-dir",
                    default=os.environ.get("DSGD_PROFILE_DIR"))
    args = ap.parse_args(argv)

    paths = trace_files(args.dir)
    if not paths:
        log(f"no trace-*.json files under {args.dir!r} "
            f"(run with DSGD_TRACE=1 and DSGD_TRACE_DIR set)")
        return 1
    merged = merge_paths(paths, trace_id=args.trace_id)
    log(f"{len(paths)} file(s), {len(merged['traceEvents'])} event(s)"
        + (f" for trace {args.trace_id}" if args.trace_id else ""))

    if args.list:
        for tid, info in sorted(list_traces(merged["traceEvents"]).items()):
            roots = ",".join(sorted(info["roots"])) or "?"
            print(f"{tid}  spans={info['spans']} events={info['events']} "
                  f"root={roots}")
        return 0

    if args.profile_dir:
        captures = profile_captures(args.profile_dir)
        merged["otherData"]["profile_captures"] = captures
        if captures:
            log(f"profiler captures to open alongside "
                f"({len(captures)}): " + ", ".join(captures[:4])
                + (" ..." if len(captures) > 4 else ""))
        else:
            log(f"no profiler captures under {args.profile_dir!r}")

    out = args.out or os.path.join(args.dir, "merged-trace.json")
    with open(out, "w") as f:
        json.dump(merged, f)
    log(f"wrote {out} — open it at https://ui.perfetto.dev")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
