"""The device trace of a run's window, read from one torch.profiler session.

The session is the process's first (a later session on this host has
been seen to lose its device events), opened for the window's last part
(harness.Window) and closed just after the window.  It records the
card's activity and the CUDA runtime's calls, not every torch operator
on the host: recording those slowed the sync cell's host-paced window
2.6-fold.  An idle gap is
named by the device operation that ends it, the one the host was
preparing to launch.  The events are read from the profiler's own result
list, not through a Chrome trace file, so that nothing is written to
disk.  A trace with no device event is an error, never a zero.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10  # entries of each breakdown list
NAME_CHARS = 160


class NoDeviceEvents(RuntimeError):
    pass


def start() -> torch.profiler.profile:
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, device seconds)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    n_device_events: int = 0

    def kernel_matching(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds `part`."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if part in name:
                n, s = n + k, s + t
        return n, s

    def kernels_not_matching(self, part: str) -> int:
        return sum(k for name, (k, _) in self.kernels.items() if part not in name)


def _device_kind(ev) -> Optional[str]:
    """'kernel', 'gpu_memcpy' or 'gpu_memset' for an operation of the card,
    None for the host's events and the card's ranges of host annotations.
    Told by device and name: torch 2.11's events carry no activity type."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.is_user_annotation():
        return None
    name = ev.name()
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


def _span_ns(ev) -> Tuple[int, int]:
    start = int(ev.start_ns())
    return start, start + int(ev.duration_ns())


def union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered length, idle gaps) of [lo, hi] under the sorted intervals."""
    busy, end, gaps = 0, lo, []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        busy += max(0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def short(name: str) -> str:
    """A device operation's name cut to NAME_CHARS characters."""
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(prof: torch.profiler.profile, lo_ns: int, hi_ns: int) -> Summary:
    """The device's busy time within [lo_ns, hi_ns] of the host's wall
    clock (``time.time_ns``), which the profiler's timestamps follow; the
    kernels by name,
    the device operations that took most time, and the idle time by the
    device operation that ended each gap."""
    events = prof.profiler.kineto_results.events()
    device: List[Tuple[int, int, str, str]] = []
    lo, hi = lo_ns, hi_ns
    for ev in events:
        kind = _device_kind(ev)
        if kind is not None:
            device.append((*_span_ns(ev), ev.name(), kind))
    inside = [e for e in device if e[1] > lo and e[0] < hi]
    if not inside:
        raise NoDeviceEvents(f"the trace holds {len(events)} events, {len(device)} on the "
                             f"device, and none in the window")
    if len(inside) < 0.9 * len(device):
        raise NoDeviceEvents(f"{len(device) - len(inside)} of the trace's {len(device)} device "
                             f"events lie outside the window: the clocks disagree")
    device = inside
    device.sort()
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    op_time: Dict[str, float] = defaultdict(float)
    for a, b, name, kind in device:
        op_time[name] += (b - a) / 1e9
        if kind == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += (b - a) / 1e9
    busy, gaps = union([(a, b) for a, b, _, _ in device], lo, hi)
    starts = [e[0] for e in device]
    by_next: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        k = bisect.bisect_left(starts, b)
        label = f"before {short(device[k][2])}" if k < len(device) else "after the last"
        by_next[label] += (b - a) / 1e9
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                   kernels={k: (int(v[0]), float(v[1])) for k, v in kernels.items()},
                   device_ops=[(short(k), v) for k, v in top(op_time)],
                   idle_gaps=top(by_next),
                   n_device_events=len(device))
