"""Do torch.profiler sessions in one process keep their kernel records?

    python -m distributed_sgd_tpu_torch.tools.profiler_sessions [--gap SECONDS]

On the card, in this fresh process: three ``torch.profiler`` sessions,
each over one ``sync_epoch`` launch (K=3, B=100 on 30,000 RCV1-shaped
rows at D=47,236): two back to back, then one after the process has run
on for ``--gap`` seconds (``GAP_S`` by default; 0: no late session).
Prints one JSON line with, for each session, its ``sync_epoch`` kernel
events, its device events, and how far the
kernel's timestamp lies from its launch's (milliseconds; both as the
trace reports them, the kernel's converted from the card's clock).
Exits 1 if either back-to-back session holds no ``sync_epoch`` kernel
event; the late session is printed whatever it holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

GAP_S = 12.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gap", type=float, default=GAP_S)
    gap = ap.parse_args().gap
    import torch

    from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity
    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.models.linear import make_model
    from distributed_sgd_tpu_torch.ops import sync_epoch as se
    from distributed_sgd_tpu_torch.parallel.sync import SyncEngine

    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device", file=sys.stderr)
        return 1
    data = rcv1_like(30000, seed=11, idf_values=True)
    model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(data),
                       device="cuda")
    bound = SyncEngine(model, 100, 0.5, virtual_workers=3, device="cuda").bind(data)
    w = torch.zeros(data.n_features, device="cuda")
    bound.epoch(w, 0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def session(key: int) -> dict:
        launches = se.sync_epoch.launches
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            bound.epoch(w, key)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        device = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        kernels = [e for e in device if "sync_epoch" in e.get("name", "")]
        launch_ts = {e.get("args", {}).get("correlation"): float(e["ts"]) for e in events
                     if e.get("cat") == "cuda_runtime"}
        offset = None
        if kernels:
            launched = launch_ts.get(kernels[0].get("args", {}).get("correlation"))
            if launched is not None:
                offset = (float(kernels[0]["ts"]) - launched) / 1e3
        return {"launches": se.sync_epoch.launches - launches, "sync_epoch_events": len(kernels),
                "device_events": len(device), "kernel_minus_launch_ms": offset,
                "session_s": round(seconds, 3)}

    t_start = time.perf_counter()
    sessions = [dict(session(1), at_s=0.0)]
    sessions.append(dict(session(2), at_s=round(time.perf_counter() - t_start, 3)))
    if gap > 0:
        time.sleep(gap)
        sessions.append(dict(session(3), at_s=round(time.perf_counter() - t_start, 3)))
    held = all(s["sync_epoch_events"] == 1 for s in sessions[:2])
    print(json.dumps({"profiler_sessions": sessions, "back_to_back_held": held,
                      "after_gap_held": sessions[2]["sync_epoch_events"] == 1 if gap > 0
                      else None}), flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    raise SystemExit(main())
