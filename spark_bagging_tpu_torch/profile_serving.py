"""Where a served single-row request's time goes, on one NVIDIA GPU.

    python -m spark_bagging_tpu_torch.profile_serving
        [--concurrency C [C ...]] [--requests N] [--out DIR]
        (default: 4, 3200, .)

Fits chip_smoke.py's headline logistic bag (256 replicas, one pooled
Newton step, on the 581,012 x 54 synthetic covtype), registers it on
the bench ladder (1..256 rows, 9 buckets, captured at warm-up) and
keeps ``C`` single-row requests in flight through
``MicroBatcher(max_delay_ms=0.5, max_batch_rows=256)``, as chip_smoke.py's
``serving_latency`` phase does. For each ``C``, on a new batcher, one
warm run is discarded, then:

- one run without the profiler that keeps no future (rows/s, p50/p99);
- one run without the profiler: rows/s, p50/p99, and each request's
  ``future.trace.breakdown`` (time queued before its batch was claimed,
  the batch's forward, the rest of the batch: scatter and delivery) and
  the client's latency beyond it (the future's wake-up), as means and
  medians, with the batch sizes and paths (direct or coalesced); and,
  over the coalesced batches, the spread of their requests' arrivals
  (the dispatcher's submits) and the wait of the last to arrive (the
  worker's linger on an empty queue and its wake-up);
- one run under ``torch.profiler``: the device-busy seconds and idle
  share, the graph replays, the device time of their kernels, and the
  host time of the runtime calls around each replay.

Prints one JSON line; the ``key_averages`` tables go to
``DIR/profile_serving_<C>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as np
import torch

from spark_bagging_tpu_torch.profile_fit import _busy_seconds

#: host runtime calls of one served slab (copy in, replay, copy out, sync)
RUNTIME_CALLS = ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaEventRecord",
                 "cudaEventSynchronize")


def run_window(X: np.ndarray, window: int, n_requests: int, submit,
               keep: bool = True):
    """Keep ``window`` single-row futures in flight until ``n_requests``
    resolved. Returns (wall seconds, [(client latency s, future)]); the
    futures' breakdowns are read after the run. ``keep=False`` keeps no
    future (as chip_smoke.py's run does), only the latencies."""
    rng = np.random.default_rng(0)
    pending, done_rows = {}, []

    def one():
        i = int(rng.integers(0, X.shape[0]))
        pending[submit(X[i:i + 1])] = time.perf_counter()

    t0 = time.perf_counter()
    for _ in range(min(window, n_requests)):
        one()
    issued = min(window, n_requests)
    while pending:
        done = [f for f in pending if f.done()]
        if not done:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
        now = time.perf_counter()
        for f in done:
            f.result()
            done_rows.append((now - pending.pop(f), f if keep else None))
            if issued < n_requests:
                one()
                issued += 1
    return time.perf_counter() - t0, done_rows


def summarize(wall: float, rows: list) -> dict:
    lat = sorted(r[0] * 1e3 for r in rows)
    bds = [r[1].trace.breakdown for r in rows]
    batches = {}
    for b in bds:
        if b["path"] == "coalesced":
            batches.setdefault(b["batch_trace_id"], []).append(b["queue_ms"])

    def stat(vals):
        return {"mean": statistics.fmean(vals),
                "median": statistics.median(vals)}

    return {
        "rows_per_sec": len(rows) / wall,
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, round(0.99 * (len(lat) - 1)))],
        "queue_ms": stat([b["queue_ms"] for b in bds]),
        "forward_ms": stat([b["forward_ms"] for b in bds]),
        "batch_rest_ms": stat([b["batch_ms"] - b["forward_ms"]
                               for b in bds]),
        "wakeup_ms": stat([r[0] * 1e3 - b["total_ms"]
                           for r, b in zip(rows, bds)]),
        "batch_size": stat([b["batch_size"] for b in bds]),
        "arrival_spread_ms": (stat([max(q) - min(q)
                                    for q in batches.values()])
                              if batches else None),
        "last_arrival_wait_ms": (stat([min(q) for q in batches.values()])
                                 if batches else None),
        "paths": {p: sum(1 for b in bds if b["path"] == p)
                  for p in sorted({b["path"] for b in bds})},
    }


def profile_level(ex, Xs, concurrency: int, n_requests: int,
                  out: str) -> dict:
    """One concurrency level on a new batcher: a warm run, an
    unprofiled run and a profiled one."""
    from torch.profiler import ProfilerActivity, profile

    from spark_bagging_tpu_torch.serving import MicroBatcher

    with MicroBatcher(ex, max_delay_ms=0.5, max_batch_rows=256) as b:
        run_window(Xs, concurrency, n_requests, b.submit)
        wall, rows = run_window(Xs, concurrency, n_requests, b.submit,
                                keep=False)
        lat = sorted(r[0] * 1e3 for r in rows)
        bare = {"rows_per_sec": len(rows) / wall,
                "p50_ms": lat[len(lat) // 2],
                "p99_ms": lat[round(0.99 * (len(lat) - 1))]}
        plain = summarize(*run_window(Xs, concurrency, n_requests,
                                      b.submit))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, rows = run_window(Xs, concurrency, n_requests, b.submit)
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    busy = _busy_seconds(prof.events())
    host = {ev.key: {"calls": ev.count,
                     "mean_us": ev.cpu_time_total / max(1, ev.count)}
            for ev in averages if ev.key in RUNTIME_CALLS}
    kernels = sum(ev.self_device_time_total for ev in averages
                  if ev.device_type == cuda) / 1e6
    replays = host.get("cudaGraphLaunch", {}).get("calls", 0)
    with open(os.path.join(out, f"profile_serving_{concurrency}.txt"),
              "w") as f:
        f.write(averages.table(sort_by="cpu_time_total", row_limit=60))
    return {
        "concurrency": concurrency,
        "unprofiled_futures_dropped": bare,
        "unprofiled": plain,
        "profiled": {
            **summarize(wall, rows),
            "wall_seconds": wall,
            "device_busy_seconds": busy,
            "idle_share": 1.0 - busy / wall,
            "graph_replays": replays,
            "kernel_ms_per_replay": (1e3 * kernels / replays
                                     if replays else None),
            "runtime_calls": host,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--concurrency", type=int, nargs="+", default=[4])
    p.add_argument("--requests", type=int, default=3_200)
    p.add_argument("--out", default=".")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.serving import ModelRegistry
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_covtype(581_012)
    X = datasets.standardize(X)
    clf = BaggingClassifier(
        LogisticRegression(max_iter=1, init="pooled", hessian_impl="pallas",
                           precision="highest"),
        n_estimators=256, seed=0,
    ).fit(X, y)
    Xs = X[:100_000]
    ex = ModelRegistry().register("m", clf, warmup=True, min_bucket_rows=1,
                                  max_batch_rows=256)
    os.makedirs(args.out, exist_ok=True)
    print(json.dumps({
        "requests": args.requests,
        "levels": [profile_level(ex, Xs, c, args.requests, args.out)
                   for c in args.concurrency],
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
