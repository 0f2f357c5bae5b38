"""Where the device time of the headline fit goes, on one NVIDIA GPU.

    python -m spark_bagging_tpu_torch.profile_fit [--out DIR]   (default: .)

Fits the headline ensemble (chip_smoke.py's fit phase: 256 replicas of
Newton logistic regression, pooled start, one step, scaled-Gram kernel,
on the 581,012 x 54 synthetic covtype) once to warm up, then once under
``torch.profiler``. Prints one JSON line: the fit's wall seconds, the
device-busy seconds, the idle share, and device time by kernel (the top
entries, with their share of busy time). The full ``key_averages``
table is written to ``DIR/profile_fit.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

TOP = 12


def _busy_seconds(events) -> float:
    """Union of the device kernels' [start, end) intervals, seconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6  # microseconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=".")
    p.add_argument("--n-replicas", type=int, default=256)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.utils.datasets import synthetic_covtype

    X, y = synthetic_covtype(581_012)
    X = ((X - X.mean(0)) / (X.std(0) + 1e-8)).astype(np.float32)
    clf = BaggingClassifier(
        LogisticRegression(max_iter=1, init="pooled", hessian_impl="pallas",
                           precision="highest"),
        n_estimators=args.n_replicas, seed=0,
    )
    clf.fit(X, y)  # warm-up: kernel build, allocator, cuBLAS handles
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_seconds(prof.events())
    rows = []
    for ev in prof.key_averages():
        # device kernels only: a CPU op's device time repeats its kernels'
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.self_device_time_total / 1e6, ev.count, ev.key))
    rows.sort(reverse=True)
    total_dev = sum(r[0] for r in rows)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_fit.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "fit_wall_seconds": wall,
        "fit_report_seconds": clf.fit_report_["fit_seconds"],
        "device_busy_seconds": busy,
        "idle_share": 1.0 - busy / wall,
        "kernel_seconds_total": total_dev,
        "top": [{"name": k[:80], "seconds": s, "calls": c,
                 "share_of_kernel_time": s / total_dev}
                for s, c, k in rows[:TOP]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
