"""Where the device time of an ensemble's fit goes, on one NVIDIA GPU.

    python -m spark_bagging_tpu_torch.profile_fit
        [--learner logistic|tree|linear|rf-reg|gbt] [--n-replicas R]
        [--out DIR]   (default: .)

Fits one of chip_smoke.py's ensembles once to warm up, then once under
``torch.profiler``:

- ``logistic`` (default): Newton logistic regression, pooled start, one
  step, scaled-Gram kernel; 256 replicas on the 581,012 x 54 synthetic
  covtype;
- ``tree``: BASELINE config 3, depth-5 32-bin Gini trees on 80% feature
  subspaces, hard vote, histogram kernel; 256 replicas, same data;
- ``linear``: BASELINE config 2, ``BaggingRegressor(LinearRegression(
  l2=1e-4))``, 100 replicas on the training 80% of the 20,640 x 8
  synthetic California housing;
- ``rf-reg``: ``RandomForestRegressor(max_depth=5)``, 128 replicas
  (config 6's shape), same data; the histogram kernel's float
  accumulator;
- ``gbt``: BASELINE config 7, ``BaggingClassifier(GBTClassifier(
  n_rounds=30, max_depth=4))``, 32 replicas on the 800,000 x 28
  training split of the standardized 1M-row synthetic HIGGS; the float
  accumulator at every level of every round.

Prints one JSON line: the fit's wall seconds, the device-busy seconds,
the idle share, and device time by kernel (the top entries, with their
share of busy time). The full ``key_averages`` table is written to
``DIR/profile_fit_<learner>.txt``.
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
    p.add_argument("--learner", default="logistic",
                   choices=("logistic", "tree", "linear", "rf-reg", "gbt"))
    p.add_argument("--out", default=".")
    p.add_argument("--n-replicas", type=int, default=None,
                   help="default: 256, 256, 100, 128, 32 by learner")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        BaggingRegressor,
        DecisionTreeClassifier,
        GBTClassifier,
        LinearRegression,
        LogisticRegression,
        RandomForestRegressor,
    )
    from spark_bagging_tpu_torch.utils import datasets

    R = args.n_replicas or {"linear": 100, "rf-reg": 128,
                            "gbt": 32}.get(args.learner, 256)
    if args.learner in ("linear", "rf-reg"):
        X, y = datasets.synthetic_california(20_640)
        X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
    elif args.learner == "gbt":
        X, y = datasets.synthetic_higgs(1_000_000)
        X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
    else:
        X, y = datasets.synthetic_covtype(581_012)
        X = datasets.standardize(X)
    if args.learner == "tree":
        clf = BaggingClassifier(
            DecisionTreeClassifier(max_depth=5, n_bins=32),
            n_estimators=R, max_features=0.8, voting="hard", seed=0,
        )
    elif args.learner == "linear":
        clf = BaggingRegressor(LinearRegression(l2=1e-4), n_estimators=R,
                               seed=0)
    elif args.learner == "rf-reg":
        clf = RandomForestRegressor(n_estimators=R, max_depth=5, seed=0)
    elif args.learner == "gbt":
        clf = BaggingClassifier(GBTClassifier(n_rounds=30, max_depth=4),
                                n_estimators=R, seed=0)
    else:
        clf = BaggingClassifier(
            LogisticRegression(max_iter=1, init="pooled",
                               hessian_impl="pallas", precision="highest"),
            n_estimators=R, seed=0,
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
    with open(os.path.join(args.out, f"profile_fit_{args.learner}.txt"),
              "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({
        "learner": args.learner,
        "n_replicas": R,
        "device": torch.cuda.get_device_name(0),
        "chunk_size": clf.fit_report_["chunk_size_resolved"],
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
