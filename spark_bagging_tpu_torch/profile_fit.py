"""Where the device time of an ensemble's fit goes, on one NVIDIA GPU.

    python -m spark_bagging_tpu_torch.profile_fit
        [--learner logistic|tree|linear|rf-reg|gbt|mlp-stream|tree-stream|
                   svm|nb|glm|fm|isotonic|aft|logistic-adam]
        [--n-replicas R] [--n-rows N] [--out DIR]   (default: .)

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
  accumulator at every level of every round;
- ``mlp-stream``: BASELINE config 4, ``BaggingClassifier(MLPClassifier(
  hidden=32, lr=0.01))`` ``fit_stream`` over synthetic HIGGS chunks of
  20,000 rows (one epoch, 2 Adam steps a chunk), 512 replicas;
  ``--n-rows`` cuts the stream (default the config's 11,000,000);
- ``tree-stream``: config 3's learner ``fit_stream``-ed over the covtype
  rows in 65,536-row chunks (7 passes), 256 replicas;
- the rest of the learner zoo, as chip_smoke.py fits them: on the
  covtype rows ``svm`` (``LinearSVC(max_iter=8)``, 256 replicas), ``nb``
  (``GaussianNB()``, 256), ``fm`` (``FMClassifier(factor_size=8,
  max_iter=100)``, 64) and ``logistic-adam`` (``LogisticRegression(
  solver="adam", max_iter=100)``, 64); on the California split ``glm``
  (``GeneralizedLinearRegression(family="poisson")`` on ``y /
  mean(y)``), ``isotonic`` (``IsotonicRegression(n_bins=128)``) and
  ``aft`` (``AFTSurvivalRegression()`` with 20% of rows censored
  through ``aux``), 100 replicas each.

Prints one JSON line: the fit's wall seconds, the device-busy seconds,
the idle share, the device time of the bootstrap draws (each
``bootstrap_weights`` call opens a profiler range) and device time by
kernel (the top entries, with their share of busy time). The full
``key_averages`` table is written to ``DIR/profile_fit_<learner>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from spark_bagging_tpu_torch.ops.bootstrap import DRAW_RANGE

TOP = 12


def _is_device_op(e) -> bool:
    """A kernel or copy on the device. A profiler range (a span of the
    program, an ops range such as ``DRAW_RANGE``) also appears on the
    device, as a user annotation spanning its kernels, and is not one."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation)


def _busy_seconds(events) -> float:
    """Union of the device operations' [start, end) intervals, seconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if _is_device_op(e)
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


def profile_device(fit, table_path: str | None = None) -> dict:
    """Run ``fit()`` once under ``torch.profiler`` (warm it up first):
    its wall seconds, the device-busy seconds, the idle share, the
    device time of the bootstrap draws (``ops/bootstrap.bootstrap_weights``
    opens the ``DRAW_RANGE`` range) and the top kernels by device time.
    Writes the full ``key_averages`` table to ``table_path`` if given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_seconds(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    draws = {ev.device_type == cuda: ev.device_time_total / 1e6
             for ev in averages if ev.key == DRAW_RANGE}
    # device operations only: a CPU op's device time repeats its kernels'
    rows = sorted(((ev.self_device_time_total / 1e6, ev.count, ev.key)
                   for ev in averages if _is_device_op(ev)), reverse=True)
    total_dev = sum(r[0] for r in rows)
    if table_path is not None:
        with open(table_path, "w") as f:
            f.write(averages.table(sort_by="self_device_time_total",
                                   row_limit=60))
    return {
        "fit_wall_seconds": wall,
        "device_busy_seconds": busy,
        "idle_share": 1.0 - busy / wall,
        # the draws' kernels' device time (the host range's), and the
        # device range's span, which also holds the gaps between them
        "bootstrap_device_seconds": draws.get(False),
        "bootstrap_share_of_busy": (draws[False] / busy
                                    if draws.get(False) and busy > 0
                                    else None),
        "bootstrap_range_seconds": draws.get(True),
        "kernel_seconds_total": total_dev,
        "top": [{"name": k[:80], "seconds": s, "calls": c,
                 "share_of_kernel_time": s / total_dev}
                for s, c, k in rows[:TOP]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--learner", default="logistic",
                   choices=("logistic", "tree", "linear", "rf-reg", "gbt",
                            "mlp-stream", "tree-stream", "svm", "nb", "glm",
                            "fm", "isotonic", "aft", "logistic-adam"))
    p.add_argument("--out", default=".")
    p.add_argument("--n-replicas", type=int, default=None,
                   help="default: 256, 256, 100, 128, 32, 512, 256, 256, "
                        "256, 100, 64, 100, 100, 64 by learner")
    p.add_argument("--n-rows", type=int, default=11_000_000,
                   help="mlp-stream: the stream's rows")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BaggingClassifier,
        BaggingRegressor,
        DecisionTreeClassifier,
        FMClassifier,
        GaussianNB,
        GBTClassifier,
        GeneralizedLinearRegression,
        IsotonicRegression,
        LinearRegression,
        LinearSVC,
        LogisticRegression,
        MLPClassifier,
        RandomForestRegressor,
    )
    from spark_bagging_tpu_torch.utils import datasets
    from spark_bagging_tpu_torch.utils.io import ArrayChunks, SyntheticChunks

    regressors = ("linear", "rf-reg", "glm", "isotonic", "aft")
    R = args.n_replicas or {"linear": 100, "rf-reg": 128, "gbt": 32,
                            "mlp-stream": 512, "glm": 100, "isotonic": 100,
                            "aft": 100, "fm": 64,
                            "logistic-adam": 64}.get(args.learner, 256)
    n_rows = None
    fit_kw = {}
    if args.learner == "mlp-stream":
        n_rows = args.n_rows
    elif args.learner in regressors:
        X, y = datasets.synthetic_california(20_640)
        X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
        if args.learner == "glm":
            y = (y / y.mean()).astype(np.float32)
        elif args.learner == "aft":
            rng = np.random.default_rng(0)
            fit_kw = {"aux": (rng.random(len(y)) > 0.2).astype(np.float32)}
    elif args.learner == "gbt":
        X, y = datasets.synthetic_higgs(1_000_000)
        X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
    else:
        X, y = datasets.synthetic_covtype(581_012)
        X = datasets.standardize(X)
    if args.learner == "mlp-stream":
        clf = BaggingClassifier(MLPClassifier(hidden=32, lr=0.01),
                                n_estimators=R, seed=0)
    elif args.learner in ("tree", "tree-stream"):
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
    elif args.learner in ("svm", "nb", "fm", "logistic-adam"):
        clf = BaggingClassifier({
            "svm": LinearSVC(max_iter=8),
            "nb": GaussianNB(),
            "fm": FMClassifier(factor_size=8, max_iter=100),
            "logistic-adam": LogisticRegression(solver="adam", max_iter=100),
        }[args.learner], n_estimators=R, seed=0)
    elif args.learner in ("glm", "isotonic", "aft"):
        clf = BaggingRegressor({
            "glm": GeneralizedLinearRegression(family="poisson"),
            "isotonic": IsotonicRegression(n_bins=128),
            "aft": AFTSurvivalRegression(),
        }[args.learner], n_estimators=R, seed=0)
        if args.learner == "aft":
            y = np.exp(y / y.std()).astype(np.float32)  # survival times
    else:
        clf = BaggingClassifier(
            LogisticRegression(max_iter=1, init="pooled",
                               hessian_impl="pallas", precision="highest"),
            n_estimators=R, seed=0,
        )

    def fit():
        if args.learner == "mlp-stream":
            clf.fit_stream(
                SyntheticChunks(datasets.synthetic_higgs, n_rows, 20_000,
                                seed=11),
                classes=[0, 1], n_epochs=1, steps_per_chunk=2, lr=0.01)
        elif args.learner == "tree-stream":
            clf.fit_stream(ArrayChunks(X, y, 65_536), classes=np.unique(y))
        else:
            clf.fit(X, y, **fit_kw)

    fit()  # warm-up: kernel build, allocator, cuBLAS handles
    os.makedirs(args.out, exist_ok=True)
    prof = profile_device(fit, os.path.join(
        args.out, f"profile_fit_{args.learner}.txt"))
    print(json.dumps({
        "learner": args.learner,
        "n_replicas": R,
        "n_rows": n_rows or len(y),
        "device": torch.cuda.get_device_name(0),
        "chunk_size": clf.fit_report_["chunk_size_resolved"],
        "fit_wall_seconds": prof.pop("fit_wall_seconds"),
        "fit_report_seconds": clf.fit_report_["fit_seconds"],
        **prof,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
