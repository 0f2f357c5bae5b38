"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``spark_bagging_tpu_torch/csrc``,
then drives the port's two paths through the estimator a user calls,
on the full 581,012 x 54 synthetic covtype:

- logistic regression: a bagged damped-Newton fit (256 replicas, pooled
  warm start, scaled-Gram kernel) and a warm soft-vote
  ``predict_proba``; the kernel held against its plain torch version at
  every replica count the fit launched it with, on the fit's kind of
  data and on exact inputs; the kernel Hessian cross-checked against
  the plain "blocked" one;
- bagged decision trees (BASELINE config 3: depth 5, 32 bins, 256
  replicas, 43 of 54 features each, hard vote): the fit, which bins the
  shared X once (bin-codes kernel) and reads the codes through each
  replica's column index at every level (histogram kernel), with no
  per-replica copy of X; a warm ``predict`` / ``predict_proba``; both
  kernels held bit for bit against their plain versions on the fit's
  own inputs, the histogram kernel at every replica count and level the
  fit launched it with, in both operand modes and both accumulators;
  kernel and dense split search cross-checked to give identical trees.

The scaled-Gram kernel is also held against its plain version at
d = 250 (``wide_gram``), and its fp32 mode against a float64 reference
at a shallow and at the capped accumulation depth (``depth``).

Each path runs with every kernel's launch count set to 0 just before it
and read just after. Every phase prints JSON lines; a failed check
exits non-zero. The last lines are the kernel table, the card's name
and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port only (never JAX or the JAX package).
Exits non-zero without a result where CUDA is unavailable.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 581_012          # covtype
N_FEATURES = 54
N_CLASSES = 7
N_REPLICAS = 256
N_SERVE_ROWS = 100_000
N_CROSS_ROWS = 50_000
N_CROSS_REPLICAS = 16
# bench.py's accuracy-parity bar: the cached sklearn LogisticRegression
# accuracy on this data (0.776, bench_baseline_cache.json) minus 0.01
ACC_BAR = 0.766
# kernel vs plain on the fit's data, per entry: |kernel - plain| over
# the entry's absolute-sum scale sum_n |x_i| |x_j s_p| (the plain version
# on |X|, |S|), the scale that fp32 summation error grows with. Both
# sides sum the same fp32 products in other orders; the kernel sums at
# most 16,384 rows in one register. On an H100 (700 W) the sound
# readings at the fit's shapes were 3.2e-6 to 5.7e-6, and the control,
# the bf16 kernel held to the fp32 plain version (a kernel that rounded
# in float32 mode), 2.9e-5 to 5.0e-5: the limit lies between them. The
# exact probe below checks the operand precision with no tolerance.
GRAM_TOL = 1.5e-5
# cross-check: max |W_kernel - W_blocked| / max |W_blocked| after the
# pooled pre-pass and one Newton step; the Gram tolerance above,
# amplified by the damped Hessians' conditioning.
W_REL_TOL = 1e-3
# H100 SXM data-sheet peaks (NVIDIA; dense, no sparsity)
PEAK_FP32 = 67e12     # fp32 on the CUDA cores
PEAK_TF32 = 495e12    # TF32 on the tensor cores
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# the scaled-Gram kernel at the JAX kernel's widest d for C = 7 classes
WIDE_GRAM = dict(n=20_000, d=250, P=28, R=2)
# the Gram error against the rows a block sums: float64 references of
# 4 replicas on the first 2**14 rows (896-row splits) and on all rows
# (splits at the MAX_SPLIT_ROWS cap)
DEPTH_GRAM = dict(R=4, rows=(2**14, N_ROWS))
# the tree path: BASELINE config 3 (benchmarks/run_configs.py)
TREE = dict(max_depth=5, n_bins=32)
TREE_MAX_FEATURES = 0.8
N_TREE_CROSS_REPLICAS = 8
# replicas whose float-statistics histograms are held to the tolerance
N_FLOAT_CHECK_REPLICAS = 8
# histogram kernel vs plain on float statistics (regression moments),
# per entry: |kernel - plain| over the entry's absolute-sum scale (the
# plain version on |S|). Both sum the same float32 terms, the kernel in
# a run-dependent order (shared-memory atomics, then row splits): a sum
# of m terms is off by at most ~m * 2**-24 of its scale, ~1e-6 at the
# rows one block adds into one bin. Integer statistics are held bitwise.
HIST_FLOAT_TOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    sys.exit(1)


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.ops.hist import bin_codes, binned_left_stats

    scaled_grams.launches = 0
    binned_left_stats.launches = 0
    bin_codes.launches = 0


def read_launches() -> dict:
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.ops.hist import bin_codes, binned_left_stats

    return {"scaled_gram": scaled_grams.launches,
            "binned_left_stats": binned_left_stats.launches,
            "bin_codes": bin_codes.launches}


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after one
    warm-up call, between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def headline_data():
    """Standardized synthetic covtype, as benchmarks/headline_data.py
    builds it for bench.py."""
    from spark_bagging_tpu_torch.utils.datasets import synthetic_covtype

    X, y = synthetic_covtype(N_ROWS)
    mu, sigma = X.mean(0), X.std(0) + 1e-8
    return ((X - mu) / sigma).astype(np.float32), y


def phase_env() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("env", ok=True, python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, device=name,
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return name, smi


def sass_atomics(path: str) -> dict | None:
    """Shared-memory atomic instructions of each histogram kernel in the
    built library, by opcode (``cuobjdump -sass``): ``ATOMS.ADD`` is the
    native add, ``ATOMS.CAST.SPIN`` the compare-and-swap loop a float
    add compiles to. None where the toolkit has no cuobjdump."""
    import os
    import re

    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1) if "hist_partial" in m.group(1) else None
            continue
        m = re.search(r"\b(ATOMS[.\w]*)", ln)
        if fn and m:
            # the instantiation: <code type, accumulator type>
            key = re.search(r"hist_partialI(\w)(\w)E", fn)
            name = "hist_partial<{},{}>".format(
                *(dict(h="uint8", s="int16", f="float", i="int")[c]
                  for c in key.groups()))
            per = counts.setdefault(name, {})
            per[m.group(1)] = per.get(m.group(1), 0) + 1
    return counts


def phase_build() -> None:
    from spark_bagging_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.library()
    log = native.build_info.get("log", "")
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         library=native.build_info.get("path"),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln],
         sass_shared_atomics=sass_atomics(native.build_info["path"]))


def kernel_inputs(X: np.ndarray, R: int):
    """The kernel's operands at a shape the fit gives it: X with its bias
    column and the Newton scale matrix S = w p_c (delta - p_c') of R
    replicas at random weights. R = 1 is the pooled pre-pass (unit row
    weights); a replica chunk takes replicas 0..R-1's bootstrap counts."""
    from spark_bagging_tpu_torch.models.base import augment_bias
    from spark_bagging_tpu_torch.models.logistic import _pairs
    from spark_bagging_tpu_torch.ops import prng
    from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights

    dev = torch.device("cuda")
    Xb = augment_bias(torch.as_tensor(X, device=dev)).contiguous()
    n, d = Xb.shape
    ci, cpi = _pairs(N_CLASSES, dev)
    delta = (ci == cpi).float()
    g = torch.Generator(device=dev).manual_seed(R)
    S = torch.empty((R, n, ci.numel()), device=dev)
    for r0 in range(0, R, 16):  # 16 replicas at a time bound the scratch
        rids = torch.arange(r0, min(R, r0 + 16), device=dev)
        w = (torch.ones((1, n), device=dev) if R == 1
             else bootstrap_weights(prng.key(0, dev), rids, n))
        W = 0.1 * torch.randn((rids.numel(), d, N_CLASSES), generator=g,
                              device=dev)
        P = torch.softmax(Xb @ W, dim=-1)
        S[r0:r0 + rids.numel()] = (
            w[..., None] * P[..., ci] * (delta - P[..., cpi]))
    return Xb, S


def probe_inputs(n: int, d: int, P: int, R: int, device: str = "cuda"):
    """Operands on which every fp32 sum is exact in any order, so the
    kernel must equal its plain version bit for bit in both modes. X is
    +-1 (bias column 1). Even pair columns are dense: s = k/16 with
    0 < |k| < 16 on every row, so a lost or doubled row shows; their sums
    stay below 2**20 on a 2**-4 grid (24 bits). Odd pair columns are
    sparse: s = k/1024 with |k| < 1024 on every 64th row; their sums
    stay below 2**14 on a 2**-10 grid, and bf16's 8-bit significand
    rounds most such s, so a kernel that rounded its operands in float32
    mode would differ there."""
    if n >= 2 ** 20:
        raise ValueError(f"n={n}: the probe's sums would not be exact")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(1)
    X = (2 * torch.randint(0, 2, (n, d), generator=g, device=dev) - 1).float()
    X[:, -1] = 1.0
    dense_col = (torch.arange(P, device=dev) % 2 == 0)
    sparse_row = (torch.arange(n, device=dev) % 64 == 0)[:, None]
    S = torch.empty((R, n, P), device=dev)
    for r in range(R):
        mag = torch.randint(1, 16, (n, P), generator=g, device=dev)
        sign = 2 * torch.randint(0, 2, (n, P), generator=g, device=dev) - 1
        fine = torch.randint(-1023, 1024, (n, P), generator=g, device=dev)
        S[r] = torch.where(dense_col, (sign * mag).float() / 16,
                           torch.where(sparse_row, fine.float() / 1024, 0.0))
    return X, S


def entry_errors(out, Xb, S, op_dtype, scale) -> tuple[float, float]:
    """(max |out - plain| / scale, max |out - plain|) over every entry of
    every replica, the plain version computed one replica at a time."""
    from spark_bagging_tpu_torch.ops.gram import scaled_grams_plain

    worst = worst_abs = 0.0
    for r in range(S.shape[0]):
        diff = (out[r] - scaled_grams_plain(Xb, S[r], op_dtype=op_dtype)).abs()
        worst = max(worst, float((diff / scale[r]).max()))
        worst_abs = max(worst_abs, float(diff.max()))
    return worst, worst_abs


def library_ms(Xb, S, op_t) -> float:
    """Device ms of the library yardstick: each replica's Grams as one
    batched cuBLAS ``torch.matmul`` of its (P, d, n) scaled operand with
    X, each call timed alone between CUDA events and the times summed
    over replicas (one call over all R would need an (R, P, d, n)
    operand, 458 GB at R = 128). Forming the operand is not timed."""
    from spark_bagging_tpu_torch.ops.precision import fp32_matmul

    Xo = Xb.to(op_t)
    spans = []
    with fp32_matmul():
        for r in range(-1, S.shape[0]):  # r = -1: an untimed warm-up
            A = (Xb.t()[None] * S[max(r, 0)].t()[:, None, :]).to(op_t)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.matmul(A, Xo)
            stop.record()
            if r >= 0:
                spans.append((start, stop))
            del A
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans)


def phase_kernels(X: np.ndarray, Rs: list[int]) -> dict:
    """The kernel against its plain version at every replica count the
    fit launched it with, in both operand modes, every replica compared,
    with times, bound and library yardstick at each shape."""
    from spark_bagging_tpu_torch.ops.gram import (
        kernel_geometry,
        scaled_grams,
        scaled_grams_plain,
    )

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for R in Rs:
        Xb, S = kernel_inputs(X, R)
        n, d = Xb.shape
        P = S.shape[2]
        geo = kernel_geometry(n, d, P, R, n_sm)
        # the i <= j half of each symmetric Gram, 2 flops per entry
        flops = float(n) * P * d * (d + 1) * R
        nbytes = 4.0 * (n * d + R * n * P + R * P * d * d)
        Xa = Xb.abs()
        scale = torch.stack([scaled_grams_plain(Xa, S[r].abs())
                             for r in range(R)]).clamp_min(1e-30)
        del Xa
        reps = 2 if R > 8 else 5
        rows[R] = {}
        # fp32-accurate work: the fp32 CUDA cores, or 3xTF32 on the
        # tensor cores (three TF32 products each); bf16 on the tensor cores
        t_simt, t_3xtf32 = 1e3 * flops / PEAK_FP32, 3e3 * flops / PEAK_TF32
        t_ops_mode = {"float32": min(t_simt, t_3xtf32),
                      "bfloat16": 1e3 * flops / PEAK_BF16}
        for mode in ("float32", "bfloat16"):
            out = scaled_grams(Xb, S, op_dtype=mode)
            again = scaled_grams(Xb, S, op_dtype=mode)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(out, again))
            del again
            err, abs_err = entry_errors(out, Xb, S, mode, scale)
            extra = {}
            if mode == "bfloat16":
                # control: the bf16 kernel held to the fp32 plain version
                extra["control_err_vs_float32_plain"] = entry_errors(
                    out, Xb, S, "float32", scale)[0]
            else:
                extra.update(bound_fp32_simt_ms=t_simt,
                             bound_3xtf32_ms=t_3xtf32)
            del out
            kernel_ms = cuda_ms(
                lambda: scaled_grams(Xb, S, op_dtype=mode), reps)
            plain_ms = cuda_ms(
                lambda: scaled_grams_plain(Xb, S, op_dtype=mode), 1)
            lib_ms = library_ms(
                Xb, S, torch.float32 if mode == "float32" else torch.bfloat16)
            torch.cuda.empty_cache()
            t_ops, t_bytes = t_ops_mode[mode], 1e3 * nbytes / PEAK_BYTES
            rows[R][mode] = row = dict(
                max_entry_err=err, tol=GRAM_TOL, max_abs_err=abs_err,
                bitwise_repeat=bitwise, kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            )
            emit("kernels", kernel="scaled_gram", op_dtype=mode,
                 shape=dict(n=n, d=d, P=P, R=R),
                 splits=geo["splits"], rows_per_split=geo["rows_per_split"],
                 **row, **extra)
            if not (err <= GRAM_TOL and bitwise):
                fail("kernels", f"scaled_gram {mode} R={R}: entry error "
                     f"{err:.3g} (tol {GRAM_TOL}), bitwise repeat {bitwise}")
        del Xb, S, scale
        torch.cuda.empty_cache()
    return rows


def phase_wide_gram() -> None:
    """The kernel at d = 250, P = 28 (beyond the earlier kernel's d <= 176,
    within the JAX kernel's envelope) against its plain version, in both
    operand modes."""
    from spark_bagging_tpu_torch.ops.gram import scaled_grams, scaled_grams_plain

    n, d, P, R = (WIDE_GRAM[k] for k in ("n", "d", "P", "R"))
    g = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn((n, d), generator=g, device="cuda")
    S = torch.rand((R, n, P), generator=g, device="cuda") * 1.3 - 0.3
    scale = scaled_grams_plain(X.abs(), S.abs()).clamp_min(1e-30)
    errs = {}
    for mode in ("float32", "bfloat16"):
        out = scaled_grams(X, S, op_dtype=mode)
        want = scaled_grams_plain(X, S, op_dtype=mode)
        errs[mode] = float(((out - want).abs() / scale).max())
    ok = all(e <= GRAM_TOL for e in errs.values())
    emit("wide_gram", ok=ok, shape=WIDE_GRAM, max_entry_err=errs, tol=GRAM_TOL)
    if not ok:
        fail("wide_gram", f"entry errors {errs} (tol {GRAM_TOL})")


def phase_depth(X: np.ndarray) -> None:
    """The fp32 kernel's entry error against a float64 reference (the
    same fp32 products x_i * fp32(x_j s) summed in float64) on the first
    rows of the fit's kind of data, at a shallow depth and at the row
    split's depth cap: an accumulation that rounded with a bias would
    grow with the rows a block sums."""
    from spark_bagging_tpu_torch.ops.gram import kernel_geometry, scaled_grams

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    Xb, S = kernel_inputs(X[:max(DEPTH_GRAM["rows"])], DEPTH_GRAM["R"])
    X64 = Xb.double()
    for rows in DEPTH_GRAM["rows"]:
        geo = kernel_geometry(rows, Xb.shape[1], S.shape[2], S.shape[0], n_sm)
        Xr, Sr = Xb[:rows], S[:, :rows].contiguous()
        out = scaled_grams(Xr, Sr)
        worst = 0.0
        for r in range(S.shape[0]):
            want = scale = 0.0
            for t0 in range(0, rows, 2**17):  # bounded float64 scratch
                sl = slice(t0, min(rows, t0 + 2**17))
                xs = (Xr[sl, None, :] * Sr[r, sl, :, None]).double()
                want = want + torch.einsum("ni,npj->pij", X64[sl], xs)
                scale = scale + torch.einsum("ni,npj->pij", X64[sl].abs(),
                                             xs.abs())
                del xs
            want = want.triu() + want.triu(1).transpose(-1, -2)
            scale = scale.triu() + scale.triu(1).transpose(-1, -2)
            worst = max(worst, float(((out[r].double() - want).abs()
                                      / scale.clamp_min(1e-30)).max()))
        emit("depth", ok=worst <= GRAM_TOL, rows=rows,
             rows_per_split=geo["rows_per_split"], splits=geo["splits"],
             max_entry_err_vs_float64=worst, tol=GRAM_TOL)
        if not worst <= GRAM_TOL:
            fail("depth", f"{rows} rows: entry error {worst:.3g}")
    del Xb, S, X64
    torch.cuda.empty_cache()


def phase_probe(Rs: list[int]) -> None:
    """The kernel at the fit's shapes on exact inputs (probe_inputs):
    equal to its plain version bit for bit in both modes, and the bf16
    mode different from the fp32 plain version (the rounding is real)."""
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    for R in Rs:
        Xp, Sp = probe_inputs(N_ROWS, N_FEATURES + 1,
                              N_CLASSES * (N_CLASSES + 1) // 2, R)
        exact, control = {}, 0.0
        for mode in ("float32", "bfloat16"):
            out = scaled_grams(Xp, Sp, op_dtype=mode)
            exact[mode] = 0
            for r in range(R):
                exact[mode] += not torch.equal(
                    out[r], scaled_grams_plain(Xp, Sp[r], op_dtype=mode))
                if mode == "bfloat16":
                    control = max(control, float((out[r] - scaled_grams_plain(
                        Xp, Sp[r])).abs().max()))
        ok = not any(exact.values()) and control > 0
        emit("probe", ok=ok, R=R,
             replicas_unequal_float32=exact["float32"],
             replicas_unequal_bfloat16=exact["bfloat16"],
             control_bf16_vs_float32_max_abs=control)
        if not ok:
            fail("probe", f"R={R}: kernel not bitwise equal to plain on "
                 f"exact inputs ({exact}) or bf16 rounding not applied")
        del Xp, Sp
        torch.cuda.empty_cache()


def phase_fit(X: np.ndarray, y: np.ndarray):
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression

    learner = LogisticRegression(max_iter=1, init="pooled",
                                 hessian_impl="pallas", precision="highest")
    # a small first fit loads the kernel library, cuBLAS and cuSOLVER, so
    # the fit below is timed as a user's later fits run
    t0 = time.perf_counter()
    BaggingClassifier(LogisticRegression(**learner.get_params()),
                      n_estimators=8, seed=1).fit(
        X[:N_CROSS_ROWS], y[:N_CROSS_ROWS])
    warmup_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    clf = BaggingClassifier(learner, n_estimators=N_REPLICAS, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    clf.fit(X, y)
    counts = read_launches()
    launches = counts["scaled_gram"]
    acc = clf.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    rep = clf.fit_report_
    # the replica counts the fit gave the kernel: one pooled pre-pass
    # (R = 1, pooled_iter launches), then max_iter launches per chunk
    chunk = rep["chunk_size_resolved"] or N_REPLICAS
    chunks = [min(chunk, N_REPLICAS - s) for s in range(0, N_REPLICAS, chunk)]
    expected = learner.pooled_iter + learner.max_iter * len(chunks)
    emit("fit", ok=True, n_rows=N_ROWS, n_replicas=N_REPLICAS,
         warmup_fit_seconds=warmup_seconds, fit_seconds=rep["fit_seconds"], fits_per_sec=rep["fits_per_sec"],
         h2d_seconds=rep["h2d_seconds"], chunk_size=rep["chunk_size_resolved"],
         achieved_tflops=rep["achieved_tflops"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_scaled_gram_launches=expected,
         accuracy_100k=acc, acc_bar=ACC_BAR)
    if launches <= 0 or launches != expected:
        fail("fit", f"{launches} scaled-Gram launches, expected {expected}")
    if counts["binned_left_stats"] or counts["bin_codes"]:
        fail("fit", "the logistic fit launched a histogram kernel")
    if not acc >= ACC_BAR:
        fail("fit", f"accuracy {acc:.4f} below the bar {ACC_BAR}")
    if not np.isfinite(clf.ensemble_["W"].cpu().numpy()).all():
        fail("fit", "non-finite weights")
    return clf, launches, sorted({1, *chunks})


def phase_serve(clf, X: np.ndarray) -> float:
    Xs = X[:N_SERVE_ROWS]
    clf.predict_proba(Xs)  # warm-up
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xs)
    seconds = time.perf_counter() - t0
    rows_per_sec = N_SERVE_ROWS / seconds
    sums_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    emit("serve", ok=True, rows=N_SERVE_ROWS, seconds=seconds,
         rows_per_sec=rows_per_sec, shape=list(proba.shape),
         max_row_sum_err=sums_err)
    if proba.shape != (N_SERVE_ROWS, N_CLASSES) or not sums_err <= 1e-5:
        fail("serve", f"bad probabilities: shape {proba.shape}, "
             f"row-sum error {sums_err}")
    return rows_per_sec


def phase_cross_check(X: np.ndarray, y: np.ndarray) -> None:
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression

    W = {}
    for impl in ("pallas", "blocked"):
        clf = BaggingClassifier(
            LogisticRegression(max_iter=1, init="pooled", hessian_impl=impl,
                               precision="highest"),
            n_estimators=N_CROSS_REPLICAS, seed=0,
        ).fit(X[:N_CROSS_ROWS], y[:N_CROSS_ROWS])
        W[impl] = clf.ensemble_["W"]
    diff = float((W["pallas"] - W["blocked"]).abs().max())
    rel = diff / float(W["blocked"].abs().max())
    emit("cross_check", ok=rel <= W_REL_TOL, rows=N_CROSS_ROWS,
         replicas=N_CROSS_REPLICAS, max_abs_diff=diff, max_rel_diff=rel,
         rel_tol=W_REL_TOL)
    if not rel <= W_REL_TOL:
        fail("cross_check", f"kernel and blocked W differ by {rel:.3g}")


def tree_bagger(n_estimators: int, seed: int = 0, split_impl: str = "auto",
                chunk_size: int | None = None):
    """BASELINE config 3's estimator: bagged depth-5, 32-bin Gini trees
    on 80% feature subspaces, hard vote (histogram in bf16 operands)."""
    from spark_bagging_tpu_torch import BaggingClassifier, DecisionTreeClassifier

    return BaggingClassifier(
        DecisionTreeClassifier(split_impl=split_impl, **TREE),
        n_estimators=n_estimators, max_features=TREE_MAX_FEATURES,
        voting="hard", seed=seed, chunk_size=chunk_size,
    )


def phase_tree_fit(X: np.ndarray, y: np.ndarray):
    from spark_bagging_tpu_torch import ensemble

    # a small first fit loads the kernel path and the allocator, so the
    # fit below is timed as a user's later fits run
    t0 = time.perf_counter()
    tree_bagger(8, seed=1).fit(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    warmup_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    clf = tree_bagger(N_REPLICAS)
    # count the engine's per-replica copies of X during the fit: the
    # trees read the shared X through their column index instead
    gather, copies = ensemble._gather_columns, []
    ensemble._gather_columns = lambda *a: copies.append(1) or gather(*a)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        clf.fit(X, y)
    finally:
        ensemble._gather_columns = gather
    counts = read_launches()
    launches = counts["binned_left_stats"]
    rep = clf.fit_report_
    learner = clf._fitted_learner
    gather_bytes = learner.subspace_gather_bytes(
        N_ROWS, rep["n_subspace"], device=torch.device("cuda"))
    # one launch per level per replica chunk
    chunk = rep["chunk_size_resolved"] or N_REPLICAS
    chunks = [min(chunk, N_REPLICAS - s) for s in range(0, N_REPLICAS, chunk)]
    expected = TREE["max_depth"] * len(chunks)
    acc = clf.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    majority = float(np.unique(y[:N_SERVE_ROWS], return_counts=True)[1].max()
                     / N_SERVE_ROWS)
    impl = clf._fitted_learner._resolved_impl(torch.device("cuda"))
    emit("tree_fit", ok=True, n_rows=N_ROWS, n_replicas=N_REPLICAS,
         n_subspace=rep["n_subspace"], split_impl=impl,
         warmup_fit_seconds=warmup_seconds, fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"], h2d_seconds=rep["h2d_seconds"],
         chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_binned_left_stats_launches=expected,
         x_copies=len(copies), subspace_gather_bytes=gather_bytes,
         accuracy_100k=acc, majority_share_100k=majority)
    if impl != "fused":
        fail("tree_fit", f"split_impl resolved to {impl!r}, not the kernel")
    if launches <= 0 or launches != expected:
        fail("tree_fit", f"{launches} histogram launches, expected {expected}")
    if counts["bin_codes"] != 1:
        fail("tree_fit", f"{counts['bin_codes']} bin-codes launches, "
             "expected one a fit")
    if copies or gather_bytes:
        fail("tree_fit", f"{len(copies)} per-replica copies of X "
             f"({gather_bytes} bytes priced a replica), expected none")
    if counts["scaled_gram"]:
        fail("tree_fit", "the tree fit launched the scaled-Gram kernel")
    if not acc > majority:
        fail("tree_fit", f"accuracy {acc:.4f} not above the majority "
             f"share {majority:.4f}")
    if not torch.isfinite(clf.ensemble_["leaf_logp"]).all():
        fail("tree_fit", "non-finite leaf log-probabilities")
    return clf, launches, counts["bin_codes"], sorted(set(chunks))


def phase_tree_serve(clf, X: np.ndarray) -> None:
    Xs = X[:N_SERVE_ROWS]
    clf.predict_proba(Xs)  # warm-up
    clf.predict(Xs)
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xs)
    proba_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = clf.predict(Xs)
    predict_seconds = time.perf_counter() - t0
    sums_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    emit("tree_serve", ok=True, rows=N_SERVE_ROWS,
         predict_proba_seconds=proba_seconds,
         predict_proba_rows_per_sec=N_SERVE_ROWS / proba_seconds,
         predict_seconds=predict_seconds,
         predict_rows_per_sec=N_SERVE_ROWS / predict_seconds,
         shape=list(proba.shape), max_row_sum_err=sums_err)
    if (proba.shape != (N_SERVE_ROWS, N_CLASSES) or not sums_err <= 1e-5
            or not np.isin(labels, clf.classes_).all()):
        fail("tree_serve", f"bad output: shape {proba.shape}, row-sum "
             f"error {sums_err}")


def record_levels(X: np.ndarray, y: np.ndarray, R: int) -> dict:
    """The histogram kernels' inputs in a fit of R replicas (replicas
    0..R-1 of the config, one chunk): the shared X and quantile edges
    the fit bins once, and at each level the shared codes, each
    replica's columns and gathered edges, the level's nodes and the
    Poisson x one-hot statistics. The fit runs through recording
    wrappers, put in the tree module's place only (the kernel wrappers
    themselves are left alone, launch counts and all)."""
    import types

    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    rec = {"codes": [], "levels": []}

    def codes(X, edges):
        rec["codes"].append(dict(X=X, edges=edges))
        return hist_ops.bin_codes(X, edges)

    def level(codes, edges, node, S, *, n_nodes, hist_dtype, cols, integral):
        rec["levels"].append(dict(codes=codes, edges=edges, node=node.clone(),
                                  S=S, N=n_nodes, hist_dtype=hist_dtype,
                                  cols=cols, integral=integral))
        return hist_ops.coded_left_stats(codes, edges, node, S,
                                         n_nodes=n_nodes, hist_dtype=hist_dtype,
                                         cols=cols, integral=integral)

    tree_mod.hist_ops = types.SimpleNamespace(**{
        **vars(hist_ops), "bin_codes": codes, "coded_left_stats": level})
    try:
        # "fused" is what "auto" resolves to on the card
        tree_bagger(R, split_impl="fused", chunk_size=R).fit(X, y)
    finally:
        tree_mod.hist_ops = hist_ops
    return rec


def timed_spans(spans) -> float:
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans)


def span(fn):
    """(start, stop) CUDA events around ``fn()``."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    return start, stop


def hist_library_ms(codes, cols, E, node, S, N: int, mode: str) -> dict:
    """Device ms of two library yardsticks of one level, per replica,
    each call timed alone between CUDA events and the times summed over
    replicas; forming the operands is not timed:

    - ``index_add``, the histogram form of the function: one
      ``index_add_`` of the replica's nonzero statistics (bf16-rounded in
      that mode) at the flattened (feature, code, node, class) index into
      a zeroed float32 buffer, then ``cumsum`` over the bins;
    - ``matmul``, the indicator form: one ``torch.mm`` of the (F·B, n)
      threshold indicator with the (n, N·K) node-scattered statistics in
      the mode's operand type with float32 results (TF32 and
      reduced-precision reduction off)."""
    from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul

    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    R, n, K = S.shape
    F, B = E.shape[-2:]
    dev = S.device
    ids, bins = torch.arange(N, device=dev), torch.arange(B, device=dev)
    f_ids = torch.arange(F, device=dev)
    buf = torch.zeros(F * (B + 1) * N * K, device=dev)
    spans = {"index_add": [], "matmul": []}
    with fp32_matmul():
        for r in range(-1, R):  # r = -1: an untimed warm-up
            rr = max(r, 0)
            c = codes[:, cols[rr].long()]
            rows, ks = (S[rr] != 0).nonzero(as_tuple=True)
            vals = S[rr][rows, ks]
            if mode == "bfloat16":
                vals = bf16_round(vals)
            idx = (((f_ids * (B + 1) + c[rows].long()) * N
                    + node[rr][rows].long()[:, None]) * K
                   + ks[:, None]).reshape(-1)
            vals = vals[:, None].expand(-1, F).reshape(-1)

            def index_add():
                buf.zero_()
                buf.index_add_(0, idx, vals)
                buf.view(F, B + 1, N, K)[:, :B].cumsum(1)

            ind = (c.t()[:, None, :] <= bins[None, :, None]).reshape(
                F * B, n).to(dt)
            st = ((node[rr][:, None] == ids).to(dt)[:, :, None]
                  * S[rr].to(dt)[:, None, :]).reshape(n, N * K)
            mm = ((lambda: torch.mm(ind, st)) if dt == torch.float32 else
                  (lambda: torch.mm(ind, st, out_dtype=torch.float32)))
            for name, fn in (("index_add", index_add), ("matmul", mm)):
                ev = span(fn)
                if r >= 0:
                    spans[name].append(ev)
            del c, idx, vals, ind, st
    return {k: timed_spans(v) for k, v in spans.items()}


def phase_bin_codes(rec: dict) -> dict:
    """The bin-codes kernel on the fit's own shared X and edges, bit for
    bit against its plain version, and at 300 bins (int16 codes) with a
    NaN-edge suffix; times, bound and library yardstick
    (``torch.searchsorted``, the edges' transpose not timed)."""
    from spark_bagging_tpu_torch.ops.hist import bin_codes, bin_codes_plain

    if len(rec["codes"]) != 1:
        fail("bin_codes", f"{len(rec['codes'])} bin-codes calls in a fit")
    Xd, E = rec["codes"][0]["X"], rec["codes"][0]["edges"]
    n, F = Xd.shape
    B = E.shape[1]
    codes = bin_codes(Xd, E)
    unequal = int((codes != bin_codes_plain(Xd, E)).sum())
    # int16 codes: 300 sorted edges from a row sample, the last 40 of
    # feature 0 NaN before the +inf edge
    g = torch.Generator(device=Xd.device).manual_seed(3)
    sample = Xd[torch.randint(0, n, (299,), generator=g, device=Xd.device)]
    E16 = torch.cat([torch.sort(sample.t(), dim=1).values,
                     torch.full((F, 1), float("inf"), device=Xd.device)], 1)
    E16[0, 259:299] = float("nan")
    E16 = E16.contiguous()
    c16 = bin_codes(Xd, E16)
    unequal16 = int((c16 != bin_codes_plain(Xd, E16)).sum())
    ms = cuda_ms(lambda: bin_codes(Xd, E), 5)
    plain_ms = cuda_ms(lambda: bin_codes_plain(Xd, E), 1)
    Et = E.contiguous()
    Xt = Xd.t().contiguous()
    lib_ms = cuda_ms(lambda: torch.searchsorted(Et, Xt), 5)
    nbytes = 4.0 * (n * F + F * B) + codes.element_size() * n * F
    row = dict(unequal=unequal, unequal_int16=unequal16, kernel_ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes")
    emit("bin_codes", ok=not (unequal or unequal16),
         shape=dict(n=n, F=F, B=B), dtype=str(codes.dtype),
         dtype_300_bins=str(c16.dtype), input_output_mb=nbytes / 1e6, **row)
    if unequal or unequal16 or c16.dtype != torch.int16:
        fail("bin_codes", f"{unequal} codes (and {unequal16} at 300 bins) "
             "differ from the plain version")
    return row


def phase_hist_kernels(X: np.ndarray, y: np.ndarray, Rs: list[int]) -> dict:
    """The histogram kernel at every replica count and level the tree
    fit launched it with, on that fit's own level inputs (shared codes
    read through each replica's columns): bit for bit equal to its plain
    version for every replica in both operand modes and both
    accumulators, repeating bitwise; the plain version equal to the
    gathered-X form on replica 0; on float statistics within
    HIST_FLOAT_TOL; with times per replica, bounds and library
    yardsticks at each shape. Also runs ``phase_bin_codes``."""
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats_plain,
        coded_left_stats,
        coded_left_stats_plain,
        hist_geometry,
    )

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, codes_row = {}, None
    for R in Rs:
        rec = record_levels(X, y, R)
        calls = rec["levels"]
        if [c["N"] for c in calls] != [2**lv for lv in range(TREE["max_depth"])]:
            fail("hist_kernels", f"R={R}: recorded levels "
                 f"{[c['N'] for c in calls]}")
        if codes_row is None:
            codes_row = phase_bin_codes(rec)
        Xd = rec["codes"][0]["X"]
        g = torch.Generator(device="cuda").manual_seed(R)
        for c in calls:
            codes, cols, E, node, S, N = (c[k] for k in (
                "codes", "cols", "edges", "node", "S", "N"))
            n, F_all = codes.shape
            F, B, K = E.shape[1], E.shape[2], S.shape[-1]
            if not c["integral"]:
                fail("hist_kernels", "the classifier fit did not pass "
                     "integral statistics")
            geo = hist_geometry(n, F, B, N, K, R, n_sm)
            out_bytes = 4.0 * R * F * B * N * K
            base_bytes = 4.0 * (node.numel() + S.numel() + R * F * B) + out_bytes
            # the function over one shared (n, 54) X read through each
            # replica's column index: X, the edges and columns read once
            shared_bytes = base_bytes + 4.0 * (n * F_all + R * F)
            # what the kernel reads instead of X: the shared codes
            codes_bytes = base_bytes + codes.element_size() * n * F_all
            adds = float(R) * n * F * K
            t_ops = 1e3 * adds / PEAK_FP32
            t_shared = max(1e3 * shared_bytes / PEAK_BYTES, t_ops)
            t_codes = max(1e3 * codes_bytes / PEAK_BYTES, t_ops)
            # float statistics with the same zero pattern (regression-like
            # moments), on the first replicas
            Rf = min(R, N_FLOAT_CHECK_REPLICAS)
            Sf = S[:Rf] * (1.0 + 0.5 * torch.randn(
                (Rf, n, 1), generator=g, device=S.device))
            for mode in ("bfloat16", "float32"):
                kw = dict(n_nodes=N, hist_dtype=mode, cols=cols)

                def run(integral=True):
                    return coded_left_stats(codes, E, node, S,
                                            integral=integral, **kw)

                out, again, fout = run(), run(), run(False)
                torch.cuda.synchronize()
                repeat = bool(torch.equal(out, again))
                float_acc_equal = bool(torch.equal(out, fout))
                del again, fout
                unequal, max_abs, spans = 0, 0.0, []
                for r in range(R):
                    one = dict(n_nodes=N, hist_dtype=mode, cols=cols[r:r + 1])
                    box = []
                    spans.append(span(lambda: box.append(coded_left_stats_plain(
                        codes, E[r:r + 1], node[r:r + 1], S[r:r + 1], **one))))
                    plain = box[0][0]
                    unequal += not torch.equal(out[r], plain)
                    max_abs = max(max_abs, float((out[r] - plain).abs().max()))
                    if r == 0:  # the codes form equals the gathered-X form
                        gathered = binned_left_stats_plain(
                            Xd[:, cols[0].long()].contiguous(), E[0], node[0],
                            S[0], n_nodes=N, hist_dtype=mode)
                        unequal += not torch.equal(gathered, plain)
                        del gathered
                    del plain, box
                plain_ms = timed_spans(spans)
                del out
                fout = coded_left_stats(codes, E[:Rf], node[:Rf], Sf,
                                        n_nodes=N, hist_dtype=mode,
                                        cols=cols[:Rf])
                fwant = coded_left_stats_plain(codes, E[:Rf], node[:Rf], Sf,
                                               n_nodes=N, hist_dtype=mode,
                                               cols=cols[:Rf])
                scale = coded_left_stats_plain(
                    codes, E[:Rf], node[:Rf], Sf.abs(), n_nodes=N,
                    hist_dtype=mode, cols=cols[:Rf]).clamp_min(1e-30)
                float_err = float(((fout - fwant).abs() / scale).max())
                del fout, fwant, scale
                kernel_ms = cuda_ms(run, 3)
                float_acc_ms = cuda_ms(lambda: run(False), 3)
                lib = hist_library_ms(codes, cols, E, node, S, N, mode)
                torch.cuda.empty_cache()
                rows[R, N, mode] = row = dict(
                    replicas_unequal=unequal, max_abs_err=max_abs,
                    bitwise_repeat=repeat, float_acc_equal=float_acc_equal,
                    float_max_entry_err=float_err, float_tol=HIST_FLOAT_TOL,
                    kernel_ms=kernel_ms, kernel_float_acc_ms=float_acc_ms,
                    plain_ms=plain_ms, library_ms=lib["index_add"],
                    library_matmul_ms=lib["matmul"], bound_ms=t_shared,
                    bound_by="bytes" if t_shared > t_ops else "operations",
                    bound_codes_ms=t_codes,
                )
                per_replica = {f"{k}_per_replica": v / R for k, v in row.items()
                               if k.endswith("_ms")}
                emit("hist_kernels", kernel="binned_left_stats",
                     hist_dtype=mode, shape=dict(R=R, n=n, F=F, F_all=F_all,
                                                 B=B, N=N, K=K),
                     geometry={k: geo[k] for k in (
                         "n_tile", "n_tiles", "f_tile", "b_stride", "cap",
                         "splits", "smem")},
                     shared_x_input_output_mb=shared_bytes / 1e6,
                     codes_input_output_mb=codes_bytes / 1e6,
                     matmul_form_gflop=2e-9 * R * n * F * B * N * K,
                     **row, **per_replica)
                if (unequal or not repeat or not float_acc_equal
                        or not float_err <= HIST_FLOAT_TOL):
                    fail("hist_kernels", f"R={R} N={N} {mode}: {unequal} "
                         f"replicas unequal to plain, bitwise repeat {repeat}, "
                         f"float accumulator equal {float_acc_equal}, float "
                         f"error {float_err:.3g} (tol {HIST_FLOAT_TOL})")
            del Sf
        del calls, rec
        torch.cuda.empty_cache()
    return rows, codes_row


def phase_tree_cross_check(X: np.ndarray, y: np.ndarray) -> None:
    """The kernel and the dense bf16 product on the card grow the same
    trees, bit for bit."""
    ens = {}
    for impl in ("fused", "dense"):
        ens[impl] = tree_bagger(N_TREE_CROSS_REPLICAS,
                                split_impl=impl).fit(X, y).ensemble_
        torch.cuda.empty_cache()
    same = {k: bool(torch.equal(ens["fused"][k], ens["dense"][k]))
            for k in ("feature", "threshold", "gain", "leaf_logp")}
    emit("tree_cross_check", ok=all(same.values()), rows=N_ROWS,
         replicas=N_TREE_CROSS_REPLICAS, equal=same)
    if not all(same.values()):
        fail("tree_cross_check", f"fused and dense trees differ: {same}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # the port itself, before any output: a copy of this script without
    # the repo fails here
    import spark_bagging_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_env()
    phase_build()
    X, y = headline_data()
    clf, launches, Rs = phase_fit(X, y)
    phase_serve(clf, X)
    del clf
    torch.cuda.empty_cache()
    rows = phase_kernels(X, Rs)
    phase_wide_gram()
    phase_depth(X)
    phase_probe(Rs)
    phase_cross_check(X, y)
    torch.cuda.empty_cache()
    tree, tree_launches, codes_launches, tree_Rs = phase_tree_fit(X, y)
    phase_tree_serve(tree, X)
    del tree
    torch.cuda.empty_cache()
    hist_rows, codes_row = phase_hist_kernels(X, y, tree_Rs)
    phase_tree_cross_check(X, y)
    # each kernel's line reports the largest replica chunk (and, for the
    # histogram, the deepest level in the fit's bf16 mode), where its fit
    # spends its kernel time; the phase lines hold every shape. The
    # histogram's bound is the function over one shared X read through
    # the replicas' column indices, what the fit asks of it
    f32 = rows[max(Rs)]["float32"]
    deepest = hist_rows[max(tree_Rs), 2 ** (TREE["max_depth"] - 1), "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "scaled_gram",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/scaled_gram.cu",
        "replaces": "spark_bagging_tpu/ops/gram.py:53",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }, {
        "name": "binned_left_stats",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/binned_left_stats.cu",
        "replaces": "spark_bagging_tpu/ops/hist.py:66",
        "launches": tree_launches,
        "max_abs_err": max(r["max_abs_err"] for r in hist_rows.values()),
        "ms": deepest["kernel_ms"],
        "plain_ms": deepest["plain_ms"],
        "bound_ms": deepest["bound_ms"],
        "bound_by": deepest["bound_by"],
        "library_ms": deepest["library_ms"],
    }, {
        "name": "bin_codes",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/binned_left_stats.cu",
        "replaces": "spark_bagging_tpu/ops/hist.py:66",
        "launches": codes_launches,
        "max_abs_err": 0.0 if not codes_row["unequal"] else None,
        "ms": codes_row["kernel_ms"],
        "plain_ms": codes_row["plain_ms"],
        "bound_ms": codes_row["bound_ms"],
        "bound_by": codes_row["bound_by"],
        "library_ms": codes_row["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
