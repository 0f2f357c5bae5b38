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
  the plain "blocked" one; the soft-vote kernel (``soft_vote``) at the
  benchmark cell's shapes (1000 replicas in chunks of 121) against
  float64, with its times (``python3 chip_smoke.py --soft-vote`` runs
  that phase alone);
- bagged decision trees (BASELINE config 3: depth 5, 32 bins, 256
  replicas, 43 of 54 features each, hard vote): the fit, which bins the
  shared X once (bin-codes kernel) and reads the codes through each
  replica's column index at every level (histogram kernel), with no
  per-replica copy of X; a warm ``predict`` / ``predict_proba``, whose
  hard vote is the tree-vote kernel (``tree_vote``: one launch a call,
  held bit for bit against the torch chain it replaced on the fitted
  trees and all 581,012 rows, with its times; ``python3 chip_smoke.py
  --tree-vote`` runs that phase alone); both fit
  kernels held bit for bit against their plain versions on the fit's
  own inputs, the histogram kernel at every replica count and level the
  fit launched it with, in both operand modes and both accumulators;
  kernel and dense split search cross-checked to give identical trees.

The serving plane (``spark_bagging_tpu_torch.serving``) runs right after
each of those two fits' ``serve`` phases, on the fitted bag itself:

- ``serving_ladder_bench`` / ``serving_ladder_default``: the logistic bag
  registered with warm-up on benchmarks/serving_latency.py's ladder
  (1..256, 9 buckets) and on the executor's default (8..4096, 10), each
  as a fresh process would (empty program cache): one CUDA-graph
  capture a bucket and none on requests, the graph pool's bytes, every
  bucket's replay bit for bit the same closure run eagerly, and 40
  requests of 1-300 rows (slabs beyond 256) within SERVE_TOL of
  ``predict_proba``;
- ``serving_latency``: 1,600 closed-loop single-row requests a run at
  concurrency 1, 4 and 16 through ``MicroBatcher(max_delay_ms=0.5,
  max_batch_rows=256)`` against naive per-request ``predict_proba``,
  rows/s and p50/p99 ms as serving_latency.py measures them (one
  discarded run, the median of SERVE_REPEATS);
- ``serving_swap``: a second 256-replica fit swapped in under four
  clients' traffic: no failed or mixed request, the new version served
  after the swap, every capture the swap's own pre-capture;
- ``serving_checkpoint``: ``registry.save`` then ``registry.load`` under
  a new name (its own captures): the same served bits;
- ``serving_trees_*``: config 3's hard-vote trees on both ladders, served
  votes bit for bit ``predict_proba``'s, and their served rows/s at
  concurrency 16;
- ``analysis`` (its ``analysis_audit`` lines come from the two serving
  phases, on executors they build): ``analysis.audit_executor`` on the
  logistic bag's 1..256 executor at its smallest and largest bucket and
  on config 3's 8..4096 executor at both ends — the forward traced with
  ``make_fx`` on the card (no host sync, no float64, at most 1 MiB of
  closure constants; the op count, the constants' bytes and the
  hand-written kernels the trace launched), then one real call under
  ``torch.cuda.set_sync_debug_mode("error")``.

The scaled-Gram kernel is also held against its plain version at
d = 250 (``wide_gram``), and its fp32 mode against a float64 reference
at a shallow and at the capped accumulation depth (``depth``).

Then the regressors, on the 80% training split of the 20,640 x 8
standardized synthetic California housing:

- ``reg_fit``: BASELINE config 2, ``BaggingRegressor(LinearRegression(
  l2=1e-4), n_estimators=100)``: its test RMSE within 2% of a float64
  numpy ridge fit on the same rows, and ``predict`` (the host-side mean
  coefficients) against the device forward of ``aggregated_forward()``.
  This path runs no kernel: the ridge Gram is a plain batched product;
- ``rf_reg_fit``: ``RandomForestRegressor(n_estimators=128,
  max_depth=5)`` (config 6's shape): the histogram kernel's float
  accumulator on the moments (w, w y, w y^2), bin codes once a fit;
  ``reg_hist_kernels`` holds that accumulator against its plain version
  at every level the fit launched, on the fit's own inputs;
- ``reg_tree_cross_check``: the same forest with the kernel and with the
  dense product on the card, whose R^2 may differ by at most 0.01.

Then the gradient-boosted trees, whose moments (h, h z, h z^2) run the
histogram kernel's float accumulator at every level of every round:

- ``gbt_fit``: BASELINE config 7 at full width, ``BaggingClassifier(
  GBTClassifier(n_rounds=30, max_depth=4), n_estimators=32)`` on the
  800,000 x 28 training split of the standardized 1M-row synthetic
  HIGGS (4 x 30 launches a replica chunk, one bin-codes launch); its
  test AUC at or above sklearn's proxy minus 0.02 (the config's parity
  rule), and a warm ``predict_proba`` of the 200,000 test rows;
- ``gbt_hist_kernels``: the float accumulator at each level of round 0
  and of the last round of one chunk, in bf16 and fp32 operand modes,
  against the plain version summed in float64;
- ``gbt_cross_check``: 4 replicas x 10 rounds with the kernel and with
  the dense product on the card (round 0's split features, test AUC);
- ``gbt_multiclass_fit``: 16 replicas x 10 rounds on the covtype data,
  the 16 x 7 class trees of a round in one launch a level; accuracy on
  the first 100k rows against sklearn's proxy minus 0.02;
- ``gbt_reg_fit``: 32 GBT regressors x 20 rounds on the California
  split; test R^2 against sklearn's proxy minus 0.02.

The streamed fits (``fit_stream``), whose chunks cross from the host
one at a time:

- ``tree_stream_fit``: config 3's learner streamed over the covtype rows
  in 65,536-row chunks (9 chunks, the last padded; 7 passes), a
  bin-codes and a histogram launch per chunk per level, all int32;
  accuracy on the first 100k rows within 0.03 of the in-memory fit's;
- ``tree_stream_hist_kernels``: every level's table of the first chunk
  and of the padded tail, kernel against plain version, bit for bit for
  every replica; ``tree_stream_cross_check``: kernel and dense streams
  grow identical trees;
- ``rf_reg_stream_fit``: the forest regressor streamed over the
  California training split in 4,096-row chunks (the float
  accumulator); test R^2 above 0.5;
- ``mlp_stream_fit``: BASELINE config 4 at full size, 512 bagged MLPs
  (hidden 32) streamed over 11,000,000 synthetic HIGGS rows in 550
  chunks of 20,000, one epoch, 2 Adam steps a chunk; test AUC on
  200,000 rows at or above sklearn's proxy minus 0.02; the stream's
  seconds, row-replicas a second, peak memory, the host's chunk-making
  time against the device's chunk visits (bootstrap draw and Adam
  steps apart), a warm ``predict_proba``;
- ``mlp_device_check``: a small stream and an in-memory minibatch MLP
  fit, on the card and on the CPU in one process, parameters and
  probabilities within the CPU parity tests' tolerance.

The histogram's float statistics (the forest regressor's, the GBTs')
sum in the kernel's int64 fixed point: every such table above is held
bit for bit against its plain version ``coded_left_stats_fixed``, its
repeat and the fit's own table bitwise too (the same table in every
run), and within 1e-5 of the function summed in float64.

Then the rest of the learner zoo, each through the estimator a user
calls at full width, with its fit seconds, fits/s, peak memory, warm
predict rows/s, quality figure, its launch counts (the zoo's products
are torch matmuls, as the JAX package's are XLA's: none expected) and a
device check, the same learner on the card and on the CPU port (8
replicas, 20,000 rows) within its CPU parity tolerance:

- ``zoo_svc``, ``zoo_gaussian_nb``, ``zoo_bernoulli_nb``,
  ``zoo_multinomial_nb`` (on ``|X|``): 256 replicas on the covtype rows;
  ``zoo_fm_classifier`` (8 factors, 100 Adam steps) and
  ``zoo_logistic_adam`` (100 steps): 64 replicas; accuracy on the first
  100k rows above the majority share; ``zoo_glm_binomial``: 256
  replicas on ``y == 1``, accuracy at 0.5 above the constant's;
- on config 2's California split, 100 replicas each, test R^2 above 0:
  ``zoo_glm_gaussian``, and poisson, gamma and tweedie on a positive
  target; ``zoo_fm_regressor``; ``zoo_isotonic``; ``zoo_aft``, 20% of
  the rows right-censored through ``aux``: the predictions' correlation
  with the test rows' times above 0.5, ``predict_quantiles`` rising;
- ``zoo_aft_stream``: the survival learner streamed in 4,096-row chunks
  with the censor flags as the last column (``aux_col=-1``), its
  ``predict_stream`` of the same wide source dropping that column;
  ``zoo_svc_stream``: 256 ``LinearSVC`` replicas streamed over the
  covtype rows in 65,536-row chunks.

Growth and resume, each against the fit it must reproduce:

- ``warm_start``: the logistic headline grown 128 -> 256 replicas
  (``warm_start=True``) against ``fit``'s cold 256: bootstrap weights
  and subspaces bitwise, ``predict_proba``'s max |delta| against
  WARM_PROBA_TOL (the growth's Gram launches hold 128 replicas, not
  256: bitwise is a finding, not the contract), scaled-Gram launches
  pooled_iter + ceil(128 / chunk), the growth's seconds beside the cold
  fit's;
- ``warm_start_trees``: config 3's 256 trees grown from 128 against
  ``tree_fit``'s: every leaf and ``predict`` bitwise, histogram
  launches 5 x ceil(128 / chunk), one bin-codes launch;
- ``stream_resume_trees``: config 3's tree stream killed in level pass
  3 and resumed from its snapshot: bitwise ``tree_stream_fit``'s, the
  kernels launched only for the 3 levels left (27 each);
- ``stream_resume_mlp``: config 4 at full size snapshotted every 100
  chunk-steps, killed after chunk 275 and resumed: every parameter
  bitwise ``mlp_stream_fit``'s; seconds and bytes a snapshot;
- ``bootstrap_rejection``: ``bootstrap_weights`` at rates 33, 100 and
  1000 (JAX's rejection sampler) over 16 replicas x 65,536 rows on the
  card against the same call on the CPU: 0 differing draws.

Snapshots go to a temporary directory the script removes.

Online updates (``online.OnlineUpdater``) and the data plane, each time
printed with the card's name and power limit:

- ``online_update``: 8 warm ``partial_fit`` steps of 16,384 fresh
  covtype rows on the logistic headline bag (Poisson(1) weights keyed by
  ``online_step_key``, a damped Newton step from the current params, an
  out-of-bag tap before it): each step's seconds, the running OOB
  estimate, the scaled-Gram launches (steps x chunks) and their (R, n),
  the kernel against its plain version at each such shape, and one step
  on the card against the CPU from the same state (16 replicas);
- ``online_publish``: the updated candidate (``to_estimator()``)
  swapped into a serving registry under four clients' traffic: no
  failed request, every served row within SERVE_TOL of its version;
- ``online_anchor``: ``OnlineUpdater(warm=False)`` over a
  ``bootstrap=False`` 16-replica bag's own 50,000 rows replays the batch
  fit: params bitwise, the same Gram launches;
- ``quality_tap`` (after ``online_publish``, on the headline bag) and
  ``quality_tap_trees`` (after ``serving_trees_*``, on config 3's trees):
  ``ModelRegistry.enable_quality`` with disagreement sampling captures
  one per-replica CUDA graph a bucket at warm-up and none of either
  kind on requests; each replay bit for bit the eager
  ``replica_forward`` closure, its mean (soft vote) within SERVE_TOL of
  the served output, its vote count (hard vote) exactly it; served
  outputs bitwise with and without the monitor; rows/s and p50/p99 at
  concurrency 4 with and without it; the monitor's host microseconds a
  single-row batch and a sampled batch's tap replay;
- ``drift_loop``: the closed loop on the headline bag. Four clients send
  3,200 fresh rows, then covariate-shifted ones (``X + 4.0``), through
  the batcher; the default drift rules fire on the monitor's PSI gauge
  (none before the shift), the ``OnlineTrainer`` (stepped) refits on
  the 1,024 labelled rows served after the alert (its Newton Hessians
  through the scaled-Gram kernel, held against the plain version at
  the refit's shapes), validates, swaps and saves; 0 failed requests,
  the max feature PSI back under the threshold after the swap, the
  published directory served bitwise by a fresh registry, and one
  forced rejection writing one ``refit_rejected`` flight dump;
- ``planes`` (after ``drift_loop``, on the headline bag; the 1..256
  ladder, 4 clients of single rows through ``MicroBatcher(
  max_delay_ms=0.5)``): 1,600 rows unarmed, then the same rows with the
  capacity and performance planes armed and the exposition server
  running, unscraped and then with ``/metrics`` and ``/healthz``
  scraped every 50 ms — no capture on a
  request, every ``/healthz`` 200, served bits unchanged (a fixed
  request set through the executor, and every row both runs served in
  a one-slab batch of the same bucket), the performance plane's stage
  shares summing to 1 per path, the capacity ledger's compiled bytes
  exactly the executor's ``graph_pool_bytes``, its params bytes the
  parameter and subspace tensors', every bucket's counted FLOPs equal
  to the CPU count and the analytic ``2·b·R·(d+1)·C``, serving MFU in
  (0, 1), the process's device bytes in use at most its limit; rows/s
  and p50/p99 of the three runs; a refit of the headline bag during paced
  traffic under ``GET /debug/profile?seconds=3`` (its Gram launches,
  the Chrome trace naming ``scaled_gram`` and ``cudaGraphLaunch``, its
  ``sbt_fit_*`` gauges on ``/metrics`` equal to its ``fit_report_``);
  that refit hot-swapped in under traffic (0 failed, the ledger holding
  only the new version); ``/debug/tail``'s verdicts; ``/healthz`` 503
  after ``close()`` and the source gone after ``retire()``;
- ``fleet`` (after ``planes``): the registry ``save``d and loaded by a
  second process, ``chip_smoke.py --fleet-peer <dir>``, with its own
  exposition server; 800 rows served by each process inside a capture
  log; a ``FleetAggregator`` over both ``/varz``: the merged request
  counter the sum of the processes' own, the merged latency histogram
  their bucket-wise sum, version skew 0; the peer killed: stale, quorum
  degraded, no counter falls; ``python -m
  spark_bagging_tpu_torch.telemetry dump --merge`` over the two logs
  giving the live merge's counters; an ``SLOSpec`` (no capture on a
  request, padding under half the FLOPs, p99 under 50 ms) on the
  phase's report, appended twice to a scratch history store without a
  digest flip;
- ``planes_trees`` (after ``quality_tap_trees``): config 3's trees
  served for 800 rows with both planes armed: no counted FLOPs
  (``flops`` None at every bucket, the cost model on rows), votes
  bitwise ``predict_proba``'s, the ledger reconciled with
  ``graph_pool_bytes``;
- ``readers``: 100,000 synthetic HIGGS rows written as libsvm, CSV and a
  hashed CSV (3 categorical columns), streamed through ``LibsvmChunks``,
  ``CSVChunks`` and ``HashedCSVChunks`` on the g++-built host loader
  (which must serve): every chunk bitwise the ``ArrayChunks`` chunk of
  the same rows (the hashed one bitwise the pure-Python hasher's); a
  64-replica logistic ``fit_stream`` over the CSV bitwise the same
  stream over the arrays; each reader's MB/s;
- ``criteo_stream``: BASELINE config 8 at full width (128 logistic
  replicas, 1024 features, 200,000-row chunks, 2 Adam steps a chunk),
  its rows cut from 40M to 600,000 (under the config's 5M pre-flight
  floor; 2.5M, then 1M before): test AUC
  on 100,000 fresh rows at or above sklearn's proxy minus 0.02, the
  stream's seconds, row-replicas/s, peak memory and the host's chunk
  making against the device's chunk visits.

The in-process mesh (``parallel/``), every shard a thread over repeated
``cuda:0`` entries (the machine has one card), each fit's launches
counted by shard:

- ``mesh_replica``, ``mesh_data``, ``mesh_kernels``, ``mesh_trees``,
  ``mesh_serving`` (``phase_mesh``, after the zoo): the headline on
  (1, 4) and (4, 1) meshes, config 3's trees on (2, 2), replica-sharded
  serving with a lost shard;
- ``mesh_gbt`` (after ``gbt_cross_check``): config 7 on (2, 2), the AUC
  bar with the bootstrap, 120 float histogram launches and one bin
  codes a shard (a replica chunk), every shard's deepest level of round
  0 bitwise ``coded_left_stats_fixed`` at its own scales
  (``mesh_gbt_hist``: shard (0, 0)'s times); with ``bootstrap=False``
  round 0's split features and the AUC against the single-device fit
  under the mesh's edges;
- ``mesh_gbt_multiclass`` and ``mesh_gbt_reg`` (after ``gbt_reg_fit``):
  the small GBT phases on a (2, 1) data mesh, the multiclass one on the
  first 200,000 rows;
- ``mesh_stream_trees`` (after ``tree_stream_cross_check``): config 3
  streamed on (2, 2) over the first 300,000 rows, levels x chunks launches a shard, every shard's
  deepest level bitwise, a mesh snapshot resumed on the mesh bitwise,
  ``bootstrap=False`` bitwise the single-device stream;
- ``mesh_stream_mlp`` (after ``mlp_device_check``): config 4's learner
  at full width on (2, 2) over the first 500,000 rows against the
  single-device stream over them;
- ``mesh_zoo`` (after ``zoo_streams``): SVC, the naive Bayes learners,
  FM, MLP, GLM, isotonic and AFT on (4, 1) with ``bootstrap=False``
  against their single-device fits.

More than one process (``multiprocess``, after ``mesh``): two children
of this script (``--mp-worker RANK PORT DIR``) join over gloo with
``initialize_distributed`` and fit on one (2, 2) mesh that spans them,
each child with ``cuda:0`` x 2 (process 0 on data row 0): the headline
at full width, config 3's trees, config 4's learner streamed over the
first MP["stream_rows"] rows with a snapshot after MP["snapshot_every"]
chunks and a resume from it, the ``oob_score`` stream refusal and a
``save()`` by both. Their gathered state is bitwise the 1-process (2, 2)
mesh's over ``cuda:0`` x 4 here (the trees: ``mesh_trees``' fit), and
each other's; only process 0 wrote; the checkpoint loaded here on the
1-process mesh predicts bitwise what the children's mesh predicted; the
Gram and histogram launches a shard equal the 1-process mesh's.

The sklearn proxies are constants, made on a CPU host that has sklearn
by ``python3 chip_smoke.py --sklearn-proxies``.

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
import os
import subprocess
import sys
import tempfile
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
# The float paths (forest regressor, GBTs) hold the kernel against the
# plain version summed in float64 (coded_left_stats_f64): the float32
# plain product adds all n rows of an entry in one register, and at a
# GBT's 800,000 rows it strays by ~1e-4 of the scale itself (its error
# is reported beside the kernel's)
HIST_FLOAT_TOL = 1e-5
# the regressors: BASELINE config 2 (benchmarks/run_configs.py:184-228)
# on the full 20,640-row synthetic California housing, split 80/20
N_CAL_ROWS = 20_640
REG = dict(n_estimators=100, l2=1e-4)
# config 2's quality check: the bagged ridge's test RMSE within 2% of a
# float64 ridge fit of the same objective on the same training rows
REG_RMSE_REL = 0.02
# predict (host matvec of the mean coefficients) vs the device forward,
# max abs over the test rows: float32 sums of the same terms
COLLAPSE_TOL = 1e-4
# a forest regressor of config 6's shape (run_configs.py:419-464)
RF_REG = dict(n_estimators=128, max_depth=5)
# test R^2 bar of the forest: a constant prediction scores 0 and the
# ridge (the best model of this linear data) ~0.91; a depth-5 forest of
# axis-aligned splits approximates the 8-feature linear trend in 32
# steps a tree and scored 0.668 with 16 trees on the CPU, so 0.5 is a
# clear margin above 0 with room for the bf16 moments on the card
RF_R2_BAR = 0.5
# kernel vs dense forests on the card: near-tied splits may flip under
# float sums in another order, so the trees need not be equal; their
# test R^2 must agree within this
RF_CROSS_R2_TOL = 0.01
# BASELINE config 7 (benchmarks/run_configs.py:467-514): bagged GBTs on
# the standardized 1M-row synthetic HIGGS, split 80/20 (800,000 x 28
# training rows), automatic chunk
N_HIGGS_ROWS = 1_000_000
GBT = dict(n_rounds=30, max_depth=4)
GBT_REPLICAS = 32
# the config's parity rule (run_configs.py:69): ours >= proxy - 0.02
PARITY_TOL = 0.02
# sklearn's proxies, computed on a CPU host with sklearn 1.9.0 (the
# card's machine has none) by ``python3 chip_smoke.py --sklearn-proxies``
# (sklearn_proxies below): HistGradientBoosting(max_depth=4,
# learning_rate=0.1, random_state=0) fitted on run_configs'
# _proxy_train_set (50,000 rows at most, seed 0) of each phase's
# training rows. Config 7: max_iter=30, test AUC (utils.metrics.roc_auc)
GBT_PROXY_AUC = 0.9892248916999542
# covtype (trained on all 581,012 rows): max_iter=10, accuracy on the
# first 100k rows
GBT_MC = dict(n_rounds=10, max_depth=4, n_estimators=16)
GBT_MC_PROXY_ACC = 0.63804
# California housing (the 16,512-row training split): the regressor,
# max_iter=20, test R^2
GBT_REG = dict(n_rounds=20, max_depth=4, n_estimators=32)
GBT_REG_PROXY_R2 = 0.7133246391671708
# kernel vs dense GBTs on the card (gbt_cross_check): 4 replicas, 10
# rounds; the share of round 0's split features that must be equal
# (float sums in another order may flip a near tie) and the test AUC
# difference allowed
GBT_CROSS = dict(n_estimators=4, n_rounds=10)
GBT_CROSS_FEATURE_SHARE = 0.95
GBT_CROSS_AUC_TOL = 0.002
# BASELINE config 4 (benchmarks/run_configs.py:283-358,
# mlp_bag512_higgs11M_streamed) at full size: 512 bagged MLPs streamed
# over 11M synthetic HIGGS rows in 20,000-row chunks, one epoch, two
# Adam steps a chunk; the test and proxy rows come from the stream's
# mixture (structure seed 11) with their own row seeds
MLP_STREAM = dict(n_rows=11_000_000, chunk_rows=20_000, n_estimators=512,
                  n_epochs=1, steps_per_chunk=2, lr=0.01)
MLP = dict(hidden=32, lr=0.01)
N_MLP_TEST_ROWS = 200_000
# sklearn MLPClassifier(hidden_layer_sizes=(32,), max_iter=30,
# batch_size=1024, learning_rate_init=0.01, random_state=0) on
# synthetic_higgs(50_000, seed=999_002, structure_seed=11), test AUC on
# the 200,000 test rows (run_configs.py:311-323)
MLP_PROXY_AUC = 0.997067283084803
# card against CPU for the same MLP fits (mlp_device_check): the
# tolerances tests/test_torch_mlp.py and test_torch_stream.py hold the
# port to JAX with at these shapes: probabilities within MLP_TOL there,
# parameters within LONG_PARAM_TOL (after tens of Adam steps a
# near-zero gradient element's last bits move its step by up to lr)
MLP_DEVICE_TOL = 1e-5
MLP_DEVICE_PARAM_TOL = 2e-4
MLP_CHECK_STREAM = dict(n_rows=40_000, chunk_rows=5_000, n_estimators=16,
                        n_epochs=2, steps_per_chunk=2)
MLP_CHECK_FIT = dict(n_rows=20_000, n_estimators=16, max_iter=50,
                     batch_size=1024)
# config 3's learner streamed over the covtype rows (tree_stream_fit):
# 9 chunks, the last padded; accuracy on the first 100k rows within this
# of the in-memory fit's (other bin edges, chunk-keyed weights)
# the rest of the learner zoo (PR 9), at full width on the covtype rows
# and config 2's California split: replicas of the Newton and closed-form
# learners, of the Adam learners, of the regressors
ZOO_REPLICAS = 256
ZOO_ADAM_REPLICAS = 64
ZOO_REG_REPLICAS = 100
# card against the CPU port: replicas and rows, and each learner's CPU
# parity tolerances (tests/test_torch_zoo_clf.py, test_torch_zoo_reg.py):
# (parameters, predictions) over max(1, |CPU value|)
ZOO_CHECK = dict(n_estimators=8, n_rows=20_000)
ZOO_TOL = {"svc": (5e-3, 1e-4), "nb": (1e-5, 1e-5), "fm": (5e-3, 5e-3),
           "logistic_adam": (1e-5, 1e-5), "glm": (5e-4, 5e-4),
           "glm_binomial": (5e-3, 5e-3),
           "iso": (1e-5, 1e-5), "aft": (2e-4, 2e-4), "stream": (1e-5, 1e-5)}
# the survival phases' censored share (as examples/06_learner_zoo.py)
AFT_CENSORED = 0.2
ZOO_STREAM = dict(aft_chunk=4_096, aft_epochs=50, svc_chunk=65_536,
                  svc_epochs=2, steps_per_chunk=4, lr=0.05)
TREE_STREAM_CHUNK = 65_536
TREE_STREAM_ACC_TOL = 0.03
# the forest regressor streamed over the California training split
RF_STREAM_CHUNK = 4_096
# the serving plane: the ladder benchmarks/serving_latency.py:416 serves
# on (1..256, 9 buckets) and the executor's default (8..4096, 10)
SERVE_LADDERS = {"bench": dict(min_bucket_rows=1, max_batch_rows=256),
                 "default": dict()}
# served soft votes against the unpadded predict_proba: a padded bucket
# is another GEMM shape, which cuBLAS may run with another kernel
SERVE_TOL = 1e-5
SERVE_LEVELS = (1, 4, 16)
# single-row requests a run (3,200 until the analysis phase came in:
# rows/s and percentiles are per run, and the serving, quality-tap and
# tree-latency phases run 4 of them a level, the monitored tap's at
# ~1,000 rows/s)
SERVE_REQUESTS = 1_600
# the naive per-request yardstick runs half as many (its 450-500 rows/s
# at concurrency 4 and 16 made it most of the phase's seconds)
SERVE_NAIVE_REQUESTS = 800
SERVE_REPEATS = 3
SERVE_BATCHER = dict(max_delay_ms=0.5, max_batch_rows=256, max_queue=4096)
SERVE_SWAP_WINDOW_S = 0.5
# growth and resume: the warm logistic growth's predict_proba against
# the cold fit's (the card's logistic tolerance, as serving's); the
# first fit's replicas, and where the streams are killed
WARM_PROBA_TOL = 1e-5
WARM_FROM = 128
MLP_SNAPSHOT_EVERY = 100
MLP_KILL_AFTER_CHUNK = 275
TREE_KILL_PASS = 3          # killed in level pass 3: levels 0 and 1 done
BOOT_RATES = (33.0, 100.0, 1000.0)
BOOT_SHAPE = (16, 65_536)
# online updates: warm partial_fit steps of fresh covtype rows on
# the headline bag (row seed 70, the headline's structure); the card
# against the CPU after one step from the same state on a 16-replica bag
# of the headline's learner, held to the CPU parity tests' logistic
# tolerance (max |dW| over max |W|, tests/test_torch_online.py)
ONLINE = dict(steps=8, rows=16_384, seed=70)
ONLINE_CHECK = dict(n_estimators=16, n_rows=20_000)
ONLINE_W_TOL = 1e-4
# accuracy floor on the first 100k headline rows after the steps: each
# warm step is a Newton step from the current params on that step's
# rows alone, so the bag drifts toward a 16,384-row fit (0.7639 after 8
# steps with 8 replicas on the CPU, from 0.7673): the headline bar less
# 0.01
ONLINE_ACC_BAR = ACC_BAR - 0.01
# the quality plane on a served bag: the monitor's refresh cadence in
# rows and its disagreement sampling (every 8th packed batch, replay.py's
# default)
QUALITY = dict(refresh_every=64, disagreement_every=8)
# the operator's planes on the headline bag: 1,600 single rows (4
# clients; 3,200 until the analysis phase came in: the gates are
# equalities over the rows served) unarmed, then armed with the
# exposition server scraped every 50 ms; a refit under a 3 s device
# profile; config 3's trees for 800 rows armed; the two-process fleet at
# 800 rows a process, its SLO (p99 under 50 ms, padding under half the
# FLOPs, no capture on a request)
PLANES = dict(requests=1_600, clients=4, scrape_every_s=0.05,
              profile_seconds=3, profile_pace_s=0.005, tree_rows=800,
              fleet_rows=800,
              slo_p99_ms=50.0, slo_padding_waste=0.5)
# the tenancy plane: the JAX drill's default policy
# (benchmarks/replay.py:1998-2200, replay_tenants) at full width. Six
# tenants t0..t5 on one registry with the 1..256 ladder: t0..t4 headline
# bags (seeds 0..4), t5 config 3's trees; priorities cycle interactive /
# standard / batch, weights 6..1, only t0 quota-bound (25 rps);
# residency for 4 of the 6, Zipf s = 1.1 over the tenants; the capacity
# plane's hot 50 / warm 20 rps; stepped batchers (2 ms window, 1 ms idle
# flush, 256 rows); a refit budget of 4 a 0.25 s window; quarantine
# window 0.25 s, backoff 0.05 s, seeded. The stepped drive: a seeded
# Poisson schedule of 1-8 row requests (3,000 a second for 1.05 s of
# virtual clock: 3,140 requests) of fresh covtype rows (row seed 80),
# twice; the tenant-chaos drive on its first 1,500 requests; the
# budgeted refits (t0 and t3 on rows shifted by + 4.0, as the drift
# loop shifts them; cold, on 1,024 rows) during a drive of its first
# 600; the threaded drive: 4 clients of single rows, 500 rows (row
# seed 81; its numbers are rates and percentiles, restore-bound at ~80
# rows/s, so 3,200 rows took 34 s to show the same). The private
# program cache holds (residency + 2) ladders: every resident's
# entries, a restore's captures before its victim's demotion, and a
# swap's pre-captures, so no pressure eviction drops a resident's entry
# and the ledger equals the residents' graph_pool_bytes exactly (the
# JAX drill's 4 x residency holds its 3-rung ladder the same way)
TENANCY = dict(tenants=6, residency=4, zipf_s=1.1, head_quota_rps=25.0,
               hot_rps=50.0, warm_rps=20.0,
               batcher=dict(max_delay_ms=2.0, idle_flush_ms=1.0,
                            max_batch_rows=256, max_queue=1024),
               refit_total=4, refit_window_s=0.25,
               quarantine_window_s=0.25, quarantine_backoff_s=0.05,
               seed=80, rate_rps=3_000.0, duration_s=1.05,
               rows=tuple(range(1, 9)), pool_rows=4_096, snapshot_every=8,
               min_requests=3_000, chaos_requests=1_500, refit_requests=600,
               refit_rows=1_024, refit_shift=4.0, refit_margin=0.05,
               threaded_requests=500, clients=4)
# the closed loop on the headline bag: 3,200 fresh rows of the headline
# mixture (row seed 71, not used before), then rows shifted as
# benchmarks/replay.py:188-206 shifts them at its defaults (scale 1.0,
# shift 4.0, :529-530); at least 3,200 of them, and on until 1,024 rows
# were served after the publish swap. The default drift rules
# (threshold 0.5) on a virtual clock of 1 ms a served row, with 128 and
# 256 ms windows; the monitor's PSI gauges read 0 below 256 rows. The
# trainer refits on the 1,024 labelled rows served after the alert
# (collect_rows = the buffer's capacity: the post-change window, as
# replay.py's trainer does), with example 10's margin. The refit starts
# from scratch (``updater_opts={"warm": False}``: the headline learner's
# pooled pre-pass and Newton step on the window's Poisson(1) weights):
# a warm Newton step from the incumbent diverges under a 4-sigma shift
# of all 54 features (the incumbent's softmax saturates; on the CPU at
# 16 replicas one warm step moved W by 680 and took the window's
# accuracy from 0.293 to 0.277, a cold refit to 0.820)
DRIFT = dict(fresh=3_200, shifted=3_200, post_swap=1_024, seed=71,
             scale=1.0, shift=4.0, dt=1e-3, fast_s=0.128, slow_s=0.256,
             min_rows=256, window=1_024, margin=0.05, warm=False)
# the file readers: synthetic HIGGS rows written as libsvm, CSV
# and a hashed CSV with a few categorical columns, streamed in chunks
# (100,000 rows: one full chunk and a partial one; 200,000 until the
# analysis phase came in)
READERS = dict(n_rows=100_000, chunk_rows=65_536, n_estimators=64,
               n_categorical=3, n_hash=64)
# BASELINE config 8 (benchmarks/run_configs.py:551-664) at full width,
# its rows cut from 40,000,000 to under the config's own pre-flight
# floor (run_configs.py:603, floor_rows=5_000_000) to fit the script's
# time limit (2.5M, then 1M before the analysis phase came in): 3
# chunks of 200,000 x 1024, host-bound at ~4 s a chunk
CRITEO = dict(n_rows=600_000, n_features=1024, chunk_rows=200_000,
              n_estimators=128, n_epochs=1, steps_per_chunk=2, lr=0.05,
              l2=1e-4, n_test=100_000)
# sklearn LogisticRegression(max_iter=100, C=1 / (1e-4 * 50,000)) on
# synthetic_criteo(50_000, 1024, seed=999_004, structure_seed=13), test
# AUC on the 100,000 test rows (run_configs.py:606-615), sklearn 1.9.0
CRITEO_PROXY_AUC = 1.0
# chunks of config 8's stream timed for the host's and the device's pace
CRITEO_PACE_CHUNKS = 2
# the in-process mesh (parallel/) over repeated cuda:0 entries, at the
# headline's full width: a replica mesh and a data mesh of the logistic
# headline, config 3's trees on a 2 x 2 mesh, and replica-sharded
# serving on the 1..256 ladder
MESH = dict(replica=(1, 4), data=(4, 1), trees=(2, 2), clients=4,
            requests=1_600, loss_requests=48)
# a replica shard's Gram launch holds fewer replicas than the
# single-device fit's, so its Hessians sum in another order (ROADMAP
# Queue C, checked, not faults)
MESH_PROBA_TOL = 1e-4
# bootstrap=False, max_samples=1.0: the data-parallel fit is the
# single-device fit (tests/test_sharded.py:85-101)
MESH_EXACT_TOL = 1e-5
MESH_TREE_ACC_TOL = 0.01
# the data axis of the other families and the mesh streams (PR 17), every
# shard a thread over cuda:0: config 7 on (2, 2); the multiclass and
# regressor GBTs on a (2, 1) data mesh, the multiclass one on the first
# MESH_MC_ROWS covtype rows (the single-device phase takes all 581,012);
# config 3 streamed on (2, 2); config 4's learner streamed on (2, 2) over
# the first MESH_MLP_ROWS of its 11M rows; the zoo on (4, 1) with
# bootstrap=False, 16 replicas on 20,000 rows (the California split's
# 16,512)
MESH_1B = dict(gbt=(2, 2), gbt_small=(2, 1), stream_trees=(2, 2),
               stream_mlp=(2, 2), zoo=(4, 1), zoo_replicas=16,
               zoo_rows=20_000)
MESH_MC_ROWS = 200_000
# mesh_stream_trees streams the first MESH_STREAM_ROWS covtype rows (5
# chunks, the last padded; cut from 581,012 for the script's time), its
# bootstrap=False check the first 3 chunks; its resume starts from the
# snapshot written after 4 of the 5 levels
MESH_STREAM_ROWS = 300_000
MESH_EXACT_CHUNKS = 3
MESH_RESUME_PASS = 5
# mesh_gbt's bootstrap=False pair fits the first MESH_GBT_EXACT_ROWS
# training rows (the bootstrap fit all 800,000)
MESH_GBT_EXACT_ROWS = 400_000
# a GBT pair's split choices differ only at ties: different splits whose
# gains agree within this share of the replica's largest gain
# (tests/test_torch_gbt.py's TOL)
GBT_TIE_TOL = 1e-5
MESH_MLP_ROWS = 500_000
# the mesh stream against the single-device stream over the same rows:
# the two data shards' gradient sums meet in another order, and 50 Adam
# steps carry last-bit differences of near-zero gradient elements into
# steps of up to lr (tests/test_torch_mlp.py: parameters within 2e-4
# after 32 steps on the CPU); the 512-replica mean probability averages
# them, so 1e-3 leaves an order of magnitude over the 1e-4 expected
MESH_MLP_PROBA_TOL = 1e-3
MESH_MLP_AUC_TOL = 0.002
# mesh_zoo: each learner's (parameter, prediction) tolerance against its
# single-device fit, ZOO_TOL's except where a 4-shard sum's last bits
# carry further (`--mesh-witness` reads both, PERF.md, PR 17): naive
# Bayes probabilities, whose 54-feature log-likelihoods turn parameter
# differences of 3.3e-6 into probability differences of up to 2.0e-5
# (so 1e-4 for them, the parameters kept at 1e-5), and the MLP's 50
# full-batch Adam steps, held as the mesh MLP stream is (probabilities
# within MESH_MLP_PROBA_TOL; parameters within 5e-3): its gap is 8e-8
# after one step and grows to 1.3e-3 at 50 as Adam's normalized steps
# carry the reordered sums of near-zero gradient elements, where a
# gradient left unsummed over the shards is 2e-2 apart after one step
MESH_ZOO_TOL = {**ZOO_TOL, "nb": (ZOO_TOL["nb"][0], 1e-4),
                "mlp": (5e-3, MESH_MLP_PROBA_TOL)}
# the MLP's CPU parity tolerance (tests/test_torch_mlp.py: LONG_PARAM_TOL,
# MLP_TOL), and the Adam steps `--mesh-witness` reads the mesh gap after
MLP_FAMILY_TOL = (2e-4, 1e-5)
WITNESS_MLP_STEPS = (1, 5, 10, 25, 50)
# the multiprocess phase: two children joined over gloo on one (2, 2)
# mesh, each child's collectives timing out after group_timeout_s, both
# killed after timeout_s; config 4's stream cut to its first stream_rows
# rows (10 chunks of 20,000), snapshotted after snapshot_every chunks
MP = dict(shape=(2, 2), stream_rows=200_000, snapshot_every=6,
          timeout_s=300, group_timeout_s=120)
# the card's `nvidia-smi` name and power limit, printed with every time
# of the online and data-plane phases
CARD = ""


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    sys.exit(1)


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from spark_bagging_tpu_torch.ops import kernels

    for fn, attr in kernels.counters().values():
        setattr(fn, attr, 0)
        fn.__dict__.pop("shard_launches", None)


def shard_launches() -> dict:
    """Each kernel's launches by mesh shard (``"data,replica"``) since
    ``reset_launches``: what the threads of a mesh run launched."""
    from spark_bagging_tpu_torch.ops import kernels

    out = {}
    for name, (fn, attr) in kernels.counters().items():
        if attr != "launches":
            continue
        per = fn.__dict__.get("shard_launches", {})
        out[name] = {f"{s[0]},{s[1]}": v for (a, s), v in
                     sorted(per.items()) if a == attr}
    return out


def read_launches() -> dict:
    from spark_bagging_tpu_torch.ops import kernels

    return {k: getattr(fn, attr)
            for k, (fn, attr) in kernels.counters().items()}


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
    from spark_bagging_tpu_torch.utils.datasets import standardize, synthetic_covtype

    X, y = synthetic_covtype(N_ROWS)
    return standardize(X), y


def regression_data():
    """BASELINE config 2's data: the standardized synthetic California
    housing, split 80/20 as benchmarks/run_configs.py splits it:
    ``(X_train, y_train, X_test, y_test)``."""
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_california(N_CAL_ROWS)
    return datasets.train_test_split(datasets.standardize(X), y)


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
                *(dict(h="uint8", s="int16", f="float", i="int", x="int64")[c]
                  for c in key.groups()))
            per = counts.setdefault(name, {})
            per[m.group(1)] = per.get(m.group(1), 0) + 1
    return counts


def phase_build() -> None:
    from spark_bagging_tpu_torch.ops import kernels
    from spark_bagging_tpu_torch.utils import native

    t0 = time.perf_counter()
    kernels.library()
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


def phase_kernels(X: np.ndarray, Rs: list[int],
                  modes=("float32", "bfloat16"),
                  phase: str = "kernels") -> dict:
    """The kernel against its plain version at every replica count the
    fit launched it with, in both operand modes (or ``modes``), every
    replica compared, with times, bound and library yardstick at each
    shape."""
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
        for mode in modes:
            wgmma_before = scaled_grams.wgmma_launches
            out = scaled_grams(Xb, S, op_dtype=mode)
            design = ("wgmma" if scaled_grams.wgmma_launches > wgmma_before
                      else "mma.sync")
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
            geo = kernel_geometry(n, d, P, R, n_sm, op_dtype=mode)
            rows[R][mode] = row = dict(
                design=design,
                # launch geometry, arithmetic and not measured: the
                # upper triangle's entries over the products issued
                geometry=dict(items=geo["items"],
                              issued_share=geo["issued_share"]),
                max_entry_err=err, tol=GRAM_TOL, max_abs_err=abs_err,
                bitwise_repeat=bitwise, kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            )
            emit(phase, kernel="scaled_gram", op_dtype=mode,
                 shape=dict(n=n, d=d, P=P, R=R),
                 splits=geo["splits"], rows_per_split=geo["rows_per_split"],
                 **row, **extra, card=CARD)
            if not (err <= GRAM_TOL and bitwise):
                fail(phase, f"scaled_gram {mode} R={R}: entry error "
                     f"{err:.3g} (tol {GRAM_TOL}), bitwise repeat {bitwise}")
        del Xb, S, scale
        torch.cuda.empty_cache()
    return rows


SOFT_VOTE_TOL = 2e-6  # mean probabilities vs float64 (the card tests')


def soft_vote_reference(X, W, rows: int = 32_768):
    """Float64 soft-vote sums ``(n, C)``: each replica's scores as one
    wide product a slice of rows, softmax over its classes."""
    R, d1, C = W.shape
    W64 = W.double().permute(1, 0, 2).reshape(d1, R * C)
    out = torch.empty((X.shape[0], C), dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], rows):
        Xb = torch.cat([X[s:s + rows].double(),
                        torch.ones((min(rows, X.shape[0] - s), 1),
                                   dtype=torch.float64, device=X.device)], 1)
        out[s:s + rows] = torch.softmax((Xb @ W64).view(-1, R, C),
                                        dim=-1).sum(dim=1)
    return out


def phase_soft_vote(X: np.ndarray, R: int = 1000, chunk: int = 121) -> dict:
    """The soft-vote kernel at the benchmark cell's shapes: the headline's
    rows and a 1000-replica bag of near-equal replicas (unit weights
    around one model, as bootstrap fits of one model are). Its gap to
    float64 on the mean probabilities, bitwise repeats, sums the same in
    chunks of 121, and ms a call (one launch over the 1000 replicas, as
    the forward makes it; and a 121-replica chunk) beside the bound and
    the plain version in the fit's chunks of 121 (the torch chain it
    replaced: bmm, softmax, sum; the library yardstick too)."""
    from spark_bagging_tpu_torch.ops.soft_vote import (
        kernel_geometry,
        soft_vote_mean,
        soft_vote_quanta,
        soft_vote_sums_plain,
    )

    dev = torch.device("cuda")
    Xd = torch.as_tensor(X, device=dev)
    n, d = Xd.shape
    g = torch.Generator(device=dev).manual_seed(23)
    W = torch.randn((1, d + 1, N_CLASSES), generator=g, device=dev)
    W = W + 1e-3 * torch.randn((R, d + 1, N_CLASSES), generator=g,
                               device=dev)
    chunks = [W[s:s + chunk] for s in range(0, R, chunk)]
    ref = soft_vote_reference(Xd, W) / R
    parts = torch.stack([soft_vote_quanta(Xd, w) for w in chunks])
    got = soft_vote_mean(parts, n_total=R)
    gap = float((got.double() - ref).abs().max())
    plain_gap = float((sum(soft_vote_sums_plain(Xd, w) for w in chunks)
                       .double() / R - ref).abs().max())
    q = soft_vote_quanta(Xd, W)
    exact = bool(torch.equal(q, parts.sum(dim=0)))
    bitwise = bool(torch.equal(q, soft_vote_quanta(Xd, W)))
    del ref, got, q, parts
    flops = 2.0 * n * R * (d + 1) * N_CLASSES
    nbytes = 4.0 * (n * d + R * (d + 1) * N_CLASSES + n * N_CLASSES)
    t_ops, t_bytes = 3e3 * flops / PEAK_TF32, 1e3 * nbytes / PEAK_BYTES
    row = dict(
        kernel_ms=cuda_ms(lambda: soft_vote_quanta(Xd, W), 5),
        kernel_ms_chunk=cuda_ms(lambda: soft_vote_quanta(Xd, chunks[0]), 10),
        plain_ms=cuda_ms(
            lambda: [soft_vote_sums_plain(Xd, w) for w in chunks], 2),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_fp32_simt_ms=1e3 * flops / PEAK_FP32,
        max_mean_gap=gap, plain_max_mean_gap=plain_gap, tol=SOFT_VOTE_TOL,
        bitwise_repeat=bitwise, chunking_exact=exact)
    row["library_ms"] = row["plain_ms"]
    torch.cuda.empty_cache()
    emit("soft_vote", kernel="soft_vote", shape=dict(n=n, d=d, C=N_CLASSES,
                                                      R=R, chunk=chunk),
         geometry=kernel_geometry(n, d, N_CLASSES, chunk,
                                  torch.cuda.get_device_properties(0)
                                  .multi_processor_count),
         **row, card=CARD)
    if not (gap <= SOFT_VOTE_TOL and bitwise and exact):
        fail("soft_vote", f"gap {gap:.3g} (tol {SOFT_VOTE_TOL}), bitwise "
             f"{bitwise}, chunking exact {exact}")
    return row


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
    errs, kernel_ms = {}, {}
    for mode in ("float32", "bfloat16"):
        out = scaled_grams(X, S, op_dtype=mode)
        want = scaled_grams_plain(X, S, op_dtype=mode)
        errs[mode] = float(((out - want).abs() / scale).max())
        kernel_ms[mode] = cuda_ms(lambda: scaled_grams(X, S, op_dtype=mode), 5)
    ok = all(e <= GRAM_TOL for e in errs.values())
    emit("wide_gram", ok=ok, shape=WIDE_GRAM, max_entry_err=errs, tol=GRAM_TOL,
         kernel_ms=kernel_ms, card=CARD)
    if not ok:
        fail("wide_gram", f"entry errors {errs} (tol {GRAM_TOL})")


def phase_gram(X: np.ndarray) -> None:
    """The Gram kernel's gates and times at every shape the fit paths
    launch it with: the headline's replica chunks in both modes
    (``phase_kernels``), the online steps' 16,384 rows and the refits'
    1,024 (``gram_at_shapes``), the data mesh's shard, d = 250, the depth
    cap and the exact probe."""
    phase_kernels(X, [1, 14, 121])
    for phase, rows, Rs in (("gram_online_shapes", 16_384, [14, 121]),
                            ("gram_refit_shapes", 1_024, [1, 14, 121]),
                            ("gram_shard_shape", N_ROWS // MESH["data"][0],
                             [110])):
        for row in gram_at_shapes(X[:rows], Rs):
            emit(phase, ok=row["max_entry_err"] <= GRAM_TOL, **row, card=CARD)
            if not row["max_entry_err"] <= GRAM_TOL:
                fail(phase, f"entry error {row['max_entry_err']:.3g}")
    phase_wide_gram()
    phase_depth(X)
    phase_probe([1, 14, 121])


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
         peak_tflops_bf16=rep["peak_tflops_bf16"], mfu=rep["mfu"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_scaled_gram_launches=expected,
         accuracy_100k=acc, acc_bar=ACC_BAR)
    if launches <= 0 or launches != expected:
        fail("fit", f"{launches} scaled-Gram launches, expected {expected}")
    if counts["scaled_gram_wgmma"] != launches:
        fail("fit", f"{counts['scaled_gram_wgmma']} of {launches} scaled-Gram "
             "launches took the wgmma design")
    if not (rep["mfu"] is not None and 0 < rep["mfu"] < 1):
        fail("fit", f"fit_report_ mfu {rep['mfu']} (peak "
             f"{rep['peak_tflops_bf16']}) is not in (0, 1)")
    if counts["binned_left_stats"] or counts["bin_codes"]:
        fail("fit", "the logistic fit launched a histogram kernel")
    if not acc >= ACC_BAR:
        fail("fit", f"accuracy {acc:.4f} below the bar {ACC_BAR}")
    if not np.isfinite(clf.ensemble_["W"].cpu().numpy()).all():
        fail("fit", "non-finite weights")
    return clf, launches, sorted({1, *chunks})


def phase_serve(clf, X: np.ndarray) -> int:
    """The headline bag's batch ``predict_proba``: its soft vote is the
    soft-vote kernel, one launch a call (logistic, identity subspace,
    soft vote). Returns the launches."""
    Xs = X[:N_SERVE_ROWS]
    reset_launches()
    clf.predict_proba(Xs)  # warm-up
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xs)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    rows_per_sec = N_SERVE_ROWS / seconds
    sums_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    emit("serve", ok=True, rows=N_SERVE_ROWS, seconds=seconds,
         rows_per_sec=rows_per_sec, shape=list(proba.shape),
         max_row_sum_err=sums_err, launches=counts,
         expected_soft_vote_launches=2)
    if proba.shape != (N_SERVE_ROWS, N_CLASSES) or not sums_err <= 1e-5:
        fail("serve", f"bad probabilities: shape {proba.shape}, "
             f"row-sum error {sums_err}")
    if counts["soft_vote"] != 2 or counts["scaled_gram"] != 0:
        fail("serve", f"launches {counts}: expected one soft-vote launch a "
             "predict_proba (2 calls) and nothing else")
    return counts["soft_vote"]


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


def expected_launches(rep: dict, R: int, levels: int) -> tuple[int, list]:
    """(histogram launches, chunk sizes) of a fit of R replicas that
    launches ``levels`` times a chunk."""
    chunk = rep["chunk_size_resolved"] or R
    chunks = [min(chunk, R - s) for s in range(0, R, chunk)]
    return levels * len(chunks), chunks


def check_float_path(phase: str, counts: dict, expected: int) -> None:
    """A float-statistics tree path's launches: ``expected`` histogram
    launches, all in the float accumulator, one bin-codes launch, no
    scaled-Gram launch."""
    launches = counts["binned_left_stats"]
    if launches <= 0 or launches != expected \
            or counts["binned_left_stats_float"] != launches:
        fail(phase, f"{launches} histogram launches "
             f"({counts['binned_left_stats_float']} float), expected "
             f"{expected}, all float")
    if counts["bin_codes"] != 1 or counts["scaled_gram"]:
        fail(phase, f"launches {counts}: expected one bin-codes launch and "
             "no scaled-Gram launch")


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
    expected, chunks = expected_launches(rep, N_REPLICAS, TREE["max_depth"])
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


def phase_tree_vote(clf, X: np.ndarray) -> dict:
    """The tree-vote kernel at config 3's shapes, on the fitted bag's own
    trees and the 581,012 rows: its counts bit for bit against the plain
    version (the torch chain it replaced: route, gather, argmax, one-hot
    sum), bitwise repeats, one launch a ``predict_proba``, and ms a call
    beside the bound (X, the tables and the counts moved once; the
    compares on the fp32 cores) and the plain version."""
    from spark_bagging_tpu_torch.ops.tree_vote import (
        kernel_geometry,
        tree_vote_counts,
        tree_vote_counts_plain,
    )

    dev = torch.device("cuda")
    Xd = torch.as_tensor(X, device=dev)
    n, F = Xd.shape
    learner, p, cols = clf._fitted_learner, clf.ensemble_, clf.subspaces_
    C, R, D = int(clf.n_classes_), int(clf.n_estimators_), learner.max_depth

    def kernel():
        return tree_vote_counts(Xd, p["feature"], p["threshold"],
                                p["leaf_logp"], depth=D, n_classes=C,
                                cols=cols)

    def plain():
        return tree_vote_counts_plain(learner, p, Xd, C, cols)

    got = kernel()
    bitwise = bool(torch.equal(got, plain()))
    repeat = bool(torch.equal(kernel(), got))
    reset_launches()
    clf.predict_proba(X)
    launches = read_launches()["tree_vote"]
    nbytes = 4.0 * (n * F + 2 * R * (2 ** D - 1) + R * 2 ** D * C + n * C)
    t_ops, t_bytes = 1e3 * n * R * D / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    row = dict(
        kernel_ms=cuda_ms(kernel, 20),
        plain_ms=cuda_ms(plain, 3),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bitwise=bitwise, bitwise_repeat=repeat, launches_a_call=launches)
    row["library_ms"] = row["plain_ms"]
    torch.cuda.empty_cache()
    emit("tree_vote", kernel="tree_vote",
         shape=dict(n=n, F=F, C=C, R=R, depth=D, k=int(cols.shape[1])),
         geometry=kernel_geometry(n, F, C, R, D,
                                  torch.cuda.get_device_properties(0)
                                  .multi_processor_count),
         **row, card=CARD)
    if not (bitwise and repeat and launches == 1):
        fail("tree_vote", f"bitwise {bitwise}, repeat {repeat}, "
             f"{launches} launches a predict_proba (expected 1)")
    return row


def record_levels(X: np.ndarray, y: np.ndarray, R: int, est=None,
                  keep=None) -> dict:
    """The histogram kernels' inputs in a fit of R replicas (replicas
    0..R-1 of the config, one chunk): the shared X and quantile edges
    the fit bins once, and at each level the shared codes, each
    replica's columns and gathered edges, the level's nodes and the
    statistics (Poisson x one-hot for the classifier trees, the moments
    of a regressor or a GBT ``est``; default the config-3 bagger). The
    fit runs through recording wrappers, put in the tree module's place
    only (the kernel wrappers themselves are left alone, launch counts
    and all). ``keep(i)`` picks the level calls to record (default all;
    a GBT's rounds call the kernel 4 x 30 times a chunk); each record
    has its call index ``i``."""
    import types

    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    rec = {"codes": [], "levels": []}
    calls = [0]

    def codes(X, edges):
        rec["codes"].append(dict(X=X, edges=edges))
        return hist_ops.bin_codes(X, edges)

    def level(codes, edges, node, S, *, n_nodes, hist_dtype, cols, integral):
        i = calls[0]
        calls[0] += 1
        if keep is None or keep(i):
            rec["levels"].append(dict(
                i=i, codes=codes, edges=edges, node=node.clone(), S=S,
                N=n_nodes, hist_dtype=hist_dtype, cols=cols,
                integral=integral))
        return hist_ops.coded_left_stats(codes, edges, node, S,
                                         n_nodes=n_nodes, hist_dtype=hist_dtype,
                                         cols=cols, integral=integral)

    tree_mod.hist_ops = types.SimpleNamespace(**{
        **vars(hist_ops), "bin_codes": codes, "coded_left_stats": level})
    try:
        # "fused" is what "auto" resolves to on the card
        (est or tree_bagger(R, split_impl="fused", chunk_size=R)).fit(X, y)
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


def phase_bin_codes(rec: dict, path: str = "tree") -> dict:
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
    emit("bin_codes", ok=not (unequal or unequal16), path=path,
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


def ridge_rmse(Xtr, ytr, Xte, yte, l2: float) -> float:
    """Test RMSE of config 2's objective solved once in float64 on the
    host: (Xb^T Xb + l2 n diag(1, ..., 1, 1e-8)) beta = Xb^T y, the
    unweighted fit every bootstrap replica approximates."""
    from spark_bagging_tpu_torch.utils.metrics import rmse

    Xb = np.c_[Xtr.astype(np.float64), np.ones(len(ytr))]
    pen = np.r_[np.full(Xtr.shape[1], l2), 1e-8] * len(ytr)
    beta = np.linalg.solve(Xb.T @ Xb + np.diag(pen),
                           Xb.T @ ytr.astype(np.float64))
    return rmse(yte, np.c_[Xte, np.ones(len(yte))] @ beta)


def phase_reg_fit(split) -> None:
    """BASELINE config 2 on the card: the fit, its test RMSE against a
    float64 ridge, and ``predict`` (the collapse to mean coefficients)
    against the device forward. The linear path runs no kernel."""
    from spark_bagging_tpu_torch import BaggingRegressor, LinearRegression
    from spark_bagging_tpu_torch.utils.metrics import r2_score, rmse

    Xtr, ytr, Xte, yte = split
    learner = LinearRegression(l2=REG["l2"])
    # a small first fit loads cuBLAS and cuSOLVER, so the fit below is
    # timed as a user's later fits run
    t0 = time.perf_counter()
    BaggingRegressor(LinearRegression(l2=REG["l2"]), n_estimators=8,
                     seed=1).fit(Xtr[:2000], ytr[:2000])
    warmup_seconds = time.perf_counter() - t0
    reg = BaggingRegressor(learner, n_estimators=REG["n_estimators"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reg.fit(Xtr, ytr)
    counts = read_launches()
    rep = reg.fit_report_
    reg.predict(Xte)  # warm-up
    t0 = time.perf_counter()
    pred = reg.predict(Xte)
    predict_seconds = time.perf_counter() - t0
    fn, params, subs = reg.aggregated_forward()
    Xd = torch.as_tensor(Xte, device="cuda")
    device_pred = fn(params, subs, Xd).cpu().numpy()
    forward_ms = cuda_ms(lambda: fn(params, subs, Xd), 5)
    collapse_err = float(np.abs(pred - device_pred).max())
    err, r2 = rmse(yte, pred), r2_score(yte, pred)
    ref = ridge_rmse(Xtr, ytr, Xte, yte, REG["l2"])
    rel = abs(err - ref) / ref
    emit("reg_fit", ok=True, n_train=len(ytr), n_test=len(yte),
         n_features=Xtr.shape[1], n_replicas=REG["n_estimators"],
         warmup_fit_seconds=warmup_seconds, fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"], h2d_seconds=rep["h2d_seconds"],
         chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, test_rmse=err, test_r2=r2,
         ridge_float64_rmse=ref, rmse_rel_diff=rel, rmse_rel_tol=REG_RMSE_REL,
         collapse_vs_device_max_abs=collapse_err, collapse_tol=COLLAPSE_TOL,
         predict_seconds=predict_seconds,
         device_forward_ms=forward_ms)
    if any(counts.values()):
        fail("reg_fit", f"the linear fit launched a kernel: {counts}")
    if not torch.isfinite(reg.ensemble_["beta"]).all():
        fail("reg_fit", "non-finite coefficients")
    if not rel <= REG_RMSE_REL:
        fail("reg_fit", f"test RMSE {err:.5f} is {rel:.3%} from the float64 "
             f"ridge's {ref:.5f} (limit {REG_RMSE_REL:.0%})")
    if not collapse_err <= COLLAPSE_TOL:
        fail("reg_fit", f"predict and the device forward differ by "
             f"{collapse_err:.3g} (limit {COLLAPSE_TOL})")


def rf_regressor(n_estimators: int = RF_REG["n_estimators"], seed: int = 0,
                 split_impl: str = "auto", chunk_size: int | None = None):
    """The forest regressor of config 6's shape: depth 5, 32 bins, a
    third of the features a split (bf16 moments, float accumulator)."""
    from spark_bagging_tpu_torch import RandomForestRegressor

    return RandomForestRegressor(
        n_estimators=n_estimators, max_depth=RF_REG["max_depth"], seed=seed,
        split_impl=split_impl, chunk_size=chunk_size)


def phase_rf_reg_fit(split):
    from spark_bagging_tpu_torch.utils.metrics import r2_score, rmse

    Xtr, ytr, Xte, yte = split
    R = RF_REG["n_estimators"]
    t0 = time.perf_counter()
    rf_regressor(8, seed=1).fit(Xtr[:2000], ytr[:2000])
    warmup_seconds = time.perf_counter() - t0
    est = rf_regressor()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est.fit(Xtr, ytr)
    counts = read_launches()
    rep = est.fit_report_
    expected, chunks = expected_launches(rep, R, RF_REG["max_depth"])
    est.predict(Xte)  # warm-up
    t0 = time.perf_counter()
    pred = est.predict(Xte)
    predict_seconds = time.perf_counter() - t0
    err, r2 = rmse(yte, pred), r2_score(yte, pred)
    impl = est._fitted_learner._resolved_impl(torch.device("cuda"))
    emit("rf_reg_fit", ok=True, n_train=len(ytr), n_test=len(yte),
         n_replicas=R, split_impl=impl,
         warmup_fit_seconds=warmup_seconds, fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"], h2d_seconds=rep["h2d_seconds"],
         chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_binned_left_stats_launches=expected,
         float_accumulator_launches=counts["binned_left_stats_float"],
         test_rmse=err, test_r2=r2, r2_bar=RF_R2_BAR,
         predict_seconds=predict_seconds)
    if impl != "fused":
        fail("rf_reg_fit", f"split_impl resolved to {impl!r}, not the kernel")
    check_float_path("rf_reg_fit", counts, expected)
    if not torch.isfinite(est.ensemble_["leaf_value"]).all():
        fail("rf_reg_fit", "non-finite leaf values")
    if not r2 > RF_R2_BAR:
        fail("rf_reg_fit", f"test R^2 {r2:.4f} not above {RF_R2_BAR}")
    return counts["binned_left_stats"], counts["bin_codes"], sorted(set(chunks))


def coded_left_stats_f64(codes, E, node, S, N: int, mode: str,
                         cols) -> torch.Tensor:
    """``coded_left_stats_plain``'s function summed in float64: the same
    indicator ``[code <= b]`` (0 at NaN edges) read through each
    replica's columns and the same node-scattered statistics
    (bf16-rounded in that mode, which float64 holds exactly), one
    replica at a time."""
    from spark_bagging_tpu_torch.ops.precision import bf16_round

    R, n, K = S.shape
    F, B = E.shape[-2:]
    bins = torch.arange(B, device=S.device)
    ids = torch.arange(N, device=S.device)
    out = torch.empty((R, F, B, N, K), dtype=torch.float64, device=S.device)
    for r in range(R):
        c = codes if cols is None else codes[:, cols[r].long()]
        e = E if E.dim() == 2 else E[r]
        T = ((c[:, :, None] <= bins) & ~torch.isnan(e)[None]).reshape(
            n, F * B).double()
        s = bf16_round(S[r]) if mode == "bfloat16" else S[r]
        st = ((node[r][:, None] == ids).double()[:, :, None]
              * s.double()[:, None, :]).reshape(n, N * K)
        out[r] = (T.t() @ st).reshape(F, B, N, K)
        del T, st
    return out


def float_hist_row(phase: str, c: dict, R: int, mode: str, fit_out=None,
                   **tags) -> dict:
    """The histogram kernel's float (fixed-point) accumulator on one
    recorded level's inputs ``c`` in operand mode ``mode``: bit for bit
    equal to its plain version ``coded_left_stats_fixed`` for every
    replica, a repeat bitwise equal (the same table in every run), and
    ``fit_out``, the table the fit itself got from these inputs, if
    given, too; every entry within HIST_FLOAT_TOL of the function summed
    in float64 (over the abs-sum scale; the float32 plain version's own
    error beside it); with the call's ms, the plain version's (each
    replica's call timed alone, summed), the library forms' and the
    shared-X bound. Emits one ``phase`` line (``tags`` added) and fails
    the phase past the tolerance or on any unequal bit."""
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_fixed,
        coded_left_stats_plain,
    )

    # the identity subspace (every feature) passes no columns and the
    # shared (F, B) edges: the kernel runs on exactly these
    codes, cols, E, node, S, N = (c[k] for k in (
        "codes", "cols", "edges", "node", "S", "N"))
    if c["integral"]:
        fail(phase, "the fit passed integral statistics")
    n, F_all = codes.shape
    F, B, K = E.shape[-2], E.shape[-1], S.shape[-1]
    kw = dict(n_nodes=N, hist_dtype=mode, cols=cols)

    def run():
        return coded_left_stats(codes, E, node, S, integral=False, **kw)

    out, again = run(), run()
    fixed = coded_left_stats_fixed(codes, E, node, S, **kw)
    unequal = int((out != fixed).any(dim=(1, 2, 3, 4)).sum())
    repeat_bitwise = bool(torch.equal(out, again))
    fit_bitwise = fit_out is None or bool(torch.equal(fit_out, fixed))
    max_abs = float((out - fixed).abs().max())
    want = coded_left_stats_f64(codes, E, node, S, N, mode, cols)
    plain = coded_left_stats_plain(codes, E, node, S, **kw)
    scale = coded_left_stats_plain(codes, E, node, S.abs(),
                                   **kw).clamp_min(1e-30)
    err = float(((out - want).abs() / scale).max())
    plain_err = float(((plain - want).abs() / scale).max())
    f64_max_abs = float((out - want).abs().max())
    fit_err = 0.0
    if fit_out is not None:
        fit_err = float(((fit_out - want).abs() / scale).max())
    del out, again, want, plain, scale, fixed
    spans = []
    for r in range(R):
        one = dict(n_nodes=N, hist_dtype=mode,
                   cols=None if cols is None else cols[r:r + 1])
        Er = E if E.dim() == 2 else E[r:r + 1]
        spans.append(span(lambda: coded_left_stats_fixed(
            codes, Er, node[r:r + 1], S[r:r + 1], **one)))
    plain_ms = timed_spans(spans)
    kernel_ms = cuda_ms(run, 3)
    lib = hist_library_ms(
        codes,
        cols if cols is not None else torch.arange(
            F_all, dtype=torch.int32, device=S.device).expand(R, F),
        E if E.dim() == 3 else E.expand(R, F, B), node, S, N, mode)
    torch.cuda.empty_cache()
    # the function over the shared X (and columns, if any), the edges,
    # nodes and statistics read once, the table written once
    shared_bytes = 4.0 * (n * F_all + E.numel() + node.numel()
                          + S.numel() + R * F * B * N * K
                          + (0 if cols is None else cols.numel()))
    t_ops = 1e3 * float(R) * n * F * K / PEAK_FP32
    t_bytes = 1e3 * shared_bytes / PEAK_BYTES
    row = dict(
        replicas_unequal_to_fixed_plain=unequal,
        bitwise_repeat=repeat_bitwise,
        **({} if fit_out is None else {"fit_table_bitwise": fit_bitwise,
                                       "fit_table_entry_err": fit_err}),
        max_entry_err=err, plain_float32_entry_err=plain_err,
        tol=HIST_FLOAT_TOL, max_abs_err=max_abs,
        f64_max_abs_err=f64_max_abs, kernel_ms=kernel_ms,
        plain_ms=plain_ms, library_ms=lib["index_add"],
        library_matmul_ms=lib["matmul"],
        bound_ms=max(t_ops, t_bytes),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    emit(phase, kernel="binned_left_stats", accumulator="float",
         hist_dtype=mode, **tags,
         shape=dict(R=R, n=n, F=F, F_all=F_all, B=B, N=N, K=K),
         **row, **{f"{k}_per_replica": v / R for k, v in row.items()
                   if k.endswith("_ms")})
    if (unequal or not repeat_bitwise or not fit_bitwise
            or not max(err, fit_err) <= HIST_FLOAT_TOL):
        fail(phase, f"R={R} N={N} {mode} {tags}: {unequal} replicas unequal "
             f"to the fixed-point plain version, bitwise repeat "
             f"{repeat_bitwise}, the fit's table bitwise {fit_bitwise}; "
             f"entry error {err:.3g}, the fit's table {fit_err:.3g} "
             f"(tol {HIST_FLOAT_TOL})")
    return row


def phase_reg_hist_kernels(split, Rs: list[int]) -> dict:
    """The histogram kernel's float accumulator at every replica count
    and level the forest regressor's fit launched, on that fit's own
    level inputs, in the fit's operand mode (``float_hist_row``). Also
    holds ``bin_codes`` on the fit's X and edges."""
    Xtr, ytr = split[:2]
    rows = {}
    for R in Rs:
        rec = record_levels(Xtr, ytr, R,
                            est=rf_regressor(R, split_impl="fused",
                                             chunk_size=R))
        calls = rec["levels"]
        if [c["N"] for c in calls] != [2**lv for lv in range(RF_REG["max_depth"])]:
            fail("reg_hist_kernels", f"R={R}: recorded levels "
                 f"{[c['N'] for c in calls]}")
        phase_bin_codes(rec, path="rf_reg")
        for c in calls:
            rows[R, c["N"]] = float_hist_row("reg_hist_kernels", c, R,
                                             c["hist_dtype"])
        del calls, rec
        torch.cuda.empty_cache()
    return rows


def phase_reg_tree_cross_check(split) -> None:
    """The forest regressor grown with the kernel and with the dense
    product on the card: the share of equal split features, the
    predictions' max abs difference, and test R^2 within
    RF_CROSS_R2_TOL (float sums in another order may flip near-tied
    splits, so the trees need not be equal)."""
    from spark_bagging_tpu_torch.utils.metrics import r2_score

    Xtr, ytr, Xte, yte = split
    fits, preds, r2 = {}, {}, {}
    for impl in ("fused", "dense"):
        fits[impl] = rf_regressor(split_impl=impl).fit(Xtr, ytr)
        preds[impl] = fits[impl].predict(Xte)
        r2[impl] = r2_score(yte, preds[impl])
        torch.cuda.empty_cache()
    feats = [fits[k].ensemble_["feature"] for k in ("fused", "dense")]
    same_features = float((feats[0] == feats[1]).float().mean())
    same_trees = float(all(
        torch.equal(fits["fused"].ensemble_[k], fits["dense"].ensemble_[k])
        for k in ("feature", "threshold")))
    diff = float(np.abs(preds["fused"] - preds["dense"]).max())
    d_r2 = abs(r2["fused"] - r2["dense"])
    emit("reg_tree_cross_check", ok=d_r2 <= RF_CROSS_R2_TOL,
         rows=len(ytr), replicas=RF_REG["n_estimators"],
         equal_split_feature_share=same_features,
         all_splits_equal=bool(same_trees), prediction_max_abs_diff=diff,
         test_r2_fused=r2["fused"], test_r2_dense=r2["dense"],
         r2_diff=d_r2, r2_tol=RF_CROSS_R2_TOL)
    if not d_r2 <= RF_CROSS_R2_TOL:
        fail("reg_tree_cross_check", f"test R^2 differs by {d_r2:.4f} "
             f"(limit {RF_CROSS_R2_TOL})")


def higgs_data():
    """BASELINE config 7's data: the standardized 1M-row synthetic
    HIGGS, split 80/20 as benchmarks/run_configs.py splits it:
    ``(X_train, y_train, X_test, y_test)``."""
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_higgs(N_HIGGS_ROWS)
    return datasets.train_test_split(datasets.standardize(X), y)


def gbt_bagger(n_estimators: int = GBT_REPLICAS, seed: int = 0,
               split_impl: str = "auto", chunk_size: int | None = None,
               n_rounds: int = GBT["n_rounds"]):
    """Config 7's estimator: bagged binary GBTs of depth 4, 32 bins, bf16
    moments (h, h z, h z^2) in the histogram's float accumulator."""
    from spark_bagging_tpu_torch import BaggingClassifier, GBTClassifier

    return BaggingClassifier(
        GBTClassifier(n_rounds=n_rounds, max_depth=GBT["max_depth"],
                      split_impl=split_impl),
        n_estimators=n_estimators, seed=seed, chunk_size=chunk_size)


def phase_gbt_fit(split):
    """BASELINE config 7 at full width: 32 bagged GBTs of 30 rounds on
    800,000 x 28, its test AUC against the sklearn proxy, and a warm
    ``predict_proba`` of the 200,000 test rows."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    Xtr, ytr, Xte, yte = split
    levels = GBT["max_depth"] * GBT["n_rounds"]
    t0 = time.perf_counter()
    gbt_bagger(4, seed=1, n_rounds=2).fit(Xtr[:50_000], ytr[:50_000])
    warmup_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    est = gbt_bagger()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est.fit(Xtr, ytr)
    counts = read_launches()
    rep = est.fit_report_
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected, chunks = expected_launches(rep, GBT_REPLICAS, levels)
    est.predict_proba(Xte)  # warm-up
    t0 = time.perf_counter()
    proba = est.predict_proba(Xte)
    predict_seconds = time.perf_counter() - t0
    auc = roc_auc(yte, proba[:, 1])
    bar = GBT_PROXY_AUC - PARITY_TOL
    impl = est._fitted_learner._resolved_impl(torch.device("cuda"))
    emit("gbt_fit", ok=True, n_train=len(ytr), n_test=len(yte),
         n_features=Xtr.shape[1], n_replicas=GBT_REPLICAS, **GBT,
         split_impl=impl, warmup_fit_seconds=warmup_seconds,
         fit_seconds=rep["fit_seconds"], fits_per_sec=rep["fits_per_sec"],
         h2d_seconds=rep["h2d_seconds"], chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=peak, launches=counts,
         expected_binned_left_stats_launches=expected,
         float_accumulator_launches=counts["binned_left_stats_float"],
         test_auc=auc, proxy_auc=GBT_PROXY_AUC, auc_bar=bar,
         predict_proba_seconds=predict_seconds,
         predict_proba_rows_per_sec=len(yte) / predict_seconds)
    if impl != "fused":
        fail("gbt_fit", f"split_impl resolved to {impl!r}, not the kernel")
    check_float_path("gbt_fit", counts, expected)
    if not torch.isfinite(est.ensemble_["leaf"]).all():
        fail("gbt_fit", "non-finite leaf values")
    if not (np.isfinite(proba).all() and proba.shape == (len(yte), 2)):
        fail("gbt_fit", f"bad probabilities, shape {proba.shape}")
    if not auc >= bar:
        fail("gbt_fit", f"test AUC {auc:.5f} below the bar {bar:.5f}")
    return counts["binned_left_stats"], counts["bin_codes"], chunks


def phase_gbt_hist_kernels(split, R: int) -> dict:
    """The float accumulator on one chunk of config 7's fit (replicas
    0..R-1), at each level of round 0 and of the last round, in bf16 and
    fp32 operand modes (``float_hist_row``)."""
    Xtr, ytr = split[:2]
    depth, rounds = GBT["max_depth"], GBT["n_rounds"]
    last = depth * (rounds - 1)
    rec = record_levels(Xtr, ytr, R,
                        est=gbt_bagger(R, split_impl="fused", chunk_size=R),
                        keep=lambda i: i < depth or i >= last)
    calls = rec["levels"]
    want = [*range(depth), *range(last, last + depth)]
    if [c["i"] for c in calls] != want or \
            [c["N"] for c in calls] != [2**lv for lv in range(depth)] * 2:
        fail("gbt_hist_kernels", f"recorded calls {[c['i'] for c in calls]}"
             f" of {[c['N'] for c in calls]} nodes")
    rows = {}
    for c in calls:
        rnd = 0 if c["i"] < depth else rounds - 1
        for mode in ("bfloat16", "float32"):
            rows[rnd, c["N"], mode] = float_hist_row(
                "gbt_hist_kernels", c, R, mode, round=rnd)
    del calls, rec
    torch.cuda.empty_cache()
    return rows


def phase_gbt_cross_check(split) -> None:
    """Config 7's GBTs (4 replicas, 10 rounds) grown with the kernel and
    with the dense product on the card: round 0's split features equal
    in at least GBT_CROSS_FEATURE_SHARE, test AUC within
    GBT_CROSS_AUC_TOL."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    Xtr, ytr, Xte, yte = split
    M = 2**GBT["max_depth"] - 1
    fits, auc = {}, {}
    for impl in ("fused", "dense"):
        fits[impl] = gbt_bagger(split_impl=impl, **GBT_CROSS).fit(Xtr, ytr)
        auc[impl] = roc_auc(yte, fits[impl].predict_proba(Xte)[:, 1])
        torch.cuda.empty_cache()
    feats = [fits[k].ensemble_["feature"] for k in ("fused", "dense")]
    round0 = float((feats[0][:, :M] == feats[1][:, :M]).float().mean())
    every = float((feats[0] == feats[1]).float().mean())
    d_auc = abs(auc["fused"] - auc["dense"])
    ok = round0 >= GBT_CROSS_FEATURE_SHARE and d_auc <= GBT_CROSS_AUC_TOL
    emit("gbt_cross_check", ok=ok, rows=len(ytr), **GBT_CROSS,
         round0_equal_split_feature_share=round0,
         equal_split_feature_share=every,
         all_splits_equal=all(torch.equal(fits["fused"].ensemble_[k],
                                          fits["dense"].ensemble_[k])
                              for k in ("feature", "threshold")),
         test_auc_fused=auc["fused"], test_auc_dense=auc["dense"],
         auc_diff=d_auc, auc_tol=GBT_CROSS_AUC_TOL,
         feature_share_bar=GBT_CROSS_FEATURE_SHARE)
    if not ok:
        fail("gbt_cross_check", f"round-0 features equal {round0:.3f} (bar "
             f"{GBT_CROSS_FEATURE_SHARE}), AUC differs by {d_auc:.5f}")


def phase_gbt_multiclass_fit(X: np.ndarray, y: np.ndarray):
    """Multiclass GBTs on the covtype data (7 classes): the R x 7 class
    trees of a round grow together, one histogram launch a level."""
    import types

    from spark_bagging_tpu_torch import BaggingClassifier, GBTClassifier
    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    R = GBT_MC["n_estimators"]
    est = BaggingClassifier(
        GBTClassifier(n_rounds=GBT_MC["n_rounds"],
                      max_depth=GBT_MC["max_depth"]),
        n_estimators=R, seed=0)
    trees = []

    def level(codes, edges, node, S, **kw):
        trees.append(S.shape[0])
        return hist_ops.coded_left_stats(codes, edges, node, S, **kw)

    tree_mod.hist_ops = types.SimpleNamespace(
        **{**vars(hist_ops), "coded_left_stats": level})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        est.fit(X, y)
    finally:
        tree_mod.hist_ops = hist_ops
    counts = read_launches()
    rep = est.fit_report_
    expected, chunks = expected_launches(
        rep, R, GBT_MC["max_depth"] * GBT_MC["n_rounds"])
    acc = est.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    bar = GBT_MC_PROXY_ACC - PARITY_TOL
    emit("gbt_multiclass_fit", ok=True, n_rows=len(y), n_classes=N_CLASSES,
         **GBT_MC, fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"],
         chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         trees_per_launch=sorted(set(trees)), launches=counts,
         expected_binned_left_stats_launches=expected,
         accuracy_100k=acc, proxy_accuracy_100k=GBT_MC_PROXY_ACC,
         acc_bar=bar)
    check_float_path("gbt_multiclass_fit", counts, expected)
    if sorted(set(trees)) != sorted({c * N_CLASSES for c in chunks}):
        fail("gbt_multiclass_fit", f"trees a launch {sorted(set(trees))}, "
             f"expected the chunks {chunks} x {N_CLASSES} classes")
    if not torch.isfinite(est.ensemble_["leaf"]).all():
        fail("gbt_multiclass_fit", "non-finite leaf values")
    if not acc >= bar:
        fail("gbt_multiclass_fit", f"accuracy {acc:.5f} below the bar "
             f"{bar:.5f}")
    return counts["binned_left_stats"], counts["bin_codes"]


def phase_gbt_reg_fit(split):
    """Bagged GBT regressors on the California split: test R^2 against
    the sklearn proxy."""
    from spark_bagging_tpu_torch import BaggingRegressor, GBTRegressor
    from spark_bagging_tpu_torch.utils.metrics import r2_score

    Xtr, ytr, Xte, yte = split
    R = GBT_REG["n_estimators"]
    est = BaggingRegressor(
        GBTRegressor(n_rounds=GBT_REG["n_rounds"],
                     max_depth=GBT_REG["max_depth"]),
        n_estimators=R, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est.fit(Xtr, ytr)
    counts = read_launches()
    rep = est.fit_report_
    expected, _ = expected_launches(
        rep, R, GBT_REG["max_depth"] * GBT_REG["n_rounds"])
    r2 = r2_score(yte, est.predict(Xte))
    bar = GBT_REG_PROXY_R2 - PARITY_TOL
    emit("gbt_reg_fit", ok=True, n_train=len(ytr), n_test=len(yte),
         **GBT_REG, fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"],
         chunk_size=rep["chunk_size_resolved"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_binned_left_stats_launches=expected,
         test_r2=r2, proxy_r2=GBT_REG_PROXY_R2, r2_bar=bar)
    check_float_path("gbt_reg_fit", counts, expected)
    if not torch.isfinite(est.ensemble_["leaf"]).all():
        fail("gbt_reg_fit", "non-finite leaf values")
    if not r2 >= bar:
        fail("gbt_reg_fit", f"test R^2 {r2:.5f} below the bar {bar:.5f}")
    return counts["binned_left_stats"], counts["bin_codes"]


def tree_stream_source(X: np.ndarray, y: np.ndarray, chunk_rows: int):
    from spark_bagging_tpu_torch.utils.io import ArrayChunks

    return ArrayChunks(X, y, chunk_rows)


def stream_levels(chunk_rows: int, n_rows: int, levels: int) -> int:
    """Histogram (and bin-codes) launches of a streamed tree fit: one a
    chunk a level."""
    return levels * -(-n_rows // chunk_rows)


def phase_tree_stream_fit(X: np.ndarray, y: np.ndarray, acc_in_memory: float):
    """Config 3's learner streamed: 256 depth-5 trees over the covtype
    rows in 65,536-row chunks, 7 passes; every chunk's level table from
    the bin-codes and histogram kernels, all int32."""
    classes = np.unique(y)
    tree_bagger(8, seed=1).fit_stream(
        tree_stream_source(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS],
                           TREE_STREAM_CHUNK), classes=classes)
    torch.cuda.empty_cache()
    clf = tree_bagger(N_REPLICAS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    clf.fit_stream(tree_stream_source(X, y, TREE_STREAM_CHUNK),
                   classes=classes)
    counts = read_launches()
    rep = clf.fit_report_
    expected = stream_levels(TREE_STREAM_CHUNK, N_ROWS, TREE["max_depth"])
    acc = clf.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    majority = float(np.unique(y[:N_SERVE_ROWS], return_counts=True)[1].max()
                     / N_SERVE_ROWS)
    emit("tree_stream_fit", ok=True, n_rows=N_ROWS, n_replicas=N_REPLICAS,
         chunk_rows=TREE_STREAM_CHUNK, n_chunks=rep["n_chunks"],
         n_passes=rep["n_passes"], fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"],
         first_step_seconds=rep["compile_seconds"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_launches_each=expected,
         accuracy_100k=acc, accuracy_in_memory=acc_in_memory,
         majority_share_100k=majority)
    if (counts["binned_left_stats"] != expected or counts["bin_codes"] != expected
            or counts["binned_left_stats_float"] or counts["scaled_gram"]):
        fail("tree_stream_fit", f"launches {counts}, expected {expected} "
             "histogram (all int32) and bin-codes launches")
    if not (acc > majority and abs(acc - acc_in_memory) <= TREE_STREAM_ACC_TOL):
        fail("tree_stream_fit", f"accuracy {acc:.5f}: majority share "
             f"{majority:.5f}, in-memory fit {acc_in_memory:.5f} "
             f"(within {TREE_STREAM_ACC_TOL})")
    if not torch.isfinite(clf.ensemble_["leaf_logp"]).all():
        fail("tree_stream_fit", "non-finite leaf log-probabilities")
    return clf, counts["binned_left_stats"], counts["bin_codes"]


def record_stream_levels(fit, n_chunks: int) -> list:
    """Every level's ``_chunk_level_hist`` call of the streamed tree fit
    ``fit()`` (``n_chunks`` chunks) for the first chunk and the padded
    tail: the call's inputs and the table the fit got from it. The fit
    runs through a recording wrapper put in the tree learners' place
    only (the kernel wrappers and their launch counts are left alone)."""
    from spark_bagging_tpu_torch.models.tree import _TreeBase

    keep = {0, n_chunks - 1}
    calls, rec = [0], []
    original = _TreeBase._chunk_level_hist

    def recorder(self, Xc, S, edges, node, N, cols=None, integral=False):
        out = original(self, Xc, S, edges, node, N, cols=cols,
                       integral=integral)
        if calls[0] % n_chunks in keep:
            rec.append(dict(chunk=calls[0] % n_chunks, X=Xc, S=S,
                            edges=edges, node=node.clone(), N=N, cols=cols,
                            integral=integral, out=out.clone()))
        calls[0] += 1
        return out

    _TreeBase._chunk_level_hist = recorder
    try:
        fit()
    finally:
        _TreeBase._chunk_level_hist = original
    return rec


def phase_tree_stream_hist_kernels(X: np.ndarray, y: np.ndarray) -> float:
    """Every level's per-chunk table of config 3's streamed fit, for the
    first (full) chunk and the padded tail: the kernel path of
    ``_chunk_level_hist`` (bin codes of the chunk, then the histogram
    through each replica's columns) bit for bit against its plain
    version (the plain codes, the plain histogram) for every replica,
    with the times a call of the kernel route's step (bin codes and
    histogram), of the plain version and of the library yardstick
    (``torch.searchsorted`` and ``hist_library_ms``'s ``index_add_``
    form), and the step's bytes bound."""
    from spark_bagging_tpu_torch.models.tree import DecisionTreeClassifier
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    rec = record_stream_levels(
        lambda: tree_bagger(N_REPLICAS).fit_stream(
            tree_stream_source(X, y, TREE_STREAM_CHUNK), classes=np.unique(y)),
        -(-N_ROWS // TREE_STREAM_CHUNK))
    learner = DecisionTreeClassifier(split_impl="fused", **TREE)
    worst = 0.0
    for c in rec:
        Xc, S, E, node, N, cols = (c[k] for k in ("X", "S", "edges", "node",
                                                  "N", "cols"))
        out = c["out"]
        codes = hist_ops.bin_codes(Xc, E)
        codes_plain = hist_ops.bin_codes_plain(Xc, E)
        Er = E[cols.long()]
        spans, unequal, max_abs = [], 0, 0.0
        for r in range(S.shape[0]):
            box = []
            spans.append(span(lambda: box.append(
                hist_ops.coded_left_stats_plain(
                    codes_plain, Er[r:r + 1], node[r:r + 1], S[r:r + 1],
                    n_nodes=N, hist_dtype=learner.hist_dtype,
                    cols=cols[r:r + 1]))))
            unequal += not torch.equal(out[r], box[0][0])
            max_abs = max(max_abs, float((out[r] - box[0][0]).abs().max()))
        plain_ms = timed_spans(spans)
        kernel_ms = cuda_ms(lambda: learner._chunk_level_hist(
            Xc, S, E, node, N, cols=cols, integral=c["integral"]), 3)
        # the library yardstick of the step: torch.searchsorted for the
        # chunk's codes, then the histogram form (index_add_ + cumsum)
        # of each replica through its columns
        Et, Xt = E.contiguous(), Xc.t().contiguous()
        lib_ms = (cuda_ms(lambda: torch.searchsorted(Et, Xt), 3)
                  + hist_library_ms(codes, cols, Er, node, S, N,
                                    learner.hist_dtype)["index_add"])
        codes_unequal = int((codes != codes_plain).sum())
        n_valid = int((S.sum(dim=(0, 2)) > 0).sum())
        # the chunk step's least bytes: the chunk's X, the edges, columns,
        # nodes and statistics read once, the table written once
        nbytes = 4.0 * (Xc.numel() + E.numel() + cols.numel() + node.numel()
                        + S.numel() + out.numel())
        emit("tree_stream_hist_kernels", chunk=c["chunk"], N=N,
             rows=Xc.shape[0], rows_weighted=n_valid,
             replicas=S.shape[0], replicas_unequal=unequal,
             max_abs_err=max_abs, codes_unequal=codes_unequal,
             integral=c["integral"], step_kernel_ms=kernel_ms,
             plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes")
        if unequal or codes_unequal or not c["integral"]:
            fail("tree_stream_hist_kernels", f"chunk {c['chunk']} N={N}: "
                 f"{unequal} replicas and {codes_unequal} codes unequal "
                 f"(integral {c['integral']})")
        worst = max(worst, max_abs)
        del out, codes, codes_plain, Er
    if len(rec) != 2 * TREE["max_depth"]:
        fail("tree_stream_hist_kernels", f"{len(rec)} level tables recorded")
    del rec
    torch.cuda.empty_cache()
    return worst


def phase_tree_stream_cross_check(X: np.ndarray, y: np.ndarray) -> None:
    """The same stream with the kernel and with the dense product on the
    card grows the same trees, bit for bit."""
    ens = {}
    for impl in ("fused", "dense"):
        ens[impl] = tree_bagger(N_TREE_CROSS_REPLICAS, split_impl=impl) \
            .fit_stream(tree_stream_source(X, y, TREE_STREAM_CHUNK),
                        classes=np.unique(y)).ensemble_
        torch.cuda.empty_cache()
    same = {k: bool(torch.equal(ens["fused"][k], ens["dense"][k]))
            for k in ("feature", "threshold", "gain", "leaf_logp")}
    emit("tree_stream_cross_check", ok=all(same.values()), rows=N_ROWS,
         replicas=N_TREE_CROSS_REPLICAS, equal=same)
    if not all(same.values()):
        fail("tree_stream_cross_check", f"fused and dense trees differ: {same}")


def phase_rf_reg_stream_fit(split):
    """The forest regressor streamed over the California training split
    in 4,096-row chunks: the float accumulator at every chunk's level."""
    from spark_bagging_tpu_torch.utils.metrics import r2_score

    Xtr, ytr, Xte, yte = split
    est = rf_regressor()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est.fit_stream(tree_stream_source(Xtr, ytr, RF_STREAM_CHUNK))
    counts = read_launches()
    rep = est.fit_report_
    expected = stream_levels(RF_STREAM_CHUNK, len(ytr), RF_REG["max_depth"])
    r2 = r2_score(yte, est.predict(Xte))
    emit("rf_reg_stream_fit", ok=True, n_train=len(ytr),
         chunk_rows=RF_STREAM_CHUNK, n_chunks=rep["n_chunks"],
         n_replicas=RF_REG["n_estimators"], fit_seconds=rep["fit_seconds"],
         fits_per_sec=rep["fits_per_sec"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=counts, expected_launches_each=expected,
         float_accumulator_launches=counts["binned_left_stats_float"],
         test_r2=r2, r2_bar=RF_R2_BAR)
    if (counts["binned_left_stats"] != expected
            or counts["binned_left_stats_float"] != expected
            or counts["bin_codes"] != expected or counts["scaled_gram"]):
        fail("rf_reg_stream_fit", f"launches {counts}, expected {expected} "
             "float histogram and bin-codes launches")
    if not r2 > RF_R2_BAR:
        fail("rf_reg_stream_fit", f"test R^2 {r2:.4f} not above {RF_R2_BAR}")
    return counts["binned_left_stats"], counts["bin_codes"]


def phase_rf_reg_stream_hist_kernels(split) -> dict:
    """Every level's per-chunk table of the streamed forest regressor
    (``phase_rf_reg_stream_fit``'s fit: 128 replicas, 4,096-row chunks),
    for the first chunk and the padded tail (128 valid rows of 4,096):
    the bin codes of the chunk bit for bit against their plain version,
    and the float accumulator's table, the fit's own and the kernel's
    on the same inputs, within HIST_FLOAT_TOL of the plain version
    summed in float64 for every replica (``float_hist_row``)."""
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    Xtr, ytr = split[:2]
    n_chunks = -(-len(ytr) // RF_STREAM_CHUNK)
    learner_box = []

    def fit():
        est = rf_regressor().fit_stream(
            tree_stream_source(Xtr, ytr, RF_STREAM_CHUNK))
        learner_box.append(est._fitted_learner)

    rec = record_stream_levels(fit, n_chunks)
    learner = learner_box[0]
    levels = RF_REG["max_depth"]
    if [(c["chunk"], c["N"]) for c in rec] != [
            (ch, 2**lv) for lv in range(levels) for ch in (0, n_chunks - 1)]:
        fail("rf_reg_stream_hist_kernels", "recorded (chunk, N) "
             f"{[(c['chunk'], c['N']) for c in rec]}")
    rows = {}
    for c in rec:
        if c["integral"]:
            fail("rf_reg_stream_hist_kernels", "the stream passed integral "
                 "statistics")
        # the kernel route's inputs, as _chunk_level_hist makes them
        prepared = learner._binned(c["X"], c["edges"])
        codes_unequal = int((prepared["codes"] != hist_ops.bin_codes_plain(
            c["X"], c["edges"])).sum())
        if c["cols"] is not None:
            prepared = learner.gather_subspace(prepared, c["cols"])
        level = dict(codes=prepared["codes"], cols=prepared.get("cols"),
                     edges=prepared["edges"], node=c["node"], S=c["S"],
                     N=c["N"], integral=False)
        R = c["S"].shape[0]
        rows[c["chunk"], c["N"]] = float_hist_row(
            "rf_reg_stream_hist_kernels", level, R,
            learner._hdt(c["S"].device), fit_out=c["out"], chunk=c["chunk"],
            rows_weighted=int((c["S"].abs().sum(dim=(0, 2)) > 0).sum()),
            codes_unequal=codes_unequal)
        if codes_unequal:
            fail("rf_reg_stream_hist_kernels", f"chunk {c['chunk']} N="
                 f"{c['N']}: {codes_unequal} bin codes unequal")
    del rec
    torch.cuda.empty_cache()
    return rows


def mlp_source(n_rows: int, chunk_rows: int):
    """Config 4's stream: synthetic HIGGS chunks made on demand, the
    mixture pinned by seed 11."""
    from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs
    from spark_bagging_tpu_torch.utils.io import SyntheticChunks

    return SyntheticChunks(synthetic_higgs, n_rows, chunk_rows, seed=11)


def mlp_test_data(n_rows: int = N_MLP_TEST_ROWS):
    from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs

    return synthetic_higgs(n_rows, seed=999_001, structure_seed=11)


def mlp_bagger(n_estimators: int, device: str = "cuda", **mlp):
    from spark_bagging_tpu_torch import BaggingClassifier, MLPClassifier

    return BaggingClassifier(MLPClassifier(**{**MLP, **mlp}),
                             n_estimators=n_estimators, seed=0, device=device)


def stream_pace(make_source, make_est, fit_kw: dict,
                n_chunks: int = 10) -> dict:
    """The pace of a synthetic stream a chunk: the host's ms to make one
    chunk (the source's own generation, the median of the first
    ``n_chunks``), and the device's ms from a profile of the engine
    itself (``profile_fit.profile_device``) fitting ``make_est()`` on
    ``make_source(n_chunks)``, the stream cut to ``n_chunks`` chunks: the
    bootstrap draws' kernels and the rest of the device's work (the
    chunk copies and the optimizer steps)."""
    from spark_bagging_tpu_torch.profile_fit import profile_device

    host, it = [], make_source(n_chunks).chunks()
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        next(it)
        host.append(time.perf_counter() - t0)
    it.close()
    est = make_est()
    prof = profile_device(lambda: est.fit_stream(make_source(n_chunks),
                                                 **fit_kw))
    boot = prof["bootstrap_device_seconds"] or 0.0
    return {"host_chunk_ms": 1e3 * float(np.median(host)),
            "bootstrap_ms": 1e3 * boot / n_chunks,
            "other_device_ms": 1e3 * (prof["device_busy_seconds"] - boot)
            / n_chunks,
            "profiled_chunks": n_chunks,
            "profiled_idle_share": prof["idle_share"]}


def phase_mlp_stream_fit() -> None:
    """BASELINE config 4 at full size: 512 bagged MLPs streamed over
    11,000,000 synthetic HIGGS rows (550 chunks, 1,100 Adam steps); the
    test AUC against sklearn's proxy, a warm ``predict_proba`` of the
    200,000 test rows, and the pace of the host's chunk making against
    the device's chunk visits."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    cfg = MLP_STREAM
    fit_kw = dict(classes=[0, 1], n_epochs=cfg["n_epochs"],
                  steps_per_chunk=cfg["steps_per_chunk"], lr=cfg["lr"])
    Xte, yte = mlp_test_data()
    t0 = time.perf_counter()
    mlp_bagger(16).fit_stream(mlp_source(40_000, cfg["chunk_rows"]), **fit_kw)
    warmup_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    est = mlp_bagger(cfg["n_estimators"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    est.fit_stream(mlp_source(cfg["n_rows"], cfg["chunk_rows"]), **fit_kw)
    stream_seconds = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = est.fit_report_
    est.predict_proba(Xte)  # warm-up
    t0 = time.perf_counter()
    proba = est.predict_proba(Xte)
    predict_seconds = time.perf_counter() - t0
    auc = roc_auc(yte, proba[:, 1])
    bar = MLP_PROXY_AUC - PARITY_TOL
    pace = stream_pace(
        lambda k: mlp_source(k * cfg["chunk_rows"], cfg["chunk_rows"]),
        lambda: mlp_bagger(cfg["n_estimators"]), fit_kw)
    n_chunks = -(-cfg["n_rows"] // cfg["chunk_rows"])
    device_ms = pace["bootstrap_ms"] + pace["other_device_ms"]
    emit("mlp_stream_fit", ok=True, **cfg, hidden=MLP["hidden"],
         n_test=len(yte),
         warmup_fit_seconds=warmup_seconds, stream_seconds=stream_seconds,
         fit_seconds=rep["fit_seconds"],
         first_step_seconds=rep["compile_seconds"],
         row_replica_per_sec=cfg["n_rows"] * cfg["n_epochs"]
         * cfg["n_estimators"] / stream_seconds,
         fits_per_sec=rep["fits_per_sec"], n_chunks=rep["n_chunks"],
         opt_steps=rep["opt_steps"], achieved_tflops=rep["achieved_tflops"],
         peak_mem_gb=peak, launches=counts, test_auc=auc,
         proxy_auc=MLP_PROXY_AUC, auc_bar=bar,
         predict_proba_seconds=predict_seconds,
         predict_proba_rows_per_sec=len(yte) / predict_seconds,
         **pace, host_seconds_per_stream=pace["host_chunk_ms"] * n_chunks / 1e3,
         device_seconds_per_stream=device_ms * n_chunks / 1e3,
         bootstrap_share_of_device=pace["bootstrap_ms"] / device_ms,
         pace_set_by="host" if pace["host_chunk_ms"] > device_ms else "device")
    if rep["n_chunks"] != n_chunks or rep["opt_steps"] != n_chunks * cfg[
            "n_epochs"] * cfg["steps_per_chunk"]:
        fail("mlp_stream_fit", f"{rep['n_chunks']} chunks, {rep['opt_steps']} "
             "optimizer steps")
    if any(counts.values()):
        fail("mlp_stream_fit", f"launches {counts}: the MLP stream runs no "
             "kernel of the repo")
    if not (np.isfinite(proba).all() and proba.shape == (len(yte), 2)):
        fail("mlp_stream_fit", f"bad probabilities, shape {proba.shape}")
    if not auc >= bar:
        fail("mlp_stream_fit", f"test AUC {auc:.5f} below the bar {bar:.5f}")
    return est


def phase_mlp_device_check() -> None:
    """Config 4's learner on the card against the CPU in one process: a
    small stream (16 replicas, 40,000 rows in 5,000-row chunks, 2 epochs,
    2 steps a chunk) and an in-memory minibatch fit (16 replicas, 50
    steps of 1,024 rows on 20,000 rows); probabilities within
    MLP_DEVICE_TOL and parameters within MLP_DEVICE_PARAM_TOL."""
    from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs

    cs, cf = MLP_CHECK_STREAM, MLP_CHECK_FIT
    Xi, yi = synthetic_higgs(cf["n_rows"], seed=5, structure_seed=11)
    Xte, _ = mlp_test_data(10_000)
    fits = {}
    for dev in ("cuda", "cpu"):
        stream = mlp_bagger(cs["n_estimators"], device=dev).fit_stream(
            mlp_source(cs["n_rows"], cs["chunk_rows"]), classes=[0, 1],
            n_epochs=cs["n_epochs"], steps_per_chunk=cs["steps_per_chunk"],
            lr=MLP["lr"])
        mem = mlp_bagger(cf["n_estimators"], device=dev,
                         max_iter=cf["max_iter"],
                         batch_size=cf["batch_size"]).fit(Xi, yi)
        fits[dev] = (stream, mem)
    errs = {}
    for i, name in enumerate(("stream", "in_memory")):
        a, b = fits["cuda"][i], fits["cpu"][i]
        errs[name] = {
            **{k: float((v.cpu() - b.ensemble_[k]).abs().max())
               for k, v in a.ensemble_.items()},
            "predict_proba": float(np.abs(a.predict_proba(Xte)
                                          - b.predict_proba(Xte)).max()),
        }
    proba = max(e.pop("predict_proba") for e in errs.values())
    param = max(v for e in errs.values() for v in e.values())
    ok = proba <= MLP_DEVICE_TOL and param <= MLP_DEVICE_PARAM_TOL
    emit("mlp_device_check", ok=ok, stream=cs, in_memory=cf,
         max_abs_err=errs, predict_proba_max_abs_err=proba,
         proba_tol=MLP_DEVICE_TOL, param_tol=MLP_DEVICE_PARAM_TOL)
    if not ok:
        fail("mlp_device_check", f"card and CPU differ by {param:.3g} in "
             f"parameters (tol {MLP_DEVICE_PARAM_TOL}) and {proba:.3g} in "
             f"probabilities (tol {MLP_DEVICE_TOL})")


def zoo_device_check(make_est, X, y, fit_kw: dict, tol: tuple,
                     stream=None) -> dict:
    """The learner on the card against the CPU port (``device="cpu"``),
    ZOO_CHECK's replicas on its first rows: the largest parameter and
    prediction differences over ``max(1, |CPU value|)``, and whether they
    are within ``tol`` (parameters, predictions). ``stream``: a callable
    ``(est) -> est`` fitting a stream instead of ``fit``."""
    n = ZOO_CHECK["n_rows"]
    Xs, ys = X[:n], y[:n]
    kw = {k: v[:n] for k, v in fit_kw.items()}
    fits = {}
    for dev in ("cuda", "cpu"):
        est = make_est(ZOO_CHECK["n_estimators"], dev)
        fits[dev] = stream(est) if stream else est.fit(Xs, ys, **kw)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    card, cpu = fits["cuda"], fits["cpu"]
    param = max(rel(v.cpu().numpy(), cpu.ensemble_[k].numpy())
                for k, v in card.ensemble_.items())
    predict = (card.predict_proba if hasattr(card, "predict_proba")
               else card.predict)
    cpu_predict = (cpu.predict_proba if hasattr(cpu, "predict_proba")
                   else cpu.predict)
    Xe = Xs[:, :card.n_features_in_]
    pred = rel(predict(Xe), cpu_predict(Xe))
    return dict(replicas=ZOO_CHECK["n_estimators"], rows=len(ys),
                param_rel_err=param, pred_rel_err=pred, param_tol=tol[0],
                pred_tol=tol[1], ok=param <= tol[0] and pred <= tol[1])


def zoo_phase(phase: str, make_est, X, y, R: int, quality, tol: tuple,
              fit_kw: dict | None = None, X_pred=None) -> None:
    """One learner of the zoo through the estimator a user calls: fit R
    replicas on the card (launch counts set to 0 just before, read just
    after: the zoo's products are torch matmuls, as the JAX package's
    are XLA's, so none is expected), a warm predict of ``X_pred``, the
    quality figure ``quality(est) -> (fields, ok)`` and the device check
    (``zoo_device_check``). One JSON line; a failed check fails the
    phase."""
    fit_kw = fit_kw or {}
    X_pred = X if X_pred is None else X_pred
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est = make_est(R, "cuda").fit(X, y, **fit_kw)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rep = est.fit_report_
    predict = (est.predict_proba if hasattr(est, "predict_proba")
               else est.predict)
    predict(X_pred)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict(X_pred)
    pred_s = time.perf_counter() - t0
    fields, good = quality(est)
    del est
    torch.cuda.empty_cache()
    check = zoo_device_check(make_est, X, y, fit_kw, tol)
    ok = good and check["ok"]
    emit(phase, ok=ok, replicas=R, rows=len(y), features=X.shape[1],
         fit_seconds=rep["fit_seconds"], fits_per_sec=rep["fits_per_sec"],
         chunk_size=rep["chunk_size_resolved"], peak_mem_gb=peak,
         predict_rows=len(X_pred), predict_rows_per_sec=len(X_pred) / pred_s,
         launches=launches, **fields, device_check=check)
    if not ok:
        fail(phase, f"quality {fields} (ok {good}), device check {check}")


def accuracy_quality(X, y, abs_x: bool = False):
    """Accuracy on the first N_SERVE_ROWS rows, above the majority share."""
    from spark_bagging_tpu_torch.utils.metrics import accuracy

    Xe, ye = X[:N_SERVE_ROWS], y[:N_SERVE_ROWS]
    Xe = np.abs(Xe) if abs_x else Xe
    floor = float(np.bincount(ye).max() / len(ye))

    def q(est):
        acc = accuracy(ye, est.predict(Xe))
        return dict(accuracy=acc, majority_share=floor), acc > floor

    return q


def phase_zoo_classifiers(X: np.ndarray, y: np.ndarray) -> None:
    """The zoo's classifiers on the covtype rows: ``LinearSVC(max_iter=8)``
    and the three naive Bayes learners (``MultinomialNB`` on ``|X|``),
    ZOO_REPLICAS each; ``FMClassifier(factor_size=8, max_iter=100)`` and
    ``LogisticRegression(solver="adam", max_iter=100)``, ZOO_ADAM_REPLICAS
    each; and ``GeneralizedLinearRegression(family="binomial")`` on
    ``y == 1``, ZOO_REPLICAS, its accuracy at 0.5 above the constant's."""
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        BaggingRegressor,
        BernoulliNB,
        FMClassifier,
        GaussianNB,
        GeneralizedLinearRegression,
        LinearSVC,
        LogisticRegression,
        MultinomialNB,
    )

    learners = [
        ("zoo_svc", lambda: LinearSVC(max_iter=8), ZOO_REPLICAS, "svc", False),
        ("zoo_gaussian_nb", GaussianNB, ZOO_REPLICAS, "nb", False),
        ("zoo_bernoulli_nb", BernoulliNB, ZOO_REPLICAS, "nb", False),
        ("zoo_multinomial_nb", MultinomialNB, ZOO_REPLICAS, "nb", True),
        ("zoo_fm_classifier",
         lambda: FMClassifier(factor_size=8, max_iter=100),
         ZOO_ADAM_REPLICAS, "fm", False),
        ("zoo_logistic_adam",
         lambda: LogisticRegression(solver="adam", max_iter=100),
         ZOO_ADAM_REPLICAS, "logistic_adam", False),
    ]
    for phase, learner, R, tol, abs_x in learners:
        Xp = np.abs(X) if abs_x else X
        zoo_phase(phase, lambda r, dev, learner=learner: BaggingClassifier(
            learner(), n_estimators=r, seed=0, device=dev), Xp, y, R,
            accuracy_quality(X, y, abs_x), ZOO_TOL[tol],
            X_pred=Xp[:N_SERVE_ROWS])
    yb = (y == 1).astype(np.float32)
    Xe, ye = X[:N_SERVE_ROWS], yb[:N_SERVE_ROWS]

    def binomial_quality(est):
        acc = float(((est.predict(Xe) > 0.5) == (ye > 0.5)).mean())
        const = float(max(ye.mean(), 1.0 - ye.mean()))
        return dict(accuracy=acc, constant_accuracy=const), acc > const

    zoo_phase("zoo_glm_binomial", lambda r, dev: BaggingRegressor(
        GeneralizedLinearRegression(family="binomial"), n_estimators=r,
        seed=0, device=dev), X, yb, ZOO_REPLICAS, binomial_quality,
        ZOO_TOL["glm_binomial"], X_pred=Xe)


def survival_data(split):
    """Survival times from the California target: ``t = y - min(y_train)
    + 1``, the top AFT_CENSORED of the training times right-censored at
    their quantile (as examples/06_learner_zoo.py): ``(t observed,
    censor flags, t of the test rows)``."""
    ytr, yte = split[1], split[3]
    base = float(ytr.min()) - 1.0
    t = (ytr - base).astype(np.float32)
    cut = float(np.quantile(t, 1.0 - AFT_CENSORED))
    cens = (t <= cut).astype(np.float32)
    return np.minimum(t, cut).astype(np.float32), cens, \
        (yte - base).astype(np.float32)


def phase_zoo_regressors(split) -> None:
    """The zoo's regressors on config 2's California split, ZOO_REG_REPLICAS
    each, test R^2 above 0 (a constant's): ``GeneralizedLinearRegression``
    gaussian on y, and poisson, gamma and tweedie on a positive target
    (the synthetic target runs negative: ``(y - min y + 1) / mean``);
    ``FMRegressor`` on standardized y; ``IsotonicRegression(n_bins=128,
    increasing=False)`` (column 0 of the synthetic data falls with y,
    correlation -0.36); ``AFTSurvivalRegression`` with AFT_CENSORED of
    the rows censored through ``aux``: the correlation of its predictions
    with the test rows' times above 0.5, and ``predict_quantiles``
    finite and rising in p."""
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BaggingRegressor,
        FMRegressor,
        GeneralizedLinearRegression,
        IsotonicRegression,
    )
    from spark_bagging_tpu_torch.utils.metrics import r2_score

    Xtr, ytr, Xte, yte = split
    pos_base = float(ytr.min()) - 1.0
    pos_mean = float((ytr - pos_base).mean())
    mu, sd = float(ytr.mean()), float(ytr.std())
    targets = {
        "identity": (ytr, yte),
        "positive": ((ytr - pos_base) / pos_mean, (yte - pos_base) / pos_mean),
        "standard": ((ytr - mu) / sd, (yte - mu) / sd),
    }

    def r2_quality(y_test):
        def q(est):
            r2 = r2_score(y_test, est.predict(Xte))
            return dict(test_r2=r2), r2 > 0.0
        return q

    learners = [
        ("zoo_glm_gaussian", lambda: GeneralizedLinearRegression(),
         "identity"),
        ("zoo_glm_poisson",
         lambda: GeneralizedLinearRegression(family="poisson"), "positive"),
        ("zoo_glm_gamma",
         lambda: GeneralizedLinearRegression(family="gamma"), "positive"),
        ("zoo_glm_tweedie",
         lambda: GeneralizedLinearRegression(family="tweedie"), "positive"),
        ("zoo_fm_regressor", lambda: FMRegressor(factor_size=8), "standard"),
        ("zoo_isotonic",
         lambda: IsotonicRegression(n_bins=128, increasing=False),
         "identity"),
    ]
    for phase, learner, target in learners:
        y_tr, y_te = (np.asarray(a, np.float32) for a in targets[target])
        tol = ZOO_TOL["fm" if "fm" in phase else
                      "iso" if "isotonic" in phase else "glm"]
        zoo_phase(phase, lambda r, dev, learner=learner: BaggingRegressor(
            learner(), n_estimators=r, seed=0, device=dev), Xtr, y_tr,
            ZOO_REG_REPLICAS, r2_quality(y_te), tol, X_pred=Xte)
    t_obs, cens, t_test = survival_data(split)

    def aft_quality(est):
        corr = float(np.corrcoef(est.predict(Xte), t_test)[0, 1])
        q = est.predict_quantiles(Xte, (0.1, 0.5, 0.9))
        rising = bool(np.isfinite(q).all() and (np.diff(q, axis=1) > 0).all())
        return (dict(corr_with_test_times=corr, quantiles_shape=list(q.shape),
                     quantiles_finite_rising=rising,
                     censored_share=float(1.0 - cens.mean())),
                corr > 0.5 and rising)

    zoo_phase("zoo_aft", lambda r, dev: BaggingRegressor(
        AFTSurvivalRegression(), n_estimators=r, seed=0, device=dev), Xtr,
        t_obs, ZOO_REG_REPLICAS, aft_quality, ZOO_TOL["aft"],
        fit_kw={"aux": cens}, X_pred=Xte)


def phase_zoo_streams(X: np.ndarray, y: np.ndarray, split) -> None:
    """Two streamed fits of the zoo: ``BaggingRegressor(
    AFTSurvivalRegression()).fit_stream`` over the California training
    rows in chunks of 4,096 with the censor flags as the last streamed
    column (``aux_col=-1``), its ``predict_stream`` of the same wide
    source dropping that column; and a ``LinearSVC`` stream over the
    covtype rows in chunks of 65,536, ZOO_REPLICAS replicas. Each with
    its quality figure and a device check on a 20,000-row stream."""
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BaggingClassifier,
        BaggingRegressor,
        LinearSVC,
    )
    from spark_bagging_tpu_torch.utils.io import ArrayChunks
    from spark_bagging_tpu_torch.utils.metrics import accuracy

    zs = ZOO_STREAM
    Xtr, Xte = split[0], split[2]
    t_obs, cens, t_test = survival_data(split)
    Xa = np.concatenate([Xtr, cens[:, None]], axis=1)
    sgd = dict(steps_per_chunk=zs["steps_per_chunk"], lr=zs["lr"],
               prefetch=0)

    def aft(r, dev):
        return BaggingRegressor(AFTSurvivalRegression(), n_estimators=r,
                                seed=0, device=dev)

    def aft_stream(est, rows=None, epochs=zs["aft_epochs"]):
        n = len(t_obs) if rows is None else rows
        return est.fit_stream(ArrayChunks(Xa[:n], t_obs[:n], zs["aft_chunk"]),
                              n_epochs=epochs, aux_col=-1, **sgd)

    def svc(r, dev):
        return BaggingClassifier(LinearSVC(), n_estimators=r, seed=0,
                                 device=dev)

    def svc_stream(est, rows=None, chunk=zs["svc_chunk"]):
        n = len(y) if rows is None else rows
        return est.fit_stream(ArrayChunks(X[:n], y[:n], chunk),
                              classes=np.unique(y), n_epochs=zs["svc_epochs"],
                              **sgd)

    n_check = ZOO_CHECK["n_rows"]
    for phase, make, run, tol_key in (
            ("zoo_aft_stream", aft, aft_stream, "aft"),
            ("zoo_svc_stream", svc, svc_stream, "stream")):
        R = ZOO_REG_REPLICAS if phase == "zoo_aft_stream" else ZOO_REPLICAS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        est = run(make(R, "cuda"))
        launches = read_launches()
        rep = est.fit_report_
        peak = torch.cuda.max_memory_allocated() / 1e9
        if phase == "zoo_aft_stream":
            Xp = Xte
            est.predict(Xp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = est.predict(Xp)
            pred_s = time.perf_counter() - t0
            corr = float(np.corrcoef(pred, t_test)[0, 1])
            wide = est.predict_stream(ArrayChunks(Xa, t_obs, zs["aft_chunk"]),
                                      drop_aux_col=True)
            same = bool(np.allclose(wide, est.predict(Xtr), rtol=1e-6,
                                    atol=0))
            fields = dict(corr_with_test_times=corr,
                          predict_stream_drops_aux_col=same,
                          n_features_in=est.n_features_in_)
            good = corr > 0.5 and same and est.n_features_in_ == Xtr.shape[1]
            check = zoo_device_check(
                make, Xa, t_obs, {}, ZOO_TOL[tol_key],
                stream=lambda e: aft_stream(e, n_check, 2))
        else:
            Xp = X[:N_SERVE_ROWS]
            est.predict_proba(Xp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.predict_proba(Xp)
            pred_s = time.perf_counter() - t0
            acc = accuracy(y[:N_SERVE_ROWS], est.predict(Xp))
            floor = float(np.bincount(y[:N_SERVE_ROWS]).max() / N_SERVE_ROWS)
            fields = dict(accuracy=acc, majority_share=floor)
            good = acc > floor
            check = zoo_device_check(
                make, X, y, {}, ZOO_TOL[tol_key],
                stream=lambda e: svc_stream(e, n_check, 5_000))
        del est
        ok = good and check["ok"]
        emit(phase, ok=ok, replicas=R, stream_seconds=rep["fit_seconds"],
             fits_per_sec=rep["fits_per_sec"], n_chunks=rep["n_chunks"],
             n_epochs=rep["n_epochs"], opt_steps=rep["opt_steps"],
             peak_mem_gb=peak, predict_rows=len(Xp),
             predict_rows_per_sec=len(Xp) / pred_s, launches=launches,
             **fields, device_check=check)
        if not ok:
            fail(phase, f"quality {fields} (ok {good}), device check {check}")


# -- the serving plane -------------------------------------------------

def serving_compiles() -> float:
    """Bucket builds so far (on the card each is one graph capture)."""
    from spark_bagging_tpu_torch import telemetry

    return telemetry.registry().counter("sbt_serving_compiles_total").value


def serving_ladders(model, X: np.ndarray, name: str, exact: bool) -> dict:
    """Register ``model`` on each ladder of SERVE_LADDERS as a fresh
    process would (an empty program cache), with warm-up; hold every
    bucket's graph replay bit for bit against the same closure run
    eagerly at that bucket, and the served output of requests of 1-300
    rows against ``predict_proba`` (bitwise for hard votes, else within
    SERVE_TOL). Returns the registry and the per-ladder facts."""
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache

    rng = np.random.default_rng(0)
    reg = ModelRegistry()
    fn, params, subs = model.aggregated_forward()
    sizes = [1, 2, 3, 7, 31, 64, 100, 255, 256, 257, 300,
             *rng.integers(1, 301, 29).tolist()]
    out = {"registry": reg}
    for ladder, opts in SERVE_LADDERS.items():
        program_cache.clear()
        c0 = serving_compiles()
        t0 = time.perf_counter()
        ex = reg.register(f"{name}_{ladder}", model, warmup=True, **opts)
        warm_s = time.perf_counter() - t0
        captures = serving_compiles() - c0
        replay_unequal = []
        for b in ex.compiled_buckets:
            Xb = X[rng.integers(0, len(X), b)]
            eager = fn(params, subs,
                       torch.from_numpy(Xb).to(subs.device)).cpu().numpy()
            if not np.array_equal(ex.program(b).run(Xb, b), eager):
                replay_unequal.append(b)
        err = 0.0
        c1 = serving_compiles()
        for n in sizes:
            i = int(rng.integers(0, len(X) - n))
            got, want = ex.forward(X[i:i + n]), model.predict_proba(X[i:i + n])
            err = max(err, float(np.abs(got - want).max()))
        post = serving_compiles() - c1
        fields = dict(buckets=list(ex.compiled_buckets),
                      captures_at_warmup=captures, warmup_seconds=warm_s,
                      graph_pool_bytes=ex.graph_pool_bytes,
                      replay_buckets_unequal_to_eager=replay_unequal,
                      requests=len(sizes), max_rows=max(sizes),
                      max_abs_err_vs_predict_proba=err,
                      tol=0.0 if exact else SERVE_TOL,
                      captures_on_requests=post)
        ok = (captures == len(ex.compiled_buckets) and not replay_unequal
              and post == 0 and err <= fields["tol"]
              and ex.graph_pool_bytes > 0)
        emit(f"{name}_ladder_{ladder}", ok=ok, **fields)
        if not ok:
            fail(f"{name}_ladder_{ladder}", f"checks failed: {fields}")
        out[ladder] = ex
    return out


def percentile(sorted_vals: list, q: float) -> float:
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def run_clients(X: np.ndarray, n_clients: int, n_requests: int, call):
    """One closed-loop run of benchmarks/serving_latency.py's naive
    path: each of ``n_clients`` threads issues its share of single-row
    requests back to back. Returns (latencies, requests a second)."""
    import threading

    per = max(1, n_requests // n_clients)
    lat, lock, gate, errors = [], threading.Lock(), threading.Event(), []

    def client(seed):
        rng = np.random.default_rng(seed)
        mine = []
        gate.wait()
        try:
            for _ in range(per):
                i = int(rng.integers(0, X.shape[0]))
                t0 = time.perf_counter()
                call(X[i:i + 1])
                mine.append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(s,))
               for s in range(n_clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    gate.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return lat, len(lat) / wall


def run_window(X: np.ndarray, window: int, n_requests: int, submit):
    """One run of serving_latency.py's served path: one dispatcher keeps
    ``window`` single-row futures in flight, refilling as they resolve.
    Returns (latencies, requests a second)."""
    from concurrent.futures import FIRST_COMPLETED, wait

    rng = np.random.default_rng(0)
    pending, lat = {}, []

    def one():
        i = int(rng.integers(0, X.shape[0]))
        pending[submit(X[i:i + 1])] = time.perf_counter()

    t0 = time.perf_counter()
    issued = 0
    for _ in range(min(window, n_requests)):
        one()
        issued += 1
    while pending:
        done = [f for f in pending if f.done()]
        if not done:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
        now = time.perf_counter()
        for f in done:
            f.result()
            lat.append(now - pending.pop(f))
            if issued < n_requests:
                one()
                issued += 1
    return lat, len(lat) / (time.perf_counter() - t0)


def measure(run_once) -> dict:
    """serving_latency.py's protocol: one discarded warm run, then the
    median requests/s of SERVE_REPEATS runs, latency percentiles pooled
    over them."""
    import statistics

    run_once()
    lat_all, rps = [], []
    for _ in range(SERVE_REPEATS):
        lat, r = run_once()
        lat_all.extend(lat)
        rps.append(r)
    lat_all.sort()
    return {"rows_per_sec": statistics.median(rps),
            "rows_per_sec_runs": sorted(rps),
            "p50_ms": percentile(lat_all, 0.5) * 1e3,
            "p99_ms": percentile(lat_all, 0.99) * 1e3}


def swap_under_traffic(reg, name: str, new_model, Xr: np.ndarray,
                       ref_a: np.ndarray, ref_b: np.ndarray):
    """Four clients' closed-loop single-row traffic on ``name`` through
    its registry batcher while ``new_model`` is swapped in mid-traffic.
    Every request must be served by the old version within SERVE_TOL of
    ``ref_a`` or by the new within SERVE_TOL of ``ref_b`` (the rows of
    ``Xr``), none may fail, the new version must serve after the swap
    and the swap's captures are its own pre-captures. Returns (facts,
    whether they hold, the new executor)."""
    import threading

    stop, errors, wrong, results = threading.Event(), [], [], []
    v_before = reg.version(name)

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i = int(rng.integers(0, len(Xr)))
            try:
                fut = b.submit(Xr[i:i + 1])
                r = fut.result(60)
            except Exception as e:  # noqa: BLE001 - counted
                errors.append(repr(e))
                continue
            version = fut.trace.breakdown.get("model_version")
            near_a = np.abs(r - ref_a[i:i + 1]).max() <= SERVE_TOL
            near_b = np.abs(r - ref_b[i:i + 1]).max() <= SERVE_TOL
            results.append(version)
            if not ((version == v_before and near_a)
                    or (version == v_before + 1 and near_b)):
                wrong.append((i, version))

    c0 = serving_compiles()
    with reg.batcher(name, **SERVE_BATCHER) as b:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        time.sleep(SERVE_SWAP_WINDOW_S)
        t0 = time.perf_counter()
        new_ex = reg.swap(name, new_model)
        swap_s = time.perf_counter() - t0
        swap_captures = serving_compiles() - c0
        time.sleep(SERVE_SWAP_WINDOW_S)
        stop.set()
        for t in threads:
            t.join(60)
        after = b.submit(Xr[:5]).result(60)
    request_captures = serving_compiles() - c0 - swap_captures
    n_after = sum(1 for v in results if v == v_before + 1)
    after_err = float(np.abs(after - ref_b[:5]).max())
    fields = dict(requests=len(results), failed=len(errors),
                  wrong_or_mixed=len(wrong), served_new_version=n_after,
                  version_after=reg.version(name), swap_seconds=swap_s,
                  swap_pre_captures=swap_captures,
                  captures_on_requests=request_captures,
                  new_graph_pool_bytes=new_ex.graph_pool_bytes,
                  after_swap_max_abs_err=after_err, errors=errors[:3])
    ok = (not errors and not wrong and n_after > 0 and request_captures == 0
          and swap_captures == len(new_ex.compiled_buckets)
          and new_ex.graph_pool_bytes > 0
          and reg.version(name) == v_before + 1 and after_err <= SERVE_TOL)
    return fields, ok, new_ex


def phase_serving(clf, X: np.ndarray, y: np.ndarray) -> list:
    """The serving plane on the headline logistic bag: the two ladders,
    the graph audit of the 1..256 executor, closed-loop single-row
    traffic through the micro-batcher against naive per-request
    ``predict_proba``, a hot swap mid-traffic to a second fit, and
    ``registry.save`` / ``load`` under a new name. Returns the audits."""
    import tempfile

    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.serving import MicroBatcher

    t_phase = time.perf_counter()
    Xs = X[:N_SERVE_ROWS]
    ladders = serving_ladders(clf, Xs, "serving", exact=False)
    reg, ex = ladders["registry"], ladders["bench"]
    audits = [analysis_audit(ex, rows, "serving_bench")
              for rows in (min(ex.compiled_buckets),
                           max(ex.compiled_buckets))]
    name = "serving_bench"
    # closed-loop single-row traffic, as benchmarks/serving_latency.py
    c0 = serving_compiles()
    levels = []
    for conc in SERVE_LEVELS:
        naive = measure(lambda: run_clients(
            Xs, conc, SERVE_NAIVE_REQUESTS, clf.predict_proba))
        with MicroBatcher(ex, **SERVE_BATCHER) as b:
            served = measure(lambda: run_window(
                Xs, conc, SERVE_REQUESTS, b.submit))
            split = {"direct": b.stats()["direct"],
                     "coalesced": b.stats()["coalesced"]}
        levels.append({"concurrency": conc, "naive": naive,
                       "served": served, "dispatch_so_far": split,
                       "speedup": served["rows_per_sec"]
                       / naive["rows_per_sec"]})
    captures = serving_compiles() - c0
    emit("serving_latency", ok=captures == 0, requests_per_run=SERVE_REQUESTS,
         naive_requests_per_run=SERVE_NAIVE_REQUESTS,
         repeats=SERVE_REPEATS, warm_runs_discarded=1,
         batcher={k: v for k, v in SERVE_BATCHER.items() if k != "max_queue"},
         ladder=list(ex.compiled_buckets), levels=levels,
         captures_during_traffic=captures)
    if captures:
        fail("serving_latency", f"{captures} captures on the request path")
    # a hot swap mid-traffic to a second fit of another seed
    learner = LogisticRegression(**clf.base_learner_.get_params())
    clf_b = BaggingClassifier(learner, n_estimators=clf.n_estimators_,
                              seed=1, device=clf.device).fit(X, y)
    rows = np.arange(2000)
    fields, ok, new_ex = swap_under_traffic(
        reg, name, clf_b, Xs[rows], clf.predict_proba(Xs[rows]),
        clf_b.predict_proba(Xs[rows]))
    emit("serving_swap", ok=ok, **fields)
    if not ok:
        fail("serving_swap", f"checks failed: {fields}")
    # registry.save, then load under a new name with the program cache
    # live, as a second name in the same process does: the loaded
    # executor adopts the saved executor's captures. The saved name is
    # then swapped back to the first fit, the second fit is dropped and
    # freed, and the allocator's free blocks are refilled with NaN: the
    # adopted graphs hold the tensors they read, so the loaded name
    # serves the same bits
    import gc
    import shutil

    path = tempfile.mkdtemp(prefix="serving_ckpt_")
    t0 = time.perf_counter()
    reg.save(name, path)
    save_s = time.perf_counter() - t0
    c0 = serving_compiles()
    t0 = time.perf_counter()
    loaded = reg.load("serving_loaded", path, device=clf.device)
    load_s = time.perf_counter() - t0
    load_captures = serving_compiles() - c0
    shutil.rmtree(path, ignore_errors=True)
    adopted = all(loaded.program(bk) is reg.executor(name).program(bk)
                  for bk in loaded.compiled_buckets)
    rng = np.random.default_rng(1)
    reqs = [Xs[rng.integers(0, len(Xs), n)] for n in (1, 5, 64, 200, 256,
                                                      300)]
    served = [loaded.forward(Xr) for Xr in reqs]
    unequal = sum(int(not np.array_equal(s, reg.executor(name).forward(Xr)))
                  for s, Xr in zip(served, reqs))
    fields = dict(save_seconds=save_s, load_and_warm_seconds=load_s,
                  captures_at_load=load_captures, adopted_captures=adopted,
                  loaded_version=reg.version("serving_loaded"),
                  saved_version=reg.version(name),
                  loaded_buckets=list(loaded.compiled_buckets),
                  request_sizes_unequal=unequal)
    ok = (unequal == 0 and fields["loaded_version"] == fields["saved_version"]
          and loaded.compiled_buckets == reg.executor(name).compiled_buckets
          and load_captures == 0 and adopted)
    emit("serving_checkpoint", ok=ok, **fields)
    if not ok:
        fail("serving_checkpoint", f"checks failed: {fields}")
    reg.swap(name, clf)
    del clf_b, new_ex
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((64 << 20,), float("nan"), device=clf.device)
            for _ in range(8)]
    torch.cuda.synchronize()
    del junk
    unequal_after = sum(int(not np.array_equal(loaded.forward(Xr), s))
                        for s, Xr in zip(served, reqs))
    fields = dict(saved_name_version=reg.version(name),
                  freed_model_refilled_bytes=8 * (64 << 20) * 4,
                  request_sizes_unequal_after=unequal_after,
                  phase_seconds=time.perf_counter() - t_phase)
    ok = unequal_after == 0
    emit("serving_adopted_after_free", ok=ok, **fields)
    if not ok:
        fail("serving_adopted_after_free", f"checks failed: {fields}")
    return audits


def phase_serving_trees(tree, X: np.ndarray) -> list:
    """Config 3's tree bag (hard vote) on both ladders: captures, graph
    replay against the eager closure and the served votes against
    ``predict_proba``, bit for bit; the graph audit of the 8..4096
    executor; and a batched throughput figure. Returns the audits."""
    from spark_bagging_tpu_torch.serving import MicroBatcher

    Xs = X[:N_SERVE_ROWS]
    ladders = serving_ladders(tree, Xs, "serving_trees", exact=True)
    ex = ladders["default"]
    audits = [analysis_audit(ex, rows, "serving_trees_default")
              for rows in (min(ex.compiled_buckets),
                           max(ex.compiled_buckets))]
    c0 = serving_compiles()
    with MicroBatcher(ex, **SERVE_BATCHER) as b:
        served = measure(lambda: run_window(Xs, 16, SERVE_REQUESTS, b.submit))
    emit("serving_trees_latency", ok=serving_compiles() == c0,
         concurrency=16, served=served,
         captures_during_traffic=serving_compiles() - c0)
    if serving_compiles() != c0:
        fail("serving_trees_latency", "captures on the request path")
    return audits


# -- the analysis phase: the serving forwards' graph audit --------------

def analysis_audit(ex, rows: int, label: str) -> dict:
    """``audit_executor`` on a CUDA executor at one bucket: the forward
    traced with ``make_fx`` on the card, then one real call under
    ``torch.cuda.set_sync_debug_mode("error")``. Prints and returns the
    op count, the closure constants' bytes, the counted kernels the
    trace launched and the seconds; a failed audit fails the run."""
    from spark_bagging_tpu_torch.analysis import AuditError, audit_executor

    t0 = time.perf_counter()
    try:
        report = audit_executor(ex, n_rows=rows)
    except AuditError as e:
        fail("analysis", f"{label}@{rows}: {e}")
    fields = dict(executor=label, rows=rows, name=report.name,
                  ops=report.n_eqns, aten_ops=sorted(report.primitives),
                  const_count=report.const_count,
                  const_bytes=report.const_bytes,
                  wide_dtypes=sorted(report.wide_dtypes),
                  host_syncs=report.host_syncs,
                  opaque_kernels=report.opaque_kernels,
                  sync_debug_checked=report.sync_debug_checked,
                  seconds=time.perf_counter() - t0)
    ok = report.ok and report.sync_debug_checked
    emit("analysis_audit", ok=ok, **fields)
    if not ok:
        fail("analysis", f"{label}@{rows}: no real call under sync debug")
    return fields


def phase_analysis(audits: list) -> None:
    """The audits' summary (``audits``: the serving phases'
    ``analysis_audit`` results): each serving forward audited at both
    ends of its ladder, the phase's seconds."""
    want = {"serving_bench", "serving_trees_default"}
    seen = {a["executor"] for a in audits}
    fields = dict(audits=[{k: a[k] for k in ("executor", "rows", "ops",
                                             "const_bytes",
                                             "opaque_kernels", "seconds")}
                          for a in audits],
                  seconds=sum(a["seconds"] for a in audits), card=CARD)
    ok = seen == want and len(audits) == 4
    emit("analysis", ok=ok, **fields)
    if not ok:
        fail("analysis", f"audited {sorted(seen)}, expected {sorted(want)}")


# -- growth and resume ------------------------------------------------

class Killed(Exception):
    """The fault a killed stream's source raises."""


def dying(source, last_chunk: int | None = None,
          after_yields: int | None = None):
    """``source`` wrapped to raise :class:`Killed` once it has yielded
    chunk ``last_chunk`` of a pass, or ``after_yields`` chunks over all
    passes: a stream killed mid-fit."""
    from spark_bagging_tpu_torch.utils.io import ChunkSource

    class Dying(ChunkSource):
        n_features, n_rows = source.n_features, source.n_rows
        chunk_rows = source.chunk_rows
        yielded = 0

        def chunks(self):
            return self.chunks_from(0)

        def chunks_from(self, start):
            for c, chunk in enumerate(source.chunks_from(start),
                                      start=start):
                if ((last_chunk is not None and c > last_chunk)
                        or (after_yields is not None
                            and self.yielded >= after_yields)):
                    raise Killed(f"killed at chunk {c}")
                self.yielded += 1
                yield chunk

    return Dying()


def expect_killed(phase: str, fn) -> None:
    """Run ``fn``, which must raise :class:`Killed` and nothing else."""
    try:
        fn()
    except Killed:
        return
    fail(phase, "the killed stream ran to its end")


def phase_warm_start(cold, X: np.ndarray, y: np.ndarray) -> int:
    """The logistic headline grown 128 -> 256 replicas against ``fit``'s
    cold 256-replica fit: the new replicas' Newton fits (and the pooled
    pre-pass again) on the scaled-Gram kernel."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression

    learner = cold._fitted_learner
    warm = BaggingClassifier(LogisticRegression(**learner.get_params()),
                             n_estimators=WARM_FROM, seed=0,
                             warm_start=True).fit(X, y)
    warm.set_params(n_estimators=N_REPLICAS)
    reset_launches()
    t0 = time.perf_counter()
    warm.fit(X, y)
    grow_seconds = time.perf_counter() - t0
    counts = read_launches()
    rep = warm.fit_report_
    chunk = rep["chunk_size_resolved"] or (N_REPLICAS - WARM_FROM)
    expected = (learner.pooled_iter
                + learner.max_iter * -(-(N_REPLICAS - WARM_FROM) // chunk))
    sampled = [0, WARM_FROM - 1, WARM_FROM, N_REPLICAS - 1]
    weights_equal = all(np.array_equal(warm.replica_weights(i),
                                       cold.replica_weights(i))
                        for i in sampled)
    subspaces_equal = bool(torch.equal(warm.subspaces_, cold.subspaces_))
    pw = warm.predict_proba(X[:N_SERVE_ROWS])
    pc = cold.predict_proba(X[:N_SERVE_ROWS])
    d_proba = float(np.abs(pw - pc).max())
    Ww, Wc = warm.ensemble_["W"], cold.ensemble_["W"]
    emit("warm_start", ok=True, n_rows=N_ROWS, grown_from=WARM_FROM,
         n_replicas=N_REPLICAS, grow_seconds=grow_seconds,
         grow_fit_seconds=rep["fit_seconds"],
         cold_fit_seconds=cold.fit_report_["fit_seconds"],
         chunk_size=rep["chunk_size_resolved"], launches=counts,
         expected_scaled_gram_launches=expected,
         sampled_replicas=sampled, weights_bitwise=weights_equal,
         subspaces_bitwise=subspaces_equal,
         W_bitwise=bool(torch.equal(Ww, Wc)),
         W_max_rel_delta=float((Ww - Wc).abs().max() / Wc.abs().max()),
         proba_max_abs_delta=d_proba, proba_bitwise=bool((pw == pc).all()),
         proba_tol=WARM_PROBA_TOL)
    if counts["scaled_gram"] != expected:
        fail("warm_start", f"{counts['scaled_gram']} scaled-Gram launches, "
             f"expected {expected}")
    if not (weights_equal and subspaces_equal):
        fail("warm_start", "grown weights or subspaces differ from the "
             "cold fit's")
    if not d_proba <= WARM_PROBA_TOL:
        fail("warm_start", f"predict_proba differs by {d_proba:.3g} > "
             f"{WARM_PROBA_TOL}")
    return counts["scaled_gram"]


def phase_warm_start_trees(cold, X: np.ndarray, y: np.ndarray):
    """Config 3's 256 trees grown from 128 against ``tree_fit``'s cold
    fit: integral statistics, so every leaf is bitwise."""
    warm = tree_bagger(WARM_FROM)
    warm.set_params(warm_start=True).fit(X, y)
    warm.set_params(n_estimators=N_REPLICAS)
    reset_launches()
    t0 = time.perf_counter()
    warm.fit(X, y)
    grow_seconds = time.perf_counter() - t0
    counts = read_launches()
    rep = warm.fit_report_
    chunk = rep["chunk_size_resolved"] or (N_REPLICAS - WARM_FROM)
    expected = TREE["max_depth"] * -(-(N_REPLICAS - WARM_FROM) // chunk)
    unequal = [k for k in cold.ensemble_
               if not torch.equal(warm.ensemble_[k], cold.ensemble_[k])]
    pred_equal = bool(np.array_equal(warm.predict(X[:N_SERVE_ROWS]),
                                     cold.predict(X[:N_SERVE_ROWS])))
    emit("warm_start_trees", ok=True, grown_from=WARM_FROM,
         n_replicas=N_REPLICAS, grow_seconds=grow_seconds,
         grow_fit_seconds=rep["fit_seconds"],
         cold_fit_seconds=cold.fit_report_["fit_seconds"],
         chunk_size=rep["chunk_size_resolved"], launches=counts,
         expected_binned_left_stats_launches=expected,
         leaves_unequal=unequal, predict_bitwise=pred_equal,
         subspaces_bitwise=bool(torch.equal(warm.subspaces_,
                                            cold.subspaces_)))
    if counts["binned_left_stats"] != expected or counts["bin_codes"] != 1:
        fail("warm_start_trees", f"launches {counts}, expected {expected} "
             "histogram and one bin-codes launch")
    if unequal or not pred_equal:
        fail("warm_start_trees", f"grown trees differ from the cold fit's "
             f"in {unequal} (predict bitwise: {pred_equal})")
    return counts["binned_left_stats"], counts["bin_codes"]


def phase_stream_resume_trees(full, X: np.ndarray, y: np.ndarray):
    """Config 3's tree stream killed in level pass TREE_KILL_PASS and
    resumed: bitwise ``tree_stream_fit``'s, the kernels launched only
    for the levels left."""
    classes = np.unique(y)
    n_chunks = -(-N_ROWS // TREE_STREAM_CHUNK)
    # the edge pass and TREE_KILL_PASS - 1 levels, then 4 chunks more
    after = TREE_KILL_PASS * n_chunks + 4
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/trees"
        expect_killed("stream_resume_trees", lambda: tree_bagger(
            N_REPLICAS).fit_stream(
            dying(tree_stream_source(X, y, TREE_STREAM_CHUNK),
                  after_yields=after),
            classes=classes, checkpoint_dir=ckpt))
        with open(f"{ckpt}/meta.json") as f:
            next_pass = json.load(f)["next_pass"]
        levels_done = next_pass - 1
        reset_launches()
        t0 = time.perf_counter()
        clf = tree_bagger(N_REPLICAS).fit_stream(
            tree_stream_source(X, y, TREE_STREAM_CHUNK), classes=classes,
            resume_from=ckpt)
        resume_seconds = time.perf_counter() - t0
        counts = read_launches()
    expected = (TREE["max_depth"] - levels_done) * n_chunks
    unequal = [k for k in full.ensemble_
               if not torch.equal(clf.ensemble_[k], full.ensemble_[k])]
    emit("stream_resume_trees", ok=True, n_chunks=n_chunks,
         killed_after_chunks=after, levels_done=levels_done,
         resume_seconds=resume_seconds,
         full_fit_seconds=full.fit_report_["fit_seconds"], launches=counts,
         expected_launches_each=expected, leaves_unequal=unequal)
    if levels_done != TREE_KILL_PASS - 1:
        fail("stream_resume_trees", f"snapshot after {levels_done} levels, "
             f"expected {TREE_KILL_PASS - 1}")
    if (counts["binned_left_stats"] != expected
            or counts["bin_codes"] != expected):
        fail("stream_resume_trees", f"launches {counts}, expected {expected} "
             "histogram and bin-codes launches")
    if unequal:
        fail("stream_resume_trees", f"resumed trees differ in {unequal}")
    return counts["binned_left_stats"], counts["bin_codes"]


def phase_stream_resume_mlp(full) -> None:
    """Config 4 at full size, snapshotted every MLP_SNAPSHOT_EVERY
    chunk-steps, killed after chunk MLP_KILL_AFTER_CHUNK and resumed:
    every parameter bitwise ``mlp_stream_fit``'s (the same shapes and
    launches)."""
    from spark_bagging_tpu_torch.optim import Adam
    from spark_bagging_tpu_torch.streaming import _save_stream_checkpoint

    cfg = MLP_STREAM
    fit_kw = dict(classes=[0, 1], n_epochs=cfg["n_epochs"],
                  steps_per_chunk=cfg["steps_per_chunk"], lr=cfg["lr"])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/mlp"
        est = mlp_bagger(cfg["n_estimators"])
        t0 = time.perf_counter()
        expect_killed("stream_resume_mlp", lambda: est.fit_stream(
            dying(mlp_source(cfg["n_rows"], cfg["chunk_rows"]),
                  last_chunk=MLP_KILL_AFTER_CHUNK),
            checkpoint_dir=ckpt, checkpoint_every=MLP_SNAPSHOT_EVERY,
            **fit_kw))
        killed_seconds = time.perf_counter() - t0
        with open(f"{ckpt}/meta.json") as f:
            meta = json.load(f)
        snap_bytes = os.path.getsize(f"{ckpt}/state.msgpack")
        # the snapshot's own cost: one more, timed alone
        opt = Adam(full.ensemble_, cfg["lr"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _save_stream_checkpoint(f"{tmp}/timed", full.ensemble_, opt, [],
                                meta)
        snap_seconds = time.perf_counter() - t0
        reset_launches()
        est = mlp_bagger(cfg["n_estimators"])
        t0 = time.perf_counter()
        est.fit_stream(mlp_source(cfg["n_rows"], cfg["chunk_rows"]),
                       resume_from=ckpt, **fit_kw)
        resume_seconds = time.perf_counter() - t0
        counts = read_launches()
    unequal = [k for k in full.ensemble_
               if not torch.equal(est.ensemble_[k], full.ensemble_[k])]
    n_chunks = -(-cfg["n_rows"] // cfg["chunk_rows"])
    emit("stream_resume_mlp", ok=True, **cfg,
         snapshot_every=MLP_SNAPSHOT_EVERY,
         killed_after_chunk=MLP_KILL_AFTER_CHUNK,
         snapshot_next_chunk=meta["next_chunk"],
         snapshot_bytes=snap_bytes, snapshot_seconds=snap_seconds,
         killed_run_seconds=killed_seconds, resume_seconds=resume_seconds,
         resumed_opt_steps=est.fit_report_["opt_steps"],
         full_stream_seconds=full.fit_report_["fit_seconds"],
         launches=counts, params_unequal=unequal)
    want_next = (MLP_KILL_AFTER_CHUNK + 1) // MLP_SNAPSHOT_EVERY \
        * MLP_SNAPSHOT_EVERY
    if meta["next_chunk"] != want_next:
        fail("stream_resume_mlp", f"snapshot at chunk {meta['next_chunk']}, "
             f"expected {want_next}")
    if est.fit_report_["opt_steps"] != (n_chunks - want_next) * cfg[
            "steps_per_chunk"]:
        fail("stream_resume_mlp", f"{est.fit_report_['opt_steps']} resumed "
             "optimizer steps")
    if unequal:
        fail("stream_resume_mlp", f"resumed parameters differ in {unequal}")


def phase_bootstrap_rejection() -> None:
    """``bootstrap_weights`` above rate 32 (JAX's rejection sampler) on
    the card against the same call on the CPU: the same IEEE operations
    on both, so every draw is equal."""
    from spark_bagging_tpu_torch.ops import prng
    from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights

    R, n = BOOT_SHAPE
    rows = []
    for rate in BOOT_RATES:
        args = dict(ratio=rate, replacement=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = bootstrap_weights(prng.key(0, "cuda"),
                                 torch.arange(R, device="cuda"), n, **args)
        torch.cuda.synchronize()
        card_seconds = time.perf_counter() - t0
        cpu = bootstrap_weights(prng.key(0), torch.arange(R), n, **args)
        diff = int((card.cpu() != cpu).sum())
        rows.append({"rate": rate, "differing_draws": diff,
                     "mean_count": float(cpu.mean()),
                     "card_seconds": card_seconds})
    emit("bootstrap_rejection", ok=True, replicas=R, rows_per_replica=n,
         rates=rows)
    bad = [r for r in rows if r["differing_draws"]]
    if bad:
        fail("bootstrap_rejection", f"card draws differ from the CPU's: {bad}")


# -- online updates --------------------------------------------------

def fresh_covtype(n_rows: int, seed: int):
    """``n_rows`` fresh covtype rows of the headline's mixture (another
    row seed, the same structure), standardized with the headline
    data's own column statistics."""
    from spark_bagging_tpu_torch.utils.datasets import synthetic_covtype

    raw, _ = synthetic_covtype(N_ROWS)
    mu, sigma = raw.mean(0), raw.std(0) + 1e-8
    del raw
    X, y = synthetic_covtype(n_rows, seed=seed, structure_seed=7)
    return ((X - mu) / sigma).astype(np.float32), y


def record_gram_shapes():
    """Patch the logistic learner's scaled-Gram call with one that
    records each launch's (R, n) and calls through; returns the list and
    the undo."""
    from spark_bagging_tpu_torch.models import logistic

    real, shapes = logistic.scaled_grams, []

    def recording(Xb, S, **kw):
        shapes.append((int(S.shape[0]), int(S.shape[1])))
        return real(Xb, S, **kw)

    logistic.scaled_grams = recording
    return shapes, lambda: setattr(logistic, "scaled_grams", real)


def gram_at_shapes(X: np.ndarray, Rs: list[int]) -> list[dict]:
    """The scaled-Gram kernel (fp32 mode, the headline's) against its
    plain version at each replica count on ``X``'s rows, every replica
    compared (per-entry error over the abs-sum scale), with the
    kernel's, the plain version's and the library yardstick's times and
    the bound (as ``phase_kernels`` computes them)."""
    from spark_bagging_tpu_torch.ops.gram import scaled_grams, scaled_grams_plain

    out = []
    for R in Rs:
        Xb, S = kernel_inputs(X, R)
        (n, d), P = Xb.shape, S.shape[2]
        scale = torch.stack([scaled_grams_plain(Xb.abs(), S[r].abs())
                             for r in range(R)]).clamp_min(1e-30)
        err, abs_err = entry_errors(scaled_grams(Xb, S), Xb, S, "float32",
                                    scale)
        flops = float(n) * P * d * (d + 1) * R
        t_ops = min(1e3 * flops / PEAK_FP32, 3e3 * flops / PEAK_TF32)
        t_bytes = 1e3 * 4.0 * (n * d + R * n * P + R * P * d * d) / PEAK_BYTES
        out.append(dict(R=R, n=n, d=d, P=P,
                        max_entry_err=err, max_abs_err=abs_err, tol=GRAM_TOL,
                        kernel_ms=cuda_ms(lambda: scaled_grams(Xb, S), 3),
                        plain_ms=cuda_ms(lambda: scaled_grams_plain(Xb, S),
                                         1),
                        library_ms=library_ms(Xb, S, torch.float32),
                        bound_ms=max(t_ops, t_bytes),
                        bound_by="operations" if t_ops >= t_bytes
                        else "bytes"))
        del Xb, S, scale
    torch.cuda.empty_cache()
    return out


def online_device_check(Xf: np.ndarray, yf: np.ndarray, X: np.ndarray,
                        y: np.ndarray) -> dict:
    """One warm step on the card and on the CPU from the same state: a
    16-replica headline-learner bag fitted on the card, its CPU twin
    (the same configuration fitted on the CPU) given the card's params,
    then each steps over the same fresh rows; max |dW| over max |W|."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.online import OnlineUpdater

    n, R = ONLINE_CHECK["n_rows"], ONLINE_CHECK["n_estimators"]
    learner = dict(max_iter=1, init="pooled", hessian_impl="pallas",
                   precision="highest")
    card = BaggingClassifier(LogisticRegression(**learner), n_estimators=R,
                             seed=0).fit(X[:n], y[:n])
    cpu = BaggingClassifier(LogisticRegression(**learner), n_estimators=R,
                            seed=0, device="cpu").fit(X[:n], y[:n])
    cpu.ensemble_ = {k: v.cpu() for k, v in card.ensemble_.items()}
    W = {}
    for name, est in (("card", card), ("cpu", cpu)):
        upd = OnlineUpdater(est)
        upd.partial_fit(Xf, yf)
        W[name] = upd.to_estimator().ensemble_["W"].cpu()
    rel = float((W["card"] - W["cpu"]).abs().max() / W["cpu"].abs().max())
    return dict(replicas=R, fit_rows=n, step_rows=len(yf),
                max_rel_w_diff=rel, tol=ONLINE_W_TOL)


def phase_online_update(clf, X: np.ndarray, y: np.ndarray):
    """ONLINE["steps"] warm ``partial_fit`` steps of ONLINE["rows"] fresh
    covtype rows on the headline bag (256 replicas, Newton Hessians
    through the scaled-Gram kernel): each step's seconds, the running
    OOB estimate, the kernel's launches and their (R, n); the kernel
    against its plain version at each such shape; one step on the card
    against the CPU. Returns the candidate and the launches."""
    from spark_bagging_tpu_torch.online import OnlineUpdater

    steps, rows = ONLINE["steps"], ONLINE["rows"]
    Xf, yf = fresh_covtype((steps + 1) * rows, ONLINE["seed"])
    upd = OnlineUpdater(clf)
    chunk = clf._eff_chunk() or clf.n_estimators_
    chunks = [min(chunk, clf.n_estimators_ - s)
              for s in range(0, clf.n_estimators_, chunk)]
    expected = steps * clf.base_learner_.max_iter * len(chunks)
    secs, oob = [], []
    shapes, undo = record_gram_shapes()
    reset_launches()
    try:
        for s in range(steps):
            sl = slice(s * rows, (s + 1) * rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = upd.partial_fit(Xf[sl], yf[sl])
            secs.append(time.perf_counter() - t0)
            oob.append(rep["oob_estimate"])
    finally:
        undo()
    counts = read_launches()
    cand = upd.to_estimator()
    acc = cand.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    kernel_rows = gram_at_shapes(Xf[:rows], sorted({r for r, _ in shapes}))
    check = online_device_check(Xf[steps * rows:], yf[steps * rows:], X, y)
    fields = dict(steps=steps, rows_per_step=rows, replicas=clf.n_estimators_,
                  chunk=chunk, step_seconds=secs, oob_estimate=oob,
                  oob_rows=upd.oob_rows, accuracy_100k_after=acc,
                  acc_bar=ONLINE_ACC_BAR,
                  launches=counts, expected_scaled_gram_launches=expected,
                  gram_launch_shapes=sorted(set(shapes)),
                  gram_at_step_shapes=kernel_rows, device_check=check,
                  card=CARD)
    ok = (counts["scaled_gram"] == expected == len(shapes)
          and all(r["max_entry_err"] <= GRAM_TOL for r in kernel_rows)
          and check["max_rel_w_diff"] <= ONLINE_W_TOL
          and oob[-1] is not None and acc >= ONLINE_ACC_BAR
          and bool(np.isfinite(cand.ensemble_["W"].cpu().numpy()).all()))
    emit("online_update", ok=ok, **fields)
    if not ok:
        fail("online_update", f"checks failed: launches {counts} (expected "
             f"{expected}), kernel rows {kernel_rows}, device check {check}, "
             f"accuracy {acc}")
    return cand, counts["scaled_gram"]


def phase_online_publish(clf, cand, X: np.ndarray) -> None:
    """The updated candidate swapped into a serving registry under four
    clients' traffic: no request fails, every served row within
    SERVE_TOL of the version that served it (the candidate's
    ``predict_proba`` after the swap)."""
    from spark_bagging_tpu_torch.serving import ModelRegistry

    Xs = X[:2000]
    reg = ModelRegistry(**SERVE_LADDERS["bench"])
    reg.register("online", clf, warmup=True)
    fields, ok, _ = swap_under_traffic(
        reg, "online", cand, Xs, clf.predict_proba(Xs),
        cand.predict_proba(Xs))
    emit("online_publish", ok=ok, **fields, card=CARD)
    if not ok:
        fail("online_publish", f"checks failed: {fields}")


def phase_online_anchor(X: np.ndarray, y: np.ndarray) -> int:
    """A ``bootstrap=False`` 16-replica logistic bag on 50,000 covtype
    rows; ``OnlineUpdater(warm=False).partial_fit`` over the same rows
    replays the batch fit: params bitwise, the same Gram launches.
    Returns the replay's launches."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.online import OnlineUpdater

    Xa, ya = X[:N_CROSS_ROWS], y[:N_CROSS_ROWS]
    reset_launches()
    est = BaggingClassifier(
        LogisticRegression(max_iter=1, init="pooled", hessian_impl="pallas",
                           precision="highest"),
        n_estimators=N_CROSS_REPLICAS, bootstrap=False, seed=0).fit(Xa, ya)
    fit_launches = read_launches()["scaled_gram"]
    upd = OnlineUpdater(est, warm=False)
    reset_launches()
    t0 = time.perf_counter()
    upd.partial_fit(Xa, ya)
    replay_seconds = time.perf_counter() - t0
    launches = read_launches()["scaled_gram"]
    replay = upd.to_estimator().ensemble_
    unequal = [k for k in est.ensemble_
               if not torch.equal(est.ensemble_[k], replay[k])]
    ok = not unequal and launches == fit_launches > 0
    emit("online_anchor", ok=ok, rows=N_CROSS_ROWS,
         replicas=N_CROSS_REPLICAS, fit_seconds=est.fit_report_["fit_seconds"],
         replay_seconds=replay_seconds, fit_launches=fit_launches,
         replay_launches=launches, params_unequal=unequal, card=CARD)
    if not ok:
        fail("online_anchor", f"replay differs in {unequal} or launches "
             f"{launches} != {fit_launches}")
    return launches


# -- the closed loop: the quality plane and the online trainer ----------

def quality_compiles() -> tuple[float, float]:
    """(serving captures, disagreement-tap captures) so far."""
    from spark_bagging_tpu_torch import telemetry

    r = telemetry.registry()
    return (r.counter("sbt_serving_compiles_total").value,
            r.counter("sbt_quality_disagreement_compiles_total").value)


def phase_quality_tap(model, X: np.ndarray, name: str) -> None:
    """The disagreement tap on a fitted bag: registered on
    serving_latency.py's ladder with warm-up, then
    ``enable_quality(disagreement_every=QUALITY["disagreement_every"])``:
    one per-replica graph a bucket captured at warm-up and none on
    requests (of either kind); every bucket's per-replica replay bit for
    bit the eager ``replica_forward`` closure, its mean (soft vote) or
    vote count (hard vote) the served output; served outputs bitwise with
    and without the monitor; rows/s and p50/p99 at concurrency 4 with and
    without it on the same 1,600 rows; the monitor's host microseconds a
    single-row batch and a sampled batch's tap replay."""
    from spark_bagging_tpu_torch.serving import (
        MicroBatcher,
        ModelRegistry,
        program_cache,
    )

    Xs = X[:N_SERVE_ROWS]
    hard = getattr(model, "voting", None) == "hard"
    program_cache.clear()
    reg = ModelRegistry(**SERVE_LADDERS["bench"])
    ex = reg.register(name, model, warmup=True)
    rng = np.random.default_rng(2)
    reqs = [Xs[rng.integers(0, len(Xs), n)] for n in (1, 5, 64, 200, 256,
                                                      300)]
    base = [ex.forward(r) for r in reqs]
    pool0 = ex.graph_pool_bytes
    with MicroBatcher(ex, **SERVE_BATCHER) as b:
        plain = measure(lambda: run_window(Xs, 4, SERVE_REQUESTS, b.submit))
    reset_launches()
    c0 = quality_compiles()
    t0 = time.perf_counter()
    mon = reg.enable_quality(name, refresh_every=QUALITY["refresh_every"],
                             disagreement_every=QUALITY["disagreement_every"])
    attach_s = time.perf_counter() - t0
    c1 = quality_compiles()
    tapped = [ex.forward(r) for r in reqs]
    unequal = sum(int(not np.array_equal(a, b)) for a, b in zip(tapped, base))
    fn, params, subs = model.replica_forward()
    replay_unequal, agg_err, vote_unequal = [], 0.0, 0
    for bk in ex.replica_buckets:
        Xb = Xs[rng.integers(0, len(Xs), bk)]
        rep = ex.replica_program(bk).run(Xb, bk)
        eager = fn(params, subs,
                   torch.from_numpy(Xb).to(subs.device)).cpu().numpy()
        if not np.array_equal(rep, eager):
            replay_unequal.append(bk)
        served = ex.forward(Xb)
        if hard:
            vote_unequal += int(not np.array_equal(
                rep.sum(0), np.rint(served * model.n_estimators_)))
        else:
            agg_err = max(agg_err, float(np.abs(rep.mean(0) - served).max()))
    with MicroBatcher(ex, **SERVE_BATCHER) as b:
        monitored = measure(lambda: run_window(Xs, 4, SERVE_REQUESTS,
                                               b.submit))
    c2 = quality_compiles()
    launches = read_launches()
    # the monitor's host cost a batch: one single-row batch's sketches,
    # and a sampled batch's per-replica replay at bucket 1
    x1 = Xs[:1]
    o1 = ex.forward(x1)
    n_obs = 2000
    t0 = time.perf_counter()
    for i in range(n_obs):
        mon.observe_parts([Xs[i:i + 1]], [o1])
    observe_us = 1e6 * (time.perf_counter() - t0) / n_obs
    t0 = time.perf_counter()
    for _ in range(200):
        ex._replica_piece(x1, 1)
    replay_us = 1e6 * (time.perf_counter() - t0) / 200
    summ = mon.summary()
    fields = dict(
        replicas=model.n_estimators_, vote="hard" if hard else "soft",
        ladder=list(ex.compiled_buckets),
        replica_captures_at_warmup=c1[1] - c0[1],
        serving_captures_at_warmup=c1[0] - c0[0],
        captures_on_requests={"serving": c2[0] - c1[0],
                              "replica": c2[1] - c1[1]},
        attach_and_capture_seconds=attach_s,
        graph_pool_bytes={"serving": pool0,
                          "with_tap": ex.graph_pool_bytes},
        request_sizes_unequal_with_monitor=unequal,
        replica_buckets_unequal_to_eager=replay_unequal,
        replica_mean_max_abs_err_vs_served=None if hard else agg_err,
        replica_vote_buckets_unequal=vote_unequal if hard else None,
        served_without_monitor=plain, served_with_monitor=monitored,
        disagreement_every=QUALITY["disagreement_every"],
        refresh_every=QUALITY["refresh_every"],
        disagreement_samples=summ["disagreement_samples"],
        disagreement_mean=(summ["drift"] or {}).get("disagreement_mean"),
        monitor_host_us_per_single_row_batch=observe_us,
        tap_replay_us_per_sampled_batch=replay_us,
        launches=launches, card=CARD)
    ok = (fields["replica_captures_at_warmup"] == len(ex.compiled_buckets)
          and fields["serving_captures_at_warmup"] == 0
          and c2 == c1 and unequal == 0 and not replay_unequal
          and ex.graph_pool_bytes > pool0
          and (vote_unequal == 0 if hard else agg_err <= SERVE_TOL)
          and summ["disagreement_samples"] > 0
          and launches["scaled_gram"] == 0)
    emit(name, ok=ok, **fields)
    if not ok:
        fail(name, f"checks failed: {fields}")
    reg.disable_quality(name)


def phase_drift_loop(clf, X: np.ndarray) -> int:
    """serve -> drift sketches -> PSI gauges -> alert -> OnlineTrainer
    refit -> validate -> publish swap -> the drift gauge recovers, on the
    headline bag (256 replicas at full width), with an armed flight
    recorder and a recording workload recorder, as example 10's loop and
    ``replay --drift --online`` run it in the JAX package.

    Four clients send single rows through ``MicroBatcher(max_delay_ms=
    0.5)``: DRIFT["fresh"] fresh rows of the headline mixture, then rows
    covariate-shifted as replay.py shifts them (``X * scale + shift``),
    at least DRIFT["shifted"] of them and on until DRIFT["post_swap"]
    have been served after the publish swap; each served row with its
    label goes into the trainer's ``LabeledBuffer``. The main thread
    evaluates the default drift rules on a virtual clock (DRIFT["dt"]
    seconds a served row) and steps the trainer, which refits once the
    buffer holds DRIFT["window"] rows served after the alert. Then one
    refit is forced to fail validation (its margin set below -1) and
    must write one ``refit_rejected`` flight dump. Returns the loop's
    scaled-Gram launches."""
    import shutil
    import threading

    from spark_bagging_tpu_torch.online import (
        LabeledBuffer,
        OnlineTrainer,
        trainer as trainer_mod,
    )
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.telemetry import alerts, recorder, workload

    t_phase = time.perf_counter()
    n_fresh, n_shift = DRIFT["fresh"], DRIFT["shifted"]
    n_pool = n_shift + DRIFT["post_swap"] + 4 * DRIFT["window"]
    Xf, yf = fresh_covtype(n_fresh + n_pool, DRIFT["seed"])
    Xs = np.concatenate([Xf[:n_fresh], Xf[n_fresh:] * np.float32(
        DRIFT["scale"]) + np.float32(DRIFT["shift"])])
    tmp = tempfile.mkdtemp(prefix="drift_loop_")
    publish_dir = os.path.join(tmp, "publish")
    reg = ModelRegistry(**SERVE_LADDERS["bench"])
    reg.register("drift", clf, warmup=True)
    mon = reg.enable_quality("drift", refresh_every=QUALITY["refresh_every"],
                             disagreement_every=QUALITY["disagreement_every"],
                             min_rows=DRIFT["min_rows"])
    rules = alerts.default_drift_rules(
        labels=mon.labels, fast_window_s=DRIFT["fast_s"],
        slow_window_s=DRIFT["slow_s"], cooldown_s=1e9)
    engine = alerts.AlertEngine(rules)
    threshold = rules[0].threshold
    flight = recorder.FlightRecorder(dir=os.path.join(tmp, "flight"),
                                     cooldown_s=3600).arm()
    rec = workload.WorkloadRecorder().start()
    buffer = LabeledBuffer(capacity_rows=DRIFT["window"],
                           labels={"model": "drift"})
    trainer = OnlineTrainer(reg, "drift", buffer, workload_recorder=rec,
                            epochs=1, batch_rows=DRIFT["window"],
                            min_refit_rows=DRIFT["window"] // 2,
                            collect_rows=DRIFT["window"],
                            margin=DRIFT["margin"], seed=DRIFT["seed"],
                            publish_dir=publish_dir,
                            trigger_rules=(rules[0].name,),
                            updater_opts={"warm": DRIFT["warm"]})
    engine.subscribe(trainer.on_alert)
    # each phase's seconds: the buffer's drain, the updater's steps, the
    # registry's swap and save; validate is the rest of the cycle
    timing = {"drain": 0.0, "refit": 0.0, "publish": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timing[key] += time.perf_counter() - t0
        return run

    real_partial_fit = trainer_mod.OnlineUpdater.partial_fit
    trainer_mod.OnlineUpdater.partial_fit = timed("refit", real_partial_fit)
    drained = []
    real_drain = buffer.drain

    def keep_drain():
        out = real_drain()
        drained.append(out)
        return out

    buffer.drain = timed("drain", keep_drain)
    reg.swap = timed("publish", reg.swap)
    reg.save = timed("publish", reg.save)
    shapes, undo = record_gram_shapes()

    lock = threading.Lock()
    state = dict(next=0, served=0, stop=False, swap_at=None)
    errors, versions = [], []
    # the shifted rows wait until the fresh ones are all served and the
    # monitor's pre-shift reading is taken
    shift_gate = threading.Event()

    def client(b):
        while True:
            with lock:
                if state["stop"]:
                    return
                i = state["next"]
                state["next"] += 1
            if i >= len(Xs):
                return
            if i >= n_fresh:
                shift_gate.wait(600)
            xi = Xs[i:i + 1]
            try:
                fut = b.submit(xi)
                fut.result(60)
                versions.append(fut.trace.breakdown.get("model_version"))
            except Exception as e:  # noqa: BLE001 - counted
                errors.append(repr(e))
                continue
            buffer.add(xi, yf[i:i + 1])
            with lock:
                state["served"] += 1
                done = state["served"]
                if state["swap_at"] is not None and (
                        done >= n_fresh + n_shift
                        and done >= state["swap_at"] + DRIFT["post_swap"]):
                    state["stop"] = True

    psi_before_shift = psi_at_alert = alert_at = None
    reset_launches()
    try:
        with reg.batcher("drift", **SERVE_BATCHER) as b:
            threads = [threading.Thread(target=client, args=(b,))
                       for _ in range(4)]
            t_serve = time.perf_counter()
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                with lock:
                    served = state["served"]
                if psi_before_shift is None and served >= n_fresh:
                    psi_before_shift = mon.drift()["psi_max"]
                    shift_gate.set()
                for ev in engine.evaluate(now=served * DRIFT["dt"]):
                    if ev["kind"] == "alert_fired" and alert_at is None:
                        alert_at = served
                        psi_at_alert = mon.drift()["psi_max"]
                if trainer.run_pending():
                    with lock:
                        state["swap_at"] = state["served"]
                time.sleep(0.002)
            for t in threads:
                t.join(60)
            serve_s = time.perf_counter() - t_serve
    finally:
        undo()
        trainer_mod.OnlineUpdater.partial_fit = real_partial_fit
    launches = read_launches()
    live = reg.executor("drift")
    psi_after = live.quality.drift()
    (record,) = trainer.transcript or [{}]
    phases = {"drain": timing["drain"], "refit": timing["refit"],
              "validate": max(0.0, record.get("seconds", 0.0)
                              - sum(timing.values())),
              "publish": timing["publish"]}
    # the refit's Gram launches against the plain version at their
    # shapes, on the window the trainer drained
    window = drained[0][0] if drained and drained[0] else Xs[:DRIFT["window"]]
    kernel_rows = gram_at_shapes(window, sorted({r for r, _ in shapes}))
    # a fresh registry serves publish_dir bitwise what the live one serves
    fresh_version, fresh_unequal = None, None
    if os.path.isfile(os.path.join(publish_dir, "serve_config.json")):
        program_cache.clear()
        fresh = ModelRegistry()
        fresh_ex = fresh.load("fresh", publish_dir, device=clf.device)
        fresh_version = fresh.version("fresh")
        rng = np.random.default_rng(3)
        probe = [Xs[n_fresh + rng.integers(0, n_shift, n)]
                 for n in (1, 5, 64, 200, 256, 300)]
        fresh_unequal = sum(int(not np.array_equal(fresh_ex.forward(p),
                                                   live.forward(p)))
                            for p in probe)
    # one forced rejection: no candidate clears incumbent + 2
    trainer.margin = -2.0
    forced = Xs[n_fresh + n_shift:][-DRIFT["window"]:]
    forced_y = yf[n_fresh + n_shift:][-DRIFT["window"]:]
    trainer.trigger(reason="forced-rejection")
    for i in range(len(forced)):  # the trigger's post-change window
        buffer.add(forced[i:i + 1], forced_y[i:i + 1])
    rejected = trainer.run_pending()
    flight.disarm()
    wl = rec.stop()
    kinds = [d["kind"] for d in flight.dump_records]
    v_live = reg.version("drift")
    fields = dict(
        replicas=clf.n_estimators_, rows_fresh=n_fresh,
        rows_shifted=state["served"] - n_fresh,
        shift=dict(scale=DRIFT["scale"], shift=DRIFT["shift"]),
        served_rows=state["served"], serve_seconds=serve_s,
        failed_requests=len(errors), errors=errors[:3],
        rows_served_before_first_alert=alert_at,
        psi_threshold=threshold,
        max_feature_psi={"before_shift": psi_before_shift,
                         "at_alert": psi_at_alert,
                         "after_swap": psi_after["psi_max"]},
        rows_after_swap=(state["served"] - state["swap_at"]
                         if state["swap_at"] is not None else None),
        refit=dict(record, seconds=record.get("seconds")),
        refit_phase_seconds=phases,
        gram_launches=launches["scaled_gram"],
        gram_launch_shapes=sorted(set(shapes)),
        gram_at_refit_shapes=kernel_rows,
        scores={"incumbent": record.get("incumbent_score"),
                "candidate_window": record.get("candidate_window_score"),
                "candidate_claim": record.get("candidate_score")},
        versions_served=sorted({v for v in versions if v is not None}),
        live_version=v_live,
        fresh_registry_version=fresh_version,
        fresh_registry_request_sizes_unequal=fresh_unequal,
        forced_rejection=[r.get("action") for r in rejected],
        flight_dump_kinds=kinds,
        workload_requests_recorded=wl.n_requests + record.get(
            "window_requests", 0),
        phase_seconds=time.perf_counter() - t_phase, card=CARD)
    shutil.rmtree(tmp, ignore_errors=True)
    ok = (not errors and alert_at is not None and alert_at >= n_fresh
          and psi_before_shift is not None and psi_before_shift < threshold
          and record.get("action") == "published"
          and record.get("candidate_window_score", -1)
          >= record.get("incumbent_score", 2)
          and psi_after["warmed"] and psi_after["psi_max"] < threshold
          and v_live == 2 and fields["fresh_registry_version"] == 2
          and fresh_unequal == 0
          and launches["scaled_gram"] == len(shapes) > 0
          and all(r["max_entry_err"] <= GRAM_TOL for r in kernel_rows)
          and [r.get("action") for r in rejected] == ["rejected"]
          and kinds.count("refit_rejected") == 1)
    emit("drift_loop", ok=ok, **fields)
    if not ok:
        fail("drift_loop", f"checks failed: {fields}")
    return launches["scaled_gram"]


# -- the operator's planes: capacity, performance, exposition, fleet ----

def http_get(port: int, path: str, timeout: float = 10.0):
    """(status, body text) of one GET on this host; HTTP errors are
    answers, not exceptions."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prometheus_samples(text: str, kinds=("counter", "gauge")) -> dict:
    """``{series with labels: value}`` of the samples of ``kinds`` in a
    Prometheus text exposition (the ``# TYPE`` lines give the kind)."""
    kind_of, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kind_of[name] = kind
        elif line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            if kind_of.get(series.split("{", 1)[0]) in kinds:
                out[series] = float(value)
    return out


def planes_traffic(b, Xs: np.ndarray, idx: np.ndarray, clients: int):
    """Closed-loop single-row traffic: ``clients`` threads submit the rows
    ``Xs[idx]`` back to back, each its contiguous share. Returns the
    outputs and served buckets by position, and rows/s, p50/p99 ms and
    failures."""
    import threading

    n = len(idx)
    outs, buckets, lat, errors = [None] * n, [None] * n, [0.0] * n, []
    share = -(-n // clients)
    gate = threading.Event()

    def client(c):
        gate.wait()
        for k in range(c * share, min(n, (c + 1) * share)):
            i = int(idx[k])
            t0 = time.perf_counter()
            try:
                fut = b.submit(Xs[i:i + 1])
                outs[k] = fut.result(60)
            except Exception as e:  # noqa: BLE001 - counted below
                errors.append(repr(e))
                continue
            lat[k] = time.perf_counter() - t0
            buckets[k] = fut.trace.breakdown.get("bucket")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    gate.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    done = sorted(v for v, o in zip(lat, outs) if o is not None)
    return {"outs": outs, "buckets": buckets, "latencies": done,
            "rows_per_sec": len(done) / wall,
            "p50_ms": percentile(done, 0.5) * 1e3 if done else None,
            "p99_ms": percentile(done, 0.99) * 1e3 if done else None,
            "failed": len(errors), "errors": errors[:3]}


def traffic_facts(t: dict) -> dict:
    return {k: t[k] for k in ("rows_per_sec", "p50_ms", "p99_ms", "failed")}


class Scraper:
    """A thread that GETs ``paths`` on the exposition server every
    ``every_s`` seconds, keeping each answer's status and milliseconds."""

    def __init__(self, port: int, paths=("/metrics", "/healthz"),
                 every_s: float = PLANES["scrape_every_s"]):
        import threading

        self.port, self.paths, self.every_s = port, paths, every_s
        self.answers = {p: [] for p in paths}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for p in self.paths:
                t0 = time.perf_counter()
                code, _ = http_get(self.port, p)
                self.answers[p].append((code, 1e3 * (time.perf_counter()
                                                     - t0)))
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)

    def facts(self) -> dict:
        out = {}
        for p, answers in self.answers.items():
            ms = sorted(m for _, m in answers)
            out[p] = {"scrapes": len(answers),
                      "statuses": sorted({c for c, _ in answers}),
                      "p50_ms": percentile(ms, 0.5) if ms else None,
                      "p99_ms": percentile(ms, 0.99) if ms else None}
        return out


def tensor_bytes(tree) -> int:
    """Bytes of every tensor of a tree of dicts, tuples and tensors."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return int(tree.nbytes) if isinstance(tree, torch.Tensor) else 0


def headline_learner():
    from spark_bagging_tpu_torch import LogisticRegression

    return LogisticRegression(max_iter=1, init="pooled",
                              hessian_impl="pallas", precision="highest")


def phase_planes(clf, X: np.ndarray, y: np.ndarray):
    """The operator's planes on the headline bag (256 replicas, the 1..256
    ladder, 4 clients of single rows through ``MicroBatcher(
    max_delay_ms=0.5)``): 1,600 rows unarmed, then the same rows with the
    capacity and performance planes armed and the exposition server
    scraped (``/metrics``, ``/healthz``) every 50 ms; a refit during
    traffic under ``GET /debug/profile?seconds=3``; the refit hot-swapped
    in under traffic; ``/debug/tail``; ``/healthz`` after ``close()`` and
    ``retire()``. Returns the refit's Gram launches, the registry (its
    model at version 2) for the fleet phase and the digest of its
    outputs on 64 rows."""
    t_phase = time.perf_counter()
    name = "planes"
    # the device profile lands under the telemetry dir: a scratch one
    tdir = tempfile.mkdtemp(prefix="sbt_planes_")
    prev_tdir = os.environ.get("SBT_TELEMETRY_DIR")
    os.environ["SBT_TELEMETRY_DIR"] = tdir
    try:
        return planes_run(clf, X, y, name, t_phase)
    finally:
        if prev_tdir is None:
            os.environ.pop("SBT_TELEMETRY_DIR", None)
        else:
            os.environ["SBT_TELEMETRY_DIR"] = prev_tdir
        import shutil

        shutil.rmtree(tdir, ignore_errors=True)


def planes_run(clf, X: np.ndarray, y: np.ndarray, name: str,
               t_phase: float):
    """The body of :func:`phase_planes`."""
    import gc
    import hashlib
    import threading

    from spark_bagging_tpu_torch import BaggingClassifier
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.serving.executor import counted_forward
    from spark_bagging_tpu_torch.telemetry import capacity, perf, server
    from spark_bagging_tpu_torch.utils import profiling

    Xs = X[:N_SERVE_ROWS]
    idx = np.random.default_rng(72).integers(0, len(Xs), PLANES["requests"])
    # a fresh serving stack: no health source or cached program of an
    # earlier phase (their batchers are closed, their captures in other
    # executors' pools)
    gc.collect()
    server.clear_health_sources()
    program_cache.clear()
    # the plane records the commit; the unarmed run runs with none
    cap = capacity.enable()
    reg = ModelRegistry(**SERVE_LADDERS["bench"])
    ex = reg.register(name, clf, warmup=True)
    capacity.disable()
    reqs = [Xs[np.random.default_rng(2).integers(0, len(Xs), n)]
            for n in (1, 5, 64, 200, 256, 300)]
    base = [ex.forward(r) for r in reqs]
    c0 = serving_compiles()
    b = reg.batcher(name, **SERVE_BATCHER)
    unarmed = planes_traffic(b, Xs, idx, PLANES["clients"])
    b.retire()
    # armed: both planes and the exposition server, first unscraped (the
    # probes' own cost), then scraped every 50 ms
    capacity.install(cap)
    perf.enable()
    port = server.start_server(port=0)
    b = reg.batcher(name, **SERVE_BATCHER)
    unscraped = planes_traffic(b, Xs, idx, PLANES["clients"])
    b.retire()
    ap = perf.enable()  # a fresh window: the scraped run's breakdowns
    b = reg.batcher(name, **SERVE_BATCHER)
    with Scraper(port) as scraper:
        armed = planes_traffic(b, Xs, idx, PLANES["clients"])
    b.retire()
    c1 = serving_compiles()
    fixed_unequal = sum(int(not np.array_equal(ex.forward(r), w))
                        for r, w in zip(reqs, base))
    # a row's output is a function of the row and its bucket's program;
    # a batch packed into several slabs reports a list of buckets, so
    # the traffic is compared where both runs served the row in a
    # one-slab batch of the same bucket
    both = [k for k in range(len(idx))
            if isinstance(unarmed["buckets"][k], int)
            and unarmed["buckets"][k] == armed["buckets"][k]
            and unarmed["outs"][k] is not None
            and armed["outs"][k] is not None]
    traffic_unequal = sum(int(not np.array_equal(unarmed["outs"][k],
                                                 armed["outs"][k]))
                          for k in both)
    summary = ap.summary()
    share_sums = {f"{e['path']}|{e['model']}":
                  sum(s["share"] for s in e["stages"].values())
                  for e in summary["by_key"]}
    led = cap.ledger()
    owner = led["owners"].get(name, {})
    params_bytes = tensor_bytes(clf.ensemble_) + tensor_bytes(clf.subspaces_)
    fn, params, subs = clf.aggregated_forward()
    params_cpu = {k: v.cpu() for k, v in params.items()}
    cpu_flops = {b_: counted_forward(
        fn, params_cpu, subs.cpu(),
        torch.zeros((b_, N_FEATURES), dtype=torch.float32))[1]["flops"]
        for b_ in ex.compiled_buckets}
    card_flops = {b_: c["flops"] for b_, c in ex.bucket_costs.items()}
    d_sub = int(clf.subspaces_.shape[1])
    analytic = {b_: 2 * b_ * N_REPLICAS * (d_sub + 1) * N_CLASSES
                for b_ in ex.compiled_buckets}
    ap.export()
    code, metrics = http_get(port, "/metrics")
    gauges = prometheus_samples(metrics, ("gauge",))
    mfu = gauges.get("sbt_perf_mfu")
    in_use = gauges.get('sbt_process_device_bytes_in_use{device="0"}')
    limit = gauges.get('sbt_process_device_bytes_limit{device="0"}')
    # a refit of the headline bag during traffic, under a device profile
    stop, traffic_errors, served_during = threading.Event(), [], [0]
    b = reg.batcher(name, **SERVE_BATCHER)

    def background():
        # paced (one request every ~5 ms) so that the trace stays small
        rng = np.random.default_rng(73)
        while not stop.wait(PLANES["profile_pace_s"]):
            i = int(rng.integers(0, len(Xs)))
            try:
                b.submit(Xs[i:i + 1]).result(60)
                served_during[0] += 1
            except Exception as e:  # noqa: BLE001 - counted
                traffic_errors.append(repr(e))

    traffic = threading.Thread(target=background, daemon=True)
    traffic.start()
    code_p, body = http_get(port, f"/debug/profile?seconds="
                                  f"{PLANES['profile_seconds']}")
    prof = json.loads(body)
    reset_launches()
    refit = BaggingClassifier(headline_learner(), n_estimators=N_REPLICAS,
                              seed=1).fit(X, y)
    counts = read_launches()
    rep = refit.fit_report_
    chunk = rep["chunk_size_resolved"] or N_REPLICAS
    lrn = headline_learner()
    expected = (lrn.pooled_iter
                + lrn.max_iter * len(range(0, N_REPLICAS, chunk)))
    deadline = time.monotonic() + 120
    while profiling.profile_active() is not None \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    stop.set()
    traffic.join(60)
    b.retire()
    trace_path = os.path.join(prof.get("dir", ""), "trace.json")
    trace = open(trace_path).read() if os.path.exists(trace_path) else ""
    code, metrics = http_get(port, "/metrics")
    gauges = prometheus_samples(metrics, ("gauge",))
    fit_keys = {k: float(v) for k, v in rep.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
    fit_unequal = sorted(k for k, v in fit_keys.items()
                         if gauges.get(f"sbt_fit_{k}") != v)
    # the refit hot-swapped in under traffic
    Xr = Xs[:2000]
    swap, swap_ok, new_ex = swap_under_traffic(
        reg, name, refit, Xr, clf.predict_proba(Xr), refit.predict_proba(Xr))
    led_after = cap.ledger()
    fps = {e["fingerprint"] for e in
           program_cache.cache().snapshot()["entries"]}
    code_t, body = http_get(port, "/debug/tail")
    tail = json.loads(body)["tail"]
    # /healthz: a closed batcher drains the node, a retired one leaves
    gc.collect()
    b = reg.batcher(name, **SERVE_BATCHER)
    b.submit(Xs[:1]).result(60)
    health_open = http_get(port, "/healthz")[0]
    b.close()
    health_closed = http_get(port, "/healthz")[0]
    b.retire()
    code_h, body = http_get(port, "/healthz")
    sources = sorted(json.loads(body)["sources"])
    digest = hashlib.sha256(new_ex.forward(Xs[:64]).tobytes()).hexdigest()
    fields = dict(
        replicas=N_REPLICAS, ladder=list(ex.compiled_buckets),
        requests=PLANES["requests"], clients=PLANES["clients"],
        unarmed=traffic_facts(unarmed),
        armed_unscraped=traffic_facts(unscraped),
        armed=traffic_facts(armed),
        captures_on_requests=c1 - c0,
        fixed_requests_unequal=fixed_unequal,
        traffic_same_bucket_compared=len(both),
        traffic_same_bucket_unequal=traffic_unequal,
        scrapes=scraper.facts(), stage_share_sums=share_sums,
        stages=summary["stages"],
        ledger={"compiled_bytes": owner.get("bytes"),
                "graph_pool_bytes": ex.graph_pool_bytes,
                "entries": owner.get("entries"),
                "unmeasured": owner.get("unmeasured"),
                "params_bytes": led["committed"][f"{name}@1"][
                    "params_bytes"],
                "params_tensor_bytes": params_bytes,
                "reconciled": led["reconciled"]},
        bucket_flops={"card": card_flops, "cpu": cpu_flops,
                      "analytic": analytic},
        bucket_bytes={b_: c["bytes"] for b_, c in ex.bucket_costs.items()},
        serving_mfu=mfu, cost_model=summary["cost_model"],
        device_bytes_in_use=in_use, device_bytes_limit=limit,
        profile={"status": code_p, "trace_bytes": len(trace),
                 "names_scaled_gram": "scaled_gram" in trace,
                 "names_graph_launch": "cudaGraphLaunch" in trace,
                 "served_during": served_during[0],
                 "failed_during": len(traffic_errors)},
        refit={"fit_seconds": rep["fit_seconds"], "launches": counts,
               "expected_scaled_gram_launches": expected,
               "fit_gauges_unequal": fit_unequal,
               "fit_gauges_compared": len(fit_keys)},
        swap=swap,
        ledger_after_swap={
            "committed": {k: v["live"] for k, v in
                          led_after["committed"].items()},
            "compiled_bytes": led_after["owners"].get(name, {}).get(
                "bytes"),
            "graph_pool_bytes": new_ex.graph_pool_bytes,
            "only_new_fingerprint": fps == {new_ex.fingerprint},
            "reconciled": led_after["reconciled"]},
        tail_verdicts=[t["verdict"] for t in tail],
        healthz={"open": health_open, "closed": health_closed,
                 "retired": code_h, "sources_after_retire": sources},
        outputs_digest=digest, card=CARD,
        seconds=time.perf_counter() - t_phase)
    ok = (fields["captures_on_requests"] == 0 and fixed_unequal == 0
          and len(both) > 0 and traffic_unequal == 0
          and unarmed["failed"] == 0 and armed["failed"] == 0
          and unscraped["failed"] == 0
          and scraper.facts()["/healthz"]["statuses"] == [200]
          and scraper.facts()["/metrics"]["statuses"] == [200]
          and scraper.facts()["/healthz"]["scrapes"] > 0
          and share_sums and all(abs(s - 1.0) <= 1e-9
                                 for s in share_sums.values())
          and led["reconciled"] and owner.get("unmeasured") == 0
          and owner.get("bytes") == ex.graph_pool_bytes > 0
          and fields["ledger"]["params_bytes"] == params_bytes > 0
          and card_flops == cpu_flops == analytic
          and mfu is not None and 0 < mfu < 1
          and in_use is not None and limit is not None
          and 0 < in_use <= limit
          and code_p == 200 and trace and "scaled_gram" in trace
          and "cudaGraphLaunch" in trace and not traffic_errors
          and counts["scaled_gram"] == expected
          and not fit_unequal and fit_keys
          and swap_ok
          and led_after["committed"][f"{name}@1"] is not None
          and led_after["committed"][f"{name}@1"]["live"] is False
          and led_after["committed"][f"{name}@2"]["live"] is True
          and fps == {new_ex.fingerprint}
          and led_after["owners"][name]["bytes"] == new_ex.graph_pool_bytes
          and led_after["reconciled"]
          and code_t == 200 and tail
          and all(v in perf.VERDICTS for v in fields["tail_verdicts"])
          and health_open == 200 and health_closed == 503
          and code_h == 200
          and not any(s.startswith("batcher") for s in sources))
    emit("planes", ok=ok, **fields)
    if not ok:
        fail("planes", f"checks failed: {fields}")
    return counts["scaled_gram"], reg, digest


def phase_planes_trees(tree, X: np.ndarray) -> None:
    """Config 3's hard-vote trees served for 800 single rows with the
    capacity and performance planes armed: the trees' forward runs no
    counted product, so every bucket's ``flops`` is None and the cost
    model falls back to rows; the capacity bytes still reconcile."""
    import gc

    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry
    from spark_bagging_tpu_torch.telemetry import capacity, perf, server

    name = "planes_trees"
    Xs = X[:N_SERVE_ROWS]
    idx = np.random.default_rng(74).integers(0, len(Xs),
                                             PLANES["tree_rows"])
    gc.collect()
    cap = capacity.enable()
    ap = perf.enable()
    port = server.start_server(port=0)
    try:
        reg = ModelRegistry(**SERVE_LADDERS["bench"])
        ex = reg.register(name, tree, warmup=True)
        b = reg.batcher(name, **SERVE_BATCHER)
        with Scraper(port) as scraper:
            served = planes_traffic(b, Xs, idx, PLANES["clients"])
        b.retire()
        want = tree.predict_proba(Xs[idx])
        unequal = sum(int(not np.array_equal(o, want[k:k + 1]))
                      for k, o in enumerate(served["outs"]))
        led = cap.ledger()
        owner = led["owners"].get(name, {})
        cm = ap.cost_model()
        fields = dict(
            ladder=list(ex.compiled_buckets), served=traffic_facts(served),
            votes_unequal_to_predict_proba=unequal,
            bucket_flops={b_: c["flops"] for b_, c in
                          ex.bucket_costs.items()},
            bucket_bytes={b_: c["bytes"] for b_, c in
                          ex.bucket_costs.items()},
            cost_model_achieved_flops={k: v["achieved_flops"]
                                       for k, v in cm.items()},
            seconds_per_row={k: v["seconds_per_row"] for k, v in cm.items()},
            ledger={"compiled_bytes": owner.get("bytes"),
                    "graph_pool_bytes": ex.graph_pool_bytes,
                    "unmeasured": owner.get("unmeasured"),
                    "reconciled": led["reconciled"]},
            scrapes=scraper.facts(), card=CARD)
        ok = (served["failed"] == 0 and unequal == 0
              and all(c["flops"] is None for c in ex.bucket_costs.values())
              and all(v["achieved_flops"] is None for v in cm.values())
              and cm and led["reconciled"] and owner.get("unmeasured") == 0
              and owner.get("bytes") == ex.graph_pool_bytes > 0
              and scraper.facts()["/healthz"]["statuses"] == [200])
        emit("planes_trees", ok=ok, **fields)
        if not ok:
            fail("planes_trees", f"checks failed: {fields}")
    finally:
        server.stop_server()
        capacity.disable()
        perf.disable()
        telemetry.recorder.disarm()


def fleet_peer(d: str) -> int:
    """The fleet phase's second process: load the parent's registry
    checkpoint, warm up, start the exposition server, write its port,
    serve its share of rows inside a capture log, report, and wait to be
    killed."""
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry
    from spark_bagging_tpu_torch.telemetry import server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "peer_args.json")) as f:
        args = json.load(f)
    Xs = np.load(os.path.join(d, "rows.npy"))
    reg = ModelRegistry(**SERVE_LADDERS["bench"])
    reg.load(args["name"], os.path.join(d, "ckpt"), warm=True)
    port = server.start_server(port=0)
    with open(os.path.join(d, "peer_port.tmp"), "w") as f:
        f.write(str(port))
    os.replace(os.path.join(d, "peer_port.tmp"),
               os.path.join(d, "peer_port"))
    c0 = serving_compiles()
    with telemetry.capture(os.path.join(d, "peer.jsonl")):
        b = reg.batcher(args["name"], **SERVE_BATCHER)
        served = planes_traffic(b, Xs, np.arange(len(Xs)), args["clients"])
        b.retire()
    report = {**traffic_facts(served),
              "captures_on_requests": serving_compiles() - c0,
              "version": reg.version(args["name"])}
    with open(os.path.join(d, "peer_served.tmp"), "w") as f:
        json.dump(report, f)
    os.replace(os.path.join(d, "peer_served.tmp"),
               os.path.join(d, "peer_served.json"))
    time.sleep(600)  # the parent kills this process
    return 0


def wait_for(path: str, proc, timeout_s: float) -> None:
    """Wait for the fleet peer to write ``path``; fail the phase with its
    log's tail when it exits or times out first."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(os.path.join(os.path.dirname(path), "peer.log")) as f:
                tail = f.read()[-3000:]
            fail("fleet", f"the peer wrote no {os.path.basename(path)} "
                          f"(exit {proc.poll()}): {tail}")
        time.sleep(0.1)


def phase_fleet(reg, X: np.ndarray, digest: str) -> None:
    """Two serving processes on one card: the parent ``save``s its
    registry and starts ``chip_smoke.py --fleet-peer``, which loads it;
    each process serves 800 rows inside a capture log; a
    ``FleetAggregator`` over both ``/varz`` merges them exactly; the peer
    is killed and goes stale (quorum degraded, no counter falls);
    ``python -m spark_bagging_tpu_torch.telemetry dump --merge`` over the
    two logs gives the live merge's counters; an ``SLOSpec`` is
    evaluated on the phase's report, which is appended to the history
    store twice without a digest flip."""
    import hashlib
    import shutil

    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.telemetry import (
        capacity,
        fleet,
        history,
        perf,
        server,
        slo,
    )

    t_phase = time.perf_counter()
    name = "planes"
    d = tempfile.mkdtemp(prefix="sbt_fleet_")
    peer = None
    try:
        rows = np.ascontiguousarray(
            X[np.random.default_rng(75).integers(0, N_SERVE_ROWS,
                                                 PLANES["fleet_rows"])])
        np.save(os.path.join(d, "rows.npy"), rows)
        with open(os.path.join(d, "peer_args.json"), "w") as f:
            json.dump({"name": name, "clients": PLANES["clients"]}, f)
        reg.save(name, os.path.join(d, "ckpt"))
        with open(os.path.join(d, "peer.log"), "w") as log:
            peer = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--fleet-peer",
                 d], stdout=log, stderr=subprocess.STDOUT)
        port = server.start_server(port=0)
        wait_for(os.path.join(d, "peer_port"), peer, 300)
        with open(os.path.join(d, "peer_port")) as f:
            peer_port = int(f.read())
        c0 = serving_compiles()
        flops0 = telemetry.registry().counter("sbt_serving_flops_total").value
        pad0 = telemetry.registry().counter(
            "sbt_serving_padding_flops_total").value
        with telemetry.capture(os.path.join(d, "parent.jsonl")):
            b = reg.batcher(name, **SERVE_BATCHER)
            served = planes_traffic(b, rows, np.arange(len(rows)),
                                    PLANES["clients"])
            b.retire()
        captures = serving_compiles() - c0
        flops = telemetry.registry().counter(
            "sbt_serving_flops_total").value - flops0
        pad = telemetry.registry().counter(
            "sbt_serving_padding_flops_total").value - pad0
        wait_for(os.path.join(d, "peer_served.json"), peer, 300)
        with open(os.path.join(d, "peer_served.json")) as f:
            peer_report = json.load(f)
        own = {}
        for proc, p in (("parent", port), ("peer", peer_port)):
            varz = json.loads(http_get(p, "/varz")[1])
            own[proc] = {(e["name"], json.dumps(e["labels"],
                                                sort_keys=True)): e
                         for e in varz["metrics"]}
        agg = fleet.FleetAggregator(
            [fleet.HTTPPeer("parent", f"http://127.0.0.1:{port}"),
             fleet.HTTPPeer("peer", f"http://127.0.0.1:{peer_port}")],
            interval_s=0.0, quorum=1)
        agg.tick(force=True)
        req_key = ("sbt_serving_requests_total", "{}")
        lat_key = ("sbt_serving_latency_seconds", "{}")
        requests_sum = sum(own[p][req_key]["value"] for p in own)
        merged_requests = agg.peek("sbt_serving_requests_total").value
        merged_lat = next(e for e in agg.merged_snapshot()
                          if e["name"] == lat_key[0] and not e["labels"])
        lat_sum = [sum(own[p][lat_key]["buckets"][i][1] for p in own)
                   for i in range(len(merged_lat["buckets"]))]
        skew = agg.peek("sbt_fleet_version_skew", {"model": name}).value
        live = telemetry.render_prometheus(agg.merged_snapshot())
        live_counters = {k: v for k, v in prometheus_samples(
            live, ("counter",)).items() if not k.startswith("sbt_fleet_")}
        before = prometheus_samples(live, ("counter",))
        # the peer dies: it goes stale, its counters freeze
        peer.kill()
        peer.wait(60)
        agg.tick(force=True)
        health = agg.fleet_health()
        after = prometheus_samples(
            telemetry.render_prometheus(agg.merged_snapshot()),
            ("counter",))
        fallen = sorted(k for k, v in before.items()
                        if after.get(k, 0.0) < v or (v and not after.get(k)))
        dump = subprocess.run(
            [sys.executable, "-m", "spark_bagging_tpu_torch.telemetry",
             "dump", "--merge", "--no-quantiles",
             os.path.join(d, "parent.jsonl"), os.path.join(d, "peer.jsonl")],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        dumped = {k: v for k, v in prometheus_samples(
            dump.stdout, ("counter",)).items()
            if not k.startswith("sbt_fleet_")}
        dump_unequal = sorted(k for k in set(dumped) | set(live_counters)
                              if dumped.get(k) != live_counters.get(k))
        # the SLO gate on the phase's report, and the history store
        report = {"latency_ms": {"p50": served["p50_ms"],
                                 "p95": percentile(served["latencies"],
                                                   0.95) * 1e3,
                                 "p99": served["p99_ms"]},
                  "rps": served["rows_per_sec"],
                  "padding": {"waste_flops_frac": pad / flops
                              if flops else None},
                  "post_warmup_compiles": captures, "overloads": 0}
        spec = slo.SLOSpec(p99_ms=PLANES["slo_p99_ms"],
                           max_padding_waste=PLANES["slo_padding_waste"],
                           max_post_warmup_compiles=0)
        verdict = slo.evaluate(spec, report)
        hist = os.path.join(d, "telemetry", "history", "history.jsonl")
        for _ in range(2):
            again = hashlib.sha256(reg.executor(name).forward(
                X[:64]).tobytes()).hexdigest()
            history.append_record(
                "bench", "fleet", digests={"outputs": again},
                numbers={"rps": served["rows_per_sec"],
                         "p99_ms": served["p99_ms"]},
                slo_ok=verdict.ok, path=hist)
        trend = history.compare_trend(history.read_history(path=hist))
        fields = dict(
            rows_per_process=PLANES["fleet_rows"],
            parent=traffic_facts(served), peer=peer_report,
            captures_on_requests=captures,
            requests={"parent": own["parent"][req_key]["value"],
                      "peer": own["peer"][req_key]["value"],
                      "sum": requests_sum, "merged": merged_requests},
            latency_count={"merged": merged_lat["count"],
                           "bucketwise_sum_equal":
                           [c for _, c in merged_lat["buckets"]]
                           == lat_sum},
            version_skew=skew,
            after_kill={"healthy": health["healthy"],
                        "degraded": health["degraded"],
                        "peer_fresh": health["peers"]["peer"]["fresh"],
                        "stale": agg.peek("sbt_fleet_peers_stale").value,
                        "counters_fallen": fallen[:5]},
            dump_merge={"rc": dump.returncode,
                        "counters": len(dumped),
                        "unequal_to_live": dump_unequal[:5],
                        "stderr": dump.stderr[-300:]},
            slo=verdict.to_dict(),
            history={"records": trend["runs"], "flips": trend["flips"],
                     "digest_matches_planes": again == digest},
            card=CARD, seconds=time.perf_counter() - t_phase)
        ok = (served["failed"] == 0 and peer_report["failed"] == 0
              and captures == 0 and peer_report["captures_on_requests"] == 0
              and merged_requests == requests_sum > 0
              and fields["latency_count"]["bucketwise_sum_equal"]
              and merged_lat["count"] == sum(lat_sum) > 0
              and skew == 0 and peer_report["version"] == reg.version(name)
              and health["degraded"] and not health["peers"]["peer"]["fresh"]
              and not fallen and dump.returncode == 0 and dumped
              and not dump_unequal and verdict.ok
              and trend["runs"] == 2 and not trend["flips"]
              and again == digest)
        emit("fleet", ok=ok, **fields)
        if not ok:
            fail("fleet", f"checks failed: {fields}")
    finally:
        if peer is not None and peer.poll() is None:
            peer.kill()
            peer.wait(60)
        server.stop_server()
        capacity.disable()
        perf.disable()
        telemetry.recorder.disarm()
        shutil.rmtree(d, ignore_errors=True)


# -- the tenancy plane: admission, fair queuing, residency, budgets -----

def tenant_names() -> list[str]:
    return [f"t{i}" for i in range(TENANCY["tenants"])]


def tenant_specs():
    """The JAX drill's specs: priorities cycle with rank, weights
    descend with it, only the Zipf head is quota-bound."""
    from spark_bagging_tpu_torch.tenancy import PRIORITY_CLASSES, TenantSpec

    n = TENANCY["tenants"]
    return [TenantSpec(name=f"t{i}",
                       priority=PRIORITY_CLASSES[i % len(PRIORITY_CLASSES)],
                       weight=float(n - i),
                       quota_rps=TENANCY["head_quota_rps"] if i == 0
                       else None)
            for i in range(n)]


def tenant_stack(models: list, threaded: bool = False):
    """One fresh stack, as the JAX drill builds one a run: a private
    capacity plane and a pin-policy program cache installed, one
    registry on the 1..256 ladder, the fleet with every tenant
    registered and warmed. Returns ``(fleet, plane, aot_root, undo)``."""
    import shutil

    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.serving.buckets import bucket_ladder
    from spark_bagging_tpu_torch.telemetry import capacity
    from spark_bagging_tpu_torch.tenancy import TenantFleet
    from spark_bagging_tpu_torch.tenancy.residency import cache_pin_policy

    ladder = SERVE_LADDERS["bench"]
    rungs = len(bucket_ladder(ladder["min_bucket_rows"],
                              ladder["max_batch_rows"]))
    plane = capacity.CapacityPlane(hot_rps=TENANCY["hot_rps"],
                                   warm_rps=TENANCY["warm_rps"])
    prev_plane = capacity.install(plane)
    prev_cache = program_cache.install(program_cache.ProgramCache(
        capacity=(TENANCY["residency"] + 2) * rungs,
        pin_policy=cache_pin_policy(plane)))
    aot_root = tempfile.mkdtemp(prefix="tenancy_aot_")
    fleet = TenantFleet(
        tenant_specs(), registry=ModelRegistry(**ladder),
        residency_capacity=TENANCY["residency"], aot_root=aot_root,
        plane=plane, threaded=threaded,
        refit_total_per_window=TENANCY["refit_total"],
        refit_window_s=TENANCY["refit_window_s"],
        quarantine_window_s=TENANCY["quarantine_window_s"],
        quarantine_backoff_s=TENANCY["quarantine_backoff_s"],
        quarantine_seed=TENANCY["seed"], batcher_opts=TENANCY["batcher"])
    for name, model in zip(tenant_names(), models):
        fleet.register(name, model, warmup=True, version=1)

    def undo():
        fleet.close()
        program_cache.install(prev_cache)
        capacity.install(prev_plane)
        shutil.rmtree(aot_root, ignore_errors=True)

    return fleet, plane, aot_root, undo


def zipf_owners(n_requests: int, seed: int) -> np.ndarray:
    """Each request's tenant index: one seeded Zipf draw, rank 1 (t0)
    the head."""
    n = TENANCY["tenants"]
    p = np.arange(1, n + 1, dtype=np.float64) ** -TENANCY["zipf_s"]
    return np.random.default_rng(seed).choice(n, size=n_requests,
                                              p=p / p.sum())


def tenancy_workload():
    """The stepped drive's schedule (virtual arrival times and row
    counts), each request's tenant and its rows: slices of one pool of
    fresh covtype rows at an index-keyed offset, as the JAX drill slices
    its payload pool."""
    from spark_bagging_tpu_torch.telemetry import workload

    reqs = workload.synthetic_workload(
        "poisson", rate_rps=TENANCY["rate_rps"],
        duration_s=TENANCY["duration_s"], seed=TENANCY["seed"],
        rows=TENANCY["rows"], width=N_FEATURES).requests
    pool, _ = fresh_covtype(TENANCY["pool_rows"], TENANCY["seed"])
    rows_max = max(r.rows for r in reqs)

    def payload(idx: int) -> np.ndarray:
        start = (idx * 131) % (len(pool) - rows_max + 1)
        return pool[start:start + reqs[idx].rows]

    return reqs, zipf_owners(len(reqs), TENANCY["seed"]), payload


def plan_windows(requests, max_delay_s: float,
                 idle_flush_s: float) -> list[list[int]]:
    """Coalescing windows on the virtual clock, as the JAX drill groups
    them (benchmarks/replay.py:101): a window opens at its first
    arrival, admits arrivals until open + max_delay_s, and closes early
    at a gap above idle_flush_s."""
    windows, i, n = [], 0, len(requests)
    while i < n:
        t_open = requests[i].t
        window, last, j = [i], t_open, i + 1
        while j < n:
            t = requests[j].t
            if t > t_open + max_delay_s or t - last > idle_flush_s:
                break
            window.append(j)
            last = t
            j += 1
        windows.append(window)
        i = j
    return windows


def compiles_of(name: str | None = None) -> float:
    from spark_bagging_tpu_torch import telemetry

    return telemetry.registry().counter(
        "sbt_serving_compiles_total",
        labels=None if name is None else {"model": name}).value


def stepped_drive(models: list, workload, n_requests: int, *,
                  plan=None, refit=None, inspect=None) -> dict:
    """The stepped fleet drive on a virtual clock over the first
    ``n_requests`` of ``workload``: each window's requests are submitted
    (admission, WFQ) and dispatched (residency touched before each
    tenant's own forwards), one fresh stack a run. After every restore
    (and the demotion it caused) and after every window the capacity
    ledger's bytes must equal the residents' ``graph_pool_bytes`` and a
    demoted tenant's must read 0. ``plan`` is armed after warm-up;
    ``refit(w_i, vt, fleet)`` runs after each window, and then the
    snapshots' refit-budget asks are left out (the trainers' triggers
    are the budget's only callers); ``inspect(fleet)`` runs before the
    stack closes. Returns the deterministic transcript and
    its digest, each served request's output and the (tenant, version,
    request ids) each window served, and the captures: at restores, at
    swaps, and on requests (everything else after warm-up)."""
    import hashlib
    from collections import deque

    from spark_bagging_tpu_torch import faults
    from spark_bagging_tpu_torch.tenancy import AdmissionShed

    reqs, owner, payload = workload
    names = tenant_names()
    fleet, plane, aot_root, undo = tenant_stack(models)
    res = fleet.residency
    bad, checks, mem, caps = [], [0], {}, {"restore": 0.0, "swap": 0.0}

    def check_ledger(where: str) -> None:
        checks[0] += 1
        led = plane.ledger()
        residents = set(res.residents())
        want = sum(fleet.registry.executor(t).graph_pool_bytes
                   for t in residents)
        demoted = {t: fleet.registry.executor(t).graph_pool_bytes
                   for t in names if t not in residents}
        if (led["cache"]["bytes"] != want or not led["reconciled"]
                or any(demoted.values())):
            bad.append(dict(where=where, ledger=led["cache"]["bytes"],
                            residents=want, demoted=demoted))

    real_touch = res.touch
    # each tenant's restores: count and seconds (the touch that restored
    # it, the demotion it caused included)
    restore_s = {t: [0, 0.0] for t in names}

    def touch(name: str) -> str:
        c0 = compiles_of()
        t_touch = time.perf_counter()
        status = real_touch(name)
        if status == "restored":
            restore_s[name][0] += 1
            restore_s[name][1] += time.perf_counter() - t_touch
            caps["restore"] += compiles_of() - c0
            check_ledger(f"restore {name}")
        return status

    res.touch = touch
    windows = plan_windows(reqs[:n_requests],
                           TENANCY["batcher"]["max_delay_ms"] / 1e3,
                           TENANCY["batcher"]["idle_flush_ms"] / 1e3)
    c_warm = compiles_of()
    c_warm_t = {t: compiles_of(t) for t in names}
    pool_bytes = {t: fleet.registry.executor(t).graph_pool_bytes
                  for t in names}
    mem["reserved_after_warmup"] = torch.cuda.memory_reserved()
    pending = {t: deque() for t in names}
    futs, comp, wfq_order, snapshots, budget_log = {}, [], [], [], []
    # each tenant's captures after warm-up, at the end of every window
    caps_by_window = []
    shed_at_submit = []

    def snap(w_i: int, vt: float) -> None:
        plane.classify(now=vt)
        snapshots.append({
            "window": w_i, "residents": list(res.residents()),
            "demand": plane.demand_summary(),
            "evictions": plane.eviction_counts(),
            "pressure_level": fleet.admission.pressure_level(vt),
            "admitted": fleet.admission.admitted_counts(),
            "wfq_served": fleet.wfq.service_totals(),
        })
        # the refit-budget transcript: the two hottest tenants by
        # admitted requests ask for a refit slot at every snapshot
        if refit is not None:
            return
        admitted = fleet.admission.admitted_counts()
        for name in sorted(admitted, key=lambda t: (-admitted[t], t))[:2]:
            budget_log.append({"window": w_i, "tenant": name,
                               "allowed": fleet.refit_allowed(name, vt)})

    if plan is not None:
        faults.arm(plan)
    t0 = time.perf_counter()
    try:
        for w_i, window in enumerate(windows):
            vt = reqs[window[0]].t
            for idx in window:
                name = names[int(owner[idx])]
                try:
                    fleet.submit(name, payload(idx), now=vt)
                    pending[name].append(idx)
                except AdmissionShed as e:
                    shed_at_submit.append((idx, name, e.reason))
            drained = fleet.dispatch(now=vt)
            served: dict[str, list] = {}
            for rec in drained:
                idx = pending[rec["tenant"]].popleft()
                if rec["future"] is not None:
                    futs[idx] = rec["future"]
                    served.setdefault(rec["tenant"], []).append(idx)
            comp.append([(t, fleet.registry.version(t), ids)
                         for t, ids in sorted(served.items())])
            caps_by_window.append({t: compiles_of(t) - c_warm_t[t]
                                   for t in names})
            wfq_order.append([rec["tenant"] for rec in drained])
            check_ledger(f"window {w_i}")
            if (w_i % TENANCY["snapshot_every"] == 0
                    or w_i == len(windows) - 1):
                snap(w_i, vt)
            if refit is not None:
                c0 = compiles_of()
                refit(w_i, vt, fleet)
                caps["swap"] += compiles_of() - c0
        drive_s = time.perf_counter() - t0
    finally:
        if plan is not None:
            faults.disarm()
    post_warmup = compiles_of() - c_warm
    events = res.events()
    outputs, failed = {}, []
    for idx, fut in futs.items():
        try:
            outputs[idx] = fut.result(0)
        except Exception as e:  # noqa: BLE001 - counted
            failed.append((idx, repr(e)))
    transcript = {
        "specs": [fleet.specs[t].to_dict() for t in sorted(fleet.specs)],
        "snapshots": snapshots, "wfq_order": wfq_order,
        "residency_events": events,
        "residents_final": list(res.residents()),
        "admitted": fleet.admission.admitted_counts(),
        "sheds": fleet.admission.shed_counts(),
        "downstream_sheds": fleet.shed_counts(),
        "served_rows": fleet.served_rows(),
        "wfq_served": fleet.wfq.service_totals(),
        "budget_log": budget_log, "budget_counts": fleet.budget.counts(),
        "quarantine": {
            "events": [{k: v for k, v in e.items() if k != "trace_id"}
                       for e in fleet.quarantine.events()],
            "counts": fleet.quarantine.counts()},
        "demand_final": plane.demand_summary(),
        "evictions_by_owner": plane.eviction_counts(),
    }
    if inspect is not None:
        inspect(fleet)
    mem["reserved_at_end"] = torch.cuda.memory_reserved()
    aot_written = os.listdir(aot_root)
    undo()
    del fleet
    torch.cuda.empty_cache()
    mem["reserved_after_close_and_empty_cache"] = torch.cuda.memory_reserved()
    restore_buckets = sum(e.get("buckets", 0) for e in events
                          if e["kind"] == "restore")
    return dict(
        transcript=transcript,
        digest=hashlib.sha256(json.dumps(
            transcript, sort_keys=True).encode()).hexdigest(),
        outputs=outputs, failed=failed, comp=comp, windows=len(windows),
        caps_by_window=caps_by_window,
        requests=sum(len(w) for w in windows),
        shed_at_submit=shed_at_submit, drive_seconds=drive_s,
        post_warmup_captures=post_warmup,
        post_warmup_by_tenant={t: compiles_of(t) - c_warm_t[t]
                               for t in names},
        restore_captures=caps["restore"], swap_captures=caps["swap"],
        request_captures=post_warmup - caps["restore"] - caps["swap"],
        restore_buckets=restore_buckets,
        demotions=sum(1 for e in events if e["kind"] == "demote"),
        restores=sum(1 for e in events if e["kind"] == "restore"),
        ledger_checks=checks[0], ledger_unequal=bad[:3],
        ledger_unequal_count=len(bad), memory=mem, pool_bytes=pool_bytes,
        restore_ms={t: 1e3 * s / n for t, (n, s) in restore_s.items()
                    if n},
        aot_root_written=aot_written)


def release_memory(models: list) -> dict:
    """``torch.cuda.memory_reserved()`` around one release of a warmed
    executor's programs (the headline bag's and the trees'): after the
    release, then after ``torch.cuda.empty_cache()`` (which residency
    calls after each demotion), then after the ladder is captured
    again — what a demotion gives back to the card, and when."""
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache

    out = {}
    prev = program_cache.install(program_cache.ProgramCache())
    try:
        for i in (0, TENANCY["tenants"] - 1):
            ex = ModelRegistry(**SERVE_LADDERS["bench"]).register(
                f"t{i}", models[i], warmup=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            pool = ex.graph_pool_bytes
            buckets = ex.release_programs()
            r1 = torch.cuda.memory_reserved()
            torch.cuda.empty_cache()
            r2 = torch.cuda.memory_reserved()
            ex.warmup(buckets)
            out[f"t{i}"] = dict(
                graph_pool_bytes=pool, reserved_warm=r0,
                after_release=r1, after_empty_cache=r2,
                after_recapture=torch.cuda.memory_reserved(),
                graph_pool_bytes_recaptured=ex.graph_pool_bytes)
    finally:
        program_cache.install(prev)
    return out


def solo_outputs(model_of: dict, comp: list, payload) -> dict:
    """Each served request again, through its tenant's model (at the
    version that served it) behind a registry of its own that never
    demotes, in the same batches: per window, the tenant's requests
    through a stepped batcher with the fleet's options. Keyed by
    request id."""
    from spark_bagging_tpu_torch.serving import ModelRegistry

    batchers, out = {}, {}
    for window in comp:
        for tenant, version, ids in window:
            b = batchers.get((tenant, version))
            if b is None:
                reg = ModelRegistry(**SERVE_LADDERS["bench"])
                reg.register("solo", model_of[tenant, version])
                b = batchers[tenant, version] = reg.batcher(
                    "solo", threaded=False, **TENANCY["batcher"])
            futs = [b.submit(payload(i)) for i in ids]
            b.run_pending()
            for i, f in zip(ids, futs):
                out[i] = f.result(0)
    for b in batchers.values():
        b.close()
    return out


def unequal_outputs(got: dict, want: dict, ids) -> list:
    return [i for i in ids
            if i not in want or not np.array_equal(got[i], want[i])]


def tenant_fits(X: np.ndarray, y: np.ndarray, tree) -> tuple[list, int]:
    """t0..t4: the headline bag with seeds 0..4 (each fit's Gram launches
    checked against pooled_iter + max_iter x chunks); t5: config 3's
    trees, already fitted. Returns the models and the fits' launches."""
    from spark_bagging_tpu_torch import BaggingClassifier

    models, launches, expected, seconds = [], 0, 0, []
    for seed in range(TENANCY["tenants"] - 1):
        learner = headline_learner()
        reset_launches()
        t0 = time.perf_counter()
        clf = BaggingClassifier(learner, n_estimators=N_REPLICAS,
                                seed=seed).fit(X, y)
        seconds.append(time.perf_counter() - t0)
        launches += read_launches()["scaled_gram"]
        chunk = clf.fit_report_["chunk_size_resolved"] or N_REPLICAS
        expected += learner.pooled_iter + learner.max_iter * len(
            range(0, N_REPLICAS, chunk))
        models.append(clf)
    if launches != expected:
        fail("tenancy", f"tenant fits launched the scaled-Gram kernel "
             f"{launches} times, expected {expected}")
    return models + [tree], launches, seconds


def refit_hook(at_window: int):
    """The budgeted refits, run after window ``at_window`` of a stepped
    drive: t0 and t3 each get an ``OnlineTrainer`` over a buffer of
    TENANCY["refit_rows"] shifted labelled rows with the fleet
    budgeter's hook. Each tenant is triggered until the window's budget
    is spent (its quota, then one more): every allowed trigger is
    refitted cold (8 Gram launches at n = 1,024) and published (swapped
    in) on the drive's thread between windows; the last is denied and
    counted. Returns the hook and its record."""
    from spark_bagging_tpu_torch.online import LabeledBuffer, OnlineTrainer

    n = TENANCY["refit_rows"]
    Xr, yr = fresh_covtype(4 * n, TENANCY["seed"] + 2)
    Xr = Xr + np.float32(TENANCY["refit_shift"])
    record = {"tenants": {}, "models": {}, "windows": []}

    def hook(w_i: int, vt: float, fleet) -> None:
        if w_i != at_window:
            return
        k = 0
        for name in ("t0", "t3"):
            quota = fleet.budget.quota(name)
            buf = LabeledBuffer(capacity_rows=n, labels={"model": name})
            tr = OnlineTrainer(
                fleet.registry, name, buf, epochs=1, batch_rows=n,
                min_refit_rows=n // 2, margin=TENANCY["refit_margin"],
                seed=TENANCY["seed"],
                refit_budget=fleet.budget.for_tenant(name),
                updater_opts={"warm": False})
            actions, t0 = [], time.perf_counter()
            for _ in range(quota + 1):
                buf.add(Xr[k * n:(k + 1) * n], yr[k * n:(k + 1) * n])
                tr.trigger(reason="drift", now=vt)
                if tr.pending:
                    k += 1
                    actions += [r.get("action") for r in tr.run_pending()]
                    version = fleet.registry.version(name)
                    record["models"][name, version] = (
                        fleet.registry.model(name))
            record["tenants"][name] = dict(
                quota=quota, actions=actions,
                budget_denied=tr.budget_denied,
                version=fleet.registry.version(name),
                seconds=time.perf_counter() - t0)
        record["windows"].append(w_i)
        record["window_rows"] = Xr[:n]

    return hook, record


def threaded_drive(models: list) -> dict:
    """The threaded fleet: TENANCY["clients"] clients send single rows
    (Zipf-routed, row seed 81); each submits and dispatches under one
    lock on the wall clock (the WFQ is driven at window boundaries, not
    free-running) and waits for its answer outside it, while the
    tenants' batcher threads forward concurrently. Numbers, not gates:
    rows/s, each tenant's p50/p99, the tail tenants' p99, sheds, and the
    captures on the request path (a restore on the dispatch thread can
    demote a tenant whose requests wait in its batcher: they capture on
    demand on its thread)."""
    import threading

    from spark_bagging_tpu_torch.tenancy import AdmissionShed

    n = TENANCY["threaded_requests"]
    names = tenant_names()
    Xs, _ = fresh_covtype(n, TENANCY["seed"] + 1)
    owner = zipf_owners(n, TENANCY["seed"] + 1)
    fleet, plane, _root, undo = tenant_stack(models, threaded=True)
    lock, fleet_lock = threading.Lock(), threading.Lock()
    state = {"next": 0}
    lat = {t: [] for t in names}
    sheds, failed = {}, []
    c0, ev0 = compiles_of(), len(fleet.residency.events())

    def client() -> None:
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if i >= n:
                return
            name = names[int(owner[i])]
            t_req = time.perf_counter()
            rec = {"future": None, "shed": None}
            with fleet_lock:
                now = time.perf_counter() - t_start
                try:
                    fleet.submit(name, Xs[i:i + 1], now=now)
                except AdmissionShed as e:
                    rec["shed"] = e.reason
                else:
                    (rec,) = fleet.dispatch(now=now)
            if rec["future"] is None:
                with lock:
                    key = f"{name}:{rec['shed']}"
                    sheds[key] = sheds.get(key, 0) + 1
                continue
            try:
                rec["future"].result(120)
            except Exception as e:  # noqa: BLE001 - counted
                failed.append(repr(e))
                continue
            ms = (time.perf_counter() - t_req) * 1e3
            with lock:
                lat[name].append(ms)
            fleet.note_latency(name, ms, trace_id=rec.get("trace_id"))

    threads = [threading.Thread(target=client)
               for _ in range(TENANCY["clients"])]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t_start
    fleet.export_gauges()
    from spark_bagging_tpu_torch import telemetry

    events = fleet.residency.events()[ev0:]
    restored = sum(e.get("buckets", 0) for e in events
                   if e["kind"] == "restore")
    captures = compiles_of() - c0
    served = sum(len(v) for v in lat.values())
    per = {t: {"served": len(v),
               "p50_ms": percentile(sorted(v), 0.5) if v else None,
               "p99_ms": percentile(sorted(v), 0.99) if v else None}
           for t, v in lat.items()}
    out = dict(requests=n, clients=TENANCY["clients"], seconds=wall,
               served_rows=served, rows_per_s=served / wall,
               per_tenant=per,
               tail_p99_ms=telemetry.registry().gauge(
                   "sbt_tenancy_tail_p99_ms").value,
               sheds=dict(sorted(sheds.items())), failed=len(failed),
               errors=failed[:3],
               demotions=sum(1 for e in events if e["kind"] == "demote"),
               restores=sum(1 for e in events if e["kind"] == "restore"),
               captures=captures, restore_captures=restored,
               captures_on_requests=captures - restored,
               alive_threads=sum(t.is_alive() for t in threads))
    undo()
    return out


def phase_tenancy(X: np.ndarray, y: np.ndarray, tree):
    """The tenancy plane on the card (module docstring of
    ``spark_bagging_tpu_torch/tenancy``) under the JAX drill's default
    policy at full width: the stepped drive twice (its transcript
    byte-identical, every served output bitwise that of a solo
    registry, no capture on a request, captures after warm-up = the
    restored ladders, the ledger = the residents' graph_pool_bytes after
    every transition, a demotion and a restore, only t0 quota-shed), the
    budgeted refits under the stepped drive, and the threaded drive's
    numbers. Returns the models, the first run, the workload and the
    path's scaled-Gram launches."""
    t_phase = time.perf_counter()
    models, fit_launches, fit_s = tenant_fits(X, y, tree)
    workload = tenancy_workload()
    reqs, owner, payload = workload
    names = tenant_names()
    if len(reqs) < TENANCY["min_requests"]:
        fail("tenancy", f"{len(reqs)} requests, fewer than "
             f"{TENANCY['min_requests']}")
    memory = release_memory(models)
    runs = [stepped_drive(models, workload, len(reqs)) for _ in range(2)]
    first = runs[0]
    model_of = {(t, 1): m for t, m in zip(names, models)}
    t0 = time.perf_counter()
    solo = solo_outputs(model_of, first["comp"], payload)
    solo_s = time.perf_counter() - t0
    unequal = [unequal_outputs(r["outputs"], solo, r["outputs"])
               for r in runs]
    sheds = first["transcript"]["sheds"]
    # the budgeted refits under a stepped drive of the first requests
    shapes, undo_shapes = record_gram_shapes()
    n_refit = TENANCY["refit_requests"]
    at = len(plan_windows(reqs[:n_refit],
                          TENANCY["batcher"]["max_delay_ms"] / 1e3,
                          TENANCY["batcher"]["idle_flush_ms"] / 1e3)) // 3
    hook, rec = refit_hook(at)
    from spark_bagging_tpu_torch import telemetry

    def denied_counts() -> dict:
        return {t: telemetry.registry().counter(
            "sbt_tenancy_refit_denied_total", labels={"tenant": t}).value
            for t in ("t0", "t3")}

    denied0 = denied_counts()
    reset_launches()
    try:
        refit_run = stepped_drive(models, workload, n_refit, refit=hook)
    finally:
        undo_shapes()
    refit_launches = read_launches()["scaled_gram"]
    refits = sum(1 for t in rec["tenants"].values() for a in t["actions"])
    refit_solo = solo_outputs({**model_of, **rec["models"]},
                              refit_run["comp"], payload)
    refit_unequal = unequal_outputs(refit_run["outputs"], refit_solo,
                                    refit_run["outputs"])
    denied_counter = {t: v - denied0[t]
                      for t, v in denied_counts().items()}
    kernel_rows = gram_at_shapes(rec.get("window_rows", X[:1024]),
                                 sorted({r for r, _ in shapes}))
    threaded = threaded_drive(models)
    run_fields = [dict(
        requests=r["requests"], windows=r["windows"],
        drive_seconds=r["drive_seconds"], digest=r["digest"],
        served=len(r["outputs"]), failed=len(r["failed"]),
        demotions=r["demotions"], restores=r["restores"],
        post_warmup_captures=r["post_warmup_captures"],
        restore_captures=r["restore_captures"],
        restore_buckets=r["restore_buckets"],
        request_captures=r["request_captures"],
        post_warmup_by_tenant=r["post_warmup_by_tenant"],
        ledger_checks=r["ledger_checks"],
        ledger_unequal=r["ledger_unequal_count"],
        ledger_unequal_first=r["ledger_unequal"],
        outputs_unequal_to_solo=len(u), memory=r["memory"],
        restore_ms=r["restore_ms"],
        aot_root_written=r["aot_root_written"])
        for r, u in zip(runs, unequal)]
    fields = dict(
        tenants=names, replicas=N_REPLICAS, fit_seconds=fit_s,
        fit_gram_launches=fit_launches,
        graph_pool_bytes_at_warmup=first["pool_bytes"],
        reserved_around_a_release=memory,
        stepped=run_fields,
        transcripts_identical=runs[0]["digest"] == runs[1]["digest"],
        sheds=sheds, downstream_sheds=first["transcript"]["downstream_sheds"],
        admitted=first["transcript"]["admitted"],
        residency=first["transcript"]["residency_events"][:6],
        budget=first["transcript"]["budget_counts"],
        solo_seconds=solo_s,
        refit=dict(requests=refit_run["requests"], at_window=at,
                   tenants=rec["tenants"], refits=refits,
                   gram_launches=refit_launches,
                   gram_launch_shapes=sorted(set(shapes)),
                   gram_at_refit_shapes=kernel_rows,
                   refit_denied_counter=denied_counter,
                   failed=len(refit_run["failed"]),
                   outputs_unequal_to_solo=len(refit_unequal),
                   swap_captures=refit_run["swap_captures"],
                   restore_captures=refit_run["restore_captures"],
                   restore_buckets=refit_run["restore_buckets"],
                   request_captures=refit_run["request_captures"],
                   ledger_unequal=refit_run["ledger_unequal_count"]),
        threaded=threaded,
        phase_seconds=time.perf_counter() - t_phase, card=CARD)
    ok = (fields["transcripts_identical"]
          and all(not r["failed"] and r["request_captures"] == 0
                  and r["restore_captures"] == r["restore_buckets"]
                  == r["post_warmup_captures"]
                  and r["ledger_unequal_count"] == 0
                  and r["demotions"] >= 1 and r["restores"] >= 1
                  and not r["aot_root_written"] for r in runs)
          and not any(unequal)
          and set(sheds) == {"t0"} and set(sheds["t0"]) == {"quota"}
          and not first["transcript"]["downstream_sheds"]
          and refit_launches == 8 * refits > 0
          and all(t["budget_denied"] == 1 and t["actions"]
                  and set(t["actions"]) == {"published"}
                  and t["version"] == 1 + len(t["actions"])
                  for t in rec["tenants"].values())
          and all(v == 1.0 for v in denied_counter.values())
          and not refit_run["failed"] and not refit_unequal
          and refit_run["request_captures"] == 0
          and refit_run["ledger_unequal_count"] == 0
          and all(r["max_entry_err"] <= GRAM_TOL for r in kernel_rows)
          and threaded["failed"] == 0 and threaded["alive_threads"] == 0)
    emit("tenancy", ok=ok, **fields)
    if not ok:
        fail("tenancy", "checks failed (the line above)")
    return models, first, workload, fit_launches + refit_launches


def phase_tenant_chaos(models: list, first: dict, workload) -> None:
    """The builtin ``tenant-chaos`` plan armed after warm-up over the
    stepped drive's first TENANCY["chaos_requests"]: t1's dispatches 2-4
    fail, it trips into quarantine, is shed with ``TenantQuarantined``,
    probes and recovers inside the run; every other tenant's outputs are
    bitwise those of the run without the plan, none of them captures on
    a request, and ``/debug/tenancy`` over the exposition server returns
    the fleet's report with t1's quarantine state in it. The plan's
    ``aot.load`` spec never fires (no persisted executable cache)."""
    from spark_bagging_tpu_torch import faults, tenancy
    from spark_bagging_tpu_torch.telemetry import server

    t_phase = time.perf_counter()
    seen = {}

    def inspect(fleet) -> None:
        tenancy.install(fleet)
        port = server.start_server(0)
        try:
            code, body = http_get(port, "/debug/tenancy")
            seen["code"] = code
            seen["body"] = json.loads(body) if code == 200 else body
        finally:
            server.stop_server()
            tenancy.uninstall()

    plan = faults.builtin_plan("tenant-chaos", seed=TENANCY["seed"])
    run = stepped_drive(models, workload, TENANCY["chaos_requests"],
                        plan=plan, inspect=inspect)
    names = tenant_names()
    snap = plan.snapshot()
    by_tenant = {t: [i for w in run["comp"] for (u, _v, ids) in w
                     if u == t for i in ids] for t in names}
    bystanders = [t for t in names if t != "t1"]
    unequal = {t: len(unequal_outputs(run["outputs"], first["outputs"],
                                      by_tenant[t])) for t in bystanders}
    # the same requests without the plan: per-tenant served counts
    base = {t: sum(1 for w in first["comp"] for (u, _v, ids) in w
                   if u == t for i in ids
                   if i < run["requests"]) for t in names}
    body = seen.get("body") or {}
    q = body.get("quarantine", {}) if isinstance(body, dict) else {}
    counts = run["transcript"]["quarantine"]["counts"]
    quarantine_sheds = [s for s in run["shed_at_submit"]
                        if s[2] == "quarantine"]
    fields = dict(
        plan=plan.name, fired_total=snap["fired_total"],
        tenant_hits=snap.get("tenant_hits"),
        quarantine=counts,
        quarantine_events=run["transcript"]["quarantine"]["events"],
        quarantine_sheds=len(quarantine_sheds),
        downstream_sheds=run["transcript"]["downstream_sheds"],
        served_by_tenant={t: len(v) for t, v in by_tenant.items()},
        served_by_tenant_without_plan=base,
        bystander_outputs_unequal=unequal,
        post_warmup_by_tenant=run["post_warmup_by_tenant"],
        # the run without the plan over the same windows (the chaos
        # drive's last window may be a cut one)
        post_warmup_by_tenant_without_plan=first["caps_by_window"][
            run["windows"] - 1],
        request_captures=run["request_captures"],
        restore_captures=run["restore_captures"],
        restore_buckets=run["restore_buckets"],
        ledger_unequal=run["ledger_unequal_count"],
        failed=len(run["failed"]), debug_tenancy_code=seen.get("code"),
        debug_tenancy_t1=q.get("tenants", {}).get("t1"),
        phase_seconds=time.perf_counter() - t_phase, card=CARD)
    ok = (counts["trips"] == {"t1": 1} and counts["recoveries"] == {"t1": 1}
          and len(quarantine_sheds) >= 1
          and all(s[1] == "t1" for s in quarantine_sheds)
          and set(run["transcript"]["downstream_sheds"]) == {"t1"}
          and not any(unequal.values())
          and all(fields["served_by_tenant"][t] == base[t]
                  for t in bystanders)
          and run["request_captures"] == 0
          and run["restore_captures"] == run["restore_buckets"]
          and run["ledger_unequal_count"] == 0 and not run["failed"]
          and seen.get("code") == 200 and body.get("enabled") is True
          and q.get("tenants", {}).get("t1", {}).get("trips") == 1)
    emit("tenant_chaos", ok=ok, **fields)
    if not ok:
        fail("tenant_chaos", "checks failed (the line above)")



# -- the data plane: file readers and config 8 -------------------------

def write_reader_files(d: str, X: np.ndarray, y: np.ndarray,
                       cats: np.ndarray) -> dict:
    """The rows as libsvm, as CSV (label last) and as a hashed CSV (label
    first, the numeric columns, then the categorical ones), floats with
    %.9g so float32 round-trips exactly."""
    yX = np.c_[y.astype(np.float32), X]
    paths = {"libsvm": os.path.join(d, "higgs.svm"),
             "csv": os.path.join(d, "higgs.csv"),
             "hashed_csv": os.path.join(d, "higgs_hashed.csv")}
    np.savetxt(paths["libsvm"], yX, fmt="%.9g " + " ".join(
        f"{j + 1}:%.9g" for j in range(X.shape[1])))
    np.savetxt(paths["csv"], np.c_[X, y.astype(np.float32)], fmt="%.9g",
               delimiter=",")
    fmt = ",".join(["%.9g"] * (X.shape[1] + 1) + ["%s"] * cats.shape[1])
    with open(paths["hashed_csv"], "w") as f:
        for row, c in zip(yX.tolist(), cats.tolist()):
            f.write(fmt % (*row, *c) + "\n")
    return paths


def stream_all(src) -> tuple[list, float]:
    t0 = time.perf_counter()
    chunks = [(Xc.copy(), yc.copy(), n) for Xc, yc, n in src.chunks()]
    return chunks, time.perf_counter() - t0


def chunks_unequal(a: list, b: list) -> int:
    """Chunks that differ in X, y (values and dtype) or valid rows."""
    if len(a) != len(b):
        return max(len(a), len(b))
    return sum(int(not (np.array_equal(p[0], q[0]) and p[0].dtype == q[0].dtype
                        and np.array_equal(p[1], q[1])
                        and p[1].dtype == q[1].dtype and p[2] == q[2]))
               for p, q in zip(a, b))


def python_path():
    """Force the readers' pure-Python parsers (the host loader's
    ``get_lib`` answers None) until the returned undo is called."""
    from spark_bagging_tpu_torch.utils import host_native

    real = host_native.get_lib
    host_native.get_lib = lambda: None
    return lambda: setattr(host_native, "get_lib", real)


def phase_readers() -> None:
    """READERS["n_rows"] synthetic HIGGS rows written as libsvm, CSV and
    hashed CSV, each streamed through its reader on the host loader's
    native path: every chunk bitwise the ``ArrayChunks`` chunk of the
    same rows (the hashed one: bitwise the pure-Python hasher's, its
    numeric columns the rows'); a 64-replica logistic ``fit_stream``
    over the CSV bitwise the same stream over ``ArrayChunks``; each
    reader's host MB/s."""
    import shutil

    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.utils import host_native
    from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs
    from spark_bagging_tpu_torch.utils.hashing import HashedCSVChunks
    from spark_bagging_tpu_torch.utils.io import (
        ArrayChunks,
        CSVChunks,
        LibsvmChunks,
    )

    cfg = READERS
    n, ch, F = cfg["n_rows"], cfg["chunk_rows"], 28
    X, y = synthetic_higgs(n, seed=999_006, structure_seed=11)
    yf = y.astype(np.float32)
    rng = np.random.default_rng(3)
    cats = np.char.add("c", rng.zipf(1.5, (n, cfg["n_categorical"]))
                       .astype(str))
    d = tempfile.mkdtemp(prefix="readers_")
    try:
        t0 = time.perf_counter()
        paths = write_reader_files(d, X, y, cats)
        write_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        lib = host_native.get_lib()
        build_seconds = time.perf_counter() - t0
        if lib is None:
            fail("readers", "the host loader did not build (g++)")
        ref, _ = stream_all(ArrayChunks(X, yf, ch))
        hashed_kw = dict(chunk_rows=ch, label_col=0,
                         numeric_cols=list(range(1, F + 1)),
                         categorical_cols=list(range(F + 1, F + 1 + cats.shape[1])),
                         n_hash=cfg["n_hash"])
        readers = {
            "libsvm": lambda: LibsvmChunks(paths["libsvm"], F, ch),
            "csv": lambda: CSVChunks(paths["csv"], ch),
            "hashed_csv": lambda: HashedCSVChunks(paths["hashed_csv"],
                                                  **hashed_kw),
        }
        rows, got = {}, {}
        for name, make in readers.items():
            before = dict(host_native.served)
            got[name], secs = stream_all(make())
            native = host_native.served["native"] - before["native"]
            python = host_native.served["python"] - before["python"]
            mb = os.path.getsize(paths[name]) / 1e6
            rows[name] = dict(seconds=secs, file_mb=mb, mb_per_sec=mb / secs,
                              chunks=len(got[name]), native_reads=native,
                              python_reads=python)
        for name in ("libsvm", "csv"):
            rows[name]["chunks_unequal_to_arrays"] = chunks_unequal(
                got[name], ref)
        undo = python_path()
        try:
            py_hashed, py_secs = stream_all(readers["hashed_csv"]())
        finally:
            undo()
        rows["hashed_csv"].update(
            chunks_unequal_to_python=chunks_unequal(got["hashed_csv"],
                                                    py_hashed),
            python_seconds=py_secs,
            numeric_unequal_to_arrays=sum(
                int(not (np.array_equal(h[0][:, :F], r[0])
                         and np.array_equal(h[1], r[1])))
                for h, r in zip(got["hashed_csv"], ref)))
        # the stream over the CSV against the same stream over the arrays
        fits = {}
        reset_launches()
        for name, src in (("csv", CSVChunks(paths["csv"], ch)),
                          ("arrays", ArrayChunks(X, yf, ch))):
            est = BaggingClassifier(LogisticRegression(l2=1e-4),
                                    n_estimators=cfg["n_estimators"], seed=0)
            t0 = time.perf_counter()
            est.fit_stream(src, classes=[0, 1])
            fits[name] = (est.ensemble_, time.perf_counter() - t0)
        counts = read_launches()
        fit_unequal = [k for k in fits["csv"][0]
                       if not torch.equal(fits["csv"][0][k],
                                          fits["arrays"][0][k])]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok = (all(r["native_reads"] >= 1 and r["python_reads"] == 0
              for r in rows.values())
          and rows["libsvm"]["chunks_unequal_to_arrays"] == 0
          and rows["csv"]["chunks_unequal_to_arrays"] == 0
          and rows["hashed_csv"]["chunks_unequal_to_python"] == 0
          and rows["hashed_csv"]["numeric_unequal_to_arrays"] == 0
          and not fit_unequal and not any(counts.values()))
    emit("readers", ok=ok, n_rows=n, chunk_rows=ch, n_features=F,
         categorical=cats.shape[1], n_hash=cfg["n_hash"],
         write_seconds=write_seconds, loader_build_seconds=build_seconds,
         readers=rows, stream_fit_replicas=cfg["n_estimators"],
         stream_fit_seconds={k: v[1] for k, v in fits.items()},
         stream_fit_params_unequal=fit_unequal, launches=counts, card=CARD)
    if not ok:
        fail("readers", f"checks failed: {rows}, fit params unequal "
             f"{fit_unequal}, launches {counts}")


def criteo_make(n: int, seed: int = 13, structure_seed: int | None = None):
    """Config 8's rows: the Criteo-shaped synthetic at its width."""
    from spark_bagging_tpu_torch.utils.datasets import synthetic_criteo

    return synthetic_criteo(n, CRITEO["n_features"], seed=seed,
                            structure_seed=structure_seed)


def criteo_source(n_rows: int):
    from spark_bagging_tpu_torch.utils.io import SyntheticChunks

    return SyntheticChunks(criteo_make, n_rows, CRITEO["chunk_rows"],
                           seed=13)


def criteo_bagger(n_estimators: int = CRITEO["n_estimators"]):
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression

    return BaggingClassifier(LogisticRegression(l2=CRITEO["l2"]),
                             n_estimators=n_estimators, seed=0)


def phase_criteo_stream() -> None:
    """BASELINE config 8 at full width, its rows cut to CRITEO["n_rows"]
    (half run_configs.py's own pre-flight floor): 128 bagged logistic
    regressions streamed by Adam over Criteo-shaped synthetic chunks of
    200,000 x 1024; test AUC on 100,000 fresh rows against sklearn's
    proxy minus 0.02; the stream's seconds, row-replicas/s, peak memory
    and the host's chunk making against the device's chunk visits."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    cfg = CRITEO
    fit_kw = dict(classes=[0, 1], n_epochs=cfg["n_epochs"],
                  steps_per_chunk=cfg["steps_per_chunk"], lr=cfg["lr"])
    Xte, yte = criteo_make(cfg["n_test"], seed=999_003, structure_seed=13)
    t0 = time.perf_counter()
    criteo_bagger(16).fit_stream(criteo_source(cfg["chunk_rows"] // 10),
                                 **fit_kw)
    warmup_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    est = criteo_bagger()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    est.fit_stream(criteo_source(cfg["n_rows"]), **fit_kw)
    stream_seconds = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = est.fit_report_
    proba = est.predict_proba(Xte)
    auc = roc_auc(yte, proba[:, 1])
    bar = CRITEO_PROXY_AUC - PARITY_TOL
    pace = stream_pace(
        lambda k: criteo_source(k * cfg["chunk_rows"]), criteo_bagger,
        fit_kw, n_chunks=CRITEO_PACE_CHUNKS)
    n_chunks = -(-cfg["n_rows"] // cfg["chunk_rows"])
    device_ms = pace["bootstrap_ms"] + pace["other_device_ms"]
    data_gib = cfg["n_rows"] * cfg["n_features"] * 4 / 2**30
    emit("criteo_stream", ok=True, **cfg, rows_cut_from=40_000_000,
         data_gib=data_gib,
         exceeds="nothing: 1,000,000 x 1024 float32 would fit the 80 GB card"
                 "; streamed chunk by chunk all the same",
         warmup_fit_seconds=warmup_seconds, stream_seconds=stream_seconds,
         first_step_seconds=rep["compile_seconds"],
         row_replica_per_sec=cfg["n_rows"] * cfg["n_epochs"]
         * cfg["n_estimators"] / stream_seconds,
         n_chunks=rep["n_chunks"], opt_steps=rep["opt_steps"],
         achieved_tflops=rep["achieved_tflops"], mfu=rep["mfu"],
         peak_mem_gb=peak, launches=counts, test_auc=auc,
         proxy_auc=CRITEO_PROXY_AUC, auc_bar=bar, **pace,
         host_seconds_per_stream=pace["host_chunk_ms"] * n_chunks / 1e3,
         device_seconds_per_stream=device_ms * n_chunks / 1e3,
         pace_set_by="host" if pace["host_chunk_ms"] > device_ms else "device",
         card=CARD)
    if rep["n_chunks"] != n_chunks or rep["opt_steps"] != n_chunks * cfg[
            "n_epochs"] * cfg["steps_per_chunk"]:
        fail("criteo_stream", f"{rep['n_chunks']} chunks, {rep['opt_steps']} "
             "optimizer steps")
    if any(counts.values()):
        fail("criteo_stream", f"launches {counts}: the logistic stream (Adam) "
             "runs no kernel of the repo")
    if not (np.isfinite(proba).all() and proba.shape == (len(yte), 2)):
        fail("criteo_stream", f"bad probabilities, shape {proba.shape}")
    if not auc >= bar:
        fail("criteo_stream", f"test AUC {auc:.5f} below the bar {bar:.5f}")


def mesh_of(data: int, replica: int, device: str = "cuda"):
    """A (data, replica) mesh over repeated cuda:0 entries (or the CPU's):
    each shard a thread of its own on the one card."""
    from spark_bagging_tpu_torch import make_mesh

    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", 0)
    return make_mesh(data, replica, devices=[dev] * (data * replica))


def mesh_logistic_fit(phase: str, X, y, shape, single, **kw):
    """The headline on a mesh: fit, per-shard launches against the
    expected, accuracy and the probabilities against ``single``'s."""
    from spark_bagging_tpu_torch import BaggingClassifier

    learner = headline_learner()
    clf = BaggingClassifier(learner, n_estimators=N_REPLICAS, seed=0,
                            mesh=mesh_of(*shape), **kw)
    reset_launches()
    t0 = time.perf_counter()
    clf.fit(X, y)
    fit_seconds = time.perf_counter() - t0
    counts, per_shard = read_launches(), shard_launches()
    rep = clf.fit_report_
    data, replica = shape
    r_shard = N_REPLICAS // replica
    chunk = rep["chunk_size_resolved"] or r_shard
    n_chunks = -(-r_shard // chunk)
    expected = learner.max_iter * n_chunks + (
        learner.pooled_iter if learner.uses_pooled_init
        and learner.pooled_amortizes(N_REPLICAS) else 0)
    Xs = X[:N_SERVE_ROWS]
    proba = clf.predict_proba(Xs)
    acc = float((clf.classes_[proba.argmax(1)] == y[:N_SERVE_ROWS]).mean())
    diff = float(np.abs(proba - single.predict_proba(Xs)).max())
    shards = per_shard["scaled_gram"]
    fields = dict(mesh=list(shape), rows_a_shard=N_ROWS // data,
                  replicas_a_shard=r_shard, chunk_size=chunk,
                  fit_seconds=fit_seconds, launches=counts,
                  launches_by_shard=per_shard,
                  expected_scaled_gram_launches_a_shard=expected,
                  accuracy_100k=acc, acc_bar=ACC_BAR,
                  max_abs_diff_vs_single=diff, card=CARD)
    return clf, counts["scaled_gram"], fields, (
        len(shards) == data * replica
        and all(v == expected for v in shards.values())
        and counts["scaled_gram"] == expected * data * replica
        and acc >= ACC_BAR and np.isfinite(proba).all()), diff


def record_shard_levels(n_nodes: int, shards=None):
    """Wrap the tree module's histogram calls to keep each mesh shard's
    first call at ``n_nodes`` nodes (its deepest level of the first
    chunk, or of the first round): the inputs and the table the fit got
    from them. ``shards``: the shards to keep (None: every one). The
    kernel wrappers and their counts are left alone. Returns (records by
    shard, restore)."""
    import types

    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops
    from spark_bagging_tpu_torch.parallel import compat

    recs = {}

    def lvl(codes, edges, node, S, *, n_nodes, hist_dtype, cols, integral):
        out = hist_ops.coded_left_stats(codes, edges, node, S,
                                        n_nodes=n_nodes,
                                        hist_dtype=hist_dtype, cols=cols,
                                        integral=integral)
        shard = compat.current_shard()
        if (n_nodes == want and shard not in recs
                and (shards is None or shard in shards)):
            recs[shard] = dict(codes=codes, edges=edges, node=node.clone(),
                               S=S, N=n_nodes, hist_dtype=hist_dtype,
                               cols=cols, integral=integral, out=out.clone())
        return out

    want = n_nodes
    tree_mod.hist_ops = types.SimpleNamespace(
        **{**vars(hist_ops), "coded_left_stats": lvl})
    return recs, lambda: setattr(tree_mod, "hist_ops", hist_ops)


def mesh_hist_check(c: dict) -> dict:
    """The histogram kernel on a mesh shard's own level inputs: every
    replica bit for bit against its plain version (integral statistics),
    with times, bound and the library yardstick at the shard's shape."""
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_plain,
    )

    codes, cols, E, node, S, N, mode = (c[k] for k in (
        "codes", "cols", "edges", "node", "S", "N", "hist_dtype"))
    R, n, K = S.shape
    F_all, (F, B) = codes.shape[1], E.shape[1:]

    def run():
        return coded_left_stats(codes, E, node, S, n_nodes=N,
                                hist_dtype=mode, cols=cols, integral=True)

    out = run()
    unequal, max_abs, spans = 0, 0.0, []
    for r in range(R):
        box = []
        spans.append(span(lambda: box.append(coded_left_stats_plain(
            codes, E[r:r + 1], node[r:r + 1], S[r:r + 1], n_nodes=N,
            hist_dtype=mode, cols=cols[r:r + 1]))))
        unequal += not torch.equal(out[r], box[0][0])
        max_abs = max(max_abs, float((out[r] - box[0][0]).abs().max()))
    plain_ms = timed_spans(spans)
    kernel_ms = cuda_ms(run, 3)
    lib = hist_library_ms(codes, cols, E, node, S, N, mode)
    out_bytes = 4.0 * R * F * B * N * K
    shared_bytes = (4.0 * (node.numel() + S.numel() + R * F * B) + out_bytes
                    + 4.0 * (n * F_all + R * F))
    t_ops = 1e3 * float(R) * n * F * K / PEAK_FP32
    t_bytes = 1e3 * shared_bytes / PEAK_BYTES
    del out
    torch.cuda.empty_cache()
    return dict(shape=dict(R=R, n=n, F=F, F_all=F_all, B=B, N=N, K=K),
                hist_dtype=mode, replicas_unequal=unequal,
                max_abs_err=max_abs, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=lib["index_add"], library_matmul_ms=lib["matmul"],
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def mesh_trees(X, y, tree_acc: float) -> tuple[dict, dict, dict]:
    """Config 3's trees on a 2 x 2 mesh. With ``bootstrap=False`` the
    mesh's edges are the shards' quantiles averaged in shard order, and
    its trees equal, bit for bit, the single-device trees grown under
    those edges (every level's integer table and the leaf counts sum
    exactly over the shards). With the bootstrap, the accuracy is within
    MESH_TREE_ACC_TOL of the single-device fit's. Returns the
    bootstrap fit's launches, the histogram row, and its state, launches
    by shard and seconds (the multiprocess phase's reference)."""
    from spark_bagging_tpu_torch.ensemble import fit_ensemble
    from spark_bagging_tpu_torch.ops import prng

    shape = MESH["trees"]
    edges = {}
    exact = tree_bagger(N_REPLICAS, split_impl="fused")
    exact.set_params(bootstrap=False, max_samples=1.0, mesh=mesh_of(*shape))
    learner = exact._learner()
    orig = type(learner).prepare

    def record(self, Xs, *, row_mask=None, axis_name=None):
        out = orig(self, Xs, row_mask=row_mask, axis_name=axis_name)
        edges["E"] = out["edges"]
        return out

    type(learner).prepare = record
    try:
        exact.fit(X, y)
    finally:
        type(learner).prepare = orig
    dev = torch.device("cuda")
    grow = exact._fitted_learner
    grow.prepare = lambda Xs, *, row_mask=None: grow._binned(Xs, edges["E"])
    try:
        params, _, _ = fit_ensemble(
            grow, torch.as_tensor(X, device=dev),
            torch.as_tensor(y.astype(np.int64), device=dev), prng.key(0, dev),
            torch.arange(N_REPLICAS, device=dev), N_CLASSES,
            bootstrap=False, n_subspace=exact.subspaces_.shape[1],
            chunk_size=exact._chunk_resolved)
    finally:
        del grow.prepare
    unequal = [k for k in ("feature", "threshold", "gain", "leaf_logp")
               if not torch.equal(exact.ensemble_[k], params[k])]
    del params, exact
    torch.cuda.empty_cache()
    boot = tree_bagger(N_REPLICAS, split_impl="fused")
    boot.set_params(mesh=mesh_of(*shape))
    reset_launches()
    recs, restore = record_shard_levels(2 ** (TREE["max_depth"] - 1),
                                        shards={(0, 0)})
    t0 = time.perf_counter()
    try:
        boot.fit(X, y)
    finally:
        restore()
    rec = recs[(0, 0)]
    fit_seconds = time.perf_counter() - t0
    counts, per_shard = read_launches(), shard_launches()
    rep = boot.fit_report_
    ref = dict(state={k: v.cpu().numpy() for k, v in boot.ensemble_.items()},
               launches_by_shard=per_shard, fit_seconds=fit_seconds,
               chunk_size=rep["chunk_size_resolved"]
               or N_REPLICAS // shape[1])
    r_shard = N_REPLICAS // shape[1]
    chunk = rep["chunk_size_resolved"] or r_shard
    expected = TREE["max_depth"] * -(-r_shard // chunk)
    acc = boot.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    hist = mesh_hist_check(rec)
    del rec, recs
    fields = dict(mesh=list(shape), rows_a_shard=N_ROWS // shape[0],
                  replicas_a_shard=r_shard, chunk_size=chunk,
                  fit_seconds=fit_seconds, launches=counts,
                  launches_by_shard=per_shard,
                  expected_hist_launches_a_shard=expected,
                  bootstrap_false_unequal_leaves=unequal,
                  accuracy_100k=acc, single_device_accuracy_100k=tree_acc,
                  acc_tol=MESH_TREE_ACC_TOL, hist_shard_0_0=hist, card=CARD)
    hs, cs = per_shard["binned_left_stats"], per_shard["bin_codes"]
    ok = (not unequal and not hist["replicas_unequal"]
          and abs(acc - tree_acc) <= MESH_TREE_ACC_TOL
          and len(hs) == 4 and all(v == expected for v in hs.values())
          and len(cs) == 4 and all(v == 1 for v in cs.values()))
    emit("mesh_trees", ok=ok, **fields)
    if not ok:
        fail("mesh_trees", f"checks failed: {fields}")
    return counts, hist, ref


def mesh_serving(single, X: np.ndarray) -> None:
    """``EnsembleExecutor(mesh=(1, 4))`` on the 1..256 ladder: one graph a
    (bucket, shard) captured at warm-up only, every bucket bitwise the
    single-device executor's, requests of 1-300 rows bitwise, rows/s at
    concurrency 4 beside the single-device executor's, then the
    ``shard-loss`` plan: shard 1 lost mid-traffic, every later output
    bitwise the surviving subset's aggregate recomputed at its bucket,
    and no request failing."""
    import warnings

    from spark_bagging_tpu_torch import faults, telemetry
    from spark_bagging_tpu_torch.parallel.sharded import (
        replica_subset_serving,
    )
    from spark_bagging_tpu_torch.serving import (
        EnsembleExecutor,
        program_cache,
    )

    opts = SERVE_LADDERS["bench"]
    program_cache.clear()
    ex1 = EnsembleExecutor(single, **opts)
    ex1.warmup()
    c0 = serving_compiles()
    t0 = time.perf_counter()
    exm = EnsembleExecutor(single, mesh=mesh_of(*MESH["replica"]), **opts)
    exm.warmup()
    warm_s = time.perf_counter() - t0
    captures = serving_compiles() - c0
    buckets, pool_bytes = list(exm.compiled_buckets), exm.graph_pool_bytes
    rng = np.random.default_rng(5)
    bucket_unequal = []
    for b in buckets:
        Xb = X[rng.integers(0, len(X), b)]
        if not np.array_equal(exm.forward(Xb), ex1.forward(Xb)):
            bucket_unequal.append(b)
    req_unequal = 0
    for n in [1, 2, 3, 7, 31, 100, 255, 257, 300,
              *rng.integers(1, 301, 16).tolist()]:
        i = int(rng.integers(0, len(X) - n))
        req_unequal += not np.array_equal(exm.forward(X[i:i + n]),
                                          ex1.forward(X[i:i + n]))
    rates = {}
    for name, ex in (("single", ex1), ("mesh", exm)):
        lat, rps = run_clients(X, MESH["clients"], MESH["requests"],
                               ex.forward)
        lat.sort()
        rates[name] = dict(rows_per_sec=rps, p50_ms=percentile(lat, 0.5) * 1e3,
                           p99_ms=percentile(lat, 0.99) * 1e3)
    post = serving_compiles() - c0 - captures
    # the shard-loss drill: single-row requests, one slab each; the plan
    # fires on the 4th mesh slab
    fn, _rf, p, s = replica_subset_serving(
        single, [i for i in range(N_REPLICAS)
                 if i // (N_REPLICAS // MESH["replica"][1]) != 1])
    outs, failed, first_error = [], 0, None
    plan = faults.arm(faults.builtin_plan("shard-loss"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for k in range(MESH["loss_requests"]):
                try:
                    outs.append(exm.forward(X[k:k + 1]))
                except Exception as e:  # noqa: BLE001 - counted, gated below
                    failed += 1
                    first_error = first_error or repr(e)
                    outs.append(None)
    finally:
        faults.disarm()
    degraded_unequal = 0
    for k in range(3, MESH["loss_requests"]):
        want = fn(p, s, torch.as_tensor(X[k:k + 1], device="cuda"))
        degraded_unequal += (outs[k] is None or not np.array_equal(
            outs[k], want.cpu().numpy()))
    reg = telemetry.registry()
    fields = dict(mesh=list(MESH["replica"]), buckets=buckets,
                  captures_at_warmup=captures,
                  graphs_at_warmup=captures * MESH["replica"][1],
                  warmup_seconds=warm_s, graph_pool_bytes=pool_bytes,
                  buckets_unequal_to_single=bucket_unequal,
                  requests_unequal_to_single=req_unequal,
                  captures_on_requests=post, concurrency=MESH["clients"],
                  requests=MESH["requests"], **{
                      f"{k}_{m}": v for k, r in rates.items()
                      for m, v in r.items()},
                  shard_loss_fired=plan.snapshot()["fired_total"],
                  failed_shards=list(exm.failed_shards),
                  surviving_replicas=exm.surviving_replicas,
                  degraded_outputs_unequal=degraded_unequal,
                  failed_requests=failed, first_error=first_error,
                  degraded_compiles=reg.counter(
                      "sbt_serving_degraded_compiles_total").value,
                  card=CARD)
    ok = (captures == len(buckets) and pool_bytes > 0 and not bucket_unequal
          and not req_unequal and post == 0 and failed == 0
          and not degraded_unequal and exm.failed_shards == (1,)
          and fields["shard_loss_fired"] == 1)
    emit("mesh_serving", ok=ok, **fields)
    if not ok:
        fail("mesh_serving", f"checks failed: {fields}")


def phase_mesh(X: np.ndarray, y: np.ndarray, tree_acc: float) -> dict:
    """The in-process mesh (parallel/) on the one card, every shard a
    thread over cuda:0: the headline on a replica mesh and on a data
    mesh (accuracy, launches per shard, bootstrap=False exactness, the
    Gram at the data shard's shapes), config 3's trees on a 2 x 2 mesh,
    and replica-sharded serving with a shard loss. Returns each kernel's
    launches in the mesh fits and the kernel rows."""
    from spark_bagging_tpu_torch import BaggingClassifier
    from spark_bagging_tpu_torch.ops.bootstrap import fit_key

    t_phase = time.perf_counter()
    reset_launches()
    single = BaggingClassifier(headline_learner(), n_estimators=N_REPLICAS,
                               seed=0).fit(X, y)
    single_launches = read_launches()["scaled_gram"]
    rep_clf, rep_launches, fields, ok, _ = mesh_logistic_fit(
        "mesh_replica", X, y, MESH["replica"], single)
    fields.update(single_device_scaled_gram_launches=single_launches,
                  single_device_fit_seconds=single.fit_report_[
                      "fit_seconds"])
    ids = torch.arange(N_REPLICAS, device="cuda")
    fields["subspaces_bitwise"] = bool(torch.equal(rep_clf.subspaces_,
                                                   single.subspaces_))
    fields["weights_bitwise"] = all(
        np.array_equal(rep_clf.replica_weights(i), single.replica_weights(i))
        for i in (0, 63, 64, 255))
    fields["keys_bitwise"] = bool(torch.equal(
        fit_key(rep_clf._fit_key, ids), fit_key(single._fit_key, ids)))
    ok = (ok and fields["max_abs_diff_vs_single"] <= MESH_PROBA_TOL
          and fields["subspaces_bitwise"] and fields["weights_bitwise"]
          and fields["keys_bitwise"])
    emit("mesh_replica", ok=ok, proba_tol=MESH_PROBA_TOL, **fields)
    if not ok:
        fail("mesh_replica", f"checks failed: {fields}")
    del rep_clf
    data_clf, data_launches, fields, ok, _ = mesh_logistic_fit(
        "mesh_data", X, y, MESH["data"], single)
    data_chunk = fields["chunk_size"]
    del data_clf
    exact_kw = dict(bootstrap=False, max_samples=1.0)
    ex_single = BaggingClassifier(headline_learner(), n_estimators=N_REPLICAS,
                                  seed=0, **exact_kw).fit(X, y)
    ex_clf, ex_launches, _f, _ok, exact_diff = mesh_logistic_fit(
        "mesh_data", X, y, MESH["data"], ex_single, **exact_kw)
    del ex_clf, ex_single
    torch.cuda.empty_cache()
    fields.update(bootstrap_false_max_abs_diff=exact_diff,
                  exact_tol=MESH_EXACT_TOL)
    ok = ok and exact_diff <= MESH_EXACT_TOL
    emit("mesh_data", ok=ok, **fields)
    if not ok:
        fail("mesh_data", f"checks failed: {fields}")
    n_shard = N_ROWS // MESH["data"][0]
    gram_rows = phase_kernels(X[:n_shard], [data_chunk], modes=("float32",),
                              phase="mesh_kernels")
    torch.cuda.empty_cache()
    tree_counts, hist_row, tree_ref = mesh_trees(X, y, tree_acc)
    mesh_serving(single, X)
    del single
    torch.cuda.empty_cache()
    emit("mesh", ok=True, phase_seconds=time.perf_counter() - t_phase,
         card=CARD)
    return dict(scaled_gram=(single_launches + rep_launches + data_launches
                             + ex_launches),
                binned_left_stats=tree_counts["binned_left_stats"],
                bin_codes=tree_counts["bin_codes"],
                gram_row=gram_rows[data_chunk]["float32"], hist_row=hist_row,
                tree_ref=tree_ref)


def mesh_exact_pair(make_est, X, y, shape, fit_kw=None,
                    device: str = "cuda"):
    """``bootstrap=False`` fits of ``make_est()`` on a mesh and on one
    device, ``(mesh fit, single-device fit)``. A learner that bins its
    rows (trees, GBTs, isotonic) bins them on the mesh with the shards'
    quantiles averaged, as the JAX package does: its single-device fit
    is made under the mesh's prepared state (shard (0, 0)'s, which every
    shard shares)."""
    from spark_bagging_tpu_torch.models.base import BaseLearner
    from spark_bagging_tpu_torch.parallel import compat

    fit_kw = fit_kw or {}
    exact = dict(bootstrap=False, max_samples=1.0, device=device)
    on_mesh, single = make_est(), make_est()
    on_mesh.set_params(mesh=mesh_of(*shape, device=device), **exact)
    single.set_params(**exact)
    cls = type(on_mesh._learner())
    own, orig, seen = "prepare" in cls.__dict__, cls.prepare, {}

    def restore():
        if own:
            cls.prepare = orig
        else:
            del cls.prepare

    def record(self, Xs, **kw):
        out = orig(self, Xs, **kw)
        if compat.current_shard() == (0, 0):
            seen.setdefault("prepared", out)
        return out

    cls.prepare = record
    try:
        on_mesh.fit(X, y, **fit_kw)
    finally:
        restore()
    if orig is not BaseLearner.prepare:
        prep = seen["prepared"]
        cls.prepare = ((lambda self, Xs, **kw: self._binned(
            Xs, prep["edges"])) if hasattr(cls, "_binned")
            else (lambda self, Xs, **kw: prep))
    try:
        single.fit(X, y, **fit_kw)
    finally:
        if orig is not BaseLearner.prepare:
            restore()
    return on_mesh, single


def split_feature_shares(a, b, per_round: int) -> tuple[float, float]:
    """(round 0's, every round's) share of equal split features of two
    fitted GBT bags; ``per_round`` nodes a round (classes x nodes)."""
    fa, fb = a.ensemble_["feature"], b.ensemble_["feature"]
    return (float((fa[:, :per_round] == fb[:, :per_round]).float().mean()),
            float((fa == fb).float().mean()))


def gbt_first_divergence(a, b, per_round: int) -> dict:
    """Where two fitted GBT bags (``a`` on a mesh, ``b`` on one device
    under its edges) first choose different splits, replica by replica,
    in growth order (round, then node within the round): the gains
    there and their gap over the replica's largest gain ``max(|b's
    gains|, 1)``; ``all_ties`` when every such gap is within
    GBT_TIE_TOL, a tie as tests/test_torch_gbt.py's ``_untied`` reads
    one: the float psum of the shards' tables met two splits of equal
    gain, and the trees below and after it follow their own choice. Also
    the largest gap of the gains at the equal splits before them, and
    where: a gain is a difference of impurities ``sum h z^2 - (sum h
    z)^2 / sum h``, so its float32 rounding scales with the node's
    ``sum h z^2``, not with the gain (PERF.md, PR 17)."""
    ea = {k: a.ensemble_[k].cpu().numpy() for k in ("feature", "threshold",
                                                    "gain")}
    eb = {k: b.ensemble_[k].cpu().numpy() for k in ("feature", "threshold",
                                                    "gain")}
    scale = np.maximum(np.abs(eb["gain"]).max(axis=1), 1.0)
    differ = ((ea["feature"] != eb["feature"])
              | (ea["threshold"] != eb["threshold"]))
    gap = (np.where(ea["gain"] == eb["gain"], 0.0,
                    np.abs(ea["gain"].astype(np.float64) - eb["gain"]))
           / scale[:, None])
    firsts, before, at = [], None, 0.0
    for r in range(differ.shape[0]):
        idx = np.flatnonzero(differ[r])
        first = int(idx[0]) if idx.size else differ.shape[1]
        if first:
            i = int(gap[r, :first].argmax())
            if before is None or gap[r, i] > before["rel_gap"]:
                before = dict(replica=r, round=i // per_round,
                              node=i % per_round,
                              gain=[float(ea["gain"][r, i]),
                                    float(eb["gain"][r, i])],
                              rel_gap=float(gap[r, i]))
        if idx.size:
            at = max(at, float(gap[r, first]))
            firsts.append(dict(replica=r, round=first // per_round,
                               node=first % per_round,
                               feature=[int(ea["feature"][r, first]),
                                        int(eb["feature"][r, first])],
                               gain=[float(ea["gain"][r, first]),
                                     float(eb["gain"][r, first])],
                               rel_gap=float(gap[r, first])))
    return dict(replicas_diverged=len(firsts),
                earliest_round=min((f["round"] for f in firsts),
                                   default=None),
                max_rel_gap_at_first=at, tie_tol=GBT_TIE_TOL,
                all_ties=at <= GBT_TIE_TOL,
                first=sorted(firsts, key=lambda f: (f["round"],
                                                    f["node"]))[:4],
                largest_gap_before=before)


def mesh_fit_launches(counts: dict, per_shard: dict, n_shards: int,
                      hist: int, codes: int, float_stats: bool) -> bool:
    """Every shard launched ``hist`` histograms and ``codes`` bin codes
    (all float or all int32), nothing else, and the totals add up."""
    hs, cs = per_shard["binned_left_stats"], per_shard["bin_codes"]
    return (len(hs) == n_shards and all(v == hist for v in hs.values())
            and len(cs) == n_shards and all(v == codes for v in cs.values())
            and counts["binned_left_stats"] == hist * n_shards
            and counts["bin_codes"] == codes * n_shards
            and counts["binned_left_stats_float"]
            == (counts["binned_left_stats"] if float_stats else 0)
            and counts["scaled_gram"] == 0)


def fixed_shard_check(c: dict) -> dict:
    """A float-statistics level of one shard: the kernel's table and the
    fit's own bitwise ``coded_left_stats_fixed`` at the shard's own
    fixed-point scales."""
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_fixed,
    )

    kw = dict(n_nodes=c["N"], hist_dtype=c["hist_dtype"], cols=c["cols"])
    out = coded_left_stats(c["codes"], c["edges"], c["node"], c["S"],
                           integral=False, **kw)
    fixed = coded_left_stats_fixed(c["codes"], c["edges"], c["node"],
                                   c["S"], **kw)
    return dict(replicas_unequal_to_fixed_plain=int(
        (out != fixed).any(dim=(1, 2, 3, 4)).sum()),
        fit_table_bitwise=bool(torch.equal(c["out"], fixed)),
        max_abs_err=float((out - fixed).abs().max()))


def phase_mesh_gbt(split) -> tuple[int, int, dict]:
    """BASELINE config 7 at full width on a (2, 2) mesh: 400,000 rows and
    16 GBTs a shard, each shard's histogram on its rows in the float
    accumulator, the tables summed over ``data``. With the bootstrap:
    the test AUC against the sklearn proxy, as ``gbt_fit``; launches by
    shard; at every shard's deepest level of round 0 the kernel bitwise
    its plain version at the shard's own fixed-point scales, shard (0,
    0)'s with times, bound and library (``float_hist_row``). With
    ``bootstrap=False`` on the first MESH_GBT_EXACT_ROWS rows: against
    the single-device fit under the mesh's edges, round 0's split features equal in at least
    GBT_CROSS_FEATURE_SHARE, every replica's first different split a
    tie (``gbt_first_divergence``) and the AUC within GBT_CROSS_AUC_TOL.
    Returns the histogram and bin-codes launches and shard (0, 0)'s
    row."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    Xtr, ytr, Xte, yte = split
    shape, depth = MESH_1B["gbt"], GBT["max_depth"]
    n_shards = shape[0] * shape[1]
    est = gbt_bagger()
    est.set_params(mesh=mesh_of(*shape))
    reset_launches()
    recs, restore = record_shard_levels(2 ** (depth - 1))
    t0 = time.perf_counter()
    try:
        est.fit(Xtr, ytr)
    finally:
        restore()
    fit_seconds = time.perf_counter() - t0
    counts, per_shard = read_launches(), shard_launches()
    rep = est.fit_report_
    r_shard = GBT_REPLICAS // shape[1]
    chunk = rep["chunk_size_resolved"] or r_shard
    expected = depth * GBT["n_rounds"] * -(-r_shard // chunk)
    auc = roc_auc(yte, est.predict_proba(Xte)[:, 1])
    del est
    torch.cuda.empty_cache()
    shards = {f"{k[0]},{k[1]}": fixed_shard_check(c)
              for k, c in sorted(recs.items())}
    c00 = recs.pop((0, 0))
    del recs
    row = float_hist_row("mesh_gbt_hist", c00, c00["S"].shape[0],
                         c00["hist_dtype"], fit_out=c00["out"],
                         mesh=list(shape), shard="0,0", round=0)
    del c00
    torch.cuda.empty_cache()
    launches_ok = mesh_fit_launches(counts, per_shard, n_shards, expected, 1,
                                    float_stats=True)
    total = dict(counts)
    reset_launches()
    on_mesh, single = mesh_exact_pair(gbt_bagger, Xtr[:MESH_GBT_EXACT_ROWS],
                                      ytr[:MESH_GBT_EXACT_ROWS], shape)
    exact_counts = read_launches()
    auc_mesh = roc_auc(yte, on_mesh.predict_proba(Xte)[:, 1])
    auc_single = roc_auc(yte, single.predict_proba(Xte)[:, 1])
    round0, every = split_feature_shares(on_mesh, single, 2**depth - 1)
    divergence = gbt_first_divergence(on_mesh, single, 2**depth - 1)
    del on_mesh, single
    torch.cuda.empty_cache()
    bar = GBT_PROXY_AUC - PARITY_TOL
    d_auc = abs(auc_mesh - auc_single)
    fields = dict(mesh=list(shape), rows_a_shard=len(ytr) // shape[0],
                  replicas_a_shard=r_shard, chunk_size=chunk, **GBT,
                  fit_seconds=fit_seconds, launches=counts,
                  launches_by_shard=per_shard,
                  expected_hist_launches_a_shard=expected,
                  test_auc=auc, proxy_auc=GBT_PROXY_AUC, auc_bar=bar,
                  deepest_level_by_shard=shards,
                  bootstrap_false_rows=MESH_GBT_EXACT_ROWS,
                  bootstrap_false_round0_equal_split_feature_share=round0,
                  bootstrap_false_equal_split_feature_share=every,
                  bootstrap_false_first_divergence=divergence,
                  bootstrap_false_test_auc_mesh=auc_mesh,
                  bootstrap_false_test_auc_single=auc_single,
                  bootstrap_false_auc_diff=d_auc,
                  feature_share_bar=GBT_CROSS_FEATURE_SHARE,
                  auc_tol=GBT_CROSS_AUC_TOL,
                  bootstrap_false_launches=exact_counts, card=CARD)
    ok = (launches_ok and auc >= bar
          and all(not v["replicas_unequal_to_fixed_plain"]
                  and v["fit_table_bitwise"] for v in shards.values())
          and len(shards) == n_shards
          and round0 >= GBT_CROSS_FEATURE_SHARE
          and divergence["all_ties"]
          and d_auc <= GBT_CROSS_AUC_TOL)
    emit("mesh_gbt", ok=ok, **fields)
    if not ok:
        fail("mesh_gbt", f"checks failed: {fields}")
    for k in ("binned_left_stats", "bin_codes"):
        total[k] += exact_counts[k]
    row["max_abs_err"] = max(row["max_abs_err"],
                             *(v["max_abs_err"] for v in shards.values()))
    return total["binned_left_stats"], total["bin_codes"], row


def gbt_small_cases(X: np.ndarray, y: np.ndarray, split) -> dict:
    """``mesh_gbt_small``'s two cases by phase: ``(make, X, y, config,
    quality(est), proxy, classes)``."""
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        BaggingRegressor,
        GBTClassifier,
        GBTRegressor,
    )
    from spark_bagging_tpu_torch.utils.metrics import accuracy, r2_score

    Xtr, ytr, Xte, yte = split
    Xm, ym = X[:MESH_MC_ROWS], y[:MESH_MC_ROWS]
    Xe, ye = X[:N_SERVE_ROWS], y[:N_SERVE_ROWS]
    return {
        "mesh_gbt_multiclass": (
            lambda: BaggingClassifier(GBTClassifier(
                n_rounds=GBT_MC["n_rounds"], max_depth=GBT_MC["max_depth"]),
                n_estimators=GBT_MC["n_estimators"], seed=0),
            Xm, ym, GBT_MC, lambda est: accuracy(ye, est.predict(Xe)),
            GBT_MC_PROXY_ACC, N_CLASSES),
        "mesh_gbt_reg": (
            lambda: BaggingRegressor(GBTRegressor(
                n_rounds=GBT_REG["n_rounds"],
                max_depth=GBT_REG["max_depth"]),
                n_estimators=GBT_REG["n_estimators"], seed=0),
            Xtr, ytr, GBT_REG, lambda est: r2_score(yte, est.predict(Xte)),
            GBT_REG_PROXY_R2, 1),
    }


def phase_mesh_gbt_small(X: np.ndarray, y: np.ndarray, split) -> tuple:
    """The multiclass GBTs (GBT_MC, on the first MESH_MC_ROWS covtype
    rows) and the GBT regressors (GBT_REG, on the California split) on a
    (2, 1) data mesh: with the bootstrap, the single-device phases'
    quality bars (accuracy and R^2 against the sklearn proxies minus
    PARITY_TOL) and every shard's launches (levels x rounds a replica
    chunk, one bin-codes launch, all float); with ``bootstrap=False``,
    against the single-device fit under the mesh's edges: round 0's
    split features equal in at least GBT_CROSS_FEATURE_SHARE, every
    replica's first different split a tie (``gbt_first_divergence``), the
    quality figure within GBT_CROSS_AUC_TOL. Returns the histogram and
    bin-codes launches."""
    shape = MESH_1B["gbt_small"]
    cases = gbt_small_cases(X, y, split)
    hist_total = codes_total = 0
    for phase, (make, Xf, yf, cfg, quality, proxy, C) in cases.items():
        R, depth = cfg["n_estimators"], cfg["max_depth"]
        est = make()
        est.set_params(mesh=mesh_of(*shape))
        reset_launches()
        t0 = time.perf_counter()
        est.fit(Xf, yf)
        fit_seconds = time.perf_counter() - t0
        counts, per_shard = read_launches(), shard_launches()
        chunk = est.fit_report_["chunk_size_resolved"] or R
        expected = depth * cfg["n_rounds"] * -(-R // chunk)
        q = quality(est)
        del est
        reset_launches()
        on_mesh, single = mesh_exact_pair(make, Xf, yf, shape)
        exact_counts = read_launches()
        q_mesh, q_single = quality(on_mesh), quality(single)
        round0, every = split_feature_shares(on_mesh, single,
                                             C * (2**depth - 1))
        divergence = gbt_first_divergence(on_mesh, single,
                                          C * (2**depth - 1))
        del on_mesh, single
        torch.cuda.empty_cache()
        bar = proxy - PARITY_TOL
        fields = dict(mesh=list(shape), rows=len(yf),
                      rows_a_shard=len(yf) // shape[0], **cfg,
                      chunk_size=chunk, fit_seconds=fit_seconds,
                      launches=counts, launches_by_shard=per_shard,
                      expected_hist_launches_a_shard=expected,
                      quality=q, proxy=proxy, bar=bar,
                      bootstrap_false_round0_equal_split_feature_share=round0,
                      bootstrap_false_equal_split_feature_share=every,
                      bootstrap_false_first_divergence=divergence,
                      bootstrap_false_quality_mesh=q_mesh,
                      bootstrap_false_quality_single=q_single,
                      feature_share_bar=GBT_CROSS_FEATURE_SHARE,
                      quality_tol=GBT_CROSS_AUC_TOL,
                      bootstrap_false_launches=exact_counts, card=CARD)
        if phase == "mesh_gbt_multiclass":
            fields["rows_cut_from"] = N_ROWS
        ok = (mesh_fit_launches(counts, per_shard, shape[0], expected, 1,
                                float_stats=True)
              and q >= bar and round0 >= GBT_CROSS_FEATURE_SHARE
              and divergence["all_ties"]
              and abs(q_mesh - q_single) <= GBT_CROSS_AUC_TOL)
        emit(phase, ok=ok, **fields)
        if not ok:
            fail(phase, f"checks failed: {fields}")
        hist_total += (counts["binned_left_stats"]
                       + exact_counts["binned_left_stats"])
        codes_total += counts["bin_codes"] + exact_counts["bin_codes"]
    return hist_total, codes_total


def phase_mesh_stream_trees(X: np.ndarray, y: np.ndarray,
                            tree_acc: float) -> tuple[int, int, dict]:
    """Config 3's learner streamed on a (2, 2) mesh over the first
    MESH_STREAM_ROWS rows: 65,536-row chunks (the last padded), each
    shard its 32,768 rows of a chunk and 128 replicas, drawing its
    rows' weights from the chunk key folded with its data index; each
    level's table summed over ``data``. With the bootstrap: accuracy on
    the first 100k rows within TREE_STREAM_ACC_TOL of the in-memory
    fit's; every shard's launches levels x chunks (int32), the histogram
    at every shard's deepest level of chunk 0 bitwise its plain version
    (shard (0, 0)'s with times, bound and library); the snapshot the
    stream wrote on the mesh after MESH_RESUME_PASS - 1 levels, resumed
    on the same mesh: bitwise the uninterrupted mesh stream, the kernels
    launched only for the levels left. With ``bootstrap=False``, on the
    first MESH_EXACT_CHUNKS chunks' rows: every split and leaf bitwise
    the single-device stream's (a global edge pass, integer tables).
    Returns the histogram and bin-codes launches and shard (0, 0)'s
    row."""
    import shutil

    from spark_bagging_tpu_torch import tree_stream as tree_stream_mod
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_plain,
    )

    shape = MESH_1B["stream_trees"]
    n_shards = shape[0] * shape[1]
    classes = np.unique(y)
    n_rows = MESH_STREAM_ROWS
    n_chunks = -(-n_rows // TREE_STREAM_CHUNK)
    depth = TREE["max_depth"]

    def bagger(**kw):
        est = tree_bagger(N_REPLICAS)
        est.set_params(**kw)
        return est

    def source():
        return tree_stream_source(X[:n_rows], y[:n_rows], TREE_STREAM_CHUNK)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, mid = f"{tmp}/mesh_trees", f"{tmp}/mesh_trees_mid"
        reset_launches()
        recs, restore = record_shard_levels(2 ** (depth - 1))
        # the stream snapshots at every pass boundary; the one written
        # after MESH_RESUME_PASS - 1 levels is kept aside for the resume
        save = tree_stream_mod.save_snapshot

        def keep_mid(path, tree, meta):
            save(path, tree, meta)
            if meta["next_pass"] == MESH_RESUME_PASS:
                shutil.copytree(path, mid)

        tree_stream_mod.save_snapshot = keep_mid
        t0 = time.perf_counter()
        try:
            full = bagger(mesh=mesh_of(*shape)).fit_stream(
                source(), classes=classes, checkpoint_dir=ckpt)
        finally:
            restore()
            tree_stream_mod.save_snapshot = save
        stream_seconds = time.perf_counter() - t0
        counts, per_shard = read_launches(), shard_launches()
        acc = full.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
        expected = depth * n_chunks
        shards = {}
        for k, c in sorted(recs.items()):
            kw = dict(n_nodes=c["N"], hist_dtype=c["hist_dtype"],
                      cols=c["cols"])
            out = coded_left_stats(c["codes"], c["edges"], c["node"], c["S"],
                                   integral=True, **kw)
            unequal = 0
            for r in range(c["S"].shape[0]):
                plain = coded_left_stats_plain(
                    c["codes"], c["edges"][r:r + 1], c["node"][r:r + 1],
                    c["S"][r:r + 1], n_nodes=c["N"],
                    hist_dtype=c["hist_dtype"], cols=c["cols"][r:r + 1])
                unequal += not (torch.equal(out[r], plain[0])
                                and torch.equal(c["out"][r], plain[0]))
            shards[f"{k[0]},{k[1]}"] = dict(
                rows=c["codes"].shape[0], replicas=c["S"].shape[0],
                replicas_unequal=unequal)
            del out
        row = mesh_hist_check(recs.pop((0, 0)))
        del recs
        torch.cuda.empty_cache()
        with open(f"{mid}/meta.json") as f:
            meta = json.load(f)
        reset_launches()
        t0 = time.perf_counter()
        resumed = bagger(mesh=mesh_of(*shape)).fit_stream(
            source(), classes=classes, resume_from=mid)
        resume_seconds = time.perf_counter() - t0
        resume_counts = read_launches()
    resume_unequal = [k for k in full.ensemble_ if not torch.equal(
        resumed.ensemble_[k], full.ensemble_[k])]
    del full, resumed
    torch.cuda.empty_cache()
    # bootstrap=False on the first MESH_EXACT_CHUNKS chunks' rows
    n_exact = MESH_EXACT_CHUNKS * TREE_STREAM_CHUNK
    reset_launches()
    exact = {}
    for name, mesh in (("mesh", mesh_of(*shape)), ("single", None)):
        exact[name] = bagger(bootstrap=False, max_samples=1.0,
                             mesh=mesh).fit_stream(
            tree_stream_source(X[:n_exact], y[:n_exact], TREE_STREAM_CHUNK),
            classes=classes)
    exact_counts = read_launches()
    exact_unequal = [k for k in exact["mesh"].ensemble_ if not torch.equal(
        exact["mesh"].ensemble_[k], exact["single"].ensemble_[k])]
    del exact
    torch.cuda.empty_cache()
    levels_left = depth - (meta["next_pass"] - 1)
    fields = dict(mesh=list(shape), rows=n_rows, rows_cut_from=N_ROWS,
                  n_chunks=n_chunks, chunk_rows=TREE_STREAM_CHUNK,
                  rows_a_shard_a_chunk=TREE_STREAM_CHUNK // shape[0],
                  replicas_a_shard=N_REPLICAS // shape[1],
                  stream_seconds=stream_seconds, launches=counts,
                  launches_by_shard=per_shard,
                  expected_launches_each_a_shard=expected,
                  accuracy_100k=acc, in_memory_accuracy_100k=tree_acc,
                  acc_tol=TREE_STREAM_ACC_TOL,
                  snapshot_data_size=meta["config"]["data_size"],
                  resumed_levels=levels_left, resume_seconds=resume_seconds,
                  resume_launches=resume_counts,
                  resumed_leaves_unequal=resume_unequal,
                  bootstrap_false_rows=n_exact,
                  bootstrap_false_leaves_unequal_to_single=exact_unequal,
                  bootstrap_false_launches=exact_counts,
                  deepest_level_by_shard=shards, hist_shard_0_0=row,
                  card=CARD)
    ok = (mesh_fit_launches(counts, per_shard, n_shards, expected, expected,
                            float_stats=False)
          and abs(acc - tree_acc) <= TREE_STREAM_ACC_TOL
          and len(shards) == n_shards
          and not any(v["replicas_unequal"] for v in shards.values())
          and not row["replicas_unequal"]
          and meta["config"]["data_size"] == shape[0]
          and levels_left == depth - (MESH_RESUME_PASS - 1)
          and resume_counts["binned_left_stats"]
          == levels_left * n_chunks * n_shards
          and not resume_unequal and not exact_unequal)
    emit("mesh_stream_trees", ok=ok, **fields)
    if not ok:
        fail("mesh_stream_trees", f"checks failed: {fields}")
    hist = (counts["binned_left_stats"] + resume_counts["binned_left_stats"]
            + exact_counts["binned_left_stats"])
    codes = (counts["bin_codes"] + resume_counts["bin_codes"]
             + exact_counts["bin_codes"])
    return hist, codes, row


def phase_mesh_stream_mlp() -> None:
    """BASELINE config 4's learner at full width (512 MLPs, hidden 32,
    20,000-row chunks, 2 Adam steps a chunk) streamed on a (2, 2) mesh:
    each shard steps 256 replicas on 10,000 rows of a chunk, the weights
    drawn over the whole chunk and sliced, the gradients summed over
    ``data`` before each step. The stream is cut to the first
    MESH_MLP_ROWS rows of its 11M; against the single-device stream over
    the same rows, the test probabilities within MESH_MLP_PROBA_TOL and
    the AUC within MESH_MLP_AUC_TOL. No kernel of the repo runs."""
    from spark_bagging_tpu_torch.utils.metrics import roc_auc

    cfg, shape = MLP_STREAM, MESH_1B["stream_mlp"]
    fit_kw = dict(classes=[0, 1], n_epochs=cfg["n_epochs"],
                  steps_per_chunk=cfg["steps_per_chunk"], lr=cfg["lr"])
    Xte, yte = mlp_test_data()
    fits, seconds = {}, {}
    reset_launches()
    for name, mesh in (("mesh", mesh_of(*shape)), ("single", None)):
        est = mlp_bagger(cfg["n_estimators"])
        est.set_params(mesh=mesh)
        t0 = time.perf_counter()
        est.fit_stream(mlp_source(MESH_MLP_ROWS, cfg["chunk_rows"]), **fit_kw)
        seconds[name] = time.perf_counter() - t0
        fits[name] = est
    counts = read_launches()
    proba = {k: v.predict_proba(Xte) for k, v in fits.items()}
    auc = {k: roc_auc(yte, p[:, 1]) for k, p in proba.items()}
    diff = float(np.abs(proba["mesh"] - proba["single"]).max())
    rep = fits["mesh"].fit_report_
    n_chunks = -(-MESH_MLP_ROWS // cfg["chunk_rows"])
    del fits
    torch.cuda.empty_cache()
    fields = dict(mesh=list(shape), **cfg, hidden=MLP["hidden"],
                  rows=MESH_MLP_ROWS, rows_cut_from=cfg["n_rows"],
                  rows_a_shard_a_chunk=cfg["chunk_rows"] // shape[0],
                  replicas_a_shard=cfg["n_estimators"] // shape[1],
                  n_chunks=rep["n_chunks"], opt_steps=rep["opt_steps"],
                  stream_seconds=seconds["mesh"],
                  single_device_stream_seconds=seconds["single"],
                  row_replica_per_sec=MESH_MLP_ROWS * cfg["n_estimators"]
                  / seconds["mesh"], launches=counts,
                  test_auc=auc["mesh"], single_device_test_auc=auc["single"],
                  auc_tol=MESH_MLP_AUC_TOL, proba_max_abs_diff=diff,
                  proba_tol=MESH_MLP_PROBA_TOL, card=CARD)
    ok = (rep["n_chunks"] == n_chunks and not any(counts.values())
          and np.isfinite(proba["mesh"]).all()
          and diff <= MESH_MLP_PROBA_TOL
          and abs(auc["mesh"] - auc["single"]) <= MESH_MLP_AUC_TOL)
    emit("mesh_stream_mlp", ok=ok, **fields)
    if not ok:
        fail("mesh_stream_mlp", f"checks failed: {fields}")


def mp_headline(mesh, X, y, chunk_size=None):
    """The multiprocess phase's headline fit on ``mesh``: ``(estimator,
    fit seconds, launches, launches by shard)``."""
    from spark_bagging_tpu_torch import BaggingClassifier

    clf = BaggingClassifier(headline_learner(), n_estimators=N_REPLICAS,
                            seed=0, mesh=mesh, chunk_size=chunk_size)
    reset_launches()
    t0 = time.perf_counter()
    clf.fit(X, y)
    return clf, time.perf_counter() - t0, read_launches(), shard_launches()


def mp_stream(mesh, **fit_kw):
    """Config 4's learner streamed on ``mesh`` over the first
    MP["stream_rows"] rows: ``(estimator, seconds)``."""
    cfg = MLP_STREAM
    est = mlp_bagger(cfg["n_estimators"])
    est.set_params(mesh=mesh)
    t0 = time.perf_counter()
    est.fit_stream(mlp_source(MP["stream_rows"], cfg["chunk_rows"]),
                   classes=[0, 1], n_epochs=cfg["n_epochs"],
                   steps_per_chunk=cfg["steps_per_chunk"], lr=cfg["lr"],
                   **fit_kw)
    return est, time.perf_counter() - t0


def mp_state(prefix: str, est) -> dict:
    return {f"{prefix}.{k}": v.cpu().numpy() for k, v in est.ensemble_.items()}


def mp_worker(rank: int, port: str, out: str) -> int:
    """One child of the multiprocess phase: join, build the (2, 2) mesh
    with ``cuda:0`` x 2 as this process's part, arm telemetry, fit the
    headline, config 3's trees and config 4's stream (snapshot and
    resume), try the OOB stream, ``save()`` the headline; write the
    gathered state to ``out/arrays<rank>.npz`` and the numbers to
    ``out/scalars<rank>.json``. The replica chunks are the 1-process
    references' (``out/chunks.json``): a chunk sets how many replicas
    one Gram launch sums, and so the bits."""
    import torch.distributed as dist

    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    n_devices = initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                       timeout_s=MP["group_timeout_s"])
    mesh = make_mesh(*MP["shape"], devices=["cuda:0"] * 2)
    telemetry.reset()
    telemetry.enable()
    X, y = headline_data()
    t_ready = time.perf_counter() - t_start
    # the parent writes the chunks once its references are fitted
    path = os.path.join(out, "chunks.json")
    while not os.path.exists(path):
        if time.perf_counter() - t_start > MP["timeout_s"]:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    with open(path) as f:
        chunks = json.load(f)
    t_waited = time.perf_counter() - t_start - t_ready

    def series(name, label=None):
        return [s for s in telemetry.registry().snapshot()
                if s["name"] == name
                and (label is None or s["labels"] == label)]

    clf, fit_s, counts, per_shard = mp_headline(mesh, X, y,
                                                chunks["headline"])
    h2d_fit = sum(s["value"] for s in series("sbt_h2d_bytes_total",
                                             {"process": str(rank)}))
    arrays = {**mp_state("headline", clf),
              "headline.subspaces": clf.subspaces_.cpu().numpy(),
              "headline.proba": clf.predict_proba(X[:N_SERVE_ROWS])}
    clf.save(os.path.join(out, "headline"))
    del clf
    reset_launches()
    trees = tree_bagger(N_REPLICAS, split_impl="fused",
                        chunk_size=chunks["trees"])
    trees.set_params(mesh=mesh)
    t0 = time.perf_counter()
    trees.fit(X, y)
    tree_s = time.perf_counter() - t0
    tree_shards = shard_launches()
    arrays.update(mp_state("trees", trees))
    del trees, X, y
    ck = os.path.join(out, "stream_ck")
    stream, stream_s = mp_stream(mesh, checkpoint_dir=ck,
                                 checkpoint_every=MP["snapshot_every"])
    with open(os.path.join(ck, "meta.json")) as f:
        snapshot_next_chunk = json.load(f)["next_chunk"]
    resumed, resume_s = mp_stream(mesh, resume_from=ck)
    arrays.update({**mp_state("stream", stream),
                   **mp_state("stream_resumed", resumed)})
    del stream, resumed
    try:
        oob = mlp_bagger(MLP_STREAM["n_estimators"])
        oob.set_params(mesh=mesh, oob_score=True)
        oob.fit_stream(mlp_source(MLP_STREAM["chunk_rows"],
                                  MLP_STREAM["chunk_rows"]), classes=[0, 1])
        oob_error = None
    except ValueError as e:
        oob_error = str(e)
    saved = {s["labels"]["kind"]: s["value"]
             for s in series("sbt_checkpoint_bytes_total")
             if s["labels"].get("op") == "save"}
    coll = series("sbt_collective_seconds")
    scalars = dict(
        rank=rank, n_global_devices=n_devices,
        mesh_processes=mesh.processes.tolist(), ready_seconds=t_ready,
        waited_seconds=t_waited,
        fit_seconds=fit_s, launches=counts, launches_by_shard=per_shard,
        tree_fit_seconds=tree_s, tree_launches_by_shard=tree_shards,
        stream_seconds=stream_s, resume_seconds=resume_s,
        snapshot_next_chunk=snapshot_next_chunk, oob_stream_error=oob_error,
        h2d_bytes_headline_fit=h2d_fit,
        h2d_bytes=sum(s["value"] for s in series("sbt_h2d_bytes_total",
                                                 {"process": str(rank)})),
        d2h_bytes=sum(s["value"] for s in series("sbt_d2h_bytes_total",
                                                 {"process": str(rank)})),
        collective_count=sum(s["count"] for s in coll),
        collective_seconds=sum(s["sum"] for s in coll),
        exchanges=mesh.exchanges, staged_bytes=mesh.staged_bytes,
        checkpoint_bytes_saved=saved)
    np.savez(os.path.join(out, f"arrays{rank}.npz"), **arrays)
    with open(os.path.join(out, f"scalars{rank}.json"), "w") as f:
        json.dump(scalars, f)
    dist.destroy_process_group()
    return 0


def mp_start(out: str) -> tuple[list, list, float]:
    """Start the two children: ``(processes, their logs, deadline)``.
    Children log to files: a pipe nobody drained could stall one in a
    collective."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    if os.path.isdir("/sys/class/net/lo"):
        # gloo on the loopback interface, whatever the host name resolves to
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [open(os.path.join(out, f"log{r}.txt"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker", str(r),
         str(port), out], stdout=log, stderr=log, env=env)
        for r, log in enumerate(logs)]
    return procs, logs, time.monotonic() + MP["timeout_s"]


def mp_finish(procs, logs, deadline) -> list[tuple[int | None, str]]:
    """Wait for both children until the deadline, then kill what is
    left: ``(exit code or None, log tail)`` each."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    return list(zip(codes, tails))


def phase_multiprocess(X: np.ndarray, y: np.ndarray, tree_ref: dict) -> dict:
    """Two processes on one (2, 2) mesh (see the module docstring): the
    children start (import, join, make their data) while the 1-process
    references are fitted here (the headline and the stream on (2, 2)
    over ``cuda:0`` x 4; the trees are ``mesh_trees``' fit); the
    children's fits begin once the references' replica chunks are
    written, so the card runs one side at a time. Then the gates.
    Returns each kernel's launches in the references and in both
    children."""
    import shutil

    from spark_bagging_tpu_torch import BaggingClassifier

    t_phase = time.perf_counter()
    shape = MP["shape"]
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="sbt_mp_")
    procs, logs, deadline = mp_start(out)
    try:
        clf, fit_s, counts, per_shard = mp_headline(mesh_of(*shape), X, y)
        ref = {**mp_state("headline", clf),
               "headline.subspaces": clf.subspaces_.cpu().numpy(),
               "headline.proba": clf.predict_proba(X[:N_SERVE_ROWS]),
               **{f"trees.{k}": v for k, v in tree_ref["state"].items()}}
        classes = clf.classes_
        chunks = dict(headline=clf.fit_report_["chunk_size_resolved"]
                      or N_REPLICAS // shape[1], trees=tree_ref["chunk_size"])
        del clf
        stream, stream_s = mp_stream(mesh_of(*shape))
        ref.update(mp_state("stream", stream))
        del stream
        torch.cuda.empty_cache()
        # written whole, then renamed: the children wait for the name
        with open(os.path.join(out, "chunks.tmp"), "w") as f:
            json.dump(chunks, f)
        os.replace(os.path.join(out, "chunks.tmp"),
                   os.path.join(out, "chunks.json"))
        t0 = time.perf_counter()
        results = mp_finish(procs, logs, deadline)
        children_s = time.perf_counter() - t0
        for r, (code, tail) in enumerate(results):
            if code != 0:
                fail("multiprocess", f"child {r} exit {code}:\n{tail}")
        got, sc = [], []
        for r in range(2):
            with np.load(os.path.join(out, f"arrays{r}.npz")) as z:
                got.append(dict(z))
            with open(os.path.join(out, f"scalars{r}.json")) as f:
                sc.append(json.load(f))
        loaded = BaggingClassifier.load(os.path.join(out, "headline"),
                                        mesh=mesh_of(*shape))
        loaded_proba = loaded.predict_proba(X[:N_SERVE_ROWS])
        del loaded
    finally:
        # no child outlives the phase, whatever failed
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(out, ignore_errors=True)
    unequal = [sorted(k for k, v in ref.items()
                      if not np.array_equal(got[r][k], v)) for r in range(2)]
    resume_unequal = [sorted(
        k for k in got[r] if k.startswith("stream.") and not np.array_equal(
            got[r][k], got[r][k.replace("stream.", "stream_resumed.")]))
        for r in range(2)]
    between = sorted(k for k in got[0]
                     if not np.array_equal(got[0][k], got[1][k]))
    acc = float((classes[got[0]["headline.proba"].argmax(1)]
                 == y[:N_SERVE_ROWS]).mean())
    # one row block a process for X (float32), y (int64) and the mask
    # (float32): its two positions share cuda:0
    h2d_want = (N_ROWS // shape[0]) * (N_FEATURES * 4 + 8 + 4)
    kinds = ("scaled_gram", "binned_left_stats", "bin_codes")

    def own(want: dict, r: int) -> dict:
        return {k: {s: v for s, v in want[k].items()
                    if s.startswith(f"{r},")} for k in kinds}

    launch_ok = [
        own(sc[r]["launches_by_shard"], r) == own(per_shard, r)
        and own(sc[r]["tree_launches_by_shard"], r)
        == own(tree_ref["launches_by_shard"], r)
        and len(sc[r]["launches_by_shard"]["scaled_gram"]) == 2
        and len(sc[r]["tree_launches_by_shard"]["binned_left_stats"]) == 2
        for r in range(2)]
    fields = dict(
        mesh=list(shape), processes=sc[0]["mesh_processes"],
        replica_chunks=chunks,
        n_global_devices=[c["n_global_devices"] for c in sc],
        replicas=N_REPLICAS, rows=N_ROWS, stream_rows=MP["stream_rows"],
        stream_rows_cut_from=MLP_STREAM["n_rows"],
        fit_seconds_2proc=[c["fit_seconds"] for c in sc],
        fit_seconds_1proc=fit_s,
        tree_fit_seconds_2proc=[c["tree_fit_seconds"] for c in sc],
        tree_fit_seconds_1proc=tree_ref["fit_seconds"],
        stream_seconds_2proc=[c["stream_seconds"] for c in sc],
        stream_seconds_1proc=stream_s,
        resume_seconds_2proc=[c["resume_seconds"] for c in sc],
        snapshot_next_chunk=[c["snapshot_next_chunk"] for c in sc],
        child_ready_seconds=[c["ready_seconds"] for c in sc],
        child_waited_seconds=[c["waited_seconds"] for c in sc],
        children_seconds_after_references=children_s,
        collective_seconds=[c["collective_seconds"] for c in sc],
        collective_gathers=[c["collective_count"] for c in sc],
        exchanges=[c["exchanges"] for c in sc],
        staged_bytes=[c["staged_bytes"] for c in sc],
        d2h_bytes=[c["d2h_bytes"] for c in sc],
        h2d_bytes=[c["h2d_bytes"] for c in sc],
        h2d_bytes_headline_fit=[c["h2d_bytes_headline_fit"] for c in sc],
        h2d_bytes_headline_fit_want=h2d_want,
        checkpoint_bytes_saved=[c["checkpoint_bytes_saved"] for c in sc],
        oob_stream_error=[c["oob_stream_error"] for c in sc],
        unequal_to_1proc=unequal, resume_unequal=resume_unequal,
        unequal_between_children=between,
        loaded_checkpoint_bitwise=bool(np.array_equal(
            loaded_proba, got[0]["headline.proba"])),
        accuracy_100k=acc, acc_bar=ACC_BAR,
        launches_by_shard_1proc=per_shard,
        tree_launches_by_shard_1proc=tree_ref["launches_by_shard"],
        launches_by_shard_2proc=[c["launches_by_shard"] for c in sc],
        tree_launches_by_shard_2proc=[c["tree_launches_by_shard"]
                                      for c in sc],
        launches_a_shard_equal=launch_ok,
        phase_seconds=time.perf_counter() - t_phase, card=CARD)
    ok = (not any(unequal) and not any(resume_unequal) and not between
          and fields["loaded_checkpoint_bitwise"] and acc >= ACC_BAR
          and all(launch_ok) and fields["n_global_devices"] == [2, 2]
          and fields["processes"] == [[0, 0], [1, 1]]
          and all(c["snapshot_next_chunk"] == MP["snapshot_every"]
                  for c in sc)
          and all(c["h2d_bytes_headline_fit"] == h2d_want for c in sc)
          and all(c["d2h_bytes"] > 0 and c["collective_count"] > 0
                  and c["exchanges"] > 0 for c in sc)
          and sc[0]["checkpoint_bytes_saved"].get("stream", 0) > 0
          and sc[0]["checkpoint_bytes_saved"].get("model", 0) > 0
          and not sc[1]["checkpoint_bytes_saved"]
          and all(c["oob_stream_error"]
                  == "oob_score with fit_stream is single-process only"
                  for c in sc))
    emit("multiprocess", ok=ok, **fields)
    if not ok:
        fail("multiprocess", f"checks failed: {fields}")
    return {k: counts[k] + sum(
        sum(c["launches_by_shard" if k == "scaled_gram"
              else "tree_launches_by_shard"][k].values()) for c in sc)
        for k in kinds}


def mesh_zoo_gaps(make_est, X, y, shape, fit_kw=None,
                  device: str = "cuda") -> tuple[float, float]:
    """``mesh_exact_pair``'s two fits of ``make_est()``: the largest gap
    of their parameters and of their predictions (probabilities for a
    classifier), each over ``max(1, |single-device value|)``."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    on_mesh, single = mesh_exact_pair(make_est, X, y, shape, fit_kw, device)
    pred = (on_mesh.predict_proba if hasattr(on_mesh, "predict_proba")
            else on_mesh.predict)
    pred_single = (single.predict_proba if hasattr(single, "predict_proba")
                   else single.predict)
    param = max(rel(v.cpu().numpy(), single.ensemble_[k].cpu().numpy())
                for k, v in on_mesh.ensemble_.items())
    return param, rel(pred(X), pred_single(X))


def phase_mesh_zoo(X: np.ndarray, y: np.ndarray, split) -> None:
    """The rest of the zoo on a (4, 1) data mesh with ``bootstrap=False``
    (16 replicas; 20,000 covtype rows for the classifiers, the 16,512
    California training rows for the regressors): LinearSVC, the three
    naive Bayes learners, FMClassifier, MLPClassifier (config 4's width,
    50 full-batch Adam steps), GLM, isotonic (under the mesh's averaged
    edges) and AFT (100 Adam steps, censor flags through ``aux``), each
    against its single-device fit on the card within MESH_ZOO_TOL (each
    family's CPU parity tolerance, ZOO_TOL, but for the naive Bayes
    probabilities and the MLP: see MESH_ZOO_TOL), over ``max(1,
    |single-device value|)``.
    Their products are torch matmuls: no kernel of the repo runs."""
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BaggingClassifier,
        BaggingRegressor,
        BernoulliNB,
        FMClassifier,
        GaussianNB,
        GeneralizedLinearRegression,
        IsotonicRegression,
        LinearSVC,
        MLPClassifier,
        MultinomialNB,
    )

    shape, R = MESH_1B["zoo"], MESH_1B["zoo_replicas"]
    n = MESH_1B["zoo_rows"]
    Xc, yc = X[:n], y[:n]
    Xtr, ytr = split[0], split[1]
    t_obs, cens, _ = survival_data(split)
    tols = MESH_ZOO_TOL
    learners = [
        ("svc", BaggingClassifier, lambda: LinearSVC(max_iter=8), Xc, yc,
         {}, tols["svc"]),
        ("gaussian_nb", BaggingClassifier, GaussianNB, Xc, yc, {},
         tols["nb"]),
        ("bernoulli_nb", BaggingClassifier, BernoulliNB, Xc, yc, {},
         tols["nb"]),
        ("multinomial_nb", BaggingClassifier, MultinomialNB, np.abs(Xc), yc,
         {}, tols["nb"]),
        ("fm", BaggingClassifier,
         lambda: FMClassifier(factor_size=8, max_iter=100), Xc, yc, {},
         tols["fm"]),
        ("mlp", BaggingClassifier,
         lambda: MLPClassifier(**MLP, max_iter=50), Xc, yc, {}, tols["mlp"]),
        ("glm", BaggingRegressor, GeneralizedLinearRegression, Xtr, ytr,
         {}, tols["glm"]),
        ("isotonic", BaggingRegressor,
         lambda: IsotonicRegression(n_bins=128, increasing=False), Xtr, ytr,
         {}, tols["iso"]),
        ("aft", BaggingRegressor,
         lambda: AFTSurvivalRegression(max_iter=100), Xtr, t_obs,
         {"aux": cens}, tols["aft"]),
    ]

    t_phase = time.perf_counter()
    results, ok = {}, True
    reset_launches()
    for name, E, learner, Xf, yf, fit_kw, tol in learners:
        t0 = time.perf_counter()
        param, out = mesh_zoo_gaps(
            lambda E=E, learner=learner: E(learner(), n_estimators=R,
                                           seed=0),
            Xf, yf, shape, fit_kw)
        good = param <= tol[0] and out <= tol[1]
        results[name] = dict(param_rel_err=param, pred_rel_err=out,
                             param_tol=tol[0], pred_tol=tol[1], ok=good,
                             seconds=time.perf_counter() - t0)
        ok = ok and good
    counts = read_launches()
    torch.cuda.empty_cache()
    ok = ok and not any(counts.values())
    emit("mesh_zoo", ok=ok, mesh=list(shape), replicas=R,
         classifier_rows=n, regressor_rows=len(ytr), learners=results,
         launches=counts, phase_seconds=time.perf_counter() - t_phase,
         card=CARD)
    if not ok:
        fail("mesh_zoo", f"checks failed: {results}, launches {counts}")


def mesh_witness(device: str) -> None:
    """``python3 chip_smoke.py --mesh-witness [cpu]``: the evidence behind
    MESH_ZOO_TOL and the GBT pairs' tie gate, a JSON line each; not part
    of the smoke. (1) ``mesh_zoo``'s MLP (config 4's width, 16 replicas,
    20,000 covtype rows, ``bootstrap=False``) on (4, 1) against one
    device after each of WITNESS_MLP_STEPS full-batch Adam steps, and
    its three naive Bayes learners, each gap beside the family's CPU
    tolerance and MESH_ZOO_TOL's. A gap of float32 sum-order size after
    one step that grows with the steps is Adam carrying the shards'
    summation order forward; a fault shows at step 1. (2) On the card,
    the ``bootstrap=False`` GBT pairs of ``mesh_gbt`` (at
    MESH_GBT_EXACT_ROWS and at all 800,000 rows) and ``mesh_gbt_small``
    with their first divergences (``gbt_first_divergence``)."""
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        BernoulliNB,
        GaussianNB,
        MLPClassifier,
        MultinomialNB,
    )

    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    shape, R = MESH_1B["zoo"], MESH_1B["zoo_replicas"]
    X, y = headline_data()
    Xc, yc = X[:MESH_1B["zoo_rows"]], y[:MESH_1B["zoo_rows"]]
    for steps in WITNESS_MLP_STEPS:
        param, out = mesh_zoo_gaps(
            lambda: BaggingClassifier(MLPClassifier(**MLP, max_iter=steps),
                                      n_estimators=R, seed=0,
                                      device=device),
            Xc, yc, shape, device=device)
        emit("mesh_witness_mlp", device=device, steps=steps,
             param_rel_err=param, pred_rel_err=out,
             family_tol=list(MLP_FAMILY_TOL),
             mesh_zoo_tol=list(MESH_ZOO_TOL["mlp"]), card=CARD)
    for name, learner, Xf in (("gaussian_nb", GaussianNB, Xc),
                              ("bernoulli_nb", BernoulliNB, Xc),
                              ("multinomial_nb", MultinomialNB,
                               np.abs(Xc))):
        param, out = mesh_zoo_gaps(
            lambda learner=learner: BaggingClassifier(
                learner(), n_estimators=R, seed=0, device=device),
            Xf, yc, shape, device=device)
        emit("mesh_witness_nb", device=device, learner=name,
             param_rel_err=param, pred_rel_err=out,
             family_tol=list(ZOO_TOL["nb"]),
             mesh_zoo_tol=list(MESH_ZOO_TOL["nb"]), card=CARD)
    if device == "cpu":
        return
    Xtr, ytr, _, _ = higgs_data()
    depth = GBT["max_depth"]
    pairs = {f"mesh_gbt_{n}": (gbt_bagger, Xtr[:n], ytr[:n],
                               MESH_1B["gbt"], 2**depth - 1)
             for n in (MESH_GBT_EXACT_ROWS, len(ytr))}
    for phase, (make, Xf, yf, cfg, _, _, C) in gbt_small_cases(
            X, y, regression_data()).items():
        pairs[phase] = (make, Xf, yf, MESH_1B["gbt_small"],
                        C * (2**cfg["max_depth"] - 1))
    for phase, (make, Xf, yf, pshape, per_round) in pairs.items():
        on_mesh, single = mesh_exact_pair(make, Xf, yf, pshape)
        round0, every = split_feature_shares(on_mesh, single, per_round)
        emit("mesh_witness_gbt", pair=phase, rows=len(yf),
             mesh=list(pshape), round0_equal_split_feature_share=round0,
             equal_split_feature_share=every,
             first_divergence=gbt_first_divergence(on_mesh, single,
                                                   per_round), card=CARD)
        del on_mesh, single
        torch.cuda.empty_cache()


def sklearn_proxies() -> dict:
    """The sklearn proxies the GBT, MLP and config 8 phases hold the port
    to (GBT_PROXY_AUC, GBT_MC_PROXY_ACC, GBT_REG_PROXY_R2, MLP_PROXY_AUC,
    CRITEO_PROXY_AUC), as benchmarks/run_configs.py computes configs 7's,
    4's and 8's. Needs sklearn (not on the card's machine) and no GPU."""
    from sklearn.ensemble import (
        HistGradientBoostingClassifier,
        HistGradientBoostingRegressor,
    )
    from sklearn.neural_network import MLPClassifier

    from spark_bagging_tpu_torch.utils import datasets
    from spark_bagging_tpu_torch.utils.metrics import accuracy, r2_score, roc_auc

    def proxy_rows(X, y, cap=50_000, seed=0):  # run_configs._proxy_train_set
        if len(y) <= cap:
            return X, y
        idx = np.random.default_rng(seed).choice(len(y), cap, replace=False)
        return X[idx], y[idx]

    sk = dict(max_depth=4, learning_rate=0.1, random_state=0)
    Xtr, ytr, Xte, yte = higgs_data()
    m = HistGradientBoostingClassifier(max_iter=GBT["n_rounds"], **sk).fit(
        *proxy_rows(Xtr, ytr))
    out = {"GBT_PROXY_AUC": roc_auc(yte, m.predict_proba(Xte)[:, 1])}
    X, y = headline_data()
    m = HistGradientBoostingClassifier(max_iter=GBT_MC["n_rounds"], **sk).fit(
        *proxy_rows(X, y))
    out["GBT_MC_PROXY_ACC"] = accuracy(y[:N_SERVE_ROWS],
                                       m.predict(X[:N_SERVE_ROWS]))
    Xtr, ytr, Xte, yte = regression_data()
    m = HistGradientBoostingRegressor(max_iter=GBT_REG["n_rounds"], **sk).fit(
        *proxy_rows(Xtr, ytr))
    out["GBT_REG_PROXY_R2"] = r2_score(yte, m.predict(Xte))
    Xte, yte = mlp_test_data()
    m = MLPClassifier(hidden_layer_sizes=(MLP["hidden"],), max_iter=30,
                      batch_size=1024, learning_rate_init=MLP["lr"],
                      random_state=0).fit(*datasets.synthetic_higgs(
                          50_000, seed=999_002, structure_seed=11))
    out["MLP_PROXY_AUC"] = roc_auc(yte, m.predict_proba(Xte)[:, 1])
    from sklearn.linear_model import LogisticRegression as SkLR

    Xte, yte = criteo_make(CRITEO["n_test"], seed=999_003, structure_seed=13)
    Xp, yp = criteo_make(50_000, seed=999_004, structure_seed=13)
    m = SkLR(max_iter=100, C=1.0 / (CRITEO["l2"] * len(yp))).fit(Xp, yp)
    out["CRITEO_PROXY_AUC"] = roc_auc(yte, m.predict_proba(Xte)[:, 1])
    return out


def main() -> int:
    global CARD
    if sys.argv[1:] == ["--sklearn-proxies"]:
        import sklearn

        print(json.dumps({"sklearn": sklearn.__version__,
                          **sklearn_proxies()}))
        return 0
    if sys.argv[1:] == ["--mesh-witness", "cpu"]:
        mesh_witness("cpu")
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--fleet-peer"]:
        return fleet_peer(sys.argv[2])
    if sys.argv[1:2] == ["--mp-worker"]:
        try:
            return mp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        except BaseException:
            import traceback

            traceback.print_exc()
            sys.stderr.flush()
            # a failed child exits at once: no teardown may wait on its peer
            os._exit(1)
    if sys.argv[1:] == ["--soft-vote"]:
        # the soft-vote kernel's phase alone (~1 min with the build)
        torch.backends.cuda.matmul.allow_tf32 = False
        CARD = phase_env()[1]
        phase_build()
        phase_soft_vote(headline_data()[0])
        print(json.dumps({"ok": True}))
        return 0
    if sys.argv[1:] == ["--gram"]:
        # the scaled-Gram kernel's phases alone, at every shape PERF.md's
        # kernel table lists (~3 min with the build)
        torch.backends.cuda.matmul.allow_tf32 = False
        CARD = phase_env()[1]
        phase_build()
        phase_gram(headline_data()[0])
        print(json.dumps({"ok": True}))
        return 0
    if sys.argv[1:] == ["--tree-vote"]:
        # the tree-vote kernel's phase alone, on config 3's fitted trees
        torch.backends.cuda.matmul.allow_tf32 = False
        CARD = phase_env()[1]
        phase_build()
        X, y = headline_data()
        phase_tree_vote(tree_bagger(N_REPLICAS).fit(X, y), X)
        print(json.dumps({"ok": True}))
        return 0
    if sys.argv[1:] == ["--mesh-witness"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        CARD = phase_env()[1]
        mesh_witness("cuda")
        return 0
    # the port itself, before any output: a copy of this script without
    # the repo fails here
    import spark_bagging_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_env()
    CARD = smi
    phase_build()
    X, y = headline_data()
    clf, launches, Rs = phase_fit(X, y)
    fit_wgmma_launches = read_launches()["scaled_gram_wgmma"]
    serve_launches = phase_serve(clf, X)
    audits = phase_serving(clf, X, y)
    torch.cuda.empty_cache()
    warm_launches = phase_warm_start(clf, X, y)
    torch.cuda.empty_cache()
    cand, online_launches = phase_online_update(clf, X, y)
    phase_online_publish(clf, cand, X)
    del cand
    torch.cuda.empty_cache()
    phase_quality_tap(clf, X, "quality_tap")
    loop_launches = phase_drift_loop(clf, X)
    planes_launches, planes_reg, planes_digest = phase_planes(clf, X, y)
    phase_fleet(planes_reg, X, planes_digest)
    del clf, planes_reg
    torch.cuda.empty_cache()
    anchor_launches = phase_online_anchor(X, y)
    torch.cuda.empty_cache()
    rows = phase_kernels(X, Rs)
    phase_wide_gram()
    phase_depth(X)
    phase_probe(Rs)
    sv_row = phase_soft_vote(X)
    phase_cross_check(X, y)
    torch.cuda.empty_cache()
    tree, tree_launches, codes_launches, tree_Rs = phase_tree_fit(X, y)
    tree_acc = tree.score(X[:N_SERVE_ROWS], y[:N_SERVE_ROWS])
    phase_tree_serve(tree, X)
    tv_row = phase_tree_vote(tree, X)
    phase_analysis(audits + phase_serving_trees(tree, X))
    phase_quality_tap(tree, X, "quality_tap_trees")
    phase_planes_trees(tree, X)
    tenants, tenancy_run, tenancy_wl, tenancy_launches = phase_tenancy(
        X, y, tree)
    phase_tenant_chaos(tenants, tenancy_run, tenancy_wl)
    del tenants, tenancy_run, tenancy_wl
    torch.cuda.empty_cache()
    wt_launches, wt_codes_launches = phase_warm_start_trees(tree, X, y)
    del tree
    torch.cuda.empty_cache()
    hist_rows, codes_row = phase_hist_kernels(X, y, tree_Rs)
    phase_tree_cross_check(X, y)
    torch.cuda.empty_cache()
    ts_fit, ts_launches, ts_codes_launches = phase_tree_stream_fit(
        X, y, tree_acc)
    torch.cuda.empty_cache()
    tr_launches, tr_codes_launches = phase_stream_resume_trees(ts_fit, X, y)
    del ts_fit
    torch.cuda.empty_cache()
    stream_err = phase_tree_stream_hist_kernels(X, y)
    phase_tree_stream_cross_check(X, y)
    torch.cuda.empty_cache()
    mst_launches, mst_codes_launches, mst_row = phase_mesh_stream_trees(
        X, y, tree_acc)
    torch.cuda.empty_cache()
    split = regression_data()
    phase_reg_fit(split)
    torch.cuda.empty_cache()
    rf_launches, rf_codes_launches, rf_Rs = phase_rf_reg_fit(split)
    torch.cuda.empty_cache()
    reg_rows = phase_reg_hist_kernels(split, rf_Rs)
    phase_reg_tree_cross_check(split)
    torch.cuda.empty_cache()
    rs_launches, rs_codes_launches = phase_rf_reg_stream_fit(split)
    torch.cuda.empty_cache()
    rs_rows = phase_rf_reg_stream_hist_kernels(split)
    higgs = higgs_data()
    gbt_launches, gbt_codes_launches, gbt_chunks = phase_gbt_fit(higgs)
    torch.cuda.empty_cache()
    gbt_rows = phase_gbt_hist_kernels(higgs, max(gbt_chunks))
    phase_gbt_cross_check(higgs)
    mg_launches, mg_codes_launches, mg_row = phase_mesh_gbt(higgs)
    del higgs
    torch.cuda.empty_cache()
    mc_launches, mc_codes_launches = phase_gbt_multiclass_fit(X, y)
    torch.cuda.empty_cache()
    gr_launches, gr_codes_launches = phase_gbt_reg_fit(split)
    torch.cuda.empty_cache()
    ms_launches, ms_codes_launches = phase_mesh_gbt_small(X, y, split)
    torch.cuda.empty_cache()
    mlp_fit = phase_mlp_stream_fit()
    torch.cuda.empty_cache()
    phase_stream_resume_mlp(mlp_fit)
    del mlp_fit
    torch.cuda.empty_cache()
    phase_bootstrap_rejection()
    phase_mlp_device_check()
    phase_mesh_stream_mlp()
    phase_zoo_classifiers(X, y)
    phase_zoo_regressors(split)
    phase_zoo_streams(X, y, split)
    torch.cuda.empty_cache()
    phase_mesh_zoo(X, y, split)
    torch.cuda.empty_cache()
    mesh = phase_mesh(X, y, tree_acc)
    torch.cuda.empty_cache()
    mp = phase_multiprocess(X, y, mesh.pop("tree_ref"))
    del X, y
    torch.cuda.empty_cache()
    phase_readers()
    phase_criteo_stream()
    # each kernel's line reports the largest replica chunk (and, for the
    # histogram, config 3's deepest level in the fit's bf16 mode), where
    # its fit spends its kernel time; the phase lines hold every shape.
    # The histogram's bound is the function over one shared X read
    # through the replicas' column indices, what the fit asks of it. Its
    # and the bin codes' launches are every tree path's together (config
    # 3, the forest regressor, config 7's GBTs, the multiclass and
    # regressor GBTs, and the streamed config 3 and forest regressor),
    # and its max_abs_err is the largest of every checked table: the
    # in-memory paths', the streamed config 3's (int32, held bit for
    # bit) and the streamed forest regressor's (float, the fit's own
    # tables and the kernel's on their inputs). The growth and resume
    # paths count too: the logistic growth's Gram launches, the grown
    # trees' and the resumed tree stream's histogram and codes launches;
    # so do the online paths: the warm steps' and the anchor replay's
    # Gram launches, the drift loop's refit, the planes phase's refit
    # under the device profile, and the tenancy phase's five tenant fits
    # and its budgeted refits; so do the mesh phases' fits and streams,
    # launched in the shards' threads (their tables and Grams are held
    # too: config 3's on (2, 2), config 7's GBTs on (2, 2) and the small
    # GBTs on (2, 1), and config 3 streamed on (2, 2)), and the
    # multiprocess phase's 1-process headline and both children's fits,
    # launched in each child's own shards)
    f32 = rows[max(Rs)]["float32"]
    deepest = hist_rows[max(tree_Rs), 2 ** (TREE["max_depth"] - 1), "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "scaled_gram",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/scaled_gram.cu",
        "replaces": "spark_bagging_tpu/ops/gram.py:53",
        "launches": launches + warm_launches + online_launches
        + anchor_launches + loop_launches + planes_launches
        + tenancy_launches + mesh["scaled_gram"] + mp["scaled_gram"],
        # the headline fit's launches, and those of them the wgmma
        # design took (every one: the fit's Grams are fp32)
        "fit_launches": launches,
        "fit_wgmma_launches": fit_wgmma_launches,
        "max_abs_err": max(f32["max_abs_err"],
                           mesh["gram_row"]["max_abs_err"]),
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
        "launches": (tree_launches + rf_launches + gbt_launches
                     + mc_launches + gr_launches + ts_launches
                     + rs_launches + wt_launches + tr_launches
                     + mesh["binned_left_stats"] + mg_launches
                     + ms_launches + mst_launches
                     + mp["binned_left_stats"]),
        "max_abs_err": max(stream_err, mesh["hist_row"]["max_abs_err"],
                           mg_row["max_abs_err"], mst_row["max_abs_err"],
                           *(r["max_abs_err"] for r in (
            *hist_rows.values(), *reg_rows.values(), *rs_rows.values(),
            *gbt_rows.values()))),
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
        "launches": (codes_launches + rf_codes_launches + gbt_codes_launches
                     + mc_codes_launches + gr_codes_launches
                     + ts_codes_launches + rs_codes_launches
                     + wt_codes_launches + tr_codes_launches
                     + mesh["bin_codes"] + mg_codes_launches
                     + ms_codes_launches + mst_codes_launches
                     + mp["bin_codes"]),
        "max_abs_err": 0.0 if not codes_row["unequal"] else None,
        "ms": codes_row["kernel_ms"],
        "plain_ms": codes_row["plain_ms"],
        "bound_ms": codes_row["bound_ms"],
        "bound_by": codes_row["bound_by"],
        "library_ms": codes_row["library_ms"],
    }, {
        # the main path's launches (the headline bag's batch predict);
        # the times and the gap at the predict cell's shapes (1000
        # near-equal replicas, one launch), the gap on the means
        "name": "soft_vote",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/soft_vote.cu",
        "replaces": "spark_bagging_tpu/ensemble.py predict_ensemble_classifier "
                    "(XLA; no TPU kernel)",
        "launches": serve_launches,
        "max_abs_err": sv_row["max_mean_gap"],
        "ms": sv_row["kernel_ms"],
        "plain_ms": sv_row["plain_ms"],
        "bound_ms": sv_row["bound_ms"],
        "bound_by": sv_row["bound_by"],
        "library_ms": sv_row["library_ms"],
    }, {
        # config 3's batch predict: one launch a call; exact counts
        "name": "tree_vote",
        "route": "cuda",
        "source": "spark_bagging_tpu_torch/csrc/tree_vote.cu",
        "replaces": "spark_bagging_tpu/models/tree.py:566 _route and the "
                    "hard vote (XLA; no TPU kernel)",
        "launches": tv_row["launches_a_call"],
        "max_abs_err": 0.0 if tv_row["bitwise"] else None,
        "ms": tv_row["kernel_ms"],
        "plain_ms": tv_row["plain_ms"],
        "bound_ms": tv_row["bound_ms"],
        "bound_by": tv_row["bound_by"],
        "library_ms": tv_row["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
