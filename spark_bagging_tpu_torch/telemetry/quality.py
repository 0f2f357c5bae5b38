"""Model-quality plane: streaming drift detection over live traffic.

The serving counters watch the *system* — latency, captures, padding,
overloads — but are blind to the *model*: nothing says whether live
traffic still looks like the data the bag was fitted on, or whether
the ensemble still agrees with itself. This module is the model half,
in three pieces:

1. **Reference profile** (:class:`ReferenceProfile`) — a fixed-size,
   JSON-friendly summary of the training distribution computed at fit
   time (``bagging.py`` stores it as ``estimator.quality_profile_``
   and checkpoints round-trip it): per-feature decile bin edges +
   fractions, the encoded class distribution, a confidence histogram
   (populated from the OOB decision function when ``oob_score`` ran —
   the honest held-out confidence), and, for regressors, a target
   histogram. Memory is ``O(n_features × bins)`` floats — independent
   of training size (rows are strided down to ``max_rows`` for the
   quantile pass).

2. **Live sketches** (:class:`QualityMonitor`) — fixed-memory
   streaming state fed from the serving hot path
   (``EnsembleExecutor._forward_packed``, which underlies BOTH
   dispatch paths: the coalescing worker's ``forward_parts`` and the
   direct-dispatch inline serve) with host arrays only: the validated
   request rows and the outputs after their copy back from the card.
   Per feature: counts in the reference's bins (order-independent), a
   running moment sketch, and a P² quantile sketch (Jain & Chlamtac:
   five markers per quantile, O(1) memory and update) fed with a
   deterministic per-batch row stride. Per prediction: class counts and
   a confidence (max-probability) histogram with its own P² median.
   Total memory is ``O(n_features × bins)`` — a million served rows
   cost the same bytes as a thousand.

3. **Drift scores** — PSI (population stability index) and a binned
   KS statistic per feature against the reference, plus
   prediction-class and confidence PSI, recomputed every
   ``refresh_every`` rows and exported as ``sbt_quality_*`` gauges
   (per-feature series capped at ``export_feature_limit`` to bound
   scrape cardinality; the aggregates always export). The alert
   engine (:mod:`~spark_bagging_tpu_torch.telemetry.alerts`) rules over
   those gauges; :func:`debug_summary` is the digest the JAX package's
   exposition server serves at ``/debug/drift``.

**Ensemble disagreement** rides along: bagging's replica spread is a
free uncertainty signal the vote/mean aggregation throws away
(*Reproducible Model Selection Using Bagged Posteriors*, arXiv
2007.14845). The executor samples a configurable fraction of batches
through a per-replica-preserving forward (``model.replica_forward()``,
one CUDA graph per bucket on the card — counted in
``sbt_quality_disagreement_compiles_total``, NOT in
``sbt_serving_compiles_total``, so the zero-captures-after-warmup gate
is untouched) and feeds :func:`disagreement_stats` here. Served outputs
stay bitwise-identical: the tap is purely additional compute.

The port's copy of the JAX package's ``telemetry/quality.py`` (numpy
only, so the sketches, PSI, KS and profiles are bitwise the same).

Cost contract: **zero overhead when disabled**. No monitor attached
means the executor's gate is one attribute read (``self._quality is
None``); nothing in this module runs. Everything mutable in a monitor
sits behind one ``make_lock`` (the debug lock-order detector of
``analysis/locks.py`` sees it), and the only lock taken while holding
it is the telemetry registry's (quality → registry, the same direction
every exporter uses).
"""

from __future__ import annotations

import math
import time
import weakref
from typing import Any

import numpy as np

from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.telemetry.state import STATE

PROFILE_SCHEMA_VERSION = 1

#: Fraction floor for PSI smoothing: an empty bin contributes through
#: this epsilon instead of dividing by zero (standard PSI practice).
PSI_EPS = 1e-4

#: Fixed confidence-histogram bin count on [0, 1] — fixed (not
#: data-derived) so a profile saved without a confidence reference can
#: still gain one later from OOB scores with compatible edges.
CONFIDENCE_BINS = 20


# -- sketch primitives --------------------------------------------------

class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator: five markers,
    O(1) memory and per-update cost, no stored samples. Exact for the
    first five observations; afterwards the markers drift toward the
    target quantile via piecewise-parabolic interpolation. Order-
    dependent by construction — drift SCORES therefore come from the
    order-independent binned counts, and P² values are telemetry."""

    __slots__ = ("q", "_n", "_heights", "_pos", "_want")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        self.q = float(q)
        self._n = 0
        self._heights: list[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]

    def update(self, v: float) -> None:
        v = float(v)
        self._n += 1
        h = self._heights
        if len(h) < 5:
            h.append(v)
            h.sort()
            return
        # locate the cell; clamp outliers into the end markers
        if v < h[0]:
            h[0] = v
            k = 0
        elif v >= h[4]:
            h[4] = v
            k = 3
        else:
            k = 0
            while k < 3 and v >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        # desired positions are linear in n — rebuild from the formula
        n = float(self._n)
        self._want = [
            1.0,
            1 + (n - 1) * self.q / 2,
            1 + (n - 1) * self.q,
            1 + (n - 1) * (1 + self.q) / 2,
            n,
        ]
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1 and self._pos[i + 1] - self._pos[i] > 1) or (
                    d <= -1 and self._pos[i - 1] - self._pos[i] < -1):
                s = 1.0 if d >= 1 else -1.0
                hp = self._parabolic(i, s)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, s)
                h[i] = hp
                self._pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1])
        )

    def _linear(self, i: int, s: float) -> float:
        h, p = self._heights, self._pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (p[j] - p[i])

    def value(self) -> float:
        """Current estimate (exact below five samples; NaN when empty)."""
        h = self._heights
        if not h:
            return math.nan
        if len(h) < 5:
            srt = sorted(h)
            # nearest-rank on the exact small sample
            k = min(len(srt) - 1, int(self.q * len(srt)))
            return srt[k]
        return h[2]


class MomentSketch:
    """Vectorized running moments over ``d`` parallel streams: count,
    sum, sum of squares, min, max — one numpy op per batch, fixed
    memory."""

    __slots__ = ("count", "_sum", "_sumsq", "_min", "_max")

    def __init__(self, d: int) -> None:
        self.count = 0
        self._sum = np.zeros(d, np.float64)
        self._sumsq = np.zeros(d, np.float64)
        self._min: np.ndarray | None = None
        self._max: np.ndarray | None = None

    def update(self, X: np.ndarray) -> None:
        """Fold a ``(n, d)`` batch in."""
        X64 = X.astype(np.float64, copy=False)
        self.count += X.shape[0]
        self._sum += X64.sum(axis=0)
        self._sumsq += (X64 * X64).sum(axis=0)
        lo, hi = X64.min(axis=0), X64.max(axis=0)
        self._min = lo if self._min is None else np.minimum(self._min, lo)
        self._max = hi if self._max is None else np.maximum(self._max, hi)

    def mean(self) -> np.ndarray:
        if self.count == 0:
            return np.full_like(self._sum, np.nan)
        return self._sum / self.count

    def std(self) -> np.ndarray:
        if self.count == 0:
            return np.full_like(self._sum, np.nan)
        var = self._sumsq / self.count - self.mean() ** 2
        return np.sqrt(np.maximum(var, 0.0))


def bin_counts(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Counts of ``values`` in the ``len(edges)+1`` bins the internal
    ``edges`` cut the line into. ``side="right"`` on BOTH the reference
    fractions and the live counts, so PSI compares like with like."""
    idx = np.searchsorted(np.asarray(edges, np.float64),
                          np.asarray(values, np.float64), side="right")
    return np.bincount(idx, minlength=len(edges) + 1).astype(np.int64)


def psi(ref_fractions, live_counts) -> float:
    """Population stability index between a reference fraction vector
    and live bin counts (same binning). Zero when the live stream is
    empty — no evidence is not drift.

    Live fractions get add-half (Laplace) smoothing: with a raw
    epsilon floor, every not-yet-populated bin of a small live sample
    contributes ``≈ 0.1·ln(0.1/eps)`` of pure noise — a few hundred
    in-distribution rows scored PSI > 2 that way. Smoothing scales the
    empty-bin penalty with the evidence (``0.5/(n + k/2)``), so the
    score converges to the true PSI as rows accumulate instead of
    starting at a cliff. The reference side (a full training pass) only
    needs the :data:`PSI_EPS` floor against log-zero."""
    live_counts = np.asarray(live_counts, np.float64)
    total = live_counts.sum()
    if total <= 0:
        return 0.0
    k = len(live_counts)
    live = (live_counts + 0.5) / (total + 0.5 * k)
    ref = np.clip(np.asarray(ref_fractions, np.float64), PSI_EPS, None)
    ref /= ref.sum()
    return float(((live - ref) * np.log(live / ref)).sum())


def ks_stat(ref_fractions, live_counts) -> float:
    """Binned two-sample KS statistic: the max CDF gap at the shared
    bin edges (a lower bound on the continuous KS — honest for a
    fixed-memory sketch). Zero on an empty live stream."""
    live_counts = np.asarray(live_counts, np.float64)
    total = live_counts.sum()
    if total <= 0:
        return 0.0
    live = np.cumsum(live_counts / total)
    ref = np.cumsum(np.asarray(ref_fractions, np.float64))
    return float(np.abs(live - ref).max())


# -- the fit-time reference ---------------------------------------------

class ReferenceProfile:
    """What "normal" looked like at fit time — the drift comparand.

    Built by :meth:`from_training` (``bagging.py`` calls it at the end
    of every in-memory fit), serialized via :meth:`to_dict` into the
    checkpoint manifest (``utils/checkpoint.py``), so
    ``ModelRegistry.save()/load()`` round-trips it with the weights.
    """

    def __init__(
        self,
        *,
        task: str,
        n_features: int,
        feature_edges: list[list[float]],
        feature_fractions: list[list[float]],
        class_fractions: list[float] | None = None,
        confidence_fractions: list[float] | None = None,
        prediction_edges: list[float] | None = None,
        prediction_fractions: list[float] | None = None,
        n_rows: int = 0,
        confidence_source: str | None = None,
    ) -> None:
        if task not in ("classification", "regression"):
            raise ValueError(f"unknown task {task!r}")
        if len(feature_edges) != n_features or \
                len(feature_fractions) != n_features:
            raise ValueError(
                f"profile carries {len(feature_edges)} feature edge "
                f"vectors for n_features={n_features}"
            )
        self.task = task
        self.n_features = int(n_features)
        self.feature_edges = [
            [float(e) for e in edges] for edges in feature_edges
        ]
        self.feature_fractions = [
            [float(f) for f in fr] for fr in feature_fractions
        ]
        self.class_fractions = (
            None if class_fractions is None
            else [float(f) for f in class_fractions]
        )
        self.confidence_fractions = (
            None if confidence_fractions is None
            else [float(f) for f in confidence_fractions]
        )
        self.prediction_edges = (
            None if prediction_edges is None
            else [float(e) for e in prediction_edges]
        )
        self.prediction_fractions = (
            None if prediction_fractions is None
            else [float(f) for f in prediction_fractions]
        )
        self.n_rows = int(n_rows)
        self.confidence_source = confidence_source

    # the fixed confidence grid (see CONFIDENCE_BINS)
    @staticmethod
    def confidence_edges() -> np.ndarray:
        return np.linspace(0.0, 1.0, CONFIDENCE_BINS + 1)[1:-1]

    @classmethod
    def from_training(
        cls,
        X,
        y=None,
        *,
        task: str,
        n_classes: int | None = None,
        bins: int = 10,
        max_rows: int = 4096,
    ) -> "ReferenceProfile":
        """Summarize the training set: per-feature decile edges and
        fractions (rows strided down to ``max_rows`` for the quantile
        pass — deterministic, no RNG), the encoded class distribution
        (classification, from ``y``), and a target histogram
        (regression, from ``y``). The confidence reference starts
        empty; :meth:`set_confidence_reference` fills it from OOB
        scores when available."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        n, d = X.shape
        stride = max(1, -(-n // max_rows))  # ceil division
        Xs = np.asarray(X[::stride], np.float64)
        qs = np.arange(1, bins) / bins
        feature_edges: list[list[float]] = []
        feature_fractions: list[list[float]] = []
        for j in range(d):
            col = Xs[:, j]
            edges = np.quantile(col, qs)
            counts = bin_counts(col, edges)
            feature_edges.append([float(e) for e in edges])
            feature_fractions.append(
                [float(c) / len(col) for c in counts]
            )
        class_fractions = None
        prediction_edges = None
        prediction_fractions = None
        if y is not None:
            ys = np.asarray(y)
            if task == "classification":
                y_int = ys.astype(np.int64).ravel()
                c = int(n_classes if n_classes is not None
                        else y_int.max() + 1)
                counts = np.bincount(y_int, minlength=c)
                class_fractions = [
                    float(v) / len(y_int) for v in counts
                ]
            else:
                yf = ys.astype(np.float64).ravel()[::stride]
                edges = np.quantile(yf, qs)
                counts = bin_counts(yf, edges)
                prediction_edges = [float(e) for e in edges]
                prediction_fractions = [
                    float(c) / len(yf) for c in counts
                ]
        return cls(
            task=task, n_features=d,
            feature_edges=feature_edges,
            feature_fractions=feature_fractions,
            class_fractions=class_fractions,
            prediction_edges=prediction_edges,
            prediction_fractions=prediction_fractions,
            n_rows=n,
        )

    def set_confidence_reference(self, max_proba,
                                 source: str = "oob") -> None:
        """Install the held-out confidence histogram (per-row max
        probability — OOB decision-function rows when ``oob_score``
        ran: the honest estimate of served confidence)."""
        conf = np.asarray(max_proba, np.float64).ravel()
        conf = conf[np.isfinite(conf)]
        if conf.size == 0:
            return
        counts = bin_counts(conf, self.confidence_edges())
        self.confidence_fractions = [
            float(c) / conf.size for c in counts
        ]
        self.confidence_source = source

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": PROFILE_SCHEMA_VERSION,
            "task": self.task,
            "n_features": self.n_features,
            "n_rows": self.n_rows,
            "feature_edges": self.feature_edges,
            "feature_fractions": self.feature_fractions,
            "class_fractions": self.class_fractions,
            "confidence_fractions": self.confidence_fractions,
            "confidence_source": self.confidence_source,
            "prediction_edges": self.prediction_edges,
            "prediction_fractions": self.prediction_fractions,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ReferenceProfile":
        schema = d.get("schema")
        if schema != PROFILE_SCHEMA_VERSION:
            raise ValueError(
                f"quality profile schema {schema!r} not supported "
                f"(this build reads {PROFILE_SCHEMA_VERSION})"
            )
        return cls(
            task=d["task"], n_features=d["n_features"],
            feature_edges=d["feature_edges"],
            feature_fractions=d["feature_fractions"],
            class_fractions=d.get("class_fractions"),
            confidence_fractions=d.get("confidence_fractions"),
            prediction_edges=d.get("prediction_edges"),
            prediction_fractions=d.get("prediction_fractions"),
            n_rows=d.get("n_rows", 0),
            confidence_source=d.get("confidence_source"),
        )

    def __repr__(self) -> str:
        return (f"ReferenceProfile(task={self.task!r}, "
                f"n_features={self.n_features}, n_rows={self.n_rows})")


# -- disagreement -------------------------------------------------------

def disagreement_stats(rep_out: np.ndarray, task: str) -> dict[str, float]:
    """Ensemble-disagreement summary of one per-replica forward.

    ``rep_out`` is ``(R, n, C)`` per-replica probabilities
    (classification) or ``(R, n)`` per-replica predictions
    (regression). Classification disagreement is the mean fraction of
    replicas whose argmax differs from the soft-vote aggregate (the
    served answer); ``proba_std`` is the mean cross-replica std of the
    probabilities. Regression disagreement is the mean cross-replica
    prediction std (the bagged predictive spread)."""
    rep = np.asarray(rep_out, np.float64)
    if task == "classification":
        mean_proba = rep.mean(axis=0)            # (n, C) — the served agg
        agg = mean_proba.argmax(axis=-1)         # (n,)
        votes = rep.argmax(axis=-1)              # (R, n)
        agree = (votes == agg[None, :]).mean(axis=0)
        return {
            "disagreement": float(1.0 - agree.mean()),
            "proba_std": float(rep.std(axis=0).mean()),
            "rows": int(rep.shape[1]),
        }
    std = rep.std(axis=0)                        # (n,)
    return {
        "disagreement": float(std.mean()),
        "pred_std": float(std.mean()),
        "rows": int(rep.shape[1]),
    }


# -- the live monitor ---------------------------------------------------

# sbt-lint: shared-state
class QualityMonitor:
    """Streaming sketches + drift scores for one serving executor.

    Attach via :func:`attach` (sets ``executor._quality``); the
    executor feeds :meth:`observe_parts` from ``_forward_packed`` —
    the seam under BOTH dispatch paths — and consults
    :meth:`wants_disagreement` once per packed batch. All state sits
    behind one lock; concurrent feeders (the coalescing worker thread
    plus direct-dispatch caller threads) lose no updates.

    ``refresh_every`` rows between drift recomputations + gauge
    exports (1 = every observe — what a deterministic replay uses).
    ``disagreement_every`` samples every Nth packed batch through the
    per-replica forward (0 = never). ``min_rows`` is the
    evidence floor: until that many rows are sketched, the exported
    PSI/KS gauges read 0.0 — a ten-row histogram against ten reference
    bins scores PSI ≈ 0.5 of pure sampling noise, and an alert rule
    must not page on it (:meth:`drift` always reports the raw scores
    plus the ``warmed`` flag). ``labels`` scope every exported series
    (:func:`attach` derives ``{"model": <name>}`` for
    registry-registered executors): two monitors writing the SAME
    unlabeled series would clobber each other last-write-wins, and a
    healthy model's refreshes interleaving into the alert window
    would mask a drifting one forever — alert rules must name the
    matching ``labels``.
    """

    def __init__(
        self,
        profile: ReferenceProfile,
        *,
        refresh_every: int = 256,
        disagreement_every: int = 0,
        quantile_rows_per_batch: int = 1,
        export_feature_limit: int = 32,
        min_rows: int = 50,
        labels: dict[str, Any] | None = None,
    ) -> None:
        if refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1, got {refresh_every}"
            )
        if min_rows < 0:
            raise ValueError(f"min_rows must be >= 0, got {min_rows}")
        if disagreement_every < 0:
            raise ValueError(
                f"disagreement_every must be >= 0, got "
                f"{disagreement_every}"
            )
        self.profile = profile
        self.refresh_every = int(refresh_every)
        self.disagreement_every = int(disagreement_every)
        self.quantile_rows_per_batch = max(1, int(quantile_rows_per_batch))
        self.export_feature_limit = int(export_feature_limit)
        self.min_rows = int(min_rows)
        self.labels = dict(labels) if labels else None
        d = profile.n_features
        self._lock = make_lock("telemetry.quality")
        self._edges = [np.asarray(e, np.float64)
                       for e in profile.feature_edges]
        self._feat_counts = np.zeros(
            (d, len(profile.feature_fractions[0])), np.int64
        )
        self._moments = MomentSketch(d)
        self._feat_p50 = [P2Quantile(0.5) for _ in range(d)]
        n_classes = (len(profile.class_fractions)
                     if profile.class_fractions else 0)
        self._class_counts = np.zeros(max(n_classes, 1), np.int64)
        self._conf_counts = np.zeros(CONFIDENCE_BINS, np.int64)
        self._conf_p50 = P2Quantile(0.5)
        self._pred_counts = (
            np.zeros(len(profile.prediction_fractions), np.int64)
            if profile.prediction_fractions else None
        )
        self._pred_edges = (
            np.asarray(profile.prediction_edges, np.float64)
            if profile.prediction_edges else None
        )
        self._rows = 0
        self._since_refresh = 0
        self._batches = 0
        self._dis_sketch = MomentSketch(1)
        self._dis_samples = 0
        self._last_drift: dict[str, Any] | None = None
        self.t_attached = time.time()

    # -- hot-path feeds ------------------------------------------------

    def observe_parts(self, parts, outs) -> None:
        """Feed one packed batch: per-request feature blocks and their
        (already padding-sliced) outputs."""
        for X, out in zip(parts, outs):
            self.observe(X, out)

    def observe(self, X, out=None) -> None:
        """Fold one ``(n, d)`` feature block (and optionally its model
        output) into the sketches. Thread-safe; O(d·bins) per call."""
        X = np.asarray(X)
        n = X.shape[0]
        with self._lock:
            for j, edges in enumerate(self._edges):
                self._feat_counts[j] += bin_counts(X[:, j], edges)
            self._moments.update(X)
            # P² is per-scalar: feed a deterministic row stride so the
            # cost stays O(quantile_rows_per_batch · d) per batch
            step = max(1, n // self.quantile_rows_per_batch)
            for row in X[::step][:self.quantile_rows_per_batch]:
                for j, sk in enumerate(self._feat_p50):
                    sk.update(row[j])
            if out is not None:
                self._observe_output_locked(np.asarray(out))
            self._rows += n
            self._since_refresh += n
            if STATE.enabled:
                STATE.registry.inc("sbt_quality_rows_total", float(n),
                                   self.labels)
            if self._since_refresh >= self.refresh_every:
                self._refresh_locked()

    def _observe_output_locked(self, out: np.ndarray) -> None:
        if self.profile.task == "classification" and out.ndim == 2:
            cls = out.argmax(axis=1)
            counts = np.bincount(cls, minlength=len(self._class_counts))
            # sbt-lint: disable=shared-state-unlocked — the _locked suffix is the contract: every caller holds self._lock (observe())
            self._class_counts += counts[:len(self._class_counts)]
            conf = out.max(axis=1)
            # sbt-lint: disable=shared-state-unlocked — under self._lock (the _locked contract)
            self._conf_counts += bin_counts(
                conf, ReferenceProfile.confidence_edges()
            )
            step = max(1, len(conf) // self.quantile_rows_per_batch)
            for v in conf[::step][:self.quantile_rows_per_batch]:
                self._conf_p50.update(v)
        elif self._pred_counts is not None and out.ndim == 1:
            # sbt-lint: disable=shared-state-unlocked — under self._lock (the _locked contract)
            self._pred_counts += bin_counts(out, self._pred_edges)

    def wants_disagreement(self) -> bool:
        """Once per packed batch: should the executor run the
        per-replica tap for this one? Deterministic counter — the Nth,
        2Nth, ... batches sample."""
        if self.disagreement_every == 0:
            return False
        with self._lock:
            self._batches += 1
            return self._batches % self.disagreement_every == 0

    def observe_disagreement(self, rep_out, task: str) -> dict[str, float]:
        """Fold one per-replica forward's stats in; returns them."""
        stats = disagreement_stats(rep_out, task)
        with self._lock:
            self._dis_sketch.update(
                np.asarray([[stats["disagreement"]]])
            )
            self._dis_samples += 1
        if STATE.enabled:
            STATE.registry.inc("sbt_quality_disagreement_samples_total",
                               1.0, self.labels)
            STATE.registry.observe("sbt_quality_disagreement",
                                   stats["disagreement"], self.labels)
        return stats

    # -- drift math ----------------------------------------------------

    def drift(self) -> dict[str, Any]:
        """Current drift scores (always freshly computed)."""
        with self._lock:
            return self._drift_locked()

    def _drift_locked(self) -> dict[str, Any]:
        prof = self.profile
        feat_psi = [
            psi(prof.feature_fractions[j], self._feat_counts[j])
            for j in range(prof.n_features)
        ]
        feat_ks = [
            ks_stat(prof.feature_fractions[j], self._feat_counts[j])
            for j in range(prof.n_features)
        ]
        out: dict[str, Any] = {
            "rows": self._rows,
            "warmed": self._rows >= self.min_rows,
            "feature_psi": feat_psi,
            "feature_ks": feat_ks,
            "psi_max": max(feat_psi) if feat_psi else 0.0,
            "psi_mean": (sum(feat_psi) / len(feat_psi)
                         if feat_psi else 0.0),
            "ks_max": max(feat_ks) if feat_ks else 0.0,
        }
        if prof.class_fractions is not None:
            out["prediction_psi"] = psi(prof.class_fractions,
                                        self._class_counts)
        if prof.prediction_fractions is not None \
                and self._pred_counts is not None:
            out["prediction_psi"] = psi(prof.prediction_fractions,
                                        self._pred_counts)
        if prof.confidence_fractions is not None:
            out["confidence_psi"] = psi(prof.confidence_fractions,
                                        self._conf_counts)
        conf_p50 = self._conf_p50.value()
        if math.isfinite(conf_p50):
            out["confidence_p50"] = conf_p50
        if self._dis_samples:
            out["disagreement_mean"] = float(
                self._dis_sketch.mean()[0]
            )
            out["disagreement_samples"] = self._dis_samples
        return out

    def refresh(self) -> dict[str, Any]:
        """Recompute drift and export the gauges now (also runs
        automatically every ``refresh_every`` observed rows)."""
        with self._lock:
            return self._refresh_locked()

    def _refresh_locked(self) -> dict[str, Any]:
        # sbt-lint: disable=shared-state-unlocked — the _locked suffix is the contract: every caller holds self._lock
        self._since_refresh = 0
        drift = self._drift_locked()
        # sbt-lint: disable=shared-state-unlocked — under self._lock (the _locked contract)
        self._last_drift = drift
        if STATE.enabled:
            # lock order: quality -> registry (the exporter direction;
            # the registry never calls back into quality)
            reg = STATE.registry

            def gated(v: float) -> float:
                # below the evidence floor the gauges read 0.0 — the
                # alert plane must not see small-sample noise as drift
                return v if drift["warmed"] else 0.0

            lbl = self.labels
            reg.set("sbt_quality_psi_max", gated(drift["psi_max"]), lbl)
            reg.set("sbt_quality_psi_mean", gated(drift["psi_mean"]),
                    lbl)
            reg.set("sbt_quality_ks_max", gated(drift["ks_max"]), lbl)
            # signals this monitor cannot produce (no confidence
            # reference, no disagreement sampling) export 0.0 — "no
            # evidence of drift" — rather than being skipped: a skip
            # would FREEZE the previous monitor's value in the gauge,
            # and a re-attached model without that signal would keep a
            # stale breaching value alive under the alert rules
            reg.set("sbt_quality_prediction_psi",
                    gated(drift.get("prediction_psi", 0.0)), lbl)
            reg.set("sbt_quality_confidence_psi",
                    gated(drift.get("confidence_psi", 0.0)), lbl)
            reg.set("sbt_quality_confidence_p50",
                    drift.get("confidence_p50", 0.0), lbl)
            reg.set("sbt_quality_disagreement_mean",
                    drift.get("disagreement_mean", 0.0), lbl)
            # per-feature series are CAPPED, not all-or-nothing: the
            # first export_feature_limit features export (bounding
            # scrape cardinality for wide models), the rest stay
            # aggregate-only — summary() reports the split
            n_export = min(self.profile.n_features,
                           self.export_feature_limit)
            for j in range(n_export):
                labels = {**(lbl or {}), "feature": str(j)}
                reg.set("sbt_quality_feature_psi",
                        gated(drift["feature_psi"][j]), labels)
                reg.set("sbt_quality_feature_ks",
                        gated(drift["feature_ks"][j]), labels)
            reg.inc("sbt_quality_refresh_total", 1.0, lbl)
        return drift

    # -- introspection -------------------------------------------------

    def summary(self) -> dict[str, Any]:
        """JSON digest (one monitor's part of :func:`debug_summary`)."""
        with self._lock:
            last = self._last_drift
            feat_p50 = [sk.value() for sk in self._feat_p50]
            return {
                "labels": self.labels,
                "task": self.profile.task,
                "n_features": self.profile.n_features,
                "reference_rows": self.profile.n_rows,
                "confidence_source": self.profile.confidence_source,
                "rows_observed": self._rows,
                "batches": self._batches,
                "feature_series_exported": min(
                    self.profile.n_features, self.export_feature_limit
                ),
                "refresh_every": self.refresh_every,
                "disagreement_every": self.disagreement_every,
                "disagreement_samples": self._dis_samples,
                "feature_p50": [
                    v if math.isfinite(v) else None for v in feat_p50
                ],
                "feature_mean": [
                    v if math.isfinite(v) else None
                    for v in self._moments.mean().tolist()
                ],
                "drift": last,
                "t_attached": self.t_attached,
            }


# -- process-level attach registry --------------------------------------

_monitors_lock = make_lock("telemetry.quality.monitors")
_monitors: list[Any] = []  # weakrefs, pruned on read and insert


def attach(executor, *, profile=None, monitor: QualityMonitor | None = None,
           **monitor_opts: Any) -> QualityMonitor:
    """Attach a drift monitor to a serving executor's hot path.

    ``profile`` defaults to the executor's model's ``quality_profile_``
    (what ``fit()`` computes and checkpoints round-trip); pass a
    :class:`ReferenceProfile` (or its dict form) to override, or a
    ready ``monitor`` to install directly. Gauge ``labels`` default to
    ``{"model": executor.model_name}`` for registry-registered
    executors (anonymous executors export unlabeled) so two monitored
    models never clobber each other's series — point alert rules at
    the matching labels. The returned monitor is registered for
    :func:`debug_summary` (weakly — it dies with its executor) and exports
    its initial gauges immediately, so stale values from a previous
    monitor never leak into fresh rules.
    """
    if monitor is None:
        if "labels" not in monitor_opts:
            name = getattr(executor, "model_name", None)
            if name is not None:
                monitor_opts["labels"] = {"model": str(name)}
        if profile is None:
            profile = getattr(
                getattr(executor, "model", None), "quality_profile_", None
            )
            if profile is None:
                raise ValueError(
                    "executor's model carries no quality_profile_ "
                    "(fitted by an older build, or a stream fit); pass "
                    "profile= explicitly or rebuild with "
                    "ReferenceProfile.from_training"
                )
        if isinstance(profile, dict):
            profile = ReferenceProfile.from_dict(profile)
        monitor = QualityMonitor(profile, **monitor_opts)
    executor.attach_quality(monitor)
    if monitor.disagreement_every and hasattr(executor,
                                              "warmup_replica"):
        # pre-capture the per-replica graphs for every bucket the
        # serving forward already captured: the sampled batches must
        # never absorb a capture stall on the live serving thread
        # (later-captured buckets still build lazily)
        executor.warmup_replica()
    with _monitors_lock:
        _monitors[:] = [r for r in _monitors if r() is not None]
        _monitors.append(weakref.ref(monitor))
    monitor.refresh()
    return monitor


def monitors() -> list[QualityMonitor]:
    """Live attached monitors (dead ones pruned)."""
    with _monitors_lock:
        out = [r() for r in _monitors]
        _monitors[:] = [r for r, m in zip(_monitors, out)
                        if m is not None]
    return [m for m in out if m is not None]


def debug_summary() -> dict[str, Any]:
    """Every live monitor's summary (the JAX package's exposition
    server serves this at ``/debug/drift``)."""
    live = monitors()
    if not live:
        return {
            "monitors": [],
            "note": "no quality monitor attached; use "
                    "telemetry.quality.attach(executor) or "
                    "ModelRegistry.enable_quality(name)",
        }
    return {"monitors": [m.summary() for m in live]}
