"""The drift-triggered trainer daemon — the loop's supervisor.

``AlertEngine`` fires ``alert_fired``; this module turns that into a
published model version. One :class:`OnlineTrainer` watches one
registry entry and, per accepted trigger, runs the four-phase cycle —
each phase a named fault-injection hand-off point
(``trainer.drain`` / ``trainer.refit`` / ``trainer.validate`` /
``trainer.publish``, :mod:`spark_bagging_tpu_torch.faults`):

1. **drain** — consume the recent labeled traffic window from its
   :class:`LabeledBuffer` (the serving edge feeds it; labels arrive on
   whatever delay the application has) plus the
   ``WorkloadRecorder.drain()`` arrival bookkeeping;
2. **refit** — bounded update epochs of
   :class:`~spark_bagging_tpu_torch.online.updater.OnlineUpdater` steps over
   the drained batches (streaming Poisson weights, warm-started from
   the incumbent's stacked params, on the incumbent's device: on the
   card a logistic bag's Newton Hessians run the scaled-Gram kernel);
3. **validate** — the candidate's claim is the MIN of its streaming
   OOB estimate (honest prequential) and its end-state score on the
   drained window (the prequential average alone is blind to
   last-step degradation), compared against the incumbent scored on
   the SAME window; the candidate also gets a fresh
   :class:`~spark_bagging_tpu_torch.telemetry.quality.ReferenceProfile`
   fitted on the window (the drift comparand the post-swap monitor
   scores against — this is what makes the drift gauge RECOVER). A
   candidate scoring worse than the incumbent (beyond ``margin``) is
   rejected: counted, flight-recorded (``refit_rejected`` is a
   flight-recorder trigger kind), never published;
4. **publish** — ``registry.swap()`` (version bump, sticky quality
   monitor re-attach, warm bucket pre-capture) then
   ``registry.save()`` of the new version's checkpoint +
   ``serve_config.json`` manifest into ``publish_dir`` — the existing
   N-process seam: every peer polling that directory converges on the
   new version through its own ``registry.load()``.

**Supervision.** A refit that dies mid-flight (injected fault, OOM,
contract violation) is absorbed: counted
(``sbt_online_refit_errors_total``), transcribed, and the daemon
keeps serving triggers — a trainer crash must never take alerting or
serving down with it. **Determinism.** Stepped mode
(:meth:`run_pending`, the replay drill's drive) performs refits
synchronously on the caller's thread with an injectable clock, so the
whole refit transcript is a pure function of (workload, seed);
:meth:`start` runs the same cycle on a daemon thread for live
processes.

The port's copy of the JAX package's ``online/trainer.py``: the same
transcript, counters and fault sites; the published checkpoint is in
the JAX package's format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.online.updater import OnlineUpdater


# sbt-lint: shared-state
class LabeledBuffer:
    """Bounded reservoir of labeled traffic blocks — what refits drain.

    The serving edge calls :meth:`add` with feature blocks and their
    (possibly delayed) labels; memory is bounded by ``capacity_rows``
    with oldest blocks evicted whole (the trainer wants the RECENT
    window — the traffic that tripped the alert — so eviction is the
    policy, not a loss)."""

    def __init__(self, *, capacity_rows: int = 65536,
                 labels: dict[str, Any] | None = None) -> None:
        if capacity_rows < 1:
            raise ValueError(
                f"capacity_rows must be >= 1, got {capacity_rows}"
            )
        self.capacity_rows = int(capacity_rows)
        # per-model gauge labels: two buffers in one process (the
        # multi-model registry case) must not clobber one shared series
        self.labels = dict(labels) if labels else None
        self._lock = make_lock("online.buffer")
        self._blocks: deque[tuple[np.ndarray, np.ndarray]] = deque()
        self._rows = 0
        self._dropped = 0
        self._seen = 0

    def add(self, X, y) -> None:
        # copies, never references: a serving edge reusing one
        # preallocated request buffer must not mutate rows already
        # banked here, and a small slice must not pin its whole base
        # array past eviction (the capacity bound is a BYTES bound)
        X = np.array(X, np.float32, copy=True)
        y = np.array(y, copy=True)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        if y.shape[0] != X.shape[0]:
            raise ValueError("X and y row counts differ")
        with self._lock:
            self._blocks.append((X, y))
            self._rows += X.shape[0]
            self._seen += X.shape[0]
            while self._rows > self.capacity_rows and len(self._blocks) > 1:
                old_X, _ = self._blocks.popleft()
                self._rows -= old_X.shape[0]
                self._dropped += old_X.shape[0]
        if telemetry.enabled():
            telemetry.set_gauge("sbt_online_buffer_rows",
                                float(self.rows), labels=self.labels)

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    @property
    def rows_seen(self) -> int:
        """Monotonic total of rows ever added (evictions included) —
        the trainer's post-trigger collection watermark."""
        with self._lock:
            return self._seen

    @property
    def dropped_rows(self) -> int:
        with self._lock:
            return self._dropped

    def drain(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Consume everything buffered as one concatenated ``(X, y)``
        (arrival order preserved — the updater's determinism contract
        is 'same example order'); None when empty. The next window
        starts from an empty buffer."""
        with self._lock:
            blocks = list(self._blocks)
            self._blocks.clear()
            self._rows = 0
        if not blocks:
            return None
        X = np.concatenate([b[0] for b in blocks], axis=0)
        y = np.concatenate([b[1] for b in blocks], axis=0)
        if telemetry.enabled():
            telemetry.set_gauge("sbt_online_buffer_rows", 0.0,
                                labels=self.labels)
        return X, y


# sbt-lint: shared-state
class OnlineTrainer:
    """One registry entry's drift-triggered refit daemon (module doc).

    ``trigger_rules`` filters which alert rules trigger a refit (None
    = every ``alert_fired``); ``margin`` is the validation slack — the
    candidate publishes when ``candidate >= incumbent - margin`` on
    the drained window (scores are accuracy for classifiers, R² for
    regressors); ``epochs``/``batch_rows`` bound the refit;
    ``publish_dir`` (optional) receives the published version's
    checkpoint + ``serve_config.json`` manifest for fleet-peer
    ``load()`` convergence."""

    def __init__(
        self,
        registry: Any,
        model_name: str,
        buffer: LabeledBuffer,
        *,
        workload_recorder: Any | None = None,
        epochs: int = 1,
        batch_rows: int = 256,
        min_refit_rows: int = 32,
        collect_rows: int = 0,
        margin: float = 0.0,
        seed: int | None = None,
        publish_dir: str | None = None,
        save_executables: bool = False,
        trigger_rules: tuple[str, ...] | None = None,
        refit_budget: Any | None = None,
        updater_opts: dict[str, Any] | None = None,
    ) -> None:
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        if batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        if min_refit_rows < 1:
            raise ValueError(
                f"min_refit_rows must be >= 1, got {min_refit_rows}"
            )
        if collect_rows < 0:
            raise ValueError(
                f"collect_rows must be >= 0, got {collect_rows}"
            )
        if margin < 0:
            raise ValueError(f"margin must be >= 0, got {margin}")
        registry.executor(model_name)  # fail fast on unknown names
        self.registry = registry
        self.model_name = str(model_name)
        self.buffer = buffer
        self.workload_recorder = workload_recorder
        self.epochs = int(epochs)
        self.batch_rows = int(batch_rows)
        self.min_refit_rows = int(min_refit_rows)
        self.collect_rows = int(collect_rows)
        self.margin = float(margin)
        self.seed = seed
        self.publish_dir = publish_dir
        self.save_executables = bool(save_executables)
        # per-model series labels (the multi-model process case:
        # two trainers must not merge their refit counters)
        self._labels = {"model": self.model_name}
        self.trigger_rules = (tuple(trigger_rules)
                              if trigger_rules is not None else None)
        # per-tenant refit budgeting: a ``now -> bool`` hook
        # (``tenancy.RefitBudgeter.for_tenant``) consulted at
        # TRIGGER time — a denied trigger is dropped (counted), never
        # queued, so one drifting hot tenant cannot monopolize the
        # fleet's refit compute while the tail's alerts rot in a queue
        if refit_budget is not None and not callable(refit_budget):
            raise ValueError("refit_budget must be callable (now -> bool)")
        self.refit_budget = refit_budget
        self.budget_denied = 0
        self.updater_opts = dict(updater_opts or {})
        self._lock = make_lock("online.trainer")
        self._pending: deque[dict] = deque()
        self._wake = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.transcript: list[dict] = []
        self.triggered = 0
        self.published = 0
        self.rejected = 0
        self.skipped = 0
        self.errors = 0

    # -- the trigger bus (AlertEngine.subscribe target) -----------------

    def on_alert(self, event: dict) -> None:
        """Alert-engine listener: accept matching ``alert_fired``
        events as refit triggers (resolutions pass through)."""
        if event.get("kind") != "alert_fired":
            return
        rule = event.get("rule")
        if self.trigger_rules is not None \
                and rule not in self.trigger_rules:
            return
        self.trigger(reason=str(rule), now=event.get("now"))

    def trigger(self, *, reason: str = "manual",
                now: float | None = None) -> None:
        """Enqueue one refit trigger (the manual/operator entry).

        With ``collect_rows > 0`` the trigger is not SERVICEABLE until
        that many fresh labeled rows arrive after it — the post-change
        window: a drift alert marks a distribution change-point, so
        rows buffered BEFORE it are the old distribution, and a refit
        (plus the candidate's reference profile) built on them would
        adapt to a mixture instead of the regime the model must serve
        next. Sizing ``collect_rows`` to the buffer capacity makes the
        drained window exactly the post-trigger traffic.

        With a ``refit_budget`` hook installed, the budget decides
        HERE: a denied trigger is dropped and counted
        (``sbt_online_refits_budget_denied_total{model=}``) — the next
        drift alert re-triggers, by which time the budget window may
        have turned."""
        if self.refit_budget is not None and not self.refit_budget(now):
            with self._lock:
                self.budget_denied += 1
            telemetry.inc("sbt_online_refits_budget_denied_total",
                          labels=self._labels)
            return
        ready_at = (self.buffer.rows_seen + self.collect_rows
                    if self.collect_rows else 0)
        with self._lock:
            self._pending.append({"reason": reason, "now": now,
                                  "ready_at": ready_at})
            self._wake.notify_all()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _pop_ready(self) -> dict | None:
        """Dequeue the head trigger iff its collection watermark is
        met (FIFO: a not-yet-ready head also holds younger triggers,
        preserving incident order)."""
        seen = self.buffer.rows_seen
        with self._lock:
            if not self._pending:
                return None
            if self._pending[0].get("ready_at", 0) > seen:
                return None
            return self._pending.popleft()

    # -- stepped processing (the deterministic drive) -------------------

    def run_pending(self, now: float | None = None) -> list[dict]:
        """Process every queued trigger synchronously on THIS thread;
        returns the transcript records produced. The replay drill's
        drive: triggers enqueued by the alert engine's virtual-clock
        evaluation are refit here, inside the same window iteration,
        so the whole cycle is a pure function of (workload, seed)."""
        out: list[dict] = []
        while True:
            trig = self._pop_ready()
            if trig is None:
                break
            out.append(self._supervised_refit(trig, now))
        return out

    # -- daemon mode ----------------------------------------------------

    def start(self) -> "OnlineTrainer":
        """Run the cycle on a daemon thread (live processes; the
        stepped :meth:`run_pending` is the deterministic twin)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="online-trainer", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopping = True
            self._wake.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)

    def _loop(self) -> None:
        while True:
            trig = self._pop_ready()
            if trig is None:
                with self._lock:
                    if self._stopping:
                        return
                    # short timeout, not pure wakeups: a collecting
                    # trigger becomes ready when the BUFFER fills, and
                    # the buffer has no handle on this condition
                    self._wake.wait(timeout=0.1)
                    if self._stopping:
                        return
                continue
            self._supervised_refit(trig, None)

    # -- the refit cycle ------------------------------------------------

    def _supervised_refit(self, trig: dict, now: float | None) -> dict:
        """One supervised cycle: a refit that dies is absorbed (counted,
        transcribed), never propagated into the trigger bus or the
        daemon loop."""
        t0 = time.perf_counter()
        with self._lock:
            self.triggered += 1
        telemetry.inc("sbt_online_refits_triggered_total",
                      labels=self._labels)
        record: dict[str, Any] = {
            "trigger": trig.get("reason"),
            "now": trig.get("now") if now is None else now,
        }
        try:
            self._refit(record)
        except Exception as e:  # noqa: BLE001 — supervision, see above
            with self._lock:
                self.errors += 1
            telemetry.inc("sbt_online_refit_errors_total",
                      labels=self._labels)
            record["action"] = "error"
            record["error"] = repr(e)
            telemetry.emit_event({
                "kind": "refit_error", "model": self.model_name,
                "error": repr(e),
            })
        wall = time.perf_counter() - t0
        record["seconds"] = round(wall, 6)
        telemetry.observe("sbt_online_refit_seconds", wall,
                          labels=self._labels)
        with self._lock:
            self.transcript.append(record)
        return record

    def _refit(self, record: dict) -> None:
        # -- drain ------------------------------------------------------
        if faults.ACTIVE is not None:
            faults.fire("trainer.drain")
        # the evidence check comes BEFORE any drain: a trigger that
        # arrives while labels are still in flight (the documented
        # delayed-label case) must leave the buffer AND the recorder
        # window accumulating toward the threshold — the rule cooldown
        # means no second trigger comes for this incident, so draining
        # here would permanently discard the incident's labeled rows
        have = self.buffer.rows
        if have < self.min_refit_rows:
            with self._lock:
                self.skipped += 1
            telemetry.inc("sbt_online_refits_skipped_total",
                      labels=self._labels)
            record["action"] = "skipped"
            record["buffered_rows"] = have
            record["note"] = (
                f"{have} labeled rows < min_refit_rows="
                f"{self.min_refit_rows} (window retained)"
            )
            return
        drained = self.buffer.drain()
        if self.workload_recorder is not None:
            window = self.workload_recorder.drain()
            record["window_requests"] = len(window)
            record["window_rows"] = sum(r.rows for r in window)
        X, y = drained
        record["drained_rows"] = int(X.shape[0])

        # -- refit ------------------------------------------------------
        incumbent = self.registry.model(self.model_name)
        # the refit ordinal folds into the updater seed: a fresh
        # updater restarts its step counter at 0, so refit k reusing
        # the bare seed would redraw refit 0's exact Poisson streams
        # (the same replicas OOB-scoring the same batch positions,
        # every incident) — correlated resampling the _ONLINE_STREAM
        # independence story forbids. triggered is incremented before
        # _refit runs, so the first refit keeps the bare seed (ordinal
        # 0) and every later one moves the stream; still a pure
        # function of (seed, trigger order), so a replay stays
        # deterministic.
        with self._lock:
            ordinal = self.triggered - 1
        base_seed = (self.seed if self.seed is not None
                     else int(getattr(incumbent, "seed", 0)))
        updater = OnlineUpdater(
            incumbent, seed=base_seed + ordinal,
            labels={"model": self.model_name}, **self.updater_opts,
        )
        n = X.shape[0]
        # batch bounds with a small tail FOLDED into the previous
        # step: each step converges the solvers toward its own batch's
        # weighted optimum, so a stray sub-half-batch tail would
        # dominate the candidate's end state out of proportion to the
        # evidence it carries
        bounds = list(range(0, n, self.batch_rows)) + [n]
        if len(bounds) > 2 and bounds[-1] - bounds[-2] < self.batch_rows // 2:
            del bounds[-2]
        updates = 0
        oob_first_epoch: float | None = None
        for epoch in range(self.epochs):
            if faults.ACTIVE is not None:
                faults.fire("trainer.refit")
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                updater.partial_fit(X[lo:hi], y[lo:hi])
                updates += 1
            if epoch == 0:
                # only the FIRST epoch's OOB votes are honest for
                # validation: from epoch 2 on, every replica has
                # already trained on the re-presented rows, so later
                # votes are in-sample and inflate the estimate
                oob_first_epoch = updater.oob_estimate()
        record["epochs"] = self.epochs
        record["updates"] = updates
        record["oob_estimate"] = oob_first_epoch

        # -- validate ---------------------------------------------------
        if faults.ACTIVE is not None:
            faults.fire("trainer.validate")
        candidate = updater.to_estimator()
        # overwrite the updater's running all-epoch estimate with the
        # honest first-epoch value the validation gate uses: anything
        # reading the attribute off the served model must not see the
        # in-sample-inflated later-epoch votes
        candidate.online_oob_estimate_ = oob_first_epoch
        candidate.quality_profile_ = self._window_profile(
            incumbent, X, y
        )
        incumbent_score = self._score(incumbent, X, y)
        # two candidate scores, BOTH must clear the margin: the
        # FIRST-epoch streaming OOB estimate (honest prequential —
        # no row scored by a replica that already trained on it) and
        # the candidate's END-STATE score on the drained window. The
        # OOB average alone is blind to last-step degradation (a
        # candidate that drifted onto its final batch still carries
        # the healthy early steps in the average); the window score
        # alone is in-sample. The min of the two is the published
        # claim.
        window_score = self._score(candidate, X, y)
        oob = oob_first_epoch
        cand_score = (window_score if oob is None
                      else min(oob, window_score))
        record["incumbent_score"] = incumbent_score
        record["candidate_window_score"] = window_score
        record["candidate_score"] = cand_score
        if cand_score < incumbent_score - self.margin:
            with self._lock:
                self.rejected += 1
            telemetry.inc("sbt_online_refits_rejected_total",
                      labels=self._labels)
            record["action"] = "rejected"
            # a flight-recorder trigger kind: a refit that produced a
            # WORSE model is an incident (bad labels, a broken window)
            # worth a black box, even though nothing was published
            telemetry.emit_event({
                "kind": "refit_rejected", "model": self.model_name,
                "candidate_score": cand_score,
                "incumbent_score": incumbent_score,
                "margin": self.margin,
            })
            return

        # -- publish ----------------------------------------------------
        if faults.ACTIVE is not None:
            faults.fire("trainer.publish")
        new_ex = self.registry.swap(self.model_name, candidate)
        version = int(new_ex.model_version)
        record["action"] = "published"
        record["version"] = version
        with self._lock:
            self.published += 1
        telemetry.inc("sbt_online_refits_published_total",
                      labels=self._labels)
        telemetry.emit_event({
            "kind": "refit_published", "model": self.model_name,
            "version": version,
            "candidate_score": cand_score,
            "incumbent_score": incumbent_score,
        })
        if self.publish_dir is not None:
            # the manifest write gets its own failure domain: the swap
            # above already published LOCALLY, so a dead save() must
            # not let supervision relabel the cycle "error" (split
            # brain: version 2 serving here while the transcript and
            # counters claim no publish happened). The partial state
            # is transcribed distinctly — manifest_version None +
            # manifest_error — which also fails the drill's
            # fleet-convergence check, the honest verdict.
            try:
                self.registry.save(self.model_name, self.publish_dir,
                                   executables=self.save_executables)
                record["manifest_version"] = self._manifest_version()
            except Exception as e:  # noqa: BLE001 — local publish
                # stands; fleet manifest did not
                record["manifest_version"] = None
                record["manifest_error"] = repr(e)
                import warnings

                warnings.warn(
                    f"refit of {self.model_name!r} published locally "
                    f"(version {version}) but the fleet manifest "
                    f"write to {self.publish_dir!r} failed: {e!r} — "
                    "peers will not converge until a save succeeds",
                    RuntimeWarning,
                    stacklevel=3,
                )

    # -- helpers --------------------------------------------------------

    @staticmethod
    def _window_profile(incumbent, X: np.ndarray, y: np.ndarray):
        """The candidate's fit-time reference, computed on the drained
        window: the post-swap monitor scores live traffic against THIS
        — a candidate adapted to the new distribution must also be
        judged against it, which is what lets the drift gauge recover
        instead of paging forever on the old reference."""
        from spark_bagging_tpu_torch.telemetry.quality import ReferenceProfile

        task = incumbent.task
        return ReferenceProfile.from_training(
            X, y, task=task,
            n_classes=(int(incumbent.n_classes_)
                       if task == "classification" else None),
        )

    @staticmethod
    def _score(estimator, X: np.ndarray, y: np.ndarray) -> float:
        """Window score: accuracy (classification) / R² (regression) —
        the same functionals the batch OOB machinery reports."""
        from spark_bagging_tpu_torch.utils.metrics import accuracy, r2_score

        if estimator.task == "classification":
            return float(accuracy(
                np.asarray(y), np.asarray(estimator.predict(X))
            ))
        return float(r2_score(
            np.asarray(y, np.float64),
            np.asarray(estimator.predict(X), np.float64),
        ))

    def _manifest_version(self) -> int | None:
        """The version the just-written manifest carries — what a
        fleet peer's ``load()`` will converge on (reported in the
        transcript so the drill can assert manifest == live). The
        filename comes from the registry's own constant so a manifest
        rename cannot silently strand this reader."""
        manifest = getattr(type(self.registry), "SERVE_CONFIG",
                           "serve_config.json")
        path = os.path.join(self.publish_dir, manifest)
        try:
            with open(path) as f:
                v = json.load(f).get("version")
            return int(v) if isinstance(v, int) else None
        except (OSError, ValueError):
            return None

    # -- introspection --------------------------------------------------

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "model": self.model_name,
                "triggered": self.triggered,
                "published": self.published,
                "rejected": self.rejected,
                "skipped": self.skipped,
                "budget_denied": self.budget_denied,
                "errors": self.errors,
                "pending": len(self._pending),
                "transcript": list(self.transcript),
            }
