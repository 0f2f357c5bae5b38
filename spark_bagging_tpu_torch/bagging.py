"""``BaggingClassifier`` and ``BaggingRegressor``: the user-facing estimators.

The same parameters, fitted state and sklearn protocol (``fit`` /
``predict_proba`` / ``predict`` / ``score`` / ``get_params``) as the JAX
package's estimators, on one device. ``_BaseBagging`` holds what both
tasks share: validation, the fit engine, OOB, the replica chunk, the
per-replica accessors (``base_learner_``, ``replica_params``,
``estimators_features_``, ``replica_weights``), the forward handles
(``aggregated_forward``, ``replica_forward``) and ``from_jax_arrays``.
The fitted state keeps the JAX layout: ``ensemble_`` (``{"W": (R, d+1,
C)}`` for logistic regression, ``{"beta": (R, d+1)}`` for linear
regression; ``feature``, ``threshold``, ``gain`` and ``leaf_logp`` or
``leaf_value`` for trees) and ``subspaces_`` ``(R, n_subspace)`` int32,
as tensors on the estimator's device.

``fit_stream`` fits out of core from a chunk source (utils/io.py) or an
``(X, y)`` pair: SGD learners (``streamable``) by Adam over the chunks
(streaming.py), trees by the multi-pass level-synchronous engine
(tree_stream.py); the ``*_stream`` predicts and scores read a source
chunk by chunk. A ``uses_aux`` learner (the survival learner) takes its
per-row aux column as ``BaggingRegressor.fit(X, y, aux=)`` or as the
streamed column ``aux_col``, which the stream predicts then drop from a
source one column wider than the fit (``drop_aux_col``).

``save``/``load`` write and read the JAX package's checkpoint format
(utils/checkpoint.py): a checkpoint saved by either package loads in
the other.

``warm_start=True`` grows a fitted ensemble: replica streams are keyed
by (seed, id), so fitting ids ``[R_old, R_new)`` and splicing them after
the old replicas is the cold fit of ``R_new`` (``_warm_start_from``
refuses whatever would break that). ``fit_stream`` snapshots and
resumes (``checkpoint_dir``, ``checkpoint_every``, ``resume_from``) in
the JAX package's snapshot format.

``device`` defaults to ``"cuda"`` and raises where CUDA is absent;
``device="cpu"`` must be asked for. ``mesh`` (``parallel.make_mesh``)
shards the fit, predicts and OOB over a ``(data, replica)`` mesh
(``parallel/sharded.py``); the mesh's devices then replace ``device``.
A mesh-fitted estimator's serving handles refuse, as in the JAX package
(serve it through ``EnsembleExecutor(model, mesh=...)`` after loading
it without a mesh). Every learner family fits on replica, data and 2-D
meshes, in memory and through ``fit_stream``. A mesh made after
``parallel.initialize_distributed`` spans processes: every process
calls the same fit with the same data, places only its shards
(``parallel.multihost.global_put``) and gathers the fitted state whole
(``multihost.to_host``), so each process holds the same ensemble.

Telemetry (one attribute read each while unarmed): the fit's spans
``h2d``, ``fit``, ``aggregate`` and ``oob``, ``sbt_h2d_bytes_total``
(by process) and ``sbt_oob_evaluations_total`` (by mode), as in the JAX
package.
"""

from __future__ import annotations

import numbers
import time
from contextlib import closing

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.ensemble import (
    classifier_forward,
    classifier_replica_forward,
    fit_ensemble,
    oob_predict_scores,
    regressor_forward,
    regressor_replica_forward,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.linear import LinearRegression
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights
from spark_bagging_tpu_torch.parallel.distributed import process_index
from spark_bagging_tpu_torch.parallel.multihost import (
    is_multiprocess_mesh,
    to_host,
    to_local,
)
from spark_bagging_tpu_torch.utils.device import resolve_device, synchronize
from spark_bagging_tpu_torch.utils.metrics import accuracy, r2_score
from spark_bagging_tpu_torch.utils.params import ParamsMixin


def clear_compiled_caches() -> int:
    """Drop every batch-predict program from the process's program cache
    (``serving/program_cache.py``); serving programs stay. The port runs
    its batch forwards eagerly, so a batch program holds no compiled
    code, only its place in the cache: the next predict at a row count
    simply misses and records a new one. Returns the number dropped."""
    from spark_bagging_tpu_torch.serving import program_cache as _pc

    return _pc.cache().drop_batch_programs()


class _EncodedChunks:
    """Label-encoding view over a chunk source: raw labels to class
    indices chunk by chunk (the streamed ``np.unique`` encode of
    ``BaggingClassifier.fit``)."""

    def __init__(self, inner, classes: np.ndarray):
        self._inner = inner
        self._classes = classes
        self.n_features = inner.n_features
        self.n_rows = inner.n_rows
        self.chunk_rows = inner.chunk_rows

    @property
    def n_chunks(self) -> int:
        return self._inner.n_chunks

    def chunks(self):
        return self.chunks_from(0)

    def chunks_from(self, start: int):
        for X, y, n_valid in self._inner.chunks_from(start):
            idx = np.searchsorted(self._classes, y)
            idx_c = np.minimum(idx, len(self._classes) - 1)
            bad = self._classes[idx_c[:n_valid]] != y[:n_valid]
            if bad.any():
                raise ValueError(
                    f"stream contains labels not in classes: "
                    f"{np.unique(np.asarray(y[:n_valid])[bad])[:5]}"
                )
            yield X, idx_c, n_valid


class _BaseBagging(ParamsMixin):
    """What both estimators share: validation, the fit engine, OOB,
    the replica accessors and the forward handles."""

    task: str
    _default_learner: type

    def __init__(
        self,
        base_learner: BaseLearner | None = None,
        n_estimators: int = 10,
        max_samples: float | int = 1.0,
        bootstrap: bool = True,
        max_features: float | int = 1.0,
        bootstrap_features: bool = False,
        oob_score: bool = False,
        seed: int = 0,
        chunk_size: int | None = None,
        mesh=None,
        warm_start: bool = False,
        device: str = "cuda",
    ):
        self.base_learner = base_learner
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.bootstrap_features = bootstrap_features
        self.oob_score = oob_score
        self.seed = seed
        self.chunk_size = chunk_size
        self.mesh = mesh
        self.warm_start = warm_start
        self.device = device
        if mesh is None:
            resolve_device(device)

    # -- sklearn interop -----------------------------------------------

    def __sklearn_tags__(self):
        """Estimator tags for sklearn >= 1.6 (``Pipeline`` and
        ``GridSearchCV`` query them); sklearn is imported only when
        sklearn itself calls this."""
        from sklearn.utils import (
            ClassifierTags,
            RegressorTags,
            Tags,
            TargetTags,
        )

        classifier = self.task == "classification"
        return Tags(
            estimator_type="classifier" if classifier else "regressor",
            target_tags=TargetTags(required=True),
            classifier_tags=ClassifierTags() if classifier else None,
            regressor_tags=None if classifier else RegressorTags(),
        )

    def __sklearn_is_fitted__(self) -> bool:
        return hasattr(self, "ensemble_")

    # -- helpers -------------------------------------------------------

    def _learner(self) -> BaseLearner:
        """The base learner to fit; a subclass may build it from its own
        parameters (the random forests build their tree)."""
        learner = self.base_learner or self._default_learner()
        if learner.task != self.task:
            raise ValueError(
                f"{type(learner).__name__} is a {learner.task} learner; "
                f"{type(self).__name__} needs {self.task}"
            )
        return learner

    def _sample_ratio(self, n_rows: int) -> float:
        """``max_samples`` as a Poisson rate: a float is the rate, an int
        an expected sample count (rate ``max_samples / n_rows``)."""
        ms = self.max_samples
        if isinstance(ms, bool) or not isinstance(ms, numbers.Real):
            raise ValueError(f"max_samples must be int or float, got {ms!r}")
        if isinstance(ms, numbers.Integral):
            ms = int(ms)
            if not 1 <= ms <= n_rows:
                raise ValueError(
                    f"int max_samples must be in [1, {n_rows}], got {ms}"
                )
            return ms / n_rows
        ms = float(ms)
        if not 0.0 < ms <= 1.0:
            raise ValueError(f"float max_samples must be in (0, 1], got {ms}")
        return ms

    def _n_subspace(self, n_features: int) -> int:
        if isinstance(self.max_features, float):
            return max(1, min(n_features,
                              round(self.max_features * n_features)))
        return max(1, min(n_features, int(self.max_features)))

    def _mesh_layout(self):
        """The mesh-shape signature that keys per-shard weight streams
        (None unmeshed); snapshotted at fit time and required unchanged
        by warm_start."""
        if self.mesh is None:
            return None
        return tuple(sorted(self.mesh.shape.items()))

    def _check_mesh(self) -> None:
        if self.mesh is not None:
            from spark_bagging_tpu_torch.parallel.mesh import Mesh

            if not isinstance(self.mesh, Mesh):
                raise TypeError(
                    f"mesh must be a parallel.make_mesh() Mesh, got "
                    f"{type(self.mesh).__name__}")

    def _home_device(self) -> torch.device:
        """Where the fitted state lives: on a mesh this process's first
        device (the mesh's first device in one process), else
        ``device``."""
        if self.mesh is not None:
            return self.mesh.home_device
        return resolve_device(self.device)

    def _eff_chunk(self) -> int | None:
        """The replica chunk of predict and OOB: the caller's
        ``chunk_size``, else the one the fit resolved."""
        if self.chunk_size is not None:
            return self.chunk_size
        return getattr(self, "_chunk_resolved", None)

    def _validate_X(self, X, device: torch.device,
                    fitted: bool = False) -> torch.Tensor:
        """X as a 2-D float32 tensor on ``device``; a fitted estimator
        also checks its feature count."""
        if isinstance(X, torch.Tensor):
            X = X.to(device=device, dtype=torch.float32)
        else:
            X = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if X.dim() != 2:
            raise ValueError(f"X must be 2-D, got shape {tuple(X.shape)}")
        if fitted and X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; the ensemble was fitted on "
                f"{self.n_features_in_}"
            )
        return X

    def _check_fitted(self) -> None:
        if not hasattr(self, "ensemble_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted; call fit(X, y) first"
            )

    def _check_replica(self, i: int) -> None:
        self._check_fitted()
        if not 0 <= i < self.n_estimators_:
            raise IndexError(
                f"replica {i} out of range [0, {self.n_estimators_})"
            )

    @staticmethod
    def _labels(y) -> np.ndarray:
        """``y`` as a 1-D array (a column vector is taken as one)."""
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        return y

    def _start_fit(self, X) -> tuple[torch.Tensor, torch.device, float,
                                     np.ndarray]:
        """X on the device, with the seconds the copy took (the ``h2d``
        span), and X on the host (the caller's array itself where it
        already is float32 numpy; pulled back only when the caller handed
        a CUDA tensor) for the quality profile. On a mesh X stays on the
        host: the fit pads it there and places each shard once
        (``_mesh_place``, which times that copy)."""
        self._check_mesh()
        if isinstance(X, torch.Tensor):
            X_host = X.detach().cpu().numpy()
        else:
            X = X_host = np.asarray(X, np.float32)  # converted once
        if self.mesh is not None:
            host = torch.device("cpu")
            return self._validate_X(X, host), host, None, X_host
        device = self._home_device()
        t0 = time.perf_counter()
        with telemetry.span("h2d"):
            X = self._validate_X(X, device)
            synchronize(device)
        h2d_seconds = time.perf_counter() - t0
        telemetry.inc("sbt_h2d_bytes_total",
                      float(X.numel() * X.element_size()),
                      labels={"process": process_index()})
        return X, device, h2d_seconds, X_host

    # -- warm start ----------------------------------------------------

    @staticmethod
    def _row_vector_digest(arr) -> str | None:
        """A small stable digest of a per-row vector (``sample_weight``,
        ``aux``) for the warm-start check; keeping the vectors would
        double the fit's memory."""
        if arr is None:
            return None
        import hashlib

        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(arr, np.float32))
        return hashlib.sha1(a.tobytes()).hexdigest()

    def _warm_start_from(self, X, learner, sample_weight=None,
                         aux=None) -> int:
        """Validate a warm start and return the first NEW replica id.

        Replica streams are keyed by (seed, id), so fitting ids
        ``[R_old, R_new)`` and splicing them after the old replicas
        reproduces exactly the cold fit of the larger ensemble, provided
        nothing that shapes the streams changed: every such input that
        did not freeze at the first fit is checked here, in the JAX
        package's order and with its messages."""
        from spark_bagging_tpu_torch.streaming import learner_fingerprint

        if self.n_estimators < self.n_estimators_:
            raise ValueError(
                f"warm_start cannot shrink the ensemble "
                f"({self.n_estimators_} -> {self.n_estimators})"
            )
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"warm_start X has {X.shape[1]} features; fitted on "
                f"{self.n_features_in_}"
            )
        # the fit-time snapshot, never the (mutable) fitted instance: a
        # missing snapshot is a mismatch
        if learner_fingerprint(learner) != getattr(
                self, "_fitted_learner_fp", None):
            raise ValueError(
                "warm_start requires the same base learner "
                "hyperparameters as the original fit (set_params on "
                "the base learner after fit changes them; ensembles "
                "fitted before the fingerprint existed cannot extend)"
            )
        if prng.key(self.seed).tolist() != self._fit_key.cpu().tolist():
            raise ValueError(
                "warm_start requires the original seed: old replicas "
                "drew from it, and OOB replays every replica's stream "
                "from one key"
            )
        if (self._sample_ratio(X.shape[0]),
                bool(self.bootstrap)) != self._fit_sampling:
            raise ValueError(
                "warm_start requires unchanged max_samples/bootstrap "
                "(an int max_samples resolves against the CURRENT row "
                "count \u2014 a different-sized X changes the rate)"
            )
        if getattr(self, "_fit_subspace_cfg", None) is None:
            raise ValueError(
                "warm_start requires an in-session in-memory fit to "
                "extend (stream-fitted or checkpoint-loaded ensembles "
                "use different replica streams)"
            )
        # the pooled pre-pass gate keys on the TOTAL ensemble size:
        # growing across its threshold would start the new replicas
        # from another init than the cold fit gave them
        new_gate = bool(learner.uses_pooled_init
                        and learner.pooled_amortizes(int(self.n_estimators)))
        if new_gate != getattr(self, "_fit_pooled_gate", new_gate):
            raise ValueError(
                "warm_start would change the pooled-init decision: the "
                f"original fit {'ran' if self._fit_pooled_gate else 'skipped'} "
                "the pooled pre-pass (amortization gate on ensemble "
                f"size), but the grown ensemble would "
                f"{'run' if new_gate else 'skip'} it \u2014 refit from "
                "scratch, or pin the behavior with init='zeros'"
            )
        fit_rows = getattr(self, "_fit_n_rows", None)
        if fit_rows is not None and X.shape[0] != fit_rows:
            raise ValueError(
                "warm_start requires the same row count as the "
                "original fit: old replicas drew (and OOB/"
                "replica_weights replay) per-row weight streams over "
                f"{fit_rows} rows, got {X.shape[0]}"
            )
        if (self._n_subspace(X.shape[1]),
                bool(self.bootstrap_features)) != self._fit_subspace_cfg:
            raise ValueError(
                "warm_start requires unchanged max_features/"
                "bootstrap_features"
            )
        if self._mesh_layout() != getattr(self, "_fit_mesh_layout", None):
            raise ValueError(
                "warm_start requires the original mesh layout: "
                "data-sharded replicas draw per-shard weight streams "
                "(fold_in(key, shard)), so a changed mesh would splice "
                "replicas from different stream families and silently "
                "corrupt OOB replay"
            )
        if self._row_vector_digest(sample_weight) != getattr(
                self, "_fit_sw_digest", None):
            raise ValueError(
                "warm_start requires the same sample_weight as the "
                "original fit (pass it again, identically)"
            )
        if self._row_vector_digest(aux) != getattr(
                self, "_fit_aux_digest", None):
            raise ValueError(
                "warm_start requires the same aux column as the "
                "original fit (pass it again, identically)"
            )
        return self.n_estimators_

    def _warm_start_id(self, X, sample_weight=None, aux=None) -> int:
        """The first replica id this fit draws: 0 for a fresh fit, the
        fitted ensemble's size for a warm start (``_warm_start_from``)."""
        if not (self.warm_start and hasattr(self, "ensemble_")):
            return 0
        return self._warm_start_from(X, self._learner(),
                                     sample_weight=sample_weight, aux=aux)

    def _nothing_to_grow(self, id_start: int) -> bool:
        """A warm start at the fitted size refits nothing (with a
        warning, as the JAX package does)."""
        if id_start == 0 or id_start != self.n_estimators:
            return False
        import warnings

        warnings.warn(
            "warm_start fit without increasing n_estimators: "
            "nothing refit (OOB state unchanged)", UserWarning,
        )
        return True

    # -- fit -----------------------------------------------------------

    def _fit_engine(self, X, y, n_outputs, device, h2d_seconds,
                    sample_weight=None, aux=None, id_start: int = 0,
                    host_xy=None) -> None:
        from spark_bagging_tpu_torch.streaming import learner_fingerprint
        from spark_bagging_tpu_torch.utils.memory import auto_chunk_size

        if self.n_estimators < 1:
            raise ValueError("n_estimators must be >= 1")
        n_rows, n_features = (int(s) for s in X.shape)
        if y.shape[0] != n_rows:
            raise ValueError("X and y row counts differ")
        ratio = self._sample_ratio(n_rows)
        if self.oob_score and not self.bootstrap and ratio >= 1.0:
            raise ValueError(
                "oob_score requires out-of-bag rows: use bootstrap=True or "
                "max_samples < 1.0"
            )
        row_mask = None
        if sample_weight is not None:
            sw = np.asarray(sample_weight, np.float32)
            if sw.shape != (n_rows,):
                raise ValueError(
                    f"sample_weight shape {sw.shape} != ({n_rows},)"
                )
            if (sw < 0).any():
                raise ValueError("sample_weight must be non-negative")
            if not (sw > 0).any():
                raise ValueError("sample_weight is all-zero")
            row_mask = torch.as_tensor(sw, device=device)
        learner = self._learner()
        n_subspace = self._n_subspace(n_features)
        key = prng.key(self.seed, device)
        n_new = self.n_estimators - id_start
        ids = torch.arange(id_start, self.n_estimators, dtype=torch.int64,
                           device=device)
        # the pooled pre-pass gate keys on the TOTAL ensemble size, so a
        # warm-grown ensemble decides as the cold fit it reproduces
        use_pooled = bool(
            learner.uses_pooled_init
            and learner.pooled_amortizes(int(self.n_estimators))
        )
        chunk_size = self.chunk_size
        if chunk_size is None:
            chunk_size = self._auto_chunk(
                learner, n_rows, n_subspace, n_outputs, n_new, device,
                n_features)
        self._chunk_resolved = chunk_size
        self._batch_programs = {}  # the last fit's, keyed to its weights
        common = dict(sample_ratio=ratio, bootstrap=bool(self.bootstrap),
                      n_subspace=n_subspace,
                      bootstrap_features=bool(self.bootstrap_features),
                      chunk_size=chunk_size, use_pooled_init=use_pooled)
        if self.mesh is not None:
            from spark_bagging_tpu_torch.parallel.sharded import sharded_fit

            (Xp, yp, mask, auxp), h2d_seconds = self._mesh_place(
                X, y, row_mask, aux)
        t0 = time.perf_counter()
        with telemetry.span("fit", n_replicas=n_new):
            if self.mesh is not None:
                params, subspaces, fit_aux = sharded_fit(
                    learner, self.mesh, Xp, yp, mask, key, n_new, n_outputs,
                    id_offset=id_start, aux=auxp, **common)
            else:
                params, subspaces, fit_aux = fit_ensemble(
                    learner, X, y, key, ids, n_outputs, row_mask=row_mask,
                    aux=aux, **common)
            # the completion barrier (a gather over the processes of a
            # process-spanning mesh)
            losses = to_host(fit_aux["loss"])
        fit_seconds = time.perf_counter() - t0
        device = self._home_device()
        key = key.to(device)
        params, subspaces = to_local((params, subspaces), device)
        if id_start > 0:
            # warm start: the new replicas after the old, on the device
            params = {k: torch.cat([self.ensemble_[k], v])
                      for k, v in params.items()}
            subspaces = torch.cat([self.subspaces_, subspaces])
        self.ensemble_ = params
        self.subspaces_ = subspaces
        self.n_features_in_ = n_features
        self.n_estimators_ = int(self.n_estimators)
        self._fit_key = key
        self._fit_n_rows = n_rows
        self._fitted_learner = learner
        # the hyperparameters as a snapshot, not the mutable instance
        self._fitted_learner_fp = learner_fingerprint(learner)
        self._fit_sampling = (ratio, bool(self.bootstrap))
        self._fit_subspace_cfg = (n_subspace, bool(self.bootstrap_features))
        self._fit_mesh_layout = self._mesh_layout()
        # a data-sharded fit folds the shard into each weight draw, so
        # no global weight vector replays (replica_weights refuses)
        self._fit_weights_replayable = not (
            self.mesh is not None and self.mesh.shape["data"] > 1)
        self._fit_sw_digest = self._row_vector_digest(sample_weight)
        self._fit_aux_digest = self._row_vector_digest(aux)
        self._fit_pooled_gate = use_pooled
        self._identity_subspace = (
            n_subspace == n_features and not self.bootstrap_features
        )
        # an earlier stream fit's aux column does not apply to this fit
        self._stream_aux_col = None
        self._device = device
        extra = {"warm_started_from": id_start} if id_start > 0 else {}
        if self.mesh is not None:
            extra["n_devices"] = int(self.mesh.size)
        # aggregate: the per-replica losses folded into the fit report
        with telemetry.span("aggregate", n_replicas=n_new):
            self._write_report(
                fit_seconds, h2d_seconds, losses, n_rows, n_features,
                n_subspace,
                learner.flops_per_fit(n_rows, n_subspace, n_outputs),
                chunk_size_resolved=chunk_size, n_replicas=n_new, **extra)
        self._fit_quality_profile(host_xy, n_outputs)

    def _auto_chunk(self, learner, n_rows, n_subspace, n_outputs, n_new,
                    device, n_features):
        """The fit's replica chunk when ``chunk_size`` is None. On a mesh
        a shard fits ``n_rows / data`` rows and ``n_new / replica``
        replicas, and shards that share a device share its memory. On a
        mesh that spans processes every process takes the smallest of
        their chunks (a collective): a chunk sets the shapes of the
        shards' psums, which must be one in every process, and each
        process reads its own free memory."""
        from spark_bagging_tpu_torch.utils.memory import (
            auto_chunk_size,
            device_memory_budget,
        )

        budget = None
        if self.mesh is not None:
            data, replica = self.mesh.shape["data"], self.mesh.shape["replica"]
            devs = self.mesh.local_devices
            device = self.mesh.home_device
            budget = device_memory_budget(device) / max(
                devs.count(d) for d in devs)
            n_rows = -(-n_rows // data)
            n_new = max(1, n_new // replica)
        chunk = auto_chunk_size(
            learner, n_rows, n_subspace, n_outputs, n_new, device,
            budget_bytes=budget, n_features=n_features,
            bootstrap_features=self.bootstrap_features,
        )
        if is_multiprocess_mesh(self.mesh):
            import torch.distributed as dist

            chunks: list = [None] * dist.get_world_size()
            dist.all_gather_object(chunks, chunk)
            # None (every replica in one chunk) is the largest chunk
            known = [c for c in chunks if c is not None]
            chunk = min(known) if known else None
        return chunk

    def _mesh_place(self, X, y, row_mask, aux):
        """The mesh fit's one host-to-device copy: rows padded on the host
        to the data axis (padding carries zero weight; ``sample_weight``
        rides the mask), then each of this process's shards placed once
        (``global_put``), under the ``h2d`` span. Returns the placed
        ``(X, y, mask, aux)`` and the seconds the copy took."""
        from spark_bagging_tpu_torch.parallel.compat import P
        from spark_bagging_tpu_torch.parallel.multihost import global_put
        from spark_bagging_tpu_torch.parallel.sharded import pad_rows

        mesh = self.mesh
        Xp, yp, mask = pad_rows(X, y, mesh.shape["data"])
        pad = Xp.shape[0] - X.shape[0]
        if row_mask is not None:
            mask = mask * torch.cat([row_mask.cpu(), torch.zeros(pad)])
        if aux is not None and pad:
            aux = torch.cat([aux.cpu(), torch.zeros(pad, dtype=aux.dtype)])
        t0 = time.perf_counter()
        with telemetry.span("h2d"):
            rows = P("data")
            placed = (global_put(Xp, mesh, P("data", None)),
                      global_put(yp, mesh, rows), global_put(mask, mesh, rows),
                      None if aux is None else global_put(aux, mesh, rows))
            for dev in set(mesh.local_devices):
                synchronize(dev)
        return placed, time.perf_counter() - t0

    def _fit_quality_profile(self, host_xy, n_outputs: int) -> None:
        """The fit-time quality reference (``telemetry/quality.py``): the
        drift comparand the serving monitors score live traffic against.
        Fixed-size (per-feature decile histograms over a strided row
        subsample + the label distribution), checkpointed with the
        weights, and best-effort — a profiling failure must never fail
        the fit it describes. ``host_xy`` is the fit's ``(X, y)`` as the
        host arrays the fit copied to the device (``y`` encoded for a
        classifier): nothing is read back from the card."""
        self.quality_profile_ = None
        try:
            from spark_bagging_tpu_torch import telemetry
            from spark_bagging_tpu_torch.telemetry.quality import (
                ReferenceProfile,
            )

            Xh, yh = host_xy
            with telemetry.span("quality_profile"):
                self.quality_profile_ = ReferenceProfile.from_training(
                    Xh, yh, task=self.task,
                    n_classes=(n_outputs if self.task == "classification"
                               else None),
                )
        except Exception as e:  # noqa: BLE001 — monitoring is optional
            import warnings

            warnings.warn(
                f"quality reference profile not computed: {e!r} "
                "(drift monitoring unavailable for this model)",
                RuntimeWarning,
                stacklevel=3,
            )

    def _write_report(self, fit_seconds, h2d_seconds, losses, n_rows,
                      n_features, n_subspace, flops, flops_seconds=None,
                      n_replicas=None, compile_seconds=0.0,
                      **extra) -> None:
        """``fit_report_``: throughput, losses and shapes of the fit, with
        the JAX package's keys; ``flops_seconds`` (default
        ``fit_seconds``) is the time the achieved TFLOP/s divides by;
        ``n_replicas`` (default the whole ensemble) the replicas this call
        fitted. As in the JAX package, a fit with no host-to-device copy
        (``h2d_seconds`` None: a stream) has no end-to-end rate, and a
        stream fit (``flops`` None: no cost model, or a resumed tree
        stream) no FLOP figures. ``compile_seconds``: an in-memory fit
        compiles nothing (eager execution); a stream passes its first
        step's seconds, where the JAX package compiles."""
        from spark_bagging_tpu_torch.utils.profiling import device_peak_tflops

        n = self.n_estimators_ if n_replicas is None else n_replicas
        report = {
            "n_replicas": n,
            "fit_seconds": fit_seconds,
            "fits_per_sec": n / fit_seconds if fit_seconds > 0 else float("inf"),
            "compile_seconds": compile_seconds,
            "h2d_seconds": h2d_seconds,
            "loss_mean": float(losses.mean()),
            "loss_std": float(losses.std()),
            "n_rows": n_rows,
            "n_features": n_features,
            "n_subspace": n_subspace,
            "backend": self._device.type,
            "n_devices": 1,
        }
        if h2d_seconds is not None:
            e2e = fit_seconds + h2d_seconds
            report["fits_per_sec_e2e"] = n / e2e if e2e > 0 else float("inf")
        if flops is not None or h2d_seconds is not None:
            flops_seconds = flops_seconds or fit_seconds
            achieved = (flops * n / flops_seconds / 1e12
                        if flops and flops_seconds > 0 else None)
            peak = device_peak_tflops(self._device)
            report.update({
                "model_flops_per_fit": flops,
                "achieved_tflops": achieved,
                # against the peak of the fit's one device (the JAX
                # package divides by the summed peak of its devices);
                # None without a known peak, as on the CPU
                "peak_tflops_bf16": peak,
                "mfu": (achieved / peak if achieved is not None and peak
                        else None),
            })
        # a registry-backed view: its numeric entries are sbt_fit_<key>
        # gauges (telemetry.record_fit_report)
        self.fit_report_ = telemetry.record_fit_report({**report, **extra})

    # -- out-of-core fit -----------------------------------------------

    def _reject_stream_options(self) -> None:
        """Refuse what the streamed fit cannot do: a mesh that is not a
        ``parallel.make_mesh()`` one, and extending an ensemble (its
        chunk-keyed replica streams are not the in-memory fit's, so a
        ``warm_start=True`` estimator that is fitted raises, as in the
        JAX package)."""
        self._check_mesh()
        if self.warm_start and hasattr(self, "ensemble_"):
            raise ValueError(
                "warm_start cannot extend an ensemble via fit_stream "
                "(stream fits use chunk-keyed replica streams): grow "
                "with fit(), or set warm_start=False to refit from "
                "scratch"
            )

    def _fit_stream_engine(self, source, n_outputs: int, *, n_epochs: int,
                           steps_per_chunk: int, lr: float,
                           prefetch: int | None = None,
                           checkpoint_dir: str | None = None,
                           checkpoint_every: int = 0,
                           resume_from: str | None = None,
                           aux_col: int | None = None) -> None:
        """Out-of-core fit over a chunk source: tree learners through the
        multi-pass level-synchronous engine (a snapshot at every pass
        boundary; ``checkpoint_every`` does not apply), ``streamable``
        learners by Adam over the chunks."""
        from spark_bagging_tpu_torch.streaming import (
            fit_ensemble_stream,
            learner_fingerprint,
        )
        from spark_bagging_tpu_torch.tree_stream import (
            fit_tree_ensemble_stream,
        )
        from spark_bagging_tpu_torch.utils.prefetch import (
            PrefetchChunks,
            worth_prefetching,
        )

        if prefetch is None:
            # a background producer only where a spare host core can
            # run it; an explicit int forces the choice, 0 disables
            prefetch = 2 if worth_prefetching() else 0
        if prefetch and not isinstance(source, PrefetchChunks):
            source = PrefetchChunks(source, prefetch)
        if self.n_estimators < 1:
            raise ValueError("n_estimators must be >= 1")
        # a stream fit computes no quality reference (the data never
        # sits in memory to profile); a stale profile from a previous
        # in-memory fit must not describe THIS model's training data
        self.quality_profile_ = None
        ratio = self._sample_ratio(int(source.n_rows))
        if self.oob_score and not self.bootstrap and ratio >= 1.0:
            raise ValueError(
                "oob_score requires out-of-bag rows: use bootstrap=True or "
                "max_samples < 1.0"
            )
        learner = self._learner()
        tree_stream = getattr(learner, "tree_streamable", False)
        if self.oob_score and is_multiprocess_mesh(self.mesh):
            # each process's OOB pass would feed only its own chunks
            raise ValueError(
                "oob_score with fit_stream is single-process only"
            )
        if (self.oob_score and tree_stream and self.mesh is not None
                and self.mesh.shape["data"] > 1):
            # the OOB pass replays the global chunk-keyed draws; a
            # data-sharded tree stream folds the shard into its draws
            raise ValueError(
                "oob_score cannot replay a data-sharded tree "
                "stream's per-shard draws; use a replica-only mesh "
                "or drop oob_score"
            )
        device = self._home_device()
        # aux_col: one streamed column is the aux channel, not a feature
        n_feat_data = source.n_features - (1 if aux_col is not None else 0)
        n_subspace = self._n_subspace(n_feat_data)
        key = prng.key(self.seed, device)
        common = dict(sample_ratio=ratio, bootstrap=bool(self.bootstrap),
                      n_subspace=n_subspace,
                      bootstrap_features=bool(self.bootstrap_features),
                      mesh=self.mesh)
        t0 = time.perf_counter()
        if tree_stream:
            if aux_col is not None:
                raise ValueError(
                    "aux_col applies to SGD-streamable uses_aux "
                    "learners; tree streams carry no aux channel"
                )
            if n_epochs != 1 or steps_per_chunk != 1:
                raise ValueError(
                    "n_epochs/steps_per_chunk are SGD-stream knobs; a "
                    "streamed tree fit always makes max_depth + 2 "
                    "passes — drop them for tree learners"
                )
            params, subspaces, aux = fit_tree_ensemble_stream(
                learner, source, key, self.n_estimators, n_outputs,
                checkpoint_dir=checkpoint_dir, resume_from=resume_from,
                **common)
        else:
            params, subspaces, aux = fit_ensemble_stream(
                learner, source, key, self.n_estimators, n_outputs,
                n_epochs=n_epochs, steps_per_chunk=steps_per_chunk, lr=lr,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume_from=resume_from,
                aux_col=aux_col, **common)
        losses = aux["loss"].cpu().numpy()  # completion barrier
        fit_seconds = time.perf_counter() - t0
        self.ensemble_ = params
        self.subspaces_ = subspaces
        self.n_features_in_ = int(n_feat_data)
        self.n_estimators_ = int(self.n_estimators)
        self._fit_key = key
        # per-chunk weight draws: no global weight vector to replay
        self._fit_n_rows = None
        self._fitted_learner = learner
        self._fitted_learner_fp = learner_fingerprint(learner)
        self._stream_aux_col = aux_col
        self._fit_sampling = (ratio, bool(self.bootstrap))
        # chunk-keyed replica streams: not extendable by the in-memory
        # warm start (its guard keys on _fit_subspace_cfg)
        self._fit_subspace_cfg = None
        self._fit_pooled_gate = False  # streams run no pooled pre-pass
        self._fit_sw_digest = None
        self._fit_aux_digest = None
        # an earlier in-memory fit's chunk must not size this fit's maps,
        # nor its batch programs outlive its weights
        self._chunk_resolved = None
        self._batch_programs = {}
        self._identity_subspace = (
            n_subspace == n_feat_data and not self.bootstrap_features
        )
        self._device = device
        # FLOPs: the tree stream does the in-memory fit's contractions
        # (a resumed one skips finished passes: no figure); the SGD
        # stream counts the optimizer steps this call made. The first
        # step, which builds the kernels, is kept out of the rate
        if "n_passes" in aux:
            flops = (learner.flops_per_fit(int(source.n_rows), n_subspace,
                                           n_outputs)
                     if resume_from is None else None)
            extra = {"n_passes": aux["n_passes"]}
        else:
            per_step = learner.sgd_step_flops(aux["chunk_rows"], n_subspace,
                                              n_outputs)
            flops = (per_step * aux["opt_steps"]
                     if per_step is not None else None)
            extra = {"opt_steps": aux["opt_steps"]}
        if self.mesh is not None:
            extra["n_devices"] = int(self.mesh.size)
        first = aux["first_step_seconds"] or 0.0
        self._write_report(
            fit_seconds, None, losses, int(source.n_rows), int(n_feat_data),
            n_subspace, flops, flops_seconds=max(fit_seconds - first, 1e-9),
            compile_seconds=aux["first_step_seconds"],
            n_chunks=aux["n_chunks"], n_epochs=aux["n_epochs"], **extra)

    def _stream_chunks(self, source, chunk_rows=None,
                       prefetch: int | None = None,
                       drop_aux_col: bool | None = None):
        """The validated chunk source of the streamed predicts and
        scores (any chunk source, or an ``(X, y)`` pair); labels ride
        along where they are not needed. A model stream-fitted with an
        aux column scores its own training source: the column is
        dropped where the source is one column wider than the fit
        (``drop_aux_col`` None: with a warning; True or False force
        it), inside a caller's prefetch wrap if there is one."""
        from spark_bagging_tpu_torch.utils.io import (
            DropColumnChunks,
            as_chunk_source,
        )
        from spark_bagging_tpu_torch.utils.prefetch import (
            PrefetchChunks,
            worth_prefetching,
        )

        self._check_fitted()
        already_wrapped = isinstance(source, PrefetchChunks)
        source = as_chunk_source(source, chunk_rows)
        aux_col = getattr(self, "_stream_aux_col", None)
        if (aux_col is not None and drop_aux_col is not False
                and source.n_features == self.n_features_in_ + 1):
            if drop_aux_col is None:
                import warnings

                warnings.warn(
                    f"source is one column wider than the fit; dropping "
                    f"column {aux_col} as the aux channel the model was "
                    "stream-fitted with (pass drop_aux_col=False if this "
                    "is a different dataset, or drop_aux_col=True to "
                    "silence)", stacklevel=3)
            if already_wrapped:
                source = source.rewrap(
                    lambda inner: DropColumnChunks(inner, aux_col))
            else:
                source = DropColumnChunks(source, aux_col)
        elif drop_aux_col:
            raise ValueError(
                "drop_aux_col=True but the model was not stream-fitted "
                "with an aux column" if aux_col is None else
                f"drop_aux_col=True needs a source with "
                f"{self.n_features_in_ + 1} columns (fitted features + "
                f"aux), got {source.n_features}"
            )
        if source.n_features != self.n_features_in_:
            raise ValueError(
                f"source has {source.n_features} features; the ensemble "
                f"was fitted on {self.n_features_in_}"
            )
        if prefetch is None:
            prefetch = 2 if worth_prefetching() else 0
        if already_wrapped or not prefetch:
            return source
        return PrefetchChunks(source, prefetch)

    def _oob_scores_stream(self, source, n_classes: int | None):
        """Streamed OOB: one more pass regenerating each replica's
        chunk-keyed membership; ``(agg, votes, y)`` in stream order."""
        from spark_bagging_tpu_torch.streaming import oob_scores_stream

        ratio, replacement = self._fit_sampling
        telemetry.inc("sbt_oob_evaluations_total",
                      labels={"mode": "stream"})
        return oob_scores_stream(
            self._fitted_learner, source, self._fit_key,
            self.ensemble_, self.subspaces_, self.n_estimators_,
            sample_ratio=ratio, bootstrap=replacement,
            n_classes=n_classes, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
            aux_col=getattr(self, "_stream_aux_col", None),
        )

    # -- OOB -----------------------------------------------------------

    def _oob_scores(self, X, n_classes):
        """OOB aggregate and per-row vote counts, as numpy (rows with no
        vote are the caller's to exclude). On a mesh the rows are padded
        as at fit time, so each shard replays its draws."""
        ratio, replacement = self._fit_sampling
        telemetry.inc("sbt_oob_evaluations_total",
                      labels={"mode": "memory"})
        with telemetry.span("oob", n_replicas=self.n_estimators_):
            if self.mesh is not None:
                from spark_bagging_tpu_torch.parallel.sharded import (
                    sharded_oob_scores,
                )

                n = X.shape[0]
                agg, votes = sharded_oob_scores(
                    self._fitted_learner, self.mesh, self.ensemble_,
                    self.subspaces_, self._mesh_rows(X), self._fit_key,
                    self.n_estimators_, sample_ratio=ratio,
                    bootstrap=replacement, n_classes=n_classes,
                    chunk_size=self._eff_chunk(),
                    identity_subspace=self._identity_subspace,
                )
                return to_host(agg)[:n], to_host(votes)[:n]
            agg, votes = oob_predict_scores(
                self._fitted_learner, self.ensemble_, self.subspaces_, X,
                self._fit_key,
                torch.arange(self.n_estimators_, dtype=torch.int64,
                             device=X.device),
                sample_ratio=ratio, bootstrap=replacement,
                n_classes=n_classes, chunk_size=self._eff_chunk(),
                identity_subspace=self._identity_subspace,
            )
            # sbt-lint: disable=host-sync-in-span — one-shot OOB result materialization (offline scoring, not a serving path)
            return agg.cpu().numpy(), votes.cpu().numpy()

    # -- the fitted replicas -------------------------------------------

    @property
    def base_learner_(self) -> BaseLearner:
        """The fitted base learner (its hyperparameters as at fit time)."""
        if not hasattr(self, "_fitted_learner"):
            # AttributeError, so hasattr() on an unfitted estimator is False
            raise AttributeError(
                f"{type(self).__name__} is not fitted; call fit() first"
            )
        return self._fitted_learner

    def replica_params(self, i: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Replica ``i`` as ``(params, subspace_idx)`` numpy arrays (the
        analog of sklearn's ``estimators_[i]``): the slice of every
        params leaf and its feature indices."""
        self._check_replica(i)
        params = {k: v[i].cpu().numpy() for k, v in self.ensemble_.items()}
        return params, self.subspaces_[i].cpu().numpy()

    @property
    def estimators_features_(self) -> np.ndarray:
        """Per-replica feature indices ``(R, n_subspace)`` (sklearn's
        name for ``subspaces_``), as numpy."""
        self._check_fitted()
        return self.subspaces_.cpu().numpy()

    def replica_weights(self, i: int) -> np.ndarray:
        """Replica ``i``'s bootstrap weights over the training rows (the
        analog of sklearn's ``estimators_samples_[i]``), regenerated from
        the fit key; rows of weight 0 are its out-of-bag rows."""
        self._check_replica(i)
        if getattr(self, "_fit_n_rows", None) is None:
            raise ValueError(
                "replica_weights needs an in-memory fit of this estimator "
                "(a stream fit draws per-chunk weights; weights carried "
                "across from the JAX package have no fit key)"
            )
        if not getattr(self, "_fit_weights_replayable", True):
            raise ValueError(
                "replica_weights requires a fit whose weight draws are "
                "globally replayable: a data-sharded mesh fit folds the "
                "shard index into each draw (layout-dependent), so no "
                "global weight vector regenerates"
            )
        ratio, replacement = self._fit_sampling
        w = bootstrap_weights(
            self._fit_key, torch.tensor([i], device=self._fit_key.device),
            self._fit_n_rows, ratio=ratio, replacement=replacement,
        )
        return w[0].cpu().numpy()

    @property
    def feature_importances_(self) -> np.ndarray:
        """Mean decrease in impurity per (global) feature, normalized to
        sum 1 (Spark ML's ``featureImportances``), for a tree base
        learner: each replica's split gains, its subspace-relative split
        features mapped back through its subspace draw."""
        if not hasattr(self, "ensemble_"):
            # AttributeError, so hasattr() on an unfitted estimator is False
            raise AttributeError(
                "feature_importances_ is only available after fit"
            )
        if "gain" not in self.ensemble_:
            raise AttributeError(
                "feature_importances_ requires a tree base learner "
                "(fitted params carry no split gains)"
            )
        gains = self.ensemble_["gain"].cpu().numpy()             # (R, M)
        feats = self.ensemble_["feature"].long().cpu().numpy()   # (R, M)
        if not self._identity_subspace:
            subs = self.subspaces_.long().cpu().numpy()          # (R, k)
            feats = np.take_along_axis(subs, feats, axis=1)
        imp = np.zeros((self.n_features_in_,), np.float64)
        np.add.at(imp, feats.ravel(), gains.astype(np.float64).ravel())
        total = imp.sum()
        return imp / total if total > 0 else imp

    # -- forward handles -----------------------------------------------

    def aggregated_forward(self):
        """The fitted ensemble's aggregated forward ``(fn, params,
        subspaces)``: ``fn(params, subspaces, X)`` gives ``(n, C)``
        probabilities (classifier) or ``(n,)`` predictions (regressor)
        with every static choice (learner, vote, replica chunk, identity
        subspace) bound in, and is the closure ``predict_proba`` /
        ``predict`` runs on the device. The single-device handle: a
        mesh-fitted estimator refuses (save it and load it without a
        mesh, then serve it through ``EnsembleExecutor(mesh=...)``)."""
        self._check_fitted()
        self._refuse_mesh_handle("aggregated_forward")
        return self._forward_closure(), self.ensemble_, self.subspaces_

    def replica_forward(self):
        """The per-replica forward ``(fn, params, subspaces)``:
        :meth:`aggregated_forward` without the aggregation, ``(R, n, C)``
        for a classifier and ``(R, n)`` for a regressor; its mean over
        replicas is the aggregated output. Single-device, as
        :meth:`aggregated_forward`."""
        self._check_fitted()
        self._refuse_mesh_handle("replica_forward")
        return self._replica_closure(), self.ensemble_, self.subspaces_

    def _refuse_mesh_handle(self, name: str) -> None:
        if self.mesh is not None:
            raise ValueError(
                f"{name} is the single-device serving handle; save() the "
                "mesh-fitted ensemble and load() it without a mesh to "
                "serve it"
            )

    def _mesh_rows(self, X):
        """X padded on the host to the data axis and placed row-sharded
        over the mesh (``global_put``)."""
        from spark_bagging_tpu_torch.parallel.compat import P
        from spark_bagging_tpu_torch.parallel.multihost import global_put
        from spark_bagging_tpu_torch.parallel.sharded import pad_rows_X

        Xp = pad_rows_X(X, self.mesh.shape["data"])
        return global_put(Xp, self.mesh, P("data", None))

    def _mesh_predict(self, X, run) -> np.ndarray:
        """``run`` over X padded to the data axis, padding sliced off
        (gathered over the processes of a process-spanning mesh)."""
        X = self._validate_X(X, torch.device("cpu"), fitted=True)
        n = X.shape[0]
        return to_host(run(self._mesh_rows(X)))[:n]

    def _cached_batch_forward(self, X: torch.Tensor) -> np.ndarray:
        """The batch forward through the unified program cache
        (``serving/program_cache.py``), under the key a serving
        executor's program at bucket ``n`` has: a batch predict at a row
        count serving already built replays that program, and a miss
        records an eager batch program (``EagerBatchProgram``: 0 program
        bytes, source "eager") that this estimator holds, since the cache
        keeps weak references. No CUDA graph is captured for a batch; the
        outputs are the eager forward's bits either way."""
        from spark_bagging_tpu_torch.serving import program_cache as _pc

        n = int(X.shape[0])
        fn = self._forward_closure()
        if n == 0:
            return fn(self.ensemble_, self.subspaces_, X).cpu().numpy()
        key = _pc.ProgramKey(
            _pc.fingerprint_model(self), _pc.forward_variant(self), n,
            None, *_pc.toolchain_id(self._device),
        )
        prog, _hit = _pc.cache().get_or_build(
            key, lambda: _pc.EagerBatchProgram(
                fn, self.ensemble_, self.subspaces_, n, X.shape[1]))
        if isinstance(prog, _pc.EagerBatchProgram):
            self.__dict__.setdefault("_batch_programs", {})[key] = prog
            return prog(X).cpu().numpy()
        # a serving executor's program for this bucket
        return prog.run(X.cpu().numpy(), n)

    def save(self, path: str, *, compress: bool | str = "auto") -> None:
        """Persist the fitted ensemble in the JAX package's checkpoint
        format (manifest + msgpack tree, zstd-compressed where the
        zstandard module imports, else zlib); the JAX package's
        ``load`` reads it too."""
        from spark_bagging_tpu_torch.utils.checkpoint import save_model

        save_model(self, path, compress=compress)

    @classmethod
    def load(cls, path: str, *, device: str = "cuda", mesh=None):
        """Load a fitted ensemble saved by :meth:`save` or by the JAX
        package's ``save``, onto ``device`` (with ``mesh``: onto the
        mesh, whose first device holds the weights and whose shards
        predict)."""
        from spark_bagging_tpu_torch.utils.checkpoint import load_model

        model = load_model(path, device=device, mesh=mesh)
        if not isinstance(model, cls):
            raise TypeError(
                f"checkpoint at {path} holds {type(model).__name__}, "
                f"not {cls.__name__}"
            )
        return model

    def _forward_closure(self):
        raise NotImplementedError  # per task

    def _replica_closure(self):
        raise NotImplementedError  # per task

    # -- weights carried across from the JAX package --------------------

    @classmethod
    def from_jax_arrays(
        cls, ensemble, subspaces, *, n_features: int,
        base_learner: BaseLearner | None = None,
        chunk_size: int | None = None, device: str = "cuda", **params,
    ):
        """A fitted estimator from a JAX estimator's ``ensemble_`` and
        ``subspaces_`` (as numpy arrays) and its ``n_features_in_``: both
        packages then predict from the same weights. ``params`` are
        further constructor parameters (a classifier's ``voting``)."""
        from spark_bagging_tpu_torch.convert import params_from_jax

        est = cls(base_learner=base_learner, chunk_size=chunk_size,
                  device=device, **params)
        dev = resolve_device(device)
        ens, subs = params_from_jax(ensemble, subspaces, device=dev)
        est.ensemble_, est.subspaces_ = ens, subs
        est.n_features_in_ = int(n_features)
        est.n_estimators_ = est.n_estimators = int(subs.shape[0])
        est._fitted_learner = est._learner()
        ident = torch.arange(n_features, dtype=torch.int32, device=dev)
        est._identity_subspace = bool(
            subs.shape[1] == n_features and (subs == ident).all()
        )
        est._device = dev
        return est


class BaggingClassifier(_BaseBagging):
    """Bagging meta-classifier: soft or hard vote over bootstrap replicas
    of the base learner (default :class:`LogisticRegression`)."""

    task = "classification"
    _default_learner = LogisticRegression

    def __init__(
        self,
        base_learner: BaseLearner | None = None,
        n_estimators: int = 10,
        max_samples: float | int = 1.0,
        bootstrap: bool = True,
        max_features: float | int = 1.0,
        bootstrap_features: bool = False,
        voting: str = "soft",
        oob_score: bool = False,
        seed: int = 0,
        chunk_size: int | None = None,
        mesh=None,
        warm_start: bool = False,
        device: str = "cuda",
    ):
        super().__init__(
            base_learner, n_estimators, max_samples, bootstrap, max_features,
            bootstrap_features, oob_score, seed, chunk_size, mesh,
            warm_start, device,
        )
        self.voting = voting

    def fit(self, X, y, sample_weight=None) -> "BaggingClassifier":
        """Fit the ensemble. ``sample_weight`` multiplies every replica's
        bootstrap counts; OOB membership stays weight-independent. With
        ``warm_start=True`` a fitted ensemble grows to ``n_estimators``
        (the same X, y and ``sample_weight`` as its first fit); OOB is
        then scored over the whole grown ensemble."""
        X, device, h2d_seconds, X_host = self._start_fit(X)
        classes, y_enc = np.unique(self._labels(y), return_inverse=True)
        if self.warm_start and hasattr(self, "ensemble_"):
            if not np.array_equal(classes, self.classes_):
                raise ValueError(
                    "warm_start requires the same class set as the "
                    "original fit"
                )
        id_start = self._warm_start_id(X, sample_weight)
        if self._nothing_to_grow(id_start):
            return self
        if len(classes) < 2:
            raise ValueError("y has a single class")
        self.classes_ = classes
        self.n_classes_ = int(len(classes))
        y_t = torch.as_tensor(y_enc.astype(np.int64), device=device)
        self._fit_engine(X, y_t, self.n_classes_, device, h2d_seconds,
                         sample_weight, id_start=id_start,
                         host_xy=(X_host, y_enc))
        if self.oob_score:
            counts, votes = self._oob_scores(X, self.n_classes_)
            self._finalize_oob(counts, votes, y_enc)
        return self

    def fit_stream(
        self,
        source,
        *,
        classes=None,
        n_epochs: int = 1,
        steps_per_chunk: int = 1,
        lr: float = 0.01,
        chunk_rows: int | None = None,
        prefetch: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume_from: str | None = None,
    ) -> "BaggingClassifier":
        """Out-of-core fit from a chunk source (utils/io.py) or an ``(X,
        y)`` pair, chunked by ``chunk_rows``.

        ``classes`` lists the label values; None makes one extra pass
        over the source to collect them. A ``streamable`` learner takes
        ``steps_per_chunk`` Adam steps (learning rate ``lr``) on every
        chunk, ``n_epochs`` times over; a tree learner grows through
        ``max_depth + 2`` passes (the SGD knobs do not apply).
        ``prefetch`` chunks are made on a background thread while the
        device steps (None: 2 where a spare host core exists, else
        none; 0 disables; a source that is already a
        ``PrefetchChunks`` keeps its depth). ``checkpoint_dir`` with
        ``checkpoint_every=N`` snapshots the fit every N chunk-steps (a
        tree learner at every pass boundary, whatever N is);
        ``resume_from`` resumes a snapshot, the JAX package's too, and
        the resumed fit is bit for bit the uninterrupted one.
        """
        from spark_bagging_tpu_torch.utils.io import as_chunk_source
        from spark_bagging_tpu_torch.utils.prefetch import PrefetchChunks

        self._reject_stream_options()
        source = as_chunk_source(source, chunk_rows)
        if classes is None:
            seen: set = set()
            with closing(source.chunks()) as chunk_iter:
                for _, y, n_valid in chunk_iter:
                    seen.update(np.unique(y[:n_valid]).tolist())
            classes = sorted(seen)
        classes = np.asarray(classes)
        if classes.ndim != 1 or len(classes) < 2:
            raise ValueError("classes must be 1-D with >= 2 entries")
        # _EncodedChunks encodes by searchsorted: sorted, no duplicates
        self.classes_ = np.unique(classes)
        if len(self.classes_) != len(classes):
            raise ValueError("classes contains duplicate values")
        self.n_classes_ = int(len(self.classes_))
        if isinstance(source, PrefetchChunks):
            # encode inside the caller's wrap, keeping its depth
            enc = source.rewrap(
                lambda inner: _EncodedChunks(inner, self.classes_))
        else:
            enc = _EncodedChunks(source, self.classes_)
        self._fit_stream_engine(enc, self.n_classes_, n_epochs=n_epochs,
                                steps_per_chunk=steps_per_chunk, lr=lr,
                                prefetch=prefetch,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                resume_from=resume_from)
        if self.oob_score:
            counts, votes, y_enc = self._oob_scores_stream(
                enc, self.n_classes_)
            self._finalize_oob(counts, votes, y_enc)
        return self

    def _finalize_oob(self, counts, votes, y_enc) -> None:
        """OOB vote counts -> ``oob_score_`` (accuracy over rows with at
        least one OOB vote) and ``oob_decision_function_`` (NaN where no
        replica voted)."""
        has_vote = votes > 0
        oob_pred = counts.argmax(axis=1)
        self.oob_score_ = accuracy(y_enc[has_vote], oob_pred[has_vote])
        self.oob_decision_function_ = np.where(
            has_vote[:, None], counts / np.maximum(votes, 1)[:, None], np.nan,
        )
        # OOB rows are the honest confidence reference for the quality
        # plane: held-out per-row max probability, free at fit time
        prof = getattr(self, "quality_profile_", None)
        if prof is not None and has_vote.any():
            prof.set_confidence_reference(
                self.oob_decision_function_[has_vote].max(axis=1),
                source="oob",
            )

    def _forward_closure(self):
        return classifier_forward(
            self._fitted_learner, self.n_classes_, self.n_estimators_,
            voting=self.voting, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def _replica_closure(self):
        return classifier_replica_forward(
            self._fitted_learner, self.n_classes_,
            voting=self.voting, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def predict_proba(self, X) -> np.ndarray:
        """Aggregated class probabilities ``(n, C)``: on a mesh, each
        shard's rows voted on by its replicas; else through the program
        cache (``_cached_batch_forward``)."""
        self._check_fitted()
        if self.mesh is not None:
            from spark_bagging_tpu_torch.parallel.sharded import (
                sharded_predict_classifier,
            )

            return self._mesh_predict(
                X, lambda Xp: sharded_predict_classifier(
                    self._fitted_learner, self.mesh, self.ensemble_,
                    self.subspaces_, Xp, self.n_classes_,
                    self.n_estimators_, voting=self.voting,
                    chunk_size=self._eff_chunk(),
                    identity_subspace=self._identity_subspace))
        X = self._validate_X(X, self._device, fitted=True)
        return self._cached_batch_forward(X)

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

    def predict_log_proba(self, X) -> np.ndarray:
        """Log of the aggregated class probabilities (sklearn parity)."""
        return np.log(np.maximum(self.predict_proba(X), 1e-38))

    def decision_function(self, X) -> np.ndarray:
        """``(n,)`` margin ``p_1 - p_0`` for two classes, the ``(n, C)``
        probabilities otherwise (the sklearn ensemble convention)."""
        proba = self.predict_proba(X)
        if proba.shape[1] == 2:
            return proba[:, 1] - proba[:, 0]
        return proba

    def predict_proba_stream(self, source, chunk_rows=None, *,
                             prefetch: int | None = None,
                             drop_aux_col: bool | None = None) -> np.ndarray:
        """Out-of-core ``predict_proba``: one chunk on the device at a
        time (``drop_aux_col``: see ``_stream_chunks``)."""
        with closing(self._stream_chunks(
                source, chunk_rows, prefetch, drop_aux_col).chunks()) as it:
            out = [self.predict_proba(Xc[:n]) for Xc, _, n in it]
        if not out:
            raise ValueError("source yielded no chunks")
        return np.concatenate(out)

    def predict_stream(self, source, chunk_rows=None, *,
                       prefetch: int | None = None,
                       drop_aux_col: bool | None = None) -> np.ndarray:
        proba = self.predict_proba_stream(source, chunk_rows,
                                          prefetch=prefetch,
                                          drop_aux_col=drop_aux_col)
        return self.classes_[proba.argmax(axis=1)]

    def score_stream(self, source, chunk_rows=None, *,
                     prefetch: int | None = None,
                     drop_aux_col: bool | None = None) -> float:
        """Out-of-core accuracy over a labelled chunk source."""
        correct = total = 0
        with closing(self._stream_chunks(
                source, chunk_rows, prefetch, drop_aux_col).chunks()) as it:
            for Xc, yc, n in it:
                correct += int((np.asarray(yc[:n])
                                == self.predict(Xc[:n])).sum())
                total += int(n)
        if total == 0:
            raise ValueError("source yielded no chunks")
        return correct / total

    def score(self, X, y, sample_weight=None) -> float:
        return accuracy(y, self.predict(X), sample_weight=sample_weight)

    @classmethod
    def from_jax_arrays(
        cls, ensemble, subspaces, *, classes, n_features: int,
        base_learner: BaseLearner | None = None, voting: str = "soft",
        chunk_size: int | None = None, device: str = "cuda",
    ) -> "BaggingClassifier":
        """:meth:`_BaseBagging.from_jax_arrays` with the JAX estimator's
        ``classes_``."""
        est = super().from_jax_arrays(
            ensemble, subspaces, n_features=n_features,
            base_learner=base_learner, chunk_size=chunk_size, device=device,
            voting=voting,
        )
        est.classes_ = np.asarray(classes)
        est.n_classes_ = int(len(est.classes_))
        return est


class BaggingRegressor(_BaseBagging):
    """Bagging meta-regressor: the mean over bootstrap replicas of the
    base learner (default :class:`LinearRegression`)."""

    task = "regression"
    _default_learner = LinearRegression

    def fit(self, X, y, sample_weight=None, aux=None) -> "BaggingRegressor":
        """Fit the ensemble; ``sample_weight`` and ``warm_start`` as in
        :meth:`BaggingClassifier.fit`. ``aux`` ``(n,)`` is the per-row
        auxiliary column of a learner that declares ``uses_aux`` (the
        survival learner's censor flags); passing it to any other
        learner is an error."""
        self.__dict__.pop("_collapsed_beta_cache", None)
        if aux is not None:
            learner = self._learner()
            if not learner.uses_aux:
                raise ValueError(
                    f"aux was passed but {type(learner).__name__} does not "
                    "declare uses_aux (it would be silently ignored)"
                )
        X, device, h2d_seconds, X_host = self._start_fit(X)
        y = self._labels(y).astype(np.float32)
        y_t = torch.as_tensor(y, device=device)
        aux_t = None
        if aux is not None:
            if isinstance(aux, torch.Tensor):
                aux = aux.detach().cpu().numpy()
            aux = np.asarray(aux, np.float32).ravel()
            if aux.shape != (X.shape[0],):
                raise ValueError(f"aux shape {aux.shape} != ({X.shape[0]},)")
            aux_t = torch.as_tensor(aux, device=device)
        id_start = self._warm_start_id(X, sample_weight, aux)
        if self._nothing_to_grow(id_start):
            return self
        self._fit_engine(X, y_t, 1, device, h2d_seconds, sample_weight,
                         aux=aux_t, id_start=id_start, host_xy=(X_host, y))
        if self.oob_score:
            sums, votes = self._oob_scores(X, None)
            self._finalize_oob(sums, votes, y)
        return self

    def fit_stream(
        self,
        source,
        *,
        n_epochs: int = 1,
        steps_per_chunk: int = 1,
        lr: float = 0.01,
        chunk_rows: int | None = None,
        prefetch: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume_from: str | None = None,
        aux_col: int | None = None,
    ) -> "BaggingRegressor":
        """Out-of-core fit from a chunk source or an ``(X, y)`` pair; see
        :meth:`BaggingClassifier.fit_stream`. ``aux_col`` names the
        streamed column that is a ``uses_aux`` learner's aux channel
        (the survival learner's censor flags): each chunk splits it off
        before the step, and the model's features are the other
        columns."""
        from spark_bagging_tpu_torch.utils.io import as_chunk_source

        self._reject_stream_options()
        self.__dict__.pop("_collapsed_beta_cache", None)
        source = as_chunk_source(source, chunk_rows)
        self._fit_stream_engine(source, 1, n_epochs=n_epochs,
                                steps_per_chunk=steps_per_chunk, lr=lr,
                                prefetch=prefetch,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                resume_from=resume_from, aux_col=aux_col)
        if self.oob_score:
            sums, votes, y = self._oob_scores_stream(source, None)
            self._finalize_oob(sums, votes, y)
        return self

    def _finalize_oob(self, sums, votes, y) -> None:
        """OOB prediction sums -> ``oob_prediction_`` (NaN where no
        replica voted) and ``oob_score_`` (R² over the voted rows)."""
        has_vote = votes > 0
        self.oob_prediction_ = np.where(
            has_vote, sums / np.maximum(votes, 1), np.nan
        )
        self.oob_score_ = r2_score(y[has_vote], self.oob_prediction_[has_vote])

    def _linear_collapse(self) -> np.ndarray | None:
        """``(D+1,)`` mean coefficients when the fitted learner's predict
        is linear in its params: the mean of R linear predictions is one
        prediction with the subspace-scattered mean betas, exactly, so
        ``predict`` is one host matvec. Cached per fit; None for a
        learner that is not linear."""
        if not hasattr(self, "_collapsed_beta_cache"):
            cache = None
            beta_fn = getattr(self._fitted_learner, "linear_beta", None)
            beta = (beta_fn(self.ensemble_) if beta_fn is not None
                    else None)
            if beta is not None:  # None: a link that is not linear
                B = beta.cpu().numpy().astype(np.float64)
                subs = self.subspaces_.cpu().numpy()
                out = np.zeros((B.shape[0], self.n_features_in_ + 1),
                               np.float64)
                rows = np.arange(B.shape[0])[:, None]
                # a column drawn twice (bootstrap_features) adds twice
                np.add.at(out, (rows, subs), B[:, :-1])
                out[:, -1] = B[:, -1]
                cache = out.mean(axis=0).astype(np.float32)
            self._collapsed_beta_cache = cache
        return self._collapsed_beta_cache

    def _forward_closure(self):
        """The device forward (the ensemble's mean), also for a linear
        learner: the collapse is ``predict``'s host-side path only."""
        return regressor_forward(
            self._fitted_learner, self.n_estimators_,
            chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def _replica_closure(self):
        return regressor_replica_forward(
            self._fitted_learner, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def predict(self, X) -> np.ndarray:
        """Mean prediction ``(n,)``: one host matvec with the collapsed
        coefficients for a linear learner, the device forward for any
        other."""
        self._check_fitted()
        beta = self._linear_collapse()
        if beta is not None:
            if isinstance(X, torch.Tensor):
                X = X.detach().cpu()
            Xh = np.asarray(X, np.float32)
            if Xh.ndim != 2 or Xh.shape[1] != self.n_features_in_:
                raise ValueError(
                    f"X has shape {Xh.shape}; the ensemble was fitted on "
                    f"{self.n_features_in_} features"
                )
            return np.asarray(Xh @ beta[:-1] + beta[-1], np.float32)
        if self.mesh is not None:
            from spark_bagging_tpu_torch.parallel.sharded import (
                sharded_predict_regressor,
            )

            return self._mesh_predict(
                X, lambda Xp: sharded_predict_regressor(
                    self._fitted_learner, self.mesh, self.ensemble_,
                    self.subspaces_, Xp, self.n_estimators_,
                    chunk_size=self._eff_chunk(),
                    identity_subspace=self._identity_subspace))
        X = self._validate_X(X, self._device, fitted=True)
        return self._cached_batch_forward(X)

    def predict_quantiles(self, X, probs=(0.1, 0.5, 0.9)) -> np.ndarray:
        """Per-row quantiles ``(n, len(probs))`` averaged over replicas,
        Spark's ``quantilesCol``, for a survival learner
        (``AFTSurvivalRegression.predict_quantiles``); any other learner
        raises ``AttributeError``."""
        from spark_bagging_tpu_torch.ensemble import (
            predict_quantiles_ensemble,
        )

        self._check_fitted()
        learner = self.base_learner_
        if not hasattr(learner, "predict_quantiles"):
            raise AttributeError(
                f"{type(learner).__name__} has no predict_quantiles "
                "(only survival learners expose quantiles)"
            )
        if self.mesh is not None:
            raise ValueError(
                "predict_quantiles is single-device; gather the model "
                "(load without mesh) first"
            )
        X = self._validate_X(X, self._device, fitted=True)
        return predict_quantiles_ensemble(
            learner, self.ensemble_, self.subspaces_, X,
            tuple(float(p) for p in probs), chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        ).cpu().numpy()

    def predict_stream(self, source, chunk_rows=None, *,
                       prefetch: int | None = None,
                       drop_aux_col: bool | None = None) -> np.ndarray:
        """Out-of-core ``predict``: one chunk on the device at a time
        (``drop_aux_col``: see ``_stream_chunks``)."""
        with closing(self._stream_chunks(
                source, chunk_rows, prefetch, drop_aux_col).chunks()) as it:
            out = [self.predict(Xc[:n]) for Xc, _, n in it]
        if not out:
            raise ValueError("source yielded no chunks")
        return np.concatenate(out)

    def score_stream(self, source, chunk_rows=None, *,
                     prefetch: int | None = None,
                     drop_aux_col: bool | None = None) -> float:
        """Out-of-core R² from one pass of moments, shifted by the first
        chunk's target mean: the raw ``Σy² - (Σy)²/n`` cancels
        catastrophically for targets with a large mean."""
        n_tot = 0
        shift = None
        s_yd = s_yd2 = s_res = 0.0
        with closing(self._stream_chunks(
                source, chunk_rows, prefetch, drop_aux_col).chunks()) as it:
            for Xc, yc, n in it:
                yv = np.asarray(yc[:n], np.float64)
                pred = np.asarray(self.predict(Xc[:n]), np.float64)
                if shift is None:
                    shift = float(yv.mean()) if n else 0.0
                yd = yv - shift
                n_tot += int(n)
                s_yd += float(yd.sum())
                s_yd2 += float((yd**2).sum())
                s_res += float(((yv - pred) ** 2).sum())
        if n_tot == 0:
            raise ValueError("source yielded no chunks")
        ss_tot = s_yd2 - s_yd**2 / n_tot
        return 1.0 - s_res / ss_tot if ss_tot > 0 else 0.0

    def score(self, X, y, sample_weight=None) -> float:
        """R² of :meth:`predict`."""
        return r2_score(y, self.predict(X), sample_weight=sample_weight)
