"""Model persistence in the JAX package's checkpoint format.

A checkpoint is one directory that either package loads:

- ``manifest.json`` — format version, estimator class, constructor
  params (the base learner serialized by class path + hyperparams) and
  fitted metadata (classes, shapes, sampling config, RNG schema, fit
  report), with the keys the JAX package's ``utils/checkpoint.py``
  writes;
- ``arrays.msgpack`` (raw), ``arrays.msgpack.z`` (zlib) or
  ``arrays.msgpack.zst`` (zstd) — the stacked parameter tree plus the
  subspaces, in flax's msgpack encoding (``utils/msgpack.py``: the
  port's own codec, byte for byte what flax writes).

Classes are named as the JAX package names them
(``spark_bagging_tpu.bagging:BaggingClassifier``, the learner's import
path); the port maps each to its counterpart by :data:`CLASS_TABLE`, so
a checkpoint written here loads in the JAX package and one written
there loads here. The device is a runtime resource and is not
persisted: ``load_model(path, device=...)`` places the weights.

Saves are atomic (the whole checkpoint is built in a temp directory and
swapped in, with a ``.old`` recovery slot a crash between the two swap
renames leaves behind), and the swap window carries the
``checkpoint.write`` fault site. Checkpoints are trusted input, like
pickle: the manifest names the classes to instantiate.
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import shutil
import warnings
from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.ops.bootstrap import RNG_SCHEMA
from spark_bagging_tpu_torch.utils import msgpack

_FORMAT_VERSION = 1

_JAX_PACKAGE = "spark_bagging_tpu"
_PORT_PACKAGE = "spark_bagging_tpu_torch"

#: ``(module under the package, class name)`` of every estimator and
#: learner both packages have: the manifest's ``spark_bagging_tpu.<module>:
#: <name>`` is the port's ``spark_bagging_tpu_torch.<module>:<name>``
CLASS_TABLE: tuple[tuple[str, str], ...] = (
    ("bagging", "BaggingClassifier"),
    ("bagging", "BaggingRegressor"),
    ("forest", "RandomForestClassifier"),
    ("forest", "RandomForestRegressor"),
    ("models.aft", "AFTSurvivalRegression"),
    ("models.fm", "FMClassifier"),
    ("models.fm", "FMRegressor"),
    ("models.gbt", "GBTClassifier"),
    ("models.gbt", "GBTRegressor"),
    ("models.glm", "GeneralizedLinearRegression"),
    ("models.isotonic", "IsotonicRegression"),
    ("models.linear", "LinearRegression"),
    ("models.logistic", "LogisticRegression"),
    ("models.mlp", "MLPClassifier"),
    ("models.mlp", "MLPRegressor"),
    ("models.naive_bayes", "BernoulliNB"),
    ("models.naive_bayes", "GaussianNB"),
    ("models.naive_bayes", "MultinomialNB"),
    ("models.svm", "LinearSVC"),
    ("models.tree", "DecisionTreeClassifier"),
    ("models.tree", "DecisionTreeRegressor"),
)
_JAX_TO_PORT = {f"{_JAX_PACKAGE}.{m}:{n}": f"{_PORT_PACKAGE}.{m}:{n}"
                for m, n in CLASS_TABLE}
_PORT_TO_JAX = {v: k for k, v in _JAX_TO_PORT.items()}

#: constructor params of the port's estimators that are runtime
#: resources, never persisted (the JAX package persists no mesh either)
_RUNTIME_PARAMS = ("mesh", "device")


def _zstd():
    """The ``zstandard`` module, or None: zstd is optional, imported
    only when a checkpoint is written or read."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def _write_arrays(path: str, payload: bytes, compress: bool | str) -> str:
    """Write the msgpack payload, compressed when requested: zstd where
    the zstandard module imports, else the stdlib zlib codec (with a
    warning), as the JAX package falls back. Returns the filename."""
    if compress not in (True, False, "auto"):
        raise ValueError(f"compress must be True, False or 'auto', got "
                         f"{compress!r}")
    if compress in (True, "auto"):
        z = _zstd()
        if z is not None:
            name = "arrays.msgpack.zst"
            payload = z.ZstdCompressor(level=3).compress(payload)
        else:
            import zlib

            warnings.warn(
                "zstandard is not installed; checkpoint compression falls "
                "back to the stdlib zlib codec", stacklevel=4)
            name = "arrays.msgpack.z"
            payload = zlib.compress(payload, 1)
    else:
        name = "arrays.msgpack"
    with open(os.path.join(path, name), "wb") as f:
        f.write(payload)
    telemetry.inc("sbt_checkpoint_bytes_total", float(len(payload)),
                  labels={"kind": "model", "op": "save"})
    return name


def _read_arrays(path: str) -> bytes:
    """The arrays payload, its codec found by filename (``.zst`` zstd,
    which needs the zstandard module; ``.z`` zlib; bare, raw)."""
    zst = os.path.join(path, "arrays.msgpack.zst")
    zl = os.path.join(path, "arrays.msgpack.z")
    if os.path.exists(zst):
        z = _zstd()
        if z is None:
            raise ImportError(
                f"{zst} is zstd-compressed but the zstandard module is "
                "not installed")
        with open(zst, "rb") as f:
            payload = z.ZstdDecompressor().decompress(f.read())
    elif os.path.exists(zl):
        import zlib

        with open(zl, "rb") as f:
            payload = zlib.decompress(f.read())
    else:
        with open(os.path.join(path, "arrays.msgpack"), "rb") as f:
            payload = f.read()
    telemetry.inc("sbt_checkpoint_bytes_total", float(len(payload)),
                  labels={"kind": "model", "op": "load"})
    return payload


def class_path(obj: Any) -> str:
    """The manifest's name of ``obj``'s class: the JAX package's path
    for a class both packages have, else the class's own path."""
    cls = type(obj)
    own = f"{cls.__module__}:{cls.__qualname__}"
    return _PORT_TO_JAX.get(own, own)


def _import_class(path: str):
    """The port's class for a manifest's ``module:qualname``. A JAX
    package path maps through :data:`CLASS_TABLE` (the JAX package is
    never imported); any other path is imported as written (a custom
    learner's module must be importable)."""
    if path.split(":")[0].split(".")[0] == _JAX_PACKAGE:
        if path not in _JAX_TO_PORT:
            raise ValueError(
                f"checkpoint names {path!r}, which has no counterpart in "
                f"{_PORT_PACKAGE}")
        path = _JAX_TO_PORT[path]
    module, _, qualname = path.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _serialize_value(v: Any) -> Any:
    """JSON-encode a constructor param; learners nest as class+params."""
    if hasattr(v, "get_params") and hasattr(v, "task"):
        return {
            "__learner__": class_path(v),
            "params": {k: _serialize_value(p)
                       for k, p in v.get_params(deep=False).items()},
        }
    return v


def _deserialize_value(v: Any) -> Any:
    if isinstance(v, dict) and "__learner__" in v:
        cls = _import_class(v["__learner__"])
        return cls(**{k: _deserialize_value(p)
                      for k, p in v["params"].items()})
    return v


def save_model(model: Any, path: str, *, compress: bool | str = "auto") -> None:
    """Save a fitted estimator to directory ``path`` in the JAX
    package's format. ``compress``: ``"auto"``/``True`` compress the
    arrays (zstd, else zlib), ``False`` writes raw msgpack."""
    with telemetry.span("checkpoint_save", metric="sbt_checkpoint_seconds"):
        _save_model_impl(model, path, compress=compress)


def _manifest(model: Any) -> dict:
    params = {k: _serialize_value(v)
              for k, v in model.get_params(deep=False).items()
              if k not in _RUNTIME_PARAMS}
    n_rows = getattr(model, "_fit_n_rows", None)
    key = getattr(model, "_fit_key", None)
    fitted: dict[str, Any] = {
        "n_features_in_": int(model.n_features_in_),
        "n_estimators_": int(model.n_estimators_),
        # an estimator carried across by from_jax_arrays has no fit of
        # its own: the sampling it reports is the default, and its
        # weights do not replay
        "fit_sampling": list(getattr(model, "_fit_sampling",
                                     (1.0, bool(model.bootstrap)))),
        "fit_n_rows": n_rows,
        "weights_replayable": (n_rows is not None and key is not None
                               and getattr(model, "_fit_weights_replayable",
                                           True)),
        "rng_schema": RNG_SCHEMA,
        "identity_subspace": bool(model._identity_subspace),
        "chunk_resolved": getattr(model, "_chunk_resolved", None),
        "stream_aux_col": getattr(model, "_stream_aux_col", None),
        "fit_report_": getattr(model, "fit_report_", {}),
        "seed_key": (key.cpu().tolist() if key is not None
                     else [0, int(model.seed) & 0xFFFFFFFF]),
    }
    if hasattr(model, "classes_"):
        classes = np.asarray(model.classes_)
        fitted["classes_"] = classes.tolist()
        fitted["classes_dtype"] = str(classes.dtype)
        fitted["n_classes_"] = int(model.n_classes_)
    if hasattr(model, "oob_score_"):
        fitted["oob_score_"] = float(model.oob_score_)
    # the quality plane's fit-time reference (telemetry/quality.py):
    # JSON-friendly by construction, rides the manifest so a loaded
    # model (ModelRegistry.load included) can be drift-monitored
    if getattr(model, "quality_profile_", None) is not None:
        fitted["quality_profile_"] = model.quality_profile_.to_dict()
    return {
        "format_version": _FORMAT_VERSION,
        "estimator": class_path(model),
        "learner": class_path(model._fitted_learner),
        "learner_params": {
            k: _serialize_value(v)
            for k, v in model._fitted_learner.get_params(deep=False).items()
        },
        "params": params,
        "fitted": fitted,
    }


def reap_stale_tmp(path: str, tmp: str) -> None:
    """Remove the ``path.tmp.<pid>`` dirs of savers that died mid-write;
    a live process's (and ``tmp``, this one's) is left alone."""
    for stale in glob.glob(glob.escape(path) + ".tmp.*"):
        suffix = stale.rsplit(".", 1)[1]
        if stale == tmp or not suffix.isdigit() or not os.path.isdir(stale):
            continue
        try:
            os.kill(int(suffix), 0)  # raises if no such process
        except ProcessLookupError:
            shutil.rmtree(stale, ignore_errors=True)
        except PermissionError:
            pass  # pid exists under another uid: leave it


def install(tmp: str, path: str) -> None:
    """Rename the complete ``tmp`` dir into ``path``. ``path + ".old"``
    is the crash-recovery slot: a crash between the two renames leaves
    the previous complete copy there, where the loaders fall back to;
    after such a crash it is the only valid copy, so it goes only once
    the new one is installed."""
    old = f"{path}.old"
    if os.path.exists(path):
        if os.path.isdir(old):
            shutil.rmtree(old)  # `path` is intact: the slot is stale
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
        if os.path.isdir(old):
            shutil.rmtree(old)  # recovery slot superseded by this save


def _save_model_impl(model: Any, path: str, *, compress: bool | str) -> None:
    from spark_bagging_tpu_torch.convert import params_to_jax

    model._check_fitted()
    manifest = _manifest(model)
    ensemble, subspaces = params_to_jax(model.ensemble_, model.subspaces_)
    tree: dict[str, Any] = {"ensemble": ensemble, "subspaces": subspaces}
    # OOB arrays ride along so a loaded model is fully OOB-fitted
    if hasattr(model, "oob_decision_function_"):
        tree["oob_decision_function"] = np.asarray(
            model.oob_decision_function_)
    if hasattr(model, "oob_prediction_"):
        tree["oob_prediction"] = np.asarray(model.oob_prediction_)
    # Atomic install: build the whole checkpoint in a temp dir, then
    # swap it in — a crash mid-save never leaves a new manifest over old
    # arrays, nor a stale arrays file of another compression beside them.
    # Temp dirs of dead savers are reaped; a live one's is left alone.
    tmp = f"{path}.tmp.{os.getpid()}"
    reap_stale_tmp(path, tmp)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    _write_arrays(tmp, msgpack.serialize(tree), compress)
    if faults.ACTIVE is not None:
        # torn-write drill: a kill here leaves only tmp debris; the
        # installed checkpoint and its .old slot stay loadable
        faults.fire("checkpoint.write")
    install(tmp, path)


def load_model(path: str, *, device: str = "cuda", mesh=None) -> Any:
    """Load a fitted estimator from directory ``path`` (written by
    either package) onto ``device``. Checkpoints are trusted input —
    see :func:`_import_class`."""
    with telemetry.span("checkpoint_load", metric="sbt_checkpoint_seconds"):
        return _load_model_impl(path, device=device, mesh=mesh)


def _load_model_impl(path: str, *, device: str, mesh=None) -> Any:
    from spark_bagging_tpu_torch.convert import params_from_jax
    from spark_bagging_tpu_torch.utils.device import resolve_device

    if (not os.path.exists(os.path.join(path, "manifest.json"))
            and os.path.isdir(f"{path}.old")):
        warnings.warn(
            f"checkpoint missing at {path!r}; loading the previous "
            f"version from {path + '.old'!r} (a save crashed mid-swap)",
            stacklevel=3)
        path = f"{path}.old"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] > _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} is newer "
            f"than supported ({_FORMAT_VERSION})")
    tree = msgpack.restore(_read_arrays(path))
    # a mesh is a runtime resource, never persisted: with one, the
    # weights go to its first device and its shards predict
    dev = mesh.first_device if mesh is not None else resolve_device(device)

    cls = _import_class(manifest["estimator"])
    params = {k: _deserialize_value(v) for k, v in manifest["params"].items()}
    model = cls(**params, device=device, mesh=mesh)
    learner_cls = _import_class(manifest["learner"])
    model._fitted_learner = learner_cls(**{
        k: _deserialize_value(v)
        for k, v in manifest["learner_params"].items()})
    fitted = manifest["fitted"]
    model.ensemble_, model.subspaces_ = params_from_jax(
        tree["ensemble"], tree["subspaces"], device=dev)
    model.n_features_in_ = int(fitted["n_features_in_"])
    model.n_estimators_ = int(fitted["n_estimators_"])
    model._fit_sampling = tuple(fitted["fit_sampling"])
    replayable = bool(fitted.get("weights_replayable",
                                 fitted.get("fit_n_rows") is not None))
    # Replayability is schema-bound: a checkpoint saved under another
    # bootstrap key-derivation schema would replay different weights
    # than its replicas were trained on. The model stays usable; the
    # silent mismatch is refused.
    if replayable and fitted.get("rng_schema") != RNG_SCHEMA:
        warnings.warn(
            f"checkpoint was saved under bootstrap RNG schema "
            f"{fitted.get('rng_schema')!r} but this build draws with "
            f"schema {RNG_SCHEMA}; replica_weights()/OOB replay is "
            "disabled for the loaded model (predictions are unaffected)",
            stacklevel=3)
        replayable = False
    model._fit_n_rows = fitted.get("fit_n_rows") if replayable else None
    model._fit_weights_replayable = replayable
    model._identity_subspace = bool(fitted["identity_subspace"])
    model._chunk_resolved = fitted.get("chunk_resolved")
    model._stream_aux_col = fitted.get("stream_aux_col")
    model.fit_report_ = fitted["fit_report_"]
    model._fit_key = torch.tensor(
        [int(w) & 0xFFFFFFFF for w in fitted["seed_key"]],
        dtype=torch.int64, device=dev)
    model._device = dev
    if "classes_" in fitted:
        model.classes_ = np.asarray(fitted["classes_"],
                                    dtype=fitted["classes_dtype"])
        model.n_classes_ = int(fitted["n_classes_"])
    if "oob_score_" in fitted:
        model.oob_score_ = fitted["oob_score_"]
    if fitted.get("quality_profile_") is not None:
        from spark_bagging_tpu_torch.telemetry.quality import (
            ReferenceProfile,
        )

        try:
            model.quality_profile_ = ReferenceProfile.from_dict(
                fitted["quality_profile_"]
            )
        except Exception as e:  # noqa: BLE001 — an unknown schema, or
            # a truncated/hand-edited dict (KeyError/TypeError): none of
            # them may brick the weights they ride with — the model
            # loads, monitoring degrades
            warnings.warn(
                f"quality profile in checkpoint not restored: {e} "
                "(drift monitoring unavailable for the loaded model)",
                stacklevel=2,
            )
    if "oob_decision_function" in tree:
        model.oob_decision_function_ = np.array(tree["oob_decision_function"])
    if "oob_prediction" in tree:
        model.oob_prediction_ = np.array(tree["oob_prediction"])
    return model
