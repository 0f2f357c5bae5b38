"""Versioned model registry with atomic hot-swap.

A serving process outlives any one fitted model: bags get retrained
(fresh data, warm-started growth) and the serving copy must be replaced
WITHOUT dropping in-flight traffic or paying a capture stall at the
swap instant. The registry owns that lifecycle:

- :meth:`ModelRegistry.register` installs a fitted estimator under a
  name (version 1) wrapped in an
  :class:`~spark_bagging_tpu_torch.serving.executor.EnsembleExecutor`;
- :meth:`ModelRegistry.swap` builds the replacement executor OFF to the
  side, validates it serves the same contract (task, feature width,
  class set), **pre-captures it on every bucket the live executor has
  active** (so post-swap traffic captures nothing), then replaces the
  entry pointer atomically under the registry lock; the retired
  executor's programs leave the unified cache, and its graphs (and
  their pool) free with the last in-flight batch that holds it;
- :meth:`ModelRegistry.load` does the same from a checkpoint directory
  (``utils/checkpoint.load_model``, the JAX package's format, so a
  checkpoint written by either package serves here) — the
  retrain-in-another-process hand-off;
- :meth:`ModelRegistry.batcher` returns a
  :class:`~spark_bagging_tpu_torch.serving.batcher.MicroBatcher` whose
  executor is RESOLVED PER MICRO-BATCH from this registry, which is
  what makes a swap atomic from the traffic's point of view: requests
  already forwarded finish on the old executor, the next batch runs on
  the new one, and nothing in between is dropped (tested mid-traffic
  in tests/test_torch_serving.py).

The port's copy of the JAX package's ``serving/registry.py``. A CUDA
graph cannot be serialized, so :meth:`ModelRegistry.save` writes no
``serving_aot/`` and :meth:`ModelRegistry.load` ignores one (counted in
``sbt_serving_aot_misses_total``), capturing the live buckets at warm
instead. Drift monitoring (:meth:`ModelRegistry.enable_quality`) is
sticky across :meth:`~ModelRegistry.swap` and :meth:`~ModelRegistry.load`.
Every registry contributes its live version map to ``/healthz``, and
feeds the capacity plane's ledger (``telemetry/capacity.py``) on
register and on a swap's commit only, so a failed swap leaves no
ledger entry. A serve_config's serving mesh (a replica mesh) is rebuilt
when the process has the devices for it (:func:`host_devices`), over a
prefix of them where it has more; otherwise it serves single-device
with a warning.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.serving import program_cache as _pc
from spark_bagging_tpu_torch.serving.executor import EnsembleExecutor
from spark_bagging_tpu_torch.telemetry import capacity as _capacity


class _Entry:
    __slots__ = ("name", "version", "executor", "opts", "quality_opts")

    def __init__(self, name: str, version: int,
                 executor: EnsembleExecutor, opts: dict):
        self.name = name
        self.version = version
        self.executor = executor
        self.opts = opts
        # sticky quality-monitoring options (enable_quality); None
        # when drift monitoring is off for this name
        self.quality_opts: dict | None = None


# sbt-lint: shared-state

def host_devices(device: str = "cuda") -> list:
    """The devices a serving mesh of this process may be built over: every
    CUDA device for a ``"cuda"`` load, the one CPU device for ``"cpu"``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]

class ModelRegistry:
    """Named, versioned serving models. All methods are thread-safe."""

    def __init__(self, **default_executor_opts: Any):
        self._lock = make_lock("serving.registry")
        self._entries: dict[str, _Entry] = {}
        self._default_opts = default_executor_opts
        # deferred import: the health registry lives in the exposition
        # server module, whose http.server import chain (~100ms) only
        # serving processes should pay
        from spark_bagging_tpu_torch.telemetry import (
            server as telemetry_server,
        )

        self._health_handle = telemetry_server.register_health_source(
            "model_registry", self, ModelRegistry.health
        )

    def health(self) -> dict:
        """``/healthz`` contribution: the live model/version map. A
        registry is healthy by construction — its job is to always
        hold a consistent serving pointer; per-batcher liveness is the
        batchers' own report."""
        with self._lock:
            models = {
                name: e.version for name, e in self._entries.items()
            }
        return {"healthy": True, "models": models}

    # -- introspection -------------------------------------------------

    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def version(self, name: str) -> int:
        return self._entry(name).version

    def executor(self, name: str) -> EnsembleExecutor:
        """The CURRENT executor for ``name`` (a snapshot — hold the
        return value no longer than one batch if you want swaps to
        take effect)."""
        return self._entry(name).executor

    def model(self, name: str) -> Any:
        return self._entry(name).executor.model

    def _entry(self, name: str) -> _Entry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"no model registered as {name!r}; have "
                    f"{sorted(self._entries)}"
                ) from None

    # -- lifecycle -----------------------------------------------------

    def _reject_swap(self, name: str, msg: str) -> None:
        """Count + flight-record a contract violation, then raise.
        A rejected swap is an incident (a retrain pipeline shipped an
        incompatible model), so it triggers the armed recorder."""
        telemetry.inc("sbt_serving_swap_rejected_total")
        telemetry.emit_event({
            "kind": "swap_rejected", "model": name, "error": msg,
        })
        raise ValueError(msg)

    def _fail_swap(self, name: str, e: Exception) -> None:
        """A swap that died BUILDING its replacement (a bucket
        pre-capture) — as opposed to one
        rejected by contract validation. The rollback is structural:
        nothing was committed, so the prior live executor keeps
        serving untouched; counted + flight-recorded as its own
        incident kind."""
        telemetry.inc("sbt_serving_swap_failed_total")
        telemetry.emit_event({
            "kind": "swap_failed", "model": name, "error": repr(e),
        })
        raise RuntimeError(
            f"swap of {name!r} failed before commit ({e!r}); rolled "
            "back — the prior live executor is unchanged and keeps "
            "serving"
        ) from e

    def register(self, name: str, model: Any, *, warmup: bool = False,
                 executable_cache: str | None = None,
                 version: int | None = None,
                 **executor_opts: Any) -> EnsembleExecutor:
        """Install a fitted estimator as version 1 of ``name``.

        ``warmup=True`` captures the full bucket ladder before the
        method returns (serve-ready, zero captures afterwards).
        ``executable_cache`` names a persisted executable cache, which
        the port cannot hydrate (a CUDA graph cannot be deserialized):
        it is counted as a miss and ignored.
        ``executor_opts`` (bucket bounds, donation)
        override the registry defaults and stick to the name across
        swaps. ``version`` installs at an explicit version number —
        the N-process seam (:meth:`load` from a ``serve_config``
        manifest) uses it so every peer process loading one checkpoint
        agrees on the version it serves.
        """
        version = 1 if version is None else int(version)
        if version < 1:
            raise ValueError(f"version must be >= 1, got {version}")
        opts = {**self._default_opts, **executor_opts}
        ex = EnsembleExecutor(model, **opts)
        if executable_cache is not None:
            ex.restore_executables(executable_cache)
        if warmup:
            ex.warmup()
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    f"{name!r} is already registered (version "
                    f"{self._entries[name].version}); use swap() to "
                    "replace it"
                )
            self._entries[name] = _Entry(name, version, ex, opts)
            ex.model_name = name
            ex.model_version = version
        telemetry.inc("sbt_serving_models_registered_total")
        telemetry.set_gauge("sbt_serving_model_version", float(version),
                            labels={"model": name})
        if ex.device.type == "cuda":
            telemetry.set_gauge("sbt_serving_graph_pool_bytes",
                                float(ex.graph_pool_bytes),
                                labels={"model": name})
        # capacity ledger feed: ownership is established HERE, at
        # commit — any builds the executor did before this point
        # retroactively become attributed via its fingerprint
        cap = _capacity.ACTIVE
        if cap is not None:
            cap.register_owner(ex)
        return ex

    def swap(self, name: str, model: Any, *, warm: bool = True,
             executable_cache: str | None = None,
             version: int | None = None,
             _equal_version_ok: bool = False,
             **executor_opts: Any) -> EnsembleExecutor:
        """Atomically replace ``name``'s serving model; returns the new
        executor and bumps the version.

        The replacement must serve the same contract (task, feature
        width, and — for classifiers — the exact class set): a swap is
        an invisible model upgrade, not an API change. ``warm=True``
        (default) maps every bucket the live executor has active
        through the NEW executor's ladder and pre-captures those rungs
        while the old graphs still serve, so the traffic profile that
        was being served never hits a capture after the swap (even
        when ``executor_opts`` changed the bucket bounds). ``executor_opts`` update the
        entry's sticky options — committed only if the swap succeeds;
        a rejected swap leaves the live entry fully untouched.
        ``executable_cache`` is counted as a miss and ignored (see
        :meth:`register`).
        ``version`` pins the replacement's version number (the
        N-process rolling-swap seam): it must be NEWER than the live
        version — a peer re-loading yesterday's checkpoint over
        today's model is a rollback that must be explicit, not a race
        a load balancer can lose — and the swap is rejected (counted,
        flight-recorded) when it is not. ``_equal_version_ok``
        (internal, used by :meth:`load`) turns the EQUAL-version case
        into a benign no-op returning the live executor instead: two
        peers racing to install the same manifest must converge, not
        record a spurious swap-rejected incident.
        """
        entry = self._entry(name)
        if version is not None and int(version) <= entry.version:
            if _equal_version_ok and int(version) == entry.version:
                return entry.executor
            self._reject_swap(
                name,
                f"stale swap: requested version {int(version)} is not "
                f"newer than the live version {entry.version} "
                "(rollbacks must re-register under a new name or use "
                "an explicitly newer manifest)",
            )
        old = entry.executor
        opts = {**entry.opts, **executor_opts}
        new = EnsembleExecutor(model, **opts)
        if new.task != old.task:
            self._reject_swap(
                name,
                f"swap would change task {old.task!r} -> {new.task!r}",
            )
        if new.n_features != old.n_features:
            self._reject_swap(
                name,
                f"swap would change feature width {old.n_features} -> "
                f"{new.n_features}",
            )
        if old.classes_ is not None and not np.array_equal(
            np.asarray(old.classes_), np.asarray(new.classes_)
        ):
            self._reject_swap(
                name,
                "swap would change the served class set; register the "
                "new label space under a new name instead",
            )
        quality_gap: Exception | None = None
        try:
            if executable_cache is not None:
                new.restore_executables(executable_cache)
            if warm:
                from spark_bagging_tpu_torch.serving.buckets import (
                    bucket_for,
                )

                for b in old.compiled_buckets:
                    if faults.ACTIVE is not None:
                        faults.fire("registry.swap.precompile",
                                    bucket=b)
                    # translate the observed traffic profile into the
                    # new executor's ladder (bounds may differ): the
                    # row counts that used to run in bucket b land in
                    # its image rung, captured before the commit
                    new._build(bucket_for(
                        b, new.min_bucket_rows, new.max_batch_rows
                    ))
            if entry.quality_opts is not None:
                # sticky drift monitoring attaches to the replacement
                # BEFORE commit (with its per-replica tap captured, when
                # disagreement sampling is on): an attach failure rolls
                # the swap back (prior executor + its monitor
                # untouched), and the replacement is monitored from its
                # very first batch. One carve-out: a replacement with no
                # fit-time profile (stream fit, older checkpoint) can
                # never be monitored, and blocking a model upgrade on an
                # optional plane is wrong — that case swaps anyway and
                # warns below.
                q_opts = dict(entry.quality_opts)
                q_opts.setdefault("labels", {"model": str(name)})
                try:
                    self._attach_quality(new, q_opts)
                except ValueError as e:
                    quality_gap = e
        # sbt-lint: disable=swallowed-fault — _fail_swap counts, flight-records, and re-raises (the rollback path)
        except Exception as e:  # noqa: BLE001 — rollback, not delivery
            # the replacement's captures free now, not when the raised
            # error's traceback (which holds ``new``) is dropped
            new.release_programs()
            self._fail_swap(name, e)
        stale_live = None
        live_ex = None
        with self._lock:
            # re-read under the lock: racing swaps must serialize into
            # a strict version order, last one in place — and an
            # explicit (manifest) version re-checks staleness HERE,
            # where the ordering is decided, not just at entry
            entry = self._entries[name]
            if version is not None and int(version) <= entry.version:
                stale_live = entry.version
                live_ex = entry.executor
            else:
                entry.executor = new
                entry.opts = opts
                entry.version = (entry.version + 1 if version is None
                                 else int(version))
                version = entry.version
                new.model_name = name
                new.model_version = version
        if stale_live is not None:
            new.release_programs()
            if _equal_version_ok and int(version) == stale_live:
                # a racing peer installed the very manifest we carry:
                # the documented poller convergence, not an incident
                return live_ex
            self._reject_swap(
                name,
                f"stale swap: requested version {int(version)} is not "
                f"newer than the live version {stale_live} (a racing "
                "peer already installed it)",
            )
        telemetry.inc("sbt_serving_swaps_total")
        telemetry.set_gauge("sbt_serving_model_version", float(version),
                            labels={"model": name})
        # not a flight-recorder trigger (a swap is routine), but it IS
        # timeline material: the fleet incident correlator lines swap
        # commits up against the dumps/alerts/sheds around them
        telemetry.emit_event({
            "kind": "model_swapped", "model": name,
            "version": int(version),
        })
        # capacity ledger feed: runs ONLY on the commit path — a failed
        # swap raised out of _fail_swap above, so the replacement's
        # fingerprint never acquires an owner and its pre-capture cache
        # entries stay unattributed. The outgoing executor is retired,
        # not erased: its entries keep their owner, so the drop below
        # is charged to it.
        cap = _capacity.ACTIVE
        if cap is not None:
            cap.register_owner(new, retired_fingerprint=old.fingerprint)
        if old.fingerprint != new.fingerprint:
            # the retired model's programs leave the unified cache at
            # once: its graphs (and their pool) free once the last
            # in-flight batch holding the old executor finishes with it
            _pc.cache().drop_fingerprint(old.fingerprint)
        if new.device.type == "cuda":
            telemetry.set_gauge("sbt_serving_graph_pool_bytes",
                                float(new.graph_pool_bytes),
                                labels={"model": name})
        if quality_gap is not None:
            # the one attach failure that does NOT roll back: a
            # replacement with no fit-time quality_profile_ (stream
            # fit, older checkpoint) can never be monitored — the
            # model upgrade ships, loudly unmonitored
            import warnings

            warnings.warn(
                f"swap of {name!r} succeeded but drift monitoring "
                f"could not re-attach: {quality_gap} (version "
                f"{version} serves UNMONITORED; fit the replacement "
                "in memory or disable_quality first)",
                RuntimeWarning,
                stacklevel=2,
            )
        return new

    def enable_quality(self, name: str,
                       **monitor_opts: Any):
        """Attach a drift monitor (``telemetry.quality``) to ``name``'s
        live executor and make it sticky: every future :meth:`swap` /
        :meth:`load` re-attaches a fresh monitor to the replacement
        executor (new model ⇒ new reference ⇒ fresh sketches).
        ``monitor_opts`` are ``QualityMonitor`` options
        (``refresh_every``, ``disagreement_every``, ...) plus an
        optional ``profile=`` override — which applies to the CURRENT
        executor only and is never sticky: a swapped-in model is
        scored against its own fit-time ``quality_profile_``, not a
        reference authored for its predecessor. Returns the monitor.
        """
        entry = self._entry(name)
        with self._lock:
            # sticky flag FIRST, executor snapshot under the same
            # lock: a swap() interleaving after this block either saw
            # the flag (and re-attaches to its new executor) or
            # committed before our read (and we attach to the new
            # executor) — either way the LIVE model ends up monitored.
            # 'profile' and 'monitor' are per-attach, never sticky: a
            # swapped-in model must be scored against its OWN
            # reference with FRESH sketches, and replaying a caller's
            # monitor= instance would re-install the predecessor's
            # profile and accumulated counts verbatim.
            entry.quality_opts = {
                k: v for k, v in monitor_opts.items()
                if k not in ("profile", "monitor")
            }
            ex = entry.executor
        return self._attach_quality(ex, monitor_opts)

    def disable_quality(self, name: str) -> None:
        """Detach ``name``'s drift monitor and clear the sticky flag."""
        entry = self._entry(name)
        with self._lock:
            # clear-then-snapshot under the lock (mirror of
            # enable_quality): a racing swap either sees the cleared
            # flag (no re-attach) or committed first (we detach its
            # new executor) — a model can never stay monitored after
            # disable_quality returns
            entry.quality_opts = None
            ex = entry.executor
        ex.detach_quality()

    @staticmethod
    def _attach_quality(executor: EnsembleExecutor, opts: dict):
        from spark_bagging_tpu_torch.telemetry import quality

        return quality.attach(executor, **opts)

    #: the JAX package's subdirectory of persisted bucket executables:
    #: :meth:`load` ignores one (counted), :meth:`save` writes none
    AOT_SUBDIR = "serving_aot"
    #: the serving manifest :meth:`save` writes next to the weights —
    #: the N-process seam: everything a fresh process needs to serve
    #: this checkpoint exactly as the saver did (executor config,
    #: version), without the operator re-specifying any of it
    SERVE_CONFIG = "serve_config.json"

    def _read_serve_config(self, path: str) -> dict | None:
        """The ``serve_config.json`` manifest at ``path``, or None
        (absent or unreadable — a config-less checkpoint is an older
        saver's, not an error)."""
        import json

        cfg_path = os.path.join(path, self.SERVE_CONFIG)
        if not os.path.isfile(cfg_path):
            return None
        try:
            with open(cfg_path) as f:
                cfg = json.load(f)
        except (OSError, ValueError) as e:
            import warnings

            warnings.warn(
                f"unreadable serve_config at {cfg_path!r} ({e!r}); "
                "loading with caller/registry executor options only",
                stacklevel=3,
            )
            return None
        return cfg if isinstance(cfg, dict) else None

    def _opts_from_config(self, cfg: dict, executor_opts: dict,
                          device: str = "cuda") -> dict:
        """Merge a serve_config's executor section UNDER the caller's
        explicit options. The persisted mesh shape is rebuilt into a live
        mesh when this process has the devices for it (over a prefix of
        them where it has more); otherwise the process serves
        single-device with a warning."""
        merged: dict[str, Any] = {}
        section = cfg.get("executor")
        if not isinstance(section, dict):
            return executor_opts
        for k in ("min_bucket_rows", "max_batch_rows", "donate_input"):
            if section.get(k) is not None:
                merged[k] = section[k]
        shape = section.get("mesh")
        if (
            shape
            and "mesh" not in executor_opts
            and "mesh" not in self._default_opts
        ):
            from spark_bagging_tpu_torch.parallel.mesh import make_mesh

            try:
                data, replica = int(shape[0]), int(shape[1])
                devices = host_devices(device)
                need = data * replica
                # a host with more devices than the recorded mesh builds
                # the recorded shape over a prefix of them
                kwargs = ({"devices": devices[:need]}
                          if len(devices) >= need else {"devices": devices})
                merged["mesh"] = make_mesh(data=data, replica=replica,
                                           **kwargs)
            except (ValueError, TypeError, IndexError, RuntimeError) as e:
                # IndexError: a truncated or hand-edited "mesh" entry —
                # a corrupt manifest degrades, it never crashes a load
                import warnings

                warnings.warn(
                    f"serve_config names a {shape} serving mesh this "
                    f"process cannot build ({e}); serving single-device",
                    stacklevel=3,
                )
        return {**merged, **executor_opts}

    def load(self, name: str, path: str, *, warm: bool = True,
             executable_cache: str | None = "auto",
             device: str = "cuda",
             **executor_opts: Any) -> EnsembleExecutor:
        """Register-or-swap ``name`` from a checkpoint directory saved
        with :meth:`save` (or ``estimator.save()`` /
        ``utils/checkpoint.save_model``, in either package), its weights
        placed on ``device`` — the hand-off seam from a retraining job
        AND between peer serving processes. ``executor_opts`` apply
        either way: on an existing name they ride the swap (committed
        to the entry's sticky options only on success).

        When the directory carries a ``serve_config.json`` manifest
        (:meth:`save` writes one), its executor configuration — bucket
        bounds, donation — is adopted underneath any caller-explicit
        options, and its VERSION is adopted outright: M peer processes
        loading the same checkpoint all serve the same version number,
        a re-load of the already-live version is an idempotent no-op,
        and a load of an OLDER manifest than the live version is
        rejected loudly (a rolling swap must only ever move forward).
        A manifest whose ``model_fingerprint`` does not match the
        weights beside it (a save killed before its manifest commit,
        or a manifest another package wrote) donates neither its
        version nor its configuration.

        ``executable_cache="auto"`` (default) looks for
        ``<path>/serving_aot``, the JAX package's persisted executables:
        a CUDA graph cannot be deserialized, so a cache found there (or
        passed explicitly) is counted in ``sbt_serving_aot_misses_total``
        and ignored, and ``warm=True`` captures the live buckets
        instead. ``None`` skips the lookup.
        """
        from spark_bagging_tpu_torch.utils.checkpoint import load_model

        cfg = self._read_serve_config(path)
        version: int | None = None
        # kept verbatim so stale-manifest detection below can fall all
        # the way back to what the CALLER asked for — a torn save's
        # manifest must donate neither its version nor its executor
        # configuration
        caller_opts = dict(executor_opts)
        if cfg is not None:
            v = cfg.get("version")
            if isinstance(v, int) and v >= 1:
                version = v
            executor_opts = self._opts_from_config(cfg, executor_opts,
                                                   device)
        with self._lock:
            entry = self._entries.get(name)
            live_version = entry.version if entry is not None else None
            live_executor = entry.executor if entry is not None else None
        if (
            version is not None
            and live_version is not None
            and version == live_version
        ):
            # idempotent convergence: a peer polling the checkpoint
            # dir re-loads the version it already serves — a no-op,
            # not an error (and not a spurious version bump)
            return live_executor
        model = load_model(path, device=device)
        if cfg is not None and isinstance(
                cfg.get("model_fingerprint"), str):
            # torn-save detection: the manifest names the weights it
            # was committed with; a mismatch means a save died between
            # its checkpoint write and its manifest rename. The
            # weights themselves are a complete, valid checkpoint —
            # serve them — but the manifest's version/config describe
            # a DIFFERENT publish and must not be adopted
            if _pc.fingerprint_model(model) != cfg["model_fingerprint"]:
                import warnings

                warnings.warn(
                    f"serve_config at {path!r} does not match the "
                    "checkpoint weights next to it (a save() was "
                    "killed before its manifest commit, or another "
                    "package wrote it); ignoring the manifest's "
                    "version AND executor config — loading as an "
                    "ordinary register/swap with the caller's options",
                    stacklevel=2,
                )
                version = None
                executor_opts = caller_opts
        if executable_cache == "auto":
            auto = os.path.join(path, self.AOT_SUBDIR)
            executable_cache = auto if os.path.isdir(auto) else None
        if live_version is None:
            try:
                return self.register(name, model, warmup=warm,
                                     executable_cache=executable_cache,
                                     version=version,
                                     **executor_opts)
            except ValueError:
                # register-or-swap must be race-safe: another load()
                # may have installed the name between our check and the
                # register — only that race falls through to swap
                with self._lock:
                    if name not in self._entries:
                        raise
        # _equal_version_ok: two peers racing to install the same
        # manifest version must CONVERGE (the loser gets the winner's
        # executor back), not crash with a spurious stale-swap incident
        return self.swap(name, model, warm=warm,
                         executable_cache=executable_cache,
                         version=version,
                         _equal_version_ok=version is not None,
                         **executor_opts)

    def save(self, name: str, path: str, *, compress: bool | str = "auto",
             executables: bool = True) -> None:
        """Checkpoint ``name``'s live model to directory ``path`` in the
        JAX package's format, with a ``serve_config.json`` manifest: the
        version + executor configuration a peer process's :meth:`load`
        adopts (see there for the rolling-swap rules). Donation is
        persisted as the entry's CONFIGURED value, not the resolved
        boolean. ``executables`` is accepted for the JAX package's
        signature; a CUDA graph cannot be serialized, so no
        ``serving_aot/`` is written either way.

        Torn-write safety: the checkpoint writes atomically (tmp+swap
        with a ``.old`` recovery slot), the manifest via tmp+rename, the
        manifest rename is LAST and is the save's commit point, and the
        manifest binds itself to the weights it describes via
        ``model_fingerprint``. A kill at ANY point between the steps
        (the ``registry.save.*`` / ``checkpoint.write`` fault sites)
        leaves a directory :meth:`load` serves correctly: a stale
        manifest is detected by fingerprint and ignored (warned), and
        the previously published version stays loadable."""
        import json

        from spark_bagging_tpu_torch.utils.checkpoint import save_model

        del executables
        entry = self._entry(name)
        with self._lock:
            ex = entry.executor
            version = entry.version
            donate_opt = entry.opts.get("donate_input")
            quality_on = entry.quality_opts is not None
        save_model(ex.model, path, compress=compress)
        if faults.ACTIVE is not None:
            faults.fire("registry.save.checkpoint")
        if faults.ACTIVE is not None:
            # the JAX package's executable-write step, kept as a probe
            # so one fault plan drills both packages' save() alike
            faults.fire("registry.save.aot")
        cfg = {
            "format": 1,
            "name": name,
            "version": version,
            "task": ex.task,
            "n_features": ex.n_features,
            # binds this manifest to the exact weights it was written
            # next to: load() ignores (and warns about) a manifest
            # whose fingerprint does not match the checkpoint — the
            # torn-save signature
            "model_fingerprint": ex.fingerprint,
            "executor": {
                "min_bucket_rows": ex.min_bucket_rows,
                "max_batch_rows": ex.max_batch_rows,
                "donate_input": donate_opt,
                "mesh": (list(ex.mesh_shape)
                         if ex.mesh_shape is not None else None),
            },
            "warm_buckets": [int(b) for b in ex.compiled_buckets],
            "quality": quality_on,
        }
        tmp = os.path.join(path, f"{self.SERVE_CONFIG}.tmp")
        with open(tmp, "w") as f:
            json.dump(cfg, f, indent=2)
        if faults.ACTIVE is not None:
            # the last kill window: everything written, nothing
            # committed — load() must still serve the prior manifest's
            # version (or detect the staleness by fingerprint)
            faults.fire("registry.save.manifest")
        os.replace(tmp, os.path.join(path, self.SERVE_CONFIG))

    def batcher(self, name: str, **batcher_opts: Any):
        """A micro-batcher bound to THIS registry entry by name: each
        micro-batch resolves the executor afresh, so ``swap()`` takes
        effect at the next batch boundary with no dropped requests."""
        from spark_bagging_tpu_torch.serving.batcher import MicroBatcher

        self._entry(name)  # fail fast on unknown names
        return MicroBatcher(lambda: self.executor(name), **batcher_opts)
