"""The base-learner contract, batched over a leading replica axis.

The JAX package's learners are pure functions of one replica that the
ensemble engine ``vmap``s. Here the replica axis is written out: every
method takes and returns tensors whose leading axis is the replica
chunk being fitted.

- ``init_params(keys, n_features, n_outputs) -> params`` with ``keys``
  ``(R, 2)`` and every params leaf ``(R, ...)``;
- ``fit(params, X, y, sample_weight, keys, prepared=None) -> (params,
  aux)`` with ``X`` ``(n, d)`` shared by every replica or ``(R, n, d)``,
  ``y`` ``(n,)`` and ``sample_weight`` ``(R, n)``;
- ``predict_scores(params, X) -> scores`` ``(R, n, C)`` (``(R, n)`` for
  a regressor).

A ``streamable`` learner also gives ``row_loss(params, X, y) -> (R, n)``,
its unweighted per-row loss, and ``penalty(params) -> (R,)``, so the
out-of-core engine (streaming.py) can fit it by Adam over data chunks.

Params are dicts of tensors. ``sample_weight`` carries the Poisson
bootstrap counts, which a learner treats as exact row multiplicities.

Row reductions go through ``ops/reduce.maybe_psum(_, axis_name)``, so
every learner fits data-parallel: ``prepare``, ``pooled_init``, ``fit``
and ``fit_from_init`` take ``axis_name``, the mesh axis rows are sharded
over, and every shard's fit is the fit on all shards' rows. The engines
pass ``axis_name`` only when it is set.
"""

from __future__ import annotations

from typing import Any, ClassVar

import torch

from spark_bagging_tpu_torch.utils.params import ParamsMixin

Params = dict[str, torch.Tensor]
Aux = dict[str, torch.Tensor]


def augment_bias(X: torch.Tensor) -> torch.Tensor:
    """Append a bias column of ones: weights are ``(d+1, C)`` with the
    bias in the LAST row, which ``W[..., :-1, :]`` penalties rely on."""
    ones = torch.ones((*X.shape[:-1], 1), dtype=X.dtype, device=X.device)
    return torch.cat([X, ones], dim=-1)


class BaseLearner(ParamsMixin):
    """Abstract base-learner contract (see module docstring)."""

    task: ClassVar[str]  # "classification" | "regression"
    uses_pooled_init: ClassVar[bool] = False
    # True: ``fit`` takes the shared ``(n, d)`` X with the column index
    # that ``gather_subspace`` puts in the prepared state, and
    # ``predict_scores(params, X, cols=idx)`` reads it the same way, so a
    # feature subspace makes no ``X[:, idx]`` copy
    reads_subspace_index: ClassVar[bool] = False
    # True: ``fit`` and ``row_loss`` take a per-row auxiliary column as
    # ``aux=`` (the survival learner's censor flags), which the engines
    # thread through beside y; other learners never see the keyword
    uses_aux: ClassVar[bool] = False
    # True: ``row_loss``/``penalty`` are implemented and ``fit_stream``
    # fits the learner by Adam over data chunks (streaming.py)
    streamable: ClassVar[bool] = False
    # The params leaf ``W (R, d+1, C)`` of a classifier whose scores are
    # ``augment_bias(X) @ W`` (bias in the last row): its soft vote is
    # one pass of the soft-vote kernel (ops/soft_vote.py). None: the
    # scores take another form
    linear_softmax_weights: ClassVar[str | None] = None
    # The params leaf ``(R, 2^D, C)`` of a depth-D tree classifier whose
    # scores are the row of the leaf its ``feature``/``threshold`` heap
    # routes a row to: its hard vote is one pass of the tree-vote kernel
    # (ops/tree_vote.py). None: the scores take another form
    tree_leaf_scores: ClassVar[str | None] = None

    def pooled_amortizes(self, n_replicas: int) -> bool:
        """Is the pooled pre-pass worth running for an ensemble of this
        total size? Learners with a cost model override."""
        del n_replicas
        return True

    def init_params(self, keys: torch.Tensor, n_features: int,
                    n_outputs: int) -> Params:
        raise NotImplementedError

    def pooled_init(self, key: torch.Tensor, prepared: Any, X: torch.Tensor,
                    y: torch.Tensor, n_outputs: int, *,
                    row_mask: torch.Tensor | None = None,
                    axis_name: str | None = None) -> Any:
        """Shared warm-start state, computed once per ensemble; the
        returned value replaces ``prepared`` for this fit."""
        raise NotImplementedError

    def initial_params(self, keys: torch.Tensor, n_features: int,
                       n_outputs: int, prepared: Any | None) -> Params:
        """Per-replica initial params; sees the prepared state so a
        pooled warm start can override the cold ``init_params``."""
        del prepared
        return self.init_params(keys, n_features, n_outputs)

    def fit(self, params: Params, X: torch.Tensor, y: torch.Tensor,
            sample_weight: torch.Tensor, keys: torch.Tensor, *,
            prepared: Any | None = None,
            axis_name: str | None = None) -> tuple[Params, Aux]:
        raise NotImplementedError

    def predict_scores(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- the streaming contract (streaming.py) --------------------------

    def row_loss(self, params: Params, X: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        """Unweighted loss per replica and row, ``(R, n)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming fits")

    def penalty(self, params: Params) -> torch.Tensor:
        """The regularizer of each replica, ``(R,)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming fits")

    def sgd_step_flops(self, chunk_rows: int, n_features: int,
                       n_outputs: int) -> float | None:
        """Matmul FLOPs of ONE streamed optimizer step (forward and
        backward, 3x the forward products) on a padded chunk for one
        replica; None means no cost model."""
        del chunk_rows, n_features, n_outputs
        return None

    def prepare(self, X: torch.Tensor, *,
                row_mask: torch.Tensor | None = None,
                axis_name: str | None = None) -> Any | None:
        """Replica-invariant precomputation; None means nothing."""
        del X, row_mask, axis_name
        return None

    def gather_subspace(self, prepared: Any, idx: torch.Tensor) -> Any:
        """Restrict prepared state to each replica's columns ``idx``
        ``(R, n_sub)``."""
        return prepared

    def flops_per_fit(self, n_rows: int, n_features: int,
                      n_outputs: int) -> float | None:
        """Analytic floating-point ops for ONE base-learner fit (a
        multiply-add counts 2); None means no cost model."""
        del n_rows, n_features, n_outputs
        return None

    def fit_workset_bytes(self, n_rows: int, n_features: int,
                          n_outputs: int,
                          device: torch.device | None = None) -> float | None:
        """Approximate peak per-replica device bytes of one fit (the
        solver's temporaries, not the shared X) on ``device``; drives
        the automatic ``chunk_size`` (utils/memory.py). None means
        unmodeled."""
        del n_rows, n_features, n_outputs, device
        return None

    def subspace_gather_bytes(self, n_rows: int, n_subspace: int,
                              device: torch.device | None = None) -> float:
        """Per-replica bytes of the ``X[:, idx]`` copy a feature
        subspace makes (on ``device``)."""
        del device
        return 4.0 * n_rows * n_subspace

    def prepared_bytes(self, n_rows: int, n_features: int,
                       device: torch.device | None = None) -> float:
        """Device bytes of the replica-invariant state ``prepare``
        keeps for the whole fit (one copy, whatever the chunk)."""
        del n_rows, n_features, device
        return 0.0

    def fit_from_init(self, keys: torch.Tensor, X: torch.Tensor,
                      y: torch.Tensor, sample_weight: torch.Tensor,
                      n_outputs: int, *, prepared: Any | None = None,
                      aux: torch.Tensor | None = None,
                      axis_name: str | None = None) -> tuple[Params, Aux]:
        """Init-then-fit with split keys; a replica chunk's whole
        training. ``aux`` reaches a ``uses_aux`` learner's fit only, and
        ``axis_name`` the fit only where it is set."""
        from spark_bagging_tpu_torch.ops.bootstrap import split_init_fit

        init_keys, fit_keys = split_init_fit(keys)
        params = self.initial_params(
            init_keys, X.shape[-1], n_outputs, prepared
        )
        kwargs = {} if prepared is None else {"prepared": prepared}
        if self.uses_aux:
            kwargs["aux"] = aux
        if axis_name is not None:
            kwargs["axis_name"] = axis_name
        return self.fit(params, X, y, sample_weight, fit_keys, **kwargs)


class PooledStartMixin:
    """Pooled warm start for convex learners: ``init="pooled"`` solves
    the unweighted pooled problem once per ensemble (``pooled_iter``
    solver steps) and starts every replica's weighted fit from it. Each
    replica's objective is convex, so the start changes the solver's
    path, not its destination.

    Subclasses list this mixin before ``BaseLearner``, declare
    ``init``/``pooled_iter`` hyperparams, keep coefficients in the
    params leaf ``_pooled_leaf`` with the bias row last, and accept a
    ``prepared=`` keyword in ``fit``.
    """

    _pooled_leaf: ClassVar[str] = "W"
    # dims of one replica's pooled leaf: (d+1, C) coefficients, or a
    # (d+1,) vector (GLM's beta)
    _pooled_leaf_ndim: ClassVar[int] = 2

    @property
    def uses_pooled_init(self) -> bool:
        return self.init == "pooled"

    def pooled_amortizes(self, n_replicas: int) -> bool:
        """The pre-pass costs ``pooled_iter`` full-data iterations and
        saves about two per replica: it pays once ``2·R >= pooled_iter``."""
        return 2 * n_replicas >= self.pooled_iter

    def pooled_init(self, key, prepared, X, y, n_outputs, *, row_mask=None,
                    axis_name=None):
        del prepared  # these learners have no other prepared state
        n = X.shape[0]
        w = (torch.ones((1, n), dtype=torch.float32, device=X.device)
             if row_mask is None else row_mask.to(torch.float32)[None])
        solver = type(self)(**{
            **self.get_params(), "init": "zeros",
            "max_iter": self.pooled_iter,
        })
        keys = key[None]
        params0 = solver.init_params(keys, X.shape[1], n_outputs)
        kw = {} if axis_name is None else {"axis_name": axis_name}
        params, _ = solver.fit(params0, X, y, w, keys, **kw)
        return params[self._pooled_leaf][0]

    def gather_subspace(self, prepared, idx):
        if prepared is None:
            return None
        # each replica's rows of the pooled solution; the bias row rides
        # along: (R, n_sub + 1, ...)
        bias = prepared[-1:].expand(idx.shape[0], *prepared[-1:].shape)
        return torch.cat([prepared[idx.long()], bias], dim=1)

    def initial_params(self, keys, n_features, n_outputs, prepared):
        if self.init == "pooled" and prepared is not None:
            if prepared.dim() == self._pooled_leaf_ndim:  # shared start
                prepared = prepared.expand(keys.shape[0], *prepared.shape)
            return {self._pooled_leaf: prepared.contiguous()}
        return self.init_params(keys, n_features, n_outputs)

    @staticmethod
    def validate_init(init: str) -> str:
        if init not in ("zeros", "pooled"):
            raise ValueError(f"init must be zeros|pooled, got {init!r}")
        return init
