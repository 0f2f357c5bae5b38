"""Weights carried across from and to the JAX package.

A fitted JAX ``BaggingClassifier`` holds ``ensemble_`` (a dict of
stacked per-replica arrays, ``{"W": (R, d+1, C)}`` for logistic
regression, ``feature``/``threshold``/``gain``/``leaf_logp`` for trees)
and ``subspaces_`` ``(R, n_subspace)`` int32. The port keeps
the same layout, so carrying a model across is a copy onto the device.
The caller passes numpy arrays (``np.asarray`` of the JAX arrays): the
port imports nothing of JAX. :func:`params_to_jax` is the inverse, the
numpy leaves a JAX checkpoint holds (``utils/checkpoint.py``).
:func:`adam_state_to_jax` and :func:`adam_state_from_jax` carry the
streamed fits' optimizer state (``optim.Adam``) to and from optax's.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(
    ensemble: dict, subspaces, *, device: torch.device | str
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``(ensemble_, subspaces_)`` of the port from the JAX package's.
    Integer leaves (a tree's split ``feature``) stay int32, which the
    routing indexes with; every other leaf becomes float32."""
    params = {}
    for name, leaf in ensemble.items():
        leaf = np.asarray(leaf)
        dtype = np.int32 if np.issubdtype(leaf.dtype, np.integer) else np.float32
        params[name] = torch.tensor(leaf.astype(dtype), device=device)
    subs = torch.tensor(np.asarray(subspaces, np.int32), device=device)
    n_rep = {leaf.shape[0] for leaf in params.values()}
    if n_rep != {subs.shape[0]}:
        raise ValueError(
            f"replica counts disagree: params {sorted(n_rep)}, "
            f"subspaces {subs.shape[0]}"
        )
    return params, subs


def params_to_jax(
    ensemble: dict[str, torch.Tensor], subspaces: torch.Tensor
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Inverse of :func:`params_from_jax`: host numpy leaves in the
    dtypes the JAX package's fitted ensembles hold (int32 for integer
    leaves and the subspaces, float32 for every other leaf)."""
    params = {}
    for name, leaf in ensemble.items():
        leaf = leaf.detach().cpu().numpy()
        dtype = np.int32 if np.issubdtype(leaf.dtype, np.integer) else np.float32
        params[name] = np.ascontiguousarray(leaf.astype(dtype, copy=False))
    subs = np.ascontiguousarray(
        subspaces.detach().cpu().numpy().astype(np.int32, copy=False))
    return params, subs


def adam_state_to_jax(opt, n_replicas: int) -> dict:
    """``optim.Adam``'s state as flax's state dict of the vmapped
    ``optax.adam`` state ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``: ``{"0": {"count": (R,) int32, "mu": {...}, "nu":
    {...}}, "1": {}}`` with numpy leaves."""
    host = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}  # noqa: E731
    return {
        "0": {"count": np.full((n_replicas,), opt.count, np.int32),
              "mu": host(opt.mu), "nu": host(opt.nu)},
        "1": {},
    }


def adam_state_from_jax(opt, state: dict) -> None:
    """Load optax's Adam state dict (:func:`adam_state_to_jax`'s form)
    into ``opt``, in place. The replicas share one step count, as the
    vmapped counts are all equal."""
    adam = state["0"]
    counts = np.unique(np.asarray(adam["count"]))
    if counts.size != 1:
        raise ValueError(f"replicas' Adam step counts differ: {counts}")
    opt.count = int(counts[0])
    for moments, saved in ((opt.mu, adam["mu"]), (opt.nu, adam["nu"])):
        for name, leaf in saved.items():
            moments[name].copy_(torch.from_numpy(np.array(leaf)))
