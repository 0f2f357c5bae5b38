"""Bootstrap engine: Poisson row weights and feature-subspace draws.

Every replica gets a per-row weight vector drawn ``Poisson(ratio)``
instead of a materialized resample. Each draw depends only on
(seed, replica_id) through the threefry key schedule (ops/prng.py), so
the port draws exactly the weights the JAX package draws, bit for bit,
and a replica's weights can be regenerated anywhere (the OOB pass
does). The functions take a 1-D tensor of replica ids and return one
row per replica: the explicit form of the JAX package's ``vmap``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.ranges import profiler_range

# Poisson(lam<=1) essentially never exceeds this; counts fit in uint8.
_MAX_COUNT = 255

# Largest rate the inverse-CDF sampler handles; above it the draws are
# jax.random.poisson's rejection sampler (prng.poisson), as in the JAX
# package.
_INV_CDF_MAX_LAM = 32.0

# Stream tags folded into the base key so row draws, feature draws,
# learner-init keys and online updates are independent streams; the
# values must stay equal to the JAX package's (see its ops/bootstrap.py).
_FEATURE_STREAM = 0x5EED
_FIT_STREAM = 0xF17
_ROW_STREAM = 0xB0B5
_ONLINE_STREAM = 0xA511
# Bumped whenever the key schedule above changes.
RNG_SCHEMA = 2
# The profiler range around every draw: profile_fit sums its kernels'
# device time under this name (no cost when no profiler is active).
DRAW_RANGE = "bootstrap_weights"


def _poisson_cdf_table(lam: float) -> np.ndarray:
    """CDF of Poisson(lam) up to the point where the tail mass is below
    1e-12; float64 host-side precompute."""
    pmf, k, p = [], 0, math.exp(-lam)
    cdf = p
    while True:
        pmf.append(cdf)
        if 1.0 - cdf < 1e-12 or k > 4 * _INV_CDF_MAX_LAM:
            break
        k += 1
        p *= lam / k
        cdf += p
    return np.asarray(pmf, np.float64)


def poisson_counts(k: torch.Tensor, lam: float, n: int) -> torch.Tensor:
    """Poisson(lam) counts by inverse-CDF lookup, ``(..., n)`` float32:
    one uniform per row and a ``searchsorted`` (side="left") into the
    float32 CDF table."""
    cdf = torch.from_numpy(_poisson_cdf_table(lam).astype(np.float32))
    if k.device.type == "cuda":
        # pinned and asynchronous: a copy from pageable host memory waits
        # for the device's queue, which would stall a stream of chunks
        cdf = cdf.pin_memory().to(k.device, non_blocking=True)
    u = prng.uniform(k, n)
    # u < cdf[j]  <=>  count <= j ; side="left" gives the smallest such j
    return torch.searchsorted(cdf, u.contiguous()).to(torch.float32)


def fit_key(k: torch.Tensor, replica_ids: torch.Tensor) -> torch.Tensor:
    """Per-replica keys for learner init/fit (independent of row draws)."""
    return prng.fold_in(prng.fold_in(k, _FIT_STREAM), replica_ids)


def online_step_key(k: torch.Tensor, step: int) -> torch.Tensor:
    """THE base key of online-update step ``step`` (online/updater.py):
    ``fold_in(fold_in(k, _ONLINE_STREAM), step)``, as the JAX package
    derives it. The returned key is consumed exactly like a batch fit's
    base key (row draws fold ``_ROW_STREAM``, fit keys ``_FIT_STREAM``,
    then the replica id), so the whole update stream is a pure function
    of ``(seed, step, replica_id)``."""
    return prng.fold_in(prng.fold_in(k, _ONLINE_STREAM), step)


def split_init_fit(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split replica training keys ``(..., 2)`` into their (init, fit) pair."""
    keys = prng.split(k, 2)
    return keys[..., 0, :], keys[..., 1, :]


def replica_init_fit_keys(
    k: torch.Tensor, replica_ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """THE (init, fit) key pair of each replica's training."""
    return split_init_fit(fit_key(k, replica_ids))


def bootstrap_weights(
    k: torch.Tensor,
    replica_ids: torch.Tensor,
    n_rows: int,
    *,
    ratio: float = 1.0,
    replacement: bool = True,
) -> torch.Tensor:
    """Per-row sample weights of each replica, ``(R, n_rows)`` float32.

    - ``replacement=True``: Poisson(ratio) counts, clamped at 255: the
      inverse-CDF lookup up to a rate of 32, JAX's rejection sampler
      above it.
    - ``replacement=False``: an exact ``round(ratio * n_rows)``-subset
      (at least 1) without replacement, as a 0/1 mask.

    Row ``r`` equals the JAX package's
    ``bootstrap_weights_one(key, replica_ids[r], n_rows, ...)``.
    """
    if ratio <= 0:
        raise ValueError(f"ratio={ratio} must be positive")
    with profiler_range(DRAW_RANGE):
        rk = prng.fold_in(prng.fold_in(k, _ROW_STREAM), replica_ids)
        if replacement:
            if ratio <= _INV_CDF_MAX_LAM:
                counts = poisson_counts(rk, ratio, n_rows)
            else:  # huge oversampling: the exact rejection sampler
                counts = prng.poisson(rk, ratio, n_rows)
            return torch.clamp_max(counts, float(_MAX_COUNT))
        m = max(1, int(round(ratio * n_rows)))
        n_rep = replica_ids.shape[0]
        if m >= n_rows:
            return torch.ones((n_rep, n_rows), dtype=torch.float32,
                              device=k.device)
        u = prng.uniform(rk, n_rows)
        # the m-th smallest u is the inclusion threshold
        kth = torch.kthvalue(u, m, dim=-1, keepdim=True).values
        return (u <= kth).to(torch.float32)


def feature_subspaces(
    k: torch.Tensor,
    replica_ids: torch.Tensor,
    n_features: int,
    n_subspace: int,
    *,
    replacement: bool = False,
) -> torch.Tensor:
    """Feature-subspace indices of each replica, ``(R, n_subspace)`` int32.

    The full feature set without replacement is the identity (so the
    degenerate ensemble is exactly the base learner); otherwise each
    replica draws from its own feature stream: ``randint`` indices with
    replacement, the first ``n_subspace`` of a permutation without.
    """
    n_rep = replica_ids.shape[0]
    if not replacement and n_subspace == n_features:
        return torch.arange(
            n_features, dtype=torch.int32, device=k.device
        ).expand(n_rep, n_features).contiguous()
    fk = prng.fold_in(prng.fold_in(k, _FEATURE_STREAM), replica_ids)
    if replacement:
        return prng.randint(fk, n_subspace, 0, n_features)
    perm = prng.permutation(fk, n_features)[:, :n_subspace]
    return perm.to(torch.int32).contiguous()


def oob_mask(weights: torch.Tensor) -> torch.Tensor:
    """Out-of-bag mask: rows a replica never sampled (weight == 0)."""
    return weights == 0
