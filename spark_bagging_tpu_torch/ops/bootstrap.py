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

# Poisson(lam<=1) essentially never exceeds this; counts fit in uint8.
_MAX_COUNT = 255

# Largest rate the inverse-CDF sampler handles (the JAX package falls
# back to jax.random.poisson's rejection sampler above it).
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

_ROADMAP_BOOTSTRAP = "ROADMAP Queue A: bootstrap branches still to port"


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
    cdf = torch.as_tensor(
        _poisson_cdf_table(lam).astype(np.float32), device=k.device
    )
    u = prng.uniform(k, n)
    # u < cdf[j]  <=>  count <= j ; side="left" gives the smallest such j
    return torch.searchsorted(cdf, u.contiguous()).to(torch.float32)


def fit_key(k: torch.Tensor, replica_ids: torch.Tensor) -> torch.Tensor:
    """Per-replica keys for learner init/fit (independent of row draws)."""
    return prng.fold_in(prng.fold_in(k, _FIT_STREAM), replica_ids)


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

    - ``replacement=True``: Poisson(ratio) counts, clamped at 255.
    - ``replacement=False``: an exact ``round(ratio * n_rows)``-subset
      (at least 1) without replacement, as a 0/1 mask.

    Row ``r`` equals the JAX package's
    ``bootstrap_weights_one(key, replica_ids[r], n_rows, ...)``.
    """
    if ratio <= 0:
        raise ValueError(f"ratio={ratio} must be positive")
    rk = prng.fold_in(prng.fold_in(k, _ROW_STREAM), replica_ids)
    if replacement:
        if ratio > _INV_CDF_MAX_LAM:
            raise NotImplementedError(
                f"ratio={ratio} > {_INV_CDF_MAX_LAM} needs the Poisson "
                f"rejection sampler ({_ROADMAP_BOOTSTRAP})"
            )
        counts = poisson_counts(rk, ratio, n_rows)
        return torch.clamp_max(counts, float(_MAX_COUNT))
    m = max(1, int(round(ratio * n_rows)))
    n_rep = replica_ids.shape[0]
    if m >= n_rows:
        return torch.ones((n_rep, n_rows), dtype=torch.float32, device=k.device)
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
