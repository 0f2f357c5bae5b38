"""The bootstrap's draws, worked out again in plain torch: threefry-2x32
keys, the Poisson(1) row counts and the feature-subspace permutations.

A frozen copy of the arithmetic of the port's ``ops/prng.py``
(``threefry2x32`` :35-49, ``key`` :52, ``fold_in`` :60-74, ``split``
:77-83, ``random_bits`` :86-97, ``uniform`` :100-108, ``permutation``
:153-166) and ``ops/bootstrap.py`` (the stream tags :32-34, the Poisson
CDF table :43-55, ``poisson_counts`` :58-73, ``bootstrap_weights``
:100-128 and ``feature_subspaces`` :140-163), spark_bagging_tpu_torch at
d3bc302: ``jax.random``'s partitionable layout, which the port
reproduces bit for bit. uint32 words are held in int64 and masked.
Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
FEATURE_STREAM = 0x5EED
ROW_STREAM = 0xB0B5
MAX_COUNT = 255


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & M32
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & M32
    return x1, x2


def key(seed: int, device) -> torch.Tensor:
    """The key of an integer seed: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None],
                         torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None],
                         torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    perm = torch.arange(n, dtype=torch.int64, device=k.device)
    perm = perm.expand(*k.shape[:-1], n)
    for _ in range(rounds):
        keys = split(k, 2)
        k, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, order)
    return perm


def _poisson_cdf(lam: float) -> np.ndarray:
    pmf, k, p = [], 0, math.exp(-lam)
    cdf = p
    while True:
        pmf.append(cdf)
        if 1.0 - cdf < 1e-12 or k > 128:
            break
        k += 1
        p *= lam / k
        cdf += p
    return np.asarray(pmf, np.float64)


def row_counts(seed: int, replica: int, n: int, device,
               ratio: float = 1.0) -> torch.Tensor:
    """Replica ``replica``'s Poisson(ratio) count of each of ``n`` rows
    under the fit seed ``seed``, float32 ``(n,)``: the inverse-CDF
    lookup of one uniform a row."""
    if ratio > 32.0:
        raise ValueError("the rejection sampler for rates above 32 is not "
                         "part of this reference")
    rk = fold_in(fold_in(key(seed, device), ROW_STREAM),
                 torch.tensor(replica, device=device))
    cdf = torch.from_numpy(_poisson_cdf(ratio).astype(np.float32)).to(device)
    counts = torch.searchsorted(cdf, uniform(rk, n).contiguous())
    return torch.clamp_max(counts.to(torch.float32), float(MAX_COUNT))


def subspace(seed: int, replica: int, n_features: int, n_subspace: int,
             device) -> torch.Tensor:
    """Replica ``replica``'s feature columns without replacement,
    ``(n_subspace,)`` int64: the identity for the full set, else the
    first ``n_subspace`` of its permutation."""
    if n_subspace == n_features:
        return torch.arange(n_features, dtype=torch.int64, device=device)
    fk = fold_in(fold_in(key(seed, device), FEATURE_STREAM),
                 torch.tensor(replica, device=device))
    return permutation(fk, n_features)[:n_subspace]
